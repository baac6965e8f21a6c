// Shared device helpers of the port's quantized kernels (qgemm.cu,
// qconv_dw.cu), in their int8-activation and float-activation modes: the
// epilogue, the weight views, and the cp.async copies both stage with.
//
// The epilogue is the bit-exactness contract with the plain PyTorch versions
// (repro_torch/kernels/qmatmul/ref.py): int32 accumulator -> f32 with
// round-to-nearest (__int2float_rn, as XLA converts), times the folded
// per-channel scale, plus bias -- each rounded on its own with __fmul_rn /
// __fadd_rn so the compiler can never contract them into one fma -- then
// ReLU, then the fixed-point requant rint(y * 2^frac) (round half to even,
// never roundf) clamped to [qmin, qmax], stored as an int8 code or decoded
// back to f32 as code * 2^-frac.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

struct Epilogue {
  int relu;
  int has_bias;
  int has_aqt;   // fixed-point requant on (act_qt given)
  int out_code;  // store int8 codes (requires has_aqt) instead of f32
  int qmin;
  int qmax;
  float mul;     // 2^frac
  float inv;     // 2^-frac
};

// `y` is the accumulator already as f32 (an int32 sum converted with
// __int2float_rn, times the per-row activation scale where there is one, or
// the float-mode sum); returns what the epilogue stores: the f32 result, or
// with `out_code` the int8 code as a float (an integer in [qmin, qmax]).
__device__ __forceinline__ float epilogue_value(float y, float s, float b,
                                                const Epilogue& e) {
  y = __fmul_rn(y, s);
  if (e.has_bias) y = __fadd_rn(y, b);
  if (e.relu) y = fmaxf(y, 0.0f);
  if (!e.has_aqt) return y;
  float c = rintf(__fmul_rn(y, e.mul));
  c = fminf(fmaxf(c, static_cast<float>(e.qmin)), static_cast<float>(e.qmax));
  return e.out_code ? c : __fmul_rn(c, e.inv);
}

__device__ __forceinline__ void store_epilogue_f(float y, float s, float b,
                                                 const Epilogue& e,
                                                 int8_t* __restrict__ out_code,
                                                 float* __restrict__ out_f,
                                                 size_t idx) {
  const float v = epilogue_value(y, s, b, e);
  if (e.out_code) {
    out_code[idx] = static_cast<int8_t>(__float2int_rn(v));
  } else {
    out_f[idx] = v;
  }
}

__device__ __forceinline__ void store_epilogue(int acc, float s, float b,
                                               const Epilogue& e,
                                               int8_t* __restrict__ out_code,
                                               float* __restrict__ out_f,
                                               size_t idx) {
  store_epilogue_f(__int2float_rn(acc), s, b, e, out_code, out_f, idx);
}

// Nested truncation of an int8 master code to its `bits`-bit view, still in
// the int8 domain: clip(rint(c / 2^sh), -2^(bits-1), 2^(bits-1)-1) * 2^sh
// with sh = 8 - bits -- the half-to-even rule of quant.ptq.derive_view, in
// integer arithmetic: c >> sh is the floor of the quotient, the low sh bits
// its remainder, and a remainder of exactly half rounds to the even floor.
__device__ __forceinline__ int truncate_view(int c, int bits) {
  if (bits >= 8) return c;
  const int sh = 8 - bits;
  const int half = 1 << (sh - 1);
  const int fl = c >> sh;
  const int rem = c & ((1 << sh) - 1);
  int q = fl + ((rem > half || (rem == half && (fl & 1))) ? 1 : 0);
  const int lim = 1 << (bits - 1);
  q = min(max(q, -lim), lim - 1);
  return q * (1 << sh);
}

// Field j of a split-row packed byte, sign-extended: the true `bits`-bit
// integer q (the 2^(8-bits) step is folded into the channel scale).
__device__ __forceinline__ int unpack_field(unsigned byte, int j, int bits) {
  const int mask = (1 << bits) - 1;
  const int half = 1 << (bits - 1);
  const int f = static_cast<int>((byte >> (j * bits)) & mask);
  return f >= half ? f - (1 << bits) : f;
}

// -- asynchronous copies global -> shared (cp.async) ---------------------------

// copy `n` (0..16) bytes into a 16-byte shared slot and zero-fill the rest;
// both addresses 16-byte aligned, n == 0 reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// copy a `kBytes` (4 or 8) unit, or zero-fill it where `ok` is false
template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// `bytes` contiguous bytes global -> shared in 16-byte units spread over the
// block's threads (both ends 16-byte aligned; the tail unit copies what is
// left); the caller commits and waits
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src,
                                               int bytes) {
  for (int off = threadIdx.x * 16; off < bytes;
       off += static_cast<int>(blockDim.x) * 16)
    cp_async16(static_cast<char*>(dst) + off,
               static_cast<const char*>(src) + off,
               bytes - off < 16 ? bytes - off : 16);
}

inline Epilogue make_epilogue(int relu, int has_bias, int has_aqt,
                              int out_code, int qmin, int qmax, float mul,
                              float inv) {
  Epilogue e;
  e.relu = relu;
  e.has_bias = has_bias;
  e.has_aqt = has_aqt;
  e.out_code = out_code;
  e.qmin = qmin;
  e.qmax = qmax;
  e.mul = mul;
  e.inv = inv;
  return e;
}

}  // namespace repro
