// Shared device helpers of the port's quantized kernels (qgemm.cu,
// qconv_dw.cu), in their int8-activation and float-activation modes.
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
// the float-mode sum); the rest is the shared epilogue.
__device__ __forceinline__ void store_epilogue_f(float y, float s, float b,
                                                 const Epilogue& e,
                                                 int8_t* __restrict__ out_code,
                                                 float* __restrict__ out_f,
                                                 size_t idx) {
  y = __fmul_rn(y, s);
  if (e.has_bias) y = __fadd_rn(y, b);
  if (e.relu) y = fmaxf(y, 0.0f);
  if (!e.has_aqt) {
    out_f[idx] = y;
    return;
  }
  float c = rintf(__fmul_rn(y, e.mul));
  c = fminf(fmaxf(c, static_cast<float>(e.qmin)), static_cast<float>(e.qmax));
  if (e.out_code) {
    out_code[idx] = static_cast<int8_t>(__float2int_rn(c));
  } else {
    out_f[idx] = __fmul_rn(c, e.inv);
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
// the int8 domain: clip(rint(c / 2^(8-bits)), -2^(bits-1), 2^(bits-1)-1) *
// 2^(8-bits) -- the half-to-even rule of quant.ptq.derive_view.  c / step is
// exact in f32 (step is a power of two).
__device__ __forceinline__ int truncate_view(int c, int bits) {
  if (bits >= 8) return c;
  const int step = 1 << (8 - bits);
  float q = rintf(__fdiv_rn(static_cast<float>(c), static_cast<float>(step)));
  q = fminf(fmaxf(q, -static_cast<float>(1 << (bits - 1))),
            static_cast<float>((1 << (bits - 1)) - 1));
  return static_cast<int>(q) * step;
}

// Field j of a split-row packed byte, sign-extended: the true `bits`-bit
// integer q (the 2^(8-bits) step is folded into the channel scale).
__device__ __forceinline__ int unpack_field(unsigned byte, int j, int bits) {
  const int mask = (1 << bits) - 1;
  const int half = 1 << (bits - 1);
  const int f = static_cast<int>((byte >> (j * bits)) & mask);
  return f >= half ? f - (1 << bits) : f;
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
