// qgemm: quantized-weight GEMM with a fused requant epilogue, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel `qgemm_kernel` in
// src/repro/kernels/qmatmul/kernel.py (with its helpers `_truncate` and
// `_unpack_fields`), in both its modes.  The weight is either the int8 master
// codes (K, N), truncated to the active W8/W4/W2 view in registers, or the
// split-row packed uint8 buffer (K'/r, N), r = 8/bits, unpacked in registers.
//
// * int8-activation mode: int8 activation codes (M, K), int32 accumulation,
//   and optionally a per-row activation scale xs (M,) applied to the
//   accumulator before the channel scale (acc * xs[m] * s[n], the oracle's
//   order); without it the scalar activation scale is folded into s.
// * float-activation mode: f32 activations (M, K) times the integer codes as
//   f32, accumulated in f32 (each product and sum rounded on its own).  The
//   TPU kernel casts the activations to bf16 to feed its MXU; this one keeps
//   them f32, since a 16-bit fixed-point activation does not fit bf16's 8
//   significant bits.
//
// Both modes end in the same epilogue: the per-channel scale (sub-byte step
// folded in on the host), bias, ReLU and fixed-point requant, storing int8
// codes (int8 mode only) or f32.
//
// What bounds it on this card: at the widths this port serves (the CNN
// slice: K = 8..1568, N = 8..32, M = batch x spatial positions) the
// arithmetic intensity is a few int8 operations per byte, far below the
// H100's ~590 int8 tensor-core operations per byte of HBM bandwidth, so the
// kernel is bound by bytes -- and at batch 8 the whole problem is a few
// hundred kB, so one launch's fixed latency dominates.  The float mode reads
// 4 bytes per activation and does f32 FMAs on CUDA cores (67 TFLOP/s); at
// these K it is bound by bytes as well.
//
// What the design does about it: one pass over each operand, no padding
// copies (the kernel masks the ragged M/N/K edges itself, so the wrapper
// makes no padded buffers), sub-byte weights stream packed (1/2 or 1/4 of the
// W8 bytes) and unpack in registers, and the epilogue writes the consumer's
// int8 codes directly so the next layer reads 1 byte per activation.  Each
// CTA owns a 64x64 output tile (256 threads, a 4x4 micro-tile each) and
// stages tiles of both operands in shared memory (int8, or f32 in the float
// mode).  Tensor-core (wgmma) tiling is later work; it pays only at larger K
// and N.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// element types of one mode: activation X, staged weight Wv, accumulator Acc
template <bool kFloat>
struct Mode {
  using X = int8_t;
  using Wv = int8_t;
  using Acc = int;
  static __device__ __forceinline__ Acc mac(Acc acc, Acc a, Acc b) {
    return acc + a * b;
  }
};

template <>
struct Mode<true> {
  using X = float;
  using Wv = float;
  using Acc = float;
  static __device__ __forceinline__ Acc mac(Acc acc, Acc a, Acc b) {
    return __fadd_rn(acc, __fmul_rn(a, b));
  }
};

template <bool kFloat>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const typename Mode<kFloat>::X* __restrict__ x,
             const void* __restrict__ w, const float* __restrict__ xs,
             const float* __restrict__ s, const float* __restrict__ bias,
             int8_t* __restrict__ out_code, float* __restrict__ out_f, int M,
             int K, int N, int bits, int packed, int kp_rows,
             repro::Epilogue e) {
  using X = typename Mode<kFloat>::X;
  using Wv = typename Mode<kFloat>::Wv;
  using Acc = typename Mode<kFloat>::Acc;
  __shared__ X As[BK][BM];
  __shared__ Wv Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int8_t* wi = static_cast<const int8_t*>(w);
  const uint8_t* wu = static_cast<const uint8_t*>(w);

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: consecutive threads read consecutive k of one row;
    // columns >= K read as zero
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk]
                                      : X(0);
    }
    // weight tile: consecutive threads read consecutive n of one row
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      int v = 0;
      if (gk < K && gn < N) {
        if (packed) {
          // split-row layout: column gk is field j of packed row gk - j*kp_rows
          const int j = gk / kp_rows;
          const int row = gk - j * kp_rows;
          v = repro::unpack_field(wu[static_cast<size_t>(row) * N + gn], j,
                                  bits);
        } else {
          v = repro::truncate_view(wi[static_cast<size_t>(gk) * N + gn], bits);
        }
      }
      Bs[kk][nn] = static_cast<Wv>(v);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = Mode<kFloat>::mac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const size_t idx = static_cast<size_t>(gm) * N + gn;
      const float b = e.has_bias ? bias[gn] : 0.0f;
      if constexpr (kFloat) {
        repro::store_epilogue_f(acc[i][j], s[gn], b, e, out_code, out_f, idx);
      } else {
        if (xs != nullptr) {
          // per-row activation scale: (acc * xs[m]) * s[n], two roundings
          repro::store_epilogue_f(
              __fmul_rn(__int2float_rn(acc[i][j]), xs[gm]), s[gn], b, e,
              out_code, out_f, idx);
        } else {
          repro::store_epilogue(acc[i][j], s[gn], b, e, out_code, out_f, idx);
        }
      }
    }
  }
}

template <bool kFloat>
int launch(const void* x, const void* w, const void* xs, const void* s,
           const void* bias, void* out, int M, int K, int N, int bits,
           int packed, int kp_rows, int relu, int has_aqt, int out_code,
           int qmin, int qmax, float mul, float inv, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const repro::Epilogue e = repro::make_epilogue(
      relu, bias != nullptr, has_aqt, out_code, qmin, qmax, mul, inv);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  qgemm_kernel<kFloat><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Mode<kFloat>::X*>(x), w,
      static_cast<const float*>(xs), static_cast<const float*>(s),
      static_cast<const float*>(bias),
      out_code ? static_cast<int8_t*>(out) : nullptr,
      out_code ? nullptr : static_cast<float*>(out), M, K, N, bits, packed,
      kp_rows, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes).  `w` is int8 (K, N) codes, or with
// `packed` the uint8 (kp_rows, N) split-row buffer (kp_rows * 8/bits >= K).
// `s` is the folded per-channel scale (N,), `bias` (N,) or null; `out` is
// int8 (M, N) when `out_code`, else f32 (M, N).  Each launches on `stream`
// and returns cudaGetLastError().
//
// int8-activation mode: `x` int8 (M, K) codes; `xs` the per-row activation
// scale (M,) f32, or null when the scalar one is folded into `s`.
extern "C" int repro_qgemm_i8(const void* x, const void* w, const void* xs,
                              const void* s, const void* bias, void* out,
                              int M, int K, int N, int bits, int packed,
                              int kp_rows, int relu, int has_aqt, int out_code,
                              int qmin, int qmax, float mul, float inv,
                              void* stream) {
  return launch<false>(x, w, xs, s, bias, out, M, K, N, bits, packed, kp_rows,
                       relu, has_aqt, out_code, qmin, qmax, mul, inv, stream);
}

// float-activation mode: `x` f32 (M, K); `xs` must be null and `out_code` 0
// (the float mode emits f32 only).
extern "C" int repro_qgemm_f32(const void* x, const void* w, const void* xs,
                               const void* s, const void* bias, void* out,
                               int M, int K, int N, int bits, int packed,
                               int kp_rows, int relu, int has_aqt,
                               int out_code, int qmin, int qmax, float mul,
                               float inv, void* stream) {
  if (xs != nullptr || out_code) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, w, xs, s, bias, out, M, K, N, bits, packed, kp_rows,
                      relu, has_aqt, out_code, qmin, qmax, mul, inv, stream);
}
