// qconv_dw: direct depthwise conv over quantized weights with a fused
// requant epilogue, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `qconv_dw_kernel` in
// src/repro/kernels/qconv_dw/kernel.py (with `_strided_taps`), in both its
// modes: per channel, the kh*kw window taps of the activation times the tap
// rows -- int8 master codes truncated to the W8/W4/W2 view in registers, or
// the split-row packed uint8 buffer (align8(kh*kw)/r, C) unpacked in
// registers -- accumulated in int32 over int8 activation codes, or in f32
// over f32 activations (tap order dy-major then dx, each product and sum
// rounded on its own, as the plain version sums), then the same fused
// scale/bias/ReLU/requant epilogue as qgemm: the scale is applied once after
// the window sum.
//
// What bounds it on this card: a depthwise conv does kh*kw MACs per output
// (9 for 3x3) and has no tensor-core form, so it is bound by bytes: each
// input code is read about kh*kw/(sh*sw) times but from L1/L2, and HBM
// traffic is one read of the activation and one write of the output.  At
// batch 8 the problem is tens of kB and a launch's fixed latency dominates.
//
// What the design does about it: channels go on threads, so neighbouring
// threads read neighbouring bytes of the NHWC plane (coalesced); each thread
// owns (batch, output row, a strip of OWS output columns, channel) and keeps
// its channel's kh*kw taps in registers for the whole strip.  Taps are read
// straight from the unpadded (B, H, W, C) input with bounds checks: an
// out-of-range tap is skipped, which IS the SAME padding (its product with
// the zero pad would add 0: fixed-point codes have no zero point, and in f32
// adding a zero product leaves a sum that starts at +0 unchanged), so the
// host makes no padded copy.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int OWS = 4;         // output columns per thread
constexpr int MAX_TAPS = 64;   // kh*kw bound (the wrapper checks it)

// element types of one mode: activation X, accumulator (and tap) Acc
template <bool kFloat>
struct Mode {
  using X = int8_t;
  using Acc = int;
  static __device__ __forceinline__ Acc mac(Acc acc, Acc a, Acc b) {
    return acc + a * b;
  }
};

template <>
struct Mode<true> {
  using X = float;
  using Acc = float;
  static __device__ __forceinline__ Acc mac(Acc acc, Acc a, Acc b) {
    return __fadd_rn(acc, __fmul_rn(a, b));
  }
};

template <bool kFloat>
__global__ void __launch_bounds__(THREADS)
qconv_dw_kernel(const typename Mode<kFloat>::X* __restrict__ x,
                const void* __restrict__ w, const float* __restrict__ s,
                const float* __restrict__ bias, int8_t* __restrict__ out_code,
                float* __restrict__ out_f, int B, int H, int W, int C, int OH,
                int OW, int kh, int kw, int sh, int sw, int ph, int pw,
                int bits, int packed, int kp_rows, repro::Epilogue e) {
  using X = typename Mode<kFloat>::X;
  using Acc = typename Mode<kFloat>::Acc;
  const int strips = (OW + OWS - 1) / OWS;
  const long long total = static_cast<long long>(B) * OH * strips * C;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  long long t = idx / C;
  const int strip = static_cast<int>(t % strips);
  t /= strips;
  const int oh = static_cast<int>(t % OH);
  const int b = static_cast<int>(t / OH);

  const int taps = kh * kw;
  const int8_t* wi = static_cast<const int8_t*>(w);
  const uint8_t* wu = static_cast<const uint8_t*>(w);
  Acc wv[MAX_TAPS];
  for (int tp = 0; tp < taps; ++tp) {
    int v;
    if (packed) {
      // split-row layout: tap tp is field j of packed row tp - j*kp_rows
      const int j = tp / kp_rows;
      v = repro::unpack_field(
          wu[static_cast<size_t>(tp - j * kp_rows) * C + c], j, bits);
    } else {
      v = repro::truncate_view(wi[static_cast<size_t>(tp) * C + c], bits);
    }
    wv[tp] = static_cast<Acc>(v);
  }
  const float sc = s[c];
  const float bc = e.has_bias ? bias[c] : 0.0f;
  const int ih0 = oh * sh - ph;

  for (int o = 0; o < OWS; ++o) {
    const int ow = strip * OWS + o;
    if (ow >= OW) break;
    const int iw0 = ow * sw - pw;
    Acc acc = Acc(0);
    for (int dy = 0; dy < kh; ++dy) {
      const int ih = ih0 + dy;
      if (ih < 0 || ih >= H) continue;
      const X* row = x + (static_cast<size_t>(b) * H + ih) * W * C;
      for (int dx = 0; dx < kw; ++dx) {
        const int iw = iw0 + dx;
        if (iw < 0 || iw >= W) continue;
        acc = Mode<kFloat>::mac(
            acc, static_cast<Acc>(row[static_cast<size_t>(iw) * C + c]),
            wv[dy * kw + dx]);
      }
    }
    const size_t out = ((static_cast<size_t>(b) * OH + oh) * OW + ow) * C + c;
    if constexpr (kFloat) {
      repro::store_epilogue_f(acc, sc, bc, e, out_code, out_f, out);
    } else {
      repro::store_epilogue(acc, sc, bc, e, out_code, out_f, out);
    }
  }
}

template <bool kFloat>
int launch(const void* x, const void* w, const void* s, const void* bias,
           void* out, int B, int H, int W, int C, int OH, int OW, int kh,
           int kw, int sh, int sw, int ph, int pw, int bits, int packed,
           int kp_rows, int relu, int has_aqt, int out_code, int qmin,
           int qmax, float mul, float inv, void* stream) {
  if (kh * kw > MAX_TAPS) return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(B) * OH * ((OW + OWS - 1) / OWS) * C;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const repro::Epilogue e = repro::make_epilogue(
      relu, bias != nullptr, has_aqt, out_code, qmin, qmax, mul, inv);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  qconv_dw_kernel<kFloat>
      <<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const typename Mode<kFloat>::X*>(x), w,
          static_cast<const float*>(s), static_cast<const float*>(bias),
          out_code ? static_cast<int8_t*>(out) : nullptr,
          out_code ? nullptr : static_cast<float*>(out), B, H, W, C, OH, OW,
          kh, kw, sh, sw, ph, pw, bits, packed, kp_rows, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes).  `w` is int8 (kh*kw, C) tap rows, or
// with `packed` the uint8 (kp_rows, C) split-row buffer; `s` the folded
// per-channel scale (C,), `bias` (C,) or null; `out` int8 or f32
// (B, OH, OW, C).  (ph, pw) are the top/left pads.  Each launches on
// `stream` and returns cudaGetLastError().
//
// int8-activation mode: `x` int8 (B, H, W, C) codes.
extern "C" int repro_qconv_dw_i8(const void* x, const void* w, const void* s,
                                 const void* bias, void* out, int B, int H,
                                 int W, int C, int OH, int OW, int kh, int kw,
                                 int sh, int sw, int ph, int pw, int bits,
                                 int packed, int kp_rows, int relu,
                                 int has_aqt, int out_code, int qmin, int qmax,
                                 float mul, float inv, void* stream) {
  return launch<false>(x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh, sw,
                       ph, pw, bits, packed, kp_rows, relu, has_aqt, out_code,
                       qmin, qmax, mul, inv, stream);
}

// float-activation mode: `x` f32 (B, H, W, C); `out_code` must be 0.
extern "C" int repro_qconv_dw_f32(const void* x, const void* w, const void* s,
                                  const void* bias, void* out, int B, int H,
                                  int W, int C, int OH, int OW, int kh, int kw,
                                  int sh, int sw, int ph, int pw, int bits,
                                  int packed, int kp_rows, int relu,
                                  int has_aqt, int out_code, int qmin,
                                  int qmax, float mul, float inv,
                                  void* stream) {
  if (out_code) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh, sw,
                      ph, pw, bits, packed, kp_rows, relu, has_aqt, out_code,
                      qmin, qmax, mul, inv, stream);
}
