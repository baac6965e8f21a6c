// qconv_dw: direct depthwise conv over quantized weights with a fused
// requant epilogue, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `qconv_dw_kernel` in
// src/repro/kernels/qconv_dw/kernel.py (with `_strided_taps`), in both its
// modes: per channel, the kh*kw window taps of the activation times the tap
// rows -- int8 master codes truncated to the W8/W4/W2 view, or the split-row
// packed uint8 buffer (align8(kh*kw)/r, C) unpacked -- accumulated in int32
// over int8 activation codes, or in f32 over f32 activations (tap order
// dy-major then dx, each product and sum rounded on its own, as the plain
// version sums), then the same fused scale/bias/ReLU/requant epilogue as
// qgemm: the scale is applied once after the window sum.
//
// What bounds it on this card: a depthwise conv does kh*kw MACs per output
// (9 for 3x3) and has no tensor-core form, so its bound is bytes: one read
// of the activation and one write of the output.  At batch 8 the problem is
// tens of kB, well under a microsecond of HBM time, so what a call pays is
// latency: the launch, one trip to memory, and each thread's chain of loads.
//
// What the design does about it: a block owns one output row of one image,
// a band of up to 64 output columns and a tile of up to 64 channels (both
// chosen on the host: by default every column and channel of a row, halved
// until they fit in shared memory; a timed sweep may choose narrower ones),
// so dw0's 8 x 14 output rows give 112 blocks to spread over the SMs.  It
//   * makes the channel tile's tap view (truncated with integer arithmetic,
//     or unpacked) once into shared memory, instead of once per thread, and
//     fetches each thread's scale and bias, while the input copies fly;
//   * stages the kh input rows x the band's input columns x the channel tile
//     in shared memory with one coalesced pass of 16-, 8- or 4-byte cp.async
//     copies (the widest that the channel pitch allows; all of a thread's
//     copies in flight at once), the SAME halo filled with zeros -- a zero
//     product adds nothing to an integer sum, and to an f32 sum that starts
//     at +0 it adds a zero that leaves the sum unchanged, so the plain
//     version's padded sum is reproduced bit for bit and the host makes no
//     padded copy;
//   * gives each thread 4 consecutive channels (char4 / float4 operands;
//     one channel where C % 4 != 0) for one output column at a time, with
//     the 3x3 window -- the only one either CNN uses -- a template whose 9 x
//     4 taps sit in registers, unrolled; every other window the wrapper
//     accepts runs a generic instance that reads its taps from shared
//     memory (no per-thread tap array in local memory);
//   * stores 4 int8 codes as one 32-bit word, or 4 floats as one float4.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int MAX_TAPS = 64;      // kh*kw bound (the wrapper checks it)
constexpr int MAX_THREADS = 256;
constexpr int MAX_CT = 64;        // channels per block
constexpr int MAX_OWB = 64;       // output columns per block
constexpr int SMEM_BUDGET = 48 * 1024;

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

// VEC consecutive channels from shared memory, widened to the accumulator
template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

// a 2- or 1-byte staging unit (too narrow for cp.async), or zeros where the
// source is off the image
template <typename T>
__device__ __forceinline__ void copy_as(void* dst, const void* src, bool ok) {
  *static_cast<T*>(dst) = ok ? *static_cast<const T*>(src) : T{};
}

__host__ __device__ __forceinline__ int tap_bytes(int taps, int ct) {
  return (taps * ct * 4 + 15) & ~15;
}

// KH = KW = 0: the generic instance (runtime kh, kw)
template <bool kFloat, int KH, int KW, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
qconv_dw_kernel(const typename Mode<kFloat>::X* __restrict__ x,
                const void* __restrict__ w, const float* __restrict__ s,
                const float* __restrict__ bias, int8_t* __restrict__ out_code,
                float* __restrict__ out_f, int H, int W, int C, int OH,
                int OW, int kh_rt, int kw_rt, int sh, int sw, int ph, int pw,
                int bits, int packed, int kp_rows, int ct, int owb, int ub,
                repro::Epilogue e) {
  using X = typename Mode<kFloat>::X;
  using Acc = typename Mode<kFloat>::Acc;
  const int kh = KH > 0 ? KH : kh_rt;
  const int kw = KW > 0 ? KW : kw_rt;
  const int taps = kh * kw;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* wsm = reinterpret_cast<Acc*>(smem);                       // [taps][ct]
  X* slab = reinterpret_cast<X*>(smem + tap_bytes(taps, ct));    // [kh][wt][ct]

  const int b = blockIdx.x / OH, oh = blockIdx.x - b * OH;
  const int ow0 = blockIdx.y * owb, c0 = blockIdx.z * ct;
  const int nc = min(ct, C - c0);
  const int ncol = min(owb, OW - ow0);
  const int wt = (ncol - 1) * sw + kw;     // staged input columns
  const int ih0 = oh * sh - ph, iw0 = ow0 * sw - pw;
  const int tid = threadIdx.x, nthr = blockDim.x;

  // the input slab: kh rows x wt columns x nc channels, zero off the image;
  // 16-, 8- and 4-byte units go by cp.async, so a thread's copies fly
  // together
  const int ue = ub / static_cast<int>(sizeof(X));   // elements per unit
  const int upp = nc / ue;                           // units per pixel
  for (int i = tid; i < kh * wt * upp; i += nthr) {
    const int pix = i / upp, u = i - pix * upp;
    const int r = pix / wt, cc = pix - r * wt;
    const int ih = ih0 + r, iw = iw0 + cc;
    const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
    const X* src =
        ok ? x + ((static_cast<size_t>(b) * H + ih) * W + iw) * C + c0 + u * ue
           : x;
    X* dst = slab + static_cast<size_t>(pix) * ct + u * ue;
    switch (ub) {
      case 16: repro::cp_async16(dst, src, ok ? 16 : 0); break;
      case 8: repro::cp_async_small<8>(dst, src, ok); break;
      case 4: repro::cp_async_small<4>(dst, src, ok); break;
      case 2: copy_as<unsigned short>(dst, src, ok); break;
      default: copy_as<unsigned char>(dst, src, ok); break;
    }
  }
  repro::cp_async_commit();

  // this thread's channels and their epilogue operands, fetched while the
  // copies fly
  const int G = ct / VEC;
  const int c = (tid % G) * VEC;
  float sc[VEC], bc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const bool in = c + v < nc;
    sc[v] = in ? s[c0 + c + v] : 0.0f;
    bc[v] = in && e.has_bias ? bias[c0 + c + v] : 0.0f;
  }

  // the channel tile's tap view, once per block
  const int8_t* wi = static_cast<const int8_t*>(w);
  const uint8_t* wu = static_cast<const uint8_t*>(w);
  for (int i = tid; i < taps * nc; i += nthr) {
    const int tp = i / nc, cw = i - tp * nc;
    int v;
    if (packed) {
      // split-row layout: tap tp is field j of packed row tp - j*kp_rows
      const int j = (tp >= kp_rows) + (tp >= 2 * kp_rows) +
                    (tp >= 3 * kp_rows);
      v = repro::unpack_field(
          wu[static_cast<size_t>(tp - j * kp_rows) * C + c0 + cw], j, bits);
    } else {
      v = repro::truncate_view(wi[static_cast<size_t>(tp) * C + c0 + cw],
                               bits);
    }
    wsm[tp * ct + cw] = static_cast<Acc>(v);
  }
  repro::cp_async_wait_all();
  __syncthreads();

  if (c >= nc) return;
  const int cstep = nthr / G;
  Acc wv[KH > 0 ? KH * KW : 1][VEC];
  if constexpr (KH > 0) {
#pragma unroll
    for (int tp = 0; tp < KH * KW; ++tp)
      load_vec<VEC>(wsm + tp * ct + c, wv[tp]);
  }

  for (int o = tid / G; o < ncol; o += cstep) {
    Acc acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = Acc(0);
    const X* base = slab + static_cast<size_t>(o) * sw * ct + c;
    if constexpr (KH > 0) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          Acc xv[VEC];
          load_vec<VEC>(base + (dy * wt + dx) * ct, xv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = Mode<kFloat>::mac(acc[v], xv[v], wv[dy * KW + dx][v]);
        }
    } else {
      for (int dy = 0; dy < kh; ++dy)
        for (int dx = 0; dx < kw; ++dx) {
          Acc xv[VEC], tv[VEC];
          load_vec<VEC>(base + (dy * wt + dx) * ct, xv);
          load_vec<VEC>(wsm + (dy * kw + dx) * ct + c, tv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = Mode<kFloat>::mac(acc[v], xv[v], tv[v]);
        }
    }
    const size_t out =
        ((static_cast<size_t>(b) * OH + oh) * OW + ow0 + o) * C + c0 + c;
    float y[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float a;
      if constexpr (kFloat) {
        a = acc[v];
      } else {
        a = __int2float_rn(acc[v]);
      }
      y[v] = repro::epilogue_value(a, sc[v], bc[v], e);
    }
    if constexpr (VEC == 4) {
      if (e.out_code) {
        unsigned word = 0;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          word |= (static_cast<unsigned>(__float2int_rn(y[v])) & 0xffu)
                  << (8 * v);
        *reinterpret_cast<unsigned*>(out_code + out) = word;
      } else {
        *reinterpret_cast<float4*>(out_f + out) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
    } else {
      if (e.out_code) {
        out_code[out] = static_cast<int8_t>(__float2int_rn(y[0]));
      } else {
        out_f[out] = y[0];
      }
    }
  }
}

int rc() { return static_cast<int>(cudaGetLastError()); }

template <bool kFloat, int VEC>
int run(const void* x, const void* w, const void* s, const void* bias,
        void* out, int B, int H, int W, int C, int OH, int OW, int kh, int kw,
        int sh, int sw, int ph, int pw, int bits, int packed, int kp_rows,
        int ct, int owb, int ub, size_t smem, const repro::Epilogue& e,
        cudaStream_t stream) {
  using X = typename Mode<kFloat>::X;
  // a thread per (channel group, output column); at least 64 threads, so
  // a narrow tile's staging is spread wider (the extra threads only stage)
  const int G = ct / VEC;
  int cpp = MAX_THREADS / G;
  if (cpp > owb) cpp = owb;
  if (G * cpp < 64) cpp = (64 + G - 1) / G;
  if (cpp < 1) cpp = 1;
  const dim3 grid(B * OH, (OW + owb - 1) / owb, (C + ct - 1) / ct);
  const dim3 block(G * cpp);
  int8_t* oc = e.out_code ? static_cast<int8_t*>(out) : nullptr;
  float* of = e.out_code ? nullptr : static_cast<float*>(out);
  const X* xp = static_cast<const X*>(x);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(bias);
  if (kh == 3 && kw == 3) {
    qconv_dw_kernel<kFloat, 3, 3, VEC><<<grid, block, smem, stream>>>(
        xp, w, sp, bp, oc, of, H, W, C, OH, OW, kh, kw, sh, sw, ph, pw, bits,
        packed, kp_rows, ct, owb, ub, e);
  } else {
    qconv_dw_kernel<kFloat, 0, 0, VEC><<<grid, block, smem, stream>>>(
        xp, w, sp, bp, oc, of, H, W, C, OH, OW, kh, kw, sh, sw, ph, pw, bits,
        packed, kp_rows, ct, owb, ub, e);
  }
  return rc();
}

template <bool kFloat>
int launch(const void* x, const void* w, const void* s, const void* bias,
           void* out, int B, int H, int W, int C, int OH, int OW, int kh,
           int kw, int sh, int sw, int ph, int pw, int bits, int packed,
           int kp_rows, int relu, int has_aqt, int out_code, int qmin,
           int qmax, int ct, int owb, float mul, float inv, void* stream) {
  const int taps = kh * kw;
  if (kh <= 0 || kw <= 0 || taps > MAX_TAPS || sh <= 0 || sw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || OH <= 0 || OW <= 0 || C <= 0) return rc();
  const int esz = kFloat ? 4 : 1;
  const int vec = C % 4 == 0 ? 4 : 1;
  // the tiles come from the host (kernels/qconv_dw/ops.py, `dw_tiles` or a
  // timed `pick_blocks_dw`): a channel tile of whole vectors up to MAX_CT,
  // a band of up to MAX_OWB output columns, the taps and the input slab
  // within SMEM_BUDGET
  if (ct < vec || ct > MAX_CT || ct % vec != 0 || owb < 1 || owb > MAX_OWB)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(tap_bytes(taps, ct)) +
      static_cast<size_t>(kh) * ((owb - 1) * sw + kw) * ct * esz;
  if (smem > SMEM_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  // the widest staging copy the channel pitch, the tile and x allow
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int ub = esz;
  for (int cand = 16; cand > esz; cand /= 2)
    if ((C * esz) % cand == 0 && (ct * esz) % cand == 0 && xa % cand == 0) {
      ub = cand;
      break;
    }
  const repro::Epilogue e = repro::make_epilogue(
      relu, bias != nullptr, has_aqt, out_code, qmin, qmax, mul, inv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return run<kFloat, 4>(x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh,
                          sw, ph, pw, bits, packed, kp_rows, ct, owb, ub, smem,
                          e, st);
  return run<kFloat, 1>(x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh,
                        sw, ph, pw, bits, packed, kp_rows, ct, owb, ub, smem,
                        e, st);
}

}  // namespace

// C entry points (bound with ctypes).  `w` is int8 (kh*kw, C) tap rows, or
// with `packed` the uint8 (kp_rows, C) split-row buffer; `s` the folded
// per-channel scale (C,), `bias` (C,) or null; `out` int8 or f32
// (B, OH, OW, C).  (ph, pw) are the top/left pads; `ct` channels and `owb`
// output columns of one output row make a block.  Each launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for a window past 64
// taps, or tiles the kernel does not take: `ct` not a whole number of
// channel vectors -- 4 channels where C % 4 == 0, else 1 -- or past 64,
// `owb` outside 1..64, or tiles whose taps and input slab pass 48 KB).
//
// int8-activation mode: `x` int8 (B, H, W, C) codes.
extern "C" int repro_qconv_dw_i8(const void* x, const void* w, const void* s,
                                 const void* bias, void* out, int B, int H,
                                 int W, int C, int OH, int OW, int kh, int kw,
                                 int sh, int sw, int ph, int pw, int bits,
                                 int packed, int kp_rows, int relu,
                                 int has_aqt, int out_code, int qmin, int qmax,
                                 int ct, int owb, float mul, float inv,
                                 void* stream) {
  return launch<false>(x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh, sw,
                       ph, pw, bits, packed, kp_rows, relu, has_aqt, out_code,
                       qmin, qmax, ct, owb, mul, inv, stream);
}

// float-activation mode: `x` f32 (B, H, W, C); `out_code` must be 0.
extern "C" int repro_qconv_dw_f32(const void* x, const void* w, const void* s,
                                  const void* bias, void* out, int B, int H,
                                  int W, int C, int OH, int OW, int kh, int kw,
                                  int sh, int sw, int ph, int pw, int bits,
                                  int packed, int kp_rows, int relu,
                                  int has_aqt, int out_code, int qmin,
                                  int qmax, int ct, int owb, float mul,
                                  float inv, void* stream) {
  if (out_code) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, w, s, bias, out, B, H, W, C, OH, OW, kh, kw, sh, sw,
                      ph, pw, bits, packed, kp_rows, relu, has_aqt, out_code,
                      qmin, qmax, ct, owb, mul, inv, stream);
}
