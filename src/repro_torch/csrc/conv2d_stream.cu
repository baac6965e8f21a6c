// conv2d_stream: the streaming line-buffer convolution (SAME padding,
// stride 1) of the stream target, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `conv_kernel` in
// src/repro/kernels/conv2d_stream/kernel.py, the TPU form of the paper's HLS
// CONV actor (Fig. 2: Line Buffer + Conv actor + resident Weight/Bias
// actors).  x is (B, H, W, Cin) NHWC, w (kh, kw, Cin, Cout) HWIO, each f32 or
// bf16 on its own; bias (Cout,) f32 or null; the output (B, H, W, Cout) takes
// x's dtype.  Every output is its kh*kw*Cin products summed in f32 (fused
// multiply-adds, taps dy-major then dx, channels in order), then the bias in
// f32, then one rounding to the output dtype (round to nearest even for
// bf16).  The plain version sums each tap's dot on its own first, so the two
// agree to f32 rounding (the 1e-4 contract), not bit for bit.
//
// What bounds it on this card: a conv does 2*kh*kw*Cin f32 operations per
// output element.  At the stream target's shapes that is about 3 (1x1, Cin
// 8) to 48 (mnist conv2: 3x3, Cin 16, Cout 32) operations per byte of device
// memory moved, against the H100's balance of 67 TFLOP/s f32 (CUDA cores)
// over 3.35 TB/s = 20, so mnist conv2 is bound by operations and the other
// layers by bytes -- and at batch 8 to 32 every layer is well under a MB, so
// what a call costs is latency: the launch, one round of staging loads, and
// the longest chain of dependent instructions any thread runs.  Tensor cores
// (TF32 or bf16 wgmma) would change the arithmetic the reference's 1e-4
// tolerance is stated for, so this kernel stays on CUDA cores in f32.
//
// What the design does about it:
// - One block per (image, R output rows, W tile, Cout tile), the mapping
//   chosen on the host by `stream_tiles` (kernels/conv2d_stream/ops.py):
//   enough blocks to cover the SMs at small batches, R > 1 at larger ones so
//   R + kh - 1 staged rows feed R output rows (the paper's Line Buffer), and
//   W tiles (halo kw - 1) so a row of any width fits: dynamic shared memory
//   up to 227 KB, refused only when one output channel's filter slice plus
//   kh rows of an 8-pixel tile do not fit.
// - Staging with no division per element: the block's filter slice (the
//   resident Weight actor) and its R + kh - 1 input rows, each row one flat
//   run of (tw + kw - 1) * Cin elements whose flat offset alone says whether
//   it lies on the image (SAME edges are written as zeros), copied by
//   16- or 4-byte cp.async units all issued before one wait (bf16 loaded and
//   widened to f32).
// - A register tile per thread: PX pixels x 4 output channels.  Per (tap,
//   input channel) one shared load of x per pixel and one 16-byte load of 4
//   filter values feed PX x 4 independent fused multiply-adds (contraction
//   is off in this build, so every fma is written out), four input channels
//   at a time where Cin allows 16-byte x loads.  1x1 and 3x3 windows are
//   compile-time instances; any other window runs the generic one.
// - Where a call puts few warps on each SM and its sums are long, ks = 2 or
//   4 threads share one register tile, each summing every ks-th input
//   channel (group of 4) of every tap; the partial sums meet in shared
//   memory and are added in group order.  That cuts the chain of dependent
//   fmas a thread runs, which is what the time of such a call follows.
// - The epilogue adds the bias in f32 and rounds once to x's dtype; ragged
//   rows, columns and channels are masked in the kernel.
//
// Measured (chip_smoke.py on an H100 SXM at 700 W; PERF.md section 6): mnist
// conv2 at batch 8 (8x14x14, 16 -> 32 channels, 3x3) takes 0.00448 ms
// against the first port's 0.01141, 21x its 0.000216 ms bound; each of the
// stream target's calls at batch 32 takes 0.41-0.93x the first port's time.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // 227 KB, a block's opt-in maximum
constexpr int SMEM_STATIC = 48 * 1024;

// the mapping `stream_tiles` chose, and the shape
struct Args {
  int H, W, Cin, Cout, kh, kw;
  int R, tw, ct;          // output rows, columns, channels per block
  int ks;                 // thread groups that share one output's sum
  int nrt, nwt;           // row tiles, W tiles
  int x_unit, w_unit;     // elements per staging copy
  int x_bf16, w_bf16;
};

// Visit every (row, unit) cell of an nrows x nunits grid, thread t first,
// then every blockDim.x-th cell: one division per thread, none per cell.
template <typename F>
__device__ __forceinline__ void for_cells(int nrows, int nunits, F&& f) {
  const int nt = static_cast<int>(blockDim.x);
  int r = static_cast<int>(threadIdx.x) / nunits;
  int u = static_cast<int>(threadIdx.x) - r * nunits;
  const int dr = nt / nunits, du = nt - dr * nunits;
  while (r < nrows) {
    f(r, u);
    u += du;
    r += dr;
    if (u >= nunits) {
      u -= nunits;
      ++r;
    }
  }
}

// Stage `unit` consecutive elements from global `src` into f32 shared
// `dst`, or zeros where `ok` is false.  f32 goes by cp.async (a 16-byte unit
// of 4 floats, or one 4-byte float; the caller commits and waits); bf16 is
// loaded as 16, 4 or 2 bytes and widened.  `any` is a valid address for the
// copies that read nothing.
__device__ __forceinline__ void stage_unit(float* dst, const float* src,
                                           const float* any, bool ok,
                                           int unit) {
  if (unit == 4)
    repro::cp_async16(dst, ok ? src : any, ok ? 16 : 0);
  else
    repro::cp_async_small<4>(dst, ok ? src : any, ok);
}
__device__ __forceinline__ void stage_unit(float* dst,
                                           const __nv_bfloat16* src,
                                           const __nv_bfloat16*, bool ok,
                                           int unit) {
  if (unit == 8) {
    const uint4 v =
        ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(__low2float(h[0]), __high2float(h[0]), __low2float(h[1]),
                    __high2float(h[1]));
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(__low2float(h[2]), __high2float(h[2]), __low2float(h[3]),
                    __high2float(h[3]));
  } else if (unit == 2) {
    const __nv_bfloat162 v = ok ? *reinterpret_cast<const __nv_bfloat162*>(src)
                                : __floats2bfloat162_rn(0.0f, 0.0f);
    dst[0] = __low2float(v);
    dst[1] = __high2float(v);
  } else {
    dst[0] = ok ? __bfloat162float(*src) : 0.0f;
  }
}

// the filter slice (kh*kw*Cin rows of ct channels from c0, zero past Cout)
template <typename T>
__device__ __forceinline__ void stage_filter(float* wsm, const T* w, int taps,
                                             int Cout, int ct, int c0,
                                             int unit) {
  for_cells(taps, ct / unit, [&](int tc, int u) {
    const int cc = u * unit;
    stage_unit(wsm + tc * ct + cc, w + static_cast<size_t>(tc) * Cout + c0 + cc,
               w, c0 + cc < Cout, unit);
  });
}

// the nr input rows from ih0 of image b, each the flat run of lp elements
// that starts at flat offset g0 of the row (column ow0 - kw/2)
template <typename T>
__device__ __forceinline__ void stage_rows(float* line, const T* x, int b,
                                           int ih0, int nr, int lp, int g0,
                                           int H, int rowlen, int unit) {
  const T* img = x + static_cast<size_t>(b) * H * rowlen;
  for_cells(nr, lp / unit, [&](int r, int u) {
    const int e = u * unit;
    const int ih = ih0 + r;
    const int g = g0 + e;
    const bool ok = ih >= 0 && ih < H && g >= 0 && g < rowlen;
    stage_unit(line + r * lp + e,
               ok ? img + static_cast<size_t>(ih) * rowlen + g : x, x, ok,
               unit);
  });
}

template <int CO>
__device__ __forceinline__ void load_w(const float* p, float (&v)[CO]) {
  if constexpr (CO == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < CO; ++c) v[c] = p[c];
  }
}

// KH, KW: the window at compile time (0: the generic runtime window); PX
// output pixels x CO output channels per thread; CIV input channels per
// shared load of x (4: 16-byte loads, Cin % 4 == 0); SPLIT: a.ks threads
// share each register tile's sum (one pixel a thread).
template <int KH, int KW, int PX, int CO, int CIV, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
conv2d_stream_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                     const float* __restrict__ bias, void* __restrict__ outv,
                     const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int kh = KH ? KH : a.kh;
  const int kw = KW ? KW : a.kw;
  const int Cin = a.Cin, ct = a.ct, tw = a.tw;
  const int lp = (tw + kw - 1) * Cin;         // a staged row, flat
  const int nr = a.R + kh - 1;                // staged rows
  float* wsm = smem;                          // (kh*kw*Cin, ct)
  float* line = smem + kh * kw * Cin * ct;    // (nr, lp)

  // block -> (image, row tile, W tile); blockIdx.y -> Cout tile
  int bx = blockIdx.x;
  const int wt = bx % a.nwt;
  bx /= a.nwt;
  const int rt = bx % a.nrt;
  const int b = bx / a.nrt;
  const int oh0 = rt * a.R, ow0 = wt * tw, c0 = blockIdx.y * ct;

  // Weight actor and Line Buffer: every copy issued, then one wait
  if (a.w_bf16)
    stage_filter(wsm, static_cast<const __nv_bfloat16*>(wv), kh * kw * Cin,
                 a.Cout, ct, c0, a.w_unit);
  else
    stage_filter(wsm, static_cast<const float*>(wv), kh * kw * Cin, a.Cout,
                 ct, c0, a.w_unit);
  const int rowlen = a.W * Cin;
  const int g0 = (ow0 - kw / 2) * Cin;
  if (a.x_bf16)
    stage_rows(line, static_cast<const __nv_bfloat16*>(xv), b, oh0 - kh / 2,
               nr, lp, g0, a.H, rowlen, a.x_unit);
  else
    stage_rows(line, static_cast<const float*>(xv), b, oh0 - kh / 2, nr, lp,
               g0, a.H, rowlen, a.x_unit);
  repro::cp_async_commit();
  repro::cp_async_wait_all();
  __syncthreads();

  // Conv actor: thread -> (split group ks, pixel group, channel group);
  // the pixel group's PX pixels are pg, pg + npg, ... of the block's R x tw
  // outputs, and split group ks sums input channels ks, ks + a.ks, ... (in
  // units of CIV) of every tap
  const int ncg = ct / CO;
  const int npix = a.R * tw;
  const int npg = (npix + PX - 1) / PX;
  const int grp = npg * ncg;                  // threads of one split group
  const int ks = static_cast<int>(threadIdx.x) / grp;
  const int rest = static_cast<int>(threadIdx.x) - ks * grp;
  const int pg = rest / ncg;
  const int cg = rest - pg * ncg;
  const bool active = ks < (SPLIT ? a.ks : 1);
  if (!SPLIT && !active) return;
  int off[PX];            // the pixel's window origin in the line buffer
  int opix[PX];           // its output pixel (b, oh, ow) flat, -1 if none
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int q = pg + j * npg;
    const int orow = q / tw;
    const int ocol = q - orow * tw;
    const bool ok = q < npix && oh0 + orow < a.H && ow0 + ocol < a.W;
    off[j] = ok ? orow * lp + ocol * Cin : 0;
    opix[j] = ok ? (b * a.H + oh0 + orow) * a.W + ow0 + ocol : -1;
  }

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[j][c] = 0.0f;

  const float* wc = wsm + cg * CO;
  // an idle thread of a split block sums nothing but meets the barrier
  const int ci0 = SPLIT ? (active ? ks * CIV : Cin) : 0;
  const int cstep = SPLIT ? CIV * a.ks : CIV;
#pragma unroll
  for (int dy = 0; dy < kh; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kw; ++dx) {
      const float* wt_ = wc + (dy * kw + dx) * Cin * ct;
      const float* xt = line + dy * lp + dx * Cin;
      if constexpr (CIV == 4) {
        for (int ci = ci0; ci < Cin; ci += cstep) {
          float4 xq[PX];
#pragma unroll
          for (int j = 0; j < PX; ++j)
            xq[j] = *reinterpret_cast<const float4*>(xt + off[j] + ci);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float wr[CO];
            load_w<CO>(wt_ + (ci + k) * ct, wr);
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float xs = k == 0   ? xq[j].x
                               : k == 1 ? xq[j].y
                               : k == 2 ? xq[j].z
                                        : xq[j].w;
#pragma unroll
              for (int c = 0; c < CO; ++c)
                acc[j][c] = __fmaf_rn(xs, wr[c], acc[j][c]);
            }
          }
        }
      } else {
        for (int ci = ci0; ci < Cin; ci += cstep) {
          float wr[CO];
          load_w<CO>(wt_ + ci * ct, wr);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float xs = xt[off[j] + ci];
#pragma unroll
            for (int c = 0; c < CO; ++c)
              acc[j][c] = __fmaf_rn(xs, wr[c], acc[j][c]);
          }
        }
      }
    }
  }

  // split groups 1.. hand their partial sums to group 0, which adds them
  // in group order
  if constexpr (SPLIT) {
    float* red = line + nr * lp;              // ((ks-1)*PX*CO, grp)
    if (active && ks > 0) {
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int c = 0; c < CO; ++c)
          red[(((ks - 1) * PX + j) * CO + c) * grp + rest] = acc[j][c];
    }
    __syncthreads();
    if (ks != 0) return;
    for (int s = 1; s < a.ks; ++s) {
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int c = 0; c < CO; ++c)
          acc[j][c] =
              __fadd_rn(acc[j][c], red[(((s - 1) * PX + j) * CO + c) * grp + rest]);
    }
  }

  // epilogue: + bias in f32, one rounding to x's dtype, ragged edges masked
  const int cb = c0 + cg * CO;
  float bv[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c)
    bv[c] = bias != nullptr && cb + c < a.Cout ? bias[cb + c] : 0.0f;
  const bool vec = CO == 4 && !a.x_bf16 && a.Cout % 4 == 0 && cb < a.Cout;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    if (opix[j] < 0) continue;
    float v[CO];
#pragma unroll
    for (int c = 0; c < CO; ++c)
      v[c] = bias != nullptr ? __fadd_rn(acc[j][c], bv[c]) : acc[j][c];
    const size_t o = static_cast<size_t>(opix[j]) * a.Cout + cb;
    if (vec) {
      *reinterpret_cast<float4*>(static_cast<float*>(outv) + o) =
          make_float4(v[0], v[CO > 1 ? 1 : 0], v[CO > 2 ? 2 : 0],
                      v[CO > 3 ? 3 : 0]);
    } else if (a.x_bf16) {
#pragma unroll
      for (int c = 0; c < CO; ++c)
        if (cb + c < a.Cout)
          static_cast<__nv_bfloat16*>(outv)[o + c] = __float2bfloat16_rn(v[c]);
    } else {
#pragma unroll
      for (int c = 0; c < CO; ++c)
        if (cb + c < a.Cout) static_cast<float*>(outv)[o + c] = v[c];
    }
  }
}

using KernelFn = void (*)(const void*, const void*, const float*, void*,
                          const Args);

template <int KH, int KW, int PX, bool SPLIT>
KernelFn pick_civ(int civ) {
  return civ == 4 ? conv2d_stream_kernel<KH, KW, PX, 4, 4, SPLIT>
                  : conv2d_stream_kernel<KH, KW, PX, 4, 1, SPLIT>;
}

template <int KH, int KW>
KernelFn pick_px(int px, int civ, int ks) {
  if (ks > 1) return px == 1 ? pick_civ<KH, KW, 1, true>(civ) : nullptr;
  switch (px) {
    case 1: return pick_civ<KH, KW, 1, false>(civ);
    case 2: return pick_civ<KH, KW, 2, false>(civ);
    case 4:  // the generic window has no 4-pixel instance (it would spill)
      if constexpr (KH != 0) return pick_civ<KH, KW, 4, false>(civ);
      return nullptr;
    default: return nullptr;
  }
}

// the instance for a window code (1: 1x1, 3: 3x3, 0: generic), pixels and
// channels per thread, input channels per load and split groups; null if
// there is none: one channel a thread runs only the generic window, one
// pixel, scalar loads and no split, and a split only one pixel a thread
KernelFn pick_kernel(int window, int px, int co, int civ, int ks) {
  if (co == 1)
    return px == 1 && civ == 1 && window == 0 && ks == 1
               ? conv2d_stream_kernel<0, 0, 1, 1, 1, false>
               : nullptr;
  if (co != 4 || (civ != 1 && civ != 4) || ks < 1) return nullptr;
  switch (window) {
    case 1: return pick_px<1, 1>(px, civ, ks);
    case 3: return pick_px<3, 3>(px, civ, ks);
    case 0: return pick_px<0, 0>(px, civ, ks);
    default: return nullptr;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// whether `unit` elements per staging copy is one that stage_unit has:
// 4 or 1 of f32, 8, 2 or 1 of bf16 x, 1 of bf16 w
bool unit_ok(int unit, int bf16, bool is_x) {
  if (!bf16) return unit == 4 || unit == 1;
  return unit == 1 || (is_x && (unit == 2 || unit == 8));
}

}  // namespace

// C entry point (bound with ctypes).  `x_bf16` / `w_bf16` say whether x / w
// (and so the output, which takes x's dtype) are bf16 rather than f32;
// `bias` is f32 (Cout,) or null.  The mapping (rows, tw, ct, px, co, ks,
// window, ci_vec, x_unit, w_unit, threads, smem_bytes) is the one
// `stream_tiles` returns, the one place its threads and shared memory are
// worked out; this entry refuses, with cudaErrorInvalidValue, a mapping
// that has no instance, staging units this dtype has no copy for, or a
// block past the hardware's 256 threads or 227 KB.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_conv2d_stream(const void* x, const void* w,
                                   const void* bias, void* out, int B, int H,
                                   int W, int Cin, int Cout, int kh, int kw,
                                   int x_bf16, int w_bf16, int rows, int tw,
                                   int ct, int px, int co, int ks, int window,
                                   int ci_vec, int x_unit, int w_unit,
                                   int threads, int smem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0)
    return static_cast<int>(cudaGetLastError());
  const KernelFn fn = pick_kernel(window, px, co, ci_vec, ks);
  const bool window_ok = window == 0 || (kh == window && kw == window);
  if (fn == nullptr || !window_ok || Cin <= 0 || kh <= 0 || kw <= 0 ||
      rows <= 0 || tw <= 0 || ct <= 0 || ct % co != 0 || ks <= 0 ||
      ks * ci_vec > Cin || !unit_ok(x_unit, x_bf16, true) ||
      !unit_ok(w_unit, w_bf16, false) || Cin % x_unit != 0 ||
      Cin % ci_vec != 0 || ct % w_unit != 0 || threads <= 0 ||
      threads > MAX_THREADS || smem_bytes <= 0 || smem_bytes > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > SMEM_STATIC) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args a{H,  W,  Cin,    Cout,   kh,     kw,
               rows, tw, ct, ks, ceil_div(H, rows), ceil_div(W, tw),
               x_unit, w_unit, x_bf16, w_bf16};
  const dim3 grid(B * a.nrt * a.nwt, ceil_div(Cout, ct));
  fn<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w, static_cast<const float*>(bias), out, a);
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread of an instance takes and how many of its blocks
// one SM holds at once with `threads` threads and `smem_bytes` of dynamic
// shared memory (the CUDA occupancy calculator).
extern "C" int repro_conv2d_stream_info(int window, int px, int co,
                                        int ci_vec, int ks, int threads,
                                        int smem_bytes, int* registers,
                                        int* blocks_per_sm) {
  const KernelFn fn = pick_kernel(window, px, co, ci_vec, ks);
  if (fn == nullptr || smem_bytes > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  if (smem_bytes > SMEM_STATIC) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads, smem_bytes));
}
