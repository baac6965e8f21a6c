// qgemm: quantized-weight GEMM with a fused requant epilogue, for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel `qgemm_kernel` in
// src/repro/kernels/qmatmul/kernel.py (with its helpers `_truncate` and
// `_unpack_fields`), in both its modes.  The weight is either the int8 master
// codes (K, N), truncated to the active W8/W4/W2 view, or the split-row
// packed uint8 buffer (K'/r, N), r = 8/bits, unpacked.
//
// * int8-activation mode: int8 activation codes (M, K), int32 accumulation
//   on the tensor cores (mma.sync m16n8k32 s8.s8.s32), and optionally a
//   per-row activation scale xs (M,) applied to the accumulator before the
//   channel scale (acc * xs[m] * s[n], the oracle's order); without it the
//   scalar activation scale is folded into s.  Integer sums do not depend on
//   their order, so this mode is bit-exact against the plain version.
// * float-activation mode: f32 activations (M, K) times the integer codes as
//   f32, accumulated in f32 on CUDA cores (each product and sum rounded on
//   its own).  The TPU kernel casts the activations to bf16 to feed its MXU;
//   this one keeps them f32, since a 16-bit fixed-point activation does not
//   fit bf16's 8 significant bits, nor TF32's 11.
//
// Both modes end in the same epilogue (epilogue.cuh): the per-channel scale
// (sub-byte step folded in on the host), bias, ReLU and fixed-point requant,
// storing int8 codes (int8 mode only) or f32.
//
// What bounds it on this card: at the widths this port serves (the CNN
// slice: K = 8..1568, N = 8..32, M = batch x spatial positions) a call moves
// tens to hundreds of kB and does a few int8 operations per byte, so its
// bound is bytes over HBM bandwidth -- well under a microsecond -- and what
// a call really pays is latency: one launch, one or two trips to memory, and
// the serial chain of whatever a single CTA has to do alone.
//
// What the design does about it: every CTA makes one trip to memory.  It
// issues all its copies of x and of the raw weight rows at once (cp.async
// 16-byte units, which do not stall the issuing thread, so a thread's copies
// fly together instead of one dependent load after another), waits once,
// truncates or unpacks the weight in shared memory, multiplies, and runs the
// epilogue with the scale and bias it fetched into registers while the
// copies flew.  The host (kernels/qmatmul/ops.py, `pick_tiles`) picks one of
// two mappings and passes its tiles in:
//
// * skinny (M <= 64, long K; the classifier FC, 8 x 1568 x 10): where a
//   tiled grid would leave one CTA to walk all of K, a cluster of 8 CTAs on
//   neighbouring SMs splits K, and each CTA splits its share across its 8
//   warps.  A CTA stages its K range at once (a chunk loop only where it
//   does not fit in 96 KB); each warp takes every 8th 32-wide step and
//   builds its weight operands from the raw rows in registers (each element
//   truncated or unpacked once), M padded to 16 in registers in the int8
//   mode.  The warps' partial sums meet in the CTA's shared memory, the
//   CTAs' in the first CTA through the cluster's distributed shared memory
//   (Hopper's DSMEM), which adds them in rank order and runs the epilogue:
//   one launch, no workspace, no atomics.
// * tiled (everything else): a CTA of 128 threads owns a BM x BN output tile,
//   BN fitted to N (8, 16, 32 or 64), so the short-N layers mask little, and
//   BM chosen so that enough CTAs exist to spread over the SMs.  It stages
//   every k step of its tile at once where they fit in 48 KB (all path
//   shapes: K <= 144): x by 16-byte units where K allows, else -- K = 9, one
//   step -- the tile's rows as one contiguous block spread into 32-wide rows
//   in shared memory; the weight steps truncated or unpacked once per tile
//   into shared memory.  The int8 mode runs m16n8k32 MMAs, one warp per 16
//   rows.  The float mode keeps a CUDA-core tile (one row and 4 columns a
//   thread, BM = 512 / BN) whose k step is fitted to K (8, 16 or 32).
//   Chunks of k steps that do not fit are loaded one after another, not
//   double-buffered: no path shape has more than one.
//
// Tensor cores through mma.sync rather than wgmma: every path call has
// N <= 32 and K <= 1,568, where one CTA's MMA work is a few hundred
// instructions and the call is bound by latency, not by tensor throughput;
// mma.sync's 16x8x32 tiles fit N = 8..32 and M = 8 without a 64-row
// warpgroup tile or the swizzled shared-memory descriptors wgmma needs.
//
// The reduction order both mappings walk: a weight buffer has P rows and
// R = 1 (master codes, P = K) or R = 8/bits (split-row packed: field j of
// row p holds reduction index k = p + j*P) -- so for each field j in turn,
// steps of consecutive rows p, each reading contiguous weight rows and the
// contiguous activation columns k = j*P + p.  Rows past K are never read.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

// element types of one mode: activation X, accumulator Acc
template <bool kFloat>
struct Mode {
  using X = int8_t;
  using Acc = int;
};

template <>
struct Mode<true> {
  using X = float;
  using Acc = float;
};

// -- the reduction order ------------------------------------------------------

// rows of field j that hold a reduction index below K
__host__ __device__ __forceinline__ int field_rows(int K, int P, int j) {
  const int r = K - j * P < P ? K - j * P : P;
  return r > 0 ? r : 0;
}

__host__ __device__ __forceinline__ int total_steps(int K, int P, int R,
                                                    int width) {
  int t = 0;
  for (int j = 0; j < R; ++j) t += (field_rows(K, P, j) + width - 1) / width;
  return t;
}

struct Step {
  int j;     // field
  int p0;    // first weight row
  int rows;  // rows of field j below K: row p is valid iff p < rows
};

__device__ __forceinline__ Step step_at(int q, int K, int P, int R,
                                        int width) {
  for (int j = 0; j < R; ++j) {
    const int rows = field_rows(K, P, j);
    const int n = (rows + width - 1) / width;
    if (q < n) return Step{j, q * width, rows};
    q -= n;
  }
  return Step{0, 0, 0};
}

// the weight's integer view at one byte: field j of a packed byte, or the
// truncated master code
__device__ __forceinline__ int weight_value(uint8_t byte, int j, int bits,
                                            int packed) {
  return packed ? repro::unpack_field(byte, j, bits)
                : repro::truncate_view(static_cast<int8_t>(byte), bits);
}

__host__ __device__ __forceinline__ int align16(int n) {
  return (n + 15) & ~15;
}

// How a CTA stages the activation columns of its k steps
enum AMode {
  kAVec = 0,    // 16-byte cp.async straight into the tile: K and the packed
                // row count are multiples of 16 bytes' worth of elements
  kAWhole = 1,  // one step holds all of K: the tile's rows are one
                // contiguous block, copied with cp.async, then spread into
                // the tile's rows in shared memory
  kAElem = 2,   // element loads (any other K)
};

template <bool kFloat>
__device__ __forceinline__ void store_out(typename Mode<kFloat>::Acc acc,
                                          int gm, int gn, int N,
                                          const float* __restrict__ xs,
                                          float s, float b,
                                          const repro::Epilogue& e,
                                          int8_t* __restrict__ out_code,
                                          float* __restrict__ out_f) {
  const size_t idx = static_cast<size_t>(gm) * N + gn;
  if constexpr (kFloat) {
    repro::store_epilogue_f(acc, s, b, e, out_code, out_f, idx);
  } else if (xs != nullptr) {
    // per-row activation scale: (acc * xs[m]) * s[n], two roundings
    repro::store_epilogue_f(__fmul_rn(__int2float_rn(acc), xs[gm]), s, b, e,
                            out_code, out_f, idx);
  } else {
    repro::store_epilogue(acc, s, b, e, out_code, out_f, idx);
  }
}

__device__ __forceinline__ unsigned ld32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a (16x32, row-major s8) * b (32x8, column-major s8), int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the raw weight rows of steps q0 .. q0+ns-1 with cp.async: step si's
// `width` rows (those below K) land at raw + si*width*N, spread over the
// block's threads in 16-byte units.  Needs N <= the tile's BN (the rows are
// contiguous) and width*N a multiple of 16.
__device__ __forceinline__ void stage_raw_w(uint8_t* raw,
                                            const uint8_t* __restrict__ w,
                                            int q0, int ns, int K, int N,
                                            int P, int R, int width) {
  const int units = width * N / 16;   // per step
  for (int u = threadIdx.x; u < ns * units; u += blockDim.x) {
    const int si = u / units, off = (u - si * units) * 16;
    const Step st = step_at(q0 + si, K, P, R, width);
    const int valid = max(0, min(width, st.rows - st.p0)) * N - off;
    repro::cp_async16(raw + si * width * N + off,
                      w + static_cast<size_t>(st.p0) * N + off,
                      valid <= 0 ? 0 : (valid < 16 ? valid : 16));
  }
}

// Truncate or unpack the raw weight rows of a chunk once, four columns a
// word where the raw row pitch N allows (N % 4 == 0), into the layout the
// mode multiplies from: the view of step si, row c, tile column n goes to
// dst[si*s_step + c*s_row + n*s_col].  Entries past K or N are 0.
template <int BN, typename T>
__device__ __forceinline__ void convert_w(const uint8_t* raw, int raw_w,
                                          const uint8_t* __restrict__ w,
                                          int q0, int ns, int n0, int K,
                                          int N, int P, int R, int width,
                                          int bits, int packed, T* dst,
                                          int s_step, int s_row, int s_col) {
  if (raw_w && (N & 3) == 0) {
    constexpr int W4 = BN / 4;
    for (int i = threadIdx.x; i < ns * width * W4; i += blockDim.x) {
      const int n = (i % W4) * 4, r = i / W4;
      const int si = r / width, c = r - si * width;
      const Step st = step_at(q0 + si, K, P, R, width);
      const unsigned word = n < N && st.p0 + c < st.rows
                                ? ld32(raw + (si * width + c) * N + n)
                                : 0u;
      T* d = dst + si * s_step + c * s_row + n * s_col;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        d[b * s_col] = static_cast<T>(weight_value(
            static_cast<uint8_t>(word >> (8 * b)), st.j, bits, packed));
    }
    return;
  }
  for (int i = threadIdx.x; i < ns * width * BN; i += blockDim.x) {
    const int nn = i % BN, r = i / BN;
    const int si = r / width, c = r - si * width;
    const Step st = step_at(q0 + si, K, P, R, width);
    const int gn = n0 + nn, p = st.p0 + c;
    int v = 0;
    if (gn < N && p < st.rows)
      v = weight_value(raw_w ? raw[(si * width + c) * N + gn]
                             : w[static_cast<size_t>(p) * N + gn],
                       st.j, bits, packed);
    dst[si * s_step + c * s_row + nn * s_col] = static_cast<T>(v);
  }
}

// -- tiled mapping ----------------------------------------------------------------
//
// A CTA of 128 threads owns a BM x BN output tile.  Per chunk of k steps
// (every step of the tile when they fit in 48 KB, which holds at every path
// shape) it issues all its copies at once -- x with cp.async, the raw weight
// rows with cp.async -- waits once, then truncates/unpacks the weight steps
// into shared memory, and multiplies.  The epilogue's scale and bias are
// fetched into registers while the copies fly.

constexpr int TILE_THREADS = 128;
constexpr int TILE_SMEM = 48 * 1024;
// bytes per staged 32-wide int8 row: 16-byte aligned for cp.async, and the
// fragment loads of a warp (8 rows x 4 words) fall in 32 distinct banks
constexpr int TI_PITCH = 48;

// int8 mode: the 4 warps form a WM x WN grid over the tile, WM = BM / 16
// row bands of 16 and WN = min(4 / WM, BN / 8) column bands, each warp
// running m16n8k32 MMAs over its band and its share of the epilogue (warps
// past WM x WN only help stage)
template <int BN>
__global__ void __launch_bounds__(TILE_THREADS)
qgemm_tiled_i8(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ xs, const float* __restrict__ s,
               const float* __restrict__ bias, int8_t* __restrict__ out_code,
               float* __restrict__ out_f, int M, int K, int N, int bits,
               int packed, int P, int R, int BM, int chunk, int a_mode,
               int raw_w, repro::Epilogue e) {
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);          // [chunk][BM][PITCH]
  int8_t* Bt = As + chunk * BM * TI_PITCH;               // [chunk][BN][PITCH]
  uint8_t* rawB = reinterpret_cast<uint8_t*>(Bt + chunk * BN * TI_PITCH);
  uint8_t* rawA = rawB + (raw_w ? align16(chunk * 32 * N) : 0);   // [BM][K]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int T = total_steps(K, P, R, 32);
  const int WM = BM / 16;
  const int WN = min(4 / WM, NT);
  const int NTW = NT / WN;              // 8-column fragments per warp
  const int wm = warp % WM, wn = warp / WM;
  const bool computes = warp < WM * WN;
  const int r0 = wm * 16 + g;           // the warp's first row in the tile
  const int nb = wn * NTW * 8;          // the warp's first column

  float sc[NT][2], bc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gn = n0 + nb + nt * 8 + 2 * t + i;
      const bool ok = nt < NTW && gn < N;
      sc[nt][i] = ok ? s[gn] : 0.0f;
      bc[nt][i] = ok && e.has_bias ? bias[gn] : 0.0f;
    }
  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;

  for (int q0 = 0; q0 < T; q0 += chunk) {
    const int ns = min(chunk, T - q0);
    if (a_mode == kAVec) {
      for (int u = tid; u < ns * BM * 2; u += TILE_THREADS) {
        const int si = u / (BM * 2), r = u - si * BM * 2;
        const int mm = r >> 1, h = (r & 1) * 16;
        const Step st = step_at(q0 + si, K, P, R, 32);
        const int gm = m0 + mm;
        const bool ok = gm < M && st.p0 + h < st.rows;
        repro::cp_async16(
            As + (si * BM + mm) * TI_PITCH + h,
            ok ? x + static_cast<size_t>(gm) * K + st.j * P + st.p0 + h : x,
            ok ? 16 : 0);
      }
    } else if (a_mode == kAWhole) {
      repro::cp_async_bytes(rawA, x + static_cast<size_t>(m0) * K,
                            min(BM, M - m0) * K);
    } else {
      for (int i = tid; i < ns * BM * 32; i += TILE_THREADS) {
        const int si = i / (BM * 32), r = i - si * BM * 32;
        const int mm = r >> 5, c = r & 31;
        const Step st = step_at(q0 + si, K, P, R, 32);
        const int gm = m0 + mm;
        As[(si * BM + mm) * TI_PITCH + c] =
            gm < M && st.p0 + c < st.rows
                ? x[static_cast<size_t>(gm) * K + st.j * P + st.p0 + c]
                : int8_t(0);
      }
    }
    if (raw_w) stage_raw_w(rawB, w, q0, ns, K, N, P, R, 32);
    repro::cp_async_commit();
    repro::cp_async_wait_all();
    __syncthreads();
    if (a_mode == kAWhole) {
      // one step (ns == 1): the tile's K-wide rows into 32-wide rows
      for (int i = tid; i < BM * 32; i += TILE_THREADS) {
        const int mm = i >> 5, c = i & 31;
        As[mm * TI_PITCH + c] = c < K && m0 + mm < M
                                    ? static_cast<int8_t>(rawA[mm * K + c])
                                    : int8_t(0);
      }
    }
    // the weight steps, truncated or unpacked once, stored transposed (k
    // contiguous per column: mma's column-major B fragment)
    convert_w<BN>(rawB, raw_w, w, q0, ns, n0, K, N, P, R, 32, bits, packed,
                  Bt, BN * TI_PITCH, 1, TI_PITCH);
    __syncthreads();
    if (computes) {
      for (int si = 0; si < ns; ++si) {
        const int8_t* pa = As + (si * BM + r0) * TI_PITCH + t * 4;
        const unsigned a[4] = {ld32(pa), ld32(pa + 8 * TI_PITCH),
                               ld32(pa + 16), ld32(pa + 8 * TI_PITCH + 16)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < NTW) {
            const int8_t* pb =
                Bt + (si * BN + nb + nt * 8 + g) * TI_PITCH + t * 4;
            mma_s8(acc[nt], a, ld32(pb), ld32(pb + 16));
          }
        }
      }
    }
    __syncthreads();
  }
  if (!computes) return;

  // accumulator fragment: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at row g+8
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + r0 + (i >> 1) * 8;
      const int gn = n0 + nb + nt * 8 + 2 * t + (i & 1);
      if (nt < NTW && gm < M && gn < N)
        store_out<false>(acc[nt][i], gm, gn, N, xs, sc[nt][i & 1],
                         bc[nt][i & 1], e, out_code, out_f);
    }
}

// float mode: CUDA cores, one row and 4 columns per thread (BM = 512 / BN),
// k steps of BK (fitted to K)
template <int BN, int BK>
__global__ void __launch_bounds__(TILE_THREADS)
qgemm_tiled_f32(const float* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ s, const float* __restrict__ bias,
                float* __restrict__ out_f, int M, int K, int N, int bits,
                int packed, int P, int R, int chunk, int a_mode, int raw_w,
                repro::Epilogue e) {
  constexpr int TX = BN / 4;               // threads along n
  constexpr int BM = TILE_THREADS / TX;    // one row per thread
  constexpr int AP = BK + 4;               // staged row pitch (floats)
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);     // [chunk][BM][AP]
  float* Bs = As + chunk * BM * AP;               // [chunk][BK][BN]
  uint8_t* rawB = reinterpret_cast<uint8_t*>(Bs + chunk * BK * BN);
  float* rawA = reinterpret_cast<float*>(
      rawB + (raw_w ? align16(chunk * BK * N) : 0));   // [BM][K]
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int T = total_steps(K, P, R, BK);

  float sc[4], bc[4], acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gn = n0 + tx * 4 + i;
    sc[i] = gn < N ? s[gn] : 0.0f;
    bc[i] = e.has_bias && gn < N ? bias[gn] : 0.0f;
    acc[i] = 0.0f;
  }

  for (int q0 = 0; q0 < T; q0 += chunk) {
    const int ns = min(chunk, T - q0);
    if (a_mode == kAVec) {
      // float4 units; K % 4 == 0 and P % 4 == 0: each all valid or not
      for (int u = tid; u < ns * BM * (BK / 4); u += TILE_THREADS) {
        const int si = u / (BM * (BK / 4)), r = u - si * BM * (BK / 4);
        const int mm = r / (BK / 4), c = (r % (BK / 4)) * 4;
        const Step st = step_at(q0 + si, K, P, R, BK);
        const int gm = m0 + mm;
        const bool ok = gm < M && st.p0 + c < st.rows;
        repro::cp_async16(
            As + (si * BM + mm) * AP + c,
            ok ? x + static_cast<size_t>(gm) * K + st.j * P + st.p0 + c : x,
            ok ? 16 : 0);
      }
    } else if (a_mode == kAWhole) {
      repro::cp_async_bytes(rawA, x + static_cast<size_t>(m0) * K,
                            min(BM, M - m0) * K * 4);
    } else {
      for (int i = tid; i < ns * BM * BK; i += TILE_THREADS) {
        const int si = i / (BM * BK), r = i - si * BM * BK;
        const int mm = r / BK, c = r % BK;
        const Step st = step_at(q0 + si, K, P, R, BK);
        const int gm = m0 + mm;
        As[(si * BM + mm) * AP + c] =
            gm < M && st.p0 + c < st.rows
                ? x[static_cast<size_t>(gm) * K + st.j * P + st.p0 + c]
                : 0.0f;
      }
    }
    if (raw_w) stage_raw_w(rawB, w, q0, ns, K, N, P, R, BK);
    repro::cp_async_commit();
    repro::cp_async_wait_all();
    __syncthreads();
    if (a_mode == kAWhole) {
      for (int i = tid; i < BM * BK; i += TILE_THREADS) {
        const int mm = i / BK, c = i % BK;
        As[mm * AP + c] = c < K && m0 + mm < M ? rawA[mm * K + c] : 0.0f;
      }
    }
    convert_w<BN>(rawB, raw_w, w, q0, ns, n0, K, N, P, R, BK, bits, packed,
                  Bs, BK * BN, BN, 1);
    __syncthreads();
    for (int si = 0; si < ns; ++si) {
      const float* ar = As + (si * BM + ty) * AP;
      const float* br = Bs + si * BK * BN + tx * 4;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float a = ar[kk];
        const float4 b = *reinterpret_cast<const float4*>(br + kk * BN);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(a, b.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(a, b.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(a, b.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(a, b.w));
      }
    }
    __syncthreads();
  }

  const int gm = m0 + ty;
  if (gm >= M) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gn = n0 + tx * 4 + i;
    if (gn < N)
      store_out<true>(acc[i], gm, gn, N, nullptr, sc[i], bc[i], e, nullptr,
                      out_f);
  }
}

// -- skinny mapping: K split across a cluster of CTAs and their warps -----------
//
// A cluster of SK_CLUSTER CTAs (neighbouring SMs) owns BN output columns and
// splits K between its CTAs; each CTA stages its K range of x (cp.async
// 16-byte units where K allows) and the raw weight rows (cp.async) in shared
// memory in one go -- a chunk loop only where they do not fit -- and each of
// its warps takes every 8th 32-wide step, building its weight operands from
// the raw rows in registers (each element truncated or unpacked once).  The
// warps' partial sums meet in the CTA's shared memory, and the CTAs' in the
// cluster's distributed shared memory, where the first CTA adds them in rank
// order and runs the epilogue: one launch, no workspace, no atomics.

constexpr int SK_WARPS = 8;
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_CLUSTER = 8;
constexpr int SK_MAX_M = 64;
constexpr int SK_SMEM = 96 * 1024;   // dynamic shared memory budget

// staged x row pitch: `chunk` 32-wide steps plus 16 bytes (16-byte aligned)
template <typename X>
__host__ __device__ __forceinline__ int sk_apitch(int chunk) {
  return chunk * 32 + 16 / static_cast<int>(sizeof(X));
}

// four rows k..k+3 of one column of a raw step as their views: one byte
// each, packed little-endian into a word (int8 mode) or widened to f32
struct RawStep {
  const uint8_t* rb;  // the step's raw rows, pitch ldb
  int ldb;
  Step st;
  bool fast;          // W8 master codes and every row of the step below K
  int bits, packed;

  __device__ __forceinline__ int at(int k, int col, bool col_ok) const {
    if (!col_ok || st.p0 + k >= st.rows) return 0;
    return weight_value(rb[k * ldb + col], st.j, bits, packed);
  }
  __device__ __forceinline__ unsigned word(int k, int col, bool col_ok) const {
    if (fast && col_ok) {
      const uint8_t* p = rb + k * ldb + col;
      return p[0] | (p[ldb] << 8) | (p[2 * ldb] << 16) |
             (static_cast<unsigned>(p[3 * ldb]) << 24);
    }
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v |= (static_cast<unsigned>(at(k + i, col, col_ok)) & 0xffu) << (8 * i);
    return v;
  }
};

template <bool kFloat, int BN>
__global__ void __cluster_dims__(SK_CLUSTER, 1, 1)
__launch_bounds__(SK_THREADS)
qgemm_skinny(const typename Mode<kFloat>::X* __restrict__ x,
             const uint8_t* __restrict__ w, const float* __restrict__ xs,
             const float* __restrict__ s, const float* __restrict__ bias,
             int8_t* __restrict__ out_code, float* __restrict__ out_f, int M,
             int K, int N, int bits, int packed, int P, int R, int vec_x,
             int raw_w, int steps_per_cta, int chunk, repro::Epilogue e) {
  using X = typename Mode<kFloat>::X;
  using Acc = typename Mode<kFloat>::Acc;
  constexpr int NT = BN / 8;
  constexpr int MSTEP = 32 / BN;        // float mode: rows a warp covers at once
  constexpr int OPL = SK_MAX_M / MSTEP; // float mode: outputs per lane, at most
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sh_s[BN], sh_b[BN];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int apitch = sk_apitch<X>(chunk);
  X* As = reinterpret_cast<X*>(smem);                       // [M][apitch]
  uint8_t* rawB = reinterpret_cast<uint8_t*>(
      smem + static_cast<size_t>(M) * apitch * sizeof(X));  // [chunk*32][ldb]
  const int ldb = raw_w ? N : BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BN;
  const int ncols = min(BN, N - n0);    // columns of this tile in rawB
  const int T = total_steps(K, P, R, 32);
  const int qb = rank * steps_per_cta;
  const int qe = min(T, qb + steps_per_cta);
  const int MT = (M + 15) / 16;
  const int nl = lane % BN, ml = lane / BN;
  const bool plain8 = !packed && bits >= 8;

  if (rank == 0 && tid < BN) {
    const int gn = n0 + tid;
    sh_s[tid] = gn < N ? s[gn] : 0.0f;
    sh_b[tid] = e.has_bias && gn < N ? bias[gn] : 0.0f;
  }
  int acc_i[4][NT][4];
  float acc_f[OPL];
  if constexpr (kFloat) {
#pragma unroll
    for (int i = 0; i < OPL; ++i) acc_f[i] = 0.0f;
  } else {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_i[mt][nt][i] = 0;
  }

  for (int q0 = qb; q0 < qe; q0 += chunk) {
    const int ns = min(chunk, qe - q0);
    // x: rows m < M, ns steps of 32 columns each
    constexpr int UE = 16 / static_cast<int>(sizeof(X));  // elements / 16 B
    constexpr int UPS = 32 / UE;                          // units per step
    if (vec_x) {
      for (int u = tid; u < M * ns * UPS; u += SK_THREADS) {
        const int m = u / (ns * UPS);
        const int r = u - m * ns * UPS;
        const int si = r / UPS, c = (r - si * UPS) * UE;
        const Step st = step_at(q0 + si, K, P, R, 32);
        const bool ok = st.p0 + c < st.rows;
        repro::cp_async16(
            As + static_cast<size_t>(m) * apitch + si * 32 + c,
            ok ? x + static_cast<size_t>(m) * K + st.j * P + st.p0 + c : x,
            ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < M * ns * 32; i += SK_THREADS) {
        const int m = i / (ns * 32);
        const int r = i - m * ns * 32;
        const int si = r >> 5, c = r & 31;
        const Step st = step_at(q0 + si, K, P, R, 32);
        As[static_cast<size_t>(m) * apitch + si * 32 + c] =
            st.p0 + c < st.rows
                ? x[static_cast<size_t>(m) * K + st.j * P + st.p0 + c]
                : X(0);
      }
    }
    // w: the raw rows of each step (all N columns when one tile spans N)
    if (raw_w) {
      stage_raw_w(rawB, w, q0, ns, K, N, P, R, 32);
    } else {
      for (int i = tid; i < ns * 32 * BN; i += SK_THREADS) {
        const int nn = i % BN, r = i / BN;
        const int si = r >> 5, c = r & 31;
        const Step st = step_at(q0 + si, K, P, R, 32);
        const int gn = n0 + nn, p = st.p0 + c;
        rawB[r * BN + nn] =
            gn < N && p < st.rows ? w[static_cast<size_t>(p) * N + gn] : 0;
      }
    }
    repro::cp_async_commit();
    repro::cp_async_wait_all();
    __syncthreads();

    // each warp takes every SK_WARPS-th step of the chunk
    for (int si = warp; si < ns; si += SK_WARPS) {
      RawStep rs;
      rs.rb = rawB + si * 32 * ldb;
      rs.ldb = ldb;
      rs.st = step_at(q0 + si, K, P, R, 32);
      rs.fast = plain8 && rs.st.p0 + 32 <= rs.st.rows;
      rs.bits = bits;
      rs.packed = packed;
      if constexpr (kFloat) {
        // lane owns column nl and rows ml, ml + MSTEP, ... below M
        const float* as = As + si * 32;
        const bool col_ok = nl < ncols;
#pragma unroll 2
        for (int c = 0; c < 32; c += 4) {
          const unsigned wb = rs.word(c, nl, col_ok);
          const float w0 = static_cast<float>(static_cast<int8_t>(wb));
          const float w1 = static_cast<float>(static_cast<int8_t>(wb >> 8));
          const float w2 = static_cast<float>(static_cast<int8_t>(wb >> 16));
          const float w3 = static_cast<float>(static_cast<int8_t>(wb >> 24));
#pragma unroll
          for (int i = 0; i < OPL; ++i) {
            const int m = ml + i * MSTEP;
            if (m >= M) break;
            const float4 xv = *reinterpret_cast<const float4*>(
                as + static_cast<size_t>(m) * apitch + c);
            float a = acc_f[i];
            a = __fadd_rn(a, __fmul_rn(xv.x, w0));
            a = __fadd_rn(a, __fmul_rn(xv.y, w1));
            a = __fadd_rn(a, __fmul_rn(xv.z, w2));
            a = __fadd_rn(a, __fmul_rn(xv.w, w3));
            acc_f[i] = a;
          }
        }
      } else {
        const int8_t* as = As + si * 32;
        unsigned b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + g;
          b[nt][0] = rs.word(t * 4, col, col < ncols);
          b[nt][1] = rs.word(16 + t * 4, col, col < ncols);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < MT) {
            // rows past M are zero registers: M padded to 16 in registers
            const int ra = mt * 16 + g, rb = ra + 8;
            const int8_t* pa = as + static_cast<size_t>(ra) * apitch;
            const int8_t* pb = as + static_cast<size_t>(rb) * apitch;
            const unsigned a[4] = {ra < M ? ld32(pa + t * 4) : 0u,
                                   rb < M ? ld32(pb + t * 4) : 0u,
                                   ra < M ? ld32(pa + 16 + t * 4) : 0u,
                                   rb < M ? ld32(pb + 16 + t * 4) : 0u};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_s8(acc_i[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // the warps' partial sums meet in shared memory: red[warp][m][n], then
  // tot[m][n] (over the staging buffers; the barrier covers a CTA that had
  // no step)
  __syncthreads();
  Acc* red = reinterpret_cast<Acc*>(smem);
  Acc* tot = red + SK_WARPS * M * BN;
  if constexpr (kFloat) {
#pragma unroll
    for (int i = 0; i < OPL; ++i) {
      const int m = ml + i * MSTEP;
      if (m >= M) break;
      red[(warp * M + m) * BN + nl] = acc_f[i];
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = mt * 16 + g + (i >> 1) * 8;
          if (mt < MT && m < M)
            red[(warp * M + m) * BN + nt * 8 + 2 * t + (i & 1)] =
                acc_i[mt][nt][i];
        }
  }
  __syncthreads();
  for (int o = tid; o < M * BN; o += SK_THREADS) {
    Acc sum = red[o];
#pragma unroll
    for (int wi = 1; wi < SK_WARPS; ++wi) {
      if constexpr (kFloat) {
        sum = __fadd_rn(sum, red[wi * M * BN + o]);
      } else {
        sum += red[wi * M * BN + o];
      }
    }
    tot[o] = sum;
  }
  // the CTAs' sums meet in the first CTA, through distributed shared memory
  cluster.sync();
  if (rank == 0) {
    for (int o = tid; o < M * BN; o += SK_THREADS) {
      const int m = o / BN, n = o % BN;
      if (n0 + n >= N) continue;
      Acc sum = tot[o];
#pragma unroll
      for (int r = 1; r < SK_CLUSTER; ++r) {
        const Acc v = cluster.map_shared_rank(tot, r)[o];
        if constexpr (kFloat) {
          sum = __fadd_rn(sum, v);
        } else {
          sum += v;
        }
      }
      store_out<kFloat>(sum, m, n0 + n, N, xs, sh_s[n], sh_b[n], e, out_code,
                        out_f);
    }
  }
  // no CTA leaves while the first still reads its shared memory
  cluster.sync();
}

__global__ void truncate_kernel(const int8_t* __restrict__ codes,
                                int8_t* __restrict__ out, int n, int bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<int8_t>(repro::truncate_view(codes[i], bits));
}

// -- host side ------------------------------------------------------------------

enum Mapping { kTiled = 0, kSkinny = 1 };

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int rc() { return static_cast<int>(cudaGetLastError()); }
int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

struct Args {
  const void* x;
  const uint8_t* w;
  const float* xs;
  const float* s;
  const float* bias;
  int8_t* out_code;
  float* out_f;
  int M, K, N, bits, packed, P, R;
  repro::Epilogue e;
  cudaStream_t stream;
};

// how a tiled CTA stages x for k steps of `width` elements of `esz` bytes
int a_mode_for(const Args& a, int width, int esz) {
  const int ue = 16 / esz;
  if (!aligned16(a.x)) return kAElem;
  if (a.K % ue == 0 && (a.R == 1 || a.P % ue == 0)) return kAVec;
  if (a.K <= width && a.P >= a.K) return kAWhole;
  return kAElem;
}

template <bool kFloat, int BN>
int launch_skinny(const Args& a) {
  using X = typename Mode<kFloat>::X;
  using Acc = typename Mode<kFloat>::Acc;
  const int esz = static_cast<int>(sizeof(X));
  const int T = total_steps(a.K, a.P, a.R, 32);
  const int spc = T > 0 ? (T + SK_CLUSTER - 1) / SK_CLUSTER : 1;
  const int raw_w = a.N <= BN && aligned16(a.w);
  const int ldb = raw_w ? a.N : BN;
  // as many 32-wide steps per shared-memory chunk as the budget holds
  int chunk = (SK_SMEM - 16 * a.M - 16) / (32 * (a.M * esz + ldb));
  if (chunk > spc) chunk = spc;
  if (chunk < 1) return invalid();
  const size_t stage =
      static_cast<size_t>(a.M) * sk_apitch<X>(chunk) * esz +
      static_cast<size_t>(align16(chunk * 32 * ldb));
  const size_t red =
      static_cast<size_t>(SK_WARPS + 1) * a.M * BN * sizeof(Acc);
  const size_t smem = stage > red ? stage : red;
  if (smem > SK_SMEM) return invalid();
  const int ue = 16 / esz;
  const int vec_x = a.K % ue == 0 && (a.R == 1 || a.P % ue == 0) &&
                    aligned16(a.x);
  auto kern = qgemm_skinny<kFloat, BN>;
  if (smem > 48 * 1024) {
    // raise the kernel's dynamic shared memory limit once per device, not
    // per call (a call may be captured in a CUDA graph)
    static int granted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return invalid();
    if (granted[dev] < SK_SMEM) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SK_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev] = SK_SMEM;
    }
  }
  const dim3 grid(SK_CLUSTER, (a.N + BN - 1) / BN);
  kern<<<grid, SK_THREADS, smem, a.stream>>>(
      static_cast<const X*>(a.x), a.w, a.xs, a.s, a.bias, a.out_code, a.out_f,
      a.M, a.K, a.N, a.bits, a.packed, a.P, a.R, vec_x, raw_w, spc, chunk,
      a.e);
  return rc();
}

template <int BN>
int launch_tiled_i8(const Args& a, int bm) {
  if (bm != 16 && bm != 32 && bm != 64) return invalid();
  const int T = total_steps(a.K, a.P, a.R, 32);
  const int a_mode = a_mode_for(a, 32, 1);
  const int raw_w = a.N <= BN && aligned16(a.w);
  const int raw_a = a_mode == kAWhole ? align16(bm * a.K) : 0;
  const int per_step = (bm + BN) * TI_PITCH + (raw_w ? 32 * a.N : 0);
  int chunk = (TILE_SMEM - raw_a - 16) / per_step;
  if (chunk > T) chunk = T;
  if (chunk < 1) chunk = 1;
  const size_t smem = static_cast<size_t>(chunk) * (bm + BN) * TI_PITCH +
                      (raw_w ? align16(chunk * 32 * a.N) : 0) + raw_a;
  if (smem > TILE_SMEM) return invalid();
  const dim3 grid((a.M + bm - 1) / bm, (a.N + BN - 1) / BN);
  qgemm_tiled_i8<BN><<<grid, TILE_THREADS, smem, a.stream>>>(
      static_cast<const int8_t*>(a.x), a.w, a.xs, a.s, a.bias, a.out_code,
      a.out_f, a.M, a.K, a.N, a.bits, a.packed, a.P, a.R, bm, chunk, a_mode,
      raw_w, a.e);
  return rc();
}

template <int BN, int BK>
int launch_tiled_f32(const Args& a, int bm) {
  constexpr int BM = TILE_THREADS * 4 / BN;
  if (bm != BM) return invalid();
  const int T = total_steps(a.K, a.P, a.R, BK);
  const int a_mode = a_mode_for(a, BK, 4);
  const int raw_w = a.N <= BN && aligned16(a.w) && (BK * a.N) % 16 == 0;
  const int raw_a = a_mode == kAWhole ? align16(BM * a.K * 4) : 0;
  const int per_step =
      BM * (BK + 4) * 4 + BK * BN * 4 + (raw_w ? BK * a.N : 0);
  int chunk = (TILE_SMEM - raw_a - 16) / per_step;
  if (chunk > T) chunk = T;
  if (chunk < 1) chunk = 1;
  const size_t smem =
      static_cast<size_t>(chunk) * (BM * (BK + 4) * 4 + BK * BN * 4) +
      (raw_w ? align16(chunk * BK * a.N) : 0) + raw_a;
  if (smem > TILE_SMEM) return invalid();
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  qgemm_tiled_f32<BN, BK><<<grid, TILE_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.x), a.w, a.s, a.bias, a.out_f, a.M, a.K,
      a.N, a.bits, a.packed, a.P, a.R, chunk, a_mode, raw_w, a.e);
  return rc();
}

template <int BN>
int launch_tiled_f32_bk(const Args& a, int bm, int bk) {
  switch (bk) {
    case 8: return launch_tiled_f32<BN, 8>(a, bm);
    case 16: return launch_tiled_f32<BN, 16>(a, bm);
    case 32: return launch_tiled_f32<BN, 32>(a, bm);
    default: return invalid();
  }
}

template <bool kFloat>
int launch(const Args& a, int mapping, int bm, int bn, int bk, int splits) {
  if (a.M <= 0 || a.N <= 0) return rc();
  if (mapping == kSkinny) {
    if (a.M > SK_MAX_M || bk != 32 || splits != SK_CLUSTER) return invalid();
    switch (bn) {
      case 8: return launch_skinny<kFloat, 8>(a);
      case 16: return launch_skinny<kFloat, 16>(a);
      case 32: return launch_skinny<kFloat, 32>(a);
      default: return invalid();
    }
  }
  if (mapping != kTiled || splits != 1) return invalid();
  if constexpr (kFloat) {
    switch (bn) {
      case 8: return launch_tiled_f32_bk<8>(a, bm, bk);
      case 16: return launch_tiled_f32_bk<16>(a, bm, bk);
      case 32: return launch_tiled_f32_bk<32>(a, bm, bk);
      case 64: return launch_tiled_f32_bk<64>(a, bm, bk);
      default: return invalid();
    }
  } else {
    if (bk != 32) return invalid();
    switch (bn) {
      case 8: return launch_tiled_i8<8>(a, bm);
      case 16: return launch_tiled_i8<16>(a, bm);
      case 32: return launch_tiled_i8<32>(a, bm);
      case 64: return launch_tiled_i8<64>(a, bm);
      default: return invalid();
    }
  }
}

Args make_args(const void* x, const void* w, const void* xs, const void* s,
               const void* bias, void* out, int M, int K, int N, int bits,
               int packed, int kp_rows, int relu, int has_aqt, int out_code,
               int qmin, int qmax, float mul, float inv, void* stream) {
  Args a;
  a.x = x;
  a.w = static_cast<const uint8_t*>(w);
  a.xs = static_cast<const float*>(xs);
  a.s = static_cast<const float*>(s);
  a.bias = static_cast<const float*>(bias);
  a.out_code = out_code ? static_cast<int8_t*>(out) : nullptr;
  a.out_f = out_code ? nullptr : static_cast<float*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.bits = bits;
  a.packed = packed;
  a.P = packed ? kp_rows : K;
  a.R = packed ? 8 / bits : 1;
  a.e = repro::make_epilogue(relu, bias != nullptr, has_aqt, out_code, qmin,
                             qmax, mul, inv);
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// C entry points (bound with ctypes).  `w` is int8 (K, N) codes, or with
// `packed` the uint8 (kp_rows, N) split-row buffer (kp_rows * 8/bits >= K).
// `s` is the folded per-channel scale (N,), `bias` (N,) or null; `out` is
// int8 (M, N) when `out_code`, else f32 (M, N).  The tile choice comes from
// the host: `mapping` 0 (tiled: bm x bn tiles, k step bk, splits 1) or 1
// (skinny: M <= 64, bn columns per cluster of `splits` = 8 CTAs that split
// K, bk = 32).  A choice the kernels do not take returns
// cudaErrorInvalidValue.  Each launches on `stream` and returns
// cudaGetLastError().
//
// int8-activation mode: `x` int8 (M, K) codes; `xs` the per-row activation
// scale (M,) f32, or null when the scalar one is folded into `s`.
extern "C" int repro_qgemm_i8(const void* x, const void* w, const void* xs,
                              const void* s, const void* bias, void* out,
                              int M, int K, int N, int bits, int packed,
                              int kp_rows, int relu, int has_aqt,
                              int out_code, int qmin, int qmax, int mapping,
                              int bm, int bn, int bk, int splits, float mul,
                              float inv, void* stream) {
  return launch<false>(make_args(x, w, xs, s, bias, out, M, K, N, bits,
                                 packed, kp_rows, relu, has_aqt, out_code,
                                 qmin, qmax, mul, inv, stream),
                       mapping, bm, bn, bk, splits);
}

// float-activation mode: `x` f32 (M, K); `xs` must be null and `out_code` 0
// (the float mode emits f32 only).
extern "C" int repro_qgemm_f32(const void* x, const void* w, const void* xs,
                               const void* s, const void* bias, void* out,
                               int M, int K, int N, int bits, int packed,
                               int kp_rows, int relu, int has_aqt,
                               int out_code, int qmin, int qmax, int mapping,
                               int bm, int bn, int bk, int splits, float mul,
                               float inv, void* stream) {
  if (xs != nullptr || out_code) return invalid();
  return launch<true>(make_args(x, w, xs, s, bias, out, M, K, N, bits,
                                packed, kp_rows, relu, has_aqt, out_code,
                                qmin, qmax, mul, inv, stream),
                      mapping, bm, bn, bk, splits);
}

// The integer truncation the kernels apply to master codes: `out[i]` =
// the `bits`-bit view of int8 `codes[i]`, i < n (held against
// quant.ptq.derive_view by the tests).
extern "C" int repro_truncate_view(const void* codes, void* out, int n,
                                   int bits, void* stream) {
  if (n <= 0) return rc();
  truncate_kernel<<<(n + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<int8_t*>(out), n, bits);
  return rc();
}
