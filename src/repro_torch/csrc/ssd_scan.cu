// ssd_scan: the Mamba-2 SSD chunked scan (state-space duality,
// arXiv:2405.21060) for Hopper (sm_90a), on CUDA cores in f32.
//
// Replaces: the Pallas TPU kernel `ssd_kernel` in
// src/repro/kernels/ssd_scan/kernel.py.  Per (batch b, head h) and per
// chunk of Q positions it computes, all in f32:
//   l      = cumsum(dt * A)                       the cumulative log-decay
//   att    = (C B^T) * exp(min(l_i - l_j, 0)) * dt_j,  j <= i
//   y      = att @ x + (C * exp(l)) @ state + x * D
//   state <- state * exp(l_last) + (B * exp(l_last - l) * dt)^T @ x
// from the given initial state (B,H,P,N) f32, or from zero, and returns y
// (B,S,H,P) in x's dtype and the final state (B,H,P,N) f32.
// x is (B,S,H,P), dt (B,S,H) f32, B and C (B,S,G,N) in x's dtype (head h
// reads group h / (H/G)), A and D (H,) f32.  All three are read in place
// through their strides (the model hands in views of the fused conv output),
// so the TPU wrapper's repeat/transpose copies have no counterpart.  A
// ragged last chunk is masked as if dt, x, B and C were 0 there, which is
// the oracle's exact zero-padding rule without a padded copy.
//
// What bounds it on this card: per (b*h, chunk) the least work is the
// causal half of C B^T and att @ x, then C * state and (B w)^T x:
// 2*(Q(Q+1)/2*(N+P) + 2*Q*N*P) = 2.90 MFLOP at Q=64, P=64, N=128; at the
// prefill call (B=4, S=2048, H=64) that is 23.7 GFLOP, 0.354 ms at 67
// TFLOP/s f32 on CUDA cores, against about 149 MB of device memory (0.044 ms
// at 3.35 TB/s).  So it is bound by operations.
//
// What the design does about it: the TPU grid ran the chunks of one (b*h) in
// order with the state in VMEM scratch; here one block per (b, h) loops over
// its chunks, the loop taking the place of the sequential grid axis, and the
// (N, P) state stays in shared memory for the whole sequence (32 KB at
// N=128, P=64).  Each chunk stages x, B and C in shared memory -- B and C
// also transposed to (N, Q), so every product reads both operands along its
// reduction dim -- takes the log-decay with a warp scan, and runs the four
// products as register-tiled GEMMs on CUDA cores: each of the 16 x 16
// threads owns a 4 x 4 output tile and per reduction step loads one float4
// of each operand for 16 FMAs (explicit fmaf, f32), the way an SGEMM tile
// does, so the FMA units rather than the shared-memory port set the pace.
// Tiles wholly above the causal diagonal are skipped.  The tiles need about
// 195 KB at full width, so the launch opts in to dynamic shared memory.
// Later work: bf16 wgmma tiles for C B^T and att @ x, splitting the chunks of
// one (b, h) across blocks when B*H < 132 (here 256 blocks, one per SM at a
// time, run in two waves), and TMA loads of the next chunk behind the
// current one's math.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 16 x 16 threads, a 4 x 4 tile each
constexpr int TILE = 4;
constexpr int SPAN = 16 * TILE;     // rows (or cols) one pass of the block covers
constexpr int SMEM_LIMIT = 232448;  // per-block opt-in maximum on Hopper

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(N) * P + static_cast<size_t>(Q) * P +
         2 * static_cast<size_t>(N) * Q + static_cast<size_t>(Q) * (Q + 4) +
         2 * static_cast<size_t>(Q) * (N + 1) + 4 * static_cast<size_t>(Q);
}

size_t smem_bytes(int Q, int P, int N) { return 4 * smem_floats(Q, P, N); }

__device__ __forceinline__ void zero(float (&acc)[TILE][TILE]) {
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c) acc[r][c] = 0.0f;
}

// acc[r][c] += sum_{k < K} A[k*lda + r0 + r] * B[k*ldb + c0 + c]: both
// operands laid out along the reduction dim k, one float4 of B per step and
// one of A too unless A's rows are padded off 16-byte alignment (kAlignedA
// false: A is read as four scalars)
template <bool kAlignedA = true>
__device__ __forceinline__ void mma(float (&acc)[TILE][TILE],
                                    const float* A, int lda, int r0,
                                    const float* B, int ldb, int c0, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* ap = A + k * lda + r0;
    float av[TILE];
    if (kAlignedA) {
      const float4 a = *reinterpret_cast<const float4*>(ap);
      av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
    } else {
#pragma unroll
      for (int r = 0; r < TILE; ++r) av[r] = ap[r];
    }
    const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + c0);
    const float bv[TILE] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c = 0; c < TILE; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ fin, int S, int H,
                int P, int G, int N, int Q, long long xsb, long long xss,
                long long xsh, long long dsb, long long dss, long long dsh,
                long long bsb, long long bss, long long bsg, long long csb,
                long long css, long long csg) {
  extern __shared__ __align__(16) float smem[];
  const int NR = N + 1;             // padded row of the row-major B and C
  const int QA = Q + 4;             // padded row of att^T
  float* st = smem;                 // (N, P) running state
  float* xs = st + N * P;           // (Q, P) x of the chunk
  float* ct = xs + Q * P;           // (N, Q) C^T, later (C * exp(l))^T
  float* bt = ct + N * Q;           // (N, Q) B^T
  float* att = bt + N * Q;          // (Q, QA) att^T: att[j * QA + i]
  float* bs = att + Q * QA;         // (Q, NR) B, later B * w
  float* cs = bs + Q * NR;          // (Q, NR) C as loaded
  float* dts = cs + Q * NR;         // (Q,) dt, 0 past the sequence
  float* ld = dts + Q;              // (Q,) cumulative log-decay
  float* wv = ld + Q;               // (Q,) exp(l_last - l_j) * dt_j
  float* eld = wv + Q;              // (Q,) exp(l_i)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float a = A[h], dd = D[h];
  const T* xb = x + b * xsb + h * xsh;
  const float* dtb = dt + b * dsb + h * dsh;
  const T* bb = Bm + b * bsb + g * bsg;
  const T* cb = Cm + b * csb + g * csg;
  T* yb = y + (static_cast<long long>(b) * S * H + h) * P;   // y contiguous
  const long long ys = static_cast<long long>(H) * P;

  // the state in shared memory is (N, P); s0 and fin are (P, N) per (b, h)
  for (int i = tid; i < N * P; i += THREADS) {
    const int pp = i / N, n = i % N;
    st[n * P + pp] =
        s0 ? s0[(static_cast<long long>(bh) * P + pp) * N + n] : 0.0f;
  }

  const int nchunks = (S + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    const int nv = min(Q, S - t0);  // valid rows of this chunk
    __syncthreads();                // the last chunk is done with the tiles

    for (int i = tid; i < Q * P; i += THREADS) {
      const int j = i / P, pp = i % P;
      xs[i] = j < nv ? load(xb + (t0 + j) * xss + pp) : 0.0f;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int j = i / N, n = i % N;
      const bool ok = j < nv;
      bs[j * NR + n] = ok ? load(bb + (t0 + j) * bss + n) : 0.0f;
      cs[j * NR + n] = ok ? load(cb + (t0 + j) * css + n) : 0.0f;
    }
    for (int j = tid; j < Q; j += THREADS)
      dts[j] = j < nv ? dtb[(t0 + j) * dss] : 0.0f;
    __syncthreads();

    if (tid < 32) {
      // warp scan of dt * A: each lane sums its segment in order, the
      // lanes' totals are scanned with shuffles, each segment adds the
      // exclusive prefix of the lanes before it
      const int seg = (Q + 31) / 32;
      const int lo = min(Q, tid * seg), hi = min(Q, lo + seg);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        ld[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl = __fadd_rn(incl, v);
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      for (int i = lo; i < hi; ++i) ld[i] = __fadd_rn(excl, ld[i]);
      __syncwarp();
      const float lq = ld[Q - 1];
      for (int i = tid; i < Q; i += 32) {
        wv[i] = __fmul_rn(expf(__fsub_rn(lq, ld[i])), dts[i]);
        eld[i] = expf(ld[i]);
      }
    }
    // B^T and C^T: consecutive threads take consecutive j, so the reads of
    // the padded row-major copies and the writes are free of bank conflicts
    for (int i = tid; i < Q * N; i += THREADS) {
      const int n = i / Q, j = i % Q;
      bt[i] = bs[j * NR + n];
      ct[i] = cs[j * NR + n];
    }
    __syncthreads();

    // att[i][j] = (C_i . B_j) * exp(min(l_i - l_j, 0)) * dt_j for j <= i
    for (int i0 = ty * TILE; i0 < Q; i0 += SPAN) {
      for (int j0 = tx * TILE; j0 < Q; j0 += SPAN) {
        float acc[TILE][TILE];
        zero(acc);
        if (j0 <= i0 + TILE - 1) mma(acc, ct, Q, i0, bt, Q, j0, N);
#pragma unroll
        for (int cc = 0; cc < TILE; ++cc) {
          const int j = j0 + cc;
          float4 v;
          float* vv = reinterpret_cast<float*>(&v);
#pragma unroll
          for (int r = 0; r < TILE; ++r) {
            const int i = i0 + r;
            vv[r] = j <= i
                        ? __fmul_rn(__fmul_rn(acc[r][cc],
                                              expf(fminf(__fsub_rn(ld[i], ld[j]),
                                                         0.0f))),
                                    dts[j])
                        : 0.0f;
          }
          *reinterpret_cast<float4*>(att + j * QA + i0) = v;
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < Q * N; i += THREADS)
      ct[i] = __fmul_rn(ct[i], eld[i % Q]);
    for (int i = tid; i < Q * N; i += THREADS) {
      const int j = i / N, n = i % N;
      bs[j * NR + n] = __fmul_rn(bs[j * NR + n], wv[j]);
    }
    __syncthreads();

    // y = att @ x + (C * exp(l)) @ state + x * D
    for (int i0 = ty * TILE; i0 < nv; i0 += SPAN) {
      for (int p0 = tx * TILE; p0 < P; p0 += SPAN) {
        float yi[TILE][TILE], yo[TILE][TILE];
        zero(yi);
        zero(yo);
        mma(yi, att, QA, i0, xs, P, p0, min(nv, i0 + TILE));
        mma(yo, ct, Q, i0, st, P, p0, N);
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          const int i = i0 + r;
          if (i >= nv) continue;
#pragma unroll
          for (int cc = 0; cc < TILE; ++cc) {
            const int p = p0 + cc;
            store(yb + (t0 + i) * ys + p,
                  __fadd_rn(__fadd_rn(yi[r][cc], yo[r][cc]),
                            __fmul_rn(xs[i * P + p], dd)));
          }
        }
      }
    }
    __syncthreads();                // y has read the state

    // state <- state * exp(l_last) + (B * w)^T @ x
    const float elast = expf(ld[Q - 1]);
    for (int n0 = ty * TILE; n0 < N; n0 += SPAN) {
      for (int p0 = tx * TILE; p0 < P; p0 += SPAN) {
        float acc[TILE][TILE];
        zero(acc);
        mma<false>(acc, bs, NR, n0, xs, P, p0, nv);
#pragma unroll
        for (int r = 0; r < TILE; ++r)
#pragma unroll
          for (int cc = 0; cc < TILE; ++cc) {
            float* sp = st + (n0 + r) * P + p0 + cc;
            *sp = __fadd_rn(__fmul_rn(*sp, elast), acc[r][cc]);
          }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += THREADS) {
    const int pp = i / N, n = i % N;
    fin[(static_cast<long long>(bh) * P + pp) * N + n] = st[n * P + pp];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* C, const void* D, const void* s0, void* y, void* fin,
           int B, int S,
           int H, int P, int G, int N, int Q, const long long* s,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, P, N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(fin), S, H, P, G, N, Q, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes).  Strides are in elements: x's, dt's, B's
// and C's over (batch, sequence, head or group); the last dim of x, B and C
// is contiguous.  `s0`, the initial state, is contiguous (B,H,P,N) f32, or
// null for a zero start.  y is written contiguous (B,S,H,P) in x's dtype
// (bf16 when `x_bf16`, else f32), fin contiguous (B,H,P,N) f32.  Launches on
// `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for shapes the
// kernel does not take (P, N or Q not a multiple of 4, H not a multiple of
// G, tiles over the shared-memory limit).
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* s0, void* y, void* fin, int B,
    int S, int H,
    int P, int G, int N, int Q, long long xsb, long long xss, long long xsh,
    long long dsb, long long dss, long long dsh, long long bsb, long long bss,
    long long bsg, long long csb, long long css, long long csg, int x_bf16,
    void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (P <= 0 || P % TILE != 0 || N <= 0 || N % TILE != 0 || Q <= 0 ||
      Q % TILE != 0 || G <= 0 || H % G != 0 || S < 0 ||
      smem_bytes(Q, P, N) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long s[12] = {xsb, xss, xsh, dsb, dss, dsh,
                           bsb, bss, bsg, csb, css, csg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, C, D, s0, y, fin, B, S, H, P, G,
                                 N, Q, s, st);
  return launch<float>(x, dt, A, Bm, C, D, s0, y, fin, B, S, H, P, G, N, Q, s,
                       st);
}
