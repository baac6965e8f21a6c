// ssd_scan: the Mamba-2 SSD chunked scan (state-space duality,
// arXiv:2405.21060) for Hopper (sm_90a), on CUDA cores in f32, as three
// chunk-parallel kernels launched in order on one stream.
//
// Replaces: the Pallas TPU kernel `ssd_kernel` in
// src/repro/kernels/ssd_scan/kernel.py.  Per (batch b, head h) and per
// chunk c of Q positions it computes, all in f32:
//   l      = cumsum(dt * A)                       the cumulative log-decay
//   att    = (C B^T) * exp(min(l_i - l_j, 0)) * dt_j,  j <= i
//   y      = att @ x + exp(l) * (C @ state_c) + x * D
//   state_{c+1} = state_c * exp(l_last) + (B * exp(l_last - l) * dt)^T @ x
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
// at 3.35 TB/s).  So the function is bound by operations.  This design adds
// its own byte floor: the (B,H,nc,N,P) f32 chunk states (268 MB at the
// prefill call) are written, read and rewritten, and read again, and x is
// read twice: about 1.29 GB, 0.38 ms at 3.35 TB/s.
//
// What the design does about the serial chain: the chunk-to-chunk
// dependence is only state_{c+1} = state_c * exp(l_last) + S_c, so the work
// splits the way mamba_ssm's ssd_combined splits it (_chunk_state,
// _state_passing, _chunk_scan):
//   1. chunk_state, one block per (b, h, chunk): the chunk summary
//      S_c = (B w)^T x (N, P) and exp(l_last), into scratch;
//   2. state_pass, one thread per (b, h, n, p): the only sequential step, a
//      multiply-add per chunk over the scratch, which it overwrites with the
//      state entering each chunk, and the final state;
//   3. chunk_scan, one block per (b, h, chunk): att, then y from x and that
//      chunk's entering state.
// Phases 1 and 3 launch B*H*nc independent blocks (8192 at the prefill call
// against 256 for a (b, h)-per-block loop), and each block's shared memory
// (49,920 and 104,192 bytes at Q=64, P=64, N=128) leaves room for four and
// two blocks on an SM, so one block's loads hide behind another's products.
// Both recompute the log-decay with the same warp scan, so their l agree to
// the bit.  The products are register-tiled GEMMs on CUDA cores: each of the
// 16 x 16 threads owns a 4 x 4 output tile and per reduction step loads one
// float4 of each operand for 16 FMAs (explicit fmaf, f32).  Rows are staged
// four elements a step with no division per element; phase 1 scales B by w
// in one pass.  Phase 3 stages B^T and C^T straight from device memory into
// rows padded to Q + 4 floats (float4-aligned, and a warp's 8 n x 4 j
// stores hit 32 distinct banks); it computes att only on the 4 x 4 tiles on
// or below the diagonal, numbered so that whole warps drop out above it;
// the entering state reuses B^T's space once att is written, and exp(l_i)
// scales the C state product's output row rather than C.
// Later work: bf16 mma.sync/wgmma tiles for C B^T and att @ x on the bf16
// path, cp.async staging, and fusing state_pass into chunk_state with a
// look-back.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // 16 x 16 threads, a 4 x 4 tile each
constexpr int TILE = 4;
constexpr int SPAN = 16 * TILE;     // rows (or cols) one pass of a block covers
constexpr int SMEM_LIMIT = 232448;  // per-block opt-in maximum on Hopper
constexpr int PASS_TILE = 32;       // state_pass: 32 (n) x 32 (p) a block

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// shared memory of phase 1: x (Q,P), B (Q,N), dt, l, w
size_t state_smem_bytes(int Q, int P, int N) {
  return 4 * (static_cast<size_t>(Q) * P + static_cast<size_t>(Q) * N +
              3 * static_cast<size_t>(Q));
}

// shared memory of phase 3: x (Q,P), C^T (N,Q+4), B^T (N,Q+4) later the
// entering state (N,P), att^T (Q,Q+4), dt, l, exp(l)
size_t scan_smem_bytes(int Q, int P, int N) {
  const size_t QS = static_cast<size_t>(Q) + 4;
  const size_t st = QS > static_cast<size_t>(P) ? QS : P;
  return 4 * (static_cast<size_t>(Q) * P + N * QS + N * st + Q * QS +
              3 * static_cast<size_t>(Q));
}

__device__ __forceinline__ void zero(float (&acc)[TILE][TILE]) {
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c) acc[r][c] = 0.0f;
}

// acc[r][c] += sum_{k < K} A[k*lda + r0 + r] * B[k*ldb + c0 + c]: both
// operands laid out along the reduction dim k, one float4 of each per step
__device__ __forceinline__ void mma(float (&acc)[TILE][TILE],
                                    const float* A, int lda, int r0,
                                    const float* B, int ldb, int c0, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float av[TILE] = {a.x, a.y, a.z, a.w};
    const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + c0);
    const float bv[TILE] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c = 0; c < TILE; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// dst (rows, cols) row-major <- src rows j < nv (row stride rs, cols
// contiguous), zero rows past nv; four elements a thread a step, with the
// (row, col) walk kept incrementally so no step divides (cols % 4 == 0)
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long rs, int rows, int cols,
                                           int nv, int tid) {
  const int cq = cols / 4;
  const int dj = THREADS / cq, dc = (THREADS % cq) * 4;
  int j = tid / cq, c = (tid % cq) * 4;
  while (j < rows) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < nv) {
      const T* q = src + j * rs + c;
      v = make_float4(load(q), load(q + 1), load(q + 2), load(q + 3));
    }
    *reinterpret_cast<float4*>(dst + j * cols + c) = v;
    j += dj;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++j;
    }
  }
}

// warp 0 only: ld[i] = sum_{i' <= i} dts[i'] * a.  Each lane sums its
// segment in order, the lanes' totals are scanned with shuffles, each
// segment adds the exclusive prefix of the lanes before it.  Phases 1 and 3
// both take l from here, so they agree to the bit.
__device__ __forceinline__ void log_decay(const float* dts, float a,
                                          float* ld, int Q, int lane) {
  const int seg = (Q + 31) / 32;
  const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    run = __fadd_rn(run, __fmul_rn(dts[i], a));
    ld[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, v);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  for (int i = lo; i < hi; ++i) ld[i] = __fadd_rn(excl, ld[i]);
  __syncwarp();
}

// Phase 1, grid (B*H, nc): S_c = (B * w)^T @ x into states (B,H,nc,N,P) and
// exp(l_last) into decay (B,H,nc), with w_j = exp(l_last - l_j) * dt_j.
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ decay,
                   int S, int H, int P, int G, int N, int Q, long long xsb,
                   long long xss, long long xsh, long long dsb, long long dss,
                   long long dsh, long long bsb, long long bss,
                   long long bsg) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // (Q, P) x of the chunk
  float* bs = xs + Q * P;           // (Q, N) B, then B * w
  float* dts = bs + Q * N;          // (Q,) dt, 0 past the sequence
  float* ld = dts + Q;              // (Q,) cumulative log-decay
  float* wv = ld + Q;               // (Q,) exp(l_last - l_j) * dt_j

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q;
  const int nv = min(Q, S - t0);    // valid rows of this chunk
  const T* xb = x + b * xsb + h * xsh + t0 * xss;
  const float* dtb = dt + b * dsb + h * dsh + t0 * dss;
  const T* bb = Bm + b * bsb + g * bsg + t0 * bss;

  stage_rows(xs, xb, xss, Q, P, nv, tid);
  stage_rows(bs, bb, bss, Q, N, nv, tid);
  for (int j = tid; j < Q; j += THREADS) dts[j] = j < nv ? dtb[j * dss] : 0.0f;
  __syncthreads();

  if (tid < 32) {
    log_decay(dts, A[h], ld, Q, tid);
    const float lq = ld[Q - 1];
    for (int i = tid; i < Q; i += 32)
      wv[i] = __fmul_rn(expf(__fsub_rn(lq, ld[i])), dts[i]);
    if (tid == 0) decay[static_cast<long long>(bh) * nc + c] = expf(lq);
  }
  __syncthreads();
  {
    // B * w, four elements a step along the rows, as stage_rows walks them
    const int cq = N / 4;
    const int dj = THREADS / cq, dc = (THREADS % cq) * 4;
    for (int j = tid / cq, n = (tid % cq) * 4; j < Q;) {
      float4* q = reinterpret_cast<float4*>(bs + j * N + n);
      const float w = wv[j];
      const float4 v = *q;
      *q = make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                       __fmul_rn(v.z, w), __fmul_rn(v.w, w));
      j += dj;
      n += dc;
      if (n >= N) {
        n -= N;
        ++j;
      }
    }
  }
  __syncthreads();

  float* sc = states + (static_cast<long long>(bh) * nc + c) * N * P;
  for (int n0 = ty * TILE; n0 < N; n0 += SPAN) {
    for (int p0 = tx * TILE; p0 < P; p0 += SPAN) {
      float acc[TILE][TILE];
      zero(acc);
      mma(acc, bs, N, n0, xs, P, p0, nv);
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        *reinterpret_cast<float4*>(sc + (n0 + r) * P + p0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// Phase 2, grid (B*H, tiles of 32 n x 32 p), 256 threads: each thread walks
// four (n, p) chains over the chunks in order, replacing S_c in `states` by
// the state entering chunk c, and writes the final state.  s0 and fin are
// (P, N) per (b, h): they pass through a shared tile so that both the
// (N, P) chunk states and the (P, N) ends are read and written along rows.
__global__ void __launch_bounds__(THREADS)
state_pass_kernel(float* states, const float* __restrict__ decay,
                  const float* __restrict__ s0, float* __restrict__ fin,
                  int nc, int P, int N) {
  __shared__ float tile[PASS_TILE][PASS_TILE + 1];
  constexpr int ROWS = THREADS / PASS_TILE;         // 8
  constexpr int PER = PASS_TILE / ROWS;             // 4 chains a thread
  const int bh = blockIdx.x;
  const int tiles_p = (P + PASS_TILE - 1) / PASS_TILE;
  const int n0 = (blockIdx.y / tiles_p) * PASS_TILE;
  const int p0 = (blockIdx.y % tiles_p) * PASS_TILE;
  const int tx = threadIdx.x % PASS_TILE, ty = threadIdx.x / PASS_TILE;
  const int p = p0 + tx;

  float s[PER];
  if (s0) {
    const float* sb = s0 + static_cast<long long>(bh) * P * N;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int pr = p0 + ty + k * ROWS, n = n0 + tx;
      tile[ty + k * ROWS][tx] = pr < P && n < N ? sb[pr * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) s[k] = tile[tx][ty + k * ROWS];
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) s[k] = 0.0f;
  }

  bool ok[PER];
  long long off[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int n = n0 + ty + k * ROWS;
    ok[k] = p < P && n < N;
    off[k] = static_cast<long long>(n) * P + p;
  }
  float* sb = states + static_cast<long long>(bh) * nc * N * P;
  const float* db = decay + static_cast<long long>(bh) * nc;
  const long long step = static_cast<long long>(N) * P;
  float v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = ok[k] && nc > 0 ? sb[off[k]] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    float* cur = sb + c * step;
    const float e = db[c];
    // the next chunk's summaries are loaded before this chunk's prefix is
    // stored (another address), so the chain waits on one load a chunk
    float nx[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      nx[k] = ok[k] && c + 1 < nc ? cur[step + off[k]] : 0.0f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (ok[k]) cur[off[k]] = s[k];
      s[k] = __fadd_rn(__fmul_rn(s[k], e), v[k]);
      v[k] = nx[k];
    }
  }

  __syncthreads();                  // every thread is done with the s0 tile
#pragma unroll
  for (int k = 0; k < PER; ++k) tile[tx][ty + k * ROWS] = s[k];
  __syncthreads();
  float* fb = fin + static_cast<long long>(bh) * P * N;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int pr = p0 + ty + k * ROWS, n = n0 + tx;
    if (pr < P && n < N) fb[pr * N + n] = tile[ty + k * ROWS][tx];
  }
}

// Phase 3, grid (B*H, nc): y = att @ x + exp(l) * (C @ state_c) + x * D for
// the chunk's valid rows, with state_c read from `states` (after phase 2).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  const float* __restrict__ states, T* __restrict__ y, int S,
                  int H, int P, int G, int N, int Q, long long xsb,
                  long long xss, long long xsh, long long dsb, long long dss,
                  long long dsh, long long bsb, long long bss, long long bsg,
                  long long csb, long long css, long long csg) {
  extern __shared__ __align__(16) float smem[];
  const int QS = Q + 4;             // padded row of C^T, B^T and att^T
  float* xs = smem;                 // (Q, P) x of the chunk
  float* ct = xs + Q * P;           // (N, QS) C^T
  float* bt = ct + N * QS;          // (N, QS) B^T, later state_c (N, P)
  float* att = bt + N * max(QS, P); // (Q, QS) att^T: att[j * QS + i]
  float* dts = att + Q * QS;        // (Q,) dt, 0 past the sequence
  float* ld = dts + Q;              // (Q,) cumulative log-decay
  float* eld = ld + Q;              // (Q,) exp(l_i)
  float* st = bt;

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q;
  const int nv = min(Q, S - t0);
  const float dd = D[h];
  const T* xb = x + b * xsb + h * xsh + t0 * xss;
  const float* dtb = dt + b * dsb + h * dsh + t0 * dss;
  const T* bb = Bm + b * bsb + g * bsg + t0 * bss;
  const T* cb = Cm + b * csb + g * csg + t0 * css;
  const long long ys = static_cast<long long>(H) * P;
  T* yb = y + (static_cast<long long>(b) * S + t0) * ys +
          static_cast<long long>(h) * P;              // y contiguous

  stage_rows(xs, xb, xss, Q, P, nv, tid);
  {
    // B^T and C^T from device memory: each warp takes 4 rows j and walks
    // n 8 at a time, so its loads run along rows and its stores hit 32
    // distinct banks of the padded rows (QS = 4 mod 32 words)
    const int warp = tid / 32, nl = tid % 8, jl = (tid % 32) / 8;
    for (int j = warp * 4 + jl; j < Q; j += 4 * (THREADS / 32)) {
      const bool ok = j < nv;
      const T* br = bb + j * bss;
      const T* cr = cb + j * css;
      for (int n = nl; n < N; n += 8) {
        bt[n * QS + j] = ok ? load(br + n) : 0.0f;
        ct[n * QS + j] = ok ? load(cr + n) : 0.0f;
      }
    }
  }
  for (int j = tid; j < Q; j += THREADS) dts[j] = j < nv ? dtb[j * dss] : 0.0f;
  __syncthreads();

  if (tid < 32) {
    log_decay(dts, A[h], ld, Q, tid);
    for (int i = tid; i < Q; i += 32) eld[i] = expf(ld[i]);
  }
  __syncthreads();

  // att[i][j] = (C_i . B_j) * exp(min(l_i - l_j, 0)) * dt_j for j <= i,
  // over the 4 x 4 tiles on or below the diagonal only, numbered row by
  // row: 136 of 256 at Q = 64, so whole warps skip the upper triangle (y
  // never reads it)
  const int nt = Q / TILE;
  for (int t = tid; t < nt * (nt + 1) / 2; t += THREADS) {
    int it = static_cast<int>(
        __fmul_rn(__fsub_rn(sqrtf(__fadd_rn(__fmul_rn(8.0f, t), 1.0f)),
                            1.0f),
                  0.5f));
    while (it * (it + 1) / 2 > t) --it;
    while ((it + 1) * (it + 2) / 2 <= t) ++it;
    const int i0 = it * TILE, j0 = (t - it * (it + 1) / 2) * TILE;
    float acc[TILE][TILE];
    zero(acc);
    mma(acc, ct, QS, i0, bt, QS, j0, N);
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
      *reinterpret_cast<float4*>(att + j * QS + i0) = v;
    }
  }
  __syncthreads();                  // B^T is dead: its space takes state_c

  const float4* sc = reinterpret_cast<const float4*>(
      states + (static_cast<long long>(bh) * nc + c) * N * P);
  for (int i = tid; i < N * P / 4; i += THREADS)
    reinterpret_cast<float4*>(st)[i] = sc[i];
  __syncthreads();

  // y = att @ x + exp(l) * (C @ state_c) + x * D
  for (int i0 = ty * TILE; i0 < nv; i0 += SPAN) {
    for (int p0 = tx * TILE; p0 < P; p0 += SPAN) {
      float yi[TILE][TILE], yo[TILE][TILE];
      zero(yi);
      zero(yo);
      mma(yi, att, QS, i0, xs, P, p0, min(nv, i0 + TILE));
      mma(yo, ct, QS, i0, st, P, p0, N);
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        const int i = i0 + r;
        if (i >= nv) continue;
        const float e = eld[i];
#pragma unroll
        for (int cc = 0; cc < TILE; ++cc) {
          const int p = p0 + cc;
          store(yb + i * ys + p,
                __fadd_rn(__fadd_rn(yi[r][cc], __fmul_rn(e, yo[r][cc])),
                          __fmul_rn(xs[i * P + p], dd)));
        }
      }
    }
  }
}

bool shapes_ok(int S, int H, int P, int G, int N, int Q) {
  return P > 0 && P % TILE == 0 && N > 0 && N % TILE == 0 && Q > 0 &&
         Q % TILE == 0 && G > 0 && H % G == 0 && S >= 0;
}

template <typename T>
int launch_state(const void* x, const void* dt, const void* A, const void* Bm,
                 void* states, void* decay, int B, int S, int H, int P, int G,
                 int N, int Q, const long long* s, cudaStream_t stream) {
  const size_t smem = state_smem_bytes(Q, P, N);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + Q - 1) / Q);
  chunk_state_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<float*>(states), static_cast<float*>(decay), S, H, P, G, N,
      Q, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scan(const void* x, const void* dt, const void* A, const void* Bm,
                const void* C, const void* D, const void* states, void* y,
                int B, int S, int H, int P, int G, int N, int Q,
                const long long* s, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(Q, P, N);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + Q - 1) / Q);
  chunk_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(states), static_cast<T*>(y), S, H, P, G, N, Q,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
      s[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes), launched in this order on one stream
// by the wrapper.  Strides are in elements: x's, dt's, B's and C's over
// (batch, sequence, head or group); the last dim of x, B and C is
// contiguous.  `states` is contiguous (B,H,nc,N,P) f32 with nc =
// ceil(S / Q), `decay` contiguous (B,H,nc) f32.  Each launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for shapes the
// kernels do not take (P, N or Q not a multiple of 4, H not a multiple of
// G, a phase's tiles over the shared-memory limit).

// Phase 1: the chunk summaries and each chunk's decay exp(l_last).
extern "C" int repro_ssd_chunk_state(
    const void* x, const void* dt, const void* A, const void* Bm,
    void* states, void* decay, int B, int S, int H, int P, int G, int N,
    int Q, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long bsb, long long bss, long long bsg,
    int x_bf16, void* stream) {
  if (!shapes_ok(S, H, P, G, N, Q) || B < 0 ||
      state_smem_bytes(Q, P, N) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const long long s[9] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_state<__nv_bfloat16>(x, dt, A, Bm, states, decay, B, S, H,
                                       P, G, N, Q, s, st);
  return launch_state<float>(x, dt, A, Bm, states, decay, B, S, H, P, G, N,
                             Q, s, st);
}

// Phase 2: `states` in place from S_c to the state entering chunk c, from
// `s0` (contiguous (BH,P,N) f32, or null for a zero start); the final state
// into `fin`, contiguous (BH,P,N) f32.
extern "C" int repro_ssd_state_pass(void* states, const void* decay,
                                    const void* s0, void* fin, int BH, int nc,
                                    int P, int N, void* stream) {
  if (BH < 0 || nc < 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaGetLastError());
  const int tiles = ((N + PASS_TILE - 1) / PASS_TILE) *
                    ((P + PASS_TILE - 1) / PASS_TILE);
  state_pass_kernel<<<dim3(BH, tiles), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(s0), static_cast<float*>(fin), nc, P, N);
  return static_cast<int>(cudaGetLastError());
}

// Phase 3: y, contiguous (B,S,H,P) in x's dtype (bf16 when `x_bf16`, else
// f32), from the entering states phase 2 left in `states`.
extern "C" int repro_ssd_chunk_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* C, const void* D, const void* states, void* y, int B, int S,
    int H, int P, int G, int N, int Q, long long xsb, long long xss,
    long long xsh, long long dsb, long long dss, long long dsh, long long bsb,
    long long bss, long long bsg, long long csb, long long css, long long csg,
    int x_bf16, void* stream) {
  if (!shapes_ok(S, H, P, G, N, Q) || B < 0 ||
      scan_smem_bytes(Q, P, N) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const long long s[12] = {xsb, xss, xsh, dsb, dss, dsh,
                           bsb, bss, bsg, csb, css, csg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_scan<__nv_bfloat16>(x, dt, A, Bm, C, D, states, y, B, S, H,
                                      P, G, N, Q, s, st);
  return launch_scan<float>(x, dt, A, Bm, C, D, states, y, B, S, H, P, G, N,
                            Q, s, st);
}

// Each phase's dynamic shared memory per block and the blocks of it one SM
// holds at once (phase 1 chunk_state, 2 state_pass, 3 chunk_scan), for the
// given shape and dtype.
extern "C" int repro_ssd_scan_info(int phase, int Q, int P, int N, int x_bf16,
                                   int* smem_bytes, int* blocks_per_sm) {
  const void* fn = nullptr;
  size_t smem = 0;
  if (phase == 1) {
    smem = state_smem_bytes(Q, P, N);
    fn = x_bf16 ? reinterpret_cast<const void*>(
                      chunk_state_kernel<__nv_bfloat16>)
                : reinterpret_cast<const void*>(chunk_state_kernel<float>);
  } else if (phase == 2) {
    fn = reinterpret_cast<const void*>(state_pass_kernel);
  } else if (phase == 3) {
    smem = scan_smem_bytes(Q, P, N);
    fn = x_bf16 ? reinterpret_cast<const void*>(
                      chunk_scan_kernel<__nv_bfloat16>)
                : reinterpret_cast<const void*>(chunk_scan_kernel<float>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *smem_bytes = static_cast<int>(smem);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, THREADS, smem));
}
