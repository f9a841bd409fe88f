// Batched shifted Cholesky G + shift I = R^H R (R upper) of small complex
// Hermitian matrices, and the two things built on it:
//   * cholqr_rinv: the upper-triangular R^{-1} (the CholeskyQR step), k <= 64;
//   * chol_solve:  (G + shift I) x = b by forward and back substitution,
//                  k <= 64.
//
// Replaces llckbdm_tpu/ops/pallas_linalg.py::_cholqr_kernel and
// ::_chol_solve_kernel, which share ::_chol_inplace; here they share
// factor().  Same algorithm: the per-matrix shift on the diagonal, the
// max(., 1e-30) guards on the pivots, rsqrt for the factor's row scaling, a
// division for the substitutions, a strictly zero lower triangle of R^{-1}.
// Entries below the diagonal of R are garbage, as in the TPU kernel, and
// never read.  The plain PyTorch mirrors are
// ops/cuda_linalg.py::cholqr_rinv_plain and ::chol_solve_plain.
//
// What bounds them on an H100: device memory sees one read of G (and b) and
// one write of the result, and that traffic is the bound (bytes).  What the
// kernels lose time on is (1) the chain of k dependent pivots, each a round
// trip through whatever holds the matrix; (2) the instructions issued around
// the 4 k^3 / 3 useful flops: with a column a lane, every lane runs every
// row update, though only those on or above the diagonal are ever read; and
// (3) the way from shared memory back to the registers, 128 bytes a cycle an
// SM however many lanes read one address: a coefficient sent to 32 lanes
// costs two cycles, as much as the four multiply-adds it feeds in a lane
// that holds one column.
//
// What the design does about it:
//  * Sizes are template parameters K (cholqr_rinv: 16, 24, 32, 64;
//    chol_solve: 16, 32, 48, 64), so every loop unrolls and every entry has
//    a register.  Any
//    other k runs in the next K above it: lanes and rows at or beyond k hold
//    the identity, and since the factor of blockdiag(G, I) is
//    blockdiag(R, .), the leading k x k block is exact.
//  * A lane holds two columns, c and c + K / 2, loaded straight from device
//    memory a row at a time: every coefficient read from shared memory feeds
//    two columns, and K / 2 lanes make a matrix, so a warp holds 4, 2, 2
//    matrices at K = 16, 24, 32 (at 24, eight lanes of a warp idle).
//  * The lower column's entries from row K / 2 on lie left of the diagonal:
//    they are not loaded, held or updated (5/8 of the updates and 3/4 of the
//    registers of the full columns remain).
//  * One barrier a pivot, no shuffle: row i + 1 is the first that pivot i
//    updates, and it is written to shared memory at once, still unscaled;
//    after the barrier every lane reads the pivot d and the coefficients
//    from that row as 16-byte broadcasts (two coefficients a load) and
//    scales by rsqrt(max(d, 1e-30)) itself.  The scaled row replaces it a
//    barrier later, so the finished R sits in shared memory (K * LD * 8
//    bytes a matrix) for the second stage.
//  * cholqr_rinv's inverse keeps the lane's two columns of X in registers
//    (no other lane reads them), reads R[i, p] as broadcasts and stores X
//    row by row.
//  * chol_solve's forward substitution rides on the factorization, one
//    pivot behind it: the lane holds b at its columns' indices; lane p
//    publishes y[p] beside row p + 1, and a lane takes conj(R[p, i]) y[p]
//    off its entries, R[p, i] being its own register.  The backward
//    substitution is column-oriented too: x[p] goes round by one shuffle,
//    and a lane takes R[i, p] x[p] off its two entries; its rows of R come
//    from shared memory 16 steps at a time (row stride K + 2: the lanes'
//    16-byte loads fall on distinct banks).
//  * At K = 48 and 64 a matrix takes a block of four warps: each holds the
//    same two columns a lane and every fourth row, so a coefficient goes to
//    one warp only; the barrier is the block's.  At K = 48 a warp's lanes
//    24-31 hold no column: they follow lane 0's arithmetic (so every address
//    they read lies in the matrix) and write nothing.  chol_solve's backward
//    substitution runs on the first warp (its shuffles span the whole warp
//    at K = 48, where 24 lanes are no power of two).  cholqr_rinv's inverse
//    gives each of the first K threads one column of X, all its rows in
//    registers, read against the rows of R in shared memory as broadcasts;
//    it is compiled at K = 64 alone above 32 (at 48 ptxas held it to 128
//    registers and spilled; splitting a column over two threads put X in
//    local memory, 0.45 ms at (2048, 64, 64) on an H100).
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 2;  // columns of its matrix that a lane holds

template <int K>
struct Shape {
  static_assert(K % 4 == 0 && K >= 4 && K <= 64, "K a multiple of 4, at most 64");
  static constexpr int kWarpsPerMat = K > 32 ? 4 : 1;
  static constexpr int kLanes = K / kCols;           // lanes a matrix takes
  static constexpr int kRows = K / kWarpsPerMat;     // rows of a column a lane holds
  static constexpr int kMatsPerWarp = 32 / kLanes;   // 4, 2, 2, 1, 1 at K = 16, 24, 32, 48, 64
  static constexpr int kBlockWarps =
      kWarpsPerMat > 1 ? kWarpsPerMat : (K <= 24 ? 4 : 2);
  static constexpr int kMatsPerBlock =
      kWarpsPerMat > 1 ? 1 : kBlockWarps * kMatsPerWarp;
  static constexpr int kThreads = 32 * kBlockWarps;
};

// Where a thread stands: matrix b of the batch, in the block's shared-memory
// slot; its columns are c + kLanes q; it holds their rows j kWarpsPerMat + w.
// owns: the lane has columns (at K = 24 and 48 a warp's last 8 lanes have
// none; at K = 48 they take c = 0 and compute what lane 0 computes).
struct Place {
  int b, slot, c, w;
  bool owns;
};

template <int K>
__device__ __forceinline__ Place place() {
  using S = Shape<K>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Place p;
  if constexpr (S::kWarpsPerMat > 1) {
    const bool owns = lane < S::kLanes;
    p = Place{static_cast<int>(blockIdx.x), 0, owns ? lane : 0, warp, owns};
  } else {
    const int sub = lane / S::kLanes;
    p.owns = sub < S::kMatsPerWarp;
    p.slot = warp * S::kMatsPerWarp + (p.owns ? sub : 0);
    p.b = blockIdx.x * S::kMatsPerBlock + p.slot;
    p.c = lane % S::kLanes;
    p.w = 0;
  }
  return p;
}

template <int K>
__device__ __forceinline__ void group_sync() {
  if constexpr (Shape<K>::kWarpsPerMat > 1)
    __syncthreads();
  else
    __syncwarp();
}

// A lane's lower columns, c < kLanes, lie left of the diagonal from row
// kLanes on: those entries of R and of R^-1 are never read (or are 0), so
// they are neither loaded, held nor updated.  needs(q, r): column group q
// has work in row r.  Where a matrix spans several warps nothing is left
// out: there the kernel measured slower without those updates (0.178 ms
// against 0.134 ms at (2048, 64, 64) on an H100).
template <int K>
__device__ __forceinline__ constexpr bool needs(int q, int r) {
  return q > 0 || r < Shape<K>::kLanes || Shape<K>::kWarpsPerMat > 1;
}

// acc -= conj(a) * b and acc -= a * b, two fused multiply-adds a component
__device__ __forceinline__ void csub_conj_mul(float2& acc, float ax, float ay,
                                              float2 b) {
  acc.x = fmaf(-ax, b.x, acc.x);
  acc.x = fmaf(-ay, b.y, acc.x);
  acc.y = fmaf(-ax, b.y, acc.y);
  acc.y = fmaf(ay, b.x, acc.y);
}
__device__ __forceinline__ void csub_mul(float2& acc, float ax, float ay,
                                         float2 b) {
  acc.x = fmaf(-ax, b.x, acc.x);
  acc.x = fmaf(ay, b.y, acc.x);
  acc.y = fmaf(-ax, b.y, acc.y);
  acc.y = fmaf(-ay, b.x, acc.y);
}

// The lane's entries of the leading keff x keff block of g (row stride k),
// the identity beyond it (keff = 0: the whole identity, for a lane without
// a matrix).
template <int K>
__device__ __forceinline__ void load_columns(
    float2 (&e)[kCols][Shape<K>::kRows], const float2* __restrict__ g, int k,
    int keff, int c, int w) {
  using S = Shape<K>;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      if (!needs<K>(q, j * S::kWarpsPerMat)) continue;
      const int r = j * S::kWarpsPerMat + w, cc = c + S::kLanes * q;
      e[q][j] = (r < keff && cc < keff)
                    ? g[r * k + cc]
                    : make_float2(r == cc ? 1.0f : 0.0f, 0.0f);
    }
  }
}

// Upper Cholesky of e + shift I; afterwards s_r[i * LD + .] holds row i of
// R.  One barrier a pivot: a row is published as soon as the pivot before it
// has updated it, still unscaled (u), so the next pivot reads d = u[i, i]
// and its coefficients u[i, r] in one round trip; with dinv = rsqrt(max(d,
// 1e-30)), R[i, c] = u[i, c] dinv, and the update row_r -= conj(R[i, r])
// R[i, :] is taken as conj(u[i, r]) (R[i, c] dinv).  The scaled row replaces
// the unscaled one a barrier later.  With kSolve, the lane also carries
// acc[q] = b[c + kLanes q] through the forward substitution R^H y = b, one
// pivot behind the factorization, and y[i] is written to s_y[i].  Ends with
// a barrier: all of s_r and s_y is visible.
template <int K, int LD, bool kSolve>
__device__ __forceinline__ void factor(float2 (&e)[kCols][Shape<K>::kRows],
                                       float2* s_r, float2* s_y,
                                       const Place& at, float shift,
                                       float2 (&acc)[kCols]) {
  using S = Shape<K>;
  constexpr int W = S::kWarpsPerMat, L = S::kLanes, R = S::kRows;
  static_assert(LD % 2 == 0, "rows of s_r start on 16 bytes");
  const int c = at.c, w = at.w;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (needs<K>(q, j * W)) e[q][j].x += j * W + w == c + L * q ? shift : 0.0f;
  }
  if (at.owns && w == 0) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) s_r[c + L * q] = e[q][0];
  }
  group_sync<K>();
  float2 prev[kCols];  // R[i - 1, c + L q]
#pragma unroll
  for (int q = 0; q < kCols; ++q) prev[q] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float dinv = rsqrtf(fmaxf(s_r[i * LD + i].x, 1e-30f));
    float2 ric[kCols], wv[kCols];  // R[i, c + L q], and that times dinv
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      float2 u = make_float2(0.0f, 0.0f);
      if (needs<K>(q, i)) {
        if constexpr (W == 1)
          u = e[q][i];
        else
          u = s_r[i * LD + c + L * q];
      }
      ric[q] = make_float2(u.x * dinv, u.y * dinv);
      wv[q] = make_float2(ric[q].x * dinv, ric[q].y * dinv);
    }
    // rows r > i:  row_r -= conj(R[i, r]) * R[i, :]; row i + 1 is final
    // after its turn, the first, and is published at once
    if constexpr (W == 1) {
#pragma unroll
      for (int r = (i + 1) & ~1; r < K; r += 2) {  // two coefficients a load
        const float4 cf = *reinterpret_cast<const float4*>(&s_r[i * LD + r]);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (!needs<K>(q, r)) continue;  // r even, kLanes even: r + 1 alike
          if (r > i) csub_conj_mul(e[q][r], cf.x, cf.y, wv[q]);
          csub_conj_mul(e[q][r + 1], cf.z, cf.w, wv[q]);
          if ((r == i + 1 || r == i) && at.owns)
            s_r[(i + 1) * LD + c + L * q] = e[q][i + 1];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j * W + W - 1 > i) {  // some warp's row j is below the pivot
          const int r = j * W + w;
          // only the row block that holds the pivot has to ask its warp
          if (j * W > i || r > i) {
            const float2 cf = s_r[i * LD + r];
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              if (!needs<K>(q, j * W)) continue;
              csub_conj_mul(e[q][j], cf.x, cf.y, wv[q]);
              if (j == (i + 1) / W && w == (i + 1) % W && at.owns)
                s_r[(i + 1) * LD + c + L * q] = e[q][j];
            }
          }
        }
      }
    }
    // no one reads u[i - 1, .] now: the row's place takes R[i - 1, .]
    if (i > 0 && at.owns && (W == 1 || w == (i - 1) % W)) {
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (needs<K>(q, i - 1)) s_r[(i - 1) * LD + c + L * q] = prev[q];
    }
    if constexpr (kSolve) {
      // y[i] = (b[i] - sum_{p<i} conj(R[p, i]) y[p]) / R[i, i]
      if (i > 0) {
        const float2 yp = s_y[i - 1];
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          if (needs<K>(q, i - 1) && c + L * q > i - 1)
            csub_conj_mul(acc[q], prev[q].x, prev[q].y, yp);
      }
      if (c == i % L && w == 0 && at.owns) {
        const float yinv = 1.0f / fmaxf(ric[i / L].x, 1e-30f);
        s_y[i] = make_float2(acc[i / L].x * yinv, acc[i / L].y * yinv);
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) prev[q] = ric[q];
    group_sync<K>();
  }
  if (at.owns && (W == 1 || w == (K - 1) % W)) {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (needs<K>(q, K - 1)) s_r[(K - 1) * LD + c + L * q] = prev[q];
  }
  group_sync<K>();
}

template <int K>
__global__ void __launch_bounds__(Shape<K>::kThreads)
    cholqr_rinv_kernel(const float2* __restrict__ g,
                       const float* __restrict__ shift,
                       float2* __restrict__ x_out, int batch, int k) {
  using S = Shape<K>;
  constexpr int LD = K, L = S::kLanes;
  __shared__ __align__(16) float2 smem[S::kMatsPerBlock * K * LD];
  const Place at = place<K>();
  if constexpr (S::kWarpsPerMat == 1) {
    // the whole warp leaves together: its first matrix is past the end
    if (blockIdx.x * S::kMatsPerBlock + threadIdx.x / 32 * S::kMatsPerWarp >= batch)
      return;
  }
  const bool active = at.owns && at.b < batch;
  const int c = at.c;
  float2* s_r = smem + at.slot * K * LD;
  const size_t base = static_cast<size_t>(active ? at.b : 0) * k * k;

  float2 e[kCols][S::kRows];
  load_columns<K>(e, g + base, k, active ? k : 0, c, at.w);
  float2 unused[kCols];
  factor<K, LD, false>(e, s_r, nullptr, at, active ? shift[at.b] : 0.0f, unused);

  // X[i, :] = (e_i - sum_{p>i} R[i, p] X[p, :]) / R[i, i], bottom row first
  if constexpr (S::kWarpsPerMat == 1) {
    // the lane holds columns c + L q of X
    float2 x[kCols][K];
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      const float dinv = 1.0f / fmaxf(s_r[i * LD + i].x, 1e-30f);
      float2 acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        acc[q] = make_float2(c + L * q == i ? 1.0f : 0.0f, 0.0f);
#pragma unroll
      for (int p = (i + 1) & ~1; p < K; p += 2) {
        const float4 rp = *reinterpret_cast<const float4*>(&s_r[i * LD + p]);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (!needs<K>(q, p)) continue;  // X[p, c] = 0 there
          if (p > i) csub_mul(acc[q], rp.x, rp.y, x[q][p]);
          csub_mul(acc[q], rp.z, rp.w, x[q][p + 1]);
        }
      }
      // strictly zero below the diagonal, whatever R holds
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        x[q][i] = (!needs<K>(q, i) || c + L * q < i)
                      ? make_float2(0.0f, 0.0f)
                      : make_float2(acc[q].x * dinv, acc[q].y * dinv);
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int cc = c + L * q;
#pragma unroll
        for (int i = 0; i < K; ++i)
          if (i < k && cc < k) x_out[base + i * k + cc] = x[q][i];
      }
    }
  } else {
    // a matrix a block: thread cc < K holds column cc of X, all K rows in
    // registers; R comes from shared memory as broadcasts
    const int cc = threadIdx.x;
    if (cc >= K) return;  // whole warps leave
    const size_t mat = static_cast<size_t>(blockIdx.x) * k * k;
    float2 x[K];
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      const float dinv = 1.0f / fmaxf(s_r[i * LD + i].x, 1e-30f);
      float2 acc = make_float2(cc == i ? 1.0f : 0.0f, 0.0f);
#pragma unroll
      for (int p = (i + 1) & ~1; p < K; p += 2) {
        const float4 rp = *reinterpret_cast<const float4*>(&s_r[i * LD + p]);
        if (p > i) csub_mul(acc, rp.x, rp.y, x[p]);
        csub_mul(acc, rp.z, rp.w, x[p + 1]);
      }
      // strictly zero below the diagonal, whatever R holds
      x[i] = cc < i ? make_float2(0.0f, 0.0f)
                    : make_float2(acc.x * dinv, acc.y * dinv);
    }
    if (cc < k) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (i < k) x_out[mat + i * k + cc] = x[i];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(Shape<K>::kThreads)
    chol_solve_kernel(const float2* __restrict__ g,
                      const float2* __restrict__ rhs,
                      const float* __restrict__ shift,
                      float2* __restrict__ x_out, int batch, int k) {
  using S = Shape<K>;
  static_assert(K % 16 == 0 && (S::kMatsPerWarp * S::kLanes == 32 ||
                                 S::kWarpsPerMat > 1),
                "chol_solve: K = 16, 32, 48 or 64, no idle lane within a warp");
  constexpr int LD = K + 2;         // row stride of R in shared memory
  constexpr int kMat = K * LD + K;  // R, then y
  constexpr int L = S::kLanes, kChunk = 16;
  // the backward substitution's shuffles: within a matrix's lanes where a
  // warp holds several, else the whole warp (L = 24 is no power of two)
  constexpr int kWidth = S::kMatsPerWarp > 1 ? L : 32;
  __shared__ __align__(16) float2 smem[S::kMatsPerBlock * kMat];
  const Place at = place<K>();
  if constexpr (S::kWarpsPerMat == 1) {
    // the whole warp leaves together: its first matrix is past the end
    if (blockIdx.x * S::kMatsPerBlock + threadIdx.x / 32 * S::kMatsPerWarp >= batch)
      return;
  }
  const bool active = at.b < batch;
  const int c = at.c;
  float2* s_r = smem + at.slot * kMat;
  float2* s_y = s_r + K * LD;
  const size_t mat = static_cast<size_t>(active ? at.b : 0);

  float2 e[kCols][S::kRows];
  load_columns<K>(e, g + mat * k * k, k, active ? k : 0, c, at.w);
  float2 xa[kCols];  // b, then y, then x, at rows c + L q
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    xa[q] = (active && c + L * q < k) ? rhs[mat * k + c + L * q]
                                      : make_float2(0.0f, 0.0f);
  factor<K, LD, true>(e, s_r, s_y, at, active ? shift[at.b] : 0.0f, xa);

  // backward: R x = y:  x[i] = (y[i] - sum_{p>i} R[i, p] x[p]) / R[i, i],
  // by the matrix's first warp
  if (at.w != 0) return;
  float xinv[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int r = c + L * q;
    xa[q] = s_y[r];
    xinv[q] = 1.0f / fmaxf(s_r[r * LD + r].x, 1e-30f);
  }
#pragma unroll
  for (int p0 = K - kChunk; p0 >= 0; p0 -= kChunk) {
    float2 row[kCols][kChunk];  // R[c + L q, p0 .. p0 + kChunk)
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
#pragma unroll
      for (int j = 0; j < kChunk; j += 2) {
        const float4 v = *reinterpret_cast<const float4*>(
            &s_r[(c + L * q) * LD + p0 + j]);
        row[q][j] = make_float2(v.x, v.y);
        row[q][j + 1] = make_float2(v.z, v.w);
      }
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const int p = p0 + j;
      // x[p] is final: send it round from the lane that holds row p
      float2 xp;
      xp.x = __shfl_sync(0xffffffffu, xa[p / L].x * xinv[p / L], p % L, kWidth);
      xp.y = __shfl_sync(0xffffffffu, xa[p / L].y * xinv[p / L], p % L, kWidth);
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (c + L * q < p) csub_mul(xa[q], row[q][j].x, row[q][j].y, xp);
    }
  }
  if (active && at.owns) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int r = c + L * q;
      if (r < k)
        x_out[mat * k + r] = make_float2(xa[q].x * xinv[q], xa[q].y * xinv[q]);
    }
  }
}

template <int K>
int launch_cholqr_rinv(const void* g, const void* shift, void* rinv, int batch,
                       int k, void* stream) {
  using S = Shape<K>;
  const int grid = (batch + S::kMatsPerBlock - 1) / S::kMatsPerBlock;
  cholqr_rinv_kernel<K><<<grid, S::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<const float*>(shift),
      static_cast<float2*>(rinv), batch, k);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_chol_solve(const void* g, const void* b, const void* shift, void* x,
                      int batch, int k, void* stream) {
  using S = Shape<K>;
  const int grid = (batch + S::kMatsPerBlock - 1) / S::kMatsPerBlock;
  chol_solve_kernel<K><<<grid, S::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<const float2*>(b),
      static_cast<const float*>(shift), static_cast<float2*>(x), batch, k);
  return static_cast<int>(cudaGetLastError());
}

// What one instantiation takes of an SM: out = {K, registers per thread,
// static shared bytes per block, local (spill and stack) bytes per thread,
// threads per block, resident blocks per SM}.
template <typename Kernel>
int resources(Kernel kernel, int big_k, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = big_k;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = threads;
  out[5] = blocks;
  return 0;
}

}  // namespace

// g: (batch, k, k) complex64, 1 <= k <= 64; shift: (batch,) float32.
// rinv: (batch, k, k) complex64.  Returns cudaGetLastError().
extern "C" int llck_cholqr_rinv(const void* g, const void* shift, void* rinv,
                                int batch, int k, void* stream) {
  if (batch <= 0) return 0;
  if (k <= 16) return launch_cholqr_rinv<16>(g, shift, rinv, batch, k, stream);
  if (k <= 24) return launch_cholqr_rinv<24>(g, shift, rinv, batch, k, stream);
  if (k <= 32) return launch_cholqr_rinv<32>(g, shift, rinv, batch, k, stream);
  return launch_cholqr_rinv<64>(g, shift, rinv, batch, k, stream);
}

// g: (batch, k, k) complex64, 1 <= k <= 64; b: (batch, k) complex64;
// shift: (batch,) float32.  x: (batch, k) complex64.  Returns
// cudaGetLastError().
extern "C" int llck_chol_solve(const void* g, const void* b, const void* shift,
                               void* x, int batch, int k, void* stream) {
  if (batch <= 0) return 0;
  if (k <= 16) return launch_chol_solve<16>(g, b, shift, x, batch, k, stream);
  if (k <= 32) return launch_chol_solve<32>(g, b, shift, x, batch, k, stream);
  if (k <= 48) return launch_chol_solve<48>(g, b, shift, x, batch, k, stream);
  return launch_chol_solve<64>(g, b, shift, x, batch, k, stream);
}

// The instantiation that size k runs in (solve != 0: chol_solve, else
// cholqr_rinv): out[6] as resources() fills it.  Returns a CUDA error code.
extern "C" int llck_chol_resources(int solve, int k, int* out) {
  if (solve) {
    if (k <= 16) return resources(chol_solve_kernel<16>, 16, Shape<16>::kThreads, out);
    if (k <= 32) return resources(chol_solve_kernel<32>, 32, Shape<32>::kThreads, out);
    if (k <= 48) return resources(chol_solve_kernel<48>, 48, Shape<48>::kThreads, out);
    return resources(chol_solve_kernel<64>, 64, Shape<64>::kThreads, out);
  }
  if (k <= 16) return resources(cholqr_rinv_kernel<16>, 16, Shape<16>::kThreads, out);
  if (k <= 24) return resources(cholqr_rinv_kernel<24>, 24, Shape<24>::kThreads, out);
  if (k <= 32) return resources(cholqr_rinv_kernel<32>, 32, Shape<32>::kThreads, out);
  return resources(cholqr_rinv_kernel<64>, 64, Shape<64>::kThreads, out);
}
