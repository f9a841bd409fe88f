// Batched shifted Cholesky G + shift I = R^H R (R upper) of small complex
// Hermitian matrices, and the two things built on it:
//   * cholqr_rinv: the upper-triangular R^{-1} (the CholeskyQR step), k <= 32;
//   * chol_solve:  (G + shift I) x = b by forward and back substitution,
//                  k <= 64.
//
// Replaces llckbdm_tpu/ops/pallas_linalg.py::_cholqr_kernel and
// ::_chol_solve_kernel, which share ::_chol_inplace; here they share
// chol_inplace.  Same algorithm: the per-matrix shift on the diagonal, the
// max(., 1e-30) guards on the pivots, rsqrt for the factor's row scaling and
// a division for the substitutions.  Entries below the diagonal of R are
// garbage, as in the TPU kernel, and never read.  The plain PyTorch mirrors
// are ops/cuda_linalg.py::cholqr_rinv_plain and ::chol_solve_plain.
//
// Design: one warp per matrix; lane t owns column t, and for k > 32 also
// column t + 32 (the Gauss-Newton normal equations of 32 clusters are
// 64 x 64); the matrix lives in shared memory with a padded row stride.  The
// factorization is k rank-1 row updates; R^{-1} is computed column by
// column, each lane reading only its own column of X, so no synchronisation
// is needed there; each step of a substitution is one warp shuffle
// reduction.
//
// Bound: the k sequential pivots (latency), with O(k^2) work per pivot
// spread over the lanes.  Device memory sees one read of G (and b) and one
// write of the result.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;  // matrices per block at k <= 32 (one at k > 32)

__device__ __forceinline__ float2 warp_sum2(float2 v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// In-place upper Cholesky of s + shift I (k x k, row stride ld) by one warp;
// lane t owns columns t + 32 q, q < Cols.
template <int Cols>
__device__ void chol_inplace(float2* s, int ld, int k, float shift, int lane) {
  for (int q = 0; q < Cols; ++q) {
    const int c = lane + 32 * q;
    if (c < k) s[c * ld + c].x += shift;
  }
  __syncwarp();
  for (int i = 0; i < k; ++i) {
    const float dinv = rsqrtf(fmaxf(s[i * ld + i].x, 1e-30f));
    __syncwarp();  // every lane has read the pivot before it is scaled
    for (int q = 0; q < Cols; ++q) {
      const int c = lane + 32 * q;
      if (c < k) {
        s[i * ld + c].x *= dinv;
        s[i * ld + c].y *= dinv;
      }
    }
    __syncwarp();
    // rows r > i:  row_r -= conj(R[i, r]) * R[i, :]
    for (int q = 0; q < Cols; ++q) {
      const int c = lane + 32 * q;
      if (c < k) {
        const float2 rit = s[i * ld + c];
        for (int r = i + 1; r < k; ++r) {
          const float2 cr = s[i * ld + r];
          float2& e = s[r * ld + c];
          e.x -= cr.x * rit.x + cr.y * rit.y;
          e.y -= cr.x * rit.y - cr.y * rit.x;
        }
      }
    }
    __syncwarp();
  }
}

__device__ void load_matrix(const float2* __restrict__ g, float2* s, int ld,
                            int k, int lane) {
  for (int e = lane; e < k * k; e += 32) s[(e / k) * ld + e % k] = g[e];
  __syncwarp();
}

__global__ void cholqr_rinv_kernel(const float2* __restrict__ g,
                                   const float* __restrict__ shift,
                                   float2* __restrict__ x_out, int batch,
                                   int k) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kWarps + threadIdx.y;
  if (b >= batch) return;  // the whole warp leaves together
  const int ld = k + 1;
  float2* s = smem + threadIdx.y * 2 * k * ld;
  float2* x = s + k * ld;  // X = R^{-1}, row stride ld
  const size_t base = static_cast<size_t>(b) * k * k;
  load_matrix(g + base, s, ld, k, lane);
  chol_inplace<1>(s, ld, k, shift[b], lane);

  // X[i, :] = (e_i - sum_{p>i} R[i, p] X[p, :]) / R[i, i], bottom row first
  if (lane < k) {
    for (int i = k - 1; i >= 0; --i) {
      const float dinv = 1.0f / fmaxf(s[i * ld + i].x, 1e-30f);
      float2 acc = make_float2(lane == i ? 1.0f : 0.0f, 0.0f);
      for (int p = i + 1; p < k; ++p) {
        const float2 rp = s[i * ld + p];
        const float2 xp = x[p * ld + lane];
        acc.x -= rp.x * xp.x - rp.y * xp.y;
        acc.y -= rp.x * xp.y + rp.y * xp.x;
      }
      x[i * ld + lane] = make_float2(acc.x * dinv, acc.y * dinv);
    }
  }
  __syncwarp();
  for (int e = lane; e < k * k; e += 32) x_out[base + e] = x[(e / k) * ld + e % k];
}

template <int Cols>
__global__ void chol_solve_kernel(const float2* __restrict__ g,
                                  const float2* __restrict__ rhs,
                                  const float* __restrict__ shift,
                                  float2* __restrict__ x_out, int batch,
                                  int k) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= batch) return;  // the whole warp leaves together
  const int ld = k + 1;
  float2* s = smem + threadIdx.y * k * ld;
  load_matrix(g + static_cast<size_t>(b) * k * k, s, ld, k, lane);
  chol_inplace<Cols>(s, ld, k, shift[b], lane);

  // lane t holds y[p] and then x[p] for p = t + 32 q
  float2 bl[Cols], y[Cols], x[Cols];
  for (int q = 0; q < Cols; ++q) {
    const int p = lane + 32 * q;
    bl[q] = p < k ? rhs[static_cast<size_t>(b) * k + p] : make_float2(0.0f, 0.0f);
    y[q] = x[q] = make_float2(0.0f, 0.0f);
  }
  // forward: R^H y = b:  y[i] = (b[i] - sum_{p<i} conj(R[p, i]) y[p]) / R[i, i]
  for (int i = 0; i < k; ++i) {
    float2 term = make_float2(0.0f, 0.0f);
    for (int q = 0; q < Cols; ++q) {
      const int p = lane + 32 * q;
      if (p < i) {
        const float2 rp = s[p * ld + i];
        term.x += rp.x * y[q].x + rp.y * y[q].y;
        term.y += rp.x * y[q].y - rp.y * y[q].x;
      }
    }
    const float2 sum = warp_sum2(term);
    const float dinv = 1.0f / fmaxf(s[i * ld + i].x, 1e-30f);
    for (int q = 0; q < Cols; ++q)
      if (lane + 32 * q == i)
        y[q] = make_float2((bl[q].x - sum.x) * dinv, (bl[q].y - sum.y) * dinv);
  }
  // backward: R x = y:  x[i] = (y[i] - sum_{p>i} R[i, p] x[p]) / R[i, i]
  for (int i = k - 1; i >= 0; --i) {
    float2 term = make_float2(0.0f, 0.0f);
    for (int q = 0; q < Cols; ++q) {
      const int p = lane + 32 * q;
      if (p > i && p < k) {
        const float2 rp = s[i * ld + p];
        term.x += rp.x * x[q].x - rp.y * x[q].y;
        term.y += rp.x * x[q].y + rp.y * x[q].x;
      }
    }
    const float2 sum = warp_sum2(term);
    const float dinv = 1.0f / fmaxf(s[i * ld + i].x, 1e-30f);
    for (int q = 0; q < Cols; ++q)
      if (lane + 32 * q == i)
        x[q] = make_float2((y[q].x - sum.x) * dinv, (y[q].y - sum.y) * dinv);
  }
  for (int q = 0; q < Cols; ++q) {
    const int p = lane + 32 * q;
    if (p < k) x_out[static_cast<size_t>(b) * k + p] = x[q];
  }
}

}  // namespace

// g: (batch, k, k) complex64, 1 <= k <= 32; shift: (batch,) float32.
// rinv: (batch, k, k) complex64.  Returns cudaGetLastError().
extern "C" int llck_cholqr_rinv(const void* g, const void* shift, void* rinv,
                                int batch, int k, void* stream) {
  if (batch <= 0) return 0;
  const dim3 block(32, kWarps);
  const dim3 grid((batch + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * 2 * k * (k + 1) * sizeof(float2);
  cholqr_rinv_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<const float*>(shift),
      static_cast<float2*>(rinv), batch, k);
  return static_cast<int>(cudaGetLastError());
}

// g: (batch, k, k) complex64, 1 <= k <= 64; b: (batch, k) complex64;
// shift: (batch,) float32.  x: (batch, k) complex64.  Returns
// cudaGetLastError().
extern "C" int llck_chol_solve(const void* g, const void* b, const void* shift,
                               void* x, int batch, int k, void* stream) {
  if (batch <= 0) return 0;
  const int warps = k > 32 ? 1 : kWarps;  // k = 64: 33 KB of shared memory
  const dim3 block(32, warps);
  const dim3 grid((batch + warps - 1) / warps);
  const size_t smem = static_cast<size_t>(warps) * k * (k + 1) * sizeof(float2);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float2*>(g);
  const auto* bp = static_cast<const float2*>(b);
  const auto* sp = static_cast<const float*>(shift);
  auto* xp = static_cast<float2*>(x);
  if (k > 32)
    chol_solve_kernel<2><<<grid, block, smem, st>>>(gp, bp, sp, xp, batch, k);
  else
    chol_solve_kernel<1><<<grid, block, smem, st>>>(gp, bp, sp, xp, batch, k);
  return static_cast<int>(cudaGetLastError());
}
