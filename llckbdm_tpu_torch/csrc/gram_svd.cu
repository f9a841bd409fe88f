// Batched one-sided Jacobi SVD of F = m^H for complex k x k m: singular
// values s and unitary V with m m^H = V diag(s^2) V^H, without forming m m^H.
//
// Replaces llckbdm_tpu/ops/pallas_linalg.py::_gram_svd_kernel (wrapper
// gram_svd).  Same algorithm: F^T = conj(m) and V^T are stored by rows, a
// right rotation of F is a row operation on F^T, the pair order is the
// round-robin schedule with its (i, j) orientation, and the skip rule, the
// renormalization of |w| to 1 and the t = 1 case for tau = 0 are kept.  The
// stable descending sort of s and of V's columns is done by the wrapper.
// The plain PyTorch mirror is ops/cuda_linalg.py::gram_svd_plain.
//
// Design: two lanes per pair of a round (k = 24: 12 pairs on 24 lanes;
// k = 32: 16 on 32; k = 64: 32 on 64).  Up to k = 32 a matrix takes one warp
// and a block kWarps matrices; above, a matrix takes a block of two warps
// (its pairs need more than 32 lanes).  The pairs of a round touch disjoint
// rows, so they rotate in parallel with no change to the result.  Each lane
// of a pair holds every other entry of the pair's two rows of F^T in
// registers, sums its half of the four pairwise Gram entries there, and one
// __shfl_xor_sync(.., 1) per sum completes them (the two lanes of a pair
// are neighbours in one warp): IEEE addition is commutative, so both lanes
// hold the same bits and compute the same c, s and w.  Each lane then
// rotates its half of the two rows of F^T and of V^T.  A barrier separates
// the rounds: __syncwarp, or the two-warp block's __syncthreads.  F^T and
// V^T live in shared memory with a padded row stride (2 k (k + 1) complex64
// a matrix, 66.6 KB at k = 64; a launch whose block takes more than 48 KB
// opts in to it).
//
// What bounds it now: shared-memory traffic.  Each pair step reads and
// writes four rows of k entries (two of F^T, two of V^T): ~213 GB over the
// (71680, 24, 24) batch of the main path at 7 sweeps, ~7 ms at the card's
// aggregate shared-memory bandwidth.  Device memory sees one read of m and
// one write of s and V^T.  The next step is to keep the rows in registers
// across rounds.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // k <= 32: matrices (warps) per block

// A matrix's threads (T) and a block's matrices (M) at H = k / 2.
template <int H>
struct Group {
  static constexpr int T = H > 16 ? 64 : 32;
  static constexpr int M = H > 16 ? 1 : kWarps;
};

template <int H>
__device__ __forceinline__ void group_sync() {
  if constexpr (Group<H>::T > 32)
    __syncthreads();  // the block is the matrix's two warps
  else
    __syncwarp();
}

// H = k / 2 entries of each row per lane.
template <int H>
__global__ void gram_svd_kernel(const float2* __restrict__ m,
                                float* __restrict__ sig,
                                float2* __restrict__ vt_out, int batch,
                                int sweeps) {
  constexpr int k = 2 * H, ld = k + 1, mm = k - 1, T = Group<H>::T;
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x;  // 0 .. T - 1 within the matrix
  const int b = blockIdx.x * Group<H>::M + threadIdx.y;
  if (b >= batch) return;  // the matrix's threads leave together
  float2* ft = smem + threadIdx.y * 2 * k * ld;  // F^T rows (= conj(m) rows)
  float2* vt = ft + k * ld;                      // V^T rows
  const size_t base = static_cast<size_t>(b) * k * k;
  for (int e = lane; e < k * k; e += T) {
    const float2 v = m[base + e];
    ft[(e / k) * ld + e % k] = make_float2(v.x, -v.y);
    vt[(e / k) * ld + e % k] = make_float2(e / k == e % k ? 1.0f : 0.0f, 0.0f);
  }
  group_sync<H>();

  const int q = lane >> 1;    // the pair of the round
  const int half = lane & 1;  // entries half, half + 2, ... of its rows
  const bool on = q < H;      // k = 24: lanes 24-31 follow along idle
  for (int step = 0; step < sweeps * mm; ++step) {
    const int r = step % mm;
    int i = 0, j = 0;
    if (on) {
      if (q == 0) {
        i = k - 1;
        j = r;
      } else {
        i = (r + q) % mm;
        j = (r - q + mm) % mm;
      }
    }
    float2 fi[H], fj[H];
    float gii = 0.0f, gjj = 0.0f, gr = 0.0f, gi = 0.0f;
    if (on) {  // idle lanes read no row that a pair of this round writes
#pragma unroll
      for (int e = 0; e < H; ++e) {
        fi[e] = ft[i * ld + 2 * e + half];
        fj[e] = ft[j * ld + 2 * e + half];
        gii += fi[e].x * fi[e].x + fi[e].y * fi[e].y;
        gjj += fj[e].x * fj[e].x + fj[e].y * fj[e].y;
        gr += fi[e].x * fj[e].x + fi[e].y * fj[e].y;
        gi += fi[e].x * fj[e].y - fi[e].y * fj[e].x;
      }
    }
    // the pairwise Gram entries of columns i, j of F: both halves; every
    // lane shuffles (an idle pair of lanes sums zeros and skips)
    gii += __shfl_xor_sync(0xffffffffu, gii, 1);
    gjj += __shfl_xor_sync(0xffffffffu, gjj, 1);
    gr += __shfl_xor_sync(0xffffffffu, gr, 1);
    gi += __shfl_xor_sync(0xffffffffu, gi, 1);
    const float babs = sqrtf(gr * gr + gi * gi);
    const bool skip = babs <= 1e-7f * sqrtf(gii * gjj) + 1e-30f;
    const float safe_b = skip ? 1.0f : babs;
    float wr = skip ? 1.0f : gr / safe_b;
    float wi = skip ? 0.0f : gi / safe_b;
    // |w| must be exactly 1 or the rotation scales the columns
    const float wn = rsqrtf(wr * wr + wi * wi);
    wr *= wn;
    wi *= wn;
    const float tau = (gjj - gii) / (2.0f * safe_b);
    float t = copysignf(1.0f, tau) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
    if (tau == 0.0f) t = 1.0f;
    float c = rsqrtf(1.0f + t * t);
    float s = c * t;
    if (skip) {
      c = 1.0f;
      s = 0.0f;
    }
    if (on) {
#pragma unroll
      for (int e = 0; e < H; ++e) {
        const int col = 2 * e + half;
        // column rotation (F J): f_i' = c f_i - s conj(w) f_j;
        //                        f_j' = s f_i + c conj(w) f_j
        const float2 wf = make_float2(wr * fj[e].x + wi * fj[e].y,
                                      wr * fj[e].y - wi * fj[e].x);
        ft[i * ld + col] = make_float2(c * fi[e].x - s * wf.x, c * fi[e].y - s * wf.y);
        ft[j * ld + col] = make_float2(s * fi[e].x + c * wf.x, s * fi[e].y + c * wf.y);
        // V' = V J: the V^T rows take the same coefficients
        const float2 vi = vt[i * ld + col];
        const float2 vj = vt[j * ld + col];
        const float2 wv = make_float2(wr * vj.x + wi * vj.y, wr * vj.y - wi * vj.x);
        vt[i * ld + col] = make_float2(c * vi.x - s * wv.x, c * vi.y - s * wv.y);
        vt[j * ld + col] = make_float2(s * vi.x + c * wv.x, s * vi.y + c * wv.y);
      }
    }
    group_sync<H>();  // the next round pairs rows other lanes wrote
  }

  for (int l = lane; l < k; l += T) {
    float ss = 0.0f;
    for (int e = 0; e < k; ++e) {
      const float2 f = ft[l * ld + e];
      ss += f.x * f.x + f.y * f.y;
    }
    sig[static_cast<size_t>(b) * k + l] = sqrtf(ss);
  }
  for (int e = lane; e < k * k; e += T)
    vt_out[base + e] = vt[(e / k) * ld + e % k];
}

template <int H>
int launch(const void* m, void* sig, void* vt, int batch, int sweeps,
           cudaStream_t stream) {
  constexpr int k = 2 * H;
  using G = Group<H>;
  const size_t smem = static_cast<size_t>(G::M) * 2 * k * (k + 1) * sizeof(float2);
  if (smem > 48 * 1024) {  // k = 32: 67.6 KB; k = 64: 66.6 KB
    const cudaError_t err = cudaFuncSetAttribute(
        gram_svd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return static_cast<int>(err);
    }
  }
  const dim3 block(G::T, G::M);
  const dim3 grid((batch + G::M - 1) / G::M);
  gram_svd_kernel<H><<<grid, block, smem, stream>>>(
      static_cast<const float2*>(m), static_cast<float*>(sig),
      static_cast<float2*>(vt), batch, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: (batch, k, k) complex64, k even, 2 <= k <= 64.  sig: (batch, k)
// float32, unsorted.  vt: (batch, k, k) complex64, V^T.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for another k).
extern "C" int llck_gram_svd(const void* m, void* sig, void* vt, int batch,
                             int k, int sweeps, void* stream) {
  if (batch <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define LLCK_GRAM_SVD_CASE(H) \
  case 2 * H:                 \
    return launch<H>(m, sig, vt, batch, sweeps, st);
    LLCK_GRAM_SVD_CASE(1) LLCK_GRAM_SVD_CASE(2) LLCK_GRAM_SVD_CASE(3)
    LLCK_GRAM_SVD_CASE(4) LLCK_GRAM_SVD_CASE(5) LLCK_GRAM_SVD_CASE(6)
    LLCK_GRAM_SVD_CASE(7) LLCK_GRAM_SVD_CASE(8) LLCK_GRAM_SVD_CASE(9)
    LLCK_GRAM_SVD_CASE(10) LLCK_GRAM_SVD_CASE(11) LLCK_GRAM_SVD_CASE(12)
    LLCK_GRAM_SVD_CASE(13) LLCK_GRAM_SVD_CASE(14) LLCK_GRAM_SVD_CASE(15)
    LLCK_GRAM_SVD_CASE(16) LLCK_GRAM_SVD_CASE(17) LLCK_GRAM_SVD_CASE(18)
    LLCK_GRAM_SVD_CASE(19) LLCK_GRAM_SVD_CASE(20) LLCK_GRAM_SVD_CASE(21)
    LLCK_GRAM_SVD_CASE(22) LLCK_GRAM_SVD_CASE(23) LLCK_GRAM_SVD_CASE(24)
    LLCK_GRAM_SVD_CASE(25) LLCK_GRAM_SVD_CASE(26) LLCK_GRAM_SVD_CASE(27)
    LLCK_GRAM_SVD_CASE(28) LLCK_GRAM_SVD_CASE(29) LLCK_GRAM_SVD_CASE(30)
    LLCK_GRAM_SVD_CASE(31) LLCK_GRAM_SVD_CASE(32)
#undef LLCK_GRAM_SVD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
