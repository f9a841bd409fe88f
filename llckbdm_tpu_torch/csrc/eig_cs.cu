// Batched eigenvalues of complex-symmetric matrices (A = A^T, not Hermitian)
// by sequential complex-orthogonal Jacobi rotations.
//
// Replaces llckbdm_tpu/ops/pallas_jacobi.py::_eig_cs_kernel (wrappers eig_cs
// and eig_cs_resid).  Same algorithm, formula by formula: the closed-form
// round-robin pair order of _rr_pair with its (i, j) orientation (the
// rotation is not symmetric in i and j), the two skip rules, the 1e-38 in
// cdiv, rows written first and then the columns as the transposed rows.
// The plain PyTorch mirror is ops/cuda_jacobi.py::eig_cs_resid_plain.
//
// What bounds it: the sequential rotation chain, sweeps * (n-1) * n/2
// dependent pair updates per matrix, each a shared-memory round trip and a
// __syncwarp.  The work is issue-bound, not memory-bound: device memory
// sees one read of A and one write of the diagonal, ~1% of the time.  The
// rotation parameters (two cdiv, two csqrt, four cabs in IEEE float32) are
// most of the instructions if every pair computes them on the chain.
//
// What the design does about it:
//  * A round's n/2 rotation parameters are computed at once, one pair per
//    lane, at the start of the round.  This is exact: pair k reads only
//    a[i,i], a[j,j] and a[i,j], and the other pairs of the round rotate rows
//    and columns disjoint from {i, j}, so none of them changes those three
//    entries; (c, s) and the 2x2 entry fix (nii, nij, njj) are the same
//    numbers whether computed now or just before the pair is applied.
//  * The n/2 row and column updates are then applied one after another, in
//    the round's order (applying them at once diverges:
//    llckbdm_tpu/ops/jacobi.py:232-237): each is only the 28n-flop row
//    update, lane t owning column t (and t + 32 above n = 32), reading its
//    (c, s) from shared memory.  A lane's two columns take their updates
//    one after the other within the pair step: neither reads what the other
//    writes, so one barrier a pair still suffices.  The number of columns
//    a lane owns is a template parameter, so n <= 32 compiles to the
//    one-column body.
//  * At n <= 16 a warp holds two matrices (lanes 0-15 and 16-31), so no
//    lane idles; up to n = 64 one matrix per warp (n/2 <= 32 pairs still
//    give each pair's parameters a lane of their own).
//  * The pair table (i, j) of the n - 1 rounds is built once per block.
// The matrix lives in shared memory with a padded row stride so column
// accesses do not land on one bank (n (n + 1) complex64 a matrix, 33 KB at
// n = 64: a block that takes more than 48 KB opts in to it).  Odd n is
// zero-padded by the wrapper.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per block

__device__ __forceinline__ float2 cadd(float2 x, float2 y) {
  return make_float2(x.x + y.x, x.y + y.y);
}
__device__ __forceinline__ float2 csub(float2 x, float2 y) {
  return make_float2(x.x - y.x, x.y - y.y);
}
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
}
__device__ __forceinline__ float2 cdiv(float2 x, float2 y) {
  const float d = y.x * y.x + y.y * y.y + 1e-38f;
  return make_float2((x.x * y.x + x.y * y.y) / d, (x.y * y.x - x.x * y.y) / d);
}
__device__ __forceinline__ float2 csqrt_(float2 x) {
  const float r = sqrtf(x.x * x.x + x.y * x.y);
  const float re = sqrtf(fmaxf(0.5f * (r + x.x), 0.0f));
  const float im = sqrtf(fmaxf(0.5f * (r - x.x), 0.0f));
  return make_float2(re, x.y < 0.0f ? -im : im);
}
__device__ __forceinline__ float cabs_(float2 x) {
  return sqrtf(x.x * x.x + x.y * x.y);
}

// One pair's rotation: (c, s) and the rotated 2x2 block's entries.
struct Rot {
  float2 c, s, nii, nij, njj;
};

__device__ Rot rotation(float2 av, float2 dv, float2 bv) {
  const float2 one = make_float2(1.0f, 0.0f);
  const float babs = cabs_(bv);
  const float dscale =
      sqrtf(av.x * av.x + av.y * av.y + dv.x * dv.x + dv.y * dv.y) + 1e-30f;
  bool skip = babs <= 1e-7f * dscale;

  // tau = (d - a) / (2 b);  root = sqrt(tau^2 + 1)
  const float2 tau = cdiv(csub(dv, av), make_float2(2.0f * bv.x, 2.0f * bv.y));
  const float2 root = csqrt_(make_float2(tau.x * tau.x - tau.y * tau.y + 1.0f,
                                         2.0f * tau.x * tau.y));
  const float2 p1 = cadd(tau, root);
  const float2 p2 = csub(tau, root);
  const float2 t = cdiv(one, cabs_(p1) >= cabs_(p2) ? p1 : p2);
  // c = 1/sqrt(1 + t^2), s = c t;  guard near-defective pairs
  const float2 ct2 = make_float2(t.x * t.x - t.y * t.y + 1.0f, 2.0f * t.x * t.y);
  skip = skip || (cabs_(ct2) < 1e-12f);
  Rot q;
  q.c = cdiv(one, csqrt_(ct2));
  q.s = cmul(q.c, t);
  if (skip) {
    q.c = one;
    q.s = make_float2(0.0f, 0.0f);
  }
  // 2x2 entry fix: B2 = J^T [[a, b], [b, d]];  A' entries = B2 J.
  const float2 b00 = csub(cmul(q.c, av), cmul(q.s, bv));
  const float2 b01 = csub(cmul(q.c, bv), cmul(q.s, dv));
  const float2 b10 = cadd(cmul(q.s, av), cmul(q.c, bv));
  const float2 b11 = cadd(cmul(q.s, bv), cmul(q.c, dv));
  q.nii = csub(cmul(q.c, b00), cmul(q.s, b01));
  q.nij = cadd(cmul(q.s, b00), cmul(q.c, b01));
  q.njj = cadd(cmul(q.s, b10), cmul(q.c, b11));
  return q;
}

// per_warp matrices per warp (2 at n <= 16, else 1); lane t of a matrix's
// lanes = 32 / per_warp owns the columns t + lanes q below n, q < Cols.
template <int Cols>
__global__ void eig_cs_kernel(const float2* __restrict__ a,
                              float2* __restrict__ mu,
                              float* __restrict__ resid,
                              int batch, int n, int sweeps, int per_warp) {
  extern __shared__ float2 smem[];
  const int h = n / 2, m = n - 1, ld = n + 1;
  const int per_block = kWarps * per_warp;
  // shared memory: the (i | j << 16) pair table of the m rounds, then the
  // matrices, then each matrix's h rotations of the current round
  int* tab = reinterpret_cast<int*>(smem);
  float2* mats = smem + (m * h + 1) / 2;
  Rot* rots = reinterpret_cast<Rot*>(mats + per_block * n * ld);

  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < m * h; e += 32 * kWarps) {
    const int r = e / h, k = e % h;
    const int i = k == 0 ? n - 1 : (r + k) % m;
    const int j = k == 0 ? r : (r - k + m) % m;
    tab[e] = i | (j << 16);
  }
  __syncthreads();

  const int lanes = 32 / per_warp;
  const int sub = threadIdx.x / lanes;
  const int t = threadIdx.x % lanes;
  const int slot = threadIdx.y * per_warp + sub;
  const int first = blockIdx.x * per_block + threadIdx.y * per_warp;
  if (first >= batch) return;  // the whole warp leaves together
  const int b = first + sub;
  const bool active = b < batch;  // the warp's second matrix may be past the end
  float2* s = mats + slot * n * ld;
  Rot* rot = rots + slot * h;
  const float2* src = a + static_cast<size_t>(b) * n * n;
  for (int e = t; e < n * n; e += lanes)
    s[(e / n) * ld + e % n] = active ? src[e] : make_float2(0.0f, 0.0f);
  __syncwarp();

  for (int step = 0; step < sweeps * m; ++step) {
    const int* row = tab + (step % m) * h;
    if (t < h) {  // the round's rotations, one pair per lane
      const int i = row[t] & 0xffff, j = row[t] >> 16;
      rot[t] = rotation(s[i * ld + i], s[j * ld + j], s[i * ld + j]);
    }
    __syncwarp();
    for (int k = 0; k < h; ++k) {  // applied one after another
      const int i = row[k] & 0xffff, j = row[k] >> 16;
#pragma unroll
      for (int q = 0; q < Cols; ++q) {  // the lane's columns
        const int col = t + q * lanes;
        if (col >= n) continue;
        float2 ni, nj;
        if (col == i) {
          ni = rot[k].nii;
          nj = rot[k].nij;
        } else if (col == j) {
          ni = rot[k].nij;
          nj = rot[k].njj;
        } else {
          // Row update (J^T A): row_i' = c ri - s rj;  row_j' = s ri + c rj
          const float2 c = rot[k].c, sn = rot[k].s;
          const float2 ri = s[i * ld + col], rj = s[j * ld + col];
          ni = csub(cmul(c, ri), cmul(sn, rj));
          nj = cadd(cmul(sn, ri), cmul(c, rj));
        }
        s[i * ld + col] = ni;
        s[j * ld + col] = nj;
        // columns = transposed rows (complex-symmetric)
        s[col * ld + i] = ni;
        s[col * ld + j] = nj;
      }
      __syncwarp();
    }
  }

  // eigenvalues on the diagonal; off-diagonal energy with the diagonal
  // excluded by mask (subtracting it cancels to 0 in f32)
  float off = 0.0f;
#pragma unroll
  for (int q = 0; q < Cols; ++q) {
    const int r = t + q * lanes;
    if (r >= n) continue;
    if (active) mu[static_cast<size_t>(b) * n + r] = s[r * ld + r];
    for (int col = 0; col < n; ++col) {
      if (col != r) {
        const float2 v = s[r * ld + col];
        off += v.x * v.x + v.y * v.y;
      }
    }
  }
  for (int o = lanes / 2; o > 0; o >>= 1)
    off += __shfl_xor_sync(0xffffffffu, off, o);
  if (t == 0 && active) resid[b] = sqrtf(fmaxf(off, 0.0f));
}

}  // namespace

// a: (batch, n, n) complex64, n even, 2 <= n <= 64.  mu: (batch, n)
// complex64.  resid: (batch,) float32.  Returns cudaGetLastError().
extern "C" int llck_eig_cs(const void* a, void* mu, void* resid, int batch,
                           int n, int sweeps, void* stream) {
  if (batch <= 0) return 0;
  const int per_warp = n <= 16 ? 2 : 1;
  const int per_block = kWarps * per_warp;
  const dim3 block(32, kWarps);
  const dim3 grid((batch + per_block - 1) / per_block);
  const int h = n / 2;
  const size_t smem = ((n - 1) * h + 1) / 2 * sizeof(float2) +
                      static_cast<size_t>(per_block) * n * (n + 1) * sizeof(float2) +
                      static_cast<size_t>(per_block) * h * sizeof(Rot);
  // one column a lane up to n = 32, two above
  void (*kernel)(const float2*, float2*, float*, int, int, int, int) =
      n <= 32 ? eig_cs_kernel<1> : eig_cs_kernel<2>;
  if (smem > 48 * 1024) {  // n = 64: 146 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return static_cast<int>(err);
    }
  }
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<float2*>(mu),
      static_cast<float*>(resid), batch, n, sweeps, per_warp);
  return static_cast<int>(cudaGetLastError());
}
