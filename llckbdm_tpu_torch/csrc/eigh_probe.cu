// Two-sided Hermitian Jacobi cost probe, with three ablation switches.
//
// Replaces tools/bench_eigh_variants.py::make_kernel, which isolated the
// per-pair costs of a Hermitian Jacobi kernel on the TPU.  It is a cost
// probe, not an eigensolver: V starts from A, not from I, and the "column
// update" copies the conjugate of each rotated row into the column instead
// of rotating the columns, so w is not the spectrum of A.  This kernel
// computes what the probe computes, formula by formula and in its order:
//  - the round-robin pairs (i, j) of each of sweeps * (n - 1) rounds;
//  - skip when |b| <= 1e-7 sqrt(a_ii^2 + a_jj^2), b = S[i, j], on the real
//    parts of the diagonal;
//  - w = b / |b|, tau = (a_jj - a_ii) / (2 |b|),
//    t = sign(tau) / (|tau| + sqrt(1 + tau^2)) with sign(0) = 0 as in
//    jnp.sign (copysignf would turn t = 0 into a 45 degree rotation),
//    c = rsqrt(1 + t^2), s = c t;
//  - DoRows: row_i = c row_i - s w row_j, row_j = s row_i + c w row_j;
//    DoCols (only with DoRows): column i = conj(row_i), column j =
//    conj(row_j), written after both rows, so the columns win where they
//    cross the rows; DoV (only with DoRows): V's rows i and j rotated the
//    same way with conj(w).
// Outputs: w = the real diagonal of S, and per matrix |S|_F, |V|_F and the
// sum of c + s over all pairs.  The TPU kernel wrote only w.  The checksums
// keep work live that nothing else reads and nvcc would drop: the V
// rotations, and with DoRows off the coefficients themselves.  |S|_F and
// |V|_F are also what the tests check at full size, where the rotation chain
// is chaotic: each row step is unitary, so |V|_F = |A|_F, and |S|_F = |A|_F
// unless DoCols.  The coefficient sum is taken one lane a pair slot and
// then across the warp, so its rounding order is not the plain version's
// pair-by-pair order (agreement to 1e-5 relative).
//
// Layout: (batch, n, n) complex64 (the TPU had (n, n, batch) real and
// imaginary planes).  One warp per matrix; lane t owns columns t and t + 32
// (even n <= 64).  S and V live in shared memory with a padded row stride
// (row and column accesses both spread over the banks).  per_block matrices
// (warps) per block is a launch parameter, the counterpart of the TPU's
// b_blk, capped at what fits in a block's shared memory; the result does
// not depend on it.
//
// Bound: operations (tools/bounds.py: ~25 flops a pair for the
// coefficients, 18n for each pair of rows of S and of V).  What held the
// first design far from it was the sequential chain: at every pair
// all 32 lanes recomputed the same parameters after a shared-memory read
// (three sqrt, three IEEE divisions and an rsqrt in a row) and then took up
// to three __syncwarp.  What this design does about it:
//  * A round's n/2 parameter sets (c, s, w) are computed at once, one lane
//    a pair, at the start of the round.  This is exact in every variant:
//    pair k reads S[i,i], S[j,j] and S[i,j], and the other pairs of the round
//    write only their own rows and (DoCols) their own columns, disjoint from
//    {i, j}, so no earlier pair of the round changes what pair k reads.
//  * Without DoCols the round's row rotations touch disjoint rows and each
//    lane only its own columns: all n/2 are applied with no barrier between
//    them, the same bits as the sequential loop.  The coefficient-only
//    variant writes nothing and takes no barrier at all.
//  * With DoCols the round's order is kept (a column write of one pair
//    changes entries that later pairs' rows read), but each pair step is the
//    row update and the column write behind one __syncwarp.  The two
//    entries where pair (i, j)'s rows and columns cross, S[i, j] and S[j, i],
//    are the only ones another lane reads within the same pair step; their
//    column values are held back in a register and stored at the end of the
//    round, before the barrier that ends it: no other pair of the round
//    reads or writes them.
//  * Pair indices come from the round by an add and a compare, not a
//    division.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 2;  // columns a lane owns: t and t + 32

__device__ __forceinline__ float2 conj_(float2 x) {
  return make_float2(x.x, -x.y);
}

// Pair slot q of round r of the round-robin schedule on n indices, m = n - 1.
__device__ __forceinline__ void rr_pair(int r, int q, int n, int m, int& i,
                                        int& j) {
  if (q == 0) {
    i = n - 1;
    j = r;
  } else {
    i = r + q;
    if (i >= m) i -= m;
    j = r - q;
    if (j < 0) j += m;
  }
}

// shared memory per matrix, in float2: the round's parameters (h float4),
// S, and (DoRows && DoV) V
__host__ __device__ __forceinline__ size_t mat_floats2(int n, bool with_v) {
  const size_t s = static_cast<size_t>(n) * (n + 1);
  return static_cast<size_t>(n) + (with_v ? 2 : 1) * s;
}

template <bool DoRows, bool DoCols, bool DoV>
__global__ void eigh_probe_kernel(const float2* __restrict__ a,
                                  float* __restrict__ w_out,
                                  float* __restrict__ chk,
                                  int batch, int n, int sweeps) {
  constexpr bool kV = DoRows && DoV;
  extern __shared__ __align__(16) float2 smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= batch) return;  // the whole warp leaves together
  const int ld = n + 1, h = n / 2, m = n - 1;
  float2* base = smem + threadIdx.y * mat_floats2(n, kV);
  float4* P = reinterpret_cast<float4*>(base);  // (c, s, wr, wi) of pair slot q
  float2* S = base + n;
  float2* V = S + n * ld;
  const float2* src = a + static_cast<size_t>(b) * n * n;
  float a2 = 0.0f;  // |A|_F^2, this lane's share: |V|_F where V stays A
  for (int e = lane; e < n * n; e += 32) {
    const float2 x = src[e];
    S[(e / n) * ld + e % n] = x;
    if (kV) V[(e / n) * ld + e % n] = x;
    a2 += x.x * x.x + x.y * x.y;
  }
  __syncwarp();

  float coef = 0.0f;  // the sum of c + s of pair slot `lane`
  for (int step = 0; step < sweeps * m; ++step) {
    const int r = step % m;
    if (lane < h) {  // the round's parameters, one pair a lane
      int i, j;
      rr_pair(r, lane, n, m, i, j);
      const float aii = S[i * ld + i].x;
      const float ajj = S[j * ld + j].x;
      const float2 bv = S[i * ld + j];
      const float babs = sqrtf(bv.x * bv.x + bv.y * bv.y);
      const float dscale = sqrtf(aii * aii + ajj * ajj) + 1e-30f;
      const bool skip = babs <= 1e-7f * dscale;
      const float safe_b = skip ? 1.0f : babs;
      const float wr = skip ? 1.0f : bv.x / safe_b;
      const float wi = skip ? 0.0f : bv.y / safe_b;
      const float tau = (ajj - aii) / (2.0f * safe_b);
      const float sgn = static_cast<float>((tau > 0.0f) - (tau < 0.0f));
      const float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
      float c = rsqrtf(1.0f + t * t);
      float s = c * t;
      if (skip) {
        c = 1.0f;
        s = 0.0f;
      }
      coef += c + s;
      if (DoRows) P[lane] = make_float4(c, s, wr, wi);
    }
    if (!DoRows) continue;  // S never changes: no barrier needed
    __syncwarp();  // the parameters are visible

    // the crossing entries' column values, stored at the round's end
    int pend_at[kMaxCols] = {-1, -1};
    float2 pend[kMaxCols];
    for (int q = 0; q < h; ++q) {
      int i, j;
      rr_pair(r, q, n, m, i, j);
      const float4 p = P[q];  // a broadcast
      const float c = p.x, s = p.y, wr = p.z, wi = p.w;
#pragma unroll
      for (int u = 0; u < kMaxCols; ++u) {
        const int col = lane + 32 * u;
        if (col >= n) continue;
        const float2 ri = S[i * ld + col], rj = S[j * ld + col];
        // w rj, then the row rotation
        const float2 wrj = make_float2(wr * rj.x - wi * rj.y, wr * rj.y + wi * rj.x);
        const float2 ni = make_float2(c * ri.x - s * wrj.x, c * ri.y - s * wrj.y);
        const float2 nj = make_float2(s * ri.x + c * wrj.x, s * ri.y + c * wrj.y);
        if (kV) {
          // conj(w) vj, then the same rotation; V's column col is this
          // lane's alone
          const float2 vi = V[i * ld + col], vj = V[j * ld + col];
          const float2 wvj = make_float2(wr * vj.x + wi * vj.y, wr * vj.y - wi * vj.x);
          V[i * ld + col] = make_float2(c * vi.x - s * wvj.x, c * vi.y - s * wvj.y);
          V[j * ld + col] = make_float2(s * vi.x + c * wvj.x, s * vi.y + c * wvj.y);
        }
        if (!DoCols) {
          S[i * ld + col] = ni;
          S[j * ld + col] = nj;
        } else if (col == i) {
          // where rows and columns cross, the columns win: S[i, i] =
          // conj(ni); S[j, i] is column i's entry of the lane that owns
          // column j; S[i, j] = conj(nj), which that lane reads in this
          // step, waits for the round's end
          S[i * ld + i] = conj_(ni);
          pend_at[u] = i * ld + j;
          pend[u] = conj_(nj);
        } else if (col == j) {
          S[j * ld + j] = conj_(nj);
          pend_at[u] = j * ld + i;
          pend[u] = conj_(ni);
        } else {
          S[i * ld + col] = ni;
          S[j * ld + col] = nj;
          S[col * ld + i] = conj_(ni);
          S[col * ld + j] = conj_(nj);
        }
      }
      if (DoCols) __syncwarp();  // the next pair reads what this one wrote
    }
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u)
      if (pend_at[u] >= 0) S[pend_at[u]] = pend[u];
    __syncwarp();  // the next round's parameters read other lanes' rows
  }

  float s2 = 0.0f, v2 = kV ? 0.0f : a2;
#pragma unroll
  for (int u = 0; u < kMaxCols; ++u) {
    const int row = lane + 32 * u;
    if (row >= n) continue;
    w_out[static_cast<size_t>(b) * n + row] = S[row * ld + row].x;
    for (int col = 0; col < n; ++col) {
      const float2 x = S[row * ld + col];
      s2 += x.x * x.x + x.y * x.y;
      if (kV) {
        const float2 y = V[row * ld + col];
        v2 += y.x * y.x + y.y * y.y;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    v2 += __shfl_xor_sync(0xffffffffu, v2, o);
    coef += __shfl_xor_sync(0xffffffffu, coef, o);
  }
  if (lane == 0) {
    chk[3 * static_cast<size_t>(b)] = sqrtf(s2);
    chk[3 * static_cast<size_t>(b) + 1] = sqrtf(v2);
    chk[3 * static_cast<size_t>(b) + 2] = coef;
  }
}

template <bool DoRows, bool DoCols, bool DoV>
int launch(const void* a, void* w, void* chk, int batch, int n, int sweeps,
           int per_block, cudaStream_t stream) {
  const auto kernel = eigh_probe_kernel<DoRows, DoCols, DoV>;
  // at most the matrices that fit in a block's shared memory (at n = 64
  // with V, 3 of 66 KB each)
  const size_t per_mat = mat_floats2(n, DoRows && DoV) * sizeof(float2);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (static_cast<size_t>(per_block) * per_mat > static_cast<size_t>(optin))
    per_block = static_cast<int>(optin / per_mat);
  const size_t smem = static_cast<size_t>(per_block) * per_mat;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return static_cast<int>(err);
    }
  }
  const dim3 block(32, per_block);
  const dim3 grid((batch + per_block - 1) / per_block);
  kernel<<<grid, block, smem, stream>>>(static_cast<const float2*>(a),
                                        static_cast<float*>(w),
                                        static_cast<float*>(chk), batch, n,
                                        sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (batch, n, n) complex64, n even, 2 <= n <= 64.  w: (batch, n) float32.
// chk: (batch, 3) float32 = |S|_F, |V|_F, sum of c + s.  per_block in
// [1, 8], fewer where they do not fit in shared memory.  variant: bit 0 DoRows, bit 1 DoCols, bit 2 DoV (DoCols and DoV
// count only with DoRows).  Returns cudaGetLastError().
extern "C" int llck_eigh_probe(const void* a, void* w, void* chk, int batch,
                               int n, int sweeps, int per_block, int variant,
                               void* stream) {
  if (batch <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (!(variant & 1))
    return launch<false, false, false>(a, w, chk, batch, n, sweeps, per_block, st);
  switch (variant & 6) {
    case 0:
      return launch<true, false, false>(a, w, chk, batch, n, sweeps, per_block, st);
    case 2:
      return launch<true, true, false>(a, w, chk, batch, n, sweeps, per_block, st);
    case 4:
      return launch<true, false, true>(a, w, chk, batch, n, sweeps, per_block, st);
    default:
      return launch<true, true, true>(a, w, chk, batch, n, sweeps, per_block, st);
  }
}
