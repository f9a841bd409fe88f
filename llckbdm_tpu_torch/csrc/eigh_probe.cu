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
// unless DoCols.
//
// Layout: (batch, n, n) complex64 (the TPU had (n, n, batch) real and
// imaginary planes).  Design: one warp per matrix, lane t owns column t
// (n <= 32), S and V in shared memory with a padded row stride so column
// accesses spread over the banks; the n/2 pairs of a round one after
// another, a __syncwarp between the reads and the writes of each pair.
// per_block matrices (warps) per block is a launch parameter, the
// counterpart of the TPU's b_blk.
//
// Bound: latency of the sequential rotation chain, sweeps (n - 1) n/2
// dependent pair steps per matrix, each a shared-memory round trip plus a
// sqrt, two divisions and an rsqrt.  S and V take 2 n (n + 1) complex64
// (9.6 KB at n = 24), so about 23 matrices fit on an SM at once; at the
// tool's 4480 matrices that is about 1.5 waves on 132 SMs.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 conj_(float2 x) {
  return make_float2(x.x, -x.y);
}

template <bool DoRows, bool DoCols, bool DoV>
__global__ void eigh_probe_kernel(const float2* __restrict__ a,
                                  float* __restrict__ w_out,
                                  float* __restrict__ chk,
                                  int batch, int n, int sweeps) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= batch) return;  // the whole warp leaves together
  const int ld = n + 1;
  float2* S = smem + threadIdx.y * 2 * n * ld;
  float2* V = S + n * ld;
  const float2* src = a + static_cast<size_t>(b) * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const float2 x = src[e];
    S[(e / n) * ld + e % n] = x;
    V[(e / n) * ld + e % n] = x;
  }
  __syncwarp();

  const int m = n - 1;
  float coef = 0.0f;
  for (int step = 0; step < sweeps * m; ++step) {
    const int r = step % m;
    for (int k = 0; k < n / 2; ++k) {
      int i, j;
      if (k == 0) {
        i = n - 1;
        j = r;
      } else {
        i = (r + k) % m;
        j = (r - k + m) % m;
      }
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
      if (!DoRows) continue;

      float2 ri = make_float2(0.0f, 0.0f), rj = ri, vi = ri, vj = ri;
      if (lane < n) {
        ri = S[i * ld + lane];
        rj = S[j * ld + lane];
        if (DoV) {
          vi = V[i * ld + lane];
          vj = V[j * ld + lane];
        }
      }
      __syncwarp();  // every lane has read a_ii, a_jj, b and its row entries
      float2 ni = ri, nj = rj;
      if (lane < n) {
        // w rj, then the row rotation
        const float2 wrj = make_float2(wr * rj.x - wi * rj.y, wr * rj.y + wi * rj.x);
        ni = make_float2(c * ri.x - s * wrj.x, c * ri.y - s * wrj.y);
        nj = make_float2(s * ri.x + c * wrj.x, s * ri.y + c * wrj.y);
        S[i * ld + lane] = ni;
        S[j * ld + lane] = nj;
        if (DoV) {
          // conj(w) vj, then the same rotation
          const float2 wvj = make_float2(wr * vj.x + wi * vj.y, wr * vj.y - wi * vj.x);
          V[i * ld + lane] = make_float2(c * vi.x - s * wvj.x, c * vi.y - s * wvj.y);
          V[j * ld + lane] = make_float2(s * vi.x + c * wvj.x, s * vi.y + c * wvj.y);
        }
      }
      if (DoCols) {
        __syncwarp();  // the column writes land after every row write
        if (lane < n) {
          S[lane * ld + i] = conj_(ni);
          S[lane * ld + j] = conj_(nj);
        }
      }
      __syncwarp();
    }
  }

  float s2 = 0.0f, v2 = 0.0f;
  if (lane < n) {
    w_out[static_cast<size_t>(b) * n + lane] = S[lane * ld + lane].x;
    for (int col = 0; col < n; ++col) {
      const float2 x = S[lane * ld + col];
      const float2 y = V[lane * ld + col];
      s2 += x.x * x.x + x.y * x.y;
      v2 += y.x * y.x + y.y * y.y;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    v2 += __shfl_xor_sync(0xffffffffu, v2, o);
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
  const size_t smem =
      static_cast<size_t>(per_block) * 2 * n * (n + 1) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
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

// a: (batch, n, n) complex64, n even, 2 <= n <= 32.  w: (batch, n) float32.
// chk: (batch, 3) float32 = |S|_F, |V|_F, sum of c + s.  per_block in
// [1, 8].  variant: bit 0 DoRows, bit 1 DoCols, bit 2 DoV (DoCols and DoV
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
