// The Gauss-Newton normal equations of one exact refine step
// (solver/refine.py), built in one pass over each voxel's signal:
//
//   P[k, n] = z_k^(t0 + n)                      complex128
//   r[n]    = c[n] - sum_k d_k P[k, n]           complex128
//   J       = [P; D],  D[k, n] = doz_k (t0 + n) P[k, n], doz_k = d_k / z_k
//   G       = J^H J    (2C, 2C) complex64, accumulated in float32
//   rhs     = J^H r    (2C,)    complex128, accumulated in float64
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (llckbdm_tpu/solver/refine.py).  Built from PyTorch ops, as the plain
// mirror ops/cuda_linalg.py::gn_normal_plain builds them, every
// intermediate (the powers, the model, the Jacobian's second block, a
// complex128 copy of J) is a (V, C, N) tensor in device memory, ~1 GB each
// at V=1024, C=32, N=2048; here none is.
//
// What bounds it on an H100: float32 operations.  Device memory sees one
// read of c, z and d and one write of G and rhs (69 MB at the brain
// shape above, 0.02 ms); the float64 work (powers, model, residual, rhs)
// is ~26 flops a (k, n); the three moments below are 16 flops a (k, l, n),
// over k <= l what the work needs.
//
// Design:
//  * G's blocks are three Hermitian moments M_j[k, l] = sum_n (t0 + n)^j
//    conj(P[k, n]) P[l, n], j = 0, 1, 2, in float32 from P rounded to
//    complex64: G = [M0, M1 diag(doz); diag(conj doz) M1, diag(conj doz)
//    M2 diag(doz)], scaled when written.  Only float32 rounding differs
//    from the three products of the plain version.  doz is formed here as
//    refine.py formed it, in float32 from z and d rounded to complex64:
//    d conj(z) / max(|z|^2, 1e-20), 0 for a masked slot (z = d = 0).
//  * Powers come from anchors and short runs: a sample group walks a run
//    of `run` <= 64 contiguous samples from its anchor z^(t0 + n0), formed
//    by binary powering in float64 as ops/powers.py::cpow_fixed does, by
//    repeated multiplication (the chunked scheme of solver/kbdm.py::
//    _poles_to_lines): relative error ~(2 log2(t0 + N) + 64) eps.
//  * A block of 256 threads takes one voxel.
//    In the walk a sample group of CP lanes holds every slot of one sample
//    (lane k slot k); the model sum over the slots is a butterfly of
//    shuffles, so each lane has r[n] and adds conj(P[k, n]) r[n] and
//    (t0 + n) conj(P[k, n]) r[n] to its own float64 sums.  Every 8 steps
//    the groups' P (complex64) and t0 + n sit in a shared-memory tile of 64
//    or 128 samples; after a barrier each thread adds a 2 x 2 block of the
//    three moments over its share of the tile (at CP = 16 four threads
//    share a block, each a quarter of the samples).  The moments are
//    computed over the whole square, not the triangle: every thread has a
//    block, none idles.
//  * The signal of a round (the groups' next runs, contiguous) is copied
//    into shared memory by the whole block, coalesced, before the walk.
//  * Sizes: CP = 16 or 32 (C padded up; padded slots are z = d = 0 and
//    are not written), as far as the refine's solve goes on the card
//    (chol_solve: 2C <= 64).  The wrapper picks `run` from the shape,
//    short enough that every group walks.  A single spectrum takes one
//    block too: splitting its time axis over blocks (a second kernel adding
//    the splits) made its refine no faster on an H100.  No float atomics:
//    the result depends only on the shape.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;    // steps of the walk between two tile passes
constexpr int kMaxRun = 64;  // longest walk from one anchor

constexpr int kT = 2;        // side of a thread's block of the moments

template <int CP>
struct Geo {
  static_assert(CP == 16 || CP == 32, "CP is 16 or 32");
  static constexpr int kGroups = kWarps * (32 / CP);      // groups a block
  static constexpr int kTile = kSteps * kGroups;          // samples a tile
  static constexpr int kPerRow = CP / kT;
  static constexpr int kBlocks = kPerRow * kPerRow;
  static constexpr int kShare = kThreads / kBlocks;       // threads a block
  static constexpr int kShareSamples = kTile / kShare;
  // shared memory: the round's signal, the tile and its weights during the
  // walk; then the group sums of the rhs and the shared moment blocks
  static constexpr int kSignalBytes = kGroups * kMaxRun * 16;
  static constexpr int kTileBytes = kTile * CP * 8;
  static constexpr int kWalkBytes = kSignalBytes + kTileBytes + kTile * 4;
  static constexpr int kRhsBytes = kGroups * CP * 32;
  static constexpr int kReduceBytes = kRhsBytes + (kShare - 1) * 3 * CP * CP * 8;
  static constexpr int kBytes =
      kWalkBytes > kReduceBytes ? kWalkBytes : kReduceBytes;
  static_assert(kThreads % kBlocks == 0 && kTile % kShare == 0, "layout");
};

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// conj(a) * b
__device__ __forceinline__ double2 cmul_conj(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, a.y * b.y), fma(a.x, b.y, -a.y * b.x));
}

__device__ __forceinline__ float2 cmulf(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ void add(float2& acc, float2 x) {
  acc.x += x.x;
  acc.y += x.y;
}

__device__ __forceinline__ void add(double2& acc, double2 x) {
  acc.x += x.x;
  acc.y += x.y;
}

// z^e, e >= 0, by binary powering (cpow_fixed's order: the first factor
// taken as it is); 0^0 = 1.
__device__ double2 cpow(double2 z, long long e) {
  double2 out = make_double2(1.0, 0.0), sq = z;
  bool first = true;
  while (e) {
    if (e & 1) {
      out = first ? sq : cmul(out, sq);
      first = false;
    }
    e >>= 1;
    if (e) sq = cmul(sq, sq);
  }
  return out;
}

// One (k, l) of G from the moments: the four blocks' entries.
__device__ __forceinline__ void emit_pair(float2* gv, int nc, int k, int l,
                                          float2 m0, float2 m1, float2 m2,
                                          float2 dk, float2 dl) {
  const int w = 2 * nc;
  const float2 dkc = make_float2(dk.x, -dk.y);
  gv[k * w + l] = m0;
  gv[k * w + nc + l] = cmulf(dl, m1);
  gv[(nc + k) * w + l] = cmulf(dkc, m1);
  gv[(nc + k) * w + nc + l] = cmulf(cmulf(dkc, dl), m2);
}

// doz_k = d_k conj(z_k) / max(|z_k|^2, 1e-20) in float32 from z, d rounded
// to complex64 (|z|^2 and the reciprocal rounded as separate operations).
__device__ __forceinline__ float2 doz_of(double2 z, double2 d) {
  const float zx = static_cast<float>(z.x), zy = static_cast<float>(z.y);
  const float dx = static_cast<float>(d.x), dy = static_cast<float>(d.y);
  const float zabs2 = __fadd_rn(__fmul_rn(zx, zx), __fmul_rn(zy, zy));
  const float inv = __fdiv_rn(1.0f, fmaxf(zabs2, 1e-20f));
  return make_float2((dx * zx + dy * zy) * inv, (dy * zx - dx * zy) * inv);
}

// Slot k of the rhs from its two float64 sums.
__device__ __forceinline__ void emit_rhs(double2* rv, int nc, int k,
                                         double2 s0, double2 s1, float2 dk) {
  rv[k] = s0;
  rv[nc + k] = cmul_conj(make_double2(dk.x, dk.y), s1);
}

template <int CP>
__global__ void __launch_bounds__(kThreads)
    gn_normal_kernel(const double2* __restrict__ c,
                     const double2* __restrict__ z,
                     const double2* __restrict__ d, float2* __restrict__ g,
                     double2* __restrict__ rhs, int nc, int n, int t0,
                     int run) {
  using G = Geo<CP>;
  constexpr int T = kT;
  __shared__ __align__(16) unsigned char smem[G::kBytes];
  __shared__ float2 dv[CP];
  double2* sig = reinterpret_cast<double2*>(smem);
  float2* tile = reinterpret_cast<float2*>(smem + G::kSignalBytes);
  float* weight =
      reinterpret_cast<float*>(smem + G::kSignalBytes + G::kTileBytes);

  const int v = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = warp * (32 / CP) + lane / CP;
  const int li = lane % CP;  // the lane's slot
  const int runs = (n + run - 1) / run;
  if (tid < nc)  // read after the barriers below
    dv[tid] = doz_of(z[static_cast<size_t>(v) * nc + tid],
                     d[static_cast<size_t>(v) * nc + tid]);

  // the walk: slot li of the group's sample
  const bool live = li < nc;
  const double2 zk =
      live ? z[static_cast<size_t>(v) * nc + li] : make_double2(0.0, 0.0);
  const double2 dk =
      live ? d[static_cast<size_t>(v) * nc + li] : make_double2(0.0, 0.0);
  double2 pk, s0 = make_double2(0.0, 0.0), s1 = make_double2(0.0, 0.0);

  // the moments: block (k0.., l0..) over samples of share `part`
  const int blk = tid % G::kBlocks, part = tid / G::kBlocks;
  const int k0 = (blk / G::kPerRow) * T, l0 = (blk % G::kPerRow) * T;
  float2 m0[T][T], m1[T][T], m2[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j)
      m0[i][j] = m1[i][j] = m2[i][j] = make_float2(0.f, 0.f);

  const double2* cv = c + static_cast<size_t>(v) * n;
  for (int rbase = 0; rbase < runs; rbase += G::kGroups) {
    // the round's signal: runs rbase .. rbase + kGroups - 1, contiguous
    const int first = rbase * run;
    const int count = min(G::kGroups, runs - rbase) * run;
    for (int i = tid; i < G::kGroups * run; i += kThreads)
      sig[i] = (i < count && first + i < n) ? cv[first + i]
                                            : make_double2(0.0, 0.0);
    __syncthreads();
    const int r = rbase + grp;
    const bool run_ok = r < runs;
    const long long n0 = static_cast<long long>(r) * run;
    pk = run_ok ? cpow(zk, t0 + n0) : make_double2(0.0, 0.0);

    for (int i0 = 0; i0 < run; i0 += kSteps) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int i = i0 + u;
        const long long nl = n0 + i;
        const bool ok = run_ok && nl < n;
        if (i > 0) pk = cmul(pk, zk);
        double2 model = cmul(dk, pk);
#pragma unroll
        for (int off = CP / 2; off > 0; off >>= 1) {
          model.x += __shfl_xor_sync(0xffffffffu, model.x, off);
          model.y += __shfl_xor_sync(0xffffffffu, model.y, off);
        }
        const double2 cn = sig[grp * run + i];
        const double2 res = ok ? make_double2(cn.x - model.x, cn.y - model.y)
                               : make_double2(0.0, 0.0);
        const double w = static_cast<double>(t0) + static_cast<double>(nl);
        const int row = u * G::kGroups + grp;
        const double2 pr = cmul_conj(pk, res);
        add(s0, pr);
        s1.x = fma(w, pr.x, s1.x);
        s1.y = fma(w, pr.y, s1.y);
        tile[row * CP + li] = ok ? make_float2(static_cast<float>(pk.x),
                                               static_cast<float>(pk.y))
                                 : make_float2(0.f, 0.f);
        if (li == 0) weight[row] = static_cast<float>(w);
      }
      __syncthreads();
      // the three moments of the thread's block over its share of the tile
#pragma unroll 4
      for (int s = part * G::kShareSamples; s < (part + 1) * G::kShareSamples;
           ++s) {
        const float w = weight[s], w2 = w * w;
        float2 a[T], b[T];
#pragma unroll
        for (int i = 0; i < T; ++i) {
          a[i] = tile[s * CP + k0 + i];
          b[i] = tile[s * CP + l0 + i];
        }
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const float qr = fmaf(a[i].x, b[j].x, a[i].y * b[j].y);
            const float qi = fmaf(a[i].x, b[j].y, -a[i].y * b[j].x);
            m0[i][j].x += qr;
            m0[i][j].y += qi;
            m1[i][j].x = fmaf(w, qr, m1[i][j].x);
            m1[i][j].y = fmaf(w, qi, m1[i][j].y);
            m2[i][j].x = fmaf(w2, qr, m2[i][j].x);
            m2[i][j].y = fmaf(w2, qi, m2[i][j].y);
          }
      }
      __syncthreads();
    }
  }

  // the groups' rhs sums and the shared moment blocks, added in a fixed
  // order (the walk's shared memory is free: the last pass ended in a
  // barrier)
  double2* rred = reinterpret_cast<double2*>(smem);
  float2* mred = reinterpret_cast<float2*>(smem + G::kRhsBytes);
  rred[(grp * CP + li) * 2] = s0;
  rred[(grp * CP + li) * 2 + 1] = s1;
  if constexpr (G::kShare > 1) {
    if (part > 0) {
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          float2* at = mred + (part - 1) * 3 * CP * CP + (k0 + i) * CP + l0 + j;
          at[0] = m0[i][j];
          at[CP * CP] = m1[i][j];
          at[2 * CP * CP] = m2[i][j];
        }
    }
  }
  __syncthreads();
  if constexpr (G::kShare > 1) {
    if (part == 0) {
      for (int q = 0; q < G::kShare - 1; ++q)
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const float2* at = mred + q * 3 * CP * CP + (k0 + i) * CP + l0 + j;
            add(m0[i][j], at[0]);
            add(m1[i][j], at[CP * CP]);
            add(m2[i][j], at[2 * CP * CP]);
          }
    }
  }
  if (tid < nc) {
    double2 a0 = make_double2(0.0, 0.0), a1 = make_double2(0.0, 0.0);
    for (int q = 0; q < G::kGroups; ++q) {
      add(a0, rred[(q * CP + tid) * 2]);
      add(a1, rred[(q * CP + tid) * 2 + 1]);
    }
    emit_rhs(rhs + static_cast<size_t>(v) * 2 * nc, nc, tid, a0, a1,
             dv[tid]);
  }
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int k = k0 + i, l = l0 + j;
        if (k >= nc || l >= nc) continue;
        emit_pair(g + static_cast<size_t>(v) * 4 * nc * nc, nc, k, l,
                  m0[i][j], m1[i][j], m2[i][j], dv[k], dv[l]);
      }
  }
}

template <int CP>
int launch(const void* c, const void* z, const void* d, void* g, void* rhs,
           int v, int nc, int n, int t0, int run, cudaStream_t st) {
  gn_normal_kernel<CP><<<v, kThreads, 0, st>>>(
      static_cast<const double2*>(c), static_cast<const double2*>(z),
      static_cast<const double2*>(d), static_cast<float2*>(g),
      static_cast<double2*>(rhs), nc, n, t0, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c: (v, n) complex128; z, d: (v, nc) complex128, masked slots 0.
// g: (v, 2 nc, 2 nc) complex64; rhs: (v, 2 nc) complex128.  run: samples a
// walk, a multiple of 8, at most 64.  1 <= nc <= 32.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments outside these).
extern "C" int llck_gn_normal(const void* c, const void* z, const void* d,
                              void* g, void* rhs, int v, int nc, int n,
                              int t0, int run, void* stream) {
  if (v <= 0) return 0;
  if (nc < 1 || nc > 32 || n < 1 || t0 < 0 || run < kSteps ||
      run > kMaxRun || run % kSteps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (nc <= 16) return launch<16>(c, z, d, g, rhs, v, nc, n, t0, run, st);
  return launch<32>(c, z, d, g, rhs, v, nc, n, t0, run, st);
}
