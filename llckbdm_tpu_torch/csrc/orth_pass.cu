// The sweep's shifted CholeskyQR pass over a (V, m, S, k) block as it is
// stored (solver/kbdm.py::_orth_pass), in two kernels around cholqr_rinv
// (csrc/chol.cu):
//
//   orth_gram:  G[v, s] = Y[v, :, s, :]^H Y[v, :, s, :]   (V, S, k, k)
//               shift[v, s] = shift_rel * mean_j |G[v, s, j, j]|
//   (cholqr_rinv: X = R^-1 with G + shift I = R^H R)
//   orth_mix:   Q[v, :, s, :] = Y[v, :, s, :] X[v, s]       in Y's storage
//
// The block is stored as complex64 (float2 entries) or as bfloat16 real
// pairs: the real parts at one offset and the imaginary parts at a fixed
// offset si further on (the sweep's (V, 2m, S, k) pairs, si = m rows).  A
// block is addressed through its strides (entries; the last axis
// contiguous), so either kernel reads any such layout, and the mix writes
// to strides of its own.
//
// It replaces no TPU kernel: the JAX package forms the Gram and the mix as
// einsums and leaves them to XLA (llckbdm_tpu/solver/kbdm.py:330-410).
// Built from PyTorch ops (ops/cuda_linalg.py::orth_pass_plain's algorithm),
// each einsum made a conj copy and permuted copies of its operands, and on
// the bfloat16 branch each pass widened the block to complex64 and rounded
// it back, with two strided copies each way.  Here the block is read in its
// storage and the result written in it; a bfloat16 pair is widened exactly
// and the mix's float32 result rounded to bfloat16 once,
// round-to-nearest-even, as torch rounds.
//
// What bounds it on an H100 (tools/bounds.py::orth_pass): device memory for
// complex64, operations for bfloat16 pairs.  orth_gram reads the block
// once; orth_mix reads it and writes its result; G, X and the shift are a
// k^2 / (m S)-th of that.  Operations: 8 flops a (j <= l, row) for the
// Gram and as many for the mix.
//
// Design:
//  * Products and sums in float32 on the CUDA cores (fmaf), no TF32.
//  * A block takes one voxel and a group of sb sweep entries and walks m
//    in tiles of kRows rows: a tile (rows x sb entries x k) is contiguous
//    in each row for the sweep's layout, and lands in shared memory as
//    float2.  complex64 tiles are copied by cp.async, two in flight: the
//    next tile's copies are issued before the current one is worked on, so
//    device memory's latency hides behind the products; a thread copies the
//    same unit (VEC entries of one entry) of every rstep-th row of every
//    tile, its offsets worked out once.  bfloat16 pairs are loaded 16 bytes
//    a load and widened in registers on the way (exact): on an H100 that
//    ran faster than cp.async into a raw buffer widened through shared
//    memory (Gram 2.39 against 2.77 ms, mix 2.87 against 3.74 at the
//    five-peak shape), whereas complex64 gained (Gram 3.08 -> 1.78 ms, mix
//    4.32 -> 3.51).  Rows past m are zeros; columns past k are zeros.
//  * orth_gram: a thread holds a 4 x 4 tile (jb, lb), jb <= lb, of the
//    upper triangle of G for one entry, and the rows r = g mod rg of the
//    walk (row group g): its sum over them is a plain float32 sum in row
//    order; the rg partial sums are added by a tree (P_g += P_{g+h}, h =
//    rg/2, ..., 1) through shared memory.  G is written Hermitian by
//    construction: the tile at j <= l, its conjugate at l > j, a real
//    diagonal.  The shift's mean is a sum over j in order, over k.
//  * orth_mix: X for the block's sb entries sits in shared memory; a thread
//    holds a 4 x 4 tile of Q (rows rq + 8 i of the tile, columns 4 lb + c)
//    and sums j <= 4 lb + 3 only (X is zero below its diagonal).  The
//    result goes back through shared memory and out in the copies'
//    pattern, to an output with strides of its own (the caller's layout),
//    and conjugated where the caller asks (the form the bfloat16 branch's
//    next Hankel apply reads).  The y tile's row stride is 1 mod 16 float2
//    (and each entry's slab shifted by 8 more), so the 8 rows x 2 entries
//    of a half-warp fall on distinct banks; complex64 lands there 8 bytes a
//    copy.
//  * Shapes: any m, any S, k <= 64 (the wrapper raises past it).  No float
//    atomics: the result depends only on the shape and rg.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;         // rows of Y a tile
constexpr int kMaxThreads = 256;  // threads a block, at most

struct C64 {          // complex64: one float2 an entry
  using T = float2;
};
struct Bf16Pairs {    // bfloat16 pairs: real part at o, imaginary at o + si
  using T = uint16_t;
};
template <class St>
constexpr bool kPairs = sizeof(typename St::T) == 2;

// A (V, m, S, k) block: its base and strides, in entries of its storage
// (bfloat16 values for pairs), the last axis contiguous; the mix's output
// has strides of its own (os*) and may be written conjugated (osign -1).
struct Block {
  const void* in;
  void* out;
  long long sv, sr, ss, si;
  long long osv, osr, oss, osi;
  float osign;
  int nv, m, ns, k;
};

// --- copies into shared memory ------------------------------------------------
// cp.async of `bytes` (4, 8 or 16) from device memory, of which the first
// `valid` are read and the rest zero-filled; a group of them is committed,
// and waited for (all but the newest group, or all).
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           uint32_t valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(valid));
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// -----------------------------------------------------------------------------

__device__ __forceinline__ float bf16_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// round-to-nearest-even, NaN to the quiet 0x7fc0 (c10::BFloat16's rounding)
__device__ __forceinline__ uint32_t float_to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__host__ __device__ __forceinline__ int round4(int k) { return (k + 3) & ~3; }

// complex64: where a thread's copies of a tile go: unit u (VEC entries of
// entry sl, from column jc VEC) of the rows row0, row0 + rstep, ... of the
// tile.  Units of a row: nu = sb k / VEC, at most the block's threads.
struct Copies {
  int nu, u, row0, rstep;
  long long src;  // the unit's offset in the block, past the voxel and row
  int dst;        // its offset in the float2 tile, past the row
  __device__ Copies(const Block& b, int v, int s0, int sb, int vec, int sls) {
    const int nj = b.k / vec;
    nu = sb * nj;
    rstep = blockDim.x / nu;
    u = threadIdx.x % nu;
    row0 = threadIdx.x / nu;
    const int sl = u / nj, jc = u % nj;
    src = v * b.sv + (s0 + sl) * b.ss + jc * vec;
    dst = sl * sls + jc * vec;
  }
};

// complex64: issue the copies of rows [r0, r0 + kRows) into the float2 tile
// t (row stride ld; VEC entries a copy, the tile's rows 16-byte aligned
// where VEC is 2), rows at or past m zero-filled, and commit them as one
// group.
template <int VEC>
__device__ __forceinline__ void issue_tile(const Copies& cp, const Block& b,
                                           int r0, float2* t, int ld) {
  if (cp.row0 < cp.rstep) {
    for (int rr = cp.row0; rr < kRows; rr += cp.rstep) {
      const int r = r0 + rr;
      const bool live = r < b.m;
      const float2* src =
          static_cast<const float2*>(b.in) + cp.src + (live ? r : 0) * b.sr;
      copy_async<8 * VEC>(t + cp.dst + rr * ld, src, live ? 8 * VEC : 0);
    }
  }
  copy_commit();
}

// Pairs: load rows [r0, r0 + kRows) x entries [s0, s0 + sb) x columns
// [0, kp) of voxel v and widen them in registers into t[sl * sls + rr * ld +
// j] as float2 (exact); rows at or past m and columns at or past k are
// zeros.  VEC values a load (VEC divides k and the strides).
template <int VEC>
__device__ __forceinline__ void load_pairs(float2* t, int ld, int sls,
                                          const Block& b, int v, int r0,
                                          int s0, int sb, int kp) {
  const int nj = b.k / VEC;
  const int chunks = kRows * sb * nj;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int jc = c % nj, rest = c / nj, sl = rest % sb, rr = rest / sb;
    const int r = r0 + rr;
    float2* dst = t + sl * sls + rr * ld + jc * VEC;
    if (r >= b.m) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = make_float2(0.0f, 0.0f);
      continue;
    }
    const long long off = v * b.sv + r * b.sr + (s0 + sl) * b.ss + jc * VEC;
    const uint16_t* re = static_cast<const uint16_t*>(b.in) + off;
    const uint16_t* im = re + b.si;
    if constexpr (VEC == 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(re);
      const uint4 i = *reinterpret_cast<const uint4*>(im);
      const uint32_t ra[4] = {a.x, a.y, a.z, a.w};
      const uint32_t ia[4] = {i.x, i.y, i.z, i.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[2 * e] = make_float2(bf16_to_float(ra[e] & 0xffffu),
                                 bf16_to_float(ia[e] & 0xffffu));
        dst[2 * e + 1] = make_float2(bf16_to_float(ra[e] >> 16),
                                     bf16_to_float(ia[e] >> 16));
      }
    } else if constexpr (VEC == 4) {
      const uint2 a = *reinterpret_cast<const uint2*>(re);
      const uint2 i = *reinterpret_cast<const uint2*>(im);
      const uint32_t ra[2] = {a.x, a.y};
      const uint32_t ia[2] = {i.x, i.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dst[2 * e] = make_float2(bf16_to_float(ra[e] & 0xffffu),
                                 bf16_to_float(ia[e] & 0xffffu));
        dst[2 * e + 1] = make_float2(bf16_to_float(ra[e] >> 16),
                                     bf16_to_float(ia[e] >> 16));
      }
    } else if constexpr (VEC == 2) {
      const uint32_t a = *reinterpret_cast<const uint32_t*>(re);
      const uint32_t i = *reinterpret_cast<const uint32_t*>(im);
      dst[0] = make_float2(bf16_to_float(a & 0xffffu),
                           bf16_to_float(i & 0xffffu));
      dst[1] = make_float2(bf16_to_float(a >> 16), bf16_to_float(i >> 16));
    } else {
      dst[0] = make_float2(bf16_to_float(*re), bf16_to_float(*im));
    }
  }
  // columns k .. kp (k not a multiple of 4)
  const int pad = kp - b.k;
  for (int c = threadIdx.x; c < kRows * sb * pad; c += blockDim.x) {
    const int jp = c % pad, rest = c / pad, sl = rest % sb, rr = rest / sb;
    t[sl * sls + rr * ld + b.k + jp] = make_float2(0.0f, 0.0f);
  }
}

// Zero the columns k .. kp of every row of nbuf tiles (k not a multiple of
// 4): the copies never write them.
__device__ __forceinline__ void zero_pad(float2* t, int nbuf, int buf, int sb,
                                         int sls, int ld, int k, int kp) {
  const int pad = kp - k;
  for (int c = threadIdx.x; c < nbuf * sb * kRows * pad; c += blockDim.x) {
    const int jp = c % pad, rest = c / pad, rr = rest % kRows;
    const int rest2 = rest / kRows, sl = rest2 % sb, bi = rest2 / sb;
    t[bi * buf + sl * sls + rr * ld + k + jp] = make_float2(0.0f, 0.0f);
  }
}

// The rows of the tile below m: t's float2 entries, columns [0, k), written
// to the block's output (its own strides, and conjugated where osign is -1)
// in its storage.
template <class St, int VEC>
__device__ __forceinline__ void store_tile(const float2* t, int ld, int sls,
                                           const Block& b, int v, int r0,
                                           int s0, int sb) {
  const int nj = b.k / VEC;
  const int nu = sb * nj;
  const int rows = min(kRows, b.m - r0);
  for (int c = threadIdx.x; c < rows * nu; c += blockDim.x) {
    const int rr = c / nu, un = c - rr * nu, sl = un / nj, jc = un - sl * nj;
    const float2* src = t + sl * sls + rr * ld + jc * VEC;
    const long long off =
        v * b.osv + (r0 + rr) * b.osr + (s0 + sl) * b.oss + jc * VEC;
    const float sg = b.osign;  // -1: the conjugate (an exact negation)
    if constexpr (!kPairs<St>) {
      float2* dst = static_cast<float2*>(b.out) + off;
      if constexpr (VEC == 2) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(src[0].x, sg * src[0].y, src[1].x, sg * src[1].y);
      } else {
        *dst = make_float2(src[0].x, sg * src[0].y);
      }
    } else {
      uint16_t* re = static_cast<uint16_t*>(b.out) + off;
      uint16_t* im = re + b.osi;
      if constexpr (VEC == 1) {
        *re = static_cast<uint16_t>(float_to_bf16(src[0].x));
        *im = static_cast<uint16_t>(float_to_bf16(sg * src[0].y));
      } else {
        uint32_t rw[VEC / 2], iw[VEC / 2];  // two bfloat16 values a word
#pragma unroll
        for (int e = 0; e < VEC / 2; ++e) {
          rw[e] = float_to_bf16(src[2 * e].x) |
                  (float_to_bf16(src[2 * e + 1].x) << 16);
          iw[e] = float_to_bf16(sg * src[2 * e].y) |
                  (float_to_bf16(sg * src[2 * e + 1].y) << 16);
        }
        if constexpr (VEC == 8) {
          *reinterpret_cast<uint4*>(re) = make_uint4(rw[0], rw[1], rw[2], rw[3]);
          *reinterpret_cast<uint4*>(im) = make_uint4(iw[0], iw[1], iw[2], iw[3]);
        } else if constexpr (VEC == 4) {
          *reinterpret_cast<uint2*>(re) = make_uint2(rw[0], rw[1]);
          *reinterpret_cast<uint2*>(im) = make_uint2(iw[0], iw[1]);
        } else {
          *reinterpret_cast<uint32_t*>(re) = rw[0];
          *reinterpret_cast<uint32_t*>(im) = iw[0];
        }
      }
    }
  }
}

// --- the Gram -----------------------------------------------------------------

// Threads a block and entries a block of orth_gram: items sb x rg x nt.
// Shared memory: the float2 tiles (two for complex64, which the copies
// fill; one for pairs) or the tree's scratch, then the diagonal.
struct GramShape {
  int kp, nb, nt, rg, sb, threads, tiles;
  __host__ __device__ GramShape(int k, int ns, int rg_, bool pairs) : rg(rg_) {
    kp = round4(k);
    nb = kp / 4;
    nt = nb * (nb + 1) / 2;
    sb = kMaxThreads / (rg * nt);
    if (sb < 1) sb = 1;
    if (sb > ns) sb = ns;
    threads = (sb * rg * nt + 31) / 32 * 32;
    tiles = pairs ? 1 : 2;
  }
  __host__ __device__ int tile() const { return sb * kRows * kp; }  // float2
  __host__ __device__ int front() const {  // float2: the tiles or the scratch
    const int a = tiles * tile(), s = (rg / 2) * sb * nt * 16;
    return a > s ? a : s;
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(front()) * sizeof(float2) +
           sb * kp * sizeof(float);
  }
};

template <class St, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    orth_gram_kernel(Block b, int rg, float shift_rel, float2* __restrict__ g,
                     float* __restrict__ shift) {
  extern __shared__ __align__(16) float2 smem[];
  const GramShape sh(b.k, b.ns, rg, kPairs<St>);
  const int k = b.k, kp = sh.kp, nb = sh.nb, nt = sh.nt;
  const int groups = (b.ns + sh.sb - 1) / sh.sb;
  const int v = blockIdx.x / groups, s0 = (blockIdx.x % groups) * sh.sb;
  const int sb = min(sh.sb, b.ns - s0);
  const int ld = kp, sls = kRows * kp, buf = sh.tile();
  float* diag = reinterpret_cast<float*>(smem + sh.front());

  const int t = threadIdx.x % nt, rest = threadIdx.x / nt;
  const int gr = rest % rg, sl = rest / rg;
  const bool active = sl < sb;
  int jb = 0, tt = t;  // t -> (jb, lb), jb <= lb, row by row of tiles
  while (tt >= nb - jb) {
    tt -= nb - jb;
    ++jb;
  }
  const int lb = jb + tt;

  float2 acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = make_float2(0.0f, 0.0f);

  const Copies cp(b, v, s0, sb, VEC, sls);
  const int ntiles = (b.m + kRows - 1) / kRows;
  if constexpr (!kPairs<St>) {
    zero_pad(smem, sh.tiles, buf, sb, sls, ld, k, kp);
    issue_tile<VEC>(cp, b, 0, smem, ld);
  }
  for (int ti = 0; ti < ntiles; ++ti) {
    const int r0 = ti * kRows, stage = ti & 1;
    __syncthreads();  // the tile the next copies fill is read
    float2* tile = smem;
    if constexpr (kPairs<St>) {
      load_pairs<VEC>(smem, ld, sls, b, v, r0, s0, sb, kp);
    } else {
      if (ti + 1 < ntiles) {
        issue_tile<VEC>(cp, b, r0 + kRows, smem + (1 - stage) * buf, ld);
        copy_wait_older();
      } else {
        copy_wait_all();
      }
      tile += stage * buf;
    }
    __syncthreads();
    if (!active) continue;
    const int rows = min(kRows, b.m - r0);
    const float2* rbase = tile + sl * sls;
    for (int rr = gr; rr < rows; rr += rg) {
      const float2* row = rbase + rr * ld;
      const float4 a01 = *reinterpret_cast<const float4*>(row + 4 * jb);
      const float4 a23 = *reinterpret_cast<const float4*>(row + 4 * jb + 2);
      const float4 b01 = *reinterpret_cast<const float4*>(row + 4 * lb);
      const float4 b23 = *reinterpret_cast<const float4*>(row + 4 * lb + 2);
      const float ar[4] = {a01.x, a01.z, a23.x, a23.z};
      const float ai[4] = {a01.y, a01.w, a23.y, a23.w};
      const float br[4] = {b01.x, b01.z, b23.x, b23.z};
      const float bi[4] = {b01.y, b01.w, b23.y, b23.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // conj(a_i) b_c
          acc[i][c].x = fmaf(ar[i], br[c], acc[i][c].x);
          acc[i][c].x = fmaf(ai[i], bi[c], acc[i][c].x);
          acc[i][c].y = fmaf(ar[i], bi[c], acc[i][c].y);
          acc[i][c].y = fmaf(-ai[i], br[c], acc[i][c].y);
        }
      }
    }
  }

  // the row groups' sums by a tree: P_g += P_{g + h}, h = rg / 2, ..., 1;
  // scratch entry e of slot ((g - h) sb_max + sl) nt + t, slots adjacent
  const int slots = (rg / 2) * sh.sb * nt;
  for (int h = rg / 2; h >= 1; h /= 2) {
    __syncthreads();
    if (active && gr >= h && gr < 2 * h) {
      const int slot = ((gr - h) * sh.sb + sl) * nt + t;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) smem[(i * 4 + c) * slots + slot] = acc[i][c];
    }
    __syncthreads();
    if (active && gr < h) {
      const int slot = (gr * sh.sb + sl) * nt + t;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 p = smem[(i * 4 + c) * slots + slot];
          acc[i][c].x += p.x;
          acc[i][c].y += p.y;
        }
    }
  }

  if (active && gr == 0) {
    float2* gout = g + (static_cast<size_t>(v) * b.ns + s0 + sl) * k * k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * jb + i, l = 4 * lb + c;
        if (j >= k || l >= k || j > l) continue;
        if (j == l) {
          gout[j * k + j] = make_float2(acc[i][c].x, 0.0f);
          diag[sl * kp + j] = fabsf(acc[i][c].x);
        } else {
          gout[j * k + l] = acc[i][c];
          gout[l * k + j] = make_float2(acc[i][c].x, -acc[i][c].y);
        }
      }
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < sb) {
    float sum = 0.0f;
    for (int j = 0; j < k; ++j) sum += diag[threadIdx.x * kp + j];
    shift[static_cast<size_t>(v) * b.ns + s0 + threadIdx.x] =
        shift_rel * (sum / static_cast<float>(k));
  }
}

// --- the mix ------------------------------------------------------------------

// Threads a block and entries a block of orth_mix: items nb x sb x 8 (the
// row quads fastest, then the entries), sb a power of two.  Shared memory:
// X, then the y tiles (two for complex64, which the copies fill; one for
// pairs).
struct MixShape {
  int kp, nb, sb, threads, ldy, sly, slx, tiles;
  __host__ __device__ MixShape(int k, int ns, bool pairs) {
    kp = round4(k);
    nb = kp / 4;
    sb = 1;
    while (2 * sb * 8 * nb <= kMaxThreads) sb *= 2;
    if (sb > ns) sb = ns;
    threads = (8 * sb * nb + 31) / 32 * 32;
    ldy = (kp + 15) / 16 * 16 + 1;   // 1 mod 16 float2
    sly = kRows * ldy + 8;           // an entry's slab: 8 more (16 banks)
    slx = kp * kp;
    tiles = pairs ? 1 : 2;
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(sb) * (slx + tiles * sly) * sizeof(float2);
  }
};

template <class St, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    orth_mix_kernel(Block b, const float2* __restrict__ x) {
  extern __shared__ __align__(16) float2 smem[];
  const MixShape sh(b.k, b.ns, kPairs<St>);
  const int k = b.k, kp = sh.kp;
  const int groups = (b.ns + sh.sb - 1) / sh.sb;
  const int v = blockIdx.x / groups, s0 = (blockIdx.x % groups) * sh.sb;
  const int sb = min(sh.sb, b.ns - s0);
  const int buf = sh.sb * sh.sly;
  float2* xs = smem;                          // X[sl][j][l], row stride kp
  float2* ys = smem + sh.sb * sh.slx;         // Y[sl][row][j], stride ldy

  // X of the block's entries, zero past k
  const float2* xg = x + (static_cast<size_t>(v) * b.ns + s0) * k * k;
  for (int c = threadIdx.x; c < sb * kp * kp; c += blockDim.x) {
    const int l = c % kp, rest = c / kp, j = rest % kp, sl = rest / kp;
    xs[sl * sh.slx + j * kp + l] = (j < k && l < k)
                                       ? xg[(sl * k + j) * k + l]
                                       : make_float2(0.0f, 0.0f);
  }

  const int rq = threadIdx.x % 8, rest = threadIdx.x / 8;
  const int sl = rest % sh.sb, lb = rest / sh.sb;
  const bool active = sl < sb && lb < sh.nb;
  const int jend = min(k, 4 * lb + 4);  // X[j, l] = 0 for j > l

  const Copies cp(b, v, s0, sb, 1, sh.sly);
  const int ntiles = (b.m + kRows - 1) / kRows;
  if constexpr (!kPairs<St>) {
    zero_pad(ys, sh.tiles, buf, sb, sh.sly, sh.ldy, k, kp);
    issue_tile<1>(cp, b, 0, ys, sh.ldy);
  }
  for (int ti = 0; ti < ntiles; ++ti) {
    const int r0 = ti * kRows, stage = ti & 1;
    __syncthreads();  // X is in place; the tile the next copies fill is out
    float2* tile = ys;
    if constexpr (kPairs<St>) {
      load_pairs<VEC>(ys, sh.ldy, sh.sly, b, v, r0, s0, sb, kp);
    } else {
      if (ti + 1 < ntiles) {
        issue_tile<1>(cp, b, r0 + kRows, ys + (1 - stage) * buf, sh.ldy);
        copy_wait_older();
      } else {
        copy_wait_all();
      }
      tile += stage * buf;
    }
    __syncthreads();
    float2 acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = make_float2(0.0f, 0.0f);
    if (active) {
      const float2* xr = xs + sl * sh.slx + 4 * lb;
      const float2* yr = tile + sl * sh.sly + rq * sh.ldy;
      for (int j = 0; j < jend; ++j) {
        const float4 x01 = *reinterpret_cast<const float4*>(xr + j * kp);
        const float4 x23 = *reinterpret_cast<const float4*>(xr + j * kp + 2);
        const float xre[4] = {x01.x, x01.z, x23.x, x23.z};
        const float xim[4] = {x01.y, x01.w, x23.y, x23.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 y = yr[8 * i * sh.ldy + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // y x
            acc[i][c].x = fmaf(y.x, xre[c], acc[i][c].x);
            acc[i][c].x = fmaf(-y.y, xim[c], acc[i][c].x);
            acc[i][c].y = fmaf(y.x, xim[c], acc[i][c].y);
            acc[i][c].y = fmaf(y.y, xre[c], acc[i][c].y);
          }
        }
      }
    }
    __syncthreads();  // every thread has read the tile
    if (active) {
      float2* qr = tile + sl * sh.sly + rq * sh.ldy + 4 * lb;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) qr[8 * i * sh.ldy + c] = acc[i][c];
    }
    __syncthreads();
    store_tile<St, VEC>(tile, sh.ldy, sh.sly, b, v, r0, s0, sb);
  }
}

template <typename Kernel>
int shared_bytes(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <class St, int VEC>
int launch_gram(const Block& b, int rg, float shift_rel, void* g, void* shift,
                void* stream) {
  const GramShape sh(b.k, b.ns, rg, kPairs<St>);
  const long long grid =
      static_cast<long long>(b.nv) * ((b.ns + sh.sb - 1) / sh.sb);
  if (grid >= (1LL << 31) || (!kPairs<St> && sh.sb * (b.k / VEC) > sh.threads))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = orth_gram_kernel<St, VEC>;
  const int err = shared_bytes(kernel, sh.bytes());
  if (err) return err;
  kernel<<<static_cast<unsigned>(grid), sh.threads, sh.bytes(),
           static_cast<cudaStream_t>(stream)>>>(
      b, rg, shift_rel, static_cast<float2*>(g), static_cast<float*>(shift));
  return static_cast<int>(cudaGetLastError());
}

template <class St, int VEC>
int launch_mix(const Block& b, const void* x, void* stream) {
  const MixShape sh(b.k, b.ns, kPairs<St>);
  const long long grid =
      static_cast<long long>(b.nv) * ((b.ns + sh.sb - 1) / sh.sb);
  // complex64 lands 8 bytes a copy (the tile's rows are 8-byte aligned)
  if (grid >= (1LL << 31) || (!kPairs<St> && sh.sb * b.k > sh.threads))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = orth_mix_kernel<St, VEC>;
  const int err = shared_bytes(kernel, sh.bytes());
  if (err) return err;
  kernel<<<static_cast<unsigned>(grid), sh.threads, sh.bytes(),
           static_cast<cudaStream_t>(stream)>>>(b, static_cast<const float2*>(x));
  return static_cast<int>(cudaGetLastError());
}

Block make_block(const void* in, void* out, const long long* strides,
                 const long long* out_strides, int conj, int nv, int m,
                 int ns, int k) {
  const long long* o = out_strides ? out_strides : strides;
  return Block{in, out, strides[0], strides[1], strides[2], strides[3],
               o[0], o[1], o[2], o[3], conj ? -1.0f : 1.0f, nv, m, ns, k};
}

}  // namespace

// y: the (nv, m, ns, k) block, its strides {sv, sr, ss, si} in entries of
// its storage (pairs != 0: bfloat16 real parts, imaginary parts si further
// on; else complex64, si unused), the last axis contiguous; vec: entries a
// copy (1 or 2 for complex64, 1, 2, 4 or 8 for pairs; it divides k, the
// strides and the base's alignment); rg: row groups (1, 2 or 4).
// g: (nv, ns, k, k) complex64, shift: (nv, ns) float32.  k <= 64.
// Returns a CUDA error code.
extern "C" int llck_orth_gram(const void* y, const long long* strides,
                              int pairs, int vec, int nv, int m, int ns, int k,
                              int rg, float shift_rel, void* g, void* shift,
                              void* stream) {
  if (nv <= 0 || ns <= 0) return 0;
  if (k < 1 || k > 64 || m < 1 || !(rg == 1 || rg == 2 || rg == 4) ||
      rg * GramShape(k, ns, rg, pairs != 0).nt > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Block b = make_block(y, nullptr, strides, nullptr, 0, nv, m, ns, k);
  if (pairs) {
    if (vec == 8) return launch_gram<Bf16Pairs, 8>(b, rg, shift_rel, g, shift, stream);
    if (vec == 4) return launch_gram<Bf16Pairs, 4>(b, rg, shift_rel, g, shift, stream);
    if (vec == 2) return launch_gram<Bf16Pairs, 2>(b, rg, shift_rel, g, shift, stream);
    return launch_gram<Bf16Pairs, 1>(b, rg, shift_rel, g, shift, stream);
  }
  if (vec == 2) return launch_gram<C64, 2>(b, rg, shift_rel, g, shift, stream);
  return launch_gram<C64, 1>(b, rg, shift_rel, g, shift, stream);
}

// y: the (nv, m, ns, k) block as for llck_orth_gram; q: its output in y's
// storage, its strides {sv, sr, ss, si} in out_strides (vec divides them
// too); conj != 0 writes the conjugate; x: (nv, ns, k, k) complex64, upper
// triangular.  q = y x per (voxel, entry).  Returns a CUDA error code.
extern "C" int llck_orth_mix(const void* y, const long long* strides,
                             void* q, const long long* out_strides, int pairs,
                             int vec, int conj, int nv, int m, int ns, int k,
                             const void* x, void* stream) {
  if (nv <= 0 || ns <= 0) return 0;
  if (k < 1 || k > 64 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Block b = make_block(y, q, strides, out_strides, conj, nv, m, ns, k);
  if (pairs) {
    if (vec == 8) return launch_mix<Bf16Pairs, 8>(b, x, stream);
    if (vec == 4) return launch_mix<Bf16Pairs, 4>(b, x, stream);
    if (vec == 2) return launch_mix<Bf16Pairs, 2>(b, x, stream);
    return launch_mix<Bf16Pairs, 1>(b, x, stream);
  }
  if (vec == 2) return launch_mix<C64, 2>(b, x, stream);
  return launch_mix<C64, 1>(b, x, stream);
}
