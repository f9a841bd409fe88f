// Dynamic row loads and stores driven by an int32 schedule: the row-access
// probe.
//
// Replaces tools/pallas_smoke.py::kernel, the smoke test of the dynamic row
// and element accesses that the Jacobi kernels rely on.  Per step k, with
// i = sched[k, 0] and j = sched[k, 1], from the matrix as it stood before the
// step:
//   c = a[i, j] * 0.25,  s = 1 - c^2,
//   row i = c row_i - s row_j,  then row j = s row_i + c row_j,
//   then the element (i, j) = c.
// The write order decides the result when i == j.  The plain PyTorch mirror
// is ops/cuda_probes.py::row_probe_plain.
//
// Layout: batch first, (batch, n, n) float32 (the TPU kept the batch in the
// lanes, (n, n, batch)).  Design: one warp per matrix, lane t owns columns t
// and t + 32 (n <= 64); the matrix lives in shared memory.  The schedule
// comes from the host as a kernel parameter, as the TPU kernel took it into
// SMEM from the host: the launcher packs each step's (i, j) into 12 bits
// (i | j << 6), two steps to three bytes, at most kMaxSteps steps (3 KB,
// inside the 4 KB of kernel parameters every toolkit takes).  So nothing is
// copied to the device before the launch, and nothing read back.  The block
// unpacks it into shared memory once.  A __syncwarp separates each step's
// reads from its writes, and its writes from the next step's reads.  The
// lane that owns column j writes both row i's entry j and then the element
// (i, j), so that order needs no barrier.
//
// Bound: this probes access patterns, not arithmetic: a few flops per
// element and step, one read and one write of each matrix in device memory.
// At the tool's shape (256 matrices of 24 x 24, 16 steps) the bound (~0.4
// us) lies below the card's launch latency; llck_empty, an empty kernel on
// the same path, measures that floor.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kWarps = 4;         // matrices per block
constexpr int kMaxSteps = 2048;   // the schedule's capacity
constexpr int kMaxCols = 2;       // columns a lane owns: t and t + 32

struct Schedule {
  unsigned char b[3 * kMaxSteps / 2];  // step 2p | step 2p + 1 << 12, 24 bits
};

__global__ void row_probe_kernel(const Schedule sched,
                                 const float* __restrict__ a,
                                 float* __restrict__ out,
                                 int batch, int n, int steps) {
  extern __shared__ int smem_i[];
  int* sch = smem_i;                                           // (steps, 2)
  float* mats = reinterpret_cast<float*>(smem_i + 2 * steps);  // kWarps (n, n)
  const int lane = threadIdx.x;
  for (int e = threadIdx.y * 32 + lane; e < steps; e += 32 * kWarps) {
    const int p = 3 * (e / 2);
    const unsigned v = sched.b[p] | sched.b[p + 1] << 8 | sched.b[p + 2] << 16;
    const unsigned code = (e & 1) ? v >> 12 : v & 0xfffu;
    sch[2 * e] = code & 63;
    sch[2 * e + 1] = code >> 6;
  }
  __syncthreads();
  const int b = blockIdx.x * kWarps + threadIdx.y;
  if (b >= batch) return;  // the whole warp leaves together
  float* s = mats + threadIdx.y * n * n;
  const float* src = a + static_cast<size_t>(b) * n * n;
  for (int e = lane; e < n * n; e += 32) s[e] = src[e];
  __syncwarp();

  for (int k = 0; k < steps; ++k) {
    const int i = sch[2 * k];
    const int j = sch[2 * k + 1];
    const float c = s[i * n + j] * 0.25f;
    const float sn = 1.0f - c * c;
    float ri[kMaxCols], rj[kMaxCols];
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      const int col = lane + 32 * u;
      ri[u] = col < n ? s[i * n + col] : 0.0f;
      rj[u] = col < n ? s[j * n + col] : 0.0f;
    }
    __syncwarp();  // every lane has read a[i, j] and its row entries
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      const int col = lane + 32 * u;
      if (col >= n) continue;
      s[i * n + col] = c * ri[u] - sn * rj[u];
      s[j * n + col] = sn * ri[u] + c * rj[u];
      if (col == j) s[i * n + j] = c;
    }
    __syncwarp();
  }

  float* dst = out + static_cast<size_t>(b) * n * n;
  for (int e = lane; e < n * n; e += 32) dst[e] = s[e];
}

__global__ void empty_kernel() {}

}  // namespace

// sched: host memory, the (steps, 2) int32 schedule, every entry in [0, n),
// steps <= 2048 (the wrapper checks both; it is packed here, on the host).
// a, out: (batch, n, n) float32 on the device, 1 <= n <= 64.  Returns
// cudaGetLastError().
extern "C" int llck_row_probe(const void* sched, const void* a, void* out,
                              int batch, int n, int steps, void* stream) {
  if (batch <= 0) return 0;
  if (steps < 0 || steps > kMaxSteps || n < 1 || n > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ij = static_cast<const int*>(sched);
  Schedule packed;
  std::memset(&packed, 0, sizeof(packed));
  for (int e = 0; e < steps; ++e) {
    const unsigned code = static_cast<unsigned>(ij[2 * e] | ij[2 * e + 1] << 6)
                          << (e & 1 ? 12 : 0);
    unsigned char* p = packed.b + 3 * (e / 2);
    p[0] |= code & 0xffu;
    p[1] |= (code >> 8) & 0xffu;
    p[2] |= (code >> 16) & 0xffu;
  }
  const dim3 block(32, kWarps);
  const dim3 grid((batch + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(2 * steps) * sizeof(int) +
                      static_cast<size_t>(kWarps) * n * n * sizeof(float);
  if (smem > 48 * 1024) {  // n = 64 and 2048 steps: 80 KB
    const cudaError_t err = cudaFuncSetAttribute(
        row_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return static_cast<int>(err);
    }
  }
  row_probe_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, static_cast<const float*>(a), static_cast<float*>(out), batch, n,
      steps);
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel (one warp) on the stream: the launch floor
// of a kernel called through this library's ctypes path.  Returns
// cudaGetLastError().
extern "C" int llck_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
