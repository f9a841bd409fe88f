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
// lanes, (n, n, batch)).  Design: one warp per matrix, lane t owns column t
// (n <= 32); the matrix lives in shared memory, and the schedule is copied
// into shared memory once per block (the TPU kept it in SMEM).  A __syncwarp
// separates each step's reads from its writes, and its writes from the next
// step's reads.  Lane j alone writes both row i's entry j and then the
// element (i, j), so that order needs no barrier.
//
// Bound: this probes access patterns, not arithmetic: a few flops per
// element and step, one read and one write of each matrix in device memory.
// At the tool's shape (256 matrices of 24 x 24, 16 steps) the launch costs
// more than the work.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // matrices per block

__global__ void row_probe_kernel(const int* __restrict__ sched,
                                 const float* __restrict__ a,
                                 float* __restrict__ out,
                                 int batch, int n, int steps) {
  extern __shared__ int smem_i[];
  int* sch = smem_i;                                           // (steps, 2)
  float* mats = reinterpret_cast<float*>(smem_i + 2 * steps);  // kWarps (n, n)
  const int lane = threadIdx.x;
  for (int e = threadIdx.y * 32 + lane; e < 2 * steps; e += 32 * kWarps)
    sch[e] = sched[e];
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
    float ri = 0.0f, rj = 0.0f;
    if (lane < n) {
      ri = s[i * n + lane];
      rj = s[j * n + lane];
    }
    __syncwarp();  // every lane has read a[i, j] and its row entries
    if (lane < n) {
      s[i * n + lane] = c * ri - sn * rj;
      s[j * n + lane] = sn * ri + c * rj;
      if (lane == j) s[i * n + j] = c;
    }
    __syncwarp();
  }

  float* dst = out + static_cast<size_t>(b) * n * n;
  for (int e = lane; e < n * n; e += 32) dst[e] = s[e];
}

}  // namespace

// sched: (steps, 2) int32, every entry in [0, n), steps <= 2048 (the wrapper
// checks both).  a, out: (batch, n, n) float32, 1 <= n <= 32.  Returns
// cudaGetLastError().
extern "C" int llck_row_probe(const void* sched, const void* a, void* out,
                              int batch, int n, int steps, void* stream) {
  if (batch <= 0) return 0;
  const dim3 block(32, kWarps);
  const dim3 grid((batch + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(2 * steps) * sizeof(int) +
                      static_cast<size_t>(kWarps) * n * n * sizeof(float);
  row_probe_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sched), static_cast<const float*>(a),
      static_cast<float*>(out), batch, n, steps);
  return static_cast<int>(cudaGetLastError());
}
