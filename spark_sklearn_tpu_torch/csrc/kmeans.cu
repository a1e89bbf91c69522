// KMeans' assignment step (C1) for Hopper (sm_90a).  Built with nvcc into
// a shared library with a plain C interface and loaded with ctypes
// (spark_sklearn_tpu_torch/ops/_build.py); the Python wrapper lives in
// spark_sklearn_tpu_torch/ops/kmeans_kernels.py beside its plain PyTorch
// version and the launch plan (`assign_plan`).
//
// C1  kmeans_assign   replaces spark_sklearn_tpu/models/cluster.py:31-35
//     (`_sq_dists` after its GEMM) with its argmin and min at :129-130,
//     :145-146 and :164:
//       d2[b,i,j]   = max((xx[i] - 2 XC[i, b*k+j]) + cc[b,j], 0)
//       assign[b,i] = the first j of the least d2[b,i,:] (the first NaN
//                     where there is one, as jnp.argmin)
//       min_d2[b,i] = that distance (NaN where any is)
//       inertia[b]  = sum_i w[b,i] * min_d2[b,i]
//     XC (n, B*k) is the library GEMM X C_allᵀ of every lane's centers;
//     xx (n,), cc (B, k), w (B, n) float32; assign (B, n) int32, min_d2
//     (B, n) float32.  Bound: bytes.  It reads XC once (at the KMeans
//     search's shape, n=100000, B=20, k=8: 64 MB) and w, and writes
//     assign and min_d2 (16 MB): ~0.029 ms at 3.35 TB/s.
//
// Design.
// - Grid: (ceil(n / 256) row tiles) x (B lanes), a thread a (row, lane):
//   its k distances are k contiguous floats of XC, read once; w[b,i],
//   assign and min_d2 are contiguous over a warp's rows.
// - Each block adds its rows' w * min_d2 in a fixed tree in shared
//   memory and writes one partial; a second launch, a block a lane, adds
//   the lane's partials in a fixed order.  No float atomics: the same
//   inputs give the same bits on the same card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;            // rows a block

__device__ __forceinline__ float block_sum(float v, float* red) {
  // a fixed tree over the block's threads (kThreads, a power of two)
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
    assign_kernel(const float* __restrict__ XC, const float* __restrict__ xx,
                  const float* __restrict__ cc, const float* __restrict__ w,
                  int* __restrict__ assign, float* __restrict__ min_d2,
                  float* __restrict__ part, int n, int B, int k) {
  __shared__ float red[kThreads];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float contrib = 0.0f;
  if (i < n) {
    const float x2 = xx[i];
    const float* row = XC + static_cast<size_t>(i) * B * k +
                       static_cast<size_t>(b) * k;
    const float* cb = cc + static_cast<size_t>(b) * k;
    int best = 0;
    float best_v = 0.0f;
    bool nan_seen = false;
    for (int j = 0; j < k; ++j) {
      float v = (x2 - 2.0f * row[j]) + cb[j];   // 2 XC is exact
      v = (v < 0.0f) ? 0.0f : v;                // max(v, 0), NaN kept
      if (j == 0) {
        best_v = v;
        nan_seen = isnan(v);
      } else if (!nan_seen) {
        if (isnan(v)) {
          best = j;
          best_v = v;
          nan_seen = true;
        } else if (v < best_v) {
          best = j;
          best_v = v;
        }
      }
    }
    const size_t at = static_cast<size_t>(b) * n + i;
    assign[at] = best;
    min_d2[at] = best_v;
    contrib = __fmul_rn(w[at], best_v);
  }
  const float s = block_sum(contrib, red);
  if (threadIdx.x == 0) part[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    lane_sum_kernel(const float* __restrict__ part,
                    float* __restrict__ inertia, int blocks) {
  __shared__ float red[kThreads];
  const int b = blockIdx.x;
  float s = 0.0f;
  for (int t = threadIdx.x; t < blocks; t += kThreads)
    s += part[static_cast<size_t>(b) * blocks + t];
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) inertia[b] = total;
}

}  // namespace

extern "C" {

// Two launches (the assignment, then the lanes' sums of its per-block
// partials in `part` (B, blocks), allocated by the caller).  Returns the
// first nonzero cudaError (0 = launched).
int kmeans_assign(const float* XC, const float* xx, const float* cc,
                  const float* w, int* assign, float* min_d2, float* part,
                  float* inertia, int n, int B, int k, int blocks,
                  void* stream) {
  if (n < 1 || B < 1 || k < 1 || B > 65535 ||
      blocks != (n + kThreads - 1) / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  assign_kernel<<<dim3(blocks, B), kThreads, 0, s>>>(XC, xx, cc, w, assign,
                                                     min_d2, part, n, B, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lane_sum_kernel<<<B, kThreads, 0, s>>>(part, inertia, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
