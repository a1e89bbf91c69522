// KMeans' assignment step (C1) for Hopper (sm_90a).  Built with nvcc into
// a shared library with a plain C interface and loaded with ctypes
// (spark_sklearn_tpu_torch/ops/_build.py); the Python wrapper lives in
// spark_sklearn_tpu_torch/ops/kmeans_kernels.py beside its plain PyTorch
// version and the launch plan (`assign_plan`).
//
// C1  kmeans_assign   replaces spark_sklearn_tpu/models/cluster.py:31-35
//     (`_sq_dists`, its GEMM included) with its argmin and min at
//     :129-130, :145-146 and :164:
//       dot[b,i,j]  = sum_t X[i,t] * C[b,j,t], t = 0 .. d-1 in order,
//                     each product and each sum rounded apart
//       d2[b,i,j]   = max((xx[i] - 2 dot[b,i,j]) + cc[b,j], 0)
//       assign[b,i] = the first j of the least d2[b,i,:] (the first NaN
//                     where there is one, as jnp.argmin)
//       min_d2[b,i] = that distance (NaN where any is)
//       inertia[b]  = sum_i w[b,i] * min_d2[b,i]
//     X (n, d), C (B, k, d), xx (n,), cc (B, k), w (B, n) float32; assign
//     (B, n) int32, min_d2 (B, n) float32.  Bound: operations.  At the
//     KMeans search's Lloyd step (n=100000, d=54, B=20, k=8) 2 n B k d =
//     1.73e9 flops, 0.026 ms at 67 TFLOP/s (the multiply and the add
//     unfused: ~0.05 ms of issue); it reads X and C and writes assign and
//     min_d2, ~46 MB, 0.014 ms at 3.35 TB/s.  d2 is never written.
//
// C1l (the keyed fleet's per-key Lloyd step, spark_sklearn_tpu/models/
//     cluster.py:68- vmapped over keys by keyed/keyed.py:271-279): each
//     lane b has its own rows, X (B, n, d) and xx (B, n), passed as lane
//     strides x_stride = n d and xx_stride = n; a block then takes one
//     lane (lanes == 1).  Strides 0 are the shared X above, the same
//     arithmetic and bits.
//
// Design.
// - Grid: (row tiles) x (groups of `lanes` lanes).  A block of 256
//   threads stages a tile of X's rows and its lanes' centers in shared
//   memory, a d-tile at a time, transposed: quad t4 (4 floats of t) of
//   row r at float4 t4 * rows + r.  The copies are cp.async of up to 16
//   bytes, a thread one row's piece, a warp 32 rows at one t, so that
//   every copy of the tile is in flight at once (copied a row at a time,
//   the tile's copies cost as much as the arithmetic).
// - A warp takes 64 rows of one lane; a thread 2 rows, and holds the
//   2 x 8 dot products of its rows and 8 centers in registers across the
//   d loop.  Its X reads are 16 bytes of 32 neighbouring rows (no bank
//   conflict); the 8 centers' quads are the same for the whole warp (one
//   broadcast read each); every address of a step is one pointer plus a
//   constant.  k above 8 is walked 8 centers at a time, the running
//   argmin carried from chunk to chunk.
// - dot is summed in t order with __fmul_rn / __fadd_rn, which nvcc never
//   contracts, so the kernel gives the plain version's bits.
// - Each block adds its rows' w * min_d2 a lane in a fixed order (a
//   thread's rows, a warp's shuffle tree, the warps in order) and writes
//   one partial; a second launch, a block a lane, adds the lane's
//   partials in a fixed tree.  No float atomics: the same inputs give
//   the same bits on the same card.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 2;
constexpr int kCenters = 8;              // centers a pass of the d loop
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block: the default 48 KB, no attribute, less
// room for the static part
constexpr int kMaxDynamicSmem = 47 * 1024;

// A row's running argmin over the centers seen so far (jnp.argmin's rule).
struct Best {
  int j;
  float v;
  bool nan;
};

__device__ __forceinline__ void consider(Best& b, int j, float v) {
  if (j == 0) {
    b.j = 0;
    b.v = v;
    b.nan = isnan(v);
  } else if (!b.nan) {
    if (isnan(v)) {
      b.j = j;
      b.v = v;
      b.nan = true;
    } else if (v < b.v) {
      b.j = j;
      b.v = v;
    }
  }
}

// kVec floats a copy (`assign_plan`: 4 where d % 4 == 0, 2 where d is
// even, else 1, and X and C start on such a boundary; their rows then do
// too).  rows and lanes * kCenters are powers of two.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    assign_kernel(const float* __restrict__ X, const float* __restrict__ C,
                  const float* __restrict__ xx, const float* __restrict__ cc,
                  const float* __restrict__ w, int* __restrict__ assign,
                  float* __restrict__ min_d2, float* __restrict__ part,
                  int n, int d, int B, int k, int lanes, int dtile,
                  int dpad, long long x_stride, long long xx_stride) {
  extern __shared__ __align__(16) float smem[];
  // C1l: lane blockIdx.y's own rows (lanes == 1); strides 0 share X
  X += static_cast<size_t>(blockIdx.y) * x_stride;
  xx += static_cast<size_t>(blockIdx.y) * xx_stride;
  __shared__ float warp_sum[kWarps];
  const int lane_warps = kWarps / lanes;           // warps a lane
  const int rows = 32 * kRowsPerThread * lane_warps;
  float* Xs = smem;                                // dpad / 4 x rows quads
  float* Cs = smem + rows * dpad;                  // dpad / 4 x lanes x 8
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lid = tid & 31;
  const int lb = warp / lane_warps;                // this warp's lane
  const int b = blockIdx.y * lanes + lb;
  const int r0 = blockIdx.x * rows;
  const int rbase = (warp % lane_warps) * 32 * kRowsPerThread + lid;
  Best best[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) best[q] = {0, 0.0f, false};
  for (int kc = 0; kc < k; kc += kCenters) {
    float acc[kRowsPerThread][kCenters];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
      for (int c = 0; c < kCenters; ++c) acc[q][c] = 0.0f;
    for (int t0 = 0; t0 < d; t0 += dtile) {
      const int dt = min(dtile, d - t0);
      __syncthreads();                  // the last tile's reads are done
      // transposed: quad t4 of row r at float4 (t4 * rows + r), quad t4 of
      // center row cr at (t4 * lc + cr); a thread copies kVec floats of
      // one row, a warp 32 rows at one t
      const int lc = lanes * kCenters;
      const int chunks = dt / kVec;
      for (int e = tid; e < rows * chunks; e += kThreads) {
        const int r = e & (rows - 1);
        const int t = (e >> (__ffs(rows) - 1)) * kVec;
        const int row = r0 + r;
        float* dst = Xs + 4 * ((t >> 2) * rows + r) + (t & 3);
        if (row < n)
          __pipeline_memcpy_async(
              dst, X + static_cast<size_t>(row) * d + t0 + t,
              sizeof(float) * kVec);
        else
#pragma unroll
          for (int v = 0; v < kVec; ++v) dst[v] = 0.0f;
      }
      for (int e = tid; e < lc * chunks; e += kThreads) {
        const int r = e & (lc - 1);
        const int t = (e >> (__ffs(lc) - 1)) * kVec;
        const int bl = blockIdx.y * lanes + r / kCenters;
        const int j = kc + r % kCenters;
        float* dst = Cs + 4 * ((t >> 2) * lc + r) + (t & 3);
        if (bl < B && j < k)
          __pipeline_memcpy_async(
              dst, C + (static_cast<size_t>(bl) * k + j) * d + t0 + t,
              sizeof(float) * kVec);
        else
#pragma unroll
          for (int v = 0; v < kVec; ++v) dst[v] = 0.0f;
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (b < B) {                      // the same for the whole warp
        const int lc = lanes * kCenters;
        const float4* xp = reinterpret_cast<const float4*>(Xs) + rbase;
        const float4* cp = reinterpret_cast<const float4*>(Cs) + lb * kCenters;
        const int quads = dt >> 2;
        for (int t4 = 0; t4 < quads; ++t4, xp += rows, cp += lc) {
          float4 xv[kRowsPerThread];
#pragma unroll
          for (int q = 0; q < kRowsPerThread; ++q) xv[q] = xp[32 * q];
#pragma unroll
          for (int c = 0; c < kCenters; ++c) {
            const float4 cv = cp[c];
#pragma unroll
            for (int q = 0; q < kRowsPerThread; ++q) {
              float a = acc[q][c];
              a = __fadd_rn(a, __fmul_rn(xv[q].x, cv.x));
              a = __fadd_rn(a, __fmul_rn(xv[q].y, cv.y));
              a = __fadd_rn(a, __fmul_rn(xv[q].z, cv.z));
              a = __fadd_rn(a, __fmul_rn(xv[q].w, cv.w));
              acc[q][c] = a;
            }
          }
        }
        const int rem = dt & 3;         // the last quad's first rem floats
        if (rem) {
          float4 xv[kRowsPerThread];
#pragma unroll
          for (int q = 0; q < kRowsPerThread; ++q) xv[q] = xp[32 * q];
#pragma unroll
          for (int c = 0; c < kCenters; ++c) {
            const float4 cv = cp[c];
#pragma unroll
            for (int q = 0; q < kRowsPerThread; ++q) {
              float a = __fadd_rn(acc[q][c], __fmul_rn(xv[q].x, cv.x));
              if (rem > 1) a = __fadd_rn(a, __fmul_rn(xv[q].y, cv.y));
              if (rem > 2) a = __fadd_rn(a, __fmul_rn(xv[q].z, cv.z));
              acc[q][c] = a;
            }
          }
        }
      }
    }
    if (b < B) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int row = r0 + rbase + 32 * q;
        if (row >= n) continue;
        const float x2 = xx[row];
#pragma unroll
        for (int c = 0; c < kCenters; ++c) {
          const int j = kc + c;
          if (j >= k) break;
          // 2 dot is exact: (xx - 2 dot) + cc, each rounded apart
          float v = __fadd_rn(__fsub_rn(x2, 2.0f * acc[q][c]),
                              cc[static_cast<size_t>(b) * k + j]);
          v = (v < 0.0f) ? 0.0f : v;              // max(v, 0), NaN kept
          consider(best[q], j, v);
        }
      }
    }
  }
  float contrib = 0.0f;
  if (b < B) {
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int row = r0 + rbase + 32 * q;
      if (row >= n) continue;
      const size_t at = static_cast<size_t>(b) * n + row;
      assign[at] = best[q].j;
      min_d2[at] = best[q].v;
      contrib = __fadd_rn(contrib, __fmul_rn(w[at], best[q].v));
    }
  }
  // a fixed tree over the warp, then the lane's warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    contrib = __fadd_rn(contrib, __shfl_down_sync(kFull, contrib, o));
  if (lid == 0) warp_sum[warp] = contrib;
  __syncthreads();
  if (tid < lanes && blockIdx.y * lanes + tid < B) {
    float s = 0.0f;
    for (int v = 0; v < lane_warps; ++v)
      s = __fadd_rn(s, warp_sum[tid * lane_warps + v]);
    part[static_cast<size_t>(blockIdx.y * lanes + tid) * gridDim.x +
         blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    lane_sum_kernel(const float* __restrict__ part,
                    float* __restrict__ inertia, int blocks) {
  __shared__ float red[kThreads];
  const int b = blockIdx.x;
  float s = 0.0f;
  for (int t = threadIdx.x; t < blocks; t += kThreads)
    s += part[static_cast<size_t>(b) * blocks + t];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) inertia[b] = red[0];
}

}  // namespace

extern "C" {

// Two launches (the assignment, then the lanes' sums of its per-block
// partials in `part` (B, blocks), allocated by the caller).  `lanes` (1,
// 2, 4 or 8) lanes a block, d-tiles of `dtile` columns staged in `dpad` /
// 4 quads by copies of `vec` floats (X and C 4 * vec-byte aligned),
// `blocks` row tiles of 64 * 8 / lanes rows (`assign_plan`); X and xx
// advance by x_stride and xx_stride floats a lane (C1l, lanes 1).  Returns
// the first nonzero cudaError (0 = launched).
int kmeans_assign(const float* X, const float* C, const float* xx,
                  const float* cc, const float* w, int* assign,
                  float* min_d2, float* part, float* inertia, int n, int d,
                  int B, int k, int lanes, int dtile, int dpad, int vec,
                  int blocks, long long x_stride, long long xx_stride,
                  void* stream) {
  const int rows = 32 * kRowsPerThread * (kWarps / (lanes > 0 ? lanes : 1));
  const int groups = lanes > 0 ? (B + lanes - 1) / lanes : 0;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(rows + lanes * kCenters) * dpad;
  if (n < 1 || d < 1 || B < 1 || k < 1 ||
      !(lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8) ||
      dtile < 1 || dtile > d || (dtile < d && dtile % 4 != 0) ||
      dpad < dtile || dpad % 4 != 0 ||
      !(vec == 1 || vec == 2 || vec == 4) || d % vec != 0 ||
      groups > 65535 || blocks != (n + rows - 1) / rows ||
      smem > kMaxDynamicSmem || x_stride < 0 || xx_stride < 0 ||
      ((x_stride != 0 || xx_stride != 0) && lanes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, groups);
  if (vec == 4)
    assign_kernel<4><<<grid, kThreads, smem, s>>>(
        X, C, xx, cc, w, assign, min_d2, part, n, d, B, k, lanes, dtile,
        dpad, x_stride, xx_stride);
  else if (vec == 2)
    assign_kernel<2><<<grid, kThreads, smem, s>>>(
        X, C, xx, cc, w, assign, min_d2, part, n, d, B, k, lanes, dtile,
        dpad, x_stride, xx_stride);
  else
    assign_kernel<1><<<grid, kThreads, smem, s>>>(
        X, C, xx, cc, w, assign, min_d2, part, n, d, B, k, lanes, dtile,
        dpad, x_stride, xx_stride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lane_sum_kernel<<<B, kThreads, 0, s>>>(part, inertia, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
