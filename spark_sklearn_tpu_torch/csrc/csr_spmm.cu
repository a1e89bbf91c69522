// SP1, the product of a CSR matrix and a dense matrix, for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py);
// the Python wrapper lives in spark_sklearn_tpu_torch/ops/spmm_kernels.py
// beside its plain PyTorch version and the launch plan (`spmm_plan`).
//
// SP1  csr_spmm   replaces XLA's BCOO gather/scatter products of the
//     reference's sparse path: spark_sklearn_tpu/models/linear.py:213-219,
//     267-277 (`Ax`, X Wᵀ), :228-236, 288-297 (`AT`, Gᵀ X), :345-346 (the
//     views), and the naive Bayes class sums and joint log-likelihoods on a
//     BCOO X (naive_bayes.py:74-95 `_class_sums`, :331-332 and :374-375
//     `_jll`):
//       Y[r, :] = sum over j in row r of values[j] * D[indices[j], :]
//     A (m rows) as int32 indptr (m+1) and indices (nnz), float32 values
//     (nnz); D (K, W) and Y (m, W) float32 row-major.  One kernel serves
//     both directions of the port's operand (sparse/csr.py CSROperand):
//     X with D = Wᵀ, and Xᵀ's CSR with D = Gᵀ.
//     Order: each Y element is summed in float32 in ascending order of its
//     row's nonzeros, a product rounded (__fmul_rn) then added (__fadd_rn)
//     from 0, so the same inputs give the same bits on every launch and the
//     bits of the plain version on the CPU (a gather times the values, then
//     index_add_ in that order).
//     Bound: the bytes it must move, A's arrays and D read once and Y
//     written once, 4 (m+1) + 8 nnz + 4 K W + 4 m W; its 2 nnz W operations
//     are far below (W = 1000: 2000 flops a nonzero against 8 bytes).  But
//     the rows of D that the nonzeros gather are nnz W 4 bytes, and at the
//     20-newsgroups shape (K = 130107, W = 1000: 520 MB of D against 50 MB
//     of L2) most of them come from device memory: the gathers, not the
//     bound, set its time.
//
// Design (the first: right and simple).
// - Row-parallel, no atomics: a block walks `rows` rows of A strided by
//   the grid (rows b, b + G, b + 2G, ... of a grid of G blocks in x), so
//   that long neighbouring rows (the Zipf head of Xᵀ: the frequent
//   columns hold ~11000 nonzeros each) fall to different blocks; its
//   threads cover a tile of threads x kCols of W's columns (the grid's
//   y); thread t holds columns t, t + threads, ..., so a warp reads 32
//   consecutive floats of a gathered row of D (coalesced) and writes Y
//   the same way.
// - A row's (index, value) pairs are staged in shared memory kStage at a
//   time by the whole block; every thread then loads the D values of
//   kBatch nonzeros (kBatch x kCols loads in flight) before it adds them,
//   in order, to its kCols accumulators in registers: a long row's time is
//   its gathers' latency, and the batch hides kBatch of them at once.
// - Empty rows are written as zeros; columns past W are masked.
// (Measured on the H100 in the design's first form, 4 consecutive rows a
// block and one nonzero's loads at a time: the backward at the
// 20-newsgroups shape took 18.1 ms, one block walking the 4 longest rows.)

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;         // threads a block, at most
constexpr int kCols = 4;                 // columns a thread
constexpr int kStage = 256;              // nonzeros staged at once
constexpr int kBatch = 8;                // nonzeros whose loads fly at once

__global__ void __launch_bounds__(kMaxThreads)
    csr_spmm_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float* __restrict__ values,
                    const float* __restrict__ D, float* __restrict__ Y,
                    int m, int W, int rows) {
  __shared__ int s_idx[kStage];
  __shared__ float s_val[kStage];
  const int nt = blockDim.x;
  const int c0 = blockIdx.y * nt * kCols + threadIdx.x;
  for (int i = 0; i < rows; ++i) {
    const int r = blockIdx.x + i * gridDim.x;
    if (r >= m) break;                   // uniform across the block
    float acc[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
    const int beg = indptr[r];
    const int end = indptr[r + 1];
    for (int j0 = beg; j0 < end; j0 += kStage) {
      const int nj = min(kStage, end - j0);
      __syncthreads();                   // the last chunk's readers are done
      for (int e = threadIdx.x; e < nj; e += nt) {
        s_idx[e] = indices[j0 + e];
        s_val[e] = values[j0 + e];
      }
      __syncthreads();
      for (int j = 0; j < nj; j += kBatch) {
        const int nb = min(kBatch, nj - j);  // uniform across the block
        float v[kBatch];
        float dv[kBatch][kCols];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = 0.0f;
#pragma unroll
          for (int q = 0; q < kCols; ++q) dv[u][q] = 0.0f;
          if (u < nb) {
            v[u] = s_val[j + u];
            const float* drow = D + static_cast<size_t>(s_idx[j + u]) * W;
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              const int c = c0 + q * nt;
              if (c < W) dv[u][q] = __ldg(drow + c);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < nb) {
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              acc[q] = __fadd_rn(acc[q], __fmul_rn(v[u], dv[u][q]));
          }
        }
      }
    }
    float* yrow = Y + static_cast<size_t>(r) * W;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = c0 + q * nt;
      if (c < W) yrow[c] = acc[q];
    }
  }
}

}  // namespace

extern "C" {

// threads: a block's threads (a multiple of 32, at most 256); rows: the
// rows a block walks, as spmm_kernels.py `spmm_plan` picks them.  Returns
// the first nonzero cudaError of the launch (0 = launched).
int csr_spmm(const int* indptr, const int* indices, const float* values,
             const float* D, float* Y, int m, int W, int threads, int rows,
             void* stream) {
  if (m < 1 || W < 1 || rows < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile = static_cast<long long>(threads) * kCols;
  const long long tiles = (W + tile - 1) / tile;
  const long long blocks = (static_cast<long long>(m) + rows - 1) / rows;
  if (tiles > 65535 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  csr_spmm_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, values, D, Y, m, W, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
