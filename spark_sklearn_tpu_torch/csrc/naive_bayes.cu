// GaussianNB's joint log-likelihood (B1) for Hopper (sm_90a).  Built with
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (spark_sklearn_tpu_torch/ops/_build.py); the Python wrapper lives
// in spark_sklearn_tpu_torch/ops/nb_kernels.py beside its plain PyTorch
// version and the launch plan (`jll_plan`).
//
// B1  gnb_jll   replaces spark_sklearn_tpu/models/naive_bayes.py:174-187
//     (`_jll`, a broadcast-reduce XLA fuses):
//       jll[b,i,j] = (log_prior[b,j] + ll[b,j])
//                    - 0.5 * sum_t (X[i,t] - theta[b,j,t])^2 / var[b,j,t]
//       ll[b,j]    = -0.5 * sum_t log(2 pi var[b,j,t])
//     X (m, d), theta and var (B, k, d), log_prior (B, k), jll (B, m, k),
//     all float32 row-major.  The division stays (sklearn's direct form):
//     the expanded x^2/var - 2 x theta/var + theta^2/var rounds
//     differently from sklearn once var sits at its epsilon floor.
//     Bound: it reads X once and writes jll once (at the GaussianNB
//     search's shape, m=100000, d=54, B=60, k=7: 21.6 MB read, 168 MB
//     written), but it also does 4 operations (a subtract, a multiply, a
//     divide, an add) for each of B*m*k*d terms, 9.1e9 at that shape:
//     ~0.14 ms at 67 TFLOP/s float32 against ~0.057 ms of bytes at
//     3.35 TB/s, so B1 is bound by its arithmetic (and a division is
//     several instructions, so by more than the bound says).
//
// Design.
// - Grid: (ceil(m / rows) row tiles) x (B lanes); 256 threads a block.
//   A block stages its tile of X rows and a chunk of kc of its lane's
//   classes (theta and var) in shared memory, each row padded to d + 1
//   floats (an odd stride: threads on different rows or classes read
//   different banks), then walks the tile's (row, class) pairs, class
//   fastest, so that a warp's stores to jll are contiguous.  The wrapper
//   picks rows and kc so that the block stays within 100 KB of shared
//   memory (`jll_plan`); a lane with more classes takes several chunks.
// - Each pair sums its d terms in feature order in one thread, and each
//   chunk's ll in one thread a class, in feature order: the same inputs
//   give the same bits on the same card.  The multiplies by 0.5 are
//   __fmul_rn so that nvcc does not fuse them into the sums.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;            // threads a block
constexpr int kMaxRows = 32;             // most rows of a tile
constexpr float kTwoPi = 6.28318530717958647692f;

constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared-memory limit to `smem` where it is
// above the default 48 KB, once a device and size (never again for a
// size already allowed, so a launch captured in a CUDA graph makes no
// attribute call).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, int* raised) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && raised[dev] >= static_cast<int>(smem)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && dev < kMaxDevices)
    raised[dev] = static_cast<int>(smem);
  return static_cast<int>(e);
}

__global__ void __launch_bounds__(kThreads)
    gnb_jll_kernel(const float* __restrict__ X,
                   const float* __restrict__ theta,
                   const float* __restrict__ var,
                   const float* __restrict__ log_prior,
                   float* __restrict__ out, int m, int d, int k, int rows,
                   int kc) {
  extern __shared__ float smem[];
  const int stride = d + 1;
  float* xs = smem;                      // rows x stride
  float* ts = xs + rows * stride;        // kc x stride
  float* vs = ts + kc * stride;          // kc x stride
  float* base = vs + kc * stride;        // kc: log_prior + ll
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, m - r0);
  const float* Xb = X + static_cast<size_t>(r0) * d;
  for (int e = threadIdx.x; e < nr * d; e += kThreads) {
    const int r = e / d;
    xs[r * stride + (e - r * d)] = Xb[e];
  }
  const float* tb = theta + static_cast<size_t>(b) * k * d;
  const float* vb = var + static_cast<size_t>(b) * k * d;
  float* ob = out + (static_cast<size_t>(b) * m + r0) * k;
  for (int j0 = 0; j0 < k; j0 += kc) {
    const int nc = min(kc, k - j0);
    __syncthreads();                     // the last chunk's reads are done
    const size_t off = static_cast<size_t>(j0) * d;
    for (int e = threadIdx.x; e < nc * d; e += kThreads) {
      const int j = e / d;
      const int at = j * stride + (e - j * d);
      ts[at] = tb[off + e];
      vs[at] = vb[off + e];
    }
    __syncthreads();
    if (threadIdx.x < nc) {
      const float* vr = vs + threadIdx.x * stride;
      float s = 0.0f;
      for (int t = 0; t < d; ++t) s += logf(kTwoPi * vr[t]);
      base[threadIdx.x] =
          log_prior[static_cast<size_t>(b) * k + j0 + threadIdx.x] +
          __fmul_rn(-0.5f, s);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < nr * nc; p += kThreads) {
      const int r = p / nc;
      const int j = p - r * nc;
      const float* xr = xs + r * stride;
      const float* tr = ts + j * stride;
      const float* vr = vs + j * stride;
      float q = 0.0f;
      for (int t = 0; t < d; ++t) {
        const float diff = xr[t] - tr[t];
        q += __fdiv_rn(__fmul_rn(diff, diff), vr[t]);
      }
      ob[static_cast<size_t>(r) * k + j0 + j] = base[j] - __fmul_rn(0.5f, q);
    }
  }
}

}  // namespace

extern "C" {

// Returns the first nonzero cudaError of the launch (0 = launched).
int gnb_jll(const float* X, const float* theta, const float* var,
            const float* log_prior, float* out, int m, int d, int B, int k,
            int rows, int kc, void* stream) {
  if (m < 1 || d < 1 || B < 1 || k < 1 || rows < 1 || rows > kMaxRows ||
      kc < 1 || kc > k || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(rows) + 2 * static_cast<size_t>(kc)) * (d + 1) *
          sizeof(float) +
      kc * sizeof(float);
  static int raised[kMaxDevices] = {};
  const int rc = allow_smem(gnb_jll_kernel, smem, raised);
  if (rc != 0) return rc;
  const dim3 grid((m + rows - 1) / rows, B);
  gnb_jll_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      X, theta, var, log_prior, out, m, d, k, rows, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
