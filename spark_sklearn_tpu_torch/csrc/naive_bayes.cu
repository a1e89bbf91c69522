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
//     all float32 row-major.  The direct form stays: the expanded x^2/var
//     - 2 x theta/var + theta^2/var rounds differently from sklearn once
//     var sits at its epsilon floor.  Each term is (x - theta)^2 times
//     1/var, the correctly rounded reciprocal taken once a (lane, class,
//     feature), added by one fused multiply-add: within ~1 ulp of the
//     division a term, which the first version (and the plain version)
//     took by an IEEE division, a multi-instruction sequence.
//     Bound: it reads X once and writes jll once (at the GaussianNB
//     search's shape, m=100000, d=54, B=60, k=7: 21.6 MB read, 168 MB
//     written, ~0.057 ms at 3.35 TB/s), but it does 4 operations (a
//     subtract, a multiply, a divide, an add) for each of B*m*k*d terms,
//     9.1e9 at that shape: ~0.14 ms at 67 TFLOP/s float32.  So B1 is bound
//     by its arithmetic; this design issues 3 instructions a term (a
//     subtract, a multiply, a fused multiply-add).
//
// Design (the second; the first took one thread a (row, class) pair, an
// IEEE division and three shared-memory loads a term, and a block a lane).
// - A block of 128 threads takes a tile of 256 rows and a group of lanes
//   (grid: row tiles x lane groups, `jll_plan` adding groups only where
//   the row tiles alone give fewer than ~2 blocks an SM).  It stages its tile of X once, transposed
//   (feature-major, a row stride of 258 floats), and walks every lane of
//   its group over it; only where d exceeds a chunk of `tc` features (64
//   KB of X) is X staged again a chunk.
// - Register tiling: a thread holds its 2 rows of two lanes (a pass) and
//   a chunk of KC <= 8 of their classes (a template: every accumulator in
//   registers).  For each feature it loads its two x values (one 8-byte
//   load) and each lane's theta and 1/var for the chunk (four 16-byte
//   loads every thread of the block reads alike: broadcasts), 9
//   shared-memory loads for 4 KC terms.  Two lanes a pass also halve the
//   passes' barriers and staging.  (Diagnostic builds, not kept, read one
//   lane a pass slower at the search's shape, and three or more slower
//   too: their registers and shared memory cut the blocks an SM holds.)
// - Per (pass, class chunk, feature chunk) the block stages theta, 1/var
//   and log(2 pi var) for the chunk's features, 8 classes a feature a
//   lane; a class's ll sums the logs in feature order (one thread a lane
//   and class), as the first version did.
// - Each pair's sum runs in feature order across the chunks, so the same
//   inputs give the same bits on the same card.  The tile of results goes
//   through shared memory, so each lane's rows are written contiguously
//   (rows x k floats when the chunk holds every class).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;            // threads a block
constexpr int kRowsPerThread = 2;
constexpr int kRows = kThreads * kRowsPerThread;   // rows of a tile
constexpr int kXStride = kRows + 2;      // floats between features of xs
constexpr int kMaxKC = 8;                // classes of a chunk
constexpr int kPass = 2;                 // lanes a pass over the X tile
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

// floats of the transposed X tile, rounded up so the next array starts
// 16-byte aligned
__host__ __device__ __forceinline__ int x_floats(int tc) {
  return (tc * kXStride + 3) / 4 * 4;
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
    gnb_jll_kernel(const float* __restrict__ X,
                   const float* __restrict__ theta,
                   const float* __restrict__ var,
                   const float* __restrict__ log_prior,
                   float* __restrict__ out, int m, int d, int B, int k,
                   int tc, int lanes) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // tc x kXStride
  float* tr = xs + x_floats(tc);                 // kPass x tc x 16
  float* lg = tr + kPass * 16 * tc;              // kPass x tc x 8
  float* base = lg + kPass * kMaxKC * tc;        // kPass x 8
  float* ot = base + kPass * kMaxKC;             // kRows x KC results
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, m - r0);
  const int b0 = blockIdx.y * lanes;
  const int b1 = min(B, b0 + lanes);
  const int nt = (d + tc - 1) / tc;

  auto stage_x = [&](int t0, int tcn) {
    for (int e = tid; e < kRows * tcn; e += kThreads) {
      const int row = e / tcn;
      const int t = e - row * tcn;
      xs[t * kXStride + row] =
          row < nr ? X[static_cast<size_t>(r0 + row) * d + t0 + t] : 0.0f;
    }
  };
  if (nt == 1) stage_x(0, d);              // once for every lane

  for (int b = b0; b < b1; b += kPass) {
    const int nl = min(kPass, b1 - b);
    for (int j0 = 0; j0 < k; j0 += KC) {
      const int nc = min(KC, k - j0);
      float acc[kPass][kRowsPerThread][KC];
#pragma unroll
      for (int l = 0; l < kPass; ++l)
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[l][q][j] = 0.0f;
      float ll = 0.0f;                     // thread l * 8 + j: its sum
      for (int c = 0; c < nt; ++c) {
        const int t0 = c * tc;
        const int tcn = min(tc, d - t0);
        __syncthreads();                   // the last readers are done
        if (nt > 1) stage_x(t0, tcn);
        for (int e = tid; e < kPass * tcn * kMaxKC; e += kThreads) {
          const int lt = e / kMaxKC;       // l * tcn + t
          const int j = e - lt * kMaxKC;
          const int l = lt / tcn;
          float th = 0.0f, rv = 0.0f, lv = 0.0f;
          if (j < nc && l < nl) {
            const size_t at = (static_cast<size_t>(b + l) * k + j0 + j) * d +
                              t0 + (lt - l * tcn);
            const float v = var[at];
            th = theta[at];
            rv = __frcp_rn(v);
            lv = logf(kTwoPi * v);
          }
          tr[lt * 16 + j] = th;
          tr[lt * 16 + kMaxKC + j] = rv;
          lg[lt * kMaxKC + j] = lv;
        }
        __syncthreads();
        if (tid < kPass * kMaxKC) {
          const int l = tid / kMaxKC, j = tid - l * kMaxKC;
          for (int t = 0; t < tcn; ++t) ll += lg[(l * tcn + t) * kMaxKC + j];
        }
        const float* xp = xs + kRowsPerThread * tid;
#pragma unroll 2
        for (int t = 0; t < tcn; ++t) {
          const float2 xv = *reinterpret_cast<const float2*>(xp + t * kXStride);
#pragma unroll
          for (int l = 0; l < kPass; ++l) {
            const float4* tp =
                reinterpret_cast<const float4*>(tr + (l * tcn + t) * 16);
            const float4 ta = tp[0], tb = tp[1], ra = tp[2], rb = tp[3];
            const float th[kMaxKC] = {ta.x, ta.y, ta.z, ta.w,
                                      tb.x, tb.y, tb.z, tb.w};
            const float rv[kMaxKC] = {ra.x, ra.y, ra.z, ra.w,
                                      rb.x, rb.y, rb.z, rb.w};
#pragma unroll
            for (int j = 0; j < KC; ++j) {
              const float d0 = xv.x - th[j];
              const float d1 = xv.y - th[j];
              acc[l][0][j] = fmaf(d0 * d0, rv[j], acc[l][0][j]);
              acc[l][1][j] = fmaf(d1 * d1, rv[j], acc[l][1][j]);
            }
          }
        }
      }
      if (tid < kPass * kMaxKC) {
        const int l = tid / kMaxKC, j = tid - l * kMaxKC;
        base[tid] = j < nc && l < nl
                        ? log_prior[static_cast<size_t>(b + l) * k + j0 + j] +
                              __fmul_rn(-0.5f, ll)
                        : 0.0f;
      }
      for (int l = 0; l < nl; ++l) {
        __syncthreads();                   // base written; ot read
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
          for (int j = 0; j < KC; ++j)
            ot[(kRowsPerThread * tid + q) * KC + j] =
                base[l * kMaxKC + j] - __fmul_rn(0.5f, acc[l][q][j]);
        __syncthreads();
        float* ob = out + (static_cast<size_t>(b + l) * m + r0) * k + j0;
        if (nc == k) {                     // the rows' results contiguous
          for (int e = tid; e < nr * KC; e += kThreads) ob[e] = ot[e];
        } else {
          for (int e = tid; e < nr * nc; e += kThreads) {
            const int row = e / nc;
            const int j = e - row * nc;
            ob[static_cast<size_t>(row) * k + j] = ot[row * KC + j];
          }
        }
      }
    }
  }
}

template <int KC>
int launch(const float* X, const float* theta, const float* var,
           const float* log_prior, float* out, int m, int d, int B, int k,
           int tc, int lanes, size_t smem, cudaStream_t s) {
  static int raised[kMaxDevices] = {};
  const int rc = allow_smem(gnb_jll_kernel<KC>, smem, raised);
  if (rc != 0) return rc;
  const dim3 grid((m + kRows - 1) / kRows, (B + lanes - 1) / lanes);
  gnb_jll_kernel<KC><<<grid, kThreads, smem, s>>>(X, theta, var, log_prior,
                                                  out, m, d, B, k, tc, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kc: classes of a chunk (min(k, 8)); tc: features of an X chunk; lanes:
// lanes of a block's group, as nb_kernels.py `jll_plan` picks them.
// Returns the first nonzero cudaError of the launch (0 = launched).
int gnb_jll(const float* X, const float* theta, const float* var,
            const float* log_prior, float* out, int m, int d, int B, int k,
            int kc, int tc, int lanes, void* stream) {
  if (m < 1 || d < 1 || B < 1 || k < 1 || kc < 1 || kc > kMaxKC ||
      kc > k || tc < 1 || tc > d || lanes < 1 || lanes > B ||
      (B + lanes - 1) / lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(x_floats(tc)) +
                       kPass * (24 * tc + kMaxKC) +
                       static_cast<size_t>(kRows) * kc);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 1: return launch<1>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    case 2: return launch<2>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    case 3: return launch<3>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    case 4: return launch<4>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    case 5: return launch<5>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    case 6: return launch<6>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    case 7: return launch<7>(X, theta, var, log_prior, out, m, d, B, k, tc,
                             lanes, smem, s);
    default: return launch<8>(X, theta, var, log_prior, out, m, d, B, k, tc,
                              lanes, smem, s);
  }
}

}  // extern "C"
