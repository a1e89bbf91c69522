// Fused GLM epilogues of the batched L-BFGS logistic-regression fit, for
// Hopper (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py);
// the Python wrappers live in spark_sklearn_tpu_torch/ops/glm_kernels.py
// beside their plain PyTorch versions.
//
// Layout (the reference's contract, solvers.py `_bcast`): the lane axis of
// the (candidate x fold) tasks sits at position 1, so logits are
// Z (n, B, k) row-major for the multinomial loss and Z (n, B) for the
// binary one (k == 2, one logit per lane).  wT (n, B) holds each lane's
// per-sample fold weight, y (n,) the encoded labels (int32).
//
// K2  glm_loss_grad   replaces spark_sklearn_tpu/models/linear.py:221-226
//     and :279-286 (`data_loss` / `data_grad`, fused by XLA there):
//       loss[b] = sum_n w[n,b] * (lse(Z[n,b,:]) - Z[n,b,y[n]])
//       G[n,b,:] = w[n,b] * (softmax(Z[n,b,:]) - onehot(y[n]))
//     binary: logaddexp(0, z) - y*z and w*(sigmoid(z) - y).
//     Bound: bytes.  It reads Z and wT once and writes G once; at the
//     headline shape (n=1797, B=5000, k=10) that is ~0.75 GB, ~0.22 ms
//     at 3.35 TB/s.  Its 2 exponentials per logit (~1.8e8) are far below
//     the special-function units' rate.
//
// K4  glm_trial_loss  replaces spark_sklearn_tpu/ops/solvers.py:290-306
//     (the 16-trial Armijo line search, one vmap over trials there):
//       out[t,b] = sum_n w[n,b] * loss(Z[n,b,:] + alphas[t,b] * Zp[n,b,:])
//     Bound: it reads Z, Zp and wT once (~0.75 GB, ~0.22 ms), but it
//     also evaluates T*n*B*k exponentials (16 x 9.0e7 = 1.44e9 at the
//     headline shape) plus T*n*B logarithms.  At the special-function
//     units' 16 results/clock/SM that is ~0.35-0.4 ms on a 132-SM card,
//     so K4 is bound by the SFUs rather than by memory.
//
// Design (simple and right first): a block holds 32 lanes (threadIdx.x)
// and 16 row groups (threadIdx.y).  Thread (x, y) walks rows
// n = y, y+16, ... of lane blockIdx.x*32 + x, so the 32 threads of a warp
// read 32 neighbouring lanes' k contiguous logits: loads coalesce on the
// (n, B, k) layout.  For k <= 16 a row's logits (and K4's Zp row) are
// cached in registers, so the 16 trials cost no extra memory traffic;
// larger k re-reads them from L1.  Per-thread sums stay in registers;
// the 16 row groups are then added in shared memory in a fixed order.
// No atomics: results are deterministic run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;    // lanes per block (threadIdx.x)
constexpr int kRows = 16;     // row groups per block (threadIdx.y)
constexpr int kKReg = 16;     // classes cached in registers
constexpr int kTMax = 16;     // most line-search trials

// loop over the k classes; with KM > 0 the bound is a compile-time
// constant so the loop unrolls and register arrays stay in registers
#define FOR_CLASSES(j) \
  _Pragma("unroll") for (int j = 0; j < (KM > 0 ? KM : k); ++j) \
    if (KM == 0 || j < k)

__device__ __forceinline__ float softplus_minus(float z, float yb) {
  // logaddexp(0, z) - y*z, in the reference's stable form
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - yb * z;
}

// logsumexp shift: the max, or 0 when the max is not finite (as
// jax.scipy.special.logsumexp and torch.logsumexp do)
__device__ __forceinline__ float lse_shift(float m) {
  return isfinite(m) ? m : 0.f;
}

template <int KM, bool BINARY>
__global__ void __launch_bounds__(kLanes * kRows)
loss_grad_kernel(const float* __restrict__ Z, const float* __restrict__ W,
                 const int* __restrict__ y, float* __restrict__ G,
                 float* __restrict__ loss, int n, int B, int k) {
  __shared__ float part[kRows][kLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * kLanes + tx;
  float acc = 0.f;
  if (b < B) {
    for (int i = ty; i < n; i += kRows) {
      const size_t row = (size_t)i * B + b;
      const float w = W[row];
      const int yi = y[i];
      if (BINARY) {
        const float z = Z[row];
        const float yb = (float)yi;
        acc += w * softplus_minus(z, yb);
        G[row] = w * (1.f / (1.f + expf(-z)) - yb);
      } else {
        const float* zr = Z + row * k;
        float* gr = G + row * k;
        float zc[KM > 0 ? KM : 1];
        float m = -INFINITY, zy = 0.f;
        FOR_CLASSES(j) {
          const float v = zr[j];
          if (KM > 0) zc[j] = v;
          m = fmaxf(m, v);
          zy = (j == yi) ? v : zy;
        }
        const float sh = lse_shift(m);
        float s = 0.f;
        FOR_CLASSES(j) s += expf((KM > 0 ? zc[j] : zr[j]) - sh);
        acc += w * (sh + logf(s) - zy);
        const float inv = 1.f / s;
        FOR_CLASSES(j) {
          const float p = expf((KM > 0 ? zc[j] : zr[j]) - sh) * inv;
          gr[j] = w * (p - (j == yi ? 1.f : 0.f));
        }
      }
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && b < B) {
    float t = 0.f;
    for (int r = 0; r < kRows; ++r) t += part[r][tx];
    loss[b] = t;
  }
}

template <int KM, bool BINARY>
__global__ void __launch_bounds__(kLanes * kRows)
trial_loss_kernel(const float* __restrict__ Z, const float* __restrict__ Zp,
                  const float* __restrict__ W, const int* __restrict__ y,
                  const float* __restrict__ alphas, float* __restrict__ out,
                  int n, int B, int k, int T) {
  __shared__ float part[kRows][kTMax][kLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * kLanes + tx;
  float a[kTMax], acc[kTMax];
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
    a[t] = (b < B && t < T) ? alphas[(size_t)t * B + b] : 0.f;
    acc[t] = 0.f;
  }
  if (b < B) {
    for (int i = ty; i < n; i += kRows) {
      const size_t row = (size_t)i * B + b;
      const float w = W[row];
      const int yi = y[i];
      if (BINARY) {
        const float z = Z[row], zp = Zp[row];
        const float yb = (float)yi;
#pragma unroll
        for (int t = 0; t < kTMax; ++t)
          if (t < T) acc[t] += w * softplus_minus(z + a[t] * zp, yb);
      } else {
        const float* zr = Z + row * k;
        const float* pr = Zp + row * k;
        float zc[KM > 0 ? KM : 1], pc[KM > 0 ? KM : 1];
        if (KM > 0) {
          FOR_CLASSES(j) {
            zc[j] = zr[j];
            pc[j] = pr[j];
          }
        }
#pragma unroll
        for (int t = 0; t < kTMax; ++t) {
          if (t >= T) break;
          float m = -INFINITY, zy = 0.f;
          FOR_CLASSES(j) {
            const float v = (KM > 0 ? zc[j] : zr[j]) +
                            a[t] * (KM > 0 ? pc[j] : pr[j]);
            m = fmaxf(m, v);
            zy = (j == yi) ? v : zy;
          }
          const float sh = lse_shift(m);
          float s = 0.f;
          FOR_CLASSES(j) {
            s += expf((KM > 0 ? zc[j] : zr[j]) +
                      a[t] * (KM > 0 ? pc[j] : pr[j]) - sh);
          }
          acc[t] += w * (sh + logf(s) - zy);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTMax; ++t) part[ty][t][tx] = acc[t];
  __syncthreads();
  if (ty == 0 && b < B) {
    for (int t = 0; t < T; ++t) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += part[r][t][tx];
      out[(size_t)t * B + b] = s;
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int glm_loss_grad(const float* Z, const float* W, const int* y, float* G,
                  float* loss, int n, int B, int k, int binary,
                  void* stream) {
  const dim3 block(kLanes, kRows);
  const dim3 grid((B + kLanes - 1) / kLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (binary)
    loss_grad_kernel<0, true><<<grid, block, 0, s>>>(Z, W, y, G, loss, n,
                                                     B, k);
  else if (k <= kKReg)
    loss_grad_kernel<kKReg, false><<<grid, block, 0, s>>>(Z, W, y, G, loss,
                                                          n, B, k);
  else
    loss_grad_kernel<0, false><<<grid, block, 0, s>>>(Z, W, y, G, loss, n,
                                                      B, k);
  return static_cast<int>(cudaGetLastError());
}

int glm_trial_loss(const float* Z, const float* Zp, const float* W,
                   const int* y, const float* alphas, float* out, int n,
                   int B, int k, int T, int binary, void* stream) {
  if (T < 1 || T > kTMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kLanes, kRows);
  const dim3 grid((B + kLanes - 1) / kLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (binary)
    trial_loss_kernel<0, true><<<grid, block, 0, s>>>(Z, Zp, W, y, alphas,
                                                      out, n, B, k, T);
  else if (k <= kKReg)
    trial_loss_kernel<kKReg, false><<<grid, block, 0, s>>>(
        Z, Zp, W, y, alphas, out, n, B, k, T);
  else
    trial_loss_kernel<0, false><<<grid, block, 0, s>>>(Z, Zp, W, y, alphas,
                                                       out, n, B, k, T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
