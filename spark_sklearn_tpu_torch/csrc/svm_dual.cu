// Kernel-SVM device passes of the SVC/NuSVC dual solve, for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C interface
// and loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py); the
// Python wrappers live in spark_sklearn_tpu_torch/ops/svm_kernels.py beside
// their plain PyTorch versions.
//
// S1  svm_gram_epilogue   replaces the elementwise part of
//     spark_sklearn_tpu/models/svm.py:45-56 (`_kernel`).  The caller has
//     already written G = X1 X2^T (a library GEMM, TF32 off); this turns G
//     into the kernel matrix in place:
//       rbf      K = exp(-gamma * max(|x1_i|^2 - 2 G_ij + |x2_j|^2, 0))
//       poly     K = (gamma G_ij + coef0)^degree
//       sigmoid  K = tanh(gamma G_ij + coef0)
//     For rbf it first takes the squared row norms: of X X^T (the kernel
//     matrix of a fit), from the product's own diagonal, copied out before
//     the epilogue rewrites it, so d2_ii = G_ii - 2 G_ii + G_ii is exactly
//     0 and the diagonal exactly 1, whatever order the norms would be
//     summed in; of X1 X2^T (a prediction), by a row-norms kernel (one warp
//     a row, a fixed-order shuffle sum).  Bound: bytes.  It reads G once
//     and writes K once: at n = 10000, 800 MB, ~0.24 ms at an H100 SXM's
//     3.35 TB/s (data sheet, 700 W); one expf a value is ~2% of that on
//     the FMA pipe and SFUs.  Full-precision expf/tanhf/powf, no
//     intrinsics: K feeds every ascent product of the solve, so its error
//     compounds.  The products and sums round like the plain version's
//     separate operations (__f*_rn, no contraction into FMA).
//
// S2  svm_dual_step       replaces one Nesterov step of `_box_fista`
//     (svm.py:94-99, :113-122) after the ascent product V = (z*yb) K, with
//     its projection: `_project_box_hyperplane` (:132-155, SVC) or NuSVC's
//     two half box-sum projections (`_project_box_sum` :158-175 as
//     `nu_dual_ascent` uses it, :249-254).  Per row r of M subproblems:
//       u  = z - step * grad         grad = -(1 - yb V)  (SVC, :322-323)
//                                    grad = yb V         (NuSVC, :253-254)
//                                    (no V: u = z, a projection only)
//       x' = proj(u)                 40 bisection steps on the multiplier
//       z' = x' + coef (x' - x)      coef = (t - 1) / t_new, from the host
//       w' = z' yb                   the next ascent product's operand
//       resid[r] = max_i |x'_i - z_i| / step
//     The bracket ([-(max|u| + max b), +...] for the hyperplane, +-(max|u|
//     + max b + 1) for each half box-sum), the 40 steps, the comparison
//     (g > 0, resp. g > target) and the final midpoint are the reference's,
//     so the projection agrees with it to rounding.
//     Bound: bytes.  It reads V, z, x, yb, bound and writes x', z', w' once:
//     at M = 225, n = 10000 that is 72 MB, ~0.022 ms at 3.35 TB/s; the 40
//     passes of ~6 operations over M*n elements are ~0.008 ms at 67
//     TFLOP/s.  In torch ops the same step is ~330 launches.
//
// Design of S2.
// - One block of 512 threads a row (M = 225 rows: one wave at two blocks
//   an SM on 132 SMs).  The first pass computes u and stages it, with the
//   row's bound and the sign of yb (yb is -1, 0 or +1: the SVM's signed
//   pair labels), in dynamic shared memory: 9 bytes an element, 88 KB at
//   n = 10000.  The 40 bisection passes then read only shared memory; the
//   last pass re-reads z, x and yb (from L2) to write x', z' and w'.
// - Plan change: above kStagedMaxN = 20480 elements a row (180 KB of
//   shared memory) the row does not fit; the "streamed" plan stores u in
//   the row of x' and re-reads bound and yb from global memory (L2) on each
//   pass.  The wrapper picks the plan from n (svm_kernels.py
//   `STAGED_MAX_N`); a staged launch with n above the limit is refused.
//   Below the limit staging pays: at M = 225, n = 10000 a step takes
//   0.096 ms staged and 0.128 ms streamed (SVC; NuSVC 0.143 / 0.180 ms;
//   H100 80GB HBM3 at 700 W, chip_smoke.py phase 3).
// - Each bisection step ends in a block-wide sum: warp shuffles (down, a
//   fixed tree), then warp 0 adds the 16 warp sums in order.  No atomics:
//   the same inputs give the same bits.  Every thread then holds the same
//   lo/hi and takes the same branch.
// - Maxima propagate NaN as jnp.max and torch.amax do, and the clip is
//   written as min(max(x, 0), b) with NaN passing through, as jnp.clip.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNormWarps = 8;              // rows of one norms block
constexpr int kEpiThreads = 256;
constexpr int kEpiPerThread = 4;           // elements a thread, loads first
constexpr int kMaxGridY = 65535;
constexpr int kStepThreads = 512;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kBisect = 40;                // svm.py:132 n_bisect
constexpr int kStagedMaxN = 20480;         // 9 bytes an element: 180 KB
constexpr int kMaxNV = 3;                  // most values one reduction adds
constexpr int kMaxDevices = 64;            // devices of one process

enum Kind { kLinear = 0, kRbf = 1, kPoly = 2, kSigmoid = 3 };

// ---------------------------------------------------------------------------
// S1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kNormWarps * 32)
row_sq_norms(const float* __restrict__ X, float* __restrict__ sq, int n,
             int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const float* x = X + static_cast<size_t>(row) * d;
  float s = 0.0f;
  for (int j = lane; j < d; j += 32) s = fmaf(x[j], x[j], s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
  if (lane == 0) sq[row] = s;
}

__global__ void __launch_bounds__(256)
copy_diagonal(const float* __restrict__ G, float* __restrict__ sq, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) sq[i] = G[static_cast<size_t>(i) * n + i];
}

template <int KIND>
__device__ __forceinline__ float kernel_value(float g, float s1, float s2,
                                              float gamma, float degree,
                                              float coef0) {
  if (KIND == kRbf) {
    float d2 = __fadd_rn(__fadd_rn(s1, __fmul_rn(-2.0f, g)), s2);
    d2 = d2 < 0.0f ? 0.0f : d2;            // keeps NaN, as jnp.maximum
    return expf(__fmul_rn(-gamma, d2));
  }
  const float a = __fadd_rn(__fmul_rn(gamma, g), coef0);
  if (KIND == kPoly) return powf(a, degree);
  return tanhf(a);
}

template <int KIND>
__global__ void __launch_bounds__(kEpiThreads)
gram_epilogue(float* __restrict__ G, const float* __restrict__ sq1,
              const float* __restrict__ sq2, int n1, int n2, float gamma,
              float degree, float coef0) {
  const int j0 = blockIdx.x * (kEpiThreads * kEpiPerThread) + threadIdx.x;
  for (int row = blockIdx.y; row < n1; row += gridDim.y) {
    float* g = G + static_cast<size_t>(row) * n2;
    const float s1 = KIND == kRbf ? sq1[row] : 0.0f;
    float v[kEpiPerThread];
#pragma unroll
    for (int q = 0; q < kEpiPerThread; ++q) {
      const int j = j0 + q * kEpiThreads;
      v[q] = j < n2 ? g[j] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kEpiPerThread; ++q) {
      const int j = j0 + q * kEpiThreads;
      if (j < n2)
        g[j] = kernel_value<KIND>(v[q], s1, KIND == kRbf ? sq2[j] : 0.0f,
                                  gamma, degree, coef0);
    }
  }
}

// ---------------------------------------------------------------------------
// S2
// ---------------------------------------------------------------------------

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;        // NaN wins, as jnp.max
}

__device__ __forceinline__ float clip(float x, float b) {
  return x < 0.0f ? 0.0f : (x > b ? b : x);  // NaN passes, as jnp.clip
}

// Block-wide reduction of NV values a thread (sum, or NaN-propagating max),
// in a fixed order; every thread gets the results.  `buf` holds two
// alternating slots of (kStepWarps + 1) * kMaxNV floats; consecutive calls
// take turns (`parity`), so a slot is never rewritten while a slow thread
// may still read its result.
template <int NV, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[NV], float* buf,
                                             int& parity) {
  static_assert(NV <= kMaxNV, "too many values for one reduction");
  float* part = buf + parity * (kStepWarps + 1) * kMaxNV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float x = v[q];
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_down_sync(kFull, x, o);
      x = kMax ? max_nan(x, y) : x + y;
    }
    if (lane == 0) part[warp * NV + q] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float x = lane < kStepWarps ? part[lane * NV + q] : (kMax ? -INFINITY
                                                               : 0.0f);
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_down_sync(kFull, x, o);
        x = kMax ? max_nan(x, y) : x + y;
      }
      if (lane == 0) part[kStepWarps * NV + q] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = part[kStepWarps * NV + q];
  parity ^= 1;
}

// Where a row's staged values live: shared memory (u, bound, sign of yb),
// or for the streamed plan u in the row of x' and bound/yb in place.
template <bool kStaged>
struct RowView {
  float* u;
  const float* b;
  const float* yf;
  signed char* ys;
  __device__ __forceinline__ float yb(int i) const {
    if (kStaged) return static_cast<float>(ys[i]);
    return yf[i];
  }
};

// MODE 0: box + hyperplane sum(yb a) = 0 (SVC); MODE 1: the two half
// box-sums sum_{yb>0} a = sum_{yb<0} a = target[row] (NuSVC).
template <int MODE, bool kStaged>
__global__ void __launch_bounds__(kStepThreads, 2)
dual_step(const float* __restrict__ V, const float* __restrict__ Z,
          const float* __restrict__ X, const float* __restrict__ Yb,
          const float* __restrict__ Bd, const float* __restrict__ step_ptr,
          float coef, const float* __restrict__ target, float* Xo,
          float* __restrict__ Zo, float* __restrict__ Wo,
          float* __restrict__ resid, int n) {
  extern __shared__ float smem[];
  __shared__ float red[2 * (kStepWarps + 1) * kMaxNV];
  int parity = 0;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const float step = *step_ptr;
  RowView<kStaged> row;
  if (kStaged) {
    row.u = smem;
    row.b = smem + n;
    row.ys = reinterpret_cast<signed char*>(smem + 2 * static_cast<size_t>(n));
    row.yf = nullptr;
  } else {
    row.u = Xo + off;
    row.b = Bd + off;
    row.yf = Yb + off;
    row.ys = nullptr;
  }

  // pass 1: the gradient step and the bracket's maxima
  float mx[3] = {0.0f, 0.0f, 0.0f};        // max|u|, max b (+half), -half
  for (int i = threadIdx.x; i < n; i += kStepThreads) {
    const float z = Z[off + i], yb = Yb[off + i], b = Bd[off + i];
    float u = z;
    if (V != nullptr) {
      const float yv = __fmul_rn(yb, V[off + i]);
      const float grad = MODE == 0 ? -__fsub_rn(1.0f, yv) : yv;
      u = __fsub_rn(z, __fmul_rn(step, grad));
    }
    row.u[i] = u;
    if (kStaged) {
      smem[n + i] = b;
      row.ys[i] = static_cast<signed char>((yb > 0.0f) - (yb < 0.0f));
    }
    mx[0] = max_nan(mx[0], fabsf(u));
    if (MODE == 0) {
      mx[1] = max_nan(mx[1], b);
    } else {
      mx[1] = max_nan(mx[1], yb > 0.0f ? b : 0.0f);
      mx[2] = max_nan(mx[2], yb < 0.0f ? b : 0.0f);
    }
  }
  if (MODE == 0) {
    float m[2] = {mx[0], mx[1]};
    block_reduce<2, true>(m, red, parity);
    mx[0] = m[0];
    mx[1] = m[1];
  } else {
    block_reduce<3, true>(mx, red, parity);
  }

  // the bisections: nu (MODE 0) or the two half multipliers (MODE 1)
  float lo[2], hi[2], tgt = 0.0f;
  if (MODE == 0) {
    lo[0] = -__fadd_rn(mx[0], mx[1]);
    hi[0] = -lo[0];
  } else {
    tgt = target[blockIdx.x];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float zmax = __fadd_rn(__fadd_rn(mx[0], mx[1 + h]), 1.0f);
      lo[h] = -zmax;
      hi[h] = zmax;
    }
  }
  for (int s = 0; s < kBisect; ++s) {
    if (MODE == 0) {
      const float mid = 0.5f * (lo[0] + hi[0]);
      float g[1] = {0.0f};
      for (int i = threadIdx.x; i < n; i += kStepThreads) {
        const float yb = row.yb(i);
        const float a = clip(__fsub_rn(row.u[i], __fmul_rn(mid, yb)),
                             row.b[i]);
        g[0] += yb * a;
      }
      block_reduce<1, false>(g, red, parity);
      const bool take_hi = g[0] > 0.0f;
      lo[0] = take_hi ? mid : lo[0];
      hi[0] = take_hi ? hi[0] : mid;
    } else {
      const float mid0 = 0.5f * (lo[0] + hi[0]);
      const float mid1 = 0.5f * (lo[1] + hi[1]);
      float g[2] = {0.0f, 0.0f};
      for (int i = threadIdx.x; i < n; i += kStepThreads) {
        const float yb = row.yb(i), u = row.u[i], b = row.b[i];
        g[0] += clip(__fsub_rn(u, mid0), yb > 0.0f ? b : 0.0f);
        g[1] += clip(__fsub_rn(u, mid1), yb < 0.0f ? b : 0.0f);
      }
      block_reduce<2, false>(g, red, parity);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mid = h == 0 ? mid0 : mid1;
        const bool take_hi = g[h] > tgt;
        lo[h] = take_hi ? mid : lo[h];
        hi[h] = take_hi ? hi[h] : mid;
      }
    }
  }
  const float m0 = 0.5f * (lo[0] + hi[0]);
  const float m1 = MODE == 0 ? 0.0f : 0.5f * (lo[1] + hi[1]);

  // last pass: x', z', w' and the residual
  float r[1] = {0.0f};
  for (int i = threadIdx.x; i < n; i += kStepThreads) {
    const float u = row.u[i], b = row.b[i];
    const float yb = Yb[off + i];
    float xn;
    if (MODE == 0) {
      xn = clip(__fsub_rn(u, __fmul_rn(m0, yb)), b);
    } else {
      xn = __fadd_rn(clip(__fsub_rn(u, m0), yb > 0.0f ? b : 0.0f),
                     clip(__fsub_rn(u, m1), yb < 0.0f ? b : 0.0f));
    }
    const float zn = __fadd_rn(xn, __fmul_rn(coef, __fsub_rn(xn, X[off + i])));
    r[0] = max_nan(r[0], fabsf(__fsub_rn(xn, Z[off + i])));
    Xo[off + i] = xn;                      // streamed: u[i] read above
    Zo[off + i] = zn;
    Wo[off + i] = __fmul_rn(zn, yb);
  }
  block_reduce<1, true>(r, red, parity);
  if (threadIdx.x == 0) resid[blockIdx.x] = __fdiv_rn(r[0], step);
}

// The staged plan takes more than the default 48 KB of dynamic shared
// memory; the limit is raised once a device, not on every launch.
template <int MODE>
int allow_staged_smem() {
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < kMaxDevices && raised[dev]) return 0;
  rc = static_cast<int>(cudaFuncSetAttribute(
      dual_step<MODE, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      9 * kStagedMaxN));
  if (rc == 0 && dev < kMaxDevices) raised[dev] = true;
  return rc;
}

template <int MODE, bool kStaged>
int launch_step(const float* V, const float* Z, const float* X,
                const float* Yb, const float* Bd, const float* step,
                float coef, const float* target, float* Xo, float* Zo,
                float* Wo, float* resid, int M, int n, cudaStream_t s) {
  size_t smem = 0;
  if (kStaged) {
    smem = 9 * static_cast<size_t>(n);
    const int rc = allow_staged_smem<MODE>();
    if (rc != 0) return rc;
  }
  dual_step<MODE, kStaged><<<M, kStepThreads, smem, s>>>(
      V, Z, X, Yb, Bd, step, coef, target, Xo, Zo, Wo, resid, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// S1: G (n1, n2) = X1 X2^T in, the kernel matrix out, in place.  sq1 (n1)
// and sq2 (n2) are scratch for the rbf row norms; `same` says X2 is X1
// (then the norms are G's diagonal, sq2 is not written and sq1 serves
// both sides).  kind: 1 rbf, 2 poly, 3 sigmoid (linear needs no launch).
// Returns the first nonzero cudaGetLastError() of its launches (0 =
// launched).
int svm_gram_epilogue(float* G, const float* X1, const float* X2,
                      float* sq1, float* sq2, int n1, int n2, int d,
                      int same, int kind, float gamma, float degree,
                      float coef0, void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (same && n1 != n2) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kRbf) {
    if (same) {
      copy_diagonal<<<(n1 + 255) / 256, 256, 0, s>>>(G, sq1, n1);
    } else {
      row_sq_norms<<<(n1 + kNormWarps - 1) / kNormWarps, kNormWarps * 32, 0,
                     s>>>(X1, sq1, n1, d);
      row_sq_norms<<<(n2 + kNormWarps - 1) / kNormWarps, kNormWarps * 32, 0,
                     s>>>(X2, sq2, n2, d);
    }
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const float* s2 = same ? sq1 : sq2;
  const dim3 grid((n2 + kEpiThreads * kEpiPerThread - 1) /
                      (kEpiThreads * kEpiPerThread),
                  n1 < kMaxGridY ? n1 : kMaxGridY);
  switch (kind) {
    case kRbf:
      gram_epilogue<kRbf><<<grid, kEpiThreads, 0, s>>>(G, sq1, s2, n1, n2,
                                                       gamma, degree, coef0);
      break;
    case kPoly:
      gram_epilogue<kPoly><<<grid, kEpiThreads, 0, s>>>(G, sq1, s2, n1, n2,
                                                        gamma, degree, coef0);
      break;
    case kSigmoid:
      gram_epilogue<kSigmoid><<<grid, kEpiThreads, 0, s>>>(
          G, sq1, s2, n1, n2, gamma, degree, coef0);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// S2: one projected Nesterov step over M rows of n.  V may be null (a
// projection of z only); `target` (M,) is read in mode 1 only; `step` is a
// device scalar.  staged = 1 takes the shared-memory plan (n <=
// kStagedMaxN), 0 the streamed one.  Xo, Zo and Wo must not alias the
// inputs.  Returns cudaGetLastError() of the launch (0 = launched).
int svm_dual_step(const float* V, const float* Z, const float* X,
                  const float* Yb, const float* Bd, const float* step,
                  float coef, const float* target, float* Xo, float* Zo,
                  float* Wo, float* resid, int M, int n, int mode,
                  int staged, void* stream) {
  if (M < 1 || n < 1 || (staged && n > kStagedMaxN) ||
      (mode == 1 && target == nullptr) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return staged ? launch_step<0, true>(V, Z, X, Yb, Bd, step, coef, target,
                                         Xo, Zo, Wo, resid, M, n, s)
                  : launch_step<0, false>(V, Z, X, Yb, Bd, step, coef,
                                          target, Xo, Zo, Wo, resid, M, n, s);
  return staged ? launch_step<1, true>(V, Z, X, Yb, Bd, step, coef, target,
                                       Xo, Zo, Wo, resid, M, n, s)
                : launch_step<1, false>(V, Z, X, Yb, Bd, step, coef, target,
                                        Xo, Zo, Wo, resid, M, n, s);
}

}  // extern "C"
