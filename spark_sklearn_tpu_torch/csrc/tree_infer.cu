// Inference over converted tree ensembles (TI1) for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py); the Python
// wrapper lives in spark_sklearn_tpu_torch/ops/tree_infer_kernels.py
// beside its plain PyTorch version.
//
// TI1 tree_ensemble   replaces spark_sklearn_tpu/convert/tree_infer.py:50-76
//     (`ensemble_leaf_values`: max_depth gather + compare steps vmapped
//     over trees, which writes a (T, n, n_out) tensor of leaf values) and
//     the shims' reductions over it (:93-160):
//       leaf(t, i)  = the leaf sample i reaches in tree t: from node 0,
//                     left[t, v] if X[i, feature[t, v]] <= threshold[t, v]
//                     else right[t, v], until left[t, v] < 0 (a leaf) or
//                     max_depth steps
//       mode 0 (forest proba):  out[i, j] = (sum over t, in order, of
//                     v[j] / max(sum_j v[j], 1e-12)) / T,  v = value[t,
//                     leaf(t, i), :]  (sum_j in j order)
//       mode 1 (mean):          out[i] = (sum_t value[t, leaf, 0]) / T
//       mode 2 (boost):         out[i, c] = init[c] + lr * sum over the
//                     trees t with t % K == c of value[t, leaf, 0]
//     X (n, d) float32; feature, left, right (T, N) int32; threshold
//     (T, N) float32; value (T, N, n_out) float32; init (K,) float32.
//     Bound: bytes (dependent gathers).  It reads what one visit touches
//     (an internal node's 16 bytes, a leaf's left and its values) and X's
//     compared features, and writes out once.
//
// Design (a first version: simple and exact).
// - A thread a sample.  It walks the trees in order, each from the root
//   to its leaf with an early exit, and adds the tree's contribution into
//   registers (an array of KMAX floats, the smallest of 1, 8, 16, 32, 64
//   that holds the outputs), so no (T, n, n_out) tensor is ever written.
// - The sums run in tree order with the multiply and add kept apart
//   (__fmul_rn / __fadd_rn, never contracted), the plain version's order,
//   so the two agree to rounding of the leaf values' loads: the same
//   bits where both run on the card.
// - Node arrays are read through the read-only cache; the threads of a
//   warp start at the same root (one broadcast load) and part at the
//   levels below.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    ensemble_kernel(const float* __restrict__ X,
                    const int* __restrict__ feature,
                    const float* __restrict__ threshold,
                    const int* __restrict__ left,
                    const int* __restrict__ right,
                    const float* __restrict__ value,
                    const float* __restrict__ init, float* __restrict__ out,
                    int n, int d, int T, int N, int n_out, int K, int depth,
                    int mode, float lr) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* x = X + static_cast<size_t>(i) * d;
  float acc[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t base = static_cast<size_t>(t) * N;
    int node = 0;
    for (int s = 0; s < depth; ++s) {
      const int l = __ldg(left + base + node);
      if (l < 0) break;
      const int f = __ldg(feature + base + node);
      node = (__ldg(x + f) <= __ldg(threshold + base + node))
                 ? l
                 : __ldg(right + base + node);
    }
    const float* v = value + (base + node) * n_out;
    if (mode == 0) {
      float s = 0.f;
      for (int j = 0; j < n_out; ++j) s = __fadd_rn(s, __ldg(v + j));
      const float den = fmaxf(s, 1e-12f);
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < n_out) acc[j] = __fadd_rn(acc[j], __fdiv_rn(__ldg(v + j), den));
    } else {
      const float v0 = __ldg(v);
      const int c = mode == 2 ? t % K : 0;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j == c) acc[j] = __fadd_rn(acc[j], v0);
    }
  }
  const float Tf = static_cast<float>(T);
  if (mode == 0) {
    float* o = out + static_cast<size_t>(i) * n_out;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < n_out) o[j] = __fdiv_rn(acc[j], Tf);
  } else if (mode == 1) {
    out[i] = __fdiv_rn(acc[0], Tf);
  } else {
    float* o = out + static_cast<size_t>(i) * K;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) o[j] = __fadd_rn(__ldg(init + j), __fmul_rn(lr, acc[j]));
  }
}

template <int KMAX>
void launch(int blocks, cudaStream_t s, const float* X, const int* feature,
            const float* threshold, const int* left, const int* right,
            const float* value, const float* init, float* out, int n,
            int d, int T, int N, int n_out, int K, int depth, int mode,
            float lr) {
  ensemble_kernel<KMAX><<<blocks, kThreads, 0, s>>>(
      X, feature, threshold, left, right, value, init, out, n, d, T, N,
      n_out, K, depth, mode, lr);
}

}  // namespace

extern "C" {

// One launch.  `width` is the outputs a sample (n_out for mode 0, 1 for
// mode 1, K for mode 2), at most 64.  Returns the first nonzero cudaError
// (0 = launched).
int tree_ensemble(const float* X, const int* feature, const float* threshold,
                  const int* left, const int* right, const float* value,
                  const float* init, float* out, int n, int d, int T, int N,
                  int n_out, int K, int depth, int mode, float lr,
                  void* stream) {
  const int width = mode == 0 ? n_out : (mode == 1 ? 1 : K);
  if (n < 1 || d < 1 || T < 1 || N < 1 || n_out < 1 || K < 1 ||
      depth < 0 || mode < 0 || mode > 2 || width > 64 ||
      (mode == 2 && T % K != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
#define TI1_ARGS                                                         \
  blocks, s, X, feature, threshold, left, right, value, init, out, n, d, \
      T, N, n_out, K, depth, mode, lr
  if (width <= 1)
    launch<1>(TI1_ARGS);
  else if (width <= 8)
    launch<8>(TI1_ARGS);
  else if (width <= 16)
    launch<16>(TI1_ARGS);
  else if (width <= 32)
    launch<32>(TI1_ARGS);
  else
    launch<64>(TI1_ARGS);
#undef TI1_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
