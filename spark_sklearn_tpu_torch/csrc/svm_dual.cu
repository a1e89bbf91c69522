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
//     matrix of a fit), from the product's own diagonal, read before the
//     epilogue rewrites it, so d2_ii = G_ii - 2 G_ii + G_ii is exactly 0
//     and the diagonal exactly 1, whatever order the norms would be
//     summed in; of X1 X2^T (a prediction), a warp a row, the lane-strided
//     fmaf sum and a fixed-order shuffle-down.  Bound: bytes.  It reads G
//     once and writes K once: at n = 10000, 800 MB, ~0.24 ms at an H100
//     SXM's 3.35 TB/s (data sheet, 700 W); one expf a value is ~2% of that
//     on the FMA pipe and SFUs.  Full-precision expf/tanhf/powf, no
//     intrinsics: K feeds every ascent product of the solve, so its error
//     compounds.  The products and sums round like the plain version's
//     separate operations (__f*_rn, no contraction into FMA).
//
// Design of S1: one launch a call, in every variant (the norms used to
// take one or two launches of their own before the epilogue's).
// - An epilogue tile is the earlier design's block: a row's chunk of
//   kEpiCols columns, a float4 a thread where n2 % 4 == 0 and G is
//   16-byte aligned, else 4 floats kEpiThreads apart.
// - rbf: one cooperative launch, phase 1 the norms, a grid sync, phase 2
//   the tiles walked by a persistent grid of kEpiBlocksPerSm blocks an
//   SM, each block's next tile loaded before its current one is
//   computed.  On the H100 a persistent grid streams G slower than a
//   block a tile scheduled by the card (grid-stride, 2D, contiguous and
//   counter-queue walks all measured so; PERF.md), and a counter
//   that orders a block-a-tile launch's norms before its epilogue costs
//   more again: the norms' own launch was the cheaper part.
// - poly and sigmoid need no norms: a block a tile.
// - Every element's arithmetic is kernel_value, as before: K keeps its
//   bits in every variant.

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
//     steps over the elements that can move are ~0.001-0.005 ms at 67
//     TFLOP/s.  In torch ops the same step is ~330 launches.  What bounds
//     it is latency: each bisection step ends in a block-wide sum.
//
// Design of S2.
// - One block of 512 threads a row (M = 225 rows: one wave at two blocks
//   an SM on 132 SMs).  Thread t owns elements t, t + 512, ... (fewer
//   threads for short rows would add the sums in another order).
// - Pass 1 computes u, the bracket's maxima and the thread's list of the
//   elements that can add to a bisection sum: bound and yb nonzero (MODE
//   1: a half with a bound), or a non-finite u, bound or yb.  Any other
//   element adds exactly +-0 at every finite midpoint, and a sum that
//   starts at +0 is never -0, so leaving it out keeps every partial sum's
//   bits (phase 8's rows keep ~16% of their elements).  The lists keep
//   each thread's own order, slot q at 512 q + t (a warp's loads hit 32
//   banks): u, bound and the sign of yb in shared memory (9 bytes a slot;
//   "staged", up to kStagedMaxN elements), or in the rows of x', z', w'
//   ("streamed", above), which a thread rewrites only at its own elements.
//   A bracket wider than FLT_MAX / 2 (a midpoint could overflow, and 0 x
//   inf is NaN) puts every element in the lists.  Its loads are issued
//   kUnroll elements at a time, as are the last pass's.
// - The 40 steps run 2 a pass: a pass sums at the 3 midpoints those
//   steps can visit, each 0.5 (lo + hi) of the bracket the sequential
//   steps would hold there, then makes the sequential choices, so lo and
//   hi are the one-step-a-pass bisection's bit for bit (3 steps a pass,
//   7 midpoints, measured slower but on the shortest lists).  In a tame row
//   (every u and bound finite, bounds >= 0, the bracket within FLT_MAX /
//   2) x is never NaN and the clip is min(max(x, 0), b), two
//   instructions; any other row runs one step a pass with clip's NaN
//   rule.
// - Each pass ends in block-wide sums: every warp adds its lanes' values
//   by the shuffle-down tree's pairs, several values at once (a lane keeps
//   half its values and trades the other half with its partner: P - 1 +
//   5 - log2 P shuffles for P values, not 5 P), then warp 0 adds the
//   warps' results by the same tree.  That is the earlier design's order, so
//   the kernel gives its bits; no atomics, so two launches give the same
//   bits.  Every thread then holds the same lo/hi and takes
//   the same branch.
// - The last pass recomputes u from z, V and yb (the lists hold only the
//   kept elements) and writes x', z', w' for every element.
// - Maxima propagate NaN as jnp.max and torch.amax do, and the clip is
//   written as min(max(x, 0), b) with NaN passing through, as jnp.clip.
//
// S2's SVR mode  svm_svr_step   replaces a step of `_box_fista` on the
//     epsilon-SVR and nu-SVR duals (spark_sklearn_tpu/models/svr.py:48-80,
//     :117-170) over rows of the pairs (a, a*), 2n elements with signs
//     (+1^n, -1^n).  Its own parts are the gradient (the linear term s y -
//     eps, or s y, formed from y (n) and eps (M)), the two lists of a
//     pair's halves (the sign by list) and the last pass (both halves,
//     and beta' = z'_a - z'_a* (M, n) for the next product).  The
//     brackets, the 40 steps with their comparison and final midpoint,
//     and the clip rules are S2's.
//     Bound: bytes.  It reads V, bound (M, n), z, x (M, 2n) and writes x',
//     z' (M, 2n), beta' (M, n): at M = 5, n = 20640, 4.5 MB, ~0.0014 ms
//     at 3.35 TB/s.  What bounds it is latency: 40 bisection steps, each
//     ending in a sum over the row.
//
// Design of S2's SVR mode.
// - A thread-block cluster of C CTAs a row (C <= 16, from n and from how
//   many clusters of C the card holds at once: `svr_step_plan`; a
//   search's 5 fold rows of 20640 pairs take 80 SMs, not 5).  CTA c owns
//   a contiguous share of ceil(n / C) pairs and keeps its two lists (u
//   and the bound, 16 bytes a pair slot) in its own shared memory, so the
//   bisection passes read no global memory; the first and last passes
//   spread over the C CTAs.  K steps a pass (`svr_levels`, as
//   `bisect_levels`: lo and hi are the sequential bisection's bit for
//   bit; K a constant a mode, kSvrLevelsSvr and kSvrLevelsNu), and each
//   pass ends in one cluster reduction (`cluster_reduce`): a block
//   reduction to the CTA's totals, which it stores into every CTA's
//   shared memory (remote stores counted on the receiver's mbarrier: no
//   cluster barrier a pass), then every CTA adds the C totals in rank
//   order, so every CTA holds the same totals and takes the same branch,
//   and two launches give the same bits.  The brackets' maxima and the
//   residual are cluster maxima.
// - A tame nu-SVR row sums each list into its own half only (the other
//   half's clip to [0, 0] adds +-0).  The sums run in another order than
//   the plain version's.
// - Rows of more than 16 kSvrShareMax = 225280 pairs are refused: the
//   product beta K before the step would read an (n, n) K of 203 GB.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEpiThreads = 256;
constexpr int kEpiCols = 4 * kEpiThreads;  // S1: columns of a tile
constexpr int kEpiBlocksPerSm = 8;         // S1: rbf's co-resident blocks
constexpr int kStepThreads = 512;          // S2: threads a row
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kBisect = 40;                // svm.py:132 n_bisect
constexpr int kStagedMaxN = 20480;         // 9 bytes an element: 180 KB
constexpr int kMaxNV = 6;                  // most values one reduction adds
constexpr int kUnroll = 4;                 // S2: elements a thread loads
                                           // before it uses them
constexpr float kHalfMax = FLT_MAX / 2;    // S2: widest bracket skipped
constexpr int kMaxSmem = 232448;           // 227 KB, an H100 block's most
constexpr int kMaxDevices = 64;            // devices of one process

enum Kind { kLinear = 0, kRbf = 1, kPoly = 2, kSigmoid = 3 };

// ---------------------------------------------------------------------------
// S1
// ---------------------------------------------------------------------------

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

// An epilogue tile's loads: row t / chunks, chunk t % chunks of
// kEpiCols columns (the earlier design's blocks, in its order); a thread
// takes a float4 (kVec) or 4 floats kEpiThreads apart.
template <bool kVec>
__device__ __forceinline__ void tile_load(const float* G, int n2, int chunks,
                                          long long t, float (&v)[4],
                                          int& row, int& j0) {
  row = static_cast<int>(t / chunks);
  const int c = static_cast<int>(t - static_cast<long long>(row) * chunks);
  const float* g = G + static_cast<size_t>(row) * n2;
  if constexpr (kVec) {
    j0 = c * kEpiCols + 4 * threadIdx.x;
    if (j0 < n2) {                      // n2 % 4 == 0: all four or none
      const float4 x = *reinterpret_cast<const float4*>(g + j0);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    }
  } else {
    j0 = c * kEpiCols + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q * kEpiThreads;
      v[q] = j < n2 ? g[j] : 0.0f;
    }
  }
}

// The tile's values through kernel_value, stored where they were loaded.
template <int KIND, bool kVec>
__device__ __forceinline__ void tile_store(float* G, const float* sq1,
                                           const float* sq2, int n2, int row,
                                           int j0, const float (&v)[4],
                                           float gamma, float degree,
                                           float coef0) {
  float* g = G + static_cast<size_t>(row) * n2;
  const float s1 = KIND == kRbf ? sq1[row] : 0.0f;
  if constexpr (kVec) {
    if (j0 >= n2) return;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (KIND == kRbf) s = *reinterpret_cast<const float4*>(sq2 + j0);
    *reinterpret_cast<float4*>(g + j0) = make_float4(
        kernel_value<KIND>(v[0], s1, s.x, gamma, degree, coef0),
        kernel_value<KIND>(v[1], s1, s.y, gamma, degree, coef0),
        kernel_value<KIND>(v[2], s1, s.z, gamma, degree, coef0),
        kernel_value<KIND>(v[3], s1, s.w, gamma, degree, coef0));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q * kEpiThreads;
      if (j < n2)
        g[j] = kernel_value<KIND>(v[q], s1, KIND == kRbf ? sq2[j] : 0.0f,
                                  gamma, degree, coef0);
    }
  }
}

// S1 rbf, one cooperative launch of at most kEpiBlocksPerSm blocks an SM:
// phase 1 the norms (X X^T: G's diagonal; X1 X2^T: a warp a row of X1
// then X2, the lane-strided fmaf sum and the shuffle-down tree of the
// earlier row-norms kernel), a grid sync, phase 2 the epilogue tiles,
// block b taking tiles b, b + gridDim.x, ..., the next tile's loads
// issued before the current tile is computed.  sq1 and sq2 are written
// and read in one launch: no __restrict__, no read-only cache path.
template <bool kVec>
__global__ void __launch_bounds__(kEpiThreads, kEpiBlocksPerSm)
gram_rbf(float* G, const float* __restrict__ X1, const float* __restrict__ X2,
         float* sq1, float* sq2, int n1, int n2, int d, int same, int chunks,
         float gamma) {
  const int threads = static_cast<int>(gridDim.x) * kEpiThreads;
  const int gt = static_cast<int>(blockIdx.x) * kEpiThreads + threadIdx.x;
  if (same) {
    for (int i = gt; i < n1; i += threads)
      sq1[i] = G[static_cast<size_t>(i) * n2 + i];
  } else {
    const int lane = threadIdx.x & 31;
    for (int row = gt >> 5; row < n1 + n2; row += threads >> 5) {
      const float* x = row < n1 ? X1 + static_cast<size_t>(row) * d
                                : X2 + static_cast<size_t>(row - n1) * d;
      float s = 0.0f;
      for (int j = lane; j < d; j += 32) s = fmaf(x[j], x[j], s);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
      if (lane == 0) (row < n1 ? sq1[row] : sq2[row - n1]) = s;
    }
  }
  cg::this_grid().sync();
  const float* s2 = same ? sq1 : sq2;
  const long long tiles = static_cast<long long>(n1) * chunks;
  long long t = blockIdx.x;
  float cur[4];
  int row = 0, j0 = 0;
  if (t < tiles) tile_load<kVec>(G, n2, chunks, t, cur, row, j0);
  for (; t < tiles; t += gridDim.x) {
    float nxt[4];
    int nrow = 0, nj0 = 0;
    if (t + gridDim.x < tiles)
      tile_load<kVec>(G, n2, chunks, t + gridDim.x, nxt, nrow, nj0);
    tile_store<kRbf, kVec>(G, sq1, s2, n2, row, j0, cur, gamma, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
    row = nrow;
    j0 = nj0;
  }
}

// S1 poly and sigmoid: no norms, so a block a tile over as many blocks as
// tiles, scheduled by the card.
template <int KIND, bool kVec>
__global__ void __launch_bounds__(kEpiThreads)
gram_elementwise(float* __restrict__ G, int n2, int chunks, float gamma,
                 float degree, float coef0) {
  float v[4];
  int row = 0, j0 = 0;
  tile_load<kVec>(G, n2, chunks, blockIdx.x, v, row, j0);
  tile_store<KIND, kVec>(G, nullptr, nullptr, n2, row, j0, v, gamma, degree,
                         coef0);
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

// Block-wide maxima of NV values a thread (NaN propagates), in a fixed
// order, for every thread: each warp's shuffle-down tree, then warp 0's
// tree over the warps' results (the earlier design's order).  `buf` holds two
// alternating slots of (kStepWarps + 1) * kMaxNV floats, the warps' results
// and the totals; consecutive calls take turns (`parity`), so a slot is
// never rewritten while a slow thread may still read its totals.
template <int NV>
__device__ __forceinline__ void block_max(float (&v)[NV], float* buf,
                                          int& parity) {
  constexpr int NW = kStepWarps;
  static_assert(NV <= kMaxNV, "reduction too wide");
  float* part = buf + parity * (kStepWarps + 1) * kMaxNV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = max_nan(x, __shfl_down_sync(kFull, x, o));
    if (lane == 0) part[q * NW + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float x = lane < NW ? part[q * NW + lane] : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = max_nan(x, __shfl_down_sync(kFull, x, o));
      if (lane == 0) part[kStepWarps * kMaxNV + q] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = part[kStepWarps * kMaxNV + q];
  parity ^= 1;
}

// NV sums a lane over one warp, added in the pairs of the shuffle-down
// tree (lanes l and l + o for o = 16, 8, ..., 1), NV at once: while a lane
// holds more than one value it keeps half of them and trades the other
// half with its partner l ^ o, so both add the same pair (float addition
// is commutative) and a warp takes P - 1 + 5 - log2 P shuffles, not 5 NV
// (P: NV rounded up to a power of two).  Value q ends in lanes l with
// l / (32 / P) == q; each lane returns the value it holds.
template <int NV>
__device__ __forceinline__ float warp_sums(const float (&v)[NV], int lane) {
  constexpr int P = NV <= 1 ? 1 : NV <= 2 ? 2 : NV <= 4 ? 4 : NV <= 8 ? 8
                                                                       : 16;
  static_assert(NV <= 16, "too many sums for one warp");
  float w[P];
#pragma unroll
  for (int q = 0; q < P; ++q) w[q] = q < NV ? v[q] : 0.0f;
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int o = 16 >> st;
    const int c = P >> (st + 1);           // values a lane keeps
    if (c >= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < c; ++i) {
        const float send = upper ? w[i] : w[c + i];
        const float keep = upper ? w[c + i] : w[i];
        w[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    } else {
      w[0] = w[0] + __shfl_xor_sync(kFull, w[0], o);
    }
  }
  return w[0];
}

// Block-wide sums of NV values a thread, for every thread: each warp's
// `warp_sums`, then warp 0's over the warps' results (lanes past the last
// warp add 0), which is the earlier design's tree of shuffle-down sums.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* buf,
                                          int& parity) {
  constexpr int NW = kStepWarps;
  constexpr int G = 32 / (NV <= 1 ? 1 : NV <= 2 ? 2 : NV <= 4 ? 4
                          : NV <= 8 ? 8 : 16);   // lanes a value
  static_assert(NV <= kMaxNV, "reduction too wide");
  float* part = buf + parity * (kStepWarps + 1) * kMaxNV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane / G;
  const float w = warp_sums<NV>(v, lane);
  if (lane % G == 0 && q < NV) part[q * NW + warp] = w;
  __syncthreads();
  if (warp == 0) {
    float x[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) x[i] = lane < NW ? part[i * NW + lane] : 0.0f;
    const float t = warp_sums<NV>(x, lane);
    if (lane % G == 0 && q < NV) part[kStepWarps * kMaxNV + q] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = part[kStepWarps * kMaxNV + i];
  parity ^= 1;
}

// clip(x, b) as the bisection sums it.  In a tame row (every u and bound
// finite, bounds >= 0, a bracket within FLT_MAX / 2) x is never NaN, and
// min(max(x, 0), b) differs from clip only in the sign of a zero result,
// which adds nothing to a sum that is never -0 (it starts at +0): two
// instructions, not four.
template <bool kTame>
__device__ __forceinline__ float clamp(float x, float b) {
  return kTame ? fminf(fmaxf(x, 0.0f), b) : clip(x, b);
}

// u = z - step * grad, the Nesterov point's gradient step from the
// product's value v (z alone when there is no product): pass 1 and the
// last pass compute it alike.
template <int MODE>
__device__ __forceinline__ float grad_step(bool has_v, float v, float z,
                                           float yb, float step) {
  if (!has_v) return z;
  const float yv = __fmul_rn(yb, v);
  const float grad = MODE == 0 ? -__fsub_rn(1.0f, yv) : yv;
  return __fsub_rn(z, __fmul_rn(step, grad));
}

// A row's elements i = threadIdx.x + k kStepThreads of one thread,
// kUnroll at a
// time: every load of a batch is issued before the first is used (pass 1
// and the last pass are a chain of loads a thread otherwise), then
// fn(i, z, yb, b, v, x) runs on them in the thread's own order (v 0
// without V, x 0 without X).
template <typename Fn>
__device__ __forceinline__ void row_batches(const float* __restrict__ V,
                                            const float* __restrict__ Z,
                                            const float* __restrict__ Yb,
                                            const float* __restrict__ Bd,
                                            const float* __restrict__ X,
                                            size_t off, int n, Fn fn) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * kStepThreads) {
    float z[kUnroll], yb[kUnroll], b[kUnroll], v[kUnroll], x[kUnroll];
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      const int i = i0 + e * kStepThreads;
      const bool in = i < n;
      z[e] = in ? Z[off + i] : 0.0f;
      yb[e] = in ? Yb[off + i] : 0.0f;
      b[e] = in ? Bd[off + i] : 0.0f;
      v[e] = in && V != nullptr ? V[off + i] : 0.0f;
      x[e] = in && X != nullptr ? X[off + i] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      const int i = i0 + e * kStepThreads;
      if (i < n) fn(i, z[e], yb[e], b[e], v[e], x[e]);
    }
  }
}

// S2's dynamic shared memory (the staged plan's lists)
extern __shared__ float s2_smem[];

// A thread's list of the elements the bisection sums, in its own order:
// slot q at q kStepThreads + threadIdx.x (a warp's loads hit 32 banks).
// Staged:
// u, bound and the sign of yb in shared memory, indexed from the shared
// array itself (so the loads stay shared-memory loads); streamed: in the
// rows of x', z' and w', which the last pass overwrites (a thread writes
// only the elements i = threadIdx.x (mod kStepThreads), the slots it
// owns).
template <bool kStaged>
struct KeptList {
  int cap;                                 // slots * kStepThreads
  float* gu;
  float* gb;
  float* gy;
  __device__ __forceinline__ float u(int k) const {
    return kStaged ? s2_smem[k] : gu[k];
  }
  __device__ __forceinline__ float b(int k) const {
    return kStaged ? s2_smem[cap + k] : gb[k];
  }
  __device__ __forceinline__ float yb(int k) const {
    if (kStaged)
      return static_cast<float>(
          reinterpret_cast<const signed char*>(s2_smem + 2 * cap)[k]);
    return gy[k];
  }
  __device__ __forceinline__ void put(int k, float uk, float bk,
                                      float yk) const {
    if (kStaged) {
      s2_smem[k] = uk;
      s2_smem[cap + k] = bk;
      reinterpret_cast<signed char*>(s2_smem + 2 * cap)[k] =
          static_cast<signed char>((yk > 0.0f) - (yk < 0.0f));
    } else {
      gu[k] = uk;
      gb[k] = bk;
      gy[k] = yk;
    }
  }
  // fn(u, b, yb) over the thread's first `cnt` slots, in slot order
  template <typename Fn>
  __device__ __forceinline__ void each(int cnt, Fn fn) const {
    for (int q = 0; q < cnt; ++q) {
      const int k = q * kStepThreads + threadIdx.x;
      fn(u(k), b(k), yb(k));
    }
  }
};

// K steps of the bisection in one pass: the sums at the 2^K - 1 midpoints
// those steps can visit (a heap: node j's children 2j and 2j + 1, each
// midpoint 0.5 (lo + hi) of the bracket the sequential steps would hold
// there), one reduction, then the K sequential choices.  So the choices,
// and lo and hi after them, are the sequential bisection's bit for bit.
// MODE 0: sum of yb clip(u - mid yb, b) > 0 takes the upper half; MODE 1:
// per half h, sum of clip(u - mid_h, b_h) > target.  `List` is KeptList:
// its each(cnt, fn) calls fn(u, b, yb) on the thread's kept elements in
// its own order.
template <int MODE, int K, bool kTame, typename List, typename Count>
__device__ __forceinline__ void bisect_levels(const List& kept, Count cnt,
                                              float (&lo)[2],
                                              float (&hi)[2], float tgt,
                                              float* red, int& parity) {
  constexpr int P = (1 << K) - 1;          // midpoints a bisection
  constexpr int H = MODE == 0 ? 1 : 2;     // bisections
  float mid[H][P + 1], from[H][P + 1], to[H][P + 1];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    from[h][1] = lo[h];
    to[h][1] = hi[h];
#pragma unroll
    for (int j = 1; j <= P; ++j) {
      mid[h][j] = 0.5f * (from[h][j] + to[h][j]);
      if (2 * j <= P) {
        from[h][2 * j] = from[h][j];
        to[h][2 * j] = mid[h][j];
        from[h][2 * j + 1] = mid[h][j];
        to[h][2 * j + 1] = to[h][j];
      }
    }
  }
  float g[H * P];
#pragma unroll
  for (int q = 0; q < H * P; ++q) g[q] = 0.0f;
  kept.each(cnt, [&](float u, float b, float yb) {
    if (MODE == 0) {
#pragma unroll
      for (int j = 1; j <= P; ++j) {
        const float a = clamp<kTame>(__fsub_rn(u, __fmul_rn(mid[0][j], yb)),
                                     b);
        g[j - 1] += yb * a;
      }
    } else {
      const float bp = yb > 0.0f ? b : 0.0f, bm = yb < 0.0f ? b : 0.0f;
#pragma unroll
      for (int j = 1; j <= P; ++j) {
        g[j - 1] += clamp<kTame>(__fsub_rn(u, mid[0][j]), bp);
        g[P + j - 1] += clamp<kTame>(__fsub_rn(u, mid[1][j]), bm);
      }
    }
  });
  block_sum<H * P>(g, red, parity);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    int j = 1;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      float gj = 0.0f, mj = 0.0f;
#pragma unroll
      for (int c = 1; c <= P; ++c) {
        if (c == j) {
          gj = g[h * P + c - 1];
          mj = mid[h][c];
        }
      }
      const bool take_hi = MODE == 0 ? gj > 0.0f : gj > tgt;
      lo[h] = take_hi ? mj : lo[h];
      hi[h] = take_hi ? hi[h] : mj;
      j = 2 * j + (take_hi ? 1 : 0);
    }
  }
}

// MODE 0: box + hyperplane sum(yb a) = 0 (SVC); MODE 1: the two half
// box-sums sum_{yb>0} a = sum_{yb<0} a = target[row] (NuSVC).
// kStepThreads threads a row.
template <int MODE, bool kStaged>
__global__ void __launch_bounds__(kStepThreads, 2)
dual_step(const float* __restrict__ V, const float* __restrict__ Z,
          const float* __restrict__ X, const float* __restrict__ Yb,
          const float* __restrict__ Bd, const float* __restrict__ step_ptr,
          float coef, const float* __restrict__ target, float* Xo, float* Zo,
          float* Wo, float* __restrict__ resid, int n) {
  __shared__ float red[2 * (kStepWarps + 1) * kMaxNV];
  int parity = 0;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const float step = *step_ptr;
  const int slots = (n + kStepThreads - 1) / kStepThreads;
  const KeptList<kStaged> kept = {slots * kStepThreads, Xo + off, Zo + off,
                                  Wo + off};

  // pass 1: the gradient step, the bracket's maxima, and the thread's list
  // of the elements that can add to a bisection sum.  One whose bound or
  // yb is 0 adds exactly +-0 at every finite midpoint (MODE 1: it has no
  // half with a bound), so leaving it out keeps every partial sum's bits;
  // one with a non-finite u, bound or yb is always kept (NaN propagates).
  float mx[3] = {0.0f, 0.0f, 0.0f};         // max|u|, max b (+half), -half
  float neg_b = -INFINITY;                  // max of -b
  int cnt = 0;
  const bool has_v = V != nullptr;
  row_batches(V, Z, Yb, Bd, nullptr, off, n,
                  [&](int, float z, float yb, float b, float v, float) {
    const float u = grad_step<MODE>(has_v, v, z, yb, step);
    mx[0] = max_nan(mx[0], fabsf(u));
    if (MODE == 0) {
      mx[1] = max_nan(mx[1], b);
    } else {
      mx[1] = max_nan(mx[1], yb > 0.0f ? b : 0.0f);
      mx[2] = max_nan(mx[2], yb < 0.0f ? b : 0.0f);
    }
    neg_b = max_nan(neg_b, -b);
    const bool moves = b != 0.0f && (yb > 0.0f || yb < 0.0f);
    if (moves || !(isfinite(u) && isfinite(b) && isfinite(yb))) {
      kept.put(cnt * kStepThreads + tid, u, b, yb);
      ++cnt;
    }
  });
  // with the least bound (as -max -b)
  float m[4] = {mx[0], mx[1], mx[2], neg_b};
  if (MODE == 0) {
    float m0[3] = {m[0], m[1], m[3]};
    block_max<3>(m0, red, parity);
    m[0] = m0[0];
    m[1] = m0[1];
    m[3] = m0[2];
  } else {
    block_max<4>(m, red, parity);
  }
  mx[0] = m[0];
  mx[1] = m[1];
  mx[2] = m[2];

  // the brackets: nu (MODE 0) or the two half multipliers (MODE 1)
  float lo[2], hi[2], tgt = 0.0f;
  if (MODE == 0) {
    lo[0] = -__fadd_rn(mx[0], mx[1]);
    hi[0] = -lo[0];
    lo[1] = hi[1] = 0.0f;
  } else {
    tgt = target[blockIdx.x];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float zmax = __fadd_rn(__fadd_rn(mx[0], mx[1 + h]), 1.0f);
      lo[h] = -zmax;
      hi[h] = zmax;
    }
  }
  // A bracket wider than FLT_MAX / 2 (or NaN) may give an infinite or NaN
  // midpoint, where 0 * mid is NaN: then every element is summed.
  const bool wide = !(hi[0] <= kHalfMax && hi[1] <= kHalfMax);
  const bool tame = !wide && m[3] <= 0.0f;
  if (wide) {
    cnt = 0;
    row_batches(V, Z, Yb, Bd, nullptr, off, n,
                    [&](int, float z, float yb, float b, float v, float) {
      kept.put(cnt * kStepThreads + tid,
               grad_step<MODE>(has_v, v, z, yb, step), b, yb);
      ++cnt;
    });
  }

  // the 40 steps, 2 a pass: a pass's barriers and reductions are most of
  // its cost (3 a pass measured slower but on the shortest lists).  A row
  // that is not tame takes them one at a time, with clip's NaN rule.
  int left = kBisect;
  if (tame) {
    for (; left >= 2; left -= 2)
      bisect_levels<MODE, 2, true>(kept, cnt, lo, hi, tgt, red, parity);
  }
  for (; left > 0; --left)
    bisect_levels<MODE, 1, false>(kept, cnt, lo, hi, tgt, red, parity);
  const float m0 = 0.5f * (lo[0] + hi[0]);
  const float m1 = MODE == 0 ? 0.0f : 0.5f * (lo[1] + hi[1]);

  // last pass, every element: x', z', w' and the residual
  float r[1] = {0.0f};
  row_batches(V, Z, Yb, Bd, X, off, n,
                  [&](int i, float z, float yb, float b, float v, float x) {
    const float u = grad_step<MODE>(has_v, v, z, yb, step);
    float xn;
    if (MODE == 0) {
      xn = clip(__fsub_rn(u, __fmul_rn(m0, yb)), b);
    } else {
      xn = __fadd_rn(clip(__fsub_rn(u, m0), yb > 0.0f ? b : 0.0f),
                     clip(__fsub_rn(u, m1), yb < 0.0f ? b : 0.0f));
    }
    const float zn = __fadd_rn(xn, __fmul_rn(coef, __fsub_rn(xn, x)));
    r[0] = max_nan(r[0], fabsf(__fsub_rn(xn, z)));
    Xo[off + i] = xn;
    Zo[off + i] = zn;
    Wo[off + i] = __fmul_rn(zn, yb);
  });
  block_max<1>(r, red, parity);
  if (tid == 0) {
    resid[blockIdx.x] = __fdiv_rn(r[0], step);
  }
}

// Raises `kernel`'s dynamic shared-memory limit to the block's most, less
// its static shared memory (the reductions'), once a device.
template <typename Kernel>
int allow_max_smem(Kernel kernel, bool* raised) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0 || (dev < kMaxDevices && raised[dev])) return rc;
  cudaFuncAttributes fa;
  rc = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem - static_cast<int>(fa.sharedSizeBytes)));
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
    // 9 bytes a slot: u, bound, the sign of yb
    smem = 9 * static_cast<size_t>((n + kStepThreads - 1) / kStepThreads) *
           kStepThreads;
    static bool raised[kMaxDevices] = {};
    const int rc = allow_max_smem(dual_step<MODE, true>, raised);
    if (rc != 0) return rc;
  }
  dual_step<MODE, kStaged><<<M, kStepThreads, smem, s>>>(
      V, Z, X, Yb, Bd, step, coef, target, Xo, Zo, Wo, resid, n);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// S2, SVR mode
// ---------------------------------------------------------------------------

// u = z - step * grad of the SVR duals (svr.py:76-80, :149-153):
// grad = -(lin - s v), lin = s y - eps (MODE 0, epsilon-SVR) or s y
// (MODE 1, nu-SVR); z alone when there is no product.
template <int MODE>
__device__ __forceinline__ float svr_grad_step(bool has_v, float v, float z,
                                               float s, float y, float eps,
                                               float step) {
  if (!has_v) return z;
  const float sy = s * y;                  // exact: s is +-1
  const float lin = MODE == 0 ? __fsub_rn(sy, eps) : sy;
  const float grad = -__fsub_rn(lin, s * v);
  return __fsub_rn(z, __fmul_rn(step, grad));
}

// x' of a pair (a, a*) from its gradient steps (ua, us) and the final
// multipliers: MODE 0 the hyperplane's m0 (a - m0, a* + m0), MODE 1 the
// two half box-sums' m0 (the a half) and m1 (the a* half).
template <int MODE>
__device__ __forceinline__ void svr_project(float ua, float us, float b,
                                            float m0, float m1, float& xa,
                                            float& xs) {
  if (MODE == 0) {
    xa = clip(__fsub_rn(ua, m0), b);
    xs = clip(__fadd_rn(us, m0), b);
  } else {
    xa = __fadd_rn(clip(__fsub_rn(ua, m0), b), clip(__fsub_rn(ua, m1), 0.0f));
    xs = __fadd_rn(clip(__fsub_rn(us, m0), 0.0f), clip(__fsub_rn(us, m1), b));
  }
}

// --- a thread-block cluster a row ---
//
// A row's n pairs are cut into C contiguous shares of `share` pairs, one a
// CTA of the row's cluster (C CTAs on C SMs, not one).  Each CTA keeps its
// share's lists in its own shared memory, so the bisection passes read no
// global memory, and every pass's sums end in one cluster reduction
// (`cluster_reduce`): the first and last passes, the brackets' maxima and
// the residual spread over the C CTAs as well.  K bisection steps a pass
// (`svr_levels`, as `bisect_levels`: the sums at the 2^K - 1 midpoints the
// steps can visit, then the sequential choices, so lo and hi are the
// one-step-a-pass bisection's).  Every launch gives the same bits.

constexpr int kSvrThreads = 256;           // threads of a CTA
constexpr int kSvrWarps = kSvrThreads / 32;
constexpr int kSvrMaxCluster = 16;         // CTAs a row (above 8
                                           // non-portable)
constexpr int kSvrLevelsSvr = 3;           // bisection steps a pass,
constexpr int kSvrLevelsNu = 2;            // epsilon-SVR and nu-SVR
constexpr int kSvrMaxNV = 30;              // most values a reduction adds
                                           // (room for 4 steps a pass in
                                           // either mode: nu 2 x 15)
constexpr int kSvrShareMax = 14080;        // pairs of a share: 16 bytes
                                           // each (u and the bound of
                                           // both halves), 220 KB, beside
                                           // the reductions' 4816 bytes

// A CTA's lists of its share's kept elements: thread t's q-th kept a
// element at slot q kSvrThreads + t of list 0, its a* ones in list 1,
// each slot (u, bound).
struct SvrShare {
  float2* list;
  int cap;                                 // slots of a list
  __device__ __forceinline__ void put(int h, int q, float u, float b) const {
    list[h * cap + q * kSvrThreads + threadIdx.x] = make_float2(u, b);
  }
  // fn(u, b) over the thread's first cnt slots of list h, in slot order
  template <typename Fn>
  __device__ __forceinline__ void each(int h, int cnt, Fn fn) const {
    const float2* l = list + h * cap + threadIdx.x;
    for (int q = 0; q < cnt; ++q) {
      const float2 e = l[q * kSvrThreads];
      fn(e.x, e.y);
    }
  }
};

// The pairs i = p0 + threadIdx.x + k kSvrThreads < p1 of a CTA's share,
// kUnroll at a time (every load of a batch issued before the first is
// used): fn(i, b, y, v, za, zs, xa, xs), v 0 without V, xa and xs 0
// without X.
template <typename Fn>
__device__ __forceinline__ void share_batches(
    const float* __restrict__ V, const float* __restrict__ Z,
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ Bh, size_t offn, size_t off2, int n, int p0,
    int p1, Fn fn) {
  for (int i0 = p0 + threadIdx.x; i0 < p1; i0 += kUnroll * kSvrThreads) {
    float b[kUnroll], y[kUnroll], v[kUnroll], za[kUnroll], zs[kUnroll],
        xa[kUnroll], xs[kUnroll];
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      const int i = i0 + e * kSvrThreads;
      const bool in = i < p1;
      b[e] = in ? Bh[offn + i] : 0.0f;
      y[e] = in ? Y[i] : 0.0f;
      v[e] = in && V != nullptr ? V[offn + i] : 0.0f;
      za[e] = in ? Z[off2 + i] : 0.0f;
      zs[e] = in ? Z[off2 + n + i] : 0.0f;
      xa[e] = in && X != nullptr ? X[off2 + i] : 0.0f;
      xs[e] = in && X != nullptr ? X[off2 + n + i] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      const int i = i0 + e * kSvrThreads;
      if (i < p1) fn(i, b[e], y[e], v[e], za[e], zs[e], xa[e], xs[e]);
    }
  }
}

// The cluster's reductions.  `wpart`: the warps' results (value q of warp
// w at q kSvrWarps + w).  `recv`: two alternating slots (a reduction's
// `use` & 1) of kSvrMaxCluster x kSvrMaxNV floats, value q of the CTA of
// rank r at r kSvrMaxNV + q, which every CTA of the cluster writes into
// every CTA's copy; `bar`: the two slots' mbarriers, each completing a
// phase when its C x NV values have landed.
struct ClusterRed {
  float* wpart;
  float* recv;
  uint64_t* bar;
  int C;                                   // CTAs of the cluster
  int rank;                                // this CTA's
  int use;                                 // reductions so far
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address `addr` of this CTA's shared memory has in CTA `rank`'s.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// The phase's one arrival, and the bytes it waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` has completed: its values, written
// by the other CTAs, are visible after it (acquire at cluster scope).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// v into the shared memory of another CTA of the cluster (both addresses
// from `cluster_addr`), its 4 bytes counted on that CTA's mbarrier.
__device__ __forceinline__ void store_remote(uint32_t addr, float v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// A warp's sums of values Q0.. of v into wpart, `warp_sums` 16 at a time.
template <int NV, int Q0>
__device__ __forceinline__ void warp_part(const float (&v)[NV], float* wpart,
                                          int warp, int lane) {
  constexpr int N = NV - Q0 < 16 ? NV - Q0 : 16;
  constexpr int G = 32 / (N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4
                          : N <= 8 ? 8 : 16);   // lanes a value
  float w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = v[Q0 + i];
  const float s = warp_sums<N>(w, lane);
  if (lane % G == 0 && lane / G < N)
    wpart[(Q0 + lane / G) * kSvrWarps + warp] = s;
  if constexpr (Q0 + 16 < NV) warp_part<NV, Q0 + 16>(v, wpart, warp, lane);
}

// Cluster-wide sums (kMax: maxima, NaN propagating) of NV values a
// thread.  Each warp adds its lanes' values (`warp_sums`' pairs; maxima by
// the shuffle-down tree), lane q of warp 0 adds the warps' results for
// value q in warp order and sends the CTA's total to every CTA of the
// cluster (a remote store that counts its bytes on the receiver's
// mbarrier), and each CTA, once its mbarrier has seen all C x NV values,
// adds them for value q in rank order in lane q of every warp.  So every
// CTA holds the same totals, bit for bit, and takes the same branch; no
// atomics, so two launches give the same bits.  Returns value q's total in
// lane q (lanes >= NV: 0).  A slot is written again two reductions later,
// which no CTA starts before every CTA has sent the reduction between,
// and a CTA sends only after a block barrier that follows its reads.
template <int NV, bool kMax>
__device__ __forceinline__ float cluster_reduce(const float (&v)[NV],
                                                ClusterRed& red) {
  static_assert(NV <= kSvrMaxNV, "reduction too wide");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kMax) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float x = v[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = max_nan(x, __shfl_down_sync(kFull, x, o));
      if (lane == 0) red.wpart[q * kSvrWarps + warp] = x;
    }
  } else {
    warp_part<NV, 0>(v, red.wpart, warp, lane);
  }
  __syncthreads();
  const int b = red.use & 1;
  const uint32_t parity = (red.use >> 1) & 1;
  float* slot = red.recv + b * kSvrMaxCluster * kSvrMaxNV;
  if (threadIdx.x == 0)
    mbar_expect(red.bar + b, static_cast<uint32_t>(red.C * NV * 4));
  if (warp == 0 && lane < NV) {
    float s = red.wpart[lane * kSvrWarps];
#pragma unroll
    for (int w = 1; w < kSvrWarps; ++w) {
      const float x = red.wpart[lane * kSvrWarps + w];
      s = kMax ? max_nan(s, x) : s + x;
    }
    const uint32_t to = smem_addr(slot + red.rank * kSvrMaxNV + lane);
    const uint32_t bar = smem_addr(red.bar + b);
    for (int r = 0; r < red.C; ++r)
      store_remote(cluster_addr(to, r), s, cluster_addr(bar, r));
  }
  mbar_wait(red.bar + b, parity);
  float t = 0.0f;
  if (lane < NV) {
    float p[kSvrMaxCluster];
#pragma unroll
    for (int r = 0; r < kSvrMaxCluster; ++r)
      p[r] = r < red.C ? slot[r * kSvrMaxNV + lane] : 0.0f;
    t = p[0];
#pragma unroll
    for (int r = 1; r < kSvrMaxCluster; ++r)
      if (r < red.C) t = kMax ? max_nan(t, p[r]) : t + p[r];
  }
  ++red.use;
  return t;
}

// K bisection steps of the cluster plan in one pass, as `bisect_levels`:
// the sums at the 2^K - 1 midpoints of the brackets the sequential steps
// would hold, one cluster reduction, then the K sequential choices.  List
// 0 holds the a elements (s = +1), list 1 the a* ones (s = -1).  MODE 0:
// sum s clip(u - mid s, b) > 0 takes the upper half (s clip(u - mid s,
// b) is clip(u - mid, b) on list 0 and -clip(u + mid, b) on list 1, the
// same values); MODE 1: per half h, sum clip(u - mid_h, b_h) > target,
// where the a half has its bound on list 0 only and the a* half on list 1
// only.  In a tame row an element adds exactly +-0 to the other half's
// sum (a clip to [0, 0] of a finite value), which a sum that starts at +0
// keeps, so only its own half is summed; otherwise both, with clip's NaN.
template <int MODE, int K, bool kTame>
__device__ __forceinline__ void svr_levels(const SvrShare& kept, int2 cnt,
                                           float (&lo)[2], float (&hi)[2],
                                           float tgt, ClusterRed& red) {
  constexpr int P = (1 << K) - 1;          // midpoints a bisection
  constexpr int H = MODE == 0 ? 1 : 2;     // bisections
  float mid[H][P + 1], from[H][P + 1], to[H][P + 1];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    from[h][1] = lo[h];
    to[h][1] = hi[h];
#pragma unroll
    for (int j = 1; j <= P; ++j) {
      mid[h][j] = 0.5f * (from[h][j] + to[h][j]);
      if (2 * j <= P) {
        from[h][2 * j] = from[h][j];
        to[h][2 * j] = mid[h][j];
        from[h][2 * j + 1] = mid[h][j];
        to[h][2 * j + 1] = to[h][j];
      }
    }
  }
  float g[H * P];
#pragma unroll
  for (int q = 0; q < H * P; ++q) g[q] = 0.0f;
  kept.each(0, cnt.x, [&](float u, float b) {
#pragma unroll
    for (int j = 1; j <= P; ++j) {
      g[j - 1] += clamp<kTame>(__fsub_rn(u, mid[0][j]), b);
      if constexpr (MODE == 1 && !kTame)
        g[P + j - 1] += clamp<kTame>(__fsub_rn(u, mid[H - 1][j]), 0.0f);
    }
  });
  kept.each(1, cnt.y, [&](float u, float b) {
#pragma unroll
    for (int j = 1; j <= P; ++j) {
      if constexpr (MODE == 0) {
        g[j - 1] -= clamp<kTame>(__fadd_rn(u, mid[0][j]), b);
      } else {
        if constexpr (!kTame)
          g[j - 1] += clamp<kTame>(__fsub_rn(u, mid[0][j]), 0.0f);
        g[H * P - P + j - 1] += clamp<kTame>(__fsub_rn(u, mid[H - 1][j]), b);
      }
    }
  });
  const float tot = cluster_reduce<H * P, false>(g, red);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    int j = 1;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float gj = __shfl_sync(kFull, tot, h * P + j - 1);
      float mj = 0.0f;
#pragma unroll
      for (int c = 1; c <= P; ++c)
        if (c == j) mj = mid[h][c];
      const bool take_hi = MODE == 0 ? gj > 0.0f : gj > tgt;
      lo[h] = take_hi ? mj : lo[h];
      hi[h] = take_hi ? hi[h] : mj;
      j = 2 * j + (take_hi ? 1 : 0);
    }
  }
}

// One projected Nesterov step of the epsilon-SVR (MODE 0: the box and
// the hyperplane sum(a - a*) = 0) or nu-SVR (MODE 1: sum a = sum a* =
// target[row]) dual over rows of 2n elements, from the product V = beta K
// (M, n), the labels y (n) and the row's epsilon (MODE 0); the brackets,
// the clip rules and the wide/tame cases are `dual_step`'s.  CTA `rank` of
// row blockIdx.x / C owns the pairs [rank share, (rank + 1) share) of its
// row.  Pass 1: the gradient step, the brackets' maxima (a cluster max)
// and the thread's two lists (the elements with a bound, or a non-finite
// value; a wide bracket lists every element).  The 40 bisection steps, K
// a pass in a tame row, one a pass otherwise.  The last pass writes x',
// z', beta' = z'_a - z'_a* over the share and the residual (a cluster
// max, written by rank 0).
template <int MODE>
__global__ void __launch_bounds__(kSvrThreads)
svr_cluster_step(const float* __restrict__ V, const float* __restrict__ Z,
                 const float* __restrict__ X, const float* __restrict__ Y,
                 const float* __restrict__ eps_ptr,
                 const float* __restrict__ Bh,
                 const float* __restrict__ step_ptr, float coef,
                 const float* __restrict__ target, float* __restrict__ Xo,
                 float* __restrict__ Zo, float* __restrict__ Beta,
                 float* __restrict__ resid, int n, int share) {
  __shared__ float wpart[kSvrMaxNV * kSvrWarps];
  __shared__ float recv[2 * kSvrMaxCluster * kSvrMaxNV];
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  ClusterRed red = {wpart, recv, bar, C, rank, 0};
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();          // every CTA's mbarriers are set before any sends
  constexpr int K = MODE == 0 ? kSvrLevelsSvr : kSvrLevelsNu;
  const size_t row = blockIdx.x / C;
  const size_t off2 = row * 2 * static_cast<size_t>(n);
  const size_t offn = row * static_cast<size_t>(n);
  const float step = *step_ptr;
  const float eps = MODE == 0 ? eps_ptr[row] : 0.0f;
  const int p0 = min(n, rank * share);
  const int p1 = min(n, p0 + share);
  const SvrShare kept = {reinterpret_cast<float2*>(s2_smem),
                         ((share + kSvrThreads - 1) / kSvrThreads) *
                             kSvrThreads};
  const bool has_v = V != nullptr;

  float mx[3] = {0.0f, 0.0f, -INFINITY};   // max|u|, max b, max -b
  int cnt_a = 0, cnt_s = 0;
  share_batches(V, Z, nullptr, Y, Bh, offn, off2, n, p0, p1,
                [&](int, float b, float y, float v, float za, float zs,
                    float, float) {
    const float ua = svr_grad_step<MODE>(has_v, v, za, 1.0f, y, eps, step);
    const float us = svr_grad_step<MODE>(has_v, v, zs, -1.0f, y, eps, step);
    mx[0] = max_nan(mx[0], max_nan(fabsf(ua), fabsf(us)));
    mx[1] = max_nan(mx[1], b);
    mx[2] = max_nan(mx[2], -b);
    const bool fin_b = isfinite(b);
    if (b != 0.0f || !(isfinite(ua) && fin_b)) kept.put(0, cnt_a++, ua, b);
    if (b != 0.0f || !(isfinite(us) && fin_b)) kept.put(1, cnt_s++, us, b);
  });
  const float mt = cluster_reduce<3, true>(mx, red);
  const float m_u = __shfl_sync(kFull, mt, 0);
  const float m_b = __shfl_sync(kFull, mt, 1);
  const float m_nb = __shfl_sync(kFull, mt, 2);

  float lo[2], hi[2], tgt = 0.0f;
  if (MODE == 0) {
    lo[0] = -__fadd_rn(m_u, m_b);
    hi[0] = -lo[0];
    lo[1] = hi[1] = 0.0f;
  } else {
    tgt = target[row];
    const float zmax = __fadd_rn(__fadd_rn(m_u, m_b), 1.0f);
    lo[0] = lo[1] = -zmax;
    hi[0] = hi[1] = zmax;
  }
  const bool wide = !(hi[0] <= kHalfMax && hi[1] <= kHalfMax);
  const bool tame = !wide && m_nb <= 0.0f;
  if (wide) {
    cnt_a = cnt_s = 0;
    share_batches(V, Z, nullptr, Y, Bh, offn, off2, n, p0, p1,
                  [&](int, float b, float y, float v, float za, float zs,
                      float, float) {
      kept.put(0, cnt_a++,
               svr_grad_step<MODE>(has_v, v, za, 1.0f, y, eps, step), b);
      kept.put(1, cnt_s++,
               svr_grad_step<MODE>(has_v, v, zs, -1.0f, y, eps, step), b);
    });
  }

  const int2 cnt = make_int2(cnt_a, cnt_s);
  int left = kBisect;
  if (tame) {
    for (; left >= K; left -= K)
      svr_levels<MODE, K, true>(kept, cnt, lo, hi, tgt, red);
    for (; left > 0; --left)
      svr_levels<MODE, 1, true>(kept, cnt, lo, hi, tgt, red);
  }
  for (; left > 0; --left)
    svr_levels<MODE, 1, false>(kept, cnt, lo, hi, tgt, red);
  const float m0 = 0.5f * (lo[0] + hi[0]);
  const float m1 = MODE == 0 ? 0.0f : 0.5f * (lo[1] + hi[1]);

  float r[1] = {0.0f};
  share_batches(V, Z, X, Y, Bh, offn, off2, n, p0, p1,
                [&](int i, float b, float y, float v, float za, float zs,
                    float xa0, float xs0) {
    const float ua = svr_grad_step<MODE>(has_v, v, za, 1.0f, y, eps, step);
    const float us = svr_grad_step<MODE>(has_v, v, zs, -1.0f, y, eps, step);
    float xa, xs;
    svr_project<MODE>(ua, us, b, m0, m1, xa, xs);
    const float na = __fadd_rn(xa, __fmul_rn(coef, __fsub_rn(xa, xa0)));
    const float ns = __fadd_rn(xs, __fmul_rn(coef, __fsub_rn(xs, xs0)));
    r[0] = max_nan(r[0], max_nan(fabsf(__fsub_rn(xa, za)),
                                 fabsf(__fsub_rn(xs, zs))));
    Xo[off2 + i] = xa;
    Xo[off2 + n + i] = xs;
    Zo[off2 + i] = na;
    Zo[off2 + n + i] = ns;
    Beta[offn + i] = __fsub_rn(na, ns);
  });
  const float rt = cluster_reduce<1, true>(r, red);
  if (rank == 0 && threadIdx.x == 0) resid[row] = __fdiv_rn(rt, step);
  cl.sync();          // no CTA leaves while its stores may be in flight
}

// A cluster kernel's attributes, once a device: clusters of more than 8
// CTAs allowed, and the dynamic shared-memory limit raised as
// `allow_max_smem` does.
template <typename Kernel>
int allow_cluster(Kernel kernel, bool* raised) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0 || (dev < kMaxDevices && raised[dev])) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  if (rc != 0) return rc;
  return allow_max_smem(kernel, raised);
}

// M clusters of C CTAs, each with 16 bytes a slot of its two lists.
// `attr` holds the cluster's dimension.
cudaLaunchConfig_t svr_config(int M, int n, int C, cudaLaunchAttribute* attr,
                              cudaStream_t s) {
  const int share = (n + C - 1) / C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(M) * static_cast<unsigned>(C));
  cfg.blockDim = dim3(kSvrThreads);
  cfg.dynamicSmemBytes =
      16 * static_cast<size_t>((share + kSvrThreads - 1) / kSvrThreads) *
      kSvrThreads;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool svr_raised[2][kMaxDevices] = {};     // allow_cluster's, by mode

// A launch the card refuses (a cluster it cannot place) returns its
// error.
template <int MODE>
int launch_svr(const float* V, const float* Z, const float* X, const float* Y,
               const float* eps, const float* Bh, const float* step,
               float coef, const float* target, float* Xo, float* Zo,
               float* Beta, float* resid, int M, int n, int C,
               cudaStream_t s) {
  int rc = allow_cluster(svr_cluster_step<MODE>, svr_raised[MODE]);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = svr_config(M, n, C, attr, s);
  rc = static_cast<int>(cudaLaunchKernelEx(
      &cfg, svr_cluster_step<MODE>, V, Z, X, Y, eps, Bh, step, coef, target,
      Xo, Zo, Beta, resid, n, (n + C - 1) / C));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C CTAs the card holds at once for rows of n pairs
// (cudaOccupancyMaxActiveClusters, on an idle card).
template <int MODE>
int svr_clusters(int n, int C, int* out) {
  const int rc = allow_cluster(svr_cluster_step<MODE>, svr_raised[MODE]);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = svr_config(1, n, C, attr, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, svr_cluster_step<MODE>, &cfg));
}

}  // namespace

extern "C" {

// S1: G (n1, n2) = X1 X2^T in, the kernel matrix out, in place, in one
// launch.  sq1 (n1) and sq2 (n2, 16-byte aligned) are scratch for the rbf
// row norms; `same` says X2 is X1 (then the norms are G's diagonal, sq2
// is not written and sq1 serves both sides).  kind: 1 rbf, 2 poly, 3
// sigmoid (linear needs no launch).  `grid` blocks: rbf's cooperative
// grid (at most kEpiBlocksPerSm an SM), else a block an epilogue tile;
// `vec` 16 bytes a thread (n2 % 4 == 0, G 16-byte aligned), as
// svm_kernels.py `gram_plan` and `gram_vec` choose them.  Returns the
// launch's error (0 = launched).
int svm_gram_epilogue(float* G, const float* X1, const float* X2,
                      float* sq1, float* sq2, int n1, int n2, int d,
                      int same, int kind, float gamma, float degree,
                      float coef0, int grid, int vec, void* stream) {
  const int chunks = (n2 + kEpiCols - 1) / kEpiCols;
  const long long tiles = static_cast<long long>(n1) * chunks;
  if (n1 < 1 || n2 < 1 || d < 1 || grid < 1 || (same && n1 != n2) ||
      kind < kRbf || kind > kSigmoid ||
      (kind != kRbf && grid != tiles) ||
      (vec && (n2 % 4 != 0 ||
               (reinterpret_cast<uintptr_t>(G) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (kind == kRbf) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g);
    cfg.blockDim = dim3(kEpiThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;   // the grid sync
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int rc = static_cast<int>(
        vec ? cudaLaunchKernelEx(&cfg, gram_rbf<true>, G, X1, X2, sq1, sq2,
                                 n1, n2, d, same, chunks, gamma)
            : cudaLaunchKernelEx(&cfg, gram_rbf<false>, G, X1, X2, sq1, sq2,
                                 n1, n2, d, same, chunks, gamma));
    if (rc != 0) return rc;
  } else if (kind == kPoly) {
    if (vec)
      gram_elementwise<kPoly, true><<<g, kEpiThreads, 0, s>>>(
          G, n2, chunks, gamma, degree, coef0);
    else
      gram_elementwise<kPoly, false><<<g, kEpiThreads, 0, s>>>(
          G, n2, chunks, gamma, degree, coef0);
  } else {
    if (vec)
      gram_elementwise<kSigmoid, true><<<g, kEpiThreads, 0, s>>>(
          G, n2, chunks, gamma, degree, coef0);
    else
      gram_elementwise<kSigmoid, false><<<g, kEpiThreads, 0, s>>>(
          G, n2, chunks, gamma, degree, coef0);
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

// S2, SVR mode: one projected Nesterov step of the epsilon-SVR (mode 0)
// or nu-SVR (mode 1) dual over M rows of 2n (a, a*) elements, a cluster
// of `cluster` CTAs a row (1 to 16, each CTA's share of ceil(n / cluster)
// pairs at most kSvrShareMax).  V (M, n) may be null (a projection of z
// only); eps (M,) is read in mode 0, target (M,) in mode 1; `step` is a
// device scalar.  Xo, Zo and Beta must not alias the inputs.  Returns the
// launch's error (0 = launched).
int svm_svr_step(const float* V, const float* Z, const float* X,
                 const float* Y, const float* eps, const float* Bh,
                 const float* step, float coef, const float* target,
                 float* Xo, float* Zo, float* Beta, float* resid, int M,
                 int n, int mode, int cluster, void* stream) {
  if (M < 1 || n < 1 || cluster < 1 || cluster > kSvrMaxCluster ||
      (n + cluster - 1) / cluster > kSvrShareMax ||
      static_cast<long long>(M) * cluster > 2147483647LL ||
      (mode == 0 && eps == nullptr) || (mode == 1 && target == nullptr) ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? launch_svr<0>(V, Z, X, Y, eps, Bh, step, coef, target,
                                   Xo, Zo, Beta, resid, M, n, cluster, s)
                   : launch_svr<1>(V, Z, X, Y, eps, Bh, step, coef, target,
                                   Xo, Zo, Beta, resid, M, n, cluster, s);
}

// S2, SVR mode: into *out, how many clusters of `cluster` CTAs (rows of n
// pairs, mode 0 or 1) the current device holds at once.  Returns the
// query's error (0 = answered).
int svm_svr_clusters(int n, int mode, int cluster, int* out) {
  if (n < 1 || cluster < 1 || cluster > kSvrMaxCluster ||
      (n + cluster - 1) / cluster > kSvrShareMax || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return mode == 0 ? svr_clusters<0>(n, cluster, out)
                   : svr_clusters<1>(n, cluster, out);
}

}  // extern "C"
