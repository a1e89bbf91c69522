// SVC/NuSVC probability=True on Hopper (sm_90a): Platt scaling (P1) and
// Wu-Lin pairwise coupling (P2).  Built with nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (spark_sklearn_tpu_torch/ops/_build.py); the Python wrappers live in
// spark_sklearn_tpu_torch/ops/svm_proba_kernels.py beside their plain
// PyTorch versions and the launch plans.
//
// P1  svm_platt_fit   replaces spark_sklearn_tpu/models/svm.py:331-393
//     (`_platt_fit`) with the targets and weights the family forms for it
//     (:658-687): per (task b, pair p) row, the pair decisions f_i =
//     dec[b, i, p] of the n training rows, weights w_i = train_w[b, i] for
//     the rows of the pair's two classes (all rows when binary), Platt's
//     smoothed targets t_pos = (N+ + 1) / (N+ + 2) on the positive class
//     (classes_[1] when binary, the pair's first class otherwise) and
//     t_neg = 1 / (N- + 2) on the other, N+- the weight sums; then A = 0,
//     B = log((Σw(1-t) + 1) / (Σwt + 1)) and 50 damped Newton steps on
//       L(A, B) = Σ w (log(1 + e^u) - (1 - t) u),  u = A f + B,
//     each with the 2x2 solve and the first of 8 halvings 1, 1/2, ..,
//     1/128 whose loss is <= the current one; no such halving, a
//     non-finite step or max(|gA|, |gB|) < 1e-5 leaves A and B untouched.
//     Bound: operations.  Every kept element costs, a Newton step, the
//     gradient pass (33 FP32 operations in its SASS, an FFMA counted as
//     2, and a MUFU.EX2 and a MUFU.RCP) and, where the gradient is at
//     least 1e-5, the 8 trial losses (416 and 8 MUFU.EX2; CUDA's log1pf
//     is a polynomial on the FP32 pipes).  The work the outputs need is
//     each row's steps up to its exit.
//
// Design of P1.
// - One block of 256 threads a row.  Pass 1 reads the row's decisions
//   (strided by P in the (B, n, P) cache), labels and fold weights once
//   and keeps the elements whose weight is not 0 (or whose decision is
//   not finite: NaN propagates as in the reference), each thread in its
//   own order at slot q 256 + t: f, w and the positive flag, 9 bytes a
//   slot in shared memory ("staged", up to kPlattStagedMaxN rows), or
//   none ("streamed": every pass reads the row again).  At phase 13's
//   multiclass rows ~16% of the elements are kept.
// - Each Newton step is two passes over the kept elements: the gradient
//   and Hessian sums (5 values, one block reduction), then the 8 trial
//   losses at once (8 values, one reduction).  The current loss is
//   carried: an accepted step's loss is the trial loss computed at the
//   same A and B.  A step whose gradient is below 1e-5 skips its trial
//   pass (its step is 0 whatever the losses).
// - The exit: a step depends only on A, B and the carried loss, so the
//   first step that leaves A and B bitwise as they were (a gradient under
//   1e-5, no halving accepted, a non-finite step) is a fixed point, and
//   the row leaves its Newton loop there with the 50-step run's outputs,
//   bit for bit ("staged_full" runs all 50 steps, to show it).  Rows that
//   never reach one (13.6% at phase 13: they accept steps of a few ulps
//   of B back and forth) mostly repeat a state within a few steps: a
//   state (A, B, loss) equal to the one p <= kCycle steps back repeats
//   with period p, so the row leaves with the state the 50th step would
//   give, bit for bit too.  Its block frees its SM's slot for the next
//   row.
// - Block sums: every warp by xor shuffles, then every thread adds the
//   8 warps' values in warp order, so every thread holds the same total
//   and takes the same branch (and the same exit), and two launches give
//   the same bits.  Each thread sums its elements in the first version's
//   order, so the outputs keep its bits.
//
// P2  svm_pair_coupling   replaces svm.py:396-446 (`_pair_probs_to_R` and
//     `_pairwise_coupling`) on the sigmoids of svm.py:768-776: per (task,
//     row) problem, r_p = clip(sigmoid(-(A_p f_p + B_p)), 1e-7, 1 - 1e-7)
//     for each pair, R[i_p, j_p] = r_p and R[j_p, i_p] = 1 - r_p, Q[t, t]
//     = Σ_j R[j, t]^2 and Q[t, j] = -R[j, t] R[t, j], then from p = 1/k,
//     100 sweeps of libsvm's k Gauss-Seidel steps (diff = (pQp - Qp_t) /
//     Q_tt; pQp, Qp and p rescaled by 1 + diff), in the reference's order.
//     Bound: operations.  A sweep of the reference's arithmetic is Qp = Q p
//     (2 k^2), pQp (2 k), and k steps of ~4 k + 11 (the diff, pQp's
//     update, Qp's and p's rescale): 6 k^2 + 13 k; R and Q from the
//     sigmoids ~13 a pair and an expf on the SFUs.
//
// Design of P2.
// - One thread a problem.  "registers" (3 <= k <= kRegMaxK, a template on
//   k): Q (k x k), p and Qp live in registers, every loop over classes
//   unrolled, so a sweep is FMAs and no memory access.  "shared" (larger
//   k): the same steps with Q, p and Qp in shared memory, the thread's
//   element e at e * blockDim + t (a warp's accesses hit 32 banks),
//   blockDim picked by the wrapper so that a block stays within the
//   block's 227 KB (`coupling_plan`: k <= 41).  "global" (above): the
//   same again in a scratch tensor, element e of grid thread g at e *
//   (grid threads) + g, the grid sized by the wrapper to the scratch it
//   allows and walking the problems.  Q's diagonal is summed in j order
//   (the pairs come in lexicographic order, which is j order for every
//   column).
// - The rescale by 1 + diff multiplies by its reciprocal, taken once a
//   step, where the reference divides each of the 2k + 1 values: within
//   an ulp of each.  The first (shared-memory) version of a k = 10 call
//   took 9.4 ms at phase 13's 450000 problems.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlattThreads = 256;
constexpr int kPlattWarps = kPlattThreads / 32;
constexpr int kPlattStagedMaxN = 20480;     // 9 bytes an element: 180 KB
constexpr int kPlattMinBlocks = 2;          // blocks an SM a list of n =
                                            // 10000 leaves room for (4, at
                                            // most 64 registers, spilled)
constexpr int kNewton = 50;                 // svm.py:331 n_iter
constexpr int kHalvings = 8;                // svm.py:366
constexpr int kCycle = 8;                   // P1: longest period the exit
                                            // looks for
constexpr int kMaxV = 8;                    // most values one reduction adds
constexpr int kMaxSmem = 232448;            // 227 KB, an H100 block's most
constexpr int kMaxDevices = 64;
constexpr int kSweeps = 100;                // svm.py:409 n_iter
constexpr float kClipLo = 1e-7f;
constexpr float kClipHi = static_cast<float>(1.0 - 1e-7);
constexpr int kRegMaxK = 12;                // P2's register plan: k <= 12

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

// Block-wide sums of NV values, for every thread: each warp's xor-shuffle
// tree, then the warps' values added in warp order by every thread.  Two
// alternating slots (`parity`), so a slot is never rewritten while a slow
// thread may still read it.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* buf,
                                          int& parity) {
  static_assert(NV <= kMaxV, "reduction too wide");
  float* part = buf + parity * kPlattWarps * kMaxV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    if (lane == 0) part[q * kPlattWarps + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kPlattWarps; ++w) s += part[q * kPlattWarps + w];
    v[q] = s;
  }
  parity ^= 1;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// log(1 + e^u) as jnp.logaddexp(0, u): max(u, 0) + log1p(e^-|u|), NaN
// passing through
__device__ __forceinline__ float softplus(float u) {
  return (u > 0.0f ? u : 0.0f) + log1pf(expf(-fabsf(u)));
}

extern __shared__ float p1_smem[];

// One row's elements: the decision, weight and positive flag of row i.
struct PlattRow {
  const float* dec;          // dec[b, 0, p]; element i at i * P
  int P;
  const float* w;            // train_w[b, :]
  const int* y;
  int pi, pj, pos;
  __device__ __forceinline__ bool get(int i, float& f, float& w_i,
                                      bool& yp) const {
    const int yi = y[i];
    f = dec[static_cast<size_t>(i) * P];
    w_i = (yi == pi || yi == pj) ? w[i] : 0.0f;
    yp = yi == pos;
    return w_i != 0.0f || !isfinite(f);
  }
};

// The kept elements of a row, visited in each thread's own order:
// staged, from the shared-memory list; streamed, by reading the row.
template <bool kStaged>
struct PlattElems {
  PlattRow row;
  int n, cnt, cap;
  template <typename Fn>
  __device__ __forceinline__ void visit(Fn fn) const {
    if (kStaged) {
      const unsigned char* flag =
          reinterpret_cast<const unsigned char*>(p1_smem + 2 * cap);
      for (int q = 0; q < cnt; ++q) {
        const int k = q * kPlattThreads + threadIdx.x;
        fn(p1_smem[k], p1_smem[cap + k], flag[k] != 0);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kPlattThreads) {
        float f, w;
        bool yp;
        if (row.get(i, f, w, yp)) fn(f, w, yp);
      }
    }
  }
};

// kStaged: the row's kept elements in shared memory; kExit: leave the
// Newton loop at the first step that leaves A and B as they were or
// repeats a state.  `steps` (rows, 2), when not null, gets each row's
// Newton steps run and trial passes run.
template <bool kStaged, bool kExit>
__global__ void __launch_bounds__(kPlattThreads, kPlattMinBlocks)
    platt_fit_kernel(const float* __restrict__ dec, const int* __restrict__ y,
                     const float* __restrict__ train_w,
                     const int* __restrict__ pairs, int n, int P, int binary,
                     float* __restrict__ A_out, float* __restrict__ B_out,
                     int* __restrict__ steps) {
  __shared__ float red[2 * kPlattWarps * kMaxV];
  int parity = 0;
  const int r = blockIdx.x;
  const int b = r / P, p = r - b * P;
  PlattRow row;
  row.dec = dec + static_cast<size_t>(b) * n * P + p;
  row.P = P;
  row.w = train_w + static_cast<size_t>(b) * n;
  row.y = y;
  row.pi = pairs[2 * p];
  row.pj = pairs[2 * p + 1];
  row.pos = binary ? row.pj : row.pi;
  const int cap = ((n + kPlattThreads - 1) / kPlattThreads) * kPlattThreads;

  // pass 1: the list, and the weight sums of the two classes
  float s3[3] = {0.0f, 0.0f, 0.0f};          // N+, N-, Σw
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kPlattThreads) {
    float f, w;
    bool yp;
    if (!row.get(i, f, w, yp)) continue;
    if (yp)
      s3[0] += w;
    else
      s3[1] += w;
    s3[2] += w;
    if (kStaged) {
      const int k = cnt * kPlattThreads + threadIdx.x;
      p1_smem[k] = f;
      p1_smem[cap + k] = w;
      reinterpret_cast<unsigned char*>(p1_smem + 2 * cap)[k] = yp ? 1 : 0;
    }
    ++cnt;
  }
  block_sum<3>(s3, red, parity);
  const float t_pos = (s3[0] + 1.0f) / (s3[0] + 2.0f);
  const float t_neg = 1.0f / (s3[1] + 2.0f);
  const PlattElems<kStaged> el = {row, n, cnt, cap};

  // _platt_fit's start: A = 0, B from the smoothed targets' weight
  float wt[1] = {0.0f};
  el.visit([&](float, float w, bool yp) { wt[0] += w * (yp ? t_pos : t_neg); });
  block_sum<1>(wt, red, parity);
  const float nn = (s3[2] + 1e-12f) - wt[0];
  float A = 0.0f, B = logf((nn + 1.0f) / (wt[0] + 1.0f));

  float L0[1] = {0.0f};
  el.visit([&](float f, float w, bool yp) {
    const float u = __fadd_rn(__fmul_rn(A, f), B);
    const float omt = 1.0f - (yp ? t_pos : t_neg);
    L0[0] += w * (softplus(u) - omt * u);
  });
  block_sum<1>(L0, red, parity);
  float loss0 = L0[0];

  // A step depends only on A, B and the carried loss, which changes only
  // with an accepted step (to the trial loss at the new A and B).  So once
  // a step leaves A and B bitwise as they were, every later step does too
  // (the same gradient, the same trial losses, the same first acceptable
  // halving), and the row's outputs are final: kExit leaves there.  And
  // once the state (A, B, loss) after step s equals the state after step
  // s - p, the states repeat with period p from there, so the state after
  // the last step is known: kExit leaves with it (rows that accept steps
  // of a few ulps back and forth).  hA, hB, hL hold the states after the
  // last kCycle steps, newest first.  Every thread holds the same totals,
  // so the block leaves together.
  int it = 0, trials = 0, have = 0;
  float hA[kCycle] = {}, hB[kCycle] = {}, hL[kCycle] = {};
  while (it < kNewton) {
    ++it;
    float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // gA gB hAA hAB hBB
    el.visit([&](float f, float w, bool yp) {
      const float u = __fadd_rn(__fmul_rn(A, f), B);
      const float s = 1.0f / (1.0f + expf(-u));
      const float omt = 1.0f - (yp ? t_pos : t_neg);
      const float rr = w * (s - omt);
      const float h = w * s * (1.0f - s);
      g[0] += rr * f;
      g[1] += rr;
      g[2] += h * f * f;
      g[3] += h * f;
      g[4] += h;
    });
    block_sum<5>(g, red, parity);
    const float hAA = g[2] + 1e-9f, hAB = g[3], hBB = g[4] + 1e-9f;
    const float det = hAA * hBB - hAB * hAB;
    const float dA = (hBB * g[0] - hAB * g[1]) / det;
    const float dB = (hAA * g[1] - hAB * g[0]) / det;
    const float ga = fabsf(g[0]), gb = fabsf(g[1]);
    const float gmax = (ga != ga || ga > gb) ? ga : gb;
    if (!(gmax >= 1e-5f)) {                  // converged: the step is 0
      if (kExit) break;
      continue;
    }
    ++trials;
    float Ls[kHalvings];
#pragma unroll
    for (int k = 0; k < kHalvings; ++k) Ls[k] = 0.0f;
    el.visit([&](float f, float w, bool yp) {
      const float omt = 1.0f - (yp ? t_pos : t_neg);
      float st = 1.0f;
#pragma unroll
      for (int k = 0; k < kHalvings; ++k) {
        const float Ak = A - st * dA, Bk = B - st * dB;
        const float u = __fadd_rn(__fmul_rn(Ak, f), Bk);
        Ls[k] += w * (softplus(u) - omt * u);
        st *= 0.5f;
      }
    });
    block_sum<kHalvings>(Ls, red, parity);
    const float A0 = A, B0 = B, L0s = loss0;
    float st = 1.0f;
#pragma unroll
    for (int k = 0; k < kHalvings; ++k) {
      if (Ls[k] <= loss0) {
        A = A - st * dA;
        B = B - st * dB;
        loss0 = Ls[k];
        break;
      }
      st *= 0.5f;
    }
    if (!kExit) continue;
    if (same_bits(A, A0) && same_bits(B, B0)) break;    // a fixed point
#pragma unroll
    for (int j = kCycle - 1; j > 0; --j) {
      hA[j] = hA[j - 1];
      hB[j] = hB[j - 1];
      hL[j] = hL[j - 1];
    }
    hA[0] = A0;
    hB[0] = B0;
    hL[0] = L0s;
    have = have < kCycle ? have + 1 : kCycle;
    // the state after step it against the one after step it - p
    int period = 0;
#pragma unroll
    for (int p = kCycle; p >= 2; --p)
      if (p <= have && same_bits(A, hA[p - 1]) && same_bits(B, hB[p - 1]) &&
          same_bits(loss0, hL[p - 1]))
        period = p;
    if (period != 0) {
      // after step kNewton: the state after step it - period + m, m =
      // (kNewton - it) mod period, which is hA[period - m - 1] for m > 0
      const int m = (kNewton - it) % period;
#pragma unroll
      for (int j = 0; j < kCycle; ++j) {
        if (m != 0 && j == period - m - 1) {
          A = hA[j];
          B = hB[j];
        }
      }
      break;
    }
  }
  if (threadIdx.x == 0) {
    A_out[r] = A;
    B_out[r] = B;
    if (steps != nullptr) {
      steps[2 * r] = it;
      steps[2 * r + 1] = trials;
    }
  }
}

// ---------------------------------------------------------------------------
// P2
// ---------------------------------------------------------------------------

extern __shared__ float p2_smem[];

// P2's general plan, any k: a thread a problem at a time, element e of its
// Q, p and Qp at base[e * stride]: in shared memory (kGlobal false,
// "shared": base p2_smem + t, stride blockDim, one problem a thread) or in
// a global scratch (kGlobal true, "global": base scratch + the thread's
// index in the grid, stride the grid's threads, the grid walking the
// problems in strides of its threads).
template <bool kGlobal>
__global__ void pair_coupling_kernel(const float* __restrict__ dec,
                                     const float* __restrict__ platt,
                                     const int* __restrict__ pairs,
                                     long long problems, int n, int P, int k,
                                     float* __restrict__ scratch,
                                     float* __restrict__ out) {
  const long long g0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long grid_threads =
      static_cast<long long>(gridDim.x) * blockDim.x;
  const size_t T = kGlobal ? static_cast<size_t>(grid_threads) : blockDim.x;
  float* Q = kGlobal ? scratch + g0 : p2_smem + threadIdx.x;
  float* p = Q + static_cast<size_t>(k) * k * T;
  float* Qp = p + static_cast<size_t>(k) * T;
  for (long long g = g0; g < problems; g += grid_threads) {
    const long long task = g / n;
    for (int e = 0; e < k * k; ++e) Q[e * T] = 0.0f;
    const float* d = dec + g * P;
    const float* ab = platt + task * 2 * P;
    // R from the pair sigmoids, straight into Q (pairs in lexicographic
    // order: each diagonal sum runs in j order)
    for (int q = 0; q < P; ++q) {
      const int i = pairs[2 * q], j = pairs[2 * q + 1];
      const float u = -__fadd_rn(__fmul_rn(d[q], ab[2 * q]), ab[2 * q + 1]);
      float r = 1.0f / (1.0f + expf(-u));
      r = r < kClipLo ? kClipLo : (r > kClipHi ? kClipHi : r);  // NaN passes
      const float rc = 1.0f - r;                 // R[j, i]
      const float off = -(rc * r);
      Q[(i * k + j) * T] = off;
      Q[(j * k + i) * T] = off;
      Q[(i * k + i) * T] += rc * rc;             // R[j, i]^2 into column i
      Q[(j * k + j) * T] += r * r;               // R[i, j]^2 into column j
    }
    const float p0 = 1.0f / static_cast<float>(k);
    for (int e = 0; e < k; ++e) p[e * T] = p0;
    for (int sweep = 0; sweep < kSweeps; ++sweep) {
      float pQp = 0.0f;
      for (int a = 0; a < k; ++a) {
        float s = 0.0f;
        for (int c = 0; c < k; ++c) s += Q[(a * k + c) * T] * p[c * T];
        Qp[a * T] = s;
      }
      for (int a = 0; a < k; ++a) pQp += p[a * T] * Qp[a * T];
      for (int t = 0; t < k; ++t) {
        const float Qtt = Q[(t * k + t) * T];
        const float qpt = Qp[t * T];
        const float diff = (-qpt + pQp) / Qtt;
        const float one = 1.0f + diff;
        pQp = (pQp + diff * (diff * Qtt + 2.0f * qpt)) / (one * one);
        const float inv = 1.0f / one;
        p[t * T] += diff;
        for (int c = 0; c < k; ++c) {
          Qp[c * T] = (Qp[c * T] + diff * Q[(t * k + c) * T]) * inv;
          p[c * T] *= inv;
        }
      }
    }
    float* o = out + g * k;
    for (int e = 0; e < k; ++e) o[e] = p[e * T];
  }
}

// P2's register plan: Q, p and Qp of one problem in registers; the pairs
// in lexicographic order (i < j, i major), as the family makes them.
template <int K>
__global__ void __launch_bounds__(128)
    pair_coupling_reg(const float* __restrict__ dec,
                      const float* __restrict__ platt, long long problems,
                      int n, float* __restrict__ out) {
  constexpr int P = K * (K - 1) / 2;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= problems) return;
  const long long task = g / n;
  const float* d = dec + g * P;
  const float* ab = platt + task * 2 * P;
  float Q[K][K];
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int c = 0; c < K; ++c) Q[a][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = i + 1; j < K; ++j) {
      const int q = i * K - i * (i + 1) / 2 + (j - i - 1);
      const float u = -__fadd_rn(__fmul_rn(d[q], ab[2 * q]), ab[2 * q + 1]);
      float r = 1.0f / (1.0f + expf(-u));
      r = r < kClipLo ? kClipLo : (r > kClipHi ? kClipHi : r);
      const float rc = 1.0f - r;
      const float off = -(rc * r);
      Q[i][j] = off;
      Q[j][i] = off;
      Q[i][i] += rc * rc;
      Q[j][j] += r * r;
    }
  }
  float p[K], Qp[K];
  const float p0 = 1.0f / static_cast<float>(K);
#pragma unroll
  for (int e = 0; e < K; ++e) p[e] = p0;
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int a = 0; a < K; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < K; ++c) s += Q[a][c] * p[c];
      Qp[a] = s;
    }
    float pQp = 0.0f;
#pragma unroll
    for (int a = 0; a < K; ++a) pQp += p[a] * Qp[a];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float Qtt = Q[t][t];
      const float qpt = Qp[t];
      const float diff = (-qpt + pQp) / Qtt;
      const float one = 1.0f + diff;
      pQp = (pQp + diff * (diff * Qtt + 2.0f * qpt)) / (one * one);
      const float inv = 1.0f / one;
      p[t] += diff;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        Qp[c] = (Qp[c] + diff * Q[t][c]) * inv;
        p[c] *= inv;
      }
    }
  }
  float* o = out + g * K;
#pragma unroll
  for (int e = 0; e < K; ++e) o[e] = p[e];
}

template <int K>
int launch_reg(const float* dec, const float* platt, long long problems,
               int n, float* out, int threads, cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((problems + threads - 1) / threads);
  pair_coupling_reg<K><<<grid, threads, 0, s>>>(dec, platt, problems, n,
                                                out);
  return static_cast<int>(cudaGetLastError());
}

// Raises a kernel's dynamic shared-memory limit where `smem` is above the
// default 48 KB, once a device and size.
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

// P1's staged launches: 9 bytes a slot, a slot an element.
template <bool kExit>
int launch_platt_staged(const float* dec, const int* y, const float* train_w,
                        const int* pairs, int n, int P, int binary, float* A,
                        float* B, int* steps, unsigned grid, cudaStream_t s) {
  const size_t smem =
      9 * static_cast<size_t>((n + kPlattThreads - 1) / kPlattThreads) *
      kPlattThreads;
  static int raised[kMaxDevices] = {};
  const int rc = allow_smem(platt_fit_kernel<true, kExit>, smem, raised);
  if (rc != 0) return rc;
  platt_fit_kernel<true, kExit><<<grid, kPlattThreads, smem, s>>>(
      dec, y, train_w, pairs, n, P, binary, A, B, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// P1: A and B (rows = B * P) of the Platt sigmoids of every (task, pair)
// row.  dec (B, n, P) float32 pair decisions; y (n) int32 class indices;
// train_w (B, n) float32; pairs (P, 2) int32; binary: the positive class
// is the pair's second (k = 2) instead of its first.  plan 1 ("staged",
// n <= kPlattStagedMaxN) keeps each row's kept elements in shared memory
// and leaves a row's Newton loop at its fixed point or first repeated
// state; plan 2 ("staged_full") is plan 1 run for all 50 steps; plan 0
// ("streamed") reads the row in every pass and leaves as plan 1.  steps
// (rows, 2) int32 may be null, else it gets each row's Newton steps and
// trial passes.  Returns the launch's error (0 = launched).
int svm_platt_fit(const float* dec, const int* y, const float* train_w,
                  const int* pairs, float* A, float* B, int* steps,
                  int tasks, int n, int P, int binary, int plan,
                  void* stream) {
  if (tasks < 1 || n < 1 || P < 1 || plan < 0 || plan > 2 ||
      (plan != 0 && n > kPlattStagedMaxN) ||
      static_cast<long long>(tasks) * P > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(tasks * P);
  if (plan == 1)
    return launch_platt_staged<true>(dec, y, train_w, pairs, n, P, binary, A,
                                     B, steps, grid, s);
  if (plan == 2)
    return launch_platt_staged<false>(dec, y, train_w, pairs, n, P, binary,
                                      A, B, steps, grid, s);
  platt_fit_kernel<false, true><<<grid, kPlattThreads, 0, s>>>(
      dec, y, train_w, pairs, n, P, binary, A, B, steps);
  return static_cast<int>(cudaGetLastError());
}

// P2: the coupled probabilities out (T, n, k) of dec (T, n, P) float32
// pair decisions and platt (T, P, 2) float32 (A, B) sigmoids; pairs (P, 2)
// int32 in lexicographic order.  plan 1 ("registers", 3 <= k <=
// kRegMaxK): a problem's state in registers; plan 0 ("shared"): each
// thread's (k^2 + 2k) floats in shared memory, a problem a thread; plan 2
// ("global"): in `scratch`, (k^2 + 2k) floats for each of the grid's
// threads, which walk the problems.  `threads` a block and `grid` blocks,
// as svm_proba_kernels.py `coupling_plan` picks them.  Returns the
// launch's error.
int svm_pair_coupling(const float* dec, const float* platt, const int* pairs,
                      float* scratch, float* out, int T, int n, int P, int k,
                      int threads, int grid, int plan, void* stream) {
  const long long problems = static_cast<long long>(T) * n;
  const size_t smem =
      plan == 0 ? static_cast<size_t>(threads) * (k * k + 2 * k) * 4 : 0;
  const long long blocks = (problems + threads - 1) / threads;
  if (T < 1 || n < 1 || k < 2 || P != k * (k - 1) / 2 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || smem > kMaxSmem || plan < 0 ||
      plan > 2 || (plan == 1 && (k < 3 || k > kRegMaxK || threads > 128)) ||
      (plan == 2 && (scratch == nullptr || grid < 1 || grid > blocks)) ||
      (plan != 2 && grid != blocks) || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan == 1) {
    switch (k) {
      case 3: return launch_reg<3>(dec, platt, problems, n, out, threads, s);
      case 4: return launch_reg<4>(dec, platt, problems, n, out, threads, s);
      case 5: return launch_reg<5>(dec, platt, problems, n, out, threads, s);
      case 6: return launch_reg<6>(dec, platt, problems, n, out, threads, s);
      case 7: return launch_reg<7>(dec, platt, problems, n, out, threads, s);
      case 8: return launch_reg<8>(dec, platt, problems, n, out, threads, s);
      case 9: return launch_reg<9>(dec, platt, problems, n, out, threads, s);
      case 10:
        return launch_reg<10>(dec, platt, problems, n, out, threads, s);
      case 11:
        return launch_reg<11>(dec, platt, problems, n, out, threads, s);
      default:
        return launch_reg<12>(dec, platt, problems, n, out, threads, s);
    }
  }
  if (plan == 2) {
    pair_coupling_kernel<true><<<grid, threads, 0, s>>>(
        dec, platt, pairs, problems, n, P, k, scratch, out);
    return static_cast<int>(cudaGetLastError());
  }
  static int raised[kMaxDevices] = {};
  const int rc = allow_smem(pair_coupling_kernel<false>, smem, raised);
  if (rc != 0) return rc;
  pair_coupling_kernel<false><<<grid, threads, smem, s>>>(
      dec, platt, pairs, problems, n, P, k, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
