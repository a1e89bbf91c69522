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
//     Bound: operations, counted as the fewest of the same 100 sweeps in
//     the deferred form below: Qp = Q p (2 k^2, an FMA counted as 2), pQp
//     (2 k), the steps' updates of Qp past t (k (k - 1)) and their scalars
//     (11 a step), the renormalisation (k): 3 k^2 + 13 k a sweep, and a
//     reciprocal a step and a sweep on the SFUs; R and Q ~13 a pair and
//     the sigmoid's exp and reciprocal.
//
// Design of P2.
// - The deferred rescale.  A sweep starts from p alone (Qp and pQp are
//   recomputed from it, svm.py:428-429), so it keeps p~ and (Qp)~
//   unscaled beside sig = 1 / s, the product of the reference's rescales,
//   and pq = p~' Q p~ = sig^2 pQp: a step is u = (pq - sig x) / (sig Q_tt)
//   (x = (Qp)~_t; u = diff * sig), p~_t += u, (Qp)~ += u Q[t, :],
//   sig += u, pq += u (u Q_tt + 2 x): one SFU reciprocal a step (within
//   an ulp) and no rescale of p or Qp; the sweep's end multiplies p~ by
//   1 / sig once.  Step t updates (Qp)~ only past t: the sweep reads
//   (Qp)~_c at step c alone.  A sweep is ~3 k^2 FP32 operations against
//   the reference's ~6 k^2 and three IEEE divisions a step.
// - "registers" (2 <= k <= kRegMaxK, a template on k): a thread a
//   problem, Q's packed upper triangle, p, p~ and (Qp)~ in registers,
//   every loop over classes unrolled: a sweep is FMAs and no memory
//   access.
// - "group" (k past kRegMaxK to 64, a template on (G, M)): G lanes a
//   problem, class c on lane c % G, each lane holding the rows of Q of
//   its M classes (G M columns, zero past k) and their p, p~ and (Qp)~ in
//   registers.  Step t takes (Qp)~_t and Q_tt from their owner by
//   __shfl_sync, every lane runs the step's scalars and updates its own
//   classes; Qp = Q p takes k broadcasts of p; pq is an xor-shuffle sum
//   over the group, the same bits in every lane.  The scalar chain runs on
//   all G lanes, so few lanes whose rows fit win: G by k from
//   kGroupLanes / kGroupLastK (4 to k = 28, 8 to 40, 16 to 64), the only
//   shapes built (chip_sweep.py rebuilds with other lists); where a
//   lane's rows pass ~120 registers a cap of 128 or 170
//   (`group_min_blocks`) runs faster, spills and all.
// - "shared" (k past 64, to 239) and "global" (past it): 32 lanes a
//   problem, the same group steps with the state in the group's slice of
//   shared memory (rows at an odd stride: a group's column reads hit
//   distinct banks) or of a global scratch the grid's groups walk.
// - A sweep that gives back its own p bit for bit fixes every later
//   sweep, so a problem could leave there with the 100-sweep bits; on
//   phase 13's inputs few problems reach one (most settle into a cycle of
//   a few sweeps) and a warp waits for its slowest problem, so the exit
//   did not pay and is not taken (chip_sweep.py counts and times it in
//   rebuilt libraries).
// - Q's diagonal is summed in the other class's order (the pairs come in
//   lexicographic order).  The first version (a thread a problem, the
//   reference's arithmetic; registers to k = 12, shared memory to 41, a
//   global scratch above) took 1.67 ms at phase 13's 450000 problems.

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
constexpr int kCouplingThreads = 128;       // P2's most threads a block
constexpr int kRegMinBlocks = 1;            // P2's blocks an SM its register
                                            // plan must leave room for
constexpr int kGroupMinBlocks = 0;          // the group plan's, 0: by shape
                                            // (group_min_blocks)
// P2's group plan: G = kGroupLanes[i] lanes a problem for k past the last
// span's to kGroupLastK[i] (the first span's from kRegMaxK + 1)
constexpr int kGroupLanes[] = {4, 8, 16};
constexpr int kGroupLastK[] = {28, 40, 64};
constexpr int kGroupSpans = sizeof(kGroupLanes) / sizeof(kGroupLanes[0]);

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

// The reciprocal on the SFU (MUFU.RCP), within an ulp.
__device__ __forceinline__ float rcp_sfu(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Pair (i, j), i < j, among k classes in lexicographic order.
__device__ __forceinline__ int pair_index(int i, int j, int k) {
  return i * k - i * (i + 1) / 2 + (j - i - 1);
}

// r = clip(sigmoid(-(A f + B))) of pair q of a problem (svm.py:774, :402):
// R[i, j] = r and R[j, i] = 1 - r for the pair's (i, j).
__device__ __forceinline__ float pair_r(const float* __restrict__ d,
                                        const float* __restrict__ ab, int q) {
  const float u = -__fadd_rn(__fmul_rn(d[q], ab[2 * q]), ab[2 * q + 1]);
  const float r = 1.0f / (1.0f + expf(-u));
  return r < kClipLo ? kClipLo : (r > kClipHi ? kClipHi : r);  // NaN passes
}

// Q[a, c], c != a, and R[c, a]^2, the term of c in Q[a, a] (svm.py:423-425).
__device__ __forceinline__ void q_entry(const float* __restrict__ d,
                                        const float* __restrict__ ab, int a,
                                        int c, int k, float& off,
                                        float& diag) {
  const float r =
      pair_r(d, ab, c > a ? pair_index(a, c, k) : pair_index(c, a, k));
  const float rc = 1.0f - r;
  off = -(rc * r);
  diag = c > a ? rc * rc : r * r;
}

// One Gauss-Seidel step in the deferred form.  The sweep keeps p~ and
// (Qp)~ unscaled and sig = 1 / s, the scale the reference's rescales
// would have applied (p = p~ / sig, Qp = (Qp)~ / sig), and pq = p~' Q p~
// = sig^2 pQp.  The reference's diff = (pQp - Qp_t) / Q_tt becomes
// u = diff * sig = (pq - sig x) / (sig Q_tt), x = (Qp)~_t; then p~_t += u,
// (Qp)~ += u Q[t, :] (the caller's), sig += u (sig (1 + diff)) and
// pq += u (u Q_tt + 2 x).  One reciprocal a step and no rescale of p or
// Qp: the sweep's end divides p~ by sig once.
__device__ __forceinline__ float coupling_step(float& sig, float& pq, float x,
                                               float qtt) {
  const float u = fmaf(-sig, x, pq) * rcp_sfu(sig * qtt);
  sig += u;
  pq = fmaf(u, fmaf(u, qtt, x + x), pq);
  return u;
}

// Index of Q[a, c], a <= c, in a packed upper triangle of K rows.
template <int K>
__device__ __forceinline__ constexpr int tri(int a, int c) {
  return a <= c ? a * K - a * (a - 1) / 2 + (c - a)
                : c * K - c * (c - 1) / 2 + (a - c);
}

// "registers" (2 <= k <= kRegMaxK): a thread a problem, its Q (the packed
// upper triangle), p, p~ and (Qp)~ in registers, every loop over classes
// unrolled.  Step t updates (Qp)~ only for the classes after t: the sweep
// reads (Qp)~_c at step c alone and recomputes Qp at its start.
template <int K>
__global__ void __launch_bounds__(kCouplingThreads, kRegMinBlocks)
    pair_coupling_reg(const float* __restrict__ dec,
                      const float* __restrict__ platt, long long problems,
                      int n, float* __restrict__ out) {
  constexpr int P = K * (K - 1) / 2;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= problems) return;
  const float* d = dec + g * P;
  const float* ab = platt + (g / n) * 2 * P;
  float Q[K * (K + 1) / 2];
#pragma unroll
  for (int a = 0; a < K; ++a) Q[tri<K>(a, a)] = 0.0f;
  // each diagonal sum in the other class's order
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = i + 1; j < K; ++j) {
      const float r = pair_r(d, ab, pair_index(i, j, K));
      const float rc = 1.0f - r;
      Q[tri<K>(i, j)] = -(rc * r);
      Q[tri<K>(i, i)] += rc * rc;
      Q[tri<K>(j, j)] += r * r;
    }
  }
  float p[K];
  const float p0 = 1.0f / static_cast<float>(K);
#pragma unroll
  for (int e = 0; e < K; ++e) p[e] = p0;
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    float qp[K], pt[K];
    float pq = 0.0f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < K; ++c) s = fmaf(Q[tri<K>(a, c)], p[c], s);
      qp[a] = s;
      pt[a] = p[a];
    }
#pragma unroll
    for (int a = 0; a < K; ++a) pq = fmaf(p[a], qp[a], pq);
    float sig = 1.0f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float u = coupling_step(sig, pq, qp[t], Q[tri<K>(t, t)]);
      pt[t] += u;
#pragma unroll
      for (int c = t + 1; c < K; ++c) qp[c] = fmaf(u, Q[tri<K>(t, c)], qp[c]);
    }
    const float inv = rcp_sfu(sig);
#pragma unroll
    for (int a = 0; a < K; ++a) p[a] = pt[a] * inv;
  }
  float* o = out + g * K;
#pragma unroll
  for (int e = 0; e < K; ++e) o[e] = p[e];
}

// The group plan's blocks of kCouplingThreads an SM by shape (G, M): where
// a lane's rows of Q pass ~120 registers, the cap (128 registers a thread
// at 4, 170 at 3) that chip_sweep.py found fastest, spills and all; the
// others take what they need.
template <int G, int M>
constexpr int group_min_blocks() {
  if (kGroupMinBlocks > 0) return kGroupMinBlocks;
  if ((G == 4 && M >= 6) || (G == 8 && M == 5) || (G == 16 && M == 4))
    return 3;
  if ((G == 4 && M == 5) || (G == 8 && M == 4) || (G == 16 && M == 3))
    return 4;
  return 1;
}

// "group" (k <= G M): a group of G lanes a problem; class c on lane
// c % G, slot c / G.  A lane holds the rows of Q of its M classes (KP =
// G M columns, zero past k) and their p, p~ and (Qp)~ in registers.  Step
// t takes (Qp)~_t and Q_tt from their owner by __shfl_sync, every lane of
// the group runs the step's scalars, and each updates its own classes.
// Qp = Q p takes k broadcasts of p; pq is an xor-shuffle sum over the
// group (the same bits in every lane).  Problems past the last (a tail
// warp's groups) repeat it and store nothing.
template <int G, int M>
__global__ void __launch_bounds__(kCouplingThreads, group_min_blocks<G, M>())
    pair_coupling_group(const float* __restrict__ dec,
                        const float* __restrict__ platt, long long problems,
                        int n, int k, float* __restrict__ out) {
  constexpr int KP = G * M;
  const int gl = threadIdx.x & (G - 1);
  const long long g0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const long long g = g0 < problems ? g0 : problems - 1;
  const int P = k * (k - 1) / 2;
  const float* d = dec + g * P;
  const float* ab = platt + (g / n) * 2 * P;
  float Q[M][KP], qd[M], p[M];
  const float p0 = 1.0f / static_cast<float>(k);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int a = i * G + gl;
    float dg = 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      float off = 0.0f, term = 0.0f;
      if (a < k && c < k && c != a) q_entry(d, ab, a, c, k, off, term);
      Q[i][c] = off;
      dg += term;
    }
#pragma unroll
    for (int c = 0; c < KP; ++c)
      if (c == a) Q[i][c] = dg;
    qd[i] = dg;
    p[i] = a < k ? p0 : 0.0f;
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    float qp[M], pt[M];
#pragma unroll
    for (int i = 0; i < M; ++i) qp[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      if (c >= k) break;
      const float pc = __shfl_sync(kFull, p[c / G], c % G, G);
#pragma unroll
      for (int i = 0; i < M; ++i) qp[i] = fmaf(Q[i][c], pc, qp[i]);
    }
    float pq = 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      pq = fmaf(p[i], qp[i], pq);
      pt[i] = p[i];
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) pq += __shfl_xor_sync(kFull, pq, o, G);
    float sig = 1.0f;
#pragma unroll
    for (int t = 0; t < KP; ++t) {
      if (t >= k) break;
      const float x = __shfl_sync(kFull, qp[t / G], t % G, G);
      const float qtt = __shfl_sync(kFull, qd[t / G], t % G, G);
      const float u = coupling_step(sig, pq, x, qtt);
      if (gl == t % G) pt[t / G] += u;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (i * G + G - 1 > t) qp[i] = fmaf(u, Q[i][t], qp[i]);
    }
    const float inv = rcp_sfu(sig);
#pragma unroll
    for (int i = 0; i < M; ++i) p[i] = pt[i] * inv;
  }
  if (g0 < problems) {
    float* o = out + g * k;
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i * G + gl < k) o[i * G + gl] = p[i];
  }
}

// Floats of one problem's state in "shared" and "global": Q's k
// rows at an odd stride (a group's column reads hit distinct banks), p, p~
// and (Qp)~.
__host__ __device__ __forceinline__ size_t coupling_mem_floats(int k) {
  return static_cast<size_t>(k) * (k | 1) + 3 * static_cast<size_t>(k);
}

// "shared" and "global" (k past the register groups): a warp a problem
// (G = 32 lanes) as above, its state in its slice of shared memory
// ("shared") or of a global scratch ("global": the grid's warps walk the
// problems); lane gl takes classes gl, gl + G, ...
template <bool kGlobal>
__global__ void __launch_bounds__(kCouplingThreads)
    pair_coupling_mem(const float* __restrict__ dec,
                      const float* __restrict__ platt, long long problems,
                      int n, int k, float* __restrict__ scratch,
                      float* __restrict__ out) {
  constexpr int G = 32;
  const int gl = threadIdx.x & (G - 1);
  const int S = k | 1;
  const size_t per = coupling_mem_floats(k);
  const long long slot =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const long long slots = static_cast<long long>(gridDim.x) * blockDim.x / G;
  float* Q = kGlobal ? scratch + slot * per : p2_smem + (threadIdx.x / G) * per;
  float* p = Q + static_cast<size_t>(k) * S;
  float* pt = p + k;
  float* qp = pt + k;
  const int P = k * (k - 1) / 2;
  for (long long g = slot; g < problems; g += slots) {
    const float* d = dec + g * P;
    const float* ab = platt + (g / n) * 2 * P;
    for (int a = gl; a < k; a += G) {
      float dg = 0.0f;
      for (int c = 0; c < k; ++c) {
        if (c == a) continue;
        float off, term;
        q_entry(d, ab, a, c, k, off, term);
        Q[a * S + c] = off;
        dg += term;
      }
      Q[a * S + a] = dg;
      p[a] = 1.0f / static_cast<float>(k);
    }
    __syncwarp();
    for (int sweep = 0; sweep < kSweeps; ++sweep) {
      float pq = 0.0f;
      for (int a = gl; a < k; a += G) {
        float s = 0.0f;
        for (int c = 0; c < k; ++c) s = fmaf(Q[a * S + c], p[c], s);
        qp[a] = s;
        pt[a] = p[a];
        pq = fmaf(p[a], s, pq);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        pq += __shfl_xor_sync(kFull, pq, o, G);
      __syncwarp();
      float sig = 1.0f;
      for (int t = 0; t < k; ++t) {
        const float u = coupling_step(sig, pq, qp[t], Q[t * S + t]);
        if (gl == t % G) pt[t] += u;
        for (int a = gl + (t + 1 - gl + G - 1) / G * G; a < k; a += G)
          qp[a] = fmaf(u, Q[a * S + t], qp[a]);
        __syncwarp();
      }
      const float inv = rcp_sfu(sig);
      for (int a = gl; a < k; a += G) p[a] = pt[a] * inv;
      __syncwarp();
    }
    for (int a = gl; a < k; a += G) out[g * k + a] = p[a];
    __syncwarp();
  }
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

template <int K>
int launch_reg_k(const float* dec, const float* platt, long long problems,
                 int n, float* out, unsigned grid, cudaStream_t s) {
  pair_coupling_reg<K><<<grid, kCouplingThreads, 0, s>>>(dec, platt,
                                                         problems, n, out);
  return static_cast<int>(cudaGetLastError());
}

// P2's register plan at k (2 <= k <= kRegMaxK).
int launch_reg(const float* dec, const float* platt, long long problems,
               int n, int k, float* out, unsigned grid, cudaStream_t s) {
  switch (k) {
#define P2_REG(K)                                                        \
  case K:                                                                \
    return launch_reg_k<K>(dec, platt, problems, n, out, grid, s);
    P2_REG(2) P2_REG(3) P2_REG(4) P2_REG(5) P2_REG(6) P2_REG(7) P2_REG(8)
    P2_REG(9) P2_REG(10) P2_REG(11) P2_REG(12)
#undef P2_REG
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The first k of the group plan's span i.
constexpr int span_first_k(int i) {
  return i == 0 ? kRegMaxK + 1 : kGroupLastK[i - 1] + 1;
}

// The group plan's lanes a problem for k classes, 0 where none serves k.
int group_lanes(int k) {
  for (int i = 0; i < kGroupSpans; ++i)
    if (k >= span_first_k(i) && k <= kGroupLastK[i]) return kGroupLanes[i];
  return 0;
}

// Span I's group plan at M slots a lane or more: the shapes built are
// those of the span's k alone.
template <int I, int M>
int launch_group_span(const float* dec, const float* platt,
                      long long problems, int n, int k, float* out,
                      unsigned grid, cudaStream_t s) {
  constexpr int G = kGroupLanes[I];
  if ((k + G - 1) / G == M) {
    pair_coupling_group<G, M><<<grid, kCouplingThreads, 0, s>>>(
        dec, platt, problems, n, k, out);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (M < (kGroupLastK[I] + G - 1) / G)
    return launch_group_span<I, M + 1>(dec, platt, problems, n, k, out,
                                       grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// P2's group plan at k, from span I on.
template <int I = 0>
int launch_group(const float* dec, const float* platt, long long problems,
                 int n, int k, float* out, unsigned grid, cudaStream_t s) {
  if constexpr (I < kGroupSpans) {
    constexpr int G = kGroupLanes[I];
    if (k >= span_first_k(I) && k <= kGroupLastK[I])
      return launch_group_span<I, (span_first_k(I) + G - 1) / G>(
          dec, platt, problems, n, k, out, grid, s);
    return launch_group<I + 1>(dec, platt, problems, n, k, out, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
// pair decisions and platt (T, P, 2) float32 (A, B) sigmoids, the pairs in
// lexicographic order.  plan 0 ("registers", 2 <= k <= kRegMaxK): a thread
// a problem; plan 1 ("group", kRegMaxK < k <= kGroupLastK's last):
// group_lanes(k) lanes a problem, the state in registers; plan 2
// ("shared"): a warp a problem, its state in shared memory; plan 3
// ("global"): the same in `scratch`, the grid's warps walking the
// problems.  `threads` a block and `grid` blocks, as svm_proba_kernels.py
// `coupling_plan` picks them.  Returns the launch's error.
int svm_pair_coupling(const float* dec, const float* platt, float* scratch,
                      float* out, int T, int n, int P, int k, int threads,
                      int grid, int plan, void* stream) {
  const long long problems = static_cast<long long>(T) * n;
  const int G = plan == 0 ? 1 : plan == 1 ? group_lanes(k) : 32;
  const size_t smem =
      plan == 2 ? static_cast<size_t>(threads / 32) * coupling_mem_floats(k) * 4
                : 0;
  const long long lanes = problems * G;
  const long long blocks = (lanes + threads - 1) / threads;
  if (T < 1 || n < 1 || k < 2 || P != k * (k - 1) / 2 || threads < 32 ||
      threads > kCouplingThreads || threads % 32 != 0 || smem > kMaxSmem ||
      plan < 0 || plan > 3 || grid < 1 || blocks > 2147483647LL ||
      (plan == 0 && k > kRegMaxK) || G == 0 ||
      (plan <= 1 && grid != blocks) || (plan >= 2 && grid > blocks) ||
      (plan == 3 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  switch (plan) {
    case 0:
      return launch_reg(dec, platt, problems, n, k, out, g, s);
    case 1:
      return launch_group(dec, platt, problems, n, k, out, g, s);
    case 2: {
      static int raised[kMaxDevices] = {};
      const int rc = allow_smem(pair_coupling_mem<false>, smem, raised);
      if (rc != 0) return rc;
      pair_coupling_mem<false><<<g, threads, smem, s>>>(
          dec, platt, problems, n, k, nullptr, out);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      pair_coupling_mem<true><<<g, threads, 0, s>>>(dec, platt, problems, n,
                                                    k, scratch, out);
      return static_cast<int>(cudaGetLastError());
  }
}

}  // extern "C"
