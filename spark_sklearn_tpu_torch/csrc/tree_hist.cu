// The histogram tree grower's device passes, for Hopper (sm_90a).  Built
// with nvcc into a shared library with a plain C interface and loaded with
// ctypes (spark_sklearn_tpu_torch/ops/_build.py); the Python wrappers live
// in spark_sklearn_tpu_torch/ops/tree_kernels.py beside their plain
// PyTorch versions.  Every pass runs over L lanes at once, one tree a
// lane; codes are the (n, d) uint8 bin codes that all lanes share.
//
// Order.  T1 and T4 add every sum in row order, as the plain versions'
// `index_add_` does on the CPU, so they give the CPU path's bits (and the
// same bits launch after launch), with no float atomics.  The order binds
// each cell alone: a (lane, node, feature, bin, stat) sum must see its own
// rows one after another, so its chain is its row count x one dependent
// add (__fadd_rn: never contracted into an FMA; a lane that adds nothing
// never touches the cell).  Cells that share no row run side by side.
//
// G   tree_segments      T1's and T4's grouping: each lane's rows sorted
//     stably by node (`perm`, and `offs` where node slots begin).  A
//     counting sort: a block counts a tile of kGroupTile rows (integer
//     atomics in shared memory), a block a lane scans the counts, and a
//     warp scatters a tile in row order (a row's rank among the batch's
//     rows of its node from ballots over the node id's bits).  Bound:
//     bytes (the node ids read twice, perm written once) and three
//     launches.
//
// T1  tree_level_hist    replaces the level histogram of
//     spark_sklearn_tpu/ops/trees.py:70-84 (`hist`, a jax.ops.segment_sum
//     over (node, feature, bin) ids per stat): per lane, node j, feature f
//     and bin b, the sum over the node's taking-part rows with code b at f
//     of each of the S stats of a row (w h, then w g per output).
//     Design.  A block owns (lane, node) x a tile of `ft` features and
//     holds its histogram in shared memory (ft x n_bins x SP floats; SP is
//     S padded to the vector width VW).  kLoaders threads stage the node's
//     rows, a row each, kRowTile at a time: the 4-byte words that hold the
//     row's ft codes and its S stats, by cp.async into a ring of kStages
//     buffers, two tiles ahead of the adds, the row ids two tiles ahead of
//     that.  A warp a feature (up to kColWarps) decodes the tile's codes
//     to bytes, then takes 32 rows at a time, a row a lane; 8 ballots on
//     the code bits give each lane its group, the rows of the batch that
//     share its cell.  Three ways to add a batch, each in row order:
//     - at most two groups (a one-hot column's batch): lane s walks stat
//       s of the 32 rows into the two cells, held in registers;
//     - every group small (a continuous column's batch): rounds by a
//       lane's rank in its group, a load, an add and a store a round;
//     - else the lowest lane of each group walks the 32 rows and adds its
//       group's, VW stats at a time.
//     Bound.  Bytes at the deep levels: each taking-part row's d codes and
//     S stats read once and the (L, n_nodes, d, n_bins, S) histogram
//     written once (226 MB a lane at 512 nodes, d = 54, S = 8); 48 KB
//     feature tiles keep the writes long and three blocks on an SM.  At
//     the shallow levels the order and the batches: the longest cell
//     chain x the add's latency is the floor (a one-hot column's hot bin
//     holds nearly every row of its node), and a warp's 32-row batches
//     follow one another, a few hundred clocks each.
//
// T2  tree_best_split    replaces trees.py:85-122: per (lane, node), the
//     cumulative sums over the bins, gain = sum over outputs o of
//     GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam), -inf where a side's H
//     is below min_child_weight, at the last bin, and at features outside
//     the node's mask; the first maximum over the flat index f * n_bins +
//     b; split where the best gain > 1e-7.  One block of 8 warps a node;
//     a half-warp takes one feature at a time, a thread 16 consecutive
//     bins: it adds them in order, the 16 threads' totals are scanned in
//     order and added to each block of bins, which is the order XLA's
//     CPU backend gives jnp.cumsum (and the plain version's
//     `cumsum_bins`).  Each operation rounds as the reference's separate
//     float32 operations do (__f*_rn: no contraction into FMA), so the
//     kernel gives the plain version's gains bit for bit, and exact ties
//     go to the smaller flat index as jnp.argmax does.  Bound: bytes
//     (one read of the histogram).
//
// T3  tree_route         replaces trees.py:129-136: one level's routing of
//     every row of every lane (a frozen row stays; a row at a node that
//     does not split freezes; else it moves to 2 node + 1 + (code > bin)).
//     tree_walk          replaces `predict_tree` (trees.py:151-163) and the
//     families' accumulation (models/trees.py:175-177, 257-261, 375-377):
//     a thread walks one row from the root of its lane's tree to a leaf,
//     then writes the leaf's values or adds scale[l] * value to `out`
//     with one rounding (an FMA: XLA contracts the reference's
//     F + lr * live * delta so in its compiled fit).
//     Bound: bytes (codes, node ids, the output rows).
//
// T4  tree_leaf_values   replaces trees.py:142-147: per (lane, node) of the
//     final tree, -sum(w g) / (sum(w h) + lam) over the node's rows (and,
//     with one node a lane, the boosting init's weighted mean).  The
//     wrapper groups rows by final node as for T1.
//     Design.  A warp (a block) a (lane, node); lane s owns stat s's
//     chain.  The warp stages kLeafRows rows at a time into shared memory,
//     stat-major, by cp.async of each row's stats through `perm`, two
//     tiles ahead of the adds (kLeafStages buffers) and the row ids two
//     tiles ahead of their copies; lane s then adds its stat's row of the
//     tile, four rows a 16-byte load.  So the chain is one add a row, and
//     the loads stay off it.  One-warp blocks keep the whole grid
//     resident, so a big node does not wait behind the small ones.
//     Bound: the order, the largest node's rows x the add's latency
//     (bytes, each row's S stats read once, where the nodes are even).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowTile = 128;          // T1: rows a tile, a loader each
constexpr int kLoaders = kRowTile;     // T1: threads that stage rows
constexpr int kStages = 3;             // T1: tiles in shared memory
constexpr int kColWarps = 6;           // T1: feature warps a block, at most
constexpr int kFew = 4;                // T1: groups this small add in rounds
constexpr int kMaxBins = 256;          // T1: uint8 codes
constexpr int kMaxSmem = 232448;       // 227 KB, an H100 block's most
constexpr int kMaxDevices = 64;
constexpr int kSplitWarps = 8;         // T2: warps a block
constexpr int kScanBase = 16;          // T2: XLA's cumsum block (bins)
constexpr int kLeafRows = 128;         // T4: rows a tile
constexpr int kLeafPad = kLeafRows + 4;   // T4: a stat's row of a tile
constexpr int kLeafStages = 3;         // T4: tiles in shared memory
constexpr int kRowThreads = 256;       // T3: threads a block
constexpr int kGroupTile = 2048;       // G: rows a tile
constexpr int kGroupThreads = 256;     // G: threads a counting block
constexpr int kScanThreads = 1024;     // G: threads a scanning block
constexpr int kGroupSmem = 48 * 1024;  // G: shared memory, the default most

template <int VW>
struct VecOf;
template <>
struct VecOf<2> {
  using T = float2;
};
template <>
struct VecOf<4> {
  using T = float4;
};

__device__ __forceinline__ float2 add_rn(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group done
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// n floats from global to shared memory by cp.async, 16 or 8 bytes a copy
// where both ends allow it
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int n) {
  const unsigned a = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst));
  if ((a & 15) == 0 && (n & 3) == 0) {
    for (int k = 0; k < n; k += 4) cp_async16(dst + k, src + k);
  } else if ((a & 7) == 0 && (n & 1) == 0) {
    for (int k = 0; k < n; k += 2) cp_async8(dst + k, src + k);
  } else {
    for (int k = 0; k < n; ++k) cp_async4(dst + k, src + k);
  }
}

// T1: one warp adds the staged rows [0, cnt) of feature fi into the
// block's histogram, every stat.  A row's codes are the 4-byte words `cw`
// (W a row) that hold them, from byte `ob[r]` of its first word on; `st`
// the rows' stats (SP floats a row), `hf` the feature's (n_bins, SP) tile,
// `cb` the warp's kRowTile bytes for the feature's codes.  32 rows a
// batch, a row a lane.  A lane's group, the rows of the batch that share
// its code, comes from 8 ballots (one a code bit); then:
// - at most two groups (a one-hot column's batch): lane s walks stat s of
//   the 32 rows in order into the two cells, held in registers;
// - every group small: lanes add their own rows in rounds by their rank
//   in their group (round k: each group's k-th row), so each cell sees its
//   rows in order;
// - else the lowest lane of each group walks the rows in order and adds
//   those of its group, VW stats at a time.
template <int VW>
__device__ __forceinline__ void add_feature(const uint32_t* cw,
                                            const uint8_t* ob, int W, int fi,
                                            const float* st, float* hf,
                                            uint8_t* cb, int cnt, int SP,
                                            int ln) {
  using V = typename VecOf<VW>::T;
#pragma unroll
  for (int k = 0; k < kRowTile / 32; ++k) {        // the tile's codes
    const int r = ln + 32 * k;
    const int o = ob[r] + fi;
    cb[r] = static_cast<uint8_t>(cw[r * W + (o >> 2)] >> ((o & 3) * 8));
  }
  __syncwarp();
  const unsigned below = (1u << ln) - 1;           // lanes before this one
  for (int r0 = 0; r0 < cnt; r0 += 32) {
    const int left = cnt - r0;
    const bool has = ln < left;
    const unsigned valid = left >= 32 ? kFull : (1u << left) - 1;
    const int code = cb[r0 + ln];
    unsigned grp = valid;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool bit = (code >> k) & 1;
      const unsigned b = __ballot_sync(kFull, bit);
      grp &= bit ? b : ~b;
    }
    if (!has) grp = 1u << ln;                      // a group of its own
    const bool lead = has && (grp & below) == 0;
    const float* rows = st + r0 * SP;
    if (__popc(__ballot_sync(kFull, lead)) <= 2) {
      // lane 0's group and the rest: two cells, lane s a stat
      const unsigned ma = __shfl_sync(kFull, grp, 0);
      const unsigned mb = valid & ~ma;
      const int ca = __shfl_sync(kFull, code, 0);
      const int cbk = __shfl_sync(kFull, code, mb ? __ffs(mb) - 1 : 0);
      for (int s = ln; s < SP; s += 32) {
        float* pa = hf + ca * SP + s;
        float* pb = hf + cbk * SP + s;
        float acc_a = *pa;
        float acc_b = *pb;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = rows[j * SP + s];
          if ((ma >> j) & 1u) acc_a = __fadd_rn(acc_a, x);
          if ((mb >> j) & 1u) acc_b = __fadd_rn(acc_b, x);
        }
        *pa = acc_a;
        if (mb) *pb = acc_b;
      }
      __syncwarp();
      continue;
    }
    const int size = __popc(grp);
    const int steps = __reduce_max_sync(kFull, size);
    float* cell = hf + code * SP;
    if (steps <= kFew) {
      const int rank = __popc(grp & below);
      const float* mine = rows + ln * SP;
      V* c0 = reinterpret_cast<V*>(cell);
      V* c1 = reinterpret_cast<V*>(cell + VW);
      const V m0 = *reinterpret_cast<const V*>(mine);
      if (SP == VW) {
        for (int k = 0; k < steps; ++k) {
          if (has && rank == k) *c0 = add_rn(*c0, m0);
          __syncwarp();
        }
      } else if (SP == 2 * VW) {
        const V m1 = *reinterpret_cast<const V*>(mine + VW);
        for (int k = 0; k < steps; ++k) {
          if (has && rank == k) {
            const V a0 = *c0;
            const V a1 = *c1;
            *c0 = add_rn(a0, m0);
            *c1 = add_rn(a1, m1);
          }
          __syncwarp();
        }
      } else {
        for (int k = 0; k < steps; ++k) {
          if (has && rank == k) {
            for (int g = 0; g < SP; g += VW) {
              V* c = reinterpret_cast<V*>(cell + g);
              *c = add_rn(*c, *reinterpret_cast<const V*>(mine + g));
            }
          }
          __syncwarp();
        }
      }
    } else {
      for (int g = 0; g < SP; g += VW) {
        V* c = reinterpret_cast<V*>(cell + g);
        V acc = *c;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const V x = *reinterpret_cast<const V*>(rows + j * SP + g);
          if ((grp >> j) & 1u) acc = add_rn(acc, x);
        }
        if (lead) *c = acc;
      }
      __syncwarp();
    }
  }
}

// T1: one (lane, node) x feature tile a block.  The first `cw` warps add
// features, a warp each; the last kLoaders threads stage rows, a row each: its code
// words and stats by cp.async into a ring of kStages buffers, two tiles
// ahead of the adds, and its row id two tiles ahead of that.
template <int VW>
__global__ void __launch_bounds__(kColWarps * 32 + kLoaders, 3)
level_hist(const uint8_t* __restrict__ codes, const int* __restrict__ perm,
           const int* __restrict__ offs, const float* __restrict__ stats,
           float* __restrict__ hist, int n, int d, int n_nodes, int n_bins,
           int S, int ft, int cwarps) {
  extern __shared__ float4 smem4[];
  const int SP = (S + VW - 1) / VW * VW;
  const int W = (ft + 2) / 4 + 1;                  // code words a row
  const int seg = blockIdx.x;                      // lane * n_nodes + node
  const int lane = seg / n_nodes;
  const int node = seg - lane * n_nodes;
  const int f0 = blockIdx.y * ft;
  const int nft = min(ft, d - f0);
  const int fstride = n_bins * SP;
  // shared memory, each part from a 16-byte boundary: the histogram (ft x
  // n_bins x SP), then per stage the stats (kRowTile x SP), the code
  // words (kRowTile x W), the rows' first code bytes; then kRowTile code
  // bytes a feature warp
  float* const h = reinterpret_cast<float*>(smem4);
  float* const st0 = h + (ft * fstride + 3) / 4 * 4;
  uint32_t* const cw0 =
      reinterpret_cast<uint32_t*>(st0 + kStages * kRowTile * SP);
  uint8_t* const ob0 =
      reinterpret_cast<uint8_t*>(cw0 + kStages * kRowTile * W);
  uint8_t* const cb0 = ob0 + kStages * kRowTile;
  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int loader0 = cwarps * 32;
  const int total = ft * fstride;
  for (int i = tid; i < total / 4; i += nth)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = total / 4 * 4 + tid; i < total; i += nth) h[i] = 0.0f;

  const int slot = lane * (n_nodes + 1) + node;
  const int lo = offs[slot];
  const int hi = offs[slot + 1];
  const long long base = static_cast<long long>(lane) * n;
  const int lt = tid - loader0;                    // this loader's row
  auto fetch = [&](int t) {
    const int i = lo + t * kRowTile + lt;
    return i < hi ? perm[i] : -1;
  };
  auto issue = [&](int t, int p) {                 // tile t's copies
    const int b = t % kStages;
    if (p >= 0) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(
          codes + ((p - base) * d + f0));
      const int o = static_cast<int>(at & 3);
      ob0[b * kRowTile + lt] = static_cast<uint8_t>(o);
      const float* wsrc = reinterpret_cast<const float*>(at - o);
      float* wdst = reinterpret_cast<float*>(cw0 + (b * kRowTile + lt) * W);
      for (int k = 0; k <= (o + nft - 1) >> 2; ++k)
        cp_async4(wdst + k, wsrc + k);
      copy_row(st0 + (b * kRowTile + lt) * SP,
               stats + static_cast<long long>(p) * S, S);
    }
    cp_async_commit();
  };
  // a loader's row ids of tiles t+2 and t+3: the tile loop runs in
  // pairs, so each id is read two tiles after its load was issued
  int pa = -1, pb = -1;
  if (lt >= 0) {
    pa = fetch(0);
    pb = fetch(1);
    issue(0, pa);
    issue(1, pb);
    pa = fetch(2);
    pb = fetch(3);
  }
  const int tiles = (hi - lo + kRowTile - 1) / kRowTile;
  const int ln = tid & 31;
  auto step = [&](int t, int& p) {
    if (lt >= 0) cp_async_wait_prev();             // tile t is in
    __syncthreads();                               // ... for all; t-1 read
    if (lt >= 0) {
      issue(t + 2, p);
      p = fetch(t + 4);
    } else {
      const int b = t % kStages;
      const int cnt = min(kRowTile, hi - lo - t * kRowTile);
      for (int fi = tid >> 5; fi < nft; fi += cwarps)
        add_feature<VW>(cw0 + b * kRowTile * W, ob0 + b * kRowTile, W, fi,
                        st0 + b * kRowTile * SP, h + fi * fstride,
                        cb0 + (tid >> 5) * kRowTile, cnt, SP, ln);
    }
  };
  for (int t = 0; t < tiles; t += 2) {
    step(t, pa);
    if (t + 1 < tiles) step(t + 1, pb);
  }
  if (lt >= 0) cp_async_wait_all();
  __syncthreads();
  float* dst = hist + (static_cast<size_t>(seg) * d + f0) * n_bins * S;
  const int out = nft * n_bins * S;
  if (SP == S && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < out / 4; i += nth) d4[i] = smem4[i];
    for (int i = out / 4 * 4 + tid; i < out; i += nth) dst[i] = h[i];
  } else {
    for (int i = tid; i < out; i += nth) {
      const int cell = i / S;                      // f * n_bins + b
      dst[i] = h[cell * SP + (i - cell * S)];
    }
  }
}

// T2 helper: the cumulative sums of stat s over one feature's (n_bins, S)
// block, in XLA's CPU order (jnp.cumsum: in order within blocks of 16
// bins, then the blocks' totals in order, added to each block).  Thread t
// of a half-warp holds bins 16t .. 16t + 15 in c (t < m = n_bins / 16);
// returns the sum over all bins (the last cumulative sum, as cum[-1]).
__device__ __forceinline__ float scan_bins(const float* __restrict__ hf,
                                           int t, int m, int S, int s,
                                           bool valid,
                                           float (&c)[kScanBase]) {
  const bool mine = valid && t < m;
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < kScanBase; ++j) {
    const float x =
        mine ? __ldg(hf + static_cast<size_t>(t * kScanBase + j) * S + s)
             : 0.0f;
    run = j == 0 ? x : __fadd_rn(run, x);
    c[j] = run;
  }
  // the blocks' totals, scanned in order: thread k adds its total to
  // thread k-1's running sum, one thread a step
  float pre = run;
  for (int k = 1; k < m; ++k) {
    const float up = __shfl_sync(kFull, pre, k - 1, kScanBase);
    if (t == k) pre = __fadd_rn(up, run);
  }
  float before = __shfl_sync(kFull, pre, t > 0 ? t - 1 : 0, kScanBase);
  if (m > 1) {
    if (t == 0) before = 0.0f;
#pragma unroll
    for (int j = 0; j < kScanBase; ++j) c[j] = __fadd_rn(c[j], before);
  }
  return __shfl_sync(kFull, c[kScanBase - 1], m - 1, kScanBase);
}

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

// T2: one (lane, node) a block; a half-warp a feature at a time.
__global__ void __launch_bounds__(kSplitWarps * 32)
best_split(const float* __restrict__ hist, const bool* __restrict__ fmask,
           int* __restrict__ feat, int* __restrict__ thr,
           float* __restrict__ gain_out, bool* __restrict__ split,
           int n_nodes, int d, int n_bins, int S, float lam, float mcw) {
  __shared__ float wg[kSplitWarps];
  __shared__ int wi[kSplitWarps];
  const int seg = blockIdx.x;
  const int node = seg % n_nodes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int t = lane & (kScanBase - 1);
  const int m = n_bins / kScanBase;
  const size_t fstride = static_cast<size_t>(n_bins) * S;
  const float* hs = hist + static_cast<size_t>(seg) * d * fstride;
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  float lh[kScanBase], lg[kScanBase], gain[kScanBase];
  // both halves of a warp run the same trip count (the scans shuffle)
  for (int fb = 2 * warp; fb < d; fb += 2 * kSplitWarps) {
    const int f = fb + half;
    const bool valid = f < d;
    const float* hf = hs + (valid ? f : 0) * fstride;
    const float tot_h = scan_bins(hf, t, m, S, 0, valid, lh);
    const float tot_term_h = __fadd_rn(tot_h, lam);
#pragma unroll
    for (int j = 0; j < kScanBase; ++j) gain[j] = 0.0f;
    for (int o = 1; o < S; ++o) {
      const float tot_g = scan_bins(hf, t, m, S, o, valid, lg);
      const float t3 = __fdiv_rn(__fmul_rn(tot_g, tot_g), tot_term_h);
#pragma unroll
      for (int j = 0; j < kScanBase; ++j) {
        const float rh = __fsub_rn(tot_h, lh[j]);
        const float rg = __fsub_rn(tot_g, lg[j]);
        const float t1 = __fdiv_rn(__fmul_rn(lg[j], lg[j]),
                                   __fadd_rn(lh[j], lam));
        const float t2 = __fdiv_rn(__fmul_rn(rg, rg), __fadd_rn(rh, lam));
        gain[j] = __fadd_rn(gain[j], __fsub_rn(__fadd_rn(t1, t2), t3));
      }
    }
    if (!valid || t >= m) continue;
    const bool masked = fmask != nullptr && !fmask[node * d + f];
#pragma unroll
    for (int j = 0; j < kScanBase; ++j) {
      const int b = t * kScanBase + j;
      const float rh = __fsub_rn(tot_h, lh[j]);
      const bool ok = lh[j] >= mcw && rh >= mcw && b != n_bins - 1 &&
                      !masked;
      const float g = ok ? gain[j] : -INFINITY;
      const int idx = f * n_bins + b;
      if (better(g, idx, best, best_i)) {
        best = g;
        best_i = idx;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, best_i, off);
    if (better(og, oi, best, best_i)) {
      best = og;
      best_i = oi;
    }
  }
  if (lane == 0) {
    wg[warp] = best;
    wi[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSplitWarps; ++w) {
      if (better(wg[w], wi[w], best, best_i)) {
        best = wg[w];
        best_i = wi[w];
      }
    }
    feat[seg] = best_i / n_bins;
    thr[seg] = best_i % n_bins;
    gain_out[seg] = best;
    split[seg] = best > 1e-7f;
  }
}

// T3, routing: one row of one lane a thread.
__global__ void route_rows(const uint8_t* __restrict__ codes,
                           int* __restrict__ node, bool* __restrict__ frozen,
                           const int* __restrict__ sf,
                           const int* __restrict__ sb, int L, int n, int d,
                           int N, int offset) {
  const long long total = static_cast<long long>(L) * n;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (frozen[i]) continue;
    const int l = static_cast<int>(i / n);
    const long long r = i - static_cast<long long>(l) * n;
    const int v = node[i];
    const int j = l * N + (v - offset);
    const int f = sf[j];
    if (f < 0) {
      frozen[i] = true;
    } else {
      node[i] = 2 * v + 1 + (codes[r * d + f] > sb[j] ? 1 : 0);
    }
  }
}

// T3, walk: one row of one lane a thread, root to leaf; then the leaf's
// values into `out`, or scale[l] * value added to it.
__global__ void walk_rows(const uint8_t* __restrict__ codes,
                          const int* __restrict__ feat,
                          const int* __restrict__ thr,
                          const bool* __restrict__ leaf,
                          const float* __restrict__ value,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int L, int n, int d, int M,
                          int n_out, int depth) {
  const long long total = static_cast<long long>(L) * n;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int l = static_cast<int>(i / n);
    const long long r = i - static_cast<long long>(l) * n;
    const int* fl = feat + static_cast<size_t>(l) * M;
    const int* tl = thr + static_cast<size_t>(l) * M;
    const bool* ll = leaf + static_cast<size_t>(l) * M;
    int v = 0;
    for (int k = 0; k < depth; ++k) {
      const int f = fl[v];
      if (ll[v] || f < 0) break;
      v = 2 * v + 1 + (codes[r * d + f] > tl[v] ? 1 : 0);
    }
    const float* val = value + (static_cast<size_t>(l) * M + v) * n_out;
    float* o = out + i * n_out;
    if (scale != nullptr) {
      const float sc = scale[l];
      for (int q = 0; q < n_out; ++q)
        o[q] = __fmaf_rn(sc, val[q], o[q]);
    } else {
      for (int q = 0; q < n_out; ++q) o[q] = val[q];
    }
  }
}

// T4: one (lane, node) a block of one warp; lane s adds stat s0 + s of
// every row of the node in row order.  Tiles of kLeafRows rows go through
// kLeafStages shared-memory buffers (stat-major, a stat's row padded to
// kLeafPad floats), filled by cp.async through `perm`, two tiles ahead of
// the adds; the row ids are read two tiles ahead of their copies.
__global__ void __launch_bounds__(32)
leaf_sums(const int* __restrict__ perm, const int* __restrict__ offs,
          const float* __restrict__ stats, float* __restrict__ value,
          int n_nodes, int S, float lam) {
  extern __shared__ float4 leaf4[];
  float* sm = reinterpret_cast<float*>(leaf4);
  const int seg = blockIdx.x;
  const int ln = threadIdx.x;
  const int l = seg / n_nodes;
  const int slot = l * (n_nodes + 1) + (seg - l * n_nodes);
  const int a = offs[slot];
  const int b = offs[slot + 1];
  const int sw_max = min(S, 32);
  constexpr int kPer = kLeafRows / 32;             // rows a lane copies
  float sum_h = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int sw = min(32, S - s0);
    float acc = 0.0f;
    int pa[kPer], pb[kPer];                // row ids of tiles t+2, t+3
    auto fetch = [&](int t, int (&pn)[kPer]) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = a + t * kLeafRows + ln + 32 * k;
        pn[k] = i < b ? perm[i] : -1;
      }
    };
    auto issue = [&](int t, const int (&pn)[kPer]) {   // one group
      float* buf = sm + (t % kLeafStages) * sw_max * kLeafPad;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int p = pn[k];
        if (p < 0) continue;
        const float* src = stats + static_cast<long long>(p) * S + s0;
        float* dst = buf + ln + 32 * k;
        for (int j = 0; j < sw; ++j) cp_async4(dst + j * kLeafPad, src + j);
      }
      cp_async_commit();
    };
    const int tiles = (b - a + kLeafRows - 1) / kLeafRows;
    fetch(0, pa);
    fetch(1, pb);
    issue(0, pa);
    issue(1, pb);
    fetch(2, pa);
    fetch(3, pb);
    // tile t: wait for it, issue tile t+2 from the ids in pn and load
    // tile t+4's ids into pn, then add tile t
    auto step = [&](int t, int (&pn)[kPer]) {
      cp_async_wait_prev();              // tile t is in
      __syncwarp();                      // ... for every lane; t-1 read
      issue(t + 2, pn);
      fetch(t + 4, pn);
      const int cnt = min(kLeafRows, b - a - t * kLeafRows);
      if (ln < sw) {
        const float* row =
            sm + (t % kLeafStages) * sw_max * kLeafPad + ln * kLeafPad;
        // a stat's row holds kLeafRows floats: 8 loads of 4 rows never
        // leave it; rows past cnt are read but not added
        for (int r = 0; r < cnt; r += 32) {
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = reinterpret_cast<const float4*>(row + r)[u];
          const int left = cnt - r;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (4 * u < left) acc = __fadd_rn(acc, v[u].x);
            if (4 * u + 1 < left) acc = __fadd_rn(acc, v[u].y);
            if (4 * u + 2 < left) acc = __fadd_rn(acc, v[u].z);
            if (4 * u + 3 < left) acc = __fadd_rn(acc, v[u].w);
          }
        }
      }
    };
    for (int t = 0; t < tiles; t += 2) {
      step(t, pa);
      if (t + 1 < tiles) step(t + 1, pb);
    }
    cp_async_wait_all();
    __syncwarp();
    if (s0 == 0) sum_h = __shfl_sync(kFull, acc, 0);
    const int s = s0 + ln;
    if (s >= 1 && ln < sw)
      value[static_cast<size_t>(seg) * (S - 1) + (s - 1)] =
          __fdiv_rn(-acc, __fadd_rn(sum_h, lam));
  }
}

// G: T1's and T4's grouping, a stable counting sort of each lane's rows by
// node key (local, or n_nodes for a row that takes no part): counts a
// tile of rows, a scan a lane, then a scatter a tile in row order.

// G, count: keys of tile t (kGroupTile rows) of lane l into counts[(l *
// tiles + t) * W + key], W = n_nodes + 1 (integer atomics in shared
// memory).
__global__ void __launch_bounds__(kGroupThreads)
group_count(const int* __restrict__ local, int* __restrict__ counts, int n,
            int n_nodes, int tiles) {
  extern __shared__ int cnt_s[];
  const int W = n_nodes + 1;
  const int t = blockIdx.x;
  const int l = blockIdx.y;
  for (int j = threadIdx.x; j < W; j += blockDim.x) cnt_s[j] = 0;
  __syncthreads();
  const int* lr = local + static_cast<long long>(l) * n;
  const int r1 = min(n, (t + 1) * kGroupTile);
  for (int r = t * kGroupTile + threadIdx.x; r < r1; r += blockDim.x) {
    const int v = lr[r];
    atomicAdd(&cnt_s[v >= 0 && v < n_nodes ? v : n_nodes], 1);
  }
  __syncthreads();
  int* out = counts + (static_cast<long long>(l) * tiles + t) * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) out[j] = cnt_s[j];
}

// G, scan: one block a lane.  offs[l * W + j] = l * n + the lane's rows of
// keys below j; bases[(l * tiles + t) * W + j] = where tile t's first row
// of key j goes (offs + the earlier tiles' rows of key j).
__global__ void __launch_bounds__(kScanThreads)
group_scan(const int* __restrict__ counts, int* __restrict__ bases,
           int* __restrict__ offs, int n, int n_nodes, int tiles, int L) {
  extern __shared__ int tot[];                     // W: a key's rows, then
  __shared__ int warp_sum[kScanThreads / 32];      // where they begin
  const int W = n_nodes + 1;
  const int l = blockIdx.x;
  const int* c = counts + static_cast<long long>(l) * tiles * W;
  int* bs = bases + static_cast<long long>(l) * tiles * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    int sum = 0;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) sum += c[t * W + j];
    tot[j] = sum;
  }
  __syncthreads();
  // exclusive scan of tot over the keys: a chunk a thread, then the
  // threads' sums across the block
  const int per = (W + blockDim.x - 1) / blockDim.x;
  const int j0 = threadIdx.x * per;
  int sum = 0;
  for (int k = 0; k < per && j0 + k < W; ++k) sum += tot[j0 + k];
  const int ln = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) warp_sum[wp] = x;
  __syncthreads();
  int run = static_cast<int>(static_cast<long long>(l) * n) + x - sum;
  for (int w = 0; w < wp; ++w) run += warp_sum[w];
  for (int k = 0; k < per && j0 + k < W; ++k) {
    const int v = tot[j0 + k];
    tot[j0 + k] = run;
    run += v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    int at = tot[j];
    offs[l * W + j] = at;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) {
      bs[t * W + j] = at;
      at += c[t * W + j];
    }
  }
  if (l == L - 1 && threadIdx.x == 0)
    offs[L * W] = static_cast<int>(static_cast<long long>(L) * n);
}

// G, scatter: one warp a tile of a lane, its rows in order, 32 at a time:
// a lane's rank among the batch's rows of its key (ballots over the key's
// `bits` bits) after where its key's rows go so far.
__global__ void __launch_bounds__(32)
group_scatter(const int* __restrict__ local, const int* __restrict__ bases,
              int* __restrict__ perm, int n, int n_nodes, int tiles,
              int bits) {
  extern __shared__ int grp_s[];                   // W bases, then keys
  const int W = n_nodes + 1;
  int* base = grp_s;
  int* keys = grp_s + W;
  const int t = blockIdx.x;
  const int l = blockIdx.y;
  const int ln = threadIdx.x;
  const int r0 = t * kGroupTile;
  const int rows = min(n - r0, kGroupTile);
  const int* lr = local + static_cast<long long>(l) * n + r0;
  for (int i = ln; i < rows; i += 32)
    cp_async4(reinterpret_cast<float*>(keys + i),
              reinterpret_cast<const float*>(lr + i));
  cp_async_commit();
  const int* c = bases + (static_cast<long long>(l) * tiles + t) * W;
  for (int j = ln; j < W; j += 32) base[j] = c[j];
  cp_async_wait_all();
  __syncwarp();
  const unsigned below = (1u << ln) - 1;
  const int flat = static_cast<int>(static_cast<long long>(l) * n) + r0;
  for (int b = 0; b < rows; b += 32) {
    const int r = b + ln;
    const bool has = r < rows;
    const int v = has ? keys[r] : 0;
    const int key = v >= 0 && v < n_nodes ? v : n_nodes;
    unsigned grp = __ballot_sync(kFull, has);
    for (int k = 0; k < bits; ++k) {
      const bool bit = (key >> k) & 1;
      const unsigned m = __ballot_sync(kFull, bit);
      grp &= bit ? m : ~m;
    }
    const int pos = base[key] + __popc(grp & below);
    __syncwarp();
    if (has) {
      perm[pos] = flat + r;
      if ((grp >> ln) == 1u) base[key] = pos + 1;  // the group's last row
    }
    __syncwarp();
  }
}

// T1 and T4 may take more than the default 48 KB of dynamic shared
// memory; the limit is raised once a device, not on every launch.
template <typename Kernel>
int allow_smem(Kernel kernel, int slot) {
  static bool raised[3][kMaxDevices] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < kMaxDevices && raised[slot][dev]) return 0;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  if (rc == 0 && dev < kMaxDevices) raised[slot][dev] = true;
  return rc;
}

// T1's dynamic shared memory at ft features, S stats padded to SP and cw
// feature warps (level_hist's layout; tree_kernels.py `hist_plan`).
long long hist_smem(int ft, int n_bins, int SP, int cw) {
  const long long words = (ft + 2) / 4 + 1;
  return 4LL * ((static_cast<long long>(ft) * n_bins * SP + 3) / 4 * 4) +
         kStages * kRowTile * (4LL * SP + 4 * words + 1) +
         static_cast<long long>(cw) * kRowTile;
}

int row_blocks(long long total) {
  const long long b = (total + kRowThreads - 1) / kRowThreads;
  return static_cast<int>(b < (1 << 20) ? (b > 0 ? b : 1) : (1 << 20));
}

}  // namespace

extern "C" {

// T1.  perm (L*n) holds flat row ids lane * n + row grouped by (lane,
// node); node j of lane l holds perm[offs[l*(n_nodes+1)+j] ..
// offs[l*(n_nodes+1)+j+1]).  hist (L, n_nodes, d, n_bins, S) out.  ft
// features a block, vector width vw (2 or 4), cw feature warps and `smem`
// bytes of dynamic shared memory, as tree_kernels.py `hist_plan` chooses
// them.  Returns cudaGetLastError() of the launch (0 = launched).
int tree_level_hist(const uint8_t* codes, const int* perm, const int* offs,
                    const float* stats, float* hist, int n, int d, int L,
                    int n_nodes, int n_bins, int S, int ft, int vw, int cw,
                    int smem, void* stream) {
  if (n < 1 || d < 1 || L < 1 || n_nodes < 1 || n_bins < 1 ||
      n_bins > kMaxBins || S < 1 || ft < 1 || (vw != 2 && vw != 4) ||
      cw < 1 || cw > kColWarps || smem > kMaxSmem ||
      smem < hist_smem(ft, n_bins, (S + vw - 1) / vw * vw, cw))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(L * n_nodes, (d + ft - 1) / ft);
  const int threads = cw * 32 + kLoaders;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (vw == 2) {
    rc = allow_smem(level_hist<2>, 0);
    if (rc != 0) return rc;
    level_hist<2><<<grid, threads, smem, s>>>(codes, perm, offs, stats, hist,
                                              n, d, n_nodes, n_bins, S, ft,
                                              cw);
  } else {
    rc = allow_smem(level_hist<4>, 1);
    if (rc != 0) return rc;
    level_hist<4><<<grid, threads, smem, s>>>(codes, perm, offs, stats, hist,
                                              n, d, n_nodes, n_bins, S, ft,
                                              cw);
  }
  return static_cast<int>(cudaGetLastError());
}

// T2.  hist (L, N, d, n_bins, S); fmask (N, d) or null; feat, thr, gain,
// split (L, N) out.  n_bins a multiple of 16 up to 256.
int tree_best_split(const float* hist, const bool* fmask, int* feat,
                    int* thr, float* gain, bool* split, int L, int N, int d,
                    int n_bins, int S, float lam, float mcw, void* stream) {
  if (L < 1 || N < 1 || d < 1 || S < 1 || n_bins < kScanBase ||
      n_bins % kScanBase || n_bins > kScanBase * kScanBase)
    return static_cast<int>(cudaErrorInvalidValue);
  best_split<<<L * N, kSplitWarps * 32, 0, static_cast<cudaStream_t>(
      stream)>>>(hist, fmask, feat, thr, gain, split, N, d, n_bins, S, lam,
                 mcw);
  return static_cast<int>(cudaGetLastError());
}

// T3, routing.  node (L, n) and frozen (L, n) in place; sf, sb (L, N): the
// level's split feature (-1: no split) and bin; offset = N - 1.
int tree_route(const uint8_t* codes, int* node, bool* frozen, const int* sf,
               const int* sb, int L, int n, int d, int N, int offset,
               void* stream) {
  if (L < 1 || n < 1 || d < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  route_rows<<<row_blocks(static_cast<long long>(L) * n), kRowThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(codes, node, frozen, sf,
                                                    sb, L, n, d, N, offset);
  return static_cast<int>(cudaGetLastError());
}

// T3, walk.  A tree's feat, thr, leaf (L, M) and value (L, M, n_out); out
// (L, n, n_out) gets the leaf values (scale null) or scale[l] * value
// added.
int tree_walk(const uint8_t* codes, const int* feat, const int* thr,
              const bool* leaf, const float* value, const float* scale,
              float* out, int L, int n, int d, int M, int n_out, int depth,
              void* stream) {
  if (L < 1 || n < 1 || d < 1 || M < 1 || n_out < 1 || depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  walk_rows<<<row_blocks(static_cast<long long>(L) * n), kRowThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      codes, feat, thr, leaf, value, scale, out, L, n, d, M, n_out, depth);
  return static_cast<int>(cudaGetLastError());
}

// T4.  perm, offs as T1's, grouped by final node; value (L, n_nodes, S-1)
// out; `smem` bytes of dynamic shared memory, as tree_kernels.py
// `leaf_plan` chooses them.
int tree_leaf_values(const int* perm, const int* offs, const float* stats,
                     float* value, int L, int n, int n_nodes, int S,
                     float lam, int smem, void* stream) {
  if (L < 1 || n < 1 || n_nodes < 1 || S < 2 || smem > kMaxSmem ||
      smem < kLeafStages * (S < 32 ? S : 32) * kLeafPad * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem(leaf_sums, 2);
  if (rc != 0) return rc;
  leaf_sums<<<L * n_nodes, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      perm, offs, stats, value, n_nodes, S, lam);
  return static_cast<int>(cudaGetLastError());
}

// G.  local (L, n) int32 node ids (< 0: no part); perm (L*n) and offs
// (L*(n_nodes+1)+1) out, as tree_kernels.py `segments` gives them; counts
// (2, L, tiles, n_nodes+1) int32 scratch (the counts, then the bases),
// tiles = ceil(n / kGroupTile).
int tree_segments(const int* local, int* perm, int* offs, int* counts, int L,
                  int n, int n_nodes, void* stream) {
  const long long W = static_cast<long long>(n_nodes) + 1;
  const long long smem = 4 * (W + kGroupTile);     // the most of the three
  if (L < 1 || n < 1 || n_nodes < 1 || smem > kGroupSmem ||
      static_cast<long long>(L) * n >= (1LL << 31) ||
      static_cast<long long>(L) * W >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int bits = 0;
  while ((1LL << bits) < W) ++bits;
  const int tiles = (n + kGroupTile - 1) / kGroupTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  group_count<<<dim3(tiles, L), kGroupThreads, 4 * W, s>>>(local, counts, n,
                                                         n_nodes, tiles);
  int* bases = counts + static_cast<long long>(L) * tiles * W;
  group_scan<<<L, kScanThreads, 4 * W, s>>>(counts, bases, offs, n, n_nodes,
                                            tiles, L);
  group_scatter<<<dim3(tiles, L), 32, smem, s>>>(local, bases, perm, n,
                                                 n_nodes, tiles, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
