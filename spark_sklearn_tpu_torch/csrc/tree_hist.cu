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
//     b; split where the best gain > 1e-7.
//     Order.  Each 16-bin block is summed in order, then the blocks'
//     totals in order, added to each block: the order XLA's CPU backend
//     gives jnp.cumsum (and the plain version's `cumsum_bins`).  Each
//     operation rounds as the reference's separate float32 operations do
//     (__f*_rn: no contraction into FMA), so the gains are the plain
//     version's bit for bit.  The maximum compares (gain, then the smaller
//     flat index), which no combining order changes; where no gain is
//     finite the answer is flat index 0, as argmax gives over all -inf.
//     Design.  The work is a (lane, node, kept feature): a block reads the
//     node's mask row first and never touches a masked feature's block
//     (the RF classifier keeps 7 of 54).  A feature's (n_bins, S) block is
//     contiguous; a group of whole warps stages it whole into shared
//     memory by cp.async (16 bytes a copy where S allows), a round or two
//     ahead of the one being scanned, in rows of rk = S (mod 32) floats a
//     16-bin block, so that the in-block scan, a thread a (block, stat),
//     reads 32 banks a warp; the blocks' totals are a 16-add chain a stat,
//     and a thread a bin computes the gains.  A block runs G groups (G
//     features a round: 2 at S = 8, 8 at S = 2), so a round's barriers and
//     chains serve G features.  Where few (lane, node)s fill the card (the
//     roots), a cluster of up to 8 blocks shares one's features and its
//     first block combines their maxima through distributed shared memory.
//     Bound: bytes, the kept features' blocks read once (and the mask).
//
// T3  tree_route         replaces trees.py:123-136 and :139 (the level's
//     heap writes, its routing and the final is_leaf scatter), the
//     reference's `predict_tree` (:151-163) and the families' accumulation
//     (models/trees.py:175-177, 257-261, 375-377).  Three entry points,
//     one count:
//     tree_level_step    one launch a level.  From T2's (feat, bin, split)
//     it writes the heap's feat (the feature or -1), thr and leaf for the
//     level's nodes; moves every row at a splitting node of the level to
//     2 node + 1 + (code > bin) (a frozen row, one at a shallower node,
//     stays; a row at a node that does not split stops there); and
//     writes the next level's keys for G (node - next offset, -1 where the
//     row stopped or is inactive).  At the last level the keys are T4's
//     (node, -1 where inactive) and leaf is set at every row's node.
//     tree_add_leaves    out += scale[l] * value[l, node[l, r]], from the
//     grower's final nodes: the fit's update needs no walk (the proof is
//     in ops/trees.py's docstring).
//     tree_walk          `predict_tree` for other codes: each row from the
//     root to a leaf, then its values, or scale[l] * value added to `out`
//     (__fmaf_rn: one rounding, as XLA contracts F + lr * live * delta in
//     the reference's compiled fit).
//     Design.  A block owns a group of lanes and a tile of kRowThreads
//     rows, a row a thread: the tile's codes are staged once in shared
//     memory by 16-byte copies (where 256 d bytes fit) and serve every
//     lane of the block, so a row's codes are read once for its lanes,
//     not once a lane; node, active and the keys are read and written
//     coalesced, a lane after another.  The level's splits (the walk: the
//     lanes' whole trees) sit in shared memory packed a word a node
//     (pack_node), so the walk's depth-long chain is two shared-memory
//     loads a level and no global load; the walk interleaves two lanes.
//     The heap's level is written by the threads of the first row tile's
//     blocks, a node a thread; the last level's scatter marks a flag a
//     node in shared memory and a block writes its flags once.
//     Bound: bytes (codes once a lane group, node read and written, active
//     read, the keys written; the walk's output rows).
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
constexpr int kSplitThreads = 256;     // T2: threads a block (a bin each)
constexpr int kSplitRow = 17;          // T2: a 16-bin block's scanned row
constexpr int kSplitMaxStages = 3;     // T2: feature blocks in shared memory
constexpr int kSplitMaxChunks = 8;     // T2: blocks a (lane, node): a cluster
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

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// T2's dynamic shared memory (best_split's layout; tree_kernels.py
// `split_smem`): `stages` rounds of G staged feature blocks (m rows of rk
// floats each), then per group the scanned sums (S rows of rs floats), the
// blocks' offsets (S x 16), the totals and the totals' gain terms (S
// each); then the node's feature list.
long long split_smem(int m, int S, int d, int rk, int rs, int stages,
                     int G) {
  return 4LL * (static_cast<long long>(stages) * G * m * rk +
                static_cast<long long>(G) * S * (rs + kScanBase + 2) + d);
}

// T2: a block takes every chunks-th of its (lane, node)'s features (all d,
// or those the node's mask row keeps), G at a time (a round; a group of
// kSplitThreads / G threads, whole warps, a feature), staged `stages` - 1
// rounds ahead; a cluster of `chunks` blocks takes the whole (lane, node),
// and its first block combines their maxima through distributed shared
// memory.  Per feature: (1) a thread a (16-bin block k, stat s) adds the
// block's 16 values in order (reads at k rk + j S + s, rk = S mod 32: a
// warp's 32 chains hit 32 banks) and writes the running sums to row s of
// the scanned sums (kSplitRow floats a 16-bin block); (2) a thread a stat
// scans the blocks' totals in order (the offset each block adds) and
// takes its total's gain term; (3) a thread a bin: its cumulative sums,
// the gain summed over the outputs where both sides hold min_child_weight
// and the bin is not the last, and the thread's running first maximum.
template <int VW>
__global__ void __launch_bounds__(kSplitThreads, 4)
best_split(const float* __restrict__ hist, const bool* __restrict__ fmask,
           int* __restrict__ feat, int* __restrict__ thr,
           float* __restrict__ gain_out, bool* __restrict__ split,
           int n_nodes, int d, int n_bins, int S, int chunks, int rk, int rs,
           int stages, int G, float lam, float mcw) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_feat;
  __shared__ float wg[kSplitThreads / 32];
  __shared__ int wi[kSplitThreads / 32];
  __shared__ float block_best;
  __shared__ int block_idx;
  const int m = n_bins / kScanBase;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TG = kSplitThreads / G;                    // a group's threads
  const int grp = tid / TG;
  const int lt = tid - grp * TG;
  const int slot = m * rk;                             // a staged feature
  float* ring = sm;                                    // stages x G slots
  float* cum = ring + stages * G * slot + grp * S * (rs + kScanBase + 2);
  float* before = cum + S * rs;                        // S x 16
  float* total = before + S * kScanBase;               // S
  float* t3 = total + S;                               // S
  int* list = reinterpret_cast<int*>(ring + stages * G * slot +
                                     G * S * (rs + kScanBase + 2));
  const int pair = blockIdx.x / chunks;                // lane * N + node
  const int rank = blockIdx.x - pair * chunks;
  const int node = pair % n_nodes;
  const size_t fstride = static_cast<size_t>(n_bins) * S;
  const float* hp = hist + static_cast<size_t>(pair) * d * fstride;

  // the node's features, in order: the mask row's kept ones (or all d)
  if (fmask == nullptr) {
    if (tid == 0) n_feat = d;
  } else if (warp == 0) {
    int cnt = 0;
    for (int f0 = 0; f0 < d; f0 += 32) {
      const int f = f0 + lane;
      const bool on = f < d && fmask[static_cast<size_t>(node) * d + f];
      const unsigned bal = __ballot_sync(kFull, on);
      if (on) list[cnt + __popc(bal & ((1u << lane) - 1u))] = f;
      cnt += __popc(bal);
    }
    if (lane == 0) n_feat = cnt;
  }
  __syncthreads();
  const int mine = n_feat > rank ? (n_feat - rank + chunks - 1) / chunks : 0;
  const int rounds = (mine + G - 1) / G;
  const int row = kScanBase * S;                       // a 16-bin block
  // this group's item of round r: the block's item r G + grp
  auto feature = [&](int r) {
    const int item = rank + (r * G + grp) * chunks;
    return fmask == nullptr ? item : list[item];
  };
  // round r's features into their stage, a group its own, VW floats a copy
  auto stage = [&](int r) {
    if (r < rounds && r * G + grp < mine) {
      const float* src = hp + feature(r) * fstride;
      float* dst = ring + ((r % stages) * G + grp) * slot;
      for (int e = lt * VW; e < n_bins * S; e += TG * VW) {
        const int k = e / row;
        float* to = dst + k * rk + (e - k * row);
        if (VW == 4) cp_async16(to, src + e);
        else if (VW == 2) cp_async8(to, src + e);
        else cp_async4(to, src + e);
      }
    }
    cp_async_commit();
  };

  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int r = 0; r < stages - 1; ++r) stage(r);
  for (int r = 0; r < rounds; ++r) {
    stage(r + stages - 1);
    if (stages == 3) cp_async_wait<2>();
    else if (stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();          // round r is in; round r-1's sums are read
    const bool busy = r * G + grp < mine;
    const float* blk = ring + ((r % stages) * G + grp) * slot;
    // (1) within each 16-bin block, in order
    for (int c = lt; busy && c < m * S; c += TG) {
      const int k = c / S;
      const int s = c - k * S;
      const float* src = blk + k * rk + s;
      float v[kScanBase];
#pragma unroll
      for (int j = 0; j < kScanBase; ++j) v[j] = src[j * S];
      float* dst = cum + s * rs + k * kSplitRow;
      float run = v[0];
      dst[0] = run;
#pragma unroll
      for (int j = 1; j < kScanBase; ++j) {
        run = __fadd_rn(run, v[j]);
        dst[j] = run;
      }
    }
    __syncthreads();
    // (2) the blocks' totals, in order: block k adds the sum of blocks < k
    // (the totals loaded first, then a chain of adds); each output's term
    // of the parent, tg^2 / (th + lam), from stat 0's total (a shuffle
    // from the group's lane 0 where the stats fit one warp)
    for (int s = lt; busy && s < S; s += TG) {
      const float* tot = cum + s * rs + kScanBase - 1;
      float* off = before + s * kScanBase;
      float t[kScanBase];
#pragma unroll
      for (int k = 0; k < kScanBase; ++k)
        t[k] = k < m ? tot[k * kSplitRow] : 0.0f;
      float pre = t[0];
      off[0] = 0.0f;
#pragma unroll
      for (int k = 1; k < kScanBase; ++k) {
        if (k < m) {
          off[k] = pre;
          pre = __fadd_rn(pre, t[k]);
        }
      }
      total[s] = pre;
      if (S <= 32) {
        // lanes 0 .. S-1 of the group's first warp, each once
        const unsigned lanes = S == 32 ? kFull : (1u << S) - 1u;
        const float th = __shfl_sync(lanes, pre, 0);
        if (s > 0)
          t3[s] = __fdiv_rn(__fmul_rn(pre, pre), __fadd_rn(th, lam));
      }
    }
    __syncthreads();
    if (S > 32) {
      for (int s = 1 + lt; busy && s < S; s += TG)
        t3[s] = __fdiv_rn(__fmul_rn(total[s], total[s]),
                          __fadd_rn(total[0], lam));
      __syncthreads();
    }
    // (3) a bin a thread
    const int f = busy ? feature(r) : 0;
    for (int b = lt; busy && b < n_bins; b += TG) {
      const int k = b >> 4;
      const int at = k * kSplitRow + (b & (kScanBase - 1));
      float lh = cum[at];
      if (m > 1) lh = __fadd_rn(lh, before[k]);
      const float rh = __fsub_rn(total[0], lh);
      if (!(lh >= mcw && rh >= mcw && b != n_bins - 1)) continue;  // -inf
      const float lhl = __fadd_rn(lh, lam);
      const float rhl = __fadd_rn(rh, lam);
      float g = 0.0f;
      for (int o = 1; o < S; ++o) {
        float lg = cum[o * rs + at];
        if (m > 1) lg = __fadd_rn(lg, before[o * kScanBase + k]);
        const float rg = __fsub_rn(total[o], lg);
        const float t1 = __fdiv_rn(__fmul_rn(lg, lg), lhl);
        const float t2 = __fdiv_rn(__fmul_rn(rg, rg), rhl);
        g = __fadd_rn(g, __fsub_rn(__fadd_rn(t1, t2), t3[o]));
      }
      const int idx = f * n_bins + b;
      if (better(g, idx, best, best_i)) {
        best = g;
        best_i = idx;
      }
    }
  }
  cp_async_wait<0>();
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
  if (tid == 0) {
    for (int w = 1; w < kSplitThreads / 32; ++w) {
      if (better(wg[w], wi[w], best, best_i)) {
        best = wg[w];
        best_i = wi[w];
      }
    }
    block_best = best;
    block_idx = best_i;
  }
  if (chunks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                      // every block's maximum is written
    if (rank == 0 && tid == 0) {
      for (int r = 1; r < chunks; ++r) {
        const float og = *cluster.map_shared_rank(&block_best, r);
        const int oi = *cluster.map_shared_rank(&block_idx, r);
        if (better(og, oi, best, best_i)) {
          best = og;
          best_i = oi;
        }
      }
    }
    cluster.sync();                      // read before any block exits
  }
  if (rank == 0 && tid == 0) {
    // no finite gain (a node that cannot split, or whose features are all
    // masked): the first maximum of all -inf is flat index 0
    if (!(best > -INFINITY)) {
      best = -INFINITY;
      best_i = 0;
    }
    feat[pair] = best_i / n_bins;
    thr[pair] = best_i % n_bins;
    gain_out[pair] = best;
    split[pair] = best > 1e-7f;
  }
}

// T3's packed node word: feature f in bits 9-30 and t = thr + 1 clamped
// to [0, 256] in bits 0-8, so that code > thr is code >= t for any int
// threshold and a uint8 code; -1 for a node where a row stops.  Limits d
// to 2^22 features.
__device__ __forceinline__ int pack_node(int f, int thr) {
  const int t = thr < 0 ? 0 : thr >= 255 ? 256 : thr + 1;
  return (f << 9) | t;
}

__device__ __forceinline__ int child(int v, const uint8_t* row, int w) {
  return 2 * v + 1 + (row[w >> 9] >= (w & 511) ? 1 : 0);
}

// A block's tile of rows' codes into shared memory: nbytes contiguous
// bytes, 16 at a time where the source is aligned.
__device__ void stage_bytes(uint8_t* __restrict__ dst,
                            const uint8_t* __restrict__ src, int nbytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = nbytes >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] =
          __ldg(reinterpret_cast<const int4*>(src) + i);
    done = n16 << 4;
  }
  for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = src[i];
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// T3, the level step.  A block owns lg lanes and walks row tiles of
// kRowThreads rows, a row a thread; with kStage the tile's codes are
// staged once in shared memory for all its lanes.  Shared memory: the
// codes tile, the lanes' packed splits (N words a lane) and, at the last
// level, a flag a heap node (M bytes a lane) for the final scatter.
template <bool kStage>
__global__ void __launch_bounds__(kRowThreads)
level_step(const uint8_t* __restrict__ codes, int* __restrict__ node,
           const bool* __restrict__ active, const int* __restrict__ bf,
           const int* __restrict__ bb, const bool* __restrict__ split,
           int* __restrict__ feat, int* __restrict__ thr,
           bool* __restrict__ leaf, int* __restrict__ local, int L, int n,
           int d, int N, int M, int lg, int last) {
  extern __shared__ int4 step_s[];
  uint8_t* tile = reinterpret_cast<uint8_t*>(step_s);
  int* words = reinterpret_cast<int*>(
      tile + (kStage ? align16(kRowThreads * d) : 0));
  uint8_t* flags = reinterpret_cast<uint8_t*>(words + lg * N);
  const int l0 = blockIdx.y * lg;
  const int nl = min(lg, L - l0);
  const int offset = N - 1, next = 2 * N - 1;
  // the splits, and the heap's level written by the first row tile's
  // blocks, a node a thread
  for (int i = threadIdx.x; i < nl * N; i += kRowThreads) {
    const int q = i / N, j = i - q * N;
    const int s = (l0 + q) * N + j;
    const bool sp = split[s];
    const int f = bf[s], b = bb[s];
    words[i] = sp ? pack_node(f, b) : -1;
    if (blockIdx.x == 0) {
      const size_t h = static_cast<size_t>(l0 + q) * M + offset + j;
      feat[h] = sp ? f : -1;
      thr[h] = b;
      leaf[h] = !sp;
    }
  }
  if (last)
    for (int i = threadIdx.x; i < nl * M; i += kRowThreads) flags[i] = 0;
  const int tiles = (n + kRowThreads - 1) / kRowThreads;
  for (int tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const int r0 = tt * kRowThreads;
    if (kStage) {
      __syncthreads();              // the previous tile's reads are done
      stage_bytes(tile, codes + static_cast<size_t>(r0) * d,
                  min(kRowThreads, n - r0) * d);
    }
    __syncthreads();
    const int r = r0 + threadIdx.x;
    if (r >= n) continue;
    const uint8_t* row =
        kStage ? tile + threadIdx.x * d : codes + static_cast<size_t>(r) * d;
#pragma unroll 4
    for (int q = 0; q < nl; ++q) {
      const size_t i = static_cast<size_t>(l0 + q) * n + r;
      int v = node[i];
      const bool a = active[i];
      const int j = v - offset;         // < 0: frozen at a shallower node
      if (j >= 0 && j < N) {
        const int w = words[q * N + j];
        if (w >= 0) {
          v = child(v, row, w);
          node[i] = v;
        }
      }
      if (last) {
        local[i] = a ? v : -1;
        if (v < M) flags[q * M + v] = 1;
      } else {
        local[i] = a && v >= next ? v - next : -1;
      }
    }
  }
  if (last) {
    __syncthreads();
    for (int i = threadIdx.x; i < nl * M; i += kRowThreads)
      if (flags[i])
        leaf[static_cast<size_t>(l0) * M + i] = true;
  }
}

// T3, the walk: a block owns lg lanes' trees, packed a word a node in
// shared memory, and walks row tiles, a row a thread, each row's codes
// from the staged tile (kStage); then writes the leaf's values to `out`
// or adds scale[l] * value to it (one rounding).
template <bool kStage>
__global__ void __launch_bounds__(kRowThreads)
walk_rows(const uint8_t* __restrict__ codes, const int* __restrict__ feat,
          const int* __restrict__ thr, const bool* __restrict__ leaf,
          const float* __restrict__ value, const float* __restrict__ scale,
          float* __restrict__ out, int L, int n, int d, int M, int n_out,
          int depth, int lg) {
  extern __shared__ int4 walk_s[];
  uint8_t* tile = reinterpret_cast<uint8_t*>(walk_s);
  int* words = reinterpret_cast<int*>(
      tile + (kStage ? align16(kRowThreads * d) : 0));
  const int l0 = blockIdx.y * lg;
  const int nl = min(lg, L - l0);
  for (int i = threadIdx.x; i < nl * M; i += kRowThreads) {
    const size_t h = static_cast<size_t>(l0) * M + i;
    const int f = feat[h];
    words[i] = leaf[h] || f < 0 ? -1 : pack_node(f, thr[h]);
  }
  const int tiles = (n + kRowThreads - 1) / kRowThreads;
  for (int tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const int r0 = tt * kRowThreads;
    __syncthreads();
    if (kStage) {
      stage_bytes(tile, codes + static_cast<size_t>(r0) * d,
                  min(kRowThreads, n - r0) * d);
      __syncthreads();
    }
    const int r = r0 + threadIdx.x;
    if (r >= n) continue;
    const uint8_t* row =
        kStage ? tile + threadIdx.x * d : codes + static_cast<size_t>(r) * d;
    // two lanes' walks interleaved: a stopped walk keeps its node
    for (int q = 0; q < nl; q += 2) {
      const bool two = q + 1 < nl;
      const int* w0 = words + q * M;
      const int* w1 = two ? w0 + M : w0;
      int v0 = 0, v1 = 0;
      for (int k = 0; k < depth; ++k) {
        const int a = w0[v0], b = w1[v1];
        if (a < 0 && b < 0) break;
        if (a >= 0) v0 = child(v0, row, a);
        if (b >= 0) v1 = child(v1, row, b);
      }
      for (int u = 0; u < (two ? 2 : 1); ++u) {
        const int l = l0 + q + u;
        const float* val =
            value + (static_cast<size_t>(l) * M + (u ? v1 : v0)) * n_out;
        float* o = out + (static_cast<size_t>(l) * n + r) * n_out;
        if (scale != nullptr) {
          const float sc = scale[l];
          for (int c = 0; c < n_out; ++c) o[c] = __fmaf_rn(sc, val[c], o[c]);
        } else {
          for (int c = 0; c < n_out; ++c) o[c] = val[c];
        }
      }
    }
  }
}

// T3, the accumulate: out[l, r, c] += scale[l] * value[l, node[l, r], c],
// one rounding, an element a thread; lane l along y, its n * n_out
// elements (< 2^31) along x, so the index arithmetic stays 32-bit.
__global__ void __launch_bounds__(kRowThreads)
add_leaves(const int* __restrict__ node, const float* __restrict__ value,
           const float* __restrict__ scale, float* __restrict__ out, int n,
           int M, int n_out) {
  const int l = blockIdx.y;
  const unsigned per_lane = static_cast<unsigned>(n) * n_out;
  const int* nl = node + static_cast<size_t>(l) * n;
  const float* vl = value + static_cast<size_t>(l) * M * n_out;
  float* ol = out + static_cast<size_t>(l) * per_lane;
  const float sc = scale[l];
  for (unsigned e = blockIdx.x * kRowThreads + threadIdx.x; e < per_lane;
       e += gridDim.x * kRowThreads) {
    const unsigned r = e / n_out;
    const unsigned c = e - r * n_out;
    ol[e] = __fmaf_rn(sc, vl[nl[r] * n_out + c], ol[e]);
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
  static bool raised[10][kMaxDevices] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < kMaxDevices && raised[slot][dev]) return 0;
  // the block's most, less what the kernel declares statically
  cudaFuncAttributes fa;
  rc = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem - static_cast<int>(fa.sharedSizeBytes)));
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

// T3's dynamic shared memory (level_step's and walk_rows' layouts;
// tree_kernels.py `row_plan`): the staged codes tile, then per lane
// `per_lane` bytes.
long long row_smem(int d, int stage, int lg, long long per_lane) {
  return (stage ? align16(kRowThreads * d) : 0) + lg * per_lane;
}

int row_blocks(long long total) {
  const long long b = (total + kRowThreads - 1) / kRowThreads;
  return static_cast<int>(b < (1 << 20) ? (b > 0 ? b : 1) : (1 << 20));
}

// the row grid of T3's level step and walk: grid_x blocks over the row
// tiles, a block a group of lg lanes along y
bool bad_row_grid(int L, int n, int d, int lg, int grid_x, int smem,
                  long long per_lane, int stage) {
  const int tiles = (n + kRowThreads - 1) / kRowThreads;
  return L < 1 || n < 1 || d < 1 || d >= (1 << 22) || lg < 1 || lg > L ||
         grid_x < 1 || grid_x > tiles || smem > kMaxSmem ||
         smem < row_smem(d, stage, lg, per_lane) ||
         static_cast<long long>(L) * n >= (1LL << 31) ||
         (L + lg - 1) / lg > 65535;
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
// split (L, N) out.  n_bins a multiple of 16 up to 256.  chunks blocks a
// (lane, node) (a cluster), rk and rs the rows of the staged and scanned
// sums, `stages` staged rounds of G features (G = 1, 2, 4 or 8 a round)
// and `smem` bytes of dynamic shared memory, as tree_kernels.py
// `split_plan` chooses them.
int tree_best_split(const float* hist, const bool* fmask, int* feat,
                    int* thr, float* gain, bool* split, int L, int N, int d,
                    int n_bins, int S, int chunks, int rk, int rs, int stages,
                    int G, int smem, float lam, float mcw, void* stream) {
  const int m = n_bins / kScanBase;
  if (L < 1 || N < 1 || d < 1 || S < 1 || n_bins < kScanBase ||
      n_bins % kScanBase || n_bins > kScanBase * kScanBase || chunks < 1 ||
      chunks > kSplitMaxChunks || stages < 1 || stages > kSplitMaxStages ||
      rk < kScanBase * S || rs < kSplitRow * m || smem > kMaxSmem ||
      (G != 1 && G != 2 && G != 4 && G != 8) ||
      smem < split_smem(m, S, d, rk, rs, stages, G) ||
      static_cast<long long>(L) * N * chunks >= (1LL << 31) ||
      static_cast<long long>(d) * n_bins >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest copy both ends allow: a staged row starts every rk floats
  const uintptr_t a = reinterpret_cast<uintptr_t>(hist);
  const int vw = (S % 4 == 0 && rk % 4 == 0 && (a & 15) == 0)   ? 4
                 : (S % 2 == 0 && rk % 2 == 0 && (a & 7) == 0) ? 2
                                                                : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(L * N * chunks));
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chunks > 1 ? 1 : 0;
  int rc;
  if (vw == 4) {
    rc = allow_smem(best_split<4>, 3);
    if (rc == 0)
      rc = static_cast<int>(cudaLaunchKernelEx(
          &cfg, best_split<4>, hist, fmask, feat, thr, gain, split, N, d,
          n_bins, S, chunks, rk, rs, stages, G, lam, mcw));
  } else if (vw == 2) {
    rc = allow_smem(best_split<2>, 4);
    if (rc == 0)
      rc = static_cast<int>(cudaLaunchKernelEx(
          &cfg, best_split<2>, hist, fmask, feat, thr, gain, split, N, d,
          n_bins, S, chunks, rk, rs, stages, G, lam, mcw));
  } else {
    rc = allow_smem(best_split<1>, 5);
    if (rc == 0)
      rc = static_cast<int>(cudaLaunchKernelEx(
          &cfg, best_split<1>, hist, fmask, feat, thr, gain, split, N, d,
          n_bins, S, chunks, rk, rs, stages, G, lam, mcw));
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// T3, the level step.  node (L, n) in place; active (L, n); bf, bb,
// split (L, N): the level's split feature, bin and flag (offset = N - 1);
// feat, thr, leaf (L, M): the heap, its level's nodes written; local (L,
// n) out: the next level's keys (node - (2N - 1), -1 where the row is
// frozen or inactive) or, with `last`, T4's keys (node, -1 where
// inactive), and then leaf set at every row's node.  lg lanes a block,
// grid_x blocks over the row tiles, the codes staged where `stage`, and
// `smem` bytes of dynamic shared memory, as tree_kernels.py `row_plan`
// chooses them.
int tree_level_step(const uint8_t* codes, int* node, const bool* active,
                    const int* bf, const int* bb, const bool* split,
                    int* feat, int* thr, bool* leaf, int* local, int L,
                    int n, int d, int N, int M, int lg, int grid_x,
                    int stage, int last, int smem, void* stream) {
  const long long per_lane = 4LL * N + (last ? M : 0);
  if (N < 1 || M < 2 * N - 1 + (last ? 2 * N : 0) ||
      bad_row_grid(L, n, d, lg, grid_x, smem, per_lane, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, (L + lg - 1) / lg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (stage) {
    rc = allow_smem(level_step<true>, 6);
    if (rc != 0) return rc;
    level_step<true><<<grid, kRowThreads, smem, s>>>(
        codes, node, active, bf, bb, split, feat, thr, leaf, local, L, n, d,
        N, M, lg, last);
  } else {
    rc = allow_smem(level_step<false>, 7);
    if (rc != 0) return rc;
    level_step<false><<<grid, kRowThreads, smem, s>>>(
        codes, node, active, bf, bb, split, feat, thr, leaf, local, L, n, d,
        N, M, lg, last);
  }
  return static_cast<int>(cudaGetLastError());
}

// T3, the walk.  A tree's feat, thr, leaf (L, M) and value (L, M, n_out);
// out (L, n, n_out) gets the leaf values (scale null) or scale[l] * value
// added.  lg, grid_x, stage and smem as for the level step.
int tree_walk(const uint8_t* codes, const int* feat, const int* thr,
              const bool* leaf, const float* value, const float* scale,
              float* out, int L, int n, int d, int M, int n_out, int depth,
              int lg, int grid_x, int stage, int smem, void* stream) {
  if (n_out < 1 || depth < 0 || depth > 30 || M < (2LL << depth) - 1 ||
      bad_row_grid(L, n, d, lg, grid_x, smem, 4LL * M, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, (L + lg - 1) / lg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (stage) {
    rc = allow_smem(walk_rows<true>, 8);
    if (rc != 0) return rc;
    walk_rows<true><<<grid, kRowThreads, smem, s>>>(
        codes, feat, thr, leaf, value, scale, out, L, n, d, M, n_out, depth,
        lg);
  } else {
    rc = allow_smem(walk_rows<false>, 9);
    if (rc != 0) return rc;
    walk_rows<false><<<grid, kRowThreads, smem, s>>>(
        codes, feat, thr, leaf, value, scale, out, L, n, d, M, n_out, depth,
        lg);
  }
  return static_cast<int>(cudaGetLastError());
}

// T3, the accumulate.  node (L, n) the grown trees' final nodes; value
// (L, M, n_out); out (L, n, n_out) gets scale[l] * value[l, node] added.
int tree_add_leaves(const int* node, const float* value, const float* scale,
                    float* out, int L, int n, int M, int n_out,
                    void* stream) {
  const long long per_lane = static_cast<long long>(n) * n_out;
  if (L < 1 || L > 65535 || n < 1 || M < 1 || n_out < 1 ||
      per_lane >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks(per_lane) < 4096 ? row_blocks(per_lane) : 4096,
                  L);
  add_leaves<<<grid, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      node, value, scale, out, n, M, n_out);
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
