// The histogram tree grower's device passes, for Hopper (sm_90a).  Built
// with nvcc into a shared library with a plain C interface and loaded with
// ctypes (spark_sklearn_tpu_torch/ops/_build.py); the Python wrappers live
// in spark_sklearn_tpu_torch/ops/tree_kernels.py beside their plain
// PyTorch versions.  Every pass runs over L lanes at once, one tree a
// lane; codes are the (n, d) uint8 bin codes that all lanes share.
//
// T1  tree_level_hist    replaces the level histogram of
//     spark_sklearn_tpu/ops/trees.py:70-84 (`hist`, a jax.ops.segment_sum
//     over (node, feature, bin) ids per stat): per lane, node j, feature f
//     and bin b, the sum over the node's taking-part rows with code b at f
//     of each of the S stats of a row (w h, then w g per output).
//     The wrapper first groups each lane's rows by node (a stable sort of
//     (lane, node) keys: `perm`, and `offs` where node slots begin).
//     Design.  A block owns (lane, node) x a tile of `ft` features; a
//     thread owns one (feature, stat) column of the tile's histogram (ft
//     x n_bins x S floats in shared memory) and alone adds into it, so
//     no atomics serialise the hot cells (most one-hot columns put nearly
//     every row in bin 0 or 1).  Each column walks the node's rows in
//     row order: every sum is taken in the order the plain version's
//     `index_add_` takes it on the CPU, so the kernel gives its bits,
//     launch after launch.  kLoaders more threads stage the next
//     kRowTile rows (codes and stats, double-buffered in shared memory)
//     while the columns add the current ones.  Feature tiles narrow where
//     nodes are few (the shallow levels) to fill the card; a column's
//     chain of dependent shared-memory adds, one a row of its node,
//     bounds the root level.
//     Bound: bytes.  It must read each taking-part row's d codes and S
//     stats once and write the (L, n_nodes, d, n_bins, S) histogram once;
//     deep levels are bound by the histogram's write (226 MB a lane at
//     512 nodes, d = 54, S = 8), shallow ones by the rows' chains.
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
//     final tree, -sum(w g) / (sum(w h) + lam) over the node's rows.  The
//     wrapper groups rows by final node as for T1; a warp sums a node's
//     rows, a lane a stat, in row order (the plain version's order).
//     Bound: bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowTile = 128;          // rows T1 stages at a time
constexpr int kLoaders = 128;          // T1: threads that stage rows
constexpr int kMaxSmem = 232448;       // 227 KB, an H100 block's most
constexpr int kMaxDevices = 64;
constexpr int kSplitWarps = 8;         // T2: warps a block
constexpr int kScanBase = 16;          // T2: XLA's cumsum block (bins)
constexpr int kLeafWarps = 4;          // T4: nodes a block, a warp each
constexpr int kRowThreads = 256;       // T3: threads a block

// T1's staged rows: the tile's codes (kRowTile x ft bytes) and stats
// (kRowTile x S floats), one loader thread a row.
__device__ __forceinline__ void stage_rows(
    const uint8_t* __restrict__ codes, const int* __restrict__ perm,
    const float* __restrict__ stats, uint8_t* cs, float* st, int i0, int cnt,
    long long base, int d, int f0, int nft, int ft, int S, int r) {
  if (r >= cnt) return;
  const int p = perm[i0 + r];
  const uint8_t* cr = codes + (p - base) * d + f0;
  for (int j = 0; j < nft; ++j) cs[r * ft + j] = cr[j];
  const float* sr = stats + static_cast<long long>(p) * S;
  for (int j = 0; j < S; ++j) st[r * S + j] = sr[j];
}

// T1: one (lane, node) x feature tile a block.  The first acc_warps warps
// hold a thread a (feature, stat) column; the last kLoaders threads stage
// the next tile of rows while the columns add the current one (two
// buffers, one barrier a tile).
__global__ void level_hist(const uint8_t* __restrict__ codes,
                           const int* __restrict__ perm,
                           const int* __restrict__ offs,
                           const float* __restrict__ stats,
                           float* __restrict__ hist, int n, int d,
                           int n_nodes, int n_bins, int S, int ft) {
  extern __shared__ float smem[];
  const int seg = blockIdx.x;                      // lane * n_nodes + node
  const int lane = seg / n_nodes;
  const int node = seg - lane * n_nodes;
  const int f0 = blockIdx.y * ft;
  const int nft = min(ft, d - f0);
  const int tile = n_bins * S;
  float* h = smem;                                 // ft x n_bins x S
  float* st[2];
  uint8_t* cs[2];
  st[0] = h + static_cast<size_t>(ft) * tile;
  st[1] = st[0] + kRowTile * S;
  cs[0] = reinterpret_cast<uint8_t*>(st[1] + kRowTile * S);
  cs[1] = cs[0] + kRowTile * ft;
  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int loader0 = nth - kLoaders;              // first loader thread
  for (int i = tid; i < ft * tile; i += nth) h[i] = 0.0f;

  const int slot = lane * (n_nodes + 1) + node;
  const int lo = offs[slot];
  const int hi = offs[slot + 1];
  const long long base = static_cast<long long>(lane) * n;
  const int fi = tid / S;
  const int s = tid - fi * S;
  const bool column = tid < ft * S && fi < nft;
  float* col = h + static_cast<size_t>(fi) * tile + s;
  if (tid >= loader0 && lo < hi)
    stage_rows(codes, perm, stats, cs[0], st[0], lo, min(kRowTile, hi - lo),
               base, d, f0, nft, ft, S, tid - loader0);
  __syncthreads();
  int buf = 0;
  for (int i0 = lo; i0 < hi; i0 += kRowTile) {
    const int cnt = min(kRowTile, hi - i0);
    const int next = i0 + kRowTile;
    if (tid >= loader0) {
      if (next < hi)
        stage_rows(codes, perm, stats, cs[buf ^ 1], st[buf ^ 1], next,
                   min(kRowTile, hi - next), base, d, f0, nft, ft, S,
                   tid - loader0);
    } else if (column) {
      // this column's rows in order: the plain version's order
      const uint8_t* c = cs[buf] + fi;
      const float* v = st[buf] + s;
      for (int r = 0; r < cnt; ++r) {
        float* cell = col + c[r * ft] * S;
        *cell = __fadd_rn(*cell, v[r * S]);
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  float* dst = hist + (static_cast<size_t>(seg) * d + f0) * tile;
  for (int i = tid; i < nft * tile; i += nth) dst[i] = h[i];
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

// T4: one (lane, node) a warp, a stat a lane, rows in order.  A warp
// reads 32 row ids at a time (one each) and shuffles them out, so the 32
// loads of a batch are in flight together; the adds stay in row order.
__global__ void __launch_bounds__(kLeafWarps * 32)
leaf_sums(const int* __restrict__ perm, const int* __restrict__ offs,
          const float* __restrict__ stats, float* __restrict__ value,
          int n_segs, int n_nodes, int S, float lam) {
  const int seg = blockIdx.x * kLeafWarps + (threadIdx.x >> 5);
  if (seg >= n_segs) return;
  const int lane = threadIdx.x & 31;
  const int l = seg / n_nodes;
  const int slot = l * (n_nodes + 1) + (seg - l * n_nodes);
  const int a = offs[slot];
  const int b = offs[slot + 1];
  float sum_h = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool mine = s < S;
    float acc = 0.0f;
    for (int i0 = a; i0 < b; i0 += 32) {
      const int cnt = min(32, b - i0);
      const int p_own = lane < cnt ? perm[i0 + lane] : 0;
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int p = __shfl_sync(kFull, p_own, j);
        v[j] = (mine && j < cnt)
                   ? __ldg(stats + static_cast<long long>(p) * S + s)
                   : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < cnt) acc = __fadd_rn(acc, v[j]);
    }
    if (s0 == 0) sum_h = __shfl_sync(kFull, acc, 0);
    if (s >= 1 && mine)
      value[static_cast<size_t>(seg) * (S - 1) + (s - 1)] =
          __fdiv_rn(-acc, __fadd_rn(sum_h, lam));
  }
}

// T1 may take more than the default 48 KB of dynamic shared memory; the
// limit is raised once a device, not on every launch.
int allow_hist_smem() {
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < kMaxDevices && raised[dev]) return 0;
  rc = static_cast<int>(cudaFuncSetAttribute(
      level_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  if (rc == 0 && dev < kMaxDevices) raised[dev] = true;
  return rc;
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
// features and `smem` bytes of dynamic shared memory a block, as
// tree_kernels.py `hist_plan` chooses them.  Returns cudaGetLastError()
// of the launch (0 = launched).
int tree_level_hist(const uint8_t* codes, const int* perm, const int* offs,
                    const float* stats, float* hist, int n, int d, int L,
                    int n_nodes, int n_bins, int S, int ft, int smem,
                    void* stream) {
  const int threads = (ft * S + 31) / 32 * 32 + kLoaders;
  if (n < 1 || d < 1 || L < 1 || n_nodes < 1 || n_bins < 1 || n_bins > 256 ||
      S < 1 || ft < 1 || threads > 1024 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_hist_smem();
  if (rc != 0) return rc;
  const dim3 grid(L * n_nodes, (d + ft - 1) / ft);
  level_hist<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, perm, offs, stats, hist, n, d, n_nodes, n_bins, S, ft);
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
// out.
int tree_leaf_values(const int* perm, const int* offs, const float* stats,
                     float* value, int L, int n, int n_nodes, int S,
                     float lam, void* stream) {
  if (L < 1 || n < 1 || n_nodes < 1 || S < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_segs = L * n_nodes;
  leaf_sums<<<(n_segs + kLeafWarps - 1) / kLeafWarps, kLeafWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(perm, offs, stats, value,
                                                   n_segs, n_nodes, S, lam);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
