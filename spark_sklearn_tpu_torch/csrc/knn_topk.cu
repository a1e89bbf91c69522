// KNN's fold-masked top-k over the distance Gram (N1) for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py); the Python
// wrapper lives in spark_sklearn_tpu_torch/ops/knn_kernels.py beside its
// plain PyTorch version and the launch plan (`topk_plan`).
//
// N1  knn_fold_topk   replaces spark_sklearn_tpu/models/neighbors.py:64-79
//     (`_sq_dists` after its GEMM and `_fold_neighbors`: the fold's mask
//     and `lax.top_k`, once a fold there):
//       D[i,j] = max((sq_rows[i] + sq_cols[j]) - 2 G[i,j], 0)
//       for each fold f and row i: the maxk smallest D[i,j] over the
//       columns with masks[f,j] > 0 (the others +inf), ascending by
//       (D, j), with their columns j.
//     G (m, n), masks (F, n), d2 (F, m, maxk) float32, idx (F, m, maxk)
//     int32, row-major.  Bound: bytes.  It reads G once (at the KNN
//     search's shape, m = n = 10000: 400 MB; the KNN regressor's,
//     n = 20640: 1.7 GB) and the masks and writes F*m*maxk results:
//     ~0.12 / 0.51 ms at 3.35 TB/s.
//
// Every entry is ordered by its 64-bit key (distance bits << 32 | column):
// a non-negative float's bits order as the float (-0 is made +0; a masked
// column's bits are +inf's), and the column breaks ties to the lower
// index, which is lax.top_k's order.  The answer is the maxk smallest keys
// of a fold, a set fixed by the inputs whatever order the columns are
// visited in, so every plan gives the plain version's bits.
//
// Plan "warp" (maxk <= kWarpMaxK, a fold group's mask bits within
// kWarpMaxMaskBytes): a warp a row, every fold of its group from one pass.
// - The block stages its group's fold masks once, as bits (word w of fold
//   f holds columns 32w .. 32w+31), then walks rows (a persistent grid:
//   the masks are read once a block, not once a row).
// - The warp streams its row of G once, 32 columns a load, kWarpUnroll
//   loads in flight, and forms each column's distance in registers.
// - Per fold, lane l holds the l-th smallest key so far (32 sorted keys
//   across the warp, the maxk-th the fold's threshold).  A column whose
//   distance is above every fold's threshold (the common case once the
//   lists fill: maxk << n) costs one compare and one warp vote.  The
//   others are tested per fold on their exact 64-bit key and inserted one
//   at a time by a shuffle that shifts the larger keys one lane up.
// - A group holds at most kWarpFolds folds (their lists in registers);
//   F above that is split into even groups along the grid's y.
// Plans "staged" / "streamed" (any maxk <= kMaxK; the large-maxk path):
// - A block (256 threads) takes one row i.  "Staged" (n <= kStagedMaxN):
//   it forms the row's n distances once, as their float bits, and keeps
//   them in shared memory for all F folds, so G's row is read once; a
//   fold's keys (the bits, or +inf's bits where masked) go to a second
//   array.  "Streamed": no row in shared memory, every pass forms the
//   keys again from G, sq and the mask.
// - Per fold, a radix select finds T, the maxk-th smallest key, in four
//   passes of 8 bits (a 256-bin histogram in shared memory; a warp adds
//   its equal bins first, __match_any_sync, then one atomicAdd each).
//   The keys below T go to the selection in any order; then the keys
//   equal to T, lowest columns first (a block-wide ordered count by warp
//   ballots), until maxk are taken.  A bitonic sort of the selection as
//   (key << 32 | column) puts it in (D, j) order.  maxk <= kMaxK (the
//   sort's width).
// - Nothing depends on the order of the atomics: the selection is a set
//   and its sort is total, so the same inputs give the same outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // radix: one block a row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;                   // the sort's width, at most
constexpr int kStagedMaxN = 26000;            // 8 bytes a column staged
constexpr unsigned kInfKey = 0x7f800000u;     // +inf's bits
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxK = 32;                 // warp plan: a key a lane
constexpr int kWarpFolds = 8;                 // folds a warp serves at once
constexpr int kWarpThreads = 256;             // warp plan: 8 rows a block
constexpr int kWarpUnroll = 8;                // 32-column loads in flight
constexpr int kWarpMaxMaskBytes = 96 * 1024;  // a block's staged mask bits

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

struct Shared {
  unsigned hist[256];
  unsigned warp_count[kWarps];
  unsigned prefix;
  int kth;
  unsigned n_lt;
  unsigned pad;
};

__device__ __forceinline__ unsigned dist_key(float sq_i, float sq_j,
                                             float g) {
  float v = (sq_i + sq_j) - 2.0f * g;         // 2g is exact: no rounding
  v = (v < 0.0f) ? 0.0f : v;                  // max(v, 0), NaN kept
  return __float_as_uint(v + 0.0f);           // -0 -> +0
}

// The warp plan (see the head of the file).  Grid (row blocks, fold
// groups); `fg` folds a group, the last group may hold fewer.
__global__ void __launch_bounds__(kWarpThreads)
    knn_topk_warp_kernel(const float* __restrict__ G,
                         const float* __restrict__ sq_rows,
                         const float* __restrict__ sq_cols,
                         const float* __restrict__ masks,
                         float* __restrict__ out_d2,
                         int* __restrict__ out_idx, int m, int n, int F,
                         int maxk, int fg, int words) {
  extern __shared__ unsigned mask_bits[];                   // nf x words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = kWarpThreads / 32;
  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  for (int e = warp; e < nf * words; e += warps) {
    const int f = e / words;
    const int j = 32 * (e - f * words) + lane;
    const bool on =
        j < n && masks[static_cast<size_t>(f0 + f) * n + j] > 0.0f;
    const unsigned word = __ballot_sync(kFull, on);
    if (lane == 0) mask_bits[e] = word;
  }
  __syncthreads();
  for (int i = blockIdx.x * warps + warp; i < m; i += gridDim.x * warps) {
    const float* Grow = G + static_cast<size_t>(i) * n;
    const float sq_i = sq_rows[i];
    unsigned long long list[kWarpFolds];    // lane l: the l-th smallest
    unsigned long long thr[kWarpFolds];     // the maxk-th, in every lane
#pragma unroll
    for (int f = 0; f < kWarpFolds; ++f) list[f] = thr[f] = ~0ull;
    unsigned thr_hi = kFull;                // max over folds of thr >> 32
    for (int base = 0; base < n; base += 32 * kWarpUnroll) {
      float g[kWarpUnroll], sq[kWarpUnroll];
#pragma unroll
      for (int q = 0; q < kWarpUnroll; ++q) {
        const int j = base + 32 * q + lane;
        g[q] = j < n ? __ldcs(Grow + j) : 0.0f;
        sq[q] = j < n ? sq_cols[j] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kWarpUnroll; ++q) {
        const int j = base + 32 * q + lane;
        const unsigned key = dist_key(sq_i, sq[q], g[q]);
        // the least key this column has in any fold (+inf where masked)
        const bool maybe = j < n && min(key, kInfKey) <= thr_hi;
        if (!__any_sync(kFull, maybe)) continue;
        const int w = (base >> 5) + q;
        bool changed = false;
#pragma unroll
        for (int f = 0; f < kWarpFolds; ++f) {
          if (f >= nf) break;
          const unsigned bits = (mask_bits[f * words + w] >> lane) & 1u;
          const unsigned long long c =
              (static_cast<unsigned long long>(bits ? key : kInfKey)
               << 32) | static_cast<unsigned>(j);
          const bool in = maybe && c < thr[f];
          unsigned ball = __ballot_sync(kFull, in);
          while (ball) {
            const int src = __ffs(ball) - 1;
            const unsigned long long v = __shfl_sync(kFull, c, src);
            const unsigned long long prev = __shfl_up_sync(kFull, list[f], 1);
            if (list[f] > v) list[f] = (lane == 0 || prev < v) ? v : prev;
            thr[f] = __shfl_sync(kFull, list[f], maxk - 1);
            ball &= ~(1u << src);
            ball &= __ballot_sync(kFull, in && c < thr[f]);
            changed = true;
          }
        }
        if (changed) {
          unsigned hi = 0;
#pragma unroll
          for (int f = 0; f < kWarpFolds; ++f)
            if (f < nf) hi = max(hi, static_cast<unsigned>(thr[f] >> 32));
          thr_hi = hi;
        }
      }
    }
    if (lane < maxk) {
#pragma unroll
      for (int f = 0; f < kWarpFolds; ++f) {
        if (f >= nf) break;
        const size_t out = (static_cast<size_t>(f0 + f) * m + i) * maxk +
                           lane;
        out_d2[out] = __uint_as_float(static_cast<unsigned>(list[f] >> 32));
        out_idx[out] = static_cast<int>(list[f] & 0xffffffffull);
      }
    }
  }
}


template <bool kStaged>
__device__ __forceinline__ unsigned key_at(int j, const unsigned* keys,
                                           const float* Grow, float sq_i,
                                           const float* sq_cols,
                                           const float* mask_f) {
  if (kStaged) return keys[j];
  return mask_f[j] > 0.0f ? dist_key(sq_i, sq_cols[j], Grow[j]) : kInfKey;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float* __restrict__ G,
                    const float* __restrict__ sq_rows,
                    const float* __restrict__ sq_cols,
                    const float* __restrict__ masks,
                    float* __restrict__ out_d2, int* __restrict__ out_idx,
                    int m, int n, int F, int maxk, int P) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* sel = smem_u64;                       // P
  Shared& sh = *reinterpret_cast<Shared*>(sel + P);
  unsigned* dbits = reinterpret_cast<unsigned*>(&sh + 1);   // n (staged)
  unsigned* keys = dbits + n;                               // n (staged)
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* Grow = G + static_cast<size_t>(i) * n;
  const float sq_i = sq_rows[i];
  if (kStaged) {
    for (int j = tid; j < n; j += kThreads)
      dbits[j] = dist_key(sq_i, sq_cols[j], Grow[j]);
  }
  const int n_round = ((n + kThreads - 1) / kThreads) * kThreads;
  for (int f = 0; f < F; ++f) {
    const float* mask_f = masks + static_cast<size_t>(f) * n;
    __syncthreads();          // the row is staged; the last fold is done
    if (kStaged) {
      for (int j = tid; j < n; j += kThreads)
        keys[j] = mask_f[j] > 0.0f ? dbits[j] : kInfKey;
    }
    if (tid == 0) sh.n_lt = 0;
    // radix select: T = the maxk-th smallest key, 8 bits a pass
    unsigned prefix = 0, pmask = 0;
    int kth = maxk;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += kThreads) sh.hist[b] = 0;
      __syncthreads();
      for (int j = tid; j < n_round; j += kThreads) {
        unsigned bin = 256;
        if (j < n) {
          const unsigned key =
              key_at<kStaged>(j, keys, Grow, sq_i, sq_cols, mask_f);
          if ((key & pmask) == prefix) bin = (key >> shift) & 255u;
        }
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin < 256 && lane == __ffs(peers) - 1)
          atomicAdd(&sh.hist[bin], static_cast<unsigned>(__popc(peers)));
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 8l .. 8l+7; the lane whose range holds the
        // kth key picks the bin
        unsigned c[8];
        unsigned s = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = sh.hist[8 * lane + q];
          s += c[q];
        }
        unsigned incl = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const unsigned excl = incl - s;
        const unsigned want = static_cast<unsigned>(kth);
        if (excl < want && want <= incl) {
          unsigned before = excl;
          int bsel = 8 * lane + 7;
          for (int q = 0; q < 8; ++q) {
            if (before + c[q] >= want) {
              bsel = 8 * lane + q;
              break;
            }
            before += c[q];
          }
          sh.prefix = prefix | (static_cast<unsigned>(bsel) << shift);
          sh.kth = kth - static_cast<int>(before);
        }
      }
      __syncthreads();
      prefix = sh.prefix;
      kth = sh.kth;
      pmask |= 255u << shift;
    }
    const unsigned T = prefix;
    const unsigned n_lt = static_cast<unsigned>(maxk - kth);
    // the keys below T, in any order
    for (int j = tid; j < n; j += kThreads) {
      const unsigned key =
          key_at<kStaged>(j, keys, Grow, sq_i, sq_cols, mask_f);
      if (key < T) {
        const unsigned pos = atomicAdd(&sh.n_lt, 1u);
        sel[pos] = (static_cast<unsigned long long>(key) << 32) |
                   static_cast<unsigned>(j);
      }
    }
    // kth keys equal to T, lowest columns first
    unsigned taken = 0;                       // the same in every thread
    for (int base = 0; base < n && taken < static_cast<unsigned>(kth);
         base += kThreads) {
      const int j = base + tid;
      const bool eq =
          j < n &&
          key_at<kStaged>(j, keys, Grow, sq_i, sq_cols, mask_f) == T;
      const unsigned ballot = __ballot_sync(kFull, eq);
      if (lane == 0) sh.warp_count[warp] = __popc(ballot);
      __syncthreads();
      unsigned before = taken;
      unsigned total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += sh.warp_count[w];
        total += sh.warp_count[w];
      }
      const unsigned rank = before + __popc(ballot & ((1u << lane) - 1u));
      if (eq && rank < static_cast<unsigned>(kth))
        sel[n_lt + rank] = (static_cast<unsigned long long>(T) << 32) |
                           static_cast<unsigned>(j);
      taken += total;
      __syncthreads();
    }
    for (int t = maxk + tid; t < P; t += kThreads) sel[t] = ~0ull;
    __syncthreads();
    // bitonic sort of the P entries, ascending
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < P / 2; t += kThreads) {
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const bool up = (lo & size) == 0;
          const unsigned long long a = sel[lo];
          const unsigned long long b = sel[hi];
          if ((a > b) == up) {
            sel[lo] = b;
            sel[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    const size_t out = (static_cast<size_t>(f) * m + i) * maxk;
    for (int t = tid; t < maxk; t += kThreads) {
      const unsigned long long v = sel[t];
      out_d2[out + t] = __uint_as_float(static_cast<unsigned>(v >> 32));
      out_idx[out + t] = static_cast<int>(v & 0xffffffffull);
    }
  }
}

template <bool kStaged>
int launch(const float* G, const float* sq_rows, const float* sq_cols,
           const float* masks, float* d2, int* idx, int m, int n, int F,
           int maxk, int P, cudaStream_t s) {
  const size_t smem = sizeof(unsigned long long) * P + sizeof(Shared) +
                      (kStaged ? 2 * sizeof(unsigned) * n : 0);
  static int raised[kMaxDevices] = {};
  const int rc = allow_smem(knn_topk_kernel<kStaged>, smem, raised);
  if (rc != 0) return rc;
  knn_topk_kernel<kStaged><<<m, kThreads, smem, s>>>(
      G, sq_rows, sq_cols, masks, d2, idx, m, n, F, maxk, P);
  return static_cast<int>(cudaGetLastError());
}

// The warp plan's persistent grid: as many blocks as fit on the card at
// once (fewer where the rows run out), times the fold groups.
int launch_warp(const float* G, const float* sq_rows, const float* sq_cols,
                const float* masks, float* d2, int* idx, int m, int n,
                int F, int maxk, cudaStream_t s) {
  const int groups = (F + kWarpFolds - 1) / kWarpFolds;
  const int fg = (F + groups - 1) / groups;       // even groups
  const int words = (n + 31) / 32;
  const size_t smem = sizeof(unsigned) * static_cast<size_t>(fg) * words;
  if (smem > static_cast<size_t>(kWarpMaxMaskBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  static int raised[kMaxDevices] = {};
  int rc = allow_smem(knn_topk_warp_kernel, smem, raised);
  if (rc != 0) return rc;
  // blocks an SM, asked once a device and shared-memory size (a launch
  // captured in a CUDA graph after one of the same shape makes no query)
  static int sms[kMaxDevices] = {}, fit_smem[kMaxDevices] = {},
             fit_per_sm[kMaxDevices] = {};
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && sms[dev] > 0 &&
      fit_smem[dev] == static_cast<int>(smem)) {
    n_sm = sms[dev];
    per_sm = fit_per_sm[dev];
  } else {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, knn_topk_warp_kernel, kWarpThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) {
      sms[dev] = n_sm;
      fit_smem[dev] = static_cast<int>(smem);
      fit_per_sm[dev] = per_sm;
    }
  }
  const int rows_per_block = kWarpThreads / 32;
  const int need = (m + rows_per_block - 1) / rows_per_block;
  const int fit = max(1, n_sm * per_sm / groups);
  knn_topk_warp_kernel<<<dim3(min(need, fit), groups), kWarpThreads, smem,
                         s>>>(G, sq_rows, sq_cols, masks, d2, idx, m, n, F,
                              maxk, fg, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// plan: 0 warp, 1 staged, 2 streamed (`topk_plan`).  Returns the first
// nonzero cudaError of the launch (0 = launched).
int knn_fold_topk(const float* G, const float* sq_rows, const float* sq_cols,
                  const float* masks, float* d2, int* idx, int m, int n,
                  int F, int maxk, int plan, void* stream) {
  if (m < 1 || n < 1 || F < 1 || maxk < 1 || maxk > kMaxK || maxk > n ||
      plan < 0 || plan > 2 || (plan == 0 && maxk > kWarpMaxK) ||
      (plan == 1 && n > kStagedMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan == 0)
    return launch_warp(G, sq_rows, sq_cols, masks, d2, idx, m, n, F, maxk,
                       s);
  int P = 1;
  while (P < maxk) P <<= 1;
  if (plan == 1)
    return launch<true>(G, sq_rows, sq_cols, masks, d2, idx, m, n, F, maxk,
                        P, s);
  return launch<false>(G, sq_rows, sq_cols, masks, d2, idx, m, n, F, maxk, P,
                       s);
}

}  // extern "C"
