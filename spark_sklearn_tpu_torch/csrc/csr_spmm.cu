// SP1, the product of a CSR matrix and a dense matrix, for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py);
// the Python wrapper lives in spark_sklearn_tpu_torch/ops/spmm_kernels.py
// beside its plain PyTorch version, the work plan (`SpmmPlan`) and the
// launch's choices (`spmm_launch`).
//
// SP1  csr_spmm   replaces XLA's BCOO gather/scatter products of the
//     reference's sparse path: spark_sklearn_tpu/models/linear.py:213-219,
//     267-277 (`Ax`, X Wᵀ), :228-236, 288-297 (`AT`, Gᵀ X), :345-346 (the
//     views), and the naive Bayes class sums and joint log-likelihoods on a
//     BCOO X (naive_bayes.py:74-95 `_class_sums`, :331-332 and :374-375
//     `_jll`):
//       Y[r, :] = sum over j in row r of values[j] * D[indices[j], :]
//     A (m rows) as int32 indptr (m+1) and indices (nnz), float32 values
//     (nnz); D (K, W) and Y (m, W) float32 row-major.  One kernel serves
//     both directions of the port's operand (sparse/csr.py CSROperand):
//     X with D = Wᵀ, and Xᵀ's CSR with D = Gᵀ.
//     Order: each Y element is summed by one thread in float32 in
//     ascending order of its row's nonzeros, a product rounded
//     (__fmul_rn) then added (__fadd_rn) from 0, so the same inputs give
//     the same bits on every launch and the bits of the plain version on
//     the CPU (a gather times the values, then index_add_ in that order).
//     Bound: the bytes it must move, A's arrays and D read once and Y
//     written once, 4 (m+1) + 8 nnz + 4 K W + 4 m W; its 2 nnz W operations
//     are far below.  But the rows of D that the nonzeros gather are
//     nnz W 4 bytes (7.27 GB at the 20-newsgroups forward, W = 1000), most
//     from L2 and the rest from device memory: the gathers' rate, and on
//     Xᵀ's Zipf-long rows the chain of one row's ordered sums, set its time.
//
// Design (the second).  The first gave each row to one block, walking its
// nonzeros 8 loads at a time: Xᵀ's longest rows (~11300 nonzeros) set the
// tail, 4-byte loads issued four times the instructions, and nothing kept
// a slice of D in L2.  Measured on the H100 (chip_sweep.py's trace), the
// launch is bound by the rate the card's L2 serves gathers, ~7 TB/s, and
// a long row by its warp's step, ~30-60 ns a nonzero while the card is
// loaded.  Now:
// - Work items, planned once per CSR on the host (SpmmPlan, from indptr):
//   a segment is a run of consecutive rows whose nonzeros plus rows stay
//   near a cost (a row past it is a segment alone), sorted by nonzeros,
//   longest first.  An item is a segment and a slice of W's columns: 32
//   lanes of a warp, each lane VEC consecutive columns (`vec_light`: 4
//   where W % 4 == 0 and the rows are 16-byte aligned, one 16-byte copy
//   a lane and nonzero; else 2 or 1).
// - Heavy segments (`n_heavy`, the longest, picked at launch from W so
//   that their chains do not outlast the launch) take slices of
//   `heavy_cols` (32 or 16) columns whose lanes copy whole row slices
//   (walk_item's HC): the same ring then holds 2-4x more of their
//   nonzeros ahead, and a batch costs a copy or two a lane.
// - The warps of a persistent grid take the items longest first from a
//   counter in device memory that the launch zeroes on its own stream
//   first, one counter a launch: a warp done with a long item takes the
//   next, so no warp holds a long item and a queue of short ones; no
//   host sync, capturable in a CUDA graph, and launches on other streams
//   draw from counters of their own.
// - A ring in shared memory a lane (kRingBytes: 64 / VEC nonzeros): the
//   lane's cp.async copies of its columns of the gathered rows of D run
//   that deep ahead of its ordered adds, in batches of 16 (or half the
//   ring), one commit group each; 16-byte copies go through L1 (`.ca`),
//   which serves the hot rows of D again.  A lane reads only what it
//   copied itself, so cp.async.wait_group needs no barrier.  A batch's
//   values and slots are all read before its adds, so the only chain a
//   nonzero adds is its float adds; a batch inside one row skips the
//   row-end test.  A segment's rows stream through one pipeline: a row's
//   end stores its sums and starts the next row's.
// - `l2_order`: the light items taken column slice by column slice (each
//   slice of D, K x 32 VEC floats, read by every row at about one time)
//   instead of segment by segment, where W spans more than one slice.
// - Index, value and row-end chunks of 32 are loaded a lane each, one
//   chunk ahead, and broadcast by __shfl_sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRingBytes = 256;             // ring bytes a lane
constexpr int kBatch = 16;                  // most nonzeros a batch
constexpr unsigned kFull = 0xffffffffu;

template <int VEC> struct VecT;
template <> struct VecT<1> { using T = float; };
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<4> { using T = float4; };

__device__ __forceinline__ void add_product(float& acc, float v, float d) {
  acc = __fadd_rn(acc, __fmul_rn(v, d));
}
__device__ __forceinline__ void add_product(float2& acc, float v, float2 d) {
  add_product(acc.x, v, d.x);
  add_product(acc.y, v, d.y);
}
__device__ __forceinline__ void add_product(float4& acc, float v, float4 d) {
  add_product(acc.x, v, d.x);
  add_product(acc.y, v, d.y);
  add_product(acc.z, v, d.z);
  add_product(acc.w, v, d.w);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.0f, 0.0f);
}
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's view of src[0..n) in chunks of 32: lane l holds element l of
// the current chunk (`cur`) and of the next (`nxt`, loaded a chunk
// ahead).  advance(q) moves to the chunk holding q where q starts one;
// get(q) broadcasts src[q] (0 past n) from the current chunk.  Every
// lane calls them with the same q, in ascending order.
template <typename T>
struct Stream32 {
  const T* src;
  int n, lane;
  T cur, nxt;
  __device__ __forceinline__ void init(const T* s, int count, int l) {
    src = s;
    n = count;
    lane = l;
    cur = lane < n ? __ldg(src + lane) : T(0);
    nxt = 32 + lane < n ? __ldg(src + 32 + lane) : T(0);
  }
  __device__ __forceinline__ void advance(int q) {
    if ((q & 31) == 0 && q != 0) {       // uniform across the warp
      cur = nxt;
      nxt = q + 32 + lane < n ? __ldg(src + q + 32 + lane) : T(0);
    }
  }
  __device__ __forceinline__ T get(int q) const {
    return __shfl_sync(kFull, cur, q & 31);
  }
  __device__ __forceinline__ T at(int q) {
    advance(q);
    return get(q);
  }
};

// One item: rows [r0, r1) of A, the columns c0 + lane VEC .. + VEC - 1,
// its nonzeros streamed through the lane's ring DEPTH deep in batches
// of GS (one commit group each; a batch lies within one chunk of 32).
// HC > 0 (a heavy item: VEC 1, W % 4 == 0 and D 16-byte aligned): the
// item's slice is HC columns (32 or 16), read by lanes 0..HC-1; the
// lanes copy whole HC-column slices of the batch's rows of D, 16 bytes a
// copy, into slots of HC floats laid out with their 16-byte chunks
// swizzled by the slot, so that a batch costs a copy or a few a lane and
// no index shuffle a nonzero, and the ring holds 2048 / HC nonzeros
// (kRingBytes 256); the lanes then read each other's copies, so the warp
// syncs after its wait and before it refills.  A heavy item's lanes past
// HC read in bounds too (their element masked into the slot), and store
// nothing.
template <int VEC, int HC = 0>
__device__ __forceinline__ void walk_item(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ values, const float* __restrict__ D,
    float* __restrict__ Y, int W, int r0, int r1, int c0, float* ring,
    int lane) {
  using T = typename VecT<VEC>::T;
  constexpr bool WIDE = HC > 0;
  constexpr int SLOT = WIDE ? HC : 32 * VEC;  // floats a slot
  constexpr int DEPTH = 8 * kRingBytes / SLOT;
  constexpr int GS = DEPTH >= 4 * kBatch ? kBatch : DEPTH / 2;
  constexpr int NG = DEPTH / GS;              // batches in flight
  static_assert(GS >= 1 && NG >= 2 && GS * NG == DEPTH && 32 % GS == 0,
                "ring size");
  static_assert((DEPTH & (DEPTH - 1)) == 0, "ring depth a power of 2");
  static_assert(!WIDE || (VEC == 1 && (HC == 16 || HC == 32) &&
                          GS * HC >= 128), "wide copies");
  constexpr int LPN = WIDE ? 32 / GS : 1;     // lanes a nonzero's slice
  constexpr int CPL = WIDE ? HC / 4 / LPN : 1;  // 16-byte copies a lane
  constexpr int SWZ = WIDE ? HC / 4 - 1 : 0;  // chunk swizzle mask
  const int c = c0 + lane * VEC;
  // W % VEC == 0 for VEC > 1; a heavy item's lanes past HC are idle
  const bool active = c < W && (!WIDE || lane < HC);
  const int a0 = __ldg(indptr + r0);
  const int len = __ldg(indptr + r1) - a0;
  T* slots = reinterpret_cast<T*>(ring);      // slot s of lane l: s * 32 + l
  const uint32_t base = static_cast<uint32_t>(
      __cvta_generic_to_shared(slots + lane));
  const float* Dc = D + c;
  Stream32<int> idx;
  Stream32<float> val;
  Stream32<int> ends;                         // the segment's row ends
  idx.init(indices + a0, len, lane);
  val.init(values + a0, len, lane);
  ends.init(indptr + r0 + 1, r1 - r0, lane);

  auto issue = [&](int q0) {                  // the batch at q0, committed
    idx.advance(q0);
    if constexpr (WIDE) {
      const int q = q0 + lane / LPN;          // this lane's nonzero
      const int col = idx.get(q);
      const uint32_t slot = static_cast<uint32_t>(
          __cvta_generic_to_shared(ring + (q & (DEPTH - 1)) * SLOT));
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int j = (lane % LPN) * CPL + i;  // its 16-byte chunk
        if (q < len && c0 + 4 * j < W)
          cp_async<16>(slot + static_cast<uint32_t>((j ^ (q & SWZ)) << 4),
                       D + static_cast<size_t>(col) * W + c0 + 4 * j);
      }
    } else {
#pragma unroll
      for (int s = 0; s < GS; ++s) {
        const int q = q0 + s;
        const int col = idx.get(q);
        if (q < len && active)
          cp_async<4 * VEC>(
              base + static_cast<uint32_t>((q & (DEPTH - 1)) * 32 *
                                           sizeof(T)),
              Dc + static_cast<size_t>(col) * W);
      }
    }
    cp_commit();
  };
  // where lane's element of slot q lies, in T (WIDE: its chunk swizzled)
  auto at_slot = [&](int q) {
    if constexpr (WIDE) {
      const int e = lane & (HC - 1);          // lanes past HC: in bounds
      return (q & (DEPTH - 1)) * SLOT +
             ((((e >> 2) ^ (q & SWZ)) << 2) | (e & 3));
    }
    return (q & (DEPTH - 1)) * 32 + lane;
  };
  T acc = zero<T>();
  int k = 0;                                  // row r0 + k
  int row_end = ends.at(0);
  auto store = [&]() {
    if (active)
      *reinterpret_cast<T*>(Y + static_cast<size_t>(r0 + k) * W + c) = acc;
    acc = zero<T>();
    ++k;
  };

#pragma unroll 1
  for (int g = 0; g < NG; ++g) issue(g * GS);
#pragma unroll 1
  for (int p0 = 0; p0 < len; p0 += GS) {
    cp_wait<NG - 1>();                        // the batch at p0 landed
    if constexpr (WIDE) __syncwarp();         // and the other lanes' too
    val.advance(p0);
    float v[GS];
    T d[GS];
#pragma unroll
    for (int s = 0; s < GS; ++s) {            // all loads first: no chain
      v[s] = val.get(p0 + s);
      d[s] = slots[at_slot(p0 + s)];
    }
    const int nb = min(GS, len - p0);
    if (nb == GS && a0 + p0 + GS <= row_end) {  // inside one row
#pragma unroll
      for (int s = 0; s < GS; ++s) add_product(acc, v[s], d[s]);
    } else {
#pragma unroll
      for (int s = 0; s < GS; ++s) {
        if (s < nb) {
          while (a0 + p0 + s == row_end) {    // rows that end here
            store();
            row_end = ends.at(k);
          }
          add_product(acc, v[s], d[s]);
        }
      }
    }
    if constexpr (WIDE) __syncwarp();         // every lane read its slots
    issue(p0 + DEPTH);                        // into the slots just read
  }
  while (k < r1 - r0) store();                // the last row, empty rows
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float* __restrict__ values,
                    const float* __restrict__ D, float* __restrict__ Y,
                    int W, const int2* __restrict__ segs, int n_heavy,
                    int n_light, int vec_light, int l2_order,
                    int heavy_cols, unsigned* __restrict__ counter,
                    long long* __restrict__ trace) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(smem) + warp * 32 * (kRingBytes / 4);
  const int hc = vec_light == 4 ? heavy_cols : 32;    // heavy slice
  const long long sh = (W + hc - 1) / hc;             // heavy slices
  const int wl = 32 * vec_light;
  const long long sl = (W + wl - 1) / wl;             // light slices
  const long long n_h = static_cast<long long>(n_heavy) * sh;
  const long long n_units = n_h + static_cast<long long>(n_light) * sl;
  auto grab = [&]() -> long long {            // the next item, longest first
    unsigned x = 0;
    if (lane == 0) x = atomicAdd(counter, 1u);
    return __shfl_sync(kFull, x, 0);
  };
  for (long long u = grab(); u < n_units; u = grab()) {
    const long long t0 = trace ? now_ns() : 0;
    if (u < n_h) {
      const int2 sg = segs[u / sh];
      const int c0 = static_cast<int>(u % sh) * hc;
      if (hc == 16)
        walk_item<1, 16>(indptr, indices, values, D, Y, W, sg.x, sg.y, c0,
                         ring, lane);
      else if (vec_light == 4)
        walk_item<1, 32>(indptr, indices, values, D, Y, W, sg.x, sg.y, c0,
                         ring, lane);
      else
        walk_item<1>(indptr, indices, values, D, Y, W, sg.x, sg.y, c0, ring,
                     lane);
    } else {
      const long long v = u - n_h;
      long long i, s;
      if (l2_order) {
        s = v / n_light;
        i = v % n_light;
      } else {
        i = v / sl;
        s = v % sl;
      }
      const int2 sg = segs[n_heavy + i];
      const int c0 = static_cast<int>(s) * wl;
      if (vec_light == 4)
        walk_item<4>(indptr, indices, values, D, Y, W, sg.x, sg.y, c0, ring,
                     lane);
      else if (vec_light == 2)
        walk_item<2>(indptr, indices, values, D, Y, W, sg.x, sg.y, c0, ring,
                     lane);
      else
        walk_item<1>(indptr, indices, values, D, Y, W, sg.x, sg.y, c0, ring,
                     lane);
    }
    if (trace && lane == 0) {                 // item, SM, start, end (ns)
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      trace[4 * u] = u;
      trace[4 * u + 1] = sm;
      trace[4 * u + 2] = t0;
      trace[4 * u + 3] = now_ns();
    }
  }
}

constexpr int kSmemBytes = kWarps * 32 * kRingBytes;

}  // namespace

extern "C" {

// The launch's constants and the blocks an SM holds (after raising the
// kernel's dynamic shared memory to kSmemBytes): out[0] threads a block,
// out[1] ring bytes a lane, out[2] most nonzeros a batch, out[3] blocks
// an SM.
// Returns the first nonzero cudaError (0 = fine).
int csr_spmm_setup(int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      csr_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, csr_spmm_kernel,
                                                    kThreads, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = kThreads;
  out[1] = kRingBytes;
  out[2] = kBatch;
  out[3] = blocks;
  return 0;
}

// segs: (n_heavy + n_light) int32 pairs (first row, end row), the heavy
// segments first; vec_light 1, 2 or 4 (W % vec_light == 0 and D, Y
// aligned to 4 vec_light bytes); heavy_cols 16 or 32, the heavy items'
// slice where vec_light is 4 (else 32); blocks: the persistent grid, as
// spmm_kernels.py `spmm_launch` picks it; counter: one uint32 on the
// card, this launch's alone, zeroed here on `stream` before the kernel;
// trace: null, or 4 int64 an item (item, SM, start and end on the global
// timer, ns) written by its lane 0.  Returns the first nonzero cudaError
// of the memset or the launch (0 = launched).
int csr_spmm(const int* indptr, const int* indices, const float* values,
             const float* D, float* Y, int W, const int* segs, int n_heavy,
             int n_light, int vec_light, int l2_order, int heavy_cols,
             int blocks, unsigned* counter, long long* trace,
             void* stream) {
  if (W < 1 || n_heavy < 0 || n_light < 0 || blocks < 1 ||
      (vec_light != 1 && vec_light != 2 && vec_light != 4) ||
      W % vec_light != 0 ||
      (heavy_cols != 16 && heavy_cols != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_heavy + n_light == 0) return 0;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(unsigned),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  csr_spmm_kernel<<<blocks, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, values, D, Y, W, reinterpret_cast<const int2*>(segs),
      n_heavy, n_light, vec_light, l2_order, heavy_cols, counter, trace);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
