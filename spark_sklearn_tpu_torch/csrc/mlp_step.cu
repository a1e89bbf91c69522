// The MLP minibatch step's fused passes, for Hopper (sm_90a).  Built with
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (spark_sklearn_tpu_torch/ops/_build.py); the Python wrappers live
// in spark_sklearn_tpu_torch/ops/mlp_kernels.py beside their plain PyTorch
// versions.
//
// Layout: the (candidate x fold) lanes lead every tensor.  A minibatch of
// R rows gives logits Z (B, R, k) row-major, fold weights w (B, R) (the
// lane's weight of each row of the batch, 0 for the padding), labels y
// (R,) int32 (classifier) or targets Yt (R, k) float32 (regressor).  The
// parameters of a lane are one flat row of P floats, layer by layer W then
// b (B, P); `wmask` (P,) marks the weights (1) against the biases (0).
//
// M1  mlp_loss_grad  replaces spark_sklearn_tpu/models/mlp.py:155-164 and
//     :104-107 (classifier), :399-401 (regressor), with the cotangent of
//     the logits that `jax.value_and_grad` takes at :248 and the output
//     layer's bias gradient:
//       wsum[b] = max(sum_r w[b,r], 1)
//       loss[b] = sum_r w[b,r] * (lse(Z[b,r,:]) - Z[b,r,y[r]])
//                 or sum_r w[b,r] * 0.5 * |Z[b,r,:] - Yt[r,:]|^2
//       G[b,r,:] = w[b,r] / wsum[b] * (softmax(Z[b,r,:]) - onehot(y[r]))
//                  or w[b,r] / wsum[b] * (Z[b,r,:] - Yt[r,:])
//       db[b,:] = sum_r G[b,r,:]
// M2  mlp_opt_step   replaces mlp.py:167-193 (`update`: adam, or sgd with
//     momentum) plus the L2 term of :163-164 and the epoch's loss sum of
//     :253-256, for the lanes whose `active` flag is set (a lane that has
//     stopped keeps its parameters and optimizer state):
//       l2 = sum over weights of p^2 (the parameters before the step)
//       acc[b] += (loss[b] / wsum[b] + 0.5 * alpha[b] * l2 / wsum[b]) * wsum[b]
//       g' = g + alpha[b] * p / wsum[b] on the weights, g on the biases
//       adam: t += 1; m = b1 m + (1-b1) g'; v = b2 v + (1-b2) g'^2;
//             p -= lr[b] * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
//       sgd:  m = mu m - lr[b] g'; p += m   (m holds the velocity)
// M3  mlp_act        replaces the hidden layers of mlp.py:60-64 `_forward`
//     and their cotangent in the same `value_and_grad`:
//       forward  H = act(A + b[lane])           (A (B, R, h), b (B, h))
//       backward dA = dH * act'(H)
//     for relu (act' = H > 0, jax.nn.relu's gradient at 0), tanh
//     ((1 + H)(1 - H), as jax's tanh rule), logistic (H (1 - H)) and the
//     identity.
//
// Bound.  At BASELINE #5's shapes (B = 12, R = 200, k = 10, h = 64,
// P = 4874) every pass moves well under 2 MB, under a microsecond at
// an H100's 3.35 TB/s: the step is bound by its launches, and these
// kernels exist to make fewer of them.
//
// Design: deterministic, no atomics: launches on the same inputs give
// the same bits.  M1 runs one block a lane and one thread a row of a
// tile of up to kThreads rows; its time is latency (0.06 us of bytes at
// BASELINE #5), so it keeps every step it can off global memory and off
// the critical path: each warp stages its own 32 rows' logits (and
// targets) and weights by cp.async, 16 bytes a copy where the lane's
// offset allows, and waits for its own copies alone; every warp sums the
// lane's weights itself (a butterfly, the same bits in every warp), their
// loads issued before the rows and their sum taken after the rows' own
// work, which needs w / wsum only for its last multiply, so no barrier
// and no wait on the weights stands before the rows.  A row's operations
// are the earlier design's, in its order and with its roundings (a zero
// numerator of a division skips the division's slow path, with the same
// result), G written over the staged logits.  After the block's one
// barrier, G leaves in 16-byte stores and each warp sums its columns of
// the tile into db (lanes over rows in order, a butterfly, then the tiles
// in order): the output bias gradient, a torch launch of its own before.
// The loss: a butterfly a warp, the warps' partials added in order by one
// thread.  A lane whose tile outgrows the stage goes in tiles of rows; a
// row wider than the stage is read from global memory (its exp computed
// twice, not stored).  With whole-number fold weights, G and wsum keep
// the earlier design's bits (a row's arithmetic is unchanged; such sums
// are exact in any order).  M3 is an elementwise
// pass (0.6 MB read and written at BASELINE #5: 0.2-0.55 us of bytes, so
// its launch and one load's latency are its time): a thread takes 16
// bytes, one float4 load per tensor, where h (forward) or the total
// (backward) is a multiple of 4 and the tensors are aligned, so a launch
// is a quarter of the threads and blocks (150 at BASELINE #5) of a float
// a thread; forward, a lane is a row of the grid, so a thread finds its
// bias column by a 32-bit modulo and no 64-bit division; the activation
// is a template argument, so the pass has no branch on it.  Otherwise
// (h not a multiple of 4, an unaligned view) a float a thread.
// M2 spreads a lane over a thread-block cluster of up
// to 8 blocks (12 lanes x 8 = 96 SMs at BASELINE #5), each taking a few
// rounds of kThreads parameters with all their loads in flight at once;
// one block of one SM a lane walking ~19 rounds of four dependent loads
// each was its time (0.012 ms for 1.6 MB).  Its l2 keeps one order, the
// kThreads strided partials each added in order then the fixed tree, with
// the partials gathered in the first block's shared memory.  A lane's rounds
// are a warp's 32 consecutive floats, four full 32-byte sectors; 16-byte
// loads would need P % 4 == 0 for each lane's row to stay aligned, which
// P = 4874 is not, and the time is latency, not instructions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLossMaxSmem = 49152;  // M1: the stage, at most (no opt-in)
constexpr int kWBatch = 8;           // M1: weights a lane loads first
constexpr int kOptRounds = 4;        // M2: rounds of kThreads a block a wave
constexpr int kOptMaxCluster = 8;    // M2: blocks a lane, at most

// Sum of one value a thread over the block, in a fixed order; every
// thread gets the total.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  float total = red[0];
  __syncthreads();
  return total;
}

// A warp's sum by the xor butterfly: every lane ends with the same bits
// (each pair adds the same two values).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The float offset (0-3) of p within its 16 bytes.
__device__ __forceinline__ int quad_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// n floats of src into dst by the calling warp's cp.async copies, 16
// bytes a copy between a head and a tail of 4-byte copies; dst lies at
// src's offset within 16 bytes (`quad_offset`).
__device__ __forceinline__ void warp_stage(float* dst, const float* src,
                                           int n, int lane) {
  const int head = min((4 - quad_offset(src)) & 3, n);
  if (lane < head) cp_async4(dst + lane, src + lane);
  const int quads = (n - head) >> 2;
  for (int q = lane; q < quads; q += 32)
    cp_async16(dst + head + 4 * q, src + head + 4 * q);
  for (int e = head + 4 * quads + lane; e < n; e += 32)
    cp_async4(dst + e, src + e);
}

// A region of the M1 stage: n floats and the 3 of slack that place its
// first float at its source's offset within 16 bytes, rounded to 16 bytes.
__host__ __device__ constexpr int stage_floats(int n) {
  return (n + 3 + 3) / 4 * 4;
}

// x / y, rounded as IEEE division, for y >= 1 or NaN (a lane's clamped
// weight sum, a row's sum of exp(z - max)): a zero numerator, which
// would take the division's slow path, returns x itself, which is what
// the division gives for such y.
__device__ __forceinline__ float quotient(float x, float y) {
  const float q = (x == 0.f ? 1.f : x) / y;
  return x == 0.f && y == y ? x : q;
}

// One row's loss term (returned) and its G before the lane's scale
// (written to g, which may be the row's staged logits z), each in the
// earlier design's order: d = z - t (regressor) or e / se - onehot
// (classifier), which `scale_row` then multiplies by w / wsum, as the
// earlier design's one rounding of each.  The classifier keeps exp(z -
// max) in g where `keep_e` (g is the stage) or computes it again (g is
// global memory).
template <bool kRegress>
__device__ __forceinline__ float loss_row(const float* z, const float* t,
                                          float* g, int k, int yr, float wr,
                                          bool keep_e) {
  if (kRegress) {
    float sq = 0.f;
    for (int j = 0; j < k; ++j) {
      const float d = z[j] - t[j];
      sq += d * d;
      g[j] = d;
    }
    return wr * (0.5f * sq);
  }
  const float zy = z[yr];
  float mx = -INFINITY;
  for (int j = 0; j < k; ++j) mx = fmaxf(mx, z[j]);
  float se = 0.f;
  for (int j = 0; j < k; ++j) {
    const float e = expf(z[j] - mx);
    if (keep_e) g[j] = e;            // exp(z - max), divided below
    se += e;
  }
  for (int j = 0; j < k; ++j) {
    const float e = keep_e ? g[j] : expf(z[j] - mx);
    g[j] = quotient(e, se) - (j == yr ? 1.f : 0.f);
  }
  return wr * (mx + logf(se) - zy);
}

__device__ __forceinline__ void scale_row(float* g, int k, float scale) {
  for (int j = 0; j < k; ++j) g[j] = scale * g[j];
}

// The sum of x[0], x[s], ..., x[(n - 1) s] over a warp: lane l adds
// elements l, l + 32, ... in order, kBatch loads in flight at a time (the
// padding adds +0, which changes no sum that starts at +0), then the
// butterfly.  Every lane gets the same bits.
__device__ __forceinline__ float warp_strided_sum(const float* x, int n,
                                                  int s, int lane) {
  constexpr int kBatch = 8;
  float acc = 0.f;
  for (int i0 = lane; i0 < n; i0 += 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + 32 * q;
      v[q] = i < n ? x[static_cast<size_t>(i) * s] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) acc += v[q];
  }
  return warp_sum(acc);
}

// M1, one block a lane, one thread a row of a tile of T rows (the block's
// threads: T rounded up to a warp).  Staged: each warp copies its 32 rows'
// logits (and targets) and weights by cp.async into shared memory and waits
// for its own copies alone; the rows' G is written over their logits and,
// after the block's one barrier, leaves in 16-byte stores while each warp
// sums its columns of the tile into db.  Unstaged (a row wider than the
// stage): the rows read global memory and write G there, the classifier
// computing exp twice instead of storing it.
template <bool kRegress, bool kStaged>
__global__ void __launch_bounds__(kThreads)
loss_grad(const float* __restrict__ Z, const int* __restrict__ y,
          const float* __restrict__ Yt, const float* __restrict__ w,
          float* __restrict__ G, float* __restrict__ loss,
          float* __restrict__ wsum, float* __restrict__ db, int R, int k,
          int T) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const float* Zb = Z + static_cast<size_t>(b) * R * k;
  const float* wb = w + static_cast<size_t>(b) * R;
  float* Gb = G + static_cast<size_t>(b) * R * k;
  const int zcap = kStaged ? stage_floats(T * k) : 0;
  float* zbase = stage;
  float* tbase = stage + zcap;
  float* wbase = tbase + (kRegress ? zcap : 0);
  float* red = kStaged ? wbase + stage_floats(T) : stage;

  float acc = 0.f, ws = 0.f;
  for (int r0 = 0; r0 < R; r0 += T) {
    const int rows = min(T, R - r0);
    const size_t off = static_cast<size_t>(r0) * k;
    float* zs = zbase + quad_offset(Zb + off);
    float* ts = tbase + (kRegress ? quad_offset(Yt + off) : 0);
    float* wsh = wbase + quad_offset(wb + r0);
    if (kStaged) {
      // this warp's rows [32 warp, 32 warp + 32) of the tile
      const int lo = min(32 * warp, rows), hi = min(32 * warp + 32, rows);
      warp_stage(zs + lo * k, Zb + off + lo * k, (hi - lo) * k, lane);
      if (kRegress)
        warp_stage(ts + lo * k, Yt + off + lo * k, (hi - lo) * k, lane);
      warp_stage(wsh + lo, wb + r0 + lo, hi - lo, lane);
    }
    const int yr = !kRegress && tid < rows ? y[r0 + tid] : 0;
    // the lane's first weights a lane, loaded now and summed after the
    // rows' own work (which waits for them only to scale G)
    float wv[kWBatch];
    if (r0 == 0) {
#pragma unroll
      for (int q = 0; q < kWBatch; ++q)
        wv[q] = lane + 32 * q < R ? wb[lane + 32 * q] : 0.f;
    }
    if (kStaged) {
      cp_async_wait_all();
      __syncwarp();
    }
    const float wr = tid < rows ? (kStaged ? wsh[tid] : wb[r0 + tid]) : 0.f;
    float* g = kStaged ? zs + tid * k : Gb + off + tid * k;
    if (tid < rows) {
      const float* z = kStaged ? zs + tid * k : Zb + off + tid * k;
      const float* t = kRegress ? (kStaged ? ts : Yt + off) + tid * k
                                : nullptr;
      acc += loss_row<kRegress>(z, t, g, k, yr, wr, kStaged);
    }
    if (r0 == 0) {
      // every warp sums the lane's weights in one order: lane l adds
      // elements l, l + 32, ... (the padding adds +0, which changes no
      // sum that starts at +0), then the butterfly: the same bits in
      // every warp
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWBatch; ++q) s += wv[q];
      for (int r = lane + 32 * kWBatch; r < R; r += 32) s += wb[r];
      ws = fmaxf(warp_sum(s), 1.f);
    }
    if (tid < rows) scale_row(g, k, quotient(wr, ws));
    const bool last = r0 + T >= R;
    if (last) {
      const float part = warp_sum(acc);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();
    if (kStaged) {
      // the tile's G, 16 bytes a store where G's offset allows
      float* gg = Gb + off;
      const int n = rows * k;
      const int head = min((4 - quad_offset(gg)) & 3, n);
      if (tid < head) gg[tid] = zs[tid];
      const int quads = (n - head) >> 2;
      const bool vec_src = quad_offset(zs + head) == 0;
      for (int q = tid; q < quads; q += blockDim.x) {
        const float* src = zs + head + 4 * q;
        *reinterpret_cast<float4*>(gg + head + 4 * q) =
            vec_src ? *reinterpret_cast<const float4*>(src)
                    : make_float4(src[0], src[1], src[2], src[3]);
      }
      for (int e = head + 4 * quads + tid; e < n; e += blockDim.x)
        gg[e] = zs[e];
    }
    // db: warp `warp` takes columns warp, warp + warps, ...; lane l adds
    // rows l, l + 32, ... of the tile in order, then the butterfly, then
    // the tiles in order
    const float* gt = kStaged ? zs : Gb + off;
    for (int j = warp; j < k; j += warps) {
      const float s = warp_strided_sum(gt + j, rows, k, lane);
      if (lane == 0) {
        float* d = db + static_cast<size_t>(b) * k + j;
        *d = r0 == 0 ? s : *d + s;
      }
    }
    if (!last) __syncthreads();
  }
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < warps; ++i) total += red[i];
    loss[b] = total;
    wsum[b] = ws;
  }
}

// One parameter's update (adam or sgd with momentum) with the roundings
// of the one-block kernel it replaced: there nvcc contracted adam's
// b1 m + (1 - b1) g into fma(1 - b1, g, m b1) and b2 v + (1 - b2) g g into
// fma(g, (1 - b2) g, v b2), and fused nothing else (the PTX of both,
// compared on the H100); here the loads come first and nvcc would fuse
// the other products, so adam's two are written out.
template <bool kAdam>
__device__ __forceinline__ void update_one(
    float pi, float gi, bool wm, float mo, float vo, float a, float ws,
    float step, float b1, float b2, float eps, float mu, float c1, float c2,
    float* __restrict__ p, float* __restrict__ m, float* __restrict__ v) {
  if (wm) gi += a * pi / ws;
  if (kAdam) {
    const float mi = __fmaf_rn(1.f - b1, gi, __fmul_rn(mo, b1));
    const float vi =
        __fmaf_rn(gi, __fmul_rn(1.f - b2, gi), __fmul_rn(vo, b2));
    *m = mi;
    *v = vi;
    *p = pi - step * (mi / c1) / (sqrtf(vi / c2) + eps);
  } else {
    const float vel = mu * mo - step * gi;
    *m = vel;
    *p = pi + vel;
  }
}

// M2: a cluster of C blocks a lane.  The lane's P parameters form rounds
// of kThreads (round k holds parameters k * kThreads + t); a wave hands
// each block rb consecutive rounds, every load of a thread's rounds
// issued before its arithmetic.  Each block stores q = p (0 off the
// weights) of its rounds into the first block's shared memory (remote
// stores, in round order); after a cluster barrier the first block adds,
// thread t, the squares of partial t's q in round order from its own
// shared memory (l2 = fma(q, q, l2): the one-block kernel's strided
// partials and order), and after the last wave sums the kThreads
// partials by block_sum's fixed tree.  A second barrier, between waves only, keeps
// the next wave's stores off the buffer until it is read.
template <bool kAdam>
__global__ void __launch_bounds__(kThreads)
opt_step(float* __restrict__ p, const float* __restrict__ g,
         float* __restrict__ m, float* __restrict__ v, float* __restrict__ t,
         const unsigned char* __restrict__ wmask,
         const float* __restrict__ alpha, const float* __restrict__ wsum,
         const float* __restrict__ lr, const unsigned char* __restrict__ active,
         const float* __restrict__ loss, float* __restrict__ acc, int P,
         int C, int rb, float b1, float b2, float eps, float mu) {
  __shared__ float sq[kOptMaxCluster * kOptRounds * kThreads];
  __shared__ float red[kThreads];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  if (!active[b]) return;           // the whole cluster leaves together
  float* sq0 = cluster.map_shared_rank(sq, 0);
  const float a = alpha[b], ws = wsum[b], step = lr[b];
  const float tn = kAdam ? t[b] + 1.f : 0.f;
  const size_t off = static_cast<size_t>(b) * P;
  const int K = (P + kThreads - 1) / kThreads;
  float l2 = 0.f;                   // partial threadIdx.x (first block)
  for (int k0 = 0; k0 < K; k0 += C * rb) {
    const int kb = k0 + c * rb;     // this block's first round
    float pv[kOptRounds], gv[kOptRounds], mv[kOptRounds], vv[kOptRounds];
    bool wv[kOptRounds];
#pragma unroll
    for (int r = 0; r < kOptRounds; ++r) {
      const int i = (kb + r) * kThreads + threadIdx.x;
      const bool in = r < rb && i < P;
      pv[r] = in ? p[off + i] : 0.f;
      gv[r] = in ? g[off + i] : 0.f;
      mv[r] = in ? m[off + i] : 0.f;
      vv[r] = in && kAdam ? v[off + i] : 0.f;
      wv[r] = in && wmask[i];
    }
    const float c1 = kAdam ? 1.f - powf(b1, tn) : 1.f;
    const float c2 = kAdam ? 1.f - powf(b2, tn) : 1.f;
#pragma unroll
    for (int r = 0; r < kOptRounds; ++r) {
      if (r >= rb) break;
      const int i = (kb + r) * kThreads + threadIdx.x;
      sq0[(c * rb + r) * kThreads + threadIdx.x] = wv[r] ? pv[r] : 0.f;
      if (i < P)
        update_one<kAdam>(pv[r], gv[r], wv[r], mv[r], vv[r], a, ws, step, b1,
                          b2, eps, mu, c1, c2, p + off + i, m + off + i,
                          kAdam ? v + off + i : nullptr);
    }
    cluster.sync();
    if (c == 0) {
      const int n = min(C * rb, K - k0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float q = sq[j * kThreads + threadIdx.x];
        l2 = __fmaf_rn(q, q, l2);
      }
    }
    if (k0 + C * rb < K) cluster.sync();
  }
  if (c != 0) return;
  const float total = block_sum(l2, red);
  if (threadIdx.x == 0) {
    acc[b] += (loss[b] / ws + 0.5f * a * total / ws) * ws;
    if (kAdam) t[b] = tn;
  }
}

enum Act { kIdentity = 0, kRelu = 1, kTanh = 2, kLogistic = 3 };

template <int kAct>
__device__ __forceinline__ float act_of(float x) {
  if (kAct == kRelu) return fmaxf(x, 0.f);
  if (kAct == kTanh) return tanhf(x);
  if (kAct == kLogistic) return 1.f / (1.f + expf(-x));
  return x;
}

// the activation's derivative times g, from the activation's output hv
template <int kAct>
__device__ __forceinline__ float act_grad(float g, float hv) {
  if (kAct == kRelu) return hv > 0.f ? g : 0.f;
  if (kAct == kTanh) return (g + g * hv) * (1.f - hv);
  if (kAct == kLogistic) return g * (hv * (1.f - hv));
  return g;
}

// M3 forward, 16 bytes a thread: lane blockIdx.y, float4 i of its R x h
// block (per4 of them), whose four columns' biases are read from the
// lane's bias row (any stride; the row is L1's after the first warp).
template <int kAct>
__global__ void __launch_bounds__(kThreads)
act_forward4(const float4* __restrict__ A, const float* __restrict__ bias,
             float4* __restrict__ H, int per4, int h4, long long ld_bias) {
  const int lane = blockIdx.y;
  const float4* a = A + static_cast<size_t>(lane) * per4;
  float4* o = H + static_cast<size_t>(lane) * per4;
  const float* bl = bias + lane * ld_bias;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < per4;
       i += gridDim.x * kThreads) {
    const float4 x = a[i];
    const float* bj = bl + 4 * (i % h4);
    o[i] = make_float4(act_of<kAct>(x.x + bj[0]), act_of<kAct>(x.y + bj[1]),
                       act_of<kAct>(x.z + bj[2]), act_of<kAct>(x.w + bj[3]));
  }
}

// M3 forward, a float a thread (h not a multiple of 4, or A unaligned)
template <int kAct>
__global__ void __launch_bounds__(kThreads)
act_forward1(const float* __restrict__ A, const float* __restrict__ bias,
             float* __restrict__ H, long long total, int h,
             long long lane_len, long long ld_bias) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long lane = i / lane_len;
    const int j = static_cast<int>(i % h);
    H[i] = act_of<kAct>(A[i] + bias[lane * ld_bias + j]);
  }
}

// M3 backward, 16 bytes a thread (items float4s, fewer than 2^31: 32-bit
// indices)
template <int kAct>
__global__ void __launch_bounds__(kThreads)
act_backward4(const float4* __restrict__ dH, const float4* __restrict__ H,
              float4* __restrict__ dA, int items) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < items;
       i += gridDim.x * kThreads) {
    const float4 g = dH[i];
    const float4 hv = H[i];
    dA[i] = make_float4(act_grad<kAct>(g.x, hv.x), act_grad<kAct>(g.y, hv.y),
                        act_grad<kAct>(g.z, hv.z), act_grad<kAct>(g.w, hv.w));
  }
}

// M3 backward, a float a thread
template <int kAct>
__global__ void __launch_bounds__(kThreads)
act_backward1(const float* __restrict__ dH, const float* __restrict__ H,
              float* __restrict__ dA, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads)
    dA[i] = act_grad<kAct>(dH[i], H[i]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kAct>
int launch_act_forward(const float* A, const float* bias, float* H, int B,
                       int R, int h, long long ld_bias, int vec, int grid_x,
                       cudaStream_t s) {
  const long long total = static_cast<long long>(B) * R * h;
  if (vec)
    act_forward4<kAct><<<dim3(grid_x, B), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(A), bias,
        reinterpret_cast<float4*>(H), R * h / 4, h / 4, ld_bias);
  else
    act_forward1<kAct><<<grid_x, kThreads, 0, s>>>(
        A, bias, H, total, h, static_cast<long long>(R) * h, ld_bias);
  return static_cast<int>(cudaGetLastError());
}

template <int kAct>
int launch_act_backward(const float* dH, const float* H, float* dA,
                        long long total, int vec, int grid_x,
                        cudaStream_t s) {
  if (vec)
    act_backward4<kAct><<<grid_x, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(dH),
        reinterpret_cast<const float4*>(H), reinterpret_cast<float4*>(dA),
        static_cast<int>(total / 4));
  else
    act_backward1<kAct><<<grid_x, kThreads, 0, s>>>(dH, H, dA, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// M1.  T rows a tile (threads: T rounded up to a warp, at most
// kThreads), `staged` in smem bytes of shared memory, as mlp_kernels.py
// `loss_plan` chooses them; db (B, k) gets the output bias gradient.
int mlp_loss_grad(const float* Z, const int* y, const float* Yt,
                  const float* w, float* G, float* loss, float* wsum,
                  float* db, int B, int R, int k, int regress, int T,
                  int staged, int smem, void* stream) {
  if (B < 1 || R < 1 || k < 1 || T < 1 || T > kThreads || smem < 0 ||
      smem > kLossMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (T + 31) / 32 * 32;
  const int warps = threads / 32;
  const int need = staged ? 4 * ((regress ? 2 : 1) * stage_floats(T * k) +
                                 stage_floats(T) + warps)
                          : 4 * warps;
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regress) {
    if (staged)
      loss_grad<true, true><<<B, threads, smem, s>>>(Z, y, Yt, w, G, loss,
                                                     wsum, db, R, k, T);
    else
      loss_grad<true, false><<<B, threads, smem, s>>>(Z, y, Yt, w, G, loss,
                                                      wsum, db, R, k, T);
  } else {
    if (staged)
      loss_grad<false, true><<<B, threads, smem, s>>>(Z, y, Yt, w, G, loss,
                                                      wsum, db, R, k, T);
    else
      loss_grad<false, false><<<B, threads, smem, s>>>(Z, y, Yt, w, G, loss,
                                                       wsum, db, R, k, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// M2.  C blocks a lane (a cluster) and rb rounds of kThreads parameters
// a block a wave, as mlp_kernels.py `opt_plan` chooses them.
int mlp_opt_step(float* p, const float* g, float* m, float* v, float* t,
                 const unsigned char* wmask, const float* alpha,
                 const float* wsum, const float* lr,
                 const unsigned char* active, const float* loss, float* acc,
                 int B, int P, int C, int rb, int adam, float b1, float b2,
                 float eps, float mu, void* stream) {
  if (B < 1 || P < 1 || C < 1 || C > kOptMaxCluster || rb < 1 ||
      rb > kOptRounds || static_cast<long long>(B) * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rc;
  if (adam)
    rc = static_cast<int>(cudaLaunchKernelEx(
        &cfg, opt_step<true>, p, g, m, v, t, wmask, alpha, wsum, lr, active,
        loss, acc, P, C, rb, b1, b2, eps, mu));
  else
    rc = static_cast<int>(cudaLaunchKernelEx(
        &cfg, opt_step<false>, p, g, m, v, t, wmask, alpha, wsum, lr, active,
        loss, acc, P, C, rb, b1, b2, eps, mu));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// M3.  `vec`: 16 bytes a thread (forward: h a multiple of 4, A and H
// 16-byte aligned, a lane a grid row; backward: total a multiple of 4,
// dH, H and dA aligned), else a float a thread; grid_x blocks (a lane's,
// forward with `vec`), as mlp_kernels.py `act_plan` chooses them.
int mlp_act_forward(const float* A, const float* bias, float* H, int B,
                    int R, int h, long long ld_bias, int act, int vec,
                    int grid_x, void* stream) {
  const long long per = static_cast<long long>(R) * h;
  if (B < 1 || R < 1 || h < 1 || grid_x < 1 || act < kIdentity ||
      act > kLogistic ||
      (vec && (h % 4 != 0 || B > 65535 || per >= (1LL << 31) ||
               !aligned16(A) || !aligned16(H))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kRelu:
      return launch_act_forward<kRelu>(A, bias, H, B, R, h, ld_bias, vec,
                                       grid_x, s);
    case kTanh:
      return launch_act_forward<kTanh>(A, bias, H, B, R, h, ld_bias, vec,
                                       grid_x, s);
    case kLogistic:
      return launch_act_forward<kLogistic>(A, bias, H, B, R, h, ld_bias,
                                           vec, grid_x, s);
    default:
      return launch_act_forward<kIdentity>(A, bias, H, B, R, h, ld_bias,
                                           vec, grid_x, s);
  }
}

int mlp_act_backward(const float* dH, const float* H, float* dA,
                     long long total, int act, int vec, int grid_x,
                     void* stream) {
  if (total < 1 || grid_x < 1 || act < kIdentity || act > kLogistic ||
      (vec && (total % 4 != 0 || total / 4 >= (1LL << 31) ||
               !aligned16(dH) || !aligned16(H) || !aligned16(dA))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kRelu:
      return launch_act_backward<kRelu>(dH, H, dA, total, vec, grid_x, s);
    case kTanh:
      return launch_act_backward<kTanh>(dH, H, dA, total, vec, grid_x, s);
    case kLogistic:
      return launch_act_backward<kLogistic>(dH, H, dA, total, vec, grid_x,
                                            s);
    default:
      return launch_act_backward<kIdentity>(dH, H, dA, total, vec, grid_x,
                                            s);
  }
}

}  // extern "C"
