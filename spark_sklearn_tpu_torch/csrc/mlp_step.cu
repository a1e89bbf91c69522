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
//     the logits that `jax.value_and_grad` takes at :248:
//       wsum[b] = max(sum_r w[b,r], 1)
//       loss[b] = sum_r w[b,r] * (lse(Z[b,r,:]) - Z[b,r,y[r]])
//                 or sum_r w[b,r] * 0.5 * |Z[b,r,:] - Yt[r,:]|^2
//       G[b,r,:] = w[b,r] / wsum[b] * (softmax(Z[b,r,:]) - onehot(y[r]))
//                  or w[b,r] / wsum[b] * (Z[b,r,:] - Yt[r,:])
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
// Design: simple and deterministic.  M1 runs one block per lane; each
// thread walks rows with a block stride and the block adds its threads'
// partial sums in shared memory in a fixed tree order, so launches on the
// same inputs give the same bits (no atomics).  M3 is an elementwise
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

constexpr int kThreads = 256;
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

template <bool kRegress>
__global__ void __launch_bounds__(kThreads)
loss_grad(const float* __restrict__ Z, const int* __restrict__ y,
          const float* __restrict__ Yt, const float* __restrict__ w,
          float* __restrict__ G, float* __restrict__ loss,
          float* __restrict__ wsum, int R, int k) {
  __shared__ float red[kThreads];
  const int b = blockIdx.x;
  const float* Zb = Z + static_cast<size_t>(b) * R * k;
  const float* wb = w + static_cast<size_t>(b) * R;
  float* Gb = G + static_cast<size_t>(b) * R * k;

  float s = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) s += wb[r];
  const float ws = fmaxf(block_sum(s, red), 1.f);

  float acc = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float wr = wb[r];
    const float scale = wr / ws;
    const float* z = Zb + static_cast<size_t>(r) * k;
    float* g = Gb + static_cast<size_t>(r) * k;
    if (kRegress) {
      const float* t = Yt + static_cast<size_t>(r) * k;
      float sq = 0.f;
      for (int j = 0; j < k; ++j) {
        const float d = z[j] - t[j];
        sq += d * d;
        g[j] = scale * d;
      }
      acc += wr * (0.5f * sq);
    } else {
      float mx = -INFINITY;
      for (int j = 0; j < k; ++j) mx = fmaxf(mx, z[j]);
      float se = 0.f;
      for (int j = 0; j < k; ++j) {
        const float e = expf(z[j] - mx);
        g[j] = e;                 // exp(z - max), scaled below
        se += e;
      }
      const int yr = y[r];
      acc += wr * (mx + logf(se) - z[yr]);
      for (int j = 0; j < k; ++j)
        g[j] = scale * (g[j] / se - (j == yr ? 1.f : 0.f));
    }
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) {
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

int mlp_loss_grad(const float* Z, const int* y, const float* Yt,
                  const float* w, float* G, float* loss, float* wsum, int B,
                  int R, int k, int regress, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regress)
    loss_grad<true><<<B, kThreads, 0, s>>>(Z, y, Yt, w, G, loss, wsum, R, k);
  else
    loss_grad<false><<<B, kThreads, 0, s>>>(Z, y, Yt, w, G, loss, wsum, R, k);
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
