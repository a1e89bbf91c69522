// Fused GLM epilogues of the batched L-BFGS logistic-regression fit, for
// Hopper (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (spark_sklearn_tpu_torch/ops/_build.py);
// the Python wrappers live in spark_sklearn_tpu_torch/ops/glm_kernels.py
// beside their plain PyTorch versions and the launch plan (`launch_plan`).
//
// Layout (the reference's contract, solvers.py `_bcast`): the lane axis of
// the (candidate x fold) tasks sits at position 1, so logits are
// Z (n, B, k) row-major for the multinomial loss and Z (n, B) for the
// binary one (one logit per lane).  wT (n, B) holds each lane's
// per-sample fold weight, y (n,) the encoded labels (int32).
//
// K2  glm_loss_grad   replaces spark_sklearn_tpu/models/linear.py:221-226
//     and :279-286 (`data_loss` / `data_grad`, fused by XLA there):
//       loss[b] = sum_n w[n,b] * (lse(Z[n,b,:]) - Z[n,b,y[n]])
//       G[n,b,:] = w[n,b] * (softmax(Z[n,b,:]) - onehot(y[n]))
//     binary: logaddexp(0, z) - y*z and w*(sigmoid(z) - y).
//     Bound: bytes.  It reads Z and wT once and writes G once: at the
//     headline shape (n=1797, B=5000, k=10) ~0.75 GB, ~0.225 ms at an
//     H100 SXM's 3.35 TB/s (data sheet, 700 W).  One exponential per
//     logit (k <= 16).
//
// K4  glm_trial_loss  replaces spark_sklearn_tpu/ops/solvers.py:290-306
//     (the 16-trial Armijo line search, one vmap over trials there):
//       out[t,b] = sum_n w[n,b] * loss(Z[n,b,:] + alphas[t,b] * Zp[n,b,:])
//     Bound: it reads Z, Zp and wT once (~0.75 GB, ~0.225 ms), but it
//     also evaluates T*n*B*k exponentials plus T*n*B logarithms (1.6e9 at
//     the headline shape): ~0.38 ms at the special-function units' 16
//     results/clock/SM on an H100 SXM's 132 SMs at 1.98 GHz (700 W), so
//     K4 is bound by the SFUs rather than by memory.  A full-precision
//     expf also issues ~7 FMA-pipe instructions, which would make
//     instruction issue the limit, so the staged kernel works in base 2
//     with the SFUs' ex2/lg2 (one instruction each), held to the plain
//     version at the unchanged tolerance by chip_smoke.py and
//     tests/test_torch_cuda.py.
//
// K2l glm_loss_grad_lanes and K4l glm_trial_loss_lanes: the same two
//     epilogues for the keyed fleet's per-key L-BFGS (replacing the loss
//     of spark_sklearn_tpu/models/linear.py:128-158 inside the scalar
//     `lbfgs`, spark_sklearn_tpu/ops/solvers.py:67-163, vmapped over keys
//     by keyed/keyed.py:271-279), over lane-major logits Z (B, n[, k]),
//     the layout `torch.bmm` writes, and with each lane's own labels
//     (label stride n) or one shared label row (stride 0).  Bound: bytes
//     for K2l (Z, W, y read once, G written once); K4l as K4.  A warp a
//     lane, its threads striding the lane's rows (see the section below).
//
// Design.
// - Grid: (ceil(B/32) lane tiles) x (S row splits).  A block is 4 warps;
//   its 32 lanes are one warp's threads, and warp w walks rows
//   r0+w, r0+w+4, ... of the block's split [r0, r1), where split s covers
//   rows [s*n/S, (s+1)*n/S).  The wrapper picks S so that the grid is
//   several waves of resident blocks (glm_kernels.py `launch_plan`).
// - Each block adds its 4 warps' per-lane sums in shared memory in a fixed
//   order and writes them to scratch (S, B) or (S, T, B); `sum_splits`
//   then adds the S partials in split order.  No atomics: the same inputs
//   give the same bits on the same card.
// - k <= 16 (the "staged" kernels, one instantiation per k): one row's
//   span of the tile, Z[i, b0:b0+32, :], is 32*k contiguous floats.  The
//   warp copies it (and K4's Zp span and the wT row) into its own shared
//   buffer with cp.async, lane l taking elements l, l+32, ..., so every
//   warp-wide copy is one full 128-byte line; the buffer is double: row
//   i+4's copy is in flight while row i is computed.  The buffer pads each
//   lane's k logits to an odd stride, so the lanes then read their own
//   logits without bank conflicts.  K2 keeps exp(z - max) in registers for
//   the softmax, writes G back into the same buffer and stores the span
//   with coalesced full-line stores.  K4 keeps its lane's z, zp (scaled
//   by log2 e) and 16 trial sums in registers, the block's 16 trial
//   steps in shared memory.  4-byte copies need
//   no alignment beyond the element's, so odd k, odd B and ragged tiles
//   take the same path (a lane past B copies and computes nothing).
// - Binary and k > 16 (the "direct" kernels): each thread loads its own
//   lane's logits from global memory.  For the binary loss a warp's 32
//   lanes are 128 contiguous bytes, so loads are full lines; for k > 16
//   the lane's k logits are re-read from L1 (two exponentials per logit
//   in K2).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;                 // lanes per block, one a thread
constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kLanes * kWarps;  // 128
constexpr int kKReg = 16;                  // most classes of a staged kernel
constexpr int kTMax = 16;                  // most line-search trials

__device__ __forceinline__ int split_begin(int s, int n, int S) {
  return static_cast<int>((static_cast<long long>(s) * n) / S);
}

__device__ __forceinline__ float softplus_minus(float z, float yb) {
  // logaddexp(0, z) - y*z, in the reference's stable form
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - yb * z;
}

// logsumexp shift: the max, or 0 when the max is not finite (as
// jax.scipy.special.logsumexp and torch.logsumexp do)
__device__ __forceinline__ float lse_shift(float m) {
  return isfinite(m) ? m : 0.f;
}

// The special-function units' base-2 exponential and logarithm, one
// instruction each (expf and logf cost ~8 and ~15, most of them on the
// FMA pipe); subnormal results flush to 0.  Used by K4's staged kernel,
// whose logits are pre-scaled by log2(e) (see there).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float lg2(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// padded stride of one lane's K logits in a stage buffer: odd, so lane x
// reading word x*KP + j hits 32 different banks
template <int K>
struct Stage {
  static constexpr int KP = K | 1;
  static constexpr int kSpan = kLanes * KP;  // floats of one span

  // copy src[0 : count) (count = lanes * K) into dst, lane-padded; lane
  // l copies elements l, l+32, ...: each warp-wide copy is 128 bytes
  __device__ static void copy(float* dst, const float* src, int count,
                              int lane) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int e = lane + j * kLanes;
      if (e < count) cp_async4(dst + (e / K) * KP + e % K, src + e);
    }
  }
};

// per-block finish: add the warps' per-lane sums (red[w][t][lane]) in warp
// order and write them to part[s][t][b0 + lane]
__device__ __forceinline__ void block_finish(const float* red, float* part,
                                             int T, int B, int b0, int nl) {
  for (int q = threadIdx.x; q < T * kLanes; q += kThreads) {
    const int t = q / kLanes, l = q % kLanes;
    if (l < nl) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[(w * T + t) * kLanes + l];
      part[(static_cast<size_t>(blockIdx.y) * T + t) * B + b0 + l] = v;
    }
  }
}

// ---------------------------------------------------------------- K2 ----

template <int K>
__global__ void __launch_bounds__(kThreads, 8)
loss_grad_staged(const float* __restrict__ Z, const float* __restrict__ W,
                 const int* __restrict__ y, float* __restrict__ G,
                 float* __restrict__ part, int n, int B) {
  using St = Stage<K>;
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, B - b0);
  const int r1 = split_begin(blockIdx.y + 1, n, gridDim.y);
  float* zs = smem + warp * 2 * (St::kSpan + kLanes);  // [2][kSpan]
  float* ws = zs + 2 * St::kSpan;                       // [2][kLanes]

  auto stage = [&](int i, int buf) {
    const size_t row = static_cast<size_t>(i) * B + b0;
    St::copy(zs + buf * St::kSpan, Z + row * K, nl * K, lane);
    if (lane < nl) cp_async4(ws + buf * kLanes + lane, W + row + lane);
  };

  float acc = 0.f;
  int i = split_begin(blockIdx.y, n, gridDim.y) + warp;
  int yi = 0;
  if (i < r1) {
    stage(i, 0);
    yi = __ldg(y + i);
  }
  cp_async_commit();
  for (int buf = 0; i < r1; i += kWarps, buf ^= 1) {
    const int inext = i + kWarps;
    int ynext = 0;
    if (inext < r1) {
      stage(inext, buf ^ 1);
      ynext = __ldg(y + inext);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    float* zb = zs + buf * St::kSpan;
    if (lane < nl) {
      float* zr = zb + lane * St::KP;
      const float w = ws[buf * kLanes + lane];
      float e[K];
      float m = -INFINITY, zy = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        e[j] = zr[j];
        m = fmaxf(m, e[j]);
        zy = (j == yi) ? e[j] : zy;
      }
      const float sh = lse_shift(m);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        e[j] = expf(e[j] - sh);
        s += e[j];
      }
      acc += w * (sh + logf(s) - zy);
      const float inv = 1.f / s;
#pragma unroll
      for (int j = 0; j < K; ++j)
        zr[j] = w * (e[j] * inv - (j == yi ? 1.f : 0.f));
    }
    __syncwarp();
    float* gr = G + (static_cast<size_t>(i) * B + b0) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int el = lane + j * kLanes;
      if (el < nl * K) gr[el] = zb[(el / K) * St::KP + el % K];
    }
    __syncwarp();  // the next iteration's copy refills this buffer
    yi = ynext;
  }
  __syncthreads();
  smem[warp * kLanes + lane] = acc;
  __syncthreads();
  block_finish(smem, part, 1, B, b0, nl);
}

// binary, and multinomial with k > 16 (logits re-read from L1)
template <bool BINARY>
__global__ void __launch_bounds__(kThreads, 8)
loss_grad_direct(const float* __restrict__ Z, const float* __restrict__ W,
                 const int* __restrict__ y, float* __restrict__ G,
                 float* __restrict__ part, int n, int B, int k) {
  __shared__ float red[kWarps * kLanes];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, B - b0);
  const int b = b0 + lane;
  const int r1 = split_begin(blockIdx.y + 1, n, gridDim.y);
  float acc = 0.f;
  if (lane < nl) {
    for (int i = split_begin(blockIdx.y, n, gridDim.y) + warp; i < r1;
         i += kWarps) {
      const size_t row = static_cast<size_t>(i) * B + b;
      const float w = W[row];
      const int yi = __ldg(y + i);
      if (BINARY) {
        const float z = Z[row];
        const float yb = static_cast<float>(yi);
        const float e = expf(-fabsf(z));  // shared by loss and sigmoid
        acc += w * (fmaxf(z, 0.f) + log1pf(e) - yb * z);
        const float r = 1.f / (1.f + e);
        G[row] = w * ((z >= 0.f ? r : e * r) - yb);
      } else {
        const float* zr = Z + row * k;
        float* gr = G + row * k;
        float m = -INFINITY, zy = 0.f;
        for (int j = 0; j < k; ++j) {
          const float v = zr[j];
          m = fmaxf(m, v);
          zy = (j == yi) ? v : zy;
        }
        const float sh = lse_shift(m);
        float s = 0.f;
        for (int j = 0; j < k; ++j) s += expf(zr[j] - sh);
        acc += w * (sh + logf(s) - zy);
        const float inv = 1.f / s;
        for (int j = 0; j < k; ++j)
          gr[j] = w * (expf(zr[j] - sh) * inv - (j == yi ? 1.f : 0.f));
      }
    }
  }
  red[warp * kLanes + lane] = acc;
  __syncthreads();
  block_finish(red, part, 1, B, b0, nl);
}

// ---------------------------------------------------------------- K4 ----

template <int K>
__global__ void __launch_bounds__(kThreads, K <= 12 ? 6 : 4)
trial_loss_staged(const float* __restrict__ Z, const float* __restrict__ Zp,
                  const float* __restrict__ W, const int* __restrict__ y,
                  const float* __restrict__ alphas, float* __restrict__ part,
                  int n, int B, int T) {
  using St = Stage<K>;
  extern __shared__ float smem[];
  __shared__ float as[kTMax][kLanes];  // the trial steps, shared by warps
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, B - b0);
  const int r1 = split_begin(blockIdx.y + 1, n, gridDim.y);
  float* zs = smem + warp * (4 * St::kSpan + 2 * kLanes);  // Z [2][kSpan]
  float* ps = zs + 2 * St::kSpan;                          // Zp [2][kSpan]
  float* ws = ps + 2 * St::kSpan;                          // wT [2][kLanes]

  auto stage = [&](int i, int buf) {
    const size_t row = static_cast<size_t>(i) * B + b0;
    St::copy(zs + buf * St::kSpan, Z + row * K, nl * K, lane);
    St::copy(ps + buf * St::kSpan, Zp + row * K, nl * K, lane);
    if (lane < nl) cp_async4(ws + buf * kLanes + lane, W + row + lane);
  };

  // the steps live in shared memory (one load a trial) rather than in 16
  // more registers a thread
  for (int q = threadIdx.x; q < T * kLanes; q += kThreads) {
    const int t = q / kLanes, l = q % kLanes;
    as[t][l] = l < nl ? alphas[static_cast<size_t>(t) * B + b0 + l] : 0.f;
  }
  float acc[kTMax];
#pragma unroll
  for (int t = 0; t < kTMax; ++t) acc[t] = 0.f;
  int i = split_begin(blockIdx.y, n, gridDim.y) + warp;
  int yi = 0;
  if (i < r1) {
    stage(i, 0);
    yi = __ldg(y + i);
  }
  cp_async_commit();
  __syncthreads();
  for (int buf = 0; i < r1; i += kWarps, buf ^= 1) {
    const int inext = i + kWarps;
    int ynext = 0;
    if (inext < r1) {
      stage(inext, buf ^ 1);
      ynext = __ldg(y + inext);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    if (lane < nl) {
      const float* zr = zs + buf * St::kSpan + lane * St::KP;
      const float* pr = ps + buf * St::kSpan + lane * St::KP;
      const float w = ws[buf * kLanes + lane];
      // base 2: lse(v) = ln2 * lse2(v * log2e), so with z and zp scaled
      // by log2(e) once a row, each logit of each trial costs an FMA, a
      // max, a subtract, one ex2 and an add.  The result stays within
      // the plain version's tolerance (rtol 1e-5 on the sums; ~3.4e-7
      // relative at the headline shape on an H100).
      // The label's logit is subtracted in base 2 too, bit for bit the
      // v[y] of the trial, so a row whose label holds the max loses
      // nothing to cancellation (k = 1 gives exactly 0).
      float z[K], p[K];
      float zy = 0.f, py = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        z[j] = zr[j] * kLog2e;
        p[j] = pr[j] * kLog2e;
        zy = (j == yi) ? z[j] : zy;
        py = (j == yi) ? p[j] : py;
      }
#pragma unroll
      for (int t = 0; t < kTMax; ++t) {
        if (t >= T) break;
        const float at = as[t][lane];
        float v[K];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          v[j] = fmaf(at, p[j], z[j]);
          m = fmaxf(m, v[j]);
        }
        const float sh = lse_shift(m);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) s += ex2(v[j] - sh);
        acc[t] += w * (kLn2 * ((sh - fmaf(at, py, zy)) + lg2(s)));
      }
    }
    __syncwarp();  // the next iteration's copy refills this buffer
    yi = ynext;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kTMax; ++t)
    if (t < T) smem[(warp * T + t) * kLanes + lane] = acc[t];
  __syncthreads();
  block_finish(smem, part, T, B, b0, nl);
}

// binary, and multinomial with k > 16 (logits re-read from L1)
template <bool BINARY>
__global__ void __launch_bounds__(kThreads, 8)
trial_loss_direct(const float* __restrict__ Z, const float* __restrict__ Zp,
                  const float* __restrict__ W, const int* __restrict__ y,
                  const float* __restrict__ alphas, float* __restrict__ part,
                  int n, int B, int k, int T) {
  __shared__ float red[kWarps * kTMax * kLanes];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, B - b0);
  const int b = b0 + lane;
  const int r1 = split_begin(blockIdx.y + 1, n, gridDim.y);
  float a[kTMax], acc[kTMax];
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
    a[t] = (lane < nl && t < T) ? alphas[static_cast<size_t>(t) * B + b]
                                : 0.f;
    acc[t] = 0.f;
  }
  if (lane < nl) {
    for (int i = split_begin(blockIdx.y, n, gridDim.y) + warp; i < r1;
         i += kWarps) {
      const size_t row = static_cast<size_t>(i) * B + b;
      const float w = W[row];
      const int yi = __ldg(y + i);
      if (BINARY) {
        const float z = Z[row], zp = Zp[row];
        const float yb = static_cast<float>(yi);
#pragma unroll
        for (int t = 0; t < kTMax; ++t)
          if (t < T) acc[t] += w * softplus_minus(fmaf(a[t], zp, z), yb);
      } else {
        const float* zr = Z + row * k;
        const float* pr = Zp + row * k;
        const bool in = 0 <= yi && yi < k;
        const float zy = in ? zr[yi] : 0.f, py = in ? pr[yi] : 0.f;
#pragma unroll
        for (int t = 0; t < kTMax; ++t) {
          if (t >= T) break;
          float m = -INFINITY;
          for (int j = 0; j < k; ++j) m = fmaxf(m, fmaf(a[t], pr[j], zr[j]));
          const float sh = lse_shift(m);
          float s = 0.f;
          for (int j = 0; j < k; ++j)
            s += expf(fmaf(a[t], pr[j], zr[j]) - sh);
          acc[t] += w * (sh + logf(s) - fmaf(a[t], py, zy));
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTMax; ++t)
    if (t < T) red[(warp * T + t) * kLanes + lane] = acc[t];
  __syncthreads();
  block_finish(red, part, T, B, b0, nl);
}

// -------------------------------------------------- lane-major modes ----
//
// K2l / K4l: the same losses over logits laid out lane-major, as the keyed
// fleet's per-key GEMM (`torch.bmm`) writes them: Z (B, n, k) or (B, n),
// W (B, n), and labels y[b * label_stride + i]: label_stride 0 shares
// one label row (n,) between the lanes, label_stride n gives each lane
// its own (B, n).  A warp takes one lane; its threads walk rows r0 +
// lane, r0 + lane + 32, ... of the block's split, so a warp's loads of a
// row step are one contiguous piece of the lane's logits.  Each thread
// sums its rows, a shuffle tree adds the warp's 32 sums in a fixed
// order, and `sum_splits` adds the splits in order: no atomics.

constexpr int kLaneWarps = 4;  // lanes a block, a warp each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool BINARY>
__global__ void __launch_bounds__(kThreads, 8)
loss_grad_lanes(const float* __restrict__ Z, const float* __restrict__ W,
                const int* __restrict__ y, float* __restrict__ G,
                float* __restrict__ part, int n, int B, int k,
                int label_stride) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int b = blockIdx.x * kLaneWarps + warp;
  if (b >= B) return;  // a whole warp: no shuffle or barrier left behind
  const int r1 = split_begin(blockIdx.y + 1, n, gridDim.y);
  const size_t lb = static_cast<size_t>(b) * n;
  const int* yl = y + static_cast<size_t>(b) * label_stride;
  float acc = 0.f;
  for (int i = split_begin(blockIdx.y, n, gridDim.y) + lane; i < r1;
       i += kLanes) {
    const size_t row = lb + i;
    const float w = W[row];
    const int yi = __ldg(yl + i);
    if (BINARY) {
      const float z = Z[row];
      const float yb = static_cast<float>(yi);
      const float e = expf(-fabsf(z));  // shared by loss and sigmoid
      acc += w * (fmaxf(z, 0.f) + log1pf(e) - yb * z);
      const float r = 1.f / (1.f + e);
      G[row] = w * ((z >= 0.f ? r : e * r) - yb);
    } else {
      const float* zr = Z + row * k;
      float* gr = G + row * k;
      float m = -INFINITY, zy = 0.f;
      for (int j = 0; j < k; ++j) {
        const float v = zr[j];
        m = fmaxf(m, v);
        zy = (j == yi) ? v : zy;
      }
      const float sh = lse_shift(m);
      float s = 0.f;
      for (int j = 0; j < k; ++j) s += expf(zr[j] - sh);
      acc += w * (sh + logf(s) - zy);
      const float inv = 1.f / s;
      for (int j = 0; j < k; ++j)
        gr[j] = w * (expf(zr[j] - sh) * inv - (j == yi ? 1.f : 0.f));
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) part[static_cast<size_t>(blockIdx.y) * B + b] = acc;
}

template <bool BINARY>
__global__ void __launch_bounds__(kThreads, 8)
trial_loss_lanes(const float* __restrict__ Z, const float* __restrict__ Zp,
                 const float* __restrict__ W, const int* __restrict__ y,
                 const float* __restrict__ alphas, float* __restrict__ part,
                 int n, int B, int k, int T, int label_stride) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int b = blockIdx.x * kLaneWarps + warp;
  if (b >= B) return;
  const int r1 = split_begin(blockIdx.y + 1, n, gridDim.y);
  const size_t lb = static_cast<size_t>(b) * n;
  const int* yl = y + static_cast<size_t>(b) * label_stride;
  float a[kTMax], acc[kTMax];
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
    a[t] = t < T ? alphas[static_cast<size_t>(t) * B + b] : 0.f;
    acc[t] = 0.f;
  }
  for (int i = split_begin(blockIdx.y, n, gridDim.y) + lane; i < r1;
       i += kLanes) {
    const size_t row = lb + i;
    const float w = W[row];
    const int yi = __ldg(yl + i);
    if (BINARY) {
      const float z = Z[row], zp = Zp[row];
      const float yb = static_cast<float>(yi);
#pragma unroll
      for (int t = 0; t < kTMax; ++t)
        if (t < T) acc[t] += w * softplus_minus(fmaf(a[t], zp, z), yb);
    } else {
      const float* zr = Z + row * k;
      const float* pr = Zp + row * k;
      const bool in = 0 <= yi && yi < k;
      const float zy = in ? zr[yi] : 0.f, py = in ? pr[yi] : 0.f;
#pragma unroll
      for (int t = 0; t < kTMax; ++t) {
        if (t >= T) break;
        float m = -INFINITY;
        for (int j = 0; j < k; ++j) m = fmaxf(m, fmaf(a[t], pr[j], zr[j]));
        const float sh = lse_shift(m);
        float s = 0.f;
        for (int j = 0; j < k; ++j) s += expf(fmaf(a[t], pr[j], zr[j]) - sh);
        acc[t] += w * (sh + logf(s) - fmaf(a[t], py, zy));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTMax; ++t) {
    if (t >= T) break;
    const float v = warp_sum(acc[t]);
    if (lane == 0)
      part[(static_cast<size_t>(blockIdx.y) * T + t) * B + b] = v;
  }
}

// ------------------------------------------------------------ finish ----

// out[m] = sum over s (in order) of part[s][m]
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, int S, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[static_cast<size_t>(s) * M + m];
  out[m] = v;
}

int finish(const float* part, float* out, int S, int M, cudaStream_t s) {
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  sum_splits<<<(M + 255) / 256, 256, 0, s>>>(part, out, S, M);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
void launch_loss_grad(dim3 grid, cudaStream_t s, const float* Z,
                      const float* W, const int* y, float* G, float* part,
                      int n, int B) {
  const size_t bytes =
      sizeof(float) * kWarps * 2 * (Stage<K>::kSpan + kLanes);
  loss_grad_staged<K><<<grid, kThreads, bytes, s>>>(Z, W, y, G, part, n, B);
}

template <int K>
void launch_trial_loss(dim3 grid, cudaStream_t s, const float* Z,
                       const float* Zp, const float* W, const int* y,
                       const float* alphas, float* part, int n, int B,
                       int T) {
  const size_t staging =
      sizeof(float) * kWarps * (4 * Stage<K>::kSpan + 2 * kLanes);
  const size_t reduce = sizeof(float) * kWarps * kTMax * kLanes;
  trial_loss_staged<K><<<grid, kThreads, staging > reduce ? staging : reduce,
                         s>>>(Z, Zp, W, y, alphas, part, n, B, T);
}

#define GLM_FOR_EACH_K(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

}  // namespace

extern "C" {

// Both entry points write per-split partial sums to `part` ((S, B) for
// K2, (S, T, B) for K4, allocated by the caller) and add them into the
// output with a second launch.  Each returns the first nonzero
// cudaGetLastError() of its launches (0 = launched).
int glm_loss_grad(const float* Z, const float* W, const int* y, float* G,
                  float* loss, float* part, int n, int B, int k, int binary,
                  int S, void* stream) {
  if (S < 1 || n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kLanes - 1) / kLanes, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (binary) {
    loss_grad_direct<true><<<grid, kThreads, 0, s>>>(Z, W, y, G, part, n, B,
                                                     k);
  } else if (k <= kKReg) {
    switch (k) {
#define GLM_CASE(KK) \
  case KK:           \
    launch_loss_grad<KK>(grid, s, Z, W, y, G, part, n, B); break;
      GLM_FOR_EACH_K(GLM_CASE)
#undef GLM_CASE
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    loss_grad_direct<false><<<grid, kThreads, 0, s>>>(Z, W, y, G, part, n,
                                                      B, k);
  }
  return finish(part, loss, S, B, s);
}

int glm_trial_loss(const float* Z, const float* Zp, const float* W,
                   const int* y, const float* alphas, float* out,
                   float* part, int n, int B, int k, int T, int binary,
                   int S, void* stream) {
  if (T < 1 || T > kTMax || S < 1 || n < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kLanes - 1) / kLanes, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (binary) {
    trial_loss_direct<true><<<grid, kThreads, 0, s>>>(Z, Zp, W, y, alphas,
                                                      part, n, B, k, T);
  } else if (k <= kKReg) {
    switch (k) {
#define GLM_CASE(KK)                                                    \
  case KK:                                                              \
    launch_trial_loss<KK>(grid, s, Z, Zp, W, y, alphas, part, n, B, T); \
    break;
      GLM_FOR_EACH_K(GLM_CASE)
#undef GLM_CASE
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    trial_loss_direct<false><<<grid, kThreads, 0, s>>>(Z, Zp, W, y, alphas,
                                                       part, n, B, k, T);
  }
  return finish(part, out, S, T * B, s);
}

// The lane-major modes (K2l, K4l): Z (B, n[, k]), W (B, n), labels
// y[b * label_stride + i] (label_stride 0 or n); a block of 4 warps takes
// 4 lanes, grid (ceil(B/4), S).  Partials and the second launch as above.
int glm_loss_grad_lanes(const float* Z, const float* W, const int* y,
                        float* G, float* loss, float* part, int n, int B,
                        int k, int binary, int label_stride, int S,
                        void* stream) {
  if (S < 1 || n < 1 || B < 1 || k < 1 ||
      !(label_stride == 0 || label_stride == n))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kLaneWarps - 1) / kLaneWarps, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (binary)
    loss_grad_lanes<true><<<grid, kThreads, 0, s>>>(Z, W, y, G, part, n, B,
                                                    k, label_stride);
  else
    loss_grad_lanes<false><<<grid, kThreads, 0, s>>>(Z, W, y, G, part, n,
                                                     B, k, label_stride);
  return finish(part, loss, S, B, s);
}

int glm_trial_loss_lanes(const float* Z, const float* Zp, const float* W,
                         const int* y, const float* alphas, float* out,
                         float* part, int n, int B, int k, int T,
                         int binary, int label_stride, int S,
                         void* stream) {
  if (T < 1 || T > kTMax || S < 1 || n < 1 || B < 1 || k < 1 ||
      !(label_stride == 0 || label_stride == n))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kLaneWarps - 1) / kLaneWarps, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (binary)
    trial_loss_lanes<true><<<grid, kThreads, 0, s>>>(
        Z, Zp, W, y, alphas, part, n, B, k, T, label_stride);
  else
    trial_loss_lanes<false><<<grid, kThreads, 0, s>>>(
        Z, Zp, W, y, alphas, part, n, B, k, T, label_stride);
  return finish(part, out, S, T * B, s);
}

}  // extern "C"
