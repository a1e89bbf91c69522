"""GaussianNB's joint log-likelihood (B1) as a hand-written CUDA kernel
(``csrc/naive_bayes.cu``) with its plain PyTorch version beside it.

- B1 `gnb_jll(X (m, d), theta (B, k, d), var (B, k, d), log_prior (B, k))
  -> jll (B, m, k)`: sklearn's direct form, per lane b, row i and class j

      jll[b, i, j] = (log_prior[b, j] + ll[b, j])
                     - 0.5 * sum_t (X[i, t] - theta[b, j, t])^2 / var[b, j, t]
      ll[b, j]     = -0.5 * sum_t log(2 pi var[b, j, t])

  Replaces `spark_sklearn_tpu/models/naive_bayes.py:174-187` (`_jll`),
  whose broadcast XLA fuses without the (m, k, d) intermediate; a plain
  broadcast over the lanes would hold (B, m, k, d).  The division stays:
  with var floored at epsilon the expanded x^2/var - 2 x theta/var +
  theta^2/var rounds differently from sklearn (the reference's comment
  at :178-184).  A block takes a tile of rows of one lane and stages the
  rows and a chunk of the lane's classes (theta and var) in shared
  memory, each padded to an odd stride (`jll_plan`).

Shapes: all float32 and contiguous.  The plain version loops over row
blocks, so that the CPU holds at most `PLAIN_ELEMS` elements of the
broadcast at once.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"gnb_jll": 0}

#: B1's threads a block, most rows of a tile and shared-memory budget of a
#: block (bytes), as `kThreads`, `kMaxRows` in csrc/naive_bayes.cu
JLL_THREADS = 256
JLL_MAX_ROWS = 32
JLL_SMEM_BUDGET = 100 * 1024

#: most elements of the (B, rows, k, d) broadcast the plain version holds
PLAIN_ELEMS = 1 << 22


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gnb_jll_plain(X, theta, var, log_prior):
    """B1's plain version: the reference's `_jll` on every lane, a block
    of rows at a time."""
    B, k, d = theta.shape
    m = X.shape[0]
    ll = -0.5 * torch.log(2.0 * math.pi * var).sum(dim=2)       # (B, k)
    base = (log_prior + ll)[:, None, :]                         # (B, 1, k)
    step = max(1, PLAIN_ELEMS // max(1, B * k * d))
    out = torch.empty((B, m, k), dtype=X.dtype, device=X.device)
    for lo in range(0, m, step):
        diff = X[None, lo:lo + step, None, :] - theta[:, None, :, :]
        q = 0.5 * ((diff * diff) / var[:, None, :, :]).sum(dim=3)
        out[:, lo:lo + step] = base - q
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("naive_bayes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gnb_jll.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.gnb_jll.restype = i
    return lib


def jll_plan(k: int, d: int) -> dict:
    """B1's launch for k classes of d features: a tile of `rows` rows
    (at most `JLL_MAX_ROWS`) and a chunk of `kc` classes in shared memory,
    (rows + 2 kc) padded rows of d + 1 floats within `JLL_SMEM_BUDGET`;
    a block walks the lane's classes chunk by chunk."""
    row_bytes = 4 * (d + 1)
    rows = JLL_MAX_ROWS
    while rows > 1 and (rows + 2) * row_bytes > JLL_SMEM_BUDGET:
        rows //= 2
    kc = min(k, (JLL_SMEM_BUDGET // row_bytes - rows) // 2)
    if kc < 1:
        raise ValueError(
            f"gnb_jll: d={d} features do not fit the kernel's shared "
            f"memory ({JLL_SMEM_BUDGET} bytes a block)")
    smem = (rows + 2 * kc) * row_bytes + 4 * kc
    return {"rows": rows, "kc": kc, "smem": smem, "threads": JLL_THREADS}


def gnb_jll(X, theta, var, log_prior):
    """B1: GaussianNB's joint log-likelihood for every lane (see the
    module docstring); one launch."""
    if X.device.type == "cpu":
        return gnb_jll_plain(X, theta, var, log_prior)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    m, d = X.shape
    B, k = log_prior.shape
    dev = X.device
    _build.check_tensor("X", X, (m, d), dev)
    _build.check_tensor("theta", theta, (B, k, d), dev)
    _build.check_tensor("var", var, (B, k, d), dev)
    _build.check_tensor("log_prior", log_prior, (B, k), dev)
    if m < 1 or d < 1 or B < 1 or k < 1:
        raise ValueError(f"gnb_jll: empty shape m={m} d={d} B={B} k={k}")
    plan = jll_plan(k, d)
    out = torch.empty((B, m, k), dtype=X.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().gnb_jll(
            X.data_ptr(), theta.data_ptr(), var.data_ptr(),
            log_prior.data_ptr(), out.data_ptr(), m, d, B, k, plan["rows"],
            plan["kc"], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gnb_jll launch failed: cudaError {rc}")
    LAUNCHES["gnb_jll"] += 1
    return out
