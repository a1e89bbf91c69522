"""GaussianNB's joint log-likelihood (B1) as a hand-written CUDA kernel
(``csrc/naive_bayes.cu``) with its plain PyTorch version beside it.

- B1 `gnb_jll(X (m, d), theta (B, k, d), var (B, k, d), log_prior (B, k))
  -> jll (B, m, k)`: sklearn's direct form, per lane b, row i and class j

      jll[b, i, j] = (log_prior[b, j] + ll[b, j])
                     - 0.5 * sum_t (X[i, t] - theta[b, j, t])^2 / var[b, j, t]
      ll[b, j]     = -0.5 * sum_t log(2 pi var[b, j, t])

  Replaces `spark_sklearn_tpu/models/naive_bayes.py:174-187` (`_jll`),
  whose broadcast XLA fuses without the (m, k, d) intermediate; a plain
  broadcast over the lanes would hold (B, m, k, d).  The direct form
  stays: with var floored at epsilon the expanded x^2/var - 2 x theta/var
  + theta^2/var rounds differently from sklearn (the reference's comment
  at :178-184).  The kernel multiplies (x - theta)^2 by the correctly
  rounded 1/var (taken once a lane, class and feature) where the plain
  version divides.  A block stages a tile of `JLL_ROWS` rows of X once
  and walks a group of lanes over it two at a time, each thread holding
  2 rows of both lanes and a chunk of up to 8 classes in registers
  (`jll_plan`, `jll_tiles`).

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

#: B1's threads a block, rows a thread and a tile, the transposed tile's
#: stride between features, and most classes of a chunk, as `kThreads`,
#: `kRowsPerThread`, `kRows`, `kXStride` and `kMaxKC` in
#: csrc/naive_bayes.cu
JLL_THREADS = 128
JLL_ROWS_PER_THREAD = 2
JLL_ROWS = JLL_THREADS * JLL_ROWS_PER_THREAD
JLL_X_STRIDE = JLL_ROWS + 2
JLL_MAX_KC = 8
#: lanes a pass over the staged X tile, as `kPass`
JLL_PASS = 2
#: bytes of the X tile a block stages at once (features a chunk follow)
JLL_X_BUDGET = 64 * 1024
#: blocks an SM below which the grid adds lane groups
JLL_BLOCKS_PER_SM = 2

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
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("naive_bayes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gnb_jll.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.gnb_jll.restype = i
    return lib


def jll_plan(m: int, d: int, B: int, k: int, n_sm: int = 132) -> dict:
    """B1's launch: tiles of `JLL_ROWS` rows x groups of `lanes` lanes
    (`grid`), more than one group only where the row tiles give fewer
    than `JLL_BLOCKS_PER_SM` blocks an SM; a block walks its group's
    lanes `JLL_PASS` at a time; a chunk of `kc` classes and of `tc`
    features (an X tile of at most `JLL_X_BUDGET` bytes; with `tc` < d X
    is staged again a chunk), and the block's `smem` bytes."""
    if min(m, d, B, k) < 1:
        raise ValueError(f"gnb_jll: empty shape m={m} d={d} B={B} k={k}")
    kc = min(k, JLL_MAX_KC)
    tc = min(d, JLL_X_BUDGET // (4 * JLL_X_STRIDE))
    tiles = -(-m // JLL_ROWS)
    groups = min(B, max(1, -(-JLL_BLOCKS_PER_SM * n_sm // tiles)))
    lanes = -(-B // groups)
    groups = -(-B // lanes)
    x_floats = -(-tc * JLL_X_STRIDE // 4) * 4
    smem = 4 * (x_floats + JLL_PASS * (24 * tc + JLL_MAX_KC)
                + JLL_ROWS * kc)
    return {"kc": kc, "tc": tc, "lanes": lanes, "grid": (tiles, groups),
            "smem": smem, "threads": JLL_THREADS}


def jll_tiles(plan: dict, m: int, d: int, B: int, k: int):
    """The kernel's work as it walks it: for every block (tile, group),
    for every lane of the group and class chunk, the (lane, rows, classes,
    feature chunks) it computes and writes."""
    tiles, groups = plan["grid"]
    kc, tc, lanes = plan["kc"], plan["tc"], plan["lanes"]
    for g in range(groups):
        for tile in range(tiles):
            r0 = tile * JLL_ROWS
            rows = range(r0, min(m, r0 + JLL_ROWS))
            group = range(g * lanes, min(B, (g + 1) * lanes))
            for p0 in range(group.start, group.stop, JLL_PASS):
                for j0 in range(0, k, kc):
                    for b in range(p0, min(group.stop, p0 + JLL_PASS)):
                        yield (b, rows, range(j0, min(k, j0 + kc)),
                               [range(t0, min(d, t0 + tc))
                                for t0 in range(0, d, tc)])


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
    plan = jll_plan(m, d, B, k, _sm_count(dev.index))
    out = torch.empty((B, m, k), dtype=X.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().gnb_jll(
            X.data_ptr(), theta.data_ptr(), var.data_ptr(),
            log_prior.data_ptr(), out.data_ptr(), m, d, B, k, plan["kc"],
            plan["tc"], plan["lanes"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gnb_jll launch failed: cudaError {rc}")
    LAUNCHES["gnb_jll"] += 1
    return out
