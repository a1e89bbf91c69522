"""KMeans' assignment step (C1) as a hand-written CUDA kernel
(``csrc/kmeans.cu``) with its plain PyTorch version beside it.

- C1 `kmeans_assign(XC (n, B*k), xx (n,), cc (B, k), w (B, n)) ->
  (assign (B, n) int32, min_d2 (B, n), inertia (B,))`: from the library
  GEMM XC = X C_allᵀ of every lane's k centers, the distances

      d2[b, i, j] = max((xx[i] - 2 XC[i, b*k + j]) + cc[b, j], 0)

  in the reference's order, then per lane and row the nearest center
  (the first on ties; the first NaN where there is one, as jnp.argmin)
  and its distance (NaN where any is), and per lane the weighted sum
  Σ_i w[b, i] min_d2[b, i].  Replaces `spark_sklearn_tpu/models/
  cluster.py:31-35` (`_sq_dists` after its GEMM) and its argmin and min
  at `:129-130`, `:145-146` and `:164`: a Lloyd iteration's assignment,
  the final inertia, `predict` and the default scorer's view.
- A thread takes one (row, lane): its k distances are k contiguous
  floats of XC.  A block sums its rows' w·min_d2 in a fixed tree, and a
  second launch adds a lane's blocks in a fixed order: no float atomics,
  so two calls give the same bits (`assign_plan`).

All float32 and contiguous, except `assign`.  A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or
raises — it never falls back.  `LAUNCHES` counts calls that launch the
kernel (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"kmeans_assign": 0}

#: C1's threads (rows) a block, as `kThreads` in csrc/kmeans.cu
ASSIGN_THREADS = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def assign_distances(XC, xx, cc):
    """(B, n, k) squared distances from the GEMM XC (n, B*k), as the
    reference forms them: max((xx - 2 XC) + cc, 0)."""
    B, k = cc.shape
    d2 = torch.clamp_min((xx[:, None] - 2.0 * XC) + cc.reshape(1, B * k),
                         0.0)
    return d2.view(-1, B, k).transpose(0, 1)


def kmeans_assign_plain(XC, xx, cc, w):
    """C1's plain version: argmin and min over the centers (torch's argmin
    takes the first minimum and the first NaN, as jnp.argmin), and the
    weighted sums."""
    d2 = assign_distances(XC, xx, cc)
    assign = torch.argmin(d2, dim=2).to(torch.int32)
    min_d2 = d2.amin(dim=2)
    return assign, min_d2, (w * min_d2).sum(dim=1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("kmeans")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kmeans_assign.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.kmeans_assign.restype = i
    return lib


def assign_plan(n: int, B: int) -> dict:
    """C1's launch: (`blocks` row tiles of `ASSIGN_THREADS` rows) x B lanes,
    then one block a lane adding its `blocks` partial sums."""
    blocks = -(-n // ASSIGN_THREADS)
    return {"blocks": blocks, "threads": ASSIGN_THREADS, "grid": (blocks, B)}


def kmeans_assign(XC, xx, cc, w):
    """C1: each lane's nearest centers, their distances and the lanes'
    weighted sums (see the module docstring)."""
    if XC.device.type == "cpu":
        return kmeans_assign_plain(XC, xx, cc, w)
    if XC.device.type != "cuda":
        raise ValueError(f"unsupported device {XC.device}")
    B, k = cc.shape
    n = xx.shape[0]
    dev = XC.device
    _build.check_tensor("XC", XC, (n, B * k), dev)
    _build.check_tensor("xx", xx, (n,), dev)
    _build.check_tensor("cc", cc, (B, k), dev)
    _build.check_tensor("w", w, (B, n), dev)
    if n < 1 or B < 1 or k < 1 or B > 65535:
        raise ValueError(f"kmeans_assign: shape n={n} B={B} k={k} is not "
                         "supported")
    plan = assign_plan(n, B)
    assign = torch.empty((B, n), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((B, n), dtype=XC.dtype, device=dev)
    # the per-block partial sums, then the lanes' sums
    part = torch.empty(B * plan["blocks"] + B, dtype=XC.dtype, device=dev)
    inertia = part[B * plan["blocks"]:]
    with torch.cuda.device(dev):
        rc = _lib().kmeans_assign(
            XC.data_ptr(), xx.data_ptr(), cc.data_ptr(), w.data_ptr(),
            assign.data_ptr(), min_d2.data_ptr(), part.data_ptr(),
            inertia.data_ptr(), n, B, k, plan["blocks"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign launch failed: cudaError {rc}")
    LAUNCHES["kmeans_assign"] += 1
    return assign, min_d2, inertia
