"""KNN's fold-masked top-k over the distance Gram (N1) as a hand-written
CUDA kernel (``csrc/knn_topk.cu``) with its plain PyTorch version beside
it.

- N1 `knn_fold_topk(G (m, n), sq_rows (m,), sq_cols (n,), train_masks
  (F, n), maxk) -> (d2 (F, m, maxk), idx (F, m, maxk))`: for every fold
  f and row i, the maxk smallest of

      D[i, j] = max((sq_rows[i] + sq_cols[j]) - 2 G[i, j], 0)

  over the columns j with train_masks[f, j] > 0 (the others count as
  +inf), ascending by (D, j), and their column indices (int32).  G is
  the library GEMM X Xᵀ (the search) or X_new X_trainᵀ (the holder's
  predict, one all-ones mask).  Replaces `spark_sklearn_tpu/models/
  neighbors.py:64-79` (`_sq_dists` after its GEMM, and `_fold_neighbors`'
  mask and `lax.top_k`, run once a fold there).  A fold with fewer train
  columns than maxk ends in +inf entries on the lowest-indexed masked
  columns, as `lax.top_k` gives them.
- `topk_plan` picks the launch.  "warp" (maxk <= `WARP_MAX_K`): a warp
  a row streams its row of G once and serves every fold of its group
  (up to `WARP_FOLDS`) from that pass; per fold the warp holds the 32
  smallest (distance, column) keys so far, a key a lane, and most
  columns are turned away by one compare against every fold's maxk-th
  key.  The block stages its group's fold masks once as bits and walks
  rows (a persistent grid).  Above `WARP_MAX_K`, or where a group's
  mask bits pass `WARP_MAX_MASK_BYTES`, a block takes one row: it forms
  the row's distances once and keeps them in shared memory for all F
  folds where n <= `STAGED_MAX_N` ("staged"; above, "streamed": each
  pass forms them again from G), then per fold finds the maxk-th
  smallest key by a 4-pass radix select, gathers the keys below it and
  the lowest-indexed keys equal to it, and sorts those maxk by (D, j)
  with a bitonic sort.  Every plan gives the plain version's bits.

maxk is at most `MAX_K`; the wrapper raises above it, and where maxk
exceeds n.  All tensors float32 and contiguous.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"knn_fold_topk": 0}

#: the largest maxk N1 takes (its sort's width), as `kMaxK` in
#: csrc/knn_topk.cu
MAX_K = 1024
#: most columns a row keeps in shared memory (8 bytes each: the distance
#: and a fold's key), as `kStagedMaxN`
STAGED_MAX_N = 26000
#: threads a block of the staged and streamed plans (one block a row), as
#: `kThreads`
TOPK_THREADS = 256
#: the largest maxk of the warp plan (a key a lane), as `kWarpMaxK`
WARP_MAX_K = 32
#: most folds a warp serves from one pass over its row, as `kWarpFolds`
WARP_FOLDS = 8
#: threads a block of the warp plan (a warp a row), as `kWarpThreads`
WARP_THREADS = 256
#: most bytes of fold-mask bits a warp-plan block stages, as
#: `kWarpMaxMaskBytes`
WARP_MAX_MASK_BYTES = 96 * 1024
#: the plans' codes in the C interface
PLANS = ("warp", "staged", "streamed")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sq_dists(G, sq_rows, sq_cols):
    """The reference's squared distances from the product G:
    max((sq_i + sq_j) - 2 G_ij, 0) (`_sq_dists`, neighbors.py:64)."""
    return torch.clamp_min((sq_rows[:, None] + sq_cols[None, :]) - 2.0 * G,
                           0.0)


def knn_fold_topk_plain(G, sq_rows, sq_cols, train_masks, maxk: int):
    """N1's plain version: a stable ascending sort of each fold's masked
    distances (ties to the lower column, as lax.top_k), cut at maxk."""
    D = sq_dists(G, sq_rows, sq_cols)                         # (m, n)
    inf = torch.tensor(float("inf"), dtype=D.dtype, device=D.device)
    d2, idx = [], []
    for f in range(train_masks.shape[0]):
        Dm = torch.where(train_masks[f][None, :] > 0, D, inf)
        v, i = torch.sort(Dm, dim=1, stable=True)
        d2.append(v[:, :maxk])
        idx.append(i[:, :maxk].to(torch.int32))
    return torch.stack(d2), torch.stack(idx)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("knn_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn_fold_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.knn_fold_topk.restype = i
    return lib


def topk_plan(n: int, maxk: int, F: int = 1, plan: str | None = None
              ) -> dict:
    """N1's launch for rows of n columns under F fold masks: "warp" where
    maxk <= `WARP_MAX_K` and a fold group's mask bits fit
    `WARP_MAX_MASK_BYTES` (F in `groups` even groups of at most
    `WARP_FOLDS`), else "staged" (the row's distances and a fold's keys in
    shared memory) up to `STAGED_MAX_N` columns, else "streamed"; `smem`
    bytes of shared memory a block; the radix plans' sort width `P`, the
    power of two at or above maxk.  `plan` asks for one plan (the card
    tests hold each to the plain version) and raises where it cannot
    take the shape."""
    groups = -(-F // WARP_FOLDS)
    fg = -(-F // groups)
    mask_bytes = 4 * fg * -(-n // 32)
    warp_ok = maxk <= WARP_MAX_K and mask_bytes <= WARP_MAX_MASK_BYTES
    if plan is None:
        plan = ("warp" if warp_ok else
                "staged" if n <= STAGED_MAX_N else "streamed")
    if plan not in PLANS:
        raise ValueError(f"unknown N1 plan {plan!r}; expected one of "
                         f"{PLANS}")
    if (plan == "warp" and not warp_ok) or \
            (plan == "staged" and n > STAGED_MAX_N):
        raise ValueError(f"N1's {plan!r} plan cannot take n={n}, "
                         f"maxk={maxk}, F={F}")
    if plan == "warp":
        return {"plan": "warp", "groups": groups, "folds": fg,
                "smem": mask_bytes, "threads": WARP_THREADS}
    P = 1
    while P < maxk:
        P *= 2
    # the sort's entries, the histogram and counters (`Shared`), the row
    smem = 8 * P + 1072 + (8 * n if plan == "staged" else 0)
    return {"plan": plan, "P": P, "smem": smem, "threads": TOPK_THREADS}


def knn_fold_topk(G, sq_rows, sq_cols, train_masks, maxk: int,
                  plan: str | None = None):
    """N1: the fold-masked top-k of every row (see the module docstring);
    one launch for all folds, by `topk_plan`'s plan (or `plan`)."""
    maxk = int(maxk)
    if G.device.type == "cpu":
        return knn_fold_topk_plain(G, sq_rows, sq_cols, train_masks, maxk)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    m, n = G.shape
    F = train_masks.shape[0]
    dev = G.device
    _build.check_tensor("G", G, (m, n), dev)
    _build.check_tensor("sq_rows", sq_rows, (m,), dev)
    _build.check_tensor("sq_cols", sq_cols, (n,), dev)
    _build.check_tensor("train_masks", train_masks, (F, n), dev)
    if not 1 <= maxk <= MAX_K:
        raise ValueError(f"knn_fold_topk: maxk={maxk} is outside [1, "
                         f"{MAX_K}], the kernel's limit")
    if maxk > n:
        raise ValueError(f"knn_fold_topk: maxk={maxk} exceeds the {n} "
                         "columns")
    if m < 1 or F < 1:
        raise ValueError(f"knn_fold_topk: empty shape m={m} F={F}")
    launch = topk_plan(n, maxk, F, plan)
    d2 = torch.empty((F, m, maxk), dtype=G.dtype, device=dev)
    idx = torch.empty((F, m, maxk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().knn_fold_topk(
            G.data_ptr(), sq_rows.data_ptr(), sq_cols.data_ptr(),
            train_masks.data_ptr(), d2.data_ptr(), idx.data_ptr(), m, n, F,
            maxk, PLANS.index(launch["plan"]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"knn_fold_topk launch failed: cudaError {rc}")
    LAUNCHES["knn_fold_topk"] += 1
    return d2, idx
