"""The sparse X's products (SP1) as a hand-written CUDA kernel
(``csrc/csr_spmm.cu``) with its plain PyTorch version beside it.

- SP1 `csr_spmm(indptr (m+1,), indices (nnz,), values (nnz,), D (K, W),
  n_cols) -> Y (m, W)`: per row r of the CSR matrix A (m, K)

      Y[r, :] = sum over j in row r of values[j] * D[indices[j], :]

  summed in float32 in ascending order of the row's nonzeros, each
  product rounded then added.  Replaces XLA's BCOO gather/scatter
  products of the reference's sparse path
  (`spark_sklearn_tpu/models/linear.py:213-219, 228-236, 267-277,
  288-297, 345-346`; `models/naive_bayes.py:74-95, 331-332, 374-375`):
  `sparse/csr.py` `CSROperand` runs X @ D over X's CSR and D @ X as
  (Xᵀ Dᵀ)ᵀ over Xᵀ's.  A block walks `SPMM_ROWS` rows strided by the
  grid (long neighbouring rows fall to different blocks), its threads a
  tile of W's columns (`spmm_plan`), the loads of 8 nonzeros
  (`kBatch`) in flight before their ordered adds; no atomics.

Shapes: indptr and indices int32, values, D and Y float32, all
contiguous; `n_cols` is A's column count, which D's rows must equal.

The plain version, `csr_spmm_plain`, gathers D's rows for a chunk of
whole rows of A, scales them by the values and `index_add_`s them into
the rows in nonzero order: on the CPU it sums each row in the kernel's
order, so the two agree bit for bit on the same inputs.

`spmm_bytes` and `spmm_ops` count what the function needs (the bound's
inputs: A and D read once, Y written once; 2 nnz W operations) and
`spmm_gathered_bytes` what the nonzeros gather from D (nnz W 4 bytes).

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
LAUNCHES = {"csr_spmm": 0}

#: columns a thread and most threads a block, as `kCols` and
#: `kMaxThreads` in csrc/csr_spmm.cu; rows a block walks (strided by the
#: grid)
SPMM_COLS = 4
SPMM_MAX_THREADS = 256
SPMM_ROWS = 4

#: most gathered elements (nonzeros x W) the plain version holds at once
#: (4 MB: a chunk stays in cache between its gather, scale and add)
PLAIN_ELEMS = 1 << 20


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def spmm_bytes(m: int, nnz: int, K: int, W: int) -> int:
    """Bytes SP1 must move: indptr, indices, values and D read once, Y
    written once."""
    return 4 * (m + 1) + 8 * nnz + 4 * K * W + 4 * m * W


def spmm_ops(nnz: int, W: int) -> int:
    """Floating-point operations: a multiply and an add a nonzero and
    column."""
    return 2 * nnz * W


def spmm_gathered_bytes(nnz: int, W: int) -> int:
    """Bytes of D's rows the nonzeros gather (each row once a nonzero)."""
    return 4 * nnz * W


def csr_spmm_plain(indptr, indices, values, D):
    """SP1's plain version: for chunks of whole rows (at most
    `PLAIN_ELEMS` gathered elements, or one row), the gathered rows of D
    times the values, `index_add_`ed into the chunk's rows in nonzero
    order."""
    m = indptr.shape[0] - 1
    W = D.shape[1]
    out = torch.zeros((m, W), dtype=D.dtype, device=D.device)
    nnz = values.shape[0]
    if m == 0 or W == 0 or nnz == 0:
        return out
    ptr = indptr.to(device="cpu", dtype=torch.int64)
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(m, device=D.device), counts)
    cols = indices.long()
    step = max(1, PLAIN_ELEMS // W)
    r0 = 0
    while r0 < m:
        lo = int(ptr[r0])
        # the last row whose end stays within `step` nonzeros of lo
        r1 = int(torch.searchsorted(ptr, lo + step, right=True)) - 1
        r1 = min(m, max(r1, r0 + 1))
        hi = int(ptr[r1])
        if hi > lo:
            part = torch.index_select(D, 0, cols[lo:hi])
            part.mul_(values[lo:hi, None])
            out.index_add_(0, rows[lo:hi], part)
        r0 = r1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("csr_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.csr_spmm.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.csr_spmm.restype = i
    return lib


def spmm_plan(m: int, W: int) -> dict:
    """SP1's launch: `threads` a block (a multiple of 32 covering W's
    columns `SPMM_COLS` a thread, at most `SPMM_MAX_THREADS`), `rows` a
    block (block b walks rows b, b + G, ... of a grid of G), and the grid
    (row blocks G, column tiles)."""
    if m < 1 or W < 1:
        raise ValueError(f"csr_spmm: empty shape m={m} W={W}")
    need = -(-W // SPMM_COLS)
    threads = min(SPMM_MAX_THREADS, -(-need // 32) * 32)
    tiles = -(-W // (threads * SPMM_COLS))
    return {"threads": threads, "rows": SPMM_ROWS,
            "grid": (-(-m // SPMM_ROWS), tiles)}


def csr_spmm(indptr, indices, values, D, n_cols: int):
    """SP1: the CSR matrix (indptr, indices, values) with `n_cols` columns
    times D (n_cols, W) (see the module docstring); one launch."""
    if D.device.type == "cpu":
        if D.shape[0] != n_cols:
            raise ValueError(f"D must have {n_cols} rows, got "
                             f"{tuple(D.shape)}")
        return csr_spmm_plain(indptr, indices, values, D)
    if D.device.type != "cuda":
        raise ValueError(f"unsupported device {D.device}")
    m = indptr.shape[0] - 1
    nnz = values.shape[0]
    W = D.shape[1] if D.dim() == 2 else -1
    dev = D.device
    _build.check_tensor("indptr", indptr, (m + 1,), dev, torch.int32)
    _build.check_tensor("indices", indices, (nnz,), dev, torch.int32)
    _build.check_tensor("values", values, (nnz,), dev)
    _build.check_tensor("D", D, (n_cols, W), dev)
    out = torch.empty((m, W), dtype=D.dtype, device=dev)
    if m == 0 or W == 0:
        return out
    plan = spmm_plan(m, W)
    with torch.cuda.device(dev):
        rc = _lib().csr_spmm(
            indptr.data_ptr(), indices.data_ptr(), values.data_ptr(),
            D.data_ptr(), out.data_ptr(), m, W, plan["threads"],
            plan["rows"], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm launch failed: cudaError {rc}")
    LAUNCHES["csr_spmm"] += 1
    return out
