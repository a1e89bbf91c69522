"""The sparse X's products (SP1) as a hand-written CUDA kernel
(``csrc/csr_spmm.cu``) with its plain PyTorch version beside it.

- SP1 `csr_spmm(indptr (m+1,), indices (nnz,), values (nnz,), D (K, W),
  n_cols, plan=None, out=None, trace=None) -> Y (m, W)`: per row r of
  the CSR matrix
  A (m, K)

      Y[r, :] = sum over j in row r of values[j] * D[indices[j], :]

  summed in float32 in ascending order of the row's nonzeros, each
  product rounded then added.  Replaces XLA's BCOO gather/scatter
  products of the reference's sparse path
  (`spark_sklearn_tpu/models/linear.py:213-219, 228-236, 267-277,
  288-297, 345-346`; `models/naive_bayes.py:74-95, 331-332, 374-375`):
  `sparse/csr.py` `CSROperand` runs X @ D over X's CSR and Xᵀ @ E over
  Xᵀ's.  `out` (m, W), contiguous, takes the result in place (the sparse
  LogisticRegression's gradient rows).

The work plan (`SpmmPlan`, built once per CSR on the host from indptr):
segments of consecutive rows whose nonzeros plus rows stay near
`SPMM_SEGMENT_COST` (a longer row is a segment alone), sorted by
nonzeros, longest first.  `spmm_launch` cuts each segment into column
slices of 32 lanes x VEC columns: the segments past `heavy_threshold`
(picked from W, so that their ordered sums do not outlast the launch)
take 16- or 32-column slices (`heavy_columns`) whose lanes copy whole
rows' slices (a ring 4-8x deeper in nonzeros), the rest `vec_light`
(16-byte copies where W % 4 == 0 and the pointers allow); where W spans
more than one light slice, the light items go slice by slice ("l2"
order), so that one slice of D is read by every row at about one time.
`spmm_units` lists the items in the order the kernel hands them out: a
persistent grid's (`blocks`) warps take them from a counter of the
launch's own, zeroed on its stream before the kernel.  `csr_spmm` without a plan builds one,
reading indptr on the host: callers on a search's path pass the
operand's.

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

import numpy as np
import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"csr_spmm": 0}

#: threads a block and ring bytes a lane, as `kThreads` and `kRingBytes`
#: in csrc/csr_spmm.cu (a launch reads the built library's own ring,
#: `spmm_config`)
SPMM_THREADS = 256
SPMM_RING_BYTES = 256
#: a segment's cost cap: its nonzeros plus its rows (a row costs a store)
SPMM_SEGMENT_COST = 512
#: what picks the heavy segments and their slice: the gathers' rate on
#: the card and the time an item takes a nonzero while the card is
#: loaded (a VEC 4 item's, and a 32-column heavy item's about the same;
#: both measured on the H100 by `chip_sweep.py`'s trace).  A segment is
#: heavy where its VEC 4 chain would outlast a quarter of the launch's
#: gathers at that rate, and it holds at least `SPMM_HEAVY_MIN` nonzeros.
SPMM_GATHER_RATE = 7e12
SPMM_ITEM_NS = 60.0
SPMM_HEAVY_MIN = 1024

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


def spmm_segments(indptr, cost: int = SPMM_SEGMENT_COST):
    """(starts, ends, nnz) of the plan's segments, longest first: runs of
    consecutive rows cut where a row's start (its nonzeros and rows
    before it, each row costing one) crosses a multiple of `cost`, and
    around every row of at least `cost` nonzeros, which stands alone.
    Every row lies in exactly one segment."""
    ptr = np.asarray(indptr, dtype=np.int64)
    m = ptr.shape[0] - 1
    if m < 1:
        z = np.zeros(0, np.int64)
        return z, z, z
    nnz = np.diff(ptr)
    key = (ptr[:-1] + np.arange(m)) // cost
    long = nnz >= cost
    new = np.ones(m, dtype=bool)
    new[1:] = (key[1:] != key[:-1]) | long[1:] | long[:-1]
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], m)
    seg_nnz = ptr[ends] - ptr[starts]
    order = np.argsort(-seg_nnz, kind="stable")
    return starts[order], ends[order], seg_nnz[order]


class SpmmPlan:
    """SP1's work plan for one CSR: its segments (`segs`, (n, 2) int32
    first and end rows on the operand's device, longest first) and their
    nonzeros on the host (`seg_nnz`), from which `spmm_launch` picks the
    heavy ones for a W without reading the device."""

    __slots__ = ("segs", "seg_nnz", "m", "nnz")

    def __init__(self, indptr, device=None):
        if isinstance(indptr, torch.Tensor):
            device = indptr.device if device is None else device
            indptr = indptr.cpu().numpy()
        ptr = np.asarray(indptr)
        starts, ends, self.seg_nnz = spmm_segments(ptr, SPMM_SEGMENT_COST)
        self.m = int(ptr.shape[0] - 1)
        self.nnz = int(ptr[-1]) if ptr.shape[0] else 0
        self.segs = torch.as_tensor(
            np.stack([starts, ends], axis=1).astype(np.int32),
            device=device)

    @property
    def n_segments(self) -> int:
        return int(self.seg_nnz.shape[0])

    @property
    def longest(self) -> int:
        return int(self.seg_nnz[0]) if self.n_segments else 0

    def __repr__(self):
        return (f"SpmmPlan(m={self.m}, nnz={self.nnz}, segments="
                f"{self.n_segments}, longest={self.longest})")


def ring_depth(vec: int, ring_bytes: int = SPMM_RING_BYTES) -> int:
    """Nonzeros a lane's ring holds ahead of its adds at VEC `vec`."""
    return ring_bytes // (4 * vec)


def heavy_threshold(nnz: int, W: int) -> int:
    """The nonzeros past which a segment is heavy (`SPMM_ITEM_NS`)."""
    t_launch = 4.0 * nnz * W / SPMM_GATHER_RATE
    return max(SPMM_HEAVY_MIN, int(0.25 * t_launch / (SPMM_ITEM_NS * 1e-9)))


def heavy_columns(plan: "SpmmPlan", W: int) -> int:
    """The heavy items' slice: 32 columns, or 16 (twice the nonzeros
    ahead in the same ring) where the longest segment's chain at 32,
    `SPMM_ITEM_NS` a nonzero, would outlast the launch's gathers."""
    t_launch = 4.0 * plan.nnz * W / SPMM_GATHER_RATE
    return 32 if plan.longest * SPMM_ITEM_NS * 1e-9 <= t_launch else 16


def spmm_launch(plan: SpmmPlan, W: int, K: int, vec_ok: int = 4,
                ring_bytes: int = SPMM_RING_BYTES, blocks: int = None
                ) -> dict:
    """The launch's choices for W columns over D (K, W): `vec_light` (the
    widest of 4, 2 and 1 that `vec_ok` and W allow), `order` ("l2": the
    light items slice by slice, where W spans more than one slice; else
    "rows", segment by segment), the heavy segments (past
    `heavy_threshold`; none at VEC 1) and their slice (`heavy_columns`
    where `vec_light` is 4, else 32 columns), the item count and, given
    `blocks` (the card's), the grid."""
    if W < 1:
        raise ValueError(f"csr_spmm: W={W}")
    vec_light = max(v for v in (1, 2, 4) if v <= vec_ok and W % v == 0)
    order = "l2" if W > 32 * vec_light else "rows"
    heavy_nnz = heavy_threshold(plan.nnz, W)
    n_heavy = (int(np.count_nonzero(plan.seg_nnz > heavy_nnz))
               if vec_light > 1 else 0)
    n_light = plan.n_segments - n_heavy
    heavy_cols = heavy_columns(plan, W)
    hc = heavy_cols if vec_light == 4 else 32
    slices_h = -(-W // hc)
    slices_l = -(-W // (32 * vec_light))
    units = n_heavy * slices_h + n_light * slices_l
    out = {"W": W, "order": order, "vec_light": vec_light,
           "heavy_nnz": heavy_nnz, "heavy_cols": heavy_cols,
           "heavy_slice": hc, "n_heavy": n_heavy, "n_light": n_light,
           "units": units, "slice": 32 * vec_light,
           "longest": plan.longest,
           "depth_light": ring_depth(vec_light, ring_bytes),
           "depth_heavy": 8 * ring_bytes // hc,
           "d_slice_bytes": 4 * K * 32 * vec_light}
    if blocks is not None:
        out["blocks"] = max(1, min(blocks, -(-units // (SPMM_THREADS // 32))))
    return out


def spmm_units(plan: SpmmPlan, launch: dict) -> np.ndarray:
    """The launch's items in the kernel's order, (units, 5) int64: first
    row, end row, first column, end column, VEC."""
    segs = plan.segs.cpu().numpy().astype(np.int64)
    out = []
    W, nh, nl = launch["W"], launch["n_heavy"], launch["n_light"]
    vl, hc = launch["vec_light"], launch["heavy_slice"]
    sh, sl = -(-W // hc), -(-W // (32 * vl))
    for u in range(nh * sh):
        r0, r1 = segs[u // sh]
        c0 = (u % sh) * hc
        out.append((r0, r1, c0, min(W, c0 + hc), 1))
    for v in range(nl * sl):
        if launch["order"] == "l2":
            s, i = divmod(v, nl)
        else:
            i, s = divmod(v, sl)
        r0, r1 = segs[nh + i]
        c0 = s * 32 * vl
        out.append((r0, r1, c0, min(W, c0 + 32 * vl), vl))
    return np.asarray(out, dtype=np.int64).reshape(-1, 5)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("csr_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.csr_spmm.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, p, p,
                             p]
    lib.csr_spmm.restype = i
    lib.csr_spmm_setup.argtypes = [p]
    lib.csr_spmm_setup.restype = i
    return lib


_SETUP = {}


def spmm_config(index: int) -> dict:
    """The built library's threads a block, ring bytes a lane, most
    nonzeros a batch and blocks an SM on card `index` (its shared memory
    raised first), and the card's SMs; once a library and card."""
    lib = _lib()
    key = (id(lib), index)
    if key not in _SETUP:
        buf = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            rc = lib.csr_spmm_setup(buf)
        if rc != 0:
            raise RuntimeError(f"csr_spmm setup failed: cudaError {rc}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SETUP[key] = {"threads": buf[0], "ring_bytes": buf[1],
                       "batch": buf[2], "blocks_per_sm": buf[3], "sms": sms}
    return _SETUP[key]


def _trace_ptr(trace, units: int, dev) -> int:
    if trace is None:
        return 0
    _build.check_tensor("trace", trace, (units, 4), dev, torch.int64)
    return trace.data_ptr()


def _vec_ok(W: int, *tensors) -> int:
    """The widest VEC (4, 2 or 1) whose copies and stores stay aligned:
    W a multiple of it and every pointer on 4 VEC bytes (None: a fresh
    allocation, aligned)."""
    for v in (4, 2):
        if W % v == 0 and all(t.data_ptr() % (4 * v) == 0
                              for t in tensors if t is not None):
            return v
    return 1


def launch_for(plan: SpmmPlan, D, out) -> dict:
    """The launch `csr_spmm` makes for D (K, W) on the card into `out`
    (m, W): `spmm_launch` with the built library's ring, the card's
    persistent grid and the widest VEC the pointers allow."""
    dev = D.device
    cfg = spmm_config(dev.index if dev.index is not None
                      else torch.cuda.current_device())
    K, W = D.shape
    return spmm_launch(plan, W, K, _vec_ok(W, D, out), cfg["ring_bytes"],
                       cfg["sms"] * cfg["blocks_per_sm"])


def csr_spmm(indptr, indices, values, D, n_cols: int, plan=None, out=None,
             trace=None):
    """SP1: the CSR matrix (indptr, indices, values) with `n_cols` columns
    times D (n_cols, W) (see the module docstring); one launch.  `plan`
    is the CSR's `SpmmPlan` (None: built here from indptr, a host read);
    `out` a contiguous (m, W) tensor to write; `trace` an int64 (items, 4)
    CUDA tensor that takes each item's number, SM, start and end (ns, the
    card's global timer).  The launch's item counter is a fresh int32
    on the current stream, zeroed by the launch itself, so launches on
    other streams, or a graph's replay beside them, never share one."""
    m = indptr.shape[0] - 1
    if D.device.type == "cpu":
        if D.shape[0] != n_cols:
            raise ValueError(f"D must have {n_cols} rows, got "
                             f"{tuple(D.shape)}")
        Y = csr_spmm_plain(indptr, indices, values, D)
        if out is None:
            return Y
        _build.check_tensor("out", out, Y.shape, D.device)
        return out.copy_(Y)
    if D.device.type != "cuda":
        raise ValueError(f"unsupported device {D.device}")
    nnz = values.shape[0]
    W = D.shape[1] if D.dim() == 2 else -1
    dev = D.device
    _build.check_tensor("indptr", indptr, (m + 1,), dev, torch.int32)
    _build.check_tensor("indices", indices, (nnz,), dev, torch.int32)
    _build.check_tensor("values", values, (nnz,), dev)
    _build.check_tensor("D", D, (n_cols, W), dev)
    if out is None:
        out = torch.empty((m, W), dtype=D.dtype, device=dev)
    else:
        _build.check_tensor("out", out, (m, W), dev)
    if m == 0 or W == 0:
        return out
    if plan is None:
        plan = SpmmPlan(indptr)
    if plan.m != m or plan.nnz != nnz or plan.segs.device != dev:
        raise ValueError(f"the plan is for {plan.m} rows and {plan.nnz} "
                         f"nonzeros on {plan.segs.device}, not {m} and "
                         f"{nnz} on {dev}")
    launch = launch_for(plan, D, out)
    with torch.cuda.device(dev):
        counter = torch.empty(1, dtype=torch.int32, device=dev)
        rc = _lib().csr_spmm(
            indptr.data_ptr(), indices.data_ptr(), values.data_ptr(),
            D.data_ptr(), out.data_ptr(), W, plan.segs.data_ptr(),
            launch["n_heavy"], launch["n_light"], launch["vec_light"],
            int(launch["order"] == "l2"), launch["heavy_cols"],
            launch["blocks"],
            counter.data_ptr(), _trace_ptr(trace, launch["units"], dev),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm launch failed: cudaError {rc}")
    LAUNCHES["csr_spmm"] += 1
    return out
