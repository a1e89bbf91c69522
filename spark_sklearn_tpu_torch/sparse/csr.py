"""The CSR container, its host staging form and its device operand.

Counterpart of `spark_sklearn_tpu/sparse/csr.py`, without JAX:

- `index_dtype` (:34-39) and `CSRMatrix` (:42-116): the container that
  carries scipy `csr_matrix` rows, with its scipy bridge, the UDT-style
  `serialize`/`deserialize`, `nnz`, `nbytes` and `__eq__` as the
  reference's; `to_dense(dtype, device)` returns a torch tensor.
- `SparseOperand` (:119-174): the host staging form of a sparse X, here
  canonical CSR (duplicates summed, columns sorted within each row) for
  X and for Xᵀ, with the reference's `signature()`.  The reference's
  BCOO assembly and `jax.export` registration (:176-221) have no
  counterpart: the port has no program store yet.
- `CSROperand`: X on one device as the CSR of X and the CSR of Xᵀ
  (int32 `indptr` and `indices`, float32 `values`, Xᵀ's built once on
  the host with scipy), each with SP1's work plan (`SpmmPlan`, built on
  the host when the operand is staged).  `mm(D, out=)` (D (d, W) ->
  (n, W)) and `tmm(E, out=)` (E (n, W) -> Xᵀ E (d, W) over Xᵀ's CSR) run
  SP1 (`ops/spmm_kernels.py` `csr_spmm`) on contiguous operands, written
  into `out` where given: the sparse LogisticRegression keeps its
  coefficients feature-major so that neither needs a copy.  ``X @ D``
  keeps the operator form the reference writes for a BCOO X's forward
  products; `map_values` applies an elementwise map to the stored values
  (BernoulliNB's binarize).
- `csr_to_dense`: the reference's numpy path of `utils/native.py:107`
  (scipy's `toarray`), with the output dtype a parameter.

Indices are int32 only: `SparseOperand` raises above 2**31 - 1 rows,
columns or nonzeros, naming the limit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_sklearn_tpu_torch.ops.spmm_kernels import SpmmPlan, csr_spmm

#: first index value that no longer fits an int32
_INT32_MAX = np.iinfo(np.int32).max


def index_dtype(*extents) -> np.dtype:
    """int32 when every extent (dims, nnz) fits, int64 past 2**31-1 —
    silent int32 truncation on a huge-axis matrix would alias rows."""
    if any(int(e) > _INT32_MAX for e in extents):
        return np.dtype(np.int64)
    return np.dtype(np.int32)


def issparse(X) -> bool:
    """True for a scipy sparse matrix or array (scipy imported only where
    it is needed)."""
    if not hasattr(X, "tocsr"):
        return False
    import scipy.sparse as sp
    return sp.issparse(X)


def as_scipy_csr(X):
    """A `CSRMatrix` or any scipy sparse format as scipy CSR; anything
    else unchanged (the reference's conversion at the top of `fit`,
    `search/grid.py:570-576`)."""
    if isinstance(X, CSRMatrix):
        return X.to_scipy()
    if issparse(X) and X.format != "csr":
        return X.tocsr()
    return X


def csr_to_dense(data, indices, indptr, shape, dtype=np.float32
                 ) -> np.ndarray:
    """CSR buffers -> a dense numpy array of `dtype` (the reference's
    numpy path, `utils/native.py:107-115`)."""
    from scipy.sparse import csr_matrix
    return csr_matrix((data, indices, indptr),
                      shape=shape).toarray().astype(dtype, copy=False)


def densify(X):
    """A scipy sparse X as a dense array of its own dtype (what
    ``np.asarray`` of the same matrix given dense would hold), once on
    the host; a dense X as a numpy array."""
    if not issparse(X):
        return np.asarray(X)
    m = X.tocsr()
    return csr_to_dense(m.data, m.indices, m.indptr, m.shape,
                        dtype=m.dtype)


class CSRMatrix:
    """Compressed sparse row matrix: (data, indices, indptr, shape)."""

    def __init__(self, data, indices, indptr, shape: Tuple[int, int]):
        self.data = np.asarray(data)
        shape = (int(shape[0]), int(shape[1]))
        # indices index columns (< shape[1]); indptr indexes into data
        # (<= nnz): each sized independently
        self.indices = np.asarray(
            indices, dtype=index_dtype(shape[1], 0))
        self.indptr = np.asarray(
            indptr, dtype=index_dtype(len(self.data)))
        self.shape = shape

    # -- scipy bridge ----------------------------------------------------
    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        m = m.tocsr()
        return cls(m.data, m.indices, m.indptr, m.shape)

    def to_scipy(self):
        from scipy.sparse import csr_matrix
        return csr_matrix((self.data, self.indices, self.indptr),
                          shape=self.shape)

    # -- device bridge ---------------------------------------------------
    def to_dense(self, dtype=np.float32, device=None) -> torch.Tensor:
        """The dense matrix as a torch tensor of `dtype` on `device`
        (None: ``cuda``, as the port's entry points)."""
        from spark_sklearn_tpu_torch.parallel.device import (
            TorchConfig,
            resolve_device,
        )
        dev = resolve_device(TorchConfig(device=device))
        return torch.as_tensor(csr_to_dense(
            self.data, self.indices, self.indptr, self.shape, dtype=dtype),
            device=dev)

    # -- UDT-style serialization -----------------------------------------
    def serialize(self):
        return (self.data, self.indices, self.indptr,
                np.asarray(self.shape, dtype=np.int64))

    @classmethod
    def deserialize(cls, datum) -> "CSRMatrix":
        data, indices, indptr, shape = datum
        return cls(data, indices, indptr, tuple(int(s) for s in shape))

    # -- conveniences ----------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(len(self.data))

    @property
    def nbytes(self) -> int:
        """Component bytes (data + indices + indptr), never n x d."""
        return int(self.data.nbytes + self.indices.nbytes
                   + self.indptr.nbytes)

    def __repr__(self):
        return (f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.data.dtype})")

    def __eq__(self, other):
        if not isinstance(other, CSRMatrix):
            return NotImplemented
        return (self.shape == other.shape
                and np.array_equal(self.data, other.data)
                and np.array_equal(self.indices, other.indices)
                and np.array_equal(self.indptr, other.indptr))


def _canonical(m):
    """scipy CSR in canonical form: duplicates summed, each row's columns
    sorted."""
    m = m.tocsr(copy=True)
    m.sum_duplicates()           # also sorts each row's indices
    m.sort_indices()
    return m


class SparseOperand:
    """Host-side staged form of one sparse X: the canonical CSR of X
    (`values` (nnz,), `indices` (nnz,), `indptr` (n+1,)) and of Xᵀ
    (`t_values`, `t_indices`, `t_indptr` (d+1,)), int32 indices, and the
    facts (`shape`, `nnz`) of its `signature()`."""

    __slots__ = ("values", "indices", "indptr", "t_values", "t_indices",
                 "t_indptr", "shape")

    def __init__(self, values, indices, indptr, t_values, t_indices,
                 t_indptr, shape):
        self.values = np.ascontiguousarray(values)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int32)
        self.t_values, self.t_indices, self.t_indptr = (None,) * 3
        if t_values is not None:
            self.t_values = np.ascontiguousarray(t_values)
            self.t_indices = np.ascontiguousarray(t_indices, dtype=np.int32)
            self.t_indptr = np.ascontiguousarray(t_indptr, dtype=np.int32)
        self.shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_csr(cls, m, dtype=np.float32, transpose=True
                 ) -> "SparseOperand":
        """The canonical CSRs of X and (with `transpose`) of Xᵀ from any
        CSR-like matrix (scipy sparse or CSRMatrix).  Raises where the
        CSR is malformed (SP1 reads D's rows at these indices unchecked)
        or an index would not fit int32 (the kernel's index width)."""
        if isinstance(m, CSRMatrix):
            m = m.to_scipy()
        m = m.tocsr()
        ptr, idx = np.asarray(m.indptr), np.asarray(m.indices)
        if (ptr.shape != (m.shape[0] + 1,) or ptr[0] != 0
                or ptr[-1] != idx.size or np.any(np.diff(ptr) < 0)
                or (idx.size and (idx.min() < 0
                                  or idx.max() >= m.shape[1]))):
            raise ValueError(
                "malformed CSR: indptr must rise from 0 to nnz and every "
                f"column index lie in [0, {m.shape[1]})")
        m = _canonical(m)
        for what, extent in (("rows", m.shape[0]), ("columns", m.shape[1]),
                             ("nonzeros", m.nnz)):
            if int(extent) > _INT32_MAX:
                raise ValueError(
                    f"sparse X has {int(extent)} {what}, past the int32 "
                    f"index limit 2**31 - 1 = {_INT32_MAX} of the port's "
                    "CSR operand (int64 indices are not ported)")
        t = _canonical(m.T) if transpose else None
        return cls(m.data.astype(dtype, copy=False), m.indices, m.indptr,
                   None if t is None else t.data.astype(dtype, copy=False),
                   None if t is None else t.indices,
                   None if t is None else t.indptr, m.shape)

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the CSRs held: what the device holds for X."""
        return int(sum(getattr(self, k).nbytes for k in self.__slots__
                       if k != "shape" and getattr(self, k) is not None))

    def signature(self) -> tuple:
        """The sparse layout's signature: enough to tell two operands
        whose dense shapes agree but whose sparse layouts differ."""
        return ("csr", self.shape, self.nnz,
                str(self.values.dtype), str(self.indices.dtype))

    def to_device(self, device) -> "CSROperand":
        """The device operand: the CSRs held, uploaded to `device`, with
        SP1's plans built from the host's indptr."""
        return CSROperand(*(None if getattr(self, k) is None else
                            torch.as_tensor(getattr(self, k), device=device)
                            for k in self.__slots__ if k != "shape"),
                          shape=self.shape,
                          plan=SpmmPlan(self.indptr, device),
                          t_plan=(None if self.t_indptr is None else
                                  SpmmPlan(self.t_indptr, device)))


def to_device(v, device):
    """A prepared data leaf on `device`: a staged sparse X as its
    CSROperand, an array as a tensor."""
    if isinstance(v, SparseOperand):
        return v.to_device(device)
    return torch.as_tensor(v, device=device)


class CSROperand:
    """A sparse X (n, d) on one device: the CSR of X and of Xᵀ (Xᵀ's
    absent in an operand made for predictions, which only take X @ D),
    each with its SP1 plan (built from the device's indptr at first use
    where none was given).  `mm`, `tmm` and ``X @ D`` run SP1; `shape`,
    `dtype` and `device` read as a tensor's."""

    def __init__(self, values, indices, indptr, t_values, t_indices,
                 t_indptr, shape, plan=None, t_plan=None):
        self.values, self.indices, self.indptr = values, indices, indptr
        self.t_values, self.t_indices = t_values, t_indices
        self.t_indptr = t_indptr
        self.shape = (int(shape[0]), int(shape[1]))
        self._plan, self._t_plan = plan, t_plan

    @classmethod
    def from_matrix(cls, m, device, dtype=np.float32, transpose=True
                    ) -> "CSROperand":
        """A scipy sparse matrix or `CSRMatrix` staged and uploaded, with
        Xᵀ's CSR only where `transpose`."""
        return SparseOperand.from_csr(
            m, dtype=dtype, transpose=transpose).to_device(device)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in (
            self.values, self.indices, self.indptr, self.t_values,
            self.t_indices, self.t_indptr) if t is not None))

    @property
    def plan(self) -> SpmmPlan:
        """SP1's plan over X's CSR."""
        if self._plan is None:
            self._plan = SpmmPlan(self.indptr)
        return self._plan

    @property
    def t_plan(self) -> SpmmPlan:
        """SP1's plan over Xᵀ's CSR."""
        self._need_transpose()
        if self._t_plan is None:
            self._t_plan = SpmmPlan(self.t_indptr)
        return self._t_plan

    def _need_transpose(self) -> None:
        if self.t_indptr is None:
            raise ValueError("Xᵀ @ E needs Xᵀ's CSR: this operand was "
                             "made with transpose=False")

    def mm(self, D: torch.Tensor, out=None) -> torch.Tensor:
        """X @ D for a contiguous D (d, W): (n, W) by SP1 over X's CSR,
        into `out` where given."""
        return csr_spmm(self.indptr, self.indices, self.values, D,
                        self.shape[1], plan=self.plan, out=out)

    def tmm(self, E: torch.Tensor, out=None) -> torch.Tensor:
        """Xᵀ @ E for a contiguous E (n, W): (d, W) by SP1 over Xᵀ's CSR,
        into `out` where given."""
        self._need_transpose()
        return csr_spmm(self.t_indptr, self.t_indices, self.t_values, E,
                        self.shape[0], plan=self.t_plan, out=out)

    def __matmul__(self, D: torch.Tensor) -> torch.Tensor:
        """X @ D: D (d, W) -> (n, W) by SP1 over X's CSR (D made
        contiguous first: a copy where it is a transposed view)."""
        if not isinstance(D, torch.Tensor) or D.dim() != 2:
            return NotImplemented
        return self.mm(D.contiguous())

    def map_values(self, fn) -> "CSROperand":
        """The operand with `fn` applied to every stored value (implicit
        zeros stay zero: `fn` must map 0 to 0 where that matters); the
        structure, and so the plans, are shared."""
        t_values = None if self.t_values is None else fn(self.t_values)
        return CSROperand(fn(self.values), self.indices, self.indptr,
                          t_values, self.t_indices, self.t_indptr,
                          self.shape, self._plan, self._t_plan)

    def __repr__(self):
        return (f"CSROperand(shape={self.shape}, nnz={self.nnz}, "
                f"device={self.device})")
