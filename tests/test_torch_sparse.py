"""Sparse X in the PyTorch port, on the CPU: the CSR container, the
staging form and the device operand against the JAX package's; SP1's
plain version against float64 numpy products; searches under
``TorchConfig(data_mode="sparse")`` against the JAX package's
``data_mode="sparse"`` searches, the port's dense searches and sklearn;
the default tier on scipy CSR, COO and `CSRMatrix` input against a
dense-input run; the refusals; successive halving and the refit on a
sparse X.

Tolerances: SP1's plain version within 1e-5 of a float64 product
relative to the row's |A| |D| sum, and bit for bit the float32 sum in
ascending nonzero order; LogisticRegression's mean_test_score atol 5e-3
(iterative fits on products summed in another order, as
`tests/test_sparse_path.py:77-88`); the naive Bayes searches atol 1e-6
(closed form), against sklearn too; the default tier exactly equal to
the dense-input run (it densifies before anything runs)."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from sklearn import naive_bayes as snb
from sklearn.linear_model import LogisticRegression as SkLogReg
from sklearn.model_selection import GridSearchCV as SkGridSearchCV

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.sparse import csr as jcsr
from spark_sklearn_tpu_torch.models import naive_bayes as pnb
from spark_sklearn_tpu_torch.ops import spmm_kernels as spk
from spark_sklearn_tpu_torch.search import cv as pcv
from spark_sklearn_tpu_torch.search import grid as pgrid
from spark_sklearn_tpu_torch.sparse import csr as pcsr

CPU = port.TorchConfig(device="cpu")
SPARSE = port.TorchConfig(device="cpu", data_mode="sparse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(n=150, d=40, density=0.1, k=3, seed=0):
    """Non-negative integer counts as CSR, with class-dependent columns
    (so the problem is learnable), and the labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    m = sp.random(n, d, density=density, format="csr", random_state=rng)
    m.data = np.ceil(m.data * 5.0)
    lift = sp.csr_matrix(
        (np.ones(n), (np.arange(n), (y * 3 + rng.integers(0, 3, n)) % d)),
        shape=(n, d))
    return (m + 2.0 * lift).tocsr(), y


def _normalized(m):
    """Rows scaled to unit l2 norm (tf-idf style)."""
    norms = np.sqrt(np.asarray(m.multiply(m).sum(axis=1))).ravel()
    return sp.diags(1.0 / np.maximum(norms, 1e-12)) @ m


# ---------------------------------------------------------------------------
# the container, the staging form and the device operand
# ---------------------------------------------------------------------------

def _messy(seed=0):
    """A COO matrix with duplicate entries, unsorted, with an empty row
    and an empty column."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 9, 60)
    cols = rng.integers(0, 11, 60)
    rows[rows == 4] = 5                       # row 4 empty
    cols[cols == 7] = 8                       # column 7 empty
    vals = rng.normal(size=60)
    return sp.coo_matrix((vals, (rows, cols)), shape=(9, 11))


@pytest.mark.parametrize("extents", [(5,), (2**31 - 1, 3), (2**31,),
                                     (3, 2**31 + 5, 0)])
def test_index_dtype_matches_reference(extents):
    assert pcsr.index_dtype(*extents) == jcsr.index_dtype(*extents)


def test_csrmatrix_matches_reference():
    m = _messy().tocsr()
    ours, ref = pcsr.CSRMatrix.from_scipy(m), jcsr.CSRMatrix.from_scipy(m)
    for a in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(ref, a))
        assert getattr(ours, a).dtype == getattr(ref, a).dtype
    assert ours.shape == ref.shape and ours.nnz == ref.nnz
    assert ours.nbytes == ref.nbytes
    assert (ours.to_scipy() != m).nnz == 0
    back = pcsr.CSRMatrix.deserialize(ours.serialize())
    assert back == ours
    for a, b in zip(ours.serialize(), ref.serialize()):
        np.testing.assert_array_equal(a, b)
    assert ours != pcsr.CSRMatrix.from_scipy(2.0 * m)
    assert repr(ours) == repr(ref)
    dense = ours.to_dense(device="cpu")
    assert isinstance(dense, torch.Tensor) and dense.dtype == torch.float32
    np.testing.assert_array_equal(dense.numpy(),
                                  m.toarray().astype(np.float32))
    np.testing.assert_array_equal(
        ours.to_dense(np.float64, device="cpu").numpy(), m.toarray())


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_sparse_operand_matches_reference(fmt):
    """Canonical form (duplicates summed, columns sorted a row): the
    values and coordinates are the JAX package's; Xᵀ's CSR is scipy's
    canonical transpose."""
    m = _messy().asformat(fmt)
    ours = pcsr.SparseOperand.from_csr(m.tocsr() if fmt != "csr" else m)
    ref = jcsr.SparseOperand.from_csr(m.tocsr())
    np.testing.assert_array_equal(ours.values, ref.values)
    rows = np.repeat(np.arange(m.shape[0]), np.diff(ours.indptr))
    np.testing.assert_array_equal(np.stack([rows, ours.indices], axis=1),
                                  ref.indices)
    assert ours.signature()[1:3] == ref.signature()[1:3]
    assert ours.signature()[0] == "csr"
    assert ours.indices.dtype == np.int32 and ours.indptr.dtype == np.int32
    t = m.tocsr().T.tocsr()
    t.sum_duplicates()
    t.sort_indices()
    np.testing.assert_array_equal(ours.t_indptr, t.indptr)
    np.testing.assert_array_equal(ours.t_indices, t.indices)
    np.testing.assert_array_equal(ours.t_values, t.data.astype(np.float32))
    # from a CSRMatrix too
    again = pcsr.SparseOperand.from_csr(pcsr.CSRMatrix.from_scipy(m.tocsr()))
    np.testing.assert_array_equal(again.values, ours.values)
    assert ours.nbytes == sum(getattr(ours, k).nbytes for k in (
        "values", "indices", "indptr", "t_values", "t_indices", "t_indptr"))


def test_sparse_operand_raises_past_int32(monkeypatch):
    monkeypatch.setattr(pcsr, "_INT32_MAX", 20)
    with pytest.raises(ValueError, match="int32 index limit"):
        pcsr.SparseOperand.from_csr(_messy().tocsr())   # 60 > 20 nonzeros


@pytest.mark.parametrize("fault", ["column", "indptr"])
def test_sparse_operand_refuses_a_malformed_csr(fault):
    """SP1 reads D's rows at the stored column indices unchecked, so the
    staging refuses a column past the shape or a falling indptr."""
    m = _messy().tocsr()
    data, indices, indptr = m.data.copy(), m.indices.copy(), m.indptr.copy()
    if fault == "column":
        indices[3] = m.shape[1]
    else:
        indptr[4], indptr[5] = indptr[5], indptr[4] - 1
    bad = pcsr.CSRMatrix(data, indices, indptr, m.shape)
    with pytest.raises(ValueError, match="malformed CSR"):
        pcsr.SparseOperand.from_csr(bad)


@pytest.mark.parametrize("W", [1, 3, 37])
def test_csr_operand_products_both_ways(W):
    """X @ D and Xᵀ @ E (`tmm`) of the operand against float64 numpy, on
    a matrix with an empty row and an empty column, and `map_values`."""
    m = _messy().tocsr()
    m.sum_duplicates()
    op = pcsr.CSROperand.from_matrix(m, "cpu")
    rng = np.random.default_rng(W)
    D = rng.normal(size=(m.shape[1], W)).astype(np.float32)
    E = rng.normal(size=(W, m.shape[0])).astype(np.float32)
    a32 = m.astype(np.float32).astype(np.float64)
    got = (op @ torch.as_tensor(D)).numpy()
    np.testing.assert_allclose(got, a32 @ D, rtol=1e-5, atol=1e-5)
    got = op.tmm(torch.as_tensor(E.T).contiguous()).numpy()
    assert got.shape == (m.shape[1], W)
    np.testing.assert_allclose(got, (E @ a32).T, rtol=1e-5, atol=1e-5)
    assert not got[7].any()                   # the empty column
    pos = op.map_values(lambda v: (v > 0).to(v.dtype))
    np.testing.assert_allclose((pos @ torch.as_tensor(D)).numpy(),
                               (a32 > 0) @ D, rtol=1e-5, atol=1e-5)
    assert op.shape == m.shape and op.dtype == torch.float32
    assert op.device.type == "cpu" and op.nnz == m.nnz


# ---------------------------------------------------------------------------
# SP1's plain version
# ---------------------------------------------------------------------------

def _spmm_case(m_rows, K, W, density, seed, full_row=False):
    rng = np.random.default_rng(seed)
    A = sp.random(m_rows, K, density=density, format="csr",
                  random_state=rng, dtype=np.float32)
    A = A.tolil()
    A[1, :] = 0                               # an empty row
    A[:, 2] = 0                               # an empty column
    if full_row:
        A[m_rows - 1, :] = rng.normal(size=K)     # a row holding every column
        A[m_rows - 1, 2] = 0
    A = A.tocsr().astype(np.float32)
    A.eliminate_zeros()
    A.sort_indices()
    D = rng.normal(size=(K, W)).astype(np.float32)
    return A, D


@pytest.mark.parametrize("W", [1, 3, 37])
@pytest.mark.parametrize("full_row", [False, True])
def test_csr_spmm_plain_matches_float64(W, full_row):
    A, D = _spmm_case(60, 45, W, 0.1, W, full_row)
    args = [torch.as_tensor(a) for a in (A.indptr.astype(np.int32),
                                         A.indices.astype(np.int32),
                                         A.data)]
    n0 = spk.LAUNCHES["csr_spmm"]
    got = spk.csr_spmm(*args, torch.as_tensor(D), A.shape[1]).numpy()
    assert spk.LAUNCHES["csr_spmm"] == n0          # the plain version ran
    want = A.astype(np.float64) @ D.astype(np.float64)
    scale = np.abs(A).astype(np.float64) @ np.abs(D).astype(np.float64)
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-30)
    assert not got[1].any()                        # the empty row
    # both directions: Xᵀ's CSR times a (m, W) matrix
    T = A.T.tocsr()
    T.sort_indices()
    E = np.random.default_rng(1).normal(size=(A.shape[0], W)).astype(
        np.float32)
    got_t = spk.csr_spmm_plain(
        *[torch.as_tensor(a) for a in (T.indptr.astype(np.int32),
                                       T.indices.astype(np.int32), T.data)],
        torch.as_tensor(E)).numpy()
    want_t = A.T.astype(np.float64) @ E.astype(np.float64)
    scale_t = np.abs(A.T).astype(np.float64) @ np.abs(E).astype(np.float64)
    assert np.all(np.abs(got_t - want_t) <= 1e-5 * scale_t + 1e-30)
    assert not got_t[2].any()                      # the empty column


def test_csr_spmm_plain_sums_rows_in_nonzero_order(monkeypatch):
    """Bit for bit the float32 sum of rounded products in ascending
    nonzero order (the kernel's order), with the row chunks cut small."""
    monkeypatch.setattr(spk, "PLAIN_ELEMS", 64)
    A, D = _spmm_case(30, 200, 5, 0.2, 7, full_row=True)
    D *= np.logspace(-6, 6, D.shape[0], dtype=np.float32)[:, None]
    got = spk.csr_spmm_plain(
        *[torch.as_tensor(a) for a in (A.indptr.astype(np.int32),
                                       A.indices.astype(np.int32), A.data)],
        torch.as_tensor(D)).numpy()
    want = np.zeros((A.shape[0], D.shape[1]), np.float32)
    for r in range(A.shape[0]):
        for j in range(A.indptr[r], A.indptr[r + 1]):
            want[r] = want[r] + np.float32(A.data[j]) * D[A.indices[j]]
    np.testing.assert_array_equal(got, want)


def _zipf_csr(m=3000, K=400, seed=0, head=2000.0):
    """A CSR whose rows follow a Zipf head (as Xᵀ of term counts), with
    empty rows."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(K, (head / np.arange(1, m + 1) ** 1.1)
                         .astype(np.int64))
    lengths[rng.permutation(m)[:m // 10]] = 0
    rng.shuffle(lengths)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(K, n, replace=False))
                              for n in lengths]).astype(np.int32)
    return indptr, indices


def _wide_indptr(m=3000, seed=0):
    """Row ends of a CSR of many rows of about 60 nonzeros and one of
    1100: its longest row is heavy (past `SPMM_HEAVY_MIN`), yet at W =
    1000 its chain at 32 columns fits the launch (32-column heavy
    slices)."""
    lengths = np.random.default_rng(seed).integers(30, 90, m)
    lengths[m // 3] = 1100
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


#: the plans' CSRs: no heavy row (K 400), Zipf-long heavy rows (16-column
#: slices), a heavy row among many nonzeros (32-column slices at W 1000)
PLAN_CSRS = {"zipf": lambda: _zipf_csr()[0],
             "zipf-long": lambda: _zipf_csr(K=3000)[0],
             "wide": _wide_indptr}


@pytest.mark.parametrize("W", [1, 100, 129, 1000, 1025])
def test_csr_spmm_checks_shapes_and_plans(W):
    """The wrapper's shape check; the launch's choices at the width W:
    16-byte lanes where W % 4 == 0 (8-byte where only 8 bytes of
    alignment allow), slice by slice past one slice, the item count of
    its slices, the heavy threshold and slice; the byte and operation
    counts."""
    A, D = _spmm_case(10, 8, 3, 0.3, 0)
    args = [torch.as_tensor(a) for a in (A.indptr.astype(np.int32),
                                         A.indices.astype(np.int32), A.data)]
    with pytest.raises(ValueError, match="rows"):
        spk.csr_spmm(*args, torch.as_tensor(D[:5]), 8)
    plan = spk.SpmmPlan(_zipf_csr(K=3000)[0])
    launch = spk.spmm_launch(plan, W, 3000, blocks=132 * 3)
    vec = 4 if W % 4 == 0 else 1
    assert launch["vec_light"] == vec and launch["slice"] == 32 * vec
    assert launch["heavy_nnz"] >= spk.SPMM_HEAVY_MIN
    heavy = int((plan.seg_nnz > launch["heavy_nnz"]).sum())
    assert launch["n_heavy"] == (heavy if vec > 1 else 0)
    assert heavy > 0
    hc = spk.heavy_columns(plan, W) if vec == 4 else 32
    assert spk.heavy_columns(plan, W) in (16, 32)
    assert launch["heavy_slice"] == hc
    assert launch["units"] == (launch["n_heavy"] * -(-W // hc)
                               + launch["n_light"] * -(-W // (32 * vec)))
    assert 1 <= launch["blocks"] <= 132 * 3
    assert launch["order"] == ("l2" if W > 32 * vec else "rows")
    assert launch["heavy_nnz"] == spk.heavy_threshold(plan.nnz, W)
    two = spk.spmm_launch(plan, W, 3000, vec_ok=2)
    assert two["vec_light"] == (2 if W % 2 == 0 else 1)
    assert two["order"] == ("l2" if W > 32 * two["vec_light"] else "rows")
    assert spk.spmm_bytes(2, 3, 4, 5) == 4 * 3 + 8 * 3 + 4 * 20 + 4 * 10
    assert spk.spmm_ops(3, 5) == 30 and spk.spmm_gathered_bytes(3, 5) == 60


@pytest.mark.parametrize("W", [1, 3, 37, 97, 98, 100, 500, 1000, 1025])
@pytest.mark.parametrize("csr", sorted(PLAN_CSRS))
@pytest.mark.parametrize("vec_ok", [4, 2])
def test_spmm_plan_covers_every_element_once(W, csr, vec_ok):
    """Every column of every row (and so every nonzero of a row times
    every column) falls in exactly one item; the column slices of a
    segment cover [0, W); the heavy items come first, each group longest
    first, the light items slice by slice where W spans more than one."""
    indptr = PLAN_CSRS[csr]()
    plan = spk.SpmmPlan(indptr)
    launch = spk.spmm_launch(plan, W, 400, vec_ok=vec_ok)
    units = spk.spmm_units(plan, launch)
    assert len(units) == launch["units"]
    cover = np.zeros((plan.m, W), np.int64)
    for r0, r1, c0, c1, vec in units:
        assert 0 <= c0 < c1 <= W and (c1 - c0) <= 32 * vec
        cover[r0:r1, c0:c1] += 1
    assert (cover == 1).all()
    nnz = indptr[units[:, 1]] - indptr[units[:, 0]]
    heavy = units[:, 4] == 1 if launch["vec_light"] > 1 else \
        np.zeros(len(units), bool)
    assert heavy.sum() == launch["n_heavy"] * -(-W // launch["heavy_slice"])
    assert (np.diff(heavy.astype(int)) <= 0).all()  # heavy items first
    if heavy.any():
        assert nnz[heavy].min() > launch["heavy_nnz"]
    if heavy.any() and not heavy.all():
        assert launch["heavy_nnz"] >= nnz[~heavy].max()
    assert (np.diff(nnz[heavy]) <= 0).all()
    if launch["order"] == "rows":
        assert W <= launch["slice"]
        assert (np.diff(nnz[~heavy]) <= 0).all()
    else:                                           # slice by slice
        c0 = units[~heavy, 2]
        assert (np.diff(c0) >= 0).all()
        for c in np.unique(c0):
            assert (np.diff(nnz[~heavy][c0 == c]) <= 0).all()
    if csr != "zipf" and launch["vec_light"] > 1:   # a heavy row, cut
        assert launch["n_heavy"] > 0
    if csr == "wide" and W == 1000 and vec_ok == 4:
        assert launch["heavy_slice"] == 32


@pytest.mark.parametrize("hc", [16, 32])
def test_spmm_plan_cuts_a_row_longer_than_the_ring(monkeypatch, hc):
    """A row past the segment cost stands alone; past the heavy threshold
    it is cut into 16- or 32-column slices (a ring 4-8x deeper in
    nonzeros than the light items' 16-byte lanes); short rows share
    segments within the cost; empty rows are covered too."""
    rng = np.random.default_rng(4)
    lengths = rng.integers(0, 6, 2000)
    lengths[777] = 5000
    lengths[1500:1600] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    starts, ends, nnz = spk.spmm_segments(indptr)
    assert (starts[0], ends[0], nnz[0]) == (777, 778, 5000)
    cost = (indptr[ends] - indptr[starts]) + (ends - starts)
    assert (cost[1:] <= 2 * spk.SPMM_SEGMENT_COST).all()
    assert sorted(zip(starts, ends))[0][0] == 0
    assert np.array_equal(np.sort(starts)[1:], np.sort(ends)[:-1])
    plan = spk.SpmmPlan(indptr)
    assert plan.longest == 5000 > spk.ring_depth(1) > spk.ring_depth(4)
    # so few nonzeros a launch that the 5000-nonzero chain takes 16
    # columns; 32 where `heavy_columns` picks it at larger launches
    assert spk.heavy_columns(plan, 100) == 16
    monkeypatch.setattr(spk, "heavy_columns", lambda plan, W: hc)
    launch = spk.spmm_launch(plan, 100, 5000)
    assert launch["n_heavy"] == 1 and launch["vec_light"] == 4
    assert launch["depth_heavy"] == 8 * spk.SPMM_RING_BYTES // hc
    units = spk.spmm_units(plan, launch)
    n = -(-100 // hc)
    assert units[:n].tolist() == [[777, 778, c, min(100, c + hc), 1]
                                  for c in range(0, 100, hc)]
    assert (units[n:, 4] == 4).all()
    assert len(units) == n + plan.n_segments - 1
    # at VEC 1 (W odd) no segment is heavy
    assert spk.spmm_launch(plan, 97, 5000)["n_heavy"] == 0


def test_csr_spmm_out_and_plan_on_the_cpu():
    """`out=` takes the result in place (a view of a larger buffer, as
    the sparse LogisticRegression's gradient rows); a plan is accepted
    and the plain version runs; the operand's plans are built on
    staging and shared by `map_values`."""
    A, D = _spmm_case(40, 30, 6, 0.2, 2)
    args = [torch.as_tensor(a) for a in (A.indptr.astype(np.int32),
                                         A.indices.astype(np.int32), A.data)]
    buf = torch.full((41, 6), 7.0)
    plan = spk.SpmmPlan(args[0])
    got = spk.csr_spmm(*args, torch.as_tensor(D), 30, plan=plan,
                       out=buf[:40])
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:40], spk.csr_spmm_plain(*args, torch.as_tensor(D)))
    assert (buf[40] == 7.0).all()
    with pytest.raises(ValueError):
        spk.csr_spmm(*args, torch.as_tensor(D), 30, out=buf[:39])
    op = pcsr.CSROperand.from_matrix(A, "cpu")
    assert op.plan.m == 40 and op.t_plan.m == 30
    assert op.map_values(torch.abs).plan is op.plan
    E = torch.as_tensor(np.random.default_rng(0).normal(
        size=(40, 5)).astype(np.float32))
    assert torch.equal(op.tmm(E), spk.csr_spmm_plain(
        op.t_indptr, op.t_indices, op.t_values, E))
    with pytest.raises(ValueError, match="transpose=False"):
        pcsr.CSROperand.from_matrix(A, "cpu", transpose=False).tmm(E)


# ---------------------------------------------------------------------------
# searches under data_mode="sparse"
# ---------------------------------------------------------------------------

def _jax_search(est, grid, X, y, **cfg):
    return sst.GridSearchCV(est, grid, cv=3, refit=False, backend="tpu",
                            config=sst.TpuConfig(**cfg)).fit(X, y)


def _port_search(est, grid, X, y, config=SPARSE, refit=False, cv=3):
    return port.GridSearchCV(est, grid, cv=cv, refit=refit,
                             backend="device", config=config).fit(X, y)


LR_CASES = [(k, penalty) for k in (2, 3)
            for penalty in ("l2", None, "l1", "elasticnet")]


@pytest.mark.parametrize("k,penalty", LR_CASES)
def test_logistic_sparse_matches_jax_and_dense(k, penalty):
    X, y = _counts(n=120, d=30, density=0.15, k=k, seed=3)
    X = _normalized(X).tocsr()
    kw = {"l1_ratio": 0.5} if penalty == "elasticnet" else {}
    solver = "saga" if penalty in ("l1", "elasticnet") else "lbfgs"
    grid = {"C": [0.5, 5.0]}
    got = _port_search(port.LogisticRegression(penalty=penalty,
                                               max_iter=100, **kw),
                       grid, X, y)
    dense = _port_search(port.LogisticRegression(penalty=penalty,
                                                 max_iter=100, **kw),
                         grid, X.toarray(), y, config=CPU)
    ref = _jax_search(SkLogReg(penalty=penalty, solver=solver, max_iter=100,
                               **kw), grid, X, y, data_mode="sparse")
    a = got.cv_results_["mean_test_score"]
    np.testing.assert_allclose(a, ref.cv_results_["mean_test_score"],
                               atol=5e-3)
    np.testing.assert_allclose(a, dense.cv_results_["mean_test_score"],
                               atol=5e-3)
    assert np.all(a > 1.0 / k)


NB_CASES = [
    ("MultinomialNB", {}),
    ("ComplementNB", {}),
    ("BernoulliNB", {"binarize": 0.0}),
    ("BernoulliNB", {"binarize": 0.5}),
]


@pytest.mark.parametrize("name,params", NB_CASES)
def test_discrete_nb_sparse_matches_jax_and_sklearn(name, params):
    X, y = _counts(seed=5)
    X = X.multiply(0.25).tocsr()        # values straddle binarize=0.5
    grid = {"alpha": [0.01, 0.1, 1.0]}
    got = _port_search(getattr(port, name)(**params), grid, X, y)
    ref = _jax_search(getattr(snb, name)(**params), grid, X, y,
                      data_mode="sparse")
    oracle = SkGridSearchCV(getattr(snb, name)(**params), grid, cv=3,
                            refit=False).fit(X, y)
    a = got.cv_results_["mean_test_score"]
    np.testing.assert_allclose(a, ref.cv_results_["mean_test_score"],
                               atol=1e-6)
    np.testing.assert_allclose(a, oracle.cv_results_["mean_test_score"],
                               atol=1e-6)


def _poison_densify(monkeypatch):
    def boom(X):
        raise AssertionError("densify reached under data_mode='sparse'")
    monkeypatch.setattr(pgrid, "densify", boom)


@pytest.mark.parametrize("est", [port.MultinomialNB(),
                                 port.LogisticRegression(max_iter=20)])
def test_sparse_mode_never_densifies_and_holds_nnz_bytes(monkeypatch, est):
    """Under "sparse" the densify step is never called, and X's device
    tensors are the operand's two CSRs: at 1% density at most 0.2 x the
    dense float32 bytes."""
    X, y = _counts(n=400, d=256, density=0.01, seed=17)
    seen = []
    real = pgrid.to_device

    def spy(v, device):
        out = real(v, device)
        seen.append(out)
        return out

    monkeypatch.setattr(pgrid, "to_device", spy)
    _poison_densify(monkeypatch)
    _port_search(est, {"C" if isinstance(est, port.LogisticRegression)
                       else "alpha": [0.5, 1.0]}, X, y)
    ops = [v for v in seen if isinstance(v, pcsr.CSROperand)]
    assert len(ops) == 1
    assert ops[0].nbytes <= 0.2 * X.shape[0] * X.shape[1] * 4


def test_sparse_mode_on_dense_input_stays_dense():
    X, y = _counts(n=90, d=12)
    got = _port_search(port.MultinomialNB(), {"alpha": [1.0]}, X.toarray(),
                       y)
    ref = _port_search(port.MultinomialNB(), {"alpha": [1.0]}, X.toarray(),
                       y, config=CPU)
    np.testing.assert_array_equal(got.cv_results_["mean_test_score"],
                                  ref.cv_results_["mean_test_score"])


def test_sparse_mode_from_the_environment(monkeypatch):
    """SST_DATA_MODE picks the tier where the config names none."""
    monkeypatch.setenv("SST_DATA_MODE", "sparse")
    X, y = _counts(n=90, d=12)
    _poison_densify(monkeypatch)
    got = _port_search(port.MultinomialNB(), {"alpha": [1.0]}, X, y,
                       config=CPU)
    assert np.isfinite(got.cv_results_["mean_test_score"]).all()


# ---------------------------------------------------------------------------
# the default tier on sparse input
# ---------------------------------------------------------------------------

def _as(fmt, X):
    return pcsr.CSRMatrix.from_scipy(X) if fmt == "CSRMatrix" else \
        X.asformat(fmt)


DEFAULT_CASES = [
    ("LogisticRegression", lambda: port.LogisticRegression(max_iter=30),
     {"C": [0.1, 1.0]}, True),
    ("GaussianNB", lambda: port.GaussianNB(), {"var_smoothing": [1e-9, 1e-3]},
     True),
    ("SVC", lambda: port.SVC(), {"C": [1.0, 10.0]}, True),
    ("BernoulliNB", lambda: port.BernoulliNB(),
     {"binarize": [-0.5, 0.0]}, True),
    # the refit's binarize < 0: it densifies X, as the search did
    ("BernoulliNB-negative", lambda: port.BernoulliNB(binarize=-0.5),
     {"alpha": [0.1, 1.0]}, True),
    ("RandomForest", lambda: port.RandomForestClassifier(
        n_estimators=3, max_depth=3, random_state=0),
     {"max_features": [0.5, 1.0]}, False),
]


@pytest.mark.parametrize("fmt", ["csr", "coo", "CSRMatrix"])
@pytest.mark.parametrize("label,make,grid,refit", DEFAULT_CASES)
def test_default_tier_sparse_input_equals_dense(fmt, label, make, grid,
                                                refit):
    X, y = _counts(n=90, d=12, density=0.3, seed=2)
    Xs = _as(fmt, X)
    got = port.GridSearchCV(make(), grid, cv=3, refit=refit,
                            config=CPU).fit(Xs, y)
    ref = port.GridSearchCV(make(), grid, cv=3, refit=refit,
                            config=CPU).fit(X.toarray(), y)
    for i in range(3):
        np.testing.assert_array_equal(
            got.cv_results_[f"split{i}_test_score"],
            ref.cv_results_[f"split{i}_test_score"])
    assert got.n_features_in_ == 12
    if refit:
        np.testing.assert_array_equal(got.predict(Xs),
                                      ref.predict(X.toarray()))
        assert got.score(Xs, y) == ref.score(X.toarray(), y)


@pytest.mark.parametrize("fmt", ["csr", "coo", "CSRMatrix"])
def test_randomized_and_halving_on_sparse_input_equal_dense(fmt):
    X, y = _counts(n=150, d=20, density=0.3, seed=4)
    Xs = _as(fmt, X)
    for make in (
            lambda: port.RandomizedSearchCV(
                port.MultinomialNB(), {"alpha": np.logspace(-2, 1, 9)},
                n_iter=4, cv=3, random_state=0, config=CPU),
            lambda: port.HalvingGridSearchCV(
                port.LogisticRegression(max_iter=30),
                {"C": [0.01, 0.1, 1.0, 10.0]}, cv=3, factor=2,
                random_state=0, config=CPU)):
        got, ref = make().fit(Xs, y), make().fit(X.toarray(), y)
        np.testing.assert_array_equal(got.cv_results_["mean_test_score"],
                                      ref.cv_results_["mean_test_score"])
        assert got.best_params_ == ref.best_params_


def test_halving_on_csr_under_sparse_mode():
    """Halving's rung compaction cuts a CSR X by its rows: under
    "sparse" the NB halving matches the dense-input run at 1e-6, and its
    rungs and survivors are the same."""
    X, y = _counts(n=150, d=20, density=0.3, seed=4)

    def make(config):
        return port.HalvingGridSearchCV(
            port.ComplementNB(), {"alpha": [0.01, 0.03, 0.1, 0.3, 1.0]},
            cv=3, factor=2, random_state=0, config=config)

    got, ref = make(SPARSE).fit(X, y), make(CPU).fit(X.toarray(), y)
    np.testing.assert_allclose(got.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], atol=1e-6)
    np.testing.assert_array_equal(got.cv_results_["n_resources"],
                                  ref.cv_results_["n_resources"])
    assert got.best_params_ == ref.best_params_


@pytest.mark.parametrize("fmt", ["csr", "CSRMatrix"])
def test_host_tier_gets_the_sparse_x(fmt):
    """An estimator without a family runs on the host tier, which hands
    sklearn the sparse X (a CSRMatrix as scipy CSR): sklearn's own search
    on the same matrix gives the same scores."""
    from sklearn.tree import DecisionTreeClassifier
    X, y = _counts(n=120, d=15, density=0.3, seed=12)
    grid = {"max_depth": [2, 4]}
    with pytest.warns(UserWarning, match="host tier"):
        got = port.GridSearchCV(DecisionTreeClassifier(random_state=0),
                                grid, cv=3, config=CPU).fit(_as(fmt, X), y)
    ref = SkGridSearchCV(DecisionTreeClassifier(random_state=0), grid,
                         cv=3).fit(X, y)
    np.testing.assert_array_equal(got.cv_results_["mean_test_score"],
                                  ref.cv_results_["mean_test_score"])
    np.testing.assert_array_equal(got.predict(X), ref.predict(X))


def test_splitters_count_sparse_rows_by_shape():
    X, y = _counts(n=31, d=5)
    for splitter in (pcv.KFold(4), pcv.StratifiedKFold(3)):
        a = list(splitter.split(X, y))
        b = list(splitter.split(X.toarray(), y))
        assert len(a) == len(b)
        for (tr, te), (tr2, te2) in zip(a, b):
            np.testing.assert_array_equal(tr, tr2)
            np.testing.assert_array_equal(te, te2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_logloss_clip_follows_the_sparse_dtype(dtype):
    """The neg_log_loss clip reads the sparse matrix's own dtype, as it
    reads a dense X's (GaussianNB's rule keeps float32)."""
    X, y = _counts(n=60, d=8, density=0.4)
    X = X.astype(dtype)
    got = port.GridSearchCV(port.GaussianNB(), {"var_smoothing": [1e-9]},
                            cv=3, scoring="neg_log_loss",
                            config=CPU).fit(X, y)
    ref = port.GridSearchCV(port.GaussianNB(), {"var_smoothing": [1e-9]},
                            cv=3, scoring="neg_log_loss",
                            config=CPU).fit(X.toarray(), y)
    assert got.scorer_.clip_eps == ref.scorer_.clip_eps == float(
        np.finfo(dtype).eps)
    np.testing.assert_array_equal(got.cv_results_["mean_test_score"],
                                  ref.cv_results_["mean_test_score"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("est,grid", [
    (port.GaussianNB(), {"var_smoothing": [1e-9]}),
    (port.CategoricalNB(), {"alpha": [1.0]})])
def test_families_without_sparse_refuse_sparse_mode(est, grid):
    X, y = _counts(n=80, d=10)
    with pytest.raises(ValueError, match="data_mode='device'"):
        _port_search(est, grid, X, y)


def test_negative_binarize_is_refused_on_sparse_x():
    X, y = _counts(n=80, d=10)
    with pytest.raises(ValueError, match="binarize < 0"):
        _port_search(port.BernoulliNB(), {"binarize": [0.5, -0.5]}, X, y)
    # wherever the stored values are mapped: fit, the views, predict
    op = pcsr.CSROperand.from_matrix(X, "cpu")
    with pytest.raises(ValueError, match="binarize < 0"):
        pnb.BernoulliNBFamily._fit_X({"binarize": -1.0}, op)
    # dense X: negative binarize is fine
    _port_search(port.BernoulliNB(binarize=-0.5), {"alpha": [1.0]},
                 X.toarray(), y)
    # the estimator densifies a sparse X for binarize < 0 (implicit zeros
    # binarize to 1), in fit and in its predictions
    Xn = X.copy()
    Xn.data = Xn.data - 3.0                 # negative stored values too
    ref = port.BernoulliNB(binarize=-1.0, device="cpu").fit(Xn.toarray(), y)
    for fitted in (port.BernoulliNB(binarize=-1.0, device="cpu").fit(Xn, y),
                   ref):
        np.testing.assert_array_equal(fitted.predict(Xn),
                                      ref.predict(Xn.toarray()))
        np.testing.assert_array_equal(fitted.predict_proba(Xn),
                                      ref.predict_proba(Xn.toarray()))


def test_stream_and_unknown_modes_raise(monkeypatch):
    X, y = _counts(n=80, d=10)
    with pytest.raises(NotImplementedError, match="stream"):
        _port_search(port.MultinomialNB(), {"alpha": [1.0]}, X, y,
                     config=port.TorchConfig(device="cpu",
                                             data_mode="stream"))
    with pytest.raises(ValueError, match="not a data tier"):
        _port_search(port.MultinomialNB(), {"alpha": [1.0]}, X, y,
                     config=port.TorchConfig(device="cpu",
                                             data_mode="bcoo"))
    monkeypatch.setenv("SST_DATA_MODE", "stream")
    with pytest.raises(NotImplementedError, match="stream"):
        _port_search(port.MultinomialNB(), {"alpha": [1.0]}, X, y,
                     config=CPU)


def test_negative_counts_are_refused_on_sparse_x():
    X, y = _counts(n=80, d=10)
    X = X.copy()
    X.data[3] = -1.0
    with pytest.raises(ValueError, match="Negative values in data passed "
                                         "to ComplementNB"):
        _port_search(port.ComplementNB(), {"alpha": [1.0]}, X, y)
    X.data[3] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        _port_search(port.BernoulliNB(), {"alpha": [1.0]}, X, y)


# ---------------------------------------------------------------------------
# the refit and the estimators on a sparse X
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make,grid,tol", [
    # L-BFGS stops at max|grad| <= 1e-4: the two fits' probabilities
    # differ by up to ~1e-3 (products summed in another order)
    (lambda: port.LogisticRegression(max_iter=100), {"C": [0.3, 3.0]},
     2e-3),
    (lambda: port.MultinomialNB(), {"alpha": [0.1, 1.0]}, 1e-5),
    (lambda: port.BernoulliNB(binarize=1.5), {"alpha": [0.1, 1.0]}, 1e-5)])
def test_sparse_refit_predicts_as_the_dense_refit(make, grid, tol):
    X, y = _counts(n=120, d=25, density=0.2, seed=8)
    got = _port_search(make(), grid, X, y, refit=True)
    ref = _port_search(make(), grid, X.toarray(), y, config=CPU, refit=True)
    assert got.best_params_ == ref.best_params_
    Xt, _ = _counts(n=50, d=25, density=0.2, seed=9)
    np.testing.assert_array_equal(got.predict(Xt), ref.predict(Xt.toarray()))
    np.testing.assert_allclose(got.predict_proba(Xt),
                               ref.predict_proba(Xt.toarray()), atol=tol)
    assert got.n_features_in_ == ref.n_features_in_ == 25


def test_estimators_keep_or_densify_sparse_x():
    """LogisticRegression and the discrete NBs fit a CSROperand; every
    other family densifies X once on the host, predicting as on dense."""
    X, y = _counts(n=90, d=12, density=0.3, seed=6)
    for make in (lambda: port.LogisticRegression(max_iter=50, device="cpu"),
                 lambda: port.ComplementNB(device="cpu"),
                 lambda: port.GaussianNB(device="cpu"),
                 lambda: port.KNeighborsClassifier(device="cpu"),
                 lambda: port.SVC(device="cpu"),
                 lambda: port.Pipeline([("s", port.StandardScaler()),
                                        ("m", port.LogisticRegression())],
                                       device="cpu")):
        a = make().fit(pcsr.CSRMatrix.from_scipy(X), y)
        b = make().fit(X.toarray(), y)
        pa, pb = a.predict(X.tocoo()), b.predict(X.toarray())
        if isinstance(a, (port.GaussianNB, port.KNeighborsClassifier,
                          port.SVC, port.Pipeline)):
            np.testing.assert_array_equal(pa, pb)
        else:
            assert np.mean(pa == pb) >= 0.95
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        km = port.KMeans(n_clusters=3, n_init=1, random_state=0,
                         device="cpu").fit(X)
        km2 = port.KMeans(n_clusters=3, n_init=1, random_state=0,
                          device="cpu").fit(X.toarray())
    np.testing.assert_array_equal(km.labels_, km2.labels_)


def test_sparse_families_match_the_reference():
    """supports_sparse on the families the reference marks, and no
    other."""
    from spark_sklearn_tpu.models import linear as jlin
    from spark_sklearn_tpu.models import naive_bayes as jnb
    from spark_sklearn_tpu_torch.models import linear as plin
    pairs = [(getattr(pnb, n), getattr(jnb, n)) for n in (
        "GaussianNBFamily", "MultinomialNBFamily", "ComplementNBFamily",
        "BernoulliNBFamily", "CategoricalNBFamily")]
    pairs += [(getattr(plin, n), getattr(jlin, n)) for n in (
        "LogisticRegressionFamily", "RidgeFamily", "ElasticNetFamily")]
    for ours, ref in pairs:
        assert bool(ours.supports_sparse) == bool(
            getattr(ref, "supports_sparse", False)), ours.name


# ---------------------------------------------------------------------------
# the sparse LogisticRegression's feature-major state; the dense path's bits
# ---------------------------------------------------------------------------

#: the dense LogisticRegression searches below (l2 and elasticnet, 3 and 2
#: classes), hashed on the tree before the solvers took a lane axis, with
#: the torch build they were hashed on: the digest holds torch's CPU
#: kernels of that build (one thread, as this module pins)
DENSE_LR_DIGEST = "6f455b2ac6bd537fdedd19ddced18fcd"
DENSE_LR_TORCH = "2.13.0+cpu"


def test_dense_logistic_keeps_its_bits(monkeypatch):
    """The dense searches hand the solvers their (B, D) state with the
    lanes first, the unchanged 2-D call; on the torch build the digest
    was taken on, they keep the bits they had before the lane axis."""
    import hashlib
    from spark_sklearn_tpu_torch.models import linear as plin
    calls = []

    def spy(fn):
        def wrapped(*args, lane_dim=0, **kw):
            x0 = kw["x0"] if "x0" in kw else args[6]
            calls.append((fn.__name__, x0.dim(), lane_dim))
            return fn(*args, lane_dim=lane_dim, **kw)
        return wrapped

    for name in ("glm_lbfgs_batched", "glm_fista_batched"):
        monkeypatch.setattr(plin, name, spy(getattr(plin, name)))
    rng = np.random.default_rng(11)
    X = rng.normal(size=(240, 12)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int) + (X[:, 2] > 0.8)
    h = hashlib.sha256()
    for est in (port.LogisticRegression(max_iter=40),
                port.LogisticRegression(max_iter=20, penalty="elasticnet",
                                        l1_ratio=0.5)):
        for yy in (y, (y > 0).astype(int)):
            gs = _port_search(est, {"C": [0.2, 3.0]}, X, yy, config=CPU,
                              refit=True)
            for a in (gs.cv_results_["mean_test_score"],
                      gs.best_estimator_.coef_,
                      gs.best_estimator_.intercept_):
                h.update(np.ascontiguousarray(a).tobytes())
    assert {c[0] for c in calls} == {"glm_lbfgs_batched",
                                     "glm_fista_batched"}
    assert all(c[1:] == (2, 0) for c in calls), calls
    if torch.__version__ != DENSE_LR_TORCH:
        pytest.skip(f"the digest was taken on torch {DENSE_LR_TORCH}")
    assert h.hexdigest()[:32] == DENSE_LR_DIGEST


@pytest.mark.parametrize("k,penalty", [(2, "l2"), (3, "l2"),
                                       (2, "elasticnet"), (3, "elasticnet")])
def test_sparse_logistic_state_is_feature_major(monkeypatch, k, penalty):
    """The sparse fit hands SP1 a view of its (d + 1, B, k') state as the
    forward's D and a view of the gradient's first d rows as the
    backward's out: no copy of the coefficients or of the gradient; the
    fit equals the dense one within 5e-3 (both stop at max|grad| 1e-4
    or 60 iterations, their sums in other orders; well-posed C)."""
    seen = {"mm": 0, "tmm": 0}
    mm, tmm = pcsr.CSROperand.mm, pcsr.CSROperand.tmm

    def spy_mm(self, D, out=None):
        assert D._base is not None and D._base.dim() == 3
        assert D._base.shape[0] == self.shape[1] + 1
        seen["mm"] += 1
        return mm(self, D, out)

    def spy_tmm(self, E, out=None):
        assert out is not None and out._base.dim() == 3
        assert out._base.shape[0] == self.shape[1] + 1
        seen["tmm"] += 1
        return tmm(self, E, out)

    monkeypatch.setattr(pcsr.CSROperand, "mm", spy_mm)
    monkeypatch.setattr(pcsr.CSROperand, "tmm", spy_tmm)
    X, y = _counts(n=120, d=30, density=0.15, k=k, seed=3)
    X = _normalized(X).tocsr()
    kw = {"l1_ratio": 0.5} if penalty == "elasticnet" else {}
    data, meta = pcsr_family().prepare_data_sparse(X, y)
    dev_data = {"X": data["X"].to_device("cpu"),
                "y": torch.as_tensor(data["y"])}
    B = 4
    w = torch.ones((B, 120))
    w[:, ::3] = 0.0
    dyn = {"C": torch.tensor([0.1, 0.3, 1.0, 3.0])}
    static = {"max_iter": 60, "penalty": penalty, **kw}
    got = pcsr_family().fit_task_batched(dyn, static, dev_data, w, meta)
    assert seen["mm"] > 0 and seen["tmm"] > 0
    dense = {"X": torch.as_tensor(X.toarray().astype(np.float32)),
             "y": dev_data["y"]}
    want = pcsr_family().fit_task_batched(dyn, static, dense, w, meta)
    kk = 1 if k == 2 else k
    assert got["coef"].shape == (B, kk, 30) and got["coef"].is_contiguous()
    assert got["intercept"].shape == (B, kk)
    np.testing.assert_allclose(got["coef"].numpy(), want["coef"].numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(got["intercept"].numpy(),
                               want["intercept"].numpy(), atol=5e-3)


def pcsr_family():
    from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
    return LogisticRegressionFamily
