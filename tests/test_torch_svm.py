"""The port's SVC and NuSVC against the JAX package's, on the CPU, and
against sklearn at the reference's own bounds (`tests/test_svm.py`).

Inputs are subsets of digits (d=64, 2-4 classes, 60-125 rows) and numpy
draws from fixed seeds.  Tolerances, each measured against the JAX
package on these inputs and stated where it is used:
- kernel matrices rtol 1e-5 (measured <= 2.3e-7 relative);
- projections atol 1e-5 (measured 1.2e-7), feasibility |Σ yb·a| and
  |Σ a − target| <= 1e-4 with 0 <= a <= bound exactly;
- dual alphas atol 1e-4 and intercepts 1e-5 (measured at most 1.6e-5
  and 7e-7 after 300 steps), nu decisions 1e-4 (measured 1.9e-5),
  `n_iter` within one step (the tol exit may flip a step between the two
  GEMMs);
- searches: mean_test_score within 5e-3 of the JAX package's with the
  same best_params_; against sklearn, 0.03 on binary and NuSVC scores and
  0.05 on multiclass ones (the reference's bounds, test_svm.py:34-36,
  :69-71).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.svm import SVC as SkSVC
from sklearn.svm import NuSVC as SkNuSVC

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import svm as jsvm
from spark_sklearn_tpu.models.standalone import SVC as JaxSVC
from spark_sklearn_tpu_torch.convert.params import (
    svc_from_jax,
    svc_model_from_jax,
)
from spark_sklearn_tpu_torch.models import svm as psvm
from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.ops import svm_kernels as sk
from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _subset(digits, classes, n):
    X, y = digits
    m = y < classes
    return X[m][:n], y[m][:n]


def _subproblems(X, y, k, n_folds, gamma=0.05):
    """Inputs of one candidate's stacked (fold x pair) duals, as both
    families build them: the rbf kernel matrix, signed pair labels and
    the box mask of each fold's training rows."""
    n = len(y)
    K = np.array(jsvm._kernel(jnp.asarray(X), jnp.asarray(X), "rbf", gamma,
                              3, 0))
    pairs = jsvm._pairs(k)
    ypos = y[None] == pairs[:, 0][:, None]
    yneg = y[None] == pairs[:, 1][:, None]
    yb = np.tile(ypos.astype(np.float32) - yneg.astype(np.float32),
                 (n_folds, 1))
    train = (np.arange(n) % n_folds)[None] != np.arange(n_folds)[:, None]
    base = (train[:, None, :] * (ypos | yneg)[None]).reshape(
        -1, n).astype(np.float32)
    return K, yb, base


# ---------------------------------------------------------------------------
# the pieces: kernel matrices, projections, the duals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "rbf", "poly", "sigmoid"])
def test_kernel_matches_reference(digits, kind):
    X, _ = digits
    X1, X2 = X[:50], X[50:90]
    got = psvm._kernel(_t(X1), _t(X2), kind, 0.05, 3.0, 0.5).numpy()
    want = np.asarray(jsvm._kernel(jnp.asarray(X1), jnp.asarray(X2), kind,
                                   0.05, 3.0, 0.5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if kind == "rbf":
        K = psvm._kernel(_t(X1), _t(X1), kind, 0.05, 3.0, 0.5)
        assert torch.all(K.diagonal() == 1.0)


@pytest.mark.parametrize("n1,n2", [(300, 257), (2000, 2000), (257, 1100),
                                   (1, 1), (40, 10000), (3, 5000),
                                   (1500, 3001)])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("kind,same,n_sm", [
    ("rbf", True, 132), ("rbf", False, 132), ("rbf", True, 1),
    ("rbf", False, 2), ("poly", False, 132)])
def test_gram_plan_covers_every_element_once(n1, n2, vec, kind, same,
                                             n_sm):
    """S1's launch as the kernel walks it (`gram_rbf`,
    `gram_elementwise` in csrc/svm_dual.cu), on an H100's 132 SMs and on
    grids small enough that a block takes many tiles: rbf's phase 1
    writes every norm once (X Xᵀ: the diagonal, a thread an element
    grid-stride; else X1's rows then X2's, a warp a row), at most
    `GRAM_BLOCKS_PER_SM` blocks an SM (the cooperative launch's bound);
    the epilogue tiles, row t // chunks and chunk t % chunks, write every
    element once, a float4 or 4 floats `GRAM_THREADS` apart a thread."""
    if same:
        n2 = n1
    if vec and n2 % 4:
        n2 += 4 - n2 % 4
        n1 = n2 if same else n1
    plan = sk.gram_plan(n1, n2, kind, n_sm)
    T, cols, grid = sk.GRAM_THREADS, sk.GRAM_COLS, plan["grid"]
    assert plan["tiles"] == n1 * plan["chunks"]
    if kind == "rbf":
        assert 1 <= grid <= n_sm * sk.GRAM_BLOCKS_PER_SM
        threads = grid * T
        norms = np.zeros(n1 if same else n1 + n2, dtype=np.int64)
        for gt in range(threads):
            if same:
                np.add.at(norms, np.arange(gt, n1, threads), 1)
            elif gt % 32 == 0:         # a warp's lane 0 writes its rows
                np.add.at(norms, np.arange(gt >> 5, n1 + n2, threads >> 5),
                          1)
        np.testing.assert_array_equal(norms, 1)
        # block b takes tiles b, b + grid, ...
        tiles = np.concatenate([np.arange(b, plan["tiles"], grid)
                                for b in range(grid)])
    else:
        assert grid == plan["tiles"]
        tiles = np.arange(grid)
    row, c = tiles // plan["chunks"], tiles % plan["chunks"]
    t = np.arange(T)
    q = np.arange(4)
    col = (c[:, None, None] * cols
           + (4 * t[None, :, None] + q if vec else t[None, :, None]
              + q * T))
    ok = col < n2
    if vec:                          # a float4 is all in or all out
        assert (ok == ok[:, :, :1]).all()
    count = np.zeros(n1 * n2, dtype=np.int32)
    np.add.at(count, (row[:, None, None] * n2 + col)[ok], 1)
    np.testing.assert_array_equal(count, 1)


def _projection_inputs(seed=0, M=6, n=80):
    rng = np.random.default_rng(seed)
    Z = (2.0 * rng.normal(size=(M, n))).astype(np.float32)
    yb = rng.choice([-1.0, 0.0, 1.0], size=(M, n),
                    p=[0.45, 0.1, 0.45]).astype(np.float32)
    bound = (rng.uniform(0.5, 2.0, size=(M, n))
             * (rng.random((M, n)) < 0.8) * (yb != 0)).astype(np.float32)
    target = rng.uniform(1.0, 5.0, size=M).astype(np.float32)
    return Z, yb, bound, target


@pytest.mark.parametrize("which", ["hyperplane", "box_sum"])
def test_projections_match_reference_and_are_feasible(which):
    Z, yb, bound, target = _projection_inputs()
    if which == "hyperplane":
        got = sk.project_box_hyperplane(_t(Z), _t(yb), _t(bound)).numpy()
        want = jsvm._project_box_hyperplane(*map(jnp.asarray,
                                                 (Z, yb, bound)))
        assert np.abs((got * yb).sum(axis=1)).max() <= 1e-4
    else:
        got = sk.project_box_sum(_t(Z), _t(bound), _t(target)).numpy()
        want = jsvm._project_box_sum(*map(jnp.asarray, (Z, bound, target)))
        assert np.abs(got.sum(axis=1) - target).max() <= 1e-4
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert (got >= 0).all() and (got <= bound).all()


def test_dual_step_plain_is_one_reference_step():
    """S2's plain version (both modes, and the projection of z alone)
    against the reference's step written out: project(z - step*grad),
    then the momentum and the residual."""
    Z, yb, bound, target = _projection_inputs(seed=1)
    rng = np.random.default_rng(2)
    V = rng.normal(size=Z.shape).astype(np.float32)
    X0 = rng.uniform(0, 1, size=Z.shape).astype(np.float32)
    step, coef = np.float32(0.3), np.float32(0.25)
    jz, jy, jb, jV, jx = map(jnp.asarray, (Z, yb, bound, V, X0))
    for mode in ("svc", "nu", "project"):
        tgt = None if mode == "svc" else target
        if mode == "svc":
            u = jz - step * -(1.0 - jy * jV)
            x_ref = jsvm._project_box_hyperplane(u, jy, jb)
        else:
            u = jz if mode == "project" else jz - step * (jy * jV)
            x_ref = (jsvm._project_box_sum(u, jnp.where(jy > 0, jb, 0.0),
                                           target)
                     + jsvm._project_box_sum(u, jnp.where(jy < 0, jb, 0.0),
                                             target))
        z_ref = x_ref + coef * (x_ref - jx)
        got = sk.dual_step(None if mode == "project" else _t(V), _t(Z),
                           _t(X0), _t(yb), _t(bound),
                           torch.tensor(step), float(coef),
                           None if tgt is None else _t(tgt))
        for a, b in zip(got, (x_ref, z_ref, z_ref * jy,
                              jnp.max(jnp.abs(x_ref - jz), axis=1) / step)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("C,tol,max_iter", [(2.0, None, 100),
                                            (0.05, 1e-3, 300),
                                            (0.2, 1e-3, 300)])
def test_fista_dual_ascent_matches_reference(digits, C, tol, max_iter):
    X, y = _subset(digits, 3, 120)
    K, yb, base = _subproblems(X, y, 3, 2)
    step = jsvm._power_step(jnp.asarray(K), len(y), jnp.float32)
    pstep = psvm._power_step(_t(K))
    np.testing.assert_allclose(float(pstep), float(step), rtol=1e-5)
    A, b, it = jsvm.fista_dual_ascent(jnp.asarray(K), jnp.asarray(yb),
                                      jnp.asarray(C * base), step, max_iter,
                                      tol)
    A2, b2, it2 = psvm.fista_dual_ascent(_t(K), _t(yb), _t(C * base), pstep,
                                         max_iter, tol)
    np.testing.assert_allclose(A2.numpy(), np.asarray(A), rtol=0, atol=1e-4)
    np.testing.assert_allclose(b2.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    assert abs(int(it2) - int(it)) <= 1
    if tol is not None:
        assert int(it2) < max_iter              # the residual exit fired
    A2 = A2.numpy()
    assert np.abs((A2 * yb).sum(axis=1)).max() <= 1e-4
    assert (A2 >= 0).all() and (A2 <= C * base).all()


def test_nu_dual_ascent_matches_reference_with_infeasible_rows(digits):
    """nu = 0.6 is feasible for the balanced pairs and infeasible for
    the pair whose second class was cut to 8 rows: those rows are NaN in
    both packages."""
    X, y = _subset(digits, 3, 120)
    keep = (y != 2) | (np.cumsum(y == 2) <= 8)
    X, y = X[keep], y[keep]
    K, yb, base = _subproblems(X, y, 3, 2)
    step = jsvm._power_step(jnp.asarray(K), len(y), jnp.float32)
    for nu in (0.3, 0.6):
        d, it = jsvm.nu_dual_ascent(jnp.asarray(K), jnp.asarray(yb),
                                    jnp.asarray(base), nu, step, 100, 1e-3)
        d2, it2 = psvm.nu_dual_ascent(_t(K), _t(yb), _t(base),
                                      torch.tensor(np.float32(nu)),
                                      psvm._power_step(_t(K)), 100, 1e-3)
        d, d2 = np.asarray(d), d2.numpy()
        np.testing.assert_array_equal(np.isnan(d2), np.isnan(d))
        np.testing.assert_allclose(d2, d, rtol=0, atol=1e-4)
        assert abs(int(it2) - int(it)) <= 1
    assert np.isnan(d2).all(axis=1).any() and not np.isnan(d2).all()


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["svc", "nu_svc"])
def test_fit_task_batched_matches_reference(digits, family):
    X, y = _subset(digits, 3, 90)
    n_folds, n = 3, len(y)
    pfam = psvm.SVCFamily if family == "svc" else psvm.NuSVCFamily
    jfam = jsvm.SVCFamily if family == "svc" else jsvm.NuSVCFamily
    data, meta = jfam.prepare_data(X, y)
    prim = np.repeat(np.array([0.5, 4.0] if family == "svc"
                              else [0.2, 0.5], np.float32), n_folds)
    gam = np.repeat(np.array([0.02, 0.05], np.float32), n_folds)
    train = np.tile(((np.arange(n) % n_folds)[None]
                     != np.arange(n_folds)[:, None]).astype(np.float32),
                    (2, 1))
    static = {"kernel": "rbf", "__n_folds__": n_folds, "max_iter": 150}
    dyn = {jfam.primary_param: prim, "gamma": gam}
    ref = jfam.fit_task_batched({k: jnp.asarray(v) for k, v in dyn.items()},
                                static, {k: jnp.asarray(v)
                                         for k, v in data.items()},
                                jnp.asarray(train), meta)
    got = pfam.fit_task_batched({k: _t(v) for k, v in dyn.items()}, static,
                                {k: _t(v) for k, v in data.items()},
                                _t(train), meta)
    np.testing.assert_allclose(got["pair_dec"].numpy(),
                               np.asarray(ref["pair_dec"]), rtol=0,
                               atol=1e-4)
    assert np.abs(got["n_iter"].numpy()
                  - np.asarray(ref["n_iter"])).max() <= 1
    # the search's views from the cache: the reference's per-task
    # predict and decision
    views = pfam.views_task_batched(got, static, None, meta,
                                    {"pred", "decision"})
    for t in range(train.shape[0]):
        task = {"pair_dec": ref["pair_dec"][t]}
        np.testing.assert_array_equal(
            views["pred"][t].numpy(),
            np.asarray(jfam.predict(task, static, None, meta)))
        np.testing.assert_allclose(
            views["decision"][t].numpy(),
            np.asarray(jfam.decision(task, static, None, meta)), rtol=0,
            atol=1e-4)


# (label, estimator name, params, grid, classes, rows, sklearn bound);
# the binary case is scored by accuracy, roc_auc (the decision view) and
# f1 at once
SEARCHES = [
    ("multiclass", "SVC", {}, {"C": [0.5, 5.0], "gamma": [0.01, 0.05]}, 4,
     100, 0.05),
    ("binary", "SVC", {}, {"C": [0.1, 1.0], "gamma": [0.05]}, 2, 120, 0.03),
    ("balanced", "SVC", {"class_weight": "balanced"}, {"C": [0.3, 3.0]}, 3,
     None, 0.05),
    ("gamma_scale", "SVC", {"gamma": "scale"}, {"C": [1.0, 10.0]}, 3, 120,
     0.05),
    ("gamma_auto_poly", "SVC", {"gamma": "auto", "kernel": "poly"},
     {"C": [0.5]}, 3, 120, 0.05),
    ("nusvc", "NuSVC", {}, {"nu": [0.1, 0.5]}, 2, 120, 0.03),
]


def _search_data(digits, classes, rows):
    X, y = digits
    if rows is not None:
        return _subset(digits, classes, rows)
    # imbalanced: 60 / 30 / 15 rows of classes 0 / 1 / 2
    idx = np.concatenate([np.where(y == c)[0][:m]
                          for c, m in ((0, 60), (1, 30), (2, 15))])
    return X[idx], y[idx]


@pytest.mark.parametrize("case", SEARCHES, ids=[s[0] for s in SEARCHES])
def test_search_matches_reference_and_sklearn(digits, case):
    label, name, params, grid, classes, rows, sk_bound = case
    X, y = _search_data(digits, classes, rows)
    sk_est = (SkSVC if name == "SVC" else SkNuSVC)(**params)
    scoring = ["accuracy", "roc_auc", "f1"] if label == "binary" else None
    refit = "accuracy" if scoring else True
    kw = dict(cv=3, scoring=scoring, refit=refit)
    ours = port.GridSearchCV(sk_est, grid, config=CPU, **kw).fit(X, y)
    ref = sst.GridSearchCV(sk_est, grid, **kw).fit(X, y)
    oracle = SkGridSearchCV(sk_est, grid, **kw).fit(X, y)
    for metric in scoring or ["score"]:
        got = ours.cv_results_[f"mean_test_{metric}"]
        np.testing.assert_allclose(
            got, ref.cv_results_[f"mean_test_{metric}"], rtol=0, atol=5e-3)
        np.testing.assert_allclose(
            got, oracle.cv_results_[f"mean_test_{metric}"], rtol=0,
            atol=sk_bound)
    assert ours.best_params_ == ref.best_params_
    assert ours.chunks_[0]["n_iter_exec"] <= 300


def test_port_estimators_search_and_refit(digits):
    """The port's own SVC in a binary search, refit on the full data on
    the search's device: the best estimator is the port's SVC fitted
    with the best parameters."""
    X, y = _subset(digits, 2, 90)
    gs = port.GridSearchCV(port.SVC(), {"C": [0.5, 5.0]}, cv=3,
                           config=CPU).fit(X, y)
    best = gs.best_estimator_
    assert isinstance(best, port.SVC) and best.device == "cpu"
    again = port.SVC(**gs.best_params_, device="cpu").fit(X, y)
    np.testing.assert_array_equal(best.decision_function(X),
                                  again.decision_function(X))
    assert best.decision_function(X).shape == (len(y),)
    assert (best.predict(X) == y).mean() > 0.95
    assert gs.best_score_ > 0.9


def test_infeasible_nu_gets_error_score(digits):
    """Imbalanced classes make nu=0.9 infeasible on every fold; alone,
    the search raises 'All the N fits failed' as sklearn's (and the
    reference's, test_svm.py:73-90) does; beside a feasible nu it scores
    error_score."""
    X, y = digits
    idx = np.concatenate([np.where(y == 0)[0][:100],
                          np.where(y == 1)[0][:25]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="fits failed"):
            port.GridSearchCV(SkNuSVC(), {"nu": [0.9]}, cv=3, refit=False,
                              error_score=np.nan, config=CPU).fit(X[idx],
                                                                  y[idx])
    with pytest.warns(UserWarning, match="fits failed"):
        gs = port.GridSearchCV(SkNuSVC(), {"nu": [0.1, 0.9]}, cv=3,
                               refit=False, error_score=-1.0,
                               config=CPU).fit(X[idx], y[idx])
    assert gs.cv_results_["mean_test_score"][1] == -1.0
    assert gs.cv_results_["mean_test_score"][0] > 0.9
    with pytest.raises(ValueError, match="infeasible"):
        port.NuSVC(nu=0.9, device="cpu").fit(X[idx], y[idx])


def test_unported_options_raise(digits):
    X, y = _subset(digits, 3, 90)
    # the host tier runs it; a search forced onto the device refuses it
    with pytest.raises(ValueError, match="precomputed"):
        port.GridSearchCV(SkSVC(kernel="precomputed"), {"C": [1.0]}, cv=3,
                          refit=False, backend="device",
                          config=CPU).fit(X @ X.T, y)
    # probability scorers need probability=True, as the reference's
    # predict_proba does (svm.py:777-778)
    with pytest.raises(NotImplementedError, match="probability=True"):
        port.GridSearchCV(SkSVC(), {"C": [1.0]}, cv=3, refit=False,
                          scoring="neg_log_loss", config=CPU).fit(X, y)
    # sklearn 1.9's "deprecated" default of probability is not True
    assert not psvm._probability_on({"probability": "deprecated"})


def test_families_resolve_and_chunks_follow_the_hint(digits, monkeypatch):
    """sklearn's and the port's classes resolve to the families; a small
    `max_tasks_hint` cuts the search into one candidate a chunk with the
    same scores, and each chunk records its lanes' largest step count."""
    for est, fam in ((SkSVC(), psvm.SVCFamily), (port.SVC(), psvm.SVCFamily),
                     (SkNuSVC(), psvm.NuSVCFamily),
                     (port.NuSVC(), psvm.NuSVCFamily)):
        assert resolve_family(est) is fam
    X, y = _subset(digits, 2, 120)
    grid = {"C": [0.01, 0.1, 10.0]}
    cv = SkStratifiedKFold(3)
    wide = port.GridSearchCV(port.SVC(), grid, cv=cv, refit=False,
                             config=CPU).fit(X, y)
    monkeypatch.setattr(psvm.SVCFamily, "max_tasks_hint",
                        staticmethod(lambda n, meta: 2))
    narrow = port.GridSearchCV(port.SVC(), grid, cv=cv, refit=False,
                               config=CPU).fit(X, y)
    assert len(wide.chunks_) == 1 and len(narrow.chunks_) == 3
    assert all(c["lanes"] == 3 for c in narrow.chunks_)
    np.testing.assert_array_equal(wide.cv_results_["mean_test_score"],
                                  narrow.cv_results_["mean_test_score"])
    per_cand = [c["n_iter_exec"] for c in narrow.chunks_]
    assert wide.chunks_[0]["n_iter_exec"] == max(per_cand)
    assert per_cand[0] < per_cand[-1]        # small C converges sooner


def test_padded_candidates_are_not_solved(digits, monkeypatch):
    """Three candidates in chunks of two: the second chunk is padded with
    a copy of its last candidate, which is not solved again.  Three
    solves in all, and the scores of one unpadded chunk."""
    X, y = _subset(digits, 2, 120)
    grid = {"C": [0.01, 0.1, 10.0]}
    cv = SkStratifiedKFold(3)
    wide = port.GridSearchCV(port.SVC(), grid, cv=cv, refit=False,
                             config=CPU).fit(X, y)
    solves = []
    pair_dec = psvm.SVCFamily._pair_dec.__func__

    def counted(cls, *args, **kw):
        solves.append(1)
        return pair_dec(cls, *args, **kw)

    monkeypatch.setattr(psvm.SVCFamily, "_pair_dec", classmethod(counted))
    monkeypatch.setattr(psvm.SVCFamily, "max_tasks_hint",
                        staticmethod(lambda n, meta: 6))
    padded = port.GridSearchCV(port.SVC(), grid, cv=cv, refit=False,
                               config=CPU).fit(X, y)
    assert [c["lanes"] for c in padded.chunks_] == [6, 6]
    assert len(solves) == 3
    np.testing.assert_array_equal(wide.cv_results_["mean_test_score"],
                                  padded.cv_results_["mean_test_score"])


def test_standalone_svc_matches_jax(digits):
    """The port's SVC against the JAX standalone SVC fitted on the same
    data (decisions atol 1e-3 after the tol exit), and the JAX model
    carried into the port by `svc_from_jax`, which predicts exactly what
    it does (decisions atol 1e-5)."""
    X, y = _subset(digits, 3, 60)
    params = {"C": 2.0, "gamma": "scale", "class_weight": "balanced"}
    ref = JaxSVC(**params).fit(X, y)
    ours = port.SVC(**params, device="cpu").fit(X, y)
    np.testing.assert_array_equal(ours.classes_, ref.classes_)
    np.testing.assert_allclose(ours.decision_function(X),
                               ref.decision_function(X), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ours.predict(X), ref.predict(X))
    carried = svc_from_jax(ref, device="cpu")
    X_new = digits[0][-40:]
    np.testing.assert_array_equal(carried.predict(X_new), ref.predict(X_new))
    np.testing.assert_allclose(carried.decision_function(X_new),
                               ref.decision_function(X_new), rtol=0,
                               atol=1e-5)


def test_standalone_nusvc_is_its_search_fit(digits):
    """NuSVC's representer form gives the decisions the family computes
    for the same full-data subproblem."""
    X, y = _subset(digits, 2, 100)
    est = port.NuSVC(nu=0.3, device="cpu").fit(X, y)
    data, meta = psvm.NuSVCFamily.prepare_data(X, y)
    model = psvm.NuSVCFamily.fit_task_batched(
        {}, {"nu": 0.3, "__n_folds__": 1}, {k: _t(v) for k, v in
                                            data.items()},
        torch.ones((1, len(y))), meta)
    np.testing.assert_allclose(est.decision_function(X),
                               model["pair_dec"][0, :, 0].numpy(), rtol=0,
                               atol=1e-4)
    assert (est.predict(X) == y).mean() > 0.95


def test_small_c_intercept_is_a_float_sensitivity_of_the_reference():
    """At C=0.1 on data shaped as chip_smoke.py phase 8's (here 600 rows
    of it, 3 folds) the dual exits after a few steps with nearly every
    alpha at its bound C, and the KKT intercept turns on a 1e-6 band: an
    alpha counts as free (then b is the mean E over free SVs) unless it
    lies within C*1e-6 of 0 or C (then b is the midpoint of the feasible
    interval).  The port and the JAX package reach the same alphas to
    rounding (atol 5e-6, C = 0.1), yet an alpha that one side leaves
    1e-6 inside the box the other puts on the bound, so whole intercepts
    differ by more than 0.5 and the search scores above 0.4 on the
    port's CPU path against below 0.15 (chance, 0.1) in the JAX package.
    Where both sides find the same free set the intercepts agree (atol
    1e-4), and every alpha that only one side calls free sits within
    2e-5 x C of the bound: the split comes from rounding, not from a
    different rule."""
    import chip_smoke

    X, y = chip_smoke.mnist_like(0)
    idx = np.concatenate([np.where(y == c)[0][:60] for c in range(10)])
    X, y = X[idx], y[idx]
    n, C = len(y), 0.1
    gamma = 1.0 / (X.shape[1] * float(np.var(X)))
    train = np.zeros((3, n), np.float32)
    for f, (tr, _) in enumerate(port.StratifiedKFold(3).split(X, y)):
        train[f, tr] = 1.0
    pairs = jsvm._pairs(10)
    ypos = y[None] == pairs[:, 0][:, None]
    yneg = y[None] == pairs[:, 1][:, None]
    yb = np.tile(ypos.astype(np.float32) - yneg.astype(np.float32), (3, 1))
    bound = C * (train[:, None, :] * (ypos | yneg)[None]).reshape(-1, n)
    K = jsvm._kernel(jnp.asarray(X), jnp.asarray(X), "rbf", gamma, 3, 0)
    step = jsvm._power_step(K, n, K.dtype)
    A_j, b_j, it_j = jax.jit(lambda K, s: jsvm.fista_dual_ascent(
        K, jnp.asarray(yb), jnp.asarray(bound), s, 300, 1e-3))(K, step)
    Kt = psvm._kernel(_t(X), _t(X), "rbf", gamma, 3, 0)
    A_p, b_p, it_p = psvm.fista_dual_ascent(
        Kt, _t(yb), _t(bound), psvm._power_step(Kt), 300, 1e-3)
    A_j, b_j, A_p, b_p = map(np.asarray, (A_j, b_j, A_p, b_p))
    assert int(it_j) == int(it_p) < 300
    np.testing.assert_allclose(A_p, A_j, rtol=0, atol=5e-6)

    def free(A):
        inb = bound > 0
        return inb & (A > bound * 1e-6) & (A < bound * (1.0 - 1e-6))

    f_j, f_p = free(A_j), free(A_p)
    same = (f_j == f_p).all(axis=1)
    assert (~same).any()                   # the effect is present here
    np.testing.assert_allclose(b_p[same], b_j[same], rtol=0, atol=1e-4)
    assert np.abs(b_p[~same] - b_j[~same]).max() > 0.5
    only_one = f_j != f_p
    near = np.minimum(np.abs(A_j - bound), np.abs(A_p - bound))
    assert (near[only_one] <= 2e-5 * C).all()
    # and so the searches' scores part far
    grid = {"C": [C], "gamma": [gamma]}
    ref = sst.GridSearchCV(SkSVC(kernel="rbf"), grid, cv=3, refit=False,
                           backend="tpu").fit(X, y)
    ours = port.GridSearchCV(port.SVC(kernel="rbf"), grid, cv=3,
                             refit=False, config=CPU).fit(X, y)
    assert ref.cv_results_["mean_test_score"][0] < 0.15
    assert ours.cv_results_["mean_test_score"][0] > 0.4


# ---------------------------------------------------------------------------
# probability=True: Platt scaling (P1) and pairwise coupling (P2)
# ---------------------------------------------------------------------------

def _platt_case(case, seed=0, R=6, n=80):
    rng = np.random.default_rng(seed)
    y01 = rng.random((R, n)) < 0.5
    f = (rng.standard_normal((R, n)) + np.where(y01, 1.5, -1.5)).astype(
        np.float32)
    t = np.where(y01, 0.9, 0.05).astype(np.float32)
    w = (rng.random((R, n)) < 0.8).astype(np.float32)
    if case == "separable":
        # far apart decisions: full Newton steps overshoot and halve
        f = np.where(y01, 8.0, -8.0).astype(np.float32) + \
            0.01 * rng.standard_normal((R, n)).astype(np.float32)
    elif case == "nan_and_empty":
        f[0, 3] = np.nan                      # a NaN decision in row 0
        w[1] = 0.0                            # an all-masked row
    return f, t, w


@pytest.mark.parametrize("case", ["informative", "separable",
                                  "nan_and_empty"])
def test_platt_fit_plain_matches_reference(case):
    """P1's plain fit against `_platt_fit` (svm.py:331-393): A and B rtol
    and atol 1e-3 (sums in another order can flip a step's acceptance or
    the 1e-5 gradient stop near convergence: measured <= 1.6e-4), NaN
    where the reference's is NaN."""
    f, t, w = _platt_case(case)
    A, B = jsvm._platt_fit(jnp.asarray(f), jnp.asarray(t), jnp.asarray(w))
    a, b = pk.platt_fit_plain(_t(f), _t(t), _t(w))
    np.testing.assert_allclose(a.numpy(), np.asarray(A), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(b.numpy(), np.asarray(B), rtol=1e-3,
                               atol=1e-3)
    if case == "nan_and_empty":
        # a rejected (non-finite) step leaves A and B where they started
        assert a[0].item() == 0.0 and np.isfinite(b[0].item())
        assert a[1].item() == 0.0


def _platt_rows(case, seed):
    """P1's row inputs as the family hands them: binary labels (one pair)
    or 4 classes (6 pairs), 3 tasks' fold weights with zeros, a task
    with no weight at all, a NaN decision and near-separable rows; or
    ("cycles") 2 KFold(5)-like tasks of 10000 rows and 4 classes, whose
    sums are long enough that some rows end accepting steps of a few ulps
    back and forth, repeating their states."""
    rng = np.random.default_rng(seed)
    if case == "cycles":
        k, B, n = 4, 2, 10000
        pairs = np.array([(i, j) for i in range(k)
                          for j in range(i + 1, k)], np.int32)
        y = rng.integers(0, k, n).astype(np.int32)
        dec = 1.5 * rng.standard_normal((B, n, len(pairs))).astype(
            np.float32)
        dec += ((y[:, None] == pairs[None, :, 0]).astype(np.float32)
                - (y[:, None] == pairs[None, :, 1]))[None]
        tw = np.ones((B, n), np.float32)
        for b in range(B):
            tw[b, b::5] = 0.0
        return (_t(dec), _t(y), _t(tw), pairs, False)
    k, B, n = (2, 3, 300) if case == "binary" else (4, 3, 300)
    pairs = np.array([(i, j) for i in range(k) for j in range(i + 1, k)],
                     np.int32)
    y = rng.integers(0, k, n).astype(np.int32)
    dec = rng.standard_normal((B, n, len(pairs))).astype(np.float32)
    for p, (i, j) in enumerate(pairs):
        sign = (y == i).astype(np.float32) - (y == j).astype(np.float32)
        dec[:, :, p] += (-1.0 if case == "binary" else 1.0) * 1.5 * sign
    dec[1] *= 30.0                                 # near-separable rows
    tw = (rng.random((B, n)) < 0.8).astype(np.float32)
    tw[2] = 0.0                                    # an all-masked task
    dec[0, 7, 0] = np.nan                          # a NaN decision
    return (_t(dec), _t(y), _t(tw), pairs, case == "binary")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["binary", "pairs"])
def test_platt_fit_plain_fixed_point_is_final(case, seed):
    """P1's exit rests on this: once a Newton step leaves a row's A and B
    bitwise as they were, no later step moves them (a step depends only
    on A, B and the carried loss).  Over seeded binary and pair rows,
    with zero weights, an all-masked task and a NaN decision, the
    "unchanged" mask of a row never turns back to moving; rows reach it
    at different steps."""
    _, _, tr = pk.platt_fit_rows_plain(*_platt_rows(case, seed), trace=True)
    unchanged = tr["unchanged"]
    assert unchanged.shape[0] == pk.N_NEWTON
    assert bool((unchanged[1:] | ~unchanged[:-1]).all())
    first = tr["steps"]
    assert bool((unchanged.sum(dim=0) == pk.N_NEWTON - first + 1)[
        unchanged[-1]].all())
    assert int(first.min()) < int(first.max())
    assert bool((tr["trials"] <= tr["trials_all"]).all())
    assert bool((tr["trials"] <= first).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["binary", "pairs"])
def test_platt_fit_plain_exit_equals_full_run(case, seed):
    """`platt_fit_plain` stopped at each row's first unchanged step gives
    the 50-step result bit for bit (NaN rows included), as P1's exit
    must."""
    rows = _platt_rows(case, seed)
    A, B, tr = pk.platt_fit_rows_plain(*rows, trace=True)
    A2, B2 = pk.platt_fit_rows_plain(*rows, exit_early=True)
    assert torch.equal(A.view(torch.int32), A2.view(torch.int32))
    assert torch.equal(B.view(torch.int32), B2.view(torch.int32))
    assert bool((A != 0).any())
    # the NaN decision's rows reject every step: A stays at its start
    P = rows[3].shape[0]
    assert float(A[0]) == 0.0 and bool(torch.isfinite(B[:P]).all())
    assert bool((tr["steps"][tr["period"] == 0] == pk.N_NEWTON).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_platt_fit_plain_cycle_exit_equals_full_run(seed):
    """Rows that never reach a fixed point but repeat a state (A, B) p <=
    `N_CYCLE` steps back: `platt_fit_plain` stopped there, with the state
    the period gives the 50th step, equals the 50-step result bit for
    bit, and the periods found repeat in the full run."""
    rows = _platt_rows("cycles", seed)
    A, B, tr = pk.platt_fit_rows_plain(*rows, trace=True)
    A2, B2, tr2 = pk.platt_fit_rows_plain(*rows, exit_early=True,
                                          trace=True)
    assert torch.equal(A.view(torch.int32), A2.view(torch.int32))
    assert torch.equal(B.view(torch.int32), B2.view(torch.int32))
    period, steps = tr["period"], tr["steps"]
    assert int((period > 1).sum()) >= 2 and torch.equal(period,
                                                         tr2["period"])
    assert bool((steps[period > 1] < pk.N_NEWTON).all())
    # a cycling row moves at every step from its first repeat on
    moved = ~tr["unchanged"]
    for r in torch.where(period > 1)[0].tolist():
        assert bool(moved[int(steps[r]) - 1:, r].all())


@pytest.mark.parametrize("k", [3, 5])
def test_pair_coupling_plain_matches_reference(k):
    """P2's plain version against `_pair_probs_to_R` and
    `_pairwise_coupling` (atol 1e-6), probabilities at the clip's ends
    and a NaN pair included; its sigmoid form against the reference's
    (svm.py:774)."""
    rng = np.random.default_rng(k)
    pairs = jsvm._pairs(k)
    P = len(pairs)
    r = rng.random((28, P)).astype(np.float32)
    r[0, 0], r[1, 0], r[7, -1] = 0.0, 1.0, np.nan
    want = jsvm._pairwise_coupling(jsvm._pair_probs_to_R(
        jnp.asarray(r), jnp.asarray(pairs), k))
    got = pk.pairwise_coupling(pk.pair_probs_to_R(_t(r), _t(pairs), k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert np.isnan(got[7].numpy()).all()
    dec = rng.standard_normal((4, 7, P)).astype(np.float32)
    platt = rng.standard_normal((4, P, 2)).astype(np.float32)
    via = pk.pair_coupling(_t(dec), _t(platt), pairs, k)
    sig = jax.nn.sigmoid(-(dec * platt[:, None, :, 0]
                           + platt[:, None, :, 1]))
    want = jsvm._pairwise_coupling(jsvm._pair_probs_to_R(
        sig.reshape(28, P), jnp.asarray(pairs), k))
    np.testing.assert_allclose(via.numpy().reshape(28, k), np.asarray(want),
                               rtol=0, atol=1e-6)


def _deferred_coupling(R, n_iter=pk.N_SWEEPS):
    """The recurrence P2's kernels run, in plain torch float32: each sweep
    from p alone, p~ and (Qp)~ kept unscaled beside sig = 1 / s and pq =
    p~' Q p~; a step u = (pq - sig x) / (sig Q_tt), p~_t += u, (Qp)~ +=
    u Q[t, :] past t, sig += u, pq += u (u Q_tt + 2 x); p = p~ / sig at
    the sweep's end."""
    k = R.shape[-1]
    eye = torch.eye(k, dtype=R.dtype)
    R0 = R * (1.0 - eye)
    RT = R0.transpose(-1, -2)
    Q = -(RT * R0) + eye * (RT ** 2).sum(dim=-1)[..., :, None]
    qd = torch.diagonal(Q, dim1=-2, dim2=-1)
    p = torch.full(R.shape[:-1], 1.0 / k, dtype=R.dtype)
    for _ in range(n_iter):
        qp = torch.einsum("...tj,...j->...t", Q, p)
        pq = (p * qp).sum(dim=-1)
        sig = torch.ones_like(pq)
        pt = p.clone()
        for t in range(k):
            x = qp[..., t]
            u = (pq - sig * x) * (1.0 / (sig * qd[..., t]))
            sig = sig + u
            pq = pq + u * (u * qd[..., t] + 2.0 * x)
            pt[..., t] += u
            qp[..., t + 1:] += u[..., None] * Q[..., t, t + 1:]
        p = pt * (1.0 / sig)[..., None]
    return p


@pytest.mark.parametrize("k", [3, 10, 13, 26])
def test_deferred_coupling_matches_reference(k):
    """The deferred-rescale recurrence of P2's kernels (a plain-torch
    mirror, used by this test only) against the reference's
    `_pairwise_coupling` on the same R, float32 both: atol 1e-5 (the
    algebra is exact; the roundings differ)."""
    rng = np.random.default_rng(k)
    pairs = jsvm._pairs(k)
    y = rng.integers(0, k, 200)
    sign = ((y[:, None] == pairs[None, :, 0]).astype(np.float32)
            - (y[:, None] == pairs[None, :, 1]).astype(np.float32))
    dec = 1.5 * rng.standard_normal((200, len(pairs))) + sign
    A = -1.0 - rng.random(len(pairs))
    B = 0.2 * rng.standard_normal(len(pairs))
    r = (1.0 / (1.0 + np.exp(A * dec + B))).astype(np.float32)
    want = jsvm._pairwise_coupling(jsvm._pair_probs_to_R(
        jnp.asarray(r), jnp.asarray(pairs), k))
    got = _deferred_coupling(pk.pair_probs_to_R(_t(r), _t(pairs), k))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("family,classes", [("svc", 2), ("svc", 3),
                                            ("nu_svc", 3)])
def test_probability_fit_matches_reference(digits, family, classes):
    """fit_task_batched with probability=True: the Platt sigmoids of every
    task (A, B atol 2e-3: fitted on decisions that agree to 1e-4), and the
    port's predict_proba of the reference's model carried over by
    `svc_model_from_jax` against the reference's per task (atol 1e-5)."""
    X, y = _subset(digits, classes, 90)
    n_folds, n = 3, len(y)
    pfam = psvm.SVCFamily if family == "svc" else psvm.NuSVCFamily
    jfam = jsvm.SVCFamily if family == "svc" else jsvm.NuSVCFamily
    data, meta = jfam.prepare_data(X, y)
    train = (((np.arange(n) % n_folds)[None]
              != np.arange(n_folds)[:, None])).astype(np.float32)
    static = {"kernel": "rbf", "__n_folds__": n_folds, "max_iter": 150,
              "probability": True, "gamma": 0.03}
    dyn = {jfam.primary_param: np.full(n_folds, 0.3 if family == "nu_svc"
                                       else 2.0, np.float32)}
    ref = jfam.fit_task_batched({k: jnp.asarray(v) for k, v in dyn.items()},
                                static, {k: jnp.asarray(v)
                                         for k, v in data.items()},
                                jnp.asarray(train), meta)
    got = pfam.fit_task_batched({k: _t(v) for k, v in dyn.items()}, static,
                                {k: _t(v) for k, v in data.items()},
                                _t(train), meta)
    key = "platt" if classes == 2 else "platt_pair"
    np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                               rtol=0, atol=2e-3)
    carried = svc_model_from_jax(ref, device="cpu")
    proba = pfam.views_task_batched(carried, static, None, meta,
                                    {"proba"})["proba"]
    for t in range(n_folds):
        task = {"pair_dec": ref["pair_dec"][t], key: ref[key][t]}
        np.testing.assert_allclose(
            proba[t].numpy(),
            np.asarray(jfam.predict_proba(task, static, None, meta)),
            rtol=0, atol=1e-5)


PROBA_SEARCHES = [
    ("binary", "SVC", {"C": [0.3, 3.0]}, 2, ["neg_log_loss", "accuracy"]),
    ("multiclass", "SVC", {"C": [0.5, 5.0], "gamma": [0.01, 0.05]}, 4,
     ["neg_log_loss", "accuracy"]),
    ("nusvc_binary", "NuSVC", {"nu": [0.2, 0.5]}, 2, "neg_log_loss"),
    ("nusvc_multiclass", "NuSVC", {"nu": [0.1, 0.3]}, 3, "neg_log_loss"),
]


@pytest.mark.parametrize("case", PROBA_SEARCHES,
                         ids=[c[0] for c in PROBA_SEARCHES])
def test_probability_search_matches_reference(digits, case):
    """probability=True searches on shared X: mean_test_<scorer> within
    5e-3 of the JAX package's and the same best_params_; both warn that
    the calibration is in-sample."""
    label, name, grid, classes, scoring = case
    X, y = _subset(digits, classes, 120)
    est = (SkSVC if name == "SVC" else SkNuSVC)(probability=True)
    refit = scoring[0] if isinstance(scoring, list) else True
    with pytest.warns(UserWarning, match="train-fold decision values"):
        ours = port.GridSearchCV(est, grid, cv=3, scoring=scoring,
                                 refit=refit, config=CPU).fit(X, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(est, grid, cv=3, scoring=scoring,
                               refit=refit).fit(X, y)
    for metric in (scoring if isinstance(scoring, list) else ["score"]):
        np.testing.assert_allclose(
            ours.cv_results_[f"mean_test_{metric}"],
            ref.cv_results_[f"mean_test_{metric}"], rtol=0, atol=5e-3)
    assert ours.best_params_ == ref.best_params_


def test_probability_pipeline_search_matches_reference(digits):
    """StandardScaler + SVC(probability=True) scored by neg_log_loss: each
    fold's transformed rows, its own kernel matrix and Platt sigmoids;
    within 5e-3 of the JAX package's."""
    from sklearn.pipeline import Pipeline as SkPipeline
    from sklearn.preprocessing import StandardScaler as SkScaler
    X, y = _subset(digits, 3, 90)
    pipe = SkPipeline([("sc", SkScaler()),
                       ("svc", SkSVC(probability=True))])
    grid = {"svc__C": [0.5, 5.0]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = port.GridSearchCV(pipe, grid, cv=3, scoring="neg_log_loss",
                                 refit=False, config=CPU).fit(X, y)
        ref = sst.GridSearchCV(pipe, grid, cv=3, scoring="neg_log_loss",
                               refit=False).fit(X, y)
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], rtol=0,
                               atol=5e-3)


@pytest.mark.parametrize("classes", [2, 3])
def test_standalone_probability_is_its_search_fit(digits, classes):
    """The port's SVC(probability=True): Platt sigmoids on its own
    training decisions, every row weighted 1, as the search fits a task
    with all-ones weights (predict_proba atol 1e-4); rows sum to 1 and
    the refit of a search is such an estimator."""
    X, y = _subset(digits, classes, 90)
    est = port.SVC(C=2.0, gamma=0.03, probability=True,
                   device="cpu").fit(X, y)
    proba = est.predict_proba(X)
    data, meta = psvm.SVCFamily.prepare_data(X, y)
    model = psvm.SVCFamily.fit_task_batched(
        {}, {"C": 2.0, "gamma": 0.03, "probability": True,
             "__n_folds__": 1}, {k: _t(v) for k, v in data.items()},
        torch.ones((1, len(y))), meta)
    want = psvm.SVCFamily.predict_proba(model, {}, None, meta)[0]
    np.testing.assert_allclose(proba, want.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=0, atol=1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gs = port.GridSearchCV(port.SVC(probability=True), {"C": [1.0]},
                               cv=3, scoring="neg_log_loss",
                               config=CPU).fit(X, y)
    assert gs.best_estimator_.predict_proba(X[:4]).shape == (4, classes)
    with pytest.raises(NotImplementedError, match="probability=True"):
        port.SVC(device="cpu").fit(X, y).predict_proba(X)
