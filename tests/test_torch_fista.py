"""The port's proximal FISTA and the l1/elasticnet LogisticRegression it
fits, against the JAX package's on the same problems, and the binary l1
search against sklearn's saga at the reference's own bound
(`tests/test_search_basic.py:418-431`, 0.01).

Tolerances: `glm_fista_batched` x within atol 1e-4 and n_iter within 2
of the reference's (both sum the GEMMs in float32 in another order, and
the done test `max|x_new - x| <= tol` can flip one or two iterations
early or late on that rounding).  Where they differ: a weakly
regularised lane still unconverged after hundreds of iterations drifts
away from the reference's by that rounding (up to ~1e-2 after 1000
iterations at C=50) along directions in which the objective is flat, so
for such lanes the objective is held to rtol 1e-4 instead.  The
searches' mean_test_score is held within 5e-3 of the JAX package's (the
repo's oracle bound for float32 training)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression as SkLogReg
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.ops.solvers import glm_fista_batched as jax_fista
from spark_sklearn_tpu_torch.models.linear import (
    LogisticRegressionFamily,
    resolve_penalty,
)
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops.solvers import glm_fista_batched

CPU = port.TorchConfig(device="cpu")
INV_C = np.array([20.0, 2.0, 0.2, 0.02], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(digits, k):
    X, y = digits
    if k == 2:
        X, y = X[y < 2][:240], y[y < 2][:240]
    else:
        X, y = X[:300], y[:300]
    rng = np.random.default_rng(0)
    w = (rng.random((len(INV_C), len(y))) < 0.7).astype(np.float32)
    return X, y.astype(np.int32), w


def _penalties(B, d, kk, l1_ratio):
    D = kk * d + kk
    pen = np.zeros((B, D), np.float32)
    pen[:, :kk * d] = 1.0
    l1 = (INV_C * np.float32(l1_ratio))[:, None] * pen
    l2 = (INV_C * (np.float32(1.0) - np.float32(l1_ratio)))[:, None] * pen
    return l1, l2, D


def _jax_closures(X, y, wT, k):
    d = X.shape[1]
    B = wT.shape[1]
    kk = 1 if k == 2 else k
    y1h = jax.nn.one_hot(y, k)

    def Ax(x):
        Z = jnp.einsum("nd,bkd->nbk", X, x[:, :kk * d].reshape(B, kk, d)) \
            + x[None, :, kk * d:]
        return Z[:, :, 0] if k == 2 else Z

    def data_loss(Z):
        if k == 2:
            per = jnp.logaddexp(0.0, Z) - y[:, None] * Z
        else:
            per = jax.scipy.special.logsumexp(Z, axis=2) - jnp.einsum(
                "nbk,nk->nb", Z, y1h)
        return jnp.sum(wT * per, axis=0)

    def data_grad(Z):
        if k == 2:
            return wT * (jax.nn.sigmoid(Z) - y[:, None])
        return wT[:, :, None] * (jax.nn.softmax(Z, axis=2) - y1h[:, None])

    def AT(G):
        G3 = G[:, :, None] if k == 2 else G
        gW = jnp.einsum("nbk,nd->bkd", G3, X).reshape(B, kk * d)
        return jnp.concatenate([gW, jnp.sum(G3, axis=0)], axis=1)

    return Ax, data_loss, data_grad, AT


def _port_closures(X, y, wT, k):
    n, d = X.shape
    B = wT.shape[1]
    kk = 1 if k == 2 else k

    def Ax(x):
        Z = torch.addmm(x[:, kk * d:].reshape(1, B * kk), X,
                        x[:, :kk * d].reshape(B * kk, d).T)
        return Z if k == 2 else Z.view(n, B, k)

    def AT(G):
        G2 = G.reshape(n, B * kk)
        return torch.cat([(G2.T @ X).reshape(B, kk * d),
                          G2.sum(dim=0).reshape(B, kk)], dim=1)

    return Ax, lambda Z: gk.glm_loss_grad(Z, wT, y), AT


@pytest.mark.parametrize("k,l1_ratio,max_iter", [
    (2, 1.0, 60), (2, 0.5, 400), (10, 1.0, 60), (10, 0.5, 300)])
def test_fista_matches_jax_solver(digits, k, l1_ratio, max_iter):
    """Every lane's x after 60 iterations; after 300-400, the x of the
    lanes both sides converged and every lane's objective."""
    X, y, w = _problem(digits, k)
    B, d = w.shape[0], X.shape[1]
    l1, l2, D = _penalties(B, d, 1 if k == 2 else k, l1_ratio)
    yj = jnp.asarray(y, jnp.float32) if k == 2 else jnp.asarray(y)
    ref = jax_fista(*_jax_closures(jnp.asarray(X), yj, jnp.asarray(w.T), k),
                    jnp.asarray(l1), jnp.asarray(l2),
                    jnp.zeros((B, D), jnp.float32), max_iter=max_iter,
                    tol=1e-4)
    got = glm_fista_batched(
        *_port_closures(torch.as_tensor(X), torch.as_tensor(y),
                        torch.as_tensor(w.T.copy()), k),
        torch.as_tensor(l1), torch.as_tensor(l2), torch.zeros((B, D)),
        max_iter=max_iter, tol=1e-4)
    lanes = slice(None)
    if max_iter > 60:
        lanes = got.converged.numpy() & np.asarray(ref.converged)
        assert lanes.any()
    np.testing.assert_allclose(got.x.numpy()[lanes], np.asarray(ref.x)[lanes],
                               atol=1e-4)
    assert abs(int(got.n_iter[0]) - int(ref.n_iter[0])) <= 2
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(ref.fun),
                               rtol=1e-4)


@pytest.mark.parametrize("static,want", [
    ({"penalty": "l1"}, ("elasticnet", 1.0)),
    ({"penalty": "elasticnet", "l1_ratio": 0.3}, ("elasticnet", 0.3)),
    ({"penalty": "elasticnet", "l1_ratio": 0.0}, ("l2", 0.0)),
    ({"penalty": "deprecated", "l1_ratio": 1.0}, ("elasticnet", 1.0)),
    ({"penalty": "deprecated", "l1_ratio": 0.0}, ("l2", 0.0)),
    ({"penalty": None}, (None, 0.0)),
    ({}, ("l2", 0.0)),
])
def test_penalty_resolution_follows_the_reference(static, want):
    assert resolve_penalty(static) == want


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("penalty,l1_ratio", [("l1", 0.0),
                                              ("elasticnet", 0.5)])
def test_fit_task_batched_matches_jax(digits, binary, penalty, l1_ratio):
    """The family's FISTA branch end to end (a budget of 1000
    iterations): the coefficients of the lanes both sides converged
    within atol 1e-4, every lane's objective within rtol 1e-4, and the
    executed and reported iteration counts within 2."""
    from spark_sklearn_tpu.models.linear import (
        LogisticRegressionFamily as JaxFam)
    X, y, w = _problem(digits, 2 if binary else 10)
    C = (1.0 / INV_C).astype(np.float32)
    static = {"penalty": penalty, "l1_ratio": l1_ratio, "max_iter": 10}
    dj, mj = JaxFam.prepare_data(X, y)
    ref = JaxFam.fit_task_batched(
        {"C": jnp.asarray(C)}, static,
        {k: jnp.asarray(v) for k, v in dj.items()}, jnp.asarray(w), mj)
    dp, mp = LogisticRegressionFamily.prepare_data(X, y)
    got = LogisticRegressionFamily.fit_task_batched(
        {"C": torch.as_tensor(C)}, static,
        {k: torch.as_tensor(v) for k, v in dp.items()}, torch.as_tensor(w),
        mp)
    converged = got["converged"].numpy() & np.asarray(ref["converged"])
    assert converged.any()
    for key in ("coef", "intercept"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy()[converged],
                                   np.asarray(ref[key])[converged],
                                   atol=1e-4)
    l1r = 1.0 if penalty == "l1" else l1_ratio
    np.testing.assert_allclose(
        _objective(X, y, w, got["coef"].numpy(), got["intercept"].numpy(),
                   1.0 / C, l1r),
        _objective(X, y, w, np.asarray(ref["coef"]),
                   np.asarray(ref["intercept"]), 1.0 / C, l1r), rtol=1e-4)
    for key in ("n_iter", "n_iter_exec"):
        assert np.abs(got[key].numpy() - np.asarray(ref[key])).max() <= 2


def _objective(X, y, w, coef, intercept, inv_C, l1_ratio):
    """Each lane's weighted log loss plus its elastic-net penalty, in
    float64."""
    Z = np.einsum("nd,bkd->bnk", X.astype(np.float64), coef) \
        + intercept[:, None, :]
    if Z.shape[2] == 1:
        z = Z[..., 0]
        per = np.logaddexp(0.0, z) - y[None, :] * z
    else:
        zmax = Z.max(axis=2, keepdims=True)
        lse = (zmax[..., 0]
               + np.log(np.exp(Z - zmax).sum(axis=2)))
        per = lse - np.take_along_axis(
            Z, np.broadcast_to(y[None, :, None], Z.shape[:2] + (1,)),
            axis=2)[..., 0]
    flat = coef.reshape(coef.shape[0], -1)
    pen = inv_C * (l1_ratio * np.abs(flat).sum(1)
                   + 0.5 * (1.0 - l1_ratio) * (flat ** 2).sum(1))
    return (w * per).sum(axis=1) + pen


def _search(est, X, y, grid, which, **kw):
    cls = {"port": port.GridSearchCV, "jax": sst.GridSearchCV,
           "sklearn": SkGridSearchCV}[which]
    if which == "port":
        kw["config"] = CPU
    elif which == "jax":
        kw["backend"] = "tpu"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # saga ConvergenceWarning
        kw.setdefault("refit", False)
        return cls(est, grid, cv=SkStratifiedKFold(3), **kw).fit(X, y)


@pytest.mark.parametrize("est", [
    SkLogReg(l1_ratio=1.0, solver="saga", max_iter=30),
    SkLogReg(penalty="elasticnet", l1_ratio=0.5, solver="saga",
             max_iter=30),
    port.LogisticRegression(penalty="l1", max_iter=30),
], ids=["sklearn_l1", "sklearn_elasticnet", "port_l1"])
def test_multiclass_search_matches_jax(digits, est):
    X, y = digits
    X, y = X[:360], y[:360]
    grid = {"C": [0.1, 1.0]}
    scoring = ["accuracy", "neg_log_loss", "f1_macro", "balanced_accuracy"]
    ours = _search(est, X, y, grid, "port", scoring=scoring)
    ref_est = est if isinstance(est, SkLogReg) else SkLogReg(
        l1_ratio=1.0, solver="saga", max_iter=30)
    ref = _search(ref_est, X, y, grid, "jax", scoring=scoring)
    for s in scoring:
        np.testing.assert_allclose(ours.cv_results_[f"mean_test_{s}"],
                                   ref.cv_results_[f"mean_test_{s}"],
                                   atol=5e-3)


def test_binary_l1_search_matches_jax_and_sklearn_saga(digits):
    X, y = digits
    m = y < 2
    Xb, yb = X[m], y[m]
    grid = {"C": [0.05, 0.5]}
    est = SkLogReg(l1_ratio=1.0, solver="saga", max_iter=300)
    scoring = ["accuracy", "roc_auc", "f1", "precision", "recall"]
    ours = _search(est, Xb, yb, grid, "port", scoring=scoring,
                   refit="accuracy")
    ref = _search(est, Xb, yb, grid, "jax", scoring=scoring,
                  refit="accuracy")
    sk = _search(est, Xb, yb, grid, "sklearn")
    for s in scoring:
        np.testing.assert_allclose(ours.cv_results_[f"mean_test_{s}"],
                                   ref.cv_results_[f"mean_test_{s}"],
                                   atol=5e-3)
    np.testing.assert_allclose(ours.cv_results_["mean_test_accuracy"],
                               sk.cv_results_["mean_test_score"], atol=0.01)
    assert ours.chunks_[0]["n_iter_exec"] <= 3000


def test_port_l1_estimator_refits_on_the_device(digits):
    """The sklearn-free l1 estimator through the search, refit on the
    search's device: sparse coefficients, n_iter_ on sklearn's axis."""
    X, y = digits
    X, y = X[y < 2][:200], y[y < 2][:200]
    gs = port.GridSearchCV(port.LogisticRegression(penalty="l1",
                                                   max_iter=50),
                           {"C": [0.05]}, cv=3, config=CPU).fit(X, y)
    best = gs.best_estimator_
    assert best.device == "cpu" and best.coef_.shape == (1, 64)
    assert (best.coef_ == 0).mean() > 0.5
    assert 1 <= int(best.n_iter_[0]) <= 50
    assert (best.predict(X) == y).mean() > 0.95
