"""The port's SVR, NuSVR, LinearSVC and LinearSVR against the JAX
package's, on the CPU, and against sklearn at the reference's own bounds
(`tests/test_svr.py`: 0.05 on the regressors' r2, 0.03 on LinearSVC's
accuracy).

Inputs: diabetes (standardised, the target standardised) and subsets of
digits, and numpy draws from fixed seeds.  Tolerances, each stated where
it is used:
- S2's SVR-mode plain step against the reference's step: atol 1e-5 on
  x', z' and β' (the bisection's sums run in another order; measured
  <= 1e-6), the residual rtol 1e-5;
- the duals after 300 steps: β and f atol 1e-4, b atol 1e-4;
- searches: mean_test_score within 5e-3 of the JAX package's with the
  same best_params_ (the repo's oracle bound, tests/test_search_basic.py).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.svm import SVR as SkSVR
from sklearn.svm import LinearSVC as SkLinearSVC
from sklearn.svm import LinearSVR as SkLinearSVR
from sklearn.svm import NuSVR as SkNuSVR

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import svm as jsvm
from spark_sklearn_tpu.models import svr as jsvr
from spark_sklearn_tpu_torch.convert.params import (
    linear_svm_from_jax,
    svr_model_from_jax,
)
from spark_sklearn_tpu_torch.models import svr as psvr
from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.ops import svm_kernels as sk

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _regression(diabetes, n=150):
    X, y = diabetes
    return X[:n], ((y - y.mean()) / y.std()).astype(np.float32)[:n]


def _svr_step_inputs(seed=0, M=4, n=90):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n).astype(np.float32)
    bh = (rng.random((M, n)) < 0.7).astype(np.float32) * 2.0
    z = rng.uniform(-0.5, 2.5, (M, 2 * n)).astype(np.float32)
    x = rng.uniform(0.0, 2.0, (M, 2 * n)).astype(np.float32)
    V = rng.standard_normal((M, n)).astype(np.float32)
    eps = np.full(M, 0.1, np.float32)
    target = (0.25 * bh.sum(axis=1)).astype(np.float32)
    return y, bh, z, x, V, eps, target


@pytest.mark.parametrize("mode", ["svr", "nu", "project"])
def test_svr_step_plain_is_one_reference_step(mode):
    """One step of S2's SVR mode against the reference's: its gradient
    (svr.py:76-80, :149-153) and projection (the box-hyperplane with s for
    labels, or the two half box-sums), then the momentum and β = z'_a −
    z'_a*."""
    y, bh, z, x, V, eps, target = _svr_step_inputs()
    M, n = bh.shape
    step, coef = np.float32(0.05), np.float32(0.4)
    s = jnp.concatenate([jnp.ones(n), -jnp.ones(n)])
    bound = jnp.concatenate([bh, bh], axis=1)
    if mode == "project":
        u = jnp.asarray(z)
    else:
        lin = s * jnp.concatenate([y, y]) - (eps[:, None] if mode == "svr"
                                             else 0.0)
        grad = -(lin - s * jnp.concatenate([V, V], axis=1))
        u = z - step * grad
    if mode == "svr":
        want = jsvm._project_box_hyperplane(u, s[None, :], bound)
    else:
        zero = jnp.zeros_like(jnp.asarray(bh))
        want = jsvm._project_box_sum(
            u, jnp.concatenate([bh, zero], axis=1), target) + \
            jsvm._project_box_sum(u, jnp.concatenate([zero, bh], axis=1),
                                  target)
    want = np.asarray(want)
    z_want = want + coef * (want - x)
    got = sk.svr_dual_step(
        None if mode == "project" else _t(V), _t(z), _t(x), _t(y),
        _t(eps) if mode == "svr" else None, _t(bh), torch.tensor(step),
        float(coef), None if mode == "svr" else _t(target))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), z_want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(),
                               z_want[:, :n] - z_want[:, n:], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(),
                               np.abs(want - z).max(axis=1) / step,
                               rtol=1e-5, atol=1e-5)


def test_svr_step_plan_picks_staged_or_streamed():
    """S2's SVR mode has one plan, a cluster of CTAs a row, each CTA's
    lists in its shared memory, for rows up to `SVR_MAX_N` pairs; longer
    rows and impossible clusters are refused."""
    plan = sk.svr_step_plan(10000)
    assert plan["cluster"] == 16 and plan["smem"] <= 232448 - 1024
    with pytest.raises(ValueError):
        sk.svr_step_plan(sk.SVR_MAX_N + 1)
    with pytest.raises(ValueError):
        sk.svr_step_plan(100, cluster=17)


def _kernel_np(X, gamma):
    return np.array(jsvm._kernel(jnp.asarray(X), jnp.asarray(X), "rbf",
                                 gamma, 3, 0))


@pytest.mark.parametrize("tol", [None, 1e-3])
def test_svr_dual_matches_reference(diabetes, tol):
    """β, b and the steps of the epsilon-SVR dual on three fold rows,
    against the reference's `svr_dual_ascent` (atol 1e-4 after up to 300
    steps; the steps within one)."""
    X, y = _regression(diabetes, 90)
    n = len(y)
    K = _kernel_np(X, 0.1)
    w = ((np.arange(n) % 3)[None] != np.arange(3)[:, None]).astype(
        np.float32) * 2.0
    step = np.float32(0.5 * np.asarray(jsvm._power_step(jnp.asarray(K), n,
                                                        jnp.float32)))
    rb, rbias, rit = jsvr.svr_dual_ascent(jnp.asarray(K), jnp.asarray(y),
                                          0.1, jnp.asarray(w), step, 300,
                                          tol)
    beta, b, it = psvr.svr_dual_ascent(
        _t(K), _t(y), torch.full((3,), 0.1), _t(w), torch.tensor(step), 300,
        tol)
    np.testing.assert_allclose(beta.numpy(), np.asarray(rb), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(rbias), rtol=0,
                               atol=1e-4)
    assert abs(int(it) - int(rit)) <= 1


def test_nu_svr_dual_matches_reference_with_infeasible_rows(diabetes):
    """nu-SVR's decisions against the reference's (atol 1e-4), an
    infeasible nu (its half sums past the box: nu > 2) giving NaN rows in
    both."""
    X, y = _regression(diabetes, 80)
    n = len(y)
    K = _kernel_np(X, 0.1)
    w = ((np.arange(n) % 2)[None] != np.arange(2)[:, None]).astype(
        np.float32)
    step = np.float32(0.5 * np.asarray(jsvm._power_step(jnp.asarray(K), n,
                                                        jnp.float32)))
    for nu in (0.4, 2.5):
        rf, _ = jsvr.nu_svr_dual_ascent(jnp.asarray(K), jnp.asarray(y), nu,
                                        jnp.asarray(w), step, 200, None)
        f, _ = psvr.nu_svr_dual_ascent(_t(K), _t(y), torch.tensor(nu),
                                       _t(w), torch.tensor(step), 200)
        np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=0,
                                   atol=1e-4)
        assert np.isnan(f.numpy()).all() == (nu > 2)


SEARCHES = [
    ("svr", SkSVR(), {"C": [0.5, 2.0], "epsilon": [0.05, 0.2]}, 0.05),
    ("svr_poly", SkSVR(kernel="poly", degree=2), {"C": [0.5, 2.0]}, 0.05),
    ("nu_svr", SkNuSVR(), {"nu": [0.3, 0.5], "C": [1.0, 3.0]}, 0.05),
    ("linear_svr", SkLinearSVR(max_iter=2000),
     {"C": [0.1, 1.0], "epsilon": [0.0, 0.1]}, 0.05),
    ("linear_svr_sq", SkLinearSVR(loss="squared_epsilon_insensitive",
                                  max_iter=2000),
     {"C": [0.5, 2.0], "epsilon": [0.0, 0.1]}, 0.05),
]


@pytest.mark.parametrize("case", SEARCHES, ids=[s[0] for s in SEARCHES])
def test_regressor_search_matches_reference_and_sklearn(diabetes, case):
    label, est, grid, sk_bound = case
    X, y = _regression(diabetes, 150)
    ours = port.GridSearchCV(est, grid, cv=3, config=CPU).fit(X, y)
    ref = sst.GridSearchCV(est, grid, cv=3).fit(X, y)
    oracle = SkGridSearchCV(est, grid, cv=3).fit(X, y)
    got = ours.cv_results_["mean_test_score"]
    np.testing.assert_allclose(got, ref.cv_results_["mean_test_score"],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, oracle.cv_results_["mean_test_score"],
                               rtol=0, atol=sk_bound)
    assert ours.best_params_ == ref.best_params_


CLASSIFIERS = [
    ("hinge_binary", 2, {"loss": "hinge"}),
    ("squared_hinge_binary", 2, {}),
    ("hinge_ovr", 4, {"loss": "hinge"}),
    ("squared_hinge_ovr", 4, {}),
    ("class_weight_scaling", 3, {"class_weight": "balanced",
                                 "intercept_scaling": 2.0}),
]


@pytest.mark.parametrize("case", CLASSIFIERS, ids=[c[0] for c in CLASSIFIERS])
def test_linear_svc_search_matches_reference_and_sklearn(digits, case):
    label, classes, params = case
    X, y = digits
    m = y < classes
    X, y = X[m][:160], y[m][:160]
    est = SkLinearSVC(max_iter=2000, **params)
    grid = {"C": [0.01, 0.1, 1.0]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # liblinear's convergence
        ours = port.GridSearchCV(est, grid, cv=3, config=CPU).fit(X, y)
        ref = sst.GridSearchCV(est, grid, cv=3).fit(X, y)
        oracle = SkGridSearchCV(est, grid, cv=3).fit(X, y)
    got = ours.cv_results_["mean_test_score"]
    np.testing.assert_allclose(got, ref.cv_results_["mean_test_score"],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, oracle.cv_results_["mean_test_score"],
                               rtol=0, atol=0.03)
    assert ours.best_params_ == ref.best_params_


def test_pipeline_svr_matches_reference(diabetes):
    """StandardScaler + SVR: each fold's own kernel matrix and gamma
    ("scale" of the fold's scaled rows)."""
    from sklearn.pipeline import Pipeline as SkPipeline
    from sklearn.preprocessing import StandardScaler as SkScaler
    X, y = _regression(diabetes, 120)
    pipe = SkPipeline([("sc", SkScaler()), ("svr", SkSVR())])
    grid = {"svr__C": [0.5, 2.0]}
    ours = port.GridSearchCV(pipe, grid, cv=3, config=CPU).fit(X, y)
    ref = sst.GridSearchCV(pipe, grid, cv=3).fit(X, y)
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], rtol=0,
                               atol=5e-3)


def test_port_estimators_fit_search_and_refit(diabetes, digits):
    """The port's own classes: a search refits the best on its device;
    the fitted holders predict close to sklearn's (r2 within 0.05 of
    sklearn's on the training rows; LinearSVC's accuracy within 0.03)."""
    X, y = _regression(diabetes, 150)
    for ours_cls, sk_cls, params in (
            (port.SVR, SkSVR, {"C": 2.0, "epsilon": 0.1}),
            (port.NuSVR, SkNuSVR, {"nu": 0.4}),
            (port.LinearSVR, SkLinearSVR, {"C": 1.0, "max_iter": 2000})):
        ours = ours_cls(**params, device="cpu").fit(X, y)
        theirs = sk_cls(**params).fit(X, y)

        def r2(p):
            return 1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum()

        assert abs(r2(ours.predict(X)) - r2(theirs.predict(X))) < 0.05
    gs = port.GridSearchCV(port.SVR(), {"C": [0.5, 2.0]}, cv=3,
                           config=CPU).fit(X, y)
    assert isinstance(gs.best_estimator_, port.SVR)
    assert gs.best_estimator_.device == "cpu"
    np.testing.assert_array_equal(
        gs.best_estimator_.predict(X),
        port.SVR(**gs.best_params_, device="cpu").fit(X, y).predict(X))
    Xc, yc = digits
    m = yc < 3
    est = port.LinearSVC(C=0.1, device="cpu").fit(Xc[m][:150], yc[m][:150])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk_est = SkLinearSVC(C=0.1).fit(Xc[m][:150], yc[m][:150])
    acc = (est.predict(Xc[m][:150]) == yc[m][:150]).mean()
    assert abs(acc - (sk_est.predict(Xc[m][:150]) == yc[m][:150]).mean()) \
        < 0.03
    assert est.decision_function(Xc[:5]).shape == (5, 3)
    assert est.coef_.shape == (3, 64)


def test_models_carried_from_jax_predict_the_same(diabetes, digits):
    """`svr_model_from_jax` and `linear_svm_from_jax` carry the reference
    families' fitted models: the port's views give the reference's
    predictions and decisions (atol 1e-5)."""
    X, y = _regression(diabetes, 60)
    n = len(y)
    w = np.ones((2, n), np.float32)
    w[0, :20] = 0.0
    data, meta = jsvr.SVRFamily.prepare_data(X, y)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    model = jsvr.SVRFamily.fit_task_batched(
        {"C": jnp.asarray([1.0, 1.0], jnp.float32)},
        {"__n_folds__": 2}, jdata, jnp.asarray(w), meta)
    carried = svr_model_from_jax(model, device="cpu")
    views = psvr.SVRFamily.views_task_batched(carried, {}, {}, meta,
                                              {"pred"})
    np.testing.assert_array_equal(views["pred"].numpy(),
                                  np.asarray(model["f"]))
    for fam, pfam, Xs, ys in (
            (jsvr.LinearSVCFamily, psvr.LinearSVCFamily, digits[0][:90],
             digits[1][:90] % 3),
            (jsvr.LinearSVRFamily, psvr.LinearSVRFamily, X, y)):
        data, meta = fam.prepare_data(Xs, ys)
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        model = fam.fit_task_batched(
            {"C": jnp.asarray([0.1, 1.0], jnp.float32)},
            {"max_iter": 200}, jdata,
            jnp.ones((2, len(ys)), jnp.float32), meta)
        carried = linear_svm_from_jax(model, device="cpu")
        assert carried["converged"].dtype == torch.bool
        pdata = {k: _t(v) for k, v in data.items()}
        ours = pfam.views_task_batched(carried, {}, pdata, meta,
                                       {"pred", "decision"})
        if fam is jsvr.LinearSVCFamily:
            want = jax_views = fam.views_task_batched(
                model, {}, jdata, meta, {"pred", "decision"})
            np.testing.assert_allclose(ours["decision"].numpy(),
                                       np.asarray(jax_views["decision"]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(ours["pred"].numpy(),
                                          np.asarray(want["pred"]))
        else:
            want = fam.views_task_batched(model, {}, jdata, meta, {"pred"})
            np.testing.assert_allclose(ours["pred"].numpy(),
                                       np.asarray(want["pred"]), rtol=0,
                                       atol=1e-5)


def test_families_resolve_and_unported_options_raise(diabetes, digits):
    for est, fam in ((SkSVR(), psvr.SVRFamily),
                     (port.SVR(), psvr.SVRFamily),
                     (SkNuSVR(), psvr.NuSVRFamily),
                     (port.NuSVR(), psvr.NuSVRFamily),
                     (SkLinearSVC(), psvr.LinearSVCFamily),
                     (port.LinearSVC(), psvr.LinearSVCFamily),
                     (SkLinearSVR(), psvr.LinearSVRFamily),
                     (port.LinearSVR(), psvr.LinearSVRFamily)):
        assert resolve_family(est) is fam
    X, y = _regression(diabetes, 60)
    # the host tier runs these; a search forced onto the device refuses
    with pytest.raises(ValueError, match="precomputed"):
        port.GridSearchCV(SkSVR(kernel="precomputed"), {"C": [1.0]}, cv=3,
                          refit=False, backend="device",
                          config=CPU).fit(X @ X.T, y)
    Xc, yc = digits
    for params, match in (({"penalty": "l1", "dual": False}, "l1"),
                          ({"multi_class": "crammer_singer"},
                           "crammer_singer")):
        with pytest.raises(ValueError, match=match):
            port.GridSearchCV(SkLinearSVC(**params), {"C": [1.0]}, cv=3,
                              refit=False, backend="device",
                              config=CPU).fit(Xc[:60], yc[:60] % 2)
    with pytest.raises(ValueError, match="infeasible"):
        port.NuSVR(nu=2.5, device="cpu").fit(X, y)
