"""The port's Ridge, LinearRegression, ElasticNet and Lasso against the
JAX package's families and searches on the same inputs, and against
sklearn at the reference's own bounds (`tests/test_search_basic.py`).

Tolerances: Ridge/LinearRegression (float64) coef rtol 1e-6 and
mean_test_score atol 1e-6 against JAX; ElasticNet/Lasso (float32, 300
FISTA steps) coef and scores atol 1e-3 against JAX.  Against sklearn:
Ridge atol 2e-3, the rank-deficient minimum-norm coef 1e-4, ElasticNet
and Lasso 0.02."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.linear_model import ElasticNet as SkElasticNet
from sklearn.linear_model import Lasso as SkLasso
from sklearn.linear_model import LinearRegression as SkLinearRegression
from sklearn.linear_model import Ridge as SkRidge
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.model_selection import KFold as SkKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import linear as jlin
from spark_sklearn_tpu_torch.convert.params import params_from_jax
from spark_sklearn_tpu_torch.models import linear as plin
from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.parallel.taskgrid import build_fold_masks
from spark_sklearn_tpu_torch.search.grid import _clone, _lane_finite

CPU = port.TorchConfig(device="cpu")
N_FOLDS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reg_data(diabetes):
    X, y = diabetes
    return X[:300], ((y[:300] - y.mean()) / y.std()).astype(np.float32)


def _rank_deficient(seed=0):
    rng = np.random.default_rng(seed)
    X4 = rng.normal(size=(60, 4))
    X = np.hstack([X4, X4[:, :2]]).astype(np.float32)       # rank 4 of 6
    y = (X4[:, 0] - 2 * X4[:, 1] + 0.1 * rng.normal(size=60)
         ).astype(np.float32)
    return X, y


def _fit_both(name, X, y, dyn, static, dtype):
    """Both families on the (candidate x fold) lanes, candidate-major:
    the JAX `fit` under vmap over lanes, the port's `fit_task_batched`."""
    jfam = getattr(jlin, name)
    pfam = getattr(plin, name)
    splits = list(SkKFold(N_FOLDS).split(X))
    train, _ = build_fold_masks(splits, len(y), dtype=dtype)
    n_cand = len(next(iter(dyn.values()))) if dyn else 1
    w = np.tile(train, (n_cand, 1))
    lanes = {k: np.repeat(np.asarray(v, np.float32), N_FOLDS)
             for k, v in dyn.items()}
    with jax.enable_x64(dtype == np.float64):
        data, meta = jfam.prepare_data(X, y, dtype=dtype)
        ref = jax.vmap(lambda d, wt: jfam.fit(d, static, {
            k: jnp.asarray(v) for k, v in data.items()}, wt, meta))(
            {k: jnp.asarray(v).astype(dtype) for k, v in lanes.items()},
            jnp.asarray(w))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    data, meta = pfam.prepare_data(X, y, dtype=dtype)
    got = pfam.fit_task_batched(
        {k: torch.as_tensor(v).to(torch.float64 if dtype == np.float64
                                  else torch.float32)
         for k, v in lanes.items()},
        {**static, "__n_folds__": N_FOLDS},
        {k: torch.as_tensor(v) for k, v in data.items()},
        torch.as_tensor(w), meta)
    return ref, got


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("name,dyn", [
    ("RidgeFamily", {"alpha": [0.01, 1.0, 100.0]}),
    ("LinearRegressionFamily", {}),
])
def test_closed_form_fits_match_jax(reg_data, name, dyn, fit_intercept):
    X, y = reg_data
    ref, got = _fit_both(name, X, y, dyn, {"fit_intercept": fit_intercept},
                         np.float64)
    for key in ("coef", "intercept"):
        assert got[key].dtype == torch.float64
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-6,
                                   atol=1e-10)


def test_min_norm_lstsq_matches_jax_on_rank_deficient_x():
    X, y = _rank_deficient()
    ref, got = _fit_both("LinearRegressionFamily", X, y, {},
                         {"fit_intercept": True}, np.float64)
    np.testing.assert_allclose(got["coef"].numpy(), ref["coef"], rtol=1e-6,
                               atol=1e-10)


@pytest.mark.parametrize("name,dyn,static", [
    ("ElasticNetFamily", {"alpha": [0.001, 0.01, 0.1],
                          "l1_ratio": [0.2, 0.5, 0.9]},
     {"max_iter": 300}),
    ("ElasticNetFamily", {"alpha": [0.01, 0.3]},
     {"max_iter": 300, "l1_ratio": 1.0, "fit_intercept": False}),
])
def test_elasticnet_fit_matches_jax(reg_data, name, dyn, static):
    X, y = reg_data
    ref, got = _fit_both(name, X, y, dyn, static, np.float32)
    for key in ("coef", "intercept"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-3)


def _searches(est, grid, X, y, scoring=None):
    cv = SkKFold(N_FOLDS)
    ours = port.GridSearchCV(est, grid, cv=cv, scoring=scoring,
                             refit=False, config=CPU).fit(X, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # ConvergenceWarning
        ref = sst.GridSearchCV(est, grid, cv=cv, scoring=scoring,
                               refit=False, backend="tpu").fit(X, y)
        sk = SkGridSearchCV(est, grid, cv=cv, scoring=scoring,
                            refit=False).fit(X, y)
    return ours, ref, sk


@pytest.mark.parametrize("est,grid,tol_jax,tol_sk", [
    (SkRidge(), {"alpha": [0.1, 1.0, 10.0, 100.0]}, 1e-6, 2e-3),
    (SkLinearRegression(), {"fit_intercept": [True, False]}, 1e-6, 2e-3),
    (SkElasticNet(max_iter=300), {"alpha": [0.001, 0.01, 0.1],
                                  "l1_ratio": [0.3, 0.8]}, 1e-3, 0.02),
    (SkLasso(max_iter=300), {"alpha": [0.001, 0.01, 0.1]}, 1e-3, 0.02),
], ids=["ridge", "linear_regression", "elasticnet", "lasso"])
def test_search_matches_jax_and_sklearn(reg_data, est, grid, tol_jax,
                                        tol_sk):
    """scoring=None: the regressors' default, r2, as in the reference."""
    X, y = reg_data
    ours, ref, sk = _searches(est, grid, X, y)
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"],
                               atol=tol_jax)
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               sk.cv_results_["mean_test_score"],
                               atol=tol_sk)
    assert ours.best_params_ == ref.best_params_ == sk.best_params_
    assert set(ours.cv_results_) == set(sk.cv_results_)


def test_regression_scorers_through_the_search_match_jax(reg_data):
    X, y = reg_data
    y = y - y.min() + 0.1                      # MSLE needs y >= 0
    scoring = ["r2", "explained_variance", "neg_mean_squared_error",
               "neg_root_mean_squared_error", "neg_mean_absolute_error",
               "neg_median_absolute_error", "neg_mean_squared_log_error",
               "neg_max_error"]
    cv = SkKFold(N_FOLDS)
    grid = {"alpha": [0.1, 10.0]}
    ours = port.GridSearchCV(SkRidge(), grid, cv=cv, scoring=scoring,
                             refit="r2", return_train_score=True,
                             config=CPU).fit(X, y)
    ref = sst.GridSearchCV(SkRidge(), grid, cv=cv, scoring=scoring,
                           refit="r2", return_train_score=True,
                           backend="tpu").fit(X, y)
    for s in scoring:
        for split in ("test", "train"):
            np.testing.assert_allclose(
                ours.cv_results_[f"mean_{split}_{s}"],
                ref.cv_results_[f"mean_{split}_{s}"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(ours.best_estimator_.coef_,
                               ref.best_estimator_.coef_, rtol=1e-6)


@pytest.mark.parametrize("ours,theirs,grid", [
    (port.Ridge(), SkRidge(), {"alpha": [0.1, 10.0]}),
    (port.LinearRegression(), SkLinearRegression(),
     {"fit_intercept": [True, False]}),
    (port.ElasticNet(max_iter=200), SkElasticNet(max_iter=200),
     {"alpha": [0.01, 0.1], "l1_ratio": [0.2, 0.9]}),
    (port.Lasso(max_iter=200), SkLasso(max_iter=200),
     {"alpha": [0.01, 0.1]}),
], ids=["ridge", "linear_regression", "elasticnet", "lasso"])
def test_port_estimators_search_like_sklearns(reg_data, ours, theirs, grid):
    """The sklearn-free estimators resolve to the same family and give
    the same search, refit on the search's device."""
    X, y = reg_data
    kw = dict(cv=SkKFold(N_FOLDS), scoring=["r2", "max_error",
                                            "neg_max_error"],
              refit="r2", config=CPU)
    a = port.GridSearchCV(ours, grid, **kw).fit(X, y)
    b = port.GridSearchCV(theirs, grid, **kw).fit(X, y)
    for s in kw["scoring"]:
        np.testing.assert_array_equal(a.cv_results_[f"mean_test_{s}"],
                                      b.cv_results_[f"mean_test_{s}"])
    np.testing.assert_array_equal(a.cv_results_["mean_test_max_error"],
                                  a.cv_results_["mean_test_neg_max_error"])
    assert a.best_params_ == b.best_params_
    assert type(a.best_estimator_) is type(ours)
    assert a.best_estimator_.device == "cpu"
    np.testing.assert_allclose(a.best_estimator_.coef_,
                               b.best_estimator_.coef_, atol=0.02)


def test_min_norm_refit_on_the_port_matches_sklearn():
    """The port's own LinearRegression, refit by the search on the
    device (here the CPU): sklearn's minimum-norm coef within 1e-4 on a
    rank-4-of-6 X, where a full-rank solver would not give it."""
    X, y = _rank_deficient()
    sk = SkLinearRegression().fit(X, y)
    gs = port.GridSearchCV(port.LinearRegression(),
                           {"fit_intercept": [True]}, cv=3,
                           config=CPU).fit(X, y)
    best = gs.best_estimator_
    assert isinstance(best, port.LinearRegression) and best.device == "cpu"
    np.testing.assert_allclose(best.coef_, sk.coef_, atol=1e-4)
    assert abs(np.linalg.norm(best.coef_) - np.linalg.norm(sk.coef_)) < 1e-4
    np.testing.assert_allclose(best.predict(X), sk.predict(X), atol=1e-4)


@pytest.mark.parametrize("ours,theirs,tol", [
    (port.Ridge(alpha=3.0), SkRidge(alpha=3.0), 1e-5),
    (port.LinearRegression(fit_intercept=False),
     SkLinearRegression(fit_intercept=False), 1e-5),
    (port.ElasticNet(alpha=0.01, l1_ratio=0.7, max_iter=2000),
     SkElasticNet(alpha=0.01, l1_ratio=0.7, max_iter=2000), 0.02),
    (port.Lasso(alpha=0.01, max_iter=2000), SkLasso(alpha=0.01,
                                                    max_iter=2000), 0.02),
], ids=["ridge", "linear_regression", "elasticnet", "lasso"])
def test_port_estimators_match_sklearn(reg_data, ours, theirs, tol):
    X, y = reg_data
    ours.set_params(device="cpu").fit(X, y)
    theirs.fit(X, y)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, atol=tol)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, atol=tol)
    np.testing.assert_allclose(ours.predict(X[:20]), theirs.predict(X[:20]),
                               atol=5 * tol)
    assert ours.n_features_in_ == X.shape[1]
    assert resolve_family(ours) is resolve_family(theirs)


# ---------------------------------------------------------------------------
# the search core's repairs for families without logistic regression's
# model shape
# ---------------------------------------------------------------------------

def test_lane_finite_takes_any_leaf_shape():
    model = {"coef": torch.ones((4, 3), dtype=torch.float64),
             "intercept": torch.tensor([0.0, np.nan, 1.0, 2.0]),
             "n_iter": torch.tensor([1, 2, 3, 4], dtype=torch.int32)}
    model["coef"][3, 1] = np.inf
    assert _lane_finite(model, 4).tolist() == [True, False, True, False]
    lr = {"coef": torch.zeros((2, 3, 5)), "intercept": torch.zeros((2, 3)),
          "converged": torch.ones(2, dtype=torch.bool)}
    lr["intercept"][1, 2] = np.nan
    assert _lane_finite(lr, 2).tolist() == [True, False]


def test_failed_regressor_fit_gets_error_score(reg_data):
    """A Ridge lane whose matrix is not positive definite comes out NaN
    (as the reference's `solve(assume_a="pos")` does) and its score
    becomes error_score."""
    X, y = reg_data
    with pytest.warns(UserWarning, match="fits failed"):
        gs = port.GridSearchCV(port.Ridge(), {"alpha": [1.0, -1e9]}, cv=3,
                               error_score=-7.0, refit=False,
                               config=CPU).fit(X, y)
    assert gs.cv_results_["mean_test_score"][1] == -7.0
    assert gs.cv_results_["mean_test_score"][0] > 0.3


def test_chunks_record_n_iter_only_where_the_family_has_one(reg_data,
                                                             digits):
    X, y = reg_data
    gs = port.GridSearchCV(port.Ridge(), {"alpha": [1.0]}, cv=3,
                           refit=False, config=CPU).fit(X, y)
    assert "n_iter_exec" not in gs.chunks_[0]
    Xd, yd = digits
    gs = port.GridSearchCV(port.LogisticRegression(max_iter=5),
                           {"C": [1.0]}, cv=3, refit=False,
                           config=CPU).fit(Xd[:150], yd[:150])
    assert gs.chunks_[0]["n_iter_exec"] == 5


@pytest.mark.parametrize("est", [
    port.LogisticRegression(penalty="l1", C=0.5, l1_ratio=0.3),
    port.Ridge(alpha=2.0), port.LinearRegression(fit_intercept=False),
    port.ElasticNet(alpha=0.1, l1_ratio=0.2), port.Lasso(alpha=0.3),
])
def test_clone_copies_every_port_estimator(est):
    twin = _clone(est)
    assert type(twin) is type(est) and twin is not est
    assert twin.get_params() == est.get_params()


def test_params_from_jax_keeps_each_floating_dtype():
    tree = {"coef": np.ones((3, 4), np.float64),
            "intercept": np.zeros(3, np.float32),
            "n_iter": np.arange(3, dtype=np.int32)}
    got = params_from_jax(tree, torch.device("cpu"))
    assert got["coef"].dtype == torch.float64
    assert got["intercept"].dtype == torch.float32
    assert got["n_iter"].dtype == torch.int32


def test_views_of_jax_regressor_models_match_jax(reg_data):
    """JAX-fitted Ridge models (float64), carried across with
    `params_from_jax`, give the JAX views through the port."""
    X, y = reg_data
    ref, _ = _fit_both("RidgeFamily", X, y, {"alpha": [0.5, 5.0]},
                       {"fit_intercept": True}, np.float64)
    with jax.enable_x64(True):
        want = jlin.RidgeFamily.views_task_batched(
            {k: jnp.asarray(v) for k, v in ref.items()}, {},
            {"X": jnp.asarray(X, jnp.float64)}, {}, ("pred",))["pred"]
        want = np.asarray(want)
    got = plin.RidgeFamily.views_task_batched(
        params_from_jax(ref, torch.device("cpu")), {},
        {"X": torch.as_tensor(X, dtype=torch.float64)}, {}, ("pred",))
    np.testing.assert_allclose(got["pred"].numpy(), want, rtol=1e-12)
