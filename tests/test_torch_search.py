"""The port's GridSearchCV end to end on the CPU, against the JAX
package's GridSearchCV and sklearn's on the same digits searches:
mean_test_score within 5e-3 (float32 training, the repo's oracle bound),
equal best_params_ and sklearn's cv_results_ schema."""

import warnings

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression as SkLogReg
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port

CPU = port.TorchConfig(device="cpu")
GRID = {"C": [0.01, 0.1, 1.0, 10.0]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _expected_keys(n_splits, scorer="score", train=False):
    keys = {"mean_fit_time", "std_fit_time", "mean_score_time",
            "std_score_time", "params",
            f"mean_test_{scorer}", f"std_test_{scorer}",
            f"rank_test_{scorer}"}
    keys |= {f"split{i}_test_{scorer}" for i in range(n_splits)}
    if train:
        keys |= {f"mean_train_{scorer}", f"std_train_{scorer}"}
        keys |= {f"split{i}_train_{scorer}" for i in range(n_splits)}
    return keys


def _sklearn(est, X, y, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # lbfgs ConvergenceWarning
        return SkGridSearchCV(est, GRID, cv=SkStratifiedKFold(3),
                              **kw).fit(X, y)


def _check_against(ours, refs, scorers, train):
    for s in scorers:
        for ref in refs[: 1 if s == "neg_log_loss" else None]:
            np.testing.assert_allclose(
                ours.cv_results_[f"mean_test_{s}"],
                ref.cv_results_[f"mean_test_{s}"], atol=5e-3)
            if train:
                np.testing.assert_allclose(
                    ours.cv_results_[f"mean_train_{s}"],
                    ref.cv_results_[f"mean_train_{s}"], atol=5e-3)
        assert _expected_keys(3, s, train) <= set(ours.cv_results_)
    for ref in refs:
        assert ours.best_params_ == ref.best_params_
        assert set(ours.cv_results_) == set(ref.cv_results_)
    assert isinstance(ours.cv_results_["param_C"], np.ma.MaskedArray)
    assert ours.n_splits_ == 3


def test_multiclass_matches_jax_and_sklearn(digits):
    """10-class, two metrics, train scores, refit on the metric named.
    neg_log_loss is held to the JAX package only: at C=10 max_iter=100
    stops the float32 solvers short of sklearn's float64 lbfgs, and the
    reference's own log loss differs from sklearn's by 5.3e-3 there."""
    X, y = digits
    X, y = X[:600], y[:600]
    scoring = ["accuracy", "neg_log_loss"]
    kw = dict(scoring=scoring, refit="neg_log_loss",
              return_train_score=True)
    ours = port.GridSearchCV(SkLogReg(max_iter=100), GRID,
                             cv=SkStratifiedKFold(3), config=CPU,
                             **kw).fit(X, y)
    jax_gs = sst.GridSearchCV(SkLogReg(max_iter=100), GRID,
                              cv=SkStratifiedKFold(3), **kw).fit(X, y)
    sk = _sklearn(SkLogReg(max_iter=100), X, y, **kw)
    _check_against(ours, [jax_gs, sk], scoring, train=True)
    assert ours.multimetric_
    assert type(ours.best_estimator_) is SkLogReg
    np.testing.assert_array_equal(ours.predict(X[:50]),
                                  sk.best_estimator_.predict(X[:50]))
    assert all(c["n_iter_exec"] <= 100 for c in ours.chunks_)


def test_binary_balanced_matches_jax_and_sklearn(digits):
    """Binary (one logit per lane) with class_weight='balanced' on an
    imbalanced pair of classes, through the port's own splitter."""
    X, y = digits
    m = (y == 3) | (y == 8)
    X, y = X[m], np.where(y[m] == 3, 1, 0)
    X, y = X[: 200], y[: 200]
    keep = (y == 1) | (np.arange(len(y)) % 3 == 0)    # imbalance it
    X, y = X[keep], y[keep]
    est = SkLogReg(max_iter=100, class_weight="balanced")
    ours = port.GridSearchCV(est, GRID, cv=port.StratifiedKFold(3),
                             config=CPU).fit(X, y)
    jax_gs = sst.GridSearchCV(est, GRID, cv=SkStratifiedKFold(3)).fit(X, y)
    sk = _sklearn(est, X, y)
    _check_against(ours, [jax_gs, sk], ["score"], train=False)
    assert ours.best_score_ == ours.cv_results_["mean_test_score"][
        ours.best_index_]


def test_port_estimator_without_sklearn_objects(digits):
    """The sklearn-free path chip_smoke.py drives: the port's estimator,
    splitter and grid, refit on the port's own fit."""
    X, y = digits
    X, y = X[:450], y[:450]
    ours = port.GridSearchCV(
        port.LogisticRegression(max_iter=100), GRID,
        cv=port.StratifiedKFold(3), config=CPU).fit(X, y)
    sk = _sklearn(SkLogReg(max_iter=100), X, y)
    _check_against(ours, [sk], ["score"], train=False)
    best = ours.best_estimator_
    assert isinstance(best, port.LogisticRegression)
    assert best.device == "cpu" and best.C == ours.best_params_["C"]
    agree = np.mean(best.predict(X) == sk.best_estimator_.predict(X))
    assert agree > 0.99
    np.testing.assert_allclose(best.predict_proba(X[:20]),
                               sk.best_estimator_.predict_proba(X[:20]),
                               atol=2e-2)


def test_chunking_does_not_change_scores(digits):
    """Chunks of a few lanes (padded last chunk) give the scores of one
    wide chunk: lanes are independent problems."""
    X, y = digits
    X, y = X[:300], y[:300]
    grid = {"C": [0.01, 0.1, 1.0, 10.0, 100.0]}
    wide = port.GridSearchCV(port.LogisticRegression(max_iter=60), grid,
                             cv=3, config=CPU, refit=False).fit(X, y)
    narrow = port.GridSearchCV(
        port.LogisticRegression(max_iter=60), grid, cv=3, refit=False,
        config=port.TorchConfig(device="cpu", max_tasks_per_batch=6)
    ).fit(X, y)
    assert len(wide.chunks_) == 1 and len(narrow.chunks_) == 3
    np.testing.assert_allclose(narrow.cv_results_["mean_test_score"],
                               wide.cv_results_["mean_test_score"],
                               atol=5e-3)
    assert narrow.best_params_ == wide.best_params_
    assert not hasattr(wide, "best_estimator_")


@pytest.mark.parametrize("est,err", [
    (SkLogReg(penalty="l3"), ValueError),
    (port.LogisticRegression(penalty="l3"), ValueError),
])
def test_unported_penalties_raise(digits, est, err):
    """l1 and elasticnet are fitted by FISTA now; a penalty neither
    package knows raises."""
    X, y = digits
    with pytest.raises(err):
        port.GridSearchCV(est, {"C": [1.0]}, cv=3, config=CPU).fit(
            X[:90], y[:90])


def test_unported_estimator_and_bad_multimetric_refit_raise(digits):
    from sklearn.tree import DecisionTreeClassifier
    X, y = digits
    with pytest.raises(NotImplementedError):
        port.GridSearchCV(DecisionTreeClassifier(), {"max_depth": [2]},
                          config=CPU).fit(X[:90], y[:90])
    with pytest.raises(ValueError, match="refit"):
        port.GridSearchCV(port.LogisticRegression(), {"C": [1.0]},
                          scoring=["accuracy", "neg_log_loss"],
                          config=CPU).fit(X[:90], y[:90])


# ---------------------------------------------------------------------------
# the search core's repairs: a callable refit, and a refit the estimator
# cannot run here refused before any fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scoring", [None, ["accuracy", "neg_log_loss"]])
def test_callable_refit_picks_its_index(digits, scoring):
    """As sklearn's: the callable gets cv_results_, its index is the best
    candidate, best_score_ stays unset; a non-integer or an index out of
    range raises."""
    X, y = digits
    X, y = X[:150], y[:150]
    seen = []

    def pick(results):
        seen.append(len(results["params"]))
        return 2

    gs = port.GridSearchCV(port.LogisticRegression(max_iter=20), GRID,
                           cv=3, scoring=scoring, refit=pick,
                           config=CPU).fit(X, y)
    assert seen == [len(GRID["C"])]
    assert gs.best_index_ == 2
    assert gs.best_params_ == {"C": GRID["C"][2]}
    assert not hasattr(gs, "best_score_")
    assert gs.best_estimator_.C == GRID["C"][2]
    with pytest.raises(TypeError):
        port.GridSearchCV(port.LogisticRegression(max_iter=20), GRID, cv=3,
                          scoring=scoring, refit=lambda r: 1.5,
                          config=CPU).fit(X, y)
    with pytest.raises(IndexError):
        port.GridSearchCV(port.LogisticRegression(max_iter=20), GRID, cv=3,
                          scoring=scoring, refit=lambda r: 9,
                          config=CPU).fit(X, y)


@pytest.mark.parametrize("in_pipeline", [False, True])
def test_unrefittable_holder_raises_before_any_fit(diabetes, monkeypatch,
                                                   in_pipeline):
    """The port's tree holders have no fit of their own: refit=True is
    refused before the search fits anything (alone or as a Pipeline's
    final step); refit=False searches."""
    from spark_sklearn_tpu_torch.models.trees import (
        GradientBoostingRegressorFamily,
    )
    calls = []
    real = GradientBoostingRegressorFamily.fit_task_batched.__func__

    def counted(cls, *args, **kw):
        calls.append(1)
        return real(cls, *args, **kw)

    monkeypatch.setattr(GradientBoostingRegressorFamily, "fit_task_batched",
                        classmethod(counted))
    est = port.GradientBoostingRegressor(n_estimators=2, max_depth=2)
    grid = {"learning_rate": [0.1, 0.2]}
    if in_pipeline:
        est = port.Pipeline([("scale", port.StandardScaler()), ("gb", est)])
        grid = {"gb__learning_rate": [0.1, 0.2]}
    X, y = diabetes[0][:90], diabetes[1][:90]
    with pytest.raises(NotImplementedError, match="refit"):
        port.GridSearchCV(est, grid, cv=3, config=CPU).fit(X, y)
    assert calls == []
    gs = port.GridSearchCV(est, grid, cv=3, refit=False,
                           config=CPU).fit(X, y)
    assert calls and np.isfinite(gs.cv_results_["mean_test_score"]).all()
