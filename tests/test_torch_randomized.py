"""The port's sklearn-free ParameterSampler and RandomizedSearchCV against
sklearn's sampler (the same candidates, exactly, from the same
random_state) and the JAX package's RandomizedSearchCV (the same
candidates; mean_test_score within 5e-3, the repo's oracle bound for
float32 training).  All three regimes of sklearn's
`sample_without_replacement` are covered: a permutation for
0.01 < n_iter/grid < 0.99, tracking selection at or below 0.01,
reservoir sampling at or above 0.99."""

import warnings

import numpy as np
import pytest
import scipy.stats as st
import torch
from sklearn.linear_model import LogisticRegression as SkLogReg
from sklearn.linear_model import Ridge as SkRidge
from sklearn.model_selection import KFold as SkKFold
from sklearn.model_selection import ParameterGrid as SkParameterGrid
from sklearn.model_selection import ParameterSampler as SkParameterSampler
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.utils.random import (
    sample_without_replacement as sk_sample_without_replacement)

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.search.cv import (
    ParameterGrid,
    ParameterSampler,
    sample_without_replacement,
)

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_population,n_samples", [
    (1000, 3), (500, 5),           # ratio <= 0.01: tracking selection
    (120, 2), (50, 25), (10, 9),   # 0.01 < ratio < 0.99: permutation
    (100, 99), (20, 20), (0, 0),   # ratio >= 0.99: reservoir sampling
])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_without_replacement_matches_sklearn(n_population,
                                                    n_samples, seed):
    got = sample_without_replacement(n_population, n_samples,
                                     random_state=seed)
    want = sk_sample_without_replacement(n_population, n_samples,
                                         random_state=seed)
    np.testing.assert_array_equal(got, want)


SAMPLER_CASES = [
    ({"a": [1, 2, 3], "b": list(range(40))}, 2),                # permutation
    ({"a": list(range(50)), "b": ["x", "y"], "c": [0.1, 0.2, 0.3]}, 2),
    ({"a": list(range(20))}, 20),                               # reservoir
    ({"a": list(range(100))}, 99),
    ({"a": list(range(10))}, 50),             # n_iter > grid: warns, 10
    ([{"a": [1, 2]}, {}, {"b": [3, 4, 5]}], 4),                 # sub-grids
    ({"C": st.loguniform(1e-2, 1e2), "k": [1, 2, 3]}, 10),      # rvs
    ([{"a": [1, 2]}, {"b": st.uniform(0, 1), "c": ["x", "y"]}], 8),
    ({"C": st.expon(), "tol": st.loguniform(1e-5, 1e-3)}, 6),
]


@pytest.mark.parametrize("dist,n_iter", SAMPLER_CASES)
@pytest.mark.parametrize("random_state", [0, 42, "instance"])
def test_parameter_sampler_matches_sklearn(dist, n_iter, random_state):
    def rs():
        return (np.random.RandomState(3) if random_state == "instance"
                else random_state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")               # n_iter > grid size
        got = list(ParameterSampler(dist, n_iter, random_state=rs()))
        want = list(SkParameterSampler(dist, n_iter, random_state=rs()))
    assert got == want
    assert len(ParameterSampler(dist, n_iter)) == \
        len(SkParameterSampler(dist, n_iter)) == len(want)


def test_tracking_selection_regime_matches_sklearn():
    grid = {"a": list(range(40)), "b": list(range(30))}        # 1200 points
    got = list(ParameterSampler(grid, 5, random_state=1))
    assert got == list(SkParameterSampler(grid, 5, random_state=1))


def test_parameter_grid_indexing_matches_sklearn():
    grid = [{"a": [1, 2, 3], "b": ["x", "y"]}, {}, {"c": [0.5, 1.5]}]
    ours, theirs = ParameterGrid(grid), SkParameterGrid(grid)
    assert [ours[i] for i in range(len(ours))] == \
        [theirs[i] for i in range(len(theirs))]
    assert sorted(map(sorted, (ours[i].items() for i in range(len(ours))))) \
        == sorted(map(sorted, (p.items() for p in ours)))
    with pytest.raises(IndexError):
        ours[len(ours)]


def test_parameter_sampler_rejects_what_sklearn_rejects():
    with pytest.raises(TypeError):
        ParameterSampler({"a": 3}, 2)
    with pytest.raises(TypeError):
        ParameterSampler([{"a": [1]}, 5], 2)
    with pytest.raises(ValueError):
        list(ParameterSampler({"a": [1, 2]}, 1, random_state="seed"))


@pytest.mark.parametrize("case", ["logreg_rvs", "ridge_lists"])
def test_randomized_search_matches_jax(digits, diabetes, case):
    if case == "logreg_rvs":
        X, y = digits
        X, y = X[:450], y[:450]
        est = SkLogReg(max_iter=60)
        dist = {"C": st.loguniform(1e-2, 1e2)}
        cv = SkStratifiedKFold(3)
    else:
        X, y = diabetes
        est = SkRidge()
        dist = {"alpha": list(np.logspace(-2, 3, 30))}
        cv = SkKFold(3)
    kw = dict(n_iter=5, cv=cv, random_state=11)
    ours = port.RandomizedSearchCV(est, dist, config=CPU, **kw).fit(X, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # lbfgs ConvergenceWarning
        ref = sst.RandomizedSearchCV(est, dist, backend="tpu", **kw).fit(X, y)
    assert ours.cv_results_["params"] == ref.cv_results_["params"]
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], atol=5e-3)
    assert ours.best_params_ == ref.best_params_
    assert set(ours.cv_results_) == set(ref.cv_results_)
    assert type(ours.best_estimator_) is type(est)


def test_port_randomized_search_without_sklearn_objects(digits):
    """The sklearn-free path chip_smoke.py drives: the port's estimator,
    splitter and sampler, refit on the search's device."""
    X, y = digits
    X, y = X[:300], y[:300]
    rs = port.RandomizedSearchCV(
        port.LogisticRegression(penalty="elasticnet", l1_ratio=0.5,
                                max_iter=20),
        {"C": st.loguniform(1e-1, 1e1)}, n_iter=3,
        cv=port.StratifiedKFold(3), random_state=0, config=CPU).fit(X, y)
    want = list(SkParameterSampler({"C": st.loguniform(1e-1, 1e1)}, 3,
                                   random_state=0))
    assert rs.cv_results_["params"] == want
    assert rs.best_estimator_.device == "cpu"
    assert rs.best_estimator_.C == rs.best_params_["C"]
    assert rs.best_score_ > 0.8
