"""The port's host tier against the JAX package's, and the tier decision.

Both packages' ``backend="host"`` run sklearn's `_fit_and_score` a task,
so `cv_results_` must be equal in every column but the times, byte for
byte: a DecisionTreeClassifier (no family in either package), a
callable scorer, a `make_scorer` object and a dict of them, a fit
parameter other than sample_weight (a Pipeline's ``lr__sample_weight``),
sample_weight with KNN (sklearn's fit refuses it: every fit fails, with
the same message) and ``kernel="precomputed"``.  Then:

- ``backend=None`` routes each of these cases to the host before any
  fit and warns once;
- ``backend="device"`` raises where the reference's ``backend="tpu"``
  raises;
- an exception inside a family's device fit propagates, with no
  warning and no host run;
- the port's host-tier halving equals sklearn's `HalvingGridSearchCV`
  and `HalvingRandomSearchCV` byte for byte (the reference's
  `tests/test_halving.py:90-145`).
"""

import warnings

import numpy as np
import pytest
import scipy.stats as stats
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.experimental import enable_halving_search_cv  # noqa: F401
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import f1_score, make_scorer
from sklearn.model_selection import HalvingGridSearchCV as SkHalvingGrid
from sklearn.model_selection import HalvingRandomSearchCV as SkHalvingRandom
from sklearn.naive_bayes import GaussianNB
from sklearn.neighbors import KNeighborsClassifier
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import StandardScaler
from sklearn.svm import SVC
from sklearn.tree import DecisionTreeClassifier

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
from spark_sklearn_tpu_torch.search import grid as pgrid

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=96, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X[:, 0] + 0.25 * rng.randn(n) > 0).astype(np.int64)
    return X, y


def _accuracy_margin(est, X, y):
    """A callable scorer: the mean signed margin of the right class."""
    proba = est.predict_proba(X)
    return float(np.mean(proba[np.arange(len(y)), y] - 0.5))


F1_MACRO = make_scorer(f1_score, average="macro")


def _case(name):
    """(estimator, grid, fit kwargs, scoring, X, y) of one host case."""
    X, y = _data()
    est, grid, kw, scoring = LogisticRegression(), {"C": [0.1, 1.0]}, {}, None
    if name == "tree":
        est, grid = DecisionTreeClassifier(random_state=0), {
            "max_depth": [1, 2, 3]}
    elif name == "callable":
        scoring = _accuracy_margin
    elif name == "scorer_object":
        scoring = F1_MACRO
    elif name == "dict":
        scoring = {"f1m": F1_MACRO, "margin": _accuracy_margin,
                   "acc": "accuracy"}
    elif name == "fit_param":
        est = Pipeline([("s", StandardScaler()), ("lr", LogisticRegression())])
        grid = {"lr__C": [0.1, 1.0]}
        kw = {"lr__sample_weight": np.linspace(0.5, 2.0, len(y))}
    elif name == "knn_weights":
        est, grid = KNeighborsClassifier(), {"n_neighbors": [3, 5]}
        kw = {"sample_weight": np.linspace(0.5, 2.0, len(y))}
    elif name == "precomputed":
        est, grid = SVC(kernel="precomputed"), {"C": [0.5, 2.0]}
        X = X @ X.T
    return est, grid, kw, scoring, X, y


CASES = ["tree", "callable", "scorer_object", "dict", "fit_param",
         "knn_weights", "precomputed"]


def _refit(scoring):
    return "acc" if isinstance(scoring, dict) else True


def _fit(pkg, name, backend, **extra):
    est, grid, kw, scoring, X, y = _case(name)
    cfg = {"config": CPU} if pkg is port else {}
    return pkg.GridSearchCV(est, grid, cv=3, scoring=scoring,
                            refit=_refit(scoring), backend=backend,
                            return_train_score=True, **cfg,
                            **extra).fit(X, y, **kw)


def _assert_results_identical(ra, rb):
    assert list(ra) == list(rb)
    for key in ra:
        if "time" in key:
            continue
        if key == "params":
            assert ra[key] == rb[key]
            continue
        a, b = np.asarray(ra[key]), np.asarray(rb[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("name", CASES)
def test_host_tier_matches_the_reference_byte_for_byte(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name == "knn_weights":
            with pytest.raises(ValueError, match="fits failed") as ours:
                _fit(port, name, "host")
            with pytest.raises(ValueError, match="fits failed") as ref:
                _fit(sst, name, "host")
            assert str(ours.value) == str(ref.value)
            assert "sample_weight" in str(ours.value)
            return
        ours = _fit(port, name, "host")
        ref = _fit(sst, name, "host")
    _assert_results_identical(ours.cv_results_, ref.cv_results_)
    assert ours.best_index_ == ref.best_index_
    assert ours.best_params_ == ref.best_params_
    assert ours.multimetric_ == ref.multimetric_
    X, y = _case(name)[4:]
    assert np.array_equal(ours.predict(X), ref.predict(X))
    if name == "scorer_object":
        assert ours.scorer_ is F1_MACRO
        assert ours.score(X, y) == ref.score(X, y)


@pytest.mark.parametrize("name", CASES)
def test_backend_none_routes_up_front_and_warns_once(name, monkeypatch):
    calls = []
    real = pgrid._BaseSearch._fit_compiled

    def spy(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(pgrid._BaseSearch, "_fit_compiled", spy)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if name == "knn_weights":
            with pytest.raises(ValueError, match="fits failed"):
                _fit(port, name, None)
        else:
            auto = _fit(port, name, None)
    host = [str(w.message) for w in caught if "host tier" in str(w.message)]
    assert len(host) == 1, host
    assert calls == []                 # no device fit ran first
    if name != "knn_weights":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            forced = _fit(port, name, "host")
        _assert_results_identical(auto.cv_results_, forced.cv_results_)


#: the cases where the reference's backend="tpu" raises (an estimator
#: without a family runs on its host tier even then)
DEVICE_REFUSED = ["callable", "scorer_object", "dict", "fit_param",
                  "knn_weights", "precomputed"]


@pytest.mark.parametrize("name", DEVICE_REFUSED)
def test_backend_device_raises_where_the_reference_does(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises((ValueError, TypeError, KeyError,
                            NotImplementedError)):
            _fit(sst, name, "tpu")
        with pytest.raises((ValueError, NotImplementedError)):
            _fit(port, name, "device")


def test_backend_device_refuses_an_estimator_without_a_family():
    with pytest.raises(NotImplementedError, match="no family"):
        _fit(port, "tree", "device")
    with pytest.raises(ValueError, match="backend="):
        _fit(port, "tree", "gpu")


def test_device_fit_failure_propagates(monkeypatch):
    def boom(cls, *args, **kwargs):
        raise RuntimeError("device fit failed")

    host = []
    monkeypatch.setattr(LogisticRegressionFamily, "fit_task_batched",
                        classmethod(boom))
    monkeypatch.setattr(pgrid._BaseSearch, "_fit_host",
                        lambda self, *a, **k: host.append(1))
    X, y = _data()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="device fit failed"):
            port.GridSearchCV(LogisticRegression(), {"C": [1.0]}, cv=3,
                              config=CPU).fit(X, y)
    assert host == []
    assert not [w for w in caught if "host" in str(w.message)]


def test_host_tier_needs_sklearn(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_joblib(name, *args, **kwargs):
        if name == "joblib" or name.startswith("sklearn.model_selection"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    X, y = _data()
    search = port.GridSearchCV(DecisionTreeClassifier(), {"max_depth": [1]},
                               cv=3, backend="host", config=CPU)
    monkeypatch.setattr(builtins, "__import__", no_joblib)
    with pytest.raises(ImportError, match="scikit-learn"):
        search.fit(X, y)


# ---------------------------------------------------------------------------
# host-tier halving against sklearn (the reference's test_halving.py:90-145)
# ---------------------------------------------------------------------------

def _pin(est, space, sk_cls, our_cls, X=None, y=None, **kw):
    if X is None:
        X, y = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sk_cls(est, space, **kw).fit(X, y)
        ours = our_cls(est, space, backend="host", config=CPU,
                       **kw).fit(X, y)
    for attr in ("n_resources_", "n_candidates_", "n_remaining_candidates_",
                 "n_iterations_", "n_possible_iterations_",
                 "n_required_iterations_", "min_resources_",
                 "max_resources_", "best_index_", "best_params_"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    _assert_results_identical(ref.cv_results_, ours.cv_results_)
    assert ours.best_score_ == ref.best_score_
    return ours


@pytest.mark.parametrize("case", ["logreg", "forest", "gnb", "random"])
def test_host_halving_matches_sklearn_byte_for_byte(case):
    if case == "logreg":
        _pin(LogisticRegression(max_iter=50),
             {"C": [0.01, 0.1, 1.0, 10.0, 100.0, 1000.0]}, SkHalvingGrid,
             port.HalvingGridSearchCV, cv=2, factor=3, random_state=7)
    elif case == "forest":
        X, y = _data(80, 5)
        ours = _pin(RandomForestClassifier(random_state=3),
                    {"max_depth": [2, 3, 4, 5]}, SkHalvingGrid,
                    port.HalvingGridSearchCV, X=X, y=y, cv=2, factor=2,
                    resource="n_estimators", max_resources=12,
                    min_resources=3, random_state=7)
        np.testing.assert_array_equal(
            ours.cv_results_["param_n_estimators"].astype(int),
            ours.cv_results_["n_resources"])
    elif case == "gnb":
        _pin(GaussianNB(), {"var_smoothing": np.logspace(-9, -4, 18).tolist()},
             SkHalvingGrid, port.HalvingGridSearchCV, cv=2, factor=3,
             random_state=5, aggressive_elimination=True, max_resources=40)
    else:
        _pin(LogisticRegression(max_iter=30),
             {"C": stats.loguniform(1e-3, 1e2)}, SkHalvingRandom,
             port.HalvingRandomSearchCV, cv=2, factor=2, random_state=11,
             n_candidates=9, min_resources=20)


def test_the_ports_own_estimator_runs_on_the_host_tier():
    """The port's estimators carry sklearn's tags for sklearn's helpers:
    forced onto the host tier, the port's LogisticRegression fits on the
    search's device a task and scores as the device tier does (the same
    fits: within the oracle bound, tests/test_search_basic.py:47)."""
    X, y = _data()
    X = X.astype(np.float32)
    grid = {"C": [0.1, 1.0, 10.0]}
    host = port.GridSearchCV(port.LogisticRegression(), grid, cv=3,
                             scoring="accuracy", backend="host",
                             config=CPU).fit(X, y)
    device = port.GridSearchCV(port.LogisticRegression(), grid, cv=3,
                               scoring="accuracy", config=CPU).fit(X, y)
    assert host.chunks_ == [] and device.chunks_
    np.testing.assert_allclose(host.cv_results_["mean_test_score"],
                               device.cv_results_["mean_test_score"],
                               atol=5e-3, rtol=0)
    assert host.best_params_ == device.best_params_
    assert host.best_estimator_.device == "cpu"
