"""Successive halving in the PyTorch port against sklearn and the JAX
package on the CPU.

- The port's copies of sklearn's `_SubsampleMetaSplitter`, `_top_k` and
  `_yields_constant_splits` return what sklearn's do (hypothesis over
  the sizes, fractions and integer seeds; NaN and tied scores).
- `HalvingGridSearchCV` / `HalvingRandomSearchCV` on ``device="cpu"``
  against the JAX package's compiled tier (``backend="tpu"`` on the
  CPU): LogisticRegression with ``resource="n_samples"``, GaussianNB
  with `aggressive_elimination`, GradientBoostingRegressor with
  ``resource="n_estimators"``, and a random search.  Every ``n_*``
  attribute, `iter`, `n_resources`, `params` and `best_params_` exactly,
  the scores at 5e-3 (the repo's oracle bound,
  `tests/test_search_basic.py:47`), on grids whose scores are tie-free
  at each cut (checked: the kept and the dropped candidates' means
  differ by more than that bound).
- The reference's input-validation errors (`tests/test_halving.py:
  147-172`) and the multimetric one; the `verbose` stdout equal to the
  JAX package's; the `evaluate_candidates` seam; rung compaction (the
  uncompacted rung's scores within 1e-6, skipped where a class drops
  out).
"""

import warnings
from math import ceil

import numpy as np
import pytest
import scipy.stats as stats
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.ensemble import GradientBoostingRegressor
from sklearn.ensemble import RandomForestClassifier
from sklearn.experimental import enable_halving_search_cv  # noqa: F401
from sklearn.linear_model import LogisticRegression, Ridge
from sklearn.model_selection import KFold as SkKFold
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.model_selection._search_successive_halving import (
    _SubsampleMetaSplitter as SkSubsample,
    _top_k as sk_top_k,
)
from sklearn.model_selection._split import (
    _yields_constant_splits as sk_constant,
)
from sklearn.naive_bayes import GaussianNB

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.search import grid as pgrid
from spark_sklearn_tpu_torch.search.cv import (
    KFold,
    StratifiedKFold,
    _SubsampleMetaSplitter,
    _top_k,
    _yields_constant_splits,
    check_cv,
)

CPU = port.TorchConfig(device="cpu")
ORACLE = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=120, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.int64)
    return X, y


def _regression(n=150, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# sklearn's helpers
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(n=st.integers(10, 200), fraction=st.floats(0.05, 1.0),
       seed=st.integers(0, 2**31 - 1), folds=st.integers(2, 5),
       subsample_test=st.booleans())
def test_subsample_splitter_matches_sklearn(n, fraction, seed, folds,
                                            subsample_test):
    X = np.zeros((n, 1))
    y = np.arange(n) % 2
    ours = _SubsampleMetaSplitter(base_cv=KFold(folds), fraction=fraction,
                                  subsample_test=subsample_test,
                                  random_state=seed)
    theirs = SkSubsample(base_cv=SkKFold(folds), fraction=fraction,
                         subsample_test=subsample_test, random_state=seed)
    try:
        want = list(theirs.split(X, y))
    except ValueError:
        # a fold whose subsample would be empty: both refuse it
        with pytest.raises(ValueError, match="n_samples"):
            list(ours.split(X, y))
        return
    got = list(ours.split(X, y))
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_subsample_splitter_global_state_matches_sklearn():
    """random_state=None draws from numpy's global RandomState, as
    sklearn's does: the same draws from the same global seed."""
    X, y = np.zeros((60, 1)), np.arange(60) % 3
    np.random.seed(4)
    got = list(_SubsampleMetaSplitter(
        base_cv=StratifiedKFold(3), fraction=0.4, subsample_test=True,
        random_state=None).split(X, y))
    np.random.seed(4)
    want = list(SkSubsample(
        base_cv=SkStratifiedKFold(3), fraction=0.4, subsample_test=True,
        random_state=None).split(X, y))
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@settings(max_examples=60, deadline=None)
@given(scores=st.lists(st.one_of(
    st.sampled_from([0.5, 0.75, 1.0]), st.just(float("nan")),
    st.floats(-2.0, 2.0)), min_size=1, max_size=30),
    k=st.integers(1, 30), n_prev=st.integers(0, 5))
def test_top_k_matches_sklearn(scores, k, n_prev):
    """NaNs, tied scores and an earlier iteration's rows before them."""
    n = len(scores)
    results = {
        "iter": [0] * n_prev + [1] * n,
        "mean_test_score": np.asarray([0.0] * n_prev + scores),
        "params": [{"i": i} for i in range(n_prev + n)],
    }
    got = _top_k(results, k, 1)
    want = sk_top_k(results, k, 1)
    assert list(got) == list(want)


@pytest.mark.parametrize("cv", [
    SkKFold(3), SkKFold(3, shuffle=True), SkKFold(3, shuffle=True,
                                                  random_state=0),
    SkStratifiedKFold(3, shuffle=True, random_state=np.random.RandomState(
        0)), KFold(3), StratifiedKFold(3), [(np.arange(3), np.arange(3))]])
def test_yields_constant_splits_matches_sklearn(cv):
    assert _yields_constant_splits(cv) == sk_constant(cv)


# ---------------------------------------------------------------------------
# against the JAX package's compiled tier
# ---------------------------------------------------------------------------

def _pair(cls_port, cls_ref, est, space, X, y, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = cls_port(est, space, config=CPU, **kw).fit(X, y)
        ref = cls_ref(est, space, backend="tpu", **kw).fit(X, y)
    return ours, ref


_ATTRS = ("n_resources_", "n_candidates_", "n_remaining_candidates_",
          "n_iterations_", "n_possible_iterations_",
          "n_required_iterations_", "min_resources_", "max_resources_",
          "best_index_", "best_params_", "n_splits_")


def _assert_matches(ours, ref):
    for attr in _ATTRS:
        assert getattr(ours, attr) == getattr(ref, attr), attr
    ro, rr = ours.cv_results_, ref.cv_results_
    assert set(ro) == set(rr)
    for key in ("iter", "n_resources"):
        np.testing.assert_array_equal(ro[key], rr[key])
        assert ro[key].dtype == rr[key].dtype
    assert list(ro["params"]) == list(rr["params"])
    for key in ro:
        if "score" in key and "rank" not in key and "time" not in key:
            np.testing.assert_allclose(ro[key], rr[key], atol=ORACLE,
                                       rtol=0, err_msg=key)
    np.testing.assert_allclose(ours.best_score_, ref.best_score_,
                               atol=ORACLE, rtol=0)
    # tie-free cuts: each rung's survivors beat the dropped candidates by
    # more than the tolerance, so no survivor rests on float noise
    for itr in range(ours.n_iterations_ - 1):
        means = rr["mean_test_score"][rr["iter"] == itr]
        keep = ceil(len(means) / ours.factor)
        order = np.sort(means)
        assert order[-keep] - order[-keep - 1] > 2 * ORACLE, (itr, order)


def test_logistic_n_samples_matches_jax():
    X, y = _data(n=240)
    ours, ref = _pair(
        port.HalvingGridSearchCV, sst.HalvingGridSearchCV,
        LogisticRegression(max_iter=200),
        {"C": [1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 1.0, 10.0]}, X, y,
        cv=3, factor=3, random_state=7, scoring="neg_log_loss")
    assert ours.n_resources_ == [26, 78, 234]
    _assert_matches(ours, ref)
    # every rung's chunks carry the rung's namespace
    assert [c["id"].split(":")[0] for c in ours.chunks_] == [
        "r0", "r1", "r2"]
    assert [r["n_candidates"] for r in ours.rungs_] == [9, 3, 1]


def test_gaussian_nb_aggressive_matches_jax():
    """Smoothing large enough that no fold's probabilities saturate: the
    port clips GaussianNB's log loss at float32's eps, as sklearn does,
    and the JAX package at float64's (`tests/test_torch_naive_bayes.py`)."""
    X, y = _data(n=120, seed=2)
    ours, ref = _pair(
        port.HalvingGridSearchCV, sst.HalvingGridSearchCV, GaussianNB(),
        {"var_smoothing": [0.05, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0,
                           300.0]}, X, y,
        cv=2, factor=3, random_state=0, aggressive_elimination=True,
        max_resources=40, scoring="neg_log_loss")
    # held at the floor while candidates are eliminated
    assert ours.n_iterations_ > ours.n_possible_iterations_
    _assert_matches(ours, ref)


def test_gradient_boosting_n_estimators_matches_jax():
    X, y = _regression()
    ours, ref = _pair(
        port.HalvingGridSearchCV, sst.HalvingGridSearchCV,
        GradientBoostingRegressor(random_state=0),
        {"learning_rate": [0.05, 0.1, 0.2], "max_depth": [1, 2, 3]}, X, y,
        cv=SkKFold(3), factor=3, resource="n_estimators",
        max_resources=18, refit=False)
    assert ours.n_resources_ == [2, 6, 18]
    np.testing.assert_array_equal(ours.cv_results_["param_n_estimators"],
                                  ours.cv_results_["n_resources"])
    _assert_matches(ours, ref)


def test_random_search_matches_jax():
    X, y = _data(n=240, seed=2)
    ours, ref = _pair(
        port.HalvingRandomSearchCV, sst.HalvingRandomSearchCV,
        LogisticRegression(max_iter=200),
        {"C": stats.loguniform(1e-4, 1e1)}, X, y,
        cv=3, factor=3, random_state=3, n_candidates=9, min_resources=24,
        scoring="neg_log_loss")
    _assert_matches(ours, ref)


# ---------------------------------------------------------------------------
# validation, verbose, the seam, rung compaction
# ---------------------------------------------------------------------------

def test_input_validation_matches_the_reference():
    X, y = _data(n=96)
    for pkg, kw in ((port, {"config": CPU}), (sst, {})):
        with pytest.raises(ValueError, match="not supported by"):
            pkg.HalvingGridSearchCV(
                GaussianNB(), {"var_smoothing": [1e-9]}, resource="nope",
                max_resources=8, **kw).fit(X, y)
        with pytest.raises(ValueError, match="part of the searched"):
            pkg.HalvingGridSearchCV(
                RandomForestClassifier(), {"n_estimators": [5, 8]},
                resource="n_estimators", max_resources=10,
                **kw).fit(X, y)
        with pytest.raises(ValueError, match="Multimetric"):
            pkg.HalvingGridSearchCV(
                GaussianNB(), {"var_smoothing": [1e-9]},
                scoring=["accuracy", "f1"], **kw).fit(X, y)
        with pytest.raises(ValueError, match="n_samples"):
            pkg.HalvingGridSearchCV(
                RandomForestClassifier(), {"max_depth": [2]},
                resource="n_estimators", **kw).fit(X, y)
        with pytest.raises(ValueError, match="consistent folds"):
            pkg.HalvingGridSearchCV(
                GaussianNB(), {"var_smoothing": [1e-9]},
                cv=SkKFold(3, shuffle=True), **kw).fit(X, y)
        with pytest.raises(ValueError, match="both set to 'exhaust'"):
            pkg.HalvingRandomSearchCV(
                GaussianNB(), {"var_smoothing": [1e-9, 1e-8]},
                min_resources="exhaust", **kw).fit(X, y)
        with pytest.raises(ValueError, match="is greater than"):
            pkg.HalvingGridSearchCV(
                GaussianNB(), {"var_smoothing": [1e-9]},
                min_resources=200, **kw).fit(X, y)


def test_verbose_stdout_matches_the_jax_package(capsys):
    X, y = _data(n=96)
    grid = {"var_smoothing": [1e-3, 1e-1, 1.0, 10.0]}
    out = {}
    for name, pkg, kw in (("port", port, {"config": CPU}),
                          ("jax", sst, {"backend": "tpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pkg.HalvingGridSearchCV(GaussianNB(), grid, cv=2, factor=2,
                                    random_state=0, verbose=1,
                                    **kw).fit(X, y)
        out[name] = capsys.readouterr().out
    assert "n_required_iterations: 3" in out["port"]
    assert out["port"].count("Fitting 2 folds") == 3
    assert out["port"] == out["jax"]


class _TwoCalls(port.GridSearchCV):
    """A search whose `_run_search` evaluates its grid in two calls, the
    second on a per-call cv, with an extra result column."""

    def _run_search(self, evaluate_candidates):
        cands = self._get_candidates()
        first = evaluate_candidates(cands[:2], more_results={"tag": [0, 0]})
        assert len(first["params"]) == 2
        evaluate_candidates(cands[2:], cv=self.second_cv,
                            more_results={"tag": [1] * (len(cands) - 2)})


def test_evaluate_candidates_accumulates_across_calls():
    X, y = _regression(n=90)
    grid = {"alpha": [0.1, 1.0, 10.0, 100.0]}
    two = _TwoCalls(Ridge(), grid, cv=3, config=CPU)
    two.second_cv = KFold(3)
    two.fit(X, y)
    one = port.GridSearchCV(Ridge(), grid, cv=3, config=CPU).fit(X, y)
    assert list(two.cv_results_["params"]) == list(one.cv_results_["params"])
    np.testing.assert_array_equal(two.cv_results_["tag"], [0, 0, 1, 1])
    for key in ("mean_test_score", "split2_test_score", "rank_test_score"):
        np.testing.assert_allclose(two.cv_results_[key],
                                   one.cv_results_[key], rtol=1e-12)
    assert list(two.cv_results_)[0] == "tag"       # sklearn's layout
    assert [c["id"] for c in two.chunks_] == ["0:0:2", "0:0:2"]
    # a per-call cv must give the search's split count
    bad = _TwoCalls(Ridge(), grid, cv=3, config=CPU)
    bad.second_cv = KFold(2)
    with pytest.raises(ValueError, match="yielded 2 splits, expected 3"):
        bad.fit(X, y)


def test_scorer_names_must_agree_across_calls():
    from sklearn.tree import DecisionTreeRegressor

    calls = []

    def scorer(est, X, y):
        calls.append(1)
        return {"a" if len(X) == 30 else "b": 1.0}

    class Split(_TwoCalls):
        pass

    X, y = _regression(n=90)
    search = Split(DecisionTreeRegressor(), {"max_depth": [1, 2, 3]}, cv=3,
                   scoring=scorer, refit=False, backend="host")
    search.second_cv = check_cv([(np.arange(60), np.arange(60, 89))] * 3)
    with pytest.raises(ValueError, match="inconsistent scorer names"):
        search.fit(X, y)


def test_rung_compaction_keeps_the_scores(monkeypatch):
    """GaussianNB's closed form: the same fit on the same rows, summed in
    another order (an iterative fit's stopping test would amplify that
    rounding past 1e-6)."""
    X, y = _data(n=240, seed=2)
    kw = dict(cv=3, factor=3, random_state=3, scoring="neg_log_loss",
              config=CPU)
    grid = {"var_smoothing": [1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0]}
    fitted_rows = []
    real = pgrid._BaseSearch._fit_compiled

    def spy(self, family, X, *args, **kwargs):
        fitted_rows.append(X.shape[0])
        return real(self, family, X, *args, **kwargs)

    monkeypatch.setattr(pgrid._BaseSearch, "_fit_compiled", spy)
    compact = port.HalvingGridSearchCV(GaussianNB(), grid, **kw).fit(X, y)
    # the first rung fits only the rows its subsampled folds use
    assert fitted_rows[0] < X.shape[0]
    monkeypatch.setattr(pgrid, "_compact_for_rung",
                        lambda *a, **k: None)
    fitted_rows.clear()
    full = port.HalvingGridSearchCV(GaussianNB(), grid, **kw).fit(X, y)
    assert fitted_rows == [X.shape[0]] * len(fitted_rows)
    assert compact.n_resources_ == full.n_resources_
    assert list(compact.cv_results_["params"]) == \
        list(full.cv_results_["params"])
    for key in compact.cv_results_:
        if "score" in key and "rank" not in key and "time" not in key:
            np.testing.assert_allclose(compact.cv_results_[key],
                                       full.cv_results_[key], rtol=0,
                                       atol=1e-6, err_msg=key)


def test_rung_compaction_is_skipped_where_a_class_drops_out():
    X = np.arange(20, dtype=np.float32)[:, None]
    y = np.array([0] * 9 + [1] * 9 + [2] * 2)
    splits = [(np.arange(0, 6), np.arange(9, 12))]       # no class 2
    assert pgrid._compact_for_rung(X, y, splits, None, None, True) is None
    # a regressor's target has no classes to lose
    sub = pgrid._compact_for_rung(X, y.astype(np.float32), splits,
                                  np.ones(20), None, False)
    Xc, yc, splits_c, fw, sw = sub
    np.testing.assert_array_equal(Xc[:, 0], np.r_[0:6, 9:12])
    np.testing.assert_array_equal(splits_c[0][0], np.arange(6))
    np.testing.assert_array_equal(splits_c[0][1], np.arange(6, 9))
    assert fw.shape == (9,) and sw is None
    # nothing drops out: nothing to compact
    every = [(np.arange(10), np.arange(10, 20))]
    assert pgrid._compact_for_rung(X, y, every, None, None, True) is None


def test_launch_owner_protocol():
    """The reference's `parallel/ownership.py` contract: only a
    LaunchOwner attaches, once; `current_owner` filters by kind; the
    halving rung loop detaches its context, also when a rung raises."""
    from spark_sklearn_tpu_torch.parallel import ownership
    from spark_sklearn_tpu_torch.search.halving import _RungContext

    class Search:
        pass

    s = Search()
    assert ownership.current_owner(s) is None
    with pytest.raises(TypeError):
        ownership.attach_owner(s, object())
    rc = ownership.attach_owner(s, _RungContext("n_samples"))
    with pytest.raises(RuntimeError, match="already has an attached rung"):
        ownership.attach_owner(s, ownership.LaunchOwner())
    assert ownership.current_owner(s, kind="rung") is rc
    assert ownership.current_owner(s, kind="fused") is None
    rc.begin_rung(2, 90, 3)
    assert rc.ns == "r2" and rc.records[-1]["n_resources"] == 90
    assert ownership.detach_owner(s) is rc
    assert ownership.detach_owner(s) is None

    X, y = _data(n=96)
    search = port.HalvingGridSearchCV(
        GaussianNB(), {"var_smoothing": [1e-3, 1e-1, 1.0]}, cv=2,
        scoring="not_a_scorer", backend="device", config=CPU)
    with pytest.raises(NotImplementedError):
        search.fit(X, y)
    assert ownership.current_owner(search) is None
