"""The port's search front end against the JAX package's on the CPU:
weighted searches (`fit(X, y, sample_weight=...)`) family by family,
`groups` through sklearn's `GroupKFold`, the refusals where the
reference leaves its compiled path, `max_error` scoring unweighted in a
weighted search, sklearn's `verbose` lines, and the search's surface
after refit (`score`, `decision_function`, `predict_log_proba`,
`classes_`, `n_features_in_`, `scorer_`).  Where the reference's own
`tests/test_routing.py` holds it to sklearn, the port is held there too:
the weighted logistic-regression search against sklearn's (atol 1e-2)
and Ridge with integer weights against repeated rows (float64 closed
form, rtol 1e-6).

Weights are drawn from fixed seeds, uniform in [0.25, 3).  Tolerances
on mean_test_score against the JAX package: the families' own search
tests' (1e-5 for the closed forms and naive Bayes, 1e-4 for the trees,
5e-3 for the iterative fits: the repo's oracle bound,
`tests/test_search_basic.py`), with the same best_params_.
"""

import re
import warnings

import numpy as np
import pytest
import torch
from sklearn import cluster as skc
from sklearn import discriminant_analysis as skda
from sklearn import ensemble as ske
from sklearn import linear_model as sklm
from sklearn import naive_bayes as sknb
from sklearn import neighbors as skn
from sklearn import neural_network as sknn
from sklearn import svm as sksvm
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.model_selection import GroupKFold, KFold, StratifiedKFold
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import StandardScaler as SkStandardScaler

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _classes(seed=0, n=150, d=6, k=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = (rng.normal(size=(n, d)) + 0.8 * (y[:, None] == np.arange(d) % k)
         ).astype(np.float32)
    return X, y


def _counts(seed=0, n=150, d=6, k=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = (rng.integers(0, 5, (n, d)) + 2 * (y[:, None] == np.arange(d) % k)
         ).astype(np.float32)
    return X, y


def _regression(seed=0, n=150, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    return X, y


def _weights(n, seed=1):
    return np.random.default_rng(seed).uniform(0.25, 3.0, n)


#: (id, estimator, grid, data, atol): every family that takes
#: sample_weight on the compiled path
FAMILIES = [
    ("logistic", sklm.LogisticRegression(max_iter=200),
     {"C": [0.1, 1.0]}, _classes, 5e-3),
    ("ridge", sklm.Ridge(), {"alpha": [0.1, 10.0]}, _regression, 1e-5),
    ("linear_regression", sklm.LinearRegression(),
     {"fit_intercept": [True, False]}, _regression, 1e-5),
    ("elasticnet", sklm.ElasticNet(max_iter=300),
     {"alpha": [0.01, 0.1]}, _regression, 5e-3),
    ("lasso", sklm.Lasso(max_iter=300), {"alpha": [0.01, 0.1]},
     _regression, 5e-3),
    ("svc", sksvm.SVC(), {"C": [1.0, 10.0]}, _classes, 5e-3),
    ("nusvc", sksvm.NuSVC(), {"nu": [0.3, 0.5]}, _classes, 5e-3),
    ("svc_proba", sksvm.SVC(probability=True), {"C": [1.0]}, _classes,
     5e-3),
    ("svr", sksvm.SVR(), {"C": [1.0, 10.0]}, _regression, 5e-3),
    ("nusvr", sksvm.NuSVR(), {"nu": [0.3, 0.6]}, _regression, 5e-3),
    ("linear_svc", sksvm.LinearSVC(), {"C": [0.1, 1.0]}, _classes, 5e-3),
    ("linear_svr", sksvm.LinearSVR(), {"C": [0.1, 1.0]}, _regression,
     5e-3),
    ("gb_regressor", ske.GradientBoostingRegressor(
        n_estimators=5, max_depth=2, random_state=0),
     {"learning_rate": [0.1, 0.3]}, _regression, 1e-4),
    ("gb_classifier", ske.GradientBoostingClassifier(
        n_estimators=4, max_depth=2, random_state=0),
     {"learning_rate": [0.1, 0.3]}, _classes, 1e-4),
    ("rf_classifier", ske.RandomForestClassifier(
        n_estimators=4, max_depth=3, random_state=0),
     {"max_features": [2, 4]}, _classes, 1e-4),
    ("rf_regressor", ske.RandomForestRegressor(
        n_estimators=4, max_depth=3, random_state=0),
     {"max_features": [2, 4]}, _regression, 1e-4),
    ("mlp_classifier", sknn.MLPClassifier(
        hidden_layer_sizes=(8,), max_iter=30, random_state=0),
     {"alpha": [1e-4, 1e-1]}, _classes, 5e-3),
    ("mlp_regressor", sknn.MLPRegressor(
        hidden_layer_sizes=(8,), max_iter=30, random_state=0),
     {"alpha": [1e-4, 1e-1]}, _regression, 5e-3),
    ("gaussian_nb", sknb.GaussianNB(), {"var_smoothing": [1e-9, 1e-2]},
     _classes, 1e-5),
    ("multinomial_nb", sknb.MultinomialNB(), {"alpha": [0.1, 1.0]},
     _counts, 1e-5),
    ("complement_nb", sknb.ComplementNB(), {"alpha": [0.1, 1.0]},
     _counts, 1e-5),
    ("bernoulli_nb", sknb.BernoulliNB(binarize=2.0),
     {"alpha": [0.1, 1.0]}, _counts, 1e-5),
    ("categorical_nb", sknb.CategoricalNB(), {"alpha": [0.1, 1.0]},
     _counts, 1e-5),
    ("kmeans", skc.KMeans(n_clusters=3, n_init=1, random_state=0),
     {"tol": [1e-4, 1e-2]}, _classes, 5e-3),
]


@pytest.mark.parametrize("est,grid,data,atol",
                         [f[1:] for f in FAMILIES],
                         ids=[f[0] for f in FAMILIES])
def test_weighted_search_matches_jax(est, grid, data, atol):
    """A weighted search through both packages: the fit masks scaled by
    the weights, the scoring masks too; the same cv_results_ scores and
    best_params_."""
    X, y = data()
    sw = _weights(len(y))
    kw = dict(cv=KFold(3), refit=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # ConvergenceWarning, Platt's
        ref = sst.GridSearchCV(est, grid, backend="tpu", **kw).fit(
            X, y, sample_weight=sw)
        got = port.GridSearchCV(est, grid, config=CPU, **kw).fit(
            X, y, sample_weight=sw)
    np.testing.assert_allclose(got.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], rtol=0,
                               atol=atol)
    assert got.best_params_ == ref.best_params_
    # the weights moved the scores: an unweighted search differs
    plain = port.GridSearchCV(est, grid, config=CPU, **kw).fit(X, y)
    assert not np.allclose(plain.cv_results_["mean_test_score"],
                           got.cv_results_["mean_test_score"], rtol=0,
                           atol=1e-9)


def test_logistic_weighted_matches_sklearn():
    """The reference's oracle (test_routing.py:27-43): a weighted
    logistic-regression search against sklearn's, atol 1e-2, integer
    weights 0-3 (zero weights included)."""
    X, y = _classes(n=300)
    sw = np.random.default_rng(0).integers(0, 4, len(y)).astype(float)
    grid = {"C": [0.1, 1.0]}
    cv = StratifiedKFold(n_splits=3)
    got = port.GridSearchCV(sklm.LogisticRegression(max_iter=200), grid,
                            cv=cv, config=CPU).fit(X, y, sample_weight=sw)
    sk = SkGridSearchCV(sklm.LogisticRegression(max_iter=200), grid,
                        cv=cv).fit(X, y, sample_weight=sw)
    np.testing.assert_allclose(got.cv_results_["mean_test_score"],
                               sk.cv_results_["mean_test_score"],
                               atol=1e-2)


def test_ridge_weights_equal_repeated_rows():
    """sklearn's statistical contract on the compiled path
    (test_routing.py:45-70): integer weights give the search over the
    rows repeated that many times, one deterministic split each."""
    rng = np.random.default_rng(1)
    n, d = 80, 12
    X = rng.normal(size=(n, d))
    y = X @ rng.normal(size=d) + 0.1 * rng.normal(size=n)
    sw = rng.integers(1, 4, size=n)
    idx = np.arange(n)
    ofs = np.cumsum(np.concatenate([[0], sw]))

    def rep(ii):
        return np.concatenate([np.arange(ofs[i], ofs[i + 1]) for i in ii])

    grid = {"alpha": [0.1, 1.0, 10.0]}
    gw = port.GridSearchCV(sklm.Ridge(), grid,
                           cv=[(idx[:n // 2], idx[n // 2:])], refit=False,
                           config=CPU).fit(X, y, sample_weight=sw.astype(
                               float))
    gr = port.GridSearchCV(sklm.Ridge(), grid,
                           cv=[(rep(idx[:n // 2]), rep(idx[n // 2:]))],
                           refit=False, config=CPU).fit(
        np.repeat(X, sw, axis=0), np.repeat(y, sw))
    np.testing.assert_allclose(gw.cv_results_["mean_test_score"],
                               gr.cv_results_["mean_test_score"], rtol=1e-6)


@pytest.mark.parametrize("scoring", [["neg_mean_squared_error",
                                      "neg_max_error"], "neg_max_error"])
def test_max_error_scores_unweighted(scoring):
    """sklearn forwards sample_weight scorer by scorer and max_error takes
    none: it scores unweighted in a weighted search, with a warning,
    while the other metrics take the weights (test_routing.py:104-123)."""
    X, y = _regression(seed=3, n=60, d=5)
    sw = np.random.default_rng(3).uniform(1.0, 5.0, len(y))
    kw = dict(cv=3, scoring=scoring, refit=False)
    with pytest.warns(UserWarning, match="does not support sample_weight"):
        got = port.GridSearchCV(sklm.Ridge(), {"alpha": [1.0]}, config=CPU,
                                **kw).fit(X, y, sample_weight=sw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = SkGridSearchCV(sklm.Ridge(), {"alpha": [1.0]}, **kw).fit(
            X, y, sample_weight=sw)
    for key in got.cv_results_:
        if key.startswith("mean_test"):
            np.testing.assert_allclose(got.cv_results_[key],
                                       sk.cv_results_[key], rtol=1e-5)
    unweighted = port.GridSearchCV(sklm.Ridge(), {"alpha": [1.0]},
                                   config=CPU, **kw).fit(X, y)
    key = ("mean_test_neg_max_error" if isinstance(scoring, list)
           else "mean_test_score")
    # the fits are weighted, the max error is not: it moves with the fit
    assert got.cv_results_[key] != unweighted.cv_results_[key]


def test_groups_reach_the_splitter():
    """`groups` goes to `cv.split(X, y, groups)`: GroupKFold's folds, and
    its n_splits_, as the JAX package's search (test_routing.py:187)."""
    X, y = _classes(n=120)
    groups = np.arange(len(y)) % 4
    cv = GroupKFold(n_splits=4)
    grid = {"C": [0.1, 1.0]}
    got = port.GridSearchCV(sklm.LogisticRegression(max_iter=100), grid,
                            cv=cv, refit=False, config=CPU).fit(
        X, y, groups=groups)
    ref = sst.GridSearchCV(sklm.LogisticRegression(max_iter=100), grid,
                           cv=cv, refit=False, backend="tpu").fit(
        X, y, groups=groups)
    assert got.n_splits_ == ref.n_splits_ == 4
    for key in ("mean_test_score", "split0_test_score", "split3_test_score"):
        np.testing.assert_allclose(got.cv_results_[key],
                                   ref.cv_results_[key], atol=5e-3)
    with pytest.raises(ValueError, match="groups"):
        port.GridSearchCV(sklm.LogisticRegression(), grid, cv=cv,
                          config=CPU).fit(X, y)


@pytest.mark.parametrize("case", ["other_param", "knn", "lda", "pipeline",
                                  "balanced_zero", "balanced_zero_in_grid",
                                  "shape"])
def test_refusals(case):
    """Where the reference leaves its compiled path (grid.py:603-633,
    :1001-1011) the port's device tier refuses as the reference's does
    with backend="tpu", and backend=None runs the search on the host
    tier, warning once, with the reference's host results: a fit
    parameter other than sample_weight, sample_weight with a family that
    takes none (KNN, LDA, Pipelines: sklearn's fit then refuses it, and
    every fit fails on both hosts), class_weight="balanced" with a zero
    weight, on the estimator or in the grid.  A weight vector of the
    wrong length is the reference's ValueError."""
    X, y = _classes(n=90)
    sw = _weights(len(y))
    est, grid, kw = sklm.LogisticRegression(), {"C": [1.0]}, {
        "sample_weight": sw}
    if case == "other_param":
        kw = {"sample_weight": sw, "extra": np.ones(len(y))}
    elif case == "knn":
        est, grid = skn.KNeighborsClassifier(), {"n_neighbors": [3]}
    elif case == "lda":
        est, grid = skda.LinearDiscriminantAnalysis(solver="lsqr"), {
            "shrinkage": [0.1]}
    elif case == "pipeline":
        est = SkPipeline([("s", SkStandardScaler()),
                          ("lr", sklm.LogisticRegression())])
        grid = {"lr__C": [1.0]}
    elif case == "balanced_zero":
        est = sklm.LogisticRegression(class_weight="balanced")
        kw = {"sample_weight": np.where(np.arange(len(y)) % 7, sw, 0.0)}
    elif case == "balanced_zero_in_grid":
        grid = {"class_weight": [None, "balanced"]}
        kw = {"sample_weight": np.where(np.arange(len(y)) % 7, sw, 0.0)}
    elif case == "shape":
        kw = {"sample_weight": sw[:-1]}
    search = port.GridSearchCV(est, grid, cv=3, config=CPU)
    if case == "shape":
        with pytest.raises(ValueError, match=r"sample_weight has shape "
                                             r"\(89,\), expected \(90,\)"):
            search.fit(X, y, **kw)
        return
    refused = "not supported on the compiled|is not compiled"
    with pytest.raises(ValueError, match=refused):
        port.GridSearchCV(est, grid, cv=3, backend="device",
                          config=CPU).fit(X, y, **kw)
    # the reference refuses the same on its compiled path
    with pytest.raises(ValueError, match=refused):
        sst.GridSearchCV(est, grid, cv=3, backend="tpu").fit(X, y, **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if case in ("other_param", "knn", "lda", "pipeline"):
            with pytest.raises(ValueError, match="fits failed"):
                search.fit(X, y, **kw)
        else:
            search.fit(X, y, **kw)
    host = [w for w in caught if "host tier" in str(w.message)]
    assert len(host) == 1, [str(w.message) for w in caught]
    if case in ("other_param", "knn", "lda", "pipeline"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="fits failed"):
                sst.GridSearchCV(est, grid, cv=3, backend="host").fit(
                    X, y, **kw)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(est, grid, cv=3, backend="host").fit(
            X, y, **kw)
    for key in ("mean_test_score", "split0_test_score", "rank_test_score"):
        np.testing.assert_array_equal(search.cv_results_[key],
                                      ref.cv_results_[key])


def test_pipeline_family_takes_no_sample_weight():
    """The reference's PipelineFamily sets accepts_sample_weight False
    (models/pipeline.py:31, :252): so does the port's, for both its
    pipeline families.  A weighted pipeline search is refused on the
    device tier, and on the host tier the Pipeline's fit refuses the
    bare sample_weight, as sklearn's does: every fit fails."""
    from spark_sklearn_tpu_torch.models.base import resolve_family

    for final in (sklm.LogisticRegression(),
                  ske.RandomForestClassifier(n_estimators=2)):
        fam = resolve_family(SkPipeline([("s", SkStandardScaler()),
                                         ("f", final)]))
        assert fam.accepts_sample_weight is False
    X, y = _classes(n=60)
    pipe = port.Pipeline([("s", port.StandardScaler()),
                          ("lr", port.LogisticRegression())])
    with pytest.raises(ValueError, match="sample_weight"):
        port.GridSearchCV(pipe, {"lr__C": [1.0]}, cv=3, backend="device",
                          config=CPU).fit(X, y, sample_weight=np.ones(len(y)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="fits failed"):
            port.GridSearchCV(pipe, {"lr__C": [1.0]}, cv=3,
                              scoring="accuracy", config=CPU).fit(
                X, y, sample_weight=np.ones(len(y)))


def _lines(text):
    # the task's time is the host's: compare everything else
    return [re.sub(r"total time=.*$", "total time=", ln)
            for ln in text.splitlines() if ln.startswith(("Fitting", "[CV"))]


@pytest.mark.parametrize("verbose", [0, 1, 2, 3])
@pytest.mark.parametrize("scoring,train", [(None, False),
                                           (["accuracy", "f1_macro"], True)])
def test_verbose_lines_match_jax(capsys, verbose, scoring, train):
    """sklearn's lines: "Fitting ..." at verbose > 0 (grid.py:762), a
    "[CV] END" line a task at > 1, with its fold and scores at > 2
    (grid.py:4237-4287), the JAX package's byte for byte but for each
    task's time."""
    X, y = _classes(n=90)
    kw = dict(cv=3, verbose=verbose, scoring=scoring,
              refit="accuracy" if scoring else True,
              return_train_score=train)
    grid = {"C": [0.1, 1.0]}
    sst.GridSearchCV(sklm.LogisticRegression(max_iter=50), grid,
                     backend="tpu", **kw).fit(X, y)
    ref = _lines(capsys.readouterr().out)
    port.GridSearchCV(sklm.LogisticRegression(max_iter=50), grid,
                      config=CPU, **kw).fit(X, y)
    got = _lines(capsys.readouterr().out)
    assert got == ref
    assert len(got) == (0 if verbose == 0 else 1 if verbose == 1 else 7)
    if verbose > 2:
        assert re.search(r"score=|accuracy: \(", got[1])


def _refit_pair(scoring=None):
    X, y = _classes(n=150)
    sw = _weights(len(y))
    grid = {"C": [0.1, 1.0]}
    got = port.GridSearchCV(port.LogisticRegression(device="cpu"), grid,
                            cv=3, scoring=scoring,
                            refit="accuracy" if scoring else True,
                            config=CPU).fit(X, y, sample_weight=sw)
    ref = sst.GridSearchCV(sklm.LogisticRegression(), grid, cv=3,
                           scoring=scoring,
                           refit="accuracy" if scoring else True,
                           backend="tpu").fit(X, y, sample_weight=sw)
    return got, ref, X, y, sw


def test_refit_surface_matches_reference():
    """After a weighted refit: classes_, n_features_in_, scorer_, score,
    decision_function and predict_log_proba as the reference's search
    gives them (its refit is sklearn's LogisticRegression, the port's its
    own: decisions atol 2e-2, probabilities' logs atol 2e-2, scores
    within 0.02); the refit took the weights."""
    got, ref, X, y, sw = _refit_pair()
    np.testing.assert_array_equal(got.classes_, ref.classes_)
    assert got.n_features_in_ == ref.n_features_in_ == X.shape[1]
    assert callable(got.scorer_)
    assert got.score(X, y) == pytest.approx(got.scorer_(
        got.best_estimator_, X, y))
    assert got.score(X, y) == pytest.approx(
        float(np.mean(got.predict(X) == y)))
    assert abs(got.score(X, y) - ref.score(X, y)) <= 0.02
    np.testing.assert_allclose(got.decision_function(X[:20]),
                               ref.decision_function(X[:20]), atol=2e-2)
    np.testing.assert_allclose(got.predict_log_proba(X[:20]),
                               ref.predict_log_proba(X[:20]), atol=2e-2)
    np.testing.assert_allclose(np.exp(got.predict_log_proba(X[:20])),
                               got.predict_proba(X[:20]), rtol=1e-6)
    # the refit is the weighted fit of the best parameters
    own = port.LogisticRegression(device="cpu", **got.best_params_).fit(
        X, y, sample_weight=sw)
    np.testing.assert_array_equal(own.coef_, got.best_estimator_.coef_)
    assert got.scorer_(got.best_estimator_, X, y, sample_weight=sw) == \
        pytest.approx(float(np.average(got.predict(X) == y, weights=sw)))


def test_refit_surface_multimetric_and_missing_methods():
    """A list of metrics: scorer_ a dict of them, score the refit
    metric's; methods the refit estimator lacks raise AttributeError
    (hasattr False) as sklearn's available_if; refit=False makes every
    delegated method and score an AttributeError; an unfitted search's
    method raises sklearn's NotFittedError."""
    got, ref, X, y, _ = _refit_pair(["accuracy", "neg_log_loss"])
    assert set(got.scorer_) == {"accuracy", "neg_log_loss"}
    assert got.score(X, y) == pytest.approx(ref.score(X, y), abs=0.02)
    assert got.scorer_["neg_log_loss"](got.best_estimator_, X, y) == \
        pytest.approx(ref.scorer_["neg_log_loss"](ref.best_estimator_, X,
                                                  y), abs=0.02)
    for name in ("transform", "inverse_transform", "score_samples"):
        assert not hasattr(got, name) and not hasattr(ref, name)
    assert hasattr(got, "decision_function")
    off = port.GridSearchCV(port.LogisticRegression(device="cpu"),
                            {"C": [1.0]}, cv=3, refit=False,
                            config=CPU).fit(X, y)
    for name in ("predict", "decision_function", "score"):
        with pytest.raises(AttributeError, match="refit=False"):
            getattr(off, name)(X) if name != "score" else off.score(X, y)
    fresh = port.GridSearchCV(port.LogisticRegression(device="cpu"),
                              {"C": [1.0]}, config=CPU)
    with pytest.raises(port.search.grid.NotFittedError, match="not fitted"):
        fresh.predict(X)


@pytest.mark.parametrize("est", [port.SVC(probability=True, device="cpu"),
                                 port.SVR(device="cpu"),
                                 port.GaussianNB(device="cpu"),
                                 port.MLPClassifier(hidden_layer_sizes=(4,),
                                                    max_iter=5,
                                                    device="cpu")],
                         ids=["svc", "svr", "gaussian_nb", "mlp"])
def test_port_estimators_take_sample_weight(est):
    """The port's own estimators that a weighted search refits take
    sample_weight in fit: all-ones weights give the unweighted fit, other
    weights another; predict_log_proba is the log of predict_proba."""
    X, y = (_regression if isinstance(est, port.SVR) else _classes)(n=80)
    ones = est.clone().fit(X, y, sample_weight=np.ones(len(y)))
    plain = est.clone().fit(X, y)
    skewed = est.clone().fit(X, y, sample_weight=_weights(len(y)))
    out = (lambda e: e.predict_proba(X)) if hasattr(est, "predict_proba") \
        else (lambda e: e.predict(X))
    np.testing.assert_allclose(out(ones), out(plain), rtol=1e-5, atol=1e-6)
    assert not np.allclose(out(skewed), out(plain), rtol=0, atol=1e-6)
    if hasattr(est, "predict_proba"):
        np.testing.assert_allclose(np.exp(plain.predict_log_proba(X)),
                                   plain.predict_proba(X), rtol=1e-5)
