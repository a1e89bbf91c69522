"""The port's naive Bayes families against the JAX package's on the CPU:
the fitted models and views against `jax.vmap` of the JAX `fit` over
(candidate x fold) lanes, the searches' `cv_results_` against the JAX
search's, models carried across by `nb_from_jax`, B1's plain version
against a direct float64 evaluation, and GaussianNB's `neg_log_loss`
against sklearn's.

Tolerances: fitted leaves and joint log-likelihoods atol 1e-5 and rtol
1e-5 (float32, sums in another order); probabilities atol 1e-5;
predictions equal; mean_test_score atol 1e-5 (accuracy exactly equal on
these data); GaussianNB's neg_log_loss within 1e-4 of sklearn's (the
reference test's bound, `tests/test_naive_bayes.py:41`)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import naive_bayes as snb
from sklearn.model_selection import GridSearchCV as SkGridSearchCV
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import naive_bayes as jnb
from spark_sklearn_tpu_torch.convert.params import nb_from_jax
from spark_sklearn_tpu_torch.models import naive_bayes as pnb
from spark_sklearn_tpu_torch.ops import nb_kernels
from spark_sklearn_tpu_torch.parallel.taskgrid import build_fold_masks

CPU = port.TorchConfig(device="cpu")
N_FOLDS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, n=150, d=6, k=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    Xg = (rng.normal(size=(n, d)) + y[:, None]).astype(np.float32)
    Xc = (rng.integers(0, 5, (n, d)) + (y[:, None] == np.arange(d) % k)
          ).astype(np.float32)
    return Xg, Xc, y


FAMILIES = [
    ("GaussianNBFamily", "g", {"var_smoothing": [1e-9, 1e-3]}, {}),
    ("GaussianNBFamily", "g", {"var_smoothing": [1e-9]},
     {"priors": [0.2, 0.5, 0.3]}),
    ("MultinomialNBFamily", "c", {"alpha": [0.1, 1.0]}, {}),
    ("MultinomialNBFamily", "c", {"alpha": [0.5]},
     {"fit_prior": False}),
    ("ComplementNBFamily", "c", {"alpha": [0.1, 1.0]}, {}),
    ("ComplementNBFamily", "c", {"alpha": [0.1]}, {"norm": True}),
    ("BernoulliNBFamily", "g", {"alpha": [0.1, 1.0]}, {"binarize": 0.5}),
    ("BernoulliNBFamily", "c", {"alpha": [1.0]},
     {"binarize": 2.0, "class_prior": [0.3, 0.3, 0.4]}),
    ("CategoricalNBFamily", "c", {"alpha": [0.1, 1.0]}, {}),
]


def _fit_both(name, X, y, dyn, static):
    jfam, pfam = getattr(jnb, name), getattr(pnb, name)
    splits = list(SkStratifiedKFold(N_FOLDS).split(X, y))
    train, test = build_fold_masks(splits, len(y))
    n_cand = len(next(iter(dyn.values())))
    w = np.tile(train, (n_cand, 1))
    lanes = {k: np.repeat(np.asarray(v, np.float32), N_FOLDS)
             for k, v in dyn.items()}
    data, meta = jfam.prepare_data(X, y)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    ref = jax.vmap(lambda d, wt: jfam.fit(d, static, jd, wt, meta))(
        {k: jnp.asarray(v) for k, v in lanes.items()}, jnp.asarray(w))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    pdata, pmeta = pfam.prepare_data(X, y)
    td = {k: torch.as_tensor(v) for k, v in pdata.items()}
    got = pfam.fit_task_batched(
        {k: torch.as_tensor(v) for k, v in lanes.items()},
        {**static, "__n_folds__": N_FOLDS}, td, torch.as_tensor(w), pmeta)
    return jfam, pfam, jd, td, ref, got, meta


@pytest.mark.parametrize("name,xkind,dyn,static", FAMILIES)
def test_fit_and_views_match_jax(name, xkind, dyn, static):
    Xg, Xc, y = _data()
    X = Xg if xkind == "g" else Xc
    jfam, pfam, jd, td, ref, got, meta = _fit_both(name, X, y, dyn, static)
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    views = pfam.views_task_batched(got, static, td, meta,
                                    {"pred", "proba", "decision"})
    one = (jfam.predict, jfam.predict_proba, jfam.decision)
    want = [np.asarray(jax.vmap(lambda m: f(m, static, jd["X"], meta))(
        {k: jnp.asarray(v) for k, v in ref.items()})) for f in one]
    np.testing.assert_array_equal(views["pred"].numpy(), want[0])
    np.testing.assert_allclose(views["proba"].numpy(), want[1], atol=1e-5)
    np.testing.assert_allclose(views["decision"].numpy(), want[2],
                               rtol=1e-5, atol=1e-4)


def test_gnb_jll_plain_matches_float64_direct_form():
    """B1's plain version (row blocks) against a float64 evaluation of
    sklearn's direct form, at a shape that takes several row blocks."""
    rng = np.random.default_rng(1)
    B, k, d, m = 3, 4, 20, 700
    X = rng.normal(size=(m, d)).astype(np.float32)
    theta = rng.normal(size=(B, k, d)).astype(np.float32)
    var = rng.uniform(1e-3, 2.0, (B, k, d)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(k), B)).astype(np.float32)
    old = nb_kernels.PLAIN_ELEMS
    try:
        nb_kernels.PLAIN_ELEMS = 4096                 # 17 rows a block
        got = nb_kernels.gnb_jll(*(torch.as_tensor(a) for a in
                                   (X, theta, var, lp)))
    finally:
        nb_kernels.PLAIN_ELEMS = old
    X64, t64, v64 = X.astype(np.float64), theta.astype(np.float64), \
        var.astype(np.float64)
    ll = -0.5 * np.log(2 * np.pi * v64).sum(axis=2)
    q = 0.5 * (((X64[None, :, None, :] - t64[:, None]) ** 2)
               / v64[:, None]).sum(axis=3)
    want = lp[:, None, :] + ll[:, None, :] - q
    assert got.shape == (B, m, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def _search_both(jest, pest, grid, X, y, scoring, cv=N_FOLDS):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(jest, grid, cv=cv, scoring=scoring,
                               refit=False, backend="tpu").fit(X, y)
    got = port.GridSearchCV(pest, grid, cv=cv, scoring=scoring,
                            refit=False, config=CPU).fit(X, y)
    return ref.cv_results_, got.cv_results_


@pytest.mark.parametrize("cls,kw,xkind", [
    ("MultinomialNB", {}, "c"),
    ("ComplementNB", {"norm": True}, "c"),
    ("BernoulliNB", {"binarize": 0.3}, "g"),
    ("CategoricalNB", {"min_categories": 6}, "c"),
])
def test_searches_match_jax(digits, cls, kw, xkind):
    X, y = digits
    X, y = X[:300], y[:300]
    if xkind == "c":
        X = np.round(X * 4)
        if cls == "CategoricalNB":
            X = X.astype(np.int64)
    scoring = (["accuracy", "neg_log_loss"] if cls != "CategoricalNB"
               else None)
    ref, got = _search_both(getattr(snb, cls)(**kw),
                            getattr(port, cls)(**kw),
                            {"alpha": [0.01, 0.1, 1.0]}, X, y, scoring)
    keys = [k for k in ref if k.startswith("mean_test")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("priors", [None, [0.5, 0.3, 0.2]])
def test_gaussian_nb_neg_log_loss_matches_sklearn(digits, priors):
    """The subset of `tests/test_naive_bayes.py::TestGaussianNB::
    test_proba_scoring_and_priors`, with and without priors: the port
    clips at float32's eps, as sklearn's float32 probabilities do."""
    X, y = digits
    m = y < 3
    Xs, ys = X[m][:240], y[m][:240]
    grid = {"var_smoothing": [1e-9, 1e-6]}
    kw = {} if priors is None else {"priors": priors}
    sk = SkGridSearchCV(snb.GaussianNB(**kw), grid, cv=3,
                        scoring="neg_log_loss").fit(Xs, ys)
    got = port.GridSearchCV(port.GaussianNB(**kw), grid, cv=3,
                            scoring="neg_log_loss", config=CPU).fit(Xs, ys)
    diff = np.abs(got.cv_results_["mean_test_score"]
                  - sk.cv_results_["mean_test_score"]).max()
    assert diff < 1e-4
    assert got.best_params_ == sk.best_params_


def test_jax_package_gaussian_nb_log_loss_clips_at_float64_eps(digits):
    """Records the reference's deviation, which the port does not copy:
    its GaussianNB family sets no `proba_dtype_rule`, so its search clips
    the float32 probabilities at float64's eps (2.2e-16) where sklearn
    clips at float32's (1.2e-7); on this subset the mean scores differ
    from sklearn's by more than 1, while the accuracies agree."""
    X, y = digits
    m = y < 3
    Xs, ys = X[m][:240], y[m][:240]
    grid = {"var_smoothing": [1e-9, 1e-6]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(snb.GaussianNB(), grid, cv=3,
                               scoring=["neg_log_loss", "accuracy"],
                               refit=False, backend="tpu").fit(Xs, ys)
    got = port.GridSearchCV(port.GaussianNB(), grid, cv=3,
                            scoring=["neg_log_loss", "accuracy"],
                            refit=False, config=CPU).fit(Xs, ys)
    assert not getattr(jnb.GaussianNBFamily, "proba_dtype_rule", None)
    assert pnb.GaussianNBFamily.proba_dtype_rule == "input"
    gap = np.abs(ref.cv_results_["mean_test_neg_log_loss"]
                 - got.cv_results_["mean_test_neg_log_loss"]).min()
    assert gap > 1.0
    np.testing.assert_array_equal(ref.cv_results_["mean_test_accuracy"],
                                  got.cv_results_["mean_test_accuracy"])


@pytest.mark.parametrize("name,xkind,static", [
    ("GaussianNBFamily", "g", {}),
    ("BernoulliNBFamily", "g", {"binarize": 0.5}),
    ("CategoricalNBFamily", "c", {}),
])
def test_nb_from_jax_scores_the_same_model(name, xkind, static):
    Xg, Xc, y = _data(seed=3)
    X = Xg if xkind == "g" else Xc
    jfam, pfam = getattr(jnb, name), getattr(pnb, name)
    data, meta = jfam.prepare_data(X, y)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    model = jfam.fit({}, static, jd, jnp.ones(len(y), jnp.float32), meta)
    carried = nb_from_jax({k: np.asarray(v) for k, v in model.items()},
                          device="cpu")
    Xt = torch.as_tensor(data["X"])
    np.testing.assert_allclose(
        pfam.predict_proba(carried, static, Xt, meta).numpy(),
        np.asarray(jfam.predict_proba(model, static, jd["X"], meta)),
        atol=1e-5)
    np.testing.assert_array_equal(
        pfam.predict(carried, static, Xt, meta).numpy(),
        np.asarray(jfam.predict(model, static, jd["X"], meta)))


def test_categorical_padding_and_check_predict_x():
    rng = np.random.default_rng(0)
    X = np.stack([rng.integers(0, 3, 90), rng.integers(0, 6, 90)], 1)
    y = rng.integers(0, 2, 90)
    data, meta = pnb.CategoricalNBFamily.prepare_data(X, y)
    np.testing.assert_array_equal(meta["n_categories"], [3, 6])
    pnb.CategoricalNBFamily.observe_candidates(
        [], {"min_categories": np.array([5, 2])}, meta)
    np.testing.assert_array_equal(meta["n_categories"], [5, 6])
    est = port.CategoricalNB(min_categories=np.array([5, 2]),
                             device="cpu").fit(X, y)
    assert [a.shape for a in est.feature_log_prob_] == [(2, 5), (2, 6)]
    ref = snb.CategoricalNB(min_categories=np.array([5, 2])).fit(X, y)
    for a, b in zip(est.feature_log_prob_, ref.feature_log_prob_):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_array_equal(est.predict(X), ref.predict(X))
    with pytest.raises(IndexError, match="out of bounds for feature 1"):
        est.predict(np.array([[0, 6]]))
    with pytest.raises(ValueError, match="should have shape"):
        pnb.CategoricalNBFamily.observe_candidates(
            [], {"min_categories": np.array([1, 2, 3])}, dict(meta))
    with pytest.raises(ValueError, match="integral type"):
        pnb.CategoricalNBFamily.observe_candidates(
            [], {"min_categories": 2.5}, dict(meta))


def test_host_checks_raise_sklearn_messages():
    Xg, Xc, y = _data()
    with pytest.raises(ValueError, match="must match number of classes"):
        port.GridSearchCV(port.GaussianNB(priors=[0.5, 0.5]),
                          {"var_smoothing": [1e-9]}, config=CPU).fit(Xg, y)
    with pytest.raises(ValueError, match="sum of the priors should be 1"):
        port.GaussianNB(priors=[0.5, 0.3, 0.3], device="cpu").fit(Xg, y)
    with pytest.raises(ValueError, match="Negative values in data passed "
                                         "to MultinomialNB"):
        port.MultinomialNB(device="cpu").fit(Xg, y)
    with pytest.raises(ValueError, match="contains NaN"):
        bad = Xc.copy()
        bad[0, 0] = np.nan
        port.BernoulliNB(device="cpu").fit(bad, y)


@pytest.mark.parametrize("cls,kw,xkind", [
    ("GaussianNB", {}, "g"), ("MultinomialNB", {"alpha": 0.3}, "c"),
    ("ComplementNB", {}, "c"), ("BernoulliNB", {"binarize": 0.5}, "g"),
])
def test_holders_match_sklearn(cls, kw, xkind):
    Xg, Xc, y = _data(seed=5)
    X = Xg if xkind == "g" else Xc
    est = getattr(port, cls)(device="cpu", **kw).fit(X, y)
    ref = getattr(snb, cls)(**kw).fit(X, y)
    np.testing.assert_array_equal(est.predict(X), ref.predict(X))
    np.testing.assert_allclose(est.predict_proba(X), ref.predict_proba(X),
                               atol=1e-5)
