"""The port's KNeighborsClassifier/Regressor against the JAX package's on
the CPU: N1's plain version (the fold-masked top-k) against the JAX
`_fold_neighbors` on the same distances, with ties, duplicates and a
fold shorter than max_k; the families' `fit_task_batched` and searches
against the JAX ones; the grid's n_neighbors against the smallest train
fold; and the holders' predictions on new X against sklearn's.

Tolerances: neighbor indices and uniform votes equal; distance-weighted
votes atol 1e-5 on the rows outside a lane's train fold (a train row's
own distance is a rounding residue of sq + sq - 2 x.x, whose inverse
weight differs between two GEMMs); mean_test_score atol 1e-5;
predictions equal, regression atol 1e-4."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import neighbors as skn
from sklearn.model_selection import KFold as SkKFold
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import neighbors as jnn
from spark_sklearn_tpu_torch.models import neighbors as pnn
from spark_sklearn_tpu_torch.ops import knn_kernels as kk
from spark_sklearn_tpu_torch.parallel.taskgrid import build_fold_masks

CPU = port.TorchConfig(device="cpu")
N_FOLDS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, n=120, d=5, k=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = (rng.normal(size=(n, d)) + y[:, None]).astype(np.float32)
    return X, y


def _topk_both(X, masks, maxk):
    Xt = torch.as_tensor(X)
    G = Xt @ Xt.T
    sq = (Xt * Xt).sum(dim=1)
    d2, idx = kk.knn_fold_topk(G, sq, sq, torch.as_tensor(masks), maxk)
    D = jnp.asarray(kk.sq_dists(G, sq, sq).numpy())
    ref = [jnn._fold_neighbors(D, jnp.asarray(m), maxk) for m in masks]
    return d2.numpy(), idx.numpy(), ref


def test_fold_topk_matches_jax_top_k():
    X, y = _data()
    splits = list(SkStratifiedKFold(N_FOLDS).split(X, y))
    train, _ = build_fold_masks(splits, len(y))
    d2, idx, ref = _topk_both(X, train, 9)
    assert d2.shape == idx.shape == (N_FOLDS, len(y), 9)
    assert idx.dtype == np.int32
    for f, (rd2, ridx, _) in enumerate(ref):
        np.testing.assert_array_equal(idx[f], np.asarray(ridx))
        np.testing.assert_array_equal(d2[f], np.asarray(rd2))
        assert np.all(train[f][idx[f]] > 0)           # train columns only


def test_fold_topk_ties_duplicates_and_short_folds():
    """Exact duplicates tie at equal distances and go to the lower column;
    a fold with 4 train columns and max_k 7 ends in +inf on the lowest
    masked columns, as lax.top_k leaves them."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 3, (10, 2)).astype(np.float32)
    X = np.concatenate([base, base, base[:4]])        # many exact ties
    masks = np.ones((2, len(X)), np.float32)
    masks[1] = 0.0
    masks[1, [3, 11, 17, 20]] = 1.0
    d2, idx, ref = _topk_both(X, masks, 7)
    for f, (rd2, ridx, _) in enumerate(ref):
        np.testing.assert_array_equal(idx[f], np.asarray(ridx))
        np.testing.assert_array_equal(d2[f], np.asarray(rd2))
    assert np.isinf(d2[1][:, 4:]).all()
    np.testing.assert_array_equal(idx[1][0, 4:], [0, 1, 2])
    # in each row equal distances come in increasing column order
    same = d2[0][:, 1:] == d2[0][:, :-1]
    assert np.all(idx[0][:, 1:][same] > idx[0][:, :-1][same])


def test_fold_topk_new_rows_against_train():
    """m != n, one all-ones mask (the holder's predict): the neighbors of
    new rows among the training rows, against a stable numpy argsort."""
    X, _ = _data(seed=1)
    Xn = _data(seed=2, n=17)[0]
    G = torch.as_tensor(Xn) @ torch.as_tensor(X).T
    sq_r = (torch.as_tensor(Xn) ** 2).sum(dim=1)
    sq_c = (torch.as_tensor(X) ** 2).sum(dim=1)
    d2, idx = kk.knn_fold_topk(G, sq_r, sq_c, torch.ones((1, len(X))), 5)
    D = kk.sq_dists(G, sq_r, sq_c).numpy()
    want = np.argsort(D, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx[0].numpy(), want)
    np.testing.assert_array_equal(d2[0].numpy(),
                                  np.take_along_axis(D, want, 1))


def _fit_both(regressor, weights, ks=(1, 3, 7)):
    X, y = _data()
    if regressor:
        y = (2 * X[:, 0] + np.random.default_rng(0).normal(size=len(y))
             ).astype(np.float32)
    splitter = SkKFold(N_FOLDS) if regressor else SkStratifiedKFold(N_FOLDS)
    train, _ = build_fold_masks(list(splitter.split(X, y)), len(y))
    jfam = jnn.KNeighborsRegressorFamily if regressor else \
        jnn.KNeighborsClassifierFamily
    pfam = pnn.KNeighborsRegressorFamily if regressor else \
        pnn.KNeighborsClassifierFamily
    w = np.tile(train, (len(ks), 1))
    k_lanes = np.repeat(np.asarray(ks, np.int32), N_FOLDS)
    static = {"weights": weights, "__n_folds__": N_FOLDS}
    data, meta = jfam.prepare_data(X, y)
    meta["max_k"] = max(ks)
    ref = jfam.fit_task_batched(
        {"n_neighbors": jnp.asarray(k_lanes)}, static,
        {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(w), meta)
    pdata, pmeta = pfam.prepare_data(X, y)
    pmeta["max_k"] = max(ks)
    got = pfam.fit_task_batched(
        {"n_neighbors": torch.as_tensor(k_lanes)}, static,
        {k: torch.as_tensor(v) for k, v in pdata.items()},
        torch.as_tensor(w), pmeta)
    return {k: np.asarray(v) for k, v in ref.items()}, got, w


@pytest.mark.parametrize("regressor", [False, True])
@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_fit_task_batched_matches_jax(regressor, weights):
    ref, got, w = _fit_both(regressor, weights)
    key = "pred" if regressor else "proba"
    a, b = ref[key], got[key].numpy()
    assert a.shape == b.shape
    if weights == "uniform" and not regressor:
        np.testing.assert_array_equal(b, a)
    outside = w == 0                   # (lanes, n): rows out of the fold
    np.testing.assert_allclose(b[outside], a[outside], atol=1e-5)


@pytest.mark.parametrize("regressor", [False, True])
def test_search_matches_jax(digits, regressor):
    X, y = digits
    X, y = X[:300], y[:300]
    grid = {"n_neighbors": [1, 3, 5, 9], "weights": ["uniform", "distance"]}
    if regressor:
        y = (X[:, 20] * 3 + 0.1 * y).astype(np.float32)
        jest, pest, scoring = skn.KNeighborsRegressor(), \
            port.KNeighborsRegressor(), ["r2", "neg_mean_absolute_error"]
    else:
        jest, pest, scoring = skn.KNeighborsClassifier(), \
            port.KNeighborsClassifier(), ["accuracy", "neg_log_loss"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(jest, grid, cv=N_FOLDS, scoring=scoring,
                               refit=False, backend="tpu").fit(X, y)
    got = port.GridSearchCV(pest, grid, cv=N_FOLDS, scoring=scoring,
                            refit=False, config=CPU).fit(X, y)
    for s in scoring:
        np.testing.assert_allclose(got.cv_results_[f"mean_test_{s}"],
                                   ref.cv_results_[f"mean_test_{s}"],
                                   atol=1e-5, err_msg=s)


def test_n_neighbors_above_the_smallest_train_fold_raises():
    X, y = _data(n=12)
    with pytest.raises(ValueError, match="n_neighbors <= n_samples_fit"):
        port.GridSearchCV(port.KNeighborsClassifier(),
                          {"n_neighbors": [1, 9]}, cv=3,
                          config=CPU).fit(X, y)
    with pytest.raises(ValueError, match="not supported"):
        port.GridSearchCV(port.KNeighborsClassifier(metric="manhattan"),
                          {"n_neighbors": [1]}, cv=3, config=CPU).fit(X, y)


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_holders_predict_new_x_as_sklearn(weights):
    X, y = _data(seed=6)
    Xn = _data(seed=7, n=40)[0]
    est = port.KNeighborsClassifier(n_neighbors=4, weights=weights,
                                    device="cpu").fit(X, y)
    ref = skn.KNeighborsClassifier(n_neighbors=4, weights=weights).fit(X, y)
    np.testing.assert_array_equal(est.predict(Xn), ref.predict(Xn))
    np.testing.assert_allclose(est.predict_proba(Xn), ref.predict_proba(Xn),
                               atol=1e-5)
    yr = X[:, 0] * 2.0
    reg = port.KNeighborsRegressor(n_neighbors=4, weights=weights,
                                   device="cpu").fit(X, yr)
    sk = skn.KNeighborsRegressor(n_neighbors=4, weights=weights).fit(X, yr)
    np.testing.assert_allclose(reg.predict(Xn), sk.predict(Xn), atol=1e-4)
    with pytest.raises(ValueError, match="n_neighbors <= n_samples_fit"):
        port.KNeighborsClassifier(n_neighbors=500, device="cpu").fit(
            X, y).predict(Xn)
