"""The port's LinearDiscriminantAnalysis (solver="lsqr") against the JAX
package's on the CPU: the fitted coef and intercept against `jax.vmap`
of the JAX `fit` over (shrinkage x fold) lanes, the minimum-norm solve
on a singular covariance (constant columns at shrinkage 0) against
`np.linalg.lstsq` in float64, the searches' `cv_results_` against the
JAX search's, models carried by `lda_from_jax`, and the holder against
sklearn.

Tolerances: coef and intercept atol 5e-5 relative to their largest
magnitude (float32 SVDs by two LAPACK paths); the minimum-norm solve
rtol 1e-4 against float64, its dropped directions within 1e-4 of the
largest coefficient of zero (a constant column's class means round in
float32); mean accuracy atol 1e-5, mean neg_log_loss and roc_auc atol
1e-4 (at shrinkage 0 the covariance of digits is singular and the two
SVDs round its kept directions differently); predictions equal."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.discriminant_analysis import (
    LinearDiscriminantAnalysis as SkLDA,
)
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import discriminant as jdis
from spark_sklearn_tpu_torch.convert.params import lda_from_jax
from spark_sklearn_tpu_torch.models import discriminant as pdis
from spark_sklearn_tpu_torch.parallel.taskgrid import build_fold_masks

CPU = port.TorchConfig(device="cpu")
N_FOLDS = 3
LSQR = {"solver": "lsqr"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, n=210, d=8, k=3, constant=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = (rng.normal(size=(n, d)) + y[:, None] * np.linspace(0.5, 1.5, d)
         ).astype(np.float32)
    if constant:
        X[:, 2] = 0.0
        X[:, 5] = 1.25
    return X, y


def _fit_both(X, y, shrinkages, static):
    jfam, pfam = jdis.LinearDiscriminantFamily, pdis.LinearDiscriminantFamily
    splits = list(SkStratifiedKFold(N_FOLDS).split(X, y))
    train, _ = build_fold_masks(splits, len(y))
    w = np.tile(train, (len(shrinkages), 1))
    s = np.repeat(np.asarray(shrinkages, np.float32), N_FOLDS)
    data, meta = jfam.prepare_data(X, y)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    ref = jax.vmap(lambda sh, wt: jfam.fit({"shrinkage": sh}, static, jd,
                                           wt, meta))(
        jnp.asarray(s), jnp.asarray(w))
    pdata, pmeta = pfam.prepare_data(X, y)
    got = pfam.fit_task_batched(
        {"shrinkage": torch.as_tensor(s)}, {**static, "__n_folds__": N_FOLDS},
        {k: torch.as_tensor(v) for k, v in pdata.items()},
        torch.as_tensor(w), pmeta)
    return {k: np.asarray(v) for k, v in ref.items()}, got, w


@pytest.mark.parametrize("k,static", [
    (3, LSQR), (2, LSQR), (4, {**LSQR, "priors": [0.1, 0.2, 0.3, 0.4]}),
])
def test_fit_matches_jax(k, static):
    X, y = _data(k=k)
    ref, got, _ = _fit_both(X, y, [0.0, 0.1, 0.5, 0.9], static)
    for key in ("coef", "intercept"):
        scale = np.abs(ref[key]).max()
        np.testing.assert_allclose(got[key].numpy(), ref[key],
                                   atol=5e-5 * scale, err_msg=key)


def test_min_norm_solve_on_singular_covariance():
    """shrinkage 0 with two constant columns: the covariance has two
    zero rows and columns, and the solve is the minimum-norm one (zero
    coefficients there, up to the rounding of those columns' float32
    class means), as jnp.linalg.lstsq and np.linalg.lstsq give."""
    X, y = _data(constant=True)
    ref, got, w = _fit_both(X, y, [0.0], LSQR)
    coef = got["coef"].numpy()
    scale = np.abs(ref["coef"]).max()
    assert np.abs(coef[:, :, [2, 5]]).max() <= 1e-4 * scale
    np.testing.assert_allclose(coef, ref["coef"], atol=5e-5 * scale)
    # float64 reference of lane 0 (fold 0)
    m = w[0] > 0
    Xf, yf = X[m].astype(np.float64), y[m]
    classes = np.unique(yf)
    means = np.stack([Xf[yf == c].mean(0) for c in classes])
    pri = np.array([(yf == c).mean() for c in classes])
    cov = sum(p * np.cov(Xf[yf == c].T, bias=True)
              for p, c in zip(pri, classes))
    want = np.linalg.lstsq(cov, means.T, rcond=None)[0].T
    np.testing.assert_allclose(coef[0], want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("binary", [False, True])
def test_search_matches_jax(digits, binary):
    X, y = digits
    X, y = X[:360], y[:360]
    if binary:
        X, y = X[y < 2], y[y < 2]
    grid = {"shrinkage": [0.0, 0.01, 0.1, 0.5, 0.9]}
    scoring = ["accuracy", "neg_log_loss"] + (["roc_auc"] if binary else [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = sst.GridSearchCV(SkLDA(solver="lsqr"), grid, cv=N_FOLDS,
                               scoring=scoring, refit=False,
                               backend="tpu").fit(X, y)
    got = port.GridSearchCV(port.LinearDiscriminantAnalysis(solver="lsqr"),
                            grid, cv=N_FOLDS, scoring=scoring, refit=False,
                            config=CPU).fit(X, y)
    for s in scoring:
        np.testing.assert_allclose(got.cv_results_[f"mean_test_{s}"],
                                   ref.cv_results_[f"mean_test_{s}"],
                                   atol=1e-5 if s == "accuracy" else 1e-4,
                                   err_msg=s)


def test_lda_from_jax_and_holder():
    X, y = _data(seed=2)
    fam = jdis.LinearDiscriminantFamily
    data, meta = fam.prepare_data(X, y)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    model = fam.fit({"shrinkage": 0.2}, LSQR, jd,
                    jnp.ones(len(y), jnp.float32), meta)
    carried = lda_from_jax({k: np.asarray(v) for k, v in model.items()},
                           device="cpu")
    Xt = torch.as_tensor(X)
    np.testing.assert_allclose(
        pdis.LinearDiscriminantFamily.predict_proba(
            carried, LSQR, Xt, meta).numpy(),
        np.asarray(fam.predict_proba(model, LSQR, jd["X"], meta)),
        atol=1e-5)
    est = port.LinearDiscriminantAnalysis(solver="lsqr", shrinkage=0.2,
                                          device="cpu").fit(X, y)
    sk = SkLDA(solver="lsqr", shrinkage=0.2).fit(X, y)
    np.testing.assert_array_equal(est.predict(X), sk.predict(X))
    np.testing.assert_allclose(est.predict_proba(X), sk.predict_proba(X),
                               atol=1e-4)


def test_unported_options_raise():
    X, y = _data()
    with pytest.raises(ValueError, match="lsqr only"):
        port.LinearDiscriminantAnalysis(device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="Ledoit-Wolf"):
        port.LinearDiscriminantAnalysis(solver="lsqr", shrinkage="auto",
                                        device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="non-negative"):
        port.GridSearchCV(
            port.LinearDiscriminantAnalysis(solver="lsqr",
                                            priors=[-0.1, 0.6, 0.5]),
            {"shrinkage": [0.1]}, config=CPU).fit(X, y)
    with pytest.warns(UserWarning, match="Renormalizing"):
        port.LinearDiscriminantAnalysis(
            solver="lsqr", priors=[0.2, 0.2, 0.2], device="cpu").fit(X, y)
