"""The port's 17 scorer cores against the JAX package's on the same views:
each reference core runs per task under `jax.vmap`, the port's over the
task axis at once.  Tolerance rtol 1e-5 (atol 1e-6): the cores sum in
another order.  The inputs hold ties, a zero-weight fold, even-sized
folds (the weighted median's averaging case) and negative targets
(MSLE's NaN case); roc_auc is also held to sklearn on continuous
margins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from spark_sklearn_tpu.search import scorers as jsc
from spark_sklearn_tpu_torch.models.linear import (
    LogisticRegressionFamily,
    RidgeFamily,
)
from spark_sklearn_tpu_torch.search import scorers as psc

T, N = 7, 40

BINARY = ["accuracy", "neg_log_loss", "f1", "precision", "recall",
          "roc_auc", "f1_macro", "balanced_accuracy"]
MULTICLASS = ["accuracy", "neg_log_loss", "f1_macro", "balanced_accuracy"]
REGRESSION = ["r2", "explained_variance", "neg_mean_squared_error",
              "neg_root_mean_squared_error", "neg_mean_absolute_error",
              "neg_median_absolute_error", "neg_mean_squared_log_error",
              "max_error", "neg_max_error"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(rng):
    """Fold weights (T, N): random folds of even and odd size, one
    zero-weight fold, and one fold of all samples."""
    w = np.zeros((T, N))
    for t in range(T - 2):
        size = 20 if t % 2 == 0 else 17
        w[t, rng.choice(N, size, replace=False)] = 1.0
    w[T - 1] = 1.0                      # task T-2 keeps zero weight
    return w


def _classification(k, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, N).astype(np.int32)
    logits = rng.standard_normal((T, N, k))
    logits[:, ::5] = np.round(logits[:, ::5])          # tied margins
    proba = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    views = {"pred": logits.argmax(-1), "proba": proba}
    if k == 2:
        views["decision"] = logits[..., 1] - logits[..., 0]
    meta = {"n_classes": k, "logloss_clip_eps": float(np.finfo(float).eps)}
    return views, y, _weights(rng), meta


def _regression(seed, negative):
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.0, 5.0, N)
    if negative:
        y[::9] *= -1.0
    pred = y[None, :] + rng.standard_normal((T, N))
    pred[:, ::4] = np.round(pred[:, ::4])               # tied errors
    pred = np.abs(pred) if not negative else pred
    return {"pred": pred}, y, _weights(rng), {}


def _jax_scores(name, views, y, w, meta):
    core = jsc.SCORERS[name].core
    return np.asarray(jax.vmap(lambda v, wt: core(v, jnp.asarray(y), wt,
                                                  meta))(
        {k: jnp.asarray(v) for k, v in views.items()}, jnp.asarray(w)))


def _port_scores(name, views, y, w, meta):
    return psc.SCORERS[name].core(
        {k: torch.as_tensor(v) for k, v in views.items()},
        torch.as_tensor(y), torch.as_tensor(w), meta).numpy()


def _cast(views, y, w, dtype):
    return ({k: (v.astype(dtype) if v.dtype.kind == "f" else v)
             for k, v in views.items()},
            y.astype(dtype) if y.dtype.kind == "f" else y, w.astype(dtype))


def _compare(name, views, y, w, meta, dtype):
    views, y, w = _cast(views, y, w, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = _jax_scores(name, views, y, w, meta)
    got = _port_scores(name, views, y, w, meta)
    assert got.shape == (T,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    return got


@pytest.mark.parametrize("name", BINARY)
def test_binary_cores_match_reference(name):
    _compare(name, *_classification(2, seed=0), np.float32)


@pytest.mark.parametrize("name", MULTICLASS)
def test_multiclass_cores_match_reference(name):
    _compare(name, *_classification(4, seed=1), np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", REGRESSION)
def test_regression_cores_match_reference(name, dtype):
    _compare(name, *_regression(seed=2, negative=False), dtype)


def test_msle_is_nan_where_sklearn_raises():
    views, y, w, meta = _regression(seed=3, negative=True)
    got = _compare("neg_mean_squared_log_error", views, y, w, meta,
                   np.float64)
    invalid = ((w > 0) & ((y[None, :] < 0) | (views["pred"] < 0))).any(1)
    assert invalid.any() and not invalid.all()
    assert np.isnan(got[invalid]).all()
    assert np.isfinite(got[~invalid]).all()


def test_median_averages_the_middle_pair_on_even_folds():
    views, y, w, meta = _regression(seed=4, negative=False)
    got = -_compare("neg_median_absolute_error", views, y, w, meta,
                    np.float64)
    for t in range(T):
        if w[t].sum() == 0:
            continue
        err = np.abs(y - views["pred"][t])[w[t] > 0]
        np.testing.assert_allclose(got[t], np.median(err), rtol=1e-12)


def test_roc_auc_matches_sklearn_on_continuous_margins():
    views, y, w, meta = _classification(2, seed=5)
    views["decision"] = np.random.default_rng(6).standard_normal((T, N))
    got = _compare("roc_auc", views, y, w, meta, np.float64)
    for t in range(T):
        m = w[t] > 0
        if m.any():
            np.testing.assert_allclose(
                got[t], roc_auc_score(y[m], views["decision"][t][m]),
                rtol=1e-12)


def test_every_reference_scorer_name_is_ported():
    assert set(psc.SCORERS) == set(jsc.SCORERS)
    for name, scorer in psc.SCORERS.items():
        assert scorer.views == jsc.SCORERS[name].views, name
    assert psc.CLASSIFICATION_SCORERS == jsc.CLASSIFICATION_SCORERS
    assert psc.BINARY_ONLY_SCORERS == jsc.BINARY_ONLY_SCORERS


def test_default_scorer_and_target_checks():
    """scoring=None is accuracy for a classifier and r2 for a regressor,
    as in the reference; class-based scorers refuse a regressor, and the
    binary-only ones a multiclass target."""
    assert psc.resolve_scoring(None, RidgeFamily)[0]["score"] is \
        psc.SCORERS["r2"]
    assert psc.resolve_scoring(None, LogisticRegressionFamily)[0][
        "score"] is psc.SCORERS["accuracy"]
    with pytest.raises(ValueError, match="classifier"):
        psc.check_scoring_target(["r2", "accuracy"], RidgeFamily,
                                 {"n_features": 3})
    with pytest.raises(ValueError, match="multiclass"):
        psc.check_scoring_target("roc_auc", LogisticRegressionFamily,
                                 {"n_classes": 3})
    psc.check_scoring_target("f1", LogisticRegressionFamily,
                             {"n_classes": 2})
    for scoring in ({"a": "accuracy"}, "not_a_scorer", ["r2", len], len):
        with pytest.raises(NotImplementedError):
            psc.resolve_scoring(scoring, RidgeFamily)
