"""The port's preprocessing steps and Pipelines against the JAX package's,
on the CPU: each step's fold-weighted fit and transform, pipeline
resolution, BASELINE #5-shaped MLP searches, scaler + SVC, scaler +
LogisticRegression and scaler + gradient boosting searches, the port's
own `Pipeline`, and `mlp_from_jax`/`pipeline_from_jax`.

Tolerances, each measured against the JAX package on these inputs:
- steps: rtol 1e-6, atol 1e-6 (an ulp or two of float32); PCA up to
  each component's sign, atol 1e-5 of the output's largest magnitude
  (measured 1.5e-6 of it: the two float32 eigensolvers differ);
- MLP pipeline searches: mean test scores within 5e-3, the repo's
  oracle bound (`tests/test_search_basic.py:47`); measured <= 5e-6;
- scaler + SVC: 5e-3, the oracle bound; measured 0 (every fold's score
  equal);
- scaler + gradient boosting: 1e-4 (the trees' bound,
  `tests/test_torch_trees.py`); scaler + LogisticRegression 5e-3;
- converted models: equal predictions, probabilities atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA as SkPCA
from sklearn.ensemble import GradientBoostingRegressor as SkGBR
from sklearn.feature_selection import SelectKBest
from sklearn.linear_model import LogisticRegression as SkLogReg
from sklearn.neural_network import MLPClassifier as SkMLPC
from sklearn.neural_network import MLPRegressor as SkMLPR
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMax
from sklearn.preprocessing import StandardScaler as SkScaler
from sklearn.svm import SVC as SkSVC

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import mlp as jm
from spark_sklearn_tpu.models import pipeline as jpipe
from spark_sklearn_tpu.models import preprocessing as jprep
from spark_sklearn_tpu_torch.convert.params import (
    mlp_from_jax,
    pipeline_from_jax,
)
from spark_sklearn_tpu_torch.models import mlp as pm
from spark_sklearn_tpu_torch.models import pipeline as ppipe
from spark_sklearn_tpu_torch.models import preprocessing as pprep
from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.search.grid import _logloss_clip_eps

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

STEPS = [
    ("StandardScaler", {}),
    ("StandardScaler", {"with_mean": False}),
    ("StandardScaler", {"with_std": False}),
    ("MinMaxScaler", {"feature_range": (-1.0, 2.0), "clip": True}),
    ("MaxAbsScaler", {}),
    ("Normalizer", {"norm": "l1"}),
    ("Normalizer", {"norm": "l2"}),
    ("Normalizer", {"norm": "max"}),
    ("PCA", {"n_components": 5}),
    ("PCA", {"n_components": 4, "whiten": True}),
]


@pytest.mark.parametrize("name,static", STEPS)
def test_step_matches_reference(name, static, diabetes):
    X = diabetes[0][:120].astype(np.float32) * 10.0
    rng = np.random.default_rng(1)
    W = (rng.random((3, len(X))) < 0.7).astype(np.float32)
    jstep, pstep = jprep.STEP_REGISTRY[name], pprep.STEP_REGISTRY[name]
    want = np.asarray(jax.vmap(lambda w: jstep.apply(
        static, jstep.fit(static, jnp.asarray(X), w), jnp.asarray(X)))(
            jnp.asarray(W)))
    Xt = torch.as_tensor(X)
    got = pstep.apply(static, pstep.fit(static, Xt, torch.as_tensor(W)),
                      Xt).numpy()
    assert got.shape == want.shape
    if name == "PCA":
        # each component is defined up to its sign, and two float32
        # eigensolvers agree on it to ~1e-6 of the data's scale
        sign = np.sign((got * want).sum(axis=1, keepdims=True))
        np.testing.assert_allclose(got * sign, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_steps_chain_over_the_fold_axis(diabetes):
    """A second step takes the first's (F, n, d) output."""
    X = torch.as_tensor(diabetes[0][:60].astype(np.float32))
    W = torch.ones(2, 60)
    W[1, :20] = 0.0
    s1 = pprep.StandardScalerStep
    Z = s1.apply({}, s1.fit({}, X, W), X)
    s2 = pprep.PCAStep
    out = s2.apply({"n_components": 3},
                   s2.fit({"n_components": 3}, Z, W), Z)
    assert out.shape == (2, 60, 3)
    for f in range(2):
        alone = s2.apply({"n_components": 3}, s2.fit(
            {"n_components": 3}, Z[f], W[f:f + 1]), Z[f])[0]
        np.testing.assert_allclose(out[f].abs(), alone.abs(), atol=1e-5)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

def test_pipeline_resolution_matches_reference():
    from spark_sklearn_tpu.models.base import resolve_family as jresolve
    cases = [
        SkPipeline([("scale", SkScaler()), ("clf", SkLogReg())]),
        SkPipeline([("sel", SelectKBest(k=2)), ("clf", SkLogReg())]),
        SkPipeline([("scale", SkScaler()), ("mlp", SkMLPC())]),
        SkPipeline([("mm", SkMinMax()), ("gb", SkGBR())]),
        SkPipeline([("pca", SkPCA(2)), ("gb", SkGBR())]),
        SkPipeline([("scale", SkScaler()), ("svc", SkSVC())]),
    ]
    for pipe in cases:
        ref, ours = jresolve(pipe), resolve_family(pipe)
        assert (ref is None) == (ours is None), pipe
        if ref is not None:
            assert type(ours).__name__ == type(ref).__name__
            assert ours.dynamic_params == ref.dynamic_params
            assert ours.proba_dtype_rule == getattr(
                ref, "proba_dtype_rule", "float64")
    fam = resolve_family(cases[0])
    assert fam.dynamic_params == {"clf__C": np.float32,
                                  "clf__tol": np.float32}
    own = port.Pipeline([("scale", port.StandardScaler()),
                         ("mlp", port.MLPClassifier())])
    fam = resolve_family(own)
    assert isinstance(fam, ppipe.PipelineFamily)
    assert fam.final is pm.MLPClassifierFamily
    assert fam.dynamic_params == {"mlp__alpha": np.float32,
                                  "mlp__learning_rate_init": np.float32}


def test_logloss_clip_follows_the_final_family():
    mlp_pipe = resolve_family(SkPipeline([("s", SkScaler()),
                                          ("m", SkMLPC())]))
    logreg = resolve_family(SkLogReg())
    f32, f64 = np.finfo(np.float32).eps, np.finfo(np.float64).eps
    assert _logloss_clip_eps(mlp_pipe, np.float32) == f32
    assert _logloss_clip_eps(mlp_pipe, np.float64) == f64
    assert _logloss_clip_eps(pm.MLPClassifierFamily, np.float32) == f32
    assert _logloss_clip_eps(logreg, np.float32) == f64


# ---------------------------------------------------------------------------
# searches against the JAX package
# ---------------------------------------------------------------------------

def _both(est, grid, X, y, **kw):
    ours = port.GridSearchCV(est, grid, config=CPU, **kw).fit(X, y)
    ref = sst.GridSearchCV(est, grid, **kw).fit(X, y)
    return ours, ref


def _close(ours, ref, key, tol):
    np.testing.assert_allclose(ours.cv_results_[key], ref.cv_results_[key],
                               rtol=0, atol=tol)


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.ConvergenceWarning")
def test_mlp_pipeline_search_matches_reference(digits):
    """BASELINE #5's shape at a small size: StandardScaler + MLP, 2 alphas
    x cv=3, hidden (16,), max_iter 10, accuracy and neg_log_loss (clipped
    at float32's eps, as sklearn's log_loss of a float32 MLP)."""
    X, y = digits
    pipe = SkPipeline([("scale", SkScaler()), ("mlp", SkMLPC(
        hidden_layer_sizes=(16,), max_iter=10, random_state=0))])
    ours, ref = _both(pipe, {"mlp__alpha": [1e-4, 1e-1]}, X, y, cv=3,
                      scoring=["accuracy", "neg_log_loss"],
                      refit="accuracy")
    for key in ("mean_test_accuracy", "mean_test_neg_log_loss"):
        _close(ours, ref, key, 5e-3)
    assert ours.best_params_ == ref.best_params_
    assert ours.chunks_[0]["n_iter_exec"] == 10
    assert ours.best_estimator_.predict(X[:5]).shape == (5,)


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.ConvergenceWarning")
def test_baseline5_full_width_matches_reference(digits):
    """BASELINE #5 itself: StandardScaler + MLPClassifier(hidden (64,),
    max_iter=60, random_state=0) over 4 alphas x cv=3 on digits (12
    lanes, 9 minibatches of 200 an epoch) — ~3 s here."""
    X, y = digits
    pipe = SkPipeline([("scale", SkScaler()), ("mlp", SkMLPC(
        hidden_layer_sizes=(64,), max_iter=60, random_state=0))])
    ours, ref = _both(pipe, {"mlp__alpha": [1e-4, 1e-3, 1e-2, 1e-1]}, X,
                      y, cv=3, refit=False)
    _close(ours, ref, "mean_test_score", 5e-3)
    assert ours.best_params_ == ref.best_params_
    assert ours.chunks_ and ours.chunks_[0]["lanes"] == 12


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.ConvergenceWarning")
def test_mlp_regressor_pipeline_search_matches_reference(diabetes):
    X = diabetes[0][:300].astype(np.float32)
    y = (diabetes[1][:300] / 100.0).astype(np.float32)
    pipe = SkPipeline([("scale", SkScaler()), ("mlp", SkMLPR(
        hidden_layer_sizes=(16,), max_iter=20, learning_rate_init=0.01,
        random_state=0))])
    from sklearn.model_selection import KFold
    ours, ref = _both(pipe, {"mlp__alpha": [1e-4, 1.0]}, X, y,
                      cv=KFold(3), refit=False)
    _close(ours, ref, "mean_test_score", 5e-3)
    assert ours.best_params_ == ref.best_params_


def test_port_pipeline_search_refits_on_the_device(digits):
    """The sklearn-free pipeline: the same scores as sklearn's classes,
    `step__param` routing, and a refit whose predictions are the refit
    MLP's on the scaled data."""
    X, y = digits
    X, y = X[:400], y[:400]
    mk = dict(hidden_layer_sizes=(16,), max_iter=8, random_state=0)
    own = port.Pipeline([("scale", port.StandardScaler()),
                         ("mlp", port.MLPClassifier(**mk))])
    sk = SkPipeline([("scale", SkScaler()), ("mlp", SkMLPC(**mk))])
    grid = {"mlp__alpha": [1e-4, 1e-2]}
    a = port.GridSearchCV(own, grid, cv=3, config=CPU).fit(X, y)
    b = port.GridSearchCV(sk, grid, cv=3, config=CPU, refit=False).fit(X, y)
    np.testing.assert_array_equal(a.cv_results_["mean_test_score"],
                                  b.cv_results_["mean_test_score"])
    best = a.best_estimator_
    assert best.named_steps["mlp"].alpha == a.best_params_["mlp__alpha"]
    assert own.named_steps["mlp"].alpha == 1e-4       # a clone was refit
    Xs = (X - X.mean(0)) / np.where(X.std(0) > 0, X.std(0), 1.0)
    mlp = port.MLPClassifier(alpha=a.best_params_["mlp__alpha"], **mk,
                             device="cpu").fit(Xs, y)
    np.testing.assert_array_equal(best.predict(X), mlp.predict(Xs))
    assert best.predict_proba(X).shape == (400, 10)
    assert own.get_params()["mlp__max_iter"] == 8
    own.set_params(mlp__max_iter=3, scale__with_mean=False)
    assert own.named_steps["mlp"].max_iter == 3
    assert own.named_steps["scale"].with_mean is False
    with pytest.raises(ValueError):
        own.set_params(nope__x=1)


def test_scaler_svc_pipeline_matches_reference(digits):
    X, y = digits
    m = y < 6
    X, y = X[m][:300], y[m][:300]
    pipe = SkPipeline([("scale", SkScaler()), ("clf", SkSVC())])
    ours, ref = _both(pipe, {"clf__C": [0.5, 2.0],
                             "clf__gamma": [0.01, 0.05]}, X, y, cv=3)
    _close(ours, ref, "mean_test_score", 5e-3)
    assert ours.best_params_ == ref.best_params_
    # gamma="scale" follows each fold's transformed rows
    ours, ref = _both(pipe, {"clf__C": [0.5, 2.0]}, X, y, cv=3,
                      refit=False)
    _close(ours, ref, "mean_test_score", 5e-3)


def test_scaler_logreg_pipeline_fits_fold_by_fold(digits):
    """A final without per-fold inputs is fitted fold by fold on that
    fold's transformed X."""
    X, y = digits
    pipe = SkPipeline([("scale", SkScaler()), ("clf", SkLogReg(
        max_iter=50))])
    ours, ref = _both(pipe, {"clf__C": [0.1, 1.0]}, X[:400], y[:400],
                      cv=3, refit=False)
    _close(ours, ref, "mean_test_score", 5e-3)


def test_scaler_boosting_pipeline_is_binned_invariant(diabetes):
    X = diabetes[0][:240].astype(np.float32)
    y = diabetes[1][:240].astype(np.float32)
    pipe = SkPipeline([("scale", SkScaler()), ("gb", SkGBR(
        n_estimators=5, max_depth=2, random_state=0))])
    fam = resolve_family(pipe)
    assert isinstance(fam, ppipe.BinnedInvariantPipelineFamily)
    ours, ref = _both(pipe, {"gb__learning_rate": [0.1, 0.3]}, X, y, cv=3,
                      refit=False)
    _close(ours, ref, "mean_test_score", 1e-4)
    assert ours.best_params_ == ref.best_params_


# ---------------------------------------------------------------------------
# converted models
# ---------------------------------------------------------------------------

def test_mlp_and_pipeline_from_jax_predict_alike(digits):
    X, y = digits
    X, y = X[:300], y[:300]
    static = {"hidden_layer_sizes": (16, 8), "max_iter": 5,
              "random_state": 0}
    data, meta = jm.MLPClassifierFamily.prepare_data(X, y)
    w = jnp.ones(len(y), jnp.float32)
    jmodel = jm.MLPClassifierFamily.fit({}, static, data, w, meta)
    model = mlp_from_jax(jmodel, device="cpu")
    assert int(model["n_iter"]) == int(jmodel["n_iter"])
    Xt = torch.as_tensor(X)
    np.testing.assert_array_equal(
        pm.MLPClassifierFamily.predict(model, static, Xt, meta).numpy(),
        np.asarray(jm.MLPClassifierFamily.predict(jmodel, static, X, meta)))
    np.testing.assert_allclose(
        pm.MLPClassifierFamily.predict_proba(model, static, Xt,
                                             meta).numpy(),
        np.asarray(jm.MLPClassifierFamily.predict_proba(jmodel, static, X,
                                                        meta)), atol=1e-6)

    pipe = SkPipeline([("scale", SkScaler()), ("mlp", SkMLPC())])
    jfam = jpipe.make_pipeline_family(pipe)
    pstatic = {"mlp__" + k: v for k, v in static.items()}
    jpm = jfam.fit({}, pstatic, data, w, meta)
    conv = pipeline_from_jax(jpm, device="cpu")
    Z = pprep.StandardScalerStep.apply({}, conv["steps"][0], Xt)[0]
    got = pm.MLPClassifierFamily.predict(conv["final"], static, Z, meta)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfam.predict(jpm, pstatic, X, meta)))
