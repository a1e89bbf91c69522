"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions, and small searches, fits and scorer cores
on cuda against the same on the CPU (logistic regression by L-BFGS and
by FISTA, Ridge and LinearRegression in float64, ElasticNet, the 17
scorers).  They skip where no card is visible.

This file imports neither JAX nor sklearn, so it also runs on a machine
that has only PyTorch:  python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.search.scorers import SCORERS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(k, device, n=301, B=77, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, B) if k == 2 else (n, B, k)
    Z = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    Zp = rng.standard_normal(shape).astype(np.float32)
    wT = (rng.random((n, B)) < 0.8).astype(np.float32)
    y = rng.integers(0, k, n).astype(np.int32)
    a0 = rng.uniform(0.05, 1.0, B).astype(np.float32)
    alphas = (a0[None, :] * 0.5 ** np.arange(16, dtype=np.float32)[:, None])
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (Z, Zp, wT, y, alphas.astype(np.float32))]


# (k, n, B, forced row splits or None for the wrapper's own plan)
SHAPES = [(k, 301, 77, None) for k in (2, 3, 10, 16, 17, 40)] + [
    (10, 301, 64, None),              # B a multiple of the lane tile
    (10, 50, 1, None),                # one lane
    (10, 1, 77, None), (2, 1, 77, None), (40, 1, 5, None),   # n = 1
    (10, 5, 77, 8), (2, 5, 77, 8), (40, 3, 40, 8),  # n < S: empty splits
    (10, 301, 77, 7),                 # S does not divide n
    (11, 301, 97, None), (1, 64, 33, None),          # odd k, odd B
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,B,splits", SHAPES)
def test_kernels_match_plain(cuda_device, monkeypatch, k, n, B, splits):
    """Tolerance: rtol 1e-5 on per-lane loss sums and atol 1e-6 on G —
    the kernels sum rows in another order than torch's reductions.  k=17
    and k=40 take the kernels' path for logits not cached in registers;
    `splits` forces the grid's row-split count past the wrapper's plan."""
    if splits is not None:
        monkeypatch.setattr(gk, "row_splits", lambda *args: splits)
    Z, Zp, wT, y, alphas = _inputs(k, cuda_device, n=n, B=B)
    n0 = dict(gk.LAUNCHES)
    loss, G = gk.glm_loss_grad(Z, wT, y)
    trials = gk.glm_trial_loss(Z, Zp, wT, y, alphas)
    trials5 = gk.glm_trial_loss(Z, Zp, wT, y, alphas[:5].contiguous())
    trials1 = gk.glm_trial_loss(Z, Zp, wT, y, alphas[:1].contiguous())
    torch.cuda.synchronize()
    assert gk.LAUNCHES["glm_loss_grad"] == n0["glm_loss_grad"] + 1
    assert gk.LAUNCHES["glm_trial_loss"] == n0["glm_trial_loss"] + 3
    loss_p, G_p = gk.glm_loss_grad_plain(Z, wT, y)
    trials_p = gk.glm_trial_loss_plain(Z, Zp, wT, y, alphas)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(G, G_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(trials, trials_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(trials5, trials_p[:5], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(trials1, trials_p[:1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 10, 40])
def test_kernels_are_bitwise_deterministic(cuda_device, k):
    """No atomics: two launches on the same inputs give the same bits."""
    Z, Zp, wT, y, alphas = _inputs(k, cuda_device, n=1000, B=333)
    first = gk.glm_loss_grad(Z, wT, y) + (
        gk.glm_trial_loss(Z, Zp, wT, y, alphas),)
    second = gk.glm_loss_grad(Z, wT, y) + (
        gk.glm_trial_loss(Z, Zp, wT, y, alphas),)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    Z, Zp, wT, y, alphas = _inputs(10, cuda_device)
    with pytest.raises(ValueError):
        gk.glm_loss_grad(Z.transpose(0, 1).contiguous().transpose(0, 1),
                         wT, y)
    with pytest.raises(ValueError):
        gk.glm_loss_grad(Z, wT.cpu(), y)
    with pytest.raises(TypeError):
        gk.glm_loss_grad(Z, wT, y.long())
    with pytest.raises(ValueError):
        gk.glm_trial_loss(Z, Zp, wT, y, torch.cat([alphas, alphas]))


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [False, True])
def test_search_on_cuda_matches_cpu(cuda_device, binary):
    rng = np.random.default_rng(0)
    y = rng.permutation(np.arange(400) % 10)
    X = (rng.uniform(0, 1, (10, 20))[y]
         + 0.8 * rng.standard_normal((400, 20))).astype(np.float32)
    if binary:
        X, y = X[y < 2], y[y < 2]
    grid = {"C": [0.01, 0.1, 1.0, 10.0]}
    runs = {}
    for dev in ("cuda", "cpu"):
        gk.reset_launches()
        runs[dev] = port.GridSearchCV(
            port.LogisticRegression(max_iter=100), grid,
            cv=port.StratifiedKFold(3),
            config=port.TorchConfig(device=dev)).fit(X, y)
        launched = all(v > 0 for v in gk.LAUNCHES.values())
        assert launched == (dev == "cuda")
    np.testing.assert_allclose(runs["cuda"].cv_results_["mean_test_score"],
                               runs["cpu"].cv_results_["mean_test_score"],
                               atol=5e-3)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_
    assert runs["cuda"].best_estimator_.device == "cuda"


# ---------------------------------------------------------------------------
# the rest of the linear families, FISTA and the scorers: cuda against
# the CPU path (the plain versions) on the same inputs
# ---------------------------------------------------------------------------

def _class_problem(k, n=300, d=20, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(n) % k)
    X = (rng.uniform(0, 1, (k, d))[y]
         + 0.8 * rng.standard_normal((n, d))).astype(np.float32)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 10])
def test_fista_on_cuda_matches_cpu(cuda_device, k):
    """The l1 LogisticRegression fit (FISTA through K2) on both devices:
    coefficients of the lanes both converged within atol 1e-4, equal
    iteration counts within 2, K2 launched only on the card."""
    X, y = _class_problem(k)
    rng = np.random.default_rng(1)
    w = (rng.random((6, len(y))) < 0.7).astype(np.float32)
    C = np.array([0.05, 0.2, 1.0, 0.05, 0.2, 1.0], np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        data, meta = LogisticRegressionFamily.prepare_data(X, y)
        gk.reset_launches()
        out[dev] = LogisticRegressionFamily.fit_task_batched(
            {"C": torch.as_tensor(C, device=dev)},
            {"penalty": "l1", "max_iter": 30},
            {n: torch.as_tensor(v, device=dev) for n, v in data.items()},
            torch.as_tensor(w, device=dev), meta)
        assert (gk.LAUNCHES["glm_loss_grad"] > 0) == (dev == "cuda")
        assert gk.LAUNCHES["glm_trial_loss"] == 0
    conv = (out["cuda"]["converged"].cpu() & out["cpu"]["converged"]).numpy()
    assert conv.any()
    for key in ("coef", "intercept"):
        np.testing.assert_allclose(out["cuda"][key].cpu().numpy()[conv],
                                   out["cpu"][key].numpy()[conv], atol=1e-4)
    assert abs(int(out["cuda"]["n_iter_exec"][0])
               - int(out["cpu"]["n_iter_exec"][0])) <= 2


def _reg_problem(n=400, d=8, seed=0, rank_deficient=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * np.linspace(0.5, 12.0, d)
    if rank_deficient:
        X[:, -2:] = X[:, :2]
    y = X @ rng.normal(size=d) + 0.5 * rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def _reg_search(est, grid, X, y, dev):
    return port.GridSearchCV(
        est, grid, cv=port.KFold(4),
        scoring=["r2", "neg_median_absolute_error",
                 "neg_mean_squared_error"], refit="r2",
        config=port.TorchConfig(device=dev)).fit(X, y)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["ridge", "linear_regression",
                                   "elasticnet"])
def test_regressor_search_on_cuda_matches_cpu(cuda_device, label):
    """Ridge and LinearRegression run in float64 on the card (r2 within
    1e-10 of the CPU's); ElasticNet in float32 (within 1e-5).  The
    refit runs on the card."""
    est, grid, tol = {
        "ridge": (port.Ridge(), {"alpha": [0.01, 1.0, 100.0]}, 1e-10),
        "linear_regression": (port.LinearRegression(),
                              {"fit_intercept": [True, False]}, 1e-10),
        "elasticnet": (port.ElasticNet(max_iter=300),
                       {"alpha": [0.01, 0.1], "l1_ratio": [0.3, 1.0]},
                       1e-5),
    }[label]
    X, y = _reg_problem()
    runs = {dev: _reg_search(est, grid, X, y, dev)
            for dev in ("cuda", "cpu")}
    for s in ("r2", "neg_median_absolute_error", "neg_mean_squared_error"):
        np.testing.assert_allclose(
            runs["cuda"].cv_results_[f"mean_test_{s}"],
            runs["cpu"].cv_results_[f"mean_test_{s}"], rtol=tol, atol=tol)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_
    best = runs["cuda"].best_estimator_
    assert best.device == "cuda"
    want_dtype = np.float32 if label == "elasticnet" else np.float64
    assert best.coef_.dtype == want_dtype


@pytest.mark.cuda
def test_min_norm_least_squares_on_cuda(cuda_device):
    """On rank-deficient X the card's answer is the minimum-norm one
    (numpy's SVD-based lstsq on the centred data), which a QR-based
    `gels` solve would not give."""
    X, y = _reg_problem(rank_deficient=True)
    est = port.LinearRegression(device="cuda").fit(X, y)
    Xc = X.astype(np.float64) - X.mean(0)
    want = np.linalg.lstsq(Xc, y - y.astype(np.float64).mean(),
                           rcond=None)[0]
    np.testing.assert_allclose(est.coef_, want, atol=1e-8)
    np.testing.assert_allclose(est.coef_[:2], est.coef_[-2:], atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCORERS))
def test_scorer_cores_on_cuda_match_cpu(cuda_device, name):
    rng = np.random.default_rng(3)
    T, n, k = 9, 101, 2
    w = (rng.random((T, n)) < 0.6).astype(np.float64)
    w[4] = 0.0                                       # a zero-weight fold
    logits = rng.standard_normal((T, n, k))
    views = {"pred": logits.argmax(-1),
             "proba": np.exp(logits) / np.exp(logits).sum(-1, keepdims=True),
             "decision": logits[..., 1] - logits[..., 0]}
    y = rng.integers(0, k, n)
    if name not in ("accuracy", "balanced_accuracy", "neg_log_loss", "f1",
                    "f1_macro", "precision", "recall", "roc_auc"):
        y = rng.uniform(0.0, 3.0, n)
        views = {"pred": y[None, :] + rng.standard_normal((T, n))}
    meta = {"n_classes": k}
    got = {}
    for dev in ("cuda", "cpu"):
        got[dev] = SCORERS[name].core(
            {v: torch.as_tensor(a, device=dev) for v, a in views.items()},
            torch.as_tensor(y, device=dev), torch.as_tensor(w, device=dev),
            meta).cpu().numpy()
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-10,
                               atol=1e-12)
