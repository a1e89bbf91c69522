"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions, and small searches, fits and scorer cores
on cuda against the same on the CPU (logistic regression by L-BFGS and
by FISTA, Ridge and LinearRegression in float64, ElasticNet, the 17
scorers, SVC and NuSVC, the tree ensembles, and the MLP and Pipeline
searches).  They skip where no card is visible.

This file imports neither JAX nor sklearn, so it also runs on a machine
that has only PyTorch:  python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops import mlp_kernels as mk
from spark_sklearn_tpu_torch.ops import svm_kernels as svk
from spark_sklearn_tpu_torch.ops import tree_kernels as tk
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


# ---------------------------------------------------------------------------
# the SVMs: S1 (Gram epilogue) and S2 (projected dual step) against their
# plain versions, and SVC/NuSVC searches on cuda against the CPU
# ---------------------------------------------------------------------------

def _gram_inputs(device, n1=300, n2=257, d=50, seed=0):
    rng = np.random.default_rng(seed)
    X1 = (rng.uniform(0, 1, (n1, d)) * (rng.random((n1, d)) < 0.3))
    X2 = (rng.uniform(0, 1, (n2, d)) * (rng.random((n2, d)) < 0.3))
    return [torch.as_tensor(a.astype(np.float32), device=device)
            for a in (X1, X2)]


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("kind", ["rbf", "poly", "sigmoid", "linear"])
def test_gram_epilogue_matches_plain(cuda_device, kind, same):
    """Tolerance: rtol 1e-5, atol 1e-6 — the kernel takes the norms of
    X X^T from the product's diagonal and sums the others in another
    order than torch's, and expf/powf/tanhf round differently from
    torch's kernels by a few ulp.  The rbf diagonal of X X^T is exactly
    1."""
    X1, X2 = _gram_inputs(cuda_device)
    if same:
        X2 = X1
    G = X1 @ X2.T
    want = svk.gram_epilogue_plain(G.clone(), X1, X2, kind, 0.07, 3.0, 0.5)
    n0 = svk.LAUNCHES["svm_gram_epilogue"]
    got = svk.gram_epilogue(G.clone(), X1, X2, kind, 0.07, 3.0, 0.5)
    torch.cuda.synchronize()
    assert svk.LAUNCHES["svm_gram_epilogue"] == n0 + (kind != "linear")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if kind == "rbf" and same:
        assert torch.all(got.diagonal() == 1.0)


def _step_inputs(device, M, n, seed=0):
    rng = np.random.default_rng(seed)
    yb = rng.choice([-1.0, 0.0, 1.0], size=(M, n), p=[0.45, 0.1, 0.45])
    bound = (rng.uniform(0.5, 2.0, (M, n)) * (rng.random((M, n)) < 0.8)
             * (yb != 0))
    z = rng.uniform(0, 1, (M, n)) * bound
    x = rng.uniform(0, 1, (M, n)) * bound
    V = rng.standard_normal((M, n))
    target = 0.3 * bound.sum(axis=1) + 0.1
    arrs = [torch.as_tensor(a.astype(np.float32), device=device)
            for a in (V, z, x, yb, bound, target)]
    return arrs + [torch.tensor(0.25, device=device)]


# (M, n, forced staged limit or None): one row of one element, ragged
# rows, the largest staged row, the streamed plan forced at a small n and
# taken at a real one
STEP_SHAPES = [(7, 300, None), (3, 1, None), (5, 777, None),
               (2, svk.STAGED_MAX_N, None), (5, 777, 256),
               (2, svk.STAGED_MAX_N + 1, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,n,staged_max", STEP_SHAPES)
@pytest.mark.parametrize("mode", ["svc", "nu", "project"])
def test_dual_step_matches_plain(cuda_device, monkeypatch, mode, M, n,
                                 staged_max):
    """Tolerance: atol 1e-5 on x', z', w' and 1e-5/step on the residual —
    the bisection's block sums add in another order than torch's, which
    moves the multiplier by rounding only where enough elements are
    free.  `staged_max` forces the streamed plan below its limit."""
    if staged_max is not None:
        monkeypatch.setattr(svk, "STAGED_MAX_N", staged_max)
    V, z, x, yb, bound, target, step = _step_inputs(cuda_device, M, n)
    V = None if mode == "project" else V
    target = None if mode == "svc" else target
    want = svk.dual_step_plain(V, z, x, yb, bound, step, 0.4, target)
    n0 = svk.LAUNCHES["svm_dual_step"]
    got = svk.dual_step(V, z, x, yb, bound, step, 0.4, target)
    torch.cuda.synchronize()
    assert svk.LAUNCHES["svm_dual_step"] == n0 + 1
    for a, b, atol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-5 / 0.25)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
    assert bool((got[0] >= 0).all() and (got[0] <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["svc", "nu"])
def test_dual_step_plans_and_repeats_agree_bitwise(cuda_device, mode):
    """No atomics: two launches give the same bits, and the staged and
    streamed plans add in the same order, so they agree bitwise too."""
    V, z, x, yb, bound, target, step = _step_inputs(cuda_device, 33, 3001)
    target = None if mode == "svc" else target
    first = svk.dual_step(V, z, x, yb, bound, step, 0.4, target)
    second = svk.dual_step(V, z, x, yb, bound, step, 0.4, target)
    streamed = svk.dual_step(V, z, x, yb, bound, step, 0.4, target,
                             plan="streamed")
    for a, b, c in zip(first, second, streamed):
        assert torch.equal(a, b) and torch.equal(a, c)
    X1, _ = _gram_inputs(cuda_device)
    G = X1 @ X1.T
    assert torch.equal(svk.gram_epilogue(G.clone(), X1, X1, "rbf", 0.1, 3, 0),
                       svk.gram_epilogue(G.clone(), X1, X1, "rbf", 0.1, 3, 0))


@pytest.mark.cuda
def test_svm_wrappers_raise_instead_of_falling_back(cuda_device):
    V, z, x, yb, bound, target, step = _step_inputs(cuda_device, 4, 50)
    with pytest.raises(ValueError):
        svk.dual_step(V, z.T.contiguous().T, x, yb, bound, step, 0.4)
    with pytest.raises(ValueError):
        svk.dual_step(V, z, x, yb.cpu(), bound, step, 0.4)
    with pytest.raises(TypeError):
        svk.dual_step(V, z, x, yb, bound.double(), step, 0.4)
    with pytest.raises(ValueError):
        svk.dual_step(V, z, x, yb, bound, step, 0.4, target[:2])
    with pytest.raises(ValueError):
        svk.dual_step(V, z, x, yb, bound, step, 0.4, plan="shared")
    X1, X2 = _gram_inputs(cuda_device)
    with pytest.raises(ValueError):
        svk.gram_epilogue(X1 @ X2.T, X1, X1, "rbf", 0.1, 3, 0)
    with pytest.raises(ValueError):
        svk.gram_epilogue(X1 @ X2.T, X1, X2, "precomputed", 0.1, 3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["svc", "binary", "nusvc"])
def test_svm_search_on_cuda_matches_cpu(cuda_device, label):
    """SVC (3 classes, and binary) and NuSVC searches on both devices:
    mean_test_score within 5e-3 (the repo's oracle bound) and the same
    best candidate; S1 and S2 launched on the card only; the refit
    estimator predicts on the card as on the CPU."""
    k = 2 if label == "binary" else 3
    X, y = _class_problem(k, n=240)
    est, grid = ((port.NuSVC(), {"nu": [0.2, 0.5]}) if label == "nusvc"
                 else (port.SVC(), {"C": [0.5, 5.0], "gamma": [0.02, 0.1]}))
    runs = {}
    for dev in ("cuda", "cpu"):
        svk.reset_launches()
        runs[dev] = port.GridSearchCV(
            est, grid, cv=port.StratifiedKFold(3),
            config=port.TorchConfig(device=dev)).fit(X, y)
        launched = all(v > 0 for v in svk.LAUNCHES.values())
        assert launched == (dev == "cuda")
    np.testing.assert_allclose(runs["cuda"].cv_results_["mean_test_score"],
                               runs["cpu"].cv_results_["mean_test_score"],
                               atol=5e-3)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_
    best = runs["cuda"].best_estimator_
    assert best.device == "cuda"
    agree = (best.predict(X) == runs["cpu"].best_estimator_.predict(X))
    assert agree.mean() >= 0.99


# ---------------------------------------------------------------------------
# the tree grower's kernels (T1-T4) and the tree searches
# ---------------------------------------------------------------------------

def _tree_inputs(device, kind, L=3, n=700, d=9, n_nodes=8, seed=0,
                 classes=4, skew=False):
    """Bin codes (n, d) uint8 (the first three columns one-hot-like),
    local node ids (L, n) with ~20% of rows taking no part, and stats (L,
    n, S): integer (forest: Poisson counts times one-hot targets, S = 1 +
    classes) or continuous (boosting, S = 2).  With `skew`, half the rows
    go to node 0, a quarter to node 1, and so on (the last node takes the
    rest); else the nodes are drawn uniformly."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    codes[:, :3] = rng.integers(0, 2, (n, 3))         # one-hot-like columns
    if skew:
        local = np.minimum(rng.geometric(0.5, (L, n)) - 1,
                           n_nodes - 1).astype(np.int32)
    else:
        local = rng.integers(0, n_nodes, (L, n)).astype(np.int32)
    local[rng.random((L, n)) < 0.2] = -1
    if kind == "forest":
        w = rng.poisson(1.0, (L, n)).astype(np.float32)
        t = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
        stats = np.concatenate([w[..., None], -w[..., None] * t], axis=2)
    else:
        w = (rng.random((L, n)) < 0.8).astype(np.float32)
        g = rng.standard_normal((L, n)).astype(np.float32)
        stats = np.stack([w, w * g], axis=2)
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (codes, local, stats)]


# (kind, L, n, d, n_nodes, classes, skew): the nodes at a shallow and a
# deep level; a node holding every row; empty nodes (64 nodes for 700
# rows, and 300 rows over 2047 nodes); n not a multiple of T1's row tile
# (256) or of T4's (128), and n above them; S = 11 (a 10-class forest);
# skewed populations
TREE_CASES = [(kind, 3, 700, 9, nodes, 4, False)
              for kind in ("forest", "boosting") for nodes in (1, 8, 64)] + [
    ("boosting", 2, 3000, 5, 1, 4, False),
    ("forest", 2, 300, 6, 2047, 4, False),
    ("boosting", 4, 257, 3, 4, 4, False),
    ("forest", 2, 1000, 4, 16, 10, False),
    ("boosting", 3, 2000, 9, 16, 4, True),
    ("forest", 3, 2000, 9, 63, 4, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L,n,d,n_nodes,classes,skew", TREE_CASES)
def test_tree_hist_and_leaves_match_plain(cuda_device, kind, L, n, d,
                                          n_nodes, classes, skew):
    """T1 and T4 against their plain versions run on CPU copies of the
    same inputs: equal, bit for bit, for integer and continuous stats
    alike (the kernels add every sum in row order, as the CPU's
    `index_add_` does); two launches give the same bits."""
    codes, local, stats = _tree_inputs(cuda_device, kind, L, n, d, n_nodes,
                                       classes=classes, skew=skew)
    cpu = [t.cpu() for t in (codes, local, stats)]
    hist = tk.level_histogram(codes, local, stats, n_nodes)
    assert torch.equal(hist, tk.level_histogram(codes, local, stats,
                                                n_nodes))
    assert torch.equal(hist.cpu(), tk.level_histogram_plain(*cpu, n_nodes))
    val = tk.leaf_values(local, stats, n_nodes, 1e-6)
    assert torch.equal(val, tk.leaf_values(local, stats, n_nodes, 1e-6))
    assert torch.equal(val.cpu(), tk.leaf_values_plain(cpu[1], cpu[2],
                                                       n_nodes, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("L,n,n_nodes,skew", [
    (3, 700, 8, False), (2, 5000, 2047, False), (4, 2049, 1, False),
    (3, 4100, 63, True), (1, 1, 1, False)])
def test_tree_segments_match_plain(cuda_device, L, n, n_nodes, skew):
    """The grouping's counting sort against its plain version (a stable
    torch sort) on CPU copies: the same perm and offs; tiles of 2048 rows
    (n above and below), every row in one node, skewed nodes."""
    local = _tree_inputs(cuda_device, "forest", L, n, 3, n_nodes,
                         skew=skew)[1]
    perm, offs = tk.segments(local, n_nodes)
    want = tk.segments_plain(local.cpu(), n_nodes)
    assert torch.equal(perm.cpu(), want[0])
    assert torch.equal(offs.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["forest", "boosting"])
@pytest.mark.parametrize("masked", [False, True])
def test_tree_best_split_matches_plain(cuda_device, kind, masked):
    """T2 on one histogram against its plain version: on integer stats
    the same feature, bin and split everywhere and gains within rounding;
    on continuous ones the same where the two best gains are apart."""
    codes, local, stats = _tree_inputs(cuda_device, kind, n_nodes=16)
    hist = tk.level_histogram_plain(codes, local, stats, 16)
    fmask = None
    if masked:
        g = torch.Generator(device="cuda").manual_seed(1)
        fmask = torch.rand((16, codes.shape[1]), generator=g,
                           device="cuda") < 0.4
    got = tk.best_splits(hist, fmask, 1e-6, 1.0)
    want = tk.best_splits_plain(hist, fmask, 1e-6, 1.0)
    again = tk.best_splits(hist, fmask, 1e-6, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ok = torch.ones_like(got[3])
    if kind == "boosting":
        flat = _plain_gains(hist, fmask)
        top2 = torch.topk(flat, 2, dim=2).values
        ok = (top2[..., 0] - top2[..., 1]) > 1e-5 * top2[..., 0].abs()
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[ok], b[ok])
    assert torch.equal(got[3], want[3])
    fin = torch.isfinite(want[2])
    assert torch.equal(fin, torch.isfinite(got[2]))
    torch.testing.assert_close(got[2][fin], want[2][fin], rtol=1e-5,
                               atol=1e-5)


def _plain_gains(hist, fmask):
    """The masked (L, N, d*B) gains of the plain T2, for tie checks."""
    L, N, d, B, _ = hist.shape
    cum_h = torch.cumsum(hist[..., 0], 3)
    cum_g = torch.cumsum(hist[..., 1], 3)
    lh, lg = cum_h, cum_g
    th, tg = cum_h[..., -1:], cum_g[..., -1:]
    gain = (lg * lg / (lh + 1e-6) + (tg - lg) ** 2 / (th - lh + 1e-6)
            - tg * tg / (th + 1e-6))
    ok = (lh >= 1.0) & (th - lh >= 1.0)
    gain = torch.where(ok, gain, torch.tensor(float("-inf"), device="cuda"))
    gain[..., -1] = float("-inf")
    if fmask is not None:
        gain = torch.where(fmask[None, :, :, None], gain,
                           torch.tensor(float("-inf"), device="cuda"))
    return gain.reshape(L, N, d * B)


@pytest.mark.cuda
def test_tree_route_and_walk_match_plain(cuda_device):
    """T3: routing one level and walking whole trees, against their plain
    versions: the same nodes, frozen flags and values, bit for bit."""
    rng = np.random.default_rng(2)
    L, n, d, depth = 3, 500, 7, 4
    codes = torch.as_tensor(rng.integers(0, 256, (n, d)).astype(np.uint8),
                            device="cuda")
    M = 2 ** (depth + 1) - 1
    feat = torch.as_tensor(rng.integers(-1, d, (L, M)).astype(np.int32),
                           device="cuda")
    thr = torch.as_tensor(rng.integers(0, 256, (L, M)).astype(np.int32),
                          device="cuda")
    leaf = torch.as_tensor(rng.random((L, M)) < 0.2, device="cuda")
    value = torch.as_tensor(rng.standard_normal((L, M, 3)).astype(
        np.float32), device="cuda")
    got = tk.walk(codes, feat, thr, leaf, value, depth)
    assert torch.equal(got, tk.walk_plain(codes, feat, thr, leaf, value,
                                          depth))
    out = torch.ones((L, n, 3), device="cuda")
    scale = torch.tensor([0.1, 0.0, 3.0], device="cuda")
    tk.walk(codes, feat, thr, leaf, value, depth, out, scale)
    want = tk.walk_plain(codes, feat, thr, leaf, value, depth,
                         torch.ones((L, n, 3), device="cuda"), scale)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)

    N = 4                                        # level 2: nodes 3 .. 6
    node = torch.as_tensor(rng.integers(3, 7, (L, n)).astype(np.int32),
                           device="cuda")
    frozen = torch.as_tensor(rng.random((L, n)) < 0.3, device="cuda")
    sf = torch.as_tensor(rng.integers(-1, d, (L, N)).astype(np.int32),
                         device="cuda")
    sb = torch.as_tensor(rng.integers(0, 256, (L, N)).astype(np.int32),
                         device="cuda")
    node_p, frozen_p = node.clone(), frozen.clone()
    tk.route(codes, node, frozen, sf, sb, 3)
    tk.route_plain(codes, node_p, frozen_p, sf, sb, 3)
    assert torch.equal(node, node_p) and torch.equal(frozen, frozen_p)


@pytest.mark.cuda
def test_tree_wrappers_raise_instead_of_falling_back(cuda_device):
    codes, local, stats = _tree_inputs(cuda_device, "forest")
    with pytest.raises(TypeError):
        tk.level_histogram(codes.int(), local, stats, 8)
    with pytest.raises(ValueError):
        tk.level_histogram(codes, local.cpu(), stats, 8)
    with pytest.raises(TypeError):
        tk.leaf_values(local.long(), stats, 8, 1e-6)
    hist = tk.level_histogram(codes, local, stats, 8)
    with pytest.raises(ValueError):
        tk.best_splits(hist[..., :100, :], None, 1e-6, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["gb_regressor", "gb_classifier",
                                   "rf_classifier", "rf_regressor"])
def test_tree_search_on_cuda_matches_cpu(cuda_device, label):
    """The four tree families on both devices: mean_test_score within
    1e-4 for the forests and the boosted regressor, the same best
    candidate, and T1-T4 launched on the card only.  T1, T2 and T4 give
    the plain versions' bits on the CPU, boosting stats too (T1 and T4
    add every sum in row order, T2 scans in XLA's order;
    `test_tree_hist_and_leaves_match_plain`), so the trees differ only
    where a torch op rounds differently on the two devices (the Poisson
    draws' log, the classifier's softmax).  The boosted classifier's
    softmax (exp) rounds differently on the two devices, which can turn
    a near-tied split and move a few of the 300 predictions: within 0.01
    (three predictions of a 100-row fold)."""
    rng = np.random.default_rng(4)
    n = 300
    X = rng.standard_normal((n, 6)).astype(np.float32)
    if label in ("gb_classifier", "rf_classifier"):
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int) + (X[:, 2] > 1)
        cv = port.StratifiedKFold(3)
    else:
        y = (X[:, 0] * 2 + X[:, 1] ** 2 + 0.3 * rng.standard_normal(n)
             ).astype(np.float32)
        cv = port.KFold(3)
    est, grid, tol = {
        "gb_regressor": (port.GradientBoostingRegressor(
            max_depth=3, random_state=0), {"n_estimators": [5, 10],
                                           "subsample": [0.8]}, 1e-4),
        "gb_classifier": (port.GradientBoostingClassifier(
            n_estimators=6, max_depth=2), {"learning_rate": [0.1, 0.3]},
                          0.01),
        "rf_classifier": (port.RandomForestClassifier(
            max_depth=5, random_state=0), {"n_estimators": [4, 6]}, 1e-4),
        "rf_regressor": (port.RandomForestRegressor(
            max_depth=5, max_features=0.5), {"n_estimators": [4, 6]},
                         1e-4),
    }[label]
    runs = {}
    for dev in ("cuda", "cpu"):
        tk.reset_launches()
        runs[dev] = port.GridSearchCV(
            est, grid, cv=cv, refit=False,
            config=port.TorchConfig(device=dev)).fit(X, y)
        assert all(v > 0 for v in tk.LAUNCHES.values()) == (dev == "cuda")
    np.testing.assert_allclose(runs["cuda"].cv_results_["mean_test_score"],
                               runs["cpu"].cv_results_["mean_test_score"],
                               rtol=0, atol=tol)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_


# ---------------------------------------------------------------------------
# the MLP step's kernels (M1-M3) and the MLP and Pipeline searches
# ---------------------------------------------------------------------------

def _mlp_inputs(device, B=12, R=200, k=10, h=64, P=4874, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = {
        "Z": 3.0 * torch.randn(B, R, k, generator=g),
        "w": (torch.rand(B, R, generator=g) < 0.67).float(),
        "y": torch.randint(0, k, (R,), generator=g, dtype=torch.int32),
        "Yt": torch.randn(R, k, generator=g),
        "A": torch.randn(B, R, h, generator=g),
        "dH": torch.randn(B, R, h, generator=g),
        "p": 0.3 * torch.randn(B, P, generator=g),
        "g": 0.01 * torch.randn(B, P, generator=g),
        "m": 0.01 * torch.randn(B, P, generator=g),
        "v": 1e-4 * torch.rand(B, P, generator=g),
        "t": torch.full((B,), 3.0),
        "alpha": torch.logspace(-4, 0, B),
        "wsum": 100.0 + torch.rand(B, generator=g),
        "lr": torch.full((B,), 1e-3),
        "loss": torch.rand(B, generator=g),
        "acc": torch.rand(B, generator=g),
    }
    t["wmask"] = torch.arange(P) < P - 100
    t["active"] = torch.arange(B) % 3 != 1
    t["b"] = t["p"][:, :h]                   # a strided slice, as in the fit
    return {name: v.to(device) for name, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("regress", [False, True])
@pytest.mark.parametrize("B,R,k", [(12, 200, 10), (3, 37, 2), (5, 300, 1),
                                   (1, 1, 17)])
def test_mlp_loss_grad_matches_plain(cuda_device, regress, B, R, k):
    """Tolerance: rtol 1e-5 on the loss sums, atol 1e-6 on G; wsum equal.
    Two launches give the same bits (no atomics)."""
    t = _mlp_inputs(cuda_device, B=B, R=R, k=k)
    kw = {"Yt": t["Yt"]} if regress else {"y": t["y"]}
    got = mk.mlp_loss_grad(t["Z"], t["w"], **kw)
    want = mk.mlp_loss_grad_plain(t["Z"], t["w"], t["y"] if not regress
                                  else None, t["Yt"] if regress else None)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    again = mk.mlp_loss_grad(t["Z"], t["w"], **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [True, False])
def test_mlp_opt_step_matches_plain(cuda_device, adam):
    """Tolerance: rtol 1e-5, atol 1e-7 on p, m, v; acc rtol 1e-5;
    inactive lanes keep every bit."""
    t = _mlp_inputs(cuda_device)
    outs = []
    for fn in (mk.mlp_opt_step, mk.mlp_opt_step_plain):
        s = {k: t[k].clone() for k in ("p", "m", "v", "t", "acc")}
        fn(s["p"], t["g"], s["m"], s["v"] if adam else None,
           s["t"] if adam else None, t["wmask"], t["alpha"], t["wsum"],
           t["lr"], t["active"], t["loss"], s["acc"], adam=adam)
        outs.append(s)
    got, want = outs
    for name in ("p", "m", "v"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-5,
                                   atol=1e-7)
    torch.testing.assert_close(got["acc"], want["acc"], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["t"], want["t"], rtol=0, atol=0)
    off = ~t["active"]
    assert torch.equal(got["p"][off], t["p"][off])
    assert torch.equal(got["acc"][off], t["acc"][off])


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh", "logistic", "identity"])
def test_mlp_act_matches_plain(cuda_device, act):
    """Forward rtol 1e-6 (tanh/logistic: the card's expf and tanhf),
    backward atol 1e-6."""
    t = _mlp_inputs(cuda_device)
    H = mk.mlp_act_forward(t["A"], t["b"], act)
    torch.testing.assert_close(H, mk.mlp_act_forward_plain(
        t["A"], t["b"], act), rtol=1e-6, atol=1e-6)
    dA = mk.mlp_act_backward(t["dH"], H, act)
    torch.testing.assert_close(dA, mk.mlp_act_backward_plain(
        t["dH"], H, act), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_mlp_wrappers_raise_instead_of_falling_back(cuda_device):
    t = _mlp_inputs(cuda_device)
    with pytest.raises(TypeError):
        mk.mlp_loss_grad(t["Z"], t["w"], y=t["y"].long())
    with pytest.raises(ValueError):
        mk.mlp_loss_grad(t["Z"], t["w"].cpu(), y=t["y"])
    with pytest.raises(ValueError):
        mk.mlp_act_forward(t["A"], t["b"].t(), "relu")
    with pytest.raises(TypeError):
        mk.mlp_opt_step(t["p"], t["g"], t["m"], t["v"], t["t"],
                        t["wmask"].float(), t["alpha"], t["wsum"], t["lr"],
                        t["active"], t["loss"], t["acc"], adam=True)


def _digits_like(n=600, d=16, k=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    X = rng.standard_normal((k, d))[y] + rng.standard_normal((n, d))
    return X.astype(np.float32), y


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["classifier", "regressor", "svc"])
def test_pipeline_search_on_cuda_matches_cpu(cuda_device, kind):
    """StandardScaler + MLPClassifier / MLPRegressor / SVC, the port's own
    classes: mean_test_score within 5e-3 (the repo's oracle bound), the
    same best candidate, M1-M3 launched on the card only (MLPs), and the
    refit pipeline predicting on the card."""
    X, y = _digits_like()
    if kind == "regressor":
        y = (X[:, 0] - 0.5 * X[:, 1] ** 2).astype(np.float32)
    final = {"classifier": port.MLPClassifier(
                 hidden_layer_sizes=(32,), max_iter=15, random_state=0),
             "regressor": port.MLPRegressor(
                 hidden_layer_sizes=(32,), max_iter=15,
                 learning_rate_init=0.01, random_state=0),
             "svc": port.SVC()}[kind]
    grid = ({"f__C": [0.5, 2.0]} if kind == "svc"
            else {"f__alpha": [1e-4, 1e-1]})
    runs = {}
    for dev in ("cuda", "cpu"):
        mk.reset_launches()
        pipe = port.Pipeline([("scale", port.StandardScaler()),
                              ("f", final)])
        runs[dev] = port.GridSearchCV(
            pipe, grid, cv=3, config=port.TorchConfig(device=dev)).fit(X, y)
        if kind != "svc":
            assert all(v > 0 for v in mk.LAUNCHES.values()) == \
                (dev == "cuda")
    np.testing.assert_allclose(runs["cuda"].cv_results_["mean_test_score"],
                               runs["cpu"].cv_results_["mean_test_score"],
                               rtol=0, atol=5e-3)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_
    assert runs["cuda"].best_estimator_.predict(X[:7]).shape == (7,)
