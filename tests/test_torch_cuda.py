"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions, and small searches, fits and scorer cores
on cuda against the same on the CPU (logistic regression by L-BFGS and
by FISTA, Ridge and LinearRegression in float64, ElasticNet, the 17
scorers, SVC and NuSVC, the tree ensembles, the MLP and Pipeline
searches, the naive Bayes, LDA, KNN and KMeans searches with N1, C1 and
B1, and the rest of the SVMs: P1 and P2 of probability=True, S2's SVR
mode, and the SVC/NuSVC probability, SVR, NuSVR, LinearSVC and LinearSVR
searches; SP1, the sparse X's products, and the searches under
data_mode="sparse"; the keyed fleets' K2ℓ, K4ℓ and C1ℓ, TI1 of the
converted tree ensembles, and the fleets on dicts of columns).  They
skip where no card is visible.

This file imports neither JAX nor sklearn, so it also runs on a machine
that has only PyTorch:  python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
from spark_sklearn_tpu_torch.ops import knn_kernels as knk
from spark_sklearn_tpu_torch.ops import mlp_kernels as mk
from spark_sklearn_tpu_torch.ops import nb_kernels as nbk
from spark_sklearn_tpu_torch.ops import spmm_kernels as spk
from spark_sklearn_tpu_torch.ops import svm_kernels as svk
from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk
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


# (n1, n2, d, G one float off 16-byte alignment): n2 % 4 != 0 with n1 >
# n2 (a float a thread), the scaler + SVC pipeline's n = 2000 (16 bytes a
# thread), n1 < n2, and an unaligned G
GRAM_SHAPES = [(300, 257, 50, False), (2000, 2000, 784, False),
               (257, 1100, 50, False), (300, 300, 50, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,d,shifted", GRAM_SHAPES)
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("kind", ["rbf", "poly", "sigmoid", "linear"])
def test_gram_epilogue_matches_plain(cuda_device, kind, same, n1, n2, d,
                                     shifted):
    """Tolerance: rtol 1e-5, atol 1e-6 — the kernel takes the norms of
    X X^T from the product's diagonal and sums the others in another
    order than torch's, and expf/powf/tanhf round differently from
    torch's kernels by a few ulp.  The rbf diagonal of X X^T is exactly
    1.  One launch a call in every variant, and two launches give the
    same bits."""
    X1, X2 = _gram_inputs(cuda_device, n1=n1, n2=n2, d=d)
    if same:
        X2 = X1
    G0 = X1 @ X2.T

    def fresh():
        flat = torch.empty(G0.numel() + int(shifted), device=cuda_device)
        G = flat[int(shifted):].view(G0.shape)
        return G.copy_(G0)

    want = svk.gram_epilogue_plain(G0.clone(), X1, X2, kind, 0.07, 3.0, 0.5)
    n0 = svk.LAUNCHES["svm_gram_epilogue"]
    got = svk.gram_epilogue(fresh(), X1, X2, kind, 0.07, 3.0, 0.5)
    torch.cuda.synchronize()
    assert svk.LAUNCHES["svm_gram_epilogue"] == n0 + (kind != "linear")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if kind == "rbf" and same:
        assert torch.all(got.diagonal() == 1.0)
    again = svk.gram_epilogue(fresh(), X1, X2, kind, 0.07, 3.0, 0.5)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(2000, 2000), (300, 257), (1, 1),
                                   (5000, 3)])
def test_gram_epilogue_repeats_and_replays_in_a_graph(cuda_device, n1, n2):
    """rbf's cooperative launch (norms, a grid sync, the epilogue): calls
    in a row, alternating X X^T and X1 X2^T, give the first call's bits,
    and so do a CUDA graph's replays of it (the card captures the
    cooperative launch)."""
    X1, X2 = _gram_inputs(cuda_device, n1=n1, n2=n2, d=784)
    outs = {}
    for label, A, B in (("same", X1, X1), ("pair", X1, X2)):
        G0 = A @ B.T
        outs[label] = (G0, A, B, svk.gram_epilogue(G0.clone(), A, B, "rbf",
                                                   0.01, 3.0, 0.0))
    for _ in range(3):
        for G0, A, B, want in outs.values():
            got = svk.gram_epilogue(G0.clone(), A, B, "rbf", 0.01, 3.0, 0.0)
            assert torch.equal(got, want)
    for G0, A, B, want in outs.values():
        work = G0.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            svk.gram_epilogue(work, A, B, "rbf", 0.01, 3.0, 0.0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            work.copy_(G0)
            svk.gram_epilogue(work, A, B, "rbf", 0.01, 3.0, 0.0)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(work, want)


def _step_inputs(device, M, n, seed=0, pairs=False):
    """One S2 step's inputs: elements drawn -1/0/+1 with bounds on ~80%
    of the signed ones, or with `pairs` rows shaped like the SVC search's
    (fold, class pair) subproblems: 10 balanced classes and 5 folds, +-1
    on a pair's two classes, bounds on the fold's training rows (~16% of
    the elements free)."""
    rng = np.random.default_rng(seed)
    if pairs:
        y = rng.permutation(n) % 10
        fold = rng.permutation(n) % 5
        ab = [(a, b) for a in range(10) for b in range(a + 1, 10)]
        r = np.arange(M)
        a, b = np.array(ab)[r % 45].T
        yb = ((y[None] == a[:, None]).astype(float)
              - (y[None] == b[:, None]))
        bound = 1.5 * (yb != 0) * (fold[None] != (r // 45 % 5)[:, None])
    else:
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


# (M, n, forced staged limit or None, pair rows): one row of one element,
# ragged rows, the largest staged row, the streamed plan forced at a small
# n and taken at a real one; the SVC search's pair rows at phase 8's shape
# and at the scaler + SVC pipeline's
STEP_SHAPES = [(7, 300, None, False), (3, 1, None, False),
               (5, 777, None, False), (2, svk.STAGED_MAX_N, None, False),
               (5, 777, 256, False), (2, svk.STAGED_MAX_N + 1, None, False),
               (225, 10000, None, True), (45, 2000, None, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,n,staged_max,pairs", STEP_SHAPES)
@pytest.mark.parametrize("mode", ["svc", "nu", "project"])
def test_dual_step_matches_plain(cuda_device, monkeypatch, mode, M, n,
                                 staged_max, pairs):
    """Tolerance: atol 1e-5 on x', z', w' and 1e-5/step on the residual —
    the bisection's block sums add in another order than torch's, which
    moves the multiplier by rounding only where enough elements are
    free.  `staged_max` forces the streamed plan below its limit."""
    if staged_max is not None:
        monkeypatch.setattr(svk, "STAGED_MAX_N", staged_max)
    V, z, x, yb, bound, target, step = _step_inputs(cuda_device, M, n,
                                                    pairs=pairs)
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
@pytest.mark.parametrize("M,n,pairs", [(33, 3001, False),
                                       (225, 10000, True),
                                       (45, 2000, True)])
@pytest.mark.parametrize("mode", ["svc", "nu"])
def test_dual_step_plans_and_repeats_agree_bitwise(cuda_device, mode, M, n,
                                                   pairs):
    """No atomics: two launches give the same bits, and the staged and
    streamed plans add in the same order, so they agree bitwise too."""
    V, z, x, yb, bound, target, step = _step_inputs(cuda_device, M, n,
                                                    pairs=pairs)
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
@pytest.mark.parametrize("mode", ["svc", "nu"])
def test_dual_step_keeps_nan_and_wide_brackets(cuda_device, mode):
    """S2 leaves out of its bisection sums the elements whose bound or yb
    is 0, but keeps a non-finite one: a NaN in an inert element still
    turns its row NaN, as in the plain version, and the other rows agree
    with it within the tolerances.  A row whose bracket is wider than
    FLT_MAX / 2 sums every element, one step a pass; its sums of values
    near FLT_MAX may round differently from torch's, so that row is held
    to the box and to the same bits in both plans, not to the plain
    version."""
    V, z, x, yb, bound, target, step = _step_inputs(cuda_device, 6, 900,
                                                    pairs=True)
    inert = int(torch.nonzero(bound[1] == 0)[0, 0])
    V[1, inert] = float("nan")
    bound[3] = torch.where(bound[3] > 0, 3.4e38, 0.0)   # a bracket past
    z[3] = x[3] = 0.0                                     # FLT_MAX / 2
    target = None if mode == "svc" else target
    got = svk.dual_step(V, z, x, yb, bound, step, 0.4, target)
    want = svk.dual_step_plain(V, z, x, yb, bound, step, 0.4, target)
    streamed = svk.dual_step(V, z, x, yb, bound, step, 0.4, target,
                             plan="streamed")
    assert torch.isnan(got[0][1]).all() and torch.isnan(want[0][1]).all()
    rows = [0, 2, 4, 5]
    for a, b, atol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-5 / 0.25)):
        torch.testing.assert_close(a[rows], b[rows], rtol=1e-5, atol=atol)
    for a, c in zip(got, streamed):
        assert torch.equal(a.nan_to_num(), c.nan_to_num())
    assert bool((got[0][3] >= 0).all() and (got[0][3] <= bound[3]).all())


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
        launched = all(svk.LAUNCHES[name] > 0 for name in
                       ("svm_gram_epilogue", "svm_dual_step"))
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
    (3, 4100, 63, True), (1, 1, 1, False),
    (6, 100000, 512, False), (6, 100000, 2047, True),   # RF: T1, T4
    (60, 20640, 16, False), (60, 20640, 63, True),      # GB: T1, T4
    (1, 581012, 2047, False), (1, 581012, 512, True),   # covtype, unstaged
    (2, 3000, 10239, False)])
def test_tree_segments_match_plain(cuda_device, L, n, n_nodes, skew):
    """The grouping's counting sort against its plain version (a stable
    torch sort) on CPU copies: the same perm and offs; one block and
    clusters of 3 and 8, every row in one node, skewed nodes; W = 2048
    (T4 at depth 10); the full covtype rows in one lane (ids read twice
    from global memory, not staged); 10239 nodes (two warps a block).
    Two launches give the same bits."""
    local = _tree_inputs(cuda_device, "forest", L, n, 3, n_nodes,
                         skew=skew)[1]
    perm, offs = tk.segments(local, n_nodes)
    want = tk.segments_plain(local.cpu(), n_nodes)
    assert torch.equal(perm.cpu(), want[0])
    assert torch.equal(offs.cpu(), want[1])
    again = tk.segments(local, n_nodes)
    assert torch.equal(perm, again[0]) and torch.equal(offs, again[1])


def _plan_edge(L, n_nodes, n_sm, where):
    """A row count at an edge of G's plan: the most rows whose ids are
    staged and the fewest that are not ("staged", "unstaged"), or one
    whose last block holds one row or a full slice ("one", "full")."""
    def plan(n):
        return tk.segments_plan(L, n, n_nodes, n_sm)
    if where in ("staged", "unstaged"):
        lo, hi = 1, 2 ** 31 // L - 1       # plan(lo) staged, plan(hi) not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if plan(mid)["stage"] else (lo, mid)
        return lo if where == "staged" else hi
    for n in range(2000, 60000):
        p = plan(n)
        if p["cluster"] > 1 and n % p["rows"] == (1 if where == "one"
                                                   else 0):
            return n
    raise AssertionError(f"no {where} edge")


@pytest.mark.cuda
@pytest.mark.parametrize("L,n_nodes,where", [
    (1, 512, "staged"), (1, 512, "unstaged"), (6, 2047, "staged"),
    (6, 2047, "unstaged"), (2, 16, "one"), (2, 16, "full"),
    (6, 512, "one")])
def test_tree_segments_at_the_plans_edges(cuda_device, L, n_nodes, where):
    """G at the edges of its plan, against the plain version: n just
    below and just above what a block's shared memory stages, and a
    cluster whose last block holds one row or a whole slice."""
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n = _plan_edge(L, n_nodes, n_sm, where)
    if where in ("staged", "unstaged"):
        assert tk.segments_plan(L, n, n_nodes, n_sm)["stage"] == (
            where == "staged")
    local = _tree_inputs(cuda_device, "forest", L, n, 3, n_nodes,
                         skew=True)[1]
    perm, offs = tk.segments(local, n_nodes)
    want = tk.segments_plain(local.cpu(), n_nodes)
    assert torch.equal(perm.cpu(), want[0])
    assert torch.equal(offs.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("L,n,n_nodes", [(3, 700, 8), (6, 100000, 512),
                                         (1, 581012, 2047)])
def test_tree_segments_with_every_row_out(cuda_device, L, n, n_nodes):
    """Every row with local < 0 (key n_nodes): each lane's rows in its
    last slot, in row order, every node's slot empty."""
    local = torch.full((L, n), -1, dtype=torch.int32, device=cuda_device)
    perm, offs = tk.segments(local, n_nodes)
    want = tk.segments_plain(local.cpu(), n_nodes)
    assert torch.equal(perm.cpu(), want[0])
    assert torch.equal(offs.cpu(), want[1])


# (kind, L, n, d, n_nodes, classes, mask): no mask and a random one (S =
# 5 forest, S = 2 boosting), nodes with every feature masked, one kept
# feature, and the RF classifier's draw of 7 of 54 features at the root
# and at 512 nodes, with forest (S = 8) and boosting (S = 2) stats
SPLIT_CASES = [(kind, 3, 700, 9, 16, 4, mask)
               for kind in ("forest", "boosting")
               for mask in (None, "random", "all-masked nodes",
                            "one feature")] + [
    (kind, L, 3000, 54, nodes, 7, "seven")
    for kind in ("forest", "boosting") for L, nodes in ((3, 1), (1, 512))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,L,n,d,n_nodes,classes,mask", SPLIT_CASES)
def test_tree_best_split_matches_plain(cuda_device, kind, L, n, d, n_nodes,
                                       classes, mask):
    """T2 on one histogram against its plain version: on integer stats
    the same feature, bin, split and gain everywhere; on continuous ones
    the same where the two best gains are apart, gains within rounding.
    A node with no finite gain (every feature masked) gets flat index 0,
    as argmax over all -inf does."""
    codes, local, stats = _tree_inputs(cuda_device, kind, L, n, d, n_nodes,
                                       classes=classes)
    hist = tk.level_histogram_plain(codes, local, stats, n_nodes)
    fmask = None
    if mask is not None:
        g = torch.Generator(device="cuda").manual_seed(1)
        sc = torch.rand((n_nodes, d), generator=g, device="cuda")
        if mask == "seven":
            fmask = sc <= torch.sort(sc, dim=1).values[:, 6:7]
        elif mask == "one feature":
            fmask = sc == sc.max(dim=1, keepdim=True).values
        else:
            fmask = sc < 0.4
        if mask == "all-masked nodes":
            fmask[::3] = False
    got = tk.best_splits(hist, fmask, 1e-6, 1.0)
    want = tk.best_splits_plain(hist, fmask, 1e-6, 1.0)
    again = tk.best_splits(hist, fmask, 1e-6, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if mask == "all-masked nodes":
        assert (got[0][:, ::3] == 0).all() and (got[1][:, ::3] == 0).all()
        assert torch.isneginf(got[2][:, ::3]).all()
    if kind == "forest":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
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


def _random_trees(rng, device, L, M, d, n_out):
    """Random heaps (feat -1 in about one node of 8d+1, a fifth of the
    nodes leaves) and leaf values."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return (t(rng.integers(-1, d, (L, M)).astype(np.int32)),
            t(rng.integers(0, 256, (L, M)).astype(np.int32)),
            t(rng.random((L, M)) < 0.2),
            t(rng.standard_normal((L, M, n_out)).astype(np.float32)))


def _level_state(device, L, n, d, depth, level, seed=0):
    """A level's state as the grower leaves it (frozen rows at shallower
    nodes, the others at the level's nodes; inactive rows; splits with
    non-splitting nodes; a heap of random contents)."""
    rng = np.random.default_rng(seed)
    N = 2 ** level
    offset = N - 1
    M = 2 ** (depth + 1) - 1
    frozen = (rng.random((L, n)) < 0.3) & (level > 0)
    node = np.where(frozen, rng.integers(0, max(offset, 1), (L, n)),
                    rng.integers(offset, offset + N, (L, n)))
    split = rng.random((L, N)) < 0.7
    split[0, 0], split[-1, -1] = True, False
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a).astype(dt),
                                      device=device)
    feat, thresh, is_leaf, _ = _random_trees(rng, device, L, M, d, 1)
    return dict(codes=t(rng.integers(0, 256, (n, d)), np.uint8),
                node=t(node, np.int32),
                active=t(rng.random((L, n)) < 0.8, bool),
                bf=t(rng.integers(0, d, (L, N)), np.int32),
                bb=t(rng.integers(0, 256, (L, N)), np.int32),
                split=t(split, bool), feat=feat, thresh=thresh,
                is_leaf=is_leaf,
                local=torch.full((L, n), 7, dtype=torch.int32,
                                 device=device))


def _level_step_pair(st, last):
    """The level step on the card and its plain version on copies of the
    same state: (kernel's state, plain's state)."""
    names = ("node", "feat", "thresh", "is_leaf", "local")
    out = []
    for fn in (tk.level_step, tk.level_step_plain):
        c = {k: st[k].clone() for k in names}
        fn(st["codes"], c["node"], st["active"], st["bf"], st["bb"],
           st["split"], c["feat"], c["thresh"], c["is_leaf"], c["local"],
           last)
        out.append(c)
    return out


@pytest.mark.cuda
def test_tree_route_and_walk_match_plain(cuda_device):
    """T3: one level step and the walk of whole trees, against their
    plain versions: the same nodes, keys, heap and values, bit for bit.
    The walk's update rounds once on both sides (the kernel's fma; the
    plain `addcmul_`, one fma on the card), so it is held equal too."""
    rng = np.random.default_rng(2)
    L, n, d, depth = 3, 500, 7, 4
    codes = torch.as_tensor(rng.integers(0, 256, (n, d)).astype(np.uint8),
                            device="cuda")
    M = 2 ** (depth + 1) - 1
    feat, thr, leaf, value = _random_trees(rng, "cuda", L, M, d, 3)
    got = tk.walk(codes, feat, thr, leaf, value, depth)
    assert torch.equal(got, tk.walk_plain(codes, feat, thr, leaf, value,
                                          depth))
    out = torch.ones((L, n, 3), device="cuda")
    scale = torch.tensor([0.1, 0.0, 3.0], device="cuda")
    tk.walk(codes, feat, thr, leaf, value, depth, out, scale)
    want = tk.walk_plain(codes, feat, thr, leaf, value, depth,
                         torch.ones((L, n, 3), device="cuda"), scale)
    assert torch.equal(out, want)

    st = _level_state(cuda_device, L, n, d, depth, 2)   # nodes 3 .. 6
    got, want = _level_step_pair(st, last=False)
    for k in got:
        assert torch.equal(got[k], want[k]), k


# (L, n, d, depth, level): the first, a middle and the last level of a
# depth-5 tree; phase 10's forest lanes at depth 10 (a middle level and
# the last); phase 9's 60 boosting lanes (spread over lane groups); d too
# wide to stage the codes; one row
LEVEL_CASES = [(3, 700, 9, 5, lv) for lv in (0, 2, 4)] + [
    (6, 3000, 54, 10, 5), (6, 3000, 54, 10, 9), (60, 2000, 8, 5, 3),
    (60, 2000, 8, 5, 4), (2, 300, 784, 4, 3), (1, 1, 3, 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("L,n,d,depth,level", LEVEL_CASES)
def test_tree_level_step_matches_plain(cuda_device, L, n, d, depth, level):
    """T3's level step against its plain version at the first, middle and
    last levels: nodes, keys and heap equal; two launches equal."""
    st = _level_state(cuda_device, L, n, d, depth, level, seed=level + d)
    last = level == depth - 1
    got, want = _level_step_pair(st, last)
    again, _ = _level_step_pair(st, last)
    for k in got:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], again[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("L,n,M,n_out", [(6, 3000, 2047, 7), (60, 2000, 63,
                                                             1),
                                         (3, 1, 7, 3)])
def test_tree_accumulate_matches_plain(cuda_device, L, n, M, n_out):
    """T3's accumulate against its plain version: equal (one fma each)."""
    rng = np.random.default_rng(n)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    node = t(rng.integers(0, M, (L, n)).astype(np.int32))
    value = t(rng.standard_normal((L, M, n_out)).astype(np.float32))
    out = t(rng.standard_normal((L, n, n_out)).astype(np.float32))
    scale = t(rng.uniform(0, 1, L).astype(np.float32))
    want = tk.accumulate_plain(value, node, out.clone(), scale)
    got = tk.accumulate(value, node, out.clone(), scale)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_tree_walk_at_depth_10_matches_plain(cuda_device):
    """The walk at phase 10's shape cut in rows: 6 lanes, d = 54, depth
    10 (two lane groups' trees in shared memory); equal."""
    rng = np.random.default_rng(10)
    L, n, d, depth = 6, 4000, 54, 10
    codes = torch.as_tensor(rng.integers(0, 256, (n, d)).astype(np.uint8),
                            device="cuda")
    M = 2 ** (depth + 1) - 1
    feat, thr, leaf, value = _random_trees(rng, "cuda", L, M, d, 7)
    leaf[:, :M // 2] = False                  # deep walks
    assert torch.equal(tk.walk(codes, feat, thr, leaf, value, depth),
                       tk.walk_plain(codes, feat, thr, leaf, value, depth))
    out = torch.randn((L, n, 7), device="cuda")
    scale = torch.rand(L, device="cuda")
    want = tk.walk_plain(codes, feat, thr, leaf, value, depth, out.clone(),
                         scale)
    assert torch.equal(tk.walk(codes, feat, thr, leaf, value, depth,
                               out.clone(), scale), want)


@pytest.mark.cuda
@pytest.mark.parametrize("forest", [True, False])
def test_tree_grower_nodes_give_the_walks_update_on_cuda(cuda_device,
                                                         forest):
    """On the card, as on the CPU: the grower's final nodes give the
    walk's update bit for bit (rows of weight 0, feature masks)."""
    from spark_sklearn_tpu_torch.ops import random as jr
    from spark_sklearn_tpu_torch.ops import trees as pt
    rng = np.random.default_rng(6)
    L, n, d, depth = 3, 2000, 9, 6
    codes = torch.as_tensor(rng.integers(0, 256, (n, d)).astype(np.uint8),
                            device="cuda")
    k = 3 if forest else 1
    g = torch.as_tensor(rng.standard_normal((L, n, k)).astype(np.float32),
                        device="cuda")
    h = torch.ones((L, n), device="cuda")
    w = torch.as_tensor((rng.poisson(1.0, (L, n))).astype(np.float32),
                        device="cuda")
    tree, node = pt.grow_tree(
        codes, g, h, w, depth, 256, 1.0, 1e-6,
        feat_mask_key=jr.fold_in(jr.PRNGKey(0), 7) if forest else None,
        max_features=4 if forest else None, n_out=k)
    scale = torch.tensor([0.5, 0.0, 2.0], device="cuda")
    walked = torch.ones((L, n, k), device="cuda")
    grown = walked.clone()
    pt.accumulate_tree(tree, codes, depth, walked, scale)
    pt.accumulate_leaves(tree, node, grown, scale)
    assert torch.equal(grown, walked)


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
    st = _level_state(cuda_device, 3, 500, 7, 4, 2)
    args = [st[k] for k in ("codes", "node", "active", "bf", "bb", "split",
                            "feat", "thresh", "is_leaf", "local")]
    for i, bad in ((1, st["node"].long()), (2, st["active"].int()),
                   (9, st["local"][:, :10]), (6, st["feat"][:, :5])):
        with pytest.raises((TypeError, ValueError)):
            tk.level_step(*args[:i], bad, *args[i + 1:], False)
    value = torch.zeros((3, 31, 1), device="cuda")
    with pytest.raises(TypeError):
        tk.accumulate(value, st["node"].long(), torch.zeros(
            (3, 500, 1), device="cuda"), torch.ones(3, device="cuda"))
    with pytest.raises(ValueError):
        tk.accumulate(value, st["node"], torch.zeros(
            (3, 500, 2), device="cuda"), torch.ones(3, device="cuda"))


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
                                   (1, 1, 17), (4, 1, 10), (6, 45, 10),
                                   (6, 200, 1), (2, 700, 3), (3, 33, 1),
                                   (4, 201, 3), (3, 150, 300),
                                   (2, 1000, 10), (2, 1000, 1),
                                   (2, 7, 9000)])
def test_mlp_loss_grad_matches_plain(cuda_device, regress, B, R, k):
    """Tolerance: rtol 1e-5 on the loss sums, atol 1e-6 on G and on db
    (the output bias gradient, G summed over the rows); wsum equal.  Two
    launches give the same bits (no atomics).  R = 1, R not a multiple of
    32, R above the block's 256 threads (several tiles of rows: 700, 1000
    at k = 1 and 10), R k not a multiple of 4 (a lane's logits start off
    16-byte alignment), k = 1 and k = 10, k = 300 (tiles of a few dozen
    rows) and k = 9000 (a row wider than the stage: unstaged)."""
    t = _mlp_inputs(cuda_device, B=B, R=R, k=k)
    kw = {"Yt": t["Yt"]} if regress else {"y": t["y"]}
    got = mk.mlp_loss_grad(t["Z"], t["w"], **kw)
    want = mk.mlp_loss_grad_plain(t["Z"], t["w"], t["y"] if not regress
                                  else None, t["Yt"] if regress else None)
    assert got[3].shape == (B, k)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)
    again = mk.mlp_loss_grad(t["Z"], t["w"], **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _loss_grad_rows(Z, w, y=None, Yt=None):
    """M1's G and wsum with each row's operations in the kernel's order
    (the max over j, exp(z - max) summed over j in order, scale (e / se -
    onehot)), on the card's own expf and IEEE division; the plain
    version's softmax sums its row in another order."""
    wsum = torch.clamp_min(w.sum(dim=1), 1.0)
    scale = (w / wsum[:, None])[:, :, None]
    if Yt is not None:
        return wsum, scale * (Z - Yt[None])
    e = torch.exp(Z - Z.amax(dim=2, keepdim=True))
    se = torch.zeros_like(e[..., 0])
    for j in range(Z.shape[2]):
        se = se + e[..., j]
    onehot = torch.nn.functional.one_hot(y.long(), Z.shape[2]).to(Z.dtype)
    return wsum, scale * (e / se[..., None] - onehot[None])


@pytest.mark.cuda
@pytest.mark.parametrize("regress", [False, True])
@pytest.mark.parametrize("B,R,k,shift", [(12, 200, 10, 0), (6, 200, 1, 0),
                                         (4, 201, 3, 1), (2, 1000, 10, 3),
                                         (3, 150, 300, 2), (2, 7, 9000, 0)])
def test_mlp_loss_grad_keeps_g_and_wsum_bits_with_whole_weights(
        cuda_device, regress, B, R, k, shift):
    """With fold weights of 0 and 1, wsum is exact in any order, and G's
    per-row arithmetic is the plain version's (the regressor) or the
    kernel's row order above (the classifier): both bit for bit.  Z
    `shift` floats off 16-byte alignment."""
    t = _mlp_inputs(cuda_device, B=B, R=R, k=k)
    flat = torch.empty(B * R * k + shift, device=cuda_device)
    Z = flat[shift:].view(B, R, k)
    Z.copy_(t["Z"])
    kw = {"Yt": t["Yt"]} if regress else {"y": t["y"]}
    _, wsum, G, _ = mk.mlp_loss_grad(Z, t["w"], **kw)
    want_wsum, want_G = _loss_grad_rows(Z, t["w"], **kw)
    assert torch.equal(wsum, want_wsum)
    assert torch.equal(G, want_G)
    if regress:
        plain = mk.mlp_loss_grad_plain(Z, t["w"], None, t["Yt"])
        assert torch.equal(G, plain[2]) and torch.equal(wsum, plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("regress", [False, True])
def test_mlp_loss_grad_clamps_an_all_zero_lane(cuda_device, regress):
    """A lane whose weights are all 0 (a fold with no row in the batch):
    wsum clamps to 1, its loss and G are 0, as the plain version's."""
    t = _mlp_inputs(cuda_device, B=5, R=200, k=10)
    t["w"][2] = 0.0
    kw = {"Yt": t["Yt"]} if regress else {"y": t["y"]}
    got = mk.mlp_loss_grad(t["Z"], t["w"], **kw)
    want = mk.mlp_loss_grad_plain(t["Z"], t["w"], t["y"] if not regress
                                  else None, t["Yt"] if regress else None)
    assert float(got[1][2]) == 1.0 and float(got[0][2]) == 0.0
    assert not bool(got[2][2].any()) and not bool(got[3][2].any())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [True, False])
@pytest.mark.parametrize("P", [4874, 641, 20001])
def test_mlp_opt_step_matches_plain(cuda_device, adam, P):
    """Tolerance: rtol 1e-5, atol 1e-7 on p, m, v; acc rtol 1e-5;
    inactive lanes keep every bit; two launches give the same bits.  P
    4874 (BASELINE #5: 20 rounds of 256, 8 blocks a lane), 641 (the
    MLPRegressor's: 3 blocks) and 20001 (two waves of 8 blocks x 8
    rounds), none a multiple of a block's 256 or of 4 floats."""
    t = _mlp_inputs(cuda_device, P=P)
    outs = []
    for fn in (mk.mlp_opt_step, mk.mlp_opt_step_plain, mk.mlp_opt_step):
        s = {k: t[k].clone() for k in ("p", "m", "v", "t", "acc")}
        fn(s["p"], t["g"], s["m"], s["v"] if adam else None,
           s["t"] if adam else None, t["wmask"], t["alpha"], t["wsum"],
           t["lr"], t["active"], t["loss"], s["acc"], adam=adam)
        outs.append(s)
    got, want, again = outs
    for name in ("p", "m", "v"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-5,
                                   atol=1e-7)
    torch.testing.assert_close(got["acc"], want["acc"], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["t"], want["t"], rtol=0, atol=0)
    for name in got:
        assert torch.equal(got[name], again[name]), name
    off = ~t["active"]
    for name in ("p", "m", "v", "t", "acc"):
        assert torch.equal(got[name][off], t[name][off]), name


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
@pytest.mark.parametrize("act", ["relu", "tanh", "logistic", "identity"])
@pytest.mark.parametrize("B,R,h,layout", [
    (12, 200, 64, "fit"), (1, 1797, 64, "fit"), (6, 1, 64, "fit"),
    (3, 37, 5, "fit"), (2, 33, 3, "fit"), (4, 50, 64, "shifted"),
    (70000, 1, 4, "fit")])
def test_mlp_act_matches_plain_at_every_layout(cuda_device, act, B, R, h,
                                               layout):
    """M3 against its plain version at the layouts the fit gives it and
    around them: 16 bytes a thread (h a multiple of 4; BASELINE #5's step,
    a view's one lane, one row), a float a thread (h = 5 and 3, and A one
    float off 16-byte alignment), more lanes than a grid's rows; the bias
    a strided slice of the flat parameters (an odd row stride).  Forward
    rtol 1e-6 atol 1e-6, backward atol 1e-6; two launches give the same
    bits."""
    g = torch.Generator(device="cpu").manual_seed(B * R * h)
    A = torch.randn(B * R * h + 1, generator=g).to(cuda_device)
    A = (A[1:] if layout == "shifted" else A[:-1]).view(B, R, h)
    dH = torch.randn(B, R, h, generator=g).to(cuda_device)
    p = torch.randn(B, 2 * h + 3, generator=g).to(cuda_device)
    b = p[:, 3:3 + h]
    H = mk.mlp_act_forward(A, b, act)
    torch.testing.assert_close(H, mk.mlp_act_forward_plain(A, b, act),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(H, mk.mlp_act_forward(A, b, act))
    for dh, hv in ((dH, H), (dH[..., :h - 1].contiguous(),
                             H[..., :h - 1].contiguous())):
        if dh.numel() == 0:
            continue
        dA = mk.mlp_act_backward(dh, hv, act)
        torch.testing.assert_close(dA, mk.mlp_act_backward_plain(
            dh, hv, act), rtol=1e-6, atol=1e-6)
        assert torch.equal(dA, mk.mlp_act_backward(dh, hv, act))


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
    with pytest.raises(ValueError):
        mk.mlp_opt_step(t["p"], t["g"][:, :100], t["m"], t["v"], t["t"],
                        t["wmask"], t["alpha"], t["wsum"], t["lr"],
                        t["active"], t["loss"], t["acc"], adam=True)
    with pytest.raises(ValueError):
        mk.mlp_opt_step(t["p"], t["g"], t["m"], None, None, t["wmask"],
                        t["alpha"], t["wsum"], t["lr"], t["active"].cpu(),
                        t["loss"], t["acc"], adam=False)


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


# --- N1 (knn_fold_topk), C1 (kmeans_assign), B1 (gnb_jll) -----------------

def _topk_inputs(m, n, F, d=12, seed=0, dup=False, device="cuda"):
    rng = np.random.default_rng(seed)
    Xc = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        Xc[n // 2:] = Xc[:n - n // 2]                  # exact duplicates
    Xr = Xc[:m] if m <= n else rng.standard_normal((m, d)).astype(
        np.float32)
    masks = (rng.random((F, n)) < 0.7).astype(np.float32)
    Xr_t, Xc_t = (torch.as_tensor(a, device=device) for a in (Xr, Xc))
    G = Xr_t @ Xc_t.T
    return (G, (Xr_t * Xr_t).sum(1), (Xc_t * Xc_t).sum(1),
            torch.as_tensor(masks, device=device))


def _check_topk(G, sq_r, sq_c, masks, maxk, plan=None):
    n0 = knk.LAUNCHES["knn_fold_topk"]
    d2, idx = knk.knn_fold_topk(G, sq_r, sq_c, masks, maxk, plan=plan)
    torch.cuda.synchronize()
    assert knk.LAUNCHES["knn_fold_topk"] == n0 + 1
    pd2, pidx = knk.knn_fold_topk_plain(G, sq_r, sq_c, masks, maxk)
    assert torch.equal(idx, pidx)
    assert torch.equal(d2, pd2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,F,maxk,dup", [
    (300, 300, 5, 1, False), (300, 300, 5, 15, False),
    (257, 1500, 3, knk.MAX_K, False),        # maxk at its limit
    (200, 200, 4, 9, True),                  # exact duplicates: ties
    (61, 700, 1, 33, False),                 # m != n: new rows, one mask
    (50, 30000, 2, 20, False),               # n past the radix stage
    (400, 2000, 5, knk.WARP_MAX_K, False),   # the warp plan's limit
    (400, 2000, 5, knk.WARP_MAX_K + 1, False),   # just past it: radix
    (300, 1000, 10, 7, False),               # two fold groups of 5
    (129, 999, 9, 16, True),                 # groups of 5 and 4, ties
    (20, 100003, 8, 5, False),               # mask bits past the stage
])
def test_knn_fold_topk_matches_plain(cuda_device, m, n, F, maxk, dup):
    """Equal to the plain version (a stable sort): the same distances,
    bit for bit, and the same columns in the same order, under the plan
    `topk_plan` picks."""
    _check_topk(*_topk_inputs(m, n, F, dup=dup), maxk)


@pytest.mark.cuda
def test_knn_fold_topk_at_the_regressor_shape(cuda_device):
    """The KNN regressor search's chunk: n=20640, d=8 (California-shaped),
    5 folds, max_k 15, every row its own column; the warp plan."""
    assert knk.topk_plan(20640, 15, 5)["plan"] == "warp"
    _check_topk(*_topk_inputs(20640, 20640, 5, d=8, seed=3), 15)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", knk.PLANS)
@pytest.mark.parametrize("maxk,dup", [(1, False), (15, True), (32, False)])
def test_knn_fold_topk_each_plan(cuda_device, plan, maxk, dup):
    """Every plan, asked for by name, on the same inputs: each equal to
    the plain version."""
    _check_topk(*_topk_inputs(150, 3000, 6, dup=dup), maxk, plan=plan)


@pytest.mark.cuda
def test_knn_fold_topk_short_fold_and_limits(cuda_device):
    """A fold with fewer train columns than maxk ends in +inf on the
    lowest masked columns (as the plain sort), under every plan; maxk
    above the limit or above n raises, as does a plan that cannot take
    the shape; CPU inputs to a CUDA call raise."""
    G, sq_r, sq_c, masks = _topk_inputs(120, 120, 2)
    masks[1] = 0.0
    masks[1, [5, 40, 77]] = 1.0
    for plan in knk.PLANS:
        _check_topk(G, sq_r, sq_c, masks, 10, plan=plan)
    with pytest.raises(ValueError, match="kernel's limit"):
        knk.knn_fold_topk(G, sq_r, sq_c, masks, knk.MAX_K + 1)
    with pytest.raises(ValueError, match="exceeds"):
        knk.knn_fold_topk(G[:, :5].contiguous(), sq_r, sq_c[:5],
                          masks[:, :5].contiguous(), 6)
    with pytest.raises(ValueError, match="cannot take"):
        knk.knn_fold_topk(G, sq_r, sq_c, masks, knk.WARP_MAX_K + 1,
                          plan="warp")
    with pytest.raises(ValueError):
        knk.knn_fold_topk(G, sq_r, sq_c, masks.cpu(), 3)
    with pytest.raises(TypeError):
        knk.knn_fold_topk(G.double(), sq_r, sq_c, masks, 3)


def _assign_inputs(n, B, k, d=10, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                        device="cuda")
    C = torch.as_tensor(rng.standard_normal((B, k, d)).astype(np.float32),
                        device="cuda")
    if ties:
        C[:, 1::2] = C[:, ::2][:, :C[:, 1::2].shape[1]]
    w = torch.as_tensor((rng.random((B, n)) < 0.8).astype(np.float32),
                        device="cuda")
    w[0] = 0.0                                         # a zero-weight lane
    return X, C, (X * X).sum(1), (C * C).sum(2), w


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,k,d,ties", [
    (1000, 4, 1, 10, False),
    (5000, 20, 8, 54, False),                # the Lloyd step's lanes and d
    (777, 3, 6, 10, True),                   # tied centers
    (1001, 5, 64, 54, False),                # k in 8 chunks of 8
    (333, 7, 13, 784, False),                # d in tiles, k = 8 + 5
    (300, 8, 64, 784, False),                # B k d = 1.6 MB of centers
    (129, 60, 7, 54, True),                  # 15 groups of 4 lanes, ties
    (5, 2, 3, 3, False),                     # fewer rows than a warp
])
def test_kmeans_assign_matches_plain(cuda_device, n, B, k, d, ties):
    """assign and min_d2 equal to the plain version bit for bit (the
    same dot order, the first center on ties), inertia rtol 1e-5
    (another summation order over the rows), and two calls give the same
    bits."""
    X, C, xx, cc, w = _assign_inputs(n, B, k, d=d, ties=ties)
    n0 = kmk.LAUNCHES["kmeans_assign"]
    a, m, s = kmk.kmeans_assign(X, C, xx, cc, w)
    a2, m2, s2 = kmk.kmeans_assign(X, C, xx, cc, w)
    torch.cuda.synchronize()
    assert kmk.LAUNCHES["kmeans_assign"] == n0 + 2
    pa, pm, ps = kmk.kmeans_assign_plain(X, C, xx, cc, w)
    assert torch.equal(a, pa) and torch.equal(m, pm)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-6)
    assert s[0].item() == 0.0
    assert torch.equal(a, a2) and torch.equal(m, m2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_kmeans_assign_nan_and_bad_input(cuda_device, monkeypatch):
    """A NaN in X makes every center of its row NaN: center 0 and a NaN
    distance, as the plain version; bad shapes, devices and a grid past
    its lane groups raise."""
    X, C, xx, cc, w = _assign_inputs(300, 2, 4, d=54)
    X[7, 20] = float("nan")
    xx = (X * X).sum(1)
    a, m, s = kmk.kmeans_assign(X, C, xx, cc, w)
    pa, pm, ps = kmk.kmeans_assign_plain(X, C, xx, cc, w)
    assert torch.equal(a, pa)
    assert torch.equal(torch.isnan(m), torch.isnan(pm))
    assert torch.equal(m[~torch.isnan(m)], pm[~torch.isnan(pm)])
    assert a[1, 7].item() == 0 and torch.isnan(m[1, 7])
    assert torch.isnan(s).all() and torch.isnan(ps).all()   # 0 x NaN
    with pytest.raises(ValueError):
        kmk.kmeans_assign(X, C, xx, cc, w[:, :10].contiguous())
    with pytest.raises(ValueError):
        kmk.kmeans_assign(X, C, xx.cpu(), cc, w)
    with pytest.raises(ValueError):
        kmk.kmeans_assign(X, C[:, :, :5].contiguous(), xx, cc, w)
    X, C, xx, cc, w = _assign_inputs(300, 9, 4, d=54)      # 9 groups of 1
    monkeypatch.setattr(kmk, "MAX_LANE_GROUPS", 8)
    with pytest.raises(ValueError, match="lane groups"):
        kmk.kmeans_assign(X, C, xx, cc, w)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,B,k,floor", [
    (1000, 54, 6, 7, False), (333, 784, 3, 10, False),   # m % tile != 0
    (100, 3000, 2, 5, False),                 # d past a tile of 32 rows
    (257, 64, 4, 3, True),                    # var at its epsilon floor
])
def test_gnb_jll_matches_plain(cuda_device, m, d, B, k, floor):
    """rtol 1e-5 against the plain version (another summation order over
    d; the kernel multiplies by the correctly rounded 1/var where the
    plain version divides), atol 1e-3 on jlls reaching ~1e5 at the
    floor."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((m, d)).astype(np.float32)
    theta = rng.standard_normal((B, k, d)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, (B, k, d)).astype(np.float32)
    if floor:
        var[:, :, ::3] = 1e-9 * var.max()
    lp = np.log(rng.dirichlet(np.ones(k), B)).astype(np.float32)
    t = [torch.as_tensor(a, device="cuda") for a in (X, theta, var, lp)]
    n0 = nbk.LAUNCHES["gnb_jll"]
    got = nbk.gnb_jll(*t)
    torch.cuda.synchronize()
    assert nbk.LAUNCHES["gnb_jll"] == n0 + 1
    torch.testing.assert_close(got, nbk.gnb_jll_plain(*t), rtol=1e-5,
                               atol=1e-3)
    with pytest.raises(ValueError):
        nbk.gnb_jll(t[0], t[1], t[2][:, :, :5].contiguous(), t[3])
    with pytest.raises(TypeError):
        nbk.gnb_jll(t[0].double(), *t[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "multinomial", "bernoulli",
                                  "categorical", "lda", "knn", "knn_reg",
                                  "kmeans"])
def test_slice_search_on_cuda_matches_cpu(cuda_device, kind):
    """Each family of the slice on cuda against the CPU: mean_test_score
    within 5e-3 (the repo's oracle bound; 1e-3 relative for KMeans'
    -inertia), the same best candidate, the kernel launched on the card
    only, and the refit estimator predicting on the card."""
    X, y = _digits_like()
    counts = np.round(np.abs(X) * 3)
    est, grid, data, launches = {
        "gaussian": (port.GaussianNB(), {"var_smoothing": [1e-9, 1e-3]},
                     (X, y), nbk.LAUNCHES),
        "multinomial": (port.MultinomialNB(), {"alpha": [0.1, 1.0]},
                        (counts, y), None),
        "bernoulli": (port.BernoulliNB(binarize=0.2), {"alpha": [0.1, 1.0]},
                      (X, y), None),
        "categorical": (port.CategoricalNB(), {"alpha": [0.1, 1.0]},
                        (counts.astype(np.int64), y), None),
        "lda": (port.LinearDiscriminantAnalysis(solver="lsqr"),
                {"shrinkage": [0.0, 0.1, 0.9]}, (X, y), None),
        "knn": (port.KNeighborsClassifier(),
                {"n_neighbors": [1, 5], "weights": ["uniform", "distance"]},
                (X, y), knk.LAUNCHES),
        "knn_reg": (port.KNeighborsRegressor(), {"n_neighbors": [1, 5]},
                    (X, X[:, 0] * 2), knk.LAUNCHES),
        "kmeans": (port.KMeans(n_clusters=4, random_state=0),
                   {"tol": [1e-4, 1e-2]}, (X, None), kmk.LAUNCHES),
    }[kind]
    runs = {}
    for dev in ("cuda", "cpu"):
        if launches is not None:
            for name in launches:
                launches[name] = 0
        runs[dev] = port.GridSearchCV(
            est, grid, cv=3, config=port.TorchConfig(device=dev)).fit(*data)
        if launches is not None:
            assert (min(launches.values()) > 0) == (dev == "cuda")
    a = runs["cuda"].cv_results_["mean_test_score"]
    b = runs["cpu"].cv_results_["mean_test_score"]
    tol = 1e-3 * np.abs(b).max() if kind == "kmeans" else 5e-3
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_
    assert runs["cuda"].best_estimator_.predict(data[0][:7]).shape == (7,)


# --- B1 (second design), P1 (svm_platt_fit), P2 (svm_pair_coupling), S2's
# --- SVR mode, and the rest of the SVMs' searches -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,d,B,k", [
    (257, 130, 5, 11),            # two X chunks, two class chunks, a tail
    (3000, 54, 40, 7),            # several lane groups
    (31, 7, 1, 1),
])
def test_gnb_jll_redesign_matches_plain_with_nan(cuda_device, m, d, B, k):
    """B1 where its plan splits features, classes, lanes and rows: rtol
    1e-5, atol 1e-3 against the plain version (the reciprocal of var
    multiplied, not divided; sums in another order), and a NaN var's
    class NaN in every row of its lane, as the plain version's."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((m, d)).astype(np.float32)
    theta = rng.standard_normal((B, k, d)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, (B, k, d)).astype(np.float32)
    var[0, k - 1, d // 2] = np.nan
    lp = np.log(rng.dirichlet(np.ones(k), B)).astype(np.float32)
    t = [torch.as_tensor(a, device="cuda") for a in (X, theta, var, lp)]
    got = nbk.gnb_jll(*t)
    want = nbk.gnb_jll_plain(*t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3,
                               equal_nan=True)
    assert bool(torch.isnan(got[0, :, k - 1]).all())
    torch.testing.assert_close(got, nbk.gnb_jll(*t), rtol=0, atol=0,
                               equal_nan=True)        # the same bits


def _platt_inputs(binary, n=3000, B=4, k=5, seed=0):
    rng = np.random.default_rng(seed)
    kk = 2 if binary else k
    pairs = np.array([(i, j) for i in range(kk) for j in range(i + 1, kk)],
                     np.int32)
    y = rng.integers(0, kk, n).astype(np.int32)
    dec = rng.standard_normal((B, n, len(pairs))).astype(np.float32)
    for p, (i, j) in enumerate(pairs):
        sign = (y == i).astype(np.float32) - (y == j).astype(np.float32)
        dec[:, :, p] += (-1.0 if binary else 1.0) * 1.5 * sign
    tw = (rng.random((B, n)) < 0.8).astype(np.float32)
    tw[-1] = 0.0                                  # an all-masked task
    dec[0, 5, 0] = np.nan                         # a NaN decision
    if B > 2:
        dec[1] *= 40.0                            # near-separable rows
    return [torch.as_tensor(a, device="cuda") for a in (dec, y, tw)] + \
        [pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("plan", ["staged", "streamed", "staged_full"])
def test_platt_fit_matches_plain(cuda_device, binary, plan):
    """P1 against its plain version: A and B rtol 1e-3 atol 1e-3 (sums
    over the kept elements in another order, through 50 Newton steps),
    NaN rows, an all-masked task (no step taken: A 0) and near-separable
    rows (rejected and halved steps) included; one launch, counted."""
    dec, y, tw, pairs = _platt_inputs(binary)
    n0 = pk.LAUNCHES["svm_platt_fit"]
    A, B = pk.platt_fit(dec, y, tw, pairs, binary, plan=plan)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["svm_platt_fit"] == n0 + 1
    pA, pB = pk.platt_fit_rows_plain(dec, y, tw, pairs, binary)
    torch.testing.assert_close(A, pA, rtol=1e-3, atol=1e-3, equal_nan=True)
    torch.testing.assert_close(B, pB, rtol=1e-3, atol=1e-3, equal_nan=True)
    P = len(pairs)
    assert bool((A[-P:] == 0).all())              # the all-masked task
    again = pk.platt_fit(dec, y, tw, pairs, binary, plan=plan)
    for a, b in ((A, again[0]), (B, again[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        pk.platt_fit(dec[:, :10].contiguous(), y, tw, pairs, binary)


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False])
def test_platt_fit_exit_equals_full_run(cuda_device, binary):
    """P1 leaving each row's Newton loop at its fixed point ("staged" and
    "streamed") gives the same kernel's 50-step run ("staged_full") bit
    for bit, NaN rows, an all-masked task and near-separable rows
    included; the rows' step counts: at most 50, the trial passes at most
    the steps, every row 50 steps without the exit."""
    dec, y, tw, pairs = _platt_inputs(binary)
    R = dec.shape[0] * len(pairs)
    runs = {}
    for plan in ("staged_full", "staged", "streamed"):
        steps = torch.zeros((R, 2), dtype=torch.int32, device="cuda")
        A, B = pk.platt_fit(dec, y, tw, pairs, binary, plan=plan,
                            steps=steps)
        runs[plan] = (A, B, steps.cpu())
    torch.cuda.synchronize()
    full = runs["staged_full"]
    assert bool((full[2][:, 0] == pk.N_NEWTON).all())
    for plan in ("staged", "streamed"):
        A, B, steps = runs[plan]
        assert torch.equal(A.view(torch.int32), full[0].view(torch.int32))
        assert torch.equal(B.view(torch.int32), full[1].view(torch.int32))
        assert bool(((steps[:, 0] >= 1) & (steps[:, 0] <= pk.N_NEWTON)).all())
        assert bool((steps[:, 1] <= steps[:, 0]).all())
        assert bool((steps[:, 1] <= full[2][:, 1]).all())
        assert int(steps[:, 0].min()) < pk.N_NEWTON
    assert torch.equal(runs["staged"][2], runs["streamed"][2])


#: P2's cases: the first design's, then k = 3, 10, 12, 13, 26, 41 and 50
#: under every plan that serves it (the register plan to k = 12, the
#: group plan from 13 to 64, the shared and the global plan at any k)
COUPLING_CASES = [(3, "registers"), (10, "registers"), (12, "registers"),
                  (10, "shared"), (14, "shared"), (41, "shared"),
                  (42, None), (5, "global"), (13, "global")] + [
    (k, plan) for k in (3, 10, 12, 13, 26, 41, 50)
    for plan in ("registers", "group", "shared", "global")
    if (k, plan) not in {(3, "registers"), (10, "registers"),
                         (12, "registers"), (10, "shared"), (41, "shared"),
                         (13, "global")}
    and (plan != "registers" or k <= 12) and (plan != "group" or k > 12)]


def _coupling_inputs(k, T=3, n=500):
    rng = np.random.default_rng(k)
    pairs = np.array([(i, j) for i in range(k) for j in range(i + 1, k)],
                     np.int32)
    P = len(pairs)
    dec = torch.as_tensor(2 * rng.standard_normal((T, n, P)).astype(
        np.float32), device="cuda")
    dec[1, 7, 0] = float("nan")
    platt = torch.as_tensor(rng.normal(-1.5, 0.3, (T, P, 2)).astype(
        np.float32), device="cuda")
    return dec, platt, pairs


def _check_coupling(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4,
                               equal_nan=True)
    assert bool(torch.isnan(got[1, 7]).all())
    ok = torch.isfinite(got).all(dim=-1)
    assert float((got[ok].sum(dim=-1) - 1).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k,plan", COUPLING_CASES)
def test_pair_coupling_matches_plain(cuda_device, k, plan):
    """P2 against its plain version under each plan: probabilities atol
    1e-4 (the deferred rescale, a reciprocal on the SFU, sums in another
    order), a NaN decision's problem NaN as the plain version's; rows sum
    to 1 within 1e-4."""
    dec, platt, pairs = _coupling_inputs(k)
    T, n, _ = dec.shape
    n0 = pk.LAUNCHES["svm_pair_coupling"]
    got = pk.pair_coupling(dec, platt, pairs, k, plan=plan)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["svm_pair_coupling"] == n0 + 1
    assert pk.coupling_plan(k, plan, T * n)["plan"] == (
        plan or ("registers" if k <= 12 else "group" if k <= 64
                 else "shared"))
    _check_coupling(got, pk.pair_coupling_plain(dec, platt, pairs, k))
    with pytest.raises(ValueError, match="lexicographic"):
        pk.pair_coupling(dec, platt, pairs[::-1].copy(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k,G", [(k, pk.coupling_group(k)) for k in (
    13, 17, 21, 25, 28, 29, 33, 40, 41, 49, 64)])
def test_pair_coupling_group_sizes_match_plain(cuda_device, k, G):
    """P2's group plan at every built shape (G lanes a problem, ceil(k /
    G) classes a lane: G 4 at 4-7 classes a lane, 8 at 4-5, 16 at 3-4),
    at a span's first and last k, held to the plain version as above."""
    dec, platt, pairs = _coupling_inputs(k)
    plan = pk.coupling_plan(k, "group", dec.shape[0] * dec.shape[1])
    assert plan["group"] == G
    got = pk.pair_coupling(dec, platt, pairs, k, plan="group")
    torch.cuda.synchronize()
    _check_coupling(got, pk.pair_coupling_plain(dec, platt, pairs, k))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["svr", "nu", "project"])
@pytest.mark.parametrize("n,cluster", [(700, None), (700, 1), (14000, None),
                                       (13825, 2), (20640, None),
                                       (20640, 2)])
def test_svr_step_matches_plain(cuda_device, mode, n, cluster):
    """S2's SVR mode against its plain version: x', z' and β' rtol 1e-5
    atol 1e-5 (the bisection's sums in another order), the residual
    1e-5/step; a NaN in a masked element still propagates to its row; a
    row with every bound 0 and a row whose bracket passes FLT_MAX / 2
    (every element listed) included.  A cluster of CTAs a row, as the
    plan picks it for the card or of 1 and 2 CTAs."""
    rng = np.random.default_rng(n)
    M = 5
    y = rng.standard_normal(n).astype(np.float32)
    bh = ((rng.random((M, n)) < 0.8) * 3.0).astype(np.float32)
    z = rng.uniform(-0.5, 3.5, (M, 2 * n)).astype(np.float32)
    x = rng.uniform(0.0, 3.0, (M, 2 * n)).astype(np.float32)
    V = rng.standard_normal((M, n)).astype(np.float32)
    j = int(np.where(bh[2] == 0)[0][0])
    z[2, j] = np.nan
    bh[0] = 0.0                                  # every bound 0
    z[4, int(np.where(bh[4] > 0)[0][-1])] = 2e38  # a wide bracket
    c = [torch.as_tensor(a, device="cuda") for a in (V, z, x, y, bh)]
    step = torch.tensor(0.02, device="cuda")
    eps = torch.full((M,), 0.1, device="cuda") if mode == "svr" else None
    target = None if mode == "svr" else 0.3 * c[4].sum(dim=1)
    args = (None if mode == "project" else c[0], c[1], c[2], c[3], eps,
            c[4], step, 0.4, target)
    plan = None if cluster is None else svk.svr_step_plan(n, M, cluster)
    n0 = svk.LAUNCHES["svm_svr_step"]
    got = svk.svr_dual_step(*args, plan=plan)
    torch.cuda.synchronize()
    assert svk.LAUNCHES["svm_svr_step"] == n0 + 1
    want = svk.svr_dual_step_plain(*args)
    for a, b, atol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-5 / 0.02)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol,
                                   equal_nan=True)
    assert bool(torch.isnan(got[0][2]).all())
    for a, b in zip(got[:3], svk.svr_dual_step(*args, plan=plan)[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0,
                                   equal_nan=True)    # the same bits
    with pytest.raises(ValueError):
        svk.svr_dual_step(args[0], c[1], c[2], c[3], eps, c[4], step, 0.4,
                          0.3 * c[4].sum(dim=1) if mode == "svr" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["svr", "nu"])
@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 12, 16])
def test_svr_step_cluster_plans_match_plain(cuda_device, mode, cluster):
    """S2's SVR mode at cluster sizes from 1 to 16 CTAs a row
    (non-portable above 8): x', z', β' rtol 1e-5 atol 1e-5 against the
    plain version, two launches equal bit for bit; the card holds at
    least one cluster of each."""
    rng = np.random.default_rng(cluster)
    M, n = 4, 3001
    y = rng.standard_normal(n).astype(np.float32)
    bh = ((rng.random((M, n)) < 0.3) * 2.0).astype(np.float32)
    z = rng.uniform(-0.5, 2.5, (M, 2 * n)).astype(np.float32)
    x = rng.uniform(0.0, 2.0, (M, 2 * n)).astype(np.float32)
    V = rng.standard_normal((M, n)).astype(np.float32)
    c = [torch.as_tensor(a, device="cuda") for a in (V, z, x, y, bh)]
    step = torch.tensor(0.02, device="cuda")
    eps = torch.full((M,), 0.2, device="cuda") if mode == "svr" else None
    target = None if mode == "svr" else 0.4 * c[4].sum(dim=1)
    args = (c[0], c[1], c[2], c[3], eps, c[4], step, 0.3, target)
    plan = svk.svr_step_plan(n, cluster=cluster)
    assert svk.svr_clusters(torch.cuda.current_device(), n, mode == "nu",
                            cluster) >= 1
    got = svk.svr_dual_step(*args, plan=plan)
    want = svk.svr_dual_step_plain(*args)
    torch.cuda.synchronize()
    for a, b, atol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-5 / 0.02)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
    for a, b in zip(got, svk.svr_dual_step(*args, plan=plan)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["svc_proba", "nusvc_proba_binary", "svr",
                                  "nu_svr", "linear_svc", "linear_svr",
                                  "svc_proba_k13", "svc_proba_k42"])
def test_svm_rest_search_on_cuda_matches_cpu(cuda_device, kind):
    """The rest of the SVMs on cuda against the CPU: every mean_test
    score within 5e-3 (the repo's oracle bound), the same best
    candidate, the new kernels launched on the card only, and the refit
    estimator predicting (and, with probability=True, giving
    probabilities) on the card.  svc_proba_k13 and svc_proba_k42 take 13
    and 42 classes, through P2's shared and global plans."""
    import warnings

    X, y = _digits_like()
    yr = X[:, 0] * 2 + 0.3 * X[:, 1] ** 2
    est, grid, data, scoring, launches = {
        "svc_proba": (port.SVC(probability=True),
                      {"C": [0.5, 5.0]}, (X, y),
                      ["accuracy", "neg_log_loss"], pk.LAUNCHES),
        "nusvc_proba_binary": (port.NuSVC(probability=True),
                               {"nu": [0.2, 0.5]}, (X, y % 2),
                               "neg_log_loss", {"svm_platt_fit": 0}),
        "svr": (port.SVR(), {"C": [0.5, 5.0], "epsilon": [0.1]}, (X, yr),
                None, {"svm_svr_step": 0}),
        "nu_svr": (port.NuSVR(), {"nu": [0.3, 0.6]}, (X, yr), None,
                   {"svm_svr_step": 0}),
        "linear_svc": (port.LinearSVC(), {"C": [0.01, 1.0],
                                          "loss": ["hinge",
                                                   "squared_hinge"]},
                       (X, y), None, None),
        "linear_svr": (port.LinearSVR(), {"C": [0.1, 1.0]}, (X, yr), None,
                       None),
        "svc_proba_k13": (port.SVC(probability=True), {"C": [0.5, 5.0]},
                          _class_problem(13, n=390),
                          ["accuracy", "neg_log_loss"], pk.LAUNCHES),
        "svc_proba_k42": (port.SVC(probability=True), {"C": [0.5, 5.0]},
                          _class_problem(42, n=420),
                          ["accuracy", "neg_log_loss"], pk.LAUNCHES),
    }[kind]
    runs = {}
    for dev in ("cuda", "cpu"):
        pk.reset_launches()
        svk.reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            refit = scoring[0] if isinstance(scoring, list) else True
            runs[dev] = port.GridSearchCV(
                est, grid, cv=3, scoring=scoring, refit=refit,
                config=port.TorchConfig(device=dev)).fit(*data)
        counts = {**pk.LAUNCHES, **svk.LAUNCHES}
        if launches is not None:
            assert (min(counts[name] for name in launches) > 0) == \
                (dev == "cuda")
    for key in (scoring if isinstance(scoring, list) else ["score"]):
        np.testing.assert_allclose(
            runs["cuda"].cv_results_[f"mean_test_{key}"],
            runs["cpu"].cv_results_[f"mean_test_{key}"], rtol=0, atol=5e-3)
    assert runs["cuda"].best_params_ == runs["cpu"].best_params_
    best = runs["cuda"].best_estimator_
    assert best.predict(data[0][:7]).shape == (7,)
    if "proba" in kind:
        proba = best.predict_proba(data[0][:7])
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# successive halving: chip_smoke.py phase 15's search (a) at a small size
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_halving_search_on_cuda_matches_cpu(cuda_device):
    """HalvingGridSearchCV(LogisticRegression) over 20 C with
    StratifiedKFold(3) on 600 rows: the same rung plan, `iter` and
    `n_resources` columns and survivors on both devices, the scores
    within 5e-3 rounded up to a whole number of test predictions' shares
    of the mean (a rung's folds hold 22 to 198 test rows, so one
    prediction of a lane stopped at max_iter, flipped by the two devices'
    rounding, moves a mean by up to 0.015), K2 and K4 launched on cuda
    only, every rung's chunks in its namespace."""
    X, y = _class_problem(10, n=600)
    grid = {"C": np.logspace(-3, 2, 20).tolist()}
    runs = {}
    for dev in ("cuda", "cpu"):
        gk.reset_launches()
        runs[dev] = port.HalvingGridSearchCV(
            port.LogisticRegression(), grid, cv=port.StratifiedKFold(3),
            factor=3, random_state=0,
            config=port.TorchConfig(device=dev)).fit(X, y)
        assert (min(gk.LAUNCHES.values()) > 0) == (dev == "cuda")
    g, c = runs["cuda"], runs["cpu"]
    assert g.n_resources_ == c.n_resources_ == [66, 198, 594]
    assert g.n_candidates_ == c.n_candidates_ == [20, 7, 3]
    for key in ("iter", "n_resources"):
        np.testing.assert_array_equal(g.cv_results_[key], c.cv_results_[key])

    def rungs(gs):      # each rung's survivors, whatever order ties take
        r = gs.cv_results_
        return {(int(i), repr(sorted(p.items()))): float(m)
                for i, p, m in zip(r["iter"], r["params"],
                                   r["mean_test_score"])}

    rg, rc = rungs(g), rungs(c)
    assert set(rg) == set(rc)
    test_rows = [len(te) for _, te in port.StratifiedKFold(3).split(X, y)]
    for key in rg:
        n_res = g.n_resources_[key[0]]
        step = 1.0 / (min(int(n_res / len(y) * t) for t in test_rows) * 3)
        bound = np.ceil(5e-3 / step - 1e-9) * step * (1 + 1e-6)
        assert abs(rg[key] - rc[key]) <= bound, key
    assert g.best_params_ == c.best_params_
    assert g.best_estimator_.device == "cuda"
    assert {ch["id"].split(":")[0] for ch in g.chunks_} == {"r0", "r1", "r2"}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 10])
def test_bf16_search_on_cuda_matches_cpu(cuda_device, k):
    """TorchConfig(bf16_matmul=True): the card's bf16 GEMMs with float32
    output against the CPU's rounded operands multiplied in float32,
    scores within 5e-3 and the same best candidate; the float32 search
    on the card within the reference's bf16 bound, 0.015."""
    X, y = _class_problem(k, n=300)
    grid = {"C": [0.01, 0.1, 1.0, 10.0]}
    runs = {}
    for dev, bf16 in (("cuda", True), ("cpu", True), ("cuda", False)):
        runs[dev, bf16] = port.GridSearchCV(
            port.LogisticRegression(max_iter=100), grid, cv=3,
            scoring="neg_log_loss", refit=False,
            config=port.TorchConfig(device=dev, bf16_matmul=bf16)).fit(X, y)
    got = runs["cuda", True].cv_results_["mean_test_score"]
    np.testing.assert_allclose(
        got, runs["cpu", True].cv_results_["mean_test_score"], atol=5e-3)
    assert runs["cuda", True].best_params_ == runs["cpu", True].best_params_
    np.testing.assert_allclose(
        got, runs["cuda", False].cv_results_["mean_test_score"], atol=0.015)


def _csr_inputs(m, K, W, density, seed=0, full_row=False, device="cuda"):
    """A random CSR (m, K) with an empty row and an empty column (and a
    row holding every other column), and D (K, W), on `device`."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    A = sp.random(m, K, density=density, format="lil", random_state=rng,
                  dtype=np.float32)
    A[min(1, m - 1), :] = 0
    A[:, min(2, K - 1)] = 0
    if full_row:
        A[m - 1, :] = rng.normal(size=K)
        A[m - 1, min(2, K - 1)] = 0
    A = A.tocsr().astype(np.float32)
    A.eliminate_zeros()
    A.sort_indices()
    D = rng.normal(size=(K, W)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (
        A.indptr.astype(np.int32), A.indices.astype(np.int32), A.data,
        D)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,K,W,density,full_row", [
    (60, 45, 1, 0.1, False), (60, 45, 3, 0.1, True), (60, 45, 37, 0.1, True),
    (300, 2000, 1000, 0.01, True), (500, 300, 1025, 0.05, False),
    (1, 7, 5, 0.5, False), (2000, 9000, 100, 0.002, True),
    (300, 2000, 97, 0.01, True), (400, 3000, 500, 0.01, True)])
def test_csr_spmm_matches_plain_on_the_cpu(cuda_device, m, K, W, density,
                                           full_row):
    """SP1 sums each row in ascending nonzero order, each product rounded
    then added: equal to its plain version on CPU copies, bit for bit,
    and bitwise repeatable; one launch counted a call."""
    indptr, indices, values, D = _csr_inputs(m, K, W, density, m + W,
                                             full_row)
    n0 = spk.LAUNCHES["csr_spmm"]
    got = spk.csr_spmm(indptr, indices, values, D, K)
    again = spk.csr_spmm(indptr, indices, values, D, K)
    torch.cuda.synchronize()
    assert spk.LAUNCHES["csr_spmm"] == n0 + 2
    want = spk.csr_spmm_plain(indptr.cpu(), indices.cpu(), values.cpu(),
                              D.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    if m > 1:
        assert not bool(got[1].any())          # the empty row


def _zipf_inputs(m, K, W, seed=0, longest=5000):
    """A CSR (m, K) whose row lengths follow a Zipf head (Xᵀ of term
    counts), its first row `longest` nonzeros (past every ring), a tenth
    of the rows empty; and D (K, W); on the card."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(K, (longest / np.arange(1, m + 1) ** 1.1)
                         .astype(np.int64))
    lengths[1 + rng.permutation(m - 1)[:m // 10]] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(K, n, replace=False))
                              for n in lengths]).astype(np.int32)
    values = rng.normal(size=indices.size).astype(np.float32)
    D = rng.normal(size=(K, W)).astype(np.float32)
    return [torch.as_tensor(a, device="cuda")
            for a in (indptr, indices, values, D)]


def _wide_inputs(W, seed=0, m=3000, K=6000):
    """A CSR (m, K) of rows of 30-90 nonzeros and one of 1100 (heavy, and
    cut into 32-column slices at W = 1000), and D (K, W), on the card."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(30, 90, m)
    lengths[m // 3] = 1100
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(K, n, replace=False))
                              for n in lengths]).astype(np.int32)
    values = rng.normal(size=indices.size).astype(np.float32)
    D = rng.normal(size=(K, W)).astype(np.float32)
    return [torch.as_tensor(a, device="cuda")
            for a in (indptr, indices, values, D)]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [97, 98, 100, 500, 1000])
@pytest.mark.parametrize("csr", ["zipf", "wide"])
def test_csr_spmm_plans_match_plain(cuda_device, W, csr):
    """The launch choices the wrapper makes (VEC 4, 2 and 1 items, heavy
    segments cut into 16- or 32-column slices or none, row or slice
    order) on a Zipf-headed CSR with a 5000-nonzero row and on one heavy
    row among many, bit for bit the plain version on CPU copies and
    bitwise repeatable."""
    indptr, indices, values, D = (_zipf_inputs(3000, 6000, W, W)
                                  if csr == "zipf" else _wide_inputs(W, W))
    plan = spk.SpmmPlan(indptr)
    launch = spk.launch_for(plan, D, None)
    if W % 2:
        assert launch["n_heavy"] == 0          # VEC 1: no heavy segment
    else:
        assert launch["n_heavy"] >= 1
    if csr == "zipf":
        assert plan.longest == 5000 > 4 * spk.ring_depth(1)
    if csr == "wide" and W == 1000:
        assert launch["heavy_slice"] == 32
    got = spk.csr_spmm(indptr, indices, values, D, 6000, plan=plan)
    again = spk.csr_spmm(indptr, indices, values, D, 6000, plan=plan)
    want = spk.csr_spmm_plain(indptr.cpu(), indices.cpu(), values.cpu(),
                              D.cpu())
    assert torch.equal(got.cpu(), want), launch
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_csr_spmm_on_two_streams_at_once(cuda_device):
    """Launches on two streams at once take their items from counters of
    their own: both outputs whole, bit for bit the plain version."""
    args = [_zipf_inputs(3000, 6000, W, W) for W in (500, 1000)]
    plans = [spk.SpmmPlan(a[0]) for a in args]
    want = [spk.csr_spmm_plain(*(t.cpu() for t in a)) for a in args]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(4):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(spk.csr_spmm(*args[i], 6000, plan=plans[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert torch.equal(got.cpu(), want[i])


@pytest.mark.cuda
def test_csr_spmm_writes_out_in_place(cuda_device):
    """`out=` a view of a larger buffer (the sparse LogisticRegression's
    gradient rows): written in place, the rows around it untouched; an
    out 4 bytes off the 16-byte line takes the scalar lanes and the same
    bits."""
    indptr, indices, values, D = _zipf_inputs(800, 2000, 100, 3)
    want = spk.csr_spmm(indptr, indices, values, D, 2000)
    buf = torch.full((802 * 100 + 1,), 7.0, device="cuda")
    for off in (100, 1):
        out = buf[off:off + 800 * 100].view(800, 100)
        got = spk.csr_spmm(indptr, indices, values, D, 2000, out=out)
        assert got.data_ptr() == out.data_ptr()
        assert torch.equal(out, want)
    assert (buf[-100:] == 7.0).all()
    with pytest.raises(ValueError):
        spk.csr_spmm(indptr, indices, values, D, 2000, out=out[:, :50])


@pytest.mark.cuda
def test_csr_spmm_replays_in_a_graph_and_raises(cuda_device):
    indptr, indices, values, D = _csr_inputs(200, 300, 64, 0.05, 1)
    plan = spk.SpmmPlan(indptr)
    want = spk.csr_spmm(indptr, indices, values, D, 300)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spk.csr_spmm(indptr, indices, values, D, 300, plan=plan)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = spk.csr_spmm(indptr, indices, values, D, 300, plan=plan)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    with pytest.raises(TypeError):
        spk.csr_spmm(indptr.long(), indices, values, D, 300)
    with pytest.raises(ValueError):
        spk.csr_spmm(indptr, indices, values, D[:, ::2], 300)
    with pytest.raises(ValueError):
        spk.csr_spmm(indptr, indices, values, D, 299)
    with pytest.raises(ValueError):
        spk.csr_spmm(indptr.cpu(), indices, values, D, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["LogisticRegression", "MultinomialNB",
                                  "ComplementNB", "BernoulliNB"])
def test_sparse_search_on_cuda_matches_cpu(cuda_device, name):
    """data_mode="sparse": the search on the card through SP1 against the
    CPU's plain version (LogisticRegression atol 5e-3, the discrete NBs
    1e-6) and against the card's densified run; SP1 launched."""
    import scipy.sparse as sp
    rng = np.random.default_rng(3)
    n, d, k = 300, 400, 4
    y = rng.integers(0, k, n)
    X = sp.random(n, d, density=0.03, format="csr", random_state=rng)
    X.data = np.ceil(X.data * 4.0)
    X = (X + sp.csr_matrix((np.full(n, 3.0), (np.arange(n), y * 5)),
                           shape=(n, d))).tocsr()
    grid = ({"C": [0.1, 1.0, 10.0]} if name == "LogisticRegression"
            else {"alpha": [0.1, 1.0]})
    tol = 5e-3 if name == "LogisticRegression" else 1e-6
    runs = {}
    for dev, mode in (("cuda", "sparse"), ("cpu", "sparse"),
                      ("cuda", "device")):
        n0 = spk.LAUNCHES["csr_spmm"]
        runs[dev, mode] = port.GridSearchCV(
            getattr(port, name)(), grid, cv=3, refit=True,
            config=port.TorchConfig(device=dev, data_mode=mode)).fit(X, y)
        if (dev, mode) == ("cuda", "sparse"):
            assert spk.LAUNCHES["csr_spmm"] > n0
    got = runs["cuda", "sparse"].cv_results_["mean_test_score"]
    for key in (("cpu", "sparse"), ("cuda", "device")):
        np.testing.assert_allclose(
            got, runs[key].cv_results_["mean_test_score"], atol=tol)
    # the refits: the same predictions but where a row sits on a
    # decision boundary within float noise
    agree = np.mean(runs["cuda", "sparse"].predict(X)
                    == runs["cpu", "sparse"].predict(X))
    assert agree >= 0.99


# --- the keyed fleets: K2ℓ, K4ℓ (lane-major GLM epilogues), C1ℓ (per-lane
# --- X), TI1 (converted tree ensembles), the fleets on cuda -------------

def _lane_inputs(k, G, L, device, per_lane=True, seed=0):
    rng = np.random.default_rng(seed)
    shape = (G, L) if k == 2 else (G, L, k)
    Z = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    Zp = rng.standard_normal(shape).astype(np.float32)
    w = (rng.random((G, L)) < 0.8).astype(np.float32)
    y = rng.integers(0, k, (G, L) if per_lane else L).astype(np.int32)
    a0 = rng.uniform(0.05, 1.0, G).astype(np.float32)
    alphas = (a0[None, :] * 0.5 ** np.arange(16, dtype=np.float32)[:, None])
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (Z, Zp, w, y, alphas.astype(np.float32))]


# (k, G, L): binary, small and wide k, a lone lane, a lone row, G not a
# multiple of the block's 4 lanes, a bucket of 4096 rows
LANE_SHAPES = [(2, 37, 64), (3, 37, 64), (4, 9, 4096), (10, 5, 300),
               (17, 6, 33), (2, 1, 1), (4, 1, 16), (4, 1000, 16),
               (2, 3, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("per_lane", [True, False])
@pytest.mark.parametrize("k,G,L", LANE_SHAPES)
def test_lane_kernels_match_plain(cuda_device, k, G, L, per_lane):
    """K2ℓ and K4ℓ against their plain versions: loss rtol 1e-5, G atol
    1e-6, trial losses rtol 1e-5 (row sums in another order); each
    launch counted; two launches give the same bits."""
    Z, Zp, w, y, alphas = _lane_inputs(k, G, L, cuda_device, per_lane)
    n0 = dict(gk.LANE_LAUNCHES)
    loss, G_ = gk.glm_loss_grad_lanes(Z, w, y)
    loss2, G2 = gk.glm_loss_grad_lanes(Z, w, y)
    out = gk.glm_trial_loss_lanes(Z, Zp, w, y, alphas)
    out_t = gk.glm_trial_loss_lanes(Z, Zp, w, y, alphas[:15].contiguous())
    assert gk.LANE_LAUNCHES["glm_loss_grad_lanes"] == \
        n0["glm_loss_grad_lanes"] + 2
    assert gk.LANE_LAUNCHES["glm_trial_loss_lanes"] == \
        n0["glm_trial_loss_lanes"] + 2
    assert torch.equal(loss, loss2) and torch.equal(G_, G2)
    cpu = [t.cpu() for t in (Z, Zp, w, y, alphas)]
    lp, Gp = gk.glm_loss_grad_lanes_plain(cpu[0], cpu[2], cpu[3])
    op = gk.glm_trial_loss_lanes_plain(*cpu)
    np.testing.assert_allclose(loss.cpu().numpy(), lp.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(G_.cpu().numpy(), Gp.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.cpu().numpy(), op.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out_t.cpu().numpy(), op[:15].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_lane_kernels_shared_labels_are_per_lane_labels(cuda_device, k):
    """Label stride 0 (one row of labels) gives the bits of stride L with
    that row repeated."""
    Z, Zp, w, y, alphas = _lane_inputs(k, 7, 50, cuda_device, False)
    yl = y.expand(7, 50).contiguous()
    a = gk.glm_loss_grad_lanes(Z, w, y)
    b = gk.glm_loss_grad_lanes(Z, w, yl)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(gk.glm_trial_loss_lanes(Z, Zp, w, y, alphas),
                       gk.glm_trial_loss_lanes(Z, Zp, w, yl, alphas))


@pytest.mark.cuda
def test_lane_kernel_wrappers_raise(cuda_device):
    Z, Zp, w, y, alphas = _lane_inputs(4, 5, 20, cuda_device)
    with pytest.raises(TypeError):
        gk.glm_loss_grad_lanes(Z, w, y.long())
    with pytest.raises(ValueError):
        gk.glm_loss_grad_lanes(Z, w[:, :10].contiguous(), y)
    with pytest.raises(ValueError):
        gk.glm_loss_grad_lanes(Z, w.cpu(), y)
    with pytest.raises(ValueError):
        gk.glm_loss_grad_lanes(Z.transpose(0, 1), w, y)
    with pytest.raises(ValueError):
        gk.glm_trial_loss_lanes(Z, Zp, w, y, torch.cat([alphas, alphas]))
    with pytest.raises(ValueError):
        gk.glm_trial_loss_lanes(Z, Zp[:, :10], w, y, alphas)


# (G, L, d, k): the fleet's buckets, d not a multiple of 4, one lane
ASSIGN_LANE_SHAPES = [(40, 16, 32, 8), (9, 4096, 32, 8), (3, 600, 7, 3),
                      (1, 8, 5, 2), (130, 64, 6, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,L,d,k", ASSIGN_LANE_SHAPES)
def test_kmeans_assign_lanes_matches_plain(cuda_device, G, L, d, k):
    """C1ℓ: assign and min_d2 bit for bit the plain version's (dot in t
    order, multiply and add apart), inertia rtol 1e-5; C1ℓ over every
    lane's copy of one X gives C1's assign and min_d2 bits (stride 0 is
    C1 itself)."""
    rng = np.random.default_rng(G + L)
    X = torch.as_tensor(rng.normal(size=(G, L, d)).astype(np.float32),
                        device=cuda_device)
    C = torch.as_tensor(rng.normal(size=(G, k, d)).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor((rng.random((G, L)) < 0.7).astype(np.float32),
                        device=cuda_device)
    xx, cc = (X * X).sum(dim=2), (C * C).sum(dim=2)
    n0 = kmk.LANE_LAUNCHES["kmeans_assign_lanes"]
    a, m, s = kmk.kmeans_assign_lanes(X, C, xx, cc, w)
    assert kmk.LANE_LAUNCHES["kmeans_assign_lanes"] == n0 + 1
    ap, mp, sp_ = kmk.kmeans_assign_lanes_plain(X.cpu(), C.cpu(), xx.cpu(),
                                                cc.cpu(), w.cpu())
    assert torch.equal(a.cpu(), ap) and torch.equal(m.cpu(), mp)
    np.testing.assert_allclose(s.cpu().numpy(), sp_.numpy(), rtol=1e-5)
    X0 = X[0]
    a1, m1, _ = kmk.kmeans_assign(X0, C, xx[0], cc, w)
    a2, m2, _ = kmk.kmeans_assign_lanes(X0.expand(G, L, d).contiguous(), C,
                                        xx[0].expand(G, L).contiguous(), cc,
                                        w)
    assert torch.equal(a1, a2) and torch.equal(m1, m2)
    with pytest.raises(ValueError):
        kmk.kmeans_assign_lanes(X, C, xx[:, :3].contiguous(), cc, w)
    with pytest.raises(ValueError):
        kmk.kmeans_assign_lanes(X[0], C, xx, cc, w)


def _grown_tree(rng, X, y, depth, n_out, min_split=8):
    """A tree in sklearn's node layout (depth first, left subtree first)
    grown on rows of X: a random feature a node, the threshold one of
    its rows' values; leaf values the rows' class shares (n_out > 1) or
    a random value."""
    feat, thr, left, right, val = [], [], [], [], []

    def grow(rows, level):
        i = len(feat)
        feat.append(-2), thr.append(-2.0), left.append(-1)
        right.append(-1)
        if n_out > 1:
            val.append(np.bincount(y[rows], minlength=n_out) / len(rows))
        else:
            val.append([rng.normal()])
        if level < depth and len(rows) >= min_split:
            f = int(rng.integers(X.shape[1]))
            t = float(X[rows[rng.integers(len(rows))], f])
            go = X[rows, f] <= t
            if 0 < go.sum() < len(rows):
                feat[i], thr[i] = f, t
                left[i] = grow(rows[go], level + 1)
                right[i] = grow(rows[~go], level + 1)
        return i

    grow(np.arange(len(X)), 0)
    tree = type("Tree", (), {})()
    tree.feature, tree.threshold = np.array(feat), np.array(thr)
    tree.children_left, tree.children_right = np.array(left), np.array(right)
    tree.value = np.asarray(val, np.float64)[:, None, :]
    tree.node_count = len(feat)
    depth_of = np.zeros(len(feat), int)
    for v in range(len(feat)):
        for c in (left[v], right[v]):
            if c >= 0:
                depth_of[c] = depth_of[v] + 1
    tree.max_depth = int(depth_of.max())
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,T", [("forest_proba", 2, 9),
                                      ("forest_proba", 7, 12),
                                      ("mean", 1, 10), ("boost", 1, 8),
                                      ("boost", 4, 24)])
def test_tree_ensemble_matches_plain(cuda_device, mode, k, T):
    """TI1 against its plain version on the card and on CPU copies (rtol
    1e-6): trees of different depths (one of 9 levels among shallower
    ones) and a single-leaf tree among them; launches counted."""
    from spark_sklearn_tpu_torch.convert import tree_infer as ti
    from spark_sklearn_tpu_torch.ops import tree_infer_kernels as tik

    rng = np.random.default_rng(T)
    X = rng.normal(size=(3000, 11)).astype(np.float32)
    y = rng.integers(0, max(k, 2), 3000)
    n_out = k if mode == "forest_proba" else 1
    trees = [_grown_tree(rng, X[rng.integers(0, 3000, 500)], y,
                         9 if t == 1 else 4, n_out) for t in range(T)]
    trees[2] = _grown_tree(rng, X[:5], y, 0, n_out)        # a single leaf
    packed = ti.to_device(ti.pack_trees(trees), cuda_device)
    K = k if mode == "boost" else 1
    init = torch.linspace(-1, 1, K, device=cuda_device)
    Xd = torch.as_tensor(X, device=cuda_device)
    args = [packed[a] for a in ti.ARRAYS] + [packed["max_depth"], mode]
    n0 = tik.LAUNCHES["tree_ensemble"]
    got = tik.tree_ensemble(Xd, *args, K=K, init=init, lr=0.1)
    assert tik.LAUNCHES["tree_ensemble"] == n0 + 1
    want = tik.tree_ensemble_plain(Xd, *args, K=K, init=init, lr=0.1)
    cpu = tik.tree_ensemble(Xd.cpu(), *[a.cpu() if torch.is_tensor(a) else a
                                        for a in args], K=K,
                            init=init.cpu(), lr=0.1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(got, tik.tree_ensemble(Xd, *args, K=K, init=init,
                                              lr=0.1))


@pytest.mark.cuda
def test_tree_ensemble_wrapper_raises(cuda_device):
    from spark_sklearn_tpu_torch.convert import tree_infer as ti
    from spark_sklearn_tpu_torch.ops import tree_infer_kernels as tik

    rng = np.random.default_rng(0)
    X = rng.normal(size=(100, 4)).astype(np.float32)
    trees = [_grown_tree(rng, X, rng.integers(0, 3, 100), 3, 3)
             for _ in range(3)]
    p = ti.to_device(ti.pack_trees(trees), cuda_device)
    Xd = torch.as_tensor(X, device=cuda_device)
    args = [p[a] for a in ti.ARRAYS] + [p["max_depth"]]
    with pytest.raises(ValueError):
        tik.tree_ensemble(Xd, *args, "median")
    with pytest.raises(ValueError):
        tik.tree_ensemble(Xd, *args, "boost", K=2, init=torch.zeros(
            2, device=cuda_device))              # 3 trees, K = 2
    with pytest.raises(TypeError):
        tik.tree_ensemble(Xd, p["feature"].long(), *args[1:],
                          "forest_proba")
    with pytest.raises(ValueError):
        tik.tree_ensemble(Xd.t(), *args,
                          "forest_proba")


def _fleet_table(seed=0, sizes=(12, 40, 100, 300, 33, 700)):
    rng = np.random.default_rng(seed)
    kid = np.concatenate([np.full(m, i) for i, m in enumerate(sizes)])
    X = rng.normal(size=(len(kid), 6)).astype(np.float32)
    W = rng.normal(size=(len(sizes), 6))
    z = np.einsum("nd,nd->n", X, W[kid]) + 0.5 * rng.normal(size=len(kid))
    return {"k": kid, "x": X, "yb": (z > 0).astype(int),
            "ym": np.digitize(z, [-1.0, 1.0]), "yr": z}


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["logreg_binary", "logreg_multinomial",
                                   "ridge", "linreg", "kmeans", "scaler",
                                   "pca"])
def test_keyed_fleet_on_cuda_matches_cpu(cuda_device, label):
    """The port's own estimators as keyed fleets on a dict of columns:
    cuda against the CPU (labels and ids equal, outputs atol 1e-4, PCA up
    to each key's component signs), the lane kernels launched on cuda."""
    est, kw = {
        "logreg_binary": (port.LogisticRegression(), {"yCol": "yb"}),
        "logreg_multinomial": (port.LogisticRegression(), {"yCol": "ym"}),
        "ridge": (port.Ridge(alpha=2.0), {"yCol": "yr"}),
        "linreg": (port.LinearRegression(), {"yCol": "yr"}),
        "kmeans": (port.KMeans(n_clusters=3, random_state=0),
                   {"estimatorType": "clusterer"}),
        "scaler": (port.StandardScaler(), {"estimatorType": "transformer"}),
        "pca": (port.PCA(n_components=3), {"estimatorType": "transformer"}),
    }[label]
    table = _fleet_table()
    outs = {}
    for dev in ("cuda", "cpu"):
        gk.reset_launches()
        kmk.reset_launches()
        km = port.KeyedEstimator(sklearnEstimator=est, keyCols=["k"],
                                 xCol="x", config=port.TorchConfig(
                                     device=dev), **kw).fit(table)
        assert km.backend == "device"
        outs[dev] = km.transform(table)["output"]
        launched = sum(gk.LANE_LAUNCHES.values()) + sum(
            kmk.LANE_LAUNCHES.values())
        if label.startswith(("logreg", "kmeans")):
            assert (launched > 0) == (dev == "cuda")
    a, b = outs["cuda"], outs["cpu"]
    if a.dtype == object:
        a, b = np.stack(a), np.stack(b)
        if label == "pca":
            for key in np.unique(table["k"]):
                m = table["k"] == key
                a[m] *= np.sign((a[m] * b[m]).sum(axis=0, keepdims=True))
        np.testing.assert_allclose(a, b, atol=1e-4)
    elif a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, atol=1e-4)
    else:
        assert np.mean(a == b) >= 0.995


@pytest.mark.cuda
def test_compiled_group_function_on_cuda(cuda_device):
    """`run_bucketed` with a compiled group function's vmap on cuda
    against the CPU (the path gapply takes; gapply itself needs pandas)."""
    from spark_sklearn_tpu_torch.keyed.gapply import (
        compiled_group_func,
        segment_launch,
    )
    from spark_sklearn_tpu_torch.keyed.keyed import run_bucketed

    @compiled_group_func
    def stats(X, w):
        n = w.sum()
        mean = (X * w[:, None]).sum(dim=0) / n
        return torch.cat([mean, n[None]])

    table = _fleet_table()
    rows = [np.flatnonzero(table["k"] == i) for i in range(6)]
    out = {}
    for dev in ("cuda", "cpu"):
        X = torch.as_tensor(table["x"], device=dev)
        order, Y, buckets = run_bucketed(rows, X, segment_launch(stats))
        out[dev] = Y.cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-5)
    assert [int(v) for v in out["cpu"][:, -1]] == [len(rows[i])
                                                   for i in order]
