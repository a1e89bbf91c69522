"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions, and a small search on cuda against the
same search on the CPU.  They skip where no card is visible.

This file imports neither JAX nor sklearn, so it also runs on a machine
that has only PyTorch:  python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.ops import glm_kernels as gk


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 10, 16, 17, 40])
def test_kernels_match_plain(cuda_device, k):
    """Tolerance: rtol 1e-5 on per-lane loss sums and atol 1e-6 on G —
    the kernels sum rows in another order than torch's reductions.  k=17
    and k=40 take the kernels' path for logits not cached in registers."""
    Z, Zp, wT, y, alphas = _inputs(k, cuda_device)
    n0 = dict(gk.LAUNCHES)
    loss, G = gk.glm_loss_grad(Z, wT, y)
    trials = gk.glm_trial_loss(Z, Zp, wT, y, alphas)
    trials5 = gk.glm_trial_loss(Z, Zp, wT, y, alphas[:5].contiguous())
    torch.cuda.synchronize()
    assert gk.LAUNCHES["glm_loss_grad"] == n0["glm_loss_grad"] + 1
    assert gk.LAUNCHES["glm_trial_loss"] == n0["glm_trial_loss"] + 2
    loss_p, G_p = gk.glm_loss_grad_plain(Z, wT, y)
    trials_p = gk.glm_trial_loss_plain(Z, Zp, wT, y, alphas)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(G, G_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(trials, trials_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(trials5, trials_p[:5], rtol=1e-5, atol=1e-6)


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
