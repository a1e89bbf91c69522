"""`TorchConfig(bf16_matmul=True)` against the JAX package's
`TpuConfig(bf16_matmul=True)` on the CPU.

LogisticRegression's fit GEMMs (K1, `X Wᵀ`, and K3, `Gᵀ X`) take bf16
operands with float32 output; on the CPU the port rounds both operands
to bf16 and multiplies them in float32, which is what the reference's
`preferred_element_type` GEMMs compute on the CPU.  The scores are held
to the JAX package's at 5e-3 (the repo's oracle bound,
`tests/test_search_basic.py:47`) with the same best_params_, and to the
port's own float32 search at the reference's bf16 bound, 0.015
(`tests/test_search_basic.py:414`); the flag must change the fit.  A
StandardScaler + LogisticRegression pipeline passes the flag on to its
final step, as the reference's does (`models/pipeline.py:204`).  The
binary case is held to the JAX package's float32 search at 0.015: XLA's
CPU backend has no BF16 x BF16 = F32 matmul (the reference's binary
`Ax`), only its einsum (the multiclass one).
"""

import warnings

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression as SkLogReg
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import StandardScaler as SkStandardScaler

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu_torch.models.linear import _bf16_mm, _bf16_operand


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _search(pkg, est, grid, X, y, bf16, scoring):
    cfg = (port.TorchConfig(device="cpu", bf16_matmul=bf16) if pkg is port
           else sst.TpuConfig(bf16_matmul=bf16))
    kw = {} if pkg is port else {"backend": "tpu"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pkg.GridSearchCV(est, grid, cv=3, scoring=scoring,
                                refit=False, config=cfg, **kw).fit(X, y)


def test_bf16_operands_are_rounded_and_multiplied_in_float32():
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.normal(size=(7, 5)), dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(5, 3)), dtype=torch.float32)
    a, b = _bf16_operand(A), _bf16_operand(B)
    assert a.dtype == torch.float32
    assert torch.equal(a, A.bfloat16().float())
    out = _bf16_mm(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a @ b, rtol=0, atol=0)
    assert not torch.equal(out, A @ B)


@pytest.mark.parametrize("case", ["multiclass", "binary", "pipeline"])
def test_bf16_search_matches_the_jax_package(digits, case):
    X, y = digits
    X, y = X[:400], y[:400]
    est, grid = SkLogReg(max_iter=100), {"C": [0.1, 1.0, 10.0]}
    if case == "binary":
        X, y = X[y < 2], y[y < 2]
    elif case == "pipeline":
        est = SkPipeline([("s", SkStandardScaler()), ("lr", est)])
        grid = {"lr__C": [0.01, 0.1, 1.0]}
    for scoring in ("accuracy", "neg_log_loss"):
        ours = _search(port, est, grid, X, y, True, scoring)
        f32 = _search(port, est, grid, X, y, False, scoring)
        got = ours.cv_results_["mean_test_score"]
        if case == "binary":
            ref = _search(sst, est, grid, X, y, False, scoring)
            np.testing.assert_allclose(
                got, ref.cv_results_["mean_test_score"], atol=0.015,
                rtol=0, err_msg=scoring)
        else:
            ref = _search(sst, est, grid, X, y, True, scoring)
            np.testing.assert_allclose(
                got, ref.cv_results_["mean_test_score"], atol=5e-3, rtol=0,
                err_msg=scoring)
            assert ours.best_params_ == ref.best_params_
        np.testing.assert_allclose(got, f32.cv_results_["mean_test_score"],
                                   atol=0.015, rtol=0, err_msg=scoring)
        if scoring == "neg_log_loss":
            # the flag reaches the fit: bf16 operands move the loss
            assert not np.array_equal(
                got, f32.cv_results_["mean_test_score"])
