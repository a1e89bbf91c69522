"""The port's batched L-BFGS and LogisticRegression family against the
JAX package's, on the same problems: same n_iter, same iterates, and the
same scorer views of the same (carried-across) models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_sklearn_tpu.models.linear import LogisticRegressionFamily as JaxFam
from spark_sklearn_tpu.ops.solvers import glm_lbfgs_batched as jax_lbfgs
from spark_sklearn_tpu_torch.convert.params import params_from_jax
from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops.solvers import glm_lbfgs_batched

CPU = torch.device("cpu")
C_GRID = np.array([0.01, 0.1, 1.0, 10.0, 0.3, 3.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(digits, binary, seed=0):
    X, y = digits
    if binary:
        X, y = X[y < 2], y[y < 2]
    else:
        X, y = X[:500], y[:500]
    rng = np.random.default_rng(seed)
    w = (rng.random((len(C_GRID), len(y))) < 0.7).astype(np.float32)
    return X, y, w


def _binary_closures_jax(X, yb, wT, inv_C):
    d = X.shape[1]
    B = wT.shape[1]

    def Ax(x):
        return X @ x[:, :d].T + x[None, :, d]

    def data_loss(Z):
        return jnp.sum(wT * (jnp.logaddexp(0.0, Z) - yb[:, None] * Z), 0)

    def data_grad(Z):
        return wT * (jax.nn.sigmoid(Z) - yb[:, None])

    def AT(G):
        return jnp.concatenate([G.T @ X, jnp.sum(G, 0)[:, None]], 1)

    def reg_loss(x):
        return 0.5 * inv_C * jnp.sum(x[:, :d] ** 2, axis=1)

    def reg_grad(x):
        return jnp.concatenate(
            [inv_C[:, None] * x[:, :d], jnp.zeros((B, 1))], 1)

    return Ax, data_loss, data_grad, AT, reg_loss, reg_grad


def _binary_closures_port(X, y, wT, inv_C):
    d = X.shape[1]
    B = wT.shape[1]

    def Ax(x):
        return X @ x[:, :d].T + x[None, :, d]

    def AT(G):
        return torch.cat([G.T @ X, G.sum(0)[:, None]], 1)

    def reg_loss(x):
        return 0.5 * inv_C * (x[..., :d] ** 2).sum(-1)

    def reg_grad(x):
        return torch.cat([inv_C[:, None] * x[:, :d], torch.zeros((B, 1))], 1)

    return (Ax, lambda Z: gk.glm_loss_grad(Z, wT, y),
            lambda Z, Zp, a: gk.glm_trial_loss(Z, Zp, wT, y, a),
            AT, reg_loss, reg_grad)


@pytest.mark.parametrize("max_iter", [5, 100])
def test_lbfgs_matches_jax_solver(digits, max_iter):
    """Binary problem through both solvers directly: equal n_iter; after
    5 iterations the iterates agree to float32 rounding (rtol 1e-4, atol
    1e-5); at convergence the objective agrees to rtol 1e-5."""
    X, y, w = _problem(digits, binary=True)
    inv_C = (1.0 / C_GRID).astype(np.float32)
    B, d = w.shape[0], X.shape[1]
    ref = jax_lbfgs(
        *_binary_closures_jax(jnp.asarray(X), jnp.asarray(y, jnp.float32),
                              jnp.asarray(w.T), jnp.asarray(inv_C)),
        jnp.zeros((B, d + 1), jnp.float32), max_iter=max_iter, tol=1e-4)
    got = glm_lbfgs_batched(
        *_binary_closures_port(torch.as_tensor(X),
                               torch.as_tensor(y.astype(np.int32)),
                               torch.as_tensor(w.T.copy()),
                               torch.as_tensor(inv_C)),
        torch.zeros((B, d + 1)), max_iter=max_iter, tol=1e-4)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    if max_iter == 5:
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(ref.fun),
                               rtol=1e-5)


def _fit_both(digits, binary, static):
    X, y, w = _problem(digits, binary)
    dj, mj = JaxFam.prepare_data(X, y)
    ref = JaxFam.fit_task_batched(
        {"C": jnp.asarray(C_GRID)}, static,
        {k: jnp.asarray(v) for k, v in dj.items()}, jnp.asarray(w), mj)
    dp, mp = LogisticRegressionFamily.prepare_data(X, y)
    data = {k: torch.as_tensor(v) for k, v in dp.items()}
    got = LogisticRegressionFamily.fit_task_batched(
        {"C": torch.as_tensor(C_GRID)}, static, data, torch.as_tensor(w),
        mp)
    return ref, got, data, mp


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("static", [
    {"max_iter": 5},
    {"max_iter": 5, "fit_intercept": False, "class_weight": "balanced"},
    {"max_iter": 5, "penalty": None},
], ids=["l2", "no_intercept_balanced", "no_penalty"])
def test_fit_task_batched_matches_jax(digits, binary, static):
    ref, got, _, _ = _fit_both(digits, binary, static)
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(ref["n_iter"]))
    for key in ("coef", "intercept"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("binary", [True, False])
def test_full_fit_n_iter_matches_jax(digits, binary):
    ref, got, _, _ = _fit_both(digits, binary, {"max_iter": 100})
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(ref["n_iter"]))


@pytest.mark.parametrize("binary", [True, False])
def test_views_of_jax_models_match_jax(digits, binary):
    """Models fitted by the JAX package, carried across with
    `params_from_jax`, give the same scorer views through the port."""
    ref, _, data, meta = _fit_both(digits, binary, {"max_iter": 30})
    models = {k: np.asarray(v) for k, v in ref.items()}
    X = digits[0][digits[1] < 2] if binary else digits[0][:500]
    needed = ("decision", "pred", "proba")
    want = JaxFam.views_task_batched(
        {k: jnp.asarray(v) for k, v in models.items()}, {},
        {"X": jnp.asarray(X)}, meta, needed)
    got = LogisticRegressionFamily.views_task_batched(
        params_from_jax(models, CPU), {}, data, meta, needed)
    for name in needed:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6)
    back = params_from_jax(models, CPU)
    for k, v in models.items():
        np.testing.assert_array_equal(back[k].cpu().numpy(), v)
