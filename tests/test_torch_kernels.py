"""K2 (loss/gradient epilogue) and K4 (line-search trial losses) of the
PyTorch port: their plain versions against the JAX expressions they
replace, and the wrappers' routing and checks.  The CUDA kernels
themselves are tested on a card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_sklearn_tpu.ops.solvers import _bcast as jax_bcast
from spark_sklearn_tpu_torch.ops import glm_kernels as gk

N, B = 97, 23


def _inputs(k, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    shape = (N, B) if k == 2 else (N, B, k)
    Z = (scale * rng.standard_normal(shape)).astype(np.float32)
    Zp = rng.standard_normal(shape).astype(np.float32)
    wT = (rng.random((N, B)) < 0.8).astype(np.float32)
    y = rng.integers(0, k, N).astype(np.int32)
    a0 = rng.uniform(0.05, 1.0, B).astype(np.float32)
    alphas = (a0[None, :] * 0.5 ** np.arange(16, dtype=np.float32)[:, None]
              ).astype(np.float32)
    return Z, Zp, wT, y, alphas


def _jax_loss_and_grad(Z, wT, y, k):
    """The reference's `data_loss` / `data_grad`
    (spark_sklearn_tpu/models/linear.py:221-226, 279-286)."""
    Z, wT = jnp.asarray(Z), jnp.asarray(wT)
    if k == 2:
        yb = jnp.asarray(y).astype(jnp.float32)

        def data_loss(Z):
            per = jnp.logaddexp(0.0, Z) - yb[:, None] * Z
            return jnp.sum(wT * per, axis=0)

        def data_grad(Z):
            return wT * (jax.nn.sigmoid(Z) - yb[:, None])
    else:
        y1h = jnp.asarray(np.eye(k, dtype=np.float32)[y])

        def data_loss(Z):
            lse = jax.scipy.special.logsumexp(Z, axis=2)
            fit_term = lse - jnp.einsum("nbk,nk->nb", Z, y1h)
            return jnp.sum(wT * fit_term, axis=0)

        def data_grad(Z):
            P = jax.nn.softmax(Z, axis=2)
            return wT[:, :, None] * (P - y1h[:, None, :])
    return data_loss, data_grad


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("k", [2, 10])
def test_loss_grad_plain_matches_jax(k):
    Z, _, wT, y, _ = _inputs(k)
    data_loss, data_grad = _jax_loss_and_grad(Z, wT, y, k)
    loss, G = gk.glm_loss_grad(*_t(Z, wT, y))
    np.testing.assert_allclose(loss.numpy(), np.asarray(data_loss(Z)),
                               rtol=1e-5)
    np.testing.assert_allclose(G.numpy(), np.asarray(data_grad(Z)),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", [2, 10])
def test_trial_loss_plain_matches_jax(k):
    """The trial evaluation of spark_sklearn_tpu/ops/solvers.py:292-298
    (data-loss part; the regulariser stays in the solver)."""
    Z, Zp, wT, y, alphas = _inputs(k, seed=1)
    data_loss, _ = _jax_loss_and_grad(Z, wT, y, k)
    Zj, Zpj = jnp.asarray(Z), jnp.asarray(Zp)

    def eval_trial(a):
        return data_loss(Zj + jax_bcast(a, Zj) * Zpj)

    ref = np.asarray(jax.vmap(eval_trial)(jnp.asarray(alphas)))
    got = gk.glm_trial_loss(*_t(Z, Zp, wT, y, alphas))
    assert got.shape == (16, B)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 10])
def test_plain_versions_handle_extreme_logits_like_jax(k):
    Z, _, wT, y, _ = _inputs(k, seed=2, scale=60.0)
    data_loss, data_grad = _jax_loss_and_grad(Z, wT, y, k)
    loss, G = gk.glm_loss_grad(*_t(Z, wT, y))
    np.testing.assert_allclose(loss.numpy(), np.asarray(data_loss(Z)),
                               rtol=1e-5)
    np.testing.assert_allclose(G.numpy(), np.asarray(data_grad(Z)),
                               rtol=1e-5, atol=1e-7)


def test_cpu_tensors_run_the_plain_version_uncounted():
    Z, Zp, wT, y, alphas = _inputs(10)
    before = dict(gk.LAUNCHES)
    gk.glm_loss_grad(*_t(Z, wT, y))
    gk.glm_trial_loss(*_t(Z, Zp, wT, y, alphas))
    assert gk.LAUNCHES == before


def test_wrapper_checks_reject_bad_inputs():
    Z, _, wT, y, _ = _inputs(10)
    Zt, wt, yt = _t(Z, wT, y)
    with pytest.raises(TypeError):
        gk._check_common(Zt, wt, yt.long())
    with pytest.raises(TypeError):
        gk._check_common(Zt.double(), wt, yt)
    with pytest.raises(ValueError):
        gk._check_common(Zt, wt[:, :-1], yt)
    with pytest.raises(ValueError, match="contiguous"):
        gk._check_common(Zt.transpose(0, 1).contiguous().transpose(0, 1),
                         wt, yt)
    with pytest.raises(ValueError):
        gk._check_common(Zt[:, :, None], wt, yt)
    assert gk._check_common(Zt, wt, yt) == (N, B, 10, False)
    assert gk._check_common(Zt[..., 0].contiguous(), wt, yt) == \
        (N, B, 2, True)


# (n, B, n_sm): the headline shape on a 132-SM card, small and ragged
# shapes, n below the split count a wide grid would want, n = 1
PLAN_SHAPES = [(1797, 5000, 132), (1797, 5000, 114), (301, 77, 132),
               (97, 23, 132), (17, 1, 132), (1, 5, 132), (40, 33, 8),
               (1000, 100000, 132)]


@pytest.mark.parametrize("n,B,n_sm", PLAN_SHAPES)
@pytest.mark.parametrize("trials", [0, 1, 16])
def test_launch_plan_covers_every_row_once(n, B, n_sm, trials):
    """The row splits of the card's grid (computed on the host, no card
    needed): every row in exactly one split, in order, no split under
    MIN_SPLIT_ROWS rows unless n forces it, the lane tiles cover B, and
    the scratch holds one partial sum per (split[, trial], lane)."""
    plan = gk.launch_plan(n, B, n_sm, trials)
    S = plan["splits"]
    assert 1 <= S <= n
    assert plan["grid"] == (-(-B // gk.LANE_TILE), S)
    assert (plan["grid"][0] - 1) * gk.LANE_TILE < B <= \
        plan["grid"][0] * gk.LANE_TILE
    assert plan["block"] == gk.LANE_TILE * gk.WARPS
    assert plan["scratch"] == ((S, trials, B) if trials else (S, B))
    rows = [i for r in gk.split_rows(n, S) for i in r]
    assert rows == list(range(n))
    if S > 1:
        assert min(len(r) for r in gk.split_rows(n, S)) >= \
            min(gk.MIN_SPLIT_ROWS, n // S)
        # no more blocks than the target number of waves needs
        resident = gk.RESIDENT_BLOCKS[
            "glm_trial_loss" if trials else "glm_loss_grad"]
        assert plan["grid"][0] * S <= gk.WAVES * resident * n_sm


@pytest.mark.parametrize("n,S", [(3, 8), (10, 4), (9, 4), (1, 1), (1, 3),
                                 (1797, 27), (64, 64)])
def test_split_rows_cover_every_row_once_for_any_split_count(n, S):
    """The kernel's split arithmetic also holds where S > n (empty
    splits) and where S does not divide n; warp w of a block then takes
    rows r0 + w, r0 + w + WARPS, ..., which again cover the split once."""
    splits = gk.split_rows(n, S)
    assert len(splits) == S
    assert [i for r in splits for i in r] == list(range(n))
    assert max(map(len, splits)) - min(map(len, splits)) <= 1
    for r in splits:
        by_warp = sorted(i for w in range(gk.WARPS)
                         for i in range(r.start + w, r.stop, gk.WARPS))
        assert by_warp == list(r)
