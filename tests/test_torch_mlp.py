"""The port's MLP families against the JAX package's, on the CPU: the
shuffle and the initial weights bit for bit, the lane-batched fit against
`jax.vmap` of the reference fit, a stopped lane's state, and the plain
versions of M1-M3 against autograd.

Tolerances, each measured against the JAX package on these inputs:
- `permutation` and `init_params`: bitwise equal;
- the batched fit (240 digits or diabetes rows, hidden (16,), batch 64,
  6 lanes of different alpha and fold masks): the same `n_iter` per
  lane, exactly, and the parameters within atol 1e-5, rtol 1e-4
  (measured: at most 3e-6 after 60 epochs);
- M1-M3's plain versions against autograd: rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_sklearn_tpu.models import mlp as jm
from spark_sklearn_tpu_torch.models import mlp as pm
from spark_sklearn_tpu_torch.ops import mlp_kernels as mk
from spark_sklearn_tpu_torch.ops import random as jr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# random state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 200, 1625, 1626, 1797, 20640])
def test_permutation_matches_jax(n):
    """1625 is the last size with one sort round, 1626 the first with
    two."""
    for seed in (0, 1, 42):
        for key in (jr.PRNGKey(seed), jr.split(jr.PRNGKey(seed))[1]):
            want = np.asarray(jax.random.permutation(jnp.asarray(key), n))
            got = jr.permutation(key, n).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes", [(64, 16, 10), (8, 64, 1), (5, 7, 3, 2)])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_bitwise(sizes, seed):
    key = jr.split(jr.PRNGKey(seed))[1]
    want = jm._init_params(jnp.asarray(key), sizes, jnp.float32)
    got = pm.layers(pm.init_params(key, sizes), sizes)
    for (W, b), ref in zip(got, want):
        np.testing.assert_array_equal(W.numpy(), np.asarray(ref["W"]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(ref["b"]))


# ---------------------------------------------------------------------------
# the lane-batched fit against jax.vmap of the reference fit
# ---------------------------------------------------------------------------

ALPHAS = np.array([1e-4, 1e-3, 1e-2, 1e-1, 1.0, 3.0], np.float32)


def _problem(kind, digits, diabetes, seed=0):
    if kind == "classifier":
        X, y = digits[0][:240], digits[1][:240]
        jfam, pfam = jm.MLPClassifierFamily, pm.MLPClassifierFamily
    else:
        X = diabetes[0][:240].astype(np.float32)
        X = (X - X.mean(0)) / X.std(0)
        y = (diabetes[1][:240] / 100.0).astype(np.float32)
        jfam, pfam = jm.MLPRegressorFamily, pm.MLPRegressorFamily
    rng = np.random.default_rng(seed)
    W = (rng.random((len(ALPHAS), len(y))) < 0.67).astype(np.float32)
    return X, y, W, jfam, pfam


def _fit_both(kind, static, digits, diabetes, alphas=ALPHAS):
    X, y, W, jfam, pfam = _problem(kind, digits, diabetes)
    W = W[:len(alphas)]
    data, meta = jfam.prepare_data(X, y)
    ref = jax.vmap(lambda a, w: jfam.fit({"alpha": a}, static, data, w,
                                         meta))(jnp.asarray(alphas),
                                                jnp.asarray(W))
    pdata, pmeta = pfam.prepare_data(X, y)
    pdata = {k: torch.as_tensor(v) for k, v in pdata.items()}
    got = pfam.fit_task_batched({"alpha": torch.as_tensor(alphas)}, static,
                                pdata, torch.as_tensor(W), pmeta)
    return ref, got, X.shape[1], pfam._out_dim(pmeta)


def _assert_params_close(ref, got, d, hidden, out):
    sizes = (d, *hidden, out)
    for (W, b), layer in zip(pm.layers(got["params"], sizes), ref["layers"]):
        np.testing.assert_allclose(W.numpy(), np.asarray(layer["W"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(layer["b"]),
                                   rtol=1e-4, atol=1e-5)


FIT_CASES = {
    "adam": dict(solver="adam"),
    "sgd-invscaling": dict(solver="sgd", learning_rate="invscaling",
                           learning_rate_init=0.2),
    # a plateau rule this loose triggers within a few epochs, so the
    # rate decays (and lanes stop) inside the run
    "sgd-adaptive-tanh": dict(solver="sgd", learning_rate="adaptive",
                              learning_rate_init=0.05, activation="tanh",
                              tol=0.05, n_iter_no_change=1),
}


@pytest.mark.parametrize("max_iter", [1, 5])
@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_batched_fit_matches_vmapped_reference(case, max_iter, digits,
                                               diabetes):
    static = dict(hidden_layer_sizes=(16,), batch_size=64, random_state=0,
                  max_iter=max_iter, **FIT_CASES[case])
    ref, got, d, out = _fit_both("classifier", static, digits, diabetes)
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(ref["n_iter"]))
    _assert_params_close(ref, got, d, (16,), out)


STOP_CASES = {
    "classifier-adam-early": ("classifier", dict(
        solver="adam", activation="tanh", early_stopping=True,
        n_iter_no_change=2, tol=1e-3, max_iter=30)),
    "classifier-sgd-early-logistic": ("classifier", dict(
        solver="sgd", learning_rate_init=0.05, activation="logistic",
        early_stopping=True, n_iter_no_change=2, tol=1e-3, max_iter=20)),
    "classifier-sgd-adaptive": ("classifier", dict(
        solver="sgd", learning_rate="adaptive", learning_rate_init=0.05,
        tol=0.05, n_iter_no_change=1, max_iter=40)),
    "regressor-adam-plateau": ("regressor", dict(
        solver="adam", learning_rate_init=0.01, tol=1e-2,
        n_iter_no_change=2, max_iter=40)),
    "regressor-sgd-early": ("regressor", dict(
        solver="sgd", learning_rate_init=0.01, early_stopping=True,
        n_iter_no_change=2, tol=1e-3, max_iter=30)),
}


@pytest.mark.parametrize("case", sorted(STOP_CASES))
def test_stopping_rules_match_vmapped_reference(case, digits, diabetes):
    """Lanes that stop at different epochs: n_iter exactly, and the
    parameters (the restored best ones with early stopping)."""
    kind, extra = STOP_CASES[case]
    static = dict(hidden_layer_sizes=(16,), batch_size=64, random_state=0,
                  **extra)
    ref, got, d, out = _fit_both(kind, static, digits, diabetes)
    n_iter = np.asarray(ref["n_iter"])
    np.testing.assert_array_equal(got["n_iter"].numpy(), n_iter)
    _assert_params_close(ref, got, d, (16,), out)


def test_stopped_lane_keeps_its_weights(digits, diabetes):
    """Fitted together, lanes that stop early come out as each lane
    fitted alone: a stopped lane's parameters and count do not move
    while the others go on."""
    static = dict(hidden_layer_sizes=(16,), batch_size=64, random_state=0,
                  solver="adam", activation="tanh", early_stopping=True,
                  n_iter_no_change=2, tol=1e-3, max_iter=30)
    X, y, W, _, pfam = _problem("classifier", digits, diabetes)
    data, meta = pfam.prepare_data(X, y)
    data = {k: torch.as_tensor(v) for k, v in data.items()}
    together = pfam.fit_task_batched(
        {"alpha": torch.as_tensor(ALPHAS)}, static, data,
        torch.as_tensor(W), meta)
    its = together["n_iter"].numpy()
    assert len(set(its.tolist())) > 1 and its.min() < 30
    for b in range(len(ALPHAS)):
        alone = pfam.fit_task_batched(
            {"alpha": torch.as_tensor(ALPHAS[b:b + 1])}, static, data,
            torch.as_tensor(W[b:b + 1]), meta)
        assert int(alone["n_iter"][0]) == its[b]
        torch.testing.assert_close(alone["params"][0],
                                   together["params"][b], rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# M1-M3's plain versions against autograd
# ---------------------------------------------------------------------------

def _rand(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


@pytest.mark.parametrize("regress", [False, True])
def test_loss_grad_plain_matches_autograd(regress):
    B, R, k = 4, 37, 5
    Z = _rand(0, B, R, k).requires_grad_()
    w = (_rand(1, B, R) > 0).float()
    w[2] = 0.0                                   # wsum clamps at 1
    y = torch.randint(0, k, (R,), generator=torch.Generator().manual_seed(2),
                      dtype=torch.int32)
    Yt = _rand(3, R, k)
    kw = {"Yt": Yt} if regress else {"y": y}
    loss, wsum, G = mk.mlp_loss_grad(Z.detach(), w, **kw)
    if regress:
        per = 0.5 * ((Z - Yt[None]) ** 2).sum(2)
    else:
        per = -torch.log_softmax(Z, 2).gather(
            2, y.long()[None, :, None].expand(B, -1, 1))[..., 0]
    want_wsum = torch.clamp_min(w.sum(1), 1.0)
    want_loss = (w * per).sum(1)
    (want_loss / want_wsum).sum().backward()
    torch.testing.assert_close(wsum, want_wsum)
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(G, Z.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh", "logistic", "identity"])
def test_act_plain_matches_autograd(act):
    A = _rand(0, 3, 11, 6).requires_grad_()
    b = _rand(1, 3, 6)
    H = mk.mlp_act_forward(A, b, act)
    ref = {"relu": torch.relu, "tanh": torch.tanh,
           "logistic": torch.sigmoid, "identity": lambda x: x}[act](
        A + b[:, None, :])
    torch.testing.assert_close(H, ref.detach())
    dH = _rand(2, 3, 11, 6)
    ref.backward(dH)
    torch.testing.assert_close(mk.mlp_act_backward(dH, H.detach(), act),
                               A.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_hand_backward_matches_autograd(kind, act, digits, diabetes):
    """The minibatch gradient the fit hands M2 (forward, M1, the
    written-out backward with M3) is autograd's of the mean data loss."""
    X, y, W, _, pfam = _problem(kind, digits, diabetes)
    data, meta = pfam.prepare_data(X[:50], y[:50])
    sizes = (X.shape[1], 16, 8, pfam._out_dim(meta))
    p = (0.3 * _rand(4, 3, pm.param_layout(sizes)[1])).requires_grad_()
    Xb = torch.as_tensor(data["X"]).expand(3, -1, -1)
    w = torch.as_tensor(W[:3, :50])
    lab, tgt = pfam._targets({k: torch.as_tensor(v)
                              for k, v in data.items()})
    loss, wsum, g = pfam._batch_grad(p.detach(), Xb, w, lab, tgt, sizes,
                                     act)
    Z = pm.forward(p, Xb, sizes, act)
    want = mk.mlp_loss_grad_plain(Z, w, lab, tgt)[0]
    (want / wsum).sum().backward()
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("adam", [True, False])
def test_opt_step_plain_matches_torch_optimizer(adam):
    """Each active lane steps as `torch.optim.Adam` (or SGD with
    momentum, sign-flipped velocity) on its gradient plus alpha·W/wsum;
    an inactive lane keeps every state bit; the loss sum adds the L2
    term."""
    B, P = 3, 9
    p = _rand(0, B, P)
    g = _rand(1, B, P)
    wmask = torch.tensor([True] * 6 + [False] * 3)
    alpha = torch.tensor([0.1, 1.0, 0.5])
    wsum = torch.tensor([7.0, 3.0, 1.0])
    lr = torch.tensor([0.01, 0.1, 0.05])
    active = torch.tensor([True, False, True])
    loss = torch.tensor([2.0, 3.0, 4.0])
    acc = torch.zeros(B)
    m, v, t = torch.zeros(B, P), torch.zeros(B, P), torch.zeros(B)
    p0 = p.clone()
    for _ in range(3):
        mk.mlp_opt_step(p, g, m, v if adam else None, t if adam else None,
                        wmask, alpha, wsum, lr, active, loss, acc,
                        adam=adam)
    for b in range(B):
        if not active[b]:
            torch.testing.assert_close(p[b], p0[b], rtol=0, atol=0)
            assert float(acc[b]) == 0.0
            continue
        q = p0[b].clone().requires_grad_()
        opt = (torch.optim.Adam([q], lr=float(lr[b]), eps=1e-8) if adam
               else torch.optim.SGD([q], lr=float(lr[b]), momentum=0.9))
        accs = 0.0
        for _ in range(3):
            opt.zero_grad()
            l2 = (q.detach() ** 2 * wmask).sum()
            accs += float((loss[b] / wsum[b] + 0.5 * alpha[b] * l2
                           / wsum[b]) * wsum[b])
            q.grad = g[b] + wmask * alpha[b] * q.detach() / wsum[b]
            opt.step()
        torch.testing.assert_close(p[b], q.detach(), rtol=1e-5, atol=1e-6)
        assert abs(float(acc[b]) - accs) <= 1e-5 * abs(accs)


@pytest.mark.parametrize("P", [1, 255, 256, 641, 2048, 4874, 20001,
                               100000])
def test_opt_plan_keeps_the_l2_order(P):
    """M2's cluster plan: every round of 256 parameters goes to one block
    of one wave, and the first block, reading the cluster's blocks in
    rank order a wave, adds each partial's rounds in round order, as the
    one-block kernel did (so `acc` keeps its bits)."""
    plan = mk.opt_plan(P)
    C, rb, waves = plan["cluster"], plan["rounds"], plan["waves"]
    K = -(-P // mk.OPT_THREADS)
    assert 1 <= C <= mk.OPT_MAX_CLUSTER and 1 <= rb <= mk.OPT_ROUNDS
    assert C <= K and (waves - 1) * C * rb < K <= waves * C * rb
    order = [k0 + c * rb + r for k0 in range(0, K, C * rb)
             for c in range(C) for r in range(rb) if k0 + c * rb + r < K]
    assert order == list(range(K))


@pytest.mark.parametrize("lanes,per_lane,vec", [
    (12, 200 * 64, True), (1, 12 * 200 * 64, True), (6, 200 * 64, True),
    (12, 1797 * 64, True), (1, 1, False), (3, 37 * 5, False),
    (70000, 64, False), (1, 2 ** 30, True), (4096, 4, True)])
def test_act_plan_covers_every_element(lanes, per_lane, vec):
    """M3's plan: with `vec` each lane's per_lane floats are float4s, a
    grid row a lane; else floats over all lanes in one row.  A launch has
    at most `ACT_MAX_BLOCKS` blocks (more items stride) and covers every
    item: blocks x threads x strides >= items."""
    plan = mk.act_plan(lanes, per_lane, vec)
    assert plan["vec"] is vec and plan["threads"] == mk.ACT_THREADS == 256
    items = -(-per_lane // 4) if vec else lanes * per_lane
    rows = lanes if vec else 1       # the grid's rows: a lane's with vec
    assert 1 <= plan["grid"] * rows <= max(mk.ACT_MAX_BLOCKS, rows)
    strides = -(-items // (plan["grid"] * plan["threads"]))
    assert plan["grid"] * plan["threads"] * strides >= items
    if items <= mk.ACT_THREADS * mk.ACT_MAX_BLOCKS // rows:
        assert strides == 1          # BASELINE #5: a float4 a thread


def test_act_vec_takes_aligned_multiples_of_four():
    """16 bytes a thread only where the width is a multiple of 4 and
    every tensor is 16-byte aligned (a view one float in is not)."""
    a = torch.zeros(2 * 200 * 64 + 4)
    whole = a[:2 * 200 * 64].view(2, 200, 64)
    shifted = a[1:1 + 2 * 200 * 64].view(2, 200, 64)
    assert mk.act_vec(64, whole) and not mk.act_vec(62, whole)
    assert not mk.act_vec(64, whole, shifted)


# ---------------------------------------------------------------------------
# the sklearn-free estimators: one lane of the batched fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_standalone_estimator_matches_reference_fit(kind, digits,
                                                    diabetes):
    """The port's MLPClassifier/MLPRegressor fit all rows at weight 1:
    the reference family's fit with all-ones weights, and sklearn's
    fitted attributes."""
    import spark_sklearn_tpu_torch as port
    X, y, _, jfam, _ = _problem(kind, digits, diabetes)
    params = dict(hidden_layer_sizes=(16, 8), max_iter=6, batch_size=64,
                  random_state=3, alpha=1e-3)
    est = (port.MLPClassifier if kind == "classifier"
           else port.MLPRegressor)(device="cpu", **params).fit(X, y)
    data, meta = jfam.prepare_data(X, y)
    ref = jfam.fit({}, params, data, jnp.ones(len(y), jnp.float32), meta)
    assert est.n_iter_ == int(ref["n_iter"]) == 6
    assert est.n_layers_ == 4 and est.n_features_in_ == X.shape[1]
    for W, b, layer in zip(est.coefs_, est.intercepts_, ref["layers"]):
        np.testing.assert_allclose(W, np.asarray(layer["W"]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(b, np.asarray(layer["b"]), rtol=1e-4,
                                   atol=1e-5)
    if kind == "classifier":
        np.testing.assert_array_equal(est.classes_, np.unique(y))
        assert est.predict_proba(X[:5]).shape == (5, len(np.unique(y)))
    assert est.predict(X[:5]).shape == (5,)


@pytest.mark.parametrize("static", [{"solver": "lbfgs"},
                                    {"solver": "sgd",
                                     "learning_rate": "optimal"},
                                    {"activation": "softplus"}])
def test_unsupported_settings_raise(static, digits):
    data, meta = pm.MLPClassifierFamily.prepare_data(*[a[:20] for a in
                                                       digits])
    data = {k: torch.as_tensor(v) for k, v in data.items()}
    with pytest.raises(ValueError):
        pm.MLPClassifierFamily.fit_task_batched(
            {}, static, data, torch.ones(1, 20), meta)
