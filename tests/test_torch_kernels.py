"""K2 (loss/gradient epilogue) and K4 (line-search trial losses) of the
PyTorch port: their plain versions against the JAX expressions they
replace, and the wrappers' routing and checks; T2's (tree_best_split)
launch plan and its plain version's fallback index; S2's (svm_dual_step)
launch plan and its kernel's arithmetic emulated in float32 (the lists of
elements that can move, 1-3 bisection steps a pass) against the plain
version.  The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_sklearn_tpu.ops.solvers import _bcast as jax_bcast
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops import svm_kernels as svk
from spark_sklearn_tpu_torch.ops import tree_kernels as tk

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


@pytest.mark.parametrize("regress", [False, True])
def test_mlp_loss_grad_db_matches_jax_bias_grad(regress):
    """M1's db, G summed over a minibatch's rows, is the JAX package's
    gradient of the mean data loss (`batch_loss` of
    spark_sklearn_tpu/models/mlp.py without its L2 term) with respect to
    the output layer's bias, on the same parameters and rows; with M1's
    loss and wsum beside it."""
    from spark_sklearn_tpu.models import mlp as jm
    from spark_sklearn_tpu_torch.ops import mlp_kernels as mk

    fam = jm.MLPRegressorFamily if regress else jm.MLPClassifierFamily
    R, d, h, k = 57, 9, 7, (3 if regress else 5)
    rng = np.random.default_rng(11)
    X = rng.standard_normal((R, d)).astype(np.float32)
    w = (rng.random(R) < 0.67).astype(np.float32)
    y = rng.integers(0, k, R).astype(np.int32)
    Yt = rng.standard_normal((R, k)).astype(np.float32)
    data = {"y_target": jnp.asarray(Yt)} if regress else {
        "y1h": jnp.asarray(np.eye(k, dtype=np.float32)[y])}
    params = jm._init_params(jax.random.PRNGKey(3), (d, h, k), jnp.float32)
    act = jm._activation("relu")

    def mean_loss(p):
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        return fam._loss_terms(jm._forward(p, jnp.asarray(X), act), data,
                               jnp.asarray(w)) / wsum

    want_db = np.asarray(jax.grad(mean_loss)(params)[-1]["b"])
    Z = np.asarray(jm._forward(params, jnp.asarray(X), act))[None]
    loss, wsum, _, db = mk.mlp_loss_grad(
        *_t(Z, w[None]), y=None if regress else torch.as_tensor(y),
        Yt=torch.as_tensor(Yt) if regress else None)
    assert db.shape == (1, k)
    np.testing.assert_allclose(db[0].numpy(), want_db, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss[0] / wsum[0]),
                               float(mean_loss(params)), rtol=1e-5)


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


# ---------------------------------------------------------------------------
# T2 (tree_best_split): its launch plan and the plain version's contract
# ---------------------------------------------------------------------------

# (L, N, d, n_bins, S): phase 10's forest at the root and depth 9, phase
# 9's boosting at the root and depth 4, a 10-class forest (S = 11), few
# bins and S = 3, many stats (fewer stages), many nodes of one lane, one
# feature
SPLIT_PLAN_SHAPES = [(6, 1, 54, 256, 8), (6, 512, 54, 256, 8),
                     (60, 1, 8, 256, 2), (60, 16, 8, 256, 2),
                     (6, 16, 64, 256, 11), (2, 4, 5, 32, 3),
                     (1, 1, 3, 256, 60), (1, 1024, 54, 256, 8),
                     (3, 1, 1, 256, 2)]


def _kernel_items(kept, rank, chunks):
    """The features block `rank` of a (lane, node)'s cluster takes, in
    the kernel's order: entries rank, rank + chunks, ... of the kept
    list."""
    mine = max(0, -(-(len(kept) - rank) // chunks))
    return [kept[rank + i * chunks] for i in range(mine)]


@pytest.mark.parametrize("L,N,d,n_bins,S", SPLIT_PLAN_SHAPES)
def test_split_plan_fills_the_card_and_fits_a_block(L, N, d, n_bins, S):
    n_sm = 132
    plan = tk.split_plan(L, N, d, n_bins, S, n_sm)
    m = n_bins // 16
    chunks, rk, rs = plan["chunks"], plan["rk"], plan["rs"]
    # a (lane, node) spreads over a cluster only while the grid has fewer
    # than SPLIT_BLOCKS_PER_SM blocks an SM, and never over more blocks
    # than it has features
    assert 1 <= chunks <= min(tk.SPLIT_MAX_CHUNKS, d)
    assert plan["grid"] == L * N * chunks
    if chunks > 1:
        assert L * N * (chunks - 1) < tk.SPLIT_BLOCKS_PER_SM * n_sm
    if chunks < min(tk.SPLIT_MAX_CHUNKS, d):
        assert L * N * chunks >= tk.SPLIT_BLOCKS_PER_SM * n_sm
    assert plan["threads"] == tk.SPLIT_THREADS >= n_bins
    # a staged 16-bin block's row holds its 16 x S values; the scan's
    # chain c = (block c // S, stat c % S) reads k·rk + j·S + s, which is
    # c + j·S mod 32 (rk = S mod 32): a warp's 32 chains, 32 banks
    assert rk >= 16 * S and rk % 32 == S % 32
    for c0 in range(0, m * S, 32):
        for j in range(16):
            banks = [((c // S) * rk + j * S + c % S) % 32
                     for c in range(c0, min(c0 + 32, m * S))]
            assert len(set(banks)) == len(banks)
    # the scanned rows: SPLIT_ROW floats a block, few write conflicts
    assert rs >= tk.SPLIT_ROW * m
    assert tk._scan_conflicts(S, m, rs) <= (1 if S in (2, 4, 8) else 2)
    # the copy's width divides a staged row and its stride
    assert (16 * S) % plan["vw"] == 0 and rk % plan["vw"] == 0
    # G features a round, a group of whole warps each, with a thread a
    # scan chain where G > 1, and no more than a block's share of d
    G = plan["groups"]
    assert G in (1, 2, 4, 8) and tk.SPLIT_THREADS // G % 32 == 0
    assert G == 1 or (tk.SPLIT_THREADS // G >= m * S
                      and G // 2 < -(-d // chunks))
    # stages: 3 (two rounds ahead) unless that leaves fewer than four
    # blocks an SM (then 2), fewer only where S is large
    st = plan["stages"]
    assert 1 <= st <= tk.SPLIT_STAGES
    assert plan["smem"] == tk.split_smem(m, S, d, rk, rs, st, G)
    assert plan["smem"] <= tk.SPLIT_MAX_SMEM < tk.MAX_SMEM
    assert st == tk.SPLIT_STAGES or tk.split_smem(
        m, S, d, rk, rs, st + 1, G) > tk.SPLIT_SMEM_FOUR
    assert st >= 2 or tk.split_smem(m, S, d, rk, rs, 2, G) > \
        tk.SPLIT_MAX_SMEM
    # every kept feature of a (lane, node) goes to exactly one block of
    # its cluster, and within the block to one group of one round
    rng = np.random.default_rng(d)
    for kept in ([], [0], list(range(d)),
                 sorted(rng.choice(d, min(d, 7), replace=False).tolist())):
        taken = []
        for r in range(chunks):
            items = _kernel_items(kept, r, chunks)
            rounds = -(-len(items) // G)
            taken += [items[k * G + g] for k in range(rounds)
                      for g in range(G) if k * G + g < len(items)]
        assert sorted(taken) == kept


def test_split_plan_refuses_what_a_block_cannot_take():
    for n_bins in (8, 24, 272):
        with pytest.raises(ValueError):
            tk.split_plan(1, 1, 3, n_bins, 2, 132)
    with pytest.raises(ValueError):
        tk.split_plan(1, 1, 3, 256, 200, 132)


@pytest.mark.parametrize("case", ["all masked", "kept gains all -inf"])
def test_best_splits_plain_falls_back_to_flat_index_zero(case):
    """Where a node has no finite gain the first maximum of its all -inf
    gains is flat index 0 (feature 0, bin 0), as jnp.argmax gives it,
    even where feature 0 is masked: gain -inf, no split.  The card's T2
    skips masked features, so it writes this index itself."""
    rng = np.random.default_rng(5)
    L, N, d, n_bins = 2, 3, 5, 32
    hist = np.stack([rng.poisson(3.0, (L, N, d, n_bins)),
                     -rng.poisson(1.0, (L, N, d, n_bins)),
                     -rng.poisson(1.0, (L, N, d, n_bins))],
                    axis=-1).astype(np.float32)
    fmask = np.ones((N, d), bool)
    fmask[:, 0] = False
    if case == "all masked":
        fmask[1] = False
    else:
        fmask[1] = [False, True, True, False, True]
        hist[:, 1, :, :, 0] = 0.0            # no side holds the weight
    feat, thr, gain, split = tk.best_splits_plain(
        torch.as_tensor(hist), torch.as_tensor(fmask), 1e-6, 1.0)
    assert (feat[:, 1] == 0).all() and (thr[:, 1] == 0).all()
    assert torch.isneginf(gain[:, 1]).all() and not split[:, 1].any()
    # the other nodes split on a kept feature, with a finite gain
    for j in (0, 2):
        assert torch.isfinite(gain[:, j]).all() and split[:, j].all()
        assert fmask[j][feat[:, j].numpy()].all()
    assert int(jnp.argmax(jnp.full((d * n_bins,), -jnp.inf))) == 0


# ---------------------------------------------------------------------------
# S2 (svm_dual_step): its plan, the kept lists and the multi-step passes,
# emulated in float32 as the kernel adds
# ---------------------------------------------------------------------------

def _warp_tree(x):
    """The kernel's shuffle-down tree over the last axis (32 lanes),
    lane 0's result: each round every lane adds lane + o's old value."""
    for o in (16, 8, 4, 2, 1):
        x = torch.cat([x[..., :32 - o] + x[..., o:], x[..., 32 - o:]], -1)
    return x[..., 0]


def _block_sum(terms, threads):
    """(M, slots, threads, J) terms, zero where an element is not in a
    list -> (M, J): each thread's sum over its slots in order, then the
    warps' trees, then the tree over the warps' results."""
    M, slots, T, J = terms.shape
    acc = torch.zeros((M, T, J))
    for q in range(slots):
        acc = acc + terms[:, q]
    warps = _warp_tree(acc.reshape(M, T // 32, 32, J).transpose(2, 3))
    lanes = torch.zeros((M, J, 32))
    lanes[:, :, :T // 32] = warps.transpose(1, 2)
    return _warp_tree(lanes)


def _emulate_dual_step(V, z, x, yb, bound, step, coef, target, levels,
                       skip):
    """S2's arithmetic as the kernel orders it: u, the brackets, each
    thread's list of kept elements (all elements where `skip` is False),
    `levels` bisection steps a pass from the 2**levels - 1 midpoints they
    can visit, then x', z', w' and the residual."""
    M, n = z.shape
    plan = svk.step_plan(n)
    T, slots = plan["threads"], plan["slots"]
    nu = target is not None
    if V is None:
        u = z
    else:
        yv = yb * V
        u = z - step * (yv if nu else -(1.0 - yv))
    finite = torch.isfinite(u) & torch.isfinite(bound) & torch.isfinite(yb)
    kept = ((bound != 0) & (yb != 0)) | ~finite
    if not skip:
        kept = torch.ones_like(kept)
    amax = u.abs().amax(1)
    if nu:
        halves = [torch.where(yb > 0, bound, 0.0),
                  torch.where(yb < 0, bound, 0.0)]
        lo = [-((amax + h.amax(1)) + 1.0) for h in halves]
    else:
        halves = [bound]
        lo = [-(amax + bound.amax(1))]
    hi = [-a for a in lo]
    if skip and not all(bool((h <= 3.4028234663852886e38 / 2).all())
                        for h in hi):
        kept = torch.ones_like(kept)

    def clip(a, b):                       # NaN passes, as the kernel's
        return torch.where(a < 0, 0.0, torch.where(a > b, b, a))

    def slotted(t):
        pad = torch.zeros((M, slots * T))
        pad[:, :n] = t
        return pad.reshape(M, slots, T)

    left = svk.N_BISECT
    while left:
        K = min(levels, left)
        for h, bh in enumerate(halves):
            frm, to, mids = {1: lo[h]}, {1: hi[h]}, {}
            for j in range(1, 2 ** K):
                mids[j] = 0.5 * (frm[j] + to[j])
                frm[2 * j], to[2 * j] = frm[j], mids[j]
                frm[2 * j + 1], to[2 * j + 1] = mids[j], to[j]
            terms = []
            for j in range(1, 2 ** K):
                m = mids[j][:, None]
                t = clip(u - m, bh) if nu else yb * clip(u - m * yb, bh)
                terms.append(slotted(torch.where(kept, t, 0.0)))
            g = _block_sum(torch.stack(terms, -1), T)
            j = torch.ones(M, dtype=torch.long)
            for _ in range(K):
                gj = torch.stack([g[:, c - 1] for c in range(1, 2 ** K)],
                                 1).gather(1, (j - 1)[:, None])[:, 0]
                mj = torch.stack([mids[c] for c in range(1, 2 ** K)],
                                 1).gather(1, (j - 1)[:, None])[:, 0]
                take_hi = gj > (target if nu else 0.0)
                lo[h] = torch.where(take_hi, mj, lo[h])
                hi[h] = torch.where(take_hi, hi[h], mj)
                j = 2 * j + take_hi.long()
        left -= K

    m0 = 0.5 * (lo[0] + hi[0])[:, None]
    if nu:
        m1 = 0.5 * (lo[1] + hi[1])[:, None]
        xn = clip(u - m0, halves[0]) + clip(u - m1, halves[1])
    else:
        xn = clip(u - m0 * yb, bound)
    zn = xn + coef * (xn - x)
    resid = (xn - z).abs().amax(1) / step
    return xn, zn, zn * yb, resid, kept


def _s2_inputs(M, n, seed=0, active=0.16):
    """Rows shaped like phase 8's pair subproblems: yb +-1 on a pair's
    classes and 0 elsewhere, bounds on the fold's rows, ~`active` of the
    elements free."""
    rng = np.random.default_rng(seed)
    yb = rng.choice([-1.0, 0.0, 1.0], size=(M, n),
                    p=[active * 0.6, 1 - active * 1.2, active * 0.6])
    bound = 2.0 * (rng.random((M, n)) < 0.8) * (yb != 0)
    z = rng.uniform(0, 1, (M, n)) * bound
    x = rng.uniform(0, 1, (M, n)) * bound
    V = 3.0 * rng.standard_normal((M, n))
    target = 0.2 * bound.sum(axis=1) + 0.1
    return [torch.as_tensor(a.astype(np.float32))
            for a in (V, z, x, yb, bound, target)] + [torch.tensor(0.05)]


@pytest.mark.parametrize("n", [1, 300, 4096, 4097, 10000, 20481])
def test_step_plan_lays_out_a_list_slot_per_element(n):
    """A thread owns elements t, t + threads, ...; its list's slot q sits
    at q·threads + t, so a warp's loads of one slot hit 32 banks and, in
    the streamed plan, a thread's slots are elements it owns."""
    plan = svk.step_plan(n)
    T, slots = plan["threads"], plan["slots"]
    assert T == svk.STEP_THREADS and T % 32 == 0
    assert (slots - 1) * T < n <= slots * T
    assert plan["plan"] == ("staged" if n <= svk.STAGED_MAX_N
                            else "streamed")
    if plan["plan"] == "staged":
        assert plan["smem"] == 9 * slots * T <= 232448 - 2048
    for t in {0, T - 1, min(T, n) - 1}:
        owned = list(range(t, n, T))
        # the most a thread keeps is every element it owns, each in a slot
        # that is itself one of its elements' positions
        assert [q * T + t for q in range(len(owned))] == owned
    assert svk.step_plan(n, "streamed")["smem"] == 0
    with pytest.raises(ValueError):
        svk.step_plan(n, "cached")


@pytest.mark.parametrize("mode", ["svc", "nu", "project"])
def test_skipping_inert_elements_keeps_the_bits(mode):
    """The kernel's kept lists against summing every element, and 2 (or
    3) bisection steps a pass against one: bitwise equal (an inert
    element adds exactly +-0 at every finite midpoint, and the multi-step
    pass evaluates the midpoints the sequential steps visit); and the result
    within today's tolerance of `dual_step_plain` (atol 1e-5, rtol 1e-5;
    residual 1e-5/step)."""
    V, z, x, yb, bound, target, step = _s2_inputs(6, 700)
    V = None if mode == "project" else V
    target = target if mode == "nu" else None
    runs = {(lv, sk): _emulate_dual_step(V, z, x, yb, bound, step, 0.4,
                                          target, lv, sk)
            for lv in (1, 2, 3) for sk in (False, True)}
    ref = runs[(1, False)]
    assert bool(ref[4].all())
    assert 0.05 < float(runs[(1, True)][4].float().mean()) < 0.25
    for key, got in runs.items():
        for a, b in zip(got[:4], ref[:4]):
            assert torch.equal(a, b), key
    want = svk.dual_step_plain(V, z, x, yb, bound, step, 0.4, target)
    for a, b, atol in zip(ref[:4], want, (1e-5, 1e-5, 1e-5,
                                          1e-5 / float(step))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("mode", ["svc", "nu"])
def test_skipped_nan_in_an_inert_element_still_propagates(mode):
    """A NaN where the bound is 0 is kept (its u is not finite), so its
    row turns NaN as the plain version's does; the other rows keep their
    bits."""
    V, z, x, yb, bound, target, step = _s2_inputs(4, 300, seed=1)
    target = target if mode == "nu" else None
    inert = torch.nonzero(bound[2] == 0)[0, 0]
    V[2, inert] = float("nan")
    clean = _emulate_dual_step(V, z, x, yb, bound, step, 0.4, target, 1,
                               False)
    for lv in (1, 3):
        got = _emulate_dual_step(V, z, x, yb, bound, step, 0.4, target,
                                 lv, True)
        assert bool(got[4][2, inert])
        for a, b in zip(got[:4], clean[:4]):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       equal_nan=True)
    want = svk.dual_step_plain(V, z, x, yb, bound, step, 0.4, target)
    assert torch.isnan(want[0][2]).all() and torch.isnan(got[0][2]).all()
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a[[0, 1, 3]], b[[0, 1, 3]], rtol=1e-5,
                                   atol=1e-5)
