"""K2 (loss/gradient epilogue) and K4 (line-search trial losses) of the
PyTorch port: their plain versions against the JAX expressions they
replace, and the wrappers' routing and checks; T2's (tree_best_split)
launch plan and its plain version's fallback index; S2's (svm_dual_step)
launch plan and its kernel's arithmetic emulated in float32 (the lists of
elements that can move, 1-3 bisection steps a pass) against the plain
version; N1's (knn_fold_topk) plans and its warp plan's selection
emulated (a sorted key a lane, the early compare, the inserts) against
the plain version; C1's (kmeans_assign) plan: every (lane, row) once, a
block within its shared memory.  The CUDA kernels themselves are tested
on a card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_sklearn_tpu.ops.solvers import _bcast as jax_bcast
from spark_sklearn_tpu_torch.ops import glm_kernels as gk
from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
from spark_sklearn_tpu_torch.ops import knn_kernels as knk
from spark_sklearn_tpu_torch.ops import nb_kernels as nbk
from spark_sklearn_tpu_torch.ops import svm_kernels as svk
from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk
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


# N1 (knn_fold_topk): its plans and its warp plan's selection, emulated

@pytest.mark.parametrize("n,maxk,F,want", [
    (10000, 15, 5, "warp"), (20640, 15, 5, "warp"), (20640, 32, 5, "warp"),
    (20640, 33, 5, "staged"), (30000, 33, 5, "streamed"),
    (100000, 15, 8, "streamed"), (100000, 15, 5, "warp"),
    (1000, 7, 10, "warp"), (1000, 1024, 1, "staged"),
])
def test_topk_plan_picks_and_sizes_each_plan(n, maxk, F, want):
    plan = knk.topk_plan(n, maxk, F)
    assert plan["plan"] == want
    if want == "warp":
        g, fg = plan["groups"], plan["folds"]
        assert fg <= knk.WARP_FOLDS and (g - 1) * fg < F <= g * fg
        assert g == -(-F // knk.WARP_FOLDS)
        assert plan["smem"] == 4 * fg * -(-n // 32) <= \
            knk.WARP_MAX_MASK_BYTES
    else:
        assert plan["P"] >= maxk > plan["P"] // 2
        assert plan["smem"] <= 232448
    for forced in knk.PLANS:
        ok = not ((forced == "warp" and maxk > knk.WARP_MAX_K)
                  or (forced == "warp" and want == "streamed"
                      and maxk <= knk.WARP_MAX_K)
                  or (forced == "staged" and n > knk.STAGED_MAX_N))
        if ok:
            assert knk.topk_plan(n, maxk, F, forced)["plan"] == forced
        else:
            with pytest.raises(ValueError, match="cannot take"):
                knk.topk_plan(n, maxk, F, forced)
    with pytest.raises(ValueError, match="unknown"):
        knk.topk_plan(n, maxk, F, "bitonic")


def _warp_select(G, sq_r, sq_c, masks, maxk, unroll=8):
    """The warp plan of csrc/knn_topk.cu, step by step in numpy: a warp a
    row; per fold 32 keys sorted across the lanes; a column turned away
    when its least key is above every fold's threshold's high word; the
    others inserted one lane at a time by the shuffle's shift."""
    m, n = G.shape
    F = masks.shape[0]
    inf_bits = np.uint64(0x7F800000)
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    d = np.maximum((sq_r[:, None] + sq_c[None, :]) - np.float32(2) * G,
                   np.float32(0)) + np.float32(0)
    bits = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    lanes = np.arange(32)
    out_d2 = np.zeros((F, m, maxk), np.float32)
    out_idx = np.zeros((F, m, maxk), np.int32)
    for i in range(m):
        lst = np.full((F, 32), full, np.uint64)
        thr = np.full(F, full, np.uint64)
        thr_hi = np.uint64(0xFFFFFFFF)
        for base in range(0, n, 32 * unroll):
            for q in range(unroll):
                j = base + 32 * q + lanes
                live = j < n
                jj = np.minimum(j, n - 1)
                key = bits[i, jj]
                maybe = live & (np.minimum(key, inf_bits) <= thr_hi)
                if not maybe.any():
                    continue
                changed = False
                for f in range(F):
                    kb = np.where(masks[f, jj] > 0, key, inf_bits)
                    c = (kb << np.uint64(32)) | jj.astype(np.uint64)
                    ball = maybe & (c < thr[f])
                    while ball.any():
                        src = int(np.flatnonzero(ball)[0])
                        v = c[src]
                        prev = np.concatenate([lst[f, :1], lst[f, :-1]])
                        lst[f] = np.where(
                            lst[f] > v,
                            np.where((lanes == 0) | (prev < v), v, prev),
                            lst[f])
                        thr[f] = lst[f, maxk - 1]
                        ball[src] = False
                        ball &= maybe & (c < thr[f])
                        changed = True
                if changed:
                    thr_hi = np.uint64(max(int(t >> np.uint64(32))
                                           for t in thr))
        out_d2[:, i] = (lst[:, :maxk] >> np.uint64(32)).astype(
            np.uint32).view(np.float32)
        out_idx[:, i] = (lst[:, :maxk] & np.uint64(0xFFFFFFFF)).astype(
            np.int32)
    return out_d2, out_idx


@pytest.mark.parametrize("m,n,F,maxk,dup,unroll", [
    (12, 300, 3, 5, False, 8), (9, 200, 2, 32, True, 2),
    (7, 70, 4, 1, False, 1), (6, 97, 5, 15, True, 8),
])
def test_warp_select_matches_the_plain_sort(m, n, F, maxk, dup, unroll):
    """The warp plan's selection gives the plain version's bits, ties,
    duplicates and short folds included (fold 0 keeps 3 columns)."""
    rng = np.random.default_rng(m * n)
    Xc = rng.standard_normal((n, 4)).astype(np.float32)
    if dup:
        Xc[n // 2:] = Xc[:n - n // 2]
    Xr = Xc[:m]
    masks = (rng.random((F, n)) < 0.7).astype(np.float32)
    masks[0] = 0.0
    masks[0, [3, n // 2, n - 1]] = 1.0
    G = Xr @ Xc.T
    sq_r, sq_c = (Xr * Xr).sum(1), (Xc * Xc).sum(1)
    got_d2, got_idx = _warp_select(G, sq_r, sq_c, masks, maxk, unroll)
    want_d2, want_idx = knk.knn_fold_topk_plain(
        *(torch.as_tensor(a) for a in (G, sq_r, sq_c, masks)), maxk)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_d2.view(np.uint32),
                                  want_d2.numpy().view(np.uint32))


# C1 (kmeans_assign): its plan

@pytest.mark.parametrize("n,d,B", [
    (100000, 54, 20), (2000, 54, 6), (300, 4, 9), (1000, 784, 60),
    (5, 3, 2), (129, 54, 60), (4097, 10, 8), (3000, 100, 1),
    (300, 784, 8),                    # the shared memory's limit
])
def test_assign_plan_covers_each_lane_and_row_once(n, d, B):
    """The kernel's indexing over `assign_plan`'s grid (blocks, lane
    groups) x 8 warps x 32 threads x 2 rows: every (lane, row) once;
    the d-tiles cover t = 0 .. d-1 in order; shared memory within the
    default 48 KB, a d-tile's quads whole; the copy width divides d and
    the pointers' alignment; rows and a block's center rows powers of
    two (the kernel's shifts)."""
    plan = kmk.assign_plan(n, d, B)
    lanes, rows = plan["lanes"], plan["rows"]
    lane_warps = 8 // lanes
    assert rows == 64 * lane_warps and plan["grid"] == (
        -(-n // rows), -(-B // lanes))
    seen = np.zeros((plan["groups"] * lanes, plan["blocks"] * rows), int)
    for by in range(plan["groups"]):
        for warp in range(8):
            b = by * lanes + warp // lane_warps
            for bx in range(plan["blocks"]):
                rb = bx * rows + (warp % lane_warps) * 64 + np.arange(32)
                for q in range(kmk.ROWS_PER_THREAD):
                    seen[b, rb + 32 * q] += 1
    assert (seen == 1).all()
    assert -(-B // lanes) * lanes == min(-(-B // L) * L for L in (1, 2, 4, 8))
    t0 = list(range(0, d, plan["dtile"]))
    assert sum(min(plan["dtile"], d - t) for t in t0) == d
    assert plan["dtile"] == d or plan["dtile"] % 4 == 0
    assert plan["dpad"] == 4 * -(-plan["dtile"] // 4)
    assert plan["smem"] == 4 * (rows + 8 * lanes) * plan["dpad"] \
        <= kmk.ASSIGN_MAX_SMEM
    assert rows & (rows - 1) == 0 and (8 * lanes) & (8 * lanes - 1) == 0
    assert d % plan["vec"] == 0
    assert kmk.assign_plan(n, d, B, align=8)["vec"] <= 2
    assert kmk.assign_plan(n, d, B, align=4)["vec"] == 1


@pytest.mark.parametrize("m,d,B,k,n_sm", [
    (100000, 54, 60, 7, 132),       # phase 12's GaussianNB views
    (333, 784, 3, 10, 132),         # d in 13 feature chunks, 2 class chunks
    (100, 3000, 2, 5, 132), (5, 3, 70, 20, 132), (1, 1, 1, 1, 132),
    (257, 64, 4, 3, 8), (70000, 17, 1, 9, 132),
])
def test_jll_plan_covers_every_lane_row_and_class_once(m, d, B, k, n_sm):
    """B1's blocks (row tiles x lane groups), as the kernel walks them:
    every (lane, row, class) written once, each sum over every feature
    once in feature order; the block's shared memory within 227 KB; the
    grid's lane groups within CUDA's 65535."""
    plan = nbk.jll_plan(m, d, B, k, n_sm)
    seen = np.zeros((B, m, k), int)
    for b, rows, classes, chunks in nbk.jll_tiles(plan, m, d, B, k):
        assert [t for c in chunks for t in c] == list(range(d))
        assert all(len(c) <= plan["tc"] for c in chunks)
        seen[b, rows.start:rows.stop, classes.start:classes.stop] += 1
    assert (seen == 1).all()
    assert plan["kc"] == min(k, nbk.JLL_MAX_KC)
    assert plan["tc"] * nbk.JLL_X_STRIDE * 4 <= nbk.JLL_X_BUDGET
    assert plan["smem"] <= 232448 and plan["grid"][1] <= 65535
    tiles = plan["grid"][0]
    assert tiles * plan["grid"][1] >= min(
        tiles * B, nbk.JLL_BLOCKS_PER_SM * n_sm)


@pytest.mark.parametrize("n", [1, 255, 256, 10000, 20480, 20481])
def test_platt_plan_lays_out_a_slot_per_element(n):
    """P1: a block a row, thread t taking elements t, t + threads, ...;
    its q-th kept element at slot q·threads + t, within the staged
    plans' 9 bytes a slot (<= 227 KB; "staged_full" the same list) or
    read again a pass (streamed)."""
    plan = pk.platt_plan(n)
    T, slots = plan["threads"], plan["slots"]
    assert T == pk.PLATT_THREADS and T % 32 == 0
    assert (slots - 1) * T < n <= slots * T
    assert plan["plan"] == ("staged" if n <= pk.PLATT_STAGED_MAX_N
                            else "streamed")
    assert plan["exit"]
    if plan["plan"] == "staged":
        assert plan["smem"] == 9 * slots * T <= 232448 - 1024
        full = pk.platt_plan(n, "staged_full")
        assert full["smem"] == plan["smem"] and not full["exit"]
    else:
        assert plan["smem"] == 0
        with pytest.raises(ValueError, match="do not fit"):
            pk.platt_plan(n, "staged")
    for t in {0, min(T, n) - 1}:
        owned = list(range(t, n, T))
        assert len({q * T + t for q in range(len(owned))}) == len(owned)
        assert max(q * T + t for q in range(len(owned))) < slots * T
    with pytest.raises(ValueError):
        pk.platt_plan(n, "cached")


def _platt_bound_case(case, seed=0):
    """Phase 13-like multiclass labels (10 classes, fold weights holding
    about a fifth out), binary labels, or the multiclass case with
    non-finite decisions."""
    rng = np.random.default_rng(seed)
    B, n = 6, 3000
    k = 2 if case == "binary" else 10
    y = rng.integers(0, k, n).astype(np.int32)
    pairs = np.array([(i, j) for i in range(k) for j in range(i + 1, k)],
                     np.int32)
    tw = (rng.random((B, n)) < 0.8).astype(np.float32)
    tw[1, : n // 2] = 0.0                         # a fold holding half out
    dec = rng.standard_normal((B, n, len(pairs))).astype(np.float32)
    if case == "nan":
        dec[0, 5, :] = np.nan                     # NaN in every pair
        dec[2, np.where(tw[2] > 0)[0][:3], 0] = np.nan
        dec[3, np.where(tw[3] == 0)[0][:400], 1] = np.inf
    return dec, y, tw, pairs


@pytest.mark.parametrize("case", ["multiclass", "binary", "nan"])
def test_platt_plan_list_covers_every_row(case):
    """P1's staged list holds every (task, pair) row's kept elements as
    the kernel keeps them (a weight not 0 in the pair's classes, or a
    non-finite decision: `platt_inputs`' weights, or a non-finite f), on
    phase 13-like labels, on binary labels and with non-finite decisions
    on weighted and unweighted elements: thread t's q-th kept element at
    slot q·threads + t, each in its own slot, all below the list's
    slots·threads."""
    dec, y, tw, pairs = _platt_bound_case(case)
    B, n, P = dec.shape
    f, _, w = pk.platt_inputs(torch.as_tensor(dec), torch.as_tensor(y),
                              torch.as_tensor(tw), torch.as_tensor(pairs),
                              case == "binary")
    kept = ((w != 0) | ~torch.isfinite(f)).numpy()            # (B·P, n)
    plan = pk.platt_plan(n)
    T, cap = plan["threads"], plan["slots"] * plan["threads"]
    assert plan["smem"] == 9 * cap
    for row in kept:
        slots = []
        for t in range(T):
            q = np.arange(int(row[t::T].sum()))
            slots.extend((q * T + t).tolist())
        assert len(slots) == int(row.sum()) == len(set(slots))
        assert max(slots, default=-1) < cap
    if case == "nan":
        assert (kept & (w == 0).numpy()).any()


@pytest.mark.parametrize("k", [2, 3, 10, 12, 13, 26, 27, 41, 42, 50, 64,
                               65, 120, 239, 240])
def test_coupling_plan_fits_a_block(k):
    """P2: the register plan for 2 <= k <= 12; the group plan above, G
    lanes a problem by `COUPLING_GROUP_SPANS` (4 to k = 28, 8 to 40, 16
    to 64, the spans covering 13 to 64 without a gap); then shared
    memory, a whole number of warps a block within the block's most (k <=
    239); then the global plan, whose grid's warps each hold one
    problem's state in a scratch within its budget.  No k is refused by
    the default choice, and the register and group plans cover every
    problem with a thread or a group each."""
    problems = 450000
    mem = 4 * pk.coupling_mem_floats(k)
    assert pk.coupling_mem_floats(k) == k * (k | 1) + 3 * k
    plan = pk.coupling_plan(k, problems=problems)
    if 2 <= k <= pk.COUPLING_REG_MAX_K:
        assert plan == {"plan": "registers",
                        "threads": pk.COUPLING_THREADS, "smem": 0,
                        "grid": -(-problems // pk.COUPLING_THREADS),
                        "scratch": 0, "group": 1, "slots": k}
    else:
        with pytest.raises(ValueError):
            pk.coupling_plan(k, "registers")
        want = ("group" if k <= 64 else "shared" if k <= 239 else "global")
        assert plan["plan"] == want
    lasts = [last for _, last in pk.COUPLING_GROUP_SPANS]
    assert lasts == sorted(lasts) and lasts[0] > pk.COUPLING_REG_MAX_K
    G = pk.coupling_group(k)
    if pk.COUPLING_REG_MAX_K < k <= 64:
        assert G == (4 if k <= 28 else 8 if k <= 40 else 16)
        gr = pk.coupling_plan(k, "group", problems)
        assert (gr["group"], gr["slots"]) == (G, -(-k // G))
        assert gr["smem"] == 0
        assert gr["grid"] * gr["threads"] >= problems * G > \
            (gr["grid"] - 1) * gr["threads"]
    else:
        assert G == 0
        with pytest.raises(ValueError, match="group plan"):
            pk.coupling_plan(k, "group")
    if mem > pk.COUPLING_SMEM_MAX:
        with pytest.raises(ValueError, match="shared memory"):
            pk.coupling_plan(k, "shared")
    else:
        sh = pk.coupling_plan(k, "shared", problems)
        assert sh["group"] == 32
        assert sh["threads"] % 32 == 0 and 32 <= sh["threads"] <= 128
        assert sh["smem"] == sh["threads"] // 32 * mem <= \
            pk.COUPLING_SMEM_MAX
        assert sh["smem"] + mem > pk.COUPLING_SMEM_MAX or \
            sh["threads"] == pk.COUPLING_THREADS
        per_block = sh["threads"] // 32
        assert sh["grid"] * per_block >= problems > \
            (sh["grid"] - 1) * per_block
    gl = pk.coupling_plan(k, "global", problems)
    assert gl["smem"] == 0 and gl["threads"] == pk.COUPLING_THREADS
    assert gl["group"] == 32
    per_block = gl["threads"] // 32
    assert 1 <= gl["grid"] <= -(-problems // per_block)
    assert gl["scratch"] == gl["grid"] * per_block * mem // 4
    assert 4 * gl["scratch"] <= max(pk.COUPLING_SCRATCH_BUDGET,
                                    per_block * mem)
    with pytest.raises(ValueError):
        pk.coupling_plan(k, "texture")


@pytest.mark.parametrize("n", [1, 511, 512, 13824, 13825, 20640,
                               svk.SVR_MAX_N, svk.SVR_MAX_N + 1])
def test_svr_step_plan_keeps_each_list_inside_its_rows(n):
    """S2's SVR mode: CTA c of the row's cluster owns the pairs [c·share,
    (c + 1)·share), its thread t keeps its q-th kept a and a* elements at
    slot q·threads + t of its two lists, below the `slots`·threads a list
    holds (16 bytes a pair slot, within 227 KB beside the reductions'
    static shared memory); a row longer than 16 CTAs' lists is
    refused."""
    if n > svk.SVR_MAX_N:
        with pytest.raises(ValueError, match="are over"):
            svk.svr_step_plan(n)
        return
    plan = svk.svr_step_plan(n)
    T, slots = plan["threads"], plan["slots"]
    C, share = plan["cluster"], plan["share"]
    assert C * share >= n > (C - 1) * share
    assert (slots - 1) * T < share <= slots * T
    assert plan["smem"] == 16 * slots * T <= 232448 - svk.SVR_STATIC_SMEM
    for c in {0, C - 1}:
        for t in {0, T - 1}:
            owned = range(c * share + t, min(n, (c + 1) * share), T)
            assert all(q * T + t < slots * T for q in range(len(owned)))


@pytest.mark.parametrize("n,cluster", [(1, None), (511, None),
                                       (13825, None), (20640, None),
                                       (13825, 1), (20640, 3), (20640, 16),
                                       (svk.SVR_MAX_N, None)])
def test_svr_cluster_plan_gives_each_pair_one_slot(n, cluster):
    """S2's SVR plan: every pair of a row lies in exactly one CTA's share
    and takes exactly one of its thread's slots (both lists alike), each
    CTA's shared memory within 227 KB, 1 to 16 CTAs a row (a CTA past a
    short row's end holds none); a cluster too small for the row's
    lists, or too large, is refused."""
    plan = svk.svr_step_plan(n, cluster=cluster)
    C, share, T, slots = (plan[k] for k in ("cluster", "share", "threads",
                                            "slots"))
    assert 1 <= C <= svk.SVR_MAX_CLUSTER and C == (cluster or C)
    assert plan["smem"] + svk.SVR_STATIC_SMEM <= 232448
    assert share <= svk.SVR_SHARE_MAX
    seen = np.zeros(n, int)
    for c in range(C):
        slots_used = set()
        for t in range(T):
            for q, i in enumerate(range(c * share + t,
                                        min(n, (c + 1) * share), T)):
                assert q < slots
                slots_used.add(q * T + t)
                seen[i] += 1
        assert len(slots_used) == max(0, min(n, (c + 1) * share)
                                      - c * share)
    assert (seen == 1).all()
    with pytest.raises(ValueError, match="are over"):
        svk.svr_step_plan(svk.SVR_MAX_N + 1)
    with pytest.raises(ValueError, match="do not fit"):
        svk.svr_step_plan(n, cluster=svk.SVR_MAX_CLUSTER + 1)
    if n > svk.SVR_SHARE_MAX:
        with pytest.raises(ValueError, match="do not fit"):
            svk.svr_step_plan(n, cluster=1)


@pytest.mark.parametrize("n,rows,held,want", [
    (1, 5, None, 1), (500, 5, None, 4), (1000, 5, None, 8),
    (2000, 5, None, 16), (20640, 5, None, 16),
    # the card holds 7 clusters of 16 (a GPC's 16-18 SMs each) and 33 of 4
    (20640, 5, {16: 7}, 16), (20640, 8, {16: 7, 15: 7, 14: 8}, 14),
    (20640, 30, {16: 7, 8: 16, 5: 26, 4: 33}, 4),
    (20640, 1000, {2: 66}, 2), (1000, 5, {8: 1, 7: 2, 6: 5}, 6)])
def test_svr_step_plan_picks_clusters_the_card_holds(n, rows, held, want):
    """S2's SVR plan picks C from n (a share of at least 128 pairs, at
    most 16 CTAs), then the most CTAs down to the fewest the row fits for
    which the card holds every row's cluster at once (`clusters`, the
    card's count: cudaOccupancyMaxActiveClusters), else the fewest."""
    clusters = None if held is None else (lambda C: held.get(C, 0))
    plan = svk.svr_step_plan(n, rows, clusters=clusters)
    assert plan["cluster"] == want
