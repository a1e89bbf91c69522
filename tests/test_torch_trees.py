"""The port's tree ensembles against the JAX package's, on the CPU:
binning, the lane-batched histogram grower and `predict_tree`, the four
families' searches, the n_estimators group, the depth warning and
`tree_from_jax`.

Tolerances, each measured against the JAX package on these inputs:
- binning: edges and codes equal;
- the grower on integer (forest-style) stats: identical feat, thresh
  and is_leaf, leaf values atol 1e-6 (measured: equal); on continuous
  (boosting-style) stats, on a seed with no near-tied split, the same
  structure and values rtol 1e-5.  The plain T2 adds its cumulative
  sums in the order XLA's CPU backend does (`cumsum_bins`, held bitwise
  here), so ties between features that induce one partition break as
  the reference breaks them;
- searches (subsets of diabetes and digits, <= 300 rows, 2 candidates,
  cv=3): mean_test_score atol 1e-5 for the forests (sums of integer
  stats are exact) and 1e-4 for boosting (measured <= 4e-8), and equal
  best_params_.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingClassifier as SkGBC
from sklearn.ensemble import GradientBoostingRegressor as SkGBR
from sklearn.ensemble import RandomForestClassifier as SkRFC
from sklearn.ensemble import RandomForestRegressor as SkRFR

import spark_sklearn_tpu as sst
import spark_sklearn_tpu_torch as port
from spark_sklearn_tpu.models import trees as jmodels
from spark_sklearn_tpu.ops import trees as jt
from spark_sklearn_tpu.utils import native
from spark_sklearn_tpu_torch.convert.params import tree_from_jax
from spark_sklearn_tpu_torch.models import trees as pmodels
from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.ops import random as jr
from spark_sklearn_tpu_torch.ops import tree_kernels as tk
from spark_sklearn_tpu_torch.ops import trees as pt
from spark_sklearn_tpu_torch.parallel.taskgrid import build_compile_groups
from spark_sklearn_tpu_torch.utils.binning import quantile_bin

CPU = port.TorchConfig(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small eager torch ops run faster on one thread than on many
    contending ones; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(codes):
    return torch.as_tensor(np.ascontiguousarray(codes, np.uint8))


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def _binning_inputs(which, digits, diabetes):
    if which == "digits":
        return digits[0][:300]
    if which == "diabetes":
        return diabetes[0]
    rng = np.random.default_rng(0)      # few distinct values: tied edges
    return rng.integers(0, 5, (200, 3)).astype(np.float32)


@pytest.mark.parametrize("which", ["digits", "diabetes", "ties"])
def test_binning_matches_reference(which, digits, diabetes):
    X = _binning_inputs(which, digits, diabetes)
    assert native._load() is None      # the reference's numpy path
    e_ref, c_ref = native.quantile_bin(X, 256)
    e, c = quantile_bin(X, 256)
    np.testing.assert_array_equal(e, e_ref)
    np.testing.assert_array_equal(c, c_ref)
    assert e.dtype == np.float32 and c.dtype == np.uint8
    _, codes_ref = jmodels._prep_codes(X, np.float32)
    _, codes = pmodels._prep_codes(X, np.float32)
    assert codes.dtype == np.int32
    np.testing.assert_array_equal(codes, codes_ref)
    with pytest.raises(ValueError):
        quantile_bin(X, 257)


# ---------------------------------------------------------------------------
# the grower and predict_tree
# ---------------------------------------------------------------------------

def _reference_trees(codes, g, h, w, depth, nb, mcw, lam, key, mf, n_out):
    """The JAX grower vmapped over lanes, with one static key."""
    def one(g_l, h_l, w_l):
        return jt.grow_tree(jnp.asarray(codes), g_l, h_l, w_l, depth, nb,
                            mcw, lam, feat_mask_key=key, max_features=mf,
                            n_out=n_out)
    return jax.jit(jax.vmap(one))(jnp.asarray(g), jnp.asarray(h),
                                  jnp.asarray(w))


def _grower_case(kind):
    rng = np.random.default_rng(5 if kind == "forest" else 3)
    n, d, depth, nb, L = 400, 6, 4, 256, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    codes = quantile_bin(X, nb)[1]
    if kind == "forest":
        # integer stats: Poisson counts x a fold mask, one-hot targets
        k = 3
        t = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
        g = np.broadcast_to(-t, (L, n, k)).copy()
        h = np.ones((L, n), np.float32)
        w = (rng.poisson(1.0, (L, n))
             * (rng.random((L, n)) < 0.7)).astype(np.float32)
        return dict(codes=codes, g=g, h=h, w=w, depth=depth, nb=nb,
                    mcw=1.0, lam=1e-9, seed=3, mf=3, n_out=k)
    # continuous stats: gradients, softmax-like hessians, a fold mask
    g = rng.standard_normal((L, n, 1)).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (L, n)).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    w = (rng.random((L, n)) < 0.7).astype(np.float32)
    return dict(codes=codes, g=g, h=h, w=w, depth=depth, nb=nb, mcw=1.0,
                lam=1e-6, seed=None, mf=None, n_out=1)


@pytest.mark.parametrize("kind", ["forest", "boosting"])
def test_grow_and_predict_match_reference(kind):
    c = _grower_case(kind)
    key_j = key_p = None
    if c["seed"] is not None:
        key_j = jax.random.fold_in(jax.random.PRNGKey(c["seed"]), 7)
        key_p = jr.fold_in(jr.PRNGKey(c["seed"]), 7)
    ref = _reference_trees(c["codes"].astype(np.int32), c["g"], c["h"],
                           c["w"], c["depth"], c["nb"], c["mcw"], c["lam"],
                           key_j, c["mf"], c["n_out"])
    codes = _u8(c["codes"])
    got, node = pt.grow_tree(codes, torch.as_tensor(c["g"]),
                             torch.as_tensor(c["h"]),
                             torch.as_tensor(c["w"]), c["depth"], c["nb"],
                             c["mcw"], c["lam"], feat_mask_key=key_p,
                             max_features=c["mf"], n_out=c["n_out"])
    np.testing.assert_array_equal(got.feat.numpy(), np.asarray(ref.feat))
    np.testing.assert_array_equal(got.thresh.numpy(), np.asarray(ref.thresh))
    np.testing.assert_array_equal(got.is_leaf.numpy(),
                                  np.asarray(ref.is_leaf))
    assert (got.feat >= 0).sum() > 10          # real trees, not stumps
    if kind == "forest":
        np.testing.assert_allclose(got.value.numpy(), np.asarray(ref.value),
                                   rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.value.numpy(), np.asarray(ref.value),
                                   rtol=1e-5, atol=1e-7)
    want = jax.vmap(lambda tr: jt.predict_tree(
        tr, jnp.asarray(c["codes"].astype(np.int32)), c["depth"]))(ref)
    pred = pt.predict_tree(got, codes, c["depth"])
    np.testing.assert_allclose(pred.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the families' update: out + scale * prediction, in place
    out = torch.ones_like(pred)
    scale = torch.tensor([0.5, 0.0, 2.0])
    pt.accumulate_tree(got, codes, c["depth"], out, scale)
    np.testing.assert_allclose(out.numpy(), 1.0 + scale.numpy()[:, None,
                                                                None]
                               * pred.numpy(), rtol=1e-6, atol=1e-6)
    # the fit's update from the grower's final nodes: the walk's bits
    from_nodes = torch.ones_like(pred)
    pt.accumulate_leaves(got, node, from_nodes, scale)
    assert torch.equal(from_nodes, out)


def test_grow_tree_in_lane_passes_gives_the_same_trees():
    c = _grower_case("forest")
    args = (_u8(c["codes"]), torch.as_tensor(c["g"]), torch.as_tensor(
        c["h"]), torch.as_tensor(c["w"]), c["depth"], c["nb"], c["mcw"],
            c["lam"])
    key = jr.fold_in(jr.PRNGKey(1), 7)
    one, node = pt.grow_tree(*args, feat_mask_key=key, max_features=2,
                             n_out=3)
    per_lane = pt.hist_bytes(c["depth"], c["codes"].shape[1], c["nb"], 4)
    passes, node_p = pt.grow_tree(*args, feat_mask_key=key, max_features=2,
                                  n_out=3, max_hist_bytes=per_lane)
    for a, b in zip(one, passes):
        assert torch.equal(a, b)
    assert torch.equal(node, node_p)


def _old_level(codes, node, frozen, active, bf, bb, split, feat, thresh,
               is_leaf, last):
    """One level of the grower as it was before the fused level step:
    the heap writes and the routing of `_grow` with a frozen flag carried
    from level to level, then the next level's keys (or T4's at the last
    level, with the final is_leaf scatter).  Returns the keys."""
    N = split.shape[1]
    offset = N - 1
    sf = torch.where(split, bf, -1)
    feat[:, offset:offset + N] = sf
    thresh[:, offset:offset + N] = bb
    is_leaf[:, offset:offset + N] = ~split
    j = (node - offset).clamp_min(0).long()
    f = torch.gather(sf, 1, j)
    b = torch.gather(bb, 1, j)
    code_at = codes.long().T.gather(0, f.clamp_min(0).long())
    go = (~frozen) & (f >= 0)
    node.copy_(torch.where(go, 2 * node + 1 + (code_at > b).to(node.dtype),
                           node))
    frozen |= (~frozen) & (f < 0)
    if last:
        is_leaf.scatter_(1, node.long(), True)
        return torch.where(active, node, -1)
    return torch.where(frozen | ~active, -1, node - (2 * N - 1))


def _level_state(rng, L, n, d, depth, level):
    """A level's state as the grower leaves it: frozen rows at shallower
    nodes, the others at the level's nodes; inactive rows; splits with
    non-splitting nodes; a heap of random contents."""
    N = 2 ** level
    offset = N - 1
    M = 2 ** (depth + 1) - 1
    frozen = (rng.random((L, n)) < 0.3) & (level > 0)
    node = np.where(frozen, rng.integers(0, max(offset, 1), (L, n)),
                    rng.integers(offset, offset + N, (L, n)))
    split = rng.random((L, N)) < 0.7
    split[0, 0], split[-1, -1] = True, False     # both kinds at the root
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a).astype(dt))
    return dict(
        codes=t(rng.integers(0, 256, (n, d)), np.uint8),
        node=t(node, np.int32), frozen=t(frozen, bool),
        active=t(rng.random((L, n)) < 0.8, bool),
        bf=t(rng.integers(0, d, (L, N)), np.int32),
        bb=t(rng.integers(0, 256, (L, N)), np.int32),
        split=t(split, bool),
        feat=t(rng.integers(-1, d, (L, M)), np.int32),
        thresh=t(rng.integers(0, 256, (L, M)), np.int32),
        is_leaf=t(rng.random((L, M)) < 0.3, bool))


@pytest.mark.parametrize("level", [0, 2, 4])
def test_level_step_plain_matches_the_old_level(level):
    """The fused level step's plain version against the grower's old
    sequence, at the first, a middle and the last level of a depth-5
    tree: the same nodes, keys and heap, on levels with non-splitting
    nodes, frozen rows and inactive rows."""
    depth = 5
    st = _level_state(np.random.default_rng(level), 3, 500, 7, depth, level)
    last = level == depth - 1
    old = {k: v.clone() for k, v in st.items()}
    want = _old_level(old["codes"], old["node"], old["frozen"],
                      old["active"], old["bf"], old["bb"], old["split"],
                      old["feat"], old["thresh"], old["is_leaf"], last)
    local = torch.full_like(st["node"], 7)
    tk.level_step(st["codes"], st["node"], st["active"], st["bf"], st["bb"],
                  st["split"], st["feat"], st["thresh"], st["is_leaf"],
                  local, last)
    assert torch.equal(local, want)
    for k in ("node", "feat", "thresh", "is_leaf"):
        assert torch.equal(st[k], old[k]), k
    assert (local >= 0).any() and (local < 0).any()


@pytest.mark.parametrize("kind", ["forest", "boosting"])
@pytest.mark.parametrize("passes", [False, True])
def test_grown_nodes_give_the_walks_update(kind, passes):
    """`grow_tree`'s final nodes are the walk's leaves: the families'
    update from them (`accumulate_leaves`) equals the walk's
    (`accumulate_tree`) bit for bit, with feature masks and rows of
    weight 0, grown in one pass or a pass a lane."""
    c = _grower_case(kind)
    codes = _u8(c["codes"])
    key = jr.fold_in(jr.PRNGKey(2), 7) if kind == "forest" else None
    per_lane = pt.hist_bytes(c["depth"], c["codes"].shape[1], c["nb"],
                             1 + c["n_out"])
    tree, node = pt.grow_tree(
        codes, torch.as_tensor(c["g"]), torch.as_tensor(c["h"]),
        torch.as_tensor(c["w"]), c["depth"], c["nb"], c["mcw"], c["lam"],
        feat_mask_key=key, max_features=c["mf"], n_out=c["n_out"],
        max_hist_bytes=per_lane if passes else pt.MAX_HIST_BYTES)
    assert (c["w"] == 0).any()
    assert bool(torch.gather(tree.is_leaf, 1, node.long()).all())
    scale = torch.tensor([0.1, 0.0, 3.0])
    base = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, codes.shape[0], c["n_out"])).astype(np.float32))
    walked, grown = base.clone(), base.clone()
    pt.accumulate_tree(tree, codes, c["depth"], walked, scale)
    pt.accumulate_leaves(tree, node, grown, scale)
    assert torch.equal(grown, walked)


# (n, d, L, N, M, last, walk): phase 10's forest at its deepest levels and
# its walk, phase 9's boosting (60 lanes), d too wide to stage
ROW_PLAN_SHAPES = [(100000, 54, 6, 256, 2047, False, False),
                   (100000, 54, 6, 512, 2047, True, False),
                   (20640, 8, 60, 16, 63, True, False),
                   (100000, 54, 6, 0, 2047, False, True),
                   (20640, 8, 60, 0, 63, False, True),
                   (3000, 784, 4, 8, 31, True, False),
                   (5, 3, 1, 1, 3, True, False)]


@pytest.mark.parametrize("n,d,L,N,M,last,walk", ROW_PLAN_SHAPES)
def test_row_plan_fits_a_block_and_covers_every_lane(n, d, L, N, M, last,
                                                     walk):
    per_lane = 4 * M if walk else 4 * N + (M if last else 0)
    budget = tk.WALK_SMEM if walk else tk.STEP_SMEM
    plan = tk.row_plan(n, d, L, per_lane, budget, 132)
    tiles = -(-n // tk.ROW_THREADS)
    assert plan["stage"] == (d <= 96)
    tile = -(-tk.ROW_THREADS * d // 16) * 16 if plan["stage"] else 0
    assert plan["smem"] == tile + plan["lg"] * per_lane <= budget
    assert plan["groups"] * plan["lg"] >= L > (plan["groups"] - 1) * plan[
        "lg"]
    assert 1 <= plan["grid_x"] <= tiles
    if L == 60:                   # few tiles: the lanes spread out
        assert plan["groups"] > 1


@pytest.mark.parametrize("length", [5, 16, 17, 100, 256])
def test_plain_cumsum_adds_in_xla_cpu_order(length):
    x = (np.random.default_rng(length).standard_normal((3, 7, length))
         * 100).astype(np.float32)
    np.testing.assert_array_equal(
        tk.cumsum_bins(torch.as_tensor(x)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=2)))


def test_segments_group_rows_by_node_in_row_order():
    local = torch.tensor([[1, -1, 0, 1, 0, 2],
                          [2, 2, -1, -1, 0, 1]], dtype=torch.int32)
    perm, offs = tk.segments(local, 3)
    width = 4
    for lane in range(2):
        for node in range(3):
            lo, hi = offs[lane * width + node], offs[lane * width + node + 1]
            rows = (perm[lo:hi] - lane * 6).tolist()
            assert rows == [i for i in range(6)
                            if int(local[lane, i]) == node]
    assert int(offs[-1]) == 12


def test_hist_plan_stays_inside_a_block():
    # covtype-shaped forest (d=54, 7 classes), a boosting lane (d=8),
    # digits-shaped forest (d=64, 10 classes)
    for d, S, L, nodes in ((54, 8, 6, 1), (54, 8, 6, 512), (8, 2, 60, 1),
                           (64, 11, 6, 16)):
        plan = tk.hist_plan(d, S, 256, L, nodes, 132)
        assert plan["threads"] <= 1024
        assert plan["threads"] == 32 * plan["warps"] + tk.HIST_LOADERS
        assert plan["smem"] <= tk.MAX_SMEM
        assert plan["grid"] == (L * nodes, -(-d // plan["ft"]))
    # few nodes: one feature a block; many: the tiles the budget holds
    assert tk.hist_plan(54, 8, 256, 6, 1, 132)["ft"] == 1
    assert tk.hist_plan(54, 8, 256, 6, 512, 132)["ft"] == (
        tk.HIST_SMEM_BYTES // (256 * 8 * 4))
    with pytest.raises(ValueError):
        tk.hist_plan(4, 300, 256, 1, 1, 132)


# (d, S, n_bins, L, n_nodes): phase 10's forest at the root and depth 9,
# phase 9's boosting at the root and depth 4, a 10-class forest (S = 11),
# S = 3 (padded to 4), few bins, one lane of many nodes
HIST_PLAN_SHAPES = [(54, 8, 256, 6, 1), (54, 8, 256, 6, 512),
                    (8, 2, 256, 60, 1), (8, 2, 256, 60, 16),
                    (64, 11, 256, 6, 16), (64, 11, 256, 6, 1),
                    (5, 3, 32, 2, 4), (54, 8, 256, 1, 1024)]


@pytest.mark.parametrize("d,S,n_bins,L,nodes", HIST_PLAN_SHAPES)
def test_hist_plan_covers_every_feature_stat_and_node(d, S, n_bins, L,
                                                      nodes):
    plan = tk.hist_plan(d, S, n_bins, L, nodes, 132)
    ft, vw, sp, warps = plan["ft"], plan["vw"], plan["sp"], plan["warps"]
    # stats padded to the vector width, the columns shared out over the
    # warps, the threads and shared memory inside an H100 block
    assert vw == (2 if S <= 2 else 4) and sp % vw == 0 and S <= sp < S + vw
    assert warps == min(tk.HIST_WARPS, ft)
    assert plan["threads"] == 32 * warps + tk.HIST_LOADERS <= 1024
    # the histogram tiles, each stage's rows (stats, the code words
    # holding ft codes), a tile of codes a column warp
    words = (ft + 2) // 4 + 1
    assert 4 * words >= ft + 3
    assert plan["smem"] == tk.hist_smem(ft, n_bins, sp, warps) >= (
        ft * n_bins * sp * 4
        + tk.HIST_STAGES * tk.ROW_TILE * (4 * sp + 4 * words)
        + warps * tk.ROW_TILE)
    assert plan["smem"] <= tk.MAX_SMEM
    assert ft * n_bins * sp * 4 <= max(tk.HIST_SMEM_BYTES, n_bins * sp * 4)
    # one block a (lane, node) and feature tile; the tiles cover d
    lanes_nodes, tiles = plan["grid"]
    assert lanes_nodes == L * nodes
    assert (tiles - 1) * ft < d <= tiles * ft
    assert tk.ROW_TILE == tk.HIST_LOADERS and tk.ROW_TILE % 32 == 0


@pytest.mark.parametrize("S", [2, 3, 8, 11, 32, 33, 64, 100])
def test_leaf_plan_fits_a_block_and_covers_every_stat(S):
    plan = tk.leaf_plan(S, 6, 2047)
    assert plan["grid"] == 6 * 2047 and plan["threads"] == 32
    assert plan["passes"] * 32 >= S > (plan["passes"] - 1) * 32
    assert plan["smem"] == tk.LEAF_STAGES * min(S, 32) * tk.LEAF_PAD * 4
    assert plan["smem"] <= tk.MAX_SMEM
    # a stat's row of a tile is whole 16-byte loads, one lane a row
    assert tk.LEAF_ROWS % 32 == 0 and tk.LEAF_PAD % 4 == 0
    assert tk.LEAF_PAD >= tk.LEAF_ROWS


@pytest.mark.parametrize("skew", [False, True])
def test_segments_keep_row_order_on_random_and_skewed_keys(skew):
    rng = np.random.default_rng(3)
    L, n, nodes = 4, 500, 16
    if skew:
        local = np.minimum(rng.geometric(0.5, (L, n)) - 1, nodes - 1)
    else:
        local = rng.integers(0, nodes, (L, n))
    local[rng.random((L, n)) < 0.2] = -1
    perm, offs = tk.segments(torch.as_tensor(local.astype(np.int32)), nodes)
    assert perm.dtype == torch.int32 and offs.dtype == torch.int32
    assert offs.shape == (L * (nodes + 1) + 1,)
    for lane in range(L):
        for node in range(nodes):
            lo = int(offs[lane * (nodes + 1) + node])
            hi = int(offs[lane * (nodes + 1) + node + 1])
            assert (perm[lo:hi] - lane * n).tolist() == np.flatnonzero(
                local[lane] == node).tolist()


def _segments_as_planned(local, n_nodes, plan):
    """The card's grouping step by step in numpy, as `segment_rows` runs
    it under `plan`: block c of a lane takes rows [c·rows, (c+1)·rows),
    its warp w the run [w·run, (w+1)·run) of them; each run's counts of a
    key become where its first row of the key goes, in (block, warp)
    order after the lane's rows of the smaller keys; each run scatters
    its rows in row order.  Returns (perm, offs, the runs of each lane)."""
    L, n = local.shape
    width = n_nodes + 1
    key = np.where((local >= 0) & (local < n_nodes), local, n_nodes)
    warps = plan["threads"] // 32
    C, rows, run = plan["cluster"], plan["rows"], plan["run"]
    runs = []
    for c in range(C):
        r0 = c * rows
        here = max(0, min(n - r0, rows))
        for w in range(warps):
            a, b = w * run, min(here, w * run + run)
            runs.append((r0 + a, r0 + max(a, b)))
    perm = np.full(L * n, -1, np.int64)
    offs = np.zeros(L * width + 1, np.int64)
    for lane in range(L):
        counts = np.stack([np.bincount(key[lane, lo:hi], minlength=width)
                           for lo, hi in runs])
        total = counts.sum(axis=0)
        start = lane * n + np.cumsum(total) - total
        offs[lane * width:(lane + 1) * width] = start
        place = start + np.cumsum(counts, axis=0) - counts
        for q, (lo, hi) in enumerate(runs):
            ks = key[lane, lo:hi]
            order = np.argsort(ks, kind="stable")
            sk = ks[order]
            rank = np.arange(sk.size) - np.searchsorted(sk, sk)
            perm[place[q, sk] + rank] = lane * n + lo + order
    offs[-1] = L * n
    return perm, offs, runs


@pytest.mark.parametrize("n_nodes", [1, 2, 16, 63, 512, 767, 768, 2047,
                                     10239])
def test_segments_plan_covers_every_row_once_within_a_block(n_nodes):
    """G's plan over the grower's shapes (1 to 2047 nodes, and up to
    10239; 1 to 581012 rows; 1 to 60 lanes): every row of a lane is in
    exactly one warp's run of one block, a cluster is at most 8 blocks,
    a block at most 512 threads and its shared memory within a block's
    most, with the ids staged exactly where they fit; on the smaller
    shapes the kernel's steps under the plan (in numpy) give
    `segments_plain`'s perm and offs."""
    width = n_nodes + 1
    rng = np.random.default_rng(n_nodes)
    for n in (1, 31, 700, 2049, 20640, 100000, 581012):
        for L in (1, 6, 60):
            plan = tk.segments_plan(L, n, n_nodes, 132)
            C, rows, run = plan["cluster"], plan["rows"], plan["run"]
            warps = plan["threads"] // 32
            assert 1 <= C <= tk.SEG_MAX_CLUSTER == 8
            assert 32 <= plan["threads"] <= tk.SEG_MAX_THREADS == 512
            assert plan["threads"] % 32 == 0 and run % 32 == 0
            assert rows == run * warps and (C - 1) * rows < n <= C * rows
            assert plan["grid"] == L * C
            staged = tk.seg_smem(width, warps, rows)
            assert plan["stage"] == (staged <= tk.SEG_MAX_SMEM)
            assert plan["smem"] == (staged if plan["stage"] else
                                    tk.seg_smem(width, warps, 0))
            assert plan["smem"] <= tk.SEG_MAX_SMEM < tk.MAX_SMEM
            if L * n > 130000 or L > 6:
                continue
            local = rng.integers(-1, n_nodes, (L, n)).astype(np.int32)
            perm, offs, runs = _segments_as_planned(local, n_nodes, plan)
            covered = np.concatenate([np.arange(lo, hi) for lo, hi in runs])
            assert covered.tolist() == list(range(n))
            want = tk.segments_plain(torch.as_tensor(local), n_nodes)
            assert perm.tolist() == want[0].tolist()
            assert offs.tolist() == want[1].tolist()


def test_segments_plan_refuses_what_no_block_holds():
    """One warp's counts and the block's three arrays of n_nodes + 1
    must fit a block (up to 14463 nodes); L·n and L·(n_nodes + 1) stay
    int32."""
    assert tk.segments_plan(1, 1000, 14463, 132)["threads"] == 32
    with pytest.raises(ValueError):
        tk.segments_plan(1, 1000, 14464, 132)
    with pytest.raises(ValueError):
        tk.segments_plan(2 ** 12, 2 ** 19, 1, 132)


def test_grouped_kernel_entry_points_run_on_the_card_only():
    c = _grower_case("boosting")
    codes = _u8(c["codes"])
    n = codes.shape[0]
    local = torch.zeros((1, n), dtype=torch.int32)
    stats = torch.ones((1, n, 2))
    perm, offs = tk.segments(local, 1)
    with pytest.raises(ValueError):
        tk.level_histogram_grouped(codes, perm, offs, stats, 1)
    with pytest.raises(ValueError):
        tk.leaf_values_grouped(perm, offs, stats, 1, 1.0)


def test_tree_from_jax_predicts_as_the_reference():
    c = _grower_case("boosting")
    codes = c["codes"].astype(np.int32)
    ref = jax.jit(jt.grow_tree, static_argnums=(4, 5))(
        jnp.asarray(codes), jnp.asarray(c["g"][0]), jnp.asarray(c["h"][0]),
        jnp.asarray(c["w"][0]), 3, c["nb"], 1.0, 1e-6)
    tree = tree_from_jax(ref, device="cpu")
    assert tree.feat.shape == (1, 15) and tree.feat.dtype == torch.int32
    assert tree.is_leaf.dtype == torch.bool
    np.testing.assert_array_equal(
        pt.predict_tree(tree, _u8(c["codes"]), 3)[0].numpy(),
        np.asarray(jt.predict_tree(ref, jnp.asarray(codes), 3)))
    stacked = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), ref)
    assert tree_from_jax(stacked, device="cpu").value.shape == (2, 15, 1)


# ---------------------------------------------------------------------------
# the families' searches against the JAX package's
# ---------------------------------------------------------------------------

def _four_classes(digits, n=200):
    X, y = digits
    m = y < 4
    return X[m][:n], y[m][:n]


def _search_case(label, digits, diabetes):
    Xr, yr = diabetes[0][:300], diabetes[1][:300]
    if label == "gb_regressor":
        return (SkGBR(max_depth=3, learning_rate=0.2, random_state=0),
                {"n_estimators": [5, 10], "subsample": [0.8]}, Xr, yr, 1e-4)
    if label == "gb_classifier":
        return (SkGBC(n_estimators=5, max_depth=2, random_state=0),
                {"learning_rate": [0.1, 0.3]}, *_four_classes(digits, 300),
                1e-4)
    if label == "rf_classifier":
        return (SkRFC(max_depth=3, random_state=0),
                {"n_estimators": [4, 6]}, *_four_classes(digits), 1e-5)
    return (SkRFR(max_depth=4, random_state=0), {"n_estimators": [5, 8]},
            Xr, yr, 1e-5)


@pytest.mark.parametrize("label", ["gb_regressor", "gb_classifier",
                                   "rf_classifier", "rf_regressor"])
def test_search_matches_the_jax_package(label, digits, diabetes):
    est, grid, X, y, atol = _search_case(label, digits, diabetes)
    ref = sst.GridSearchCV(est, grid, cv=3, backend="tpu",
                           refit=False).fit(X, y)
    got = port.GridSearchCV(est, grid, cv=3, refit=False,
                            config=CPU).fit(X, y)
    np.testing.assert_allclose(got.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"], rtol=0,
                               atol=atol)
    assert got.best_params_ == ref.best_params_
    # one group for every n_estimators value; a chunk grows its lanes'
    # largest count
    n_est = grid.get("n_estimators", [est.get_params()["n_estimators"]])
    assert len(got.chunks_) == 1
    assert got.chunks_[0]["n_iter_exec"] == max(n_est)


def test_n_estimators_is_one_compile_group():
    fam = resolve_family(SkGBR())
    cands = [{"n_estimators": v} for v in (10, 50, 100)]
    assert len(build_compile_groups(cands, list(fam.dynamic_params),
                                    fam.dynamic_params)) == 1
    meta = {}
    fam.observe_candidates(cands, {"n_estimators": 7}, meta)
    assert meta["max_estimators"] == 100
    # the base value counts only where no candidate overrides it
    fam.observe_candidates([{"learning_rate": 0.1}], {"n_estimators": 7},
                           meta)
    assert meta["max_estimators"] == 7


def test_depth_warning_once_a_search(digits):
    X, y = _four_classes(digits, 60)
    X = X[:, 20:23]          # three features keep the depth-10 fit small
    with pytest.warns(UserWarning, match="exceed") as rec:
        port.GridSearchCV(SkRFC(n_estimators=2, random_state=0),
                          {"max_depth": [None, 12]}, cv=2, refit=False,
                          config=CPU).fit(X, y)
    assert sum("exceed" in str(r.message) for r in rec) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.GridSearchCV(SkRFC(n_estimators=2, random_state=0),
                          {"max_depth": [2, 3]}, cv=2, refit=False,
                          config=CPU).fit(X, y)


@pytest.mark.parametrize("mf", ["sqrt", "log2", None, 0.5, 1.0, 1, 3])
def test_max_features_rules_match_reference(mf):
    for ours, ref in ((pmodels.RandomForestClassifierFamily,
                       jmodels.RandomForestClassifierFamily),
                      (pmodels.RandomForestRegressorFamily,
                       jmodels.RandomForestRegressorFamily)):
        assert ours._max_features({"max_features": mf}, 54) == \
            ref._max_features({"max_features": mf}, 54)
    assert pmodels.RandomForestRegressorFamily._max_features(
        {"max_features": 1}, 8) == 1
    assert pmodels.RandomForestRegressorFamily._max_features(
        {"max_features": 1.0}, 8) == 8


def test_port_parameter_holders_resolve_and_refuse_to_refit(diabetes):
    pairs = ((port.GradientBoostingRegressor, SkGBR),
             (port.GradientBoostingClassifier, SkGBC),
             (port.RandomForestClassifier, SkRFC),
             (port.RandomForestRegressor, SkRFR))
    for ours, theirs in pairs:
        assert resolve_family(ours()) is resolve_family(theirs())
        sk_params = theirs().get_params()
        for name, value in ours().get_params().items():
            if name != "device":
                assert sk_params[name] == value, (ours, name)
    X, y = diabetes[0][:90], diabetes[1][:90]
    gs = port.GridSearchCV(port.GradientBoostingRegressor(n_estimators=3),
                           {"max_depth": [2]}, cv=3, refit=False,
                           config=CPU).fit(X, y)
    assert np.isfinite(gs.cv_results_["mean_test_score"]).all()
    with pytest.raises(NotImplementedError, match="refit"):
        port.GradientBoostingRegressor().fit(X, y)
