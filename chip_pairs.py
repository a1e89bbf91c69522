"""Compare two trees' `chip_smoke.py` on one card: run A, B, B, A.

Each tree's `chip_smoke.py` runs from its own directory, in the order
parent, change, change, parent, so that drift of the card or of the
host over the call falls on both trees alike.  Each run's
`chiprun_out/chip_smoke.json` and its output are kept under
`chiprun_out/pairs/` of the working directory as `run<i>_<label>.json`
and `.log`; the script then prints each phase's warm search wall (s) of
the four runs, the parent's spread (its two runs' max - min) and the
change's mean minus the parent's, and marks a phase "outside" where
that difference is larger than the parent's spread; then, for the tree
searches, each run's device busy time and cuda-against-cpu max |d
mean_test_score|; then the SVM searches' busy time (phase 8's SVC,
phase 13's profiled searches); then phase 3's kernel rows (ms between
events, each kernel by shape and variant) with the change's mean over
the parent's;
then SP1 (at phase 16's four shapes, warm and with L2 flushed), G, T2,
S2 (and its SVR mode), T3, M1, M2, M3, S1, N1, C1, B1 and P1
alone and `grow_tree` at
the tree searches' chunks (`ALONE_ROWS`, again parent, change, change,
parent): each
tree's wrappers replayed in a CUDA graph, their host time a call, the
grower's launches and host time a level, whether each row's outputs
have the same bits in the four runs, and how many of C1's assignments
and of B1's argmax classes differ between the trees.

    python3 chip_pairs.py --parent .scratch/parent --change .
    python3 chip_pairs.py --parent .scratch/parent --change . --sp1-alone

With `--sp1-alone` it runs SP1's rows alone (parent, change, change,
parent), no `chip_smoke.py`.

It exits non-zero if a run fails.  A phase that only the change has is
printed with the change's runs alone.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

OUT = os.path.join("chiprun_out", "pairs")


def warm_walls(d: dict) -> dict:
    """{phase: warm wall (s)} from one run's chip_smoke.json."""
    w = {"[4] headline": d["main"]["warm_s"]}
    for name, r in d["regressors"].items():
        w[f"[6] {name}"] = r.get("warm_s")
    w["[7] l1"] = d["l1"]["l1"]["warm_s"]
    w["[7] elasticnet"] = d["l1"]["elasticnet"]["warm_s"]
    w["[8] svc"] = d["svm"]["svc"]["warm_s"]
    w["[8] nusvc (one run)"] = d["svm"]["nusvc"]["wall_s"]
    w["[9] gb_regressor"] = d["gb"]["regressor"]["warm_s"]
    w["[9] gb_classifier"] = d["gb"]["classifier"]["warm_s"]
    w["[10] rf_classifier"] = d["rf"]["classifier"]["warm_s"]
    w["[10] rf_regressor"] = d["rf"]["regressor"]["warm_s"]
    if "mlp" in d:
        w["[11] baseline5"] = d["mlp"]["classifier"]["warm_s"]
    for name, r in d.get("slice", {}).items():
        w[f"[12] {name}"] = r["warm_s"]
    for name, r in d.get("rest", {}).items():
        w[f"[13] {name}"] = r["warm_s"]
    w["total (whole script)"] = d["main"]["wall_s"]
    return w


TREE_SEARCHES = [("gb", "regressor"), ("gb", "classifier"),
                 ("rf", "classifier"), ("rf", "regressor")]


def tree_rows(d: dict) -> dict:
    """{search: (device busy s, cuda-against-cpu max |d score|)}."""
    return {f"[{9 if ph == 'gb' else 10}] {ph}_{kind}": (
        d[ph][kind]["device_busy_s"], d[ph][kind]["check"]["max_abs"])
        for ph, kind in TREE_SEARCHES}


def svm_busy(d: dict) -> dict:
    """{search: device busy s} of phase 8's SVC search and phase 13's
    profiled searches (None where a run has no such search)."""
    rows = {"[8] svc": d["svm"]["svc"].get("device_busy_s")}
    for name, r in d.get("rest", {}).items():
        if r.get("device_busy_s") is not None:
            rows[f"[13] {name}"] = r["device_busy_s"]
    return rows


def kernel_rows(d: dict) -> dict:
    """{kernel and shape: ms} of phase 3's rows in the `kernels` list: each
    kernel's headline row, its rows by shape and its variants, each timed
    between CUDA events around its wrapper's calls (`events_ms` where a
    row also has a CUDA graph's time as `ms`), as every tree times it."""
    rows = {}
    for k in d["kernels"]:
        shape = k.get("shape") or {}
        label = shape if isinstance(shape, str) else (
            shape.get("mode") or shape.get("kind") or "")
        subs = [(label, k)]
        subs += list((k.get("by_shape") or {}).items())
        subs += list((k.get("phase3_inputs") or {}).items())
        subs += [(v, k[v]) for v in ("nu", "nu_pairs", "poly",
                                     "svc_pipeline", "rbf_predict",
                                     "shared", "global", "svr_c8", "nu_c8",
                                     "staged_full", "lr_backward",
                                     "nb_class_sums", "nb_jll")
                 if isinstance(k.get(v), dict)]
        for sub, r in subs:
            if isinstance(r, dict) and "ms" in r:
                rows[f"{k['name']} {sub}".strip()] = r.get("events_ms",
                                                           r["ms"])
    return rows


# Kernels alone, in `tree`'s directory (its own package) on inputs that
# the change's chip_smoke.py makes (the same in every run): each row's
# launches replayed in a CUDA graph (the host's time a call is not in
# it), its host time a call (a loop of calls, too short to fill the
# launch queue, on the host's clock), and a digest of its outputs, so
# that the two trees' bits can be compared.  At the roots and on short
# rows the wrappers take longer on the host than the kernels on the card,
# so timed between events they measure the host.
# - T2 at phase 9's and 10's roots and deepest levels; S2 on phase 3's
#   rows (`svm_step_inputs`), phase 8's own structure (`svm_pair_inputs`)
#   and the scaler + SVC pipeline's (45 pairs of a StratifiedKFold(3)
#   fold, 2000 rows, C=1).
# - T3's level step at phase 9's and 10's roots and last levels, from a
#   copy of the level's nodes (its time taken off); in a tree without the
#   level step, the grower's bookkeeping and routing of a level as that
#   tree ran it (the level's keys, the split features, the heap's three
#   writes, `route`; at the last level the is_leaf scatter and T4's keys).
#   The digest holds node and the heap (and T4's keys at the last level).
# - T3's walk at phase 10's depth 10; the fit's update after a grown tree
#   (`accumulate_leaves` from the grower's nodes, or the walk where a
#   tree has no such entry point), whose bits must match; `grow_tree`
#   alone at each search's chunk (`grower_alone`: launches and host us a
#   level) with a digest of its tree.
# - G at phase 9's and 10's roots, deepest levels and T4's final level.
# - M1 at phase 3's BASELINE #5 and regressor shapes, alone and with
#   the output layer's bias gradient (M1's own `db`, or in a tree whose
#   M1 has none, M1 then `G.sum(dim=1)`); its digest holds wsum and G,
#   whose bits the fold weights' whole numbers keep.
# - S1 (rbf) at phase 8's n=10000 (X X^T), its (2000, 10000) prediction
#   and a 2000-row centred fold (the scaler + SVC pipeline's shape).
# - M3 (relu, forward and backward) at phase 3's BASELINE #5 and
#   regressor shapes, with `threshold_backward` on the backward's inputs;
#   M2 at phase 3's adam, sgd and regressor shapes, on a copy of the
#   state a call.
# - N1 at phase 12's KNN (MNIST-shaped, n=10000) and KNN regressor
#   (California-shaped, n=20640) chunks: 5 folds, max_k 15, the plan the
#   tree's `topk_plan` picks.
# - C1 at phase 12's Lloyd step (covtype-shaped, n=100000, 20 lanes of 8
#   centers), by either signature: where the tree's C1 takes the product
#   XC, its library GEMM X C_allᵀ and C1; where it takes X and the
#   centers, C1 alone.  Its assignments are saved beside the rows
#   (`assign.npy` under the directory the script is given), so that the
#   trees' assignments can be counted apart where their bits differ.
# - B1 at phase 12's GaussianNB views (covtype-shaped, n=100000, d=54,
#   60 lanes, 7 classes, the family's own fit), by either design (the
#   signature did not change); the argmax class of every (lane, row) is
#   saved beside the rows (`jll_pred.npy`) and counted apart between the
#   trees.
# - S2's SVR mode at phase 13's SVR and NuSVR steps (5 folds of n=20640),
#   by the plan each tree picks (a block a row in the parent of the
#   cluster plan); P1 at phase 13's SVC probability search (2025 rows of
#   n=10000), timed between events.
ALONE_ROWS = """
import hashlib
import importlib.util
import inspect
import json
import os
import sys
import time
import numpy as np
import torch
spec = importlib.util.spec_from_file_location(
    "chip_smoke_change", sys.argv[1] + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from spark_sklearn_tpu_torch.ops import mlp_kernels as mk
from spark_sklearn_tpu_torch.ops import svm_kernels as svk
from spark_sklearn_tpu_torch.ops import tree_kernels as tk
from spark_sklearn_tpu_torch.ops import trees as pt
from spark_sklearn_tpu_torch.utils.binning import quantile_bin

FUSED = hasattr(tk, "level_step")
MINUS_ONE = torch.tensor(-1, dtype=torch.int32, device="cuda")


def host_us(fn, calls=100):
    best = float("inf")
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def level_unit(codes, st, active, bf, bb, split, last):
    node, feat, thresh, is_leaf, keys, frozen = st
    if FUSED:
        tk.level_step(codes, node, active, bf, bb, split, feat, thresh,
                      is_leaf, keys, last)
        return
    N = split.shape[1]
    offset = N - 1
    torch.where(frozen | ~active, MINUS_ONE, node - offset)
    sf = torch.where(split, bf, MINUS_ONE)
    feat[:, offset:offset + N] = sf
    thresh[:, offset:offset + N] = bb
    is_leaf[:, offset:offset + N] = ~split
    tk.route(codes, node, frozen, sf, bb, offset)
    if last:
        is_leaf.scatter_(1, node.long(), True)
        keys.copy_(torch.where(active, node, MINUS_ONE))


def tree_of(res):
    return res if hasattr(res, "feat") else res[0]


rows = {}
# SP1 at phase 16's four shapes, by each tree's own launch (the change's
# work plan, built once an operand; the parent builds none)
from spark_sklearn_tpu_torch.ops import spmm_kernels as spk
_, ops = cs.sparse_operands(0)
for variant in cs.SPARSE_MAIN:
    which, over, W = cs.SPARSE_SHAPES[variant]
    op = ops[which]
    n, d = op.shape
    A, K = (((op.t_indptr, op.t_indices, op.t_values), n) if over
            else ((op.indptr, op.indices, op.values), d))
    D = cs.sp1_operand(K, W, variant)
    kw = {}
    if "plan" in inspect.signature(spk.csr_spmm).parameters:
        kw["plan"] = spk.SpmmPlan(A[0])
    fn = lambda: spk.csr_spmm(*A, D, K, **kw)
    rows[f"csr_spmm {variant}"] = {
        "ms": cs.graph_ms(fn, reps=10), "flushed_ms": cs.flushed_ms(fn),
        "host_us": host_us(fn), "bits": digest([fn()])}
del ops, A, D
torch.cuda.empty_cache()
if sys.argv[3:] == ["sp1"]:
    print(json.dumps(rows))
    sys.exit(0)
for label, codes_np, L, depth, kind in (
        ("rf", quantile_bin(cs.covtype_like(0)[0])[1], 6, 10, "forest"),
        ("gb", quantile_bin(cs.california_like(0)[0])[1], 60, 5,
         "boosting")):
    codes = torch.as_tensor(codes_np, device="cuda")
    d = codes.shape[1]
    M = 2 ** (depth + 1) - 1
    for n_nodes in (1, 2 ** (depth - 1)):
        local, stats = cs.tree_level_inputs(codes, L, n_nodes, kind, n_nodes)
        fn = lambda: tk.segments(local, n_nodes)
        rows[f"tree_segments {label}/{n_nodes}"] = {
            "ms": cs.graph_ms(fn), "host_us": host_us(fn),
            "bits": digest(fn())}
        hist = tk.level_histogram(codes, local, stats, n_nodes)
        masks = {"": None}
        if kind == "forest":
            g = torch.Generator(device="cuda").manual_seed(0)
            sc = torch.rand((n_nodes, d), generator=g, device="cuda")
            masks[" masked"] = sc <= torch.sort(sc, dim=1).values[:, 6:7]
        for tag, fm in masks.items():
            fn = lambda: tk.best_splits(hist, fm, 1e-6, 1.0)
            rows[f"tree_best_split {label}/{n_nodes}{tag}"] = {
                "ms": cs.graph_ms(fn), "host_us": host_us(fn),
                "bits": digest(fn())}
        bf, bb, _, split = tk.best_splits(hist, masks[" masked" if kind
                                                     == "forest" else ""],
                                          1e-6, 1.0)
        del hist
        last = n_nodes == 2 ** (depth - 1)
        node0 = (local.clamp_min(0) + (n_nodes - 1)).to(torch.int32)
        active = local >= 0
        st = [node0.clone(),
              torch.full((L, M), -1, dtype=torch.int32, device="cuda"),
              torch.zeros((L, M), dtype=torch.int32, device="cuda"),
              torch.zeros((L, M), dtype=torch.bool, device="cuda"),
              torch.full_like(node0, -7), torch.zeros_like(active)]
        restore = lambda: (st[0].copy_(node0), st[5].zero_())
        stepped = lambda: (restore(), level_unit(codes, st, active, bf, bb,
                                                 split, last))
        stepped()
        bits = digest(st[:4] + ([st[4]] if last else []))
        rows[f"tree_route step {label}/{n_nodes}"] = {
            "ms": cs.graph_ms(stepped) - cs.graph_ms(restore),
            "host_us": host_us(stepped) - host_us(restore), "bits": bits}
    # the walk of random trees of the path's depth (phase 3's)
    local, stats = cs.tree_level_inputs(codes, L, M, kind, 7)
    fn = lambda: tk.segments(local, M)
    rows[f"tree_segments {label}/{M}"] = {
        "ms": cs.graph_ms(fn), "host_us": host_us(fn), "bits": digest(fn())}
    val = tk.leaf_values(local, stats, M, 1e-6)
    g = torch.Generator(device="cuda").manual_seed(9)
    feat = torch.randint(0, d, (L, M), generator=g, device="cuda",
                         dtype=torch.int32)
    thr = torch.randint(0, 256, (L, M), generator=g, device="cuda",
                        dtype=torch.int32)
    leaf = torch.zeros((L, M), dtype=torch.bool, device="cuda")
    leaf[:, M // 2:] = True
    scale = torch.full((L,), 0.1, device="cuda")
    out = torch.zeros((L, codes.shape[0], val.shape[2]), device="cuda")
    fn = lambda: tk.walk(codes, feat, thr, leaf, val, depth, out, scale)
    rows[f"tree_route walk {label}"] = {
        "ms": cs.graph_ms(fn), "host_us": host_us(fn),
        "bits": digest([tk.walk(codes, feat, thr, leaf, val, depth,
                                torch.zeros_like(out), scale)])}
    # a grown tree at the search's chunk, and the fit's update from it
    args, kw = cs.grower_inputs(label, 0)
    grow = lambda: pt.grow_tree(*args, **kw)
    res = grow()
    tree = tree_of(res)
    scale = torch.full((tree.value.shape[0],), 0.1, device="cuda")
    out = torch.zeros((tree.value.shape[0], codes.shape[0],
                       tree.value.shape[2]), device="cuda")
    if FUSED:
        update = lambda o: pt.accumulate_leaves(tree, res[1], o, scale)
    else:
        update = lambda o: pt.accumulate_tree(tree, codes, depth, o, scale)
    fn = lambda: update(out)
    rows[f"tree_route update {label}"] = {
        "ms": cs.graph_ms(fn), "host_us": host_us(fn),
        "bits": digest([update(torch.zeros_like(out))])}
    per_level = cs.grower_alone(label, 0)
    rows[f"grow_tree {label}"] = {
        "ms": cs.cuda_ms(grow, reps=5, warmup=1),
        "host_us": host_us(grow, calls=3), "bits": digest(tree),
        **per_level}
for path, shape in (("baseline5", {}),
                    ("regressor", dict(B=6, k=1, d=cs.D_REG,
                                       alphas=cs.MLP_REG_ALPHAS))):
    t = cs.mlp_step_inputs(0, **shape)
    H = mk.mlp_act_forward_plain(t["A"], t["b"], "relu")
    for part, fn in (
            ("forward", lambda: mk.mlp_act_forward(t["A"], t["b"], "relu")),
            ("backward", lambda: mk.mlp_act_backward(t["dH"], H, "relu")),
            ("threshold_backward", lambda: torch.ops.aten.threshold_backward(
                t["dH"], H, 0.0))):
        rows[f"mlp_act {part} {path}"] = {
            "ms": cs.graph_ms(fn), "host_us": host_us(fn),
            "bits": digest([fn()])}
for path, shape, adam in (("adam", {}, True), ("sgd", {}, False),
                          ("regressor", dict(B=6, k=1, d=cs.D_REG,
                                             alphas=cs.MLP_REG_ALPHAS),
                           True)):
    t = cs.mlp_step_inputs(0, **shape)
    fn = cs.state_in_place(t, mk.mlp_opt_step, adam)
    names = ("p", "m", "v", "t", "acc") if adam else ("p", "m", "acc")
    s = {n: t[n].clone() for n in ("p", "m", "v", "t", "acc")}
    mk.mlp_opt_step(s["p"], t["g"], s["m"], s["v"] if adam else None,
                    s["t"] if adam else None, t["wmask"], t["alpha"],
                    t["wsum"], t["lr"], t["active"], t["loss"], s["acc"],
                    adam=adam)
    rows[f"mlp_opt_step {path}"] = {
        "ms": cs.graph_ms(fn), "host_us": host_us(fn),
        "bits": digest([s[n] for n in names])}
for path, shape in (("baseline5", {}),
                    ("regressor", dict(B=6, k=1, d=cs.D_REG,
                                       alphas=cs.MLP_REG_ALPHAS))):
    t = cs.mlp_step_inputs(0, **shape)
    kw = {"y": t["y"]} if path == "baseline5" else {"Yt": t["Yt"]}
    fn = lambda: mk.mlp_loss_grad(t["Z"], t["w"], **kw)
    if len(fn()) == 4:
        with_db = fn
    else:
        with_db = lambda: (lambda o: o + (o[2].sum(dim=1),))(fn())
    for part, call in (("", fn), ("+db", with_db)):
        rows[f"mlp_loss_grad{part} {path}"] = {
            "ms": cs.graph_ms(call), "host_us": host_us(call),
            "bits": digest(call()[1:3])}
X = torch.as_tensor(cs.mnist_like(0)[0], device="cuda")
Xp = X[:2000] - X[:2000].mean(dim=0)
for label, X1, X2 in (("rbf", X, X), ("rbf_predict", X[:2000], X),
                      ("rbf_pipeline", Xp, Xp)):
    gamma = 1.0 / (X1.shape[1] * float(X1.var()))
    G0 = X1 @ X2.T
    work = G0.clone()
    fn = lambda: svk.gram_epilogue(work, X1, X2, "rbf", gamma, 3, 0.0)
    rows[f"svm_gram_epilogue {label}"] = {
        "ms": cs.graph_ms(fn, reps=20), "host_us": host_us(fn),
        "bits": digest([svk.gram_epilogue(G0.clone(), X1, X2, "rbf", gamma,
                                          3, 0.0)])}
    del G0, work
*fold, step = cs.svm_pair_inputs(0, C=1.0, folds=3, n=2000)
for shape, inputs in (
        ("", cs.svm_step_inputs(0)),
        (" pairs", cs.svm_pair_inputs(0)),
        (" pipeline", (*(t[:45] for t in fold), step))):
    V, z, x, yb, bnd, target, step = inputs
    for mode in ("svc", "nu"):
        tgt = target if mode == "nu" else None
        fn = lambda: svk.dual_step(V, z, x, yb, bnd, step, 0.4, tgt)
        rows[f"svm_dual_step {mode}{shape}"] = {
            "ms": cs.graph_ms(fn), "host_us": host_us(fn),
            "bits": digest(fn())}
from spark_sklearn_tpu_torch import KFold, StratifiedKFold
from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
from spark_sklearn_tpu_torch.ops import knn_kernels as knk
for label, (Xn, yn, splitter) in (
        ("knn", (*cs.mnist_like(0), StratifiedKFold(cs.N_FOLDS))),
        ("knn_regressor", (*cs.california_like(0), KFold(cs.N_FOLDS)))):
    Xt = torch.as_tensor(Xn, device="cuda")
    G = Xt @ Xt.T
    sq = (Xt * Xt).sum(dim=1)
    masks = torch.as_tensor(cs.train_masks(yn, splitter), device="cuda")
    fn = lambda: knk.knn_fold_topk(G, sq, sq, masks, max(cs.KNN_K))
    rows[f"knn_fold_topk {label}"] = {
        "ms": cs.graph_ms(fn, reps=10), "host_us": host_us(fn, calls=10),
        "bits": digest(fn())}
    del G
Xc, yc = cs.covtype_like(0)
Xk = torch.as_tensor(Xc, device="cuda")
n, d = Xc.shape
B = len(cs.KMEANS_TOL) * cs.N_FOLDS
rng = np.random.default_rng(0)
C = Xk[torch.as_tensor(rng.integers(0, n, (B, cs.KMEANS_K)), device="cuda")]
xx, cc = (Xk * Xk).sum(dim=1), (C * C).sum(dim=2)
w = torch.as_tensor(np.tile(cs.train_masks(yc, KFold(cs.N_FOLDS)),
                            (len(cs.KMEANS_TOL), 1)), device="cuda")
if len(inspect.signature(kmk.kmeans_assign).parameters) == 5:
    fn = lambda: kmk.kmeans_assign(Xk, C, xx, cc, w)
else:
    C_all = C.reshape(B * cs.KMEANS_K, d)
    fn = lambda: kmk.kmeans_assign(Xk @ C_all.T, xx, cc, w)
a, m, s = fn()
np.save(os.path.join(sys.argv[2], "assign.npy"), a.cpu().numpy())
rows["kmeans_assign lloyd"] = {
    "ms": cs.graph_ms(fn), "host_us": host_us(fn), "bits": digest([a, m])}
del w, a, m, s
from spark_sklearn_tpu_torch.models.naive_bayes import GaussianNBFamily
from spark_sklearn_tpu_torch.ops import nb_kernels as nbk
data_np, meta = GaussianNBFamily.prepare_data(Xc, yc)
data = {k: torch.as_tensor(v, device="cuda") for k, v in data_np.items()}
B = len(cs.NB_SMOOTHING) * cs.N_FOLDS
model = GaussianNBFamily.fit_task_batched(
    {"var_smoothing": torch.as_tensor(
        np.repeat(cs.NB_SMOOTHING, cs.N_FOLDS).astype(np.float32),
        device="cuda")}, {"__n_folds__": cs.N_FOLDS}, data,
    torch.as_tensor(np.tile(cs.train_masks(yc, StratifiedKFold(cs.N_FOLDS)),
                            (len(cs.NB_SMOOTHING), 1)), device="cuda"), meta)
args = (data["X"], model["theta"], model["var"], model["log_prior"])
fn = lambda: nbk.gnb_jll(*args)
jll = fn()
np.save(os.path.join(sys.argv[2], "jll_pred.npy"),
        jll.argmax(dim=2).cpu().numpy())
rows["gnb_jll gaussian_nb"] = {
    "ms": cs.graph_ms(fn, reps=20), "host_us": host_us(fn, calls=20),
    "bits": digest([jll])}
del data, model, args, jll
from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk
torch.cuda.empty_cache()
for mode in ("svr", "nu"):
    a = cs.svr_step_inputs(0, mode)
    fn = lambda: svk.svr_dual_step(*a)
    rows[f"svm_svr_step {mode}"] = {
        "ms": cs.graph_ms(fn), "host_us": host_us(fn), "bits": digest(fn())}
    del a
dec, y, tw, pairs = cs.proba_inputs(0)
fn = lambda: pk.platt_fit(dec, y, tw, pairs, False)
rows["svm_platt_fit svc_proba"] = {
    "ms": cs.cuda_ms(fn, reps=10), "host_us": host_us(fn, calls=3),
    "bits": digest(fn())}
print(json.dumps(rows))
"""


def alone_rows(tree: str, change: str, out: str, sp1: bool = False
               ) -> dict:
    """{row: {ms, host_us, bits}} of ALONE_ROWS run in `tree`'s
    directory on the inputs of `change`'s chip_smoke.py (with `sp1`, its
    SP1 rows alone); C1's assignments saved under `out`."""
    os.makedirs(out, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", ALONE_ROWS,
                           os.path.abspath(change), os.path.abspath(out)]
                          + (["sp1"] if sp1 else []),
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"the kernels-alone timing failed in {tree}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def print_alone(alone: dict, rows, keys) -> None:
    """The kernels-alone table: each row's `keys` for the four runs and
    the change's mean over the parent's."""
    for key, title, fmt in keys:
        print(f"\n{title:40s} {'parent 1':>9s} {'change 1':>9s} "
              f"{'change 2':>9s} {'parent 2':>9s} {'change/parent':>14s}")
        for r in rows:
            par = [a[r][key] for a in alone["parent"]]
            chg = [a[r][key] for a in alone["change"]]
            print(f"{r:40s} " + " ".join(f"{c:{fmt}}" for c in
                                         (par[0], chg[0], chg[1], par[1]))
                  + f" {sum(chg) / sum(par):14.3f}")


def print_bits(alone: dict) -> None:
    print(f"\n{'outputs, change against parent':40s} bits")
    for r in alone["change"][0]:
        runs = {a[r]["bits"] for a in alone["change"] + alone["parent"]}
        same_change = len({a[r]["bits"] for a in alone["change"]}) == 1
        print(f"{r:40s} " + ("equal" if len(runs) == 1 else
                             "differ" if same_change else
                             "the change's two runs differ"))


def sp1_alone(order, change: str) -> int:
    """SP1's kernels-alone rows only, parent, change, change, parent."""
    alone = {"parent": [], "change": []}
    for i, (label, tree) in enumerate(order, 1):
        alone[label].append(alone_rows(
            tree, change, os.path.join(OUT, f"alone{i}_{label}"), sp1=True))
    print_alone(alone, list(alone["change"][0]),
                (("ms", "SP1 alone (ms, CUDA graph, L2 warm)", "9.4f"),
                 ("flushed_ms", "SP1 alone (ms, L2 flushed)", "9.4f"),
                 ("host_us", "host time a call (us)", "9.1f")))
    print_bits(alone)
    with open(os.path.join(OUT, "sp1_alone.json"), "w") as f:
        json.dump(alone, f, indent=1)
    return 0


def run(tree: str, label: str, i: int) -> dict:
    """Run `tree`'s chip_smoke.py; keep its JSON and output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          capture_output=True, text=True)
    with open(os.path.join(OUT, f"run{i}_{label}.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    print(f"run {i} {label} ({tree}): exit {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"run {i} ({label}) failed")
    src = os.path.join(tree, "chiprun_out", "chip_smoke.json")
    dst = os.path.join(OUT, f"run{i}_{label}.json")
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copyfile(src, dst)
    with open(dst) as f:
        return json.load(f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="directory of the parent's tree")
    ap.add_argument("--change", default=".",
                    help="directory of the change's tree")
    ap.add_argument("--sp1-alone", action="store_true",
                    help="SP1's rows alone, without the chip_smoke.py runs")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    order = [("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent)]
    if args.sp1_alone:
        return sp1_alone(order, args.change)
    walls = {"parent": [], "change": []}
    trees = {"parent": [], "change": []}
    kernels = {"parent": [], "change": []}
    busy = {"parent": [], "change": []}
    for i, (label, tree) in enumerate(order, 1):
        d = run(tree, label, i)
        walls[label].append(warm_walls(d))
        trees[label].append(tree_rows(d))
        kernels[label].append(kernel_rows(d))
        busy[label].append(svm_busy(d))
    phases = list(walls["change"][0])
    print(f"\n{'phase':24s} {'parent 1':>10s} {'change 1':>10s} "
          f"{'change 2':>10s} {'parent 2':>10s} {'spread':>8s} "
          f"{'change-parent':>14s}")
    for p in phases:
        par = [w.get(p) for w in walls["parent"]]
        chg = [w[p] for w in walls["change"]]
        cells = [par[0], chg[0], chg[1], par[1]]
        text = " ".join(f"{c:10.4f}" if c is not None else f"{'-':>10s}"
                        for c in cells)
        if None in par:
            print(f"{p:24s} {text}")
            continue
        spread = max(par) - min(par)
        diff = sum(chg) / 2 - sum(par) / 2
        mark = "" if abs(diff) <= spread else "  outside"
        print(f"{p:24s} {text} {spread:8.4f} {diff:+14.4f}{mark}")
    print(f"\n{'search':24s} {'busy s, |d score|: parent 1':>30s} "
          f"{'change 1':>22s} {'change 2':>22s} {'parent 2':>22s}")
    for p in trees["change"][0]:
        cells = [trees["parent"][0][p], trees["change"][0][p],
                 trees["change"][1][p], trees["parent"][1][p]]
        print(f"{p:24s} " + " ".join(f"{b:10.4f} s, {x:9.3g}"
                                     for b, x in cells))
    print(f"\n{'SVM search busy (s)':24s} {'parent 1':>10s} {'change 1':>10s} "
          f"{'change 2':>10s} {'parent 2':>10s}")
    for p in busy["change"][0]:
        cells = [busy["parent"][0].get(p), busy["change"][0][p],
                 busy["change"][1][p], busy["parent"][1].get(p)]
        print(f"{p:24s} " + " ".join(
            f"{c:10.4f}" if c is not None else f"{'-':>10s}" for c in cells))
    print(f"\n{'phase 3 row (ms)':40s} {'parent 1':>9s} {'change 1':>9s} "
          f"{'change 2':>9s} {'parent 2':>9s} {'change/parent':>14s}")
    for r in kernels["change"][0]:
        par = [k.get(r) for k in kernels["parent"]]
        chg = [k[r] for k in kernels["change"]]
        cells = [par[0], chg[0], chg[1], par[1]]
        text = " ".join(f"{c:9.4f}" if c is not None else f"{'-':>9s}"
                        for c in cells)
        ratio = ("" if None in par else
                 f"{sum(chg) / sum(par):14.3f}")
        print(f"{r:40s} {text} {ratio}")
    alone = {"parent": [], "change": []}
    assigns = {"parent": [], "change": []}
    preds = {"parent": [], "change": []}
    for i, (label, tree) in enumerate(order, 1):
        out = os.path.join(OUT, f"alone{i}_{label}")
        alone[label].append(alone_rows(tree, args.change, out))
        for name, keep in (("assign.npy", assigns), ("jll_pred.npy", preds)):
            # read, then removed: the four runs' files are tens of MB each
            keep[label].append(np.load(os.path.join(out, name)))
            os.remove(os.path.join(out, name))
    grow = [r for r in alone["change"][0] if r.startswith("grow_tree")]
    print_alone(alone, list(alone["change"][0]),
                (("ms", "kernels alone (ms, CUDA graph; grow_tree events)",
                  "9.4f"),
                 ("host_us", "host time a call (us)", "9.1f")))
    sp1 = [r for r in alone["change"][0] if r.startswith("csr_spmm")]
    print_alone(alone, sp1, (("flushed_ms", "SP1 alone (ms, L2 flushed)",
                              "9.4f"),))
    print_alone(alone, grow,
                (("launches_per_level", "grow_tree: device launches a "
                  "level", "9.2f"),
                 ("host_us_per_level", "grow_tree: host us a level",
                  "9.1f"),
                 ("device_us_per_level", "grow_tree: device us a level",
                  "9.1f")))
    print_bits(alone)
    a_par, a_chg = assigns["parent"][0], assigns["change"][0]
    print(f"\nC1's assignments at the Lloyd step, change against parent: "
          f"{int((a_par != a_chg).sum())} of {a_par.size} differ (the "
          f"trees' own repeats: "
          f"{int((a_par != assigns['parent'][1]).sum())}, "
          f"{int((a_chg != assigns['change'][1]).sum())})")
    p_par, p_chg = preds["parent"][0], preds["change"][0]
    print(f"B1's argmax class at the GaussianNB views, change against "
          f"parent: {int((p_par != p_chg).sum())} of {p_par.size} differ "
          f"(the trees' own repeats: "
          f"{int((p_par != preds['parent'][1]).sum())}, "
          f"{int((p_chg != preds['change'][1]).sum())})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
