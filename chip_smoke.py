#!/usr/bin/env python3
"""Drive the PyTorch port (spark_sklearn_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; no phase's exception is caught):

1. print the card (nvidia-smi name and power limit, torch's device name);
2. build the CUDA kernels from spark_sklearn_tpu_torch/csrc/ with nvcc;
3. kernel check: K2 (glm_loss_grad) and K4 (glm_trial_loss) against their
   plain PyTorch versions at the headline shapes (n=1797 samples,
   B=5000 lanes, k=10 and k=2), with times, bounds, launch plans, ptxas'
   registers and spills, and a check that two launches on the same
   inputs give the same bits;
4. main path: the headline search — GridSearchCV(LogisticRegression(
   max_iter=100), 1000 C values, StratifiedKFold(5), refit=False) on
   digits-shaped data made from --seed — on cuda, cold then warm, with
   the kernels' launch counts, and a profiled run for the device's
   busy share;
5. device agreement: the same search over 20 C values (every 50th of the
   grid) and a binary search (classes 0 and 1) on cuda and on the CPU;
6. regressors at full width on California-Housing-shaped data made from
   --seed (n=20640, d=8): GridSearchCV of Ridge (1000 alphas, float64),
   LinearRegression (fit_intercept True/False) and ElasticNet(max_iter=
   1000) (100 alphas x 5 l1_ratios), KFold(5), four regression scorers,
   refit on r2 on the device; cold and warm walls, fits/s, peak memory,
   and cuda against the CPU on a subsample of each grid;
7. the l1 path at full width: RandomizedSearchCV(LogisticRegression(
   penalty="l1", max_iter=100), C ~ loguniform(1e-2, 1e2), n_iter=200,
   StratifiedKFold(5)) on phase 4's data, fitted by FISTA through K2, and
   the same candidates with penalty="elasticnet", l1_ratio=0.5; walls,
   FISTA iterations, K2 launches, the profiler's idle share and kernel
   list, FISTA's per-iteration split, and cuda against the CPU on 20 of
   the candidates;
8. kernel SVMs at full width on MNIST-shaped data made from --seed
   (n=10000, d=784, 10 classes): GridSearchCV(SVC(kernel="rbf"), 3 C x 3
   gamma, StratifiedKFold(5), refit=True) through S1 (the Gram epilogue)
   and S2 (the projected dual step), cold, warm and profiled, with the
   steps of each candidate, the split of a step between the ascent GEMM
   and S2, and the refit SVC predicting on the card; a NuSVC(nu in {0.1,
   0.3}) search on the same data; and cuda against the CPU on a
   stratified 2000-row subset (2 candidates, 3 folds, and at C=0.1, where
   the residual exit ends the solve before its 300-step budget).

9. gradient boosting, BASELINE config #4, on phase 6's data:
   GridSearchCV(GradientBoostingRegressor(random_state=0), learning_rate
   {0.05, 0.1, 0.2} x subsample {1.0, 0.8} x n_estimators {100, 200} x
   max_depth {3, 5}, KFold(5), r2 and neg_mean_squared_error,
   refit=False): 120 fits in two groups; then GradientBoostingClassifier(
   n_estimators=50, max_depth=3) over learning_rate {0.1, 0.3} on phase
   4's data, 5 folds; each cold, warm and profiled (trees grown, busy ms
   a tree, idle share, peak memory, best candidate), and cuda against the
   CPU on at most 2000 rows (2 candidates, 3 folds); the device
   launches and warm wall a level of each search (its profile's events
   over its T3 level steps), and `grow_tree` alone at the search's chunk
   (launches, host and device us a level);
10. random forest, BASELINE config #3, on covtype-shaped data made from
   --seed (d=54: 10 quantitative columns in covtype's ranges, 4
   wilderness and 40 soil one-hot columns, 7 classes at covtype's
   shares; rows cut from 581012 to 100000 to keep the phase near a
   minute): RandomizedSearchCV(RandomForestClassifier(random_state=0),
   n_estimators {20, 30, 40, 50} x max_depth {6, 8, 10}, n_iter=4,
   StratifiedKFold(3), random_state=0, refit=False); a
   RandomForestRegressor at one candidate on phase 6's data; as phase 9's
   record, and cuda against the CPU on 2000 stratified rows;
11. the MLP pipeline, BASELINE config #5, with the port's own classes:
   GridSearchCV(Pipeline([("scale", StandardScaler()), ("mlp",
   MLPClassifier(hidden_layer_sizes=(64,), max_iter=60, random_state=0))]),
   mlp__alpha in {1e-4, 1e-3, 1e-2, 1e-1}, cv=3, refit=True) on phase 4's
   data (12 lanes, batch 200, through M1-M3), cold, warm and profiled
   (epochs, busy ms and launches a minibatch step, idle share, peak
   memory, best alpha and score, the refit pipeline predicting on the
   card); then Pipeline(StandardScaler + MLPRegressor(hidden_layer_sizes=
   (64,), max_iter=20, random_state=0)) over 2 alphas x KFold(3) on phase
   6's data (M1's regressor variant) and Pipeline(StandardScaler + SVC)
   over 2 C x 3 folds on 2000 rows of phase 8's data (S1 and S2 on
   per-fold inputs); each with its kernels' launches and cuda against
   the CPU (the same best candidate, scores within 5e-3);
12. naive Bayes, LDA, KNN and KMeans with the port's own classes, each
   search cold (with its kernels' launches), warm and profiled (busy ms,
   device launches, idle share), then against the CPU on its first 2000
   rows with a smaller grid and 3 folds: GaussianNB (var_smoothing, 12
   values in [1e-11, 1e-5]) x StratifiedKFold(5) = 60 lanes on phase 10's
   covtype-shaped data (B1), accuracy and neg_log_loss; MultinomialNB,
   ComplementNB, BernoulliNB and CategoricalNB (alpha, 20 values in
   [1e-3, 10]) on phase 4's digits as counts 0-16; LDA(solver="lsqr",
   shrinkage in {0, 0.01, 0.1, 0.5, 0.9}) and KNeighborsClassifier
   (n_neighbors 1, 3, ..., 15 x weights uniform/distance) on phase 8's
   MNIST-shaped data (N1); a KNeighborsRegressor over the same
   n_neighbors on phase 6's data (N1); KMeans(n_clusters=8, n_init=1,
   random_state=0) over tol {1e-5, 1e-4, 1e-3, 1e-2} x KFold(5) on the
   covtype-shaped data with its default scorer, -inertia (C1);
13. the rest of the SVMs with the port's own classes, each search cold
   (with its kernels' launches), warm and profiled, then against the CPU
   on 2000 rows with a smaller grid and 3 folds: phase 8's SVC(rbf)
   search (3 C x 3 gamma, StratifiedKFold(5), MNIST-shaped) with
   probability=True, scored by accuracy and neg_log_loss, refit on
   accuracy and its predict_proba on the card (P1, P2); GridSearchCV(
   SVR(kernel="rbf"), C {1, 10, 100} x epsilon {0.1, 0.5}, KFold(5)) and
   NuSVR over nu {0.25, 0.5, 0.75} on phase 6's California-shaped data
   (S1 and S2's SVR mode); LinearSVC (C {0.01, 0.1, 1} x loss hinge,
   squared_hinge) on phase 8's data and LinearSVR (C {0.01, 0.1, 1} x
   both losses) on phase 6's (library GEMMs and torch ops);
14. the search front end's weighted fit: phase 4's headline search with
   sample_weight (uniform in [0.25, 3) from --seed) on cuda, cold (K2's
   and K4's launches), warm and profiled beside phase 4's unweighted
   walls, and on the CPU: the same best index, scores within 5e-3 on
   phase 5's 20 C (every 50th: the CPU takes ~12 minutes
   over all 1000); phase 13's SVC(probability=True) search weighted on cuda
   (S1, S2, P1, P2), against the CPU on its 2000-row subset; and the
   weighted search over phase 5's 20 C values refit on cuda and on the
   CPU: the refit's score, decision_function and predict_log_proba on
   the card against the CPU's;
15. successive halving through the search core's evaluate_candidates
   seam, with the port's own estimators: (a) HalvingGridSearchCV(
   LogisticRegression(), phase 4's 1000 C, StratifiedKFold(5), factor=3)
   on phase 4's data (K2, K4), (b) HalvingGridSearchCV(SVC(rbf), phase
   8's 3 C x 3 gamma, cv=5) on phase 8's data (S1, S2), (c)
   HalvingGridSearchCV(GradientBoostingRegressor(), 3 learning rates x 3
   depths, resource="n_estimators", max_resources=90, KFold(5),
   refit=False) on phase 6's data (G, T1-T4), (d) HalvingRandomSearchCV(
   LogisticRegression(), C ~ loguniform(1e-3, 1e2)) on phase 4's data
   (K2, K4); each cold (its kernels' launches) and warm, with its rung
   plan (n_resources_, n_candidates_) held to the expected one and each
   rung's wall; then cuda against the CPU: the same rung plan, iter and
   n_resources columns and survivors, and scores within the phases'
   tolerances (for accuracy on a subsampled rung rounded up to a whole
   number of test predictions' shares of the mean), and the same best
   or one tied with it there, (a) on phase 5's 20 C, (b) on 600 of
   phase 8's rows (60 a class) with 3 folds, (c) on 2000 rows (as phase
   9 checks), (d) whole;
16. sparse X under TorchConfig(data_mode="sparse"), on counts made from
   --seed shaped like fetch_20newsgroups_vectorized's training split
   (11314 rows, 130107 columns, 20 classes, ~161 nonzeros a row on
   Zipf-like columns; 5.9 GB were it dense): (a) GridSearchCV(
   LogisticRegression(max_iter=100), 10 C in logspace(-1, 2),
   StratifiedKFold(5), refit=False) on the l2-normalised rows, (b)
   MultinomialNB, ComplementNB and BernoulliNB over 5 alphas x
   StratifiedKFold(5) on the counts; each cold with SP1's launches, warm
   and profiled (busy, idle share, SP1's and the copy kernels' device
   time); then on a 2000 x 20000 cut, 3 C (the 5 alphas) x 3 folds, cuda
   sparse against CPU sparse and against cuda densified (5e-3; NB 1e-6);
17. keyed fleets, gapply and converted tree ensembles with the port's
   own classes: (a) KeyedEstimator on a dict of columns (no pandas on the
   card) of 2000 keys with Zipf-skewed group sizes of 16-4096 rows (~1 M
   rows), d=32, plus 20 keys whose labels lack a class: LogisticRegression
   multinomial (k=4; the 20 keys host-fitted by the port's own
   LogisticRegression on cuda, backend "hybrid") and binary (K2ℓ, K4ℓ),
   LinearRegression, Ridge, KMeans(n_clusters=8) (C1ℓ), StandardScaler
   and PCA(8), each fitted cold, warm and profiled (busy, idle share),
   with its launches, buckets and the keys' n_iter range, then
   `transform` over the same rows plus 10 unseen keys, and cuda against
   the CPU on 200 keys of at most 512 rows; (b) `run_bucketed` with a
   torch compiled group function over the same segments; (c) RF-shaped
   (100 trees of depth <= 20, 7 classes) and GB-shaped (100 stages x 7
   classes, depth 3) ensembles grown from --seed in sklearn's node
   layout on phase 10's covtype-shaped X (n=100000, d=54), timed through
   `TorchModel.predict_proba` (TI1, `csrc/tree_infer.cu`); K2ℓ, K4ℓ and
   C1ℓ at the fleets' largest bucket and TI1 at (c)'s ensembles against
   their plain versions, timed in a CUDA graph beside their bounds.

Phase 3 also holds S1 (rbf, poly; and rbf on a (2000, 10000) prediction,
whose norms are summed apart; each timed as a CUDA graph's replay,
between events and on the host a call, its device time split by kernel
by the profiler) and S2 (SVC and NuSVC projections; the
staged plan, and the streamed one forced for its time) against their
plain versions at phase 8's shapes (n=10000, d=784; 225 subproblem rows
of 10000: phase 8's own structure, 45 class pairs x 5 folds with 16% of
the elements free, and the 65%-free rows of `svm_step_inputs`) and on a
fold of phase 11's scaler + SVC path (n=2000, 45 rows), and the tree
grower's T1 (level histogram), T2 (split choice: the forest's roots
unmasked and with 7 of 54 features kept, its deepest level with 7 kept
and with a quarter of the nodes keeping none; its bound counts the kept
features' bytes, the whole histogram's time beside it), T3 (its level
step at the roots and at the last level, its accumulate of the last
level's nodes and the walk of whole trees, each `torch.equal` to its
plain version, timed as a CUDA graph's replay and between events), T4
(leaf values) and G (their grouping of rows by node) at phase 9's (60
lanes, n=20640, d=8, depth 5) and phase 10's (6 lanes, n=100000, d=54,
depth 10) shapes: T1 at the root and the deepest level,
uniform and skewed (half the rows in one node, a quarter in the next,
...), T4 uniform, skewed and at one node a lane (the boosting init),
each `torch.equal` to its plain version on CPU copies of the inputs,
timed alone and with its grouping, beside `index_add_` (T1, T4),
`torch.sort` (G, timed as a CUDA graph's replay and between events),
its byte bound and its order bound (the longest chain
of one sum x 4 clocks at the SM clock read under load); and the MLP
step's M1 (loss, cotangent and the output bias gradient; the host time
a call, and `G.sum(dim=1)`, the step's reduction it replaced, timed
beside it), M2 (adam step; `torch._fused_adam_`
timed beside it, and `torch._fused_sgd_` beside the sgd step) and M3
(bias and activation, forward and backward; relu's backward beside
`torch.ops.aten.threshold_backward`) at
every shape phase 11 gives them: the BASELINE #5 step (12 lanes, 200
rows, k=10, h=64) and the MLPRegressor's (6 lanes, k=1, d=8), timed; the
refit's one lane and the views' whole folds, checked; and N1 (KNN's
fold-masked top-k: phase 12's KNN classifier and regressor chunks,
beside `torch.topk` on each fold's masked distances), C1 (k-means
assignment from X and the centers: its Lloyd step, beside the library
GEMM X C_allᵀ then `torch.min` on the formed distances)
and B1 (GaussianNB's joint log-likelihood: its views on the family's own
fit), each equal to (N1, C1) or within rtol 1e-5 of (B1) its plain
version, timed in a CUDA graph and between events; and phase 13's P1
(Platt fits of the SVC probability search's 2025 (task, pair) rows, each
leaving at its fixed point, its steps counted and its bits held to the
same kernel's 50-step run, timed beside it), P2 (the coupling of its 45
tasks x 10000 rows under every plan that serves k = 10, and of
decisions made from --seed at k = 26 and k = 50 over the same
450000 problems), SP1 (`csr_spmm`, the sparse X's products, at phase
16's shapes: (a)'s forward X Wᵀ and backward Xᵀ G at W = 1000, (b)'s
class sums at W = 100 and joint log-likelihoods at W = 500, the
backward at W = 97 and Xᵀ's heaviest row alone; within the float32
bound of two summation orders of its plain version on the card, equal
to it on integer inputs of the same structure and to the CPU's plain
version on 2000 rows; its work plan; timed warm and with L2 flushed,
beside `torch.sparse.mm`, with the copies the sparse path no longer
makes and those that remain) and S2's SVR mode
(epsilon-SVR and nu-SVR steps at the SVR searches' 5 folds of 20640
pairs: a thread-block cluster a row as the plan picks it for the card,
beside clusters of 8 CTAs, with how many clusters the card holds at once
and five graph timings), each against its plain version with its
tolerance, bound and registers.

It prints one JSON line of per-kernel numbers, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits 2.  It imports no
JAX, nothing of the JAX package and no scikit-learn.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

OUT_DIR = "chiprun_out"
N, D, K = 1797, 64, 10                 # digits: samples, features, classes
N_C, N_FOLDS = 1000, 5                 # the headline grid
N_REG, D_REG = 20640, 8                # California Housing: samples, features
REG_SCORING = ["r2", "neg_mean_squared_error", "neg_mean_absolute_error",
               "neg_median_absolute_error"]
N_L1 = 200                             # the l1 path's RandomizedSearchCV
N_SVM, D_SVM, K_SVM = 10000, 784, 10   # MNIST-10k: samples, pixels, classes
SVC_KERNELS = ("svm_gram_epilogue", "svm_dual_step")  # S1, S2: SVC's path
SVM_C = [1.0, 10.0, 100.0]             # phase 8's grid: C x gamma factors
SVM_GAMMA = [0.5, 1.0, 2.0]            # x 1/(d var X), sklearn's "scale"
SVM_NU = [0.1, 0.3]
SVM_C_EXIT = 0.1                       # a C whose dual exits before 300 steps
N_SVM_CHECK = 2000                     # rows of the cuda-against-cpu check
SVM_ROWS = N_FOLDS * K_SVM * (K_SVM - 1) // 2   # 225 subproblems a candidate
N_RF, D_RF, K_RF = 100000, 54, 7       # covtype, rows cut from 581012
N_TREE_CHECK = 2000                    # rows of the trees' cuda/cpu checks
GB_GRID = {"learning_rate": [0.05, 0.1, 0.2], "subsample": [1.0, 0.8],
           "n_estimators": [100, 200], "max_depth": [3, 5]}
RF_GRID = {"n_estimators": [20, 30, 40, 50], "max_depth": [6, 8, 10]}
MLP_ALPHAS = [1e-4, 1e-3, 1e-2, 1e-1]  # BASELINE #5's grid
MLP_HIDDEN, MLP_BATCH, MLP_FOLDS = 64, 200, 3
MLP_LANES = len(MLP_ALPHAS) * MLP_FOLDS
HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12                  # H100 SXM float32, non-tensor-core
SFU_PER_CLOCK_PER_SM = 16              # exp2/log2 results (CUDA guide, 9.0)
P1_GRAD_OPS, P1_TRIAL_OPS = 33, 416   # P1's FP32 operations an element a
                                       # pass (its SASS; phase 3)


def header(title: str, t_start: float) -> None:
    print(f"{title} ({time.perf_counter() - t_start:.1f} s in)")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of `fn()` without its host cost: `reps` calls
    captured in one CUDA graph, replayed between CUDA events.  For the
    small launches of the MLP step, whose wrappers take longer on the
    host than their kernels on the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of `fn()` over `reps` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int = 100) -> float:
    """The host's time a call of `fn()` (us): the best of 7 loops of
    `calls` calls, each begun on an idle device (too few calls to fill
    the launch queue)."""
    import torch
    best = float("inf")
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def device_split(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call} over `calls` calls of `fn()`, from
    the profiler's records: the kernels a wrapper launches and how its
    device time divides among them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            split[e.name()] = (split.get(e.name(), 0.0)
                               + e.duration_ns() / 1e6 / calls)
    return split


def three_times(fn, graph_reps: int = 50) -> dict:
    """A wrapper's device time in a CUDA graph (`ms`), between events
    around eager calls (`events_ms`, its host cost included where that is
    longer) and its host time a call (`host_us`)."""
    return {"ms": graph_ms(fn, reps=graph_reps), "events_ms": cuda_ms(fn),
            "host_us": host_us(fn)}


def kernel_inputs(k: int, seed: int, B: int = N_C * N_FOLDS):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (N, B) if k == 2 else (N, B, k)
    Z = 3.0 * torch.randn(shape, generator=g, device="cuda")
    Zp = torch.randn(shape, generator=g, device="cuda")
    wT = (torch.rand((N, B), generator=g, device="cuda") < 0.8).float()
    y = torch.randint(0, k, (N,), generator=g, device="cuda",
                      dtype=torch.int32)
    a0 = 0.05 + 0.95 * torch.rand(B, generator=g, device="cuda")
    alphas = (0.5 ** torch.arange(16, device="cuda", dtype=torch.float32)
              )[:, None] * a0[None, :]
    return Z, Zp, wT, y, alphas.contiguous()


def op_counts(k: int, B: int, T: int = 16):
    """Floating-point operations (a transcendental counts as one) and
    transcendentals of K2 and K4 on (n, B[, k]) logits."""
    rows = N * B
    if k == 2:
        # loss: max, abs, neg, exp, log1p, mul, sub, add, mul-add (~10);
        # grad: neg, exp, add, div, sub, mul (6)
        k2_ops, k2_sfu = rows * 16, rows * 3
        # per trial: fma (2) + the loss (10)
        k4_ops, k4_sfu = T * rows * 12, T * rows * 2
    else:
        # per logit: max, sub, exp, add; mul, sub, mul (7); per row:
        # log, add, sub, mul, add, reciprocal (6)
        k2_ops, k2_sfu = rows * (7 * k + 6), rows * (k + 2)
        # per trial and logit: fma, max; fma, sub, exp, add (8); per row 5
        k4_ops, k4_sfu = T * rows * (8 * k + 5), T * rows * (k + 1)
    return (k2_ops, k2_sfu), (k4_ops, k4_sfu)


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def ptxas_table(log: str):
    """{mangled kernel name: (registers, spilled bytes)} from nvcc's
    ``-Xptxas -v`` report."""
    table, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            table[fn] = (int(m.group(1)), spill)
    return table


def kernel_symbol(name: str, k: int) -> str:
    """The part of the mangled name of the CUDA kernel that `name` runs
    at k classes (k == 2: the binary loss)."""
    base = {"glm_loss_grad": "loss_grad", "glm_trial_loss": "trial_loss"}
    if k == 2:
        return f"{base[name]}_directILb1E"
    if k <= 16:
        return f"{base[name]}_stagedILi{k}E"
    return f"{base[name]}_directILb0E"


def phase_kernels(seed: int, n_sm: int, sm_mhz: float, ptxas: dict):
    """K2 and K4 against their plain versions at the headline shapes."""
    import torch

    from spark_sklearn_tpu_torch.ops import glm_kernels as gk

    sfu_per_ms = n_sm * SFU_PER_CLOCK_PER_SM * sm_mhz * 1e3
    rows = {}
    for k in (K, 2):
        Z, Zp, wT, y, alphas = kernel_inputs(k, seed + k)
        loss, G = gk.glm_loss_grad(Z, wT, y)
        trials = gk.glm_trial_loss(Z, Zp, wT, y, alphas)
        torch.cuda.synchronize()
        loss_p, G_p = gk.glm_loss_grad_plain(Z, wT, y)
        trials_p = gk.glm_trial_loss_plain(Z, Zp, wT, y, alphas)
        # tolerance: rtol 1e-5 on per-lane loss sums, atol 1e-6 on G —
        # the kernels add rows in another order than torch's reductions
        # (and fuse z + a*zp into one FMA)
        checks = {
            "glm_loss_grad": [(loss, loss_p, 1e-5, 1e-6), (G, G_p, 0, 1e-6)],
            "glm_trial_loss": [(trials, trials_p, 1e-5, 1e-6)],
        }
        # two launches on the same inputs must give the same bits (the
        # kernels add their partial sums in a fixed order, no atomics)
        again = {"glm_loss_grad": gk.glm_loss_grad(Z, wT, y),
                 "glm_trial_loss": (gk.glm_trial_loss(Z, Zp, wT, y, alphas),)}
        first = {"glm_loss_grad": (loss, G), "glm_trial_loss": (trials,)}
        for name in first:
            if not all(torch.equal(a, b)
                       for a, b in zip(first[name], again[name])):
                raise AssertionError(f"{name} (k={k}): two launches on the "
                                     "same inputs differ")
        del again
        (k2_ops, k2_sfu), (k4_ops, k4_sfu) = op_counts(k, Z.shape[1])
        io = {
            "glm_loss_grad": (Z.nbytes + wT.nbytes + y.nbytes + G.nbytes
                              + loss.nbytes, k2_ops, k2_sfu),
            "glm_trial_loss": (Z.nbytes + Zp.nbytes + wT.nbytes + y.nbytes
                               + alphas.nbytes + trials.nbytes, k4_ops,
                               k4_sfu),
        }
        timed = {
            "glm_loss_grad": (lambda: gk.glm_loss_grad(Z, wT, y),
                              lambda: gk.glm_loss_grad_plain(Z, wT, y)),
            "glm_trial_loss": (
                lambda: gk.glm_trial_loss(Z, Zp, wT, y, alphas),
                lambda: gk.glm_trial_loss_plain(Z, Zp, wT, y, alphas)),
        }
        for name in checks:
            max_abs = 0.0
            for got, want, rtol, atol in checks[name]:
                err = (got - want).abs()
                max_abs = max(max_abs, float(err.max()))
                ok = bool((err <= atol + rtol * want.abs()).all())
                if not ok:
                    raise AssertionError(
                        f"{name} (k={k}) disagrees with its plain version: "
                        f"max abs err {float(err.max())}, rtol {rtol}, "
                        f"atol {atol}")
            nbytes, ops, sfu = io[name]
            bound_ms, bound_by = bound(nbytes, ops)
            ms = cuda_ms(timed[name][0])
            plain_ms = cuda_ms(timed[name][1], reps=5, warmup=1)
            plan = gk.launch_plan(N, Z.shape[1], n_sm,
                                  alphas.shape[0] if name == "glm_trial_loss"
                                  else 0)
            sym = kernel_symbol(name, k)
            regs, spill = next((v for f, v in ptxas.items() if sym in f),
                               (None, None))
            rows[(name, k)] = {
                "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "sfu_bound_ms": sfu / sfu_per_ms, "bytes": nbytes,
                "ops": ops, "plan": plan, "registers": regs,
                "spill_bytes": spill}
            print(f"  {name:15s} k={k:2d}: {ms:.4f} ms (plain {plain_ms:.4f}"
                  f" ms, bound {bound_ms:.4f} ms by {bound_by}, SFU "
                  f"{sfu / sfu_per_ms:.4f} ms, bound/time "
                  f"{bound_ms / ms:.3f}, SFU/time {sfu / sfu_per_ms / ms:.3f}"
                  f"), max abs err {max_abs:.3g}, bitwise repeatable")
            print(f"    plan grid {plan['grid']} block {plan['block']} "
                  f"S {plan['splits']} scratch {plan['scratch']}; {sym}: "
                  f"{regs} registers, {spill} bytes spilled")
        del Z, Zp, wT, y, alphas, loss, G, trials, loss_p, G_p, trials_p
        torch.cuda.empty_cache()
    return rows


def mnist_like(seed: int, n: int = N_SVM):
    """MNIST-shaped data: n 28x28 images (d=784) of 10 balanced classes,
    float32 pixels in [0, 1], ~19% of them non-zero (mean ~0.13, as
    MNIST's).  Each class is a prototype of three blurred strokes; an
    image is its class's prototype shifted by up to 2 pixels, dimmed at
    random, with noise, and dark pixels cut to 0.  An rbf SVC separates
    the classes to ~0.7 accuracy: neither at a glance nor at chance."""
    rng = np.random.default_rng(seed)
    side = 28
    yy, xx = np.mgrid[0:side, 0:side]
    protos = np.zeros((K_SVM, side, side))
    for c in range(K_SVM):
        for _ in range(3):
            p0, p1 = rng.uniform(6, 22, 2), rng.uniform(6, 22, 2)
            for t in np.linspace(0.0, 1.0, 16):
                cx, cy = p0 + t * (p1 - p0)
                protos[c] += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 3.0)
        protos[c] /= protos[c].max()
    y = rng.permutation(np.arange(n) % K_SVM)
    X = np.empty((n, side, side))
    shifts = rng.integers(-2, 3, (n, 2))
    for dy, dx in {tuple(sh) for sh in shifts}:
        m = (shifts[:, 0] == dy) & (shifts[:, 1] == dx)
        X[m] = np.roll(protos[y[m]], (dy, dx), axis=(1, 2))
    X *= rng.uniform(0.6, 1.0, (n, 1, 1))
    X += 0.45 * rng.standard_normal((n, side, side))
    X = np.clip(X, 0.0, 1.0)
    X[X < 0.45] = 0.0
    return X.reshape(n, D_SVM).astype(np.float32), y


def svm_step_inputs(seed: int, M: int = SVM_ROWS, n: int = N_SVM):
    """Inputs of one S2 step at phase 8's shape: signed pair labels (-1,
    0, +1), box bounds with zeros outside a subproblem, feasible iterates
    and a product V of an rbf kernel's scale."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand((M, n), generator=g, device="cuda")
    yb = torch.where(u < 0.1, 0.0, torch.where(u < 0.55, -1.0, 1.0))
    bound = 10.0 * (torch.rand((M, n), generator=g, device="cuda") < 0.8
                    ).float() * (yb != 0)
    z = torch.rand((M, n), generator=g, device="cuda") * bound
    x = torch.rand((M, n), generator=g, device="cuda") * bound
    V = 30.0 * torch.randn((M, n), generator=g, device="cuda")
    target = 0.2 * bound.sum(dim=1)
    step = torch.tensor(1.0 / 3000.0, device="cuda")
    return V, z, x, yb, bound, target, step


def svm_pair_inputs(seed: int, C: float = 10.0, folds: int = N_FOLDS,
                    k: int = K_SVM, n: int = N_SVM):
    """Inputs of one S2 step with phase 8's structure: 10 balanced classes
    and 5 folds give 225 (fold, class pair) rows, each holding +1 / -1 on
    its pair's two classes and a bound C on the fold's training rows, so
    ~2/10 x 4/5 = 16% of a row's elements can move; feasible iterates and
    a product V of an rbf kernel's scale, as `svm_step_inputs`."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randperm(n, generator=g, device="cuda") % k
    fold = torch.randperm(n, generator=g, device="cuda") % folds
    pairs = [(a, b) for a in range(k) for b in range(a + 1, k)]
    ca = torch.tensor([a for a, _ in pairs], device="cuda")
    cb = torch.tensor([b for _, b in pairs], device="cuda")
    yb = ((y[None, :] == ca[:, None]).float()
          - (y[None, :] == cb[:, None]).float())               # (45, n)
    train = fold[None, :] != torch.arange(folds, device="cuda")[:, None]
    yb = yb.repeat(folds, 1)                                   # fold-major
    bound = C * (yb != 0) * train.repeat_interleave(len(pairs), 0)
    M = yb.shape[0]
    z = torch.rand((M, n), generator=g, device="cuda") * bound
    x = torch.rand((M, n), generator=g, device="cuda") * bound
    V = 30.0 * torch.randn((M, n), generator=g, device="cuda")
    target = 0.2 * bound.sum(dim=1)
    step = torch.tensor(1.0 / 3000.0, device="cuda")
    return V, z, x, yb.contiguous(), bound.float().contiguous(), target, step


def svm_ops(kind: str, M: int = SVM_ROWS, n: int = N_SVM,
            kept: int = None):
    """Floating-point operations (a transcendental counts as one) of S1 on
    an (n, n) product, or of one S2 step over (M, n) whose bisection sums
    `kept` elements (all M n where None)."""
    if kind == "rbf":
        # per value: mul, add, add, max, mul, exp (the norms are G's
        # diagonal)
        return 6 * n * n
    if kind == "poly":
        return 3 * n * n                      # mul, add, pow
    # S2: the gradient step (4) and the bracket's maxima (2) of every
    # element; 40 bisection steps over the kept ones (mul, sub, 2
    # compares, mul-add: 5; NuSVC's two halves 8); the last pass over
    # every element (the gradient step again 4, clip 3, momentum 3,
    # |x'-z| max 2, w' 1: 13)
    kept = M * n if kept is None else kept
    return (4 + 2 + 13) * M * n + 40 * (5 if kind == "svc" else 8) * kept


def svm_symbol(name: str, variant) -> str:
    """Part of the mangled name of an S1/S2 kernel instantiation (S1: rbf's
    cooperative kernel or poly's and sigmoid's, 16 bytes a thread; S2:
    its mode's, the staged plan)."""
    if name == "svm_gram_epilogue":
        return ("gram_rbfILb1E" if variant == 1 else
                f"gram_elementwiseILi{variant}ELb1E")
    return f"dual_stepILi{int(variant == 'nu')}ELb1E"


def short_name(kernel: str) -> str:
    """A profiler's kernel name without its namespace and arguments."""
    m = re.search(r"(\w+(<[^>(]*>)?)\(", kernel)
    return m.group(1) if m else kernel[:40]


def s1_times(fn) -> dict:
    """S1's wrapper timed three ways (`three_times`: `ms` is the CUDA
    graph's) and its device time a call split by kernel (`split`)."""
    return {**three_times(fn, graph_reps=20), "split": device_split(fn)}


def s1_times_text(t: dict) -> str:
    split = ", ".join(f"{short_name(name)} {ms:.4f}"
                      for name, ms in sorted(t["split"].items()))
    return (f"graph {t['ms']:.4f} ms, events {t['events_ms']:.4f} ms, host "
            f"{t['host_us']:.1f} us a call; device ms a call by kernel: "
            f"{split}")


def phase_svm_kernels(seed: int, ptxas: dict):
    """S1 (rbf, poly) and S2 (SVC, NuSVC) against their plain versions at
    phase 8's shapes: times, bounds, launch plans, registers, and two
    launches giving the same bits.  Returns {(name, variant): row}."""
    import torch

    from spark_sklearn_tpu_torch.ops import svm_kernels as svk

    rows = {}
    X = torch.as_tensor(mnist_like(seed)[0], device="cuda")
    gamma = 1.0 / (D_SVM * float(X.var()))
    G = X @ X.T
    for kind, (g, deg, c0) in (("rbf", (gamma, 3, 0.0)),
                               ("poly", (gamma, 3, 0.0))):
        got = svk.gram_epilogue(G.clone(), X, X, kind, g, deg, c0)
        again = svk.gram_epilogue(G.clone(), X, X, kind, g, deg, c0)
        want = svk.gram_epilogue_plain(G.clone(), X, X, kind, g, deg, c0)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"S1 {kind}: two launches differ")
        err = (got - want).abs()
        # tolerance: rtol 1e-5, atol 1e-6 (the kernel's norms are the
        # product's diagonal, the plain version's are summed apart;
        # expf/powf round by a few ulp)
        if not bool((err <= 1e-6 + 1e-5 * want.abs()).all()):
            raise AssertionError(f"S1 {kind} disagrees with its plain "
                                 f"version: max abs err {float(err.max())}")
        if kind == "rbf" and not bool((got.diagonal() == 1.0).all()):
            raise AssertionError("S1 rbf: a diagonal value is not 1")
        work = G.clone()
        times = s1_times(lambda: svk.gram_epilogue(work, X, X, kind, g, deg,
                                                   c0))
        ms = times["ms"]
        plain_ms = cuda_ms(lambda: svk.gram_epilogue_plain(
            G, X, X, kind, g, deg, c0), reps=5, warmup=1)
        nbytes = 2 * G.nbytes
        bound_ms, bound_by = bound(nbytes, svm_ops(kind))
        variant = svk.KINDS[kind]
        regs, spill = next((v for f, v in ptxas.items()
                            if svm_symbol("svm_gram_epilogue", variant) in f),
                           (None, None))
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        plan = svk.gram_plan(N_SVM, N_SVM, kind, n_sm)
        rows[("svm_gram_epilogue", kind)] = {
            "max_abs_err": float(err.max()), **times, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": svm_ops(kind), "plan": plan, "registers": regs,
            "spill_bytes": spill}
        print(f"  S1 svm_gram_epilogue {kind:4s} n={N_SVM}: {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by}, bound/time {bound_ms / ms:.3f}), max abs err "
              f"{float(err.max()):.3g}, bitwise repeatable; plan grid "
              f"{plan}; {regs} registers, {spill} bytes "
              f"spilled; {s1_times_text(times)}")
        del got, again, want, work, err
    del G

    # the prediction route: K(X[:2000], X) at the grid's middle gamma, the
    # norms summed apart by the row-norms kernel (tolerance as above)
    X1 = X[:N_SVM_CHECK]
    G = X1 @ X.T
    got = svk.gram_epilogue(G.clone(), X1, X, "rbf", gamma, 3, 0.0)
    again = svk.gram_epilogue(G.clone(), X1, X, "rbf", gamma, 3, 0.0)
    want = svk.gram_epilogue_plain(G.clone(), X1, X, "rbf", gamma, 3, 0.0)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("S1 rbf predict: two launches differ")
    err = (got - want).abs()
    if not bool((err <= 1e-6 + 1e-5 * want.abs()).all()):
        raise AssertionError(f"S1 rbf predict disagrees with its plain "
                             f"version: max abs err {float(err.max())}")
    work = G.clone()
    times = s1_times(lambda: svk.gram_epilogue(work, X1, X, "rbf", gamma, 3,
                                               0.0))
    ms = times["ms"]
    plain_ms = cuda_ms(lambda: svk.gram_epilogue_plain(
        G, X1, X, "rbf", gamma, 3, 0.0), reps=5, warmup=1)
    # reads G, X1 and X (the norms), writes K
    nbytes = 2 * G.nbytes + X1.nbytes + X.nbytes
    # the epilogue's 6 operations a value, and 2 a pixel for the norms
    ops = 6 * G.numel() + 2 * (X1.numel() + X.numel())
    bound_ms, bound_by = bound(nbytes, ops)
    rows[("svm_gram_epilogue", "rbf_predict")] = {
        "max_abs_err": float(err.max()), **times, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "ops": ops, "shape": {"n1": N_SVM_CHECK, "n2": N_SVM, "d": D_SVM}}
    print(f"  S1 svm_gram_epilogue rbf  ({N_SVM_CHECK}, {N_SVM}), norms "
          f"summed apart: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by}, bound/time "
          f"{bound_ms / ms:.3f}), max abs err {float(err.max()):.3g}, "
          f"bitwise repeatable; {s1_times_text(times)}")
    del got, again, want, work, err, G, X1, X
    torch.cuda.empty_cache()

    # S2 on phase 8's structure (10 classes x 5 folds: 225 pair rows, 16%
    # of the elements free; the rows phase 8 runs) and on phase 3's inputs
    # of `svm_step_inputs` (65% free), each for SVC and NuSVC
    for population, inputs in (("pairs", svm_pair_inputs(seed)),
                               ("", svm_step_inputs(seed))):
        V, z, x, yb, bnd, target, step = inputs
        kept = int(((bnd != 0) & (yb != 0)).sum())
        for mode in ("svc", "nu"):
            rows[("svm_dual_step", f"{mode}_{population}".strip("_"))] = \
                s2_row(mode, V, z, x, yb, bnd, target, step, kept, ptxas)
        del V, z, x, yb, bnd, target, step
    torch.cuda.empty_cache()
    return rows


def s2_row(mode, V, z, x, yb, bnd, target, step, kept, ptxas):
    """S2 against its plain version on one population: two launches and
    the staged and streamed plans bitwise equal, the tolerances, times,
    bounds and registers."""
    import torch

    from spark_sklearn_tpu_torch.ops import svm_kernels as svk
    M, n = z.shape
    tgt = target if mode == "nu" else None
    got = svk.dual_step(V, z, x, yb, bnd, step, 0.4, tgt)
    again = svk.dual_step(V, z, x, yb, bnd, step, 0.4, tgt)
    want = svk.dual_step_plain(V, z, x, yb, bnd, step, 0.4, tgt)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"S2 {mode}: two launches differ")
    # tolerance: atol 1e-5 on x', z', w' (the bisection's block sums add
    # in another order than torch's), 1e-5/step on the residual; rtol
    # 1e-5 on all four
    errs = []
    for a, b, atol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-5 / float(step))):
        err = (a - b).abs()
        errs.append(float(err.max()))
        if not bool((err <= atol + 1e-5 * b.abs()).all()):
            raise AssertionError(
                f"S2 {mode} disagrees with its plain version: max abs "
                f"err {float(err.max())}, atol {atol}")
    max_abs, resid_err = max(errs[:3]), errs[3]
    # the streamed plan, forced at this n: the same bits, and its time
    streamed = svk.dual_step(V, z, x, yb, bnd, step, 0.4, tgt,
                             plan="streamed")
    if not all(torch.equal(a, b) for a, b in zip(got, streamed)):
        raise AssertionError(f"S2 {mode}: the plans differ")
    # the kernel alone (a CUDA graph's replay: on the pipeline's rows the
    # wrapper takes longer on the host than the kernel on the card), and
    # between events around wrapper calls, as the earlier rows were timed
    ms = graph_ms(lambda: svk.dual_step(V, z, x, yb, bnd, step, 0.4, tgt))
    events_ms = cuda_ms(lambda: svk.dual_step(V, z, x, yb, bnd, step, 0.4,
                                              tgt))
    streamed_ms = cuda_ms(lambda: svk.dual_step(
        V, z, x, yb, bnd, step, 0.4, tgt, plan="streamed"))
    plain_ms = cuda_ms(lambda: svk.dual_step_plain(
        V, z, x, yb, bnd, step, 0.4, tgt), reps=5, warmup=1)
    nbytes = (V.nbytes + z.nbytes + x.nbytes + yb.nbytes + bnd.nbytes
              + 3 * z.nbytes + got[3].nbytes + step.nbytes
              + (target.nbytes if tgt is not None else 0))
    ops = svm_ops(mode, M, n, kept)
    bound_ms, bound_by = bound(nbytes, ops)
    regs, spill = next((v for f, v in ptxas.items()
                        if svm_symbol("svm_dual_step", mode) in f),
                       (None, None))
    plan = {"grid": M, **svk.step_plan(n)}
    print(f"  S2 svm_dual_step {mode:3s} M={M} n={n}, {kept / (M * n):.3f} "
          f"kept: {ms:.4f} ms staged ({events_ms:.4f} ms between "
          f"events), {streamed_ms:.4f} ms streamed (same "
          f"bits; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}, bound/time {bound_ms / ms:.3f}), max abs err "
          f"{max_abs:.3g} (x', z', w'), "
          f"{resid_err:.3g} (residual, values "
          f"~{float(want[3].abs().max()):.3g}), bitwise repeatable; plan "
          f"{plan}; {regs} registers, {spill} bytes spilled")
    return {"max_abs_err": max_abs, "resid_max_abs_err": resid_err,
            "ms": ms, "events_ms": events_ms, "streamed_ms": streamed_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "kept": kept / (M * n),
            "plan": plan, "registers": regs, "spill_bytes": spill}


def phase_pipeline_svm_kernels(seed: int, ptxas: dict):
    """S1 and S2 against their plain versions at phase 11's StandardScaler
    + SVC path's shapes, on its data: the first StratifiedKFold(3) fold
    of 2000 MNIST-shaped rows, scaled by the port's StandardScaler step
    fitted on the fold's training rows (the fold's X_folds row), its
    kernel matrix at the fold's gamma="scale", and one S2 step of its 45
    pair subproblems at C=1 from iterates drawn inside the box.  Same
    tolerances as phase 8's rows.  Returns {(name, variant): row}."""
    import torch

    from spark_sklearn_tpu_torch.models import preprocessing as prep
    from spark_sklearn_tpu_torch.models import svm as svm_family
    from spark_sklearn_tpu_torch.ops import svm_kernels as svk
    from spark_sklearn_tpu_torch.search.cv import StratifiedKFold

    rows = {}
    Xs, ys = mnist_like(seed, N_SVM_CHECK)
    train, _ = next(StratifiedKFold(3).split(Xs, ys))
    X = torch.as_tensor(Xs, device="cuda")
    w = torch.zeros((1, N_SVM_CHECK), device="cuda")
    w[0, torch.as_tensor(train, device="cuda")] = 1.0
    scaler = prep.StandardScalerStep
    X_folds = scaler.apply({}, scaler.fit({}, X, w), X)
    gamma = svm_family._fold_scale_gamma(X_folds, w)[0]
    Xf = X_folds[0]
    G = Xf @ Xf.T

    def check(name, variant, got, again, want, atols, nbytes, ops, fn,
              plain, sym, shape):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} ({variant}): two launches differ")
        errs = []
        for a, b, atol in zip(got, want, atols):
            err = (a - b).abs()
            errs.append(float(err.max()))
            if not bool((err <= atol + 1e-5 * b.abs()).all()):
                raise AssertionError(
                    f"{name} ({variant}) disagrees with its plain version: "
                    f"max abs err {errs[-1]}, atol {atol}, rtol 1e-5")
        times = s1_times(fn)
        ms = times["ms"]
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        bound_ms, bound_by = bound(nbytes, ops)
        regs, spill = next((v for f, v in ptxas.items() if sym in f),
                           (None, None))
        rows[(name, variant)] = {
            "max_abs_err": max(errs[:3]), **times, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "registers": regs, "spill_bytes": spill,
            "shape": shape}
        if len(errs) > 3:
            rows[(name, variant)]["resid_max_abs_err"] = errs[3]
        print(f"  {name} {variant} {shape}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
              f"bound/time {bound_ms / ms:.3f}), max abs err {errs}, "
              f"bitwise repeatable; {regs} registers, {spill} bytes "
              f"spilled; {s1_times_text(times)}")

    def s1(g0):
        return [svk.gram_epilogue(g0.clone(), Xf, Xf, "rbf", gamma, 3, 0.0)]

    work = G.clone()
    check("svm_gram_epilogue", "rbf_pipeline", s1(G), s1(G),
          [svk.gram_epilogue_plain(G.clone(), Xf, Xf, "rbf", gamma, 3, 0.0)],
          [1e-6], 2 * G.nbytes, svm_ops("rbf", n=N_SVM_CHECK),
          lambda: svk.gram_epilogue(work, Xf, Xf, "rbf", gamma, 3, 0.0),
          lambda: svk.gram_epilogue_plain(G, Xf, Xf, "rbf", gamma, 3, 0.0),
          svm_symbol("svm_gram_epilogue", svk.KINDS["rbf"]),
          {"n": N_SVM_CHECK, "d": D_SVM, "gamma": gamma})
    K = s1(G)[0]
    del work, G

    pairs = torch.as_tensor(svm_family._pairs(K_SVM), device="cuda").long()
    yb, in_pair = svm_family._pair_labels(
        torch.as_tensor(ys, device="cuda"), pairs, K_SVM, torch.float32)
    bnd = w * in_pair                                        # C = 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.rand(bnd.shape, generator=gen, device="cuda") * bnd
    x = torch.rand(bnd.shape, generator=gen, device="cuda") * bnd
    V = (z * yb) @ K
    step = svm_family._power_step(K)
    M = bnd.shape[0]

    kept = int(((bnd != 0) & (yb != 0)).sum())
    rows[("svm_dual_step", "svc_pipeline")] = {
        **s2_row("svc", V, z, x, yb, bnd, None, step, kept, ptxas),
        "shape": {"M": M, "n": N_SVM_CHECK, "mode": "svc"}}
    del K, V, z, x, yb, bnd
    torch.cuda.empty_cache()
    return rows


def digits_like(seed: int):
    """Digits-shaped data: n=1797, d=64, 10 balanced classes, float32 in
    [0, 1] on a 1/16 grid (like sklearn's digits / 16)."""
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(N) % K)
    centers = rng.uniform(0.0, 1.0, (K, D))
    X = centers[y] + 0.8 * rng.standard_normal((N, D))
    X = np.round(np.clip(X, 0.0, 1.0) * 16.0) / 16.0
    return X.astype(np.float32), y


def search(X, y, Cs, device):
    from spark_sklearn_tpu_torch import (
        GridSearchCV, LogisticRegression, StratifiedKFold, TorchConfig)
    return GridSearchCV(
        LogisticRegression(max_iter=100), {"C": Cs},
        cv=StratifiedKFold(N_FOLDS), refit=False,
        config=TorchConfig(device=device)).fit(X, y)


def profile_busy(run, warm: float, iters: int, out_name: str,
                 with_kernels: bool = False, top: int = 12,
                 primed: bool = False, host: bool = True):
    """Profile one `run()` and print the device's busy time against the
    warm wall `warm` (idle share), per solver iteration where `iters` > 1,
    and the largest `top` kernels; the time and count of every kernel go to
    chiprun_out/`out_name`.  Returns the kernels' busy seconds (and, with
    `with_kernels`, {kernel name: (device ns, launches)}).

    The device events are summed from the profiler's raw records: the
    profiler's own per-op tables take tens of seconds to build over the
    ~10^5 events of a 1000-iteration solve.  With `primed` the profile
    runs `run()` twice, a marker kernel between, and counts the device
    events after the marker: a single profiled run of a short search has
    come back without its first tens of ms of device events (phase 12's
    KNN searches), which a run of seconds hardly notices.  `host=False`
    records the device's activity alone: a run of 10^5 eager launches
    then profiles in about its own time instead of several times it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=([ProfilerActivity.CPU] if host else [])
                 + [ProfilerActivity.CUDA]) as prof:
        if primed:
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)            # the marker: a spin kernel
            torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if primed:
        marks = [e for e in events if "spin_kernel" in e.name()]
        after = (marks[0].start_ns() + marks[0].duration_ns() if marks
                 else float("inf"))
        # without its marker the second run cannot be told apart: no
        # device time is then counted (busy reads "not measured")
        events = [e for e in events if e.start_ns() >= after]
    by_name = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy_s = sum(ns for ns, _ in by_name.values()) / 1e9
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        for name, (ns, count) in kernels:
            f.write(f"{ns / 1e6:12.3f} ms {count:8d}x  {name}\n")
    if busy_s > 0:
        per_iter = (f"; per iteration {busy_s / iters * 1e3:.3f} ms busy, "
                    f"{(warm - busy_s) / iters * 1e3:.3f} ms idle"
                    if iters > 1 else "")
        print(f"  profiled: kernels busy {busy_s:.4f} s against the warm "
              f"wall {warm:.4f} s: idle share {1 - busy_s / warm:.4f}"
              f"{per_iter}")
    else:
        print("  profiled: no device time recorded (idle share not "
              "measured)")
    for name, (ns, count) in kernels[:top]:
        print(f"    {ns / 1e6:10.3f} ms  {count:6d}x  {name[:90]}")
    print(f"    (profiled run {t_run:.1f} s, whole profile "
          f"{time.perf_counter() - t0:.1f} s)")
    if with_kernels:
        return busy_s, by_name
    return busy_s


def phase_main(X, y, Cs):
    """The headline search on cuda: cold, then warm, then profiled."""
    import torch

    from spark_sklearn_tpu_torch.ops import glm_kernels as gk

    gk.reset_launches()
    t0 = time.perf_counter()
    gs = search(X, y, Cs, "cuda")
    cold = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)

    scores = gs.cv_results_["mean_test_score"]
    if not np.all(np.isfinite(scores)):
        raise AssertionError("non-finite scores on the main path")
    if not gs.best_score_ > 0.5:                   # chance is 0.1
        raise AssertionError(f"best_score_ {gs.best_score_} near chance")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs = search(X, y, Cs, "cuda")
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_iter = [c["n_iter_exec"] for c in gs.chunks_]
    fits = N_C * N_FOLDS
    print(f"  cold {cold:.3f} s, warm {warm:.3f} s, {fits / warm:.1f} fits/s"
          f", n_iter per chunk {n_iter}, lanes per chunk "
          f"{[c['lanes'] for c in gs.chunks_]}, peak memory "
          f"{peak / 2**20:.1f} MiB, best_score_ {gs.best_score_:.4f}, "
          f"launches {launches}")

    busy_s = profile_busy(lambda: search(X, y, Cs, "cuda"), warm,
                          sum(n_iter), "chip_smoke_profile.txt")
    return {"cold_s": cold, "warm_s": warm, "fits_per_s": fits / warm,
            "n_iter": n_iter, "peak_bytes": peak, "launches": launches,
            "device_busy_s": busy_s, "best_score": float(gs.best_score_)}


def phase_agreement(X, y, Cs):
    """cuda against the CPU (the kernels' plain versions) on a small grid,
    10-class and binary: mean_test_score within 5e-3 (the repo's oracle
    bound), equal best_params_."""
    for label, (Xs, ys) in (("10-class", (X, y)),
                            ("binary", (X[y < 2], y[y < 2]))):
        g = search(Xs, ys, Cs, "cuda")
        c = search(Xs, ys, Cs, "cpu")
        diff = np.abs(g.cv_results_["mean_test_score"]
                      - c.cv_results_["mean_test_score"]).max()
        print(f"  {label}: max |cuda - cpu| mean_test_score {diff:.3g}, "
              f"best_params_ {g.best_params_} / {c.best_params_}")
        if not diff <= 5e-3:
            raise AssertionError(f"{label}: cuda and cpu scores differ by "
                                 f"{diff}")
        if g.best_params_ != c.best_params_:
            raise AssertionError(f"{label}: best_params_ differ")


def weights(seed: int, n: int):
    """Sample weights uniform in [0.25, 3), made from `seed`."""
    return np.random.default_rng(seed + 7).uniform(0.25, 3.0, n)


def phase_weighted(X, y, Cs, seed: int, main_run: dict):
    """The headline search weighted: cuda (cold with K2's and K4's
    launches, warm, profiled) beside phase 4's unweighted walls; cuda
    against the CPU on phase 5's grid, searched and refit on both, the
    refit's surface compared."""
    from spark_sklearn_tpu_torch import (
        GridSearchCV, LogisticRegression, StratifiedKFold, TorchConfig)
    from spark_sklearn_tpu_torch.ops import glm_kernels as gk

    sw = weights(seed, len(y))

    def run(device, grid=Cs, refit=False):
        return GridSearchCV(
            LogisticRegression(max_iter=100), {"C": grid},
            cv=StratifiedKFold(N_FOLDS), refit=refit,
            config=TorchConfig(device=device)).fit(X, y, sample_weight=sw)

    gk.reset_launches()
    t0 = time.perf_counter()
    g = run("cuda")
    cold = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the weighted "
                                 "headline")
    t0 = time.perf_counter()
    g = run("cuda")
    warm = time.perf_counter() - t0
    n_iter = [c["n_iter_exec"] for c in g.chunks_]
    busy = profile_busy(lambda: run("cuda"), warm, sum(n_iter),
                        "chip_smoke_weighted.txt")
    if not np.all(np.isfinite(g.cv_results_["mean_test_score"])):
        raise AssertionError("weighted headline: non-finite scores")
    # against the CPU on phase 5's 20 C, refit on both: over all 1000 the
    # CPU's search takes ~12 minutes on an 8-core host, and lanes short of
    # convergence at max_iter=100 move their scores by up to ~0.01 between
    # the devices
    sub = Cs[::50]
    gs_sub = run("cuda", sub, True)
    t0 = time.perf_counter()
    c = run("cpu", sub, True)
    cpu_s = time.perf_counter() - t0
    diff = float(np.abs(gs_sub.cv_results_["mean_test_score"]
                        - c.cv_results_["mean_test_score"]).max())
    print(f"  weighted headline: cold {cold:.3f} s, warm {warm:.3f} s "
          f"(unweighted {main_run['warm_s']:.3f} s), busy {busy:.4f} s "
          f"(unweighted {main_run['device_busy_s']:.4f} s), launches "
          f"{launches}, best index {g.best_index_}, best_score_ "
          f"{g.best_score_:.4f}; on {len(sub)} C: best index "
          f"{gs_sub.best_index_} (cpu {c.best_index_}, {cpu_s:.1f} s), "
          f"max |cuda - cpu| mean_test_score {diff:.3g}")
    if not diff <= 5e-3:
        raise AssertionError(f"weighted headline: cuda and cpu scores "
                             f"differ by {diff}")
    if gs_sub.best_index_ != c.best_index_:
        raise AssertionError(f"weighted headline: best index "
                             f"{gs_sub.best_index_} on cuda, "
                             f"{c.best_index_} on the CPU")
    # the refit's surface on the card against the CPU's
    surface = {}
    for name in ("decision_function", "predict_log_proba"):
        surface[name] = float(np.abs(getattr(gs_sub, name)(X)
                                     - getattr(c, name)(X)).max())
        if not surface[name] <= 1e-3:
            raise AssertionError(f"weighted refit {name}: cuda and cpu "
                                 f"differ by {surface[name]}")
    surface["score"] = (gs_sub.score(X, y), c.score(X, y))
    if abs(surface["score"][0] - surface["score"][1]) > 5e-3:
        raise AssertionError(f"weighted refit score: {surface['score']}")
    if gs_sub.best_params_ != c.best_params_ or \
            list(gs_sub.classes_) != list(range(K)):
        raise AssertionError("weighted refit: best_params_ or classes_")
    print(f"  weighted refit on {len(sub)} C: best_params_ "
          f"{gs_sub.best_params_}, |cuda - cpu| decision_function "
          f"{surface['decision_function']:.3g}, predict_log_proba "
          f"{surface['predict_log_proba']:.3g}, score "
          f"{surface['score'][0]:.4f} / {surface['score'][1]:.4f}")
    return {"cold_s": cold, "warm_s": warm, "device_busy_s": busy,
            "launches": launches, "cpu_s": cpu_s,
            "best_index": int(g.best_index_),
            "best_index_20c": int(gs_sub.best_index_),
            "max_abs_diff_cpu_20c": diff,
            "unweighted_warm_s": main_run["warm_s"],
            "unweighted_busy_s": main_run["device_busy_s"],
            "refit_surface": surface}


def california_like(seed: int):
    """California-Housing-shaped data: n=20640, d=8 features at the
    dataset's spread of scales (means and spreads of MedInc, HouseAge,
    AveRooms, AveBedrms, Population in thousands, AveOccup, Latitude,
    Longitude), float32, and a target linear in X plus noise (mean ~2,
    in units of $100k).  The rows come in five blocks of regions, as the
    real rows are grouped by place, so KFold(5) without shuffling is a
    split by region; AveOccup's effect changes sign between regions,
    which makes shrinkage pay on the held-out region and gives the
    searches a well-separated best candidate rather than a near-tie."""
    rng = np.random.default_rng(seed)
    mean = np.array([3.87, 28.6, 5.43, 1.10, 1.4255, 3.07, 35.63, -119.57])
    std = np.array([1.90, 12.59, 2.47, 0.47, 1.1325, 1.39, 2.14, 2.00])
    X = mean + std * rng.standard_normal((N_REG, D_REG))
    coef = np.array([0.44, 0.0097, -0.107, 0.645, -0.004, -0.0038, -0.42,
                     -0.43])
    region = np.arange(N_REG) * N_FOLDS // N_REG
    flip = np.array([1.0, -1.0, 1.0, -1.0, 0.0])[region]
    y = (-36.9 + X @ coef + 0.3 * flip * (X[:, 5] - mean[5])
         + 0.72 * rng.standard_normal(N_REG))
    return X.astype(np.float32), y.astype(np.float32)


def regressor_searches():
    """(label, estimator, full grid, the subsample checked against the
    CPU, r2 tolerance of that check)."""
    from spark_sklearn_tpu_torch import ElasticNet, LinearRegression, Ridge
    alphas = np.logspace(-3, 3, 1000)
    en = {"alpha": np.logspace(-4, 0, 100),
          "l1_ratio": [0.1, 0.5, 0.7, 0.9, 1.0]}
    return [
        ("Ridge", Ridge(), {"alpha": alphas}, {"alpha": alphas[::50]},
         1e-6),
        ("LinearRegression", LinearRegression(),
         {"fit_intercept": [True, False]},
         {"fit_intercept": [True, False]}, 1e-6),
        ("ElasticNet", ElasticNet(max_iter=1000), en,
         {"alpha": en["alpha"][::10], "l1_ratio": en["l1_ratio"]}, 1e-3),
    ]


def reg_search(est, grid, X, y, device):
    from spark_sklearn_tpu_torch import GridSearchCV, KFold, TorchConfig
    return GridSearchCV(est, grid, cv=KFold(N_FOLDS), scoring=REG_SCORING,
                        refit="r2", config=TorchConfig(device=device)
                        ).fit(X, y)


def phase_regressors(seed: int):
    """Each regressor search on cuda, cold then warm, refit on r2 on the
    device; then cuda against the CPU on a subsample of its grid:
    mean_test_r2 within the stated tolerance (1e-6 in float64, 1e-3 for
    the float32 ElasticNet) and equal best_params_."""
    import torch

    X, y = california_like(seed)
    out = {}
    for label, est, grid, sub, tol in regressor_searches():
        n_cand = int(np.prod([len(v) for v in grid.values()]))
        t0 = time.perf_counter()
        gs = reg_search(est, grid, X, y, "cuda")
        cold = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gs = reg_search(est, grid, X, y, "cuda")
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for s in REG_SCORING:
            v = gs.cv_results_[f"mean_test_{s}"]
            if v.shape != (n_cand,) or not np.all(np.isfinite(v)):
                raise AssertionError(f"{label}: mean_test_{s} is not "
                                     f"{n_cand} finite values")
        best = gs.best_estimator_
        pred = best.predict(X[:100])
        if best.device != "cuda" or pred.shape != (100,) or \
                not np.all(np.isfinite(pred)):
            raise AssertionError(f"{label}: refit on the device failed")
        if not gs.best_score_ > 0.5:
            raise AssertionError(f"{label}: best r2 {gs.best_score_}")
        fits = n_cand * N_FOLDS
        print(f"  {label}: {n_cand} candidates x {N_FOLDS} folds, cold "
              f"{cold:.3f} s, warm {warm:.3f} s, {fits / warm:.1f} fits/s, "
              f"peak memory {peak / 2**20:.1f} MiB, chunks "
              f"{[c['lanes'] for c in gs.chunks_]}, best {gs.best_params_} "
              f"r2 {gs.best_score_:.6f}, refit {gs.refit_time_:.3f} s")
        busy = profile_busy(lambda: reg_search(est, grid, X, y, "cuda"),
                            warm, est.get_params().get("max_iter", 1),
                            f"chip_smoke_{label}.txt")
        g = reg_search(est, sub, X, y, "cuda")
        t0 = time.perf_counter()
        c = reg_search(est, sub, X, y, "cpu")
        cpu_s = time.perf_counter() - t0
        diff = float(np.abs(g.cv_results_["mean_test_r2"]
                            - c.cv_results_["mean_test_r2"]).max())
        top = np.sort(c.cv_results_["mean_test_r2"])[::-1]
        gap = float(top[0] - top[1]) if len(top) > 1 else None
        print(f"    cuda against cpu on {len(c.cv_results_['params'])} "
              f"candidates: max |d mean_test_r2| {diff:.3g} (tolerance "
              f"{tol:g}), best_params_ {g.best_params_} / {c.best_params_}"
              f", gap to the second best {gap}; the CPU run {cpu_s:.1f} s")
        if not diff <= tol:
            raise AssertionError(f"{label}: cuda and cpu r2 differ by {diff}")
        if g.best_params_ != c.best_params_:
            raise AssertionError(f"{label}: best_params_ differ")
        out[label] = {"cold_s": cold, "warm_s": warm,
                      "fits_per_s": fits / warm, "peak_bytes": peak,
                      "device_busy_s": busy,
                      "best_params": {k: float(v) for k, v in
                                      gs.best_params_.items()},
                      "best_r2": float(gs.best_score_),
                      "cuda_cpu_max_abs_r2": diff, "cpu_best_gap": gap}
    return out


def l1_search(X, y, penalty, device, n_iter=N_L1, seed=0, scoring=None):
    from scipy.stats import loguniform

    from spark_sklearn_tpu_torch import (
        LogisticRegression, RandomizedSearchCV, StratifiedKFold,
        TorchConfig)
    est = (LogisticRegression(penalty="l1", max_iter=100)
           if penalty == "l1" else
           LogisticRegression(penalty="elasticnet", l1_ratio=0.5,
                              max_iter=100))
    return RandomizedSearchCV(
        est, {"C": loguniform(1e-2, 1e2)}, n_iter=n_iter, scoring=scoring,
        cv=StratifiedKFold(N_FOLDS), random_state=seed, refit=False,
        config=TorchConfig(device=device)).fit(X, y)


def phase_l1(X, y, seed: int):
    """The l1 and elasticnet searches on cuda (cold, warm, profiled),
    with K2's launches on this path; FISTA's per-iteration split; then
    cuda against the CPU on the first 20 candidates (the same draws),
    scored by accuracy and neg_log_loss: neg_log_loss within 5e-3 on
    every candidate, accuracy within 5e-3 and the same best candidate
    by accuracy.

    Accuracy is held only where the model is well posed: at the
    smallest C an l1 model is (nearly) all zeros and predicts by its
    intercepts, which are tied between classes of equal count, so float
    rounding breaks those ties and its accuracy (chance: 1/K) flips
    between devices.  The JAX package and the port's CPU path differ by
    the same amount there.  Such candidates (accuracy below 1.5/K) are
    held by their log loss alone."""
    import torch

    from spark_sklearn_tpu_torch.ops import glm_kernels as gk

    out = {}
    for penalty in ("l1", "elasticnet"):
        gk.reset_launches()
        t0 = time.perf_counter()
        rs = l1_search(X, y, penalty, "cuda", seed=seed)
        cold = time.perf_counter() - t0
        launches = dict(gk.LAUNCHES)
        if launches["glm_loss_grad"] == 0:
            raise AssertionError(f"{penalty}: K2 never launched on the "
                                 "FISTA path")
        scores = rs.cv_results_["mean_test_score"]
        if scores.shape != (N_L1,) or not np.all(np.isfinite(scores)):
            raise AssertionError(f"{penalty}: scores not {N_L1} finite")
        if not rs.best_score_ > 0.5:                 # chance is 0.1
            raise AssertionError(f"{penalty}: best_score_ {rs.best_score_}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rs = l1_search(X, y, penalty, "cuda", seed=seed)
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        iters = [c["n_iter_exec"] for c in rs.chunks_]
        fits = N_L1 * N_FOLDS
        print(f"  {penalty}: cold {cold:.3f} s, warm {warm:.3f} s, "
              f"{fits / warm:.1f} fits/s, FISTA iterations per chunk "
              f"{iters}, lanes {[c['lanes'] for c in rs.chunks_]}, peak "
              f"memory {peak / 2**20:.1f} MiB, launches {launches}, best "
              f"{rs.best_params_} score {rs.best_score_:.4f}")
        busy = profile_busy(lambda: l1_search(X, y, penalty, "cuda",
                                              seed=seed),
                            warm, sum(iters), f"chip_smoke_{penalty}.txt")
        out[penalty] = {"cold_s": cold, "warm_s": warm,
                        "fits_per_s": fits / warm, "fista_iters": iters,
                        "peak_bytes": peak, "launches": launches,
                        "device_busy_s": busy,
                        "best_score": float(rs.best_score_)}

    # FISTA's per-iteration split at this path's shapes: K1 (Ax), K2 on
    # the extrapolated logits, K3 (AT); the rest of the busy time per
    # iteration is the torch-op tail
    B = N_L1 * N_FOLDS
    g = torch.Generator(device="cuda").manual_seed(seed)
    Xd = torch.rand((N, D), generator=g, device="cuda")
    W = torch.randn((B * K, D), generator=g, device="cuda")
    bias = torch.randn((1, B * K), generator=g, device="cuda")
    Z, _, wT, yk, _ = kernel_inputs(K, seed, B=B)
    G2 = Z.reshape(N, B * K)
    split = {"K1_ms": cuda_ms(lambda: torch.addmm(bias, Xd, W.T)),
             "K2_ms": cuda_ms(lambda: gk.glm_loss_grad(Z, wT, yk)),
             "K3_ms": cuda_ms(lambda: (G2.T @ Xd, G2.sum(dim=0)))}
    loss, G = gk.glm_loss_grad(Z, wT, yk)
    loss_p, G_p = gk.glm_loss_grad_plain(Z, wT, yk)
    split["K2_max_abs_err"] = max(float((loss - loss_p).abs().max()),
                                  float((G - G_p).abs().max()))
    (k2_ops, _), _ = op_counts(K, B)
    split["K2_bound_ms"], split["K2_bound_by"] = bound(
        Z.nbytes + wT.nbytes + yk.nbytes + G.nbytes + loss.nbytes, k2_ops)
    split["K1_tflops"] = 2 * N * D * B * K / split["K1_ms"] / 1e9
    if not (torch.allclose(loss, loss_p, rtol=1e-5, atol=1e-6)
            and torch.allclose(G, G_p, rtol=0, atol=1e-6)):
        raise AssertionError("K2 disagrees with its plain version at the "
                             "FISTA path's shape")
    for penalty in ("l1", "elasticnet"):
        r = out[penalty]
        per_it = r["device_busy_s"] / sum(r["fista_iters"]) * 1e3
        tail = per_it - split["K1_ms"] - split["K2_ms"] - split["K3_ms"]
        r["busy_ms_per_iter"] = per_it
        r["tail_ms_per_iter"] = tail
        print(f"  {penalty} per FISTA iteration: busy {per_it:.3f} ms = K1 "
              f"{split['K1_ms']:.3f} + K2 {split['K2_ms']:.3f} + K3 "
              f"{split['K3_ms']:.3f} + torch-op tail {tail:.3f} ms")
    print(f"  K1 {split['K1_tflops']:.1f} TFLOP/s; K2 at B={B}: bound "
          f"{split['K2_bound_ms']:.4f} ms by {split['K2_bound_by']}, "
          f"bound/time {split['K2_bound_ms'] / split['K2_ms']:.3f}, max abs "
          f"err {split['K2_max_abs_err']:.3g}")
    out["split"] = split
    del Xd, W, bias, Z, wT, yk, G2, loss, G, loss_p, G_p
    torch.cuda.empty_cache()

    for penalty in ("l1", "elasticnet"):
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = l1_search(X, y, penalty, dev, n_iter=20, seed=seed,
                                 scoring=["accuracy", "neg_log_loss"]
                                 ).cv_results_
            cpu_s = time.perf_counter() - t0
        acc = {d: r["mean_test_accuracy"] for d, r in res.items()}
        d_acc = np.abs(acc["cuda"] - acc["cpu"])
        d_ll = np.abs(res["cuda"]["mean_test_neg_log_loss"]
                      - res["cpu"]["mean_test_neg_log_loss"])
        posed = acc["cpu"] >= 1.5 / K
        best = {d: r["params"][int(r["rank_test_accuracy"].argmin())]
                for d, r in res.items()}
        diff = float(d_acc[posed].max())
        print(f"  {penalty}: cuda against cpu on 20 candidates: max |d "
              f"mean_test_accuracy| {diff:.3g} on the {int(posed.sum())} "
              f"well-posed ones ({float(d_acc.max()):.3g} on all), max |d "
              f"mean_test_neg_log_loss| {float(d_ll.max()):.3g}, best "
              f"{best['cuda']} / {best['cpu']}; the CPU run {cpu_s:.1f} s")
        if not (diff <= 5e-3 and d_ll.max() <= 5e-3):
            raise AssertionError(f"{penalty}: cuda and cpu differ by "
                                 f"{diff} (accuracy), {d_ll.max()} (log "
                                 "loss)")
        if best["cuda"] != best["cpu"]:
            raise AssertionError(f"{penalty}: best candidates differ")
        out[penalty].update(cuda_cpu_max_abs=diff,
                            cuda_cpu_max_abs_all=float(d_acc.max()),
                            cuda_cpu_max_abs_log_loss=float(d_ll.max()),
                            n_well_posed=int(posed.sum()))
    return out


def svm_search(est, grid, X, y, device, folds=N_FOLDS, refit=True,
               max_tasks=None):
    from spark_sklearn_tpu_torch import (
        GridSearchCV, StratifiedKFold, TorchConfig)
    config = TorchConfig(device=device, max_tasks_per_batch=(
        max_tasks or TorchConfig.max_tasks_per_batch))
    return GridSearchCV(est, grid, cv=StratifiedKFold(folds), refit=refit,
                        config=config).fit(X, y)


def phase_svm(seed: int, kernel_rows: dict):
    """BASELINE config #2 on MNIST-shaped data: the SVC(rbf) C x gamma
    search on cuda (cold with the kernels' launch counts, warm, then
    profiled with one candidate a chunk for each candidate's steps), the
    refit SVC predicting on the card, a NuSVC search, and cuda against
    the CPU on a stratified 2000-row subset."""
    import torch

    from spark_sklearn_tpu_torch import SVC, NuSVC
    from spark_sklearn_tpu_torch.ops import glm_kernels as gk
    from spark_sklearn_tpu_torch.ops import svm_kernels as svk

    X, y = mnist_like(seed)
    gamma0 = 1.0 / (D_SVM * float(np.var(X)))
    grid = {"C": SVM_C, "gamma": [f * gamma0 for f in SVM_GAMMA]}
    n_cand = len(SVM_C) * len(SVM_GAMMA)
    fits = n_cand * N_FOLDS
    out = {}

    gk.reset_launches()
    svk.reset_launches()
    t0 = time.perf_counter()
    gs = svm_search(SVC(kernel="rbf"), grid, X, y, "cuda")
    cold = time.perf_counter() - t0
    scores = gs.cv_results_["mean_test_score"]
    if scores.shape != (n_cand,) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"SVC: scores not {n_cand} finite values")
    if not gs.best_score_ > 0.3:                     # chance is 0.1
        raise AssertionError(f"SVC: best_score_ {gs.best_score_}")
    best, refit_s = gs.best_estimator_, gs.refit_time_
    pred = best.predict(X[:N_SVM_CHECK])
    # the search, the refit and its prediction (S1 with the norms summed
    # apart)
    launches = {name: svk.LAUNCHES[name] for name in SVC_KERNELS}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the SVC path")
    refit_acc = float((pred == y[:N_SVM_CHECK]).mean())
    if best.device != "cuda" or pred.shape != y[:N_SVM_CHECK].shape or \
            not refit_acc > 0.3:
        raise AssertionError(f"SVC refit on the card: accuracy {refit_acc}")

    cold_chunks = [c["lanes"] for c in gs.chunks_]

    # warm and profiled: one candidate a chunk, so that each chunk's step
    # count is one candidate's (the default chunk holds all nine and runs
    # the same loop over them)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs = svm_search(SVC(kernel="rbf"), grid, X, y, "cuda", refit=False,
                    max_tasks=N_FOLDS)
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = [c["n_iter_exec"] for c in gs.chunks_]
    total = sum(steps)
    print(f"  SVC(rbf) {n_cand} candidates x {N_FOLDS} folds, n={N_SVM}: "
          f"cold {cold:.3f} s (chunks {cold_chunks}, refit {refit_s:.3f} s)"
          f", warm {warm:.3f} s (one candidate a chunk), {fits / warm:.2f} "
          f"fits/s, peak memory {peak / 2**20:.1f} MiB, launches {launches}")
    print(f"    best {gs.best_params_} score {gs.best_score_:.4f}; scores "
          f"{np.round(scores, 4).tolist()}; refit SVC on the card: "
          f"accuracy {refit_acc:.4f} on 2000 training rows")
    busy = profile_busy(
        lambda: svm_search(SVC(kernel="rbf"), grid, X, y, "cuda",
                           refit=False, max_tasks=N_FOLDS),
        warm, total, "chip_smoke_svc.txt")
    g = torch.Generator(device="cuda").manual_seed(seed)
    K = torch.rand((N_SVM, N_SVM), generator=g, device="cuda")
    W = torch.rand((SVM_ROWS, N_SVM), generator=g, device="cuda")
    gemm_ms = cuda_ms(lambda: W @ K)
    del K, W
    torch.cuda.empty_cache()
    s2_ms = kernel_rows[("svm_dual_step", "svc_pairs")]["ms"]
    per_step = busy / total * 1e3
    print(f"  steps per candidate {steps} ({total} in all); busy "
          f"{per_step:.4f} ms a step = ascent GEMM {gemm_ms:.4f} "
          f"({2 * SVM_ROWS * N_SVM * N_SVM / gemm_ms / 1e9:.1f} TFLOP/s) + "
          f"S2 {s2_ms:.4f} + the rest {per_step - gemm_ms - s2_ms:.4f} ms; "
          f"idle share {1 - busy / warm:.4f} of the warm wall")
    out["svc"] = {"cold_s": cold, "warm_s": warm, "fits_per_s": fits / warm,
                  "peak_bytes": peak, "launches": launches,
                  "steps_per_candidate": steps, "device_busy_s": busy,
                  "busy_ms_per_step": per_step, "gemm_ms": gemm_ms,
                  "s2_ms": s2_ms, "best_params": gs.best_params_,
                  "best_score": float(gs.best_score_),
                  "refit_accuracy": refit_acc}

    svk.reset_launches()
    t0 = time.perf_counter()
    nu = svm_search(NuSVC(), {"nu": SVM_NU}, X, y, "cuda", refit=False)
    nu_s = time.perf_counter() - t0
    nu_scores = nu.cv_results_["mean_test_score"]
    if not np.all(np.isfinite(nu_scores)) or not nu.best_score_ > 0.3:
        raise AssertionError(f"NuSVC: scores {nu_scores}")
    nu_launch = {name: svk.LAUNCHES[name] for name in SVC_KERNELS}
    if min(nu_launch.values()) == 0:
        raise AssertionError(f"NuSVC: launches {nu_launch}")
    print(f"  NuSVC nu {SVM_NU} x {N_FOLDS} folds: {nu_s:.3f} s, steps "
          f"{[c['n_iter_exec'] for c in nu.chunks_]}, scores "
          f"{np.round(nu_scores, 4).tolist()}, launches {nu_launch}")
    out["nusvc"] = {"wall_s": nu_s, "scores": nu_scores.tolist(),
                    "launches": nu_launch}

    # cuda against the CPU at a reduced size: mean_test_score within 5e-3
    # (the repo's oracle bound) and the same best candidate
    per = N_SVM_CHECK // K_SVM
    idx = np.concatenate([np.where(y == c)[0][:per] for c in range(K_SVM)])
    sub = {"C": SVM_C[:2], "gamma": [gamma0]}
    res, secs, small = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = svm_search(SVC(kernel="rbf"), sub, X[idx], y[idx], dev,
                              folds=3, refit=False)
        secs[dev] = time.perf_counter() - t0
        # the residual exit: at C = SVM_C_EXIT the dual converges (tol
        # 1e-3) well before the 300-step budget, on both devices.  Its
        # scores are printed, not held to 5e-3: where a subproblem has no
        # free support vector, libsvm's intercept rule takes the midpoint
        # of an interval whose ends move with which alphas sit within
        # 1e-6 of a bound, so rounding can move the intercept a lot
        small[dev] = svm_search(SVC(kernel="rbf"), {
            "C": [SVM_C_EXIT], "gamma": [gamma0]}, X[idx], y[idx], dev,
            folds=3, refit=False)
    exit_steps = [small[d].chunks_[0]["n_iter_exec"] for d in small]
    exit_diff = abs(float(small["cuda"].cv_results_["mean_test_score"][0]
                          - small["cpu"].cv_results_["mean_test_score"][0]))
    print(f"  residual exit at C={SVM_C_EXIT}: steps {exit_steps} (cuda / "
          f"cpu, budget 300), mean_test_score "
          f"{small['cuda'].cv_results_['mean_test_score'][0]:.4f} / "
          f"{small['cpu'].cv_results_['mean_test_score'][0]:.4f}")
    if not max(exit_steps) < 300 or abs(exit_steps[0] - exit_steps[1]) > 1:
        raise AssertionError(f"SVC C={SVM_C_EXIT}: steps {exit_steps}")
    diff = float(np.abs(res["cuda"].cv_results_["mean_test_score"]
                        - res["cpu"].cv_results_["mean_test_score"]).max())
    top = np.sort(res["cpu"].cv_results_["mean_test_score"])[::-1]
    print(f"  cuda against cpu, {N_SVM_CHECK} rows, 2 candidates x 3 folds:"
          f" max |d mean_test_score| {diff:.3g} (tolerance 5e-3), best "
          f"{res['cuda'].best_params_} / {res['cpu'].best_params_}, gap to "
          f"the second best {float(top[0] - top[1]):.4g}; steps "
          f"{res['cuda'].chunks_[0]['n_iter_exec']} / "
          f"{res['cpu'].chunks_[0]['n_iter_exec']}; cuda {secs['cuda']:.1f} s, "
          f"cpu {secs['cpu']:.1f} s")
    if not diff <= 5e-3:
        raise AssertionError(f"SVC: cuda and cpu scores differ by {diff}")
    if res["cuda"].best_params_ != res["cpu"].best_params_:
        raise AssertionError("SVC: best_params_ differ between cuda and cpu")
    out["check"] = {"max_abs": diff, "cpu_s": secs["cpu"],
                    "cpu_best_gap": float(top[0] - top[1]),
                    "exit_steps": exit_steps, "exit_max_abs": exit_diff}
    return out


# --- tree ensembles: data, the kernel check and phases 9 and 10 ----------

def covtype_like(seed: int, n: int = N_RF):
    """Covertype-shaped data (UCI covtype.info): d=54 columns, the 10
    quantitative ones in covtype's ranges (elevation 1859-3858 m, aspect
    0-360, slope 0-66, the hydrology, road and fire-point distances, the
    three hillshades 0-254), then 4 wilderness-area and 40 soil-type
    one-hot columns, and 7 cover types at covtype's shares (36.5, 48.8,
    6.2, 0.5, 1.6, 3.0, 3.5 %).  A type shifts the elevation (as it does
    in covtype, its strongest feature), the distances and the slope, and
    draws its wilderness area and soil type from its own distributions,
    so a forest separates the types well but not perfectly.  float32."""
    rng = np.random.default_rng(seed)
    share = np.array([36.5, 48.8, 6.2, 0.5, 1.6, 3.0, 3.5])
    y = rng.choice(K_RF, size=n, p=share / share.sum())
    elev_mu = np.array([3130, 2920, 2390, 2220, 2790, 2590, 3360])
    X = np.empty((n, D_RF), np.float32)
    X[:, 0] = np.clip(elev_mu[y] + 150 * rng.standard_normal(n), 1859, 3858)
    X[:, 1] = rng.uniform(0, 360, n)
    X[:, 2] = np.clip(14 + 3 * (y == 2) + 7.5 * rng.standard_normal(n), 0,
                      66)
    X[:, 3] = np.clip(rng.gamma(1.6, 170, n) * (1 + 0.2 * (y == 0)), 0, 1397)
    X[:, 4] = np.clip(46 + 58 * rng.standard_normal(n), -173, 601)
    X[:, 5] = np.clip(rng.gamma(2.3, 1020, n) * (1 + 0.3 * (y == 6)), 0,
                      7117)
    X[:, 6] = np.clip(212 + 27 * rng.standard_normal(n), 0, 254)
    X[:, 7] = np.clip(223 + 20 * rng.standard_normal(n), 0, 254)
    X[:, 8] = np.clip(143 + 38 * rng.standard_normal(n), 0, 254)
    X[:, 9] = np.clip(rng.gamma(2.2, 900, n) * (1 + 0.2 * (y == 1)), 0,
                      7173)
    X[:, 10:] = 0.0
    wild_p = rng.dirichlet(np.full(4, 0.7), K_RF)
    soil_p = rng.dirichlet(np.full(40, 0.3), K_RF)
    for c in range(K_RF):
        m = np.flatnonzero(y == c)
        X[m, 10 + (rng.random(len(m))[:, None]
                   > np.cumsum(wild_p[c])[None, :]).sum(1)] = 1.0
        X[m, 14 + np.minimum((rng.random(len(m))[:, None]
                              > np.cumsum(soil_p[c])[None, :]).sum(1),
                             39)] = 1.0
    return X, y


def tree_level_inputs(codes, lanes: int, n_nodes: int, stats_kind: str,
                      seed: int, skew: bool = False):
    """One level's T1/T3 inputs on the card at a path's shape: each of
    `lanes` lanes takes about 2/3 of the rows (a fold) with forest stats
    (Poisson(1) counts x the fold, one-hot targets of 7 classes: S = 8,
    integers) or boosting stats (the fold, continuous gradients: S = 2),
    the rows spread uniformly over `n_nodes` nodes, or with `skew` as a
    grown tree's are: half the rows in node 0, a quarter in node 1, and
    so on (the last node takes the rest)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = codes.shape[0]
    fold = (torch.rand((lanes, n), generator=g, device="cuda") < 2 / 3
            ).float()
    if stats_kind == "forest":
        w = torch.poisson(torch.ones((lanes, n), device="cuda"),
                          generator=g) * fold
        y = torch.randint(0, K_RF, (n,), generator=g, device="cuda")
        t = torch.nn.functional.one_hot(y, K_RF).float()
        stats = torch.cat([w[..., None], -w[..., None] * t[None]], dim=2)
    else:
        w = fold
        grad = torch.randn((lanes, n), generator=g, device="cuda")
        stats = torch.stack([w, w * grad], dim=2)
    if skew:
        u = torch.rand((lanes, n), generator=g, device="cuda")
        local = torch.floor(-torch.log2(1.0 - u)).clamp_max(
            n_nodes - 1).to(torch.int32)
    else:
        local = torch.randint(0, n_nodes, (lanes, n), generator=g,
                              device="cuda", dtype=torch.int32)
    local = torch.where(w > 0, local, torch.full_like(local, -1))
    return local, stats.contiguous()


def sm_clock_under_load(fn, seconds: float = 1.0) -> float:
    """The SM clock (MHz) nvidia-smi reads while `fn` runs back to back on
    the card for about `seconds`."""
    import torch
    reps = max(1, int(seconds / (cuda_ms(fn, reps=3, warmup=1) * 1e-3)))
    for _ in range(reps):
        fn()                       # queued: the card runs while smi reads
    mhz = float(nvidia_smi("clocks.sm").split()[0])
    torch.cuda.synchronize()
    return mhz


#: the parts of the mangled names of each count's CUDA kernels (T3: the
#: level step, the accumulate and the walk; the grouping's one kernel)
TREE_SYMBOLS = {"tree_level_hist": ("level_hist",),
                "tree_best_split": ("best_split",),
                "tree_route": ("level_step", "add_leaves", "walk_rows"),
                "tree_leaf_values": ("leaf_sums",),
                "tree_segments": ("segment_rows",)}


def tree_symbol(name: str) -> str:
    """The part of the mangled name of `name`'s main CUDA kernel."""
    return TREE_SYMBOLS[name][0]


def phase_tree_kernels(seed: int, ptxas: dict):
    """T1-T4 against their plain versions at phase 9's (boosting,
    n=20640, d=8, 60 lanes, depth 5) and phase 10's (forest, n=100000,
    d=54, 6 lanes, depth 10) shapes, each a chunk's lanes as the searches
    run them: T1 at the root and the deepest level, the latter also with
    a skewed population (half the rows in one node, a quarter in the next,
    ...); T2 and T3 on the uniform levels; T4 at the final level, uniform
    and skewed, and (boosting) at one node a lane, as the boosting init
    calls it.
    T1 and T4 are held `torch.equal` to their plain versions run on CPU
    copies of the inputs (the kernels add in the CPU's row order: forest
    and boosting stats alike); T2 and T3 as before (forest equal;
    boosting gains rtol 1e-4 and T2's feature and bin equal where the
    two best gains differ by more than 1e-5 relative).  Two launches give
    the same bits.  Times (CUDA events): for T1 and T4 the kernel alone on
    rows already grouped and the wrapper with its grouping; the plain
    versions on the card, `index_add_` (T1, T4: one call a stat, ids
    built beforehand), the byte bound and, for T1 and T4, the order bound:
    the longest chain of one sum (a cell's or a node's rows) x 4 clocks
    (one dependent add) at the SM clock read under load.  Returns
    {(name, shape label): row}."""
    import torch

    from spark_sklearn_tpu_torch.ops import tree_kernels as tk
    from spark_sklearn_tpu_torch.utils.binning import quantile_bin

    rows = {}
    shapes = {
        "rf": (quantile_bin(covtype_like(seed)[0])[1], 2 * 3, 10, "forest"),
        "gb": (quantile_bin(california_like(seed)[0])[1], 12 * N_FOLDS, 5,
               "boosting"),
    }

    def record(name, label, got, want, exact, ms, plain_ms, lib_ms, nbytes,
               ops, extra=None, rtol=1e-5, atol=1e-5, symbol=None):
        errs = [float(torch.nan_to_num(a.float() - b.float()).abs().max())
                if a.numel() else 0.0 for a, b in zip(got, want)]
        for a, b in zip(got, want):
            if exact:
                ok = torch.equal(a, b)
            else:
                a, b = a.float(), b.float()
                fin = torch.isfinite(b)
                ok = torch.equal(fin, torch.isfinite(a)) and bool((
                    (a[fin] - b[fin]).abs()
                    <= atol + rtol * b[fin].abs()).all())
            if not ok:
                raise AssertionError(f"{name} ({label}) disagrees with its "
                                     f"plain version: max abs err {errs}")
        bound_ms, bound_by = bound(nbytes, ops)
        regs, spill = next((v for f, v in ptxas.items()
                            if (symbol or tree_symbol(name)) in f),
                           (None, None))
        rows[(name, label)] = {
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            "registers": regs, "spill_bytes": spill, **(extra or {})}
        lib = f", index_add_ {lib_ms:.4f} ms" if lib_ms is not None else ""
        more = ""
        if extra and "events_ms" in extra:
            more = f", {extra['events_ms']:.4f} ms between events"
        if extra and "hist_bytes_ms" in extra:
            more += (f", whole histogram bound {extra['hist_bytes_ms']:.4f}"
                     f" ms, {extra['kept_features']} kept features")
        if extra and "wrapper_ms" in extra:
            more = (f", wrapper {extra['wrapper_ms']:.4f} ms, order bound "
                    f"{extra['order_bound_ms']:.4f} ms (chain "
                    f"{extra['chain']}), cpu plain "
                    f"{extra['cpu_plain_s']:.2f} s")
        print(f"  {name:16s} {label:14s}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms by "
              f"{bound_by}, bound/time {bound_ms / ms:.3f}{more}), max abs "
              f"err {max(errs):.3g}, bitwise repeatable; {regs} registers, "
              f"{spill} bytes spilled", flush=True)

    def repeat(fn, name):
        a, b = fn(), fn()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: two launches differ")
        return a

    def index_add_ms(local, stats, n_seg, ids):
        """One `index_add_` a stat into a zeroed (n_seg,) vector."""
        live = local >= 0
        vals = [stats[..., s][live] for s in range(stats.shape[2])]
        if ids.numel() != vals[0].numel():
            vals = [v[:, None].expand(-1, ids.numel() // v.numel()
                                      ).reshape(-1) for v in vals]

        def run():
            for v in vals:
                torch.zeros(n_seg, device="cuda").index_add_(0, ids, v)
        return cuda_ms(run, reps=5, warmup=1)

    def on_cpu(fn, *args):
        """fn on CPU copies of `args`, back on the card, and its seconds."""
        t0 = time.perf_counter()
        out = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args])
        return out.to("cuda"), time.perf_counter() - t0

    def record_segments(lab, local, n_nodes, perm, offs):
        """The grouping against `segments_plain` on CPU copies (equal);
        `torch.sort` of the same keys (stable) as the library call."""
        L = local.shape[0]
        want = on_cpu(lambda lo: torch.cat(tk.segments_plain(lo, n_nodes)),
                      local)[0]
        key = (torch.where(local >= 0, local, n_nodes) + torch.arange(
            L, dtype=torch.int32, device="cuda")[:, None] * (n_nodes + 1)
               ).reshape(-1)
        # the kernel alone (a CUDA graph's replay) and the wrapper's time
        # between events (its host cost and allocations included)
        record("tree_segments", lab, (torch.cat((perm, offs)),), (want,),
               True, graph_ms(lambda: tk.segments(local, n_nodes)),
               cuda_ms(lambda: tk.segments_plain(local, n_nodes), reps=5,
                       warmup=1),
               cuda_ms(lambda: torch.sort(key, stable=True), reps=5,
                       warmup=1),
               local.nbytes + perm.nbytes + offs.nbytes, 0,
               {"lanes": L, "n_nodes": n_nodes,
                "events_ms": cuda_ms(lambda: tk.segments(local, n_nodes))})

    sm_mhz = None
    final_node = {}
    for label, (codes_np, L, depth, kind) in shapes.items():
        codes = torch.as_tensor(codes_np, device="cuda")
        n, d = codes.shape
        lane = torch.arange(L, device="cuda")[:, None]
        deep = 2 ** (depth - 1)
        for n_nodes, skew in ((1, False), (deep, False), (deep, True)):
            local, stats = tree_level_inputs(codes, L, n_nodes, kind,
                                             seed + n_nodes, skew)
            S = stats.shape[2]
            lab = f"{label}/{n_nodes}" + (" skew" if skew else "")
            perm, offs = repeat(lambda: tk.segments(local, n_nodes),
                                "tree_segments")
            record_segments(lab, local, n_nodes, perm, offs)
            if sm_mhz is None:
                sm_mhz = sm_clock_under_load(
                    lambda: tk.level_histogram_grouped(codes, perm, offs,
                                                       stats, n_nodes))
                print(f"  SM clock under T1's load: {sm_mhz:.0f} MHz")
            hist = repeat(lambda: tk.level_histogram(codes, local, stats,
                                                     n_nodes),
                          "tree_level_hist")[0]
            want, cpu_s = on_cpu(tk.level_histogram_plain, codes, local,
                                 stats, n_nodes)
            live = local >= 0
            m = int(live.sum())
            seg = (lane * n_nodes + local.long())[live]
            ids = ((seg[:, None] * d + torch.arange(d, device="cuda"))
                   * 256 + codes[torch.nonzero(live)[:, 1]].long()
                   ).reshape(-1)
            chain = int(torch.bincount(ids).max())
            plan = tk.hist_plan(d, S, 256, L, n_nodes, 132)
            record("tree_level_hist", lab, (hist,), (want,), True,
                   cuda_ms(lambda: tk.level_histogram_grouped(
                       codes, perm, offs, stats, n_nodes), reps=10),
                   cuda_ms(lambda: tk.level_histogram_plain(
                       codes, local, stats, n_nodes), reps=3, warmup=1),
                   index_add_ms(local, stats, L * n_nodes * d * 256, ids),
                   codes.nbytes + local.nbytes + stats.nbytes + hist.nbytes,
                   m * d * S, {
                       "entries": m * d, "lanes": L, "n_nodes": n_nodes,
                       "S": S, "plan": plan,
                       "wrapper_ms": cuda_ms(lambda: tk.level_histogram(
                           codes, local, stats, n_nodes), reps=10),
                       "chain": chain,
                       "order_bound_ms": chain * 4 / (sm_mhz * 1e3),
                       "sm_mhz": sm_mhz, "cpu_plain_s": cpu_s},
                   symbol=f"level_histILi{plan['vw']}E")
            del want, ids, seg
            if skew:
                del hist
                continue
            exact = kind == "forest"
            lam = 1e-9 if exact else 1e-6
            keep = None
            if not exact:
                # nodes whose two best gains are apart (else a tie that
                # rounding may break either way)
                gains = []
                for f in range(d):
                    one = hist[:, :, f:f + 1]
                    gains.append(_gain_table(one, lam, 1.0))
                top = torch.topk(torch.cat(gains, dim=2), 2, dim=2).values
                keep = (top[..., 0] - top[..., 1]) > 1e-5 * top[..., 0].abs()
            # the forest draws 7 of its 54 features a node at every level
            # (max_features="sqrt"), the root too; the unmasked root is the
            # RF regressor's (and the earlier row), and a quarter of the
            # nodes with no feature left tests the fallback index
            variants = [(lab, None)]
            if exact:
                g = torch.Generator(device="cuda").manual_seed(seed)
                sc = torch.rand((n_nodes, d), generator=g, device="cuda")
                fmask = sc <= torch.sort(sc, dim=1).values[:, 6:7]
                if n_nodes == 1:
                    variants.append((f"{lab} masked", fmask))
                else:
                    quarter = fmask.clone()
                    quarter[::4] = False
                    variants = [(lab, fmask),
                                (f"{lab} a quarter all-masked", quarter)]
            for vlab, fmask in variants:
                got = repeat(lambda: tk.best_splits(hist, fmask, lam, 1.0),
                             "tree_best_split")
                want = tk.best_splits_plain(hist, fmask, lam, 1.0)
                sel = torch.ones_like(want[3]) if keep is None else keep
                # the bytes the result needs: the kept features' blocks
                # (each (n_bins, S) block read once), the mask, the
                # outputs
                kept = (int(fmask.sum()) if fmask is not None
                        else n_nodes * d)
                nbytes = (L * kept * 256 * S * 4 + 13 * L * n_nodes
                          + (fmask.nbytes if fmask is not None else 0))
                # tolerance: boosting gains rtol 1e-4 (differences of sums
                # added in another order), on the nodes with a clear best
                # the kernel alone (a CUDA graph's replay: at the roots
                # the wrapper takes longer on the host than the kernel on
                # the card), and between events around wrapper calls as
                # the earlier rows were timed
                record("tree_best_split", vlab,
                       (got[0][sel], got[1][sel], got[3][sel], got[2][sel]),
                       (want[0][sel], want[1][sel], want[3][sel],
                        want[2][sel]),
                       exact, graph_ms(lambda: tk.best_splits(
                           hist, fmask, lam, 1.0)),
                       cuda_ms(lambda: tk.best_splits_plain(
                           hist, fmask, lam, 1.0), reps=3, warmup=1), None,
                       nbytes, L * kept * 256 * (2 + 10 * (S - 1)),
                       {"nodes_compared": int(sel.sum()),
                        "nodes": L * n_nodes, "kept_features": kept,
                        "events_ms": cuda_ms(lambda: tk.best_splits(
                            hist, fmask, lam, 1.0)),
                        "hist_bytes_ms": bound(hist.nbytes + 13 * L
                                               * n_nodes, 0)[0],
                        "no_finite_gain": int(torch.isneginf(
                            want[2]).sum()),
                        "plan": tk.split_plan(L, n_nodes, d, 256, S, 132)},
                       rtol=1e-4)
                if vlab == lab:
                    split_of_level = got
            got = split_of_level
            del hist
            # T3: the level step on this level's splits, every row at
            # the level's nodes (local < 0: inactive, routed all the
            # same); the deepest level is the tree's last
            node0 = (local.clamp_min(0) + (n_nodes - 1)).to(torch.int32)
            active = local >= 0
            last = n_nodes == deep
            M = 2 ** (depth + 1) - 1
            bf, bb, split = got[0], got[1], got[3]

            def fresh():
                return [node0.clone(),
                        torch.full((L, M), -1, dtype=torch.int32,
                                   device="cuda"),
                        torch.zeros((L, M), dtype=torch.int32, device="cuda"),
                        torch.zeros((L, M), dtype=torch.bool, device="cuda"),
                        torch.empty_like(node0)]

            def step_on(fn, st):
                fn(codes, st[0], active, bf, bb, split, st[1], st[2], st[3],
                   st[4], last)
                return st

            outs = [step_on(tk.level_step, fresh()) for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError("tree_route (level step): two launches "
                                     "differ")
            want = step_on(tk.level_step_plain, fresh())
            if last:
                final_node[label] = outs[0][0]
            # a routed row leaves the level: each timed launch starts from
            # a copy of the level's nodes, whose own time is taken off
            work = fresh()

            def restore():
                work[0].copy_(node0)

            def stepped():
                restore()
                step_on(tk.level_step, work)

            # the bytes the step needs: the codes, node read and written,
            # active, the keys written, the splits read and the heap's
            # level written (9 bytes a node each), the final is_leaf
            nbytes = (codes.nbytes + 3 * node0.nbytes + active.nbytes
                      + 18 * L * n_nodes + (L * M if last else 0))
            record("tree_route", lab, outs[0], want, True,
                   graph_ms(stepped) - graph_ms(restore),
                   cuda_ms(lambda: step_on(tk.level_step_plain, fresh()),
                           reps=5, warmup=1), None, nbytes, 3 * L * n,
                   {"events_ms": cuda_ms(stepped) - cuda_ms(restore),
                    "last": last,
                    "plan": tk.row_plan(n, d, L, 4 * n_nodes
                                        + (M if last else 0),
                                        tk.STEP_SMEM, 132)},
                   symbol="level_step")
            del got, want, outs, work
        # T4 at the final level (uniform, skewed) and, for boosting, at
        # one node a lane (the init); T3's walk of a whole tree
        M = 2 ** (depth + 1) - 1
        lam = 1e-9 if kind == "forest" else 1e-6
        cases = [(M, False), (M, True)] + ([(1, False)] if kind ==
                                           "boosting" else [])
        for n_nodes, skew in cases:
            local, stats = tree_level_inputs(codes, L, n_nodes, kind,
                                             seed + 7, skew)
            lab = f"{label}/{n_nodes}" + (" skew" if skew else "")
            perm, offs = repeat(lambda: tk.segments(local, n_nodes),
                                "tree_segments")
            record_segments(lab, local, n_nodes, perm, offs)
            val = repeat(lambda: tk.leaf_values(local, stats, n_nodes, lam),
                         "tree_leaf_values")[0]
            val_p, cpu_s = on_cpu(tk.leaf_values_plain, local, stats,
                                  n_nodes, lam)
            ids = (lane * n_nodes + local.long())[local >= 0]
            chain = int(torch.bincount(ids).max())
            record("tree_leaf_values", lab, (val,), (val_p,), True,
                   cuda_ms(lambda: tk.leaf_values_grouped(
                       perm, offs, stats, n_nodes, lam)),
                   cuda_ms(lambda: tk.leaf_values_plain(local, stats,
                                                        n_nodes, lam),
                           reps=5, warmup=1),
                   index_add_ms(local, stats, L * n_nodes, ids),
                   local.nbytes + stats.nbytes + val.nbytes,
                   L * n * stats.shape[2], {
                       "lanes": L, "n_nodes": n_nodes,
                       "wrapper_ms": cuda_ms(lambda: tk.leaf_values(
                           local, stats, n_nodes, lam)),
                       "chain": chain,
                       "order_bound_ms": chain * 4 / (sm_mhz * 1e3),
                       "sm_mhz": sm_mhz, "cpu_plain_s": cpu_s,
                       "plan": tk.leaf_plan(stats.shape[2], L, n_nodes)})
        local, stats = tree_level_inputs(codes, L, M, kind, seed + 7)
        val = tk.leaf_values(local, stats, M, lam)
        g = torch.Generator(device="cuda").manual_seed(seed + 9)
        feat = torch.randint(0, d, (L, M), generator=g, device="cuda",
                             dtype=torch.int32)
        thr = torch.randint(0, 256, (L, M), generator=g, device="cuda",
                            dtype=torch.int32)
        leaf = torch.zeros((L, M), dtype=torch.bool, device="cuda")
        leaf[:, M // 2:] = True
        out0 = torch.zeros((L, n, val.shape[2]), device="cuda")
        scale = torch.full((L,), 0.1, device="cuda")
        got = repeat(lambda: tk.walk(codes, feat, thr, leaf, val, depth,
                                     out0.clone(), scale), "tree_walk")
        want = tk.walk_plain(codes, feat, thr, leaf, val, depth, out0.clone(),
                             scale)
        work = out0.clone()

        def walked():
            tk.walk(codes, feat, thr, leaf, val, depth, work, scale)
        record("tree_route", f"{label}/walk", got, (want,), True,
               graph_ms(walked),
               cuda_ms(lambda: tk.walk_plain(codes, feat, thr, leaf, val,
                                             depth, out0.clone(), scale),
                       reps=5, warmup=1), None,
               codes.nbytes + feat.nbytes + thr.nbytes + leaf.nbytes
               + val.nbytes + 2 * out0.nbytes, L * n * (2 * depth + 2),
               {"events_ms": cuda_ms(walked),
                "plan": tk.row_plan(n, d, L, 4 * M, tk.WALK_SMEM, 132)},
               symbol="walk_rows")
        # the fit's update: the leaf values at the last level step's
        # final nodes added to the prediction
        node = final_node[label]
        got = repeat(lambda: tk.accumulate(val, node, out0.clone(), scale),
                     "tree_add_leaves")
        want = tk.accumulate_plain(val, node, out0.clone(), scale)

        def added():
            tk.accumulate(val, node, work, scale)
        record("tree_route", f"{label}/accumulate", got, (want,), True,
               graph_ms(added),
               cuda_ms(lambda: tk.accumulate_plain(val, node, out0.clone(),
                                                   scale), reps=5, warmup=1),
               None, node.nbytes + 2 * out0.nbytes + val.nbytes
               + scale.nbytes, 2 * out0.numel(),
               {"events_ms": cuda_ms(added)}, symbol="add_leaves")
        del codes, local, stats, val, out0, work
    return rows


def _gain_table(hist, lam, mcw):
    """(L, N, d·B) masked gains of a one-output histogram (no feature
    mask), by torch ops: for the check's tie test only."""
    import torch
    cum = torch.cumsum(hist, dim=3)
    lh, lg = cum[..., 0], cum[..., 1]
    th, tg = lh[..., -1:], lg[..., -1:]
    gain = (lg * lg / (lh + lam) + (tg - lg) ** 2 / (th - lh + lam)
            - tg * tg / (th + lam))
    gain = torch.where((lh >= mcw) & (th - lh >= mcw), gain,
                       torch.full_like(gain, float("-inf")))
    gain[..., -1] = float("-inf")
    return gain.reshape(gain.shape[0], gain.shape[1], -1)


def tree_search(est, grid, X, y, device, cv, scoring=None, n_iter=None,
                seed=0):
    from spark_sklearn_tpu_torch import (
        GridSearchCV, RandomizedSearchCV, TorchConfig)
    config = TorchConfig(device=device)
    if n_iter is not None:
        return RandomizedSearchCV(est, grid, n_iter=n_iter, cv=cv,
                                  scoring=scoring, random_state=seed,
                                  refit=False, config=config).fit(X, y)
    return GridSearchCV(est, grid, cv=cv, scoring=scoring, refit=False,
                        config=config).fit(X, y)


def trees_grown(gs, n_folds: int, default: int) -> int:
    """Trees the search grew: each (candidate, fold) lane grows its
    n_estimators (k a stage for a k-class booster, counted once)."""
    return n_folds * sum(int(p.get("n_estimators", default))
                         for p in gs.cv_results_["params"])


def run_tree_search(label, run, n_fits, n_trees_of, key, min_score):
    """A tree search on cuda: cold (with T1-T4's launches), warm, then
    profiled; checks its scores are finite and above `min_score`.
    Returns the row for the record."""
    import torch

    from spark_sklearn_tpu_torch.ops import tree_kernels as tk

    tk.reset_launches()
    t0 = time.perf_counter()
    gs = run()
    cold = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{label}: {name} never launched")
    scores = gs.cv_results_[f"mean_test_{key}"]
    if not np.all(np.isfinite(scores)):
        raise AssertionError(f"{label}: non-finite scores {scores}")
    best = int(gs.cv_results_[f"rank_test_{key}"].argmin())
    best_score = float(scores[best])
    if not best_score > min_score:
        raise AssertionError(f"{label}: best {key} {best_score}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs = run()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trees = n_trees_of(gs)
    print(f"  {label}: cold {cold:.3f} s, warm {warm:.3f} s, "
          f"{n_fits / warm:.2f} fits/s, {trees} trees, chunks "
          f"{[(c['lanes'], c['n_iter_exec']) for c in gs.chunks_]} (lanes, "
          f"trees), peak memory {peak / 2**20:.1f} MiB, launches {launches}"
          f"; best {gs.cv_results_['params'][best]} {key} "
          f"{best_score:.4f}")
    busy, by_name = profile_busy(run, warm, 1, f"chip_smoke_{label}.txt",
                                 with_kernels=True)
    per_kernel = {}
    for name in tk.LAUNCHES:
        ns, count = (sum(v[i] for k, v in by_name.items()
                         if any(part in k for part in TREE_SYMBOLS[name]))
                     for i in (0, 1))
        per_kernel[name] = {"launches": count,
                            "ms_per_launch": ns / 1e6 / max(count, 1),
                            "share_of_busy": ns / 1e9 / busy if busy else
                            None}
    print(f"    busy {busy / trees * 1e3:.4f} ms a tree, idle share "
          f"{1 - busy / warm:.4f}; " + ", ".join(
              f"{tree_symbol(k)} {v['launches']}x "
              f"{v['ms_per_launch']:.4f} ms ({v['share_of_busy'] or 0:.3f}"
              f" of busy)" for k, v in per_kernel.items()))
    # a level: every device launch of the profiled search (kernels,
    # copies, fills) over its levels, one T3 level step each
    levels = sum(c for k, (_, c) in by_name.items() if "level_step" in k)
    n_launch = sum(c for _, c in by_name.values())
    tree_launch = sum(c for k, (_, c) in by_name.items()
                      if any(part in k for parts in TREE_SYMBOLS.values()
                             for part in parts))
    per_level = {"levels": levels,
                 "launches_per_level": n_launch / max(levels, 1),
                 "tree_kernel_launches_per_level": tree_launch
                 / max(levels, 1),
                 "wall_us_per_level": warm / max(levels, 1) * 1e6}
    print(f"    {levels} levels: {per_level['launches_per_level']:.2f} "
          f"device launches a level ("
          f"{per_level['tree_kernel_launches_per_level']:.2f} of them T1-T4 "
          f"and G), {per_level['wall_us_per_level']:.1f} us of warm wall a "
          f"level")
    return {"cold_s": cold, "warm_s": warm, "fits_per_s": n_fits / warm,
            "profile_kernels": per_kernel,
            "trees": trees, "busy_ms_per_tree": busy / trees * 1e3,
            "device_busy_s": busy, "idle_share": 1 - busy / warm,
            "peak_bytes": peak, "launches": launches,
            "best_params": gs.cv_results_["params"][best],
            "best_score": best_score, "per_level": per_level}


def grower_inputs(kind: str, seed: int):
    """`grow_tree`'s arguments at a tree search's chunk: "rf" phase 10's
    forest (6 lanes of Poisson(1) x 2/3-fold weights, one-hot targets of
    7 classes, 7 of 54 features a node, depth 10), "gb" phase 9's
    boosting (60 lanes, fold weights, normal gradients, depth 5)."""
    import torch

    from spark_sklearn_tpu_torch.ops import random as jr
    from spark_sklearn_tpu_torch.utils.binning import quantile_bin

    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "rf":
        X, y = covtype_like(seed)
        L, depth = 6, 10
    else:
        X, y = california_like(seed)
        L, depth = 12 * N_FOLDS, 5
    codes = torch.as_tensor(quantile_bin(X)[1], device="cuda")
    n = codes.shape[0]
    fold = (torch.rand((L, n), generator=g, device="cuda") < 2 / 3).float()
    if kind == "rf":
        w = torch.poisson(torch.ones((L, n), device="cuda"),
                          generator=g) * fold
        t = torch.nn.functional.one_hot(torch.as_tensor(y, device="cuda"),
                                        K_RF).float()
        return (codes, -t, torch.ones(n, device="cuda"), w, depth, 256), {
            "min_child_weight": 1.0, "reg_lambda": 1e-9,
            "feat_mask_key": jr.fold_in(jr.PRNGKey(seed), 7),
            "max_features": 7, "n_out": K_RF}
    grad = torch.randn((L, n, 1), generator=g, device="cuda")
    return (codes, grad, torch.ones((L, n), device="cuda"), fold, depth,
            256), {"min_child_weight": 1.0, "reg_lambda": 1e-6}


def grower_alone(kind: str, seed: int, reps: int = 7):
    """One `grow_tree` at a search's chunk (`grower_inputs`): its device
    launches a level (the profiler's device events over the depth), its
    host time a level (the host clock from the call to its return, the
    card idle before it, best of `reps`) and its device time a level (CUDA
    events around the call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_sklearn_tpu_torch.ops.trees import grow_tree

    args, kw = grower_inputs(kind, seed)
    depth = args[4]
    grow_tree(*args, **kw)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grow_tree(*args, **kw)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    dev_ms = cuda_ms(lambda: grow_tree(*args, **kw), reps=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grow_tree(*args, **kw)
        torch.cuda.synchronize()
    n_dev = sum(1 for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    row = {"lanes": args[3].shape[0], "depth": depth,
           "launches_per_level": n_dev / depth,
           "host_us_per_level": min(host) / depth * 1e6,
           "device_us_per_level": dev_ms / depth * 1e3}
    print(f"  grow_tree alone at the {kind} search's chunk ({row['lanes']} "
          f"lanes, depth {depth}): {row['launches_per_level']:.2f} device "
          f"launches a level, host {row['host_us_per_level']:.1f} us a "
          f"level, device {row['device_us_per_level']:.1f} us a level")
    return row


def cuda_cpu_check(label, est, grid, X, y, cv, tol):
    """The same small search on cuda and on the CPU: mean_test_score
    within `tol` and the same best candidate."""
    res, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = tree_search(est, grid, X, y, dev, cv)
        secs[dev] = time.perf_counter() - t0
    diff = float(np.abs(res["cuda"].cv_results_["mean_test_score"]
                        - res["cpu"].cv_results_["mean_test_score"]).max())
    print(f"  {label} cuda against cpu, {len(y)} rows, "
          f"{len(res['cpu'].cv_results_['params'])} candidates x "
          f"{res['cpu'].n_splits_} folds: max |d mean_test_score| "
          f"{diff:.3g} (tolerance {tol:g}), best {res['cuda'].best_params_}"
          f" / {res['cpu'].best_params_}; cuda {secs['cuda']:.1f} s, cpu "
          f"{secs['cpu']:.1f} s")
    if not diff <= tol:
        raise AssertionError(f"{label}: cuda and cpu differ by {diff}")
    if res["cuda"].best_params_ != res["cpu"].best_params_:
        raise AssertionError(f"{label}: best_params_ differ")
    return {"max_abs": diff, "cpu_s": secs["cpu"]}


def phase_gb(seed: int):
    """BASELINE config #4: GridSearchCV(GradientBoostingRegressor(
    random_state=0), learning_rate x subsample x n_estimators x
    max_depth = 24 candidates, KFold(5), r2 and neg_mean_squared_error,
    refit=False) on phase 6's data (n=20640, d=8): 120 fits in two groups
    (the depths), each growing its lanes' n_estimators; then a
    GradientBoostingClassifier(n_estimators=50, max_depth=3) over two
    learning rates on phase 4's data, 5 folds; then cuda against the CPU
    on 2000 rows of each."""
    from spark_sklearn_tpu_torch import (
        GradientBoostingClassifier, GradientBoostingRegressor, KFold,
        StratifiedKFold)

    X, y = california_like(seed)
    n_cand = int(np.prod([len(v) for v in GB_GRID.values()]))
    out = {"regressor": run_tree_search(
        "gb_regressor",
        lambda: tree_search(GradientBoostingRegressor(random_state=0),
                            GB_GRID, X, y, "cuda", KFold(N_FOLDS),
                            scoring=["r2", "neg_mean_squared_error"]),
        n_cand * N_FOLDS, lambda gs: trees_grown(gs, N_FOLDS, 100), "r2",
        0.3)}
    Xd, yd = digits_like(seed)
    out["classifier"] = run_tree_search(
        "gb_classifier",
        lambda: tree_search(GradientBoostingClassifier(
            n_estimators=50, max_depth=3), {"learning_rate": [0.1, 0.3]},
            Xd, yd, "cuda", StratifiedKFold(N_FOLDS), scoring=["accuracy"]),
        2 * N_FOLDS, lambda gs: K * trees_grown(gs, N_FOLDS, 50),
        "accuracy", 0.3)
    out["regressor"]["check"] = cuda_cpu_check(
        "gb_regressor", GradientBoostingRegressor(
            n_estimators=50, max_depth=3, random_state=0),
        {"learning_rate": [0.1, 0.2]}, X[:N_TREE_CHECK], y[:N_TREE_CHECK],
        KFold(3), 1e-3)
    out["classifier"]["check"] = cuda_cpu_check(
        "gb_classifier", GradientBoostingClassifier(
            n_estimators=20, max_depth=3), {"learning_rate": [0.1, 0.3]},
        Xd, yd, StratifiedKFold(3), 1e-3)
    out["regressor"]["grower"] = grower_alone("gb", seed)
    return out


def phase_rf(seed: int):
    """BASELINE config #3: RandomizedSearchCV(RandomForestClassifier(
    random_state=0), n_estimators in {20, 30, 40, 50} x max_depth in {6,
    8, 10}, n_iter=4, StratifiedKFold(3), random_state=0, refit=False) on
    covtype-shaped data (rows cut from 581012 to 100000); a
    RandomForestRegressor at one candidate on phase 6's data; then cuda
    against the CPU on 2000 stratified rows."""
    from spark_sklearn_tpu_torch import (
        KFold, RandomForestClassifier, RandomForestRegressor,
        StratifiedKFold)

    X, y = covtype_like(seed)
    out = {"classifier": run_tree_search(
        "rf_classifier",
        lambda: tree_search(RandomForestClassifier(random_state=0), RF_GRID,
                            X, y, "cuda", StratifiedKFold(3),
                            scoring=["accuracy"], n_iter=4, seed=0),
        4 * 3, lambda gs: trees_grown(gs, 3, 100), "accuracy", 0.5)}
    Xr, yr = california_like(seed)
    out["regressor"] = run_tree_search(
        "rf_regressor",
        lambda: tree_search(RandomForestRegressor(random_state=0),
                            {"n_estimators": [30], "max_depth": [8]}, Xr,
                            yr, "cuda", KFold(N_FOLDS), scoring=["r2"]),
        N_FOLDS, lambda gs: trees_grown(gs, N_FOLDS, 30), "r2", 0.3)
    per = {c: max(1, int(round(N_TREE_CHECK * float(np.mean(y == c)))))
           for c in range(K_RF)}
    idx = np.concatenate([np.flatnonzero(y == c)[:per[c]]
                          for c in range(K_RF)])
    out["classifier"]["check"] = cuda_cpu_check(
        "rf_classifier", RandomForestClassifier(max_depth=6, random_state=0),
        {"n_estimators": [10, 20]}, X[idx], y[idx], StratifiedKFold(3),
        1e-4)
    out["regressor"]["check"] = cuda_cpu_check(
        "rf_regressor", RandomForestRegressor(max_depth=6, random_state=0),
        {"n_estimators": [10, 20]}, Xr[:N_TREE_CHECK], yr[:N_TREE_CHECK],
        KFold(3), 1e-4)
    out["classifier"]["grower"] = grower_alone("rf", seed)
    return out


# --- the MLP pipeline: the kernel check and phase 11 ----------------------

def mlp_symbol(log_table: dict, part: str, variant: str = ""):
    """(registers, spilled bytes) of the mlp_step kernel whose mangled
    name holds `part` (and `variant`, e.g. ILb0E for a false template
    flag)."""
    return next((v for f, v in log_table.items()
                 if part in f and variant in f), (None, None))


def mlp_step_inputs(seed: int, B: int = MLP_LANES, R: int = MLP_BATCH,
                    k: int = K, h: int = MLP_HIDDEN, d: int = D,
                    alphas=MLP_ALPHAS):
    """One minibatch step's operands at a path's shape (phase 11's
    classifier by default): logits, fold weights, labels and targets, a
    hidden layer's pre-activations and cotangent, the flat parameters
    (P = d·h + h + h·k + k) with adam's state after a few steps, each
    lane's alpha from `alphas` repeated over the folds."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = d * h + h + h * k + k
    t = {
        "Z": 3.0 * torch.randn((B, R, k), generator=g, device="cuda"),
        "w": (torch.rand((B, R), generator=g, device="cuda") < 0.67).float(),
        "y": torch.randint(0, k, (R,), generator=g, device="cuda",
                           dtype=torch.int32),
        "Yt": torch.randn((R, k), generator=g, device="cuda"),
        "A": torch.randn((B, R, h), generator=g, device="cuda"),
        "dH": torch.randn((B, R, h), generator=g, device="cuda"),
        "p": 0.2 * torch.randn((B, P), generator=g, device="cuda"),
        "g": 0.01 * torch.randn((B, P), generator=g, device="cuda"),
        "m": 0.01 * torch.randn((B, P), generator=g, device="cuda"),
        "v": 1e-4 * torch.rand((B, P), generator=g, device="cuda"),
        "t": torch.full((B,), 3.0, device="cuda"),
        "alpha": torch.tensor(np.repeat(alphas, MLP_FOLDS)[:B],
                              dtype=torch.float32, device="cuda"),
        "wsum": 130.0 + torch.rand(B, generator=g, device="cuda"),
        "lr": torch.full((B,), 1e-3, device="cuda"),
        "loss": 300.0 * torch.rand(B, generator=g, device="cuda"),
        "acc": torch.zeros(B, device="cuda"),
        "active": torch.ones(B, dtype=torch.bool, device="cuda"),
    }
    wmask = torch.zeros(P, dtype=torch.bool, device="cuda")
    wmask[:d * h] = True
    wmask[d * h + h:d * h + h + h * k] = True
    t["wmask"] = wmask
    t["b"] = t["p"][:, d * h:d * h + h]      # the hidden bias, strided
    return t


#: M1 loss sums rtol 1e-5, G and db atol 1e-6, wsum equal; M2 p, m, v
#: rtol 1e-5
#: atol 1e-7, acc rtol 1e-5; M3 forward rtol 1e-6 atol 1e-6, backward
#: atol 1e-6
MLP_TOLS = {"mlp_loss_grad": [(1e-5, 1e-6), (0.0, 0.0), (0.0, 1e-6),
                              (0.0, 1e-6)],
            "mlp_opt_step": [(1e-5, 1e-7)] * 3 + [(1e-5, 0.0)],
            "mlp_act_forward": [(1e-6, 1e-6)],
            "mlp_act_backward": [(0.0, 1e-6)]}
MLP_REG_ALPHAS = [1e-4, 1.0]           # phase 11's MLPRegressor grid


def mlp_disagreement(name, variant, got, want):
    """Max abs error of a kernel's outputs against its plain version's;
    raises where one is outside its tolerance (MLP_TOLS)."""
    max_abs = 0.0
    for a, b, (rtol, atol) in zip(got, want, MLP_TOLS[name]):
        err = (a - b).abs()
        max_abs = max(max_abs, float(err.max()))
        if not bool((err <= atol + rtol * b.abs()).all()):
            raise AssertionError(
                f"{name} ({variant}) disagrees with its plain version: max "
                f"abs err {float(err.max())}, rtol {rtol}, atol {atol}")
    return max_abs


def mlp_step_calls(t, classifier: bool, adam: bool = True):
    """The kernels of one minibatch step on the inputs `t` (relu): {name:
    (kernel call, plain call, bytes, operations)}.  Each call returns the
    outputs it wrote; M2 runs on copies of the state, so that a call can
    be repeated, and `state_in_place` below times it in place."""
    from spark_sklearn_tpu_torch.ops import mlp_kernels as mk

    B, R, k = t["Z"].shape
    h, P = t["A"].shape[2], t["p"].shape[1]
    kw = {"y": t["y"]} if classifier else {"Yt": t["Yt"]}

    def opt(fn):
        s = {n: t[n].clone() for n in ("p", "m", "v", "t", "acc")}
        fn(s["p"], t["g"], s["m"], s["v"] if adam else None,
           s["t"] if adam else None, t["wmask"], t["alpha"], t["wsum"],
           t["lr"], t["active"], t["loss"], s["acc"], adam=adam)
        return (s["p"], s["m"]) + ((s["v"],) if adam else ()) + (s["acc"],)

    H = mk.mlp_act_forward_plain(t["A"], t["b"], "relu")
    # a row's operations, and one add a logit for db
    per_row = (8 * k + 6) if classifier else (5 * k + 3)
    return {
        "mlp_loss_grad": (
            lambda: mk.mlp_loss_grad(t["Z"], t["w"], **kw),
            lambda: mk.mlp_loss_grad_plain(t["Z"], t["w"], kw.get("y"),
                                           kw.get("Yt")),
            2 * t["Z"].nbytes + t["w"].nbytes + 8 * B + 4 * B * k
            + (t["y"].nbytes if classifier else t["Yt"].nbytes),
            B * R * per_row),
        "mlp_opt_step": (lambda: opt(mk.mlp_opt_step),
                         lambda: opt(mk.mlp_opt_step_plain),
                         (7 if adam else 5) * t["p"].nbytes + P + 30 * B,
                         B * P * (22 if adam else 8)),
        "mlp_act_forward": (
            lambda: [mk.mlp_act_forward(t["A"], t["b"], "relu")],
            lambda: [mk.mlp_act_forward_plain(t["A"], t["b"], "relu")],
            2 * t["A"].nbytes + B * h * 4, 2 * B * R * h),
        "mlp_act_backward": (
            lambda: [mk.mlp_act_backward(t["dH"], H, "relu")],
            lambda: [mk.mlp_act_backward_plain(t["dH"], H, "relu")],
            3 * t["A"].nbytes, B * R * h),
    }


def state_in_place(t, fn, adam: bool):
    """M2 (or its plain version) in place on one copy of the state: the
    call that is timed (a copy a call would be timed with it)."""
    s = {n: t[n].clone() for n in ("p", "m", "v", "t", "acc")}
    return lambda: fn(s["p"], t["g"], s["m"], s["v"] if adam else None,
                      s["t"] if adam else None, t["wmask"], t["alpha"],
                      t["wsum"], t["lr"], t["active"], t["loss"], s["acc"],
                      adam=adam)


def phase_mlp_kernels(seed: int, ptx: dict):
    """M1-M3 against their plain versions at every shape phase 11's paths
    give them.  At the searches' minibatch step (BASELINE #5: 12 lanes,
    k=10, P=4810; the MLPRegressor path: 6 lanes, k=1, d=8, P=641):
    times, bounds, registers and spills, a bitwise repeat check, and
    `torch._fused_adam_` (the adam core without the per-lane alpha, rate
    and mask) on the same buffers beside M2; sgd's M2 at BASELINE #5's
    shape, with `torch._fused_sgd_` beside it.  At the refit's one lane
    and the views' whole folds: the agreement.  Returns {(name, variant):
    row}."""
    import torch

    from spark_sklearn_tpu_torch.ops import mlp_kernels as mk

    rows = {}
    steps = {
        "baseline5": (dict(B=MLP_LANES), True),
        "regressor": (dict(B=len(MLP_REG_ALPHAS) * MLP_FOLDS, k=1, d=D_REG,
                           alphas=MLP_REG_ALPHAS), False),
    }
    # the mangled-name parts of each kernel's instantiation
    syms = {"mlp_loss_grad": "loss_grad", "mlp_opt_step": "opt_step",
            "mlp_act_forward": "act_forward",
            "mlp_act_backward": "act_backward"}

    def same_twice(label, fn):
        a, b = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{label}: two launches on the same inputs "
                                 "differ")

    def record(name, variant, call, timed=None, library=None, sym="",
               shape=None):
        fn, plain, nbytes, ops = call
        max_abs = mlp_disagreement(name, variant, fn(), plain())
        same_twice(f"{name} ({variant})", fn)
        fn, plain = timed or (fn, plain)
        bound_ms, bound_by = bound(nbytes, ops)
        # device times from graph replays; the wrapper's eager time (host
        # cost included) beside them
        ms, plain_ms = graph_ms(fn), graph_ms(plain, reps=20)
        lib_ms = graph_ms(library) if library else None
        wrapper_ms = cuda_ms(fn, reps=50, warmup=5)
        call_us = host_us(fn)
        regs, spill = mlp_symbol(ptx, syms[name], sym)
        rows[(name, variant)] = {
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "wrapper_ms": wrapper_ms, "host_us": call_us, "bytes": nbytes,
            "ops": ops, "registers": regs, "spill_bytes": spill,
            "shape": shape}
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"  {name:16s} {variant:9s} {shape}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.5f} ms by "
              f"{bound_by}, bound/time {bound_ms / ms:.4f}; eager wrapper "
              f"{wrapper_ms:.4f} ms, host {call_us:.1f} us a call), max abs "
              f"err {max_abs:.3g}, {regs} registers, {spill} bytes "
              "spilled, bitwise repeatable")

    for path, (shape, classifier) in steps.items():
        t = mlp_step_inputs(seed, **shape)
        B, R, k = t["Z"].shape
        dims = {"B": B, "R": R, "k": k, "h": MLP_HIDDEN,
                "P": t["p"].shape[1]}
        fused = {"p": [t["p"].clone()], "m": [t["m"].clone()],
                 "v": [t["v"].clone()],
                 "step": [torch.tensor(3.0, device="cuda")]}

        def fused_adam(fused=fused, g=t["g"]):
            torch._fused_adam_(fused["p"], [g], fused["m"], fused["v"], [],
                               fused["step"], lr=1e-3, beta1=0.9,
                               beta2=0.999, weight_decay=0.0, eps=1e-8,
                               amsgrad=False, maximize=False)

        # relu's backward: `threshold_backward` computes dH where H > 0,
        # else 0, in one call (autograd's own relu backward)
        H = mk.mlp_act_forward_plain(t["A"], t["b"], "relu")

        def relu_backward(dH=t["dH"], H=H):
            return torch.ops.aten.threshold_backward(dH, H, 0.0)

        if not torch.equal(relu_backward(),
                           mk.mlp_act_backward_plain(t["dH"], H, "relu")):
            raise AssertionError("threshold_backward is not relu's backward")
        libraries = {"mlp_opt_step": fused_adam,
                     "mlp_act_backward": relu_backward}
        for name, call in mlp_step_calls(t, classifier).items():
            opt = name == "mlp_opt_step"
            record(name, path, call,
                   timed=((state_in_place(t, mk.mlp_opt_step, True),
                           state_in_place(t, mk.mlp_opt_step_plain, True))
                          if opt else None),
                   library=libraries.get(name),
                   sym={"mlp_opt_step": "ILb1E",
                        # staged tiles
                        "mlp_loss_grad": ("ILb0ELb1E" if classifier
                                          else "ILb1ELb1E"),
                        # relu (1), 16 bytes a thread
                        "mlp_act_forward": "4ILi1E",
                        "mlp_act_backward": "4ILi1E"}[name],
                   shape=dims)
        # the output layer's bias gradient as a torch reduction over M1's
        # G (`dz.sum(dim=1)`, the step's launch before M1 returned it)
        kw = {"y": t["y"]} if classifier else {"Yt": t["Yt"]}
        G_out = mk.mlp_loss_grad(t["Z"], t["w"], **kw)[2]
        rows[("db_sum", path)] = {**three_times(lambda: G_out.sum(dim=1)),
                                  "shape": dims}
        print(f"  G.sum(dim=1)     {path:9s} {dims}: "
              f"{rows[('db_sum', path)]}")
        if classifier:
            # sgd with momentum, the family's other solver;
            # `torch._fused_sgd_` (the momentum core alone) beside it
            sgd = {"p": [t["p"].clone()], "m": [t["m"].clone()]}

            def fused_sgd(sgd=sgd, g=t["g"]):
                torch._fused_sgd_(sgd["p"], [g], sgd["m"], weight_decay=0.0,
                                  momentum=0.9, lr=1e-3, dampening=0.0,
                                  nesterov=False, maximize=False,
                                  is_first_step=False)

            record("mlp_opt_step", "sgd",
                   mlp_step_calls(t, True, adam=False)["mlp_opt_step"],
                   timed=(state_in_place(t, mk.mlp_opt_step, False),
                          state_in_place(t, mk.mlp_opt_step_plain, False)),
                   library=fused_sgd, sym="ILb0E",
                   shape={"B": B, "P": dims["P"]})
            tanh = mk.mlp_act_forward(t["A"], t["b"], "tanh")
            for a, b in ((tanh, mk.mlp_act_forward_plain(t["A"], t["b"],
                                                         "tanh")),
                         (mk.mlp_act_backward(t["dH"], tanh, "tanh"),
                          mk.mlp_act_backward_plain(t["dH"], tanh, "tanh"))):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        del t

    # the agreement alone at the other shapes of phase 11's paths: the
    # refit's one lane on BASELINE #5, and each search's views (M3
    # forward over every lane's whole fold)
    reg = dict(B=len(MLP_REG_ALPHAS) * MLP_FOLDS, k=1, d=D_REG,
               alphas=MLP_REG_ALPHAS)
    agree = [("baseline5_refit", dict(B=1), True, None),
             ("baseline5_views", dict(R=N), True, ("mlp_act_forward",)),
             ("regressor_views", dict(reg, R=N_REG), False,
              ("mlp_act_forward",))]
    for i, (label, shape, classifier, which) in enumerate(agree):
        t = mlp_step_inputs(seed + 1 + i, **shape)
        calls = mlp_step_calls(t, classifier)
        errs = {name: mlp_disagreement(name, label, calls[name][0](),
                                       calls[name][1]())
                for name in (which or calls)}
        dims = {"B": t["Z"].shape[0], "R": t["Z"].shape[1],
                "k": t["Z"].shape[2], "P": t["p"].shape[1]}
        rows[("agreement", label)] = {"shape": dims, "max_abs_err": errs}
        print(f"  agreement at {label} {dims}: max abs err {errs}")
        del t, calls
    torch.cuda.empty_cache()
    return rows


def mlp_pipeline(final, device):
    from spark_sklearn_tpu_torch import Pipeline, StandardScaler
    return Pipeline([("scale", StandardScaler()), ("f", final)],
                    device=device)


def mlp_search(final, grid, X, y, device, cv, refit=True):
    from spark_sklearn_tpu_torch import GridSearchCV, TorchConfig
    return GridSearchCV(mlp_pipeline(final, device), grid, cv=cv,
                        refit=refit,
                        config=TorchConfig(device=device)).fit(X, y)


def check_cuda_cpu(label, run, key="score"):
    """`run(device)` on cuda and on the CPU: mean_test_score within 5e-3
    (the repo's oracle bound) and the same best candidate."""
    res, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = run(dev)
        secs[dev] = time.perf_counter() - t0
    a = res["cuda"].cv_results_[f"mean_test_{key}"]
    b = res["cpu"].cv_results_[f"mean_test_{key}"]
    diff = float(np.abs(a - b).max())
    top = np.sort(b)[::-1]
    gap = float(top[0] - top[1]) if len(top) > 1 else None
    print(f"  {label} cuda against cpu: max |d mean_test_score| {diff:.3g} "
          f"(tolerance 5e-3), best {res['cuda'].best_params_} / "
          f"{res['cpu'].best_params_}, cpu gap to the second best {gap}; "
          f"cuda {secs['cuda']:.1f} s, cpu {secs['cpu']:.1f} s")
    if not diff <= 5e-3:
        raise AssertionError(f"{label}: cuda and cpu differ by {diff}")
    if res["cuda"].best_params_ != res["cpu"].best_params_:
        raise AssertionError(f"{label}: best_params_ differ")
    return {"max_abs": diff, "cpu_s": secs["cpu"], "cpu_best_gap": gap}


def phase_mlp(seed: int):
    """BASELINE config #5 on cuda with the port's own classes (cold with
    M1-M3's launches, warm, profiled), the refit pipeline predicting on
    the card, cuda against the CPU; then the MLPRegressor pipeline on
    phase 6's data and the StandardScaler + SVC pipeline on 2000 rows of
    phase 8's data, each with its launches and a cuda/cpu check."""
    import torch

    from spark_sklearn_tpu_torch import (
        KFold, MLPClassifier, MLPRegressor, SVC, StratifiedKFold)
    from spark_sklearn_tpu_torch.ops import mlp_kernels as mk
    from spark_sklearn_tpu_torch.ops import svm_kernels as svk

    X, y = digits_like(seed)
    grid = {"f__alpha": MLP_ALPHAS}
    clf = MLPClassifier(hidden_layer_sizes=(MLP_HIDDEN,), max_iter=60,
                        random_state=0)

    def run(device="cuda", refit=True):
        return mlp_search(clf, grid, X, y, device, MLP_FOLDS, refit)

    out = {}
    mk.reset_launches()
    t0 = time.perf_counter()
    gs = run()
    cold = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the MLP path")
    scores = gs.cv_results_["mean_test_score"]
    if scores.shape != (len(MLP_ALPHAS),) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"MLP: scores {scores}")
    if not gs.best_score_ > 0.3:                     # chance is 0.1
        raise AssertionError(f"MLP: best_score_ {gs.best_score_}")
    best = gs.best_estimator_
    pred = best.predict(X)
    refit_acc = float((pred == y).mean())
    proba = best.predict_proba(X[:100])
    if best.device != "cuda" or pred.shape != y.shape or \
            not refit_acc > 0.3 or not np.allclose(proba.sum(1), 1.0,
                                                    atol=1e-5):
        raise AssertionError(f"MLP refit on the card: accuracy {refit_acc}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs_w = run(refit=False)
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    epochs = gs_w.chunks_[0]["n_iter_exec"]
    steps = epochs * -(-N // MLP_BATCH)
    fits = MLP_LANES
    print(f"  BASELINE #5: StandardScaler + MLPClassifier(({MLP_HIDDEN},), "
          f"max_iter=60), {len(MLP_ALPHAS)} alphas x {MLP_FOLDS} folds = "
          f"{fits} lanes: cold {cold:.3f} s (with refit {gs.refit_time_:.3f}"
          f" s), warm {warm:.3f} s (refit=False), {fits / warm:.2f} fits/s,"
          f" {epochs} epochs ({steps} minibatch steps), chunks "
          f"{[(c['lanes'], c['n_iter_exec']) for c in gs_w.chunks_]}, peak "
          f"memory {peak / 2**20:.1f} MiB, launches {launches}")
    print(f"    best {gs.best_params_} score {gs.best_score_:.4f}; scores "
          f"{np.round(scores, 4).tolist()}; refit pipeline on the card: "
          f"accuracy {refit_acc:.4f} on the training rows")
    busy, by_name = profile_busy(lambda: run(refit=False), warm, steps,
                                 "chip_smoke_mlp.txt", with_kernels=True)
    n_kernels = sum(count for _, count in by_name.values())
    per_step = busy / steps * 1e3
    # each kernel's device time a launch on this path, from the profile
    path_ms = {}
    for name, part in (("mlp_loss_grad", "loss_grad"),
                       ("mlp_opt_step", "opt_step"),
                       ("mlp_act", "act_")):
        ns, count = map(sum, zip(*[v for k, v in by_name.items()
                                   if part in k and "anonymous" in k]))
        path_ms[name] = ns / count / 1e6
    print(f"    busy {per_step:.4f} ms and {n_kernels / steps:.1f} kernel "
          f"launches a minibatch step ({n_kernels} in all), idle share "
          f"{1 - busy / warm:.4f}; M1/M2/M3 launches a step "
          f"{launches['mlp_loss_grad'] / steps:.2f} / "
          f"{launches['mlp_opt_step'] / steps:.2f} / "
          f"{launches['mlp_act'] / steps:.2f} (cold run, refit included);"
          f" device ms a launch in the search {path_ms}")
    out["classifier"] = {
        "cold_s": cold, "warm_s": warm, "fits_per_s": fits / warm,
        "epochs": epochs, "steps": steps, "peak_bytes": peak,
        "launches": launches, "device_busy_s": busy,
        "busy_ms_per_step": per_step, "kernels_per_step": n_kernels / steps,
        "path_ms": path_ms,
        "idle_share": 1 - busy / warm, "best_params": gs.best_params_,
        "best_score": float(gs.best_score_), "refit_accuracy": refit_acc,
        "check": check_cuda_cpu("BASELINE #5",
                                lambda dev: run(dev, refit=False))}

    Xr, yr = california_like(seed)
    reg = MLPRegressor(hidden_layer_sizes=(MLP_HIDDEN,), max_iter=20,
                       random_state=0)
    reg_grid = {"f__alpha": [1e-4, 1.0]}

    def run_reg(device="cuda"):
        return mlp_search(reg, reg_grid, Xr, yr, device, KFold(3),
                          refit=False)

    mk.reset_launches()
    t0 = time.perf_counter()
    gr = run_reg()
    wall = time.perf_counter() - t0
    r_launch = dict(mk.LAUNCHES)
    r_scores = gr.cv_results_["mean_test_score"]
    if min(r_launch.values()) == 0 or not np.all(np.isfinite(r_scores)):
        raise AssertionError(f"MLP regressor: launches {r_launch}, scores "
                             f"{r_scores}")
    r_epochs = gr.chunks_[0]["n_iter_exec"]
    print(f"  MLPRegressor(({MLP_HIDDEN},), max_iter=20) pipeline, 2 alphas "
          f"x KFold(3), n={N_REG}: {wall:.3f} s (first run), {r_epochs} "
          f"epochs, r2 {np.round(r_scores, 4).tolist()}, launches "
          f"{r_launch}")
    out["regressor"] = {"wall_s": wall, "epochs": r_epochs,
                        "scores": r_scores.tolist(), "launches": r_launch,
                        "check": check_cuda_cpu("MLP regressor", run_reg)}

    Xs, ys = mnist_like(seed, N_SVM_CHECK)

    def run_svc(device="cuda"):
        return mlp_search(SVC(), {"f__C": [1.0, 10.0]}, Xs, ys, device,
                          StratifiedKFold(3), refit=False)

    svk.reset_launches()
    t0 = time.perf_counter()
    gv = run_svc()
    wall = time.perf_counter() - t0
    v_launch = {name: svk.LAUNCHES[name] for name in SVC_KERNELS}
    v_scores = gv.cv_results_["mean_test_score"]
    if min(v_launch.values()) == 0 or not np.all(np.isfinite(v_scores)) \
            or not v_scores.max() > 0.3:
        raise AssertionError(f"SVC pipeline: launches {v_launch}, scores "
                             f"{v_scores}")
    print(f"  StandardScaler + SVC pipeline, 2 C x 3 folds, n={N_SVM_CHECK},"
          f" d={D_SVM}: {wall:.3f} s, steps "
          f"{[c['n_iter_exec'] for c in gv.chunks_]}, accuracy "
          f"{np.round(v_scores, 4).tolist()}, launches {v_launch}")
    out["svc_pipeline"] = {"wall_s": wall, "scores": v_scores.tolist(),
                           "launches": v_launch,
                           "check": check_cuda_cpu("SVC pipeline", run_svc)}
    return out


# --- naive Bayes, LDA, KNN and KMeans: the kernel check and phase 12 -----

NB_SMOOTHING = np.logspace(-11, -5, 12)        # phase 12's GaussianNB grid
NB_ALPHAS = np.logspace(-3, 1, 20)             # the discrete NB families'
LDA_SHRINKAGE = [0.0, 0.01, 0.1, 0.5, 0.9]
KNN_K = [1, 3, 5, 7, 9, 11, 13, 15]
KMEANS_TOL = [1e-5, 1e-4, 1e-3, 1e-2]
KMEANS_K = 8
N_SLICE_CHECK = 2000                   # rows of the slice's cuda/cpu checks


def train_masks(y, splitter):
    """(folds, n) float32 train masks of `splitter` over labels y."""
    from spark_sklearn_tpu_torch.parallel.taskgrid import build_fold_masks
    return build_fold_masks(list(splitter.split(np.zeros(len(y)), y)),
                            len(y))[0]


def slice_symbol(ptxas: dict, part: str):
    """(registers, spilled bytes) of the first kernel whose mangled name
    holds `part`."""
    return next((v for f, v in ptxas.items() if part in f), (None, None))


def mufu_counts(lib, part: str) -> dict:
    """{MUFU op: count} in the SASS of the first kernel of `lib` whose
    mangled name holds `part` (cuobjdump -sass), or {} without
    cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if inside:
                break
            inside = part in m.group(1)
        elif inside:
            op = re.search(r"MUFU\.(\w+)", line)
            if op:
                counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return counts


def phase_slice_kernels(seed: int, ptxas: dict):
    """N1, C1 and B1 against their plain versions at phase 12's shapes:
    N1 at the KNN classifier's (MNIST-shaped, n=10000, 5 folds, max_k 15)
    and regressor's (n=20640) searches, C1 at the KMeans search's Lloyd
    step (covtype-shaped, n=100000, 20 lanes of 8 centers), B1 at the
    GaussianNB search's views (n=100000, d=54, 60 lanes, 7 classes, the
    family's own fit on the card); each timed in a CUDA graph and between
    events, with its bound, registers and a bitwise repeat check, beside
    the plain version and the library call that computes the same
    (torch.topk per fold for N1; for C1 the library GEMM X C_allᵀ that
    it took in, then torch.min on the formed distances; none for B1).
    N1 runs the plan `topk_plan` picks, and its radix plan is checked and
    timed beside it.  Returns {(name, variant): row}."""
    import torch

    from spark_sklearn_tpu_torch import KFold, StratifiedKFold
    from spark_sklearn_tpu_torch.models.naive_bayes import GaussianNBFamily
    from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
    from spark_sklearn_tpu_torch.ops import knn_kernels as knk
    from spark_sklearn_tpu_torch.ops import nb_kernels as nbk

    rows = {}

    def record(key, fn, plain, nbytes, ops, err, part, shape, library=None,
               extra=None):
        a, b = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{key}: two launches on the same inputs "
                                 "differ")
        bound_ms, bound_by = bound(nbytes, ops)
        ms = graph_ms(fn, reps=20)
        events = cuda_ms(fn, reps=10)
        plain_ms = cuda_ms(plain, reps=1, warmup=0)
        lib_ms = cuda_ms(library, reps=5) if library else None
        regs, spill = slice_symbol(ptxas, part)
        rows[key] = {"ms": ms, "events_ms": events, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "max_abs_err": err,
                     "bytes": nbytes, "ops": ops, "registers": regs,
                     "spill_bytes": spill, "shape": shape, **(extra or {})}
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"  {key[0]:14s} {key[1]:13s} {shape}: {ms:.4f} ms in a "
              f"graph, {events:.4f} ms between events (plain {plain_ms:.4f}"
              f" ms{lib}; bound {bound_ms:.5f} ms by {bound_by}, "
              f"bound/time {bound_ms / ms:.4f}), max abs err {err:.3g}, "
              f"{regs} registers, {spill} bytes spilled, bitwise "
              f"repeatable{'; ' + str(extra) if extra else ''}")

    # N1 at the KNN searches' chunks
    maxk = max(KNN_K)
    for variant, (X, y, splitter) in (
            ("knn", (*mnist_like(seed), StratifiedKFold(N_FOLDS))),
            ("knn_regressor", (*california_like(seed), KFold(N_FOLDS)))):
        Xt = torch.as_tensor(X, device="cuda")
        G = Xt @ Xt.T
        sq = (Xt * Xt).sum(dim=1)
        masks = torch.as_tensor(train_masks(y, splitter), device="cuda")
        n, F = len(X), masks.shape[0]
        d2, idx = knk.knn_fold_topk(G, sq, sq, masks, maxk)
        pd2, pidx = knk.knn_fold_topk_plain(G, sq, sq, masks, maxk)
        torch.cuda.synchronize()
        if not (torch.equal(idx, pidx) and torch.equal(d2, pd2)):
            bad = int((idx != pidx).sum())
            raise AssertionError(f"knn_fold_topk ({variant}): {bad} "
                                 "neighbors differ from the plain version")
        D = knk.sq_dists(G, sq, sq)
        inf = torch.tensor(float("inf"), device="cuda")
        Dm = [torch.where(masks[f] > 0, D, inf) for f in range(F)]
        del D
        plan = knk.topk_plan(n, maxk, F)
        radix = "staged" if n <= knk.STAGED_MAX_N else "streamed"
        rd2, ridx = knk.knn_fold_topk(G, sq, sq, masks, maxk, plan=radix)
        torch.cuda.synchronize()
        if not (torch.equal(ridx, pidx) and torch.equal(rd2, pd2)):
            raise AssertionError(f"knn_fold_topk ({variant}, {radix}): "
                                 "differs from the plain version")
        del rd2, ridx
        radix_ms = graph_ms(lambda: knk.knn_fold_topk(G, sq, sq, masks, maxk,
                                                      plan=radix), reps=10)
        record(("knn_fold_topk", variant),
               lambda: knk.knn_fold_topk(G, sq, sq, masks, maxk),
               lambda: knk.knn_fold_topk_plain(G, sq, sq, masks, maxk),
               4 * (n * n + F * n + 2 * n) + 8 * F * n * maxk, 3 * n * n,
               0.0, {"warp": "knn_topk_warp_kernel",
                     "staged": "knn_topk_kernelILb1E",
                     "streamed": "knn_topk_kernelILb0E"}[plan["plan"]],
               {"m": n, "n": n, "F": F, "maxk": maxk, "d": X.shape[1]},
               library=lambda: [torch.topk(Dm[f], maxk, dim=1,
                                           largest=False)
                                for f in range(F)],
               extra={"plan": plan["plan"], "smem": plan["smem"],
                      f"{radix}_plan_ms": radix_ms})
        del G, Dm, d2, idx, pd2, pidx

    # C1 at the KMeans search's Lloyd step, from X and the centers
    Xc, yc = covtype_like(seed)
    Xk = torch.as_tensor(Xc, device="cuda")
    n, d = Xc.shape
    B = len(KMEANS_TOL) * N_FOLDS
    rng = np.random.default_rng(seed)
    C = Xk[torch.as_tensor(rng.integers(0, n, (B, KMEANS_K)),
                           device="cuda")]                   # (B, k, d)
    xx = (Xk * Xk).sum(dim=1)
    cc = (C * C).sum(dim=2)
    w = torch.as_tensor(np.tile(train_masks(yc, KFold(N_FOLDS)),
                                (len(KMEANS_TOL), 1)), device="cuda")
    a, m, s = kmk.kmeans_assign(Xk, C, xx, cc, w)
    pa, pm, ps = kmk.kmeans_assign_plain(Xk, C, xx, cc, w)
    torch.cuda.synchronize()
    if not (torch.equal(a, pa) and torch.equal(m, pm)):
        raise AssertionError("kmeans_assign: assignments or distances "
                             "differ from the plain version")
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=0.0)
    C_all = C.reshape(B * KMEANS_K, d)

    def gemm_then_min():
        """The library route C1 took in: the GEMM X C_allᵀ, the distances
        formed from it, and their min and argmin."""
        XC = Xk @ C_all.T
        d2 = torch.clamp_min((xx[:, None] - 2.0 * XC)
                             + cc.reshape(1, B * KMEANS_K), 0.0)
        return torch.min(d2.view(n, B, KMEANS_K), dim=-1)

    lib_vals, lib_idx = gemm_then_min()
    plan = kmk.assign_plan(n, d, B)
    record(("kmeans_assign", "kmeans"),
           lambda: kmk.kmeans_assign(Xk, C, xx, cc, w),
           lambda: kmk.kmeans_assign_plain(Xk, C, xx, cc, w),
           4 * (n * d + B * KMEANS_K * d + n + B * KMEANS_K + B * n)
           + 8 * B * n + 4 * B,
           2 * n * B * KMEANS_K * d + 4 * n * B * KMEANS_K,
           float((m - pm).abs().max()),
           f"assign_kernelILi{plan['vec']}E",
           {"n": n, "d": d, "B": B, "k": KMEANS_K},
           library=gemm_then_min,
           extra={"inertia_max_rel_err": float(
               ((s - ps).abs() / ps.abs()).max()),
               "plan": {k: plan[k] for k in ("lanes", "rows", "dtile",
                                             "dpad", "vec", "grid",
                                             "smem")},
               "library_assign_differs": int(
                   (lib_idx.T.to(torch.int32) != a).sum()),
               "library_min_d2_max_abs_diff": float(
                   (lib_vals.T - m).abs().max())})
    del w, lib_vals, lib_idx

    # B1 at the GaussianNB search's views, on the family's own fit
    data_np, meta = GaussianNBFamily.prepare_data(Xc, yc)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in data_np.items()}
    folds = train_masks(yc, StratifiedKFold(N_FOLDS))
    B = len(NB_SMOOTHING) * N_FOLDS
    model = GaussianNBFamily.fit_task_batched(
        {"var_smoothing": torch.as_tensor(
            np.repeat(NB_SMOOTHING, N_FOLDS).astype(np.float32),
            device="cuda")},
        {"__n_folds__": N_FOLDS}, data,
        torch.as_tensor(np.tile(folds, (len(NB_SMOOTHING), 1)),
                        device="cuda"), meta)
    args = (data["X"], model["theta"], model["var"], model["log_prior"])
    got, want = nbk.gnb_jll(*args), nbk.gnb_jll_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    k = meta["n_classes"]
    plan = nbk.jll_plan(n, d, B, k,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    record(("gnb_jll", "gaussian_nb"), lambda: (nbk.gnb_jll(*args),),
           lambda: (nbk.gnb_jll_plain(*args),),
           4 * (n * d + 2 * B * k * d + B * k + B * n * k),
           4 * B * n * k * d, float((got - want).abs().max()),
           f"gnb_jll_kernelILi{plan['kc']}E", {"m": n, "d": d, "B": B,
                                               "k": k},
           extra={"max_rel_err": float(((got - want).abs()
                                        / want.abs().clamp_min(1.0)).max()),
                  "plan": plan})
    del got, want, data, model
    torch.cuda.empty_cache()
    return rows


def slice_check(label, run, keys, tol, relative=False):
    """`run(device)` on cuda and on the CPU: each mean_test_<key> within
    `tol` (times the largest |score| where `relative`), and the same best
    candidate where the CPU's best leads its second by more than twice
    that."""
    res, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = run(dev)
        secs[dev] = time.perf_counter() - t0
    out = {"cpu_s": secs["cpu"], "cuda_s": secs["cuda"]}
    for key in keys:
        a = res["cuda"].cv_results_[f"mean_test_{key}"]
        b = res["cpu"].cv_results_[f"mean_test_{key}"]
        diff = float(np.abs(a - b).max())
        limit = tol * float(np.abs(b).max()) if relative else tol
        top = np.sort(b)[::-1]
        gap = float(top[0] - top[1]) if len(top) > 1 else None
        same = int(np.argmax(a)) == int(np.argmax(b))
        print(f"  {label} cuda against cpu ({key}): max |d mean_test| "
              f"{diff:.3g} (tolerance {limit:.3g}), same best {same}, cpu "
              f"gap to the second {gap}; cuda {secs['cuda']:.1f} s, cpu "
              f"{secs['cpu']:.1f} s")
        if not diff <= limit:
            raise AssertionError(f"{label}: cuda and cpu differ by {diff}")
        if gap is not None and gap > 2 * limit and not same:
            raise AssertionError(f"{label}: the best candidate differs")
        out[key] = {"max_abs": diff, "tolerance": limit,
                    "cpu_best_gap": gap, "same_best": same}
    return out


def slice_search(label, est, grid, X, y, cv, scoring, kernels, check,
                 min_score=None):
    """One search of phase 12 on cuda with the port's own classes: cold
    with its kernels' launches, warm, profiled (busy ms, device launches,
    idle share), then `check` = (rows, grid, cv, tolerance, relative)
    against the CPU on a subset."""
    import torch

    from spark_sklearn_tpu_torch import GridSearchCV, TorchConfig

    def run(device, Xs=X, ys=y, g=grid, folds=cv):
        return GridSearchCV(est, g, cv=folds, scoring=scoring, refit=False,
                            config=TorchConfig(device=device)).fit(Xs, ys)

    for mod in kernels:
        mod.reset_launches()
    t0 = time.perf_counter()
    gs = run("cuda")
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {name: c for mod in kernels for name, c in
                mod.LAUNCHES.items()}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on {label}'s path")
    keys = list(scoring) if isinstance(scoring, list) else ["score"]
    for key in keys:
        sc = gs.cv_results_[f"mean_test_{key}"]
        if not np.all(np.isfinite(sc)):
            raise AssertionError(f"{label}: non-finite {key} {sc}")
    best = float(np.max(gs.cv_results_[f"mean_test_{keys[0]}"]))
    if min_score is not None and not best > min_score:
        raise AssertionError(f"{label}: best {keys[0]} {best}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs_w = run("cuda")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fits = len(gs_w.cv_results_["params"]) * gs_w.n_splits_
    busy, by_name = profile_busy(lambda: run("cuda"), warm, 1,
                                 f"chip_smoke_{label}.txt",
                                 with_kernels=True, top=4, primed=True)
    n_launch = sum(count for _, count in by_name.values())
    iters = [c.get("n_iter_exec") for c in gs_w.chunks_]
    print(f"  {label}: {fits} fits ({len(gs_w.chunks_)} chunks, lanes "
          f"{[c['lanes'] for c in gs_w.chunks_]}, iterations {iters}), "
          f"cold {cold:.3f} s, warm {warm:.3f} s, {fits / warm:.1f} fits/s,"
          f" busy {busy * 1e3:.3f} ms, {n_launch} device launches, idle "
          f"share {1 - busy / warm:.4f}, peak {peak / 2**20:.1f} MiB, "
          f"kernel launches {launches}, best {keys[0]} {best:.4f}")
    rows_c, grid_c, cv_c, tol, relative = check
    sub = slice(0, rows_c)
    return {"cold_s": cold, "warm_s": warm, "fits": fits,
            "fits_per_s": fits / warm, "device_busy_s": busy,
            "device_launches": n_launch,
            "idle_share": None if busy is None else 1 - busy / warm,
            "peak_bytes": peak, "launches": launches, "best": best,
            "chunks": gs_w.chunks_,
            "check": slice_check(
                label, lambda dev: run(dev, X[sub], None if y is None
                                       else y[sub], grid_c, cv_c),
                keys, tol, relative)}


def phase_slice(seed: int):
    """The slice's searches at full width on the card (module docstring,
    phase 12), each against the CPU on a subset."""
    from spark_sklearn_tpu_torch import (
        BernoulliNB, CategoricalNB, ComplementNB, GaussianNB, KFold, KMeans,
        KNeighborsClassifier, KNeighborsRegressor,
        LinearDiscriminantAnalysis, MultinomialNB, StratifiedKFold)
    from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
    from spark_sklearn_tpu_torch.ops import knn_kernels as knk
    from spark_sklearn_tpu_torch.ops import nb_kernels as nbk

    Xc, yc = covtype_like(seed)
    Xd, yd = digits_like(seed)
    counts = np.round(Xd * 16.0)
    Xm, ym = mnist_like(seed)
    Xr, yr = california_like(seed)
    skf, kf = StratifiedKFold(N_FOLDS), KFold(N_FOLDS)
    skf3, kf3 = StratifiedKFold(3), KFold(3)
    out = {"gaussian_nb": slice_search(
        "gaussian_nb", GaussianNB(), {"var_smoothing": NB_SMOOTHING}, Xc,
        yc, skf, ["accuracy", "neg_log_loss"], [nbk],
        (N_SLICE_CHECK, {"var_smoothing": NB_SMOOTHING[::4]}, skf3, 5e-3,
         False), min_score=0.3)}
    for label, est, X in (
            ("multinomial_nb", MultinomialNB(), counts),
            ("complement_nb", ComplementNB(), counts),
            ("bernoulli_nb", BernoulliNB(), counts),
            ("categorical_nb", CategoricalNB(), counts.astype(np.int64))):
        out[label] = slice_search(
            label, est, {"alpha": NB_ALPHAS}, X, yd, skf, "accuracy", [],
            (N_SLICE_CHECK, {"alpha": NB_ALPHAS[::5]}, skf3, 5e-3, False),
            min_score=0.2)
    out["lda"] = slice_search(
        "lda", LinearDiscriminantAnalysis(solver="lsqr"),
        {"shrinkage": LDA_SHRINKAGE}, Xm, ym, skf, "accuracy", [],
        (N_SLICE_CHECK, {"shrinkage": [0.01, 0.5]}, skf3, 5e-3, False),
        min_score=0.2)
    out["knn"] = slice_search(
        "knn", KNeighborsClassifier(),
        {"n_neighbors": KNN_K, "weights": ["uniform", "distance"]}, Xm, ym,
        skf, "accuracy", [knk],
        (N_SLICE_CHECK, {"n_neighbors": [1, 5],
                         "weights": ["uniform", "distance"]}, skf3, 5e-3,
         False), min_score=0.2)
    out["knn_regressor"] = slice_search(
        "knn_regressor", KNeighborsRegressor(), {"n_neighbors": KNN_K}, Xr,
        yr, kf, "r2", [knk],
        (N_SLICE_CHECK, {"n_neighbors": [1, 5]}, kf3, 5e-3, False))
    out["kmeans"] = slice_search(
        "kmeans", KMeans(n_clusters=KMEANS_K, n_init=1, random_state=0),
        {"tol": KMEANS_TOL}, Xc, None, kf, None, [kmk],
        (N_SLICE_CHECK, {"tol": KMEANS_TOL[1::2]}, kf3, 1e-3, True))
    return out


# --- the rest of the SVMs: the kernel check and phase 13 -----------------

SVR_C = [1.0, 10.0, 100.0]             # phase 13's SVR grid: C x epsilon
SVR_EPS = [0.1, 0.5]
SVR_NU = [0.25, 0.5, 0.75]             # NuSVR's nu
LIN_C = [0.01, 0.1, 1.0]               # LinearSVC's and LinearSVR's C
N_REST_CHECK = 2000                    # rows of phase 13's cuda/cpu checks
COUPLING_KS = (26, 50)                 # P2's classes past phase 13's 10


def proba_inputs(seed: int):
    """P1's and P2's inputs at phase 13's SVC search: the 45 tasks (9
    candidates x StratifiedKFold(5)) of MNIST-shaped labels, their fold
    weights and a (45, 10000, 45) cache of pair decisions, N(0, 1.5)
    moved by +1 on the pair's first class and -1 on its second (trained
    decisions' sign), made on the card from `seed`."""
    import torch

    from spark_sklearn_tpu_torch import StratifiedKFold
    from spark_sklearn_tpu_torch.models.svm import _pairs

    _, y = mnist_like(seed)
    pairs = _pairs(K_SVM)
    tasks = len(SVM_C) * len(SVM_GAMMA) * N_FOLDS
    masks = train_masks(y, StratifiedKFold(N_FOLDS))
    tw = torch.as_tensor(np.tile(masks, (tasks // N_FOLDS, 1)),
                         device="cuda")
    yt = torch.as_tensor(y.astype(np.int32), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    dec = 1.5 * torch.randn((tasks, N_SVM, len(pairs)), generator=g,
                            device="cuda")
    pt = torch.as_tensor(pairs, device="cuda").long()
    sign = ((yt.long()[:, None] == pt[None, :, 0]).float()
            - (yt.long()[:, None] == pt[None, :, 1]).float())    # (n, P)
    dec += sign[None]
    return dec.contiguous(), yt, tw, pairs


def coupling_inputs(seed: int, k: int):
    """P2's inputs for k classes at phase 13's 450000 problems (45 tasks x
    n = 10000), made on the card from `seed`: labels uniform over the k
    classes, pair decisions N(0, 1.5) moved by +1 on the pair's first
    class and -1 on its second (as `proba_inputs`), and a (task, pair)'s
    Platt sigmoid A in [-2, -1), B N(0, 0.2)."""
    import torch

    from spark_sklearn_tpu_torch.models.svm import _pairs

    g = torch.Generator(device="cuda").manual_seed(seed + k)
    tasks = len(SVM_C) * len(SVM_GAMMA) * N_FOLDS
    pairs = _pairs(k)
    y = torch.randint(0, k, (N_SVM,), generator=g, device="cuda")
    pt = torch.as_tensor(pairs, device="cuda").long()
    sign = ((y[:, None] == pt[None, :, 0]).float()
            - (y[:, None] == pt[None, :, 1]).float())
    dec = 1.5 * torch.randn((tasks, N_SVM, len(pairs)), generator=g,
                            device="cuda")
    dec += sign[None]
    del sign
    A = -1.0 - torch.rand((tasks, len(pairs)), generator=g, device="cuda")
    B = 0.2 * torch.randn((tasks, len(pairs)), generator=g, device="cuda")
    return dec, torch.stack([A, B], dim=-1).contiguous(), pairs


def svr_step_inputs(seed: int, mode: str):
    """One S2 SVR-mode step at phase 13's SVR search (KFold(5) folds of
    the California-shaped rows, C = 10; n = 20640 pairs a row, streamed):
    iterates inside the box, a product of the size a solve sees."""
    import torch

    from spark_sklearn_tpu_torch import KFold

    _, y = california_like(seed)
    masks = train_masks(y, KFold(N_FOLDS))
    M, n = masks.shape
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    bh = 10.0 * torch.as_tensor(masks, device="cuda")
    z = bh.repeat(1, 2) * torch.rand((M, 2 * n), generator=g,
                                     device="cuda")
    x = bh.repeat(1, 2) * torch.rand((M, 2 * n), generator=g,
                                     device="cuda")
    V = torch.randn((M, n), generator=g, device="cuda")
    yt = torch.as_tensor(y, device="cuda")
    step = torch.tensor(0.01, device="cuda")
    if mode == "svr":
        return (V, z, x, yt, torch.full((M,), 0.1, device="cuda"), bh, step,
                0.3, None)
    return (V, z, x, yt, None, bh, step, 0.3, 0.25 * bh.sum(dim=1))


def phase_proba_kernels(seed: int, n_sm: int, sm_mhz: float, ptxas: dict):
    """P1 (Platt fit: with its exit, and run for all 50 steps), P2
    (pairwise coupling, each plan) and S2's SVR mode (epsilon-SVR and
    nu-SVR, a cluster of CTAs a row as the plan picks it for this card,
    and of 8 CTAs) against their plain versions at phase 13's shapes,
    each timed between CUDA events (S2 also in a CUDA graph, five times,
    with how many of its clusters the card holds at once), with its
    bound, registers and a bitwise repeat check; no single PyTorch call
    computes any of them (library_ms null).  Returns {(name, variant):
    row}."""
    import torch

    from spark_sklearn_tpu_torch.ops import _build
    from spark_sklearn_tpu_torch.ops import svm_kernels as svk
    from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk

    rows = {}
    sfu_per_ms = n_sm * SFU_PER_CLOCK_PER_SM * sm_mhz * 1e3

    def record(key, fn, plain, err, nbytes, ops, part, shape, graph=False,
               sfu=0, tol="", extra=None, plain_ms=None):
        a, b = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{key}: two launches on the same inputs "
                                 "differ")
        bound_ms, bound_by = bound(nbytes, ops)
        if sfu / sfu_per_ms > bound_ms:
            bound_ms, bound_by = sfu / sfu_per_ms, "operations"
        events = cuda_ms(fn, reps=10)
        ms = graph_ms(fn, reps=20) if graph else events
        if plain_ms is None:
            plain_ms = cuda_ms(plain, reps=1, warmup=0)
        regs, spill = slice_symbol(ptxas, part)
        rows[key] = {"ms": ms, "events_ms": events, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "max_abs_err": err,
                     "bytes": nbytes, "ops": ops, "sfu_ops": sfu,
                     "registers": regs, "spill_bytes": spill,
                     "shape": shape, "tolerance": tol, **(extra or {})}
        print(f"  {key[0]:17s} {key[1]:10s} {shape}: {ms:.4f} ms"
              f"{' in a graph' if graph else ''}, {events:.4f} ms between "
              f"events (plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms by"
              f" {bound_by}, bound/time {bound_ms / ms:.4f}), max abs err "
              f"{err:.3g} ({tol}), {regs} registers, {spill} bytes spilled,"
              f" bitwise repeatable{'; ' + str(extra) if extra else ''}")

    dec, y, tw, pairs = proba_inputs(seed)
    B, n, P = dec.shape
    steps = torch.zeros((B * P, 2), dtype=torch.int32, device="cuda")
    A, Bo = pk.platt_fit(dec, y, tw, pairs, False, steps=steps)
    steps50 = torch.zeros_like(steps)
    A50, B50 = pk.platt_fit(dec, y, tw, pairs, False, plan="staged_full",
                            steps=steps50)
    pA, pB = pk.platt_fit_rows_plain(dec, y, tw, pairs, False)
    torch.cuda.synchronize()
    err = max(float((A - pA).abs().max()), float((Bo - pB).abs().max()))
    torch.testing.assert_close(A, pA, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(Bo, pB, rtol=1e-3, atol=1e-3)
    # the exit leaves every row at its fixed point: the 50-step bits
    if not (torch.equal(A.view(torch.int32), A50.view(torch.int32)) and
            torch.equal(Bo.view(torch.int32), B50.view(torch.int32))):
        raise AssertionError("svm_platt_fit: the exit's A and B differ "
                             "from the 50-step run's")
    del A50, B50
    pt = torch.as_tensor(pairs, device="cuda").long()
    yl = y.long()
    in_pair = (yl[None, :] == pt[:, 0:1]) | (yl[None, :] == pt[:, 1:2])
    kept_rows = ((tw[:, None, :] > 0) & in_pair[None]).sum(dim=2).reshape(-1)
    kept = int(kept_rows.sum())
    # the work of this run's rows, from the kernel's own counts: each
    # Newton step's gradient pass over the row's kept elements and, at
    # the steps whose gradient is at least 1e-5, the trial pass; with the
    # exit the steps up to the row's fixed point (`steps`), without it
    # all 50 (`steps50`).  Per element, from the kernel's SASS
    # (cuobjdump -sass, an FFMA counted as 2): the gradient pass
    # P1_GRAD_OPS FP32 operations and 2 SFU results (the sigmoid's
    # MUFU.EX2 and MUFU.RCP), the trial pass P1_TRIAL_OPS and 8 (a
    # MUFU.EX2 a halving; CUDA's log1pf is a polynomial on the FP32
    # pipes, no MUFU).  The MUFU counts of this build are kept in the row.
    mufu = mufu_counts(_build.library_path("svm_proba"),
                       "platt_fit_kernelILb1ELb1E")

    def work(st):
        st = st.long()
        grad_el = int((kept_rows * st[:, 0]).sum())
        trial_el = int((kept_rows * st[:, 1]).sum())
        return (grad_el * P1_GRAD_OPS + trial_el * P1_TRIAL_OPS,
                grad_el * 2 + trial_el * pk.N_HALVINGS, grad_el, trial_el)

    ops, sfu, grad_el, trial_el = work(steps)
    ops50, sfu50, grad50, trial50 = work(steps50)
    nbytes = 4 * (B * n * P + n + B * n + 2 * B * P) + 8 * P
    st = steps[:, 0].float()
    b50 = bound(nbytes, ops50)
    if sfu50 / sfu_per_ms > b50[0]:
        b50 = (sfu50 / sfu_per_ms, "operations")
    tol = ("A and B rtol 1e-3 atol 1e-3 (float32 sums over ~1600 kept "
           "elements in another order, through the Newton steps)")
    plan = pk.platt_plan(n)
    record(("svm_platt_fit", "svc_proba"),
           lambda: pk.platt_fit(dec, y, tw, pairs, False),
           lambda: pk.platt_fit_rows_plain(dec, y, tw, pairs, False), err,
           nbytes, ops, "platt_fit_kernelILb1ELb1E",
           {"tasks": B, "n": n, "P": P}, sfu=sfu, tol=tol,
           extra={"plan": plan, "kept_elements": kept,
                  "kept_share": kept / (B * n * P),
                  "steps_min_median_max": [int(st.min()),
                                           float(st.median()),
                                           int(st.max())],
                  "steps_share": grad_el / (kept * pk.N_NEWTON),
                  "trial_steps_share": trial_el / (kept * pk.N_NEWTON),
                  "ops_50_steps": ops50, "sfu_ops_50_steps": sfu50,
                  "bound_ms_50_steps": b50[0], "bound_by_50_steps": b50[1],
                  "equal_to_50_steps": True, "sass_mufu": mufu})
    record(("svm_platt_fit", "staged_full"),
           lambda: pk.platt_fit(dec, y, tw, pairs, False,
                                plan="staged_full"),
           lambda: pk.platt_fit_rows_plain(dec, y, tw, pairs, False), err,
           nbytes, ops50, "platt_fit_kernelILb1ELb0E",
           {"tasks": B, "n": n, "P": P}, sfu=sfu50, tol=tol,
           extra={"plan": pk.platt_plan(n, "staged_full"),
                  "trial_steps_share": trial50 / (kept * pk.N_NEWTON)})
    del steps, steps50
    platt = torch.stack([A, Bo], dim=1).reshape(B, P, 2).contiguous()
    del pA, pB, tw
    lib = _build.library_path("svm_proba")

    def coupling(dec, platt, pairs, k, label):
        """P2's rows at k classes: every plan that serves k."""
        T, n, P = dec.shape
        want = pk.pair_coupling_plain(dec, platt, pairs, k)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: pk.pair_coupling_plain(dec, platt, pairs,
                                                          k),
                           reps=1, warmup=0)
        # the fewest operations of the deferred form, a sweep: Qp = Q p
        # (2 k^2, an FMA counted as 2), pq (2 k), the steps' updates of
        # (Qp)~ past t (k (k - 1)) and their scalars (11 a step), the
        # renormalisation (k); SFU: a reciprocal a step and a sweep.  R and
        # Q ~13 a pair and 2 SFU (the sigmoid's exp and reciprocal).
        per_sweep, sfu_sweep = 3 * k * k + 13 * k, k + 1
        ops = T * n * (pk.N_SWEEPS * per_sweep + 13 * P)
        sfu = T * n * (pk.N_SWEEPS * sfu_sweep + 2 * P)
        nbytes = 4 * (T * n * P + 2 * T * P + T * n * k) + 8 * P
        count = {"ops_per_sweep": per_sweep, "sfu_per_sweep": sfu_sweep}
        default = pk.coupling_plan(k)["plan"]
        for plan in pk.COUPLING_PLANS:
            try:
                pl = pk.coupling_plan(k, plan, T * n)
            except ValueError:
                continue
            got = pk.pair_coupling(dec, platt, pairs, k, plan=plan)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
            part = {"registers": f"pair_coupling_regILi{k}E",
                    "group": "pair_coupling_groupILi{group}ELi{slots}E",
                    "shared": "pair_coupling_memILb0E",
                    "global": "pair_coupling_memILb1E"}[plan]
            part = part.format(**pl)
            extra = {"plan": pl, "k": k, "default": plan == default,
                     **count}
            if plan == default:
                extra["sass_mufu"] = mufu_counts(lib, part)
            record(("svm_pair_coupling",
                    plan if label is None else f"{label}_{plan}"),
                   lambda p=plan: (pk.pair_coupling(dec, platt, pairs, k,
                                                    plan=p),),
                   None, float((got - want).abs().max()), nbytes, ops, part,
                   {"tasks": T, "n": n, "k": k}, sfu=sfu,
                   tol="atol 1e-4 on probabilities (the deferred rescale, "
                       "a reciprocal on the SFU, sums in another order)",
                   extra=extra, plain_ms=plain_ms)
            del got
        del want
        torch.cuda.empty_cache()

    coupling(dec, platt, pairs, K_SVM, None)
    del dec, platt
    torch.cuda.empty_cache()
    for k in COUPLING_KS:
        cdec, cplatt, cpairs = coupling_inputs(seed, k)
        coupling(cdec, cplatt, cpairs, k, f"k{k}")
        del cdec, cplatt
        torch.cuda.empty_cache()

    for mode in ("svr", "nu"):
        args = svr_step_inputs(seed, mode)
        M, n = args[5].shape
        m = 0 if mode == "svr" else 1
        # reads V, bound (M, n), z, x (M, 2n), y (n), eps or target (M);
        # writes x', z' (M, 2n), beta' (M, n), resid (M).  Operations: the
        # gradient (~6) and the last pass (~8) at every element, the 40
        # bisection steps (~4) at the elements with a bound
        kept = 2 * int((args[5] != 0).sum())
        nbytes = 4 * (11 * M * n + n + 2 * M)
        ops = M * 2 * n * 14 + kept * svk.N_BISECT * 4
        want = svk.svr_dual_step_plain(*args)
        held = functools.partial(svk.svr_clusters, torch.cuda.current_device(),
                                 n, mode == "nu")
        for variant, cluster in ((mode, None), (f"{mode}_c8", 8)):
            sp = svk.svr_step_plan(n, M, cluster, held)
            got = svk.svr_dual_step(*args, plan=sp)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
            fn = lambda a=args, p=sp: svk.svr_dual_step(*a, plan=p)
            record(("svm_svr_step", variant), fn,
                   lambda a=args: svk.svr_dual_step_plain(*a), max(errs[:3]),
                   nbytes, ops, f"svr_cluster_stepILi{m}EE",
                   {"M": M, "n": n, "mode": mode}, graph=True,
                   tol="x', z', beta' rtol 1e-5 atol 1e-4; the bisection's "
                       "sums in another order",
                   extra={"plan": sp, "resid_max_abs_err": errs[3],
                          "clusters_held": held(sp["cluster"]),
                          "clusters_held_by_size": {
                              C: held(C) for C in (16, 12, 8, 4)},
                          "graph_ms_repeats": [graph_ms(fn, reps=20)
                                               for _ in range(5)]})
            del got
        del want, args
    torch.cuda.empty_cache()
    return rows


def rest_search(label, run, kernels, scoring, check, min_score=None,
                path=None, profile=True):
    """One search of phase 13 on cuda: cold, with the launches of the
    kernel modules `kernels` (each kernel in `path`, all of them by
    default, must launch), warm, profiled (busy ms, device launches, idle
    share; `profile` False skips it: the profiler takes ~4x the warm wall
    over the ~10^5 small launches of LinearSVC's and LinearSVR's loops),
    then `check` = (run_small, tolerance) on cuda against the CPU."""
    import torch

    for mod in kernels:
        mod.reset_launches()
    t0 = time.perf_counter()
    gs = run("cuda", True)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {name: c for mod in kernels for name, c in
                mod.LAUNCHES.items()}
    for name in (launches if path is None else path):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on {label}'s path")
    keys = list(scoring) if isinstance(scoring, list) else ["score"]
    for key in keys:
        sc = gs.cv_results_[f"mean_test_{key}"]
        if not np.all(np.isfinite(sc)):
            raise AssertionError(f"{label}: non-finite {key} {sc}")
    best = float(np.max(gs.cv_results_[f"mean_test_{keys[0]}"]))
    if min_score is not None and not best > min_score:
        raise AssertionError(f"{label}: best {keys[0]} {best}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs_w = run("cuda", False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fits = len(gs_w.cv_results_["params"]) * gs_w.n_splits_
    busy, by_name = (profile_busy(lambda: run("cuda", False), warm, 1,
                                  f"chip_smoke_{label}.txt",
                                  with_kernels=True, top=6)
                     if profile else (None, {}))
    n_launch = sum(count for _, count in by_name.values())
    iters = [c.get("n_iter_exec") for c in gs_w.chunks_]
    print(f"  {label}: {fits} fits (chunks {[c['lanes'] for c in gs_w.chunks_]}"
          f", iterations {iters}), cold {cold:.3f} s, warm {warm:.3f} s, "
          f"{fits / warm:.1f} fits/s, busy "
          f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}, "
          f"{n_launch} device launches, peak {peak / 2**20:.1f} MiB, kernel "
          f"launches {launches}, best {keys[0]} {best:.4f}")
    run_small, tol = check
    return {"cold_s": cold, "warm_s": warm, "fits": fits,
            "fits_per_s": fits / warm, "device_busy_s": busy,
            "device_launches": n_launch,
            "idle_share": None if busy is None else 1 - busy / warm,
            "peak_bytes": peak, "launches": launches, "best": best,
            "chunks": gs_w.chunks_,
            "kernel_split_ms": {name: ns / 1e6 for name, (ns, _) in
                                sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:8]},
            "check": slice_check(label, run_small, keys, tol)}


def phase_svm_rest(seed: int):
    """The rest of the SVMs at their sources' widths (module docstring,
    phase 13), each against the CPU on a subset."""
    import warnings

    import torch

    from spark_sklearn_tpu_torch import (
        SVC, SVR, GridSearchCV, KFold, LinearSVC, LinearSVR, NuSVR,
        StratifiedKFold, TorchConfig)
    from spark_sklearn_tpu_torch.ops import svm_kernels as svk
    from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk

    Xm, ym = mnist_like(seed)
    Xr, yr = california_like(seed)
    gamma0 = 1.0 / (D_SVM * float(np.var(Xm)))
    grid = {"C": SVM_C, "gamma": [f * gamma0 for f in SVM_GAMMA]}
    per = N_REST_CHECK // K_SVM
    idx = np.concatenate([np.where(ym == c)[0][:per] for c in range(K_SVM)])
    out = {}

    def search(est, g, X, y, cv, scoring, refit, device, sw=None):
        kw = {} if sw is None else {"sample_weight": sw}
        with warnings.catch_warnings():
            # the reference's warning on in-sample Platt calibration
            warnings.simplefilter("ignore", UserWarning)
            return GridSearchCV(est, g, cv=cv, scoring=scoring, refit=refit,
                                config=TorchConfig(device=device)).fit(
                X, y, **kw)

    proba_scoring = ["accuracy", "neg_log_loss"]

    def svc_run(device, cold):
        gs = search(SVC(kernel="rbf", probability=True), grid, Xm, ym,
                    StratifiedKFold(N_FOLDS), proba_scoring,
                    "accuracy" if cold else False, device)
        if cold:
            # the refit SVC(probability=True) on the card: its Platt
            # sigmoids and coupled probabilities of 2000 rows
            proba = gs.best_estimator_.predict_proba(Xm[:N_SVM_CHECK])
            if proba.shape != (N_SVM_CHECK, K_SVM) or not np.allclose(
                    proba.sum(axis=1), 1.0, atol=1e-4):
                raise AssertionError(f"SVC refit predict_proba: {proba}")
            gs.refit_proba_ = proba
        return gs

    out["svc_proba"] = rest_search(
        "svc_proba", svc_run, [svk, pk], proba_scoring,
        (lambda dev: search(SVC(kernel="rbf", probability=True),
                            {"C": SVM_C[:2], "gamma": [gamma0]}, Xm[idx],
                            ym[idx], StratifiedKFold(3), proba_scoring,
                            False, dev), 5e-3), min_score=0.3,
        path=SVC_KERNELS + tuple(pk.LAUNCHES))
    # the same search weighted (phase 14's), against the CPU on the subset
    sw = weights(seed, len(ym))
    out["svc_proba_weighted"] = rest_search(
        "svc_proba_weighted", lambda dev, cold: search(
            SVC(kernel="rbf", probability=True), grid, Xm, ym,
            StratifiedKFold(N_FOLDS), proba_scoring, False, dev, sw),
        [svk, pk], proba_scoring,
        (lambda dev: search(SVC(kernel="rbf", probability=True),
                            {"C": SVM_C[:2], "gamma": [gamma0]}, Xm[idx],
                            ym[idx], StratifiedKFold(3), proba_scoring,
                            False, dev, sw[idx]), 5e-3), min_score=0.3,
        path=SVC_KERNELS + tuple(pk.LAUNCHES))
    for label, est, g in (
            ("svr", SVR(kernel="rbf"), {"C": SVR_C, "epsilon": SVR_EPS}),
            ("nu_svr", NuSVR(kernel="rbf"), {"nu": SVR_NU})):
        small = {k: v[:2] for k, v in g.items()}
        out[label] = rest_search(
            label, lambda dev, cold, e=est, gg=g: search(
                e, gg, Xr, yr, KFold(N_FOLDS), "r2", False, dev),
            [svk], "r2",
            (lambda dev, e=est, gg=small: search(
                e, gg, Xr[:N_REST_CHECK], yr[:N_REST_CHECK], KFold(3), "r2",
                False, dev), 5e-3),
            path=("svm_gram_epilogue", "svm_svr_step"))
    lin_grid = {"C": LIN_C, "loss": ["hinge", "squared_hinge"]}
    out["linear_svc"] = rest_search(
        "linear_svc", lambda dev, cold: search(
            LinearSVC(), lin_grid, Xm, ym, StratifiedKFold(N_FOLDS),
            "accuracy", False, dev), [], "accuracy",
        (lambda dev: search(LinearSVC(), {"C": LIN_C[:2], "loss": [
            "hinge", "squared_hinge"]}, Xm[idx], ym[idx], StratifiedKFold(3),
            "accuracy", False, dev), 5e-3), min_score=0.3, profile=False)
    svr_grid = {"C": LIN_C, "loss": ["epsilon_insensitive",
                                     "squared_epsilon_insensitive"]}
    out["linear_svr"] = rest_search(
        "linear_svr", lambda dev, cold: search(
            LinearSVR(), svr_grid, Xr, yr, KFold(N_FOLDS), "r2", False,
            dev), [], "r2",
        (lambda dev: search(LinearSVR(), svr_grid, Xr[:N_REST_CHECK],
                            yr[:N_REST_CHECK], KFold(3), "r2", False, dev),
         5e-3), profile=False)
    torch.cuda.empty_cache()
    return out


# --- successive halving: phase 15 ----------------------------------------

#: the rung plans, (n_resources_, n_candidates_), that phase 15's searches
#: must show: sklearn's schedule for their data, grids and factor 3
HALVING_PLANS = {
    "a": ([100, 300, 900], [1000, 334, 112]),
    "a_check": ([199, 597, 1791], [20, 7, 3]),
    "b": ([1111, 3333, 9999], [9, 3, 1]),
    "b_check": ([66, 198, 594], [9, 3, 1]),
    "c": ([10, 30, 90], [9, 3, 1]),
    "c_check": ([10, 30, 90], [9, 3, 1]),
    "d": ([100, 300, 900], [17, 6, 2]),
}
HALVING_GB_GRID = {"learning_rate": [0.05, 0.1, 0.2], "max_depth": [3, 4, 5]}


def halving_plan(gs) -> str:
    return (f"{' / '.join(map(str, gs.n_resources_))} resources, "
            f"{' / '.join(map(str, gs.n_candidates_))} candidates")


def halving_search(label, make, kernels, counters):
    """One phase 15 search on cuda: cold with the launches of `kernels`
    (each must launch), then warm; its rung plan must be
    HALVING_PLANS[label].  Returns (the warm search, its record)."""
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    gs = make("cuda")
    cold = time.perf_counter() - t0
    launches = {}
    for c in counters:
        launches.update({k: v for k, v in c.LAUNCHES.items()
                         if k in kernels})
    for name in kernels:
        if launches.get(name, 0) == 0:
            raise AssertionError(f"halving ({label}): {name} never "
                                 "launched")
    t0 = time.perf_counter()
    gs = make("cuda")
    warm = time.perf_counter() - t0
    plan = (gs.n_resources_, gs.n_candidates_)
    if plan != HALVING_PLANS[label]:
        raise AssertionError(f"halving ({label}): rung plan {plan}, "
                             f"expected {HALVING_PLANS[label]}")
    scores = gs.cv_results_["mean_test_score"]
    if not np.all(np.isfinite(scores)):
        raise AssertionError(f"halving ({label}): non-finite scores")
    rungs = [{**r, "lanes": [c["lanes"] for c in gs.chunks_
                             if c["id"].startswith(f"r{r['iter']}:")]}
             for r in gs.rungs_]
    print(f"  ({label}) {halving_plan(gs)}: cold {cold:.3f} s, warm "
          f"{warm:.3f} s; rung walls "
          f"{[round(r['wall_s'], 4) for r in rungs]} s, lanes "
          f"{[r['lanes'] for r in rungs]}; best {gs.best_params_} "
          f"{gs.best_score_:.4f}; launches {launches}")
    return gs, {"cold_s": cold, "warm_s": warm, "launches": launches,
                "n_resources": gs.n_resources_,
                "n_candidates": gs.n_candidates_, "rungs": rungs,
                "best_params": gs.best_params_,
                "best_score": float(gs.best_score_)}


def halving_rungs(gs):
    """{(iter, candidate): (n_resources, mean_test_score)}: each rung's
    survivors, whatever order equal scores put them in."""
    r = gs.cv_results_
    return {(int(i), repr(sorted(p.items()))): (int(n), float(m))
            for i, p, n, m in zip(r["iter"], r["params"], r["n_resources"],
                                  r["mean_test_score"])}


def rung_flip(n_resources, X, y, cv):
    """{iter: one test prediction's share of a mean accuracy at that
    rung}: 1 / (the rung's smallest subsampled test fold x the folds),
    the subsample `_SubsampleMetaSplitter` takes of `cv`'s folds."""
    tests = [len(te) for _, te in cv.split(X, y)]
    return {i: 1.0 / (min(int(n / len(y) * t) for t in tests) * len(tests))
            for i, n in enumerate(n_resources)}


def halving_agree(label, make, tol, flip_of=None):
    """The same halving search on cuda and on the CPU: the same rung plan
    (HALVING_PLANS[label]), the same survivors with the same iter and
    n_resources, mean_test_score within `tol` for each, and the same best
    candidate, or where the best differs, a CPU best that scores on the
    card within that bound of the card's best (a tie at the bound's
    resolution).  `flip_of` (X, y, the search's folds) marks an accuracy
    search on subsampled rungs: a mean accuracy moves in steps of one
    test prediction's share, 1 / (test rows x folds), which on a rung's
    few dozen rows a fold is as large as `tol` (phase 5's folds hold
    360), so there `tol` is rounded up to a whole number of steps; how
    many candidates differ by more than `tol` is printed."""
    runs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = make(dev)
        secs[dev] = time.perf_counter() - t0
    g, c = runs["cuda"], runs["cpu"]
    for gs in (g, c):
        if (gs.n_resources_, gs.n_candidates_) != HALVING_PLANS[label]:
            raise AssertionError(f"halving ({label}): rung plan "
                                 f"{halving_plan(gs)}")
    for key in ("iter", "n_resources"):
        if not np.array_equal(g.cv_results_[key], c.cv_results_[key]):
            raise AssertionError(f"halving ({label}): {key} differs")
    rg, rc = halving_rungs(g), halving_rungs(c)
    if set(rg) != set(rc):
        raise AssertionError(f"halving ({label}): the survivors differ: "
                             f"{sorted(set(rg) ^ set(rc))}")
    flip = {} if flip_of is None else rung_flip(c.n_resources_, *flip_of)
    d = {k: abs(rg[k][1] - rc[k][1]) for k in rg}
    diff = max(d.values())
    bound = {i: np.ceil(tol / step - 1e-9) * step * (1 + 1e-6)
             for i, step in flip.items()}
    over = sorted(k for k in d if d[k] > tol)
    bad = [k for k in over if d[k] > bound.get(k[0], tol)]
    print(f"  ({label}) cuda against cpu, {halving_plan(c)}: max |d "
          f"mean_test_score| {diff:.3g} (tolerance {tol:g}, in whole test "
          f"predictions a rung {[round(float(v), 5) for v in bound.values()]}; "
          f"{len(over)} candidates past {tol:g}), the same survivors, best "
          f"{g.best_params_} / {c.best_params_}; cuda {secs['cuda']:.1f} s,"
          f" cpu {secs['cpu']:.1f} s")
    if bad:
        raise AssertionError(f"halving ({label}): cuda and cpu differ by "
                             f"{[(k, d[k]) for k in bad]}")
    best_gap = 0.0
    if g.best_params_ != c.best_params_:
        last = int(np.max(g.cv_results_["iter"]))
        best_gap = (rg[(last, repr(sorted(g.best_params_.items())))][1]
                    - rg[(last, repr(sorted(c.best_params_.items())))][1])
        print(f"    the best differs: the CPU's best scores {best_gap:.3g} "
              "under the card's best on the card")
        if not best_gap <= bound.get(last, tol):
            raise AssertionError(f"halving ({label}): best_params_ differ "
                                 f"by {best_gap} on the card")
    return {"max_abs": diff, "cpu_s": secs["cpu"], "cuda_s": secs["cuda"],
            "one_prediction": flip, "n_over_tol": len(over),
            "best_gap_on_card": best_gap}


def phase_halving(seed: int, X, y, Cs):
    """Phase 15: the four halving searches (a)-(d) on cuda, each against
    the CPU (module docstring)."""
    from scipy.stats import loguniform

    from spark_sklearn_tpu_torch import (
        SVC, GradientBoostingRegressor, HalvingGridSearchCV,
        HalvingRandomSearchCV, KFold, LogisticRegression, StratifiedKFold,
        TorchConfig)
    from spark_sklearn_tpu_torch.ops import glm_kernels as gk
    from spark_sklearn_tpu_torch.ops import svm_kernels as svk
    from spark_sklearn_tpu_torch.ops import tree_kernels as tk

    glm = ("glm_loss_grad", "glm_trial_loss")
    out = {}

    def logistic(grid, Xs, ys):
        return lambda dev: HalvingGridSearchCV(
            LogisticRegression(), {"C": grid}, cv=StratifiedKFold(N_FOLDS),
            factor=3, random_state=seed,
            config=TorchConfig(device=dev)).fit(Xs, ys)

    gs, out["a"] = halving_search("a", logistic(Cs, X, y), glm, [gk])
    out["a"]["check"] = halving_agree(
        "a_check", logistic(Cs[::50], X, y), 5e-3,
        (X, y, StratifiedKFold(N_FOLDS)))

    Xm, ym = mnist_like(seed)
    gamma0 = 1.0 / (D_SVM * float(np.var(Xm)))
    svm_grid = {"C": SVM_C, "gamma": [f * gamma0 for f in SVM_GAMMA]}

    def svc(Xs, ys, folds):
        return lambda dev: HalvingGridSearchCV(
            SVC(kernel="rbf"), svm_grid, cv=folds, factor=3,
            random_state=seed, config=TorchConfig(device=dev)).fit(Xs, ys)

    gs, out["b"] = halving_search("b", svc(Xm, ym, N_FOLDS), SVC_KERNELS,
                                  [svk])
    if gs.best_estimator_.device != "cuda":
        raise AssertionError("halving (b): the refit SVC is not on cuda")
    # 600 rows: the card's host takes ~32 s for the CPU's search on 1000
    per = 60
    idx = np.concatenate([np.where(ym == c)[0][:per] for c in range(K_SVM)])
    out["b"]["check"] = halving_agree(
        "b_check", svc(Xm[idx], ym[idx], 3), 5e-3,
        (Xm[idx], ym[idx], StratifiedKFold(3)))

    Xr, yr = california_like(seed)

    def boosting(Xs, ys, max_resources):
        return lambda dev: HalvingGridSearchCV(
            GradientBoostingRegressor(), HALVING_GB_GRID,
            resource="n_estimators", max_resources=max_resources,
            cv=KFold(N_FOLDS), factor=3, refit=False,
            config=TorchConfig(device=dev)).fit(Xs, ys)

    gs, out["c"] = halving_search("c", boosting(Xr, yr, 90),
                                  tuple(tk.LAUNCHES), [tk])
    out["c"]["check"] = halving_agree(
        "c_check", boosting(Xr[:N_TREE_CHECK], yr[:N_TREE_CHECK], 90), 1e-3)

    def random_logistic(dev):
        return HalvingRandomSearchCV(
            LogisticRegression(), {"C": loguniform(1e-3, 1e2)},
            random_state=seed, config=TorchConfig(device=dev)).fit(X, y)

    gs, out["d"] = halving_search("d", random_logistic, glm, [gk])
    out["d"]["check"] = halving_agree("d", random_logistic, 5e-3,
                                      (X, y, StratifiedKFold(N_FOLDS)))
    return out


# --- sparse X: SP1's kernel check and phase 16 ---------------------------

NG_N, NG_D, NG_K = 11314, 130107, 20   # 20 newsgroups' training split
NG_TOKENS = 195                        # median tokens a row: ~161 nonzeros
NG_TOPIC_SHARE = 0.06                  # of a row's tokens on its class's
NG_CUT = (2000, 20000)                 # rows and columns of the checks
SPARSE_C = np.logspace(-1, 2, 10)      # phase 16 (a)'s grid
SPARSE_ALPHAS = [0.01, 0.03, 0.1, 0.3, 1.0]
SPARSE_NB = ("MultinomialNB", "ComplementNB", "BernoulliNB")


def newsgroups_like(seed: int, n: int = NG_N, d: int = NG_D, k: int = NG_K):
    """Count data shaped like scikit-learn's fetch_20newsgroups_vectorized
    training split (11314 rows, 130107 columns, 20 classes; its TF-IDF
    rows hold ~159 nonzeros): a row's tokens (lognormal lengths about
    NG_TOKENS) fall on Zipf-like column frequencies, 6% of them on its
    class's 1500 topic columns, summed into integer counts (float32 CSR,
    ~161 nonzeros a row; sklearn's MultinomialNB(alpha=0.1) scores ~0.86
    in 3-fold CV at the full shape, ~0.69 on the 2000 x 20000 cut).
    Returns (X, y)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.arange(n) % k)
    w = 1.0 / np.arange(1, d + 1) ** 1.05
    cdf = np.cumsum(w / w.sum())
    lengths = np.maximum(8, rng.lognormal(np.log(NG_TOKENS), 0.6, n)
                         .astype(np.int64))
    rows = np.repeat(np.arange(n), lengths)
    cols = np.minimum(np.searchsorted(cdf, rng.random(rows.size)), d - 1)
    topic = 1500
    topics = np.stack([rng.choice(np.arange(100, min(d, 20000)), topic,
                                  replace=False) for _ in range(k)])
    tw = 1.0 / np.arange(1, topic + 1) ** 0.8
    tcdf = np.cumsum(tw / tw.sum())
    pick = rng.random(rows.size) < NG_TOPIC_SHARE
    cols[pick] = topics[y[rows[pick]], np.minimum(
        np.searchsorted(tcdf, rng.random(int(pick.sum()))), topic - 1)]
    X = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(n, d))
    X.sum_duplicates()
    return X, y


def l2_rows(X):
    """X with each row scaled to unit l2 norm (LogisticRegression's
    input)."""
    import scipy.sparse as sp
    norms = np.sqrt(np.asarray(X.multiply(X).sum(axis=1))).ravel()
    return (sp.diags(1.0 / np.maximum(norms, 1e-12)).astype(np.float32)
            @ X).tocsr()


def csr_row_slice(indptr, indices, values, r0: int, r1: int):
    """Rows r0..r1-1 of a CSR as its own CSR (int32 indptr from 0)."""
    lo, hi = int(indptr[r0]), int(indptr[r1])
    return ((indptr[r0:r1 + 1] - lo).contiguous(), indices[lo:hi],
            values[lo:hi])


def flushed_ms(fn, reps: int = 10) -> float:
    """Mean device time of `fn()` with L2 cold: before each launch a 256
    MB buffer is written (5x the H100's 50 MB L2) behind a sleep that
    keeps the card busy while the host enqueues the launch, which is then
    timed alone between CUDA events."""
    import torch
    buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        buf.fill_(1.0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    del buf
    return total / reps


def sparse_operands(seed: int):
    """Phase 16's X (the 20-newsgroups-shaped counts) and its device
    operands: "lr" (rows at unit l2 norm) and "nb" (the counts), each the
    CSRs of X and Xᵀ with SP1's plans."""
    from spark_sklearn_tpu_torch.sparse.csr import SparseOperand
    X, _ = newsgroups_like(seed)
    return X, {"lr": SparseOperand.from_csr(l2_rows(X)).to_device("cuda"),
               "nb": SparseOperand.from_csr(X).to_device("cuda")}


#: SP1's rows in phase 3: variant -> (operand, over Xᵀ's CSR, W).  (a)'s
#: forward X Wᵀ and backward Xᵀ G at 50 lanes x 20 classes, (b)'s class
#: sums at 5 folds x 20 classes and joint log-likelihoods at 25 lanes x
#: 20 classes; the backward at W = 97 (the scalar lanes); and Xᵀ's
#: heaviest row alone at W = 1000 and 100 (`heavy_row`).
SPARSE_SHAPES = {"lr_forward": ("lr", False, len(SPARSE_C) * N_FOLDS * NG_K),
                 "lr_backward": ("lr", True, len(SPARSE_C) * N_FOLDS * NG_K),
                 "nb_class_sums": ("nb", True, N_FOLDS * NG_K),
                 "nb_jll": ("nb", False,
                            len(SPARSE_ALPHAS) * N_FOLDS * NG_K),
                 "lr_backward_w97": ("lr", True, 97),
                 "heavy_row_w1000": ("lr", "heavy", 1000),
                 "heavy_row_w100": ("nb", "heavy", N_FOLDS * NG_K)}
SPARSE_MAIN = ("lr_forward", "lr_backward", "nb_class_sums", "nb_jll")


def sparse_case(ops, variant):
    """(A's three tensors, its SpmmPlan, K, W) of an SPARSE_SHAPES row."""
    from spark_sklearn_tpu_torch.ops import spmm_kernels as spk
    which, over, W = SPARSE_SHAPES[variant]
    op = ops[which]
    n, d = op.shape
    if over is False:
        return (op.indptr, op.indices, op.values), op.plan, d, W
    A = (op.t_indptr, op.t_indices, op.t_values)
    if over == "heavy":
        r = int((A[0][1:] - A[0][:-1]).argmax())
        A = csr_row_slice(*A, r, r + 1)
        return A, spk.SpmmPlan(A[0]), n, W
    return A, op.t_plan, n, W


def sp1_operand(K: int, W: int, variant: str):
    """D (K, W) for an SPARSE_SHAPES row outside phase 3 (chip_sweep.py,
    chip_pairs.py): normal draws from a generator seeded by the variant's
    name, the same in every tree and run."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, variant)))
    return torch.randn((K, W), generator=g, device="cuda")


def phase_sparse_kernels(seed: int, ptxas: dict):
    """SP1 against its plain version at phase 16's shapes and beside them
    (SPARSE_SHAPES).  Each: within the float32 bound of two summation
    orders of the plain version on the card (2 nnz_r 2^-24 (|A| |D|)),
    equal to it on integer inputs of the same structure (exact sums),
    equal to the plain version on CPU copies of 2000 rows (the heaviest
    of Xᵀ) and bitwise repeatable; its launch (items, the longest
    segment, slice width, heavy segments); timed in a CUDA graph (L2 warm
    from the last launch), with L2 flushed before each launch, and
    between events, beside the plain version, `torch.sparse.mm`
    (cuSPARSE, warm and flushed) and its bound.  Then the copies: those
    the sparse LogisticRegression's iterations made around SP1 before its
    state was feature-major (timed for the record, at (a)'s shape) and
    those that remain, once a chunk's scoring.  Returns ({variant: row},
    the copies' times)."""
    import torch

    from spark_sklearn_tpu_torch.ops import spmm_kernels as spk

    X, ops = sparse_operands(seed)
    n, d = X.shape
    lanes = len(SPARSE_C) * N_FOLDS
    nb_lanes = len(SPARSE_ALPHAS) * N_FOLDS
    print(f"  20-newsgroups-shaped X: {n} x {d}, nnz {X.nnz} "
          f"({X.nnz / n:.1f} a row; dense float32 would be "
          f"{4 * n * d / 1e9:.2f} GB, the two CSRs "
          f"{ops['lr'].nbytes / 1e6:.1f} MB)")
    regs, spill = slice_symbol(ptxas, "csr_spmm_kernel")
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for variant, (which, over, W) in SPARSE_SHAPES.items():
        A, plan, K, W = sparse_case(ops, variant)
        m = int(A[0].numel()) - 1
        nnz = int(A[2].numel())
        D = torch.randn((K, W), generator=g, device="cuda")

        def fn(A=A, D=D, K=K, plan=plan):
            return spk.csr_spmm(*A, D, K, plan=plan)

        got, again = fn(), fn()
        want = spk.csr_spmm_plain(*A, D)
        scale = spk.csr_spmm_plain(A[0], A[1], A[2].abs(), D.abs())
        row_nnz = (A[0][1:] - A[0][:-1]).float()[:, None]
        tol = 2.0 * row_nnz * 2.0 ** -24 * scale
        err = (got - want).abs()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"csr_spmm ({variant}): two launches "
                                 "on the same inputs differ")
        if not bool((err <= tol).all()):
            raise AssertionError(
                f"csr_spmm ({variant}): {int((err > tol).sum())} elements "
                "past the two-order float32 bound of the plain version")
        max_err = float(err.max())
        rel = float((err / scale.clamp_min(1e-30)).max())
        del want, scale, err, tol, again
        # integer inputs of the same structure: every sum exact
        Ai = (A[0], A[1], torch.ceil(4.0 * A[2]) if which == "lr"
              else A[2])
        Di = torch.randint(-3, 4, (K, W), generator=g, device="cuda",
                           dtype=torch.int32).float()
        if not torch.equal(spk.csr_spmm(*Ai, Di, K, plan=plan),
                           spk.csr_spmm_plain(*Ai, Di)):
            raise AssertionError(f"csr_spmm ({variant}): integer inputs "
                                 "differ from the plain version")
        del Ai, Di
        # the plain version on CPU copies sums in the kernel's order
        heavy = torch.argsort(row_nnz[:, 0], descending=True)[:2000]
        r0 = int(heavy.min()) if over else 0
        r1 = min(m, r0 + 2000)
        sub = csr_row_slice(*A, r0, r1)
        cpu = spk.csr_spmm_plain(*(t.cpu() for t in sub), D.cpu())
        if not torch.equal(spk.csr_spmm(*sub, D, K).cpu(), cpu):
            raise AssertionError(f"csr_spmm ({variant}): rows {r0}-{r1} "
                                 "differ from the plain version on the CPU")
        del cpu, sub
        Asp = torch.sparse_csr_tensor(A[0], A[1], A[2], size=(m, K))
        lib = torch.sparse.mm(Asp, D)
        lib_err = float((lib - got).abs().max())
        del lib, got
        bnd, by = bound(spk.spmm_bytes(m, nnz, K, W), spk.spmm_ops(nnz, W))
        gathered = spk.spmm_gathered_bytes(nnz, W)
        ms = graph_ms(fn, reps=10)
        cold = flushed_ms(fn)
        events = cuda_ms(fn, reps=5)
        plain_ms = (cuda_ms(lambda: spk.csr_spmm_plain(*A, D), reps=1,
                            warmup=0) if variant in SPARSE_MAIN else None)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(Asp, D), reps=5)
        lib_cold = flushed_ms(lambda: torch.sparse.mm(Asp, D))
        launch = spk.launch_for(plan, D, None)
        rows[variant] = {
            "ms": ms, "flushed_ms": cold, "events_ms": events,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_flushed_ms": lib_cold, "bound_ms": bnd,
            "bound_by": by, "gathered_bytes": gathered,
            "gathered_ms": gathered / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": max_err, "max_err_over_scale": rel,
            "library_max_abs_diff": lib_err, "registers": regs,
            "spill_bytes": spill, "plan": launch,
            "shape": {"m": m, "K": K, "W": W, "nnz": nnz}}
        plain_txt = "-" if plain_ms is None else f"{plain_ms:.4f}"
        print(f"  csr_spmm {variant:15s} m={m} K={K} W={W} nnz={nnz}: "
              f"{ms:.4f} ms in a graph, {cold:.4f} ms L2 flushed, "
              f"{events:.4f} ms between events (plain {plain_txt}, "
              f"torch.sparse.mm {lib_ms:.4f} ms, flushed {lib_cold:.4f}; "
              f"bound {bnd:.5f} ms by {by}, bound/time {bnd / ms:.4f}; "
              f"gathered {gathered / 1e9:.2f} GB = "
              f"{gathered / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s), max "
              f"abs err {max_err:.3g} ({rel:.3g} of |A||D|); plan: "
              f"{launch['units']} items, longest segment "
              f"{launch['longest']} nonzeros, slice {launch['slice']} "
              f"columns ({launch['order']}), {launch['n_heavy']} heavy "
              f"segments past {launch['heavy_nnz']}, {launch['blocks']} "
              f"blocks; {regs} registers, {spill} bytes spilled; bitwise "
              "repeatable, integer inputs and the CPU's rows equal")
        del D, Asp
    # the copies: those the sparse LogisticRegression made around SP1 in
    # every iteration while its state was (B, k d + k) (Wᵀ made
    # contiguous before the forward, the backward's (d, W) result made
    # (B, k d) after it, then the intercept's cat), timed for the record;
    # and those that remain, once a chunk: the scoring views' Wᵀ at (a)
    # and the joint log-likelihoods' flpᵀ at (b)
    W_a, W_b = lanes * NG_K, nb_lanes * NG_K
    Wm = torch.randn((W_a, d), generator=g, device="cuda")
    R = torch.randn((d, W_a), generator=g, device="cuda")
    x = torch.randn((lanes, NG_K * d + NG_K), generator=g, device="cuda")
    gb = torch.randn((lanes, NG_K), generator=g, device="cuda")
    Wb = torch.randn((W_b, d), generator=g, device="cuda")
    removed = {
        "forward_reshape_ms": cuda_ms(
            lambda: x[:, :NG_K * d].reshape(W_a, d), reps=5),
        "forward_transpose_ms": cuda_ms(lambda: Wm.T.contiguous(), reps=5),
        "backward_reshape_ms": cuda_ms(
            lambda: R.T.reshape(lanes, NG_K * d), reps=5),
        "backward_cat_ms": cuda_ms(
            lambda: torch.cat([R.T.reshape(lanes, NG_K * d), gb], dim=1),
            reps=5) - cuda_ms(lambda: R.T.reshape(lanes, NG_K * d), reps=5)}
    remaining = {"lr_views_transpose_ms": cuda_ms(lambda: Wm.T.contiguous(),
                                                  reps=5),
                 "nb_jll_transpose_ms": cuda_ms(lambda: Wb.T.contiguous(),
                                                reps=5)}
    copies = {"removed": removed, "remaining": remaining,
              "bytes_a": 2 * 4 * W_a * d, "bytes_b": 2 * 4 * W_b * d}
    copies["bound_a_ms"] = copies["bytes_a"] / HBM_BYTES_PER_S * 1e3
    print(f"  copies at (a)'s shape ({W_a} x {d}, "
          f"{copies['bytes_a'] / 1e9:.2f} GB moved each, "
          f"{copies['bound_a_ms']:.4f} ms at 3.35 TB/s): removed from every "
          f"L-BFGS iteration "
          + ", ".join(f"{k} {v:.4f}" for k, v in removed.items())
          + "; remaining once a chunk's scoring "
          + ", ".join(f"{k} {v:.4f}" for k, v in remaining.items()))
    del Wm, R, x, gb, Wb, ops
    torch.cuda.empty_cache()
    return rows, copies


def sparse_search(label, run, iters_of, min_score, top: int = 6):
    """One phase 16 search on cuda: cold with SP1's launches (it must
    launch), warm, then profiled: busy, idle share, SP1's and the copy
    kernels' device time.  `run()` returns the search."""
    import torch

    from spark_sklearn_tpu_torch.ops import glm_kernels as gk
    from spark_sklearn_tpu_torch.ops import spmm_kernels as spk

    spk.reset_launches()
    gk.reset_launches()
    t0 = time.perf_counter()
    gs = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {**spk.LAUNCHES, **{k: v for k, v in gk.LAUNCHES.items()
                                   if v}}
    if launches["csr_spmm"] == 0:
        raise AssertionError(f"{label}: csr_spmm never launched")
    cold_chunks = [(round(c["fit_s"], 4), round(c["score_s"], 4))
                   for c in gs.chunks_]
    scores = gs.cv_results_["mean_test_score"]
    if not np.all(np.isfinite(scores)):
        raise AssertionError(f"{label}: non-finite scores {scores}")
    best = float(np.max(scores))
    if not best > min_score:
        raise AssertionError(f"{label}: best score {best}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gs = run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    iters = iters_of(gs)
    busy, by_name = profile_busy(run, warm, max(1, iters),
                                 f"chip_smoke_sparse_{label}.txt",
                                 with_kernels=True, top=top,
                                 primed=warm < 1.0)
    spmm_ns = sum(ns for name, (ns, _) in by_name.items()
                  if "csr_spmm" in name)
    copy_ns = sum(ns for name, (ns, _) in by_name.items()
                  if "copy" in name.lower())
    n_launch = sum(count for _, count in by_name.values())
    fits = len(scores) * gs.n_splits_
    chunk_s = [(round(c["fit_s"], 4), round(c["score_s"], 4))
               for c in gs.chunks_]
    print(f"  {label}: chunks' (fit, score) s warm {chunk_s}, cold "
          f"{cold_chunks}")
    print(f"  {label}: {fits} fits, cold {cold:.3f} s, warm {warm:.3f} s, "
          f"busy {busy:.4f} s (SP1 {spmm_ns / 1e9:.4f} s, copy kernels "
          f"{copy_ns / 1e9:.4f} s), {n_launch} device launches, idle share "
          f"{1 - busy / warm if busy else float('nan'):.4f}, peak "
          f"{peak / 2**30:.2f} GiB, iterations {iters}, launches "
          f"{launches}, best {best:.4f}")
    return gs, {"cold_s": cold, "warm_s": warm, "fits": fits,
                "device_busy_s": busy, "spmm_busy_s": spmm_ns / 1e9,
                "copy_busy_s": copy_ns / 1e9, "device_launches": n_launch,
                "idle_share": None if not busy else 1 - busy / warm,
                "peak_bytes": peak, "launches": launches, "best": best,
                "iterations": iters, "cold_chunks": cold_chunks,
                "warm_chunks": chunk_s}


def sparse_agree(label, runs, tol):
    """{name: search} on the same data: every mean_test_score within
    `tol` of the first's, and the same best where the first's best leads
    its second by more than twice `tol`."""
    names = list(runs)
    a = runs[names[0]].cv_results_["mean_test_score"]
    top = np.sort(a)[::-1]
    gap = float(top[0] - top[1]) if len(top) > 1 else None
    out = {"cpu_best_gap": gap}
    for name in names[1:]:
        b = runs[name].cv_results_["mean_test_score"]
        diff = float(np.abs(a - b).max())
        same = int(np.argmax(a)) == int(np.argmax(b))
        print(f"  {label}: {names[0]} against {name}: max |d mean_test| "
              f"{diff:.3g} (tolerance {tol:g}), same best {same}")
        if not diff <= tol:
            raise AssertionError(f"{label}: {names[0]} and {name} differ "
                                 f"by {diff}")
        if gap is not None and gap > 2 * tol and not same:
            raise AssertionError(f"{label}: the best candidate differs")
        out[name] = {"max_abs": diff, "same_best": same}
    return out


def phase_sparse(seed: int):
    """Phase 16 (module docstring): (a) LogisticRegression and (b) the
    three discrete naive Bayes over the 20-newsgroups-shaped X under
    data_mode="sparse" on cuda, then cuda sparse against CPU sparse and
    against cuda densified on a 2000 x 20000 cut."""
    import spark_sklearn_tpu_torch as port
    from spark_sklearn_tpu_torch import (
        GridSearchCV, LogisticRegression, StratifiedKFold, TorchConfig)

    X, y = newsgroups_like(seed)
    Xn = l2_rows(X)

    def lr(Xs, ys, Cs, folds, dev, mode="sparse"):
        return GridSearchCV(
            LogisticRegression(max_iter=100), {"C": Cs},
            cv=StratifiedKFold(folds), refit=False,
            config=TorchConfig(device=dev, data_mode=mode)).fit(Xs, ys)

    def nb(name, Xs, ys, folds, dev, mode="sparse"):
        return GridSearchCV(
            getattr(port, name)(), {"alpha": SPARSE_ALPHAS},
            cv=StratifiedKFold(folds), refit=False,
            config=TorchConfig(device=dev, data_mode=mode)).fit(Xs, ys)

    out = {"nnz": int(X.nnz), "shape": list(X.shape)}
    _, out["lr"] = sparse_search(
        "lr", lambda: lr(Xn, y, SPARSE_C, N_FOLDS, "cuda"),
        lambda gs: sum(c["n_iter_exec"] for c in gs.chunks_), 0.3)
    for name in SPARSE_NB:
        _, out[name] = sparse_search(
            name, lambda name=name: nb(name, X, y, N_FOLDS, "cuda"),
            lambda gs: 1, 0.3)
    Xc, yc = newsgroups_like(seed, *NG_CUT)
    Xcn = l2_rows(Xc)
    Cs = SPARSE_C[::4]
    t0 = time.perf_counter()
    runs = {"cpu": lr(Xcn, yc, Cs, 3, "cpu"),
            "cuda": lr(Xcn, yc, Cs, 3, "cuda"),
            "cuda_dense": lr(Xcn, yc, Cs, 3, "cuda", "device")}
    out["lr"]["check"] = sparse_agree("lr cut", runs, 5e-3)
    out["lr"]["check"]["seconds"] = time.perf_counter() - t0
    for name in SPARSE_NB:
        runs = {"cpu": nb(name, Xc, yc, 3, "cpu"),
                "cuda": nb(name, Xc, yc, 3, "cuda"),
                "cuda_dense": nb(name, Xc, yc, 3, "cuda", "device")}
        out[name]["check"] = sparse_agree(f"{name} cut", runs, 1e-6)
    return out


# --- keyed fleets, gapply and converted ensembles: phase 17 ---------------

KEYED_KEYS, KEYED_D, KEYED_K = 2000, 32, 4     # keys, features, classes
KEYED_MIN, KEYED_MAX, KEYED_ALPHA = 16, 4096, 0.2   # Zipf group sizes
KEYED_HOST_KEYS = 20                   # keys lacking a class: host fits
KEYED_UNSEEN = 10                      # keys transform meets but fit never
KEYED_CHECK_KEYS, KEYED_CHECK_MAX = 200, 512   # the cuda-vs-cpu keys
RF_TREES, RF_DEPTH, GB_STAGES, GB_DEPTH = 100, 20, 100, 3


def keyed_table(seed: int):
    """A dict of columns: KEYED_KEYS keys whose group sizes follow a
    truncated Zipf (Pareto) law of exponent KEYED_ALPHA on [16, 4096] rows
    (~1 M rows in all), then KEYED_HOST_KEYS keys of 200 rows whose labels
    never take class 3; x (n, 32) float32 rows (column spreads 3 to
    0.3), each key its own linear model W_k: ym the argmax of 4 noisy scores, yb the sign of the first,
    yr the first score.  Also the same columns for KEYED_UNSEEN unseen
    keys (200 rows each) that transform meets."""
    rng = np.random.default_rng(seed)
    a = KEYED_ALPHA
    u = rng.random(KEYED_KEYS)
    ratio = (KEYED_MIN / KEYED_MAX) ** a
    sizes = np.floor(KEYED_MIN * (1 - u * (1 - ratio)) ** (-1 / a))
    sizes = np.clip(sizes, KEYED_MIN, KEYED_MAX).astype(np.int64)
    sizes = np.concatenate([sizes, np.full(KEYED_HOST_KEYS + KEYED_UNSEEN,
                                           200)])
    kid = np.repeat(np.arange(len(sizes)), sizes)
    # features of distinct spreads (3 down to 0.3), as a table's columns
    # are: PCA's leading directions are then well separated
    X = rng.standard_normal((len(kid), KEYED_D), dtype=np.float32) \
        * np.geomspace(3.0, 0.3, KEYED_D, dtype=np.float32)
    W = rng.standard_normal((len(sizes), KEYED_D, KEYED_K),
                            dtype=np.float32) / np.sqrt(KEYED_D)
    z = np.einsum("nd,ndk->nk", X, W[kid]) \
        + 0.5 * rng.standard_normal((len(kid), KEYED_K), dtype=np.float32)
    ym = np.argmax(z, axis=1)
    host = (kid >= KEYED_KEYS) & (kid < KEYED_KEYS + KEYED_HOST_KEYS)
    ym[host] = np.argmax(z[host, :3], axis=1)         # never class 3
    cols = {"k": kid, "x": X, "ym": ym, "yb": (z[:, 0] > 0).astype(np.int64),
            "yr": z[:, 0].astype(np.float64)}
    fit = kid < KEYED_KEYS + KEYED_HOST_KEYS
    return ({c: v[fit] for c, v in cols.items()}, cols, sizes)


def keyed_specs():
    """(label, estimator, KeyedEstimator keywords, kernels of its path)."""
    import spark_sklearn_tpu_torch as port
    return [
        ("logreg_multinomial", port.LogisticRegression(), {"yCol": "ym"},
         ("glm_loss_grad_lanes", "glm_trial_loss_lanes")),
        ("logreg_binary", port.LogisticRegression(), {"yCol": "yb"},
         ("glm_loss_grad_lanes", "glm_trial_loss_lanes")),
        ("linreg", port.LinearRegression(), {"yCol": "yr"}, ()),
        ("ridge", port.Ridge(alpha=1.0), {"yCol": "yr"}, ()),
        ("kmeans", port.KMeans(n_clusters=8, random_state=0),
         {"estimatorType": "clusterer"}, ("kmeans_assign_lanes",)),
        ("scaler", port.StandardScaler(), {"estimatorType": "transformer"},
         ()),
        ("pca", port.PCA(n_components=8), {"estimatorType": "transformer"},
         ()),
    ]


def lane_launches():
    from spark_sklearn_tpu_torch.ops import glm_kernels as gk
    from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
    return {**gk.LANE_LAUNCHES, **kmk.LANE_LAUNCHES}


def reset_lane_launches():
    from spark_sklearn_tpu_torch.ops import glm_kernels as gk
    from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk
    gk.reset_launches()
    kmk.reset_launches()


def keyed_outputs_ok(label, out, table, all_table, kind):
    """Fleet rows have finite outputs (a label, an id, a value or a
    vector of the step's width); the unseen keys' rows NaN or None."""
    seen = all_table["k"] < KEYED_KEYS + KEYED_HOST_KEYS
    if kind == "transformer":
        bad = sum(v is None for v in out[seen])
        if bad or any(v is not None for v in out[~seen]):
            raise AssertionError(f"{label}: {bad} fitted rows without an "
                                 "output, or an unseen key with one")
        width = {len(v) for v in out[seen]}
        if width != {8 if label == "pca" else KEYED_D}:
            raise AssertionError(f"{label}: output widths {width}")
        if not np.isfinite(np.stack(out[seen][:100000])).all():
            raise AssertionError(f"{label}: non-finite outputs")
        return
    if not np.isfinite(out[seen].astype(np.float64)).all():
        raise AssertionError(f"{label}: non-finite outputs on fitted keys")
    if not np.isnan(out[~seen].astype(np.float64)).all():
        raise AssertionError(f"{label}: unseen keys did not give NaN")


def keyed_agreement(label, est, kw, table, sizes):
    """The fleet on cuda against the CPU on KEYED_CHECK_KEYS keys of at
    most KEYED_CHECK_MAX rows: labels and cluster ids agree on all but
    0.1 % of the rows (float32 sums in other orders can move a row on a
    decision boundary), outputs within 1e-4; PCA's columns up to their
    sign a key, within 1e-4 of the outputs' largest magnitude."""
    import spark_sklearn_tpu_torch as port
    keys = np.flatnonzero(sizes[:KEYED_KEYS] <= KEYED_CHECK_MAX)[
        :KEYED_CHECK_KEYS]
    m = np.isin(table["k"], keys)
    sub = {c: v[m] for c, v in table.items()}
    outs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        km = port.KeyedEstimator(sklearnEstimator=est, keyCols=["k"],
                                 xCol="x", config=port.TorchConfig(
                                     device=dev), **kw).fit(sub)
        outs[dev] = km.transform(sub)["output"]
        walls[dev] = time.perf_counter() - t0
    a, b = outs["cuda"], outs["cpu"]
    if a.dtype == object:
        a, b = np.stack(a), np.stack(b)
        err = float(np.abs(a - b).max())
        ok = err <= 1e-4
        stat = {"max_abs_err": err}
        if label == "pca":
            # each key's components up to their sign, and held relative
            # to the outputs' scale: float32 eigenvectors of a key's
            # sample covariance move by ~eps |C| / gap, and a key of 16
            # rows has close eigenvalues
            for key in keys:
                r = sub["k"] == key
                a[r] *= np.sign((a[r] * b[r]).sum(axis=0, keepdims=True))
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            ok = err <= 1e-4 * scale
            stat = {"max_abs_err": err, "output_scale": scale}
    elif a.dtype.kind == "f":
        err = float(np.abs(a - b).max())
        ok = err <= 1e-4
        stat = {"max_abs_err": err}
    else:
        differ = int((a != b).sum())
        ok = differ <= 1e-3 * len(a)
        stat = {"rows_differ": differ}
    stat.update({"keys": len(keys), "rows": int(m.sum()),
                 "cuda_s": walls["cuda"], "cpu_s": walls["cpu"]})
    print(f"  {label}: cuda against cpu on {len(keys)} keys "
          f"({int(m.sum())} rows): {stat}")
    if not ok:
        raise AssertionError(f"{label}: cuda and cpu disagree: {stat}")
    return stat


def phase_keyed(seed: int):
    """Phase 17 (a) and (b): the fleets at full size on cuda, their
    launches, walls, busy and idle share (a profiled second fit against
    the first's wall), buckets and iterations; cuda against the CPU on
    200 keys; the compiled group function over the same segments."""
    import torch

    import spark_sklearn_tpu_torch as port
    from spark_sklearn_tpu_torch.keyed.gapply import (
        compiled_group_func,
        segment_launch,
    )
    from spark_sklearn_tpu_torch.keyed.keyed import run_bucketed

    table, all_table, sizes = keyed_table(seed)
    n_fit = len(table["k"])
    print(f"  {KEYED_KEYS} keys + {KEYED_HOST_KEYS} lacking class 3: "
          f"{n_fit} rows (group sizes {sizes[:KEYED_KEYS].min()}-"
          f"{sizes[:KEYED_KEYS].max()}, median "
          f"{int(np.median(sizes[:KEYED_KEYS]))}), d={KEYED_D}; transform "
          f"adds {KEYED_UNSEEN} unseen keys ({len(all_table['k'])} rows)")
    out = {}
    for label, est, kw, path in keyed_specs():
        kind = kw.get("estimatorType", "predictor")

        def fit(est=est, kw=kw):
            km = port.KeyedEstimator(sklearnEstimator=est, keyCols=["k"],
                                     xCol="x", config=port.TorchConfig(
                                         device="cuda"), **kw).fit(table)
            torch.cuda.synchronize()
            return km

        reset_lane_launches()
        t0 = time.perf_counter()
        km = fit()
        wall = time.perf_counter() - t0
        launches = lane_launches()
        for name in path:
            if launches[name] == 0:
                raise AssertionError(f"{label}: {name} never launched")
        want = "hybrid" if label == "logreg_multinomial" else "device"
        if km.backend != want:
            raise AssertionError(f"{label}: backend {km.backend}")
        t0 = time.perf_counter()
        res = km.transform(all_table)
        transform_s = time.perf_counter() - t0
        keyed_outputs_ok(label, res["output"], table, all_table, kind)
        models = km.fleet["models"]
        n_iter = (models["n_iter"].cpu().numpy() if "n_iter" in models
                  else None)
        iters = int(n_iter.max()) * len(km.fleet["buckets"]) \
            if n_iter is not None else 1
        busy = profile_busy(fit, wall, iters, f"chip_smoke_keyed_{label}.txt",
                            top=6, host=False)
        rec = {"fit_s": wall, "transform_s": transform_s,
               "launches": {k: launches[k] for k in path},
               "device_busy_s": busy,
               "idle_share": None if not busy else 1 - busy / wall,
               "buckets": km.fleet["buckets"], "backend": km.backend,
               "fleet_keys": len(km.fleet["key_index"]),
               "host_keys": len(km.models or {}),
               "n_iter_range": (None if n_iter is None else
                                [int(n_iter.min()), int(n_iter.max())])}
        print(f"  {label}: fit {wall:.3f} s (the kernels built and "
              f"warmed by earlier phases), transform {transform_s:.3f} s, "
              f"busy {busy:.4f} s, idle "
              f"share {rec['idle_share']}, launches {rec['launches']}, "
              f"buckets {rec['buckets']}, {rec['fleet_keys']} fleet keys, "
              f"{rec['host_keys']} host keys ({km.backend}), n_iter "
              f"{rec['n_iter_range']}")
        rec["agreement"] = keyed_agreement(label, est, kw, table, sizes)
        out[label] = rec

    # (b) a compiled group function over the same segments
    @compiled_group_func
    def stats(X, w):
        n = w.sum()
        mean = (X * w[:, None]).sum(dim=0) / n
        var = (w[:, None] * (X - mean) ** 2).sum(dim=0) / n
        return torch.cat([mean, var, n[None]])

    rows = [np.flatnonzero(table["k"] == i) for i in
            range(KEYED_KEYS + KEYED_HOST_KEYS)]
    X = torch.as_tensor(table["x"], device="cuda")
    launch = segment_launch(stats)
    run_bucketed(rows, X, launch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    order, Y, buckets = run_bucketed(rows, X, launch)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    Y = Y.cpu().numpy()
    order_c, Yc, _ = run_bucketed(rows[:KEYED_CHECK_KEYS], X.cpu(), launch)
    err = float(np.abs(Y[[order.index(i) for i in order_c]]
                       - Yc.numpy()).max())
    want_n = np.array([len(rows[i]) for i in order])
    if not (np.array_equal(Y[:, -1], want_n) and err <= 1e-4):
        raise AssertionError(f"compiled group function: counts or cuda "
                             f"against cpu (max abs err {err})")
    print(f"  gapply segments: run_bucketed of a torch group function "
          f"(mean, var, count) over {len(rows)} segments in "
          f"{len(buckets)} buckets: {seg_s:.3f} s; cuda against cpu on "
          f"{KEYED_CHECK_KEYS} segments max abs err {err:.3g}")
    out["gapply_segments"] = {"wall_s": seg_s, "buckets": buckets,
                              "max_abs_err": err}
    return out


def grown_trees(rng, X, y, n_trees, depth, n_out, sample=5000,
                min_split=8):
    """`n_trees` trees in sklearn's node layout (depth first, left
    subtree first) grown on random samples of X's rows: at a node a
    random feature, the threshold one of its rows' values of it (as
    sklearn's thresholds lie between X's values; up to 8 draws for one
    that splits the node's rows), children while the node holds
    `min_split` rows and is above `depth`; a node's value its
    rows' class shares (n_out > 1) or a draw of N(0, 0.1)."""
    trees = []
    for _ in range(n_trees):
        feat, thr, left, right, val, lvl = [], [], [], [], [], []
        stack = [(rng.integers(0, len(X), sample), 0, -1, 0)]
        while stack:
            rows, level, parent, side = stack.pop()
            i = len(feat)
            if parent >= 0:
                (left if side == 0 else right)[parent] = i
            feat.append(-2), thr.append(-2.0), left.append(-1)
            right.append(-1), lvl.append(level)
            val.append(np.bincount(y[rows], minlength=n_out) / len(rows)
                       if n_out > 1 else [0.1 * rng.standard_normal()])
            for _ in range(8 if level < depth and len(rows) >= min_split
                           else 0):
                f = int(rng.integers(X.shape[1]))
                t = float(X[rows[rng.integers(len(rows))], f])
                go = X[rows, f] <= t
                if 0 < go.sum() < len(rows):   # else another draw
                    feat[i], thr[i] = f, t
                    stack.append((rows[~go], level + 1, i, 1))
                    stack.append((rows[go], level + 1, i, 0))
                    break
        tree = type("Tree", (), {})()
        tree.feature, tree.threshold = np.array(feat), np.array(thr)
        tree.children_left = np.array(left)
        tree.children_right = np.array(right)
        tree.value = np.asarray(val, np.float64)[:, None, :]
        tree.node_count, tree.max_depth = len(feat), max(lvl)
        trees.append(tree)
    return trees


def phase_tree_infer(seed: int):
    """Phase 17 (c): RF-shaped (RF_TREES trees of depth <= RF_DEPTH, 7
    classes) and GB-shaped (GB_STAGES stages x 7 classes of depth
    GB_DEPTH) ensembles grown from --seed on phase 10's covtype-shaped X,
    predicted through TorchModel.predict_proba (TI1), each TI1 held to
    its plain version (rtol 1e-6) and timed in a CUDA graph beside its
    bound (X, the nodes this X reaches and the output once; a compare
    and a select a node visit) and the plain version.
    Returns (rows, runs)."""
    import torch

    from spark_sklearn_tpu_torch.convert import tree_infer as ti
    from spark_sklearn_tpu_torch.convert.converter import TorchModel
    from spark_sklearn_tpu_torch.ops import tree_infer_kernels as tik

    X, y = covtype_like(seed)
    rng = np.random.default_rng(seed + 17)
    Xd = torch.as_tensor(X, device="cuda")
    meta = {"n_features": D_RF, "n_classes": K_RF,
            "classes": np.arange(K_RF)}
    t0 = time.perf_counter()
    forest = ti.pack_trees(grown_trees(rng, X, y, RF_TREES, RF_DEPTH, K_RF))
    boost = ti.pack_trees(grown_trees(rng, X, y, GB_STAGES * K_RF, GB_DEPTH,
                                      1, sample=20000))
    boost.update(init=np.log(np.bincount(y, minlength=K_RF) / len(y)
                             ).astype(np.float32),
                 learning_rate=0.1, k_eff=K_RF)
    grow_s = time.perf_counter() - t0
    rows, runs = {}, {}
    for label, packed, shim, mode in (
            ("forest", forest, ti.PackedForestClassifier, "forest_proba"),
            ("boost", boost, ti.PackedGBClassifier, "boost")):
        model = ti.to_device(packed, "cuda")
        tm = TorchModel(shim, model, {}, meta)
        tik.reset_launches()
        t0 = time.perf_counter()
        proba = tm.predict_proba(X)
        cold = time.perf_counter() - t0
        if tik.LAUNCHES["tree_ensemble"] == 0:
            raise AssertionError(f"{label}: tree_ensemble never launched")
        launches = dict(tik.LAUNCHES)
        t0 = time.perf_counter()
        proba = tm.predict_proba(X)
        warm = time.perf_counter() - t0
        if not (np.isfinite(proba).all()
                and np.allclose(proba.sum(axis=1), 1.0, atol=1e-5)):
            raise AssertionError(f"{label}: probabilities do not sum to 1")
        acc = float(np.mean(np.argmax(proba, axis=1) == y))
        args = [model[a] for a in ti.ARRAYS] + [model["max_depth"], mode]
        kw = ({"K": K_RF, "init": model["init"], "lr": 0.1}
              if mode == "boost" else {})
        got = tik.tree_ensemble(Xd, *args, **kw)
        want = tik.tree_ensemble_plain(Xd, *args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        if not torch.equal(got, tik.tree_ensemble(Xd, *args, **kw)):
            raise AssertionError(f"{label}: two launches differ")
        internal, leaf, inner_nodes, leaf_nodes = tik.node_visits(
            Xd, *args[:4], model["max_depth"])
        width = got.shape[1]
        n_out = packed["value"].shape[2]
        # bytes: X once, each node this X reaches once (an internal
        # node's feature, threshold, left and right; a leaf's left and
        # values), the output once; operations: a compare and a select a
        # visit of an internal node, the leaf's reduction (forest: its
        # sum, the divisions and the adds over n_out; else one add)
        nbytes = (4 * X.size + 16 * inner_nodes
                  + (4 + 4 * n_out) * leaf_nodes + 4 * len(X) * width)
        ops = 2 * internal + leaf * (3 * n_out if mode == "forest_proba"
                                     else 1)
        b_ms, b_by = bound(nbytes, ops)
        ms = graph_ms(lambda: tik.tree_ensemble(Xd, *args, **kw), reps=10)
        events = cuda_ms(lambda: tik.tree_ensemble(Xd, *args, **kw),
                         reps=10)
        plain_ms = cuda_ms(lambda: tik.tree_ensemble_plain(Xd, *args, **kw),
                           reps=1, warmup=0)
        T, N = packed["feature"].shape
        rows[label] = {"ms": ms, "events_ms": events, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None, "max_abs_err": err,
                       "bytes": nbytes, "ops": ops,
                       "internal_visits": internal, "leaf_visits": leaf,
                       "internal_nodes": inner_nodes,
                       "leaf_nodes": leaf_nodes,
                       "shape": {"n": len(X), "d": D_RF, "trees": T,
                                 "nodes": N, "max_depth":
                                     packed["max_depth"], "width": width}}
        runs[label] = {"cold_s": cold, "warm_s": warm, "launches": launches,
                       "accuracy": acc}
        print(f"  {label}: {T} trees of up to {N} nodes, depth "
              f"{packed['max_depth']}: predict_proba on {len(X)} rows cold "
              f"{cold:.3f} s, warm {warm:.3f} s (launches {launches}, "
              f"accuracy {acc:.4f}); TI1 {ms:.4f} ms in a graph, {events:.4f}"
              f" ms between events (plain {plain_ms:.2f} ms; bound "
              f"{b_ms:.5f} ms by {b_by}, {internal} internal and {leaf} "
              f"leaf visits), max abs err {err:.3g}")
    runs["grow_s"] = grow_s
    return rows, runs


def phase_keyed_kernels(seed: int):
    """K2ℓ, K4ℓ and C1ℓ against their plain versions at phase 17's
    largest bucket (the multinomial fleet's k = 4, d = 32; KMeans' 8
    centers), each timed in a CUDA graph and between events beside its
    bound and the plain version (and for C1ℓ the library route: torch.bmm
    of X Cᵀ, the distances formed from it, torch.min).  Returns {name:
    row}."""
    import torch

    from spark_sklearn_tpu_torch.keyed.keyed import buckets_of
    from spark_sklearn_tpu_torch.ops import glm_kernels as gk
    from spark_sklearn_tpu_torch.ops import kmeans_kernels as kmk

    _, _, sizes = keyed_table(seed)
    buckets = buckets_of(sizes[:KEYED_KEYS])
    L, idx = max(buckets.items(), key=lambda kv: kv[0] * len(kv[1]))
    G = len(idx)
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, d, kc = KEYED_K, KEYED_D, 8
    w = torch.zeros((G, L), device="cuda")
    for j, i in enumerate(idx):
        w[j, :sizes[i]] = 1.0
    Z = 3.0 * torch.randn((G, L, k), generator=g, device="cuda")
    Zp = torch.randn((G, L, k), generator=g, device="cuda")
    y = torch.randint(0, k, (G, L), generator=g, device="cuda",
                      dtype=torch.int32)
    a0 = 0.05 + 0.95 * torch.rand(G, generator=g, device="cuda")
    alphas = ((0.5 ** torch.arange(16, device="cuda", dtype=torch.float32)
               )[:, None] * a0[None, :]).contiguous()
    X = torch.randn((G, L, d), generator=g, device="cuda") * w[:, :, None]
    C = X[:, :kc].contiguous()
    xx, cc = (X * X).sum(dim=2), (C * C).sum(dim=2)
    rows = {}
    rowsGL = G * L
    # K2ℓ: reads Z, w, y once, writes G once; per logit max, sub, exp,
    # add, then mul, sub, mul; per row log, add, sub, mul, add, recip
    # K4ℓ: reads Z, Zp, w, y; per trial and logit fma, max, fma, sub,
    # exp, add, per row 5
    cases = {
        "glm_loss_grad_lanes": (
            lambda: gk.glm_loss_grad_lanes(Z, w, y),
            lambda: gk.glm_loss_grad_lanes_plain(Z, w, y),
            4 * (2 * rowsGL * k + 2 * rowsGL + G), rowsGL * (7 * k + 6),
            None),
        "glm_trial_loss_lanes": (
            lambda: gk.glm_trial_loss_lanes(Z, Zp, w, y, alphas),
            lambda: gk.glm_trial_loss_lanes_plain(Z, Zp, w, y, alphas),
            4 * (2 * rowsGL * k + 2 * rowsGL + 32 * G),
            16 * rowsGL * (8 * k + 5), None),
        "kmeans_assign_lanes": (
            lambda: kmk.kmeans_assign_lanes(X, C, xx, cc, w),
            lambda: kmk.kmeans_assign_lanes_plain(X, C, xx, cc, w),
            4 * (rowsGL * d + G * kc * d + rowsGL + G * kc + rowsGL)
            + 8 * rowsGL + 4 * G,
            2 * rowsGL * kc * d + 4 * rowsGL * kc,
            lambda: torch.min(torch.clamp_min(
                (xx[:, :, None] - 2.0 * torch.bmm(X, C.transpose(1, 2)))
                + cc[:, None, :], 0.0), dim=2)),
    }
    for name, (fn, plain, nbytes, ops, library) in cases.items():
        a, b = fn(), fn()
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError(f"{name}: two launches differ")
        want = plain()
        if name == "kmeans_assign_lanes":
            if not (torch.equal(a[0], want[0]) and torch.equal(a[1],
                                                               want[1])):
                raise AssertionError("kmeans_assign_lanes: assignments or "
                                     "distances differ from the plain "
                                     "version")
            torch.testing.assert_close(a[2], want[2], rtol=1e-5, atol=0.0)
            err = float((a[1] - want[1]).abs().max())
        elif name == "glm_loss_grad_lanes":
            torch.testing.assert_close(a[0], want[0], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(a[1], want[1], rtol=0, atol=1e-6)
            err = max(float((a[0] - want[0]).abs().max()),
                      float((a[1] - want[1]).abs().max()))
        else:
            torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)
            err = float((a - want).abs().max())
        b_ms, b_by = bound(nbytes, ops)
        ms = graph_ms(fn, reps=20)
        events = cuda_ms(fn, reps=10)
        plain_ms = cuda_ms(plain, reps=1, warmup=0)
        lib_ms = cuda_ms(library, reps=5) if library else None
        rows[name] = {"ms": ms, "events_ms": events, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms, "max_abs_err": err,
                      "bytes": nbytes, "ops": ops,
                      "shape": {"G": G, "L": L, "k": kc if "kmeans" in name
                                else k, "d": d}}
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"  {name:22s} G={G} L={L}: {ms:.4f} ms in a graph, "
              f"{events:.4f} ms between events (plain {plain_ms:.4f} ms"
              f"{lib}; bound {b_ms:.5f} ms by {b_by}), max abs err "
              f"{err:.3g}, bitwise repeatable")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from spark_sklearn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 GEMMs
    t_start = time.perf_counter()
    print("[1] card")
    print(nvidia_smi("name,power.limit"))
    kind = torch.cuda.get_device_name(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{n_sm} SMs, max SM clock {sm_mhz:.0f} MHz, "
          f"{torch.cuda.device_count()} visible")

    header("[2] build", t_start)
    report = _build.build(["glm_epilogue", "svm_dual", "tree_hist",
                           "mlp_step", "naive_bayes", "knn_topk", "kmeans",
                           "svm_proba", "csr_spmm", "tree_infer"])
    ptxas = {}
    for name, r in report.items():
        print(f"  {name}: {r['seconds']:.2f} s")
        ptxas.update(ptxas_table(str(r["log"])))
    for fn, (regs, spill) in sorted(ptxas.items()):
        print(f"    {regs:4d} registers {spill:5d} bytes spilled  {fn}")

    header("[3] kernels at the headline and phase-8/9/10/11/12/13/16 shapes",
           t_start)
    rows = phase_kernels(args.seed, n_sm, sm_mhz, ptxas)
    svm_rows = phase_svm_kernels(args.seed, ptxas)
    svm_rows.update(phase_pipeline_svm_kernels(args.seed, ptxas))
    tree_rows = phase_tree_kernels(args.seed, ptxas)
    mlp_rows = phase_mlp_kernels(
        args.seed, ptxas_table(str(report["mlp_step"]["log"])))
    slice_rows = phase_slice_kernels(args.seed, ptxas)
    proba_rows = phase_proba_kernels(args.seed, n_sm, sm_mhz, ptxas)
    sparse_rows, sparse_copies = phase_sparse_kernels(args.seed, ptxas)

    header("[4] main path: 1000 C x 5 folds on cuda", t_start)
    X, y = digits_like(args.seed)
    Cs = np.logspace(-4, 3, N_C)
    main_run = phase_main(X, y, Cs)

    header("[5] cuda against cpu", t_start)
    phase_agreement(X, y, Cs[::50])

    header("[6] regressors: California-Housing-shaped, n=20640, d=8", t_start)
    regressors = phase_regressors(args.seed)

    header("[7] the l1 path: RandomizedSearchCV, 200 C x 5 folds by FISTA",
           t_start)
    l1_run = phase_l1(X, y, args.seed)

    header("[8] kernel SVMs: SVC(rbf) 3 C x 3 gamma x 5 folds, n=10000, "
           "d=784", t_start)
    svm_run = phase_svm(args.seed, svm_rows)

    header("[9] gradient boosting: GridSearchCV(GradientBoostingRegressor)"
           " 24 candidates x 5 folds, n=20640, d=8", t_start)
    gb_run = phase_gb(args.seed)

    header(f"[10] random forest: RandomizedSearchCV(RandomForestClassifier)"
           f" 4 candidates x 3 folds on covtype-shaped data, n={N_RF} "
           f"(rows cut from 581012), d={D_RF}", t_start)
    rf_run = phase_rf(args.seed)

    header("[11] the MLP pipeline, BASELINE #5: GridSearchCV(Pipeline("
           "StandardScaler, MLPClassifier)) 4 alphas x 3 folds, n=1797, "
           "d=64", t_start)
    mlp_run = phase_mlp(args.seed)

    header("[12] naive Bayes, LDA, KNN and KMeans: GaussianNB on "
           f"covtype-shaped data (n={N_RF}), the discrete NBs on digits "
           "counts, LDA and KNN on MNIST-shaped data, a KNN regressor, "
           "KMeans", t_start)
    slice_run = phase_slice(args.seed)

    header("[13] the rest of the SVMs: SVC(probability=True) on MNIST-shaped "
           "data, SVR and NuSVR on California-shaped data, LinearSVC, "
           "LinearSVR", t_start)
    rest_run = phase_svm_rest(args.seed)

    header("[14] the weighted search front end: the headline search and "
           "phase 13's SVC probability search with sample_weight", t_start)
    weighted_run = phase_weighted(X, y, Cs, args.seed, main_run)
    weighted_run["svc_proba"] = rest_run["svc_proba_weighted"]

    header("[15] successive halving: (a) 1000 C and (d) a random search "
           "on digits-shaped data, (b) SVC(rbf) on MNIST-shaped data, "
           "(c) boosting with resource=n_estimators", t_start)
    halving_run = phase_halving(args.seed, X, y, Cs)

    header("[16] sparse X: LogisticRegression and the discrete naive Bayes "
           f"under data_mode='sparse' on 20-newsgroups-shaped counts "
           f"({NG_N} x {NG_D}, {NG_K} classes)", t_start)
    sparse_run = phase_sparse(args.seed)
    sparse_run["copies"] = sparse_copies

    header(f"[17] keyed fleets ({KEYED_KEYS} keys, Zipf group sizes "
           f"{KEYED_MIN}-{KEYED_MAX}, d={KEYED_D}), gapply segments, "
           f"converted RF/GB ensembles on covtype-shaped data", t_start)
    keyed_rows = phase_keyed_kernels(args.seed)
    keyed_run = phase_keyed(args.seed)
    ti_rows, ti_run = phase_tree_infer(args.seed)
    keyed_run["tree_infer"] = ti_run

    meta = {
        "glm_loss_grad": "spark_sklearn_tpu/models/linear.py:221",
        "glm_trial_loss": "spark_sklearn_tpu/ops/solvers.py:290",
    }
    kernels = []
    for name, replaces in meta.items():
        head, binary = rows[(name, K)], rows[(name, 2)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_sklearn_tpu_torch/csrc/glm_epilogue.cu",
            "replaces": replaces,
            "launches": main_run["launches"][name],
            "launches_by_path": {
                "headline": main_run["launches"][name],
                "l1": l1_run["l1"]["launches"][name],
                "elasticnet": l1_run["elasticnet"]["launches"][name],
                "halving_a": halving_run["a"]["launches"][name],
                "halving_d": halving_run["d"]["launches"][name]},
            "max_abs_err": max(head["max_abs_err"], binary["max_abs_err"]),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "sfu_bound_ms": head["sfu_bound_ms"],
            "plan": head["plan"], "registers": head["registers"],
            "spill_bytes": head["spill_bytes"],
            "tolerance": ("loss rtol 1e-5, G atol 1e-6"
                          if name == "glm_loss_grad" else "rtol 1e-5"),
            "shape": {"n": N, "B": N_C * N_FOLDS, "k": K},
            "binary": {k: binary[k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by",
                        "sfu_bound_ms", "max_abs_err", "plan", "registers",
                        "spill_bytes")},
        })
    svm_meta = {
        "svm_gram_epilogue": ("spark_sklearn_tpu/models/svm.py:45", "rbf",
                              "poly", "rtol 1e-5, atol 1e-6"),
        "svm_dual_step": ("spark_sklearn_tpu/models/svm.py:94", "svc_pairs",
                          "nu_pairs",
                          "atol 1e-5 (x', z', w'; max_abs_err), 1e-5/step "
                          "(residual; resid_max_abs_err), rtol 1e-5"),
    }
    svm_pipeline = {"svm_gram_epilogue": "rbf_pipeline",
                    "svm_dual_step": "svc_pipeline"}
    for name, (replaces, main_v, other_v, tol) in svm_meta.items():
        head, other = svm_rows[(name, main_v)], svm_rows[(name, other_v)]
        pipe = svm_rows[(name, svm_pipeline[name])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_sklearn_tpu_torch/csrc/svm_dual.cu",
            "replaces": replaces,
            "launches": svm_run["svc"]["launches"][name],
            "launches_by_path": {
                "svc": svm_run["svc"]["launches"][name],
                "nusvc": svm_run["nusvc"]["launches"][name],
                "svc_pipeline": mlp_run["svc_pipeline"]["launches"][name],
                "halving_b": halving_run["b"]["launches"][name]},
            "max_abs_err": max(svm_rows[key]["max_abs_err"]
                               for key in svm_rows if key[0] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            **({"events_ms": head["events_ms"]} if "events_ms" in head
               else {}),
            **({"host_us": head["host_us"]} if "host_us" in head else {}),
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "plan": head["plan"],
            "registers": head["registers"],
            "spill_bytes": head["spill_bytes"], "tolerance": tol,
            "shape": ({"n": N_SVM, "d": D_SVM, "kind": main_v}
                      if name == "svm_gram_epilogue" else
                      {"M": SVM_ROWS, "n": N_SVM, "mode": main_v}),
            other_v: {k: other[k] for k in
                      ("ms", "events_ms", "plain_ms", "bound_ms", "bound_by",
                       "max_abs_err", "plan", "registers", "spill_bytes")
                      if k in other},
            "svc_pipeline": pipe,
            **({"resid_max_abs_err": max(
                    r["resid_max_abs_err"] for key, r in svm_rows.items()
                    if key[0] == name),
                "streamed_ms": {key[1]: r["streamed_ms"]
                                for key, r in svm_rows.items()
                                if key[0] == name},
                "phase3_inputs": {v: svm_rows[(name, v)]
                                  for v in ("svc", "nu")}}
               if name == "svm_dual_step" else
               {"rbf_predict": svm_rows[(name, "rbf_predict")]}),
        })
    tree_meta = {
        "tree_level_hist": ("spark_sklearn_tpu/ops/trees.py:70", "rf/512"),
        "tree_best_split": ("spark_sklearn_tpu/ops/trees.py:85", "rf/512"),
        "tree_route": ("spark_sklearn_tpu/ops/trees.py:129", "rf/512"),
        "tree_leaf_values": ("spark_sklearn_tpu/ops/trees.py:142",
                             "rf/2047"),
        "tree_segments": ("spark_sklearn_tpu/ops/trees.py:70", "rf/512"),
    }
    tree_paths = {"rf_classifier": rf_run["classifier"],
                  "rf_regressor": rf_run["regressor"],
                  "gb_regressor": gb_run["regressor"],
                  "gb_classifier": gb_run["classifier"]}
    for name, (replaces, main_shape) in tree_meta.items():
        head = tree_rows[(name, main_shape)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_sklearn_tpu_torch/csrc/tree_hist.cu",
            "replaces": replaces,
            "launches": rf_run["classifier"]["launches"][name],
            "launches_by_path": {
                **{p: r["launches"][name] for p, r in tree_paths.items()},
                "halving_c": halving_run["c"]["launches"][name]},
            "max_abs_err": max(r["max_abs_err"] for key, r in
                               tree_rows.items() if key[0] == name),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **({k: head[k] for k in ("wrapper_ms", "order_bound_ms")}
               if "wrapper_ms" in head else {}),
            **{k: head[k] for k in ("events_ms", "hist_bytes_ms")
               if k in head},
            "registers": head["registers"],
            "spill_bytes": head["spill_bytes"],
            "tolerance": (
                "equal to the plain version on CPU copies of the inputs "
                "(forest and boosting stats)" if name in (
                    "tree_level_hist", "tree_leaf_values") else
                "equal to the plain version on CPU copies (integers)"
                if name == "tree_segments" else
                "forest stats equal; boosting gains rtol 1e-4 and the "
                "same split where the two best gains differ by > 1e-5 "
                "relative" if name == "tree_best_split" else "equal"),
            "shape": main_shape,
            "by_shape": {key[1]: {k: v for k, v in r.items()
                                  if k not in ("plan",)}
                         for key, r in tree_rows.items() if key[0] == name},
        })
    mlp_meta = {
        "mlp_loss_grad": ("spark_sklearn_tpu/models/mlp.py:155",
                          ("mlp_loss_grad",),
                          "loss rtol 1e-5, G and db atol 1e-6, wsum "
                          "equal"),
        "mlp_opt_step": ("spark_sklearn_tpu/models/mlp.py:167",
                         ("mlp_opt_step",), "p, m, v rtol 1e-5 atol 1e-7; "
                         "acc rtol 1e-5"),
        "mlp_act": ("spark_sklearn_tpu/models/mlp.py:60",
                    ("mlp_act_forward", "mlp_act_backward"),
                    "forward rtol 1e-6 atol 1e-6, backward atol 1e-6"),
    }
    mlp_paths = {"baseline5": mlp_run["classifier"],
                 "regressor": mlp_run["regressor"]}
    agreement = {key[1]: r for key, r in mlp_rows.items()
                 if key[0] == "agreement"}
    for name, (replaces, parts, tol) in mlp_meta.items():
        head = mlp_rows[(parts[0], "baseline5")]
        by_shape = {f"{part}/{key[1]}": {
            k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_abs_err", "registers",
                              "spill_bytes", "shape")}
            for part in parts for key, r in mlp_rows.items()
            if key[0] == part}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_sklearn_tpu_torch/csrc/mlp_step.cu",
            "replaces": replaces,
            "launches": mlp_run["classifier"]["launches"][name],
            "launches_by_path": {p: r["launches"][name]
                                 for p, r in mlp_paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in by_shape.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "wrapper_ms": head["wrapper_ms"],
            "path_ms": mlp_run["classifier"]["path_ms"][name],
            "library": {
                "mlp_opt_step": "torch._fused_adam_ (the adam core alone); "
                                "sgd: torch._fused_sgd_ (the momentum core)",
                "mlp_act": "forward: none; backward (relu): "
                           "torch.ops.aten.threshold_backward, by_shape's "
                           "mlp_act_backward rows"}.get(
                name, "none: no single torch call computes it"),
            "registers": head["registers"],
            "spill_bytes": head["spill_bytes"], "tolerance": tol,
            "shape": head["shape"], "by_shape": by_shape,
            "agreement": {label: a["max_abs_err"][part]
                          for label, a in agreement.items()
                          for part in parts if part in a["max_abs_err"]},
            **({"host_us": head["host_us"],
                "torch_db_sum": {key[1]: r for key, r in mlp_rows.items()
                                 if key[0] == "db_sum"}}
               if name == "mlp_loss_grad" else {"host_us": head["host_us"]}),
        })
    slice_meta = {
        "knn_fold_topk": ("knn_topk", "spark_sklearn_tpu/models/"
                          "neighbors.py:71", "knn", "knn_regressor",
                          {"knn": slice_run["knn"],
                           "knn_regressor": slice_run["knn_regressor"]},
                          "equal to the plain version (d2 and idx)"),
        "kmeans_assign": ("kmeans", "spark_sklearn_tpu/models/"
                          "cluster.py:31", "kmeans", None,
                          {"kmeans": slice_run["kmeans"]},
                          "assign and min_d2 equal to the plain version, "
                          "inertia rtol 1e-5"),
        "gnb_jll": ("naive_bayes", "spark_sklearn_tpu/models/"
                    "naive_bayes.py:174", "gaussian_nb", None,
                    {"gaussian_nb": slice_run["gaussian_nb"]},
                    "rtol 1e-5, atol 1e-3"),
    }
    for name, (src, replaces, main_v, other_v, paths, tol) in \
            slice_meta.items():
        head = slice_rows[(name, main_v)]
        main_path = next(iter(paths.values()))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_sklearn_tpu_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "launches_by_path": {p: r["launches"][name]
                                 for p, r in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for key, r in
                               slice_rows.items() if key[0] == name),
            "ms": head["ms"], "events_ms": head["events_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": {"knn_fold_topk": "torch.topk(largest=False) on "
                                         "each fold's masked distances",
                        "kmeans_assign": "X @ C_all.T (cuBLAS), the "
                                         "distances formed from it, then "
                                         "torch.min(dim=-1)"}.get(name),
            "registers": head["registers"],
            "spill_bytes": head["spill_bytes"], "tolerance": tol,
            "shape": head["shape"],
            **({other_v: slice_rows[(name, other_v)]} if other_v else {}),
        })
    rest_meta = {
        "svm_platt_fit": ("svm_proba", "spark_sklearn_tpu/models/svm.py:331",
                          "svc_proba", {"svc_proba": "svc_proba",
                                        "svc_proba_weighted":
                                            "svc_proba_weighted"}),
        "svm_pair_coupling": ("svm_proba",
                              "spark_sklearn_tpu/models/svm.py:409",
                              "registers", {"svc_proba": "svc_proba",
                                            "svc_proba_weighted":
                                                "svc_proba_weighted"}),
        "svm_svr_step": ("svm_dual", "spark_sklearn_tpu/models/svr.py:48",
                         "svr", {"svr": "svr", "nu_svr": "nu_svr"}),
    }
    for name, (src, replaces, main_v, paths) in rest_meta.items():
        head = proba_rows[(name, main_v)]
        main_path = rest_run[next(iter(paths))]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_sklearn_tpu_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "launches_by_path": {p: rest_run[p]["launches"][name]
                                 for p in paths},
            "max_abs_err": max(r["max_abs_err"] for key, r in
                               proba_rows.items() if key[0] == name),
            "ms": head["ms"], "events_ms": head["events_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "library": "none: no single torch call computes it",
            "registers": head["registers"],
            "spill_bytes": head["spill_bytes"],
            "tolerance": head["tolerance"], "shape": head["shape"],
            **{v: row for (nm, v), row in proba_rows.items()
               if nm == name and v != main_v},
        })
    head = sparse_rows["lr_forward"]
    kernels.append({
        "name": "csr_spmm", "route": "cuda",
        "source": "spark_sklearn_tpu_torch/csrc/csr_spmm.cu",
        "replaces": "spark_sklearn_tpu/models/linear.py:213",
        "launches": sparse_run["lr"]["launches"]["csr_spmm"],
        "launches_by_path": {p: sparse_run[p]["launches"]["csr_spmm"]
                             for p in ("lr",) + SPARSE_NB},
        "max_abs_err": max(r["max_abs_err"] for r in sparse_rows.values()),
        "ms": head["ms"], "events_ms": head["events_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library": "torch.sparse.mm of a torch.sparse_csr_tensor "
                   "(cuSPARSE)",
        "gathered_ms": head["gathered_ms"],
        "registers": head["registers"], "spill_bytes": head["spill_bytes"],
        "tolerance": "2 nnz_row 2^-24 (|A| |D|) against the plain version "
                     "on the card (two summation orders); equal to it on "
                     "integer inputs and to the CPU's plain version on "
                     "2000 rows",
        "shape": head["shape"],
        **{v: r for v, r in sparse_rows.items() if v != "lr_forward"},
        "copies": sparse_copies,
    })
    keyed_meta = {
        "glm_loss_grad_lanes": (
            "glm_epilogue", "spark_sklearn_tpu/models/linear.py:128",
            "loss rtol 1e-5, G atol 1e-6", None),
        "glm_trial_loss_lanes": (
            "glm_epilogue", "spark_sklearn_tpu/ops/solvers.py:122",
            "rtol 1e-5", None),
        "kmeans_assign_lanes": (
            "kmeans", "spark_sklearn_tpu/models/cluster.py:129",
            "assign and min_d2 equal to the plain version, inertia rtol "
            "1e-5", "torch.bmm(X, Cᵀ), the distances formed from it, "
                    "torch.min(dim=2)"),
    }
    keyed_paths = {"glm_loss_grad_lanes": ("logreg_multinomial",
                                           "logreg_binary"),
                   "glm_trial_loss_lanes": ("logreg_multinomial",
                                            "logreg_binary"),
                   "kmeans_assign_lanes": ("kmeans",)}
    for name, (src, replaces, tol, library) in keyed_meta.items():
        head = keyed_rows[name]
        paths = keyed_paths[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_sklearn_tpu_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": keyed_run[paths[0]]["launches"][name],
            "launches_by_path": {p: keyed_run[p]["launches"][name]
                                 for p in paths},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "events_ms": head["events_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": library or "none: no single torch call computes it",
            "tolerance": tol, "shape": head["shape"]})
    head = ti_rows["forest"]
    kernels.append({
        "name": "tree_ensemble", "route": "cuda",
        "source": "spark_sklearn_tpu_torch/csrc/tree_infer.cu",
        "replaces": "spark_sklearn_tpu/convert/tree_infer.py:50",
        "launches": ti_run["forest"]["launches"]["tree_ensemble"],
        "launches_by_path": {p: ti_run[p]["launches"]["tree_ensemble"]
                             for p in ("forest", "boost")},
        "max_abs_err": max(r["max_abs_err"] for r in ti_rows.values()),
        "ms": head["ms"], "events_ms": head["events_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "library": "none: no single torch call computes it",
        "tolerance": "rtol 1e-6 against the plain version on the card",
        "shape": head["shape"], "boost": ti_rows["boost"]})
    main_run["wall_s"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "main": main_run,
                   "regressors": regressors, "l1": l1_run,
                   "svm": svm_run, "gb": gb_run, "rf": rf_run,
                   "mlp": mlp_run, "slice": slice_run, "rest": rest_run,
                   "weighted": weighted_run, "halving": halving_run,
                   "sparse": sparse_run, "keyed": keyed_run,
                   "card": nvidia_smi("name,power.limit")}, f, indent=1,
                  default=str)
    print(f"  total {main_run['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
