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
   the candidates.

It prints one JSON line of per-kernel numbers, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits 2.  It imports no
JAX, nothing of the JAX package and no scikit-learn.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12                  # H100 SXM float32, non-tensor-core
SFU_PER_CLOCK_PER_SM = 16              # exp2/log2 results (CUDA guide, 9.0)


def header(title: str, t_start: float) -> None:
    print(f"{title} ({time.perf_counter() - t_start:.1f} s in)")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


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


def profile_busy(run, warm: float, iters: int, out_name: str) -> float:
    """Profile one `run()` and print the device's busy time against the
    warm wall `warm` (idle share), per solver iteration where `iters` > 1,
    and the largest kernels; the time and count of every kernel go to
    chiprun_out/`out_name`.  Returns the kernels' busy seconds.

    The device events are summed from the profiler's raw records: the
    profiler's own per-op tables take tens of seconds to build over the
    ~10^5 events of a 1000-iteration solve."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
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
    for name, (ns, count) in kernels[:12]:
        print(f"    {ns / 1e6:10.3f} ms  {count:6d}x  {name[:90]}")
    print(f"    (profiled run {t_run:.1f} s, whole profile "
          f"{time.perf_counter() - t0:.1f} s)")
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
    n_iter = [c["n_iter"] for c in gs.chunks_]
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
    report = _build.build(["glm_epilogue"])
    ptxas = {}
    for name, r in report.items():
        print(f"  {name}: {r['seconds']:.2f} s")
        ptxas.update(ptxas_table(str(r["log"])))
    for fn, (regs, spill) in sorted(ptxas.items()):
        print(f"    {regs:4d} registers {spill:5d} bytes spilled  {fn}")

    header("[3] kernels at the headline shapes", t_start)
    rows = phase_kernels(args.seed, n_sm, sm_mhz, ptxas)

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
                "elasticnet": l1_run["elasticnet"]["launches"][name]},
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
    main_run["wall_s"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "main": main_run,
                   "regressors": regressors, "l1": l1_run,
                   "card": nvidia_smi("name,power.limit")}, f, indent=1)
    print(f"  total {main_run['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
