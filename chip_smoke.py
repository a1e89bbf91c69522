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
   grid) and a binary search (classes 0 and 1) on cuda and on the CPU.

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
HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12                  # H100 SXM float32, non-tensor-core
SFU_PER_CLOCK_PER_SM = 16              # exp2/log2 results (CUDA guide, 9.0)


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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        search(X, y, Cs, "cuda")
        torch.cuda.synchronize()
    # device time from the kernels alone: an aten op's row repeats the
    # time of the kernels it launched
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    iters = sum(n_iter)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    if busy_s > 0:
        print(f"  profiled: kernels busy {busy_s:.4f} s against the warm "
              f"wall {warm:.4f} s: idle share {1 - busy_s / warm:.4f}; per "
              f"iteration {busy_s / iters * 1e3:.3f} ms busy, "
              f"{(warm - busy_s) / iters * 1e3:.3f} ms idle")
    else:
        print("  profiled: no device time recorded (idle share not "
              "measured)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"    {dev_us(e) / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}")
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

    print("[2] build")
    report = _build.build(["glm_epilogue"])
    ptxas = {}
    for name, r in report.items():
        print(f"  {name}: {r['seconds']:.2f} s")
        ptxas.update(ptxas_table(str(r["log"])))
    for fn, (regs, spill) in sorted(ptxas.items()):
        print(f"    {regs:4d} registers {spill:5d} bytes spilled  {fn}")

    print("[3] kernels at the headline shapes")
    rows = phase_kernels(args.seed, n_sm, sm_mhz, ptxas)

    print("[4] main path: 1000 C x 5 folds on cuda")
    X, y = digits_like(args.seed)
    Cs = np.logspace(-4, 3, N_C)
    main_run = phase_main(X, y, Cs)

    print("[5] cuda against cpu")
    phase_agreement(X, y, Cs[::50])

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
                   "card": nvidia_smi("name,power.limit")}, f, indent=1)
    print(f"  total {main_run['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
