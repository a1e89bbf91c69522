"""Sweep the launch choices of S2's SVR mode and of P1 on one card.

- S2's SVR mode (`svm_svr_step`): at phase 13's SVR and NuSVR steps (5
  KFold rows of the California-shaped n = 20640, from
  `chip_smoke.svr_step_inputs`) and at shorter rows (n = 500 to 6000), a
  CUDA graph's ms for each cluster size C (CTAs a row) beside the one
  `svm_kernels.svr_step_plan` picks, with how many clusters of C the card
  holds at once; then, at n = 20640 and the picked C, the library built
  with other bisection steps a pass (`kSvrLevelsSvr`, `kSvrLevelsNu`:
  2, 3 and 4).  Each held to the plain version (rtol 1e-5, atol 1e-4).
  It picks `SVR_MIN_SHARE` and the two constants.
- P1 (`svm_platt_fit`) at phase 13's SVC probability search (2025 rows of
  n = 10000, `chip_smoke.proba_inputs`), built with at most 128
  registers a thread (its own `kPlattMinBlocks` = 2) and 64 (4): ms
  between CUDA events of the staged plan (with the exit), `staged_full`
  (all 50 steps) and `streamed` through the wrapper, the rows' steps,
  and whether the three give the same bits.
- With `--parent DIR`, the same SVR and P1 calls of the parent tree's
  package (run in its directory) on the same inputs, timed alike, with
  whether P1's outputs keep the parent's bits.

    python3 chip_sweep.py [--parent .scratch/parent]

Prints one table a part and writes everything to
`chiprun_out/chip_sweep.json`; the card's name and power limit head the
output.  It exits non-zero without a card or if a variant disagrees with
its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import chip_smoke as cs

#: S2's SVR mode: the rows (n) and their cluster sizes, and the builds
#: with other bisection steps a pass: (tag, epsilon-SVR's, nu-SVR's)
SVR_ROWS = ((20640, (2, 4, 8, 12, 16)), (500, (1, 2, 4, 8)),
            (1000, (2, 4, 8, 16)), (2000, (4, 8, 16)), (6000, (8, 16)))
LEVELS = "constexpr int kSvrLevels{} = {};"
SVR_LEVEL_BUILDS = (("k3k2", 3, 2), ("k2k3", 2, 3), ("k4k4", 4, 4))
MB = "constexpr int kPlattMinBlocks = 2; "
#: P1's builds: (tag, source replacements)
PLATT_VARIANTS = (("mb2", []), ("mb4", [(MB, MB.replace("2", "4"))]))
OUT = os.path.join("chiprun_out", "chip_sweep.json")

# The parent's calls, run in the parent's directory on this tree's inputs
# (argv: this tree's directory): the SVR step by the parent's own plan and
# P1, each timed, P1's outputs digested.
PARENT = """
import hashlib, importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("cs", sys.argv[1] + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from spark_sklearn_tpu_torch.ops import svm_kernels as svk
from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk
out = {}
for mode in ("svr", "nu"):
    args = cs.svr_step_inputs(0, mode)
    out["svr " + mode] = {"ms": cs.graph_ms(lambda: svk.svr_dual_step(*args)),
                          "plan": svk.svr_step_plan(args[5].shape[1])}
dec, y, tw, pairs = cs.proba_inputs(0)
A, B = pk.platt_fit(dec, y, tw, pairs, False)
h = hashlib.sha256()
for t in (A, B):
    h.update(t.cpu().numpy().tobytes())
out["platt"] = {"ms": cs.cuda_ms(lambda: pk.platt_fit(dec, y, tw, pairs, False),
                                 reps=5, warmup=1), "bits": h.hexdigest()[:16]}
print(json.dumps(out))
"""


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _use(module, lib) -> None:
    """Point `module._lib` at the library `lib` (None: the build's own)."""
    from spark_sklearn_tpu_torch.ops import _build

    module._lib.cache_clear()
    if lib is None:
        return
    load = _build.load_library
    _build.load_library = lambda name: lib
    try:
        module._lib()
    finally:
        _build.load_library = load


def svr_sweep() -> list:
    """The SVR step's cluster sizes at phase 13's rows and shorter ones,
    then its bisection steps a pass at phase 13's rows, both modes."""
    import torch

    from spark_sklearn_tpu_torch.ops import svm_kernels as svk

    rows = []
    dev = torch.cuda.current_device()

    def run(mode, n, args, want, cluster, tag):
        held = functools.partial(svk.svr_clusters, dev, n, mode == "nu")
        picked = svk.svr_step_plan(n, args[5].shape[0], clusters=held)
        plan = picked if cluster is None else svk.svr_step_plan(
            n, cluster=cluster)
        got = svk.svr_dual_step(*args, plan=plan)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
        ms = cs.graph_ms(lambda: svk.svr_dual_step(*args, plan=plan))
        row = {"mode": mode, "n": n, "build": tag,
               "cluster": plan["cluster"],
               "picked": plan["cluster"] == picked["cluster"],
               "clusters_held": held(plan["cluster"]), "ms": ms}
        rows.append(row)
        print(f"  svr {mode:3s} n={n:6d} {tag} C={row['cluster']:2d}"
              f"{' (picked)' if row['picked'] else ''}: {ms:.4f} ms, "
              f"{row['clusters_held']} clusters held", flush=True)

    for mode in ("svr", "nu"):
        full = cs.svr_step_inputs(0, mode)
        for n, clusters in SVR_ROWS:
            args = full if n == full[5].shape[1] else _cut(full, n)
            want = svk.svr_dual_step_plain(*args)
            for c in clusters:
                run(mode, n, args, want, c, "k3k2")
            del want
    for tag, k_svr, k_nu in SVR_LEVEL_BUILDS[1:]:
        lib, _ = build_variant("svm_dual", [
            (LEVELS.format("Svr", 3), LEVELS.format("Svr", k_svr)),
            (LEVELS.format("Nu", 2), LEVELS.format("Nu", k_nu))], tag)
        _use(svk, lib)
        svk.svr_clusters.cache_clear()
        for mode in ("svr", "nu"):
            args = cs.svr_step_inputs(0, mode)
            run(mode, args[5].shape[1], args,
                svk.svr_dual_step_plain(*args), None, tag)
    _use(svk, None)
    svk.svr_clusters.cache_clear()
    return rows


def _cut(args, n):
    """Phase 13's SVR step inputs cut to the first n pairs of each row
    (nu-SVR's target a quarter of the cut row's box, as for the full)."""
    import torch

    V, z, x, y, eps, bh, step, coef, target = args
    N = bh.shape[1]
    bh_n = bh[:, :n].contiguous()

    def pairs(a):
        return torch.cat([a[:, :n], a[:, N:N + n]], dim=1).contiguous()

    return (V[:, :n].contiguous(), pairs(z), pairs(x), y[:n].contiguous(),
            eps, bh_n, step, coef,
            None if target is None else 0.25 * bh_n.sum(dim=1))


def build_variant(name: str, subs, tag: str):
    """csrc/<name>.cu with the text replacements `subs`, built as
    `_build` builds it into a temporary directory: (CDLL, nvcc's log)."""
    from spark_sklearn_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for a, b in subs:
        if a not in src:
            raise SystemExit(f"chip_sweep: {a!r} is not in {name}.cu")
        src = src.replace(a, b)
    d = tempfile.mkdtemp(prefix="chip_sweep_")
    path = os.path.join(d, f"{name}_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(d, f"lib{name}_{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                           path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {tag}:\n{proc.stdout}"
                         f"{proc.stderr}")
    return ctypes.CDLL(out), proc.stdout + proc.stderr


def platt_sweep() -> list:
    """P1 built as each of `PLATT_VARIANTS` says: each plan through the
    wrapper, ms between CUDA events, its rows' steps and bits."""
    import torch

    from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk

    dec, y, tw, pairs = cs.proba_inputs(0)
    B, n, P = dec.shape
    pA, pB = pk.platt_fit_rows_plain(dec, y, tw, pairs, False)
    rows = []
    for tag, subs in PLATT_VARIANTS:
        lib, log = build_variant("svm_proba", subs, tag)
        regs = {f.split("platt_fit_kernel")[1][:12]: v for f, v in
                cs.ptxas_table(log).items() if "platt_fit" in f}
        _use(pk, lib)
        bits = {}
        for plan in ("staged", "staged_full", "streamed"):
            steps = torch.zeros((B * P, 2), dtype=torch.int32, device="cuda")
            Ap, Bp = pk.platt_fit(dec, y, tw, pairs, False, plan=plan,
                                  steps=steps)
            torch.cuda.synchronize()
            torch.testing.assert_close(Ap, pA, rtol=1e-3, atol=1e-3)
            torch.testing.assert_close(Bp, pB, rtol=1e-3, atol=1e-3)
            bits[plan] = digest([Ap, Bp])
            st = steps[:, 0].float()
            rows.append({
                "variant": tag, "plan": plan, "bits": bits[plan],
                "ms": cs.cuda_ms(lambda p=plan: pk.platt_fit(
                    dec, y, tw, pairs, False, plan=p), reps=5, warmup=1),
                "steps_min_median_max": [int(st.min()), float(st.median()),
                                         int(st.max())],
                "rows_at_50_steps": int((st == pk.N_NEWTON).sum()),
                "trials_mean": float(steps[:, 1].float().mean()),
                "registers": regs})
        if len(set(bits.values())) != 1:
            raise SystemExit(f"chip_sweep: P1's plans differ in bits in "
                             f"{tag}: {bits}")
    _use(pk, None)
    for r in rows:
        print(f"  platt {r['variant']:4s} {r['plan']:12s}: {r['ms']:.4f} ms,"
              f" steps {r['steps_min_median_max']} ({r['rows_at_50_steps']}"
              f" rows at 50), trials {r['trials_mean']:.2f}, bits "
              f"{r['bits']}, registers {r['registers']}", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory of the parent's tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    from spark_sklearn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    report = _build.build(["svm_dual", "svm_proba"])
    table = {}
    for r in report.values():
        table.update(cs.ptxas_table(str(r["log"])))
    for fn, (regs, spill) in sorted(table.items()):
        if "svr" in fn or "platt" in fn:
            print(f"  {regs:4d} registers {spill:5d} bytes spilled  {fn}")
    out = {"card": card, "ptxas": {f: v for f, v in table.items()
                                   if "svr" in f or "platt" in f}}
    if args.parent:
        proc = subprocess.run([sys.executable, "-c", PARENT,
                               os.path.abspath(".")], cwd=args.parent,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit("chip_sweep: the parent's calls failed")
        out["parent"] = json.loads(proc.stdout.strip().splitlines()[-1])
        print("  parent:", json.dumps(out["parent"]), flush=True)
    out["svr"] = svr_sweep()
    out["platt"] = platt_sweep()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    best = {}
    for r in out["svr"]:
        key = (r["mode"], r["n"])
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    for (mode, n), r in sorted(best.items()):
        print(f"  fastest svr {mode} n={n}: {r['build']} C={r['cluster']} "
              f"{r['ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
