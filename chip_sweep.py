"""Sweep the launch choices of S2's SVR mode, P1 and P2 on one card.

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
- P2 (`svm_pair_coupling`) at phase 13's 450000 problems (its SVC
  search's k = 10 decisions, and `chip_smoke.coupling_inputs` at k = 10
  to 64): every plan of this tree's build, each held to the plain
  version (atol 1e-4); then libraries rebuilt (`COUPLING_VARIANTS`, in
  parallel): the group plan with one group size G for every k it holds
  (`kGroupLanes`, `kGroupLastK`: G 8, 16 and 32 beside the build's 4 to
  k = 28, 8 to 40, 16 to 64), other register caps (`kRegMinBlocks`,
  `kGroupMinBlocks`: the blocks of 128 threads an SM each plan leaves
  room for; the group plan's 0 takes `group_min_blocks`' cap by shape),
  99 sweeps (a problem whose 99-sweep p has the 100-sweep bits reached
  a sweep that gives back its own p: the share an exact exit could
  serve) and the register plan leaving a problem at such a sweep (timed,
  its bits held to the 100-sweep run's).
- SP1 (`csr_spmm`) at phase 16's four shapes (`chip_smoke.SPARSE_MAIN`:
  the sparse LogisticRegression's forward and backward at W = 1000, the
  naive Bayes class sums at W = 100 and joint log-likelihoods at W =
  500, on the 20-newsgroups-shaped X from `--seed` 0): each shape's
  items traced on the card's global timer (span, heavy and light items'
  times, the last to finish); then other launch choices of this tree's
  build, set in this process by replacing what `spmm_kernels` picks them
  with (`sp1_choices`): the light items' order ("rows" or "l2", slice by
  slice) times the heavy segments (the threshold `heavy_threshold`
  picks, none, or a fixed count of nonzeros), 64-column light slices
  (`_vec_ok` 2), the heavy items' slice (16 or 32 columns; where
  `heavy_columns` picks 32 or 16), other segment costs
  (`SPMM_SEGMENT_COST`: the item cap); then libraries built with other
  ring bytes a lane (`kRingBytes`), in parallel.  Each warm (a CUDA
  graph) and with L2 flushed before each launch, its bits held to the
  first output at that shape (the parent's, with `--parent`), beside
  `torch.sparse.mm` warm and flushed.
- With `--parent DIR`, the same SVR and P1 calls of the parent tree's
  package (run in its directory) on the same inputs, timed alike, with
  whether P1's outputs keep the parent's bits; and SP1 at the same four
  shapes by the parent's own launch, warm and flushed, with its bits.

    python3 chip_sweep.py [--parent .scratch/parent] [--parts svr,platt,p2,sp1]

Prints one table a part and writes everything to
`chiprun_out/chip_sweep.json`; the card's name and power limit head the
output.  It exits non-zero without a card or if a variant disagrees with
its plain version.
"""

from __future__ import annotations

import argparse
import contextlib
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
#: P2's builds: (tag, the register plan's and the group plan's blocks an
#: SM, the group plan's spans (G, the largest k) or None for the build's
#: own), then the 99-sweep and exit builds
RB = "constexpr int kRegMinBlocks = 1; "
GB = "constexpr int kGroupMinBlocks = 0;"
COUPLING_VARIANTS = (("g8", 1, 0, ((8, 40),)), ("g16", 1, 0, ((16, 64),)),
                     ("g32", 1, 0, ((32, 64),)),
                     ("g32gb4", 1, 4, ((32, 64),)), ("rb1gb1", 1, 1, None),
                     ("rb1gb3", 1, 3, None), ("rb6gb4", 6, 4, None),
                     ("rb8gb5", 8, 5, None))
SWEEPS = "constexpr int kSweeps = 100;"
RENORM = "    for (int a = 0; a < K; ++a) p[a] = pt[a] * inv;\n"
EXIT = """    bool same = true;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float v = pt[a] * inv;
      same = same && same_bits(v, p[a]);
      p[a] = v;
    }
    if (same) break;
"""
COUPLING_KS = (10, 13, 20, 26, 33, 41, 50, 64)
#: SP1: heavy thresholds (nonzeros; None: `spmm_launch`'s pick, 10**9:
#: none heavy), segment costs, and ring bytes a lane of the other builds
SP1_HEAVY = (None, 10 ** 9, 256, 1024, 4096)
SP1_COSTS = (64, 512, 1024)
SP1_HEAVY_COLS = (16, 32)
RING = "constexpr int kRingBytes = 256;"
SP1_BUILDS = (("ring128", RING.replace("256", "128")),
              ("ring512", RING.replace("256", "512")))
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


# SP1 by the parent's package (run in its directory; argv: this tree's
# directory, the variants): its own launch at each shape, warm, flushed
# and its bits, on the inputs this tree's chip_smoke.py makes.
PARENT_SP1 = """
import hashlib, importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("cs", sys.argv[1] + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from spark_sklearn_tpu_torch.ops import spmm_kernels as spk
_, ops = cs.sparse_operands(0)
out = {}
for variant in sys.argv[2].split(","):
    which, over, W = cs.SPARSE_SHAPES[variant]
    op = ops[which]
    n, d = op.shape
    A, K = (((op.t_indptr, op.t_indices, op.t_values), n) if over
            else ((op.indptr, op.indices, op.values), d))
    D = cs.sp1_operand(K, W, variant)
    fn = lambda: spk.csr_spmm(*A, D, K)
    h = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
    out[variant] = {"ms": cs.graph_ms(fn, reps=10),
                    "flushed_ms": cs.flushed_ms(fn), "bits": h}
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


def build_variant(name: str, subs, tag: str, wait: bool = True):
    """csrc/<name>.cu with the text replacements `subs`, built as
    `_build` builds it into a temporary directory: (CDLL, nvcc's log), or
    with `wait` False (the running nvcc, the source, the library's path)."""
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
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path]
    if not wait:
        return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                path, out)
    proc = subprocess.run(cmd, capture_output=True, text=True)
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


def spans_source(spans) -> str:
    """The .cu lines of the group plan's spans ((G, the largest k), ...)."""
    return (f"constexpr int kGroupLanes[] = "
            f"{{{', '.join(str(G) for G, _ in spans)}}};\n"
            f"constexpr int kGroupLastK[] = "
            f"{{{', '.join(str(k) for _, k in spans)}}};")


def coupling_sweep(ks=COUPLING_KS, builds=True) -> list:
    """P2: every plan of this build at phase 13's k = 10 decisions
    ("k10p13") and at each of `ks`; then each library of
    `COUPLING_VARIANTS` (all built in parallel with the first part): the
    register plan to k = 12 and the group plan at every k it serves;
    then the 99-sweep build's bits against this build's (the share of
    problems at a fixed sweep by the 100th) and the exit build's
    register plan, timed, its bits held to this build's."""
    import torch

    from spark_sklearn_tpu_torch.ops import svm_proba_kernels as pk

    own = spans_source(pk.COUPLING_GROUP_SPANS)
    subs = {tag: ([(RB, RB.replace("1", str(rb))),
                   (GB, GB.replace("0", str(gb)))]
                  + ([(own, spans_source(spans))] if spans else []), spans)
            for tag, rb, gb, spans in COUPLING_VARIANTS}
    subs["s99"] = ([(SWEEPS, SWEEPS.replace("100", "99"))], None)
    subs["exit"] = ([(RENORM, EXIT)], None)
    if not builds:
        subs = {}
    procs = {tag: build_variant("svm_proba", sub, tag, wait=False)
             for tag, (sub, _) in subs.items()}
    rows = []
    inputs, bits = {}, {}

    def run(label, plan, tag="own"):
        k, dec, platt, pairs, want = inputs[label]
        pl = pk.coupling_plan(k, plan, dec.shape[0] * dec.shape[1])
        got = pk.pair_coupling(dec, platt, pairs, k, plan=plan)
        torch.cuda.synchronize()
        # held to the plain version on the first tasks (the plain R and Q
        # of all 450000 problems at k = 64 take ~15 GB)
        torch.testing.assert_close(got[:len(want)], want, rtol=0, atol=1e-4,
                                   equal_nan=True)
        ms = cs.cuda_ms(lambda: pk.pair_coupling(dec, platt, pairs, k,
                                                 plan=plan),
                        reps=5, warmup=1)
        row = {"inputs": label, "k": k, "plan": pl["plan"],
               "group": pl["group"], "slots": pl["slots"], "build": tag,
               "ms": ms, "bits": digest([got])}
        rows.append(row)
        print(f"  p2 {label:6s} {tag:6s} {row['plan']:9s} G={row['group']:2d}"
              f" M={row['slots']:2d}: {ms:.4f} ms", flush=True)
        return got

    dec, y, tw, pairs = cs.proba_inputs(0)
    A, B = pk.platt_fit(dec, y, tw, pairs, False)
    platt = torch.stack([A, B], dim=1).reshape(dec.shape[0], -1, 2)
    del y, tw, A, B
    labels = ["k10p13"] + [f"k{k}" for k in ks]
    for label in labels:
        if label != "k10p13":
            k = int(label[1:])
            dec, platt, pairs = cs.coupling_inputs(0, k)
        else:
            k = cs.K_SVM
        inputs[label] = (k, dec, platt.contiguous(), pairs,
                         pk.pair_coupling_plain(dec[:4], platt[:4], pairs,
                                                k))
        for plan in pk.COUPLING_PLANS:
            try:
                pk.coupling_plan(k, plan)
            except ValueError:
                continue
            got = run(label, plan)
            if plan == pk.coupling_plan(k)["plan"]:
                bits[label] = got
    spans = pk.COUPLING_GROUP_SPANS
    for tag, (proc, path, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        regs = {f.split("pair_coupling_")[1][:16]: v
                for f, v in cs.ptxas_table(log).items()
                if "pair_coupling_reg" in f or "pair_coupling_group" in f}
        print(f"  p2 {tag} registers, spilled bytes: {regs}", flush=True)
        _use(pk, ctypes.CDLL(lib))
        pk.COUPLING_GROUP_SPANS = subs[tag][1] or spans
        try:
            if tag == "s99":
                for label in labels:
                    k, dec, platt, pairs, _ = inputs[label]
                    got = pk.pair_coupling(dec, platt, pairs, k)
                    same = (got.view(torch.int32)
                            == bits[label].view(torch.int32)).all(dim=-1)
                    rows.append({"inputs": label, "k": k, "build": tag,
                                 "fixed_share": float(same.float().mean())})
                    print(f"  p2 {label:6s} {tag}: "
                          f"{rows[-1]['fixed_share']:.5f} of the problems "
                          "reach a sweep that gives back its own p",
                          flush=True)
                continue
            for label in labels:
                k = inputs[label][0]
                if k <= pk.COUPLING_REG_MAX_K:
                    got = run(label, "registers", tag)
                    if tag == "exit" and not torch.equal(
                            got.view(torch.int32),
                            bits[label].view(torch.int32)):
                        raise SystemExit(f"chip_sweep: P2's exit changes "
                                         f"the bits at {label}")
                elif pk.coupling_group(k) and tag != "exit":
                    run(label, "group", tag)
        finally:
            pk.COUPLING_GROUP_SPANS = spans
        rows.append({"build": tag, "registers": regs})
    _use(pk, None)
    return rows


def sp1_trace(variant, A, plan, K, D) -> dict:
    """SP1's items timed on the card's global timer at its own launch:
    the launch's span, the heavy and light items' durations, and the
    items that finish last."""
    import numpy as np
    import torch

    from spark_sklearn_tpu_torch.ops import spmm_kernels as spk

    launch = spk.launch_for(plan, D, None)
    trace = torch.zeros((launch["units"], 4), dtype=torch.int64,
                        device="cuda")
    spk.csr_spmm(*A, D, K, plan=plan, trace=trace)
    spk.csr_spmm(*A, D, K, plan=plan, trace=trace)
    t = trace.cpu().numpy()
    units = spk.spmm_units(plan, launch)
    ptr = A[0].cpu().numpy().astype(np.int64)
    nnz = ptr[units[:, 1]] - ptr[units[:, 0]]
    t0 = t[:, 2] - t[:, 2].min()
    dur = (t[:, 3] - t[:, 2]) / 1e3
    end = (t[:, 3] - t[:, 2].min()) / 1e3
    heavy = np.arange(len(units)) < launch["n_heavy"] * -(
        -launch["W"] // launch["heavy_slice"])
    last = np.argsort(end)[-5:][::-1]
    row = {"shape": variant, "build": "trace", "span_us": float(end.max()),
           "sms": int(len(np.unique(t[:, 1]))),
           "heavy_items": int(heavy.sum()),
           "heavy_us_mean": float(dur[heavy].mean()) if heavy.any() else 0,
           "heavy_us_max": float(dur[heavy].max()) if heavy.any() else 0,
           "light_us_mean": float(dur[~heavy].mean()),
           "light_us_max": float(dur[~heavy].max()),
           "light_us_p99": float(np.percentile(dur[~heavy], 99)),
           "ns_a_nonzero_light": float((dur[~heavy] * 1e3).sum()
                                       / max(1, nnz[~heavy].sum())),
           "last": [{"item": int(i), "heavy": bool(heavy[i]),
                     "nnz": int(nnz[i]), "start_us": float(t0[i] / 1e3),
                     "us": float(dur[i])} for i in last]}
    print(f"  sp1 {variant:13s} trace: span {row['span_us']:.1f} us on "
          f"{row['sms']} SMs; heavy {row['heavy_items']} items "
          f"{row['heavy_us_mean']:.1f} us mean, {row['heavy_us_max']:.1f} "
          f"max; light {row['light_us_mean']:.2f} us mean, p99 "
          f"{row['light_us_p99']:.1f}, max {row['light_us_max']:.1f}, "
          f"{row['ns_a_nonzero_light']:.1f} warp-ns a nonzero; last "
          + ", ".join(f"{'H' if r['heavy'] else 'L'}{r['nnz']}@"
                      f"{r['start_us']:.0f}+{r['us']:.0f}"
                      for r in row["last"]), flush=True)
    return row


@contextlib.contextmanager
def sp1_choices(order=None, heavy=None, vec=None, hcols=None, cost=None):
    """`spmm_kernels` with the given choices in place of its own picks
    (None: its own): the light items' order, the heavy threshold, the
    widest VEC, the heavy items' slice and the segment cost (plans built
    inside the block)."""
    from spark_sklearn_tpu_torch.ops import spmm_kernels as spk

    saved = {k: getattr(spk, k) for k in (
        "spmm_launch", "heavy_threshold", "_vec_ok", "heavy_columns",
        "SPMM_SEGMENT_COST")}
    launch = saved["spmm_launch"]

    def ordered(*args, **kw):
        out = launch(*args, **kw)
        out["order"] = order or out["order"]
        return out

    spk.spmm_launch = ordered
    if heavy is not None:
        spk.heavy_threshold = lambda nnz, W: heavy
    if vec is not None:
        spk._vec_ok = lambda W, *tensors: min(vec, saved["_vec_ok"](
            W, *tensors))
    if hcols is not None:
        spk.heavy_columns = lambda plan, W: hcols
    if cost is not None:
        spk.SPMM_SEGMENT_COST = cost
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(spk, k, v)


def sp1_sweep(builds=True, parent=None) -> list:
    """SP1's launch choices, segment costs and ring builds at phase 16's
    four shapes (module docstring); with `parent`, the parent's own
    launch first.  Raises where a choice changes the bits."""
    import torch

    from spark_sklearn_tpu_torch.ops import spmm_kernels as spk

    rows = []
    procs = {}
    if builds:
        procs = {tag: build_variant("csr_spmm", [(RING, text)], tag,
                                    wait=False)
                 for tag, text in SP1_BUILDS}
    if parent:
        proc = subprocess.run([sys.executable, "-c", PARENT_SP1,
                               os.path.abspath("."),
                               ",".join(cs.SPARSE_MAIN)], cwd=parent,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit("chip_sweep: the parent's SP1 failed")
        for variant, r in json.loads(
                proc.stdout.strip().splitlines()[-1]).items():
            rows.append({"shape": variant, "build": "parent", **r})
    _, ops = cs.sparse_operands(0)
    cases = {}
    for variant in cs.SPARSE_MAIN:
        A, plan, K, W = cs.sparse_case(ops, variant)
        cases[variant] = (A, plan, K, cs.sp1_operand(K, W, variant))
    bits = {r["shape"]: r["bits"] for r in rows}

    def run(variant, build, **choices):
        A, plan, K, D = cases[variant]
        with sp1_choices(**choices):
            if choices.get("cost"):
                plan = spk.SpmmPlan(A[0])
            fn = lambda: spk.csr_spmm(*A, D, K, plan=plan)
            h = digest([fn()])
            if bits.setdefault(variant, h) != h:
                raise SystemExit(f"chip_sweep: SP1 {variant} {build} "
                                 f"{choices} changed the bits")
            launch = spk.launch_for(plan, D, None)
            row = {"shape": variant, "build": build,
                   "order": launch["order"], "vec": launch["vec_light"],
                   "heavy_cols": launch["heavy_cols"],
                   "heavy_nnz": launch["heavy_nnz"],
                   "n_heavy": launch["n_heavy"], "units": launch["units"],
                   "cost": spk.SPMM_SEGMENT_COST,
                   "ms": cs.graph_ms(fn, reps=10),
                   "flushed_ms": cs.flushed_ms(fn), "bits": h}
        rows.append(row)
        print(f"  sp1 {variant:13s} {build:8s} {row['order']:4s} vec "
              f"{row['vec']} hc {row['heavy_cols']:2d} heavy>"
              f"{row['heavy_nnz']:<10d} ({row['n_heavy']:4d}) cost "
              f"{row['cost']:5d} items {row['units']:7d}: {row['ms']:.4f} ms"
              f" warm, {row['flushed_ms']:.4f} ms flushed", flush=True)

    for variant in cs.SPARSE_MAIN:
        A, plan, K, D = cases[variant]
        rows.append(sp1_trace(variant, A, plan, K, D))
    for variant in cs.SPARSE_MAIN:
        A, _, K, D = cases[variant]
        m = A[0].numel() - 1
        Asp = torch.sparse_csr_tensor(A[0], A[1], A[2], size=(m, K))
        lib = lambda: torch.sparse.mm(Asp, D)
        rows.append({"shape": variant, "build": "torch.sparse.mm",
                     "ms": cs.graph_ms(lib, reps=10),
                     "flushed_ms": cs.flushed_ms(lib)})
        print(f"  sp1 {variant:13s} torch.sparse.mm: {rows[-1]['ms']:.4f} "
              f"ms warm, {rows[-1]['flushed_ms']:.4f} ms flushed",
              flush=True)
        del Asp
        for order in ("rows", "l2"):
            for heavy in SP1_HEAVY:
                run(variant, "ring256", order=order, heavy=heavy)
        run(variant, "ring256", order="l2", vec=2)
        for hcols in SP1_HEAVY_COLS:
            run(variant, "ring256", hcols=hcols)
        for cost in SP1_COSTS:
            run(variant, "ring256", cost=cost)
    for tag, (proc, _, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        _use(spk, ctypes.CDLL(path))
        for variant in cs.SPARSE_MAIN:
            for order in ("rows", "l2"):
                run(variant, tag, order=order)
    _use(spk, None)
    best = {}
    for r in rows:
        if r["build"] not in ("parent", "torch.sparse.mm", "trace"):
            if r["shape"] not in best or r["ms"] < best[r["shape"]]["ms"]:
                best[r["shape"]] = r
    for variant, r in best.items():
        print(f"  fastest sp1 {variant}: {r['build']} {r['order']} heavy>"
              f"{r['heavy_nnz']} cost {r['cost']}: {r['ms']:.4f} ms warm, "
              f"{r['flushed_ms']:.4f} flushed")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory of the parent's tree")
    ap.add_argument("--parts", default="svr,platt,p2,sp1",
                    help="comma-separated parts to sweep")
    ap.add_argument("--p2-ks", default=",".join(map(str, COUPLING_KS)),
                    help="P2's class counts, comma-separated")
    ap.add_argument("--p2-no-builds", action="store_true",
                    help="P2 with this tree's build only")
    ap.add_argument("--sp1-no-builds", action="store_true",
                    help="SP1 with this tree's build only")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    from spark_sklearn_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    report = _build.build(sorted({name for part, name in (
        ("svr", "svm_dual"), ("platt", "svm_proba"), ("p2", "svm_proba"),
        ("sp1", "csr_spmm")) if part in parts}))
    table = {}
    for r in report.values():
        table.update(cs.ptxas_table(str(r["log"])))
    mine = ("svr", "platt", "pair_coupling", "csr_spmm")
    for fn, (regs, spill) in sorted(table.items()):
        if any(m in fn for m in mine):
            print(f"  {regs:4d} registers {spill:5d} bytes spilled  {fn}")
    out = {"card": card, "ptxas": {f: v for f, v in table.items()
                                   if any(m in f for m in mine)}}
    if args.parent and "svr" in parts:
        proc = subprocess.run([sys.executable, "-c", PARENT,
                               os.path.abspath(".")], cwd=args.parent,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit("chip_sweep: the parent's calls failed")
        out["parent"] = json.loads(proc.stdout.strip().splitlines()[-1])
        print("  parent:", json.dumps(out["parent"]), flush=True)
    out["svr"] = svr_sweep() if "svr" in parts else []
    out["platt"] = platt_sweep() if "platt" in parts else []
    out["p2"] = (coupling_sweep(tuple(int(k) for k in
                                      args.p2_ks.split(",")),
                                not args.p2_no_builds)
                 if "p2" in parts else [])
    out["sp1"] = (sp1_sweep(not args.sp1_no_builds, args.parent)
                  if "sp1" in parts else [])
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
