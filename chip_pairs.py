"""Compare two trees' `chip_smoke.py` on one card: run A, B, B, A.

Each tree's `chip_smoke.py` runs from its own directory, in the order
parent, change, change, parent, so that drift of the card or of the
host over the call falls on both trees alike.  Each run's
`chiprun_out/chip_smoke.json` and its output are kept under
`chiprun_out/pairs/` of the working directory as `run<i>_<label>.json`
and `.log`; the script then prints each phase's warm search wall (s) of
the four runs, the parent's spread (its two runs' max - min) and the
change's mean minus the parent's, and marks a phase "outside" where
that difference is larger than the parent's spread.

    python3 chip_pairs.py --parent .scratch/parent --change .

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

OUT = os.path.join("chiprun_out", "pairs")


def warm_walls(d: dict) -> dict:
    """{phase: warm wall (s)} from one run's chip_smoke.json."""
    w = {"[4] headline": d["main"]["warm_s"]}
    for name, r in d["regressors"].items():
        w[f"[6] {name}"] = r.get("warm_s")
    w["[7] l1"] = d["l1"]["l1"]["warm_s"]
    w["[7] elasticnet"] = d["l1"]["elasticnet"]["warm_s"]
    w["[8] svc"] = d["svm"]["svc"]["warm_s"]
    w["[9] gb_regressor"] = d["gb"]["regressor"]["warm_s"]
    w["[9] gb_classifier"] = d["gb"]["classifier"]["warm_s"]
    w["[10] rf_classifier"] = d["rf"]["classifier"]["warm_s"]
    w["[10] rf_regressor"] = d["rf"]["regressor"]["warm_s"]
    if "mlp" in d:
        w["[11] baseline5"] = d["mlp"]["classifier"]["warm_s"]
    w["total (whole script)"] = d["main"]["wall_s"]
    return w


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
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    order = [("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent)]
    walls = {"parent": [], "change": []}
    for i, (label, tree) in enumerate(order, 1):
        walls[label].append(warm_walls(run(tree, label, i)))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
