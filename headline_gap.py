"""The headline search's scores on one device, to compare two devices.

`chip_smoke.py`'s headline (phase 4: LogisticRegression over 1000 C x
StratifiedKFold(5) on digits-shaped data from --seed) in three forms:
weighted with phase 14's weights at max_iter=100 ("w100"), unweighted at
max_iter=100 ("u100") and weighted at max_iter=300 ("w300").  Each
form's mean_test_score, best index, the chunks' most iterations run and
the wall go to chiprun_out/headline_gap_<device>_<form>.json.

    python3 headline_gap.py --device cuda
    python3 headline_gap.py --device cpu [--forms u100,w300] [--threads 4]
    python3 headline_gap.py --compare cuda cpu
    python3 headline_gap.py --compare cuda_w100 cuda_w300

--compare prints, for each form run on both devices (or for two runs
named <device>_<form>), the largest |A - B| of mean_test_score with the
two scores there, how many candidates differ by more than 5e-3 (phase
5's tolerance), the two best indices and best scores, and the largest
and mean |A - B| in each tenth of the grid.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs

FORMS = {"w100": (True, 100), "u100": (False, 100), "w300": (True, 300)}


def run_form(form: str, device: str, seed: int) -> dict:
    from spark_sklearn_tpu_torch import (
        GridSearchCV, LogisticRegression, StratifiedKFold, TorchConfig)

    weighted, max_iter = FORMS[form]
    X, y = cs.digits_like(seed)
    kw = {"sample_weight": cs.weights(seed, len(y))} if weighted else {}
    t0 = time.perf_counter()
    g = GridSearchCV(
        LogisticRegression(max_iter=max_iter),
        {"C": np.logspace(-4, 3, cs.N_C)}, cv=StratifiedKFold(cs.N_FOLDS),
        refit=False, config=TorchConfig(device=device)).fit(X, y, **kw)
    wall = time.perf_counter() - t0
    return {"mean_test_score": g.cv_results_["mean_test_score"].tolist(),
            "best_index": int(g.best_index_),
            "n_iter_exec_max": max(c["n_iter_exec"] for c in g.chunks_),
            "wall_s": wall}


def out_path(device: str, form: str) -> str:
    return os.path.join("chiprun_out", f"headline_gap_{device}_{form}.json")


def compare(a_run: str, b_run: str) -> None:
    """a_run, b_run: two devices (every form run on both) or two runs
    named <device>_<form>."""
    if "_" not in a_run:
        for form in FORMS:
            if all(os.path.exists(out_path(d, form)) for d in (a_run, b_run)):
                compare(f"{a_run}_{form}", f"{b_run}_{form}")
        return
    runs = []
    for run in (a_run, b_run):
        with open(out_path(*run.split("_"))) as f:
            runs.append(json.load(f))
    a, b = (np.asarray(r["mean_test_score"]) for r in runs)
    d = np.abs(a - b)
    i = int(d.argmax())
    Cs = np.logspace(-4, 3, len(d))
    print(f"{a_run} against {b_run}: max |A - B| {d.max():.6g} at C "
          f"{Cs[i]:.4g} ({a[i]:.4f} / {b[i]:.4f}), {int((d > 5e-3).sum())} "
          f"of {len(d)} above 5e-3, best index {runs[0]['best_index']} / "
          f"{runs[1]['best_index']} (score {a.max():.4f} / {b.max():.4f}), "
          f"most iterations {runs[0]['n_iter_exec_max']} / "
          f"{runs[1]['n_iter_exec_max']}")
    for part in np.array_split(np.arange(len(d)), 10):
        print(f"  C {Cs[part[0]]:.3g}-{Cs[part[-1]]:.3g}: max "
              f"{d[part].max():.4f}, mean {d[part].mean():.5f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's CPU threads (0: its default)")
    ap.add_argument("--compare", nargs=2, metavar="RUN")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("headline_gap: no CUDA device is available", file=sys.stderr)
        return 2
    if args.threads:
        torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("chiprun_out", exist_ok=True)
    for form in args.forms.split(","):
        out = run_form(form, args.device, args.seed)
        print(f"{form} on {args.device}: best index {out['best_index']}, "
              f"most iterations {out['n_iter_exec_max']}, "
              f"{out['wall_s']:.1f} s", flush=True)
        with open(out_path(args.device, form), "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
