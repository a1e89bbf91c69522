"""Scorers of the compiled search path, as plain torch.

Counterpart of `spark_sklearn_tpu/search/scorers.py` (:39-98, :321) for
`accuracy` and `neg_log_loss`.  Each metric is a **view requirement**
(the model outputs it reads: "pred" or "proba") plus a **core**, a
reduction over a leading task axis:

    core(views, y, w, meta) -> (T,)

with views (T, n[, k]), y (n,) encoded labels and w (T, n) the fold
weight of each task (1.0 on the fold's samples, 0.0 elsewhere).  The
search computes the views once per chunk for every task, from one GEMM.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

EPS = 1e-12


class Scorer(NamedTuple):
    views: Tuple[str, ...]
    core: Callable


def _wsum(w):
    return w.sum(dim=1) + EPS


def _accuracy(v, y, w, meta):
    return (w * (v["pred"] == y.long()[None, :])).sum(dim=1) / _wsum(w)


def _neg_log_loss(v, y, w, meta):
    # sklearn's log_loss clips at the oracle proba dtype's eps, which the
    # search resolves per family into meta["logloss_clip_eps"]
    eps = meta.get("logloss_clip_eps") or float(np.finfo(np.float64).eps)
    proba = v["proba"]                                      # (T, n, k)
    idx = y.long()[None, :, None].expand(proba.shape[0], -1, 1)
    p = torch.clamp(torch.gather(proba, 2, idx)[..., 0], eps, 1.0 - eps)
    return -((w * -torch.log(p)).sum(dim=1) / _wsum(w))


SCORERS: Dict[str, Scorer] = {
    "accuracy": Scorer(("pred",), _accuracy),
    "neg_log_loss": Scorer(("proba",), _neg_log_loss),
}


def resolve_scoring(scoring, family) -> Tuple[Dict[str, Scorer],
                                              Optional[str]]:
    """scoring arg -> (ordered {name: Scorer}, single-metric key or None).
    None uses the estimator default (accuracy for classifiers); a string
    or a list of strings names metrics.  Anything else raises
    NotImplementedError."""
    if scoring is None:
        if not family.is_classifier:
            raise NotImplementedError(
                "only classifier families are ported; their default "
                "scorer is accuracy")
        return {"score": SCORERS["accuracy"]}, "score"
    if isinstance(scoring, str):
        if scoring not in SCORERS:
            raise NotImplementedError(
                f"scoring={scoring!r} is not implemented in the PyTorch "
                f"port; available: {sorted(SCORERS)}")
        return {"score": SCORERS[scoring]}, "score"
    if isinstance(scoring, (list, tuple)):
        out = {}
        for s in scoring:
            if not isinstance(s, str) or s not in SCORERS:
                raise NotImplementedError(
                    f"scoring entry {s!r} is not implemented in the "
                    f"PyTorch port; available: {sorted(SCORERS)}")
            if s in out:
                raise ValueError(f"duplicate scoring entry {s!r}")
            out[s] = SCORERS[s]
        return out, None
    raise NotImplementedError(
        f"scoring={scoring!r} is not implemented in the PyTorch port; "
        f"pass None, one of {sorted(SCORERS)} or a list of them")
