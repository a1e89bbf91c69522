"""Scorers of the compiled search path, as plain torch.

Counterpart of `spark_sklearn_tpu/search/scorers.py` (:39-262, :321):
the reference's 17 scorer names.  Each metric is a **view requirement**
(the model outputs it reads: "pred", "decision" or "proba") plus a
**core**, a reduction over a leading task axis:

    core(views, y, w, meta) -> (T,)

with views (T, n[, k]), y (n,) encoded labels (classifiers) or targets
(regressors; None for an unsupervised search, whose only scorer is its
family's default, `FAMILY_DEFAULTS`) and w (T, n) the fold weight of
each task (1.0 on the fold's
samples, 0.0 elsewhere).  The search computes the views once per chunk
for every task, from one GEMM.  Each core is the reference's per-task
core with the task axis made explicit, and keeps its semantics, among
them three the reference documents:

- `neg_median_absolute_error` is a weighted median that averages the two
  middle errors where the cumulative weight hits exactly half;
- `neg_mean_squared_log_error` is NaN where sklearn raises (a negative
  target or prediction in the fold);
- `roc_auc` ranks by cumulative weight, so ties are handled only
  approximately (exact on continuous margins).

`SearchScorer` applies one of them to a fitted estimator (a search's
`scorer_`).  Scorer objects and callables need sklearn to resolve and
are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_sklearn_tpu_torch.search.cv import _num_samples

EPS = 1e-12


class Scorer(NamedTuple):
    views: Tuple[str, ...]
    core: Callable


def _wsum(w):
    return w.sum(dim=1) + EPS


def _wmean(w, v):
    return (w * v).sum(dim=1) / _wsum(w)


def _accuracy(v, y, w, meta):
    return _wmean(w, v["pred"] == y.long()[None, :])


def _neg_log_loss(v, y, w, meta):
    # sklearn's log_loss clips at the oracle proba dtype's eps, which the
    # search resolves per family into meta["logloss_clip_eps"]
    eps = meta.get("logloss_clip_eps") or float(np.finfo(np.float64).eps)
    proba = v["proba"]                                      # (T, n, k)
    idx = y.long()[None, :, None].expand(proba.shape[0], -1, 1)
    p = torch.clamp(torch.gather(proba, 2, idx)[..., 0], eps, 1.0 - eps)
    return -_wmean(w, -torch.log(p))


def _class_counts(pred, y, w, c):
    """Weighted (tp, fp, fn) of class `c`, each (T,)."""
    is_p, is_y = pred == c, (y.long() == c)[None, :]
    return ((w * (is_p & is_y)).sum(dim=1), (w * (is_p & ~is_y)).sum(dim=1),
            (w * (~is_p & is_y)).sum(dim=1))


def _f1_of(tp, fp, fn):
    return 2 * tp / torch.clamp_min(2 * tp + fp + fn, EPS)


def _f1(v, y, w, meta):
    return _f1_of(*_class_counts(v["pred"], y, w, 1))


def _precision(v, y, w, meta):
    tp, fp, _ = _class_counts(v["pred"], y, w, 1)
    return tp / torch.clamp_min(tp + fp, EPS)


def _recall(v, y, w, meta):
    tp, _, fn = _class_counts(v["pred"], y, w, 1)
    return tp / torch.clamp_min(tp + fn, EPS)


def _f1_macro(v, y, w, meta):
    k = meta["n_classes"]
    return torch.stack([_f1_of(*_class_counts(v["pred"], y, w, c))
                        for c in range(k)]).mean(dim=0)


def _balanced_accuracy(v, y, w, meta):
    """Mean recall over the classes present in the fold (sklearn: classes
    absent from y_true drop out of the mean)."""
    recalls, present = [], []
    for c in range(meta["n_classes"]):
        tp, _, fn = _class_counts(v["pred"], y, w, c)
        support = tp + fn
        recalls.append(tp / torch.clamp_min(support, EPS))
        present.append((support > 0).to(w.dtype))
    recalls, present = torch.stack(recalls), torch.stack(present)
    return (recalls * present).sum(dim=0) / torch.clamp_min(
        present.sum(dim=0), 1.0)


def _roc_auc(v, y, w, meta):
    """Weighted binary AUC by the rank (Mann-Whitney) statistic; a
    sample's rank is the cumulative weight below it, so tied scores get
    the ranks of their sorted order, not their average."""
    s = v["decision"]                                       # (T, n)
    order = torch.argsort(s, dim=1, stable=True)
    y_s = y.to(s.dtype)[order]
    w_s = torch.gather(w, 1, order)
    cw = torch.cumsum(w_s, dim=1) - 0.5 * w_s
    pos = (w_s * y_s).sum(dim=1)
    neg = (w_s * (1.0 - y_s)).sum(dim=1)
    rank_pos = (w_s * y_s * cw).sum(dim=1)
    return (rank_pos - 0.5 * pos * pos) / torch.clamp_min(pos * neg, EPS)


def _r2(v, y, w, meta):
    ybar = _wmean(w, y[None, :])
    ss_res = (w * (y[None, :] - v["pred"]) ** 2).sum(dim=1)
    ss_tot = (w * (y[None, :] - ybar[:, None]) ** 2).sum(dim=1)
    return 1.0 - ss_res / torch.clamp_min(ss_tot, EPS)


def _explained_variance(v, y, w, meta):
    err = y[None, :] - v["pred"]
    ebar = _wmean(w, err)
    var_err = _wmean(w, (err - ebar[:, None]) ** 2)
    ybar = _wmean(w, y[None, :])
    var_y = _wmean(w, (y[None, :] - ybar[:, None]) ** 2)
    return 1.0 - var_err / torch.clamp_min(var_y, EPS)


def _neg_mse(v, y, w, meta):
    return -_wmean(w, (y[None, :] - v["pred"]) ** 2)


def _neg_rmse(v, y, w, meta):
    return -torch.sqrt(-_neg_mse(v, y, w, meta))


def _neg_mae(v, y, w, meta):
    return -_wmean(w, (y[None, :] - v["pred"]).abs())


def _neg_msle(v, y, w, meta):
    # sklearn raises on a negative target or prediction; a reduction
    # cannot, so the fold's score is NaN and surfaces through the search's
    # non-finite-score warning instead of scoring a clamp
    pred = v["pred"]
    invalid = (w * ((y[None, :] < 0) | (pred < 0))).sum(dim=1) > 0
    ly = torch.log1p(torch.clamp_min(y, 0.0))[None, :]
    lp = torch.log1p(torch.clamp_min(pred, 0.0))
    val = -_wmean(w, (ly - lp) ** 2)
    return torch.where(invalid, torch.nan, val)


def _neg_median_ae(v, y, w, meta):
    # weighted median over |err| sorted with the fold weights; where the
    # cumulative weight hits exactly half (even-sized unweighted folds),
    # average the two middle errors as np.median does
    err = (y[None, :] - v["pred"]).abs()
    e_s, order = torch.sort(err, dim=1, stable=True)
    w_s = torch.gather(w, 1, order)
    cw = torch.cumsum(w_s, dim=1)
    half = (0.5 * w_s.sum(dim=1))[:, None]
    n = err.shape[1]
    idx_lo = torch.searchsorted(cw, half).clamp(0, n - 1)
    idx_hi = torch.searchsorted(cw, half, right=True).clamp(0, n - 1)
    lo = torch.gather(e_s, 1, idx_lo)[:, 0]
    hi = torch.gather(e_s, 1, idx_hi)[:, 0]
    at_half = torch.gather(cw, 1, idx_lo)[:, 0] == half[:, 0]
    return -torch.where(at_half, 0.5 * (lo + hi), lo)


def _max_error(v, y, w, meta):
    return -(w * (y[None, :] - v["pred"]).abs()).amax(dim=1)


def _neg_inertia(v, y, w, meta):
    """KMeans' default scorer, sklearn's `KMeans.score`: -Σ w·min d² of
    each lane's rows to its centers (`cluster.py:38-41`); y unused."""
    return -(w * v["min_d2"]).sum(dim=1)


SCORERS: Dict[str, Scorer] = {
    "accuracy": Scorer(("pred",), _accuracy),
    "balanced_accuracy": Scorer(("pred",), _balanced_accuracy),
    "explained_variance": Scorer(("pred",), _explained_variance),
    "neg_mean_squared_log_error": Scorer(("pred",), _neg_msle),
    "neg_log_loss": Scorer(("proba",), _neg_log_loss),
    "f1": Scorer(("pred",), _f1),
    "f1_macro": Scorer(("pred",), _f1_macro),
    "precision": Scorer(("pred",), _precision),
    "recall": Scorer(("pred",), _recall),
    "roc_auc": Scorer(("decision",), _roc_auc),
    "r2": Scorer(("pred",), _r2),
    "neg_mean_squared_error": Scorer(("pred",), _neg_mse),
    "neg_root_mean_squared_error": Scorer(("pred",), _neg_rmse),
    "neg_mean_absolute_error": Scorer(("pred",), _neg_mae),
    "neg_median_absolute_error": Scorer(("pred",), _neg_median_ae),
    "max_error": Scorer(("pred",), _max_error),        # legacy sklearn name
    "neg_max_error": Scorer(("pred",), _max_error),    # sklearn >= 1.6 name
}

#: a family's own default scorer, named by its `default_scorer`
#: attribute and used where scoring is None (the reference's
#: `family.default_scorer`, scorers.py:321)
FAMILY_DEFAULTS: Dict[str, Scorer] = {
    "neg_inertia": Scorer(("min_d2",), _neg_inertia),
}

#: scorers whose sklearn twin takes no sample_weight: a weighted search
#: scores them unweighted (the reference's `SAMPLE_WEIGHT_BLIND_FNS`)
SAMPLE_WEIGHT_BLIND = frozenset({"max_error", "neg_max_error"})

#: scorers that need class structure (meta["n_classes"])
CLASSIFICATION_SCORERS = frozenset({
    "accuracy", "balanced_accuracy", "neg_log_loss", "f1", "f1_macro",
    "precision", "recall", "roc_auc"})
#: scorers whose compiled form is binary only (the reference leaves their
#: multiclass averaging to its host path)
BINARY_ONLY_SCORERS = frozenset({"f1", "precision", "recall", "roc_auc"})


def _lookup(name):
    if not isinstance(name, str) or name not in SCORERS:
        raise NotImplementedError(
            f"scoring={name!r} is not implemented in the PyTorch port; "
            f"available: {sorted(SCORERS)} (scorer objects and callables "
            "need sklearn)")
    return SCORERS[name]


def resolve_scoring(scoring, family) -> Tuple[Dict[str, Scorer],
                                              Optional[str]]:
    """scoring arg -> (ordered {name: Scorer}, single-metric key or None).
    None uses the estimator's default (the family's `default_scorer`
    where it names one of `FAMILY_DEFAULTS`, else accuracy for
    classifiers and r2 for regressors); a string or a list of strings
    names metrics.  Anything else raises NotImplementedError."""
    if scoring is None:
        own = getattr(family, "default_scorer", None)
        if own is not None:
            return {"score": FAMILY_DEFAULTS[own]}, "score"
        name = "accuracy" if family.is_classifier else "r2"
        return {"score": SCORERS[name]}, "score"
    if isinstance(scoring, str):
        return {"score": _lookup(scoring)}, "score"
    if isinstance(scoring, (list, tuple)):
        out = {}
        for s in scoring:
            scorer = _lookup(s)
            if s in out:
                raise ValueError(f"duplicate scoring entry {s!r}")
            out[s] = scorer
        return out, None
    raise NotImplementedError(
        f"scoring={scoring!r} is not implemented in the PyTorch port; "
        f"pass None, one of {sorted(SCORERS)} or a list of them")


def check_scoring_target(scoring, family, meta) -> None:
    """The reference's pre-sweep checks (`grid.py` `_fit_compiled_impl`):
    class-based scorers need a classifier, and the binary-only ones a
    binary target."""
    if scoring is None:
        return
    wanted = [scoring] if isinstance(scoring, str) else list(scoring)
    if any(s in CLASSIFICATION_SCORERS for s in wanted) and \
            "n_classes" not in meta:
        raise ValueError(
            f"scoring={scoring!r} requires a classifier family; "
            f"{family.name} has no class structure")
    if any(s in BINARY_ONLY_SCORERS for s in wanted) and \
            meta.get("n_classes", 2) > 2:
        raise ValueError(
            f"scoring={scoring!r} on multiclass targets is not compiled")


class SearchScorer:
    """The metric `name` (one of `SCORERS`, or "score": the estimator's
    own `score` where it has one, else `default`) on a fitted
    estimator, as sklearn's scorer objects are called:
    ``scorer(estimator, X, y, sample_weight=None) -> float``.  The views
    come from the estimator's `predict`, `predict_proba` and
    `decision_function`; classes by the estimator's `classes_`; log loss
    clipped at `clip_eps`.  A search keeps one as `scorer_` (a dict of
    them for a list of metrics)."""

    def __init__(self, name: str, default: str, clip_eps: float = None):
        self.name = name
        self.default = default
        self.clip_eps = clip_eps

    def __repr__(self):
        return f"SearchScorer({self.name!r})"

    def __call__(self, estimator, X, y=None, sample_weight=None) -> float:
        kw = {} if sample_weight is None else {"sample_weight":
                                               sample_weight}
        if self.name == "score" and hasattr(estimator, "score"):
            return estimator.score(X, y, **kw)
        scorer = SCORERS[self.default if self.name == "score" else self.name]
        n = _num_samples(X)           # X may be scipy-sparse
        w = torch.as_tensor(np.ones(n) if sample_weight is None else
                            np.asarray(sample_weight, np.float64),
                            dtype=torch.float64)[None, :]
        classes = getattr(estimator, "classes_", None)
        meta = {"logloss_clip_eps": self.clip_eps}
        views = {}
        if classes is not None:
            classes = np.asarray(classes)
            meta["n_classes"] = len(classes)

            def encode(v):
                idx = np.searchsorted(classes, v).clip(0, len(classes) - 1)
                return np.where(classes[idx] == v, idx, -1)

            yt = torch.as_tensor(encode(np.asarray(y)))
            if "pred" in scorer.views:
                views["pred"] = torch.as_tensor(
                    encode(estimator.predict(X)))[None]
            if "proba" in scorer.views:
                if bool((yt < 0).any()):
                    raise ValueError("y contains labels not in classes_")
                views["proba"] = torch.as_tensor(np.asarray(
                    estimator.predict_proba(X), np.float64))[None]
            if "decision" in scorer.views:
                dec = (estimator.decision_function(X)
                       if hasattr(estimator, "decision_function")
                       else estimator.predict_proba(X)[:, 1])
                views["decision"] = torch.as_tensor(
                    np.asarray(dec, np.float64))[None]
        else:
            yt = None if y is None else torch.as_tensor(
                np.asarray(y, np.float64))
            views["pred"] = torch.as_tensor(np.asarray(
                estimator.predict(X), np.float64))[None]
        return float(scorer.core(views, yt, w, meta)[0])
