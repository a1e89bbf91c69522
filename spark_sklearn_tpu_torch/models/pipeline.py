"""Pipelines of preprocessing steps and a ported final estimator.

Counterpart of `spark_sklearn_tpu/models/pipeline.py`: `PipelineFamily`
(:24-240), `BinnedInvariantPipelineFamily` (:243-304) and
`make_pipeline_family` (:307-342).  Grid keys such as ``mlp__alpha``
reach the final family as its dynamic parameters, and static
``step__param`` keys reach their step, as `_split_static` routes them.

The reference fuses the transform into each lane's fit.  Here the
transformer chain is fitted once per **fold** (the chunk's first F
lanes: tasks are candidate-major, so every candidate repeats the same F
fold masks), as the reference's `prefix_transform` and
`_fit_task_batched_folds` (:125-142, :175-210) do; the reference's
`tests/test_prefix.py` pins that split as bit-exact with the fused
transform.  The final family then gets ``data["X_folds"]`` (F, n, d'):

- a final that takes per-fold inputs itself (`accepts_fold_inputs`: the
  MLPs, SVC and NuSVC) fits all its lanes in one batched call, lane t
  reading fold t % F;
- any other final is fitted and scored fold by fold, on the lanes of
  that fold, with the fold's X as its data, and the lanes are put back
  in order.

The transformed X of the last fit is kept for the views of the same
chunk and reused by the next chunk of the same step settings and fold
masks.  A cache shared across compile groups (the reference's
`search/prefix.py`) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from spark_sklearn_tpu_torch.models import preprocessing as prep
from spark_sklearn_tpu_torch.models.base import resolve_family


def _step_params(estimator) -> Dict[str, Any]:
    out = {}
    for sname, step_est in estimator.named_steps.items():
        if step_est is None or isinstance(step_est, str):
            continue
        for k, v in step_est.get_params(deep=False).items():
            out[f"{sname}__{k}"] = v
    return out


class PipelineFamily:
    """An instance-level family (duck-typed to the Family protocol) built
    for one concrete Pipeline."""

    #: sklearn's Pipeline.fit refuses a bare sample_weight (its steps take
    #: "step__sample_weight"): a weighted search raises, as the reference
    #: leaves its compiled path there (models/pipeline.py:31)
    accepts_sample_weight = False

    def __init__(self, steps: List[Tuple[str, Any]], final_name: str,
                 final_family):
        self.steps = steps          # [(name, step), ...] the transformers
        self.final_name = final_name
        self.final = final_family
        self.name = (f"pipeline({'+'.join(n for n, _ in steps)}"
                     f"+{final_family.name})")
        self.is_classifier = final_family.is_classifier
        # the proba dtype is the final step's fact (the transformers only
        # feed it X): log_loss clips where the final's would
        self.proba_dtype_rule = getattr(final_family, "proba_dtype_rule",
                                        "float64")
        self.dynamic_params = {
            f"{final_name}__{k}": v
            for k, v in final_family.dynamic_params.items()}
        hint = getattr(final_family, "max_tasks_hint", None)
        if hint is not None:
            self.max_tasks_hint = hint
        self._cache = None      # (step settings, fold masks, X_folds)

    # -- host side ---------------------------------------------------------

    def extract_params(self, estimator) -> Dict[str, Any]:
        return _step_params(estimator)

    def prepare_data(self, X, y, dtype=np.float32):
        return self.final.prepare_data(X, y, dtype=dtype)

    def observe_candidates(self, candidates, base_params, meta):
        """The final's host-side check (SVC's probability warning), on its
        own parameters."""
        if hasattr(self.final, "observe_candidates"):
            self.final.observe_candidates(
                [self._final_static(c) for c in candidates],
                self._final_static(base_params), meta)

    def host_reason(self, static):
        """The final's tier predicate on its own parameters."""
        reason = getattr(self.final, "host_reason", None)
        return None if reason is None else reason(self._final_static(static))

    def _split_static(self, static):
        per_step: Dict[str, Dict[str, Any]] = {n: {} for n, _ in self.steps}
        per_step[self.final_name] = {}
        for key, v in static.items():
            if key.startswith("__") or "__" not in key:
                continue
            sname, pname = key.split("__", 1)
            if sname in per_step:
                per_step[sname][pname] = v
        return per_step

    def _final_static(self, static):
        out = self._split_static(static)[self.final_name]
        out.update({k: v for k, v in static.items()
                    if k.startswith("__")})
        return out

    def _final_dynamic(self, dynamic):
        pref = f"{self.final_name}__"
        return {k[len(pref):]: v for k, v in dynamic.items()
                if k.startswith(pref)}

    # -- the transformer chain ---------------------------------------------

    def _settings(self, static):
        per_step = self._split_static(static)
        return repr([(n, sorted(per_step[n].items()))
                     for n, _ in self.steps])

    def prefix_transform(self, static, data, fold_w):
        """Fold masks (F, n) -> the per-fold transformed design matrix
        (F, n, d'), each step's statistics weighted by its fold's mask."""
        per_step = self._split_static(static)
        X = data["X"]
        for sname, step in self.steps:
            state = step.fit(per_step[sname], X, fold_w)
            X = step.apply(per_step[sname], state, X)
        if X.dim() == 2:                    # no transformer: share X
            X = X.unsqueeze(0).expand(fold_w.shape[0], -1, -1)
        return X

    def _folds_of(self, static, data, fold_w):
        key = self._settings(static)
        c = self._cache
        if c is not None and c[0] == key and c[1].shape == fold_w.shape \
                and torch.equal(c[1], fold_w):
            return c[2]
        X_folds = self.prefix_transform(static, data, fold_w)
        self._cache = (key, fold_w.clone(), X_folds)
        return X_folds

    # -- device side -------------------------------------------------------

    def fit_task_batched(self, dynamic, static, data, train_w, meta):
        n_folds = int(static.get("__n_folds__", 0))
        if n_folds <= 0:
            raise ValueError("the search must pass __n_folds__")
        X_folds = self._folds_of(static, data, train_w[:n_folds])
        fdyn = self._final_dynamic(dynamic)
        fstatic = self._final_static(static)
        if getattr(self.final, "accepts_fold_inputs", False):
            return self.final.fit_task_batched(
                fdyn, fstatic, {**data, "X_folds": X_folds}, train_w, meta)
        B = train_w.shape[0]
        parts = []
        for f in range(n_folds):
            lanes = torch.arange(f, B, n_folds, device=train_w.device)
            parts.append((lanes, self.final.fit_task_batched(
                {k: v[lanes] for k, v in fdyn.items()},
                {**fstatic, "__n_folds__": 1}, {**data, "X": X_folds[f]},
                train_w[lanes], meta)))
        return _interleave(parts, B)

    def views_task_batched(self, models, static, data, meta, needed):
        if self._cache is None or self._cache[0] != self._settings(static):
            raise RuntimeError("views of a pipeline chunk come after its fit")
        X_folds = self._cache[2]
        fstatic = self._final_static(static)
        if getattr(self.final, "accepts_fold_inputs", False):
            return self.final.views_task_batched(
                models, fstatic, {**data, "X_folds": X_folds}, meta, needed)
        n_folds = X_folds.shape[0]
        B = next(iter(models.values())).shape[0]
        parts = []
        for f in range(n_folds):
            lanes = torch.arange(f, B, n_folds, device=X_folds.device)
            parts.append((lanes, self.final.views_task_batched(
                {k: v[lanes] for k, v in models.items()},
                {**fstatic, "__n_folds__": 1}, {**data, "X": X_folds[f]},
                meta, needed)))
        return _interleave(parts, B)


def _interleave(parts, B):
    """{key: (B, ...)} from per-fold {key: (B/F, ...)} on their lanes."""
    out = {}
    for key, first in parts[0][1].items():
        full = torch.empty((B, *first.shape[1:]), dtype=first.dtype,
                           device=first.device)
        for lanes, part in parts:
            full[lanes] = part[key]
        out[key] = full
    return out


class BinnedInvariantPipelineFamily:
    """Monotone per-feature scalers feeding a histogram-tree final.
    Quantile binning is invariant under strictly monotone per-feature
    maps, so the scalers cannot change the codes the trees consume: fit
    and scoring delegate to the final family."""

    accepts_sample_weight = False    # Pipeline.fit's contract, as above

    def __init__(self, final_name: str, final_family):
        self.final_name = final_name
        self.final = final_family
        self.name = f"pipeline(binned-invariant+{final_family.name})"
        self.is_classifier = final_family.is_classifier
        self.proba_dtype_rule = getattr(final_family, "proba_dtype_rule",
                                        "float64")
        self.dynamic_params = {
            f"{final_name}__{k}": v
            for k, v in final_family.dynamic_params.items()}

    def _strip(self, d):
        """The final's keys without the step prefix; the search's own
        ``__keys__`` pass through."""
        pref = f"{self.final_name}__"
        out = {k[len(pref):]: v for k, v in d.items() if k.startswith(pref)}
        out.update({k: v for k, v in d.items() if k.startswith("__")})
        return out

    def extract_params(self, estimator) -> Dict[str, Any]:
        return _step_params(estimator)

    def prepare_data(self, X, y, dtype=np.float32):
        return self.final.prepare_data(X, y, dtype=dtype)

    def observe_candidates(self, candidates, base_params, meta):
        if hasattr(self.final, "observe_candidates"):
            self.final.observe_candidates(
                [self._strip(c) for c in candidates],
                self._strip(base_params), meta)

    def host_reason(self, static):
        reason = getattr(self.final, "host_reason", None)
        return None if reason is None else reason(self._strip(static))

    def fit_task_batched(self, dynamic, static, data, train_w, meta):
        return self.final.fit_task_batched(
            self._strip(dynamic), self._strip(static), data, train_w, meta)

    def views_task_batched(self, models, static, data, meta, needed):
        return self.final.views_task_batched(
            models, self._strip(static), data, meta, needed)


def make_pipeline_family(pipeline):
    """A pipeline family for a Pipeline (sklearn's or the port's), or None
    when a step has no counterpart here (the port has no host path, so
    the search then raises)."""
    try:
        steps = list(pipeline.steps)
    except AttributeError:
        return None
    if not steps:
        return None
    *transformers, (final_name, final_est) = steps
    resolved = []
    for sname, t in transformers:
        if t is None or (isinstance(t, str) and t == "passthrough"):
            continue
        step = prep.resolve_step(t)
        if step is None:
            return None
        resolved.append((sname, step))
    final_family = resolve_family(final_est)
    if final_family is None or isinstance(
            final_family, (PipelineFamily, BinnedInvariantPipelineFamily)):
        return None
    if getattr(final_family, "binned_codes", False):
        # tree finals consume bin codes: they compose only with monotone
        # per-feature steps, under which the codes are unchanged
        if all(getattr(s, "monotone_per_feature", False)
               for _, s in resolved):
            return BinnedInvariantPipelineFamily(final_name, final_family)
        return None
    return PipelineFamily(resolved, final_name, final_family)
