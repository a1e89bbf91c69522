"""Successive halving: HalvingGridSearchCV and HalvingRandomSearchCV.

Counterpart of `spark_sklearn_tpu/search/halving.py` (:178-561), itself
sklearn's `model_selection/_search_successive_halving.py`.  Rung k fits
every surviving candidate at resource ``r_k = factor**k *
min_resources_``, keeps the best ``ceil(n / factor)`` by mean test score
and repeats.  Each rung is one `evaluate_candidates` call of the search
core (`search/grid.py`):

  - ``resource="n_samples"``: the rung's folds come from the port's copy
    of sklearn's `_SubsampleMetaSplitter` (`search/cv.py`, the same
    subsamples from the same `random_state`), and the device tier fits
    only the rows the rung's folds use;
  - ``resource`` an estimator parameter (``n_estimators``, ...): the
    value is set in every candidate, on the search's own folds;
  - elimination is the copy of sklearn's `_top_k` on the gathered
    scores (its NaN placement and tie order), so the survivors are
    sklearn's for the same scores.

The rung loop attaches a `_RungContext` through the launch-ownership
protocol (`parallel/ownership.py`): the core names each rung's chunks
``r<k>:<group>:<lo>:<hi>`` in `chunks_`, and the context keeps a record
of each rung (`rungs_`: iteration, candidates, resource, wall seconds,
chunks).  Not ported: the reference's device-resident elimination under
``chunk_loop="scan"`` (its default path is this host `_top_k`), its
geometry re-planning between rungs (`halving_replan`,
`min_rung_width`), and the search report, session and data-plane hooks.
Neither class needs sklearn on the device tier.
"""

from __future__ import annotations

import time
from math import ceil, floor, log
from typing import Any, Dict, List, Optional

import numpy as np

from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.parallel import ownership
from spark_sklearn_tpu_torch.parallel.device import TorchConfig
from spark_sklearn_tpu_torch.search.cv import (
    ParameterGrid,
    ParameterSampler,
    _num_samples,
    _SubsampleMetaSplitter,
    _top_k,
    _yields_constant_splits,
    check_classification_targets,
    check_cv,
)
from spark_sklearn_tpu_torch.search.grid import _BaseSearch, _is_classifier
from spark_sklearn_tpu_torch.sparse.csr import as_scipy_csr

__all__ = ["HalvingGridSearchCV", "HalvingRandomSearchCV"]


class _RungContext(ownership.LaunchOwner):
    """The rung loop's state, attached to the search for the loop: the
    current rung's chunk-id namespace and resource, and one record a
    rung."""

    kind = "rung"

    def __init__(self, resource: str):
        self.resource = resource
        self.itr = 0
        self.ns = "r0"
        self.n_resources = 0
        self.records: List[Dict[str, Any]] = []

    def begin_rung(self, itr: int, n_resources: int,
                   n_candidates: int) -> Dict[str, Any]:
        self.itr = int(itr)
        self.ns = f"r{int(itr)}"
        self.n_resources = int(n_resources)
        rec = {"iter": int(itr), "n_candidates": int(n_candidates),
               "n_resources": int(n_resources), "wall_s": 0.0,
               "n_chunks": 0}
        self.records.append(rec)
        return rec


class BaseSuccessiveHalving(_BaseSearch):
    """sklearn's `BaseSuccessiveHalving` over the port's search core:
    candidate generation is the subclass hook
    (`_generate_candidate_params`), the rung loop drives
    `evaluate_candidates(candidates, cv, more_results)`."""

    def __init__(self, estimator, *, scoring=None, n_jobs=None, refit=True,
                 cv=5, verbose=0, random_state=None, error_score=np.nan,
                 return_train_score=True, max_resources="auto",
                 min_resources="exhaust", resource="n_samples", factor=3,
                 aggressive_elimination=False, backend=None,
                 config: Optional[TorchConfig] = None):
        super().__init__(
            estimator, scoring=scoring, n_jobs=n_jobs, refit=refit, cv=cv,
            verbose=verbose, error_score=error_score,
            return_train_score=return_train_score, backend=backend,
            config=config)
        self.random_state = random_state
        self.max_resources = max_resources
        self.resource = resource
        self.factor = factor
        self.min_resources = min_resources
        self.aggressive_elimination = aggressive_elimination

    def _check_input_parameters(self, X, y, split_params):
        """sklearn's `_check_input_parameters`, messages included."""
        if not _yields_constant_splits(self._checked_cv_orig):
            raise ValueError(
                "The cv parameter must yield consistent folds across "
                "calls to split(). Set its random_state to an int, or set "
                "shuffle=False.")
        if (self.resource != "n_samples"
                and self.resource not in self.estimator.get_params()):
            raise ValueError(
                f"Cannot use resource={self.resource} which is not "
                "supported by estimator "
                f"{self.estimator.__class__.__name__}")
        if isinstance(self, HalvingRandomSearchCV):
            if self.min_resources == self.n_candidates == "exhaust":
                raise ValueError(
                    "n_candidates and min_resources cannot be both set "
                    "to 'exhaust'.")
        self.min_resources_ = self.min_resources
        if self.min_resources_ in ("smallest", "exhaust"):
            if self.resource == "n_samples":
                n_splits = self._checked_cv_orig.get_n_splits(
                    X, y, **split_params)
                magic_factor = 2            # sklearn's
                self.min_resources_ = n_splits * magic_factor
                if self._classifier:
                    check_classification_targets(y)
                    n_classes = np.unique(np.asarray(y)).shape[0]
                    self.min_resources_ *= n_classes
            else:
                self.min_resources_ = 1
            # 'exhaust' may raise min_resources_ again in _run_search
        self.max_resources_ = self.max_resources
        if self.max_resources_ == "auto":
            if not self.resource == "n_samples":
                raise ValueError(
                    "resource can only be 'n_samples' when "
                    "max_resources='auto'")
            self.max_resources_ = _num_samples(X)
        if self.min_resources_ > self.max_resources_:
            raise ValueError(
                f"min_resources_={self.min_resources_} is greater "
                f"than max_resources_={self.max_resources_}.")
        if self.min_resources_ == 0:
            raise ValueError(
                f"min_resources_={self.min_resources_}: you might have "
                "passed an empty dataset X.")

    @staticmethod
    def _select_best_index(refit, refit_metric, results) -> int:
        """sklearn's halving rule: the best candidate of the last
        iteration (NaN scores skipped; all NaN: its first)."""
        last_iter = np.max(results["iter"])
        last_iter_indices = np.flatnonzero(results["iter"] == last_iter)
        test_scores = results["mean_test_score"][last_iter_indices]
        if np.isnan(test_scores).all():
            best_idx = 0
        else:
            best_idx = np.nanargmax(test_scores)
        return int(last_iter_indices[best_idx])

    def fit(self, X, y=None, *, groups=None, **fit_params):
        """Validate the resource budget as sklearn does, then run the rung
        loop through the search core."""
        if isinstance(self.scoring, (list, tuple, set, dict)):
            # the elimination reads one mean_test_score column
            raise ValueError(
                "Multimetric scoring is not supported for successive "
                "halving; pass a single scorer name or callable.")
        X = as_scipy_csr(X)      # a CSRMatrix, COO, DOK, ...: scipy CSR
        family = None if self.backend == "host" else \
            resolve_family(self.estimator)
        self._classifier = _is_classifier(self.estimator, family)
        self._checked_cv_orig = check_cv(
            self.cv, None if y is None else np.asarray(y),
            classifier=self._classifier)
        self._check_input_parameters(X, y, {"groups": groups})
        self._n_samples_orig = _num_samples(X)
        super().fit(X, y, groups=groups, **fit_params)
        self.best_score_ = self.cv_results_["mean_test_score"][
            self.best_index_]
        return self

    def _run_search(self, evaluate_candidates) -> None:
        candidate_params = list(self._generate_candidate_params())
        if self.resource != "n_samples" and any(
                self.resource in candidate
                for candidate in candidate_params):
            raise ValueError(
                f"Cannot use parameter {self.resource} as the resource "
                "since it is part of the searched parameters.")
        n_required_iterations = 1 + floor(
            log(len(candidate_params), self.factor))
        if self.min_resources == "exhaust":
            # start as high as lets the last required rung use the most
            last_iteration = n_required_iterations - 1
            self.min_resources_ = max(
                self.min_resources_,
                self.max_resources_ // self.factor ** last_iteration)
        n_possible_iterations = 1 + floor(log(
            self.max_resources_ // self.min_resources_, self.factor))
        if self.aggressive_elimination:
            n_iterations = n_required_iterations
        else:
            n_iterations = min(n_possible_iterations,
                               n_required_iterations)
        if self.verbose:
            print(f"n_iterations: {n_iterations}")
            print(f"n_required_iterations: {n_required_iterations}")
            print(f"n_possible_iterations: {n_possible_iterations}")
            print(f"min_resources_: {self.min_resources_}")
            print(f"max_resources_: {self.max_resources_}")
            print(f"aggressive_elimination: {self.aggressive_elimination}")
            print(f"factor: {self.factor}")

        self.n_resources_ = []
        self.n_candidates_ = []
        rc = ownership.attach_owner(self, _RungContext(self.resource))
        try:
            for itr in range(n_iterations):
                power = itr
                if self.aggressive_elimination:
                    # hold the resource at its floor while candidates are
                    # still being eliminated, then grow as usual
                    power = max(0, itr - n_required_iterations
                                + n_possible_iterations)
                n_resources = int(self.factor ** power * self.min_resources_)
                n_resources = min(n_resources, self.max_resources_)
                self.n_resources_.append(n_resources)
                n_candidates = len(candidate_params)
                self.n_candidates_.append(n_candidates)
                if self.verbose:
                    print("-" * 10)
                    print(f"iter: {itr}")
                    print(f"n_candidates: {n_candidates}")
                    print(f"n_resources: {n_resources}")
                if self.resource == "n_samples":
                    cv = _SubsampleMetaSplitter(
                        base_cv=self._checked_cv_orig,
                        fraction=n_resources / self._n_samples_orig,
                        subsample_test=True,
                        random_state=self.random_state)
                else:
                    # copies, so that the next rung's value does not
                    # overwrite this rung's records
                    candidate_params = [dict(c) for c in candidate_params]
                    for candidate in candidate_params:
                        candidate[self.resource] = n_resources
                    cv = None
                more_results = {"iter": [itr] * n_candidates,
                                "n_resources": [n_resources] * n_candidates}
                rec = rc.begin_rung(itr, n_resources, n_candidates)
                n_chunks0 = len(self.chunks_)
                t0 = time.perf_counter()
                results = evaluate_candidates(candidate_params, cv,
                                              more_results=more_results)
                rec["wall_s"] = time.perf_counter() - t0
                rec["n_chunks"] = len(self.chunks_) - n_chunks0
                n_candidates_to_keep = ceil(n_candidates / self.factor)
                candidate_params = list(
                    _top_k(results, n_candidates_to_keep, itr))
        finally:
            ownership.detach_owner(self)
        self.n_remaining_candidates_ = len(candidate_params)
        self.n_required_iterations_ = n_required_iterations
        self.n_possible_iterations_ = n_possible_iterations
        self.n_iterations_ = n_iterations
        self.rungs_ = rc.records

    def _generate_candidate_params(self):
        raise NotImplementedError


class HalvingGridSearchCV(BaseSuccessiveHalving):
    """sklearn's `HalvingGridSearchCV` on the port: `n_resources_`,
    `n_candidates_`, `n_remaining_candidates_`, the `n_*_iterations_`,
    the `iter` and `n_resources` columns of `cv_results_` and the best
    candidate of the last iteration; `config` as `GridSearchCV`'s."""

    def __init__(self, estimator, param_grid, *, factor=3,
                 resource="n_samples", max_resources="auto",
                 min_resources="exhaust", aggressive_elimination=False,
                 cv=5, scoring=None, refit=True, error_score=np.nan,
                 return_train_score=True, random_state=None, n_jobs=None,
                 verbose=0, backend=None,
                 config: Optional[TorchConfig] = None):
        super().__init__(
            estimator, scoring=scoring, n_jobs=n_jobs, refit=refit, cv=cv,
            verbose=verbose, random_state=random_state,
            error_score=error_score, return_train_score=return_train_score,
            max_resources=max_resources, min_resources=min_resources,
            resource=resource, factor=factor,
            aggressive_elimination=aggressive_elimination, backend=backend,
            config=config)
        self.param_grid = param_grid

    def _generate_candidate_params(self):
        return ParameterGrid(self.param_grid)


class HalvingRandomSearchCV(BaseSuccessiveHalving):
    """sklearn's `HalvingRandomSearchCV` on the port: the first rung's
    candidates drawn by the port's `ParameterSampler` (sklearn's draws
    from the same `random_state`), ``n_candidates="exhaust"`` enough that
    the last rung exhausts the resource."""

    def __init__(self, estimator, param_distributions, *,
                 n_candidates="exhaust", factor=3, resource="n_samples",
                 max_resources="auto", min_resources="smallest",
                 aggressive_elimination=False, cv=5, scoring=None,
                 refit=True, error_score=np.nan, return_train_score=True,
                 random_state=None, n_jobs=None, verbose=0, backend=None,
                 config: Optional[TorchConfig] = None):
        super().__init__(
            estimator, scoring=scoring, n_jobs=n_jobs, refit=refit, cv=cv,
            verbose=verbose, random_state=random_state,
            error_score=error_score, return_train_score=return_train_score,
            max_resources=max_resources, min_resources=min_resources,
            resource=resource, factor=factor,
            aggressive_elimination=aggressive_elimination, backend=backend,
            config=config)
        self.param_distributions = param_distributions
        self.n_candidates = n_candidates

    def _generate_candidate_params(self):
        n_candidates_first_iter = self.n_candidates
        if n_candidates_first_iter == "exhaust":
            n_candidates_first_iter = (
                self.max_resources_ // self.min_resources_)
        return ParameterSampler(
            self.param_distributions, n_candidates_first_iter,
            random_state=self.random_state)
