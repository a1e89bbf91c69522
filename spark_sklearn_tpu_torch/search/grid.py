"""GridSearchCV and RandomizedSearchCV on the compiled, lane-batched path.

Counterpart of `spark_sklearn_tpu/search/grid.py`: `_fit_impl` (:554),
`_fit_compiled_dispatch` (:1035, float64 families), `_fit_compiled_impl`
(:1150), the sequential per-chunk core of `_run_groups` (:1928;
`fit_batch_tb` / `score_batch_wide`, :2622-2756), `_format_results`
(:4414) and `RandomizedSearchCV` (:4635).  For each compile group the
(candidate x fold) tasks are laid out candidate-major (task t is fold
t % n_folds) and cut into chunks of at most `max_tasks_per_batch` lanes;
each chunk is fitted as one batched problem and then scored from one wide
GEMM.  `cv_results_` follows sklearn's schema.

`refit` may be a callable, as sklearn's: it gets `cv_results_` and
returns the best index (`best_score_` is then not set).  A search whose
refit the estimator cannot run here (the port's tree parameter holders)
raises before any fit.

Not ported in this slice: the host fallback for estimators without a
family, `fit_params`/`sample_weight` routing, `groups`, `verbose`, and
the speed knobs of the reference (sorted chunking, the pipelined
executor, the chunk scan, fused fit+score).
"""

from __future__ import annotations

import numbers
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.models.estimators import _Estimator, _clone
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device
from spark_sklearn_tpu_torch.parallel.taskgrid import (
    build_compile_groups,
    build_fold_masks,
    pad_chunk,
)
from spark_sklearn_tpu_torch.search.cv import (
    ParameterGrid,
    ParameterSampler,
    check_cv,
)
from spark_sklearn_tpu_torch.search.scorers import (
    check_scoring_target,
    resolve_scoring,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refits_here(estimator) -> bool:
    """False where the estimator has no fit of its own to refit with (the
    port's tree parameter holders, or a Pipeline holding one); sklearn's
    estimators refit themselves on the host."""
    return not isinstance(estimator, _Estimator) or estimator.can_refit()


def _select_best_index(refit, refit_metric, results) -> int:
    """The refit candidate: what a callable `refit` returns (checked as
    sklearn checks it), else the best rank of `refit_metric`."""
    if callable(refit):
        best_index = refit(results)
        if not isinstance(best_index, numbers.Integral):
            raise TypeError("best_index_ returned is not an integer")
        if best_index < 0 or best_index >= len(results["params"]):
            raise IndexError("best_index_ index out of range")
        return int(best_index)
    return int(results[f"rank_test_{refit_metric}"].argmin())


def _logloss_clip_eps(family, x_dtype) -> float:
    """The eps sklearn's log_loss clips at: that of the probabilities'
    dtype, float64 for most estimators whatever X's dtype, but X's own
    for a family whose `proba_dtype_rule` is "input" (the MLPs) when
    sklearn's validation keeps X float32 (every other dtype becomes
    float64), as the reference resolves it (grid.py:1180-1216)."""
    rule = getattr(family, "proba_dtype_rule", "float64")
    keep = rule == "input" and np.dtype(x_dtype) == np.float32
    return float(np.finfo(np.float32 if keep else np.float64).eps)


def _lane_finite(model, B: int) -> torch.Tensor:
    """(B,) True where every floating leaf of the lane's model is finite,
    whatever each leaf's shape."""
    return torch.stack([torch.isfinite(leaf.reshape(B, -1)).all(dim=1)
                        for leaf in model.values()
                        if leaf.is_floating_point()]).all(dim=0)


class _BaseSearch:
    """The search core shared by `GridSearchCV` and `RandomizedSearchCV`,
    which differ only in `_get_candidates`.

    Runs on `config.device` (default ``cuda``; see `TorchConfig`).  The
    estimator must resolve to a ported family: the port's or sklearn's
    `LogisticRegression`, `Ridge`, `LinearRegression`, `ElasticNet`,
    `Lasso`, `SVC`, `NuSVC`, `GradientBoostingRegressor`/`Classifier`,
    `RandomForestClassifier`/`Regressor`, `MLPClassifier`/`Regressor`, or
    a `Pipeline` of preprocessing steps and one of them.  `scoring` is
    None (accuracy for classifiers, r2 for regressors), one of the scorer
    names of `search/scorers.py` or a list of them; `cv` is None, an int,
    a splitter with ``.split(X, y)`` or an iterable of (train, test) index
    pairs.
    """

    def __init__(self, estimator, *, scoring=None, refit=True, cv=None,
                 error_score=np.nan, return_train_score=False,
                 config: Optional[TorchConfig] = None):
        self.estimator = estimator
        self.scoring = scoring
        self.refit = refit
        self.cv = cv
        self.error_score = error_score
        self.return_train_score = return_train_score
        self.config = config

    def _get_candidates(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    # -- fit --------------------------------------------------------------

    def fit(self, X, y):
        family = resolve_family(self.estimator)
        if family is None:
            raise NotImplementedError(
                f"{type(self.estimator).__name__} has no family in the "
                "PyTorch port (the host fallback is not ported)")
        if self.refit and not _refits_here(self.estimator):
            raise NotImplementedError(
                f"{type(self.estimator).__name__} has no fit of its own in "
                "the PyTorch port to refit with: search with refit=False, "
                "or pass sklearn's estimator (refit runs it on the host)")
        scorers, single = resolve_scoring(self.scoring, family)
        scorer_names = list(scorers)
        self.multimetric_ = single is None
        if self.multimetric_ and self.refit is not False and \
                not callable(self.refit) and (
                    not isinstance(self.refit, str)
                    or self.refit not in scorer_names):
            # sklearn's phrasing (_search.py _check_refit_for_multimetric)
            raise ValueError(
                "For multi-metric scoring, the parameter refit must be set "
                "to a scorer key or a callable to refit an estimator with "
                "the best parameter setting on the whole data and make the "
                "best_* attributes available for that metric. If this is "
                "not needed, refit should be set to False explicitly. "
                f"{self.refit!r} was passed.")
        config = self.config or TorchConfig()
        device = resolve_device(config)
        X = np.asarray(X)
        y = np.asarray(y)
        cv = check_cv(self.cv, y, classifier=family.is_classifier)
        splits = [(np.asarray(tr), np.asarray(te))
                  for tr, te in cv.split(X, y)]
        self.n_splits_ = len(splits)
        candidates = self._get_candidates()
        if not splits or not candidates:
            raise ValueError(
                "No fits were performed. Was the CV iterator empty? "
                "Were there no candidates?")

        test_scores, train_scores, fit_times, score_times = \
            self._fit_compiled(family, X, y, candidates, splits, scorers,
                               config, device)
        results = self._format_results(
            candidates, test_scores, train_scores, fit_times, score_times,
            scorer_names)
        self.cv_results_ = results

        refit_metric = (self.refit if self.multimetric_
                        and isinstance(self.refit, str) else "score")
        if self.refit or not self.multimetric_:
            self.best_index_ = _select_best_index(self.refit, refit_metric,
                                                  results)
            if not callable(self.refit):
                self.best_score_ = results[
                    f"mean_test_{refit_metric}"][self.best_index_]
            self.best_params_ = results["params"][self.best_index_]
        if self.refit:
            best = _clone(self.estimator).set_params(**self.best_params_)
            if isinstance(best, _Estimator) and best.device is None:
                best.set_params(device=str(device))
            t0 = time.perf_counter()
            best.fit(X, y)
            self.refit_time_ = time.perf_counter() - t0
            self.best_estimator_ = best
        return self

    def _fit_compiled(self, family, X, y, candidates, splits, scorers,
                      config, device):
        """Fit and score every (candidate x fold) task, chunk by chunk.
        Returns per-scorer (n_candidates, n_folds) test (and train)
        scores and the fit/score times per task.

        A family that sets `wants_float64` runs with float64 data, fold
        masks and dynamic parameters (the reference runs it under x64;
        its dynamic parameters are float32 arrays cast to float64, and
        so are these)."""
        use_f64 = bool(getattr(family, "wants_float64", False)) and \
            config.dtype is None
        dtype = np.float64 if use_f64 else np.float32
        data_np, meta = family.prepare_data(X, y, dtype=dtype)
        check_scoring_target(self.scoring, family, meta)
        meta["logloss_clip_eps"] = _logloss_clip_eps(family, X.dtype)
        n_samples = X.shape[0]
        train_masks, test_masks = build_fold_masks(splits, n_samples,
                                                   dtype=dtype)
        data = {k: torch.as_tensor(v, device=device)
                for k, v in data_np.items()}
        train_dev = torch.as_tensor(train_masks, device=device)
        test_dev = torch.as_tensor(test_masks, device=device)
        n_folds = len(splits)
        n_cand = len(candidates)
        return_train = self.return_train_score
        needed = frozenset(v for s in scorers.values() for v in s.views)

        test_scores = {s: np.empty((n_cand, n_folds)) for s in scorers}
        train_scores = ({s: np.empty((n_cand, n_folds)) for s in scorers}
                        if return_train else None)
        fit_times = np.empty((n_cand, n_folds))
        score_times = np.empty((n_cand, n_folds))
        fit_failed = np.zeros((n_cand, n_folds), bool)
        self.chunks_: List[Dict[str, Any]] = []

        base_params = family.extract_params(self.estimator)
        if hasattr(family, "observe_candidates"):
            # the tree families read the grid's largest n_estimators (the
            # trees a chunk may grow) and warn once on capped depths, as
            # the reference does (grid.py:1357-1361)
            family.observe_candidates(candidates, base_params, meta)
        # bound the chunk: at most max_tasks_per_batch lanes, and fewer
        # where the family asks (SVC's kernel matrix and decision caches),
        # as the reference does (grid.py:1666-1671)
        max_tasks = config.max_tasks_per_batch
        hint = getattr(family, "max_tasks_hint", None)
        if hint is not None:
            max_tasks = min(max_tasks, max(n_folds, hint(n_samples, meta)))
        groups = build_compile_groups(
            candidates, dynamic_names=list(family.dynamic_params),
            dynamic_dtypes=family.dynamic_params)
        for group in groups:
            static = {**base_params, **group.static_params,
                      "__n_folds__": n_folds}
            nc = group.n_candidates
            width = max(1, min(nc, max_tasks // n_folds))
            lanes = width * n_folds
            fold_idx = torch.arange(lanes, device=device) % n_folds
            w_fit = train_dev[fold_idx]                       # (lanes, n)
            w_test = test_dev[fold_idx]
            for lo in range(0, nc, width):
                hi = min(lo + width, nc)
                n_real = hi - lo
                dyn = {}
                for k, v in group.dynamic_params.items():
                    arr = pad_chunk(v, lo, hi, width, repeat=n_folds)
                    if use_f64 and arr.dtype.kind == "f":
                        arr = arr.astype(np.float64)
                    dyn[k] = torch.as_tensor(arr, device=device)
                _sync(device)
                t0 = time.perf_counter()
                # the real candidates of the chunk, for a family that can
                # skip its padding (SVC solves candidate by candidate)
                model = family.fit_task_batched(
                    dyn, {**static, "__n_real__": n_real}, data, w_fit,
                    meta)
                _sync(device)
                t1 = time.perf_counter()
                views = family.views_task_batched(model, static, data,
                                                  meta, needed)
                te = {s: sc.core(views, data["y"], w_test, meta)
                      for s, sc in scorers.items()}
                tr = ({s: sc.core(views, data["y"], w_fit, meta)
                       for s, sc in scorers.items()} if return_train
                      else {})
                bad = ~_lane_finite(model, lanes)
                te = {s: v.cpu().numpy() for s, v in te.items()}
                tr = {s: v.cpu().numpy() for s, v in tr.items()}
                t2 = time.perf_counter()

                idx = group.candidate_indices[lo:hi]
                for s in scorers:
                    test_scores[s][idx] = \
                        te[s].reshape(width, n_folds)[:n_real]
                    if return_train:
                        train_scores[s][idx] = \
                            tr[s].reshape(width, n_folds)[:n_real]
                fit_failed[idx] |= bad.cpu().numpy().reshape(
                    width, n_folds)[:n_real]
                # charge each launch's wall to the real tasks in it
                fit_times[idx] = (t1 - t0) / (n_real * n_folds)
                score_times[idx] = (t2 - t1) / (n_real * n_folds)
                chunk = {"candidates": (int(lo), int(hi)), "lanes": lanes,
                         "fit_s": t1 - t0, "score_s": t2 - t1}
                # the iterations the chunk ran, where the family has a
                # solver (the closed-form regressors have none): the max
                # over its lanes of n_iter_exec, else n_iter, as the
                # reference records it (grid.py:2800)
                it = model.get("n_iter_exec", model.get("n_iter"))
                if it is not None:
                    chunk["n_iter_exec"] = int(it.max())
                self.chunks_.append(chunk)
            for arr in group.dynamic_params.values():
                if np.issubdtype(arr.dtype, np.floating):
                    fit_failed[group.candidate_indices[np.isnan(arr)]] = \
                        True

        self._handle_failed_fits(fit_failed, test_scores, train_scores)
        return test_scores, train_scores, fit_times, score_times

    def _handle_failed_fits(self, fit_failed, test_scores, train_scores):
        """sklearn's error_score semantics for fits whose model came out
        non-finite (or whose hyperparameters were NaN)."""
        if not fit_failed.any():
            return
        n_bad, n_all = int(fit_failed.sum()), fit_failed.size
        if isinstance(self.error_score, str) and self.error_score == "raise":
            raise ValueError(
                f"{n_bad} fits failed with non-finite parameters and "
                "error_score='raise'")
        if fit_failed.all():
            raise ValueError(
                f"\nAll the {n_all} fits failed.\nIt is very likely that "
                "your model is misconfigured.\nYou can try to debug the "
                "error by setting error_score='raise'.")
        warnings.warn(
            f"\n{n_bad} fits failed out of a total of {n_all}.\nThe score "
            "on these train-test partitions for these parameters will be "
            f"set to {self.error_score}. (cause: non-finite model "
            "parameters or hyperparameters)", UserWarning)
        for s in test_scores:
            test_scores[s][fit_failed] = self.error_score
            if train_scores is not None:
                train_scores[s][fit_failed] = self.error_score

    # -- results ----------------------------------------------------------

    def _format_results(self, candidates, test_scores, train_scores,
                        fit_times, score_times, scorer_names):
        from scipy.stats import rankdata

        n_candidates = len(candidates)
        results: Dict[str, Any] = {}

        def _store(key_name, array, splits=False, rank=False):
            array = np.asarray(array, dtype=np.float64).reshape(
                n_candidates, -1)
            if splits:
                for i in range(array.shape[1]):
                    results[f"split{i}_{key_name}"] = array[:, i]
            means = np.average(array, axis=1)
            results[f"mean_{key_name}"] = means
            if key_name.startswith(("train_", "test_")) and np.any(
                    ~np.isfinite(means)):
                warnings.warn(
                    f"One or more of the {key_name.split('_')[0]} scores "
                    f"are non-finite: {means}", category=UserWarning)
            results[f"std_{key_name}"] = np.sqrt(np.average(
                (array - means[:, None]) ** 2, axis=1))
            if rank:
                if np.isnan(means).any():
                    rank_arr = rankdata(
                        np.where(np.isnan(means), np.inf, -means),
                        method="min")
                else:
                    rank_arr = rankdata(-means, method="min")
                results[f"rank_{key_name}"] = rank_arr.astype(np.int32)

        _store("fit_time", fit_times)
        _store("score_time", score_times)

        # masked param arrays, sklearn's dtype rule: inferred from the
        # present values; strings and nested sequences stay object
        param_results: Dict[str, Dict[int, Any]] = defaultdict(dict)
        for cand_idx, params in enumerate(candidates):
            for name, value in params.items():
                param_results[f"param_{name}"][cand_idx] = value
        for key, param_result in param_results.items():
            param_list = list(param_result.values())
            try:
                arr = np.array(param_list)
            except ValueError:
                arr_dtype = np.dtype(object)
            else:
                arr_dtype = (arr.dtype if arr.dtype.kind != "U"
                             and arr.ndim == 1 else object)
            ma = np.ma.MaskedArray(np.empty(n_candidates, dtype=arr_dtype),
                                   mask=True)
            for index, value in param_result.items():
                ma[index] = value
            results[key] = ma
        results["params"] = list(candidates)

        for s in scorer_names:
            _store(f"test_{s}", test_scores[s], splits=True, rank=True)
            if self.return_train_score:
                _store(f"train_{s}", train_scores[s], splits=True)
        return results

    # -- prediction (delegates to the refit estimator) ---------------------

    def predict(self, X):
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        return self.best_estimator_.predict_proba(X)


class GridSearchCV(_BaseSearch):
    """Exhaustive search over `param_grid` (a dict or list of dicts of
    value lists) with cross-validation; see `_BaseSearch`."""

    def __init__(self, estimator, param_grid, *, scoring=None, refit=True,
                 cv=None, error_score=np.nan, return_train_score=False,
                 config: Optional[TorchConfig] = None):
        super().__init__(estimator, scoring=scoring, refit=refit, cv=cv,
                         error_score=error_score,
                         return_train_score=return_train_score,
                         config=config)
        self.param_grid = param_grid

    def _get_candidates(self):
        return list(ParameterGrid(self.param_grid))


class RandomizedSearchCV(_BaseSearch):
    """Search over `n_iter` candidates drawn from `param_distributions`
    by the port's `ParameterSampler` (the candidates sklearn's draws from
    the same `random_state`); see `_BaseSearch`."""

    def __init__(self, estimator, param_distributions, *, n_iter=10,
                 scoring=None, refit=True, cv=None, random_state=None,
                 error_score=np.nan, return_train_score=False,
                 config: Optional[TorchConfig] = None):
        super().__init__(estimator, scoring=scoring, refit=refit, cv=cv,
                         error_score=error_score,
                         return_train_score=return_train_score,
                         config=config)
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state

    def _get_candidates(self):
        return list(ParameterSampler(self.param_distributions, self.n_iter,
                                     random_state=self.random_state))
