"""GridSearchCV on the compiled, lane-batched path.

Counterpart of `spark_sklearn_tpu/search/grid.py`: `_fit_impl` (:554),
`_fit_compiled_impl` (:1150), the sequential per-chunk core of
`_run_groups` (:1928; `fit_batch_tb` / `score_batch_wide`, :2622-2756)
and `_format_results` (:4414).  For each compile group the
(candidate x fold) tasks are laid out candidate-major (task t is fold
t % n_folds) and cut into chunks of at most `max_tasks_per_batch` lanes;
each chunk is fitted as one batched L-BFGS and then scored from one wide
GEMM.  `cv_results_` follows sklearn's schema.

Not ported in this slice: RandomizedSearchCV, the host fallback for
estimators without a family, and the speed knobs of the reference
(sorted chunking, the pipelined executor, the chunk scan, fused
fit+score).
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.models.estimators import LogisticRegression
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device
from spark_sklearn_tpu_torch.parallel.taskgrid import (
    build_compile_groups,
    build_fold_masks,
    pad_chunk,
)
from spark_sklearn_tpu_torch.search.cv import ParameterGrid, check_cv
from spark_sklearn_tpu_torch.search.scorers import resolve_scoring


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clone(estimator):
    """An unfitted copy with the same params: the port's own estimators
    copy themselves; anything else goes through sklearn's `clone`."""
    if isinstance(estimator, LogisticRegression):
        return type(estimator)(**estimator.get_params())
    from sklearn.base import clone
    return clone(estimator)


class GridSearchCV:
    """Exhaustive search over `param_grid` with cross-validation.

    Runs on `config.device` (default ``cuda``; see `TorchConfig`).  The
    estimator must resolve to a ported family (the port's or sklearn's
    `LogisticRegression`).  `scoring` is None, ``"accuracy"``,
    ``"neg_log_loss"`` or a list of those; `cv` is None, an int, a
    splitter with ``.split(X, y)`` or an iterable of (train, test)
    index pairs.
    """

    def __init__(self, estimator, param_grid, *, scoring=None, refit=True,
                 cv=None, error_score=np.nan, return_train_score=False,
                 config: Optional[TorchConfig] = None):
        self.estimator = estimator
        self.param_grid = param_grid
        self.scoring = scoring
        self.refit = refit
        self.cv = cv
        self.error_score = error_score
        self.return_train_score = return_train_score
        self.config = config

    # -- fit --------------------------------------------------------------

    def fit(self, X, y):
        family = resolve_family(self.estimator)
        if family is None:
            raise NotImplementedError(
                f"{type(self.estimator).__name__} has no family in the "
                "PyTorch port (only LogisticRegression is ported, and the "
                "host fallback is not)")
        scorers, single = resolve_scoring(self.scoring, family)
        scorer_names = list(scorers)
        self.multimetric_ = single is None
        if self.multimetric_ and self.refit is not False and (
                not isinstance(self.refit, str)
                or self.refit not in scorer_names):
            raise ValueError(
                "For multi-metric scoring, the parameter refit must be set "
                "to a scorer key or False to refit an estimator with the "
                f"best parameter setting on the whole data; got "
                f"refit={self.refit!r}")
        config = self.config or TorchConfig()
        device = resolve_device(config)
        X = np.asarray(X)
        y = np.asarray(y)
        cv = check_cv(self.cv, y, classifier=family.is_classifier)
        splits = [(np.asarray(tr), np.asarray(te))
                  for tr, te in cv.split(X, y)]
        self.n_splits_ = len(splits)
        candidates = list(ParameterGrid(self.param_grid))
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

        refit_metric = self.refit if self.multimetric_ else "score"
        if self.refit or not self.multimetric_:
            self.best_index_ = int(
                results[f"rank_test_{refit_metric}"].argmin())
            self.best_score_ = results[
                f"mean_test_{refit_metric}"][self.best_index_]
            self.best_params_ = results["params"][self.best_index_]
        if self.refit:
            best = _clone(self.estimator).set_params(**self.best_params_)
            if isinstance(best, LogisticRegression) and best.device is None:
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
        scores and the fit/score times per task."""
        data_np, meta = family.prepare_data(X, y)
        # sklearn's log_loss clips at its proba dtype's eps, and sklearn's
        # LogisticRegression returns float64 probabilities whatever X's
        # dtype (the reference resolves the same, grid.py:1251)
        meta["logloss_clip_eps"] = float(np.finfo(np.float64).eps)
        n_samples = X.shape[0]
        train_masks, test_masks = build_fold_masks(splits, n_samples)
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
        groups = build_compile_groups(
            candidates, dynamic_names=list(family.dynamic_params),
            dynamic_dtypes=family.dynamic_params)
        for group in groups:
            static = {**base_params, **group.static_params}
            nc = group.n_candidates
            width = max(1, min(nc, config.max_tasks_per_batch // n_folds))
            lanes = width * n_folds
            fold_idx = torch.arange(lanes, device=device) % n_folds
            w_fit = train_dev[fold_idx]                       # (lanes, n)
            w_test = test_dev[fold_idx]
            for lo in range(0, nc, width):
                hi = min(lo + width, nc)
                dyn = {k: torch.as_tensor(
                           pad_chunk(v, lo, hi, width, repeat=n_folds),
                           device=device)
                       for k, v in group.dynamic_params.items()}
                _sync(device)
                t0 = time.perf_counter()
                model = family.fit_task_batched(dyn, static, data, w_fit,
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
                bad = ~(torch.isfinite(model["coef"]).flatten(1).all(1)
                        & torch.isfinite(model["intercept"]).all(1))
                te = {s: v.cpu().numpy() for s, v in te.items()}
                tr = {s: v.cpu().numpy() for s, v in tr.items()}
                t2 = time.perf_counter()

                idx = group.candidate_indices[lo:hi]
                n_real = hi - lo
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
                self.chunks_.append({
                    "candidates": (int(lo), int(hi)), "lanes": lanes,
                    "n_iter": int(model["n_iter"][0]),
                    "fit_s": t1 - t0, "score_s": t2 - t1})
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
