"""GridSearchCV and RandomizedSearchCV: sklearn's `evaluate_candidates`
seam over the compiled, lane-batched device tier and a host tier.

Counterpart of `spark_sklearn_tpu/search/grid.py`: `fit` and
`_run_search` (:418-433), `_fit_impl` with its tier decision and
`evaluate_candidates` (:554-825), `_compact_for_rung` (:654-690),
`_fit_compiled_dispatch` (:1035, float64 families), `_fit_compiled_impl`
(:1150), the sequential per-chunk core of `_run_groups` (:1928;
`fit_batch_tb` / `score_batch_wide`, :2622-2756), `_fit_host`
(:4292-4413), `_format_results` (:4414) and `RandomizedSearchCV`
(:4635).

`fit` validates, then hands `evaluate_candidates(candidate_params, cv=
None, more_results=None)` to `_run_search`, sklearn's extension point:
Grid and Randomized search call it once, successive halving
(`search/halving.py`) once a rung with a per-call cv (a subsample of the
search's folds, whose rows the device tier compacts to the ones the rung
uses) and extra result columns.  Each call returns the results so far.

**Tiers.**  Before any fit, the first `evaluate_candidates` call decides
where the search runs.  The device tier needs a ported family (the
port's or sklearn's estimator, see `_BaseSearch`), no fit parameter but
`sample_weight` (and that only for a family that takes it, and not with
`class_weight="balanced"` and a zero weight), a scoring the port
resolves (None, one of the 17 scorer names or a list of them) and no
candidate that its family's `host_reason` sends to the host
(`kernel="precomputed"`; LinearSVC's l1 penalty, other losses and
crammer_singer; LDA's svd and eigen solvers and shrinkage="auto").  For
the device tier the (candidate x fold) tasks of each compile group are
laid out candidate-major (task t is fold t % n_folds), cut into chunks
of at most `max_tasks_per_batch` lanes, each fitted as one batched
problem and scored from one wide GEMM.  Everything else runs on the host
tier: sklearn's `_fit_and_score` a task through joblib with `n_jobs`,
which needs scikit-learn.  `backend=None` picks the tier and warns once
where it picks the host; `"host"` forces the host tier; `"device"` (the
reference's `"tpu"`) raises where the device tier cannot run the search.
An exception on the device tier propagates: the port never re-runs a
search on the host after a device failure.

`refit` may be a callable, as sklearn's: it gets `cv_results_` and
returns the best index (`best_score_` is then not set).  A search whose
refit the estimator cannot run here (the port's tree parameter holders)
raises before any fit.

`fit(X, y=None, *, groups=None, **fit_params)` routes as the reference
does without sklearn's metadata routing (:494-510): `groups` goes to the
splitter; on the device tier `sample_weight` scales the fit masks and
the scoring masks (but not those of `max_error`, whose sklearn twin
takes no weights: :1298-1330); the refit gets every fit parameter.
`verbose` prints sklearn's lines (:762, :4240-4287).  After refit the
search has `classes_`, `n_features_in_`, `scorer_`, `score` and the
delegated `predict`, `predict_proba`, `predict_log_proba`,
`decision_function`, `score_samples`, `transform` and
`inverse_transform` (:4491-4590), each an AttributeError where the refit
estimator lacks it.

**Sparse X** (the reference's `grid.py:570-576`, `:967-982`,
`:1220-1245`).  A `CSRMatrix` or any scipy-sparse X becomes scipy CSR;
the splitters count its rows by its shape and the host tier gets it as
it is.  The device tier densifies it once on the host, or, under
`TorchConfig(data_mode="sparse")`, keeps it sparse for a family that
sets `supports_sparse` (LogisticRegression and the discrete naive
Bayes): `prepare_data_sparse` stages it and the device holds the CSRs of
X and Xᵀ (`sparse/csr.py`), which the families multiply through SP1.

Not ported: the reference's speed knobs (sorted chunking, the pipelined
executor, the chunk scan, fused fit+score), its search report and its
callbacks.
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
from spark_sklearn_tpu_torch.parallel import ownership
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
    SAMPLE_WEIGHT_BLIND,
    SearchScorer,
    check_scoring_target,
    resolve_scoring,
)
from spark_sklearn_tpu_torch.search.stream import resolve_data_mode
from spark_sklearn_tpu_torch.sparse.csr import (
    as_scipy_csr,
    densify,
    issparse,
    to_device,
)

_NO_FITS = ("No fits were performed. Was the CV iterator empty? Were "
            "there no candidates?")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refits_here(estimator) -> bool:
    """False where the estimator has no fit of its own to refit with (the
    port's tree parameter holders, or a Pipeline holding one); sklearn's
    estimators refit themselves on the host."""
    return not isinstance(estimator, _Estimator) or estimator.can_refit()


def _is_classifier(estimator, family) -> bool:
    """The family's fact where there is one, else sklearn's
    `is_classifier` (an estimator without a family is sklearn's)."""
    if family is not None:
        return bool(family.is_classifier)
    try:
        from sklearn.base import is_classifier
    except ImportError:
        return getattr(estimator, "_estimator_type", None) == "classifier"
    return is_classifier(estimator)


def _is_multimetric(scorer_names) -> bool:
    return not (len(scorer_names) == 1 and scorer_names[0] == "score")


def _logloss_clip_eps(family, x_dtype) -> float:
    """The eps sklearn's log_loss clips at: that of the probabilities'
    dtype, float64 for most estimators whatever X's dtype, but X's own
    for a family whose `proba_dtype_rule` is "input" (the MLPs) when
    sklearn's validation keeps X float32 (every other dtype becomes
    float64), as the reference resolves it (grid.py:1180-1216)."""
    rule = getattr(family, "proba_dtype_rule", "float64")
    keep = rule == "input" and np.dtype(x_dtype) == np.float32
    return float(np.finfo(np.float32 if keep else np.float64).eps)


def _metric(scoring, key: str):
    """The metric name behind a result key: "score" is `scoring` itself
    (one named metric, or None for the family's default)."""
    return scoring if key == "score" else key


def short_format_time(t: float) -> str:
    """joblib's `short_format_time`, as sklearn's verbose lines print a
    task's time."""
    return f"{t / 60.0:4.1f}min" if t > 60 else f" {t:5.1f}s"


def _compact_for_rung(X, y, splits, fit_weight, score_weight,
                      classifier: bool):
    """X, y, the splits and both weight vectors cut to the rows that some
    fold of `splits` uses, the splits remapped onto them (the reference's
    `_compact_for_rung`, grid.py:654-690).  A halving rung fits only its
    subsample; every kept row keeps its value, so each fold computes on
    the same rows (a scipy CSR X is cut by its rows, and stays CSR).  None
    where nothing drops out, or where a classifier's subsample lost a
    class (the fitted class structure must be the full data's)."""
    used = np.unique(np.concatenate(
        [np.concatenate([np.asarray(tr), np.asarray(te)])
         for tr, te in splits]))
    if used.size == 0 or used.size >= X.shape[0]:
        return None
    y_sub = None if y is None else y[used]
    if y is not None and classifier and \
            np.unique(y_sub).size != np.unique(y).size:
        return None
    splits_c = [(np.searchsorted(used, np.asarray(tr)),
                 np.searchsorted(used, np.asarray(te)))
                for tr, te in splits]
    fw = None if fit_weight is None else np.asarray(fit_weight)[used]
    sw = None if score_weight is None else np.asarray(score_weight)[used]
    return X[used], y_sub, splits_c, fw, sw


class NotFittedError(ValueError, AttributeError):
    """sklearn's NotFittedError: the search has not been fitted."""


def _check_refit(search, attr: str) -> None:
    if not search.refit:
        raise AttributeError(
            f"This {type(search).__name__} instance was initialized with "
            f"`refit=False`. {attr} is available only after refitting on "
            "the best parameters. You can refit an estimator manually "
            "using the `best_params_` parameter")


class _Delegated:
    """A method of the refit estimator, available as sklearn's
    `available_if(_search_estimator_has(name))` makes it: an
    AttributeError where refit is off or the estimator lacks it."""

    def __init__(self, name: str):
        self.name = name

    def __get__(self, search, owner=None):
        if search is None:
            return self
        _check_refit(search, self.name)
        # an AttributeError where the estimator lacks the method
        getattr(getattr(search, "best_estimator_", search.estimator),
                self.name)
        name = self.name

        def call(X):
            if not hasattr(search, "best_estimator_"):
                raise NotFittedError(
                    f"This {type(search).__name__} instance is not fitted "
                    "yet. Call 'fit' with appropriate arguments before "
                    "using this estimator.")
            return getattr(search.best_estimator_, name)(X)

        return call


def _lane_finite(model, B: int) -> torch.Tensor:
    """(B,) True where every floating leaf of the lane's model is finite,
    whatever each leaf's shape."""
    return torch.stack([torch.isfinite(leaf.reshape(B, -1)).all(dim=1)
                        for leaf in model.values()
                        if leaf.is_floating_point()]).all(dim=0)


class _Evaluation:
    """One `fit`'s `evaluate_candidates` and what it accumulates across
    calls: candidates, scores, times and extra result columns (sklearn's
    `BaseSearchCV.fit` closure, the reference's grid.py:744-825)."""

    def __init__(self, search, X, X_arr, y, groups, fit_params, family,
                 config, splits):
        self.search = search
        self.X, self.X_arr, self.y = X, X_arr, y
        self.y_arr = None if y is None else np.asarray(y)
        self.groups = groups
        self.fit_params = dict(fit_params)
        self.family = family
        self.config = config
        self.splits = splits
        self.device = None
        self.tier = None                # decided at the first call
        self.params: List[Dict[str, Any]] = []
        self.test = self.train = None
        self.fit_t: List[np.ndarray] = []
        self.score_t: List[np.ndarray] = []
        self.names = None
        self.more: Dict[str, list] = {}
        self.results = None
        self.scorer_attr = None

    # -- the tier ----------------------------------------------------------

    def _host_reason(self, candidates) -> Optional[Exception]:
        """The exception a forced device tier raises for this search, or
        None where the device tier runs it (the reference's up-front
        cases, grid.py:601-640, and the compiled-path refusals it reaches
        through its exception fallback)."""
        s, family = self.search, self.family
        if family is None:
            return NotImplementedError(
                f"{type(s.estimator).__name__} has no family in the "
                "PyTorch port")
        sw = self.fit_params.get("sample_weight")
        other = sorted(k for k, v in self.fit_params.items()
                       if k != "sample_weight" and v is not None)
        if other or (sw is not None and not getattr(
                family, "accepts_sample_weight", True)):
            return ValueError(
                f"fit/score params {other or ['sample_weight']} are not "
                "supported on the compiled path; use backend='host'")
        if sw is not None and np.any(np.asarray(sw) == 0):
            # sklearn's balanced counts take in every train-fold row, the
            # compiled path's only the weighted ones (grid.py:1001-1011)
            if getattr(s.estimator, "class_weight", None) == "balanced":
                return ValueError(
                    "fit/score params ['sample_weight'] are not supported "
                    "on the compiled path; use backend='host'")
            if any(isinstance(v, str) and v == "balanced"
                   for c in candidates for k, v in c.items()
                   if k == "class_weight" or k.endswith("__class_weight")):
                return ValueError(
                    "class_weight='balanced' with zero-valued sample "
                    "weights is not compiled; use backend='host'")
        try:
            resolve_scoring(s.scoring, family)
        except NotImplementedError as exc:
            return exc
        host_reason = getattr(family, "host_reason", None)
        if host_reason is not None:
            base = family.extract_params(s.estimator)
            for c in candidates:
                reason = host_reason({**base, **c})
                if reason is not None:
                    return ValueError(reason)
        return None

    def _decide(self, candidates) -> None:
        """Pick the tier at the first call; later calls' candidates must
        fit the device tier where it was picked (a custom `_run_search`
        may bring new ones)."""
        s = self.search
        if self.tier == "host":
            return
        if self.tier is None and s.backend == "host":
            self.tier = "host"
            return
        exc = self._host_reason(candidates)
        if exc is not None:
            if s.backend == "device" or self.tier == "device":
                raise exc
            warnings.warn(
                f"{type(s).__name__} runs on the host tier (scikit-learn's "
                f"_fit_and_score): {exc}", UserWarning)
            self.tier = "host"
            return
        if self.tier is None:
            self.tier = "device"
            self._prepare_device()

    def _prepare_device(self) -> None:
        s, family = self.search, self.family
        self.device = resolve_device(self.config)
        # the data tier (search/stream.py; the reference's grid.py:
        # 1220-1245): under "sparse" a scipy-sparse X stays sparse, for a
        # family that takes it; otherwise it is densified here, once
        if issparse(self.X_arr) and \
                resolve_data_mode(self.config) == "sparse":
            if not getattr(family, "supports_sparse", False):
                raise ValueError(
                    "data_mode='sparse' requires a family with sparse "
                    f"fit/predict programs; {family.name} has none.  Use "
                    "data_mode='device' (densified upload) or "
                    "backend='host'.")
            self.Xd = self.X_arr
        else:
            self.Xd = densify(self.X_arr)
        scorers, single = resolve_scoring(s.scoring, family)
        self.scorers = scorers
        names = list(scorers)
        sw = self.fit_params.get("sample_weight")
        self.fit_weight, self.score_weight = sw, None
        if sw is not None:
            # the scorers get the weights unless none of them takes them
            # (each that does not is warned of and scores unweighted)
            blind = [n for n in names
                     if _metric(s.scoring, n) in SAMPLE_WEIGHT_BLIND]
            for n in blind:
                label = n if isinstance(s.scoring, str) else f"{n}={n}"
                warnings.warn(
                    f"The scoring {label} does not support sample_weight, "
                    "which may lead to statistically incorrect results "
                    f"when fitting {type(s).__name__} with sample_weight. ",
                    UserWarning)
            if len(blind) < len(names):
                self.score_weight = sw
        default = getattr(family, "default_scorer", None) or (
            "accuracy" if family.is_classifier else "r2")
        # sklearn's clip follows X's own dtype, which the densified (or
        # sparse) Xd keeps
        eps = _logloss_clip_eps(family, self.Xd.dtype)
        self.scorer_attr = (
            SearchScorer(s.scoring if isinstance(s.scoring, str)
                         else "score", default, eps)
            if single is not None else
            {n: SearchScorer(n, default, eps) for n in names})

    # -- the seam ----------------------------------------------------------

    def evaluate_candidates(self, candidate_params, cv=None,
                            more_results=None):
        """Fit and score `candidate_params` on the search's folds, or on
        `cv`'s where given (split with the search's `groups`), add
        `more_results`' columns, and return `cv_results_` for every
        candidate evaluated so far."""
        s = self.search
        cands = list(candidate_params)
        if cv is None:
            splits = self.splits
        else:
            splits = [(np.asarray(tr), np.asarray(te)) for tr, te in
                      cv.split(self.X_arr, self.y_arr, groups=self.groups)]
            if len(splits) != s.n_splits_:
                raise ValueError(
                    f"the per-call cv yielded {len(splits)} splits, "
                    f"expected {s.n_splits_}")
        if s.verbose > 0:
            print(f"Fitting {s.n_splits_} folds for each of {len(cands)} "
                  f"candidates, totalling {s.n_splits_ * len(cands)} fits")
        if not cands:
            if not self.params:
                raise ValueError(_NO_FITS)
            return self.results
        if not splits:
            raise ValueError(_NO_FITS)
        self._decide(cands)
        if self.tier == "host":
            (test, train, fit_t, score_t, names,
             self.scorer_attr) = s._fit_host(
                self.X, self.y, cands, splits, self.fit_params, self.family,
                self.config)
        else:
            X, y, splits_c = self.Xd, self.y_arr, splits
            fw, sw = self.fit_weight, self.score_weight
            if cv is not None:
                # a per-call cv is a halving rung's subsample: fit only
                # the rows the rung uses
                sub = _compact_for_rung(X, y, splits, fw, sw,
                                        self.family.is_classifier)
                if sub is not None:
                    X, y, splits_c, fw, sw = sub
            test, train, fit_t, score_t = s._fit_compiled(
                self.family, X, y, cands, splits_c, self.scorers,
                self.config, self.device, fw, sw)
            names = list(self.scorers)
        if self.names is None:
            self.names = names
            self.test = {n: [] for n in names}
            self.train = {n: [] for n in names} if s.return_train_score \
                else None
        elif names != self.names:
            raise ValueError(
                "inconsistent scorer names across evaluate_candidates "
                f"calls: {names} vs {self.names}")
        self.params.extend(cands)
        for n in names:
            self.test[n].append(test[n])
            if s.return_train_score:
                self.train[n].append(train[n])
        self.fit_t.append(fit_t)
        self.score_t.append(score_t)
        for k, v in (more_results or {}).items():
            self.more.setdefault(k, []).extend(v)
        self.results = s._format_results(
            self.params, {n: np.concatenate(v) for n, v in self.test.items()},
            ({n: np.concatenate(v) for n, v in self.train.items()}
             if s.return_train_score else None),
            np.concatenate(self.fit_t), np.concatenate(self.score_t),
            self.names, more_results=self.more)
        return self.results


class _BaseSearch:
    """The search core shared by `GridSearchCV`, `RandomizedSearchCV` and
    successive halving, which differ in `_run_search` (by default, one
    `evaluate_candidates` call over `_get_candidates()`).

    The device tier runs on `config.device` (default ``cuda``; see
    `TorchConfig`) for an estimator of a ported family: the port's or
    sklearn's `LogisticRegression`, `Ridge`, `LinearRegression`,
    `ElasticNet`, `Lasso`, `SVC`, `NuSVC` (with `probability=True`),
    `SVR`, `NuSVR`, `LinearSVC`, `LinearSVR`,
    `GradientBoostingRegressor`/`Classifier`,
    `RandomForestClassifier`/`Regressor`, `MLPClassifier`/`Regressor`,
    the five naive Bayes classes, `LinearDiscriminantAnalysis(solver=
    "lsqr")`, `KNeighborsClassifier`/`Regressor`, `KMeans`, or a
    `Pipeline` of preprocessing steps and one of them.  `scoring` is None
    (the family's default: accuracy for classifiers, r2 for regressors,
    -inertia for KMeans), one of the scorer names of
    `search/scorers.py` or a list of them there; on the host tier also a
    callable, an sklearn scorer object or a dict of them.  `cv` is None,
    an int, a splitter with ``.split(X, y, groups)`` or an iterable of
    (train, test) index pairs; `n_jobs` the host tier's joblib workers;
    `backend` None, "host" or "device" (see the module docstring);
    `verbose` > 0 prints sklearn's "Fitting ..." line, > 1 its "[CV]
    END" line a task, > 2 with the task's fold and scores.
    """

    def __init__(self, estimator, *, scoring=None, n_jobs=None, refit=True,
                 cv=None, verbose=0, error_score=np.nan,
                 return_train_score=False, backend=None,
                 config: Optional[TorchConfig] = None):
        self.estimator = estimator
        self.scoring = scoring
        self.n_jobs = n_jobs
        self.refit = refit
        self.cv = cv
        self.verbose = verbose
        self.error_score = error_score
        self.return_train_score = return_train_score
        self.backend = backend
        self.config = config

    def _get_candidates(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def _run_search(self, evaluate_candidates) -> None:
        """sklearn's extension point: call `evaluate_candidates` any
        number of times with any candidate batches; each call returns
        `cv_results_` for everything evaluated so far."""
        evaluate_candidates(self._get_candidates())

    def _check_refit_for_multimetric(self, scorer_names) -> None:
        if self.refit is not False and not callable(self.refit) and (
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

    @staticmethod
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

    # -- fit --------------------------------------------------------------

    def fit(self, X, y=None, *, groups=None, **fit_params):
        if self.backend not in (None, "host", "device"):
            raise ValueError(f"backend={self.backend!r}: pass None, "
                             "'host' or 'device'")
        if isinstance(self.scoring, (list, tuple, set, dict)):
            self._check_refit_for_multimetric(list(self.scoring))
        if self.refit and not _refits_here(self.estimator):
            raise NotImplementedError(
                f"{type(self.estimator).__name__} has no fit of its own in "
                "the PyTorch port to refit with: search with refit=False, "
                "or pass sklearn's estimator (refit runs it on the host)")
        config = self.config or TorchConfig()
        config.check_supported()
        resolve_data_mode(config)           # refuses "stream" up front
        family = None if self.backend == "host" else \
            resolve_family(self.estimator)
        # a CSRMatrix becomes scipy CSR, and so do COO, DOK and the other
        # scipy formats (rows a fold's indices can cut), as the reference
        # converts them (grid.py:570-576); the host tier gets this X
        X = as_scipy_csr(X)
        X_arr = X if hasattr(X, "shape") else np.asarray(X)
        y_arr = None if y is None else np.asarray(y)
        cv = check_cv(self.cv, y_arr,
                      classifier=_is_classifier(self.estimator, family))
        splits = [(np.asarray(tr), np.asarray(te))
                  for tr, te in cv.split(X_arr, y_arr, groups=groups)]
        self.n_splits_ = len(splits)
        if hasattr(cv, "get_n_splits"):
            expected = cv.get_n_splits(X_arr, y_arr, groups=groups)
            if expected != self.n_splits_:
                raise ValueError(
                    "cv.split and cv.get_n_splits return inconsistent "
                    f"results. Expected {expected} splits, got "
                    f"{self.n_splits_}")
        self.chunks_: List[Dict[str, Any]] = []
        run = _Evaluation(self, X, X_arr, y, groups, fit_params, family,
                          config, splits)
        self._run_search(run.evaluate_candidates)
        if not run.params:
            raise ValueError(_NO_FITS)

        self.multimetric_ = _is_multimetric(run.names)
        if self.multimetric_:
            self._check_refit_for_multimetric(run.names)
        results = run.results
        self.cv_results_ = results
        self.scorer_ = run.scorer_attr
        refit_metric = (self.refit if self.multimetric_
                        and isinstance(self.refit, str) else "score")
        if self.refit or not self.multimetric_:
            self.best_index_ = self._select_best_index(
                self.refit, refit_metric, results)
            if not callable(self.refit):
                self.best_score_ = results[
                    f"mean_test_{refit_metric}"][self.best_index_]
            self.best_params_ = results["params"][self.best_index_]
        if self.refit:
            best = _clone(self.estimator).set_params(**self.best_params_)
            if isinstance(best, _Estimator) and best.device is None:
                best.set_params(device=str(run.device
                                           or resolve_device(config)))
            kw = {k: v for k, v in fit_params.items() if v is not None}
            t0 = time.perf_counter()
            if y is None:
                best.fit(X_arr, **kw)
            else:
                best.fit(X_arr, y_arr, **kw)
            self.refit_time_ = time.perf_counter() - t0
            self.best_estimator_ = best
            if hasattr(best, "classes_"):
                self.classes_ = best.classes_
        if len(getattr(X_arr, "shape", ())) == 2:
            self.n_features_in_ = X_arr.shape[1]
        return self

    # -- the host tier ------------------------------------------------------

    def _host_scorers(self, estimator):
        """(scorer for `_fit_and_score`, `scorer_`, names or None) as
        sklearn resolves `scoring`: a callable may return a scalar or a
        dict (names found from its results)."""
        from sklearn.metrics import check_scoring
        from sklearn.metrics._scorer import (
            _check_multimetric_scoring,
            _MultimetricScorer,
        )

        if callable(self.scoring):
            return self.scoring, self.scoring, None
        if self.scoring is None or isinstance(self.scoring, str):
            scorer = check_scoring(estimator, self.scoring)
            return scorer, scorer, ["score"]
        scorers = _check_multimetric_scoring(estimator, self.scoring)
        return (_MultimetricScorer(scorers=scorers,
                                   raise_exc=(self.error_score == "raise")),
                dict(scorers), list(scorers))

    def _host_score_params(self, scorer, sample_weight) -> Dict[str, Any]:
        """The scorers' `sample_weight`, as sklearn forwards it without
        metadata routing: to the scorers where any takes it, each that
        does not warned of."""
        from inspect import signature

        from sklearn.metrics._scorer import _MultimetricScorer

        if sample_weight is None:
            return {}
        if isinstance(scorer, _MultimetricScorer):
            for name, sc in scorer._scorers.items():
                if not sc._accept_sample_weight():
                    warnings.warn(
                        f"The scoring {name}={sc} does not support "
                        "sample_weight, which may lead to statistically "
                        f"incorrect results when fitting {self} with "
                        "sample_weight. ")
            accept = scorer._accept_sample_weight()
        elif hasattr(scorer, "_accept_sample_weight"):
            accept = scorer._accept_sample_weight()
        else:
            accept = "sample_weight" in signature(scorer).parameters
        if not accept:
            warnings.warn(
                f"The scoring {scorer} does not support sample_weight, "
                "which may lead to statistically incorrect results when "
                f"fitting {self} with sample_weight. ")
            return {}
        return {"sample_weight": sample_weight}

    def _fit_host(self, X, y, candidates, splits, fit_params, family,
                  config):
        """Every (candidate x fold) task by sklearn's `_fit_and_score`
        through joblib with `n_jobs` (the reference's `_fit_host`,
        grid.py:4292-4413).  The port's own estimators get the search's
        device where they name none."""
        try:
            from joblib import Parallel, delayed
            from sklearn.model_selection._validation import (
                _fit_and_score,
                _warn_or_raise_about_fit_failures,
            )
        except ImportError as exc:
            raise ImportError(
                f"{type(self).__name__}'s host tier runs scikit-learn's "
                "_fit_and_score through joblib: install scikit-learn, or "
                f"search an estimator the device tier runs ({exc})") from exc
        from inspect import signature

        base = _clone(self.estimator)
        if isinstance(base, _Estimator) and base.device is None:
            base.set_params(device=str(resolve_device(config)))
        scorer, scorer_attr, names = self._host_scorers(base)
        score_params = self._host_score_params(
            scorer, fit_params.get("sample_weight"))
        # sklearn's callback branch adds `caller`; stock releases reject
        # unknown keywords
        extra = ({"caller": self}
                 if "caller" in signature(_fit_and_score).parameters else {})
        n_folds = len(splits)
        tasks = [(ci, fi, params, train, test)
                 for ci, params in enumerate(candidates)
                 for fi, (train, test) in enumerate(splits)]

        def run(params, train, test):
            return _fit_and_score(
                _clone(base), X, y, scorer=scorer, train=train, test=test,
                verbose=self.verbose, parameters=params,
                fit_params=fit_params or None,
                score_params=score_params or None,
                return_train_score=self.return_train_score,
                return_times=True, error_score=self.error_score, **extra)

        results = Parallel(n_jobs=self.n_jobs)(
            delayed(run)(params, train, test)
            for _, _, params, train, test in tasks)
        _warn_or_raise_about_fit_failures(results, self.error_score)
        if names is None:
            # a callable scoring is multimetric where it returned a dict
            names = ["score"]
            for res in results:
                if isinstance(res["test_scores"], dict):
                    names = list(res["test_scores"])
                    break
        n_cand = len(candidates)
        test_scores = {s: np.empty((n_cand, n_folds)) for s in names}
        train_scores = ({s: np.empty((n_cand, n_folds)) for s in names}
                        if self.return_train_score else None)
        fit_times = np.empty((n_cand, n_folds))
        score_times = np.empty((n_cand, n_folds))
        for (ci, fi, _, _, _), res in zip(tasks, results):
            ts = res["test_scores"]
            if not isinstance(ts, dict):
                # one metric, or error_score for every metric
                ts = {s: ts for s in names}
            for s in names:
                test_scores[s][ci, fi] = ts.get(s, np.nan)
            if self.return_train_score:
                trs = res.get("train_scores", {})
                if not isinstance(trs, dict):
                    trs = {s: trs for s in names}
                for s in names:
                    train_scores[s][ci, fi] = trs.get(s, np.nan)
            fit_times[ci, fi] = res["fit_time"]
            score_times[ci, fi] = res["score_time"]
        return (test_scores, train_scores, fit_times, score_times, names,
                scorer_attr)

    # -- the device tier ----------------------------------------------------

    def _fit_compiled(self, family, X, y, candidates, splits, scorers,
                      config, device, fit_weight=None, score_weight=None):
        """Fit and score every (candidate x fold) task, chunk by chunk.
        Returns per-scorer (n_candidates, n_folds) test (and train)
        scores and the fit/score times per task.  `fit_weight` scales the
        fit masks and `score_weight` the scoring masks, as the reference
        carries sample_weight (grid.py:1298-1330); a scorer whose sklearn
        twin takes no weights keeps the unweighted masks.

        A family that sets `wants_float64` runs with float64 data, fold
        masks and dynamic parameters (the reference runs it under x64;
        its dynamic parameters are float32 arrays cast to float64, and
        so are these)."""
        use_f64 = bool(getattr(family, "wants_float64", False)) and \
            config.dtype is None
        dtype = np.float64 if use_f64 else np.float32
        # a scipy-sparse X reaches here only under data_mode="sparse"
        prepare = (family.prepare_data_sparse if issparse(X)
                   else family.prepare_data)
        data_np, meta = prepare(X, y, dtype=dtype)
        if self.scoring is not None and "y" not in data_np:
            # the reference's refusal (grid.py:1252-1258)
            raise ValueError(
                f"scoring={self.scoring!r} needs labels, but none reached "
                f"the device ({family.name} is unsupervised: y was absent "
                "or not numeric; only its default scorer applies)")
        check_scoring_target(self.scoring, family, meta)
        meta["logloss_clip_eps"] = _logloss_clip_eps(family, X.dtype)
        n_samples = X.shape[0]
        train_masks, test_masks = build_fold_masks(splits, n_samples,
                                                   dtype=dtype)
        # for the families whose validity depends on the folds (KNN's
        # n_neighbors <= the smallest train fold), as the reference
        # records it (grid.py:1289-1293)
        meta["min_fold_train_count"] = int(
            np.sum(train_masks > 0, axis=1).min())
        data = {k: to_device(v, device) for k, v in data_np.items()}

        def weighted(masks, weight, what):
            if weight is None:
                return masks
            w = np.asarray(weight, dtype=dtype)
            if w.shape != (n_samples,):
                raise ValueError(f"{what} has shape {w.shape}, expected "
                                 f"({n_samples},)")
            return masks * w[None, :]

        train_dev = torch.as_tensor(
            weighted(train_masks, fit_weight, "sample_weight"),
            device=device)
        # each scorer's (test, train) scoring masks: weighted, but for a
        # scorer whose sklearn twin takes no weights
        pairs = {}

        def scoring_masks(sw):
            key = sw is None
            if key not in pairs:
                pairs[key] = tuple(
                    torch.as_tensor(weighted(m, sw, "scorer sample_weight"),
                                    device=device)
                    for m in (test_masks, train_masks))
            return pairs[key]

        sc_masks = {s: scoring_masks(
            None if _metric(self.scoring, s) in SAMPLE_WEIGHT_BLIND
            else score_weight) for s in scorers}
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
        # a halving rung's chunks carry its namespace ("r1:0:0:24")
        rung = ownership.current_owner(self, kind="rung")
        cid_ns = f"{rung.ns}:" if rung is not None else ""

        base_params = family.extract_params(self.estimator)
        if hasattr(family, "observe_candidates"):
            # the tree families read the grid's largest n_estimators (the
            # trees a chunk may grow) and warn once on capped depths, as
            # the reference does (grid.py:1357-1361); the others check
            # their grid host-side (priors, n_neighbors, min_categories)
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
        for gi, group in enumerate(groups):
            static = {**base_params, **group.static_params,
                      "__n_folds__": n_folds,
                      "__bf16__": bool(config.bf16_matmul)}
            nc = group.n_candidates
            width = max(1, min(nc, max_tasks // n_folds))
            lanes = width * n_folds
            fold_idx = torch.arange(lanes, device=device) % n_folds
            w_fit = train_dev[fold_idx]                       # (lanes, n)
            w_sc = {s: (te[fold_idx], tr[fold_idx])
                    for s, (te, tr) in sc_masks.items()}
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
                y_dev = data.get("y")
                te = {s: sc.core(views, y_dev, w_sc[s][0], meta)
                      for s, sc in scorers.items()}
                tr = ({s: sc.core(views, y_dev, w_sc[s][1], meta)
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
                if self.verbose > 1:
                    self._print_task_end_lines(
                        candidates, idx, n_folds, list(scorers),
                        test_scores, train_scores, fit_failed,
                        fit_times[idx[0], 0] + score_times[idx[0], 0])
                chunk = {"id": f"{cid_ns}{gi}:{lo}:{hi}",
                         "candidates": (int(lo), int(hi)), "lanes": lanes,
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

    def _print_task_end_lines(self, candidates, idx, n_folds, scorer_names,
                              test_scores, train_scores, fit_failed,
                              t_task):
        """sklearn's `_fit_and_score` "[CV i/n] END ..." line for each
        task of a chunk once it has run (the reference's, grid.py:
        4237-4287): a failed fit prints error_score."""
        err = self.error_score if not isinstance(self.error_score, str) \
            else np.nan
        return_train = self.return_train_score

        def cell(scores, gidx, f):
            return err if fit_failed[gidx, f] else scores[gidx, f]

        for gidx in idx:
            params = candidates[gidx]
            params_msg = ", ".join(f"{k}={params[k]}"
                                   for k in sorted(params))
            for f in range(n_folds):
                progress_msg = (f" {f + 1}/{n_folds}"
                                if self.verbose > 2 else "")
                result_msg = params_msg + (";" if params_msg else "")
                if self.verbose > 2 and len(scorer_names) > 1:
                    for s in sorted(scorer_names):
                        result_msg += f" {s}: ("
                        if return_train:
                            result_msg += (
                                f"train={cell(train_scores[s], gidx, f):.3f}"
                                ", ")
                        result_msg += \
                            f"test={cell(test_scores[s], gidx, f):.3f})"
                elif self.verbose > 2:
                    s = scorer_names[0]
                    result_msg += ", score="
                    if return_train:
                        result_msg += (
                            f"(train={cell(train_scores[s], gidx, f):.3f}, "
                            f"test={cell(test_scores[s], gidx, f):.3f})")
                    else:
                        result_msg += f"{cell(test_scores[s], gidx, f):.3f}"
                result_msg += f" total time={short_format_time(t_task)}"
                end_msg = f"[CV{progress_msg}] END "
                end_msg += "." * max(0, 80 - len(end_msg) - len(result_msg))
                print(end_msg + result_msg)

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
                        fit_times, score_times, scorer_names,
                        more_results=None):
        from scipy.stats import rankdata

        n_candidates = len(candidates)
        # a halving rung's extra columns come first, as arrays (sklearn's
        # layout: `results = dict(more_results or {})`)
        results: Dict[str, Any] = {
            k: np.asarray(v) for k, v in (more_results or {}).items()}

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

    # -- after refit (delegates to the refit estimator) --------------------

    predict = _Delegated("predict")
    predict_proba = _Delegated("predict_proba")
    predict_log_proba = _Delegated("predict_log_proba")
    decision_function = _Delegated("decision_function")
    score_samples = _Delegated("score_samples")
    transform = _Delegated("transform")
    inverse_transform = _Delegated("inverse_transform")

    def score(self, X, y=None):
        """The refit metric's scorer (`scorer_`) on `best_estimator_`, as
        sklearn's `BaseSearchCV.score`."""
        _check_refit(self, "score")
        if not hasattr(self, "best_estimator_"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet; "
                "call fit() first.")
        if isinstance(self.scorer_, dict):
            if isinstance(self.refit, str):
                return self.scorer_[self.refit](self.best_estimator_, X, y)
            return self.best_estimator_.score(X, y)
        return self.scorer_(self.best_estimator_, X, y)


class GridSearchCV(_BaseSearch):
    """Exhaustive search over `param_grid` (a dict or list of dicts of
    value lists) with cross-validation; see `_BaseSearch`."""

    def __init__(self, estimator, param_grid, *, scoring=None, n_jobs=None,
                 refit=True, cv=None, verbose=0, error_score=np.nan,
                 return_train_score=False, backend=None,
                 config: Optional[TorchConfig] = None):
        super().__init__(estimator, scoring=scoring, n_jobs=n_jobs,
                         refit=refit, cv=cv, verbose=verbose,
                         error_score=error_score,
                         return_train_score=return_train_score,
                         backend=backend, config=config)
        self.param_grid = param_grid

    def _get_candidates(self):
        return list(ParameterGrid(self.param_grid))


class RandomizedSearchCV(_BaseSearch):
    """Search over `n_iter` candidates drawn from `param_distributions`
    by the port's `ParameterSampler` (the candidates sklearn's draws from
    the same `random_state`); see `_BaseSearch`."""

    def __init__(self, estimator, param_distributions, *, n_iter=10,
                 scoring=None, n_jobs=None, refit=True, cv=None, verbose=0,
                 random_state=None, error_score=np.nan,
                 return_train_score=False, backend=None,
                 config: Optional[TorchConfig] = None):
        super().__init__(estimator, scoring=scoring, n_jobs=n_jobs,
                         refit=refit, cv=cv, verbose=verbose,
                         error_score=error_score,
                         return_train_score=return_train_score,
                         backend=backend, config=config)
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state

    def _get_candidates(self):
        return list(ParameterSampler(self.param_distributions, self.n_iter,
                                     random_state=self.random_state))
