"""Candidate grids, candidate samplers and CV splitters without
scikit-learn.

The card's machine has no sklearn, so the port carries its own
`ParameterGrid`, `ParameterSampler`, `KFold`, `StratifiedKFold` and
`check_cv`.  Each gives the same candidates and folds as sklearn 1.9's
class of the same name (splitters without shuffling; the sampler draws
the same numbers from the same `random_state`).  Successive halving's
helpers are copies of sklearn 1.9's too, equal in what they return:
`_SubsampleMetaSplitter` and `_top_k` (`model_selection/
_search_successive_halving.py:23-62`), `_yields_constant_splits`
(`model_selection/_split.py:3071-3079`), `_num_samples` and
`check_classification_targets`.  `cv` may also be any
object with ``.split(X, y)`` — an sklearn splitter where sklearn is
installed — or an iterable of (train, test) index pairs.
"""

from __future__ import annotations

import itertools
import numbers
import warnings
from collections.abc import Iterable
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple, Union

import numpy as np


class ParameterGrid:
    """Cartesian product of a dict (or list of dicts) of value lists, in
    sklearn's order: keys sorted, values by `itertools.product`."""

    def __init__(self, param_grid: Union[Mapping, Sequence[Mapping]]):
        if isinstance(param_grid, Mapping):
            param_grid = [param_grid]
        for grid in param_grid:
            if not isinstance(grid, Mapping):
                raise TypeError(f"Parameter grid is not a dict ({grid!r})")
            for key, value in grid.items():
                if isinstance(value, np.ndarray) and value.ndim > 1:
                    raise ValueError(
                        f"Parameter array for {key!r} should be "
                        f"one-dimensional, got: {value!r} with shape "
                        f"{value.shape}")
                if isinstance(value, str) or not hasattr(value, "__iter__"):
                    raise TypeError(
                        f"Parameter grid for parameter {key!r} needs to be "
                        f"a list or a numpy array, but got {value!r}")
                if len(value) == 0:
                    raise ValueError(
                        f"Parameter grid for parameter {key!r} need to be "
                        f"a non-empty sequence, got: {value!r}")
        self.param_grid = list(param_grid)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for p in self.param_grid:
            items = sorted(p.items())
            if not items:
                yield {}
            else:
                keys, values = zip(*items)
                for v in itertools.product(*values):
                    yield dict(zip(keys, v))

    def __len__(self) -> int:
        return sum(int(np.prod([len(v) for v in p.values()])) if p else 1
                   for p in self.param_grid)

    def __getitem__(self, ind: int) -> Dict[str, Any]:
        """``list(self)[ind]`` without building the list (sklearn's
        mixed-radix decoding, last sorted key cycling fastest)."""
        for sub_grid in self.param_grid:
            if not sub_grid:
                if ind == 0:
                    return {}
                ind -= 1
                continue
            keys, values_lists = zip(*sorted(sub_grid.items())[::-1])
            sizes = [len(v_list) for v_list in values_lists]
            total = np.prod(sizes)
            if ind >= total:
                ind -= total
            else:
                out = {}
                for key, v_list, n in zip(keys, values_lists, sizes):
                    ind, offset = divmod(ind, n)
                    out[key] = v_list[offset]
                return out
        raise IndexError("ParameterGrid index out of range")


def check_random_state(seed) -> np.random.RandomState:
    """sklearn's `check_random_state`: None -> numpy's global
    RandomState, an int -> a new RandomState, a RandomState -> itself."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(
        f"{seed!r} cannot be used to seed a numpy.random.RandomState "
        "instance")


def sample_without_replacement(n_population: int, n_samples: int,
                               random_state=None) -> np.ndarray:
    """`n_samples` distinct integers of [0, n_population), drawing the
    same numbers as sklearn's `sample_without_replacement` with
    method="auto" (`sklearn/utils/_random.pyx`): a permutation where
    0.01 < n_samples / n_population < 0.99, else tracking selection
    (ratio < 0.2) or reservoir sampling."""
    if n_population < 0:
        raise ValueError(
            f"n_population should be greater than 0, got {n_population}.")
    if n_samples > n_population:
        raise ValueError(
            "n_population should be greater or equal than n_samples, got "
            f"n_samples > n_population ({n_samples} > {n_population})")
    rng = check_random_state(random_state)
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, dtype=int)
    if ratio < 0.2:                                   # tracking selection
        selected = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
        return out
    out[:] = np.arange(n_samples)                     # reservoir sampling
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


class ParameterSampler:
    """`n_iter` candidates drawn from `param_distributions` (a dict or a
    list of dicts of value lists or objects with ``rvs``), as sklearn's
    `ParameterSampler`: all lists -> sampling without replacement from
    the grid; otherwise, per candidate, a dict by ``rng.choice``, then
    its keys in sorted order, each by ``v.rvs(random_state=rng)`` or
    ``v[rng.randint(len(v))]``."""

    def __init__(self, param_distributions, n_iter: int, *,
                 random_state=None):
        if not isinstance(param_distributions, (Mapping, Iterable)):
            raise TypeError(
                "Parameter distribution is not a dict or a list, got: "
                f"{param_distributions!r} of type "
                f"{type(param_distributions).__name__}")
        if isinstance(param_distributions, Mapping):
            param_distributions = [param_distributions]
        for dist in param_distributions:
            if not isinstance(dist, dict):
                raise TypeError(
                    f"Parameter distribution is not a dict ({dist!r})")
            for key in dist:
                if not isinstance(dist[key], Iterable) and \
                        not hasattr(dist[key], "rvs"):
                    raise TypeError(
                        f"Parameter grid for parameter {key!r} is not "
                        f"iterable or a distribution (value={dist[key]})")
        self.n_iter = n_iter
        self.random_state = random_state
        self.param_distributions = param_distributions

    def _is_all_lists(self) -> bool:
        return all(not hasattr(v, "rvs")
                   for dist in self.param_distributions
                   for v in dist.values())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = check_random_state(self.random_state)
        if self._is_all_lists():
            param_grid = ParameterGrid(self.param_distributions)
            grid_size = len(param_grid)
            n_iter = self.n_iter
            if grid_size < n_iter:
                warnings.warn(
                    f"The total space of parameters {grid_size} is smaller "
                    f"than n_iter={self.n_iter}. Running {grid_size} "
                    "iterations. For exhaustive searches, use "
                    "GridSearchCV.", UserWarning)
                n_iter = grid_size
            for i in sample_without_replacement(grid_size, n_iter,
                                                random_state=rng):
                yield param_grid[i]
            return
        for _ in range(self.n_iter):
            dist = rng.choice(self.param_distributions)
            params = {}
            for k, v in sorted(dist.items()):
                if hasattr(v, "rvs"):
                    params[k] = v.rvs(random_state=rng)
                else:
                    params[k] = v[rng.randint(len(v))]
            yield params

    def __len__(self) -> int:
        if self._is_all_lists():
            return min(self.n_iter,
                       len(ParameterGrid(self.param_distributions)))
        return self.n_iter


def _target_type(y) -> str:
    """"binary", "multiclass" or "continuous" — the part of sklearn's
    `type_of_target` that `check_cv` and `StratifiedKFold` read."""
    y = np.asarray(y)
    if y.ndim != 1:
        return "unknown"
    if y.dtype.kind == "f" and np.any(y != y.astype(np.int64)):
        return "continuous"
    return "binary" if np.unique(y).size <= 2 else "multiclass"


class KFold:
    """K folds of consecutive samples, without shuffling."""

    def __init__(self, n_splits: int = 5):
        if int(n_splits) < 2:
            raise ValueError(
                f"k-fold cross-validation requires at least one "
                f"train/test split by setting n_splits=2 or more, got "
                f"n_splits={n_splits}.")
        self.n_splits = int(n_splits)

    def get_n_splits(self, X=None, y=None, groups=None) -> int:
        return self.n_splits

    def _test_folds(self, X, y) -> np.ndarray:
        n = _num_samples(X)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        return np.repeat(np.arange(self.n_splits), sizes)

    def split(self, X, y=None, groups=None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        # X.shape[0] where X has a shape: a scipy-sparse X has no len
        n = _num_samples(X)
        if self.n_splits > n:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of samples: n_samples={n}.")
        folds = self._test_folds(X, y)
        indices = np.arange(n)
        for i in range(self.n_splits):
            test = folds == i
            yield indices[~test], indices[test]


class StratifiedKFold(KFold):
    """Folds that keep each class's share, without shuffling: sklearn's
    round-robin allocation over the sorted labels, with each class's
    samples assigned to folds in blocks in order of appearance."""

    def _test_folds(self, X, y) -> np.ndarray:
        y = np.asarray(y)
        if _target_type(y) not in ("binary", "multiclass"):
            raise ValueError(
                "Supported target types are: ('binary', 'multiclass'). "
                f"Got {_target_type(y)!r} instead.")
        _, y_idx, y_inv = np.unique(y, return_index=True,
                                    return_inverse=True)
        # encode classes by order of first appearance
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv.ravel()]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(
                f"n_splits={self.n_splits} cannot be greater than the "
                "number of members in each class.")
        if self.n_splits > np.min(y_counts):
            warnings.warn(
                f"The least populated class in y has only "
                f"{np.min(y_counts)} members, which is less than "
                f"n_splits={self.n_splits}.", UserWarning)
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i::self.n_splits], minlength=n_classes)
             for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            test_folds[y_encoded == k] = np.arange(
                self.n_splits).repeat(allocation[:, k])
        return test_folds


class _SplitList:
    """An iterable of (train, test) pairs seen as a splitter."""

    def __init__(self, cv):
        self.splits = [(np.asarray(tr), np.asarray(te)) for tr, te in cv]

    def get_n_splits(self, X=None, y=None, groups=None) -> int:
        return len(self.splits)

    def split(self, X=None, y=None, groups=None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        yield from self.splits


def check_cv(cv=5, y=None, *, classifier: bool = False):
    """sklearn's `check_cv` without shuffling: None or an int gives
    `StratifiedKFold` for a binary/multiclass classifier target, else
    `KFold`; an object with `.split` passes through; an iterable of
    splits is wrapped."""
    cv = 5 if cv is None else cv
    if isinstance(cv, numbers.Integral):
        if classifier and y is not None and \
                _target_type(y) in ("binary", "multiclass"):
            return StratifiedKFold(cv)
        return KFold(cv)
    if hasattr(cv, "split") and not isinstance(cv, str):
        return cv
    if isinstance(cv, str) or not hasattr(cv, "__iter__"):
        raise ValueError(
            "Expected `cv` as an integer, a cross-validation object, or "
            f"an iterable yielding (train, test) splits. Got {cv}.")
    return _SplitList(cv)


# ---------------------------------------------------------------------------
# successive halving's helpers (sklearn 1.9)
# ---------------------------------------------------------------------------

def _num_samples(x) -> int:
    """The number of samples in array-like `x`, as sklearn's
    `utils.validation._num_samples` counts them."""
    message = f"Expected sequence or array-like, got {type(x)}"
    if hasattr(x, "fit") and callable(x.fit):
        # not an ensemble's length
        raise TypeError(message)
    if hasattr(x, "shape") and x.shape is not None:
        if len(x.shape) == 0:
            raise TypeError(
                "Input should have at least 1 dimension i.e. satisfy "
                f"`len(x.shape) > 0`, got scalar `{x!r}` instead.")
        if isinstance(x.shape[0], numbers.Integral):
            return x.shape[0]
    if not hasattr(x, "__len__") and not hasattr(x, "shape"):
        if hasattr(x, "__array__"):
            x = np.asarray(x)
        else:
            raise TypeError(message)
    try:
        return len(x)
    except TypeError as type_error:
        raise TypeError(message) from type_error


def check_classification_targets(y) -> None:
    """sklearn's `check_classification_targets`: raise on a continuous
    target, and warn where a multiclass target has more distinct values
    than half its (over 20) samples."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] > 1:
        kind = ("continuous-multioutput" if y.dtype.kind == "f" and np.any(
            y != y.astype(np.int64)) else "multiclass-multioutput")
    else:
        kind = _target_type(y.ravel())
    if kind.startswith("continuous"):
        raise ValueError(
            f"Unknown label type: {kind}. Maybe you are trying to fit a "
            "classifier, which expects discrete classes on a regression "
            "target with continuous values.")
    if "multiclass" in kind:
        n_samples = _num_samples(y)
        if n_samples > 20 and np.unique(y).shape[0] > round(0.5 * n_samples):
            warnings.warn(
                "The number of unique classes is greater than 50% of the "
                "number of samples. `y` could represent a regression "
                "problem, not a classification problem.", UserWarning,
                stacklevel=2)


def _yields_constant_splits(cv) -> bool:
    """True where calling `cv.split` always gives the same splits: a cv
    without a shuffle parameter is assumed to shuffle, and one without a
    random_state to have random_state 0 (sklearn's rule)."""
    shuffle = getattr(cv, "shuffle", True)
    random_state = getattr(cv, "random_state", 0)
    return isinstance(random_state, numbers.Integral) or not shuffle


def _resample_without_replacement(indices, n_samples: int, random_state):
    """sklearn's `utils.resample(indices, replace=False, n_samples=...,
    random_state=...)`: arange, shuffle by `check_random_state`, the
    first `n_samples` (`utils/_indexing.py:572-575`)."""
    indices = np.asarray(indices)
    if n_samples < 1:
        # sklearn's parameter validation of `resample`
        raise ValueError(
            "The 'n_samples' parameter of resample must be an int in the "
            f"range [1, inf) or None. Got {n_samples} instead.")
    if n_samples > indices.shape[0]:
        raise ValueError(
            f"Cannot sample {n_samples} out of arrays with dim "
            f"{indices.shape[0]} when replace is False")
    rng = check_random_state(random_state)
    order = np.arange(indices.shape[0])
    rng.shuffle(order)
    return indices[order[:n_samples]]


class _SubsampleMetaSplitter:
    """A splitter that subsamples a fraction of each of `base_cv`'s train
    (and, with `subsample_test`, test) folds.  With an int random_state
    every subsample starts a fresh RandomState of that seed."""

    def __init__(self, *, base_cv, fraction, subsample_test, random_state):
        self.base_cv = base_cv
        self.fraction = fraction
        self.subsample_test = subsample_test
        self.random_state = random_state

    def split(self, X, y, **kwargs):
        for train_idx, test_idx in self.base_cv.split(X, y, **kwargs):
            train_idx = _resample_without_replacement(
                train_idx, int(self.fraction * len(train_idx)),
                self.random_state)
            if self.subsample_test:
                test_idx = _resample_without_replacement(
                    test_idx, int(self.fraction * len(test_idx)),
                    self.random_state)
            yield train_idx, test_idx


def _top_k(results, k: int, itr: int):
    """The best `k` candidates of iteration `itr`, in ascending order of
    mean test score: numpy's argsort puts NaNs last, and the roll moves
    them to the front so that the last k are the highest scores."""
    iteration, mean_test_score, params = (
        np.asarray(a) for a in (results["iter"], results["mean_test_score"],
                                results["params"]))
    iter_indices = np.flatnonzero(iteration == itr)
    scores = mean_test_score[iter_indices]
    sorted_indices = np.roll(np.argsort(scores),
                             np.count_nonzero(np.isnan(scores)))
    return np.array(params[iter_indices][sorted_indices[-k:]])
