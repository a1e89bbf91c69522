"""Candidate grids and CV splitters without scikit-learn.

The card's machine has no sklearn, so the port carries its own
`ParameterGrid`, `KFold`, `StratifiedKFold` and `check_cv`.  Each gives
the same candidates and folds as sklearn 1.9's class of the same name
(without shuffling).  `cv` may also be any object with
``.split(X, y)`` — an sklearn splitter where sklearn is installed — or an
iterable of (train, test) index pairs.
"""

from __future__ import annotations

import itertools
import numbers
import warnings
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
        n = len(X)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        return np.repeat(np.arange(self.n_splits), sizes)

    def split(self, X, y=None, groups=None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(X)
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
