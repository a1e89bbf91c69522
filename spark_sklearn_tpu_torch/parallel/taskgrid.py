"""Lowering of the (ParameterGrid x KFold) task list onto arrays.

Host-side numpy, copied from `spark_sklearn_tpu/parallel/taskgrid.py`
(`CompileGroup`, `build_compile_groups`, `pad_chunk`, `split_range`,
`freeze`, `build_fold_masks`) without its tracer spans, so that the port
imports nothing of the JAX package:

  - candidate params split into a STATIC part (strings, bools,
    shape-determining ints) and a DYNAMIC part (numeric leaves that batch
    over the lane axis).  Candidates sharing a static signature form one
    **compile group**, fitted together lane by lane.
  - folds become fixed-shape **masks** (n_folds, n_samples): 1.0 where the
    sample is in the train (resp. test) split, so every fit is a weighted
    fit with the mask as sample weight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CompileGroup:
    """One statically-shaped batch of candidates: fitted as lanes of one
    batched solve."""

    static_params: Dict[str, Any]                # shared by every candidate
    dynamic_params: Dict[str, np.ndarray]        # each shape (n_candidates,)
    candidate_indices: np.ndarray                # (n_candidates,) into the
                                                 # original candidate order
    params_list: List[Dict[str, Any]]            # original dicts, group order

    @property
    def n_candidates(self) -> int:
        return len(self.candidate_indices)


def _is_dynamic_value(v: Any) -> bool:
    """A value can batch over lanes iff it is a real number that does not
    change the program.  Bools and ints used as sizes/switches are
    conservatively static unless the family says otherwise."""
    return isinstance(v, (float, np.floating)) and not isinstance(v, bool)


def build_compile_groups(
    candidate_params: Sequence[Mapping[str, Any]],
    dynamic_names: Optional[Sequence[str]] = None,
    dynamic_dtypes: Optional[Mapping[str, Any]] = None,
) -> List[CompileGroup]:
    """Partition candidates into compile groups by static signature.

    `dynamic_names`: param names the estimator family promises are pure
    numeric leaves of the fit (e.g. C, tol).  Anything else — and any
    dynamic-name whose value is non-numeric (e.g. C="auto") — is static
    for that candidate.
    """
    dynamic_names = set(dynamic_names or ())
    dynamic_dtypes = dict(dynamic_dtypes or {})
    groups: Dict[Tuple, Dict[str, Any]] = {}
    for idx, params in enumerate(candidate_params):
        static, dynamic = {}, {}
        for k, v in params.items():
            if k in dynamic_names and (
                _is_dynamic_value(v)
                or isinstance(v, (int, np.integer))
                and not isinstance(v, bool)
            ):
                dynamic[k] = v
            else:
                static[k] = v
        key = (
            tuple(sorted((k, _hashable(v)) for k, v in static.items())),
            tuple(sorted(dynamic)),
        )
        g = groups.setdefault(
            key, {"static": static, "dyn": {k: [] for k in dynamic},
                  "idx": [], "plist": []})
        for k, v in dynamic.items():
            g["dyn"][k].append(v)
        g["idx"].append(idx)
        g["plist"].append(dict(params))
    out = []
    for g in groups.values():
        dyn = {
            k: np.asarray(v, dtype=dynamic_dtypes.get(k, np.float32))
            for k, v in g["dyn"].items()
        }
        out.append(
            CompileGroup(
                static_params=g["static"],
                dynamic_params=dyn,
                candidate_indices=np.asarray(g["idx"], dtype=np.int64),
                params_list=g["plist"],
            )
        )
    # deterministic order: by first candidate index
    out.sort(key=lambda g: g.candidate_indices[0])
    return out


def pad_chunk(arr: np.ndarray, lo: int, hi: int, width: int,
              repeat: int = 1, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """Slice `arr[lo:hi]` and pad it to the chunk's uniform `width` by
    repeating the last row.  `repeat > 1` additionally repeats each row
    that many times (the task-batched layout's candidate-major fold
    axis).  Pass `out` — shaped ``(width * repeat,) + arr.shape[1:]`` —
    to reuse a caller-owned buffer."""
    n = hi - lo
    shape = (width * repeat,) + arr.shape[1:]
    if out is None:
        out = np.empty(shape, arr.dtype)
    elif out.shape != shape or out.dtype != arr.dtype:
        raise ValueError(
            f"pad_chunk out buffer has shape {out.shape}/{out.dtype}, "
            f"expected {shape}/{arr.dtype}")
    chunk = arr[lo:hi]
    if repeat == 1:
        out[:n] = chunk
    else:
        # candidate-major fold axis: row c lands at [c*repeat,
        # (c+1)*repeat) — identical to np.repeat(chunk, repeat, 0)
        out[:n * repeat].reshape((n, repeat) + arr.shape[1:])[:] = \
            chunk[:, None]
    if n < width:
        out[n * repeat:] = arr[hi - 1]
    return out


def split_range(lo: int, hi: int) -> Tuple[int, int, int]:
    """Bisect the candidate range [lo, hi): returns (lo, mid, hi) with
    both halves non-empty."""
    if hi - lo < 2:
        raise ValueError(f"range [{lo}, {hi}) cannot be bisected")
    return lo, lo + (hi - lo) // 2, hi


def freeze(v: Any, strict: bool = False):
    """Recursively hashable view of nested params/arrays (compile-group
    keying).  Object-dtype ndarrays hash by ELEMENT — ``tobytes()`` on
    them is raw PyObject pointers.  `strict=True` raises TypeError on an
    unhashable leaf instead of falling back to its repr."""
    if isinstance(v, dict):
        # key by (type, str) so {1: v} and {"1": v} freeze differently
        return tuple(sorted((type(k).__name__, str(k), freeze(x, strict))
                            for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("__seq__",) + tuple(freeze(x, strict) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("__set__",) + tuple(
            sorted((freeze(x, strict) for x in v), key=repr))
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return ("__ndo__", v.shape,
                    tuple(freeze(x, strict) for x in v.ravel().tolist()))
        return ("__nd__", v.shape, str(v.dtype), v.tobytes())
    try:
        hash(v)
        return v
    except TypeError:
        if strict:
            raise
        return repr(v)


def _hashable(v: Any):
    return freeze(v)


def build_fold_masks(
    cv_splits: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_samples: int,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) pairs -> dense (n_folds, n_samples) masks."""
    n_folds = len(cv_splits)
    train = np.zeros((n_folds, n_samples), dtype=dtype)
    test = np.zeros((n_folds, n_samples), dtype=dtype)
    for i, (tr, te) in enumerate(cv_splits):
        train[i, tr] = 1.0
        test[i, te] = 1.0
    return train, test
