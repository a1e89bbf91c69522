"""Estimator family protocol and registry.

Counterpart of `spark_sklearn_tpu/models/base.py`.  Each supported
estimator *family* re-expresses fit/predict/score as functions on tensors
with a lane axis for the (candidate x fold) tasks:

    fit_task_batched(dynamic, static, data, train_w, meta) -> model dict
    views_task_batched(models, static, data, meta, needed) -> scorer views

- `data`:    dict of device tensors (X, y, ...); X is a sparse
             `CSROperand` for a family with `supports_sparse` under
             `data_mode="sparse"`
- `dynamic`: dict of (B,) tensors of numeric hyperparameters (C, tol)
- `static`:  dict of hyperparameters shared by the lanes (penalty, ...)
- `train_w`: (B, n) per-sample weight masks (one CV fold per lane)
- `meta`:    host-side data facts (n_classes, classes, ...)

The registry maps estimator classes to a family by qualified class name,
so an sklearn `LogisticRegression` instance resolves to the compiled path
without sklearn being imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

import numpy as np
import torch

_FAMILIES_BY_CLASSNAME: Dict[str, Any] = {}
#: Pipeline classes: each instance gets a family of its own
#: (`models/pipeline.py` `make_pipeline_family`)
_PIPELINES = ("sklearn.pipeline.Pipeline",
              "spark_sklearn_tpu_torch.models.estimators.Pipeline")


def register_family(family, *qualified_names: str):
    """Register a family under fully-qualified estimator class names
    (e.g. "sklearn.linear_model._logistic.LogisticRegression")."""
    for qn in qualified_names:
        _FAMILIES_BY_CLASSNAME[qn] = family
    return family


def _qualname(cls: Type) -> str:
    return f"{cls.__module__}.{cls.__name__}"


def resolve_family(estimator) -> Optional[Any]:
    """The family for an estimator instance, or None.

    A Pipeline (sklearn's or the port's) gets a family built for it, or
    None when a step has no counterpart.  Otherwise matching is by
    qualified class name, then — for sklearn classes only — by bare class
    name, robust to sklearn's private-module shuffling.  A
    third-party class that happens to be named "LogisticRegression" does
    not get the compiled fit.
    """
    cls = type(estimator)
    qn = _qualname(cls)
    if qn in _PIPELINES:
        from spark_sklearn_tpu_torch.models.pipeline import (
            make_pipeline_family,
        )
        return make_pipeline_family(estimator)
    if qn in _FAMILIES_BY_CLASSNAME:
        return _FAMILIES_BY_CLASSNAME[qn]
    if qn.startswith("sklearn."):
        for known, fam in _FAMILIES_BY_CLASSNAME.items():
            if known.startswith("sklearn.") and \
                    known.split(".")[-1] == cls.__name__:
                return fam
    return None


class Family:
    """Base class for families (documentation of the protocol)."""

    name: str = "base"
    #: dynamic (lane-batchable) hyperparameter names -> numpy dtype
    dynamic_params: Dict[str, Any] = {}
    #: True for classifiers (label-encode y, default scorer = accuracy)
    is_classifier: bool = False
    #: True where fit and the views take data["X"] as a sparse device
    #: operand (`sparse/csr.py` CSROperand: products in operator form
    #: through SP1, no dense-only op on X) and the family implements
    #: `prepare_data_sparse`: the `data_mode="sparse"` tier reads it
    supports_sparse: bool = False

    @classmethod
    def extract_params(cls, estimator) -> Dict[str, Any]:
        """estimator instance -> full param dict (host)."""
        return dict(estimator.get_params(deep=False))

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        """-> (data: dict of numpy arrays for the device, meta: dict of
        host facts).  Called once per search."""
        raise NotImplementedError

    @classmethod
    def prepare_data_sparse(cls, X, y, dtype=np.float32):
        """Sparse twin of `prepare_data`: `X` is a scipy CSR matrix, and
        the data dict carries it as a `sparse.csr.SparseOperand` under
        "X" (the search uploads it as a CSROperand).  Host-side input
        checks (finiteness, sign) run on `X.data`, never on a densified
        form.  Only meaningful with `supports_sparse`."""
        raise NotImplementedError(
            f"{cls.name} takes no sparse X (supports_sparse is False)")

    @classmethod
    def takes_sparse(cls, static) -> bool:
        """Whether a fit with these static parameters keeps a sparse X
        sparse: `supports_sparse`, unless a parameter needs the implicit
        zeros (BernoulliNB's binarize < 0).  The estimators densify X
        where it is False."""
        return cls.supports_sparse

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        raise NotImplementedError

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        raise NotImplementedError

    @classmethod
    def decision(cls, model, static, X, meta):
        raise NotImplementedError

    @classmethod
    def sklearn_attrs(cls, model, static, meta) -> Dict[str, Any]:
        """Fitted-attribute dict (coef_, intercept_, classes_...)."""
        raise NotImplementedError


def encode_labels(y):
    """Host-side label encoding shared by all classifier families."""
    classes, y_enc = np.unique(y, return_inverse=True)
    return classes, y_enc.astype(np.int32)


def class_weight_multiplier(mask, y_enc, meta, class_weight):
    """Per-sample weight multipliers for `class_weight`.

    mask: (..., n) fold-mask tensor; y_enc: (n,) encoded labels tensor.
    Returns a same-shape multiplier, or None for no class weighting.

    - dict {label: weight}: fold-independent lookup.
    - "balanced": sklearn's n_train / (n_classes * bincount(y_train)),
      computed per fold from the mask's support (mask > 0).
    """
    if class_weight is None:
        return None
    k = meta["n_classes"]
    y1h = torch.nn.functional.one_hot(y_enc.long(), k).to(mask.dtype)
    if isinstance(class_weight, str):
        if class_weight != "balanced":
            raise ValueError(
                f"class_weight={class_weight!r} is not supported")
        ind = (mask > 0).to(mask.dtype)                      # (..., n)
        cnt = ind @ y1h                                      # (..., k)
        n_eff = ind.sum(dim=-1, keepdim=True)                # (..., 1)
        per_class = n_eff / (k * torch.clamp_min(cnt, 1.0))  # (..., k)
        return per_class @ y1h.T                             # (..., n)
    if isinstance(class_weight, dict):
        classes = list(meta["classes"])
        cw = np.ones(k, np.float64)
        for label, weight in class_weight.items():
            hits = [i for i, c in enumerate(classes) if c == label]
            if not hits:
                raise ValueError(
                    f"class_weight key {label!r} is not a class label")
            cw[hits[0]] = weight
        arr = torch.as_tensor(cw, dtype=mask.dtype, device=mask.device)
        return arr[y_enc.long()].expand(mask.shape)
    raise ValueError(f"class_weight={class_weight!r} is not supported")


def apply_class_weight(mask, y_enc, meta, class_weight):
    """mask with `class_weight` multiplied in (identity when None)."""
    mult = class_weight_multiplier(mask, y_enc, meta, class_weight)
    return mask if mult is None else mask * mult
