"""Carry fitted models between the JAX package and the port.

The JAX family's model dict, as numpy arrays (logistic regression:
`coef` (T, k, d), `intercept` (T, k), `n_iter`, `converged`, ...;
regressors: `coef` (T, d), `intercept` (T,)), becomes the port's tensors
with `params_from_jax`; going back is ``t.cpu().numpy()`` per entry.

A fitted standalone SVC of the JAX package (`models/standalone.py`:
training X `_X_train`, signed alphas `_alphas` (P, n), `_intercepts` (P,)
and `classes_`) becomes the port's `SVC` with `svc_from_jax`.

A tree grown by the JAX package's histogram grower (`ops/trees.py`
`Tree`) becomes the port's, lane axis and all, with `tree_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on `device`}, each keeping its
    dtype: the JAX package fits Ridge and LinearRegression in float64 and
    the other families in float32."""
    return {name: torch.tensor(np.asarray(value), device=device)
            for name, value in tree.items()}


def svc_from_jax(est, device=None):
    """The port's fitted `SVC` carrying a fitted JAX standalone SVC's
    representer form and hyperparameters; it predicts what `est` does.
    `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.models.estimators import SVC
    from spark_sklearn_tpu_torch.models.svm import _pairs
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    params = est.get_params(deep=False)
    svc = SVC(**{k: params[k] for k in SVC._param_names() if k in params},
              device=device)
    dev = resolve_device(TorchConfig(device=device))
    X = np.asarray(est._X_train, np.float32)
    classes = np.asarray(est.classes_)
    # the facts prepare_data derives from the training data (gamma="scale"
    # reads its variance)
    meta = {"n_classes": len(classes), "classes": classes,
            "n_features": int(X.shape[1]), "x_var": float(np.var(X)),
            "pairs": _pairs(len(classes))}
    model = {name: torch.as_tensor(np.array(value, np.float32), device=dev)
             for name, value in (("sv_X", X), ("alphas", est._alphas),
                                 ("intercepts", est._intercepts))}
    return svc._set_fitted(model, meta, dev)


def tree_from_jax(tree, device=None):
    """The port's `Tree` (ops/trees.py) from a JAX package `Tree`
    (spark_sklearn_tpu/ops/trees.py: feat, thresh, value, is_leaf as jax
    or numpy arrays), one tree (M,) or a stack (L, M); the port's always
    has the lane axis.  `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.ops.trees import Tree
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))
    feat = np.asarray(tree.feat, np.int32)
    lanes = feat.ndim == 1

    def conv(a, dtype):
        a = np.array(a, dtype)
        return torch.as_tensor(a[None] if lanes else a, device=dev)

    return Tree(feat=conv(tree.feat, np.int32),
                thresh=conv(tree.thresh, np.int32),
                value=conv(tree.value, np.float32),
                is_leaf=conv(tree.is_leaf, np.bool_))
