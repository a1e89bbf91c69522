"""Carry fitted models between the JAX package and the port.

The JAX family's model dict, as numpy arrays (logistic regression:
`coef` (T, k, d), `intercept` (T, k), `n_iter`, `converged`, ...;
regressors: `coef` (T, d), `intercept` (T,)), becomes the port's tensors
with `params_from_jax`; going back is ``t.cpu().numpy()`` per entry.
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
