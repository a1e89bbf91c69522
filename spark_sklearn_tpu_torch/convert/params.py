"""Carry fitted models between the JAX package and the port.

The JAX family's model dict, as numpy arrays (`coef` (T, k, d),
`intercept` (T, k), `n_iter`, `converged`, ...), becomes the port's
tensors with `params_from_jax`; going back is ``t.cpu().numpy()`` per
entry.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on `device`}; floating arrays become
    float32, integer and bool arrays keep their kind."""
    out = {}
    for name, value in tree.items():
        arr = np.asarray(value)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        out[name] = torch.tensor(arr, device=device)
    return out
