"""Per-feature quantile binning, the host-side prep of the tree learners.

A copy of the numpy path of `spark_sklearn_tpu/utils/native.py:130-148`
(`quantile_bin`), which the reference takes wherever the native library
`native/libtpusk.so` is absent (the repository ships none): edges are
``np.quantile(X, linspace(0, 1, n_bins + 1)[1:-1], axis=0,
method="lower")`` and a value's code is the count of edges at or below it
(``searchsorted(side="right")``), so codes lie in [0, n_bins - 1].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantile_bin(X: np.ndarray, n_bins: int = 256
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(edges (d, n_bins - 1) float32, codes (n, d) uint8)."""
    if not 2 <= n_bins <= 256:
        raise ValueError(
            f"n_bins must be in [2, 256] (codes are uint8), got {n_bins}")
    X = np.ascontiguousarray(X, np.float32)
    n, d = X.shape
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.ascontiguousarray(
        np.quantile(X, qs, axis=0, method="lower").T.astype(np.float32))
    codes = np.empty((n, d), np.uint8)
    for f in range(d):
        codes[:, f] = np.searchsorted(edges[f], X[:, f], side="right")
    return edges, codes
