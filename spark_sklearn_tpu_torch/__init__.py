"""spark_sklearn_tpu_torch — the PyTorch/CUDA port of spark_sklearn_tpu.

The JAX package `spark_sklearn_tpu` stays the reference; this package
runs the same searches with PyTorch on an NVIDIA H100 (``sm_90a``), with
the hot elementwise passes as hand-written CUDA kernels (``csrc/``).  It
imports neither JAX nor the JAX package, and needs no scikit-learn:
sklearn estimators and splitters are accepted where sklearn is installed.

Entry points run on ``cuda`` unless the caller passes
``TorchConfig(device="cpu")``.

Public API of this slice:
  - GridSearchCV        (compiled LogisticRegression search)
  - TorchConfig
  - LogisticRegression  (sklearn-free estimator)
  - StratifiedKFold, KFold
"""

from spark_sklearn_tpu_torch.models.estimators import LogisticRegression
from spark_sklearn_tpu_torch.parallel.device import TorchConfig
from spark_sklearn_tpu_torch.search.cv import KFold, StratifiedKFold
from spark_sklearn_tpu_torch.search.grid import GridSearchCV

__all__ = [
    "GridSearchCV",
    "TorchConfig",
    "LogisticRegression",
    "StratifiedKFold",
    "KFold",
]
