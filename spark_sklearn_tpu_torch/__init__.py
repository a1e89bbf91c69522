"""spark_sklearn_tpu_torch — the PyTorch/CUDA port of spark_sklearn_tpu.

The JAX package `spark_sklearn_tpu` stays the reference; this package
runs the same searches with PyTorch on an NVIDIA H100 (``sm_90a``), with
the hot elementwise passes as hand-written CUDA kernels (``csrc/``).  It
imports neither JAX nor the JAX package, and needs no scikit-learn:
sklearn estimators and splitters are accepted where sklearn is installed.

Entry points run on ``cuda`` unless the caller passes
``TorchConfig(device="cpu")``.

Public API so far:
  - GridSearchCV, RandomizedSearchCV  (compiled linear-family,
    SVC/NuSVC, tree-ensemble, MLP and Pipeline searches)
  - TorchConfig
  - LogisticRegression, Ridge, LinearRegression, ElasticNet, Lasso, SVC,
    NuSVC (sklearn-free estimators)
  - MLPClassifier, MLPRegressor (sklearn-free estimators)
  - Pipeline, StandardScaler, MinMaxScaler, MaxAbsScaler, Normalizer,
    PCA (sklearn-free; a search over a Pipeline of these steps and a
    ported final refits on the device)
  - GradientBoostingRegressor, GradientBoostingClassifier,
    RandomForestClassifier, RandomForestRegressor (parameter holders a
    search resolves without sklearn; refit needs sklearn's estimators)
  - ParameterGrid, ParameterSampler, StratifiedKFold, KFold
"""

from spark_sklearn_tpu_torch.models.estimators import (
    ElasticNet,
    Lasso,
    LinearRegression,
    LogisticRegression,
    MaxAbsScaler,
    MinMaxScaler,
    MLPClassifier,
    MLPRegressor,
    Normalizer,
    NuSVC,
    PCA,
    Pipeline,
    Ridge,
    StandardScaler,
    SVC,
)
from spark_sklearn_tpu_torch.models.trees import (
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from spark_sklearn_tpu_torch.parallel.device import TorchConfig
from spark_sklearn_tpu_torch.search.cv import (
    KFold,
    ParameterGrid,
    ParameterSampler,
    StratifiedKFold,
)
from spark_sklearn_tpu_torch.search.grid import (
    GridSearchCV,
    RandomizedSearchCV,
)

__all__ = [
    "GridSearchCV",
    "RandomizedSearchCV",
    "TorchConfig",
    "LogisticRegression",
    "Ridge",
    "LinearRegression",
    "ElasticNet",
    "Lasso",
    "SVC",
    "NuSVC",
    "MLPClassifier",
    "MLPRegressor",
    "Pipeline",
    "StandardScaler",
    "MinMaxScaler",
    "MaxAbsScaler",
    "Normalizer",
    "PCA",
    "GradientBoostingRegressor",
    "GradientBoostingClassifier",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "ParameterGrid",
    "ParameterSampler",
    "StratifiedKFold",
    "KFold",
]
