"""spark_sklearn_tpu_torch — the PyTorch/CUDA port of spark_sklearn_tpu.

The JAX package `spark_sklearn_tpu` stays the reference; this package
runs the same searches with PyTorch on an NVIDIA H100 (``sm_90a``), with
the hot elementwise passes as hand-written CUDA kernels (``csrc/``).  It
imports neither JAX nor the JAX package, and needs no scikit-learn:
sklearn estimators and splitters are accepted where sklearn is installed.

Entry points run on ``cuda`` unless the caller passes
``TorchConfig(device="cpu")``.  A search the device tier cannot run (an
estimator without a family, a callable or scorer-object scoring, a fit
parameter other than sample_weight, ...) runs on the host tier,
sklearn's `_fit_and_score` through joblib, which needs scikit-learn.

Public API so far:
  - GridSearchCV, RandomizedSearchCV  (compiled linear-family,
    SVC/NuSVC, SVR/NuSVR, LinearSVC/LinearSVR, tree-ensemble, MLP,
    naive Bayes, LDA, KNN, KMeans and Pipeline searches; the host tier
    for the rest)
  - HalvingGridSearchCV, HalvingRandomSearchCV  (successive halving
    over the same tiers)
  - TorchConfig
  - LogisticRegression, Ridge, LinearRegression, ElasticNet, Lasso, SVC,
    NuSVC (with probability=True), SVR, NuSVR, LinearSVC, LinearSVR
    (sklearn-free estimators)
  - MLPClassifier, MLPRegressor (sklearn-free estimators)
  - GaussianNB, MultinomialNB, ComplementNB, BernoulliNB, CategoricalNB,
    LinearDiscriminantAnalysis (solver="lsqr"), KNeighborsClassifier,
    KNeighborsRegressor, KMeans (sklearn-free estimators)
  - Pipeline, StandardScaler, MinMaxScaler, MaxAbsScaler, Normalizer,
    PCA (sklearn-free; a search over a Pipeline of these steps and a
    ported final refits on the device)
  - GradientBoostingRegressor, GradientBoostingClassifier,
    RandomForestClassifier, RandomForestRegressor (parameter holders a
    search resolves without sklearn; refit needs sklearn's estimators)
  - ParameterGrid, ParameterSampler, StratifiedKFold, KFold
  - CSRMatrix  (sparse rows; a search or an estimator takes it, or any
    scipy-sparse X: densified once on the host, or kept sparse on the
    device under TorchConfig(data_mode="sparse") for LogisticRegression
    and MultinomialNB/ComplementNB/BernoulliNB)
  - KeyedEstimator, KeyedModel  (a model a key of a pandas DataFrame or
    a dict of columns, fitted as bucketed fleets on the device)
  - gapply, compiled_group_func  (grouped apply; torch group functions
    over the fleets' buckets)
  - Converter  (fitted sklearn models to the port's tensors and back:
    toTorch/toTPU/toSpark, toSKLearn, toPandas)
"""

from spark_sklearn_tpu_torch.convert.converter import Converter
from spark_sklearn_tpu_torch.keyed.gapply import compiled_group_func, gapply
from spark_sklearn_tpu_torch.keyed.keyed import KeyedEstimator, KeyedModel
from spark_sklearn_tpu_torch.models.estimators import (
    BernoulliNB,
    CategoricalNB,
    ComplementNB,
    ElasticNet,
    GaussianNB,
    KMeans,
    KNeighborsClassifier,
    KNeighborsRegressor,
    Lasso,
    LinearDiscriminantAnalysis,
    LinearRegression,
    LogisticRegression,
    MaxAbsScaler,
    MinMaxScaler,
    MLPClassifier,
    MLPRegressor,
    MultinomialNB,
    Normalizer,
    NuSVC,
    PCA,
    Pipeline,
    Ridge,
    StandardScaler,
    LinearSVC,
    LinearSVR,
    NuSVR,
    SVC,
    SVR,
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
from spark_sklearn_tpu_torch.search.halving import (
    HalvingGridSearchCV,
    HalvingRandomSearchCV,
)
from spark_sklearn_tpu_torch.sparse.csr import CSRMatrix

__all__ = [
    "GridSearchCV",
    "RandomizedSearchCV",
    "HalvingGridSearchCV",
    "HalvingRandomSearchCV",
    "TorchConfig",
    "LogisticRegression",
    "Ridge",
    "LinearRegression",
    "ElasticNet",
    "Lasso",
    "SVC",
    "NuSVC",
    "SVR",
    "NuSVR",
    "LinearSVC",
    "LinearSVR",
    "MLPClassifier",
    "MLPRegressor",
    "GaussianNB",
    "MultinomialNB",
    "ComplementNB",
    "BernoulliNB",
    "CategoricalNB",
    "LinearDiscriminantAnalysis",
    "KNeighborsClassifier",
    "KNeighborsRegressor",
    "KMeans",
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
    "CSRMatrix",
    "KeyedEstimator",
    "KeyedModel",
    "gapply",
    "compiled_group_func",
    "Converter",
]
