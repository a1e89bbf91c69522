"""Estimator classes that need no scikit-learn.

Counterpart of `spark_sklearn_tpu/models/estimators.py` (:63-145):
`LogisticRegression`, `Ridge`, `LinearRegression`, `ElasticNet` and
`Lasso`; and of `spark_sklearn_tpu/models/standalone.py` (:18-115):
`SVC`, with `NuSVC` beside it.  The reference subclasses sklearn's
`BaseEstimator`; the card's machine has no sklearn, so `_Estimator`
carries the small part of that contract the search uses
(`get_params`/`set_params`, `fit`, `predict`, `predict_proba`) itself.
Each class is registered to its family, and its `fit` is one lane of the
same batched fit the search runs, on `device` (None means ``cuda``; pass
``"cpu"`` for the CPU).  Families that want float64 (Ridge,
LinearRegression) fit in float64 here too.

`LogisticRegression` also takes ``penalty="l1"``/``"elasticnet"`` and
`l1_ratio` (fitted by FISTA) and `class_weight`, as sklearn's does.

`SVC` and `NuSVC` fit the full data with the search's dual solver and
keep the representer form (training X, signed alphas, intercepts), so
they predict new X with one kernel matrix.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.linear import (
    ElasticNetFamily,
    LinearRegressionFamily,
    LogisticRegressionFamily,
    RidgeFamily,
)
from spark_sklearn_tpu_torch.models.svm import NuSVCFamily, SVCFamily
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device


class _Estimator:
    """get_params/set_params by constructor signature, and the single
    fit: prepare -> params -> one lane of the family's batched fit with
    all-ones (or the caller's) sample weights -> fitted attributes."""

    _family = None

    @classmethod
    def _param_names(cls):
        return sorted(p for p in inspect.signature(cls.__init__).parameters
                      if p != "self")

    def get_params(self, deep=True):
        return {name: getattr(self, name) for name in self._param_names()}

    def set_params(self, **params):
        valid = set(self._param_names())
        for name, value in params.items():
            if name not in valid:
                raise ValueError(
                    f"Invalid parameter {name!r} for estimator "
                    f"{type(self).__name__}. Valid parameters are: "
                    f"{sorted(valid)!r}.")
            setattr(self, name, value)
        return self

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({args})"

    def fit(self, X, y, sample_weight=None):
        dev = resolve_device(TorchConfig(device=self.device))
        family = self._family
        dtype = (np.float64 if getattr(family, "wants_float64", False)
                 else np.float32)
        X = np.asarray(X)
        data_np, meta = family.prepare_data(X, np.asarray(y), dtype=dtype)
        data = {k: torch.as_tensor(v, device=dev) for k, v in data_np.items()}
        w = (np.ones(X.shape[0], dtype) if sample_weight is None
             else np.asarray(sample_weight, dtype))
        static = family.extract_params(self)
        model = family.fit_task_batched(
            {}, static, data, torch.as_tensor(w[None, :], device=dev), meta)
        self._model = {k: v[0] for k, v in model.items()}
        self._meta = meta
        self._static = static
        self._device = dev
        for k, v in family.sklearn_attrs(self._model, static, meta).items():
            setattr(self, k, v)
        return self

    def _X(self, X):
        return torch.as_tensor(
            np.asarray(X), dtype=self._model["coef"].dtype,
            device=self._device)


class LogisticRegression(_Estimator):
    """Logistic regression, binary or multinomial: lbfgs for the l2 or no
    penalty, proximal FISTA for l1 and elasticnet."""

    _family = LogisticRegressionFamily

    def __init__(self, penalty="l2", C=1.0, l1_ratio=0.0, tol=1e-4,
                 fit_intercept=True, max_iter=100, class_weight=None,
                 device=None):
        self.penalty = penalty
        self.C = C
        self.l1_ratio = l1_ratio
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.class_weight = class_weight
        self.device = device

    def predict(self, X):
        idx = self._family.predict(
            self._model, self._static, self._X(X), self._meta)
        return self.classes_[idx.cpu().numpy()]

    def predict_proba(self, X):
        return self._family.predict_proba(
            self._model, self._static, self._X(X), self._meta
        ).cpu().numpy()


class _Regressor(_Estimator):
    def predict(self, X):
        return self._family.predict(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()


class Ridge(_Regressor):
    _family = RidgeFamily

    def __init__(self, alpha=1.0, fit_intercept=True, tol=1e-4,
                 random_state=None, device=None):
        self.alpha = alpha
        self.fit_intercept = fit_intercept
        self.tol = tol
        self.random_state = random_state
        self.device = device


class LinearRegression(_Regressor):
    _family = LinearRegressionFamily

    def __init__(self, fit_intercept=True, device=None):
        self.fit_intercept = fit_intercept
        self.device = device


class ElasticNet(_Regressor):
    _family = ElasticNetFamily

    def __init__(self, alpha=1.0, l1_ratio=0.5, fit_intercept=True,
                 max_iter=1000, tol=1e-4, random_state=None, device=None):
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.device = device


class Lasso(ElasticNet):
    """ElasticNet with l1_ratio fixed at 1 (its family reads the class
    name, as the reference's does)."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=1000,
                 tol=1e-4, random_state=None, device=None):
        super().__init__(alpha=alpha, l1_ratio=1.0,
                         fit_intercept=fit_intercept, max_iter=max_iter,
                         tol=tol, random_state=random_state, device=device)


class SVC(_Estimator):
    """Kernel SVM, one-vs-one for k > 2 classes, fitted by projected
    Nesterov ascent on libsvm's dual (`models/svm.py`)."""

    _family = SVCFamily

    def __init__(self, C=1.0, kernel="rbf", gamma="scale", degree=3,
                 coef0=0.0, max_iter=-1, tol=1e-3, class_weight=None,
                 random_state=None, device=None):
        self.C = C
        self.kernel = kernel
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.max_iter = max_iter
        self.tol = tol
        self.class_weight = class_weight
        self.random_state = random_state
        self.device = device

    def fit(self, X, y):
        dev = resolve_device(TorchConfig(device=self.device))
        data_np, meta = self._family.prepare_data(
            np.asarray(X, np.float32), np.asarray(y))
        static = self._family.extract_params(self)
        X_t = torch.as_tensor(data_np["X"], device=dev)
        y_t = torch.as_tensor(data_np["y"], device=dev)
        return self._set_fitted(
            self._family.fit_representer(X_t, y_t, static, meta), meta, dev)

    def _set_fitted(self, model, meta, dev):
        self._model = model
        self._meta = meta
        self._static = self._family.extract_params(self)
        self._device = dev
        for k, v in self._family.sklearn_attrs(
                model, self._static, meta).items():
            setattr(self, k, v)
        return self

    def _X(self, X):
        return torch.as_tensor(np.asarray(X, np.float32),
                               device=self._device)

    def decision_function(self, X):
        return self._family.decision(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()

    def predict(self, X):
        idx = self._family.predict(
            self._model, self._static, self._X(X), self._meta)
        return self.classes_[idx.cpu().numpy()]


class NuSVC(SVC):
    """nu-SVC: `nu` bounds the fraction of margin errors and support
    vectors in place of C; raises ValueError in fit where nu is
    infeasible, as sklearn's does."""

    _family = NuSVCFamily

    def __init__(self, nu=0.5, kernel="rbf", gamma="scale", degree=3,
                 coef0=0.0, max_iter=-1, tol=1e-3, class_weight=None,
                 random_state=None, device=None):
        self.nu = nu
        self.kernel = kernel
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.max_iter = max_iter
        self.tol = tol
        self.class_weight = class_weight
        self.random_state = random_state
        self.device = device
