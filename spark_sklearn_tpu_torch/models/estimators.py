"""Estimator classes that need no scikit-learn.

Counterpart of `spark_sklearn_tpu/models/estimators.py` `LogisticRegression`
(:63).  The reference subclasses sklearn's `BaseEstimator`; the card's
machine has no sklearn, so this class carries the small part of that
contract the search uses (`get_params`/`set_params`, `fit`, `predict`,
`predict_proba`) itself.  It is registered to `LogisticRegressionFamily`,
and its `fit` is one lane of the same batched L-BFGS the search runs.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.linear import LogisticRegressionFamily
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device


class LogisticRegression:
    """Logistic regression (lbfgs; l2 or no penalty), binary or
    multinomial.  `device` is where `fit` runs: None means ``cuda``;
    pass ``"cpu"`` for the CPU."""

    _family = LogisticRegressionFamily

    def __init__(self, penalty="l2", C=1.0, tol=1e-4, fit_intercept=True,
                 max_iter=100, class_weight=None, device=None):
        self.penalty = penalty
        self.C = C
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.class_weight = class_weight
        self.device = device

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
        X = np.asarray(X)
        data_np, meta = family.prepare_data(X, np.asarray(y))
        data = {k: torch.as_tensor(v, device=dev) for k, v in data_np.items()}
        w = (np.ones(X.shape[0], np.float32) if sample_weight is None
             else np.asarray(sample_weight, np.float32))
        static = self.get_params()
        model = family.fit_task_batched(
            {}, static, data, torch.as_tensor(w[None, :], device=dev), meta)
        self._model = {k: v[0] for k, v in model.items()}
        self._meta = meta
        self._device = dev
        for k, v in family.sklearn_attrs(self._model, static, meta).items():
            setattr(self, k, v)
        return self

    def _X(self, X):
        return torch.as_tensor(np.asarray(X, np.float32), device=self._device)

    def predict(self, X):
        idx = self._family.predict(
            self._model, self.get_params(), self._X(X), self._meta)
        return self.classes_[idx.cpu().numpy()]

    def predict_proba(self, X):
        return self._family.predict_proba(
            self._model, self.get_params(), self._X(X), self._meta
        ).cpu().numpy()
