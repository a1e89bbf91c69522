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
they predict new X with one kernel matrix; with `probability=True` they
also calibrate Platt sigmoids on their training decisions and give
`predict_proba`.  `SVR` and `NuSVR` keep (training X, β, b) the same
way; `LinearSVC` and `LinearSVR` fit one lane of their family's batched
fit (the reference's `models/svr.py`).

The five naive Bayes classes, `LinearDiscriminantAnalysis`,
`KNeighborsClassifier`/`Regressor` and `KMeans` (the reference's
`models/naive_bayes.py`, `discriminant.py`, `neighbors.py`,
`cluster.py`) hold sklearn's constructor defaults.  The naive Bayes
classes, LDA and KMeans fit one lane of their family's batched fit; KNN
keeps its training rows and predicts new X through N1 (one all-ones
mask); KMeans' `predict` and `score` run C1.

`MLPClassifier` and `MLPRegressor` (the reference's `models/
standalone.py:117-168`, with the stopping and schedule knobs its family
reads) fit one lane of the batched minibatch fit.  `StandardScaler`,
`MinMaxScaler`, `MaxAbsScaler`, `Normalizer` and `PCA` hold sklearn's
parameters and fit one fold of their step (`models/preprocessing.py`)
with all-ones weights.  `Pipeline` chains them as sklearn's does:
`named_steps`, ``step__param`` keys in `get_params`/`set_params`, and
`fit`, `predict`, `predict_proba`.  A search over
any of these refits on the card, where there is no sklearn.

Every class takes a `CSRMatrix` or a scipy-sparse X in `fit` and in its
predictions: `LogisticRegression`, `MultinomialNB`, `ComplementNB` and
`BernoulliNB` keep it sparse (a `CSROperand`, products through SP1);
every other class densifies it once, on the host.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from spark_sklearn_tpu_torch.models import naive_bayes as nb
from spark_sklearn_tpu_torch.models.cluster import KMeansFamily
from spark_sklearn_tpu_torch.models.discriminant import (
    LinearDiscriminantFamily,
)
from spark_sklearn_tpu_torch.models.linear import (
    ElasticNetFamily,
    LinearRegressionFamily,
    LogisticRegressionFamily,
    RidgeFamily,
)
from spark_sklearn_tpu_torch.models.mlp import (
    MLPClassifierFamily,
    MLPRegressorFamily,
)
from spark_sklearn_tpu_torch.models.neighbors import (
    KNeighborsClassifierFamily,
    KNeighborsRegressorFamily,
    check_metric,
)
from spark_sklearn_tpu_torch.models import preprocessing as prep
from spark_sklearn_tpu_torch.models.svm import NuSVCFamily, SVCFamily
from spark_sklearn_tpu_torch.models.svr import (
    LinearSVCFamily,
    LinearSVRFamily,
    NuSVRFamily,
    SVRFamily,
)
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device
from spark_sklearn_tpu_torch.sparse.csr import (
    CSROperand,
    as_scipy_csr,
    densify,
    issparse,
    to_device,
)


def _dense(X, dtype=None):
    """X as a dense numpy array for a family that takes no sparse X: a
    `CSRMatrix` or scipy-sparse X densified once, on the host."""
    X = densify(as_scipy_csr(X))
    return X if dtype is None else np.asarray(X, dtype)


def _sparse_for(family, X, static):
    """X as scipy CSR where it is sparse and `family` keeps it sparse
    under the parameters `static` (LogisticRegression, the discrete
    naive Bayes; BernoulliNB not for binarize < 0), else None."""
    X = as_scipy_csr(X)
    takes = getattr(family, "takes_sparse", None)
    if issparse(X) and takes is not None and takes(static):
        return X
    return None


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

    def clone(self):
        """An unfitted copy with the same parameters."""
        return type(self)(**self.get_params(deep=False))

    def can_refit(self) -> bool:
        """Whether a search can refit this estimator here."""
        return True

    def _sklearn_kind(self):
        """sklearn's estimator type: "classifier", "regressor",
        "clusterer", or "transformer" for a step without a family."""
        from spark_sklearn_tpu_torch.models.base import resolve_family

        family = resolve_family(self)
        if family is None:
            return "transformer"
        if getattr(family, "default_scorer", None) == "neg_inertia":
            return "clusterer"
        return "classifier" if family.is_classifier else "regressor"

    def __sklearn_tags__(self):
        """sklearn's tags, which sklearn's helpers read where the
        estimator runs on a search's host tier (needs sklearn)."""
        from sklearn.utils import (
            ClassifierTags,
            RegressorTags,
            Tags,
            TargetTags,
            TransformerTags,
        )

        kind = self._sklearn_kind()
        return Tags(
            estimator_type=None if kind == "transformer" else kind,
            target_tags=TargetTags(
                required=kind in ("classifier", "regressor")),
            transformer_tags=(TransformerTags() if kind == "transformer"
                              else None),
            classifier_tags=(ClassifierTags() if kind == "classifier"
                             else None),
            regressor_tags=(RegressorTags() if kind == "regressor"
                            else None))

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({args})"

    def fit(self, X, y, sample_weight=None):
        dev = resolve_device(TorchConfig(device=self.device))
        family = self._family
        dtype = (np.float64 if getattr(family, "wants_float64", False)
                 else np.float32)
        static = family.extract_params(self)
        Xs = _sparse_for(family, X, static)
        if Xs is not None:                  # kept sparse: a CSROperand
            X = Xs
            data_np, meta = family.prepare_data_sparse(
                X, np.asarray(y), dtype=dtype)
        else:
            X = _dense(X)
            data_np, meta = family.prepare_data(X, np.asarray(y),
                                                dtype=dtype)
        data = {k: to_device(v, dev) for k, v in data_np.items()}
        w = (np.ones(X.shape[0], dtype) if sample_weight is None
             else np.asarray(sample_weight, dtype))
        if hasattr(family, "observe_candidates"):
            # the family's host-side checks of its parameters (priors,
            # min_categories, the LDA solver), as a search runs them
            family.observe_candidates([], static, meta)
        model = family.fit_task_batched(
            {}, static, data, torch.as_tensor(w[None, :], device=dev), meta)
        self._model = {k: v[0] for k, v in model.items()}
        self._meta = meta
        self._static = static
        self._device = dev
        for k, v in family.sklearn_attrs(self._model, static, meta).items():
            setattr(self, k, v)
        return self

    def _X(self, X, dtype=None):
        """X for a prediction: a CSROperand of X's CSR alone (the
        products of a prediction are all X @ D) where fit keeps X
        sparse, else dense, of `dtype` (None: the coefficients')."""
        Xs = _sparse_for(self._family, X, self._static)
        if Xs is not None:
            return CSROperand.from_matrix(Xs, self._device, transpose=False)
        return torch.as_tensor(
            _dense(X), dtype=dtype or self._model["coef"].dtype,
            device=self._device)


class _LogProba:
    """`predict_log_proba`, the log of `predict_proba`, as sklearn's
    classifiers have it."""

    def predict_log_proba(self, X):
        with np.errstate(divide="ignore"):
            return np.log(self.predict_proba(X))


class LogisticRegression(_LogProba, _Estimator):
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

    def decision_function(self, X):
        return self._family.decision(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()

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


class _KernelEstimator(_Estimator):
    """The kernel SVMs' fit: the family's full-data representer form
    (training X and its coefficients), which predicts new X with one
    kernel matrix."""

    def fit(self, X, y, sample_weight=None):
        dev = resolve_device(TorchConfig(device=self.device))
        data_np, meta = self._family.prepare_data(
            _dense(X, np.float32), np.asarray(y))
        static = self._family.extract_params(self)
        X_t = torch.as_tensor(data_np["X"], device=dev)
        y_t = torch.as_tensor(data_np["y"], device=dev)
        w = None if sample_weight is None else torch.as_tensor(
            np.asarray(sample_weight, np.float32), device=dev)
        return self._set_fitted(
            self._family.fit_representer(X_t, y_t, static, meta, w), meta,
            dev)

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
        return torch.as_tensor(_dense(X, np.float32),
                               device=self._device)


class SVC(_LogProba, _KernelEstimator):
    """Kernel SVM, one-vs-one for k > 2 classes, fitted by projected
    Nesterov ascent on libsvm's dual (`models/svm.py`)."""

    _family = SVCFamily

    def __init__(self, C=1.0, kernel="rbf", gamma="scale", degree=3,
                 coef0=0.0, probability=False, max_iter=-1, tol=1e-3,
                 class_weight=None, random_state=None, device=None):
        self.C = C
        self.kernel = kernel
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.probability = probability
        self.max_iter = max_iter
        self.tol = tol
        self.class_weight = class_weight
        self.random_state = random_state
        self.device = device

    def decision_function(self, X):
        return self._family.decision(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()

    def predict(self, X):
        idx = self._family.predict(
            self._model, self._static, self._X(X), self._meta)
        return self.classes_[idx.cpu().numpy()]

    def predict_proba(self, X):
        return self._family.predict_proba(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()


class NuSVC(SVC):
    """nu-SVC: `nu` bounds the fraction of margin errors and support
    vectors in place of C; raises ValueError in fit where nu is
    infeasible, as sklearn's does."""

    _family = NuSVCFamily

    def __init__(self, nu=0.5, kernel="rbf", gamma="scale", degree=3,
                 coef0=0.0, probability=False, max_iter=-1, tol=1e-3,
                 class_weight=None, random_state=None, device=None):
        self.nu = nu
        self.kernel = kernel
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.probability = probability
        self.max_iter = max_iter
        self.tol = tol
        self.class_weight = class_weight
        self.random_state = random_state
        self.device = device


class SVR(_KernelEstimator):
    """Epsilon-SVR, fitted by projected Nesterov ascent on libsvm's dual
    (`models/svr.py`); predicts K(X, X_train) β + b."""

    _family = SVRFamily

    def __init__(self, kernel="rbf", degree=3, gamma="scale", coef0=0.0,
                 tol=1e-3, C=1.0, epsilon=0.1, max_iter=-1, device=None):
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.C = C
        self.epsilon = epsilon
        self.max_iter = max_iter
        self.device = device

    def predict(self, X):
        return self._family.predict(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()


class NuSVR(SVR):
    """nu-SVR: `nu` fixes the share of support vectors in place of
    epsilon."""

    _family = NuSVRFamily

    def __init__(self, nu=0.5, C=1.0, kernel="rbf", degree=3,
                 gamma="scale", coef0=0.0, tol=1e-3, max_iter=-1,
                 device=None):
        self.nu = nu
        self.C = C
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.max_iter = max_iter
        self.device = device


class LinearSVC(_Estimator):
    """liblinear's LinearSVC (l2 penalty, one-vs-rest): squared hinge by
    L-BFGS, hinge by its box dual; liblinear's regularised intercept."""

    _family = LinearSVCFamily

    def __init__(self, penalty="l2", loss="squared_hinge", tol=1e-4,
                 C=1.0, multi_class="ovr", fit_intercept=True,
                 intercept_scaling=1, class_weight=None, max_iter=1000,
                 device=None):
        self.penalty = penalty
        self.loss = loss
        self.tol = tol
        self.C = C
        self.multi_class = multi_class
        self.fit_intercept = fit_intercept
        self.intercept_scaling = intercept_scaling
        self.class_weight = class_weight
        self.max_iter = max_iter
        self.device = device

    def decision_function(self, X):
        return self._family.decision(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()

    def predict(self, X):
        idx = self._family.predict(
            self._model, self._static, self._X(X), self._meta)
        return self.classes_[idx.cpu().numpy()]


class LinearSVR(_Regressor):
    """liblinear's LinearSVR: epsilon-insensitive by its dual, squared
    epsilon-insensitive by L-BFGS; liblinear's regularised intercept."""

    _family = LinearSVRFamily

    def __init__(self, epsilon=0.0, tol=1e-4, C=1.0,
                 loss="epsilon_insensitive", fit_intercept=True,
                 intercept_scaling=1.0, max_iter=1000, device=None):
        self.epsilon = epsilon
        self.tol = tol
        self.C = C
        self.loss = loss
        self.fit_intercept = fit_intercept
        self.intercept_scaling = intercept_scaling
        self.max_iter = max_iter
        self.device = device


class _MLP(_Estimator):
    def _X(self, X):
        return torch.as_tensor(_dense(X, np.float32),
                               device=self._device)

    def predict(self, X):
        out = self._family.predict(self._model, self._static, self._X(X),
                                   self._meta).cpu().numpy()
        return self.classes_[out] if self._family.is_classifier else out


class MLPClassifier(_LogProba, _MLP):
    """Multi-layer perceptron classifier: softmax output, adam or sgd
    with momentum, sklearn's stopping rules (`models/mlp.py`)."""

    _family = MLPClassifierFamily

    def __init__(self, hidden_layer_sizes=(100,), activation="relu",
                 solver="adam", alpha=1e-4, batch_size="auto",
                 learning_rate="constant", learning_rate_init=1e-3,
                 power_t=0.5, max_iter=200, random_state=None, tol=1e-4,
                 momentum=0.9, early_stopping=False,
                 validation_fraction=0.1, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-8, n_iter_no_change=10, device=None):
        self.hidden_layer_sizes = hidden_layer_sizes
        self.activation = activation
        self.solver = solver
        self.alpha = alpha
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.learning_rate_init = learning_rate_init
        self.power_t = power_t
        self.max_iter = max_iter
        self.random_state = random_state
        self.tol = tol
        self.momentum = momentum
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.n_iter_no_change = n_iter_no_change
        self.device = device

    def predict_proba(self, X):
        return self._family.predict_proba(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()


class MLPRegressor(_MLP):
    """Multi-layer perceptron regressor: identity output, half squared
    error; the parameters of `MLPClassifier`."""

    _family = MLPRegressorFamily
    __init__ = MLPClassifier.__init__


class _ClosedForm(_LogProba, _Estimator):
    """A classifier fitted as one lane of its family's batched fit."""

    def _X(self, X):
        return super()._X(X, torch.float32)

    def predict(self, X):
        idx = self._family.predict(self._model, self._static, self._X(X),
                                   self._meta)
        return self.classes_[idx.cpu().numpy()]

    def predict_proba(self, X):
        return self._family.predict_proba(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()


class GaussianNB(_ClosedForm):
    """Gaussian naive Bayes; its joint log-likelihood is B1."""

    _family = nb.GaussianNBFamily

    def __init__(self, priors=None, var_smoothing=1e-9, device=None):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.device = device


class MultinomialNB(_ClosedForm):
    _family = nb.MultinomialNBFamily

    def __init__(self, alpha=1.0, force_alpha=True, fit_prior=True,
                 class_prior=None, device=None):
        self.alpha = alpha
        self.force_alpha = force_alpha
        self.fit_prior = fit_prior
        self.class_prior = class_prior
        self.device = device


class ComplementNB(_ClosedForm):
    _family = nb.ComplementNBFamily

    def __init__(self, alpha=1.0, force_alpha=True, fit_prior=True,
                 class_prior=None, norm=False, device=None):
        self.alpha = alpha
        self.force_alpha = force_alpha
        self.fit_prior = fit_prior
        self.class_prior = class_prior
        self.norm = norm
        self.device = device


class BernoulliNB(_ClosedForm):
    _family = nb.BernoulliNBFamily

    def __init__(self, alpha=1.0, force_alpha=True, binarize=0.0,
                 fit_prior=True, class_prior=None, device=None):
        self.alpha = alpha
        self.force_alpha = force_alpha
        self.binarize = binarize
        self.fit_prior = fit_prior
        self.class_prior = class_prior
        self.device = device


class CategoricalNB(_ClosedForm):
    """Categorical naive Bayes on non-negative integer codes; a code past
    a feature's fitted categories raises IndexError, as sklearn's."""

    _family = nb.CategoricalNBFamily

    def __init__(self, alpha=1.0, force_alpha=True, fit_prior=True,
                 class_prior=None, min_categories=None, device=None):
        self.alpha = alpha
        self.force_alpha = force_alpha
        self.fit_prior = fit_prior
        self.class_prior = class_prior
        self.min_categories = min_categories
        self.device = device

    def _X(self, X):
        X = _dense(X)
        self._family.check_predict_X(X, self._meta)
        return torch.as_tensor(np.asarray(X, np.int32), device=self._device)


class LinearDiscriminantAnalysis(_ClosedForm):
    """LDA; only solver="lsqr" is ported (sklearn's default, "svd",
    raises at fit)."""

    _family = LinearDiscriminantFamily

    def __init__(self, solver="svd", shrinkage=None, priors=None,
                 n_components=None, store_covariance=False, tol=1e-4,
                 covariance_estimator=None, device=None):
        self.solver = solver
        self.shrinkage = shrinkage
        self.priors = priors
        self.n_components = n_components
        self.store_covariance = store_covariance
        self.tol = tol
        self.covariance_estimator = covariance_estimator
        self.device = device

    def decision_function(self, X):
        return self._family.decision(
            self._model, self._static, self._X(X), self._meta).cpu().numpy()


class KNeighborsClassifier(_Estimator):
    """Brute-force euclidean k-nearest neighbors: `fit` keeps the training
    rows on the device, `predict` votes through N1."""

    _family = KNeighborsClassifierFamily

    def __init__(self, n_neighbors=5, weights="uniform", algorithm="auto",
                 leaf_size=30, p=2, metric="minkowski", metric_params=None,
                 n_jobs=None, device=None):
        self.n_neighbors = n_neighbors
        self.weights = weights
        self.algorithm = algorithm
        self.leaf_size = leaf_size
        self.p = p
        self.metric = metric
        self.metric_params = metric_params
        self.n_jobs = n_jobs
        self.device = device

    def fit(self, X, y):
        dev = resolve_device(TorchConfig(device=self.device))
        family = self._family
        data_np, meta = family.prepare_data(_dense(X), np.asarray(y))
        self._static = family.extract_params(self)
        check_metric(self._static)
        self._train = {k: torch.as_tensor(v, device=dev)
                       for k, v in data_np.items()}
        self._meta, self._device = meta, dev
        for k, v in family.sklearn_attrs({}, self._static, meta).items():
            setattr(self, k, v)
        self.n_samples_fit_ = int(data_np["X"].shape[0])
        return self

    def _votes(self, X):
        return self._family.predict_new(
            self._train["X"], self._train["y"],
            torch.as_tensor(_dense(X, np.float32), device=self._device),
            self._static, self._meta)

    def predict(self, X):
        proba = self._votes(X)
        return self.classes_[torch.argmax(proba, dim=1).cpu().numpy()]

    def predict_proba(self, X):
        return self._votes(X).cpu().numpy()


class KNeighborsRegressor(KNeighborsClassifier):
    """Brute-force euclidean k-nearest-neighbor regression."""

    _family = KNeighborsRegressorFamily

    def predict(self, X):
        return self._votes(X).cpu().numpy()

    def predict_proba(self, X):
        raise AttributeError(
            "'KNeighborsRegressor' object has no attribute 'predict_proba'")


class KMeans(_Estimator):
    """k-means by Lloyd's iterations after k-means++ or random seeding;
    `predict` and `score` run C1."""

    _family = KMeansFamily

    def __init__(self, n_clusters=8, init="k-means++", n_init="auto",
                 max_iter=300, tol=1e-4, verbose=0, random_state=None,
                 copy_x=True, algorithm="lloyd", device=None):
        self.n_clusters = n_clusters
        self.init = init
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.verbose = verbose
        self.random_state = random_state
        self.copy_x = copy_x
        self.algorithm = algorithm
        self.device = device

    def fit(self, X, y=None, sample_weight=None):
        X = _dense(X)
        super().fit(X, None, sample_weight)
        self.labels_ = self.predict(X)
        return self

    def _X(self, X):
        return torch.as_tensor(_dense(X, np.float32),
                               device=self._device)

    def _views(self, X, needed):
        model = {k: v[None] for k, v in self._model.items()}
        return self._family.views_task_batched(
            model, self._static, {"X": self._X(X)}, self._meta, needed)

    def predict(self, X):
        return self._views(X, {"pred"})["pred"][0].cpu().numpy()

    def score(self, X, y=None, sample_weight=None):
        """-inertia of X's rows to the fitted centers, each at its sample
        weight (sklearn's)."""
        d2 = self._views(X, {"min_d2"})["min_d2"][0].double().cpu()
        if sample_weight is not None:
            d2 = d2 * torch.as_tensor(np.asarray(sample_weight, np.float64))
        return -float(d2.sum())


class _Transformer(_Estimator):
    """A preprocessing step's parameters, fitted on all rows."""

    _step = None

    def fit(self, X, y=None):
        dev = resolve_device(TorchConfig(device=self.device))
        X_t = torch.as_tensor(_dense(X, np.float32), device=dev)
        static = self.get_params()
        self._state = self._step.fit(
            static, X_t, torch.ones((1, X_t.shape[0]), dtype=X_t.dtype,
                                    device=dev))
        self._device = dev
        self.n_features_in_ = int(X_t.shape[1])
        return self

    def transform(self, X):
        X_t = torch.as_tensor(_dense(X, np.float32),
                              device=self._device)
        return self._step.apply(self.get_params(), self._state,
                                X_t)[0].cpu().numpy()


class StandardScaler(_Transformer):
    _step = prep.StandardScalerStep

    def __init__(self, with_mean=True, with_std=True, device=None):
        self.with_mean = with_mean
        self.with_std = with_std
        self.device = device


class MinMaxScaler(_Transformer):
    _step = prep.MinMaxScalerStep

    def __init__(self, feature_range=(0, 1), clip=False, device=None):
        self.feature_range = feature_range
        self.clip = clip
        self.device = device


class MaxAbsScaler(_Transformer):
    _step = prep.MaxAbsScalerStep

    def __init__(self, device=None):
        self.device = device


class Normalizer(_Transformer):
    _step = prep.NormalizerStep

    def __init__(self, norm="l2", device=None):
        self.norm = norm
        self.device = device


class PCA(_Transformer):
    _step = prep.PCAStep

    def __init__(self, n_components=None, whiten=False, svd_solver="auto",
                 device=None):
        self.n_components = n_components
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.device = device


def _is_passthrough(step) -> bool:
    return step is None or (isinstance(step, str) and step == "passthrough")


def _clone(estimator):
    """An unfitted copy with the same params: the port's own estimators
    (a Pipeline with its steps) copy themselves; anything else goes
    through sklearn's `clone`."""
    if isinstance(estimator, _Estimator):
        return estimator.clone()
    from sklearn.base import clone
    return clone(estimator)


class Pipeline(_Estimator):
    """A chain of transformers and a final estimator, sklearn's or the
    port's.  `device` (None: each step's own) is handed to the port's
    steps that have none when the pipeline fits."""

    def __init__(self, steps, device=None):
        self.steps = steps
        self.device = device

    @property
    def named_steps(self):
        return dict(self.steps)

    def get_params(self, deep=True):
        out = {"steps": self.steps, "device": self.device}
        if deep:
            for name, est in self.steps:
                out[name] = est
                if hasattr(est, "get_params"):
                    for k, v in est.get_params(deep=False).items():
                        out[f"{name}__{k}"] = v
        return out

    def set_params(self, **params):
        names = [name for name, _ in self.steps]
        for key, value in params.items():
            if key in ("steps", "device"):
                setattr(self, key, value)
            elif key in names:
                self.steps = [(n, value if n == key else e)
                              for n, e in self.steps]
            elif "__" in key and key.split("__", 1)[0] in names:
                name, sub = key.split("__", 1)
                self.named_steps[name].set_params(**{sub: value})
            else:
                raise ValueError(
                    f"Invalid parameter {key!r} for estimator Pipeline. "
                    f"Valid parameters are: {sorted(self.get_params())!r}.")
        return self

    def clone(self):
        return Pipeline([(n, e if _is_passthrough(e) else _clone(e))
                         for n, e in self.steps], device=self.device)

    def can_refit(self) -> bool:
        return all(not isinstance(e, _Estimator) or e.can_refit()
                   for _, e in self.steps if not _is_passthrough(e))

    def _own_device(self, est):
        if self.device is not None and isinstance(est, _Estimator) and \
                getattr(est, "device", None) is None:
            est.set_params(device=self.device)
        return est

    def fit(self, X, y):
        Xt = X
        for _, est in self.steps[:-1]:
            if not _is_passthrough(est):
                Xt = self._own_device(est).fit(Xt, y).transform(Xt)
        self._own_device(self.steps[-1][1]).fit(Xt, y)
        return self

    def _transform(self, X):
        for _, est in self.steps[:-1]:
            if not _is_passthrough(est):
                X = est.transform(X)
        return X

    @property
    def _final(self):
        return self.steps[-1][1]

    def predict(self, X):
        return self._final.predict(self._transform(X))

    def predict_proba(self, X):
        return self._final.predict_proba(self._transform(X))

    def _chained(self, name):
        method = getattr(self._final, name)   # AttributeError where none
        return lambda X: method(self._transform(X))

    # the final estimator's methods after the transforms, where it has them
    decision_function = property(
        lambda self: self._chained("decision_function"))
    predict_log_proba = property(
        lambda self: self._chained("predict_log_proba"))

    @property
    def classes_(self):
        return self._final.classes_

