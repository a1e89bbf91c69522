"""Converter: fitted models between sklearn and the port's tensors.

Counterpart of `spark_sklearn_tpu/convert/converter.py` (:1-728), with
the reference's verbs: `toTorch` (aliases `toTPU`, `toSpark`, so code
written against the JAX package runs), `toSKLearn` and `toPandas`.
A fitted sklearn estimator becomes a `TorchModel` (family, tensors,
static parameters, meta) whose `predict`, `decision_function`,
`predict_proba` and `transform` run the port's family functions on the
device:

- LogisticRegression, LinearRegression, Ridge, ElasticNet/Lasso: coef
  and intercept;
- SVC/NuSVC: the representer form (support vectors, per-pair signed
  alphas, intercepts), and libsvm's probA/probB, coupled by the port's
  `pair_coupling` (P2) for more than two classes;
- MLPClassifier/MLPRegressor: the layers flattened as the port's MLP
  families take them;
- KMeans (C1), KNeighbors (the fitted rows, N1), the five naive Bayes
  families, PCA (its step's apply);
- RandomForest and GradientBoosting: the fitted trees packed and walked
  by TI1 (`convert/tree_infer.py`).

Nothing here imports sklearn at module level: `toSKLearn` and the
conversions that read sklearn's helpers import it where they run, and an
ImportError names scikit-learn.  `toTorch` takes `config=TorchConfig(...)`
(the Converter's or the call's): ``cuda`` unless the caller asks for
``"cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device


def _sklearn():
    try:
        import sklearn
    except ImportError as exc:
        raise ImportError(
            "this conversion needs scikit-learn, which is not "
            "installed") from exc
    return sklearn


def _check_is_fitted(est):
    _sklearn()
    from sklearn.utils.validation import check_is_fitted
    check_is_fitted(est)


class TorchModel:
    """A fitted model as device tensors: (family, model, static, meta).

    `predict`, `decision_function`, `predict_proba` and `transform` run
    the family's functions on the model's device and return numpy; a
    classifier's `predict` returns labels.  It is what `Converter.toTorch`
    returns and what `KeyedModel.keyedModels` shows for a fleet key."""

    def __init__(self, family, model: Dict[str, Any], static: Dict[str, Any],
                 meta: Dict[str, Any]):
        self.family = family
        self.model = model
        self.static = static
        self.meta = meta

    @property
    def device(self):
        return next(v.device for v in self.model.values()
                    if isinstance(v, torch.Tensor))

    def _device_X(self, X):
        Xh = np.asarray(X)
        check = getattr(self.family, "check_predict_X", None)
        if check is not None:
            # sklearn's own input checks at predict (CategoricalNB's
            # category range), on the host
            check(Xh, self.meta)
            return torch.as_tensor(Xh.astype(np.int32), device=self.device)
        return torch.as_tensor(Xh, dtype=torch.float32, device=self.device)

    @staticmethod
    def _np(t):
        return t.cpu().numpy()

    def predict(self, X):
        pred = self._np(self.family.predict(self.model, self.static,
                                            self._device_X(X), self.meta))
        if self.family.is_classifier:
            return np.asarray(self.meta["classes"])[pred]
        return pred

    def decision_function(self, X):
        return self._np(self.family.decision(
            self.model, self.static, self._device_X(X), self.meta))

    def predict_proba(self, X):
        return self._np(self.family.predict_proba(
            self.model, self.static, self._device_X(X), self.meta))

    def transform(self, X):
        return self._np(self.family.transform(
            self.model, self.static, self._device_X(X), self.meta))

    def __repr__(self):
        return f"TorchModel(family={self.family.name})"


class _ConvertedSVC:
    """A converted sklearn SVC/NuSVC: decisions by the port's SVC family
    (representer form), probabilities from libsvm's probA/probB as the
    reference's (`svm.py:746-760`): binary, the sigmoid of the negated
    public margin; more classes, the pairs' sigmoids coupled by P2."""

    is_classifier = True

    def __init__(self, family):
        self.base = family
        self.name = family.name

    def predict(self, model, static, X, meta):
        return self.base.predict(model, static, X, meta)

    def decision(self, model, static, X, meta):
        return self.base.decision(model, static, X, meta)

    def predict_proba(self, model, static, X, meta):
        from spark_sklearn_tpu_torch.ops.svm_proba_kernels import (
            pair_coupling,
        )
        if "probA" not in model:
            raise NotImplementedError(
                "predict_proba requires SVC(probability=True)")
        dec = self.base._pair_dec_of(model, static, X, meta)   # (n, P)
        A, Bp = model["probA"], model["probB"]
        k = meta["n_classes"]
        if k == 2:
            r0 = torch.sigmoid(-(A[0] * (-dec[:, 0]) + Bp[0]))
            return torch.stack([r0, 1.0 - r0], dim=1)
        ab = torch.stack([A, Bp], dim=1)                       # (P, 2)
        return pair_coupling(dec[None].contiguous(), ab[None].contiguous(),
                             meta["pairs"], k)[0]


class _BruteKNN:
    """A converted KNeighbors model: the fitted rows and labels, every
    query's neighbors among them by the port's family (N1)."""

    def __init__(self, family):
        self.base = family
        self.is_classifier = family.is_classifier
        self.name = ("knn_brute_classifier" if family.is_classifier
                     else "knn_brute_regressor")

    def predict_proba(self, model, static, X, meta):
        if not self.is_classifier:
            raise AttributeError("a KNeighborsRegressor has no "
                                 "predict_proba")
        return self.base.predict_new(model["X"], model["y"], X, static,
                                     meta)

    def predict(self, model, static, X, meta):
        out = self.base.predict_new(model["X"], model["y"], X, static, meta)
        return torch.argmax(out, dim=1) if self.is_classifier else out


class _PCATransform:
    """A converted PCA: its step's apply (`models/preprocessing.PCAStep`),
    the state with the leading fold axis of 1 the step takes."""

    is_classifier = False
    name = "pca_transform"

    @staticmethod
    def transform(model, static, X, meta):
        from spark_sklearn_tpu_torch.models.preprocessing import PCAStep
        state = {k: model[k][None] for k in ("mean", "components", "var")}
        return PCAStep.apply(static, state, X)[0]


_LINEAR = {"logistic_regression", "ridge", "linear_regression",
           "elastic_net"}
_NB = ("gaussian_nb", "multinomial_nb", "bernoulli_nb", "complement_nb",
       "categorical_nb")
_TREES = ("random_forest_classifier", "random_forest_regressor",
          "gradient_boosting_classifier", "gradient_boosting_regressor")


class Converter:
    """Convert fitted models between sklearn and the port's tensors.

    The constructor takes the reference's optional context argument
    (ignored, so `Converter(sc)` still works) and a `config`.

    >>> tm = Converter(config=TorchConfig(device="cpu")).toTorch(
    ...     sklearn_linear_regression)
    >>> tm.predict(X)
    """

    def __init__(self, sc=None, config: Optional[TorchConfig] = None):
        self._sc = sc
        self.config = config

    def _device(self, config):
        return resolve_device(config or self.config)

    # -- sklearn -> the port (reference: toSpark) --------------------------
    def toTorch(self, sklearn_model, config: Optional[TorchConfig] = None):
        from spark_sklearn_tpu_torch.models.preprocessing import (
            PCAStep,
            resolve_step,
        )
        dev = self._device(config)
        if resolve_step(sklearn_model) is PCAStep:
            return self._pca(sklearn_model, dev)
        family = resolve_family(sklearn_model)
        name = getattr(family, "name", None)
        if name in ("svc", "nu_svc"):
            return self._svc(sklearn_model, family, dev)
        if name == "kmeans":
            return self._kmeans(sklearn_model, family, dev)
        if name in ("kneighbors_classifier", "kneighbors_regressor"):
            return self._knn(sklearn_model, family, dev)
        if name in _NB:
            return self._nb(sklearn_model, family, dev)
        if name in ("mlp_classifier", "mlp_regressor"):
            return self._mlp(sklearn_model, family, dev)
        if name in _TREES:
            return self._tree_ensemble(sklearn_model, family, dev)
        if name not in _LINEAR:
            raise ValueError(
                f"Cannot convert {type(sklearn_model).__name__}: not a "
                f"convertible family (reference Converter supports "
                f"LogisticRegression/LinearRegression only; this one also "
                f"covers Ridge/ElasticNet/Lasso, SVC/NuSVC, "
                f"MLPClassifier/MLPRegressor, RandomForest/"
                f"GradientBoosting ensembles, KMeans, KNeighbors, PCA "
                f"and the naive Bayes families)")
        if not hasattr(sklearn_model, "coef_"):
            raise ValueError("model must be fitted (missing coef_)")
        static = family.extract_params(sklearn_model)
        coef = np.asarray(sklearn_model.coef_)
        intercept = np.asarray(getattr(sklearn_model, "intercept_", 0.0))
        meta: Dict[str, Any] = {"n_features": int(coef.shape[-1])}
        if family.is_classifier:
            classes = np.asarray(sklearn_model.classes_)
            meta["n_classes"] = len(classes)
            meta["classes"] = classes
            model = {"coef": np.atleast_2d(coef).astype(np.float32),
                     "intercept": np.atleast_1d(intercept).astype(
                         np.float32)}
        else:
            model = {"coef": coef.ravel().astype(np.float32),
                     "intercept": np.asarray(intercept, np.float32
                                             ).reshape(())}
        return TorchModel(family, _tensors(model, dev), static, meta)

    # the reference's verbs
    toTPU = toTorch
    toSpark = toTorch

    def _svc(self, est, family, dev) -> TorchModel:
        """Fitted SVC/NuSVC -> representer form: pair (i, j)'s signed
        alphas read row j-1 on class-i support vectors and row i on
        class-j ones (libsvm's one-vs-one layout of dual_coef_)."""
        from spark_sklearn_tpu_torch.models.svm import _pairs, _probability_on

        _check_is_fitted(est)
        kernel = est.kernel
        if not isinstance(kernel, str) or kernel == "precomputed":
            raise ValueError(
                f"Cannot convert SVC with kernel={kernel!r}: only "
                "string kernels (rbf/linear/poly/sigmoid) carry the "
                "support-vector form the converted model evaluates")
        classes = np.asarray(est.classes_)
        k = len(classes)
        pairs = _pairs(k)
        sv = np.asarray(est.support_vectors_, np.float32)
        dual = np.atleast_2d(np.asarray(est.dual_coef_, np.float32))
        icpt = np.atleast_1d(np.asarray(est.intercept_, np.float32))
        starts = np.concatenate([[0], np.cumsum(np.asarray(est.n_support_))])
        alphas = np.zeros((len(pairs), sv.shape[0]), np.float32)
        for p, (i, j) in enumerate(pairs):
            alphas[p, starts[i]:starts[i + 1]] = \
                dual[j - 1, starts[i]:starts[i + 1]]
            alphas[p, starts[j]:starts[j + 1]] = \
                dual[i, starts[j]:starts[j + 1]]
        static = dict(est.get_params(deep=False))
        meta: Dict[str, Any] = {
            "n_classes": k, "classes": classes,
            "n_features": int(sv.shape[1]), "pairs": pairs,
            "resolved_gamma": float(est._gamma)}
        model = {"sv_X": sv, "alphas": alphas, "intercepts": icpt}
        probA = np.asarray(getattr(est, "_probA", np.empty(0)))
        if _probability_on(static) and probA.size:
            model["probA"] = probA.astype(np.float32)
            model["probB"] = np.asarray(est._probB, np.float32)
        tm = TorchModel(_ConvertedSVC(family), _tensors(model, dev), static,
                        meta)
        tm._sv_class_starts = starts
        return tm

    def _mlp(self, est, family, dev) -> TorchModel:
        """Fitted MLP -> the port's flat parameter row (each layer's W
        then b); a binary classifier's one logistic logit z becomes the
        two softmax logits [0, z]."""
        _check_is_fitted(est)
        if family.is_classifier and \
                getattr(est, "out_activation_", "") == "logistic" and \
                getattr(est, "n_outputs_", 1) > 1:
            raise ValueError(
                "Cannot convert a multilabel MLPClassifier "
                f"(n_outputs_={est.n_outputs_} with a logistic head); "
                "only binary/multiclass classifiers are supported")
        coefs = [np.asarray(W, np.float32) for W in est.coefs_]
        icpts = [np.asarray(b, np.float32) for b in est.intercepts_]
        static = dict(est.get_params(deep=False))
        meta: Dict[str, Any] = {"n_features": int(coefs[0].shape[0])}
        if family.is_classifier:
            classes = np.asarray(est.classes_)
            meta["n_classes"] = len(classes)
            meta["classes"] = classes
            if coefs[-1].shape[1] == 1 and len(classes) == 2:
                coefs[-1] = np.concatenate(
                    [np.zeros_like(coefs[-1]), coefs[-1]], axis=1)
                icpts[-1] = np.concatenate(
                    [np.zeros_like(icpts[-1]), icpts[-1]])
        else:
            meta["n_targets"] = int(coefs[-1].shape[1])
        flat = np.concatenate([a for W, b in zip(coefs, icpts)
                               for a in (W.reshape(-1), b)])
        model = {"params": torch.as_tensor(flat, device=dev)}
        return TorchModel(family, model, static, meta)

    def _kmeans(self, est, family, dev) -> TorchModel:
        _check_is_fitted(est)
        static = dict(est.get_params(deep=False))
        centers = np.asarray(est.cluster_centers_, np.float32)
        model = {"centers": centers,
                 "inertia": np.float32(est.inertia_),
                 "n_iter": np.int32(est.n_iter_)}
        return TorchModel(family, _tensors(model, dev), static,
                          {"n_features": int(centers.shape[1])})

    def _knn(self, est, family, dev) -> TorchModel:
        from spark_sklearn_tpu_torch.models.neighbors import check_metric

        _check_is_fitted(est)
        if np.asarray(est._y).ndim > 1 or getattr(est, "outputs_2d_",
                                                  False):
            raise ValueError(
                "Cannot convert a multi-output KNeighbors model; only "
                "single-output estimators are supported")
        static = dict(est.get_params(deep=False))
        check_metric(static)
        fit_X = np.asarray(est._fit_X, np.float32)
        meta: Dict[str, Any] = {"n_features": int(fit_X.shape[1])}
        if family.is_classifier:
            classes = np.asarray(est.classes_)
            meta["n_classes"] = len(classes)
            meta["classes"] = classes
            y = np.asarray(est._y).ravel().astype(np.int32)
        else:
            y = np.asarray(est._y).ravel().astype(np.float32)
        return TorchModel(_BruteKNN(family),
                          _tensors({"X": fit_X, "y": y}, dev), static, meta)

    def _nb(self, est, family, dev) -> TorchModel:
        """Fitted naive Bayes -> the port family's own layout (the
        reference's `_nb_to_tpu`): CategoricalNB's ragged per-feature
        tables zero-padded to the most categories."""
        _check_is_fitted(est)
        static = dict(est.get_params(deep=False))
        classes = np.asarray(est.classes_)
        meta: Dict[str, Any] = {
            "n_classes": len(classes), "classes": classes,
            "n_features": int(est.n_features_in_)}
        if family.name == "gaussian_nb":
            model = {"theta": np.asarray(est.theta_, np.float32),
                     "var": np.asarray(est.var_, np.float32),
                     "log_prior": np.log(np.maximum(
                         est.class_prior_, 0.0)).astype(np.float32)}
        elif family.name == "categorical_nb":
            ncat = np.asarray(est.n_categories_, np.int64)
            k, d, C = len(classes), len(ncat), int(ncat.max())
            flp = np.zeros((k, d, C), np.float32)
            for i, f in enumerate(est.feature_log_prob_):
                flp[:, i, :f.shape[1]] = f
            model = {"feature_log_prob": flp,
                     "class_log_prior": np.asarray(est.class_log_prior_,
                                                   np.float32),
                     "class_count": np.asarray(est.class_count_,
                                               np.float32)}
            meta["n_categories"] = ncat
        else:
            model = {"feature_log_prob": np.asarray(est.feature_log_prob_,
                                                    np.float32),
                     "class_log_prior": np.asarray(est.class_log_prior_,
                                                   np.float32),
                     "class_count": np.asarray(est.class_count_,
                                               np.float32)}
            if family.name == "bernoulli_nb":
                log_p = np.asarray(est.feature_log_prob_, np.float64)
                model["log_neg_prob"] = np.log1p(
                    -np.exp(log_p)).astype(np.float32)
        return TorchModel(family, _tensors(model, dev), static, meta)

    def _pca(self, est, dev) -> TorchModel:
        """Fitted PCA -> its step's state {mean, components, var}; the
        float64 originals ride in meta so that a round trip is exact."""
        _check_is_fitted(est)
        static = dict(est.get_params(deep=False))
        static["n_components"] = int(est.n_components_)
        model = {"mean": np.asarray(est.mean_, np.float32),
                 "components": np.asarray(est.components_, np.float32),
                 "var": np.asarray(est.explained_variance_, np.float32)}
        meta: Dict[str, Any] = {
            "n_features": int(est.n_features_in_),
            "n_samples": int(est.n_samples_),
            "explained_variance_ratio": np.asarray(
                est.explained_variance_ratio_, np.float64),
            "singular_values": np.asarray(est.singular_values_, np.float64),
            "noise_variance": float(est.noise_variance_),
            "mean64": np.asarray(est.mean_, np.float64),
            "components64": np.asarray(est.components_, np.float64),
            "explained_variance64": np.asarray(
                est.explained_variance_, np.float64)}
        return TorchModel(_PCATransform, _tensors(model, dev), static, meta)

    def _tree_ensemble(self, est, family, dev) -> TorchModel:
        """Fitted forest or boosting -> the packed trees TI1 walks; exact
        (the same thresholds on the same raw X), inference only."""
        from spark_sklearn_tpu_torch.convert import tree_infer as ti

        _check_is_fitted(est)
        if getattr(est, "n_outputs_", 1) > 1:
            raise ValueError(
                "Cannot convert a multi-output tree ensemble "
                f"(n_outputs_={est.n_outputs_}); only single-output "
                "ensembles are supported")
        if family.name.startswith("random_forest"):
            packed = ti.forest_to_model(est)
            shim = (ti.PackedForestClassifier if family.is_classifier
                    else ti.PackedForestRegressor)
        else:
            packed = ti.gb_to_model(est)
            shim = (ti.PackedGBClassifier if family.is_classifier
                    else ti.PackedGBRegressor)
        meta: Dict[str, Any] = {"n_features": int(est.n_features_in_)}
        if family.is_classifier:
            classes = np.asarray(est.classes_)
            meta["n_classes"] = len(classes)
            meta["classes"] = classes
        return TorchModel(shim, ti.to_device(packed, dev),
                          dict(est.get_params(deep=False)), meta)

    # -- the port -> sklearn (reference: toSKLearn) ------------------------
    def toSKLearn(self, torch_model: TorchModel):
        _sklearn()
        from sklearn import linear_model as lm

        family = torch_model.family
        name = family.name
        if name in ("svc", "nu_svc") and "sv_X" in torch_model.model:
            return self._svc_to_sklearn(torch_model)
        if name in ("mlp_classifier", "mlp_regressor"):
            return self._mlp_to_sklearn(torch_model)
        if name in ("knn_brute_classifier", "knn_brute_regressor"):
            return self._knn_to_sklearn(torch_model)
        if name == "pca_transform":
            return self._pca_to_sklearn(torch_model)
        if name == "sk_tree_ensemble":
            raise ValueError(
                "tree-ensemble TorchModels are inference-only (packed "
                "traversal arrays); keep the original sklearn estimator "
                "for the sklearn side")
        cls = {"logistic_regression": lm.LogisticRegression,
               "ridge": lm.Ridge,
               "linear_regression": lm.LinearRegression,
               "elastic_net": lm.ElasticNet}.get(name)
        if cls is None and name == "kmeans":
            from sklearn.cluster import KMeans
            cls = KMeans
        if cls is None and name in _NB:
            from sklearn import naive_bayes as nb
            cls = {"gaussian_nb": nb.GaussianNB,
                   "multinomial_nb": nb.MultinomialNB,
                   "bernoulli_nb": nb.BernoulliNB,
                   "complement_nb": nb.ComplementNB,
                   "categorical_nb": nb.CategoricalNB}[name]
        if cls is None:
            raise ValueError(f"no sklearn counterpart for {name}")
        attrs = family.sklearn_attrs(torch_model.model, torch_model.static,
                                     torch_model.meta)
        valid = cls().get_params()
        est = cls(**{k: v for k, v in torch_model.static.items()
                     if k in valid})
        for k, v in attrs.items():
            setattr(est, k, v)
        if name == "kmeans":
            est._n_threads = 1    # sklearn's KMeans.predict reads it
        return est

    to_sklearn = toSKLearn

    def _svc_to_sklearn(self, tm: TorchModel):
        from sklearn.svm import SVC as SkSVC, NuSVC as SkNuSVC

        starts = getattr(tm, "_sv_class_starts", None)
        if starts is None:
            raise ValueError(
                "toSKLearn for SVC needs the support vectors' class "
                "grouping; convert with toTorch first (round trip)")
        cls = SkNuSVC if tm.family.name == "nu_svc" else SkSVC
        valid = cls().get_params()
        est = cls(**{k: v for k, v in tm.static.items() if k in valid})
        classes = np.asarray(tm.meta["classes"])
        k = len(classes)
        m = tm.model
        sv = m["sv_X"].cpu().numpy().astype(np.float64)
        alphas = m["alphas"].cpu().numpy().astype(np.float64)
        icpt = m["intercepts"].cpu().numpy().astype(np.float64)
        n_sv = sv.shape[0]
        pairs = tm.meta["pairs"]
        dual_pub = np.zeros((max(1, k - 1), n_sv))
        for p, (i, j) in enumerate(pairs):
            dual_pub[j - 1, starts[i]:starts[i + 1]] = \
                alphas[p, starts[i]:starts[i + 1]]
            dual_pub[i, starts[j]:starts[j + 1]] = \
                alphas[p, starts[j]:starts[j + 1]]
        flip = -1.0 if k == 2 else 1.0   # sklearn's binary public flip
        est.classes_ = classes
        est.support_vectors_ = sv
        est.support_ = np.arange(n_sv, dtype=np.int32)
        est._n_support = np.diff(starts).astype(np.int32)
        est.dual_coef_ = dual_pub
        est.intercept_ = icpt
        est._dual_coef_ = flip * dual_pub
        est._intercept_ = flip * icpt
        est._probA = (m["probA"].cpu().numpy().astype(np.float64)
                      if "probA" in m else np.empty(0))
        est._probB = (m["probB"].cpu().numpy().astype(np.float64)
                      if "probB" in m else np.empty(0))
        est._gamma = float(tm.meta["resolved_gamma"])
        est._sparse = False
        est.shape_fit_ = (n_sv, sv.shape[1])
        est.fit_status_ = 0
        est.class_weight_ = np.ones(k)
        est.n_features_in_ = sv.shape[1]
        est.n_iter_ = np.zeros(len(pairs), dtype=np.int32)
        return est

    def _knn_to_sklearn(self, tm: TorchModel):
        """Refit on the stored rows: k-NN's fit is storing them, so the
        estimator is exact."""
        from sklearn.neighbors import (KNeighborsClassifier,
                                       KNeighborsRegressor)

        is_clf = tm.family.is_classifier
        cls = KNeighborsClassifier if is_clf else KNeighborsRegressor
        valid = cls().get_params()
        est = cls(**{k: v for k, v in tm.static.items() if k in valid})
        X = tm.model["X"].cpu().numpy().astype(np.float64)
        y = tm.model["y"].cpu().numpy()
        if is_clf:
            y = np.asarray(tm.meta["classes"])[y]
        return est.fit(X, y)

    def _pca_to_sklearn(self, tm: TorchModel):
        from sklearn.decomposition import PCA

        valid = PCA().get_params()
        est = PCA(**{k: v for k, v in tm.static.items() if k in valid})
        meta = tm.meta
        est.components_ = np.asarray(meta.get(
            "components64", tm.model["components"].cpu().numpy()),
            np.float64)
        est.mean_ = np.asarray(meta.get(
            "mean64", tm.model["mean"].cpu().numpy()), np.float64)
        est.explained_variance_ = np.asarray(meta.get(
            "explained_variance64", tm.model["var"].cpu().numpy()),
            np.float64)
        n_comp, n_feat = est.components_.shape
        est.n_components_ = n_comp
        est.n_features_in_ = n_feat
        est.n_samples_ = int(meta.get("n_samples", 0))
        est.explained_variance_ratio_ = np.asarray(meta.get(
            "explained_variance_ratio", np.full(n_comp, np.nan)))
        est.singular_values_ = np.asarray(meta.get(
            "singular_values", np.full(n_comp, np.nan)))
        est.noise_variance_ = float(meta.get("noise_variance", 0.0))
        return est

    def _mlp_to_sklearn(self, tm: TorchModel):
        from sklearn.neural_network import MLPClassifier, MLPRegressor
        from sklearn.preprocessing import LabelBinarizer

        is_clf = tm.family.is_classifier
        cls = MLPClassifier if is_clf else MLPRegressor
        valid = cls().get_params()
        est = cls(**{k: v for k, v in tm.static.items() if k in valid})
        attrs = tm.family.sklearn_attrs(tm.model, tm.static, tm.meta)
        coefs = [np.asarray(W, np.float64) for W in attrs["coefs_"]]
        icpts = [np.asarray(b, np.float64) for b in attrs["intercepts_"]]
        if is_clf:
            classes = np.asarray(tm.meta["classes"])
            if len(classes) == 2 and coefs[-1].shape[1] == 2:
                # the family's two softmax logits -> sklearn's one
                # logistic logit z1 - z0
                coefs[-1] = coefs[-1][:, 1:] - coefs[-1][:, :1]
                icpts[-1] = icpts[-1][1:] - icpts[-1][:1]
            est.classes_ = classes
            est._label_binarizer = LabelBinarizer().fit(classes)
            est.out_activation_ = ("logistic" if len(classes) == 2
                                   else "softmax")
        else:
            est.out_activation_ = "identity"
        est.n_outputs_ = coefs[-1].shape[1]
        est.coefs_ = coefs
        est.intercepts_ = icpts
        est.n_layers_ = len(coefs) + 1
        est.n_features_in_ = coefs[0].shape[0]
        if "n_iter" in tm.model:
            est.n_iter_ = int(tm.model["n_iter"])
        return est

    # -- DataFrame helper (reference: toPandas) ----------------------------
    def toPandas(self, df):
        """A DataFrame (or a dict of columns) whose cells may hold
        tensors, numpy arrays or CSRMatrix rows, as a pandas DataFrame of
        numpy arrays."""
        import pandas as pd
        from spark_sklearn_tpu_torch.keyed.keyed import Columns
        from spark_sklearn_tpu_torch.sparse.csr import CSRMatrix

        def cell(v):
            if isinstance(v, CSRMatrix):
                return np.asarray(v.to_scipy().toarray()).ravel()
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().numpy()
            if hasattr(v, "__array__") and not np.isscalar(v):
                return np.asarray(v)
            return v

        cols = Columns(df)
        return pd.DataFrame({c: [cell(v) for v in cols.column(c)]
                             for c in cols.names})


def _tensors(model: Dict[str, Any], dev) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors on `dev`, float32 and int32 as they are."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in model.items()}
