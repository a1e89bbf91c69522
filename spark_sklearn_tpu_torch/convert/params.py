"""Carry fitted models between the JAX package and the port.

The JAX family's model dict, as numpy arrays (logistic regression:
`coef` (T, k, d), `intercept` (T, k), `n_iter`, `converged`, ...;
regressors: `coef` (T, d), `intercept` (T,)), becomes the port's tensors
with `params_from_jax`; going back is ``t.cpu().numpy()`` per entry.

A fitted standalone SVC of the JAX package (`models/standalone.py`:
training X `_X_train`, signed alphas `_alphas` (P, n), `_intercepts` (P,)
and `classes_`) becomes the port's `SVC` with `svc_from_jax`.

A fitted naive Bayes, LDA or KMeans model of the JAX families
(`models/naive_bayes.py`: theta/var/log_prior, or feature_log_prob,
class_log_prior, class_count and Bernoulli's log_neg_prob;
`discriminant.py`: coef, intercept; `cluster.py`: centers, inertia,
n_iter), one fit or a lane stack, becomes the port's with `nb_from_jax`,
`lda_from_jax` and `kmeans_from_jax`: the same keys and shapes, float32
and int32.  KNN has no fitted parameters to carry.

The SVM families' task-batched models carry over with
`svc_model_from_jax` (pair decisions and the Platt sigmoids of
probability=True), `svr_model_from_jax` (SVR and NuSVR's regression
values) and `linear_svm_from_jax` (LinearSVC and LinearSVR's coef and
intercept): the same keys and shapes, float32 and int32.

A tree grown by the JAX package's histogram grower (`ops/trees.py`
`Tree`) becomes the port's, lane axis and all, with `tree_from_jax`.

An MLP family's model (`models/mlp.py`: ``{"layers": [{"W", "b"}, ...],
"n_iter"}``, one fit or a lane stack) becomes the port's ``{"params":
flat (P,) or (B, P), "n_iter"}`` with `mlp_from_jax`, and one fit of a
fused pipeline (``{"steps": [state, ...], "final": model}``) becomes
step states with the port's leading fold axis and the final's model
with `pipeline_from_jax`.

A fitted JAX `KeyedModel` (its stacked fleet: key index, family or step
name, meta, static and the models as arrays; its host-fitted estimators
as they are) becomes the port's with `keyed_model_from_jax`, and a JAX
`TpuModel` from `Converter.toTPU` (packed trees included) the port's
`TorchModel` with `torch_model_from_jax`: each `transform` or `predict`
reproduces the JAX package's on the same rows.
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


def svc_from_jax(est, device=None):
    """The port's fitted `SVC` carrying a fitted JAX standalone SVC's
    representer form and hyperparameters; it predicts what `est` does.
    `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.models.estimators import SVC
    from spark_sklearn_tpu_torch.models.svm import _pairs
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    params = est.get_params(deep=False)
    svc = SVC(**{k: params[k] for k in SVC._param_names() if k in params},
              device=device)
    dev = resolve_device(TorchConfig(device=device))
    X = np.asarray(est._X_train, np.float32)
    classes = np.asarray(est.classes_)
    # the facts prepare_data derives from the training data (gamma="scale"
    # reads its variance)
    meta = {"n_classes": len(classes), "classes": classes,
            "n_features": int(X.shape[1]), "x_var": float(np.var(X)),
            "pairs": _pairs(len(classes))}
    model = {name: torch.as_tensor(np.array(value, np.float32), device=dev)
             for name, value in (("sv_X", X), ("alphas", est._alphas),
                                 ("intercepts", est._intercepts))}
    return svc._set_fitted(model, meta, dev)


def tree_from_jax(tree, device=None):
    """The port's `Tree` (ops/trees.py) from a JAX package `Tree`
    (spark_sklearn_tpu/ops/trees.py: feat, thresh, value, is_leaf as jax
    or numpy arrays), one tree (M,) or a stack (L, M); the port's always
    has the lane axis.  `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.ops.trees import Tree
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))
    feat = np.asarray(tree.feat, np.int32)
    lanes = feat.ndim == 1

    def conv(a, dtype):
        a = np.array(a, dtype)
        return torch.as_tensor(a[None] if lanes else a, device=dev)

    return Tree(feat=conv(tree.feat, np.int32),
                thresh=conv(tree.thresh, np.int32),
                value=conv(tree.value, np.float32),
                is_leaf=conv(tree.is_leaf, np.bool_))


def mlp_from_jax(model, device=None):
    """{"params", "n_iter"} of the port's MLP families from the JAX
    family's model: each layer's W (.., fi, fo) and b (.., fo) laid out
    W then b, layer by layer, in one flat row per lane.  `device` None
    means ``cuda``."""
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))
    parts = []
    for layer in model["layers"]:
        W = np.asarray(layer["W"], np.float32)
        parts += [W.reshape(*W.shape[:-2], -1),
                  np.asarray(layer["b"], np.float32)]
    out = {"params": torch.as_tensor(np.concatenate(parts, axis=-1),
                                     device=dev)}
    if "n_iter" in model:
        out["n_iter"] = torch.as_tensor(np.array(model["n_iter"],
                                                   np.int32), device=dev)
    return out


def pipeline_from_jax(model, device=None):
    """{"steps": [state, ...], "final": model} of one fit of the JAX
    package's fused pipeline as the port's: each step state's arrays
    with the leading fold axis (of 1) that the port's steps
    (`models/preprocessing.py`) apply with, and the final model by
    `mlp_from_jax`.  `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))

    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        return torch.as_tensor(a[None], device=dev)

    steps = [{k: conv(v) for k, v in state.items()}
             for state in model["steps"]]
    return {"steps": steps, "final": mlp_from_jax(model["final"], device)}


def _fitted_from_jax(model, keys, device):
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))
    out = {}
    for key in keys:
        if key not in model:
            continue
        a = np.asarray(model[key])
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
        out[key] = torch.as_tensor(a, device=dev)
    return out


def nb_from_jax(model, device=None):
    """A naive Bayes family's fitted dict (any of the five) as the port's
    tensors.  `device` None means ``cuda``."""
    return _fitted_from_jax(
        model, ("theta", "var", "log_prior", "feature_log_prob",
                "log_neg_prob", "class_log_prior", "class_count"), device)


def lda_from_jax(model, device=None):
    """LDA's fitted {coef (.., k, d), intercept (.., k)} as the port's
    tensors.  `device` None means ``cuda``."""
    return _fitted_from_jax(model, ("coef", "intercept"), device)


def kmeans_from_jax(model, device=None):
    """KMeans' fitted {centers, inertia, n_iter} as the port's tensors.
    `device` None means ``cuda``."""
    return _fitted_from_jax(model, ("centers", "inertia", "n_iter"), device)


def svc_model_from_jax(model, device=None):
    """An SVC or NuSVC family's task-batched model (`pair_dec` (T, n, P),
    `n_iter`, and with probability=True `platt` (T, 2) or `platt_pair`
    (T, P, 2)) as the port's tensors: the port's `predict`, `decision`
    and `predict_proba` on it give what the reference's give.  `device`
    None means ``cuda``."""
    return _fitted_from_jax(
        model, ("pair_dec", "n_iter", "platt", "platt_pair"), device)


def svr_model_from_jax(model, device=None):
    """An SVR or NuSVR family's task-batched model (`f` (T, n), the
    full-set regression values, and `n_iter`) as the port's tensors.
    `device` None means ``cuda``."""
    return _fitted_from_jax(model, ("f", "n_iter"), device)


def linear_svm_from_jax(model, device=None):
    """A LinearSVC or LinearSVR family's fitted dict (`coef`, `intercept`,
    `converged`, `n_iter`; one fit or a lane stack) as the port's
    tensors (`converged` as bool).  `device` None means ``cuda``."""
    out = _fitted_from_jax(model, ("coef", "intercept", "n_iter"), device)
    if "converged" in model:
        out["converged"] = torch.as_tensor(
            np.array(model["converged"], bool),
            device=out["coef"].device)
    return out


def _port_family(name: str):
    """The port's family (or preprocessing step) named `name`."""
    from spark_sklearn_tpu_torch.models import base, preprocessing
    import spark_sklearn_tpu_torch.models.estimators  # noqa: F401 registers

    for fam in list(base._FAMILIES_BY_CLASSNAME.values()) + list(
            preprocessing.STEP_REGISTRY.values()):
        if fam.name == name:
            return fam
    raise ValueError(f"the port has no family or step named {name!r}")


def _tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.as_tensor(np.array(a, order="C"), device=dev)


def keyed_model_from_jax(jax_model, device=None):
    """The port's `KeyedModel` carrying a fitted JAX `KeyedModel`: the
    fleet's stacked models (leading key axis) as tensors of the port's
    family or step, the same key index, static parameters and meta; the
    host-fitted estimators as they are.  A JAX logistic regression's
    (G, k', d) coef, a regressor's (G, d), KMeans' centers and the steps'
    states keep their shapes; the stateless Normalizer gets the port's
    per-key placeholder.  `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.keyed.keyed import KeyedModel
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))
    fleet = None
    jf = jax_model.fleet
    if jf is not None:
        G = len(jf["key_index"])
        models = {k: _tensor(v, dev) for k, v in jf["models"].items()}
        if jf["kind"] == "step":
            step = _port_family(jf["step"].name)
            if not models:
                models = {"folds": torch.zeros(G, device=dev)}
            fleet = dict(kind="step", step=step, models=models, meta={},
                         static=dict(jf["static"]), buckets=[])
        else:
            fleet = dict(kind="family", family=_port_family(
                jf["family"].name), models=models, meta=dict(jf["meta"]),
                static=dict(jf["static"]), buckets=[])
        fleet["key_index"] = dict(jf["key_index"])
    return KeyedModel(
        keyCols=jax_model.keyCols, xCol=jax_model.xCol,
        yCol=jax_model.yCol, outputCol=jax_model.outputCol,
        estimatorType=jax_model.estimatorType,
        models=dict(jax_model.models) if jax_model.models else None,
        fleet=fleet, pandas=True, device=dev)


def torch_model_from_jax(tpu_model, device=None):
    """The port's `TorchModel` carrying a JAX `TpuModel` (from the JAX
    package's `Converter.toTPU`): the same family (the linear families,
    SVC/NuSVC with probA/probB, the MLPs as one flat parameter row,
    KMeans, KNN, naive Bayes, PCA, the packed tree ensembles), static
    parameters and meta.  `device` None means ``cuda``."""
    from spark_sklearn_tpu_torch.convert import converter as cv
    from spark_sklearn_tpu_torch.convert import tree_infer as ti
    from spark_sklearn_tpu_torch.parallel.device import (
        TorchConfig,
        resolve_device,
    )

    dev = resolve_device(TorchConfig(device=device))
    name = tpu_model.family.name
    model = tpu_model.model
    static, meta = dict(tpu_model.static), dict(tpu_model.meta)
    if name == "sk_tree_ensemble":
        shim = getattr(ti, tpu_model.family.__name__)
        packed = {k: (np.asarray(v) if k in ti.ARRAYS + ("init",) else v)
                  for k, v in model.items()}
        return cv.TorchModel(shim, ti.to_device(packed, dev), static, meta)
    if name in ("mlp_classifier", "mlp_regressor"):
        return cv.TorchModel(_port_family(name),
                             mlp_from_jax(model, device), static, meta)
    if name == "pca_transform":
        return cv.TorchModel(cv._PCATransform,
                             {k: _tensor(v, dev) for k, v in model.items()},
                             static, meta)
    tensors = {k: _tensor(v, dev) for k, v in model.items()}
    if name in ("knn_brute_classifier", "knn_brute_regressor"):
        family = cv._BruteKNN(_port_family(
            name.replace("knn_brute", "kneighbors")))
        return cv.TorchModel(family, tensors, static, meta)
    if name in ("svc", "nu_svc"):
        tm = cv.TorchModel(cv._ConvertedSVC(_port_family(name)), tensors,
                           static, meta)
        if hasattr(tpu_model, "_sv_class_starts"):
            tm._sv_class_starts = tpu_model._sv_class_starts
        return tm
    return cv.TorchModel(_port_family(name), tensors, static, meta)
