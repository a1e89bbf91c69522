"""Inference over fitted tree ensembles, converted from sklearn.

Counterpart of `spark_sklearn_tpu/convert/tree_infer.py` (:1-195).  The
search's tree families keep no tree structures, so a converted ensemble
carries the fitted trees' own arrays (`pack_trees`: feature, threshold,
children and values of every tree, padded to one node count) and is
walked exactly, threshold by threshold on the raw X.  The walk and the
reduction over the trees are TI1 (`ops/tree_infer_kernels.tree_ensemble`,
`csrc/tree_infer.cu`): a sample a thread through every tree, the
forest's mean of normalised leaf distributions or boosting's per-class
sums kept in registers, where the reference writes a (T, n, n_out)
tensor of leaf values and reduces it (`tree_infer.py:50-160`).  The
plain version, `tree_ensemble_plain`, takes the reference's level steps.

The shims below are the families `TorchModel` calls: `predict`,
`decision`, `predict_proba` over a model dict of the packed arrays (as
tensors on the model's device) and "max_depth"; boosting adds "init",
"learning_rate" and "k_eff" (1 for binary, else the classes).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from spark_sklearn_tpu_torch.ops.tree_infer_kernels import (
    tree_ensemble,
    tree_ensemble_plain,
)

__all__ = ["pack_trees", "tree_ensemble_plain", "forest_to_model",
           "gb_to_model", "PackedForestClassifier", "PackedForestRegressor",
           "PackedGBClassifier", "PackedGBRegressor"]

#: the packed arrays of a model dict
ARRAYS = ("feature", "threshold", "left", "right", "value")


def pack_trees(trees) -> Dict[str, Any]:
    """Pad a list of fitted trees, any objects with sklearn's `Tree`
    arrays (`node_count`, `feature`, `threshold`, `children_left`,
    `children_right`, `value`, `max_depth`), to one (T, N, ...) array
    set.  Leaves keep children -1; padding nodes are never reached."""
    T = len(trees)
    N = max(int(t.node_count) for t in trees)
    n_out = np.asarray(trees[0].value).shape[-1]
    feat = np.zeros((T, N), np.int32)
    thr = np.zeros((T, N), np.float32)
    left = np.full((T, N), -1, np.int32)
    right = np.full((T, N), -1, np.int32)
    value = np.zeros((T, N, n_out), np.float32)
    depth = 0
    for i, t in enumerate(trees):
        c = int(t.node_count)
        feat[i, :c] = np.maximum(np.asarray(t.feature)[:c], 0)
        thr[i, :c] = np.asarray(t.threshold)[:c]
        left[i, :c] = np.asarray(t.children_left)[:c]
        right[i, :c] = np.asarray(t.children_right)[:c]
        value[i, :c] = np.asarray(t.value).reshape(c, -1)[:, :n_out]
        depth = max(depth, int(t.max_depth))
    return {"feature": feat, "threshold": thr, "left": left,
            "right": right, "value": value, "max_depth": int(depth)}


def to_device(packed: Dict[str, Any], device) -> Dict[str, Any]:
    """The packed arrays as contiguous tensors on `device` (the rest of
    the dict unchanged)."""
    out = dict(packed)
    for name in ARRAYS + ("init",):
        if name in packed:
            out[name] = torch.as_tensor(np.ascontiguousarray(packed[name]),
                                        device=device)
    return out


def _run(model, X, mode, **kw):
    return tree_ensemble(X.contiguous(), *(model[a] for a in ARRAYS),
                         int(model["max_depth"]), mode, **kw)


class _PackedEnsembleBase:
    name = "sk_tree_ensemble"


class PackedForestClassifier(_PackedEnsembleBase):
    is_classifier = True

    @classmethod
    def predict_proba(cls, model, static, X, meta):
        return _run(model, X, "forest_proba")

    @classmethod
    def predict(cls, model, static, X, meta):
        return torch.argmax(cls.predict_proba(model, static, X, meta), dim=1)

    @classmethod
    def decision(cls, model, static, X, meta):
        p = cls.predict_proba(model, static, X, meta)
        if meta["n_classes"] == 2:
            return p[:, 1] - p[:, 0]
        return p


class PackedForestRegressor(_PackedEnsembleBase):
    is_classifier = False

    @classmethod
    def predict(cls, model, static, X, meta):
        return _run(model, X, "mean")


class PackedGBRegressor(_PackedEnsembleBase):
    is_classifier = False

    @classmethod
    def predict(cls, model, static, X, meta):
        return _run(model, X, "boost", K=1, init=model["init"],
                    lr=model["learning_rate"])[:, 0]


class PackedGBClassifier(_PackedEnsembleBase):
    is_classifier = True

    @classmethod
    def _raw(cls, model, X):
        return _run(model, X, "boost", K=int(model["k_eff"]),
                    init=model["init"], lr=model["learning_rate"])

    @classmethod
    def predict_proba(cls, model, static, X, meta):
        raw = cls._raw(model, X)
        if int(model["k_eff"]) == 1:
            p1 = torch.sigmoid(raw[:, 0])
            return torch.stack([1.0 - p1, p1], dim=1)
        return torch.softmax(raw, dim=1)

    @classmethod
    def predict(cls, model, static, X, meta):
        return torch.argmax(cls.predict_proba(model, static, X, meta), dim=1)

    @classmethod
    def decision(cls, model, static, X, meta):
        raw = cls._raw(model, X)
        return raw[:, 0] if int(model["k_eff"]) == 1 else raw


def forest_to_model(est) -> Dict[str, Any]:
    """RandomForest{Classifier,Regressor} -> packed model dict."""
    return pack_trees([e.tree_ for e in est.estimators_])


def gb_to_model(est) -> Dict[str, Any]:
    """GradientBoosting{Classifier,Regressor} (default init only) ->
    packed model dict with the constant raw init and learning rate."""
    init = est.init_
    if type(init).__name__ not in ("DummyClassifier", "DummyRegressor"):
        raise ValueError(
            "Cannot convert GradientBoosting with a custom init "
            "estimator; only the default (constant) init is supported")
    ests = np.asarray(est.estimators_)                    # (S, K)
    packed = pack_trees([t.tree_ for t in ests.reshape(-1)])
    X0 = np.zeros((1, est.n_features_in_), np.float32)
    packed["init"] = np.asarray(est._raw_predict_init(X0)[0], np.float32)
    packed["learning_rate"] = float(est.learning_rate)
    packed["k_eff"] = int(ests.shape[1])
    return packed
