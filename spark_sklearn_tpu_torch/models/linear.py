"""Logistic regression as a lane-batched family.

Counterpart of `spark_sklearn_tpu/models/linear.py`
`LogisticRegressionFamily` (:46-396) for the l2 and unpenalised lbfgs
fits, binary and multinomial.  Numerics follow sklearn: minimise
sum-logloss + 0.5/C * ||coef||^2 (intercept unpenalised), tol on
max|grad|.

All (candidate x fold) lanes of a chunk fit as ONE batched problem: the
logits of every lane come from one GEMM of width B*k (`Ax`, K1), the
gradient pull-back is one GEMM (`AT`, K3), and the elementwise passes
between them are the hand-written kernels K2 (`glm_loss_grad`) and K4
(`glm_trial_loss`).  The lane axis sits at position 1 — Z is (n, B) or
(n, B, k) — so the kernels' loads coalesce over lanes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import (
    Family,
    apply_class_weight,
    encode_labels,
    register_family,
)
from spark_sklearn_tpu_torch.ops.glm_kernels import (
    glm_loss_grad,
    glm_trial_loss,
)
from spark_sklearn_tpu_torch.ops.solvers import glm_lbfgs_batched


def resolve_penalty(static: Dict[str, Any]):
    """The penalty this slice fits: "l2" or None.  l1 and elasticnet
    raise NotImplementedError (the reference fits them by FISTA)."""
    penalty = static.get("penalty", "l2")
    l1_ratio = static.get("l1_ratio", 0.0) or 0.0
    if penalty == "deprecated":
        # sklearn >= 1.8 sentinel: l2 unless l1_ratio mixes in l1
        penalty = "l2" if not l1_ratio else "elasticnet"
    if penalty == "elasticnet" and not l1_ratio:
        penalty = "l2"
    if penalty in ("l1", "elasticnet"):
        raise NotImplementedError(
            f"penalty={penalty!r} is not implemented in the PyTorch port")
    if penalty in (None, "none"):
        return None
    if penalty != "l2":
        raise ValueError(f"penalty={penalty!r} is not supported")
    return "l2"


class LogisticRegressionFamily(Family):
    name = "logistic_regression"
    is_classifier = True
    dynamic_params = {"C": np.float32, "tol": np.float32}

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        classes, y_enc = encode_labels(y)
        data = {"X": np.ascontiguousarray(X, dtype=dtype), "y": y_enc}
        meta = {"n_classes": int(len(classes)), "classes": classes,
                "n_features": int(X.shape[1])}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """All B lanes of a chunk as one batched L-BFGS.

        `dynamic` holds (B,) tensors, `train_w` (B, n) fold weights and
        `data` the device tensors X (n, d) float32 and y (n,) int32.
        Returns a model dict with leading axis B: coef (B, k', d),
        intercept (B, k'), converged, n_iter (k' = 1 when binary)."""
        X, y = data["X"], data["y"]
        n, d = X.shape
        k = meta["n_classes"]
        B = train_w.shape[0]
        dev, dt = X.device, X.dtype

        def lane_param(name, default):
            v = dynamic.get(name, static.get(name, default))
            return torch.as_tensor(v, dtype=dt, device=dev).expand(B)

        C = lane_param("C", 1.0)
        tol = lane_param("tol", 1e-4)
        max_iter = int(static.get("max_iter", 100))
        fit_intercept = bool(static.get("fit_intercept", True))
        penalty = resolve_penalty(static)
        train_w = apply_class_weight(
            train_w, y, meta, static.get("class_weight"))
        inv_C = 1.0 / C if penalty == "l2" else torch.zeros_like(C)
        wT = train_w.T.contiguous()                          # (n, B)

        kk = 1 if k == 2 else k              # logits per lane
        kd = kk * d

        def Ax(x):                           # K1 -> Z (n, B) or (n, B, k)
            W = x[:, :kd].reshape(B * kk, d)
            if fit_intercept:
                Z = torch.addmm(x[:, kd:].reshape(1, B * kk), X, W.T)
            else:
                Z = X @ W.T
            return Z if k == 2 else Z.view(n, B, k)

        def AT(G):                           # K3 -> (B, kd + kk)
            G2 = G.reshape(n, B * kk)
            gW = (G2.T @ X).reshape(B, kd)
            gb = G2.sum(dim=0).reshape(B, kk) if fit_intercept else \
                torch.zeros((B, kk), dtype=dt, device=dev)
            return torch.cat([gW, gb], dim=1)

        def loss_grad(Z):                    # K2
            return glm_loss_grad(Z, wT, y)

        def trial_loss(Z, Zp, alphas):       # K4
            return glm_trial_loss(Z, Zp, wT, y, alphas)

        def reg_loss(x):                     # x (..., B, D) -> (..., B)
            return 0.5 * inv_C * (x[..., :kd] ** 2).sum(dim=-1)

        def reg_grad(x):
            return torch.cat([inv_C[:, None] * x[:, :kd],
                              torch.zeros((B, kk), dtype=dt, device=dev)],
                             dim=1)

        res = glm_lbfgs_batched(
            Ax, loss_grad, trial_loss, AT, reg_loss, reg_grad,
            torch.zeros((B, kd + kk), dtype=dt, device=dev),
            max_iter=max_iter, tol=tol)
        W = res.x[:, :kd].reshape(B, kk, d)
        b = res.x[:, kd:]
        if not fit_intercept:
            b = torch.zeros_like(b)
        return {"coef": W, "intercept": b,
                "converged": res.converged, "n_iter": res.n_iter}

    @classmethod
    def decision(cls, model, static, X, meta):
        Z = X @ model["coef"].T + model["intercept"]
        if meta["n_classes"] == 2:
            return Z[:, 0]
        return Z

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """Scorer views for ALL T tasks from ONE GEMM of width T*k:
        "decision" (T, n[, k]), "pred" (T, n) int64 class indices,
        "proba" (T, n, k)."""
        X = data["X"]
        n = X.shape[0]
        W = models["coef"]                                 # (T, k, d)
        b = models["intercept"]                            # (T, k)
        T, k, d = W.shape
        Z = torch.addmm(b.reshape(1, T * k), X, W.reshape(T * k, d).T)
        Z = Z.view(n, T, k).transpose(0, 1)                # (T, n, k)
        views = {}
        if meta["n_classes"] == 2:
            z = Z[:, :, 0]
            if "decision" in needed:
                views["decision"] = z
            if "pred" in needed:
                views["pred"] = (z > 0).long()
            if "proba" in needed:
                p1 = torch.sigmoid(z)
                views["proba"] = torch.stack([1.0 - p1, p1], dim=-1)
        else:
            if "decision" in needed:
                views["decision"] = Z
            if "pred" in needed:
                views["pred"] = torch.argmax(Z, dim=-1)
            if "proba" in needed:
                views["proba"] = torch.softmax(Z, dim=-1)
        return views

    @classmethod
    def predict(cls, model, static, X, meta):
        Z = cls.decision(model, static, X, meta)
        if meta["n_classes"] == 2:
            return (Z > 0).long()
        return torch.argmax(Z, dim=1)

    @classmethod
    def predict_proba(cls, model, static, X, meta):
        Z = cls.decision(model, static, X, meta)
        if meta["n_classes"] == 2:
            p1 = torch.sigmoid(Z)
            return torch.stack([1.0 - p1, p1], dim=1)
        return torch.softmax(Z, dim=1)

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        attrs = {
            "coef_": model["coef"].cpu().numpy(),
            "intercept_": model["intercept"].cpu().numpy(),
            "classes_": meta["classes"],
            "n_features_in_": meta["n_features"],
        }
        if "n_iter" in model:
            attrs["n_iter_"] = np.asarray([int(model["n_iter"])])
        return attrs


register_family(
    LogisticRegressionFamily,
    "sklearn.linear_model._logistic.LogisticRegression",
    "sklearn.linear_model.LogisticRegression",
    "spark_sklearn_tpu_torch.models.estimators.LogisticRegression",
)
