"""The linear families, lane-batched: logistic regression, Ridge,
LinearRegression and ElasticNet/Lasso.

Counterpart of `spark_sklearn_tpu/models/linear.py` (:46-676).  Numerics
follow sklearn, as the reference's do:

- LogisticRegression: minimise sum-logloss + 0.5/C * ||coef||^2
  (intercept unpenalised), lbfgs, tol on max|grad|; l1 and elasticnet by
  proximal FISTA (`_fista_elasticnet`), binary and multinomial.
- Ridge: weighted normal equations with an unpenalised intercept, in
  float64 (`wants_float64`).
- LinearRegression: the minimum-norm weighted least-squares solution, in
  float64.
- ElasticNet/Lasso: exactly `max_iter` FISTA steps on 1/(2n) LSQ +
  alpha*(l1_ratio*L1 + (1-l1_ratio)/2*L2), centred intercept, float32.

All (candidate x fold) lanes of a chunk fit as ONE batched problem: the
logits of every lane come from one GEMM of width B*k (`Ax`, K1), the
gradient pull-back is one GEMM (`AT`, K3), and the elementwise passes
between them are the hand-written kernels K2 (`glm_loss_grad`) and K4
(`glm_trial_loss`).  The lane axis sits at position 1 — Z is (n, B) or
(n, B, k) — so the kernels' loads coalesce over lanes.

LogisticRegression also takes a sparse X (`supports_sparse`, the
reference's BCOO path, `linear.py:31-39, 79-91, 203-297, 345-346`): under
`data_mode="sparse"` data["X"] is a `CSROperand` and K1 and K3 are its
products, X Wᵀ and Xᵀ G, both through SP1.  There the solver's state is
feature-major, (d + 1, B, k') with the intercepts as the last row
(`_sparse_problem`): the forward's D is a view of its first d rows and
SP1 writes the backward straight into the gradient's, so neither copies
the coefficients; the intercept's add and Σₙ G stay torch ops, and
`bf16_matmul` is ignored.

The keyed fleets (`keyed/keyed.py`) fit one problem a key, each on its
own rows: `fit_fleet(static, X (G, L, d), y (G, L), w (G, L), meta)`
and `predict_fleet(models, static, X (G, L, d), meta)`, the
reference's per-task `fit` and `predict` under `jax.vmap` over keys
(`keyed.py:271-279, 490-503`).  LogisticRegression runs the scalar
L-BFGS per key (`lbfgs_lanes`) with logits from `torch.bmm`, lane-major
(G, L[, k]), through K2ℓ and K4ℓ; Ridge and LinearRegression solve their
normal equations per key in float32, the dtype of the reference's fleet.

The reference writes the regressors as a per-task `fit` under
`jax.vmap`.  Here every lane of a fold has the same fold weights, so the
weighted means, centred Gram matrices and decompositions are computed
once per fold and each lane solves its own small problem, gathering its
fold's by ``t % n_folds`` (lanes are candidate-major; the search passes
the fold count as ``static["__n_folds__"]``).
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
    glm_loss_grad_lanes,
    glm_trial_loss,
    glm_trial_loss_lanes,
)
from spark_sklearn_tpu_torch.ops.solvers import (
    Lanes,
    fista_momentum,
    glm_fista_batched,
    glm_lbfgs_batched,
    lbfgs_lanes,
    soft_threshold,
)
from spark_sklearn_tpu_torch.sparse.csr import CSROperand, SparseOperand


def resolve_penalty(static: Dict[str, Any]):
    """(penalty, l1_ratio) as the reference resolves them
    (`linear.py:183-193`): penalty is "l2", "elasticnet" or None; "l1" is
    elasticnet with l1_ratio 1, and elasticnet with l1_ratio 0 is l2."""
    penalty = static.get("penalty", "l2")
    l1_ratio = static.get("l1_ratio", 0.0) or 0.0
    if penalty == "deprecated":
        # sklearn >= 1.8 sentinel: l2 unless l1_ratio mixes in l1
        penalty = "l2" if not l1_ratio else "elasticnet"
    if penalty == "l1":
        penalty, l1_ratio = "elasticnet", 1.0
    if penalty == "elasticnet" and not l1_ratio:
        penalty = "l2"   # pure l2: quasi-Newton is far cheaper
    if penalty == "none":
        penalty = None
    if penalty not in ("l2", "elasticnet", None):
        raise ValueError(f"penalty={penalty!r} is not supported")
    return penalty, float(l1_ratio)


def _bf16_operand(A):
    """`A` as an operand of `_bf16_mm`: bfloat16 on the card; on the CPU
    (the plain version) rounded to bfloat16 and cast back to float32."""
    if A.device.type == "cuda":
        return A.to(torch.bfloat16)
    return A.to(torch.bfloat16).to(A.dtype)


def _bf16_mm(A, B):
    """A @ B of two `_bf16_operand`s with float32 output: on the card one
    cuBLAS bf16 GEMM with float32 accumulation, on the CPU the rounded
    operands multiplied in float32 (`TorchConfig.bf16_matmul`, the
    reference's `preferred_element_type` GEMMs, linear.py:201-297)."""
    if A.device.type == "cuda":
        return torch.mm(A, B, out_dtype=torch.float32)
    return A @ B


def _affine(X, W, b):
    """X @ Wᵀ + b: one fused addmm for a dense X, SP1 over X's CSR then
    the add for a CSROperand."""
    if isinstance(X, CSROperand):
        return X @ W.T + b
    return torch.addmm(b, X, W.T)


def _lane_param(dynamic, static, name, default, B, like):
    """A hyperparameter as a (B,) tensor of `like`'s dtype and device:
    the lanes' own values if it is dynamic, else the shared one."""
    v = dynamic.get(name, static.get(name, default))
    return torch.as_tensor(v, device=like.device).to(like.dtype).expand(B)


class LogisticRegressionFamily(Family):
    name = "logistic_regression"
    is_classifier = True
    dynamic_params = {"C": np.float32, "tol": np.float32}
    #: the solvers touch X only through Ax and AT, both products a
    #: CSROperand computes
    supports_sparse = True

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        classes, y_enc = encode_labels(y)
        data = {"X": np.ascontiguousarray(X, dtype=dtype), "y": y_enc}
        meta = {"n_classes": int(len(classes)), "classes": classes,
                "n_features": int(X.shape[1])}
        return data, meta

    @classmethod
    def prepare_data_sparse(cls, X, y, dtype=np.float32):
        """X a scipy CSR, staged as a `SparseOperand` (the reference's
        `prepare_data_sparse`, linear.py:79-91)."""
        classes, y_enc = encode_labels(y)
        op = SparseOperand.from_csr(X, dtype=dtype)
        data = {"X": op, "y": y_enc}
        meta = {"n_classes": int(len(classes)), "classes": classes,
                "n_features": int(X.shape[1]), "sparse": op.signature()}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """All B lanes of a chunk as one batched problem: L-BFGS for the
        l2 or no penalty, FISTA for l1 and elasticnet.

        `dynamic` holds (B,) tensors, `train_w` (B, n) fold weights and
        `data` the device tensors X (n, d) float32 (or a CSROperand) and
        y (n,) int32.
        Returns a model dict with leading axis B: coef (B, k', d),
        intercept (B, k'), converged, n_iter (FISTA's rescaled onto
        max_iter) and n_iter_exec (the iterations run); k' = 1 when
        binary."""
        X, y = data["X"], data["y"]
        n, d = X.shape
        k = meta["n_classes"]
        B = train_w.shape[0]
        dev, dt = X.device, X.dtype

        C = _lane_param(dynamic, static, "C", 1.0, B, X)
        tol = _lane_param(dynamic, static, "tol", 1e-4, B, X)
        max_iter = int(static.get("max_iter", 100))
        fit_intercept = bool(static.get("fit_intercept", True))
        penalty, l1_ratio = resolve_penalty(static)
        train_w = apply_class_weight(
            train_w, y, meta, static.get("class_weight"))
        inv_C = 1.0 / C if penalty == "l2" else torch.zeros_like(C)
        wT = train_w.T.contiguous()                          # (n, B)

        kk = 1 if k == 2 else k              # logits per lane
        kd = kk * d
        # bf16 GEMM operands with float32 output (the solver's state, the
        # losses and the views stay float32), as the reference's
        # `__bf16__` (linear.py:201-208); a sparse X stays float32 there
        sparse_X = isinstance(X, CSROperand)
        bf16 = bool(static.get("__bf16__", False)) and not sparse_X
        Xm = _bf16_operand(X) if bf16 else None

        def loss_grad(Z):                    # K2
            return glm_loss_grad(Z, wT, y)

        def trial_loss(Z, Zp, alphas):       # K4
            return glm_trial_loss(Z, Zp, wT, y, alphas)

        if sparse_X:
            return _fit_sparse(X, k, B, C, inv_C, tol, max_iter,
                               fit_intercept, penalty, l1_ratio, loss_grad,
                               trial_loss)

        def Ax(x):                           # K1 -> Z (n, B) or (n, B, k)
            W = x[:, :kd].reshape(B * kk, d)
            b = x[:, kd:].reshape(1, B * kk)
            if bf16:
                Z = _bf16_mm(Xm, _bf16_operand(W).T)
                if fit_intercept:
                    Z = Z + b
            elif fit_intercept:
                Z = _affine(X, W, b)
            else:
                Z = X @ W.T
            return Z if k == 2 else Z.view(n, B, k)

        def AT(G):                           # K3 -> (B, kd + kk)
            G2 = G.reshape(n, B * kk)
            gW = (_bf16_mm(_bf16_operand(G2.T), Xm) if bf16
                  else G2.T @ X).reshape(B, kd)
            gb = G2.sum(dim=0).reshape(B, kk) if fit_intercept else \
                torch.zeros((B, kk), dtype=dt, device=dev)
            return torch.cat([gW, gb], dim=1)

        def reg_loss(x):                     # x (..., B, D) -> (..., B)
            return 0.5 * inv_C * (x[..., :kd] ** 2).sum(dim=-1)

        def reg_grad(x):
            return torch.cat([inv_C[:, None] * x[:, :kd],
                              torch.zeros((B, kk), dtype=dt, device=dev)],
                             dim=1)

        pen = torch.zeros((B, kd + kk), dtype=dt, device=dev)
        pen[:, :kd] = 1.0
        res, n_exec = _solve(penalty, Ax, AT, loss_grad, trial_loss,
                             reg_loss, reg_grad, pen, C, l1_ratio, max_iter,
                             tol)
        W = res.x[:, :kd].reshape(B, kk, d)
        b = res.x[:, kd:]
        if not fit_intercept:
            b = torch.zeros_like(b)
        return {"coef": W, "intercept": b, "converged": res.converged,
                "n_iter": res.n_iter, "n_iter_exec": n_exec}

    @classmethod
    def fit_fleet(cls, static, X, y, w, meta):
        """One fit a key (the reference's `fit`, `linear.py:93-158`, under
        `jax.vmap` over keys): X (G, L, d) float32, y (G, L) int32 encoded
        labels, w (G, L) row weights (0 on the padding).  The sum-loss
        plus l2 = 0.5/C times ||coef||^2 (l2 or none) by `lbfgs_lanes`.
        Returns coef (G, k', d), intercept (G, k'), n_iter, converged."""
        G, L, d = X.shape
        k = meta["n_classes"]
        penalty, _ = resolve_penalty(static)
        if penalty == "elasticnet":
            raise NotImplementedError(
                "keyed fleets of LogisticRegression with an l1 or "
                "elasticnet penalty are not ported; see ROADMAP.md Queue "
                "1, item 5 (keyed fleets still to port)")
        dt, dev = X.dtype, X.device
        C = torch.tensor(float(static.get("C", 1.0)), dtype=dt, device=dev)
        l2 = (0.5 / C if penalty == "l2" else torch.zeros((), dtype=dt,
                                                          device=dev))
        tol = float(static.get("tol", 1e-4))
        max_iter = int(static.get("max_iter", 100))
        fit_intercept = bool(static.get("fit_intercept", True))
        w = fleet_class_weight(w, y, meta, static.get("class_weight"))
        kk = 1 if k == 2 else k
        kd = kk * d

        def Ax(x):                           # -> Z (G, L) or (G, L, k)
            W = x[:, :kd].view(G, kk, d).transpose(1, 2)
            if fit_intercept:
                Z = torch.baddbmm(x[:, None, kd:], X, W)
            else:
                Z = torch.bmm(X, W)
            return Z.view(G, L) if k == 2 else Z

        def AT(dZ):                          # -> (G, kd + kk)
            G3 = dZ.view(G, L, kk)
            gW = torch.bmm(G3.transpose(1, 2), X).reshape(G, kd)
            gb = G3.sum(dim=1) if fit_intercept else \
                torch.zeros((G, kk), dtype=dt, device=dev)
            return torch.cat([gW, gb], dim=1)

        def loss_grad(Z):                    # K2ℓ
            return glm_loss_grad_lanes(Z, w, y)

        def trial_loss(Z, Zp, alphas, idx=None):   # K4ℓ
            if idx is None:
                return glm_trial_loss_lanes(Z, Zp, w, y, alphas)
            return glm_trial_loss_lanes(Z, Zp, w[idx].contiguous(),
                                        y[idx].contiguous(), alphas)

        pen = torch.zeros(kd + kk, dtype=dt, device=dev)
        pen[:kd] = 1.0
        res = lbfgs_lanes(Ax, loss_grad, trial_loss, AT,
                          torch.zeros((G, kd + kk), dtype=dt, device=dev),
                          l2.expand(G), pen, max_iter=max_iter, tol=tol)
        b = res.x[:, kd:] if fit_intercept else \
            torch.zeros((G, kk), dtype=dt, device=dev)
        return {"coef": res.x[:, :kd].reshape(G, kk, d), "intercept": b,
                "n_iter": res.n_iter, "converged": res.converged}

    @classmethod
    def predict_fleet(cls, models, static, X, meta):
        """(G, L) class indices of each key's rows X (G, L, d)."""
        Z = torch.baddbmm(models["intercept"][:, None, :], X,
                          models["coef"].transpose(1, 2))
        if meta["n_classes"] == 2:
            return (Z[:, :, 0] > 0).long()
        return torch.argmax(Z, dim=2)

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
        Z = _affine(X, W.reshape(T * k, d), b.reshape(1, T * k))
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


def fleet_class_weight(w, y, meta, class_weight):
    """Row weights w (G, L) with `class_weight` multiplied in, each key's
    own: "balanced" counts its rows with w > 0 (the reference's
    `class_weight_multiplier` under `jax.vmap` over keys)."""
    if class_weight is None:
        return w
    k = meta["n_classes"]
    y1h = torch.nn.functional.one_hot(y.long(), k).to(w.dtype)  # (G, L, k)
    if isinstance(class_weight, str):
        if class_weight != "balanced":
            raise ValueError(
                f"class_weight={class_weight!r} is not supported")
        ind = (w > 0).to(w.dtype)
        cnt = torch.bmm(ind[:, None, :], y1h)[:, 0]           # (G, k)
        n_eff = ind.sum(dim=1, keepdim=True)
        per_class = n_eff / (k * torch.clamp_min(cnt, 1.0))
        return w * torch.bmm(y1h, per_class[:, :, None])[:, :, 0]
    if isinstance(class_weight, dict):
        classes = list(meta["classes"])
        cw = np.ones(k, np.float64)
        for label, weight in class_weight.items():
            hits = [i for i, c in enumerate(classes) if c == label]
            if not hits:
                raise ValueError(
                    f"class_weight key {label!r} is not a class label")
            cw[hits[0]] = weight
        arr = torch.as_tensor(cw, dtype=w.dtype, device=w.device)
        return w * arr[y.long()]
    raise ValueError(f"class_weight={class_weight!r} is not supported")


def _fleet_center(static, X, y, w):
    """Each key's weighted centring (the reference's `_centered_problem`
    per key, `linear.py:433-449`): (Xc, yc, xm (G, d), ym (G,))."""
    if static.get("positive", False):
        raise ValueError("positive=True is not compiled")
    G, L, d = X.shape
    if not bool(static.get("fit_intercept", True)):
        return (X, y, torch.zeros((G, d), dtype=X.dtype, device=X.device),
                torch.zeros(G, dtype=X.dtype, device=X.device))
    wsum = w.sum(dim=1) + torch.finfo(X.dtype).eps
    xm = torch.bmm(w[:, None, :], X)[:, 0] / wsum[:, None]
    ym = (w * y).sum(dim=1) / wsum
    return X - xm[:, None, :], y - ym[:, None], xm, ym


def _fit_sparse(X, k, B, C, inv_C, tol, max_iter, fit_intercept, penalty,
                l1_ratio, loss_grad, trial_loss):
    """LogisticRegression's lanes over a CSROperand X (n, d): L-BFGS or
    FISTA on a feature-major state x (d + 1, B, k'), lane_dim 1 — rows
    0..d-1 the coefficients, row d the intercepts — so that the forward
    reads x[:d] as SP1's D (d, B k') and SP1 writes the backward into
    the gradient's first d rows, with no copy of either.  A lane's sums
    run over (d + 1, k'), in another order than the dense (B, k' d + k')
    state's.  Returns the family's model dict."""
    n, d = X.shape
    kk = 1 if k == 2 else k
    W = B * kk
    dt, dev = X.dtype, X.device
    shape = (d + 1, B, kk)

    def Ax(x):                               # K1 -> Z (n, B) or (n, B, k)
        Z = X.mm(x[:d].contiguous().view(d, W))
        if fit_intercept:
            Z += x[d].reshape(1, W)
        return Z if k == 2 else Z.view(n, B, k)

    def AT(G):                               # K3 -> (d + 1, B, k')
        G2 = G.reshape(n, W).contiguous()
        g = torch.empty(shape, dtype=dt, device=dev)
        X.tmm(G2, out=g[:d].view(d, W))
        if fit_intercept:
            g[d] = G2.sum(dim=0).view(B, kk)
        else:
            g[d] = 0.0
        return g

    def reg_loss(x):                         # x (..., d+1, B, k') -> (..., B)
        return 0.5 * inv_C * (x[..., :d, :, :] ** 2).sum(dim=(-3, -1))

    def reg_grad(x):
        g = x * inv_C.view(1, B, 1)
        g[d] = 0.0
        return g

    pen = torch.ones(shape, dtype=dt, device=dev)
    pen[d] = 0.0
    res, n_exec = _solve(penalty, Ax, AT, loss_grad, trial_loss, reg_loss,
                         reg_grad, pen, C, l1_ratio, max_iter, tol,
                         lane_dim=1)
    b = res.x[d] if fit_intercept else torch.zeros((B, kk), dtype=dt,
                                                   device=dev)
    return {"coef": res.x[:d].permute(1, 2, 0).contiguous(),
            "intercept": b, "converged": res.converged,
            "n_iter": res.n_iter, "n_iter_exec": n_exec}


def _solve(penalty, Ax, AT, loss_grad, trial_loss, reg_loss, reg_grad, pen,
           C, l1_ratio, max_iter, tol, lane_dim=0):
    """LogisticRegression's lanes from a zero state shaped like `pen` (1
    at the coefficients, 0 at the intercepts; lanes along `lane_dim`):
    FISTA for elasticnet, L-BFGS otherwise.  Returns (result, the
    iterations actually run)."""
    if penalty == "elasticnet":
        return _fista_elasticnet(Ax, loss_grad, AT, 1.0 / C, l1_ratio, pen,
                                 max_iter, tol, lane_dim)
    res = glm_lbfgs_batched(
        Ax, loss_grad, trial_loss, AT, reg_loss, reg_grad,
        torch.zeros_like(pen), max_iter=max_iter, tol=tol,
        lane_dim=lane_dim)
    return res, res.n_iter


def _fista_elasticnet(Ax, loss_grad, AT, inv_C, l1_ratio, pen, max_iter,
                      tol, lane_dim=0):
    """Elastic-net logistic regression by proximal FISTA (the reference's
    `_fista_elasticnet`, `linear.py:399-430`): per-coefficient l1/l2
    weights where `pen` (shaped like the state, lanes along `lane_dim`)
    is 1 (the coefficients), unpenalised intercepts.  The internal
    budget is max(10*max_iter, 1000) steps (cheaper than saga's epochs,
    which sklearn caps at max_iter), and the reported n_iter is rescaled
    onto max_iter so that sklearn's "n_iter_ >= max_iter means not
    converged" holds.  Returns (result with the rescaled n_iter, the
    iterations actually run)."""
    dt, dev = inv_C.dtype, inv_C.device
    lanes = Lanes(pen, lane_dim)
    l1r = torch.as_tensor(l1_ratio, dtype=dt, device=dev)
    res = glm_fista_batched(
        Ax, loss_grad, AT,
        l1=lanes.b(inv_C * l1r) * pen,
        l2=lanes.b(inv_C * (1.0 - l1r)) * pen,
        x0=torch.zeros(pen.shape, dtype=dt, device=dev),
        max_iter=max(10 * max_iter, 1000), tol=tol, lane_dim=lane_dim)
    n_rep = torch.where(res.converged,
                        torch.clamp_max(res.n_iter, max_iter - 1),
                        max_iter).to(res.n_iter.dtype)
    return res._replace(n_iter=n_rep), res.n_iter


# ----------------------------------------------------------------------------
# Ridge / LinearRegression / ElasticNet
# ----------------------------------------------------------------------------

def _fold_problems(static, X, y, train_w):
    """The per-fold preamble shared by the regressors (the reference's
    `_centered_problem`, `linear.py:441-450`, once per fold): the
    positive= guard, each lane's fold f (B,) — lane t is fold
    t % n_folds, and lanes 0..n_folds-1 carry each fold's weights once —
    the folds' weights wF (F, n) and, with an intercept, their weighted
    centring.  Returns (f, wF, Xc (F, n, d), yc (F, n), xm (F, d),
    ym (F,))."""
    if static.get("positive", False):
        raise ValueError("positive=True is not compiled")
    B, (n, d) = train_w.shape[0], X.shape
    n_folds = int(static.get("__n_folds__", B))
    if B % n_folds:
        raise ValueError(f"{B} lanes are not a whole number of "
                         f"{n_folds}-fold candidates")
    f = torch.arange(B, device=X.device) % n_folds
    wF = train_w[:n_folds]
    if not bool(static.get("fit_intercept", True)):
        zeros = torch.zeros((n_folds,), dtype=X.dtype, device=X.device)
        return (f, wF, X.expand(n_folds, n, d), y.expand(n_folds, n),
                zeros[:, None].expand(n_folds, d), zeros)
    wsum = wF.sum(dim=1) + torch.finfo(X.dtype).eps
    xm = (wF @ X) / wsum[:, None]
    ym = (wF * y).sum(dim=1) / wsum
    return f, wF, X - xm[:, None, :], y - ym[:, None], xm, ym


class RidgeFamily(Family):
    name = "ridge"
    is_classifier = False
    dynamic_params = {"alpha": np.float32}
    # closed-form normal equations: the Gram's conditioning amplifies
    # float32 rounding far past sklearn's float64 answers, so the search
    # runs this family in float64 (d x d solves: negligible cost)
    wants_float64 = True

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        data = {"X": np.ascontiguousarray(X, dtype=dtype),
                "y": np.ascontiguousarray(y, dtype=dtype)}
        meta = {"n_features": int(X.shape[1])}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """(A + alpha*I) w = b per lane, A = Xcᵀ W Xc and b = Xcᵀ W yc of
        its fold, by a batched Cholesky factor and solve.  A lane whose
        matrix is not positive definite gets NaN coefficients (the
        reference's `solve(assume_a="pos")` does the same), which the
        search reports as a failed fit."""
        X, y = data["X"], data["y"]
        B, d = train_w.shape[0], X.shape[1]
        alpha = _lane_param(dynamic, static, "alpha", 1.0, B, X)
        f, wF, Xc, yc, xm, ym = _fold_problems(static, X, y, train_w)
        Xw = Xc * wF[:, :, None]
        A = Xw.transpose(1, 2) @ Xc                          # (F, d, d)
        b = Xw.transpose(1, 2) @ yc[:, :, None]              # (F, d, 1)
        eye = torch.eye(d, dtype=X.dtype, device=X.device)
        factor, info = torch.linalg.cholesky_ex(
            A[f] + alpha[:, None, None] * eye)
        w = torch.cholesky_solve(b[f], factor)[:, :, 0]
        w = torch.where((info == 0)[:, None], w, torch.nan)
        return {"coef": w, "intercept": ym[f] - (xm[f] * w).sum(dim=1)}

    @classmethod
    def fit_fleet(cls, static, X, y, w, meta):
        """One fit a key (the reference's `fit`, `linear.py:473-484`,
        under `jax.vmap`): (A + alpha I) coef = b, A = Xwᵀ Xc, b = Xwᵀ yc
        of the key's centred rows, by a batched Cholesky factor and solve
        in X's dtype; a key whose matrix is not positive definite gets
        NaN coefficients (the reference's `solve(assume_a="pos")`)."""
        d = X.shape[2]
        alpha = float(static.get("alpha", 1.0))
        Xc, yc, xm, ym = _fleet_center(static, X, y, w)
        Xw = Xc * w[:, :, None]
        A = torch.bmm(Xw.transpose(1, 2), Xc)
        b = torch.bmm(Xw.transpose(1, 2), yc[:, :, None])
        eye = torch.eye(d, dtype=X.dtype, device=X.device)
        factor, info = torch.linalg.cholesky_ex(A + alpha * eye)
        coef = torch.cholesky_solve(b, factor)[:, :, 0]
        coef = torch.where((info == 0)[:, None], coef, torch.nan)
        return {"coef": coef, "intercept": ym - (xm * coef).sum(dim=1)}

    @classmethod
    def predict_fleet(cls, models, static, X, meta):
        """(G, L) predictions of each key's rows X (G, L, d)."""
        return torch.bmm(X, models["coef"][:, :, None])[:, :, 0] \
            + models["intercept"][:, None]

    @classmethod
    def predict(cls, model, static, X, meta):
        return X @ model["coef"] + model["intercept"]

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """All T tasks' predictions from ONE (T, d) @ (d, n) GEMM:
        "pred" (T, n)."""
        if "pred" not in needed:
            return {}
        return {"pred": torch.addmm(models["intercept"][:, None],
                                    models["coef"], data["X"].T)}

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        return {"coef_": model["coef"].cpu().numpy(),
                "intercept_": float(model["intercept"]),
                "n_features_in_": meta["n_features"]}


class LinearRegressionFamily(RidgeFamily):
    name = "linear_regression"

    @classmethod
    def fit_fleet(cls, static, X, y, w, meta):
        """One fit a key (the reference's `fit`, `linear.py:560-575`):
        the minimum-norm least squares of the key's centred rows scaled
        by sqrt(w), by SVD, singular values below eps max(L, d) s_max
        counted as zero (`jnp.linalg.lstsq`'s cut-off)."""
        G, L, d = X.shape
        Xc, yc, xm, ym = _fleet_center(static, X, y, w)
        sw = torch.sqrt(w)
        U, S, Vh = torch.linalg.svd(Xc * sw[:, :, None], full_matrices=False)
        rcond = torch.finfo(X.dtype).eps * max(L, d)
        keep = (S > 0) & (S >= rcond * S[:, :1])
        s_inv = torch.where(keep, 1.0 / torch.where(keep, S, 1.0), 0.0)
        uTb = torch.bmm(U.transpose(1, 2), (yc * sw)[:, :, None])
        coef = torch.bmm(Vh.transpose(1, 2), s_inv[:, :, None] * uTb)[:, :, 0]
        return {"coef": coef, "intercept": ym - (xm * coef).sum(dim=1)}

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """Weighted OLS as the minimum-norm least-squares solution, per
        fold: the SVD of Xc*sqrt(w) on the device, singular values below
        eps*max(n, d)*s_max counted as zero (the cut-off of the
        reference's `jnp.linalg.lstsq`).  On rank-deficient X this is
        sklearn's answer; a QR-based solver (`gels`, the only method of
        torch's `lstsq` on CUDA) assumes full rank and is not."""
        X, y = data["X"], data["y"]
        n, d = X.shape
        f, wF, Xc, yc, xm, ym = _fold_problems(static, X, y, train_w)
        sw = torch.sqrt(wF)
        U, S, Vh = torch.linalg.svd(Xc * sw[:, :, None], full_matrices=False)
        rcond = torch.finfo(X.dtype).eps * max(n, d)
        keep = (S > 0) & (S >= rcond * S[:, :1])
        s_inv = torch.where(keep, 1.0 / torch.where(keep, S, 1.0), 0.0)
        uTb = U.transpose(1, 2) @ (yc * sw)[:, :, None]      # (F, r, 1)
        w = (Vh.transpose(1, 2) @ (s_inv[:, :, None] * uTb))[:, :, 0][f]
        return {"coef": w, "intercept": ym[f] - (xm[f] * w).sum(dim=1)}


class ElasticNetFamily(Family):
    name = "elastic_net"
    is_classifier = False
    dynamic_params = {"alpha": np.float32, "l1_ratio": np.float32}

    prepare_data = RidgeFamily.prepare_data

    @classmethod
    def extract_params(cls, estimator):
        params = dict(estimator.get_params(deep=False))
        if type(estimator).__name__ == "Lasso":
            params["l1_ratio"] = 1.0
        return params

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """Exactly `max_iter` FISTA steps per lane (the reference's
        `lax.scan` has no early stop and never reads `tol`), step 1/L with
        L from 30 power iterations on the fold's Gram G = Xwᵀ Xc / n_eff
        plus alpha*(1 - l1_ratio) + 1e-6.

        The gradient is the reference's residual form
        Xwᵀ(Xc z - yc)/n_eff + lam2*z, lane-batched without a (B, n, d)
        centred copy: Xc z = X zᵀ - xm·z is one (n, B) GEMM, and
        Xcᵀ(w ⊙ r) = Xᵀ(w ⊙ r) - xm Σ(w ⊙ r) one (B, n) @ (n, d) GEMM."""
        X, y = data["X"], data["y"]
        B, d = train_w.shape[0], X.shape[1]
        dt, dev = X.dtype, X.device
        alpha = _lane_param(dynamic, static, "alpha", 1.0, B, X)
        l1r = _lane_param(dynamic, static, "l1_ratio", 0.5, B, X)
        max_iter = int(static.get("max_iter", 1000))
        f, wF, Xc, _, xm, ym = _fold_problems(static, X, y, train_w)
        eps = torch.finfo(dt).eps
        n_eff = wF.sum(dim=1) + eps                          # (F,)
        Xw = Xc * wF[:, :, None]
        G = Xw.transpose(1, 2) @ Xc / n_eff[:, None, None]
        v = torch.full((G.shape[0], d, 1),
                       float(np.float32(1.0) / np.sqrt(np.float32(d))),
                       dtype=dt, device=dev)
        for _ in range(30):
            v = G @ v
            v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + eps)
        L_fold = (v * (G @ v)).sum(dim=(1, 2))               # (F,)

        L = L_fold[f] + alpha * (1.0 - l1r) + 1e-6
        lam1, lam2 = alpha * l1r, alpha * (1.0 - l1r)
        xm_l, ym_l, n_l = xm[f], ym[f], n_eff[f]
        wT = train_w.T.contiguous()                          # (n, B)
        L_col, thresh = L[:, None], (lam1 / L)[:, None]

        def grad(z):                                         # z (B, d)
            R = torch.addmm((ym_l - (xm_l * z).sum(dim=1))[None, :], X,
                            z.T) - y[:, None]                # Xc z - yc
            WR = wT * R                                      # (n, B)
            g = WR.T @ X - xm_l * WR.sum(dim=0)[:, None]
            return g / n_l[:, None] + lam2[:, None] * z

        w = z = torch.zeros((B, d), dtype=dt, device=dev)
        t = np.float32(1.0)
        for _ in range(max_iter):
            w_new = soft_threshold(z - grad(z) / L_col, thresh)
            t, beta = fista_momentum(t)
            z = w_new + beta * (w_new - w)
            w = w_new
        return {"coef": w, "intercept": ym_l - (xm_l * w).sum(dim=1)}

    predict = RidgeFamily.predict
    views_task_batched = RidgeFamily.views_task_batched
    sklearn_attrs = RidgeFamily.sklearn_attrs


register_family(
    LogisticRegressionFamily,
    "sklearn.linear_model._logistic.LogisticRegression",
    "sklearn.linear_model.LogisticRegression",
    "spark_sklearn_tpu_torch.models.estimators.LogisticRegression",
)
register_family(
    RidgeFamily,
    "sklearn.linear_model._ridge.Ridge",
    "sklearn.linear_model.Ridge",
    "spark_sklearn_tpu_torch.models.estimators.Ridge",
)
register_family(
    LinearRegressionFamily,
    "sklearn.linear_model._base.LinearRegression",
    "sklearn.linear_model.LinearRegression",
    "spark_sklearn_tpu_torch.models.estimators.LinearRegression",
)
register_family(
    ElasticNetFamily,
    "sklearn.linear_model._coordinate_descent.ElasticNet",
    "sklearn.linear_model.ElasticNet",
    "sklearn.linear_model._coordinate_descent.Lasso",
    "sklearn.linear_model.Lasso",
    "spark_sklearn_tpu_torch.models.estimators.ElasticNet",
    "spark_sklearn_tpu_torch.models.estimators.Lasso",
)
