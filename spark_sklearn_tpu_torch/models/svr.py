"""SVR, NuSVR, LinearSVC and LinearSVR families, lane-batched.

Counterpart of `spark_sklearn_tpu/models/svr.py`.

- SVR and NuSVR solve libsvm's epsilon- and nu-SVR duals with SVC's
  accelerated projected ascent (`models/svm.py` `_box_fista`): the pairs
  u = (a, a*) of a subproblem live in one (M, 2n) row with signs s =
  (+1ⁿ, −1ⁿ), the equality Σ(a − a*) = 0 is SVC's hyperplane with s for
  labels (nu-SVR: each half's sum fixed), and the tiled kernel [[K, K],
  [K, K]] acts through one (M, n) @ (n, n) product of β = a − a* a step.
  On the card the kernel matrix is the library GEMM plus S1, and each
  step the product β K plus S2's SVR mode (`ops/svm_kernels.py`
  `svr_dual_step`: the linear term s·y − ε formed in the kernel from y
  and ε, and β' written for the next product); on the CPU their plain
  versions.  The power-method step halves (the tiled matrix's top
  eigenvalue is 2 λ_max(K)).
- LinearSVC and LinearSVR solve liblinear's problems with liblinear's
  regularised intercept column (`intercept_scaling`): the squared hinge
  and squared epsilon-insensitive losses by the port's batched L-BFGS
  (`ops/solvers.py` `glm_lbfgs_batched`, with torch-op loss closures),
  the hinge and epsilon-insensitive losses by their box-constrained duals
  on `_box_fista` (a clip, or a soft threshold then a clip).  Their
  products are library GEMMs; one-vs-rest for k > 2.

`kernel="precomputed"`, `penalty="l1"` and `multi_class="crammer_singer"`
raise, as the reference's compiled families do.
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
from spark_sklearn_tpu_torch.models.svm import (
    _box_fista,
    _f32,
    _finite_mid,
    _fold_scale_gamma,
    _kernel,
    _kernel_args,
    kernel_host_reason,
    _masked_mean_or_mid,
    _max_iter,
    _power_step,
    _resolve_gamma,
    _tol_or_default,
)
from spark_sklearn_tpu_torch.ops.solvers import glm_lbfgs_batched
from spark_sklearn_tpu_torch.ops.svm_kernels import svr_dual_step


def _run_svr(K, y, bound_half, step, max_iter, tol, eps=None, target=None,
             x0=None, beta0=None):
    """`_box_fista` on the stacked (a, a*) rows: each step β K, then S2's
    SVR mode.  Returns (U (M, 2n), executed steps: the max over the rows
    with a tol, else max_iter)."""
    M, n = bound_half.shape

    def advance(x, z, beta, coef):
        return svr_dual_step(beta @ K, z, x, y, eps, bound_half, step, coef,
                             target)

    if x0 is None:
        x0 = torch.zeros((M, 2 * n), dtype=K.dtype, device=K.device)
        beta0 = torch.zeros_like(bound_half)
    if tol is None:
        return _box_fista(advance, x0, beta0, max_iter), \
            torch.tensor(max_iter, dtype=torch.int32)
    U, n_it, _ = _box_fista(advance, x0, beta0, max_iter, tol=tol)
    return U, n_it.max()


def _free_masks(U, bound_half):
    n = bound_half.shape[1]
    a, a_star = U[:, :n], U[:, n:]
    inb = bound_half > 0
    t_lo = bound_half * 1e-6
    t_hi = bound_half * (1.0 - 1e-6)
    free_a = inb & (a > t_lo) & (a < t_hi)
    free_as = inb & (a_star > t_lo) & (a_star < t_hi)
    return a, a_star, inb, t_lo, t_hi, free_a, free_as


def _svr_intercept(f0, U, y, eps, bound_half):
    """KKT intercept of epsilon-SVR (svr.py:83-114): over free SVs y − f0 −
    b = +eps (0 < a < C) or −eps (0 < a* < C); with none free, the
    midpoint of the feasible interval.  f0 = β K."""
    E = y[None, :] - f0
    eps = eps[:, None]
    a, a_star, inb, t_lo, t_hi, free_a, free_as = _free_masks(U, bound_half)
    nfree = free_a.sum(dim=1) + free_as.sum(dim=1)
    zero = torch.zeros((), dtype=E.dtype, device=E.device)
    inf = torch.tensor(torch.inf, dtype=E.dtype, device=E.device)
    b_free = (torch.where(free_a, E - eps, zero).sum(dim=1)
              + torch.where(free_as, E + eps, zero).sum(dim=1)) \
        / torch.clamp_min(nfree, 1)
    lb = torch.maximum(
        torch.where(inb & (a <= t_lo), E - eps, -inf).amax(dim=1),
        torch.where(inb & (a_star >= t_hi), E + eps, -inf).amax(dim=1))
    ub = torch.minimum(
        torch.where(inb & (a >= t_hi), E - eps, inf).amin(dim=1),
        torch.where(inb & (a_star <= t_lo), E + eps, inf).amin(dim=1))
    return torch.where(nfree > 0, b_free, _finite_mid(lb, ub))


def _svr_solve(K, y, eps, bound_half, step, max_iter, tol=None):
    """The epsilon-SVR dual of M subproblems (svr.py:48-80): (β (M, n),
    f0 = β K, b (M,), executed steps).  eps (M,)."""
    U, n_it = _run_svr(K, y, bound_half, step, max_iter, tol, eps=eps)
    n = y.shape[0]
    beta = U[:, :n] - U[:, n:]
    f0 = beta @ K
    return beta, f0, _svr_intercept(f0, U, y, eps, bound_half), n_it


def svr_dual_ascent(K, y, eps, bound_half, step, max_iter, tol=None):
    """Projected ascent on the epsilon-SVR dual (the reference's
    `svr_dual_ascent`): (β, b, n_iter)."""
    beta, _, b, n_it = _svr_solve(K, y, eps, bound_half, step, max_iter,
                                  tol)
    return beta, b, n_it


def _nu_svr_solve(K, y, nu, bound_half, step, max_iter, tol=None):
    """libsvm's nu-SVR dual (svr.py:117-170): each half sums to nu/2 of
    the row's box capacity, epsilon implicit.  Returns (β, f0 = β K, b,
    executed steps); b is NaN where the target is infeasible."""
    M, n = bound_half.shape
    cap = bound_half.sum(dim=1)
    target = (0.5 * nu * cap).expand(M).contiguous()
    feasible = target <= cap * (1.0 + 1e-6)
    zeros2 = torch.zeros((M, 2 * n), dtype=K.dtype, device=K.device)
    x0, _, beta0, _ = svr_dual_step(None, zeros2, zeros2, y, None,
                                    bound_half, step, 0.0, target)
    U, n_it = _run_svr(K, y, bound_half, step, max_iter, tol, target=target,
                       x0=x0, beta0=beta0)
    beta = U[:, :n] - U[:, n:]
    f0 = beta @ K
    E = y[None, :] - f0
    a, a_star, inb, t_lo, t_hi, free_a, free_as = _free_masks(U, bound_half)
    m_a = _masked_mean_or_mid(E, free_a, inb & (a <= t_lo),
                              inb & (a >= t_hi))
    m_as = _masked_mean_or_mid(E, free_as, inb & (a_star >= t_hi),
                               inb & (a_star <= t_lo))
    b = 0.5 * (m_a + m_as)
    return beta, f0, torch.where(feasible, b, torch.nan), n_it


def nu_svr_dual_ascent(K, y, nu, bound_half, step, max_iter, tol=None):
    """The reference's `nu_svr_dual_ascent`: (f (M, n) = β K + b, NaN
    rows where infeasible; n_iter)."""
    _, f0, b, n_it = _nu_svr_solve(K, y, nu, bound_half, step, max_iter,
                                   tol)
    return f0 + b[:, None], n_it


class SVRFamily(Family):
    name = "svr"
    is_classifier = False
    #: a Pipeline hands it per-fold transformed inputs, data["X_folds"]
    accepts_fold_inputs = True
    dynamic_params = {"C": np.float32, "gamma": np.float32,
                      "epsilon": np.float32}
    #: the third per-candidate scalar beside C and gamma (NuSVR: nu)
    aux_param = "epsilon"
    aux_default = 0.1
    #: the search's tier predicate over a candidate's static parameters
    host_reason = staticmethod(kernel_host_reason)

    @classmethod
    def _solve(cls, K, y, C_c, aux_c, w_rows, step, max_iter, tol=None):
        """(β, f0 = β K, b, steps) of the subproblems of rows `w_rows`."""
        M = w_rows.shape[0]
        eps = torch.as_tensor(aux_c, dtype=K.dtype,
                              device=K.device).expand(M).contiguous()
        return _svr_solve(K, y, eps, C_c * w_rows, step, max_iter, tol)

    @staticmethod
    def max_tasks_hint(n_samples: int, meta) -> int:
        budget = 1 << 30
        return max(1, budget // max(1, n_samples * 8))

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        data = {"X": np.ascontiguousarray(X, dtype=dtype),
                "y": np.ascontiguousarray(y, dtype=dtype)}
        meta = {"n_features": int(X.shape[1]),
                "x_var": float(np.var(np.asarray(X)))}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """Candidate-major tasks (task t = (cand t // F, fold t % F)): one
        kernel matrix a candidate (a fold's, in a Pipeline) shared by its
        F fold subproblems.  Returns the full-set regression values "f"
        (B, n) and "n_iter" (B,), as the reference caches them."""
        X, y = data["X"], data["y"]
        X_folds = data.get("X_folds")
        n = X.shape[0]
        dev, dt = X.device, X.dtype
        B = train_w.shape[0]
        kind, degree, coef0 = _kernel_args(static)
        max_iter = _max_iter(static)
        tol_exit = _tol_or_default(static)
        n_folds = int(static.get("__n_folds__", 0))
        if n_folds <= 0:
            raise ValueError("engine must pass __n_folds__ for SVR")
        nc = B // n_folds
        n_real = min(nc, int(static.get("__n_real__", nc)))

        gamma_default = _resolve_gamma(static.get("gamma", "scale"), meta)
        ap = cls.aux_param

        def per_cand(value):
            return torch.as_tensor(value, device=dev).to(dt).expand(
                B).reshape(nc, n_folds)[:, 0]

        C_cand = per_cand(dynamic.get("C", static.get("C", 1.0)))
        e_cand = per_cand(dynamic.get(ap, static.get(ap, cls.aux_default)))
        g_cand = per_cand(dynamic.get("gamma", gamma_default)).cpu().tolist()
        w_cand = train_w.reshape(nc, n_folds, n)
        g_fold = None
        if X_folds is not None and "gamma" not in dynamic and \
                static.get("gamma", "scale") == "scale":
            g_fold = _fold_scale_gamma(X_folds, w_cand[0])

        K_buf = torch.empty((n, n), dtype=dt, device=dev)
        f = torch.empty((B, n), dtype=dt, device=dev)
        its = []
        for c in range(n_real):
            if X_folds is None:
                K = _kernel(X, X, kind, g_cand[c], degree, coef0, out=K_buf)
                _, f0, b, it = cls._solve(K, y, C_cand[c], e_cand[c],
                                          w_cand[c], 0.5 * _power_step(K),
                                          max_iter, tol_exit)
                fc = f0 + b[:, None]
            else:
                rows, fold_its = [], []
                for fi in range(n_folds):
                    g = g_cand[c] if g_fold is None else g_fold[fi]
                    K = _kernel(X_folds[fi], X_folds[fi], kind, g, degree,
                                coef0, out=K_buf)
                    _, f0, b, it_f = cls._solve(
                        K, y, C_cand[c], e_cand[c], w_cand[c, fi][None],
                        0.5 * _power_step(K), max_iter, tol_exit)
                    rows.append(f0[0] + b[0])
                    fold_its.append(torch.as_tensor(it_f, device=dev))
                fc = torch.stack(rows)
                it = torch.stack(fold_its).max()
            f[c * n_folds:(c + 1) * n_folds] = fc
            its.append(torch.as_tensor(it, device=dev))
        last = f[(n_real - 1) * n_folds:n_real * n_folds]
        for c in range(n_real, nc):
            f[c * n_folds:(c + 1) * n_folds] = last
            its.append(its[-1])
        n_iter = torch.stack(its).to(torch.int32)
        return {"f": f, "n_iter": n_iter.repeat_interleave(n_folds)}

    @classmethod
    def fit_representer(cls, X, y, static, meta, w=None):
        """The full-data fit of one estimator: {"sv_X": X, "beta": (n,),
        "intercept": ()}; predictions are K(X', X) β + b.  `w` (n,), the
        sample weights (all ones by default), scales each sample's box
        bound as a fold mask does."""
        kind, degree, coef0 = _kernel_args(static)
        gamma = _f32(_resolve_gamma(static.get("gamma", "scale"), meta))
        K = _kernel(X, X, kind, gamma, degree, coef0)
        if w is None:
            w = torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
        ap = cls.aux_param
        beta, _, b, _ = cls._solve(
            K, y, _f32(static.get("C", 1.0)),
            _f32(static.get(ap, cls.aux_default)), w[None, :],
            0.5 * _power_step(K), _max_iter(static), _tol_or_default(static))
        if not bool(torch.isfinite(b).all()):
            raise ValueError("specified nu is infeasible")
        return {"sv_X": X, "beta": beta[0], "intercept": b[0]}

    @classmethod
    def predict(cls, model, static, X, meta):
        if "f" in model:
            return model["f"]
        g = _f32(_resolve_gamma(static.get("gamma", "scale"), meta))
        kind, degree, coef0 = _kernel_args(static)
        K = _kernel(X, model["sv_X"], kind, g, degree, coef0)
        return K @ model["beta"] + model["intercept"]

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """The "pred" view of all T tasks: their cached f (T, n)."""
        return {"pred": models["f"]} if "pred" in needed else {}

    @classmethod
    def sklearn_attrs(cls, model, static, meta) -> Dict[str, Any]:
        return {"n_features_in_": meta["n_features"]}


class NuSVRFamily(SVRFamily):
    """nu-SVR: SVR's scaffold with libsvm's nu dual: box C a sample, each
    half's sum C·nu·l/2, epsilon implicit (recovered with b from the free
    SVs); NaN decisions where infeasible."""

    name = "nu_svr"
    dynamic_params = {"C": np.float32, "gamma": np.float32,
                      "nu": np.float32}
    aux_param = "nu"
    aux_default = 0.5

    @classmethod
    def _solve(cls, K, y, C_c, aux_c, w_rows, step, max_iter, tol=None):
        nu = torch.as_tensor(aux_c, dtype=K.dtype, device=K.device)
        return _nu_svr_solve(K, y, nu, C_c * w_rows, step, max_iter, tol)


# ----------------------------------------------------------------------------
# liblinear primal and dual families
# ----------------------------------------------------------------------------

def linear_svc_host_reason(static):
    """Why a LinearSVC candidate runs on the search's host tier, or None:
    the device path solves the l2-penalised ovr problem with the hinge
    or squared hinge loss."""
    if static.get("penalty", "l2") != "l2":
        return "penalty='l1' is not compiled"
    if static.get("loss", "squared_hinge") not in ("squared_hinge", "hinge"):
        return f"loss={static.get('loss')!r} is not compiled"
    if static.get("multi_class", "ovr") != "ovr":
        return "multi_class='crammer_singer' is not compiled"
    return None


def _check_linear_svc_static(static):
    reason = linear_svc_host_reason(static)
    if reason is not None:
        raise ValueError(reason)


def _gram_step(Xa):
    """1 / λ_max(Xa Xaᵀ) by 20 power steps through the factored Gram (two
    (n, da) products a step; svr.py:320-333); a 0-dim tensor."""
    n = Xa.shape[0]
    v = torch.ones(n, dtype=Xa.dtype, device=Xa.device) / torch.sqrt(
        torch.tensor(float(n), dtype=Xa.dtype))
    for _ in range(20):
        u = Xa @ (v @ Xa)
        v = u / (torch.linalg.vector_norm(u) + 1e-30)
    return 1.0 / (torch.dot(v, Xa @ (v @ Xa)) + 1e-6)


def _augment(X, static):
    """liblinear's intercept column: X with `intercept_scaling` appended
    (regularised like any coefficient), or X."""
    if not bool(static.get("fit_intercept", True)):
        return X
    isc = float(static.get("intercept_scaling", 1.0))
    return torch.cat([X, torch.full((X.shape[0], 1), isc, dtype=X.dtype,
                                    device=X.device)], dim=1)


def _split_coef(W, d, static):
    """(coef, intercept) from the augmented weights W (..., da)."""
    if bool(static.get("fit_intercept", True)):
        isc = float(static.get("intercept_scaling", 1.0))
        return W[..., :d], W[..., d] * isc
    return W, torch.zeros(W.shape[:-1], dtype=W.dtype, device=W.device)


def _lane_tensor(value, B, like):
    return torch.as_tensor(value, device=like.device).to(like.dtype).expand(
        B).contiguous()


class LinearSVCFamily(Family):
    """liblinear's L2-regularised LinearSVC, one-vs-rest (one machine when
    binary): squared hinge by L-BFGS on the primal, hinge by projected
    Nesterov on its box dual."""

    name = "linear_svc"
    is_classifier = True
    dynamic_params = {"C": np.float32, "tol": np.float32}
    #: the search's tier predicate over a candidate's static parameters
    host_reason = staticmethod(linear_svc_host_reason)

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        classes, y_enc = encode_labels(y)
        data = {"X": np.ascontiguousarray(X, dtype=dtype), "y": y_enc,
                "y1h": np.eye(len(classes), dtype=dtype)[y_enc]}
        meta = {"n_classes": int(len(classes)), "classes": classes,
                "n_features": int(X.shape[1])}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        _check_linear_svc_static(static)
        X = data["X"]
        n, d = X.shape
        k = meta["n_classes"]
        ko = 1 if k == 2 else k
        B = train_w.shape[0]
        C = _lane_tensor(dynamic.get("C", static.get("C", 1.0)), B, X)
        tol = _lane_tensor(dynamic.get("tol", static.get("tol", 1e-4)), B, X)
        max_iter = int(static.get("max_iter", 1000))
        train_w = apply_class_weight(train_w, data["y"], meta,
                                     static.get("class_weight"))
        Xa = _augment(X, static)
        da = Xa.shape[1]
        if k == 2:
            T = (2.0 * data["y"].to(X.dtype) - 1.0)[:, None]    # (n, 1)
        else:
            T = 2.0 * data["y1h"] - 1.0                         # (n, k)

        if static.get("loss", "squared_hinge") == "hinge":
            # liblinear's l1-loss dual a machine: min 0.5 a'Qa − 1'a over
            # 0 <= a_i <= C w_i, Q = diag(t) Xa Xaᵀ diag(t)
            step = _gram_step(Xa)
            Tt = T.T[None, :, :]                                # (1, ko, n)
            bound = C[:, None, None] * train_w[:, None, :]      # (B, 1, n)
            zero = torch.zeros((), dtype=X.dtype, device=X.device)

            def advance(x, z, w, coef):
                v = torch.einsum("bkn,nd->bkd", z * Tt, Xa)
                grad = torch.einsum("bkd,nd->bkn", v, Xa) * Tt - 1.0
                x_new = torch.minimum(torch.maximum(z - step * grad, zero),
                                      bound)
                z_new = x_new + coef * (x_new - x)
                resid = (x_new - z).abs().amax(dim=(1, 2)) / step
                return x_new, z_new, None, resid

            a0 = torch.zeros((B, ko, n), dtype=X.dtype, device=X.device)
            a, n_iter, converged = _box_fista(advance, a0, None, max_iter,
                                              tol=tol)
            W = torch.einsum("bkn,nd->bkd", a * Tt, Xa)         # (B, ko, da)
            coef, intercept = _split_coef(W, d, static)
            return {"coef": coef, "intercept": intercept,
                    "converged": converged, "n_iter": n_iter}

        wT = train_w.T                                          # (n, B)

        def Ax(x):
            return torch.einsum("nd,bkd->nbk", Xa, x.reshape(B, ko, da))

        def loss_grad(Z):
            r = torch.clamp_min(1.0 - T[:, None, :] * Z, 0.0)
            loss = C * (wT[:, :, None] * r * r).sum(dim=(0, 2))
            G = C[None, :, None] * wT[:, :, None] * (-2.0 * T[:, None, :] * r)
            return loss, G

        def trial_loss(Z, Zp, alphas):
            out = []
            for a in alphas:
                r = torch.clamp_min(
                    1.0 - T[:, None, :] * (Z + a[None, :, None] * Zp), 0.0)
                out.append(C * (wT[:, :, None] * r * r).sum(dim=(0, 2)))
            return torch.stack(out)

        def AT(G):
            return torch.einsum("nbk,nd->bkd", G, Xa).reshape(B, ko * da)

        res = glm_lbfgs_batched(
            Ax, loss_grad, trial_loss, AT,
            lambda x: 0.5 * (x * x).sum(dim=-1), lambda x: x,
            torch.zeros((B, ko * da), dtype=X.dtype, device=X.device),
            max_iter=max_iter, tol=tol)
        coef, intercept = _split_coef(res.x.reshape(B, ko, da), d, static)
        return {"coef": coef, "intercept": intercept,
                "converged": res.converged, "n_iter": res.n_iter}

    @classmethod
    def decision(cls, model, static, X, meta):
        Z = X @ model["coef"].transpose(-1, -2) + model["intercept"][..., None,
                                                                      :]
        return Z[..., 0] if meta["n_classes"] == 2 else Z

    @classmethod
    def predict(cls, model, static, X, meta):
        Z = cls.decision(model, static, X, meta)
        if meta["n_classes"] == 2:
            return (Z > 0).long()
        return torch.argmax(Z, dim=-1)

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """The views of all T tasks from one GEMM X W_allᵀ (coef (T, ko,
        d)): "decision" (T, n) binary or (T, n, k), and "pred"."""
        X = data["X"]
        n = X.shape[0]
        W, b = models["coef"], models["intercept"]
        T, ko, d = W.shape
        Z = (X @ W.reshape(T * ko, d).T).reshape(n, T, ko) + b[None]
        Z = Z.transpose(0, 1)                                   # (T, n, ko)
        z = Z[..., 0] if meta["n_classes"] == 2 else Z
        views = {}
        if "decision" in needed:
            views["decision"] = z
        if "pred" in needed:
            views["pred"] = (z > 0).long() if meta["n_classes"] == 2 \
                else torch.argmax(Z, dim=-1)
        return views

    @classmethod
    def sklearn_attrs(cls, model, static, meta) -> Dict[str, Any]:
        return {"coef_": model["coef"].cpu().numpy(),
                "intercept_": model["intercept"].cpu().numpy(),
                "classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


class LinearSVRFamily(Family):
    """liblinear's LinearSVR: squared epsilon-insensitive by L-BFGS on the
    primal, epsilon-insensitive (the default) by projected Nesterov on
    its dual in β = a − a* (a soft threshold, then the box clip)."""

    name = "linear_svr"
    is_classifier = False
    dynamic_params = {"C": np.float32, "tol": np.float32,
                      "epsilon": np.float32}

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        data = {"X": np.ascontiguousarray(X, dtype=dtype),
                "y": np.ascontiguousarray(y, dtype=dtype)}
        return data, {"n_features": int(X.shape[1])}

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        loss = static.get("loss", "epsilon_insensitive")
        if loss not in ("epsilon_insensitive",
                        "squared_epsilon_insensitive"):
            raise ValueError(f"loss={loss!r} is not compiled")
        X, y = data["X"], data["y"]
        n, d = X.shape
        B = train_w.shape[0]
        C = _lane_tensor(dynamic.get("C", static.get("C", 1.0)), B, X)
        eps = _lane_tensor(dynamic.get("epsilon",
                                       static.get("epsilon", 0.0)), B, X)
        tol = _lane_tensor(dynamic.get("tol", static.get("tol", 1e-4)), B, X)
        max_iter = int(static.get("max_iter", 1000))
        Xa = _augment(X, static)
        da = Xa.shape[1]

        if loss == "epsilon_insensitive":
            # min 0.5 b'(Xa Xaᵀ)b − y'b + eps |b|_1 over |b_i| <= C w_i
            step = _gram_step(Xa)
            bound = C[:, None] * train_w                        # (B, n)
            thresh = step * eps[:, None]

            def advance(x, z, w, coef):
                grad = (z @ Xa) @ Xa.T - y[None, :]
                u = z - step * grad
                s = torch.sign(u) * torch.clamp_min(u.abs() - thresh, 0.0)
                x_new = torch.minimum(torch.maximum(s, -bound), bound)
                z_new = x_new + coef * (x_new - x)
                resid = (x_new - z).abs().amax(dim=1) / step
                return x_new, z_new, None, resid

            beta, n_iter, converged = _box_fista(
                advance, torch.zeros((B, n), dtype=X.dtype, device=X.device),
                None, max_iter, tol=tol)
            coef, intercept = _split_coef(beta @ Xa, d, static)
            return {"coef": coef, "intercept": intercept,
                    "converged": converged, "n_iter": n_iter}

        wT = train_w.T                                          # (n, B)

        def loss_grad(Z):
            e = Z - y[:, None]
            r = torch.clamp_min(e.abs() - eps[None, :], 0.0)
            return (C * (wT * r * r).sum(dim=0),
                    C[None, :] * wT * 2.0 * torch.sign(e) * r)

        def trial_loss(Z, Zp, alphas):
            out = []
            for a in alphas:
                r = torch.clamp_min((Z + a[None, :] * Zp - y[:, None]).abs()
                                    - eps[None, :], 0.0)
                out.append(C * (wT * r * r).sum(dim=0))
            return torch.stack(out)

        res = glm_lbfgs_batched(
            lambda x: Xa @ x.T, loss_grad, trial_loss, lambda G: G.T @ Xa,
            lambda x: 0.5 * (x * x).sum(dim=-1), lambda x: x,
            torch.zeros((B, da), dtype=X.dtype, device=X.device),
            max_iter=max_iter, tol=tol)
        coef, intercept = _split_coef(res.x, d, static)
        return {"coef": coef, "intercept": intercept,
                "converged": res.converged, "n_iter": res.n_iter}

    @classmethod
    def predict(cls, model, static, X, meta):
        return X @ model["coef"] + model["intercept"]

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """All T tasks' predictions from one GEMM X Wᵀ (n, d) @ (d, T)."""
        if "pred" not in needed:
            return {}
        pred = data["X"] @ models["coef"].T + models["intercept"][None]
        return {"pred": pred.T}

    @classmethod
    def sklearn_attrs(cls, model, static, meta) -> Dict[str, Any]:
        return {"coef_": model["coef"].cpu().numpy(),
                "intercept_": model["intercept"].cpu().numpy(),
                "n_features_in_": meta["n_features"]}


register_family(
    SVRFamily,
    "sklearn.svm._classes.SVR",
    "sklearn.svm.SVR",
    "spark_sklearn_tpu_torch.models.estimators.SVR",
)
register_family(
    NuSVRFamily,
    "sklearn.svm._classes.NuSVR",
    "sklearn.svm.NuSVR",
    "spark_sklearn_tpu_torch.models.estimators.NuSVR",
)
register_family(
    LinearSVCFamily,
    "sklearn.svm._classes.LinearSVC",
    "sklearn.svm.LinearSVC",
    "spark_sklearn_tpu_torch.models.estimators.LinearSVC",
)
register_family(
    LinearSVRFamily,
    "sklearn.svm._classes.LinearSVR",
    "sklearn.svm.LinearSVR",
    "spark_sklearn_tpu_torch.models.estimators.LinearSVR",
)
