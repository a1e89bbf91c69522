"""SVC and NuSVC families: the kernel SVM dual, lane-batched.

Counterpart of `spark_sklearn_tpu/models/svm.py` (:40-328, :449-812).  The
reference solves libsvm's dual QP by Nesterov-accelerated projected
gradient ascent, all (fold x class-pair) subproblems of a candidate at
once, so each step is one (F·P, n) @ (n, n) product with the candidate's
kernel matrix plus a 40-step bisection projection:

  max_a  1'a - 0.5 a' Q a,   0 <= a_i <= C_i,  Σ y_i a_i = 0,
  Q = (y y') ∘ K

(NuSVC: libsvm's nu dual, two half box-sum projections and the KKT
rescale).  Multi-class is one-vs-one over all k(k-1)/2 pairs with
confidence-tie-broken voting, as sklearn's.

On the card the kernel matrix is a library GEMM plus the hand-written
epilogue S1, and each step is the ascent GEMM plus the hand-written S2
(projection, momentum, residual and the next product's operand in one
launch; `ops/svm_kernels.py`).  On the CPU the same code runs their plain
versions.  The reference's `lax.scan` over candidates is a Python loop
that builds each candidate's kernel matrix into one reused (n, n) buffer.
The residual exit reads `done.all()` on the host once a step.

In a Pipeline the final SVC gets per-fold transformed inputs
``data["X_folds"]`` (F, n, d'): each (candidate, fold) then has its own
kernel matrix, and ``gamma="scale"`` follows the fold's transformed
training rows (the reference's pipeline mode, svm.py:584-638).

Not ported in this slice: `probability=True` (Platt scaling and pairwise
coupling) and the converted-model probability path; they raise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import (
    Family,
    class_weight_multiplier,
    encode_labels,
    register_family,
)
from spark_sklearn_tpu_torch.ops.svm_kernels import dual_step, gram_epilogue

#: iterations of the power method that sizes the ascent step (svm.py:69)
POWER_STEPS = 20


def _pairs(k: int) -> np.ndarray:
    return np.array([(i, j) for i in range(k) for j in range(i + 1, k)],
                    dtype=np.int32)


def _kernel(X1, X2, kind, gamma, degree, coef0, out=None):
    """The (n1, n2) kernel matrix: the product X1 X2ᵀ (a library GEMM,
    into `out` when given), then S1 (in place on the card)."""
    G = torch.mm(X1, X2.T, out=out) if out is not None else X1 @ X2.T
    return gram_epilogue(G, X1, X2, kind, gamma, degree, coef0)


def _power_step(K):
    """1/λ_max(K) by 20 power steps, a safe ascent step for every masked,
    sign-flipped subproblem; a 0-dim tensor on K's device."""
    n = K.shape[0]
    v = torch.ones(n, dtype=K.dtype, device=K.device) / torch.sqrt(
        torch.tensor(float(n), dtype=K.dtype))
    for _ in range(POWER_STEPS):
        v = torch.mv(K, v)
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    return 1.0 / (torch.dot(v, torch.mv(K, v)) + 1e-6)


def _momentum(t):
    """(t_new, (t - 1) / t_new) in float32, as the reference's carry
    computes them (svm.py:97-98)."""
    one = np.float32(1.0)
    t_new = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0) * t * t))
    return t_new, (t - one) / t_new


def _box_fista(advance, x0, w0, max_iter, tol=None):
    """Nesterov-accelerated projected gradient (svm.py:73-129).

    `advance(x, z, w, coef) -> (x', z', w', resid)` is one step (the
    ascent product of w = z∘yb and S2); x0 is feasible and w0 = x0∘yb.
    With `tol=None` runs `max_iter` steps and returns x.  With a float
    `tol` it also stops once every lane's residual max|x' − z|/step is at
    or below it (read on the host once a step) and returns (x, n_iter,
    done): a lane's n_iter is the step at which it first converged, or
    the steps run where it never did."""
    x = z = x0
    w = w0
    t = np.float32(1.0)
    if tol is None:
        for _ in range(max_iter):
            t, coef = _momentum(t)
            x, z, w, _ = advance(x, z, w, coef)
        return x
    B = x0.shape[0]
    tol_t = torch.tensor(tol, dtype=x0.dtype, device=x0.device)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    n_iter = torch.full((B,), max_iter, dtype=torch.int32, device=x0.device)
    it = 0
    while it < max_iter and not bool(done.all()):
        t, coef = _momentum(t)
        x, z, w, resid = advance(x, z, w, coef)
        done_new = done | (resid <= tol_t)
        n_iter = torch.where(~done & done_new,
                             torch.full_like(n_iter, it + 1), n_iter)
        done = done_new
        it += 1
    return x, torch.where(done, n_iter, torch.full_like(n_iter, it)), done


def _run_dual(K, yb, bound, step, max_iter, tol, x0, w0, target=None):
    """The shared tol dispatch (svm.py:194-204): (x, executed steps), the
    max over the lanes with a tol.  Each step is V = w K, then S2."""

    def advance(x, z, w, coef):
        return dual_step(w @ K, z, x, yb, bound, step, coef, target)

    if tol is None:
        return _box_fista(advance, x0, w0, max_iter), \
            torch.tensor(max_iter, dtype=torch.int32)
    x, n_it, _ = _box_fista(advance, x0, w0, max_iter, tol=tol)
    return x, n_it.max()


def _tol_or_default(static):
    """sklearn's SVC tol (libsvm eps), defaulting to libsvm's 1e-3."""
    tol = static.get("tol", 1e-3)
    return 1e-3 if tol is None else float(tol)


def _probability_on(params):
    """sklearn 1.9 made SVC's `probability` default the string
    "deprecated", which is truthy: only an explicit boolean True (python
    or numpy) counts."""
    value = params.get("probability", False)
    return isinstance(value, (bool, np.bool_)) and bool(value)


def _masked_mean_or_mid(vals, free, at_hi, at_lo):
    """libsvm's r1/r2 rule: mean of `vals` over free SVs; when none are
    free, the midpoint of [max over at-upper-bound, min over at-0]."""
    inf = torch.tensor(torch.inf, dtype=vals.dtype, device=vals.device)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    nfree = free.sum(dim=1)
    mean_free = torch.where(free, vals, zero).sum(dim=1) / \
        torch.clamp_min(nfree, 1)
    lb = torch.where(at_hi, vals, -inf).amax(dim=1)
    ub = torch.where(at_lo, vals, inf).amin(dim=1)
    return torch.where(nfree > 0, mean_free, _finite_mid(lb, ub))


def _finite_mid(lo, up):
    """(lo + up)/2 where finite, else whichever end is finite, else 0."""
    mid = 0.5 * (lo + up)
    zero = torch.zeros_like(mid)
    return torch.where(torch.isfinite(mid), mid,
                       torch.where(torch.isfinite(lo), lo,
                                   torch.where(torch.isfinite(up), up, zero)))


def _kkt_masks(A, bound):
    inb = bound > 0
    at_lo = A <= bound * 1e-6
    at_hi = A >= bound * (1.0 - 1e-6)
    return inb, at_lo, at_hi, inb & ~at_lo & ~at_hi


def _kkt_intercept(V, A, yb, bound):
    """Per-subproblem intercept from the KKT conditions (libsvm's -rho,
    svm.py:277-300): the mean of E = yb − V over free SVs, else the
    midpoint of the feasible interval.  Takes the product V = (A∘yb) K,
    which the caller reuses for the decision (the reference computes it
    twice)."""
    E = yb - V
    inb, at_lo, at_hi, free = _kkt_masks(A, bound)
    nfree = free.sum(dim=1)
    zero = torch.zeros((), dtype=E.dtype, device=E.device)
    inf = torch.tensor(torch.inf, dtype=E.dtype, device=E.device)
    b_free = torch.where(free, E, zero).sum(dim=1) / torch.clamp_min(nfree, 1)
    lo_mask = inb & ((at_lo & (yb > 0)) | (at_hi & (yb < 0)))
    up_mask = inb & ((at_lo & (yb < 0)) | (at_hi & (yb > 0)))
    max_lo = torch.where(lo_mask, E, -inf).amax(dim=1)
    min_up = torch.where(up_mask, E, inf).amin(dim=1)
    return torch.where(nfree > 0, b_free, _finite_mid(max_lo, min_up))


def _svc_dual(K, yb, bound, step, max_iter, tol=None):
    """The SVC dual of M stacked subproblems: (A, V = (A∘yb) K, steps)."""
    zeros = torch.zeros_like(bound)
    A, n_it = _run_dual(K, yb, bound, step, max_iter, tol, zeros, zeros)
    return A, (A * yb) @ K, n_it


def fista_dual_ascent(K, yb, bound, step, max_iter, tol=None):
    """Nesterov-accelerated projected gradient ascent on the SVC dual
    (svm.py:303-328): K (n, n); yb, bound (M, n) signed labels and box
    bounds of M subproblems.  Returns (A, b, n_iter): alphas, the KKT
    intercepts and the steps run (max_iter when tol is None)."""
    A, V, n_it = _svc_dual(K, yb, bound, step, max_iter, tol)
    return A, _kkt_intercept(V, A, yb, bound), n_it


def _nu_dual(K, yb, bound, nu, step, max_iter, tol=None):
    """libsvm's nu-SVC dual (Solver_NU), batched over M subproblems
    (svm.py:225-274): min 0.5 a'Qa over the box with Σ over each class
    half = nu·l/2, from the projection of zero.  Returns (A, V = (A∘yb) K,
    r, rho, ok, steps): the decision is (V − rho)/r where `ok` (feasible
    nu and r > 1e-12)."""
    zero = torch.zeros((), dtype=bound.dtype, device=bound.device)
    pos_b = torch.where(yb > 0, bound, zero)
    neg_b = torch.where(yb < 0, bound, zero)
    l_sub = (bound > 0).sum(dim=1).to(K.dtype)
    target = 0.5 * nu * l_sub                                   # (M,)
    cap = torch.minimum(pos_b.sum(dim=1), neg_b.sum(dim=1))
    feasible = target <= cap * (1.0 + 1e-6)
    zeros = torch.zeros_like(bound)
    x0, _, w0, _ = dual_step(None, zeros, zeros, yb, bound, step, 0.0,
                             target)
    A, n_it = _run_dual(K, yb, bound, step, max_iter, tol, x0, w0, target)
    V = (A * yb) @ K
    G = yb * V                         # gradient of 0.5 a'Qa
    inb, at_lo, at_hi, free = _kkt_masks(A, bound)
    pos, neg = yb > 0, yb < 0
    r1 = _masked_mean_or_mid(G, free & pos, inb & pos & at_hi,
                             inb & pos & at_lo)
    r2 = _masked_mean_or_mid(G, free & neg, inb & neg & at_hi,
                             inb & neg & at_lo)
    r = 0.5 * (r1 + r2)                # lambda_e: the alpha rescale
    rho = 0.5 * (r1 - r2)              # lambda_y
    return A, V, r, rho, feasible & (r > 1e-12), n_it


def nu_dual_ascent(K, yb, bound, nu, step, max_iter, tol=None):
    """Per-subproblem full-set decision rows of the nu dual and the steps
    run; infeasible subproblems come back as NaN rows (the search's
    failed-fit detector gives them error_score)."""
    _, V, r, rho, ok, n_it = _nu_dual(K, yb, bound, nu, step, max_iter, tol)
    dec = (V - rho[:, None]) / r[:, None]
    return torch.where(ok[:, None], dec, torch.nan), n_it


def _resolve_gamma(gamma, meta):
    if isinstance(gamma, str):
        if gamma == "scale":
            # X variance precomputed host-side in prepare_data
            return 1.0 / (meta["n_features"] * meta["x_var"])
        if gamma == "auto":
            return 1.0 / meta["n_features"]
        raise ValueError(f"gamma={gamma!r} not understood")
    return float(gamma)


def _kernel_args(static):
    kind = static.get("kernel", "rbf")
    if kind == "precomputed":
        raise ValueError(
            "kernel='precomputed' is not compiled (the reference runs it on "
            "its host tier, which is not ported)")
    if _probability_on(static):
        raise NotImplementedError(
            "SVC(probability=True) (Platt scaling and pairwise coupling) "
            "waits for a later slice of the port")
    return kind, float(static.get("degree", 3)), \
        float(static.get("coef0", 0.0))


def _max_iter(static):
    max_iter = int(static.get("max_iter", -1))
    return 300 if max_iter in (-1, 0) else max_iter


def _pair_labels(y, pairs, k, dtype):
    """(ybin, in_pair), each (P, n): +1 for pairs[p, 0], -1 for
    pairs[p, 1] (negated when binary: sklearn's decision > 0 is
    classes_[1]), and the pair's membership."""
    ypos = y[None, :] == pairs[:, 0][:, None]
    yneg = y[None, :] == pairs[:, 1][:, None]
    ybin = ypos.to(dtype) - yneg.to(dtype)
    if k == 2:
        ybin = -ybin
    return ybin, (ypos | yneg).to(dtype)


def _fold_scale_gamma(X_folds, w_folds):
    """gamma="scale" of each fold's transformed training rows, 1 / (d ·
    var), as float32 host numbers (the reference's pipeline mode,
    svm.py:607-614)."""
    d = X_folds.shape[2]
    mrow = (w_folds > 0).to(X_folds.dtype)[:, :, None]       # (F, n, 1)
    cnt = mrow.sum(dim=(1, 2)) * d + 1e-12
    mu = (X_folds * mrow).sum(dim=(1, 2)) / cnt
    var = (((X_folds - mu[:, None, None]) ** 2) * mrow).sum(dim=(1, 2)) \
        / cnt
    g = 1.0 / (d * torch.clamp_min(var, 1e-12))
    return [_f32(v) for v in g.cpu().tolist()]


def _f32(v):
    """A scalar as the float32 value the reference's traced scalar holds."""
    return float(np.float32(v))


class SVCFamily(Family):
    name = "svc"
    is_classifier = True
    #: a Pipeline hands it per-fold transformed inputs, data["X_folds"]
    accepts_fold_inputs = True
    dynamic_params = {"C": np.float32, "gamma": np.float32}
    #: the per-candidate scalar the dual consumes (NuSVC swaps in "nu")
    primary_param = "C"
    primary_default = 1.0

    @classmethod
    def _pair_dec(cls, K, p_c, base_bound, yb, step, max_iter, tol=None):
        """(M, n) full-set decision rows of the M stacked subproblems and
        the steps run; `p_c` (C here) scales the box `base_bound`."""
        bound = p_c * base_bound
        A, V, n_it = _svc_dual(K, yb, bound, step, max_iter, tol)
        return V + _kkt_intercept(V, A, yb, bound)[:, None], n_it

    @classmethod
    def _representer(cls, K, p_c, base_bound, yb, step, max_iter, tol):
        """(signed alphas (P, n), intercepts (P,)) of the full-data fit."""
        bound = p_c * base_bound
        A, V, _ = _svc_dual(K, yb, bound, step, max_iter, tol)
        return A * yb, _kkt_intercept(V, A, yb, bound)

    # kernel matrices + per-task decision caches are the memory hot spot;
    # tell the search to keep task batches small
    @staticmethod
    def max_tasks_hint(n_samples: int, meta) -> int:
        k = meta["n_classes"]
        p = max(1, k * (k - 1) // 2)
        budget = 1 << 30   # ~1 GiB of decision cache per launch
        return max(1, budget // max(1, n_samples * p * 4))

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        classes, y_enc = encode_labels(y)
        k = len(classes)
        data = {"X": np.ascontiguousarray(X, dtype=dtype), "y": y_enc}
        meta = {"n_classes": int(k), "classes": classes,
                "n_features": int(X.shape[1]),
                "x_var": float(np.var(np.asarray(X))),
                "pairs": _pairs(k)}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """Tasks arrive candidate-major (task t = (cand t//F, fold t%F)).
        Per candidate: one kernel matrix shared by its F·P (fold x pair)
        subproblems, one power step, one batched dual solve.  Returns per
        task the full-set pair decisions `pair_dec` (B, n, P) — the search
        scores masked rows of the training X from them — and `n_iter`
        (B,), each candidate's steps repeated over its folds."""
        X, y = data["X"], data["y"]
        X_folds = data.get("X_folds")
        n = X.shape[0]
        k = meta["n_classes"]
        dev, dt = X.device, X.dtype
        pairs = torch.as_tensor(meta["pairs"], device=dev).long()    # (P, 2)
        P = pairs.shape[0]
        B = train_w.shape[0]
        kind, degree, coef0 = _kernel_args(static)
        max_iter = _max_iter(static)
        # libsvm's eps stopping rule (sklearn tol, default 1e-3)
        tol_exit = _tol_or_default(static)
        n_folds = int(static.get("__n_folds__", 0))
        if n_folds <= 0:
            raise ValueError("engine must pass __n_folds__ for SVC")
        nc = B // n_folds
        # the search pads a chunk by repeating its last candidate: solve
        # the real ones and copy the last one's result into the padding
        n_real = min(nc, int(static.get("__n_real__", nc)))

        gamma_default = _resolve_gamma(static.get("gamma", "scale"), meta)
        pp = cls.primary_param
        C_task = torch.as_tensor(
            dynamic.get(pp, static.get(pp, cls.primary_default)),
            device=dev).to(dt).expand(B)
        g_task = torch.as_tensor(dynamic.get("gamma", gamma_default),
                                 device=dev).to(dt).expand(B)
        C_cand = C_task.reshape(nc, n_folds)[:, 0]
        # S1 takes gamma as a host scalar: one read for the chunk
        g_cand = g_task.reshape(nc, n_folds)[:, 0].cpu().tolist()
        w_cand = train_w.reshape(nc, n_folds, n)

        ybin, in_pair = _pair_labels(y, pairs, k, dt)                 # (P, n)
        yb = ybin.repeat(n_folds, 1)                               # (F·P, n)
        # class_weight scales each sample's box bound: 0 <= a_i <= C * cw_i
        # (libsvm's per-class C); "balanced" follows each fold's counts
        cw_fold = class_weight_multiplier(
            w_cand[0], y, meta, static.get("class_weight"))
        if cw_fold is None:
            cw_fold = torch.ones((n_folds, n), dtype=dt, device=dev)

        K_buf = torch.empty((n, n), dtype=dt, device=dev)
        pair_dec = torch.empty((B, n, P), dtype=dt, device=dev)
        g_fold = None
        if X_folds is not None and "gamma" not in dynamic and \
                static.get("gamma", "scale") == "scale":
            g_fold = _fold_scale_gamma(X_folds, w_cand[0])
        its = []
        for c in range(n_real):
            if X_folds is None:
                K = _kernel(X, X, kind, g_cand[c], degree, coef0, out=K_buf)
                step = _power_step(K)
                base = ((w_cand[c] * cw_fold)[:, None, :]
                        * in_pair[None, :, :]).reshape(-1, n)
                dec, it = cls._pair_dec(K, C_cand[c], base, yb, step,
                                        max_iter, tol_exit)
                dec = dec.reshape(n_folds, P, n)
            else:
                # a kernel matrix per fold, whose P pair subproblems are
                # solved together; the candidate's steps are the most
                # any of its folds ran
                decs, fold_its = [], []
                for f in range(n_folds):
                    g = g_cand[c] if g_fold is None else g_fold[f]
                    K = _kernel(X_folds[f], X_folds[f], kind, g, degree,
                                coef0, out=K_buf)
                    base = (w_cand[c, f] * cw_fold[f])[None, :] * in_pair
                    d_f, it_f = cls._pair_dec(K, C_cand[c], base, ybin,
                                              _power_step(K), max_iter,
                                              tol_exit)
                    decs.append(d_f)
                    fold_its.append(torch.as_tensor(it_f, device=dev))
                dec = torch.stack(decs)
                it = torch.stack(fold_its).max()
            pair_dec[c * n_folds:(c + 1) * n_folds] = dec.transpose(1, 2)
            its.append(it)
        last = pair_dec[(n_real - 1) * n_folds:n_real * n_folds]
        for c in range(n_real, nc):
            pair_dec[c * n_folds:(c + 1) * n_folds] = last
            its.append(its[-1])
        n_iter = torch.stack(its).to(dev).to(torch.int32)
        return {"pair_dec": pair_dec,
                "n_iter": n_iter.repeat_interleave(n_folds)}

    @classmethod
    def fit_representer(cls, X, y, static, meta):
        """The full-data fit of one estimator (the counterpart of
        `spark_sklearn_tpu/models/standalone.py` `SVC._solve_alphas`):
        {"sv_X": X, "alphas": signed (P, n), "intercepts": (P,)}."""
        kind, degree, coef0 = _kernel_args(static)
        n = X.shape[0]
        k = meta["n_classes"]
        pairs = torch.as_tensor(meta["pairs"], device=X.device).long()
        gamma = _f32(_resolve_gamma(static.get("gamma", "scale"), meta))
        K = _kernel(X, X, kind, gamma, degree, coef0)
        yb, box = _pair_labels(y, pairs, k, X.dtype)
        cw = class_weight_multiplier(
            torch.ones(n, dtype=X.dtype, device=X.device), y, meta,
            static.get("class_weight"))
        base = box if cw is None else box * cw[None, :]
        p_c = torch.tensor(_f32(static.get(cls.primary_param,
                                           cls.primary_default)),
                           dtype=X.dtype, device=X.device)
        alphas, b = cls._representer(K, p_c, base, yb, _power_step(K),
                                     _max_iter(static),
                                     _tol_or_default(static))
        return {"sv_X": X, "alphas": alphas, "intercepts": b}

    # -- prediction from cached decisions (search-internal) or from the
    # -- representer form (the standalone estimators) ----------------------
    @classmethod
    def _pair_dec_of(cls, model, static, X, meta):
        """Pair decisions (n, P): the cached `pair_dec` of the search, or
        K(X, sv_X) @ alphasᵀ + intercepts for a fitted estimator."""
        if "pair_dec" in model:
            return model["pair_dec"]
        g = meta.get("resolved_gamma")
        if g is None:
            g = _resolve_gamma(static.get("gamma", "scale"), meta)
        kind, degree, coef0 = _kernel_args(static)
        K = _kernel(X, model["sv_X"], kind, _f32(g), degree, coef0)
        return K @ model["alphas"].T + model["intercepts"][None, :]

    @classmethod
    def _votes(cls, dec, meta):
        """One-vs-one votes plus sklearn's bounded confidence tie-break
        (svm.py:709-721), over any leading axes of dec (..., P)."""
        pairs = torch.as_tensor(meta["pairs"], device=dec.device).long()
        k = meta["n_classes"]
        pos_mat = torch.nn.functional.one_hot(pairs[:, 0], k).to(dec.dtype)
        neg_mat = torch.nn.functional.one_hot(pairs[:, 1], k).to(dec.dtype)
        win_pos = (dec > 0).to(dec.dtype)
        votes = win_pos @ pos_mat + (1.0 - win_pos) @ neg_mat
        conf = dec @ pos_mat - dec @ neg_mat
        conf = conf / (3.0 * (conf.abs() + 1.0))
        return votes + conf

    @classmethod
    def predict(cls, model, static, X, meta):
        dec = cls._pair_dec_of(model, static, X, meta)
        if meta["n_classes"] == 2:
            return (dec[..., 0] > 0).long()
        return torch.argmax(cls._votes(dec, meta), dim=-1)

    @classmethod
    def decision(cls, model, static, X, meta):
        dec = cls._pair_dec_of(model, static, X, meta)
        if meta["n_classes"] == 2:
            return dec[..., 0]
        return cls._votes(dec, meta)

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """Scorer views of all T tasks from the cached `pair_dec` (T, n,
        P): "pred" (T, n) class indices and "decision" (T, n) for binary,
        (T, n, k) votes otherwise."""
        if "proba" in needed:
            raise NotImplementedError(
                "probability scorers of SVC (Platt scaling) wait for a later "
                "slice of the port")
        views = {}
        if "pred" in needed:
            views["pred"] = cls.predict(models, static, None, meta)
        if "decision" in needed:
            views["decision"] = cls.decision(models, static, None, meta)
        return views

    @classmethod
    def sklearn_attrs(cls, model, static, meta) -> Dict[str, Any]:
        return {"classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


class NuSVCFamily(SVCFamily):
    """nu-SVC: the SVC machinery with libsvm's nu dual per pair
    (`nu_dual_ascent`): box bound 1 per sample (class_weight-scaled), the
    two half box-sum projections, the decision rescaled by the KKT
    multiplier r.  Infeasible nu comes out as NaN decisions, which the
    search scores as error_score (sklearn raises in fit)."""

    name = "nu_svc"
    dynamic_params = {"nu": np.float32, "gamma": np.float32}
    primary_param = "nu"
    primary_default = 0.5

    @classmethod
    def _pair_dec(cls, K, p_c, base_bound, yb, step, max_iter, tol=None):
        return nu_dual_ascent(K, yb, base_bound, p_c, step, max_iter, tol)

    @classmethod
    def _representer(cls, K, p_c, base_bound, yb, step, max_iter, tol):
        A, _, r, rho, ok, _ = _nu_dual(K, yb, base_bound, p_c, step,
                                       max_iter, tol)
        if not bool(ok.all()):
            raise ValueError("specified nu is infeasible")
        return A * yb / r[:, None], -rho / r


register_family(
    SVCFamily,
    "sklearn.svm._classes.SVC",
    "sklearn.svm.SVC",
    "spark_sklearn_tpu_torch.models.estimators.SVC",
)
register_family(
    NuSVCFamily,
    "sklearn.svm._classes.NuSVC",
    "sklearn.svm.NuSVC",
    "spark_sklearn_tpu_torch.models.estimators.NuSVC",
)
