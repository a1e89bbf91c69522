"""LinearDiscriminantAnalysis with solver="lsqr", lane-batched.

Counterpart of `spark_sklearn_tpu/models/discriminant.py` (:40-160),
sklearn's `_solve_lstsq`:

    means_c   = per-class fold means
    cov       = sum_c priors_c * empirical_cov(X_c), one weighted Gram of
                the rows' residuals about their own class mean, then
                (1 - s) cov + s (trace / d) I
    coef      = lstsq(cov, means.T).T      (the minimum-norm solution)
    intercept = -0.5 diag(means coef.T) + log priors

with sklearn's binary collapse (one decision row, sigmoid
probabilities).  `shrinkage` is dynamic (None is 0.0).  The means and
the covariance are computed once a fold (`models/naive_bayes.fold_rows`),
the shrinkage and the solve once a lane.

The solve is the reference's `jnp.linalg.lstsq`: an SVD, singular values
below rcond = eps * d of the largest dropped (eps of the dtype, d the
covariance's order), on both devices by one code path.
`torch.linalg.lstsq` is not used: on CUDA it has only the `gels` driver,
which assumes full rank, and at shrinkage 0 the covariance of data with
constant columns is singular.

solver "svd" and "eigen", shrinkage="auto" and covariance_estimator are
not ported and raise; LDA's fit takes no sample_weight (sklearn).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import Family, register_family
from spark_sklearn_tpu_torch.models.naive_bayes import (
    _prep_classifier_data,
    class_sums,
    fold_rows,
)

_EPS = 1e-12


def min_norm_solve(A, Bm):
    """x = pinv(A) Bm for each of the stacked square A (..., d, d) and
    right-hand sides Bm (..., d, k), as jnp.linalg.lstsq computes it."""
    d = A.shape[-1]
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = float(torch.finfo(A.dtype).eps) * d
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.transpose(-1, -2) @ (s_inv[..., None]
                                   * (U.transpose(-1, -2) @ Bm))


class LinearDiscriminantFamily(Family):
    name = "lda"
    is_classifier = True
    dynamic_params = {"shrinkage": np.float32}
    accepts_sample_weight = False
    #: sklearn's LDA keeps the user's X dtype to its probabilities
    proba_dtype_rule = "input"

    @classmethod
    def host_reason(cls, static):
        """Why a candidate runs on the search's host tier, or None: the
        device path is the lsqr solver with a numeric shrinkage."""
        solver = static.get("solver", "svd")
        if solver != "lsqr":
            return (f"solver={solver!r} is not supported in the PyTorch "
                    "port (lsqr only)")
        if isinstance(static.get("shrinkage"), str):
            return (f"shrinkage={static.get('shrinkage')!r} (Ledoit-Wolf) "
                    "is not supported in the PyTorch port")
        if static.get("covariance_estimator") is not None:
            return "covariance_estimator is not supported in the PyTorch port"
        return None

    @classmethod
    def check_static(cls, static):
        reason = cls.host_reason(static)
        if reason is not None:
            raise ValueError(reason)

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        """Host-side static and priors validation, once a search: sklearn
        raises for negative priors and warns and renormalizes ones that do
        not sum to 1 (the fit normalizes too)."""
        cls.check_static(base_params)
        seen = set()
        for params in [base_params] + [
                {**base_params, **c} for c in candidates]:
            cls.check_static(params)
            priors = params.get("priors")
            if priors is None or id(priors) in seen:
                continue
            seen.add(id(priors))
            p = np.asarray(priors, np.float64)
            k = meta.get("n_classes")
            if k is not None and len(p) != k:
                raise ValueError(
                    f"priors must have length n_classes ({k}); got "
                    f"{len(p)}")
            if (p < 0).any():
                raise ValueError("priors must be non-negative")
            if abs(p.sum() - 1.0) > 1e-5:
                warnings.warn("The priors do not sum to 1. "
                              "Renormalizing", UserWarning, stacklevel=2)

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        return _prep_classifier_data(X, y, dtype)

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """coef (B, k, d) and intercept (B, k) (`fit`, discriminant.py:97)."""
        cls.check_static(static)
        X, y, y1h = data["X"], data["y"].long(), data["y1h"]
        d = X.shape[1]
        B = train_w.shape[0]
        s_raw = dynamic.get("shrinkage", static.get("shrinkage"))
        s = torch.as_tensor(0.0 if s_raw is None else s_raw,
                            device=X.device).to(X.dtype).expand(B)
        fold_w, lane_fold = fold_rows(train_w, static)
        counts, sums = class_sums(y1h, fold_w, X)            # (F, k[, d])
        cnt = torch.clamp_min(counts, _EPS)
        means = sums / cnt[:, :, None]                       # (F, k, d)
        priors = static.get("priors")
        if priors is not None:
            pri = torch.as_tensor(np.asarray(priors), device=X.device).to(
                X.dtype).expand(counts.shape)
            pri = pri / torch.clamp_min(pri.sum(dim=1, keepdim=True), _EPS)
        else:
            pri = counts / torch.clamp_min(counts.sum(dim=1, keepdim=True),
                                           _EPS)
        # within-class covariance, priors-weighted (sklearn _class_cov):
        # residuals about each row's own class mean (two-pass), each row
        # weighted priors_c / n_c
        r = X[None] - means[:, y]                            # (F, n, d)
        row_w = fold_w * (pri / cnt)[:, y]                   # (F, n)
        cov = torch.bmm((r * row_w[:, :, None]).transpose(1, 2), r)
        mu = torch.diagonal(cov, dim1=1, dim2=2).sum(dim=1) / d   # (F,)
        eye = torch.eye(d, dtype=X.dtype, device=X.device)
        cov = ((1.0 - s)[:, None, None] * cov[lane_fold]
               + (s * mu[lane_fold])[:, None, None] * eye)
        means, pri = means[lane_fold], pri[lane_fold]
        coef = min_norm_solve(cov, means.transpose(1, 2)).transpose(1, 2)
        intercept = -0.5 * (means * coef).sum(dim=2) \
            + torch.log(torch.clamp_min(pri, _EPS))
        return {"coef": coef.contiguous(), "intercept": intercept}

    @staticmethod
    def _scores(model, X):
        """(T, n, k) class scores of every lane from one GEMM."""
        W, b = model["coef"], model["intercept"]             # (T, k, d)
        T, k, d = W.shape
        Z = torch.addmm(b.reshape(1, T * k), X, W.reshape(T * k, d).T)
        return Z.view(-1, T, k).transpose(0, 1)

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        Z = cls._scores(models, data["X"])
        views = {}
        if meta["n_classes"] == 2:
            dec = Z[..., 1] - Z[..., 0]
            if "decision" in needed:
                views["decision"] = dec
            if "pred" in needed:
                views["pred"] = (dec > 0).long()
            if "proba" in needed:
                p = torch.sigmoid(dec)
                views["proba"] = torch.stack([1.0 - p, p], dim=-1)
        else:
            if "decision" in needed:
                views["decision"] = Z
            if "pred" in needed:
                views["pred"] = torch.argmax(Z, dim=-1)
            if "proba" in needed:
                views["proba"] = torch.softmax(Z, dim=-1)
        return views

    @classmethod
    def _one_view(cls, model, X, meta, name):
        one = {k: v[None] for k, v in model.items()}
        return cls.views_task_batched(one, {}, {"X": X}, meta,
                                      (name,))[name][0]

    @classmethod
    def decision(cls, model, static, X, meta):
        return cls._one_view(model, X, meta, "decision")

    @classmethod
    def predict(cls, model, static, X, meta):
        return cls._one_view(model, X, meta, "pred")

    @classmethod
    def predict_proba(cls, model, static, X, meta):
        return cls._one_view(model, X, meta, "proba")

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        coef = model["coef"].cpu().numpy()
        icpt = model["intercept"].cpu().numpy()
        if meta["n_classes"] == 2:
            coef = (coef[1] - coef[0]).reshape(1, -1)
            icpt = np.asarray([icpt[1] - icpt[0]])
        return {"coef_": coef, "intercept_": icpt,
                "classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


register_family(
    LinearDiscriminantFamily,
    "sklearn.discriminant_analysis.LinearDiscriminantAnalysis",
    "spark_sklearn_tpu_torch.models.estimators.LinearDiscriminantAnalysis",
)
