"""Preprocessing steps as fold-weighted torch functions.

Counterpart of `spark_sklearn_tpu/models/preprocessing.py` (:26-216).
A transformer is a pair of functions whose statistics are weighted by a
fold mask, so each fold sees only its training rows while shapes stay
fixed:

    fit(static, X, w)        -> state dict (weighted statistics)
    apply(static, state, X)  -> X'        (full-length transform)

The reference maps one fold (w (n,), X (n, d)) and `vmap`s; here the
fold axis is written out: w is (F, n), X is (n, d) for the first step of
a chain or (F, n, d) after it, and every state and output carries the
leading F.  PCA's eigendecomposition is `torch.linalg.eigh`, a library
call, as the reference's is `jnp.linalg.eigh`.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-12


def _folds(X):
    """X as (F or 1, n, d), to broadcast over the folds."""
    return X if X.dim() == 3 else X.unsqueeze(0)


def _wdot(w, X):
    """(F, d): each fold's weighted column sums, w (F, n) against X (n,
    d) or (F, n, d)."""
    return torch.matmul(w[:, None, :], _folds(X))[:, 0]


def _row_mask(w):
    """(F, n, 1) boolean: the rows each fold trains on."""
    return (w > 0)[:, :, None]


class StandardScalerStep:
    name = "standard_scaler"
    #: strictly monotone per-feature map: quantile binning (and so the
    #: histogram-tree fits) is invariant under this step
    monotone_per_feature = True

    @staticmethod
    def fit(static, X, w):
        wsum = (w.sum(dim=1) + EPS)[:, None]
        mean = _wdot(w, X) / wsum
        # variance about the true mean even when with_mean=False (as
        # sklearn's var_); only the shift is disabled
        dev = (_folds(X) - mean[:, None, :]) ** 2
        var = _wdot(w, dev) / wsum
        scale = torch.where(var > 0, torch.sqrt(var), torch.ones_like(var))
        if not bool(static.get("with_std", True)):
            scale = torch.ones_like(scale)
        if not bool(static.get("with_mean", True)):
            mean = torch.zeros_like(mean)
        return {"mean": mean, "scale": scale}

    @staticmethod
    def apply(static, state, X):
        return (_folds(X) - state["mean"][:, None, :]) \
            / state["scale"][:, None, :]


class MinMaxScalerStep:
    name = "minmax_scaler"
    monotone_per_feature = True

    @staticmethod
    def fit(static, X, w):
        Xf = _folds(X)
        big = torch.finfo(X.dtype).max
        m = _row_mask(w)
        lo_v = torch.where(m, Xf, torch.full_like(Xf, big)).amin(dim=1)
        hi_v = torch.where(m, Xf, torch.full_like(Xf, -big)).amax(dim=1)
        lo, hi = static.get("feature_range", (0.0, 1.0))
        span = hi_v - lo_v
        scale = torch.where(span > 0, (hi - lo) / span,
                            torch.ones_like(span))
        return {"min": lo_v, "scale": scale}

    @staticmethod
    def apply(static, state, X):
        lo, hi = static.get("feature_range", (0.0, 1.0))
        out = (_folds(X) - state["min"][:, None, :]) \
            * state["scale"][:, None, :] + lo
        if static.get("clip", False):
            out = torch.clamp(out, lo, hi)
        return out


class MaxAbsScalerStep:
    name = "maxabs_scaler"
    # |x|-scaling by a positive constant: monotone per feature
    monotone_per_feature = True

    @staticmethod
    def fit(static, X, w):
        m = (_folds(X).abs() * _row_mask(w)).amax(dim=1)
        return {"scale": torch.where(m > 0, m, torch.ones_like(m))}

    @staticmethod
    def apply(static, state, X):
        return _folds(X) / state["scale"][:, None, :]


class NormalizerStep:
    """Stateless per-row normalisation (norm in l1/l2/max)."""

    name = "normalizer"
    monotone_per_feature = False   # row-wise, mixes features

    @staticmethod
    def fit(static, X, w):
        return {"folds": torch.zeros(w.shape[0], dtype=X.dtype,
                                     device=X.device)}

    @staticmethod
    def apply(static, state, X):
        Xf = _folds(X)
        norm = static.get("norm", "l2")
        if norm == "l1":
            d = Xf.abs().sum(dim=2, keepdim=True)
        elif norm == "max":
            d = Xf.abs().amax(dim=2, keepdim=True)
        else:
            d = torch.sqrt((Xf * Xf).sum(dim=2, keepdim=True))
        out = Xf / torch.clamp_min(d, EPS)
        return out.expand(state["folds"].shape[0], -1, -1)


class PCAStep:
    """Weighted PCA from the eigendecomposition of the fold-weighted
    covariance (n_components is static: it sets the transformed width).
    Matches sklearn's PCA(svd_solver='full') up to component sign on
    the training fold; whitening supported."""

    name = "pca"
    monotone_per_feature = False   # rotation, mixes features

    @staticmethod
    def check_static(static, n_features=None):
        """Raise ValueError for settings the compiled path cannot serve
        (as the reference's, `preprocessing.py:160-177`)."""
        nc = static.get("n_components")
        if nc is None or isinstance(nc, bool) or \
                not isinstance(nc, (int, np.integer)):
            raise ValueError(
                "PCA needs an integer n_components on the compiled path")
        if nc < 0:
            raise ValueError(f"n_components={nc} must be >= 0")
        if n_features is not None and nc > n_features:
            raise ValueError(
                f"n_components={nc} must be <= n_features={n_features}")
        if static.get("svd_solver", "auto") not in ("auto", "full",
                                                    "covariance_eigh"):
            raise ValueError("only full-SVD PCA is compiled")

    @staticmethod
    def fit(static, X, w):
        PCAStep.check_static(static, X.shape[-1])
        nc = int(static["n_components"])
        wsum = (w.sum(dim=1) + EPS)[:, None, None]
        mean = _wdot(w, X) / wsum[:, 0]
        Xc = _folds(X) - mean[:, None, :]
        cov = torch.matmul((Xc * w[:, :, None]).transpose(1, 2), Xc) / wsum
        evals, evecs = torch.linalg.eigh(cov)                 # ascending
        # the top nc components, by descending eigenvalue
        comps = evecs.flip(-1)[:, :, :nc].transpose(1, 2)     # (F, nc, d)
        var = torch.clamp_min(evals.flip(-1)[:, :nc], 0.0)
        return {"mean": mean, "components": comps, "var": var}

    @staticmethod
    def apply(static, state, X):
        Z = torch.matmul(_folds(X) - state["mean"][:, None, :],
                         state["components"].transpose(1, 2))
        if static.get("whiten", False):
            Z = Z / torch.sqrt(state["var"] + EPS)[:, None, :]
        return Z


#: transformer class name -> step implementation
STEP_REGISTRY = {
    "StandardScaler": StandardScalerStep,
    "MinMaxScaler": MinMaxScalerStep,
    "MaxAbsScaler": MaxAbsScalerStep,
    "Normalizer": NormalizerStep,
    "PCA": PCAStep,
}

#: the module of the port's own transformer classes
_PORT_MODULE = "spark_sklearn_tpu_torch.models.estimators"


def resolve_step(transformer):
    """The step of an sklearn transformer or of the port's own, matched
    by module and class name without importing sklearn; None otherwise
    (a third-party class merely named StandardScaler gets no step)."""
    cls = type(transformer)
    if not (cls.__module__.startswith("sklearn.")
            or cls.__module__ == _PORT_MODULE):
        return None
    return STEP_REGISTRY.get(cls.__name__)
