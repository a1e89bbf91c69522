"""The naive Bayes families, lane-batched: GaussianNB, MultinomialNB,
ComplementNB, BernoulliNB and CategoricalNB.

Counterpart of `spark_sklearn_tpu/models/naive_bayes.py` (:42-604).  Each
fit is closed form: a few weighted reductions over X with the fold masks
as weights, sklearn's formulas throughout:

- GaussianNB: per-class weighted means, the two-pass variance about each
  row's own class mean, plus epsilon = var_smoothing x the largest
  feature variance of the unweighted train fold; its joint
  log-likelihood is the hand-written kernel B1 (`ops/nb_kernels.py`,
  sklearn's direct form, one launch for every lane of a chunk);
- MultinomialNB: log(N_cf + a) - log(N_c + a d);
- ComplementNB: each class from the counts of every other class;
- BernoulliNB: binarized counts, (N_cf + a) / (N_c + 2a) and the
  log(1 - p) term;
- CategoricalNB: per-(feature, category) counts, the categories padded
  to the search's largest count.

The per-class sums are library GEMMs.  Every lane of a fold has the same
fold weights, so the statistics are computed once a fold and each lane
takes its fold's by ``t % n_folds`` (lanes are candidate-major; the
search passes the fold count as ``static["__n_folds__"]``); only the
smoothing (var_smoothing, alpha) differs between a fold's lanes.

GaussianNB sets `proba_dtype_rule = "input"`: sklearn's GaussianNB keeps
a float32 X's probabilities float32, so `neg_log_loss` clips at
float32's eps.  The reference clips at float64's there and misses
sklearn; the port does not copy that.

MultinomialNB, ComplementNB and BernoulliNB also take a sparse X
(`supports_sparse`; the reference's `prepare_data_sparse`,
`naive_bayes.py:57-73, 266-275, 395-428`): under `data_mode="sparse"`
data["X"] is a `CSROperand`, the class sums Xᵀ (w y) and the joint
log-likelihoods' ``X @ flpᵀ`` run through SP1, and BernoulliNB binarizes
the stored values (a negative `binarize`, which would make every
implicit zero a one, is refused).  GaussianNB and CategoricalNB take
dense X only.

Not ported in this slice: the `stream_fit_*` protocol (streamed X).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import (
    Family,
    encode_labels,
    register_family,
)
from spark_sklearn_tpu_torch.models.linear import _lane_param
from spark_sklearn_tpu_torch.ops.nb_kernels import gnb_jll
from spark_sklearn_tpu_torch.sparse.csr import CSROperand, SparseOperand

_EPS = 1e-10


def _prep_classifier_data(X, y, dtype, x_override=None):
    """Encoded labels, their one-hot and the meta every classifier here
    shares (`naive_bayes.py:42`); `x_override` supplies data["X"]
    (CategoricalNB's int codes)."""
    classes, y_enc = encode_labels(y)
    k = len(classes)
    data = {"X": (np.ascontiguousarray(X, dtype=dtype)
                  if x_override is None else x_override),
            "y": y_enc,
            "y1h": np.eye(k, dtype=dtype)[y_enc]}
    meta = {"n_classes": int(k), "classes": classes,
            "n_features": int(X.shape[1])}
    return data, meta


def _prep_classifier_sparse(X, y, dtype):
    """Sparse twin of `_prep_classifier_data` (`naive_bayes.py:57-73`):
    X a scipy CSR staged as a `SparseOperand`, never densified; the
    labels as on the dense path."""
    op = SparseOperand.from_csr(X, dtype=dtype)
    data, meta = _prep_classifier_data(X, y, dtype, x_override=op)
    meta["sparse"] = op.signature()
    return data, meta


def _check_finite(Xa) -> None:
    """sklearn's check_array contract: NaN or infinity raise before any
    launch, in sklearn's words."""
    if not np.issubdtype(Xa.dtype, np.floating):
        return
    if np.isnan(Xa).any():
        raise ValueError("Input X contains NaN.")
    if np.isinf(Xa).any():
        raise ValueError(
            f"Input X contains infinity or a value too large for "
            f"{Xa.dtype!r}.")


def fold_rows(train_w, static):
    """(fold weights (F, n), lane -> fold index (B,)): the distinct
    weight rows of a chunk whose lanes are candidate-major over
    ``static["__n_folds__"]`` folds, else every lane its own row."""
    B = train_w.shape[0]
    F = int(static.get("__n_folds__", 0) or 0)
    if F <= 0 or B % F:
        return train_w, torch.arange(B, device=train_w.device)
    return train_w[:F], torch.arange(B, device=train_w.device) % F


def class_sums(y1h, w, X=None):
    """Weighted per-class sums for each row of `w` (F, n): counts (F, k)
    and, with X (n, d), the per-class feature sums (F, k, d) as one GEMM
    (`_class_sums`, naive_bayes.py:76), or one SP1 product over Xᵀ's CSR
    for a CSROperand: Xᵀ (w y) with the products laid out (n, F k), as
    SP1 reads them, and the (d, F k) result read back as its view."""
    counts = w @ y1h                                         # (F, k)
    if X is None:
        return counts, None
    F, k = counts.shape
    if isinstance(X, CSROperand):
        wy = (w.T[:, :, None] * y1h[:, None, :]).reshape(-1, F * k)
        return counts, X.tmm(wy).T.reshape(F, k, X.shape[1])
    wy = (w[:, None, :] * y1h.T[None, :, :]).reshape(F * k, -1)
    return counts, (wy @ X).reshape(F, k, X.shape[1])


def log_prior(counts, static, k):
    """sklearn's _update_class_log_prior for each row of counts (B, k)
    (`_log_prior`, naive_bayes.py:86)."""
    class_prior = static.get("class_prior")
    if class_prior is not None:
        lp = torch.log(torch.as_tensor(np.asarray(class_prior),
                                       device=counts.device).to(
                                           counts.dtype))
        return lp.expand(counts.shape).clone()
    if static.get("fit_prior", True):
        return torch.log(counts) - torch.log(counts.sum(dim=1,
                                                        keepdim=True))
    return torch.full_like(counts, -float(np.log(k)))


def _views_from_jll(jll, meta, needed):
    """Scorer views of a (T, n, k) joint log-likelihood."""
    views = {}
    if "pred" in needed:
        views["pred"] = torch.argmax(jll, dim=-1)
    if "proba" in needed:
        views["proba"] = torch.softmax(jll, dim=-1)
    if "decision" in needed:
        views["decision"] = (jll[..., 1] - jll[..., 0]
                             if meta["n_classes"] == 2 else jll)
    return views


class _NBFamily(Family):
    """The predict/proba/decision views shared by the families: each
    defines `_jll(model, static, X) -> (T, n, k)` for a model whose
    leaves carry a lane axis T."""

    is_classifier = True

    @classmethod
    def _jll(cls, model, static, X):
        raise NotImplementedError

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        return _views_from_jll(cls._jll(models, static, data["X"]), meta,
                               needed)

    @staticmethod
    def _one(model):
        return {k: v[None] for k, v in model.items()}

    @classmethod
    def predict(cls, model, static, X, meta):
        return torch.argmax(cls._jll(cls._one(model), static, X)[0], dim=1)

    @classmethod
    def predict_proba(cls, model, static, X, meta):
        return torch.softmax(cls._jll(cls._one(model), static, X)[0], dim=1)

    @classmethod
    def decision(cls, model, static, X, meta):
        jll = cls._jll(cls._one(model), static, X)[0]
        if meta["n_classes"] == 2:
            return jll[:, 1] - jll[:, 0]
        return jll


class GaussianNBFamily(_NBFamily):
    name = "gaussian_nb"
    dynamic_params = {"var_smoothing": np.float32}
    proba_dtype_rule = "input"

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        """sklearn's priors validation (GaussianNB._partial_fit), host-side
        and with sklearn's messages."""
        k = meta.get("n_classes")
        seen = set()
        for params in [base_params] + list(candidates):
            priors = params.get("priors")
            if priors is None or id(priors) in seen:
                continue
            seen.add(id(priors))
            p = np.asarray(priors, np.float64)
            if k is not None and len(p) != k:
                raise ValueError(
                    "Number of priors must match number of classes.")
            if not np.isclose(p.sum(), 1.0):
                raise ValueError("The sum of the priors should be 1.")
            if (p < 0).any():
                raise ValueError("Priors must be non-negative.")

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        return _prep_classifier_data(X, y, dtype)

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """theta and var (B, k, d), log_prior (B, k) (`fit`,
        naive_bayes.py:134-171): the statistics a fold, the smoothing a
        lane."""
        X, y, y1h = data["X"], data["y"].long(), data["y1h"]
        B = train_w.shape[0]
        vs = _lane_param(dynamic, static, "var_smoothing", 1e-9, B, X)
        fold_w, lane_fold = fold_rows(train_w, static)
        counts, sums = class_sums(y1h, fold_w, X)            # (F, k[, d])
        cnt = torch.clamp_min(counts, _EPS)[:, :, None]
        theta = sums / cnt                                   # (F, k, d)
        # two-pass variance about each row's own class mean (a one-pass
        # form cancels in float32 where a class offset dwarfs the spread)
        r = X[None] - theta[:, y]                            # (F, n, d)
        F, k = counts.shape
        wy = fold_w[:, None, :] * y1h.T[None]                # (F, k, n)
        var = torch.bmm(wy, r * r) / cnt
        # epsilon from the unweighted variance of the train fold
        ind = (fold_w > 0).to(X.dtype)
        n_ind = torch.clamp_min(ind.sum(dim=1, keepdim=True), 1.0)
        mu0 = (ind @ X) / n_ind                              # (F, d)
        r0 = X[None] - mu0[:, None, :]
        fold_var = torch.bmm(ind[:, None, :], r0 * r0)[:, 0] / n_ind
        eps = vs * fold_var.amax(dim=1)[lane_fold]           # (B,)
        var = var[lane_fold] + eps[:, None, None]
        priors = static.get("priors")
        if priors is not None:
            prior = torch.as_tensor(np.asarray(priors), device=X.device).to(
                X.dtype).expand(B, k)
        else:
            prior = (counts / torch.clamp_min(
                counts.sum(dim=1, keepdim=True), _EPS))[lane_fold]
        return {"theta": theta[lane_fold].contiguous(),
                "var": var.contiguous(),
                "log_prior": torch.log(torch.clamp_min(prior, 0.0))
                .contiguous()}

    @classmethod
    def _jll(cls, model, static, X):
        return gnb_jll(X.contiguous(), model["theta"], model["var"],
                       model["log_prior"])

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        return {"theta_": model["theta"].cpu().numpy(),
                "var_": model["var"].cpu().numpy(),
                "class_prior_": np.exp(model["log_prior"].cpu().numpy()),
                "classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


class MultinomialNBFamily(_NBFamily):
    name = "multinomial_nb"
    dynamic_params = {"alpha": np.float32}
    #: the fit and the views touch X only through products
    supports_sparse = True
    #: sklearn's check_non_negative names the concrete class
    _sklearn_display = "MultinomialNB"

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        """sklearn's class_prior length check (_update_class_log_prior),
        host-side."""
        k = meta.get("n_classes")
        if k is None:
            return
        for params in [base_params] + list(candidates):
            cp = params.get("class_prior")
            if cp is not None and len(np.asarray(cp)) != k:
                raise ValueError(
                    "Number of priors must match number of classes.")

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        Xa = np.asarray(X)
        _check_finite(Xa)
        if np.min(Xa) < 0:
            raise ValueError(
                f"Negative values in data passed to "
                f"{cls._sklearn_display} (input X)")
        return _prep_classifier_data(X, y, dtype)

    @classmethod
    def prepare_data_sparse(cls, X, y, dtype=np.float32):
        # the sign and finiteness checks on the stored values: implicit
        # zeros are non-negative and finite
        Xd = np.asarray(X.data)
        _check_finite(Xd)
        if Xd.size and np.min(Xd) < 0:
            raise ValueError(
                f"Negative values in data passed to "
                f"{cls._sklearn_display} (input X)")
        return _prep_classifier_sparse(X, y, dtype)

    @classmethod
    def _alpha(cls, dynamic, static, B, like):
        a = _lane_param(dynamic, static, "alpha", 1.0, B, like)
        if not static.get("force_alpha", True):
            a = torch.clamp_min(a, 1e-10)   # sklearn's _check_alpha clamp
        return a

    @classmethod
    def _fit_X(cls, static, X):
        """The matrix the count sums run over (Bernoulli binarizes)."""
        return X

    @classmethod
    def _model_from_sums(cls, a, static, counts, fc, meta):
        """The closed-form model from the lanes' class counts (B, k) and
        feature sums (B, k, d), `a` (B,) the lanes' alphas."""
        smoothed = fc + a[:, None, None]
        flp = torch.log(smoothed) - torch.log(smoothed.sum(dim=2))[:, :, None]
        return {"feature_log_prob": flp,
                "class_log_prior": log_prior(counts, static,
                                             meta["n_classes"]),
                "class_count": counts}

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        X = cls._fit_X(static, data["X"])
        a = cls._alpha(dynamic, static, train_w.shape[0], X)
        fold_w, lane_fold = fold_rows(train_w, static)
        counts, fc = class_sums(data["y1h"], fold_w, X)
        return cls._model_from_sums(a, static, counts[lane_fold],
                                    fc[lane_fold], meta)

    @staticmethod
    def _lane_gemm(X, W):
        """X (n, d) against each lane's (k, d) rows W (T, k, d): (T, n, k)
        from one GEMM of width T*k (one SP1 product for a CSROperand)."""
        T, k, d = W.shape
        Z = X @ W.reshape(T * k, d).T                        # (n, T*k)
        return Z.view(-1, T, k).transpose(0, 1)

    @classmethod
    def _jll(cls, model, static, X):
        return cls._lane_gemm(X, model["feature_log_prob"]) \
            + model["class_log_prior"][:, None, :]

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        return {"feature_log_prob_": model["feature_log_prob"].cpu().numpy(),
                "class_log_prior_": model["class_log_prior"].cpu().numpy(),
                "class_count_": model["class_count"].cpu().numpy(),
                "classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


class ComplementNBFamily(MultinomialNBFamily):
    """Complement NB (sklearn ComplementNB): comp_count = feature_all +
    alpha - feature_count, negated log ratios (or normalized with
    `norm`); the class prior enters only the single-class case."""

    name = "complement_nb"
    _sklearn_display = "ComplementNB"

    @classmethod
    def _model_from_sums(cls, a, static, counts, fc, meta):
        comp = fc.sum(dim=1, keepdim=True) + a[:, None, None] - fc
        logged = torch.log(comp / comp.sum(dim=2, keepdim=True))
        if static.get("norm", False):
            flp = logged / logged.sum(dim=2, keepdim=True)
        else:
            flp = -logged
        return {"feature_log_prob": flp,
                "class_log_prior": log_prior(counts, static,
                                             meta["n_classes"]),
                "class_count": counts}

    @classmethod
    def _jll(cls, model, static, X):
        jll = cls._lane_gemm(X, model["feature_log_prob"])
        if model["class_log_prior"].shape[1] == 1:
            jll = jll + model["class_log_prior"][:, None, :]
        return jll


def _binarizes_zeros(b) -> bool:
    """Whether threshold `b` maps 0 to 1."""
    return b is not None and float(b) < 0


def _refuse_sparse_binarize(b) -> None:
    if _binarizes_zeros(b):
        raise ValueError(
            "binarize < 0 densifies a sparse X (implicit zeros "
            "binarize to 1); use data_mode='device'")


class BernoulliNBFamily(MultinomialNBFamily):
    name = "bernoulli_nb"
    _sklearn_display = "BernoulliNB"

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        # negative X is fine (binarize thresholds it); NaN is not
        _check_finite(np.asarray(X))
        return _prep_classifier_data(X, y, dtype)

    @classmethod
    def prepare_data_sparse(cls, X, y, dtype=np.float32):
        _check_finite(np.asarray(X.data))
        return _prep_classifier_sparse(X, y, dtype)

    @classmethod
    def takes_sparse(cls, static) -> bool:
        """binarize < 0 would turn every implicit zero into a one: such a
        fit takes X dense."""
        return not _binarizes_zeros(static.get("binarize", 0.0))

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        """Also refuses binarize < 0 on a sparse X before any fit (the
        reference's refusal, naive_bayes.py:398-415)."""
        super().observe_candidates(candidates, base_params, meta)
        if not meta.get("sparse"):
            return
        b0 = base_params.get("binarize", 0.0)
        for params in [base_params] + list(candidates):
            _refuse_sparse_binarize(params.get("binarize", b0))

    @classmethod
    def _fit_X(cls, static, X):
        b = static.get("binarize", 0.0)
        if b is None:
            return X
        if isinstance(X, CSROperand):
            # the stored values only: implicit zeros stay zero (b >= 0)
            _refuse_sparse_binarize(b)
            return X.map_values(lambda v: (v > b).to(v.dtype))
        return (X > b).to(X.dtype)

    @classmethod
    def _model_from_sums(cls, a, static, counts, fc, meta):
        a3 = a[:, None, None]
        denom = torch.log(counts + 2.0 * a[:, None])[:, :, None]
        return {"feature_log_prob": torch.log(fc + a3) - denom,
                "log_neg_prob": torch.log(counts[:, :, None] - fc + a3)
                - denom,
                "class_log_prior": log_prior(counts, static,
                                             meta["n_classes"]),
                "class_count": counts}

    @classmethod
    def _jll(cls, model, static, X):
        flp, lnp = model["feature_log_prob"], model["log_neg_prob"]
        return cls._lane_gemm(cls._fit_X(static, X), flp - lnp) \
            + lnp.sum(dim=2)[:, None, :] \
            + model["class_log_prior"][:, None, :]


class CategoricalNBFamily(MultinomialNBFamily):
    """Categorical NB: per-(feature, category) counts, padded to the
    largest category count of the search; the counts are one GEMM of
    the weighted one-hot labels against the one-hot codes, the jll one
    GEMM of the codes against the lanes' log-probabilities.

    As the reference (its documented deviation): n_categories_ comes from
    the whole X of the search, as if `min_categories` covered it, where
    sklearn's per-fold fit would raise on a test fold holding a category
    its train fold never saw."""

    name = "categorical_nb"
    _sklearn_display = "CategoricalNB"
    supports_sparse = False

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        Xa = np.asarray(X)
        if np.issubdtype(Xa.dtype, np.floating) and \
                not np.isfinite(Xa).all():
            raise ValueError("Input X contains NaN.")
        if np.min(Xa) < 0:
            raise ValueError(
                "Negative values in data passed to CategoricalNB "
                "(input X)")
        codes = np.ascontiguousarray(Xa, dtype=np.int32)
        data, meta = _prep_classifier_data(codes, y, dtype,
                                           x_override=codes)
        meta["n_categories"] = (codes.max(axis=0) + 1).astype(np.int64)
        return data, meta

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        """min_categories into the padded category counts (sklearn
        _validate_n_categories), host-side."""
        super().observe_candidates(candidates, base_params, meta)
        mc = base_params.get("min_categories")
        if any(c.get("min_categories", mc) is not mc for c in candidates):
            raise ValueError(
                "min_categories changes the fitted shapes and cannot vary "
                "between the candidates of one search")
        if mc is not None and "n_categories" in meta:
            mc_arr = np.asarray(mc)
            if not np.issubdtype(mc_arr.dtype, np.signedinteger):
                raise ValueError(
                    "'min_categories' should have integral type. Got "
                    f"{mc_arr.dtype} instead.")
            d = len(meta["n_categories"])
            if mc_arr.ndim > 0 and mc_arr.shape != (d,):
                raise ValueError(
                    f"'min_categories' should have shape ({d},) when "
                    f"an array-like is provided. Got {mc_arr.shape} "
                    f"instead.")
            meta["n_categories"] = np.maximum(
                meta["n_categories"], mc_arr).astype(np.int64)

    @staticmethod
    def _one_hot(codes, C, dtype):
        """(n, d*C) one-hot of the codes (a code >= C gives a zero row, as
        jax.nn.one_hot does)."""
        n, d = codes.shape
        oh = torch.zeros((n, d, C), dtype=dtype, device=codes.device)
        c = codes.long()
        oh.scatter_(2, torch.clamp(c, 0, C - 1)[:, :, None],
                    (c < C).to(dtype)[:, :, None])
        return oh.reshape(n, d * C)

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        codes, y1h = data["X"], data["y1h"]
        k = meta["n_classes"]
        ncat = torch.as_tensor(np.asarray(meta["n_categories"]),
                               device=y1h.device).to(y1h.dtype)   # (d,)
        d = codes.shape[1]
        C = int(np.max(meta["n_categories"]))
        B = train_w.shape[0]
        a = cls._alpha(dynamic, static, B, y1h)
        fold_w, lane_fold = fold_rows(train_w, static)
        F = fold_w.shape[0]
        counts = fold_w @ y1h                                # (F, k)
        wy = (fold_w[:, None, :] * y1h.T[None]).reshape(F * k, -1)
        cat = (wy @ cls._one_hot(codes, C, y1h.dtype)).reshape(F, k, d, C)
        cat, counts = cat[lane_fold], counts[lane_fold]
        # per-feature denominator: total + alpha * n_categories_i
        denom = cat.sum(dim=3) + a[:, None, None] * ncat[None, None, :]
        flp = torch.log(cat + a[:, None, None, None]) \
            - torch.log(denom)[:, :, :, None]
        return {"feature_log_prob": flp,                     # (B, k, d, C)
                "class_log_prior": log_prior(counts, static, k),
                "class_count": counts}

    @classmethod
    def _jll(cls, model, static, X):
        flp = model["feature_log_prob"]                      # (T, k, d, C)
        T, k, d, C = flp.shape
        oh = cls._one_hot(X, C, flp.dtype)
        return cls._lane_gemm(oh, flp.reshape(T, k, d * C)) \
            + model["class_log_prior"][:, None, :]

    @classmethod
    def check_predict_X(cls, X, meta):
        """sklearn raises IndexError for a category the model never
        allocated; a one-hot would silently zero it."""
        ncat = np.asarray(meta["n_categories"])
        codes = np.asarray(X)
        bad = codes >= ncat[None, :]
        if bad.any():
            i, j = np.argwhere(bad)[0]
            raise IndexError(
                f"index {int(codes[i, j])} is out of bounds for feature "
                f"{int(j)} with {int(ncat[j])} categories")

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        flp = model["feature_log_prob"].cpu().numpy()
        ncat = np.asarray(meta["n_categories"])
        return {"feature_log_prob_": [flp[:, i, :ncat[i]]
                                      for i in range(flp.shape[1])],
                "class_log_prior_": model["class_log_prior"].cpu().numpy(),
                "class_count_": model["class_count"].cpu().numpy(),
                "n_categories_": ncat,
                "classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


_PORT = "spark_sklearn_tpu_torch.models.estimators"
for _fam, _cls in ((GaussianNBFamily, "GaussianNB"),
                   (MultinomialNBFamily, "MultinomialNB"),
                   (ComplementNBFamily, "ComplementNB"),
                   (BernoulliNBFamily, "BernoulliNB"),
                   (CategoricalNBFamily, "CategoricalNB")):
    register_family(_fam, f"sklearn.naive_bayes.{_cls}", f"{_PORT}.{_cls}")
