"""The k-nearest-neighbors families, lane-batched: KNeighborsClassifier
and KNeighborsRegressor (brute force, euclidean).

Counterpart of `spark_sklearn_tpu/models/neighbors.py` (:48-290).  A
chunk of (candidate x fold) lanes shares one preamble:

- ONE squared-distance Gram for the whole chunk: the library GEMM
  G = X Xᵀ and the row norms;
- N1 (`ops/knn_kernels.knn_fold_topk`): for every fold at once, each
  row's `max_k` nearest train columns (the non-train ones at +inf),
  ascending, ties to the lower column, from one launch;
- per fold the cumulative weighted votes over the sorted neighbors
  (one-hot labels for the classifier, targets for the regressor), with
  weights 1/max(d, 1e-12) (`weights="distance"`: an exact duplicate
  takes the vote, as sklearn's zero-distance rule) or 1;
- per lane, k is an index into the cumulative votes.

A row of the train fold sees itself as a zero-distance neighbor, as
sklearn's `fit(X_train).predict(X_train)` does.  `observe_candidates`
raises, as sklearn does when scoring such a fold, where the grid's
largest n_neighbors exceeds the smallest train fold.  metric is
minkowski with p=2 or euclidean; weights "uniform" or "distance"; KNN's
fit takes no sample_weight (sklearn).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import (
    Family,
    encode_labels,
    register_family,
)
from spark_sklearn_tpu_torch.ops.knn_kernels import knn_fold_topk

_EPS_DIST = 1e-12


def check_metric(static) -> None:
    metric = static.get("metric", "minkowski")
    p = static.get("p", 2)
    if metric not in ("minkowski", "euclidean") or \
            (metric == "minkowski" and p not in (2, 2.0)):
        raise ValueError(
            f"metric={metric!r}/p={p!r} is not supported in the PyTorch "
            "port (brute euclidean only)")
    weights = static.get("weights", "uniform")
    if callable(weights) or weights not in ("uniform", "distance"):
        raise ValueError(f"weights={weights!r} is not supported in the "
                         "PyTorch port")


def neighbors(X_rows, X_cols, masks, maxk):
    """(d2, idx) (F, m, maxk) of each row of X_rows among the columns
    X_cols under each mask row, through the library GEMM and N1."""
    G = X_rows @ X_cols.T
    sq_rows = (X_rows * X_rows).sum(dim=1)
    sq_cols = sq_rows if X_rows is X_cols else (X_cols * X_cols).sum(dim=1)
    return knn_fold_topk(G, sq_rows, sq_cols, masks.contiguous(), maxk)


def neighbor_weights(d2, weights):
    """The votes' weights, 0 past a fold's train count (+inf d2)."""
    valid = torch.isfinite(d2)
    if weights == "distance":
        w = 1.0 / torch.clamp_min(torch.sqrt(d2), _EPS_DIST)
    else:
        w = torch.ones_like(d2)
    return torch.where(valid, w, torch.zeros_like(w))


class KNeighborsClassifierFamily(Family):
    name = "kneighbors_classifier"
    is_classifier = True
    dynamic_params = {"n_neighbors": np.int32}
    #: sklearn's vote tables are float64 whatever X's dtype
    proba_dtype_rule = "float64"
    accepts_sample_weight = False

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        classes, y_enc = encode_labels(y)
        data = {"X": np.ascontiguousarray(X, dtype=dtype), "y": y_enc}
        meta = {"n_classes": int(len(classes)), "classes": classes,
                "n_features": int(X.shape[1])}
        return data, meta

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        ks = [int(c.get("n_neighbors", base_params.get("n_neighbors", 5)))
              for c in candidates] or [int(base_params.get("n_neighbors",
                                                           5))]
        meta["max_k"] = max(ks)
        mft = meta.get("min_fold_train_count")
        if mft is not None and meta["max_k"] > mft:
            raise ValueError(
                f"Expected n_neighbors <= n_samples_fit, but "
                f"n_neighbors = {meta['max_k']}, n_samples_fit = {mft} "
                f"(smallest CV train fold); sklearn raises when scoring "
                f"such a fold")

    @staticmethod
    def max_tasks_hint(n_samples: int, meta) -> int:
        """The chunk's (lanes, n, n_classes) float votes within 1 GiB."""
        kc = meta.get("n_classes", 2)
        return max(1, (1 << 30) // max(1, n_samples * kc * 4))

    @classmethod
    def _cum_votes(cls, data, static, train_w, meta, vals_of):
        """The preamble: the folds' sorted neighbors (N1) and their
        cumulative weighted votes (F, n, maxk, V) and weights (F, n,
        maxk); `vals_of(idx)` gives what is voted, (F, n, maxk, V)."""
        check_metric(static)
        n_folds = int(static.get("__n_folds__", 0))
        if n_folds <= 0:
            raise ValueError("the search must pass __n_folds__ for KNN")
        X = data["X"]
        B, n = train_w.shape
        maxk = cls._maxk(static, meta, n)
        fold_w = train_w.reshape(B // n_folds, n_folds, n)[0]    # (F, n)
        d2, idx = neighbors(X, X, fold_w, maxk)                  # (F, n, K)
        wkn = neighbor_weights(d2, static.get("weights", "uniform"))
        vals = vals_of(idx.long())
        return (torch.cumsum(vals * wkn[..., None], dim=2),
                torch.cumsum(wkn, dim=2))

    @staticmethod
    def _maxk(static, meta, n):
        return min(int(meta.get("max_k", static.get("n_neighbors", 5))), n)

    @classmethod
    def _lanes(cls, dynamic, static, meta, B, n, device):
        """Each lane's fold and neighbor index k - 1 (clipped to maxk)."""
        n_folds = int(static["__n_folds__"])
        k = torch.as_tensor(
            dynamic.get("n_neighbors", static.get("n_neighbors", 5)),
            device=device).long().expand(B)
        kk = torch.clamp(k - 1, 0, cls._maxk(static, meta, n) - 1)
        return torch.arange(B, device=device) % n_folds, kk

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        X, y = data["X"], data["y"].long()
        B, n = train_w.shape
        kc = meta["n_classes"]
        cum, _ = cls._cum_votes(
            data, static, train_w, meta,
            lambda idx: torch.nn.functional.one_hot(y[idx], kc).to(X.dtype))
        f_idx, kk = cls._lanes(dynamic, static, meta, B, n, X.device)
        votes = cum[f_idx, :, kk]                              # (B, n, kc)
        return {"proba": votes / torch.clamp_min(
            votes.sum(dim=2, keepdim=True), _EPS_DIST)}

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        proba = models["proba"]
        views = {}
        if "pred" in needed:
            views["pred"] = torch.argmax(proba, dim=-1)
        if "proba" in needed:
            views["proba"] = proba
        if "decision" in needed:
            views["decision"] = (proba[..., 1] if meta["n_classes"] == 2
                                 else proba)
        return views

    @classmethod
    def predict_new(cls, X_train, y_train, X, static, meta):
        """Each row of X's votes among all of X_train: class
        probabilities (m, n_classes) for the classifier, predictions (m,)
        for the regressor; one N1 launch with one all-ones mask."""
        check_metric(static)
        n = X_train.shape[0]
        k = int(static.get("n_neighbors", 5))
        if k > n:
            raise ValueError(
                f"Expected n_neighbors <= n_samples_fit, but n_neighbors = "
                f"{k}, n_samples_fit = {n}")
        ones = torch.ones((1, n), dtype=X.dtype, device=X.device)
        d2, idx = neighbors(X, X_train, ones, k)
        wkn = neighbor_weights(d2[0], static.get("weights", "uniform"))
        labels = y_train[idx[0].long()]                          # (m, k)
        if not cls.is_classifier:
            return (labels * wkn).sum(dim=1) / torch.clamp_min(
                wkn.sum(dim=1), _EPS_DIST)
        votes = (torch.nn.functional.one_hot(
            labels.long(), meta["n_classes"]).to(X.dtype)
            * wkn[..., None]).sum(dim=1)
        return votes / torch.clamp_min(votes.sum(dim=1, keepdim=True),
                                       _EPS_DIST)

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        return {"classes_": meta["classes"],
                "n_features_in_": meta["n_features"]}


class KNeighborsRegressorFamily(KNeighborsClassifierFamily):
    name = "kneighbors_regressor"
    is_classifier = False

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        data = {"X": np.ascontiguousarray(X, dtype=dtype),
                "y": np.ascontiguousarray(y, dtype=dtype)}
        meta = {"n_features": int(X.shape[1])}
        return data, meta

    @staticmethod
    def max_tasks_hint(n_samples: int, meta) -> int:
        return max(1, (1 << 30) // max(1, n_samples * 4))

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        X, y = data["X"], data["y"]
        B, n = train_w.shape
        cum, cumw = cls._cum_votes(data, static, train_w, meta,
                                   lambda idx: y[idx][..., None])
        f_idx, kk = cls._lanes(dynamic, static, meta, B, n, X.device)
        s = cum[..., 0][f_idx, :, kk]                             # (B, n)
        w = cumw[f_idx, :, kk]
        return {"pred": s / torch.clamp_min(w, _EPS_DIST)}

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        if needed - {"pred"}:
            raise NotImplementedError(
                "KNeighborsRegressor has only predictions to score")
        return {"pred": models["pred"]}

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        return {"n_features_in_": meta["n_features"]}


register_family(
    KNeighborsClassifierFamily,
    "sklearn.neighbors._classification.KNeighborsClassifier",
    "sklearn.neighbors.KNeighborsClassifier",
    "spark_sklearn_tpu_torch.models.estimators.KNeighborsClassifier",
)
register_family(
    KNeighborsRegressorFamily,
    "sklearn.neighbors._regression.KNeighborsRegressor",
    "sklearn.neighbors.KNeighborsRegressor",
    "spark_sklearn_tpu_torch.models.estimators.KNeighborsRegressor",
)
