"""KMeans, lane-batched: k-means++ (or random) seeding and Lloyd's
iterations for every (candidate x fold) lane at once.

Counterpart of `spark_sklearn_tpu/models/cluster.py` (:31-185).  A lane's
fold mask is its sample weight, in the seeding and in the center
updates:

- seeding draws the reference's numbers (`ops/random.py`, bit for bit
  up to the logs' last ulp): k-means++ by Gumbel-max draws over the
  weighted squared distances to the nearest chosen center (sklearn's D^2
  sampling without its local trials), `init="random"` by `choice`
  without replacement weighted by w; run t of `n_init` draws under
  ``fold_in(PRNGKey(random_state), t)``, the same keys for every lane;
- a Lloyd iteration is C1 (`ops/kmeans_kernels.kmeans_assign`: every
  lane's distances from X and its centers, in a fixed summation order,
  and the nearest centers; no GEMM before it) and the center update as
  one batched GEMM of the weighted one-hot assignment against X; an
  empty cluster keeps its center;
- a lane runs while its iterations are below max_iter and its last
  shift (Σ ||C_new - C||²) is above tol x the weighted mean feature
  variance of its fold (sklearn's `_tolerance`), as `jax.vmap` runs the
  reference's `while_loop`: a finished lane keeps its centers and its
  count; the loop ends when every lane has finished;
- of the `n_init` runs a lane keeps the one of least inertia.

The keyed fleet (`fit_fleet`, `predict_fleet`) runs the same seeding
and iterations with each key's own rows, X (G, L, d), through C1ℓ
(`kmeans_assign_lanes`): the reference's per-task `fit` under `jax.vmap`
over keys, its draws shared by the keys of a bucket (one key,
`PRNGKey(random_state)`, for every lane) and its tol scaled by each
key's own weighted variance; a key needs n_clusters rows
(`min_group_size`).

The default scorer is -Σ w min d² over the test fold (sklearn's
`KMeans.score`): the search's `neg_inertia` core over the "min_d2"
view, which C1 gives.  Labels are never needed; numeric y reaches the
device only for a supervised scorer.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import Family, register_family
from spark_sklearn_tpu_torch.models.naive_bayes import fold_rows
from spark_sklearn_tpu_torch.ops import random as prng
from spark_sklearn_tpu_torch.ops.kmeans_kernels import (
    assign_distances,
    kmeans_assign,
    kmeans_assign_lanes,
)

#: most elements of a (lanes, n, d) difference formed at once in seeding
_SEED_ELEMS = 1 << 26


def _sq_to(X, P):
    """(B, n) squared distances of X's rows to each lane's point P (B, d),
    as the reference's sum((X - p)^2) over the features."""
    B, (n, d) = P.shape[0], X.shape
    step = max(1, _SEED_ELEMS // max(1, n * d))
    return torch.cat([((X[None] - P[lo:lo + step, None, :]) ** 2).sum(dim=2)
                      for lo in range(0, B, step)])


class _SharedRows:
    """X (n, d), the same rows for every lane (the search's folds)."""

    def __init__(self, X):
        self.X, self.n = X, X.shape[0]

    def take(self, idx):
        """The rows idx (B,) or (B, k) of each lane."""
        return self.X[idx]

    def sq_to(self, P):
        return _sq_to(self.X, P)


class _LaneRows:
    """X (B, n, d), each lane's own rows (the keyed fleet's keys)."""

    def __init__(self, X):
        self.X, self.n = X, X.shape[1]
        self.lanes = torch.arange(X.shape[0], device=X.device)

    def take(self, idx):
        lanes = self.lanes if idx.dim() == 1 else self.lanes[:, None]
        return self.X[lanes, idx]

    def sq_to(self, P):
        return ((self.X - P[:, None, :]) ** 2).sum(dim=2)


def _resolve_init(static):
    init = static.get("init", "k-means++")
    if not isinstance(init, str) or init not in ("k-means++", "random"):
        raise ValueError(
            f"init={init!r} is not supported in the PyTorch port "
            "('k-means++' or 'random')")
    n_init = static.get("n_init", "auto")
    if n_init == "auto":
        n_init = 1 if init == "k-means++" else 10
    return init, int(n_init)


class KMeansFamily(Family):
    name = "kmeans"
    is_classifier = False
    dynamic_params = {"tol": np.float32}
    #: the search's scorer for scoring=None (`search/scorers.py`)
    default_scorer = "neg_inertia"

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        data = {"X": np.ascontiguousarray(X, dtype=dtype)}
        if y is not None:
            y_arr = np.asarray(y)
            if np.issubdtype(y_arr.dtype, np.number):
                data["y"] = y_arr   # object labels never reach the device
        meta = {"n_features": int(X.shape[1])}
        return data, meta

    @staticmethod
    def _assign(X, xx, C, w):
        """C1 on every lane's centers C (B, k, d)."""
        return kmeans_assign(X.contiguous(), C.contiguous(), xx,
                             (C * C).sum(dim=2), w)

    @classmethod
    def _seed(cls, key, init, rows, w, k):
        """(B, k, d) initial centers of every lane under one key; `rows`
        X (n, d), a `_SharedRows` or a `_LaneRows`."""
        if isinstance(rows, torch.Tensor):
            rows = _SharedRows(rows)
        n = rows.n
        if init == "random":
            p = w / (w.sum(dim=1, keepdim=True) + 1e-12)
            return rows.take(prng.choice(key, n, k, p))
        k0, key = prng.split(key)
        dev = w.device
        ninf = torch.tensor(-float("inf"), dtype=w.dtype, device=dev)
        logw = torch.where(w > 0, torch.log(w + 1e-12), ninf)
        first = torch.argmax(logw + prng.gumbel(k0, (n,), dev), dim=1)
        centers = [rows.take(first)]
        min_d2 = rows.sq_to(centers[0])
        for _ in range(1, k):
            key, kk = prng.split(key)
            logits = torch.where((w > 0) & (min_d2 > 0),
                                 torch.log(w * min_d2 + 1e-30), ninf)
            nxt = torch.argmax(logits + prng.gumbel(kk, (n,), dev), dim=1)
            centers.append(rows.take(nxt))
            min_d2 = torch.minimum(min_d2, rows.sq_to(centers[-1]))
        return torch.stack(centers, dim=1)

    @classmethod
    def _lloyd(cls, assign_fn, X, w, C, tol, max_iter):
        """Lloyd's iterations of every lane until each has finished, the
        assignment by `assign_fn(C)` (C1 or C1ℓ) and the centre sums
        `onehotᵀ @ X` over X (n, d) or (B, n, d); returns (centers,
        inertia, n_iter)."""
        B, k, _ = C.shape
        shift = torch.full((B,), float("inf"), dtype=X.dtype,
                           device=X.device)
        n_iter = torch.zeros(B, dtype=torch.int32, device=X.device)
        active = (n_iter < max_iter) & (shift > tol)
        while bool(active.any()):
            assign, _, _ = assign_fn(C)
            oh = torch.nn.functional.one_hot(assign.long(), k).to(X.dtype) \
                * w[:, :, None]                              # (B, n, k)
            counts = oh.sum(dim=1)                           # (B, k)
            sums = oh.transpose(1, 2) @ X                    # (B, k, d)
            C_new = torch.where(
                counts[:, :, None] > 0,
                sums / torch.clamp_min(counts[:, :, None], 1e-12), C)
            new_shift = ((C_new - C) ** 2).sum(dim=(1, 2))
            C = torch.where(active[:, None, None], C_new, C)
            shift = torch.where(active, new_shift, shift)
            n_iter = n_iter + active.to(torch.int32)
            active = (n_iter < max_iter) & (shift > tol)
        _, _, inertia = assign_fn(C)
        return C, inertia, n_iter

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """centers (B, k, d), inertia (B,) and n_iter (B,) of every lane
        (`fit`, cluster.py:68-160)."""
        X = data["X"]
        B, n = train_w.shape
        k = int(static.get("n_clusters", 8))
        max_iter = int(static.get("max_iter", 300))
        init, n_init = _resolve_init(static)
        # tol scales by the weighted mean feature variance of the fold
        fold_w, lane_fold = fold_rows(train_w, static)
        wsum = fold_w.sum(dim=1, keepdim=True) + 1e-12
        xbar = (fold_w @ X) / wsum
        wvar = torch.bmm(fold_w[:, None, :],
                         (X[None] - xbar[:, None, :]) ** 2)[:, 0] / wsum
        tol = torch.as_tensor(dynamic.get("tol", static.get("tol", 1e-4)),
                              device=X.device).to(X.dtype).expand(B) \
            * wvar.mean(dim=1)[lane_fold]
        seed = static.get("random_state")
        base_key = prng.PRNGKey(0 if seed is None else int(seed))
        xx = (X * X).sum(dim=1)
        w = train_w.contiguous()
        best_C = torch.zeros((B, k, X.shape[1]), dtype=X.dtype,
                             device=X.device)
        best_inertia = torch.full((B,), float("inf"), dtype=X.dtype,
                                  device=X.device)
        best_iter = torch.zeros(B, dtype=torch.int32, device=X.device)
        rows = _SharedRows(X)
        for t in range(n_init):
            C0 = cls._seed(prng.fold_in(base_key, t), init, rows, w, k)
            C, inertia, n_iter = cls._lloyd(
                lambda C: cls._assign(X, xx, C, w), X, w, C0, tol, max_iter)
            better = inertia < best_inertia
            best_C = torch.where(better[:, None, None], C, best_C)
            best_inertia = torch.where(better, inertia, best_inertia)
            best_iter = torch.where(better, n_iter, best_iter)
        return {"centers": best_C, "inertia": best_inertia,
                "n_iter": best_iter}

    @classmethod
    def min_group_size(cls, static) -> int:
        """A key needs n_clusters rows; fewer go to a host fit, which
        raises as sklearn does (`cluster.py:51`)."""
        return int(static.get("n_clusters", 8))

    @classmethod
    def fit_fleet(cls, static, X, y, w, meta):
        """One fit a key (the reference's `fit` under `jax.vmap` over
        keys): X (G, L, d), w (G, L) 0/1 row weights.  Returns centers
        (G, k, d), inertia (G,) and n_iter (G,)."""
        G, L, d = X.shape
        k = int(static.get("n_clusters", 8))
        max_iter = int(static.get("max_iter", 300))
        init, n_init = _resolve_init(static)
        # tol scales by each key's weighted mean feature variance
        wsum = w.sum(dim=1, keepdim=True) + 1e-12
        xbar = torch.bmm(w[:, None, :], X)[:, 0] / wsum
        wvar = torch.bmm(w[:, None, :],
                         (X - xbar[:, None, :]) ** 2)[:, 0] / wsum
        tol = torch.as_tensor(static.get("tol", 1e-4),
                              device=X.device).to(X.dtype) \
            * wvar.mean(dim=1)
        seed = static.get("random_state")
        base_key = prng.PRNGKey(0 if seed is None else int(seed))
        xx = (X * X).sum(dim=2)
        rows = _LaneRows(X)

        def assign_fn(C):                    # C1ℓ
            return kmeans_assign_lanes(X, C.contiguous(), xx,
                                       (C * C).sum(dim=2), w)

        best_C = torch.zeros((G, k, d), dtype=X.dtype, device=X.device)
        best_inertia = torch.full((G,), float("inf"), dtype=X.dtype,
                                  device=X.device)
        best_iter = torch.zeros(G, dtype=torch.int32, device=X.device)
        for t in range(n_init):
            C0 = cls._seed(prng.fold_in(base_key, t), init, rows, w, k)
            C, inertia, n_iter = cls._lloyd(assign_fn, X, w, C0, tol,
                                            max_iter)
            better = inertia < best_inertia
            best_C = torch.where(better[:, None, None], C, best_C)
            best_inertia = torch.where(better, inertia, best_inertia)
            best_iter = torch.where(better, n_iter, best_iter)
        return {"centers": best_C, "inertia": best_inertia,
                "n_iter": best_iter}

    @classmethod
    def predict_fleet(cls, models, static, X, meta):
        """(G, L) nearest centers of each key's rows X (G, L, d), C1ℓ."""
        C = models["centers"].contiguous()
        ones = torch.ones(X.shape[:2], dtype=X.dtype, device=X.device)
        assign, _, _ = kmeans_assign_lanes(
            X.contiguous(), C, (X * X).sum(dim=2), (C * C).sum(dim=2), ones)
        return assign.long()

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """"pred" (T, n) nearest centers and "min_d2" (T, n) their
        distances, from C1; "decision" (T, n, k) the negated distances in
        C1's order (`assign_distances`), so that "pred" is its argmax."""
        X, C = data["X"], models["centers"]
        xx = (X * X).sum(dim=1)
        views = {}
        if needed & {"pred", "min_d2"}:
            ones = torch.ones((C.shape[0], X.shape[0]), dtype=X.dtype,
                              device=X.device)
            assign, min_d2, _ = cls._assign(X, xx, C, ones)
            views["pred"], views["min_d2"] = assign.long(), min_d2
        if "decision" in needed:
            views["decision"] = -assign_distances(X, C, xx,
                                                  (C * C).sum(dim=2))
        return {v: views[v] for v in needed}

    @classmethod
    def predict(cls, model, static, X, meta):
        return cls.views_task_batched(
            {k: v[None] for k, v in model.items()}, static, {"X": X}, meta,
            {"pred"})["pred"][0]

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        return {"cluster_centers_": model["centers"].cpu().numpy(),
                "inertia_": float(model["inertia"]),
                "n_iter_": int(model["n_iter"]),
                "n_features_in_": meta["n_features"]}


register_family(
    KMeansFamily,
    "sklearn.cluster._kmeans.KMeans",
    "sklearn.cluster.KMeans",
    "spark_sklearn_tpu_torch.models.estimators.KMeans",
)
