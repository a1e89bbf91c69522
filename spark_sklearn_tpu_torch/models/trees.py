"""Gradient boosting and random forest families on binned trees.

Counterpart of `spark_sklearn_tpu/models/trees.py`: the same four
families (GradientBoostingRegressor/Classifier, RandomForestClassifier/
Regressor) on the histogram grower of `ops/trees.py`, with the lane axis
written out where the reference `vmap`s over candidates and folds:

- Boosting carries the prediction F on the full data (fold masks only
  weight the gradients) and grows one tree a stage per lane (k per-class
  trees for a k-class classifier, folded into the lane axis).
  `n_estimators` is dynamic: a chunk grows the max over its lanes of
  ``min(n_estimators, t_max)`` trees, and a lane past its own count grows
  no more (the reference's batched `while_loop` freezes it; its masked
  contribution is zero either way).  One group serves every
  `n_estimators` of a grid.
- The forest averages trees grown on Poisson(1) bootstrap weights (or the
  fold mask with ``bootstrap=False``) with per-level random feature
  subsets, on one-hot targets (the variance criterion matches gini up to
  scale).

The reference's key is static: ``PRNGKey(random_state)`` does not depend
on the lane, so every lane of a tree draws the same subsample mask,
Poisson weights and feature masks, and only the fold weights differ.  The
port draws each tree's numbers once (`ops/random.py`, bit for bit
jax.random's) and broadcasts them over the lanes.

Known deviations from sklearn, as the reference's: 256-bin quantile
splits instead of exact ones, the Poisson bootstrap, and `max_depth`
None or above 10 capped (with a warning once a search).  Refit is the
user's sklearn estimator on the host; the port's own `GradientBoosting*`
and `RandomForest*` classes below are parameter holders that a search
resolves on a machine without sklearn, and cannot refit.
"""

from __future__ import annotations

import warnings
import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import (
    Family,
    encode_labels,
    register_family,
)
from spark_sklearn_tpu_torch.models.estimators import _Estimator
from spark_sklearn_tpu_torch.ops import random as jr
from spark_sklearn_tpu_torch.ops.tree_kernels import leaf_values
from spark_sklearn_tpu_torch.ops.trees import accumulate_tree, grow_tree
from spark_sklearn_tpu_torch.utils.binning import quantile_bin

N_BINS = 256
#: boosting stages whose subsample draws are made in one pass
RNG_BLOCK = 16
#: the grower's static depth bound
MAX_COMPILED_DEPTH = 10


def _prep_codes(X, dtype):
    edges, codes = quantile_bin(np.asarray(X, np.float32), N_BINS)
    return edges, codes.astype(np.int32)


def _seed(static):
    rs = static.get("random_state")
    return 0 if rs is None else int(rs)


def _observe_tree_candidates(cls, candidates, base_params, meta):
    """The search's hook, host-side once a search (models/trees.py:53-94):
    the grid's largest `n_estimators` (`meta["max_estimators"]`, the count
    of trees a chunk may grow), and one warning where a candidate's
    `max_depth` is None or above the grower's bound."""
    # the base estimator's value counts only where a candidate does not
    # override it
    base = base_params.get("n_estimators", 100)
    vals = [c.get("n_estimators", base) for c in candidates] or [base]
    meta["max_estimators"] = int(
        max([v for v in vals
             if isinstance(v, (int, np.integer))] or [100]))
    base_md = base_params.get("max_depth", cls._sklearn_default_depth)
    depths = ({c.get("max_depth", base_md) for c in candidates}
              or {base_md})
    truncated = sorted(
        (d for d in depths
         if d is None or (isinstance(d, (int, np.integer))
                          and int(d) > MAX_COMPILED_DEPTH)),
        key=lambda d: (d is not None, d if d is not None else 0))
    if truncated:
        warnings.warn(
            f"compiled {cls.name}: max_depth values {truncated} exceed "
            f"the histogram grower's static bound — integers are capped "
            f"at {MAX_COMPILED_DEPTH} and None (sklearn: unbounded) "
            f"maps to the family default of {cls._default_depth}. The "
            f"fitted model can differ from sklearn's on deep data; "
            f"pass max_depth <= {MAX_COMPILED_DEPTH} for a faithful "
            f"compiled fit.",
            UserWarning, stacklevel=2)


def _depth(static, default):
    md = static.get("max_depth", default)
    return default if md is None else min(int(md), MAX_COMPILED_DEPTH)


def _lane_param(dynamic, static, name, default, dtype, B, device):
    """(B,) values of a hyperparameter: the chunk's dynamic values, else
    the group's static one."""
    v = dynamic.get(name, static.get(name, default))
    return torch.as_tensor(v, device=device).to(dtype).expand(B)


def _t_max(static, meta):
    return int(meta.get("max_estimators") or static.get("n_estimators", 100))


def _softmax(x, dim):
    """jax.nn.softmax's arithmetic: exp(x - max) / sum (torch's own
    softmax multiplies by a reciprocal and rounds differently)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _weighted_mean(train_w, y):
    """(B,) Σ w·y / (Σ w + 1e-12) per lane (models/trees.py:154-155).
    The sums are a one-node tree's leaf sums (T4: -Σ w·(-y) / (Σ w +
    λ)), taken in row order, so both devices start boosting from the
    same bits."""
    B, n = train_w.shape
    stats = torch.stack([train_w, train_w * -y[None, :]], dim=2)
    root = torch.where(train_w > 0, 0, -1).to(torch.int32)
    return leaf_values(root, stats.contiguous(), 1, 1e-12)[:, 0, 0]


def _codes(data):
    """The shared bin codes as the kernels take them: (n, d) uint8."""
    return data["codes"].to(torch.uint8).contiguous()


class GradientBoostingRegressorFamily(Family):
    name = "gradient_boosting_regressor"
    is_classifier = False
    dynamic_params = {"learning_rate": np.float32,
                      "n_estimators": np.int32,
                      "subsample": np.float32}
    #: max_depth=None caps at GBDT's usual 3
    _default_depth = 3
    #: sklearn's own default (GradientBoosting*: max_depth=3)
    _sklearn_default_depth = 3

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        edges, codes = _prep_codes(X, dtype)
        data = {"codes": codes, "y": np.asarray(y, dtype)}
        meta = {"n_features": int(X.shape[1]), "edges": edges,
                "max_estimators": None}
        return data, meta

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        _observe_tree_candidates(cls, candidates, base_params, meta)

    @classmethod
    def _boost(cls, dynamic, static, data, train_w, meta, F, n_out, grads):
        """The boosting loop shared by both GB families (models/trees.py:
        158-181, 236-265).  F (B, n_out, n) is updated in place: stage t
        grows, for each lane still below its count, one tree per output
        on ``grads(F_lanes) -> (g, h)`` (each (lanes, n_out, n)) and adds
        lr times its prediction.  Returns (lr, n_est, n_lim) per lane."""
        codes = _codes(data)
        B, n = train_w.shape
        dev = codes.device
        depth = _depth(static, cls._default_depth)
        t_max = _t_max(static, meta)
        lr = _lane_param(dynamic, static, "learning_rate", 0.1,
                         torch.float32, B, dev)
        n_est = _lane_param(dynamic, static, "n_estimators", 100,
                            torch.int32, B, dev)
        subsample = _lane_param(dynamic, static, "subsample", 1.0,
                                torch.float32, B, dev)
        min_leaf = float(static.get("min_samples_leaf", 1))
        keys = jr.split(jr.PRNGKey(_seed(static)), t_max)
        n_lim = torch.clamp_max(n_est, t_max)
        n_lim_host = n_lim.cpu().numpy()
        # u < subsample holds for every u in [0, 1) where subsample >= 1:
        # then no draw changes a weight, and none is made
        draw = bool((subsample < 1.0).any())
        for t in range(int(n_lim_host.max(initial=0))):
            grow = np.flatnonzero(n_lim_host > t)
            lanes = (slice(None) if len(grow) == B
                     else torch.as_tensor(grow, device=dev))
            w_t = train_w[lanes]
            if draw:
                if t % RNG_BLOCK == 0:      # the next trees' draws at once
                    u_block = jr.uniform_many(keys[t:t + RNG_BLOCK], (n,),
                                              dev)
                u = u_block[t % RNG_BLOCK]
                w_t = w_t * (u[None, :] < subsample[lanes, None]).to(
                    torch.float32)
            F_l = F[lanes]
            g, h = grads(F_l)                           # (Lb, n_out, n)
            Lb = F_l.shape[0]
            tree = grow_tree(codes, g.reshape(Lb * n_out, n, 1),
                             h.reshape(Lb * n_out, n),
                             w_t.repeat_interleave(n_out, dim=0), depth,
                             N_BINS, min_child_weight=min_leaf,
                             reg_lambda=1e-6)
            # F + lr·live·delta; every lane grown here has t < n_est
            scale = (lr[lanes] * (t < n_est[lanes]).to(torch.float32)
                     ).repeat_interleave(n_out)
            out = F_l.reshape(Lb * n_out, n, 1)
            accumulate_tree(tree, codes, depth, out, scale)
            if not isinstance(lanes, slice):
                F[lanes] = F_l
        return lr, n_est, n_lim

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """(B lanes) -> {"pred": F (B, n) on the full data, "f0", "lr",
        "n_est", "n_iter": the trees grown, min(n_est, t_max)}."""
        y = data["y"]
        B, n = train_w.shape
        F0 = _weighted_mean(train_w, y)
        F = F0[:, None, None].expand(B, 1, n).contiguous()

        def grads(F_l):          # d(0.5 (F - y)^2)/dF, hessian 1
            return F_l - y, torch.ones_like(F_l)

        lr, n_est, n_lim = cls._boost(dynamic, static, data, train_w, meta,
                                      F, 1, grads)
        return {"pred": F[:, 0, :], "f0": F0, "lr": lr, "n_est": n_est,
                "n_iter": n_lim}

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        return {"pred": models["pred"]} if "pred" in needed else {}


class GradientBoostingClassifierFamily(GradientBoostingRegressorFamily):
    name = "gradient_boosting_classifier"
    is_classifier = True

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        edges, codes = _prep_codes(X, dtype)
        classes, y_enc = encode_labels(y)
        k = len(classes)
        data = {"codes": codes, "y": y_enc,
                "y1h": np.eye(k, dtype=np.float32)[y_enc]}
        meta = {"n_features": int(X.shape[1]), "edges": edges,
                "n_classes": int(k), "classes": classes,
                "max_estimators": None}
        return data, meta

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """(B lanes) -> {"pred": argmax class (B, n), "logits" (B, n, k),
        "lr", "n_est", "n_iter"}; the k per-class trees of a stage are k
        lanes each (models/trees.py:214-267)."""
        y1h = data["y1h"]                                   # (n, k)
        B, n = train_w.shape
        k = meta["n_classes"]
        wsum = train_w.sum(dim=1, keepdim=True) + 1e-12
        prior = torch.clamp(
            (train_w[:, :, None] * y1h[None]).sum(dim=1) / wsum, 1e-6,
            1 - 1e-6)
        F = torch.log(prior)[:, :, None].expand(B, k, n).contiguous()
        y1h_t = y1h.T

        def grads(F_l):          # softmax cross-entropy, diagonal hessian
            P = _softmax(F_l, dim=1)
            return P - y1h_t, P * (1.0 - P)

        lr, n_est, n_lim = cls._boost(dynamic, static, data, train_w, meta,
                                      F, k, grads)
        logits = F.transpose(1, 2).contiguous()             # (B, n, k)
        return {"pred": torch.argmax(logits, dim=2).to(torch.int32),
                "logits": logits, "lr": lr, "n_est": n_est,
                "n_iter": n_lim}

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        views = {}
        logits = models["logits"]
        if "pred" in needed:
            views["pred"] = models["pred"]
        if "decision" in needed:
            # scorer contract: a binary decision is a 1-D margin
            views["decision"] = (logits[..., 1] - logits[..., 0]
                                 if meta["n_classes"] == 2 else logits)
        if "proba" in needed:
            views["proba"] = _softmax(logits, dim=2)
        return views


class RandomForestClassifierFamily(Family):
    name = "random_forest_classifier"
    is_classifier = True
    dynamic_params = {"n_estimators": np.int32}
    _default_depth = 10
    #: sklearn's own default (RandomForest*: max_depth=None, unbounded:
    #: the cap always applies, so a default forest search warns)
    _sklearn_default_depth = None

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        edges, codes = _prep_codes(X, dtype)
        classes, y_enc = encode_labels(y)
        k = len(classes)
        data = {"codes": codes, "y": y_enc,
                "y1h": np.eye(k, dtype=np.float32)[y_enc]}
        meta = {"n_features": int(X.shape[1]), "edges": edges,
                "n_classes": int(k), "classes": classes,
                "max_estimators": None}
        return data, meta

    @classmethod
    def observe_candidates(cls, candidates, base_params, meta):
        _observe_tree_candidates(cls, candidates, base_params, meta)

    @classmethod
    def _max_features(cls, static, d):
        mf = static.get("max_features", "sqrt")
        if mf in ("sqrt", "auto"):
            return max(1, int(np.sqrt(d)))
        if mf == "log2":
            return max(1, int(np.log2(d)))
        if mf is None:
            return d
        if isinstance(mf, float):
            return max(1, int(mf * d))
        return int(mf)

    @classmethod
    def _targets(cls, data):
        return data["y1h"]

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        """(B lanes) -> the averaged leaf values of min(n_est, t_max)
        trees a lane, finalised (models/trees.py:335-386), and "n_iter",
        the trees grown."""
        codes = _codes(data)
        targets = cls._targets(data)                        # (n, n_out)
        B, n = train_w.shape
        d = codes.shape[1]
        n_out = targets.shape[1]
        dev = codes.device
        depth = _depth(static, cls._default_depth)
        t_max = _t_max(static, meta)
        n_est = _lane_param(dynamic, static, "n_estimators", 100,
                            torch.int32, B, dev)
        bootstrap = bool(static.get("bootstrap", True))
        min_leaf = float(static.get("min_samples_leaf", 1))
        mf = cls._max_features(static, d)
        keys = jr.split(jr.PRNGKey(_seed(static)), t_max)
        n_lim = torch.clamp_max(n_est, t_max)
        n_lim_host = n_lim.cpu().numpy()
        # squared loss from F = 0: gradient -target, hessian 1, so a
        # leaf's value is its weighted mean target
        g, h = -targets, torch.ones(n, dtype=torch.float32, device=dev)
        acc = torch.zeros((B, n, n_out), dtype=torch.float32, device=dev)
        for ti in range(int(n_lim_host.max(initial=0))):
            grow = np.flatnonzero(n_lim_host > ti)
            lanes = (slice(None) if len(grow) == B
                     else torch.as_tensor(grow, device=dev))
            k_t = keys[ti]
            w_t = train_w[lanes]
            if bootstrap:
                w_t = w_t * jr.poisson_one(k_t, (n,), dev).to(
                    torch.float32)[None, :]
            tree = grow_tree(codes, g, h, w_t, depth, N_BINS,
                             min_child_weight=min_leaf, reg_lambda=1e-9,
                             feat_mask_key=jr.fold_in(k_t, 7),
                             max_features=mf, n_out=n_out)
            acc_l = acc[lanes]
            live = (ti < n_est[lanes]).to(torch.float32)
            accumulate_tree(tree, codes, depth, acc_l, live)
            if not isinstance(lanes, slice):
                acc[lanes] = acc_l
        avg = acc / torch.clamp_min(n_lim.to(torch.float32), 1.0)[:, None,
                                                                 None]
        out = cls._finalize(avg)
        out["n_iter"] = n_lim
        return out

    @classmethod
    def _finalize(cls, avg):
        return {"proba": avg,
                "pred": torch.argmax(avg, dim=2).to(torch.int32)}

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        views = {}
        if "pred" in needed:
            views["pred"] = models["pred"]
        if "proba" in needed:
            p = torch.clamp_min(models["proba"], 0.0)
            views["proba"] = p / torch.clamp_min(p.sum(dim=2, keepdim=True),
                                                 1e-12)
        if "decision" in needed:
            proba = models["proba"]
            # scorer contract: a binary decision is a 1-D margin
            views["decision"] = (proba[..., 1] - proba[..., 0]
                                 if meta.get("n_classes") == 2 else proba)
        return views


class RandomForestRegressorFamily(RandomForestClassifierFamily):
    name = "random_forest_regressor"
    is_classifier = False

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        edges, codes = _prep_codes(X, dtype)
        y = np.asarray(y, dtype)
        data = {"codes": codes, "y": y, "y_target": y.reshape(len(y), 1)}
        meta = {"n_features": int(X.shape[1]), "edges": edges,
                "max_estimators": None}
        return data, meta

    @classmethod
    def _max_features(cls, static, d):
        mf = static.get("max_features", 1.0)   # sklearn regressor default
        if isinstance(mf, float) and mf == 1.0:
            return d                            # int 1 means ONE feature
        return RandomForestClassifierFamily._max_features.__func__(
            cls, static, d)

    @classmethod
    def _targets(cls, data):
        return data["y_target"]

    @classmethod
    def _finalize(cls, avg):
        return {"pred": avg[:, :, 0]}

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        return {"pred": models["pred"]} if "pred" in needed else {}


# ---------------------------------------------------------------------------
# the port's own parameter holders: what a search resolves where sklearn
# is not installed (the card's machine); refit needs sklearn's estimator
# ---------------------------------------------------------------------------


class _TreeSpec(_Estimator):
    """sklearn's constructor defaults for the parameters the family
    reads; `fit` raises: refit the best parameters with sklearn's own
    estimator, or search with ``refit=False``."""

    def fit(self, X, y, sample_weight=None):
        raise NotImplementedError(
            f"the port has no {type(self).__name__} fit of its own: search "
            "with refit=False, or pass sklearn's estimator (refit runs it "
            "on the host)")


class GradientBoostingRegressor(_TreeSpec):
    _family = GradientBoostingRegressorFamily

    def __init__(self, learning_rate=0.1, n_estimators=100, subsample=1.0,
                 max_depth=3, min_samples_leaf=1, random_state=None,
                 device=None):
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample = subsample
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.random_state = random_state
        self.device = device


class GradientBoostingClassifier(GradientBoostingRegressor):
    _family = GradientBoostingClassifierFamily


class RandomForestClassifier(_TreeSpec):
    _family = RandomForestClassifierFamily

    def __init__(self, n_estimators=100, max_depth=None, min_samples_leaf=1,
                 max_features="sqrt", bootstrap=True, random_state=None,
                 device=None):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.random_state = random_state
        self.device = device


class RandomForestRegressor(RandomForestClassifier):
    _family = RandomForestRegressorFamily

    def __init__(self, n_estimators=100, max_depth=None, min_samples_leaf=1,
                 max_features=1.0, bootstrap=True, random_state=None,
                 device=None):
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         min_samples_leaf=min_samples_leaf,
                         max_features=max_features, bootstrap=bootstrap,
                         random_state=random_state, device=device)


for _fam, _est, _mod in (
        (GradientBoostingRegressorFamily, GradientBoostingRegressor, "_gb"),
        (GradientBoostingClassifierFamily, GradientBoostingClassifier,
         "_gb"),
        (RandomForestClassifierFamily, RandomForestClassifier, "_forest"),
        (RandomForestRegressorFamily, RandomForestRegressor, "_forest")):
    register_family(_fam, f"sklearn.ensemble.{_mod}.{_est.__name__}",
                    f"sklearn.ensemble.{_est.__name__}",
                    f"{__name__}.{_est.__name__}")
