"""MLP classifier and regressor families: lane-batched minibatch training.

Counterpart of `spark_sklearn_tpu/models/mlp.py` (:77 `MLPClassifierFamily`,
:371 `MLPRegressorFamily`).  The reference writes one fit and the search
`vmap`s it over the (candidate x fold) lanes, its epoch `while_loop`
running until every lane has stopped.  Here the lane axis is written
out: every lane's parameters are one row of a flat (B, P) buffer (layer
by layer, W then b), a minibatch is a few batched GEMMs (library
`torch.matmul`/`bmm`) between three hand-written kernels (`ops/mlp_kernels.py`:
M1 the loss and its cotangent, M2 the optimizer step, M3 the hidden
layers' bias and activation), and the backward pass is written out by
hand: dZ from M1, then dW = Hᵀ dZ, db = Σ dZ and dH = dZ Wᵀ ⊙ act′ (M3)
layer by layer down.

The reference's semantics, kept here:
- **One random state for every lane.** ``PRNGKey(random_state)`` (None
  means 0) does not depend on the lane, so every lane starts from the
  same Glorot-uniform weights, shuffles by the same permutation each
  epoch (`ops/random.py`, bit for bit jax.random's; the shuffles of 16
  epochs are drawn in one pass) and, with ``early_stopping=True``, holds
  out the same rows.  They are drawn once per chunk and broadcast.
- **Minibatches** pad the permutation with row 0 at weight 0; a lane's
  batch loss is its weighted data loss plus 0.5·alpha·Σ‖W‖², both over
  ``max(Σ w, 1)``; the epoch loss is Σ loss·wsum / max(Σ fit_w, 1).
- **Stopping.** A lane is active until it has run `max_iter` epochs or
  its rule stops it: the `tol`/`n_iter_no_change` plateau of the
  training loss, or of the held-out score with ``early_stopping=True``
  (the best weights are restored); sgd's ``invscaling`` clock counts the
  rows a lane trains on; ``adaptive`` divides the lane's rate by 5 while
  it is above 1e-6.  A lane that has stopped keeps its parameters and
  optimizer state (M2 skips it) and its epoch count; the host reads
  ``active.any()`` once an epoch.
- `alpha` and `learning_rate_init` are dynamic; solvers other than adam
  and sgd, and schedules other than constant, invscaling and adaptive,
  raise.

`fit_task_batched` takes the data's X (n, d), or per-fold transformed
inputs ``data["X_folds"]`` (F, n, d') from a Pipeline, lane t reading
fold t % F.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import (
    Family,
    encode_labels,
    register_family,
)
from spark_sklearn_tpu_torch.ops import mlp_kernels as mk
from spark_sklearn_tpu_torch.ops import random as jr

_ACTIVATIONS = ("identity", "relu", "tanh", "logistic")
#: epochs whose shuffles are drawn in one pass
RNG_BLOCK = 16


def _check_supported(static):
    solver = static.get("solver", "adam")
    if solver not in ("adam", "sgd"):
        raise ValueError(f"solver={solver!r} is not compiled")
    if static.get("learning_rate", "constant") not in (
            "constant", "invscaling", "adaptive"):
        raise ValueError(
            f"learning_rate={static.get('learning_rate')!r} is not compiled")
    if static.get("activation", "relu") not in _ACTIVATIONS:
        raise ValueError(
            f"activation={static.get('activation')!r} is not supported")


def _hidden(static):
    hidden = static.get("hidden_layer_sizes", (100,))
    if isinstance(hidden, (int, np.integer)):
        hidden = (hidden,)
    return tuple(int(h) for h in hidden)


def param_layout(sizes):
    """[(W offset, b offset, fan_in, fan_out)] of each layer in the flat
    parameter row, and its length P."""
    out, off = [], 0
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        out.append((off, off + fi * fo, fi, fo))
        off += fi * fo + fo
    return out, off


def sizes_from_params(P: int, hidden, out_dim: int):
    """The layer sizes (d, *hidden, out_dim) of a flat row of P params."""
    rest = param_layout((*hidden, out_dim))[1] if hidden else 0
    first = hidden[0] if hidden else out_dim
    d, r = divmod(P - rest - first, first)
    if r or d < 1:
        raise ValueError(f"{P} parameters do not fit hidden {hidden} and "
                         f"{out_dim} outputs")
    return (d, *hidden, out_dim)


def layers(params, sizes):
    """[(W (..., fi, fo), b (..., fo))] views of flat params (..., P)."""
    return [(params[..., ow:ob].unflatten(-1, (fi, fo)),
             params[..., ob:ob + fo])
            for ow, ob, fi, fo in param_layout(sizes)[0]]


def init_params(key, sizes, device=None):
    """The reference's `_init_params` (Glorot-uniform, `mlp.py:45-57`),
    bit for bit, as one flat float32 row (P,)."""
    keys = jr.split(key, len(sizes) - 1)
    parts = []
    for k, (fi, fo) in zip(keys, zip(sizes[:-1], sizes[1:])):
        bound = np.sqrt(np.float32(6.0 / (fi + fo)), dtype=np.float32)
        kw, kb = jr.split(k)
        for kk, m in ((kw, fi * fo), (kb, fo)):
            parts.append(jr.uniform(kk, (m,), device, -bound, bound))
    return torch.cat(parts)


def weight_mask(sizes, device=None):
    """(P,) bool: True on the weights, False on the biases."""
    lay, P = param_layout(sizes)
    mask = torch.zeros(P, dtype=torch.bool, device=device)
    for ow, ob, _, _ in lay:
        mask[ow:ob] = True
    return mask


def forward(params, X, sizes, act, kept=None):
    """Logits of every lane: params (B, P), X (n, d) shared or (B, n, d)
    per lane -> (B, n, out); each hidden layer's bias and activation by
    M3.  A list `kept` gets the input of every layer (the backward pass
    reads them)."""
    h = X
    lay = layers(params, sizes)
    for W, b in lay[:-1]:
        if kept is not None:
            kept.append(h)
        h = mk.mlp_act_forward(torch.matmul(h, W), b, act)
    W, b = lay[-1]
    if kept is not None:
        kept.append(h)
    return torch.matmul(h, W) + b[:, None, :]


def _lanes(X_folds, B):
    """(B, ...) per-lane rows of per-fold inputs (F, ...): lane t reads
    fold t % F."""
    F = X_folds.shape[0]
    if B % F:
        raise ValueError(f"{B} lanes are not a whole number of {F} folds")
    return X_folds.unsqueeze(0).expand(B // F, *X_folds.shape).reshape(
        B, *X_folds.shape[1:])


def _dyn(dynamic, static, name, default, B, device, dtype):
    v = dynamic.get(name, static.get(name, default))
    return torch.as_tensor(v, device=device).to(dtype).expand(B).contiguous()


class MLPClassifierFamily(Family):
    name = "mlp_classifier"
    is_classifier = True
    dynamic_params = {"alpha": np.float32,
                      "learning_rate_init": np.float32}
    #: sklearn's MLP keeps the user's X dtype all the way to its
    #: probabilities, so log_loss clips at that dtype's eps
    proba_dtype_rule = "input"
    #: a Pipeline hands it per-fold transformed inputs, data["X_folds"]
    accepts_fold_inputs = True

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        classes, y_enc = encode_labels(y)
        data = {"X": np.ascontiguousarray(X, dtype=np.float32), "y": y_enc}
        meta = {"n_classes": int(len(classes)), "classes": classes,
                "n_features": int(X.shape[1])}
        return data, meta

    @classmethod
    def _out_dim(cls, meta):
        return meta["n_classes"]

    @classmethod
    def _targets(cls, data):
        """(labels (n,) int32, None) or (None, targets (n, t))."""
        return data["y"], None

    @classmethod
    def _val_score(cls, Z, data, val_w):
        wsum = torch.clamp_min(val_w.sum(dim=1), 1e-12)
        pred = Z.argmax(dim=2)
        hit = (pred == data["y"].long()[None, :]).to(val_w.dtype)
        return (val_w * hit).sum(dim=1) / wsum

    @classmethod
    def fit_task_batched(cls, dynamic, static, data, train_w, meta):
        _check_supported(static)
        X = data["X"]
        X_folds = data.get("X_folds")
        n = X.shape[0]
        B = train_w.shape[0]
        dev, dt = X.device, torch.float32
        d = X_folds.shape[2] if X_folds is not None else X.shape[1]
        sizes = (d, *_hidden(static), cls._out_dim(meta))
        act = static.get("activation", "relu")
        adam = static.get("solver", "adam") == "adam"
        schedule = static.get("learning_rate", "constant")
        alpha = _dyn(dynamic, static, "alpha", 1e-4, B, dev, dt)
        lr = _dyn(dynamic, static, "learning_rate_init", 1e-3, B, dev, dt)
        max_iter = int(static.get("max_iter", 200))
        batch_size = static.get("batch_size", "auto")
        bs = min(200, n) if batch_size == "auto" else int(
            min(batch_size, n))
        n_batches = -(-n // bs)
        n_pad = n_batches * bs
        seed = static.get("random_state")
        key = jr.PRNGKey(0 if seed is None else int(seed))
        hyper = {"beta_1": float(static.get("beta_1", 0.9)),
                 "beta_2": float(static.get("beta_2", 0.999)),
                 "epsilon": float(static.get("epsilon", 1e-8)),
                 "momentum": float(static.get("momentum", 0.9))}
        tol = float(static.get("tol", 1e-4))
        n_iter_no_change = int(static.get("n_iter_no_change", 10))
        early = bool(static.get("early_stopping", False))
        power_t = float(static.get("power_t", 0.5))
        val_frac = float(static.get("validation_fraction", 0.1))

        key, init_key = jr.split(key)
        p = init_params(init_key, sizes, dev).expand(B, -1).contiguous()
        P = p.shape[1]
        wmask = weight_mask(sizes, dev)
        train_w = train_w.to(dt)
        if early:
            key, vkey = jr.split(key)
            val_sel = (jr.uniform(vkey, (n,), dev) < val_frac).to(dt)
            fit_w = train_w * (1.0 - val_sel)
            val_w = train_w * val_sel
        else:
            fit_w, val_w = train_w, None
        n_fit_rows = (fit_w > 0).to(dt).sum(dim=1)
        wtot = torch.clamp_min(fit_w.sum(dim=1), 1.0)
        y_lab, y_tgt = cls._targets(data)

        m = torch.zeros_like(p)
        v = torch.zeros_like(p) if adam else None
        t = torch.zeros(B, dtype=dt, device=dev) if adam else None
        big = float(np.finfo(np.float32).max)
        it = torch.zeros(B, dtype=torch.int32, device=dev)
        stop = torch.zeros(B, dtype=torch.bool, device=dev)
        best_score = torch.full((B,), -big, dtype=dt, device=dev)
        best_loss = torch.full((B,), big, dtype=dt, device=dev)
        no_improve = torch.zeros(B, dtype=torch.int32, device=dev)
        lr_div = torch.ones(B, dtype=dt, device=dev)
        best_p = p.clone() if early else None
        X_val = (_lanes(X_folds, B) if X_folds is not None else X) \
            if early else None
        pad = torch.zeros(n_pad - n, dtype=torch.int64, device=dev)
        wmul = torch.cat([torch.ones(n, dtype=dt, device=dev),
                          torch.zeros(n_pad - n, dtype=dt, device=dev)])

        for epoch in range(max_iter):
            active = (it < max_iter) & ~stop
            if not bool(active.any()):         # one host read an epoch
                break
            if epoch % RNG_BLOCK == 0:         # the next epochs' shuffles
                eks = []
                for _ in range(min(RNG_BLOCK, max_iter - epoch)):
                    key, ek = jr.split(key)
                    eks.append(ek)
                perms = jr.permutations(np.stack(eks), n, dev)
            idx = torch.cat([perms[epoch % RNG_BLOCK], pad])
            w_ep = fit_w[:, idx] * wmul                       # (B, n_pad)
            X_ep = X_folds[:, idx] if X_folds is not None else X[idx]
            y_ep = y_lab[idx] if y_lab is not None else None
            t_ep = y_tgt[idx] if y_tgt is not None else None
            base = lr
            if not adam and schedule == "invscaling":
                # sklearn rescales after each epoch from the rows seen
                base = lr / (it.to(dt) * n_fit_rows + 1.0) ** power_t
            lr_eff = base / lr_div
            acc = torch.zeros(B, dtype=dt, device=dev)
            for j in range(n_batches):
                s, e = j * bs, (j + 1) * bs
                Xb = (_lanes(X_ep[:, s:e], B) if X_folds is not None
                      else X_ep[s:e])
                loss, wsum, g = cls._batch_grad(
                    p, Xb, w_ep[:, s:e].contiguous(),
                    None if y_ep is None else y_ep[s:e],
                    None if t_ep is None else t_ep[s:e], sizes, act)
                mk.mlp_opt_step(p, g, m, v, t, wmask, alpha, wsum, lr_eff,
                                active, loss, acc, adam=adam, **hyper)
            loss = acc / wtot
            if early:
                score = cls._val_score(forward(p, X_val, sizes, act), data,
                                       val_w)
                improved = score >= best_score + tol
                is_best = (score > best_score) & active
                best_score = torch.where(is_best, score, best_score)
                best_p = torch.where(is_best[:, None], p, best_p)
            else:
                improved = loss <= best_loss - tol
                best_loss = torch.where(
                    active, torch.minimum(loss, best_loss), best_loss)
            ni = torch.where(improved, torch.zeros_like(no_improve),
                             no_improve + 1)
            trigger = ni > n_iter_no_change
            if not adam and schedule == "adaptive":
                # while the current rate is above 1e-6, divide it by 5 and
                # go on; stop once it has decayed to 1e-6 or below
                can_decay = lr_eff > 1e-6
                lr_div = torch.where(active & trigger & can_decay,
                                     lr_div * 5.0, lr_div)
                st = trigger & ~can_decay
                ni = torch.where(trigger, torch.zeros_like(ni), ni)
            else:
                st = trigger
            no_improve = torch.where(active, ni, no_improve)
            stop = torch.where(active, st, stop)
            it = it + active.to(torch.int32)
        return {"params": best_p if early else p, "n_iter": it}

    @classmethod
    def _batch_grad(cls, p, Xb, w, y, Yt, sizes, act):
        """One minibatch's forward and hand-written backward over every
        lane: (loss sums (B,), wsum (B,), flat gradient (B, P) of the
        mean data loss; M2 adds the L2 term)."""
        hs = []
        Z = forward(p, Xb, sizes, act, hs)
        # M1 also returns the output layer's bias gradient, dz summed over
        # the rows
        loss, wsum, dz, db = mk.mlp_loss_grad(Z, w, y=y, Yt=Yt)
        grads = []
        for i, (W, _) in reversed(list(enumerate(layers(p, sizes)))):
            h = hs[i]
            grads.append(db if i == len(hs) - 1 else dz.sum(dim=1))
            grads.append(torch.matmul(h.transpose(-1, -2), dz).flatten(1))
            if i:
                dz = mk.mlp_act_backward(torch.bmm(dz, W.transpose(1, 2)),
                                         h, act)
        return loss, wsum, torch.cat(grads[::-1], dim=1)

    # -- prediction --------------------------------------------------------

    @classmethod
    def _sizes(cls, params, static, meta):
        return sizes_from_params(params.shape[-1], _hidden(static),
                                 cls._out_dim(meta))

    @classmethod
    def _logits(cls, model, static, X, meta):
        """(n, out) for one model's params (P,), (B, n, out) for (B, P)."""
        params = model["params"]
        one = params.dim() == 1
        sizes = cls._sizes(params, static, meta)
        Z = forward(params[None] if one else params, X, sizes,
                    static.get("activation", "relu"))
        return Z[0] if one else Z

    @classmethod
    def _lane_X(cls, data, B):
        X_folds = data.get("X_folds")
        return _lanes(X_folds, B) if X_folds is not None else data["X"]

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        """"pred" (B, n), "decision" (B, n) for two classes or (B, n, k),
        "proba" (B, n, k), over each lane's X."""
        B = models["params"].shape[0]
        Z = cls._logits(models, static, cls._lane_X(data, B), meta)
        views = {}
        if "pred" in needed:
            views["pred"] = Z.argmax(dim=-1)
        if "decision" in needed:
            # binary: the one margin Z1 - Z0, as the scorers take it
            views["decision"] = (Z[..., 1] - Z[..., 0]
                                 if meta["n_classes"] == 2 else Z)
        if "proba" in needed:
            views["proba"] = torch.softmax(Z, dim=-1)
        return views

    @classmethod
    def predict(cls, model, static, X, meta):
        return cls._logits(model, static, X, meta).argmax(dim=-1)

    @classmethod
    def predict_proba(cls, model, static, X, meta):
        return torch.softmax(cls._logits(model, static, X, meta), dim=-1)

    @classmethod
    def sklearn_attrs(cls, model, static, meta) -> Dict[str, Any]:
        params = model["params"]
        lay = layers(params, cls._sizes(params, static, meta))
        attrs = {
            "coefs_": [W.cpu().numpy() for W, _ in lay],
            "intercepts_": [b.cpu().numpy() for _, b in lay],
            "classes_": meta.get("classes"),
            "n_features_in_": meta["n_features"],
            "n_layers_": len(lay) + 1,
        }
        if "n_iter" in model:
            attrs["n_iter_"] = int(model["n_iter"])
        return attrs


class MLPRegressorFamily(MLPClassifierFamily):
    name = "mlp_regressor"
    is_classifier = False

    @classmethod
    def prepare_data(cls, X, y, dtype=np.float32):
        y = np.asarray(y, dtype=np.float32)
        data = {"X": np.ascontiguousarray(X, dtype=np.float32), "y": y,
                "y_target": np.ascontiguousarray(y.reshape(len(y), -1))}
        meta = {"n_features": int(X.shape[1]),
                "n_targets": int(data["y_target"].shape[1])}
        return data, meta

    @classmethod
    def _out_dim(cls, meta):
        return meta["n_targets"]

    @classmethod
    def _targets(cls, data):
        return None, data["y_target"]

    @classmethod
    def _val_score(cls, Z, data, val_w):
        yt = data["y_target"]
        wsum = torch.clamp_min(val_w.sum(dim=1), 1e-12)
        err = ((Z - yt[None]) ** 2).sum(dim=2)
        resid = (val_w * err).sum(dim=1) / wsum
        ym = (val_w @ yt) / wsum[:, None]
        tot = (val_w * ((yt[None] - ym[:, None, :]) ** 2).sum(dim=2)).sum(
            dim=1) / wsum
        return 1.0 - resid / torch.clamp_min(tot, 1e-12)

    @classmethod
    def views_task_batched(cls, models, static, data, meta, needed):
        if "pred" not in needed:
            return {}
        B = models["params"].shape[0]
        Z = cls._logits(models, static, cls._lane_X(data, B), meta)
        return {"pred": Z[..., 0] if meta["n_targets"] == 1 else Z}

    @classmethod
    def predict(cls, model, static, X, meta):
        out = cls._logits(model, static, X, meta)
        return out[..., 0] if meta["n_targets"] == 1 else out

    @classmethod
    def sklearn_attrs(cls, model, static, meta):
        attrs = MLPClassifierFamily.sklearn_attrs.__func__(
            cls, model, static, meta)
        attrs.pop("classes_", None)
        return attrs


register_family(
    MLPClassifierFamily,
    "sklearn.neural_network._multilayer_perceptron.MLPClassifier",
    "sklearn.neural_network.MLPClassifier",
    "spark_sklearn_tpu_torch.models.estimators.MLPClassifier",
)
register_family(
    MLPRegressorFamily,
    "sklearn.neural_network._multilayer_perceptron.MLPRegressor",
    "sklearn.neural_network.MLPRegressor",
    "spark_sklearn_tpu_torch.models.estimators.MLPRegressor",
)
