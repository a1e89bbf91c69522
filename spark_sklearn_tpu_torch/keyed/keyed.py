"""KeyedEstimator / KeyedModel: one model per key of a table, fitted as
fleets on the device.

Counterpart of `spark_sklearn_tpu/keyed/keyed.py` (:1-530), the
reference's `KeyedEstimator(sklearnEstimator=, keyCols=, xCol=, yCol=,
outputCol=, estimatorType=)` with `estimatorType` in {"predictor",
"transformer", "clusterer"}.

- The table is a pandas DataFrame or a dict of equal-length columns
  (`Columns`: the card's machine has no pandas); the outputs take the
  input's form.  Rows group by the key columns (`group_rows`: sorted
  keys, tuple keys, rows with a null key left out of fit), as the
  reference's ``groupby(keyCols, sort=True)``.
- A fleet fits its keys by buckets (`run_bucketed`): each key's rows
  zero-padded to the next power of two (`bucket_len`), with 0/1 row
  weights, and every key of a bucket fitted by one call of its family's
  `fit_fleet` on (G, L, d) stacks on the device, never a launch a key:
  LogisticRegression (l2 or none) by `ops/solvers.lbfgs_lanes` through
  K2ℓ/K4ℓ, Ridge and LinearRegression by their normal equations, KMeans
  through C1ℓ, and the preprocessing steps by their weighted statistics.
- Keys with fewer rows than the family needs (`min_group_size`), and
  classifier keys that lack one of the global classes, are fitted one by
  one by a clone of the given estimator (`clone`: the port's own
  get_params/set_params), so the model's `backend` is ``"hybrid"``; so is
  every key of a family the reference fits per key (no fleet form: the
  kernel SVMs, CategoricalNB, KNN, the tree families), ``"host"``.  A
  family the reference fits as a fleet but this port does not yet
  (`FLEET_TODO`) raises NotImplementedError; a fleet that fails raises.
- `KeyedModel.transform` predicts every fleet key of a bucket in one
  call (`_fleet_predict_all`) and reassembles by position: rows whose
  key is null or was never fitted get NaN (None for a transformer).

Every entry point runs on ``cuda`` unless `config=TorchConfig(device=
"cpu")` asks for the CPU.
"""

from __future__ import annotations

import numbers
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_sklearn_tpu_torch.models.base import resolve_family
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device

#: families the reference fits key by key (no per-task fit, or a fit
#: that needs more than the stacked X): every key goes to a host fit
HOST_FAMILIES = frozenset({
    "svc", "nu_svc", "svr", "nu_svr", "categorical_nb",
    "kneighbors_classifier", "kneighbors_regressor",
    "gradient_boosting_regressor", "gradient_boosting_classifier",
    "random_forest_classifier", "random_forest_regressor"})
#: the ROADMAP item that lists the fleets still to port
FLEET_TODO = "ROADMAP.md Queue 1, item 5 (keyed fleets still to port)"


# ---------------------------------------------------------------------------
# the table: a pandas DataFrame or a dict of equal-length columns
# ---------------------------------------------------------------------------

def is_pandas(df) -> bool:
    return type(df).__module__.split(".")[0] == "pandas"


class Columns:
    """Read access to a table's columns, the same for a pandas DataFrame
    and for a dict of equal-length columns (lists or numpy arrays)."""

    def __init__(self, df):
        if is_pandas(df) and hasattr(df, "columns"):
            self.pandas = True
            self.names = list(df.columns)
            self.n = len(df)
            self._df = df
        elif isinstance(df, Mapping):
            self.pandas = False
            self.names = list(df.keys())
            lengths = {len(v) for v in df.values()}
            if len(lengths) > 1:
                raise ValueError(
                    f"columns have different lengths: {sorted(lengths)}")
            self.n = lengths.pop() if lengths else 0
            self._df = df
        else:
            raise TypeError(
                "expected a pandas DataFrame or a dict of equal-length "
                f"columns, got {type(df).__name__}")

    def __contains__(self, name) -> bool:
        return name in self.names

    def column(self, name) -> np.ndarray:
        """The column as a numpy array: 1-D, or 2-D where a dict column
        is a 2-D array (one vector a row)."""
        if self.pandas:
            return self._df[name].to_numpy()
        v = self._df[name]
        if isinstance(v, np.ndarray):
            return v
        if len(v) and not _is_scalar(v[0]):
            out = np.empty(len(v), dtype=object)
            for i, e in enumerate(v):
                out[i] = e
            return out
        return np.asarray(v)

    def missing(self, names) -> List[str]:
        return [c for c in names if c not in self]


def _is_scalar(v) -> bool:
    return v is None or np.isscalar(v) or (
        hasattr(v, "shape") and np.asarray(v).ndim == 0)


def stack_x(col: np.ndarray) -> np.ndarray:
    """A column of vectors or scalars -> 2-D float64 (the reference's
    `_stack_x`)."""
    if col.ndim == 2:
        return np.asarray(col, dtype=np.float64)
    if len(col) == 0:
        return np.zeros((0, 0), np.float64)
    if _is_scalar(col[0]):
        return np.asarray(col, dtype=np.float64)[:, None]
    return np.stack([np.asarray(v, dtype=np.float64) for v in col])


def _null(col: np.ndarray) -> np.ndarray:
    """Rows whose key is null (None or NaN), as pandas' isna."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, numbers.Real)
                                       and v != v) for v in col], bool)
    return np.zeros(len(col), bool)


def group_rows(key_cols: Sequence[np.ndarray]):
    """(keys, rows, null): the distinct key tuples in sorted order, each
    with its row positions in table order, and the mask of rows with a
    null key (in no group), as pandas' ``groupby(keys, sort=True)``."""
    n = len(key_cols[0])
    null = np.zeros(n, bool)
    for c in key_cols:
        null |= _null(c)
    keep = np.flatnonzero(~null)
    if not len(keep):
        return [], [], null
    codes, uniques = [], []
    for c in key_cols:
        u, inv = np.unique(c[keep], return_inverse=True)
        codes.append(inv.reshape(-1))
        uniques.append(u)
    order = np.lexsort(codes[::-1])                     # stable
    sc = np.stack([c[order] for c in codes])            # (m, kept)
    starts = np.flatnonzero(np.concatenate(
        [[True], (sc[:, 1:] != sc[:, :-1]).any(axis=0)]))
    ends = np.append(starts[1:], len(order))
    keys = [tuple(u[sc[j, s]] for j, u in enumerate(uniques))
            for s in starts]
    rows = [keep[order[s:e]] for s, e in zip(starts, ends)]
    return keys, rows, null


# ---------------------------------------------------------------------------
# the bucketed launcher, shared by the fleets and gapply
# ---------------------------------------------------------------------------

def bucket_len(m: int, floor: int = 8) -> int:
    """Pad length for a group of m rows: the next power of two (>= floor),
    so padding wastes at most half a bucket (the reference's)."""
    L = floor
    while L < m:
        L *= 2
    return L


def buckets_of(sizes) -> Dict[int, List[int]]:
    """bucket length -> the indices of the groups it holds, ascending."""
    out: Dict[int, List[int]] = {}
    for i, m in enumerate(sizes):
        out.setdefault(bucket_len(int(m)), []).append(i)
    return dict(sorted(out.items()))


def pad_bucket(X, rows, idxs, L, y=None):
    """The groups `idxs` of a bucket as zero-padded stacks on X's device:
    (X (G, L, d), y (G, L) or None, w (G, L) 0/1 row weights).  X (n, d)
    and y (n,) are tensors; rows[i] are group i's row positions."""
    dev = X.device
    src = np.concatenate([rows[i] for i in idxs]).astype(np.int64)
    dst = np.concatenate([j * L + np.arange(len(rows[i]))
                          for j, i in enumerate(idxs)]).astype(np.int64)
    src_t = torch.as_tensor(src, device=dev)
    dst_t = torch.as_tensor(dst, device=dev)
    G = len(idxs)
    Xs = torch.zeros((G * L, X.shape[1]), dtype=X.dtype, device=dev)
    Xs[dst_t] = X[src_t]
    ws = torch.zeros(G * L, dtype=X.dtype, device=dev)
    ws[dst_t] = 1.0
    ys = None
    if y is not None:
        ys = torch.zeros(G * L, dtype=y.dtype, device=dev)
        ys[dst_t] = y[src_t]
        ys = ys.view(G, L)
    return Xs.view(G, L, -1), ys, ws.view(G, L)


def _concat(parts):
    if isinstance(parts[0], Mapping):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


def run_bucketed(rows, X, fit_bucket, y=None):
    """The bucketed fleet launcher (the reference's `run_bucketed`,
    `keyed.py:55-104`): group i's rows `rows[i]` of X (n, d) (and of y
    (n,), if given) zero-padded to its bucket's length with 0/1 weights,
    and one call of ``fit_bucket(X (G, L, d)[, y (G, L)], w (G, L))`` a
    bucket.  The results (tensors, or dicts of tensors, with a leading
    group axis) are concatenated over the buckets.  Returns (order,
    stacked, buckets): order[j] = the group of stacked row j; buckets
    [(L, groups)] in launch order."""
    order, stacked, buckets = [], [], []
    for L, idxs in buckets_of(len(r) for r in rows).items():
        Xs, ys, ws = pad_bucket(X, rows, idxs, L, y)
        out = fit_bucket(Xs, ws) if y is None else fit_bucket(Xs, ys, ws)
        stacked.append(out)
        order.extend(idxs)
        buckets.append((L, len(idxs)))
    return order, _concat(stacked), buckets


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

def clone(estimator, device=None):
    """An unfitted copy with the same parameters, by get_params/set_params
    (estimator parameters cloned in turn, as a Pipeline's steps); a port
    estimator whose `device` is None gets `device`."""
    def copy(v):
        if hasattr(v, "get_params") and not isinstance(v, type):
            return clone(v, device)
        if isinstance(v, (list, tuple)):
            return type(v)(copy(e) for e in v)
        return v

    params = estimator.get_params(deep=False)
    new = type(estimator)(**{k: copy(v) for k, v in params.items()})
    if device is not None and "device" in params and \
            params["device"] is None:
        new.set_params(device=str(device))
    return new


def _fleet_family(estimator):
    """(family, fleet-able): the family of `estimator` and whether this
    port fits it as a fleet; None where every key is host-fitted.  Raises
    NotImplementedError for a family the reference fits as a fleet and
    this port does not yet."""
    family = resolve_family(estimator)
    if family is None:
        return None
    final = getattr(family, "final", None)
    if final is not None:                 # a Pipeline's family
        if final.name in HOST_FAMILIES or \
                getattr(final, "binned_codes", False):
            return None
        raise NotImplementedError(
            f"keyed fleets of a Pipeline ({family.name}) are not ported; "
            f"see {FLEET_TODO}")
    if family.name in HOST_FAMILIES:
        return None
    if not hasattr(family, "fit_fleet"):
        raise NotImplementedError(
            f"keyed fleets of {family.name} are not ported; see "
            f"{FLEET_TODO}")
    return family


class KeyedEstimator:
    """Fits one estimator per distinct key of a table.

    >>> ke = KeyedEstimator(sklearnEstimator=LinearRegression(),
    ...                     keyCols=["user"], xCol="x", yCol="y")
    >>> model = ke.fit(df)     # a DataFrame or a dict of columns
    >>> model.transform(df2)   # adds outputCol, each row's key's output
    """

    _TYPES = ("predictor", "transformer", "clusterer")

    def __init__(self, sklearnEstimator=None,
                 keyCols: Sequence[str] = ("key",),
                 xCol: str = "features", yCol: Optional[str] = None,
                 outputCol: str = "output",
                 estimatorType: Optional[str] = None,
                 config: Optional[TorchConfig] = None):
        self.outputCol = outputCol
        if sklearnEstimator is None:
            raise ValueError("sklearnEstimator must be provided")
        if not hasattr(sklearnEstimator, "fit"):
            raise ValueError("sklearnEstimator must implement fit()")
        if yCol is not None and not hasattr(sklearnEstimator, "predict"):
            raise ValueError(
                "supervised (yCol given) requires a predictor estimator")
        self.sklearnEstimator = sklearnEstimator
        self.keyCols = list(keyCols)
        self.xCol = xCol
        self.yCol = yCol
        if estimatorType is None:
            estimatorType = "predictor" if yCol is not None else (
                "clusterer" if hasattr(sklearnEstimator, "predict")
                and not hasattr(sklearnEstimator, "transform")
                else "transformer")
        if estimatorType not in self._TYPES:
            raise ValueError(
                f"estimatorType must be one of {self._TYPES}, "
                f"got {estimatorType!r}")
        if yCol is not None and estimatorType != "predictor":
            raise ValueError(
                "estimatorType must be 'predictor' when yCol is given")
        needed = ("transform" if estimatorType == "transformer"
                  else "predict")
        if not hasattr(sklearnEstimator, needed):
            raise ValueError(
                f"estimatorType={estimatorType!r} requires an estimator "
                f"with a {needed}() method; "
                f"{type(sklearnEstimator).__name__} has none")
        self.estimatorType = estimatorType
        self.config = config

    def fit(self, df) -> "KeyedModel":
        cols = Columns(df)
        need = self.keyCols + [self.xCol] + (
            [self.yCol] if self.yCol is not None else [])
        missing = cols.missing(need)
        if missing:
            raise KeyError(f"DataFrame is missing columns: {missing}")
        dev = resolve_device(self.config)
        if cols.n:
            keys, rows, _ = group_rows([cols.column(c)
                                        for c in self.keyCols])
        else:
            keys, rows = [], []
        if self.estimatorType == "transformer":
            fleet, host = self._fit_transformer_fleet(cols, keys, rows, dev)
        else:
            fleet, host = self._fit_family_fleet(cols, keys, rows, dev)
        models: Optional[Dict[tuple, Any]] = None
        if host:
            models = {}
            xcol = cols.column(self.xCol)
            ycol = cols.column(self.yCol) if self.yCol is not None else None
            for key, pos in host:
                est = clone(self.sklearnEstimator, dev)
                if ycol is not None:
                    est.fit(stack_x(xcol[pos]), np.asarray(ycol[pos]))
                else:
                    est.fit(stack_x(xcol[pos]))
                models[key] = est
        return KeyedModel(
            keyCols=self.keyCols, xCol=self.xCol, yCol=self.yCol,
            outputCol=self.outputCol, estimatorType=self.estimatorType,
            models=models, fleet=fleet, pandas=cols.pandas, device=dev)

    def _fit_family_fleet(self, cols, keys, rows, dev):
        """The per-key fleet of a family: (fleet | None, host pairs)."""
        pairs = list(zip(keys, rows))
        if not pairs:
            return None, pairs
        family = _fleet_family(self.sklearnEstimator)
        if family is None:
            return None, pairs
        X_all = stack_x(cols.column(self.xCol)).astype(np.float32)
        unsupervised = self.yCol is None
        y_all = None if unsupervised else np.asarray(
            cols.column(self.yCol))
        data, meta = family.prepare_data(X_all, y_all)
        static = family.extract_params(self.sklearnEstimator)
        min_needed = (family.min_group_size(static)
                      if hasattr(family, "min_group_size") else 1)
        enc = None if unsupervised else np.asarray(data["y"])
        eligible, host = [], []
        for key, pos in pairs:
            if len(pos) < min_needed:
                host.append((key, pos))
            elif not unsupervised and family.is_classifier and \
                    len(np.unique(enc[pos])) < meta["n_classes"]:
                # per-key classes_: a key missing a global class is
                # fitted over its own labels, by a host fit
                host.append((key, pos))
            else:
                eligible.append((key, pos))
        if not eligible:
            return None, host
        X = torch.as_tensor(np.asarray(data["X"], np.float32), device=dev)
        y = None if enc is None else torch.as_tensor(
            enc.astype(np.int32 if family.is_classifier else np.float32),
            device=dev)

        def fit_bucket(Xs, *rest):
            ys, ws = rest if len(rest) == 2 else (None, rest[0])
            return family.fit_fleet(static, Xs, ys, ws, meta)

        order, models, buckets = run_bucketed(
            [pos for _, pos in eligible], X, fit_bucket, y)
        return dict(
            kind="family", family=family, models=models, meta=meta,
            static=static, buckets=buckets,
            key_index={eligible[i][0]: j for j, i in enumerate(order)}), \
            host

    def _fit_transformer_fleet(self, cols, keys, rows, dev):
        """Transformer fleets: the step's weighted statistics per key."""
        from spark_sklearn_tpu_torch.models.preprocessing import (
            resolve_step,
        )

        pairs = list(zip(keys, rows))
        if not pairs:
            return None, pairs
        step = resolve_step(self.sklearnEstimator)
        if step is None:
            return None, pairs
        static = dict(self.sklearnEstimator.get_params(deep=False))
        X_all = stack_x(cols.column(self.xCol)).astype(np.float32)
        if hasattr(step, "check_static"):
            try:
                step.check_static(static, X_all.shape[1])
            except ValueError:
                # settings the fleet does not serve (PCA with no integer
                # n_components, another solver): per-key fits, where the
                # estimator raises its own error if the setting is invalid
                return None, pairs
        min_needed = (step.min_group_size(static)
                      if hasattr(step, "min_group_size") else 1)
        eligible, host = [], []
        for key, pos in pairs:
            (eligible if len(pos) >= min_needed else host).append(
                (key, pos))
        if not eligible:
            return None, host
        X = torch.as_tensor(X_all, device=dev)
        order, states, buckets = run_bucketed(
            [pos for _, pos in eligible], X,
            lambda Xs, ws: step.fit(static, Xs, ws))
        return dict(
            kind="step", step=step, models=states, meta={}, static=static,
            buckets=buckets,
            key_index={eligible[i][0]: j for j, i in enumerate(order)}), \
            host


class TorchTransformer:
    """A fitted transformer step of one key (the transformer-type
    counterpart of `convert/converter.TorchModel`), as
    `KeyedModel.keyedModels` returns it: `state` keeps a leading axis of
    1, as the port's steps apply it."""

    def __init__(self, step, state, static):
        self.step = step
        self.state = state
        self.static = static

    def transform(self, X):
        dev = next(iter(self.state.values())).device
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=dev)
        return self.step.apply(self.static, self.state, X)[0].cpu().numpy()

    def __repr__(self):
        return f"TorchTransformer(step={self.step.name})"


def _as_column(values: np.ndarray) -> np.ndarray:
    """An output column of a dict table, typed as pandas infers a Series
    of these values: numbers -> int64 or float64, else object."""
    if all(isinstance(v, (numbers.Number, np.number)) and
           not isinstance(v, (bool, np.bool_)) for v in values):
        return np.array(values.tolist())
    return values


class KeyedModel:
    """The fitted fleet.  `keyedModels` lists one estimator a key (a
    `TorchModel` or `TorchTransformer` view of a fleet key, or the
    host-fitted estimator)."""

    def __init__(self, keyCols, xCol, yCol, outputCol, estimatorType,
                 models: Optional[Dict[tuple, Any]], fleet=None,
                 pandas: bool = True, device=None):
        self.keyCols = list(keyCols)
        self.xCol = xCol
        self.yCol = yCol
        self.outputCol = outputCol
        self.estimatorType = estimatorType
        self.models = models            # host-fitted keys: {key: estimator}
        self.fleet = fleet              # the fleet: stacked tensors
        self.pandas = pandas
        self.device = device

    @property
    def backend(self) -> str:
        """"device" (every key in the fleet), "host" (every key fitted by
        itself) or "hybrid" (both)."""
        if self.fleet is not None and self.models:
            return "hybrid"
        return "device" if self.fleet is not None else "host"

    def _views(self):
        """(key, estimator) of every key: the fleet's, then the host's."""
        out = []
        if self.fleet is not None:
            from spark_sklearn_tpu_torch.convert.converter import TorchModel
            fleet = self.fleet
            for key, i in fleet["key_index"].items():
                if fleet["kind"] == "step":
                    view: Any = TorchTransformer(
                        fleet["step"],
                        {k: v[i:i + 1] for k, v in fleet["models"].items()},
                        fleet["static"])
                else:
                    view = TorchModel(
                        fleet["family"],
                        {k: v[i] for k, v in fleet["models"].items()},
                        fleet["static"], fleet["meta"])
                out.append((key, view))
        if self.models:
            out.extend(self.models.items())
        return out

    @property
    def keyedModels(self):
        """One row a key with an `estimator` cell that predicts or
        transforms: a pandas DataFrame where fit took one, else a dict of
        columns."""
        views = self._views()
        if self.pandas:
            import pandas as pd
            return pd.DataFrame([dict(zip(self.keyCols, key), estimator=est)
                                 for key, est in views])
        out = {c: [key[i] for key, _ in views]
               for i, c in enumerate(self.keyCols)}
        out["estimator"] = [est for _, est in views]
        return out

    def transform(self, df):
        """Each row's output from its key's model: predictor -> predict
        (float, or the class label), clusterer -> predict (int),
        transformer -> transform (a vector).  Rows whose key is null or
        was never fitted get NaN (None for a transformer)."""
        cols = Columns(df)
        missing = cols.missing(self.keyCols + [self.xCol])
        if missing:
            raise KeyError(f"DataFrame is missing columns: {missing}")
        n = cols.n
        fill = None if self.estimatorType == "transformer" else np.nan
        values = np.empty(n, dtype=object)
        values[:] = [fill] * n
        if n:
            keys, rows, _ = group_rows([cols.column(c)
                                        for c in self.keyCols])
            xcol = cols.column(self.xCol)
            fleet_groups = []
            for key, pos in zip(keys, rows):
                if self.fleet is not None and \
                        key in self.fleet["key_index"]:
                    fleet_groups.append((key, pos))
                    continue
                est = self.models.get(key) if self.models else None
                if est is not None:
                    _put(values, pos,
                         self._host_output(est, stack_x(xcol[pos])))
            if fleet_groups:
                X_all = stack_x(xcol).astype(np.float32)
                for (key, pos), vals in zip(
                        fleet_groups,
                        self._fleet_predict_all(fleet_groups, X_all)):
                    _put(values, pos, vals)
        if self.pandas:
            import pandas as pd
            res = df.copy()
            res[self.outputCol] = pd.Series(values.tolist(), index=df.index)
            return res
        res = dict(df)
        res[self.outputCol] = _as_column(values)
        return res

    def _host_output(self, est, X):
        if self.estimatorType == "transformer":
            return list(np.asarray(est.transform(X)))
        if self.estimatorType == "clusterer":
            return np.asarray(est.predict(X), dtype=np.int64)
        pred = np.asarray(est.predict(X))
        if np.issubdtype(pred.dtype, np.number):
            pred = pred.astype(np.float64)
        return pred

    def _fleet_predict_all(self, fleet_groups, X_all):
        """The fleet keys' outputs, a bucket of keys a call: each key's
        rows padded to its bucket's length, the models gathered by key,
        one `predict_fleet` (or the step's apply) over (G, L, d).  One
        output list a group, in `fleet_groups` order."""
        fleet = self.fleet
        static = fleet["static"]
        models = fleet["models"]
        dev = next(iter(models.values())).device
        X = torch.as_tensor(X_all, device=dev)
        rows = [pos for _, pos in fleet_groups]
        midx = np.asarray([fleet["key_index"][key]
                           for key, _ in fleet_groups])
        outs: List[Any] = [None] * len(rows)
        for L, idxs in buckets_of(len(r) for r in rows).items():
            Xs, _, _ = pad_bucket(X, rows, idxs, L)
            sel = torch.as_tensor(midx[idxs], device=dev)
            mb = {k: v.index_select(0, sel) for k, v in models.items()}
            if fleet["kind"] == "step":
                Y = fleet["step"].apply(static, mb, Xs)
            else:
                Y = fleet["family"].predict_fleet(mb, static, Xs,
                                                  fleet["meta"])
            Y = Y.cpu().numpy()
            for j, gi in enumerate(idxs):
                outs[gi] = Y[j, :len(rows[gi])]
        for out in outs:
            if fleet["kind"] == "step":
                yield list(out.astype(np.float64))
            elif fleet["family"].is_classifier:
                yield fleet["meta"]["classes"][out.astype(np.int64)]
            elif self.estimatorType == "clusterer":
                yield out.astype(np.int64)
            else:
                yield out.astype(np.float64)


def _put(values: np.ndarray, pos: np.ndarray, vals) -> None:
    """values[pos[i]] = vals[i]: at once for a 1-D array of scalars, an
    element a row for a list of vectors."""
    if isinstance(vals, np.ndarray) and vals.ndim == 1:
        values[pos] = vals
        return
    for p, v in zip(pos, vals):
        values[p] = v
