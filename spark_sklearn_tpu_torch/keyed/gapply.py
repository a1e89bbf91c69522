"""gapply: grouped apply with a declared output schema.

Counterpart of `spark_sklearn_tpu/keyed/gapply.py` (:1-247), the
reference's `gapply(grouped_data, func, schema, *cols)`: a
``(key, pandas.DataFrame) -> pandas.DataFrame`` function run a group at a
time, its output held to the schema (names, order, dtypes), the key
columns put back in front (`retainGroupColumns`), several output rows a
group allowed.  It takes a pandas GroupBy, as the reference does, and so
needs pandas (imported where it runs).

`compiled_group_func` marks a **torch** function of one segment,
``fn(X (L, c), w (L,)) -> (width,)``, for the device path: every group's
value columns go through the keyed fleets' bucketed launcher
(`keyed.run_bucketed`), a bucket of groups a call of
``torch.func.vmap(fn)`` (cached on the decorated function, as the
reference caches its jit), on ``cuda`` unless `config=TorchConfig(
device="cpu")`.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from spark_sklearn_tpu_torch.keyed.keyed import run_bucketed
from spark_sklearn_tpu_torch.parallel.device import TorchConfig, resolve_device

Schema = Union[Sequence[tuple], Mapping[str, object], None]


def compiled_group_func(device_fn: Callable) -> Callable:
    """Mark a torch per-group function for gapply's device path.

    `device_fn(X, w)` gets the group's value columns as one float32
    tensor X (L, n_cols), zero-padded, and its 0/1 row mask w (L,), and
    returns a fixed-width 1-D tensor: one output row a group.  The value
    columns must be numeric (TypeError otherwise).  Called directly as
    ``func(key, pdf)`` the decorated function runs one unpadded group on
    the CPU and returns a DataFrame of positional columns.

    >>> @compiled_group_func
    ... def mean_v(X, w):
    ...     return (X * w[:, None]).sum(dim=0) / w.sum()
    >>> gapply(df.groupby("g"), mean_v, [("v", "float64")])
    """

    def as_group_func(key, pdf):
        import pandas as pd
        X = torch.tensor(pdf.to_numpy(np.float32))
        w = torch.ones(len(pdf), dtype=torch.float32)
        out = np.atleast_1d(device_fn(X, w).cpu().numpy())
        return pd.DataFrame([out])

    as_group_func._sst_segment_fn = device_fn
    as_group_func.__name__ = getattr(device_fn, "__name__", "group_func")
    return as_group_func


def segment_launch(func) -> Callable:
    """``torch.func.vmap`` of a compiled group function's segment
    function, made once and kept on `func`."""
    launch = getattr(func, "_sst_segment_vmap", None)
    if launch is None:
        launch = torch.func.vmap(func._sst_segment_fn)
        func._sst_segment_vmap = launch
    return launch


def _gapply_segments(gb, key_names, value_cols, func, norm_schema,
                     retain_group_columns, device):
    """A compiled group function over every group through the bucketed
    launcher; None for zero groups (the empty-schema path serves it)."""
    import pandas as pd

    keys, slices = [], []
    for key, pdf in gb:
        if not isinstance(key, tuple):
            key = (key,)
        keys.append(key)
        slices.append(pdf[value_cols])
    if not keys:
        return None
    try:
        mats = [p.to_numpy(np.float32) for p in slices]
    except (ValueError, TypeError) as exc:
        raise TypeError(
            "compiled_group_func requires numeric value columns; got "
            f"{[str(d) for d in slices[0].dtypes]}") from exc
    sizes = [len(m) for m in mats]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    rows = [np.arange(starts[i], starts[i + 1]) for i in range(len(mats))]
    X = torch.as_tensor(np.concatenate(mats), device=device)
    order, Y, _ = run_bucketed(rows, X, segment_launch(func))
    Y = Y.cpu().numpy()
    if Y.ndim == 1:
        Y = Y[:, None]         # a scalar a group -> one output column
    if Y.ndim != 2:
        raise ValueError(
            "a compiled_group_func must return a fixed-width 1-D "
            f"tensor a group; got a group's shape {Y.shape[1:]}")
    out_rows = [None] * len(keys)
    for j, gi in enumerate(order):
        out_rows[gi] = Y[j]
    width = Y.shape[1]
    if norm_schema is not None:
        if len(norm_schema) != width:
            raise ValueError(
                f"schema declares {len(norm_schema)} columns but the "
                f"compiled group func returned {width}")
        names = [n for n, _ in norm_schema]
    else:
        names = [f"out{i}" for i in range(width)]
    out = pd.DataFrame(np.stack(out_rows), columns=names)
    if norm_schema is not None:
        for n, dt in norm_schema:
            if dt is not None:
                out[n] = out[n].astype(dt)
    if retain_group_columns:
        for i, kn in enumerate(key_names):
            if kn in out.columns:
                continue
            out.insert(min(i, len(out.columns)), kn, [k[i] for k in keys])
    return out


def _normalize_schema(schema: Schema):
    """schema -> ordered list of (name, numpy dtype or None)."""
    if schema is None:
        return None
    if isinstance(schema, Mapping):
        return [(k, np.dtype(v) if v is not None else None)
                for k, v in schema.items()]
    out = []
    for item in schema:
        if isinstance(item, str):
            out.append((item, None))
        else:
            name, dtype = item
            out.append((name, np.dtype(dtype) if dtype is not None else None))
    return out


def gapply(grouped_data, func: Callable, schema: Schema = None, *cols: str,
           retainGroupColumns: bool = True,
           config: Optional[TorchConfig] = None):
    """Apply ``func(key_tuple, pandas.DataFrame) -> pandas.DataFrame`` a
    group at a time (the reference's parameters):

    - grouped_data: a pandas ``DataFrameGroupBy`` or a ``(df, keys)``
      tuple;
    - func: the key is always a tuple; the frame holds `cols` (or every
      non-key column); a `compiled_group_func` runs on the device;
    - schema: a list of names, of (name, dtype), or {name: dtype}; the
      output is held to it (None: inferred);
    - retainGroupColumns: put the key columns in front of the output.
    """
    import pandas as pd

    if isinstance(grouped_data, tuple):
        df, keys = grouped_data
        if isinstance(keys, str):
            keys = [keys]
        gb = df.groupby(list(keys), sort=True)
        key_names = list(keys)
    else:
        gb = grouped_data
        keys_attr = gb.keys if not isinstance(gb.keys, str) else [gb.keys]
        key_names = list(keys_attr)
        df = gb.obj

    value_cols = list(cols) if cols else [
        c for c in df.columns if c not in key_names]
    norm_schema = _normalize_schema(schema)

    if getattr(func, "_sst_segment_fn", None) is not None:
        res = _gapply_segments(gb, key_names, value_cols, func,
                               norm_schema, retainGroupColumns,
                               resolve_device(config))
        if res is not None:
            return res

    pieces = []
    for key, pdf in gb:
        if not isinstance(key, tuple):
            key = (key,)
        out = func(key, pdf[value_cols].reset_index(drop=True))
        if not isinstance(out, pd.DataFrame):
            raise TypeError(
                f"func must return a pandas DataFrame, got {type(out)}")
        if norm_schema is not None:
            names = [n for n, _ in norm_schema]
            missing = set(names) - set(out.columns)
            if missing:
                raise ValueError(
                    f"func output is missing schema columns {sorted(missing)}")
            out = out[names]
            for n, dt in norm_schema:
                if dt is not None:
                    out[n] = out[n].astype(dt)
        if retainGroupColumns:
            for i, kn in enumerate(key_names):
                if kn in out.columns:   # func already emitted the key column
                    continue
                out.insert(min(i, len(out.columns)), kn,
                           [key[i]] * len(out))
        pieces.append(out)

    if not pieces:
        # zero groups: the declared schema with its dtypes; with no schema
        # the func's columns are unknowable, so the input value columns
        out = pd.DataFrame()
        if retainGroupColumns:
            for kn in key_names:
                out[kn] = pd.Series([], dtype=df[kn].dtype)
        if norm_schema:
            for n, dt in norm_schema:
                out[n] = pd.Series([], dtype=dt if dt is not None
                                   else object)
        else:
            for c in value_cols:
                out[c] = pd.Series([], dtype=df[c].dtype)
        return out
    return pd.concat(pieces, ignore_index=True)
