"""The search's data tier: where X lives while it is searched.

Counterpart of the first part of `spark_sklearn_tpu/search/stream.py`
(`DATA_MODES`, `resolve_data_mode`, :65-87): `TorchConfig.data_mode`
wins, then the ``SST_DATA_MODE`` environment variable, then
``"device"``.

- ``"device"``: X is dense on the device; a scipy-sparse X (or a
  `CSRMatrix`) is densified once on the host.
- ``"sparse"``: a sparse X stays sparse end to end, as the CSR of X and
  of Xᵀ on the device (`sparse/csr.py` `CSROperand`), for the families
  that set `supports_sparse`; a dense X runs the dense path unchanged.
- ``"stream"``: the streaming-fold tier (sample shards folded through the
  chunk pipeline, the data plane and the checkpoint journal) is not
  ported yet; it waits for the engine, and `resolve_data_mode` raises
  on it (a search resolves its tier when it starts).
"""

from __future__ import annotations

import os

DATA_MODES = ("device", "stream", "sparse")


def resolve_data_mode(config) -> str:
    """The search's data tier: ``config.data_mode`` wins, then
    ``SST_DATA_MODE``, then ``"device"``.  Raises on ``"stream"``, which
    is not ported, and on a name that is no tier."""
    mode = getattr(config, "data_mode", None)
    if mode is None:
        mode = os.environ.get("SST_DATA_MODE", "").strip().lower() or None
    if mode is None:
        return "device"
    mode = str(mode).strip().lower()
    if mode not in DATA_MODES:
        raise ValueError(
            f"data_mode={mode!r} is not a data tier; expected one of "
            f"{DATA_MODES}")
    if mode == "stream":
        raise NotImplementedError(
            "data_mode='stream': the streaming-fold tier is not ported "
            "yet; use data_mode='device' or 'sparse'")
    return mode
