"""Search configuration and device choice.

Counterpart of `spark_sklearn_tpu/parallel/mesh.py` `TpuConfig`.  The JAX
config describes a device mesh; this slice of the port runs on one card,
so only the fields that still mean something carry over (`dtype`,
`max_tasks_per_batch`, `bf16_matmul`, `data_mode`) and `device` is new.

Entry points run on `cuda` unless the caller asks for the CPU with
`TorchConfig(device="cpu")`.  With no card and no explicit CPU request
they raise: the port never falls back to the CPU silently.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TorchConfig:
    """Knobs of one search.

    - `device`: ``None`` means ``"cuda"``; ``"cpu"`` runs every kernel's
      plain PyTorch version (what the CPU tests use).
    - `dtype`: ``None`` means each family's own (float32; float64 for
      Ridge and LinearRegression, as the reference runs them); float32
      forces float32 everywhere; nothing else is implemented.
    - `max_tasks_per_batch`: most (candidate x fold) lanes fitted in one
      chunk; bounds device memory for big grids.
    - `bf16_matmul`: LogisticRegression's fit GEMMs (K1, K3) take bf16
      operands with float32 output, as the reference's do
      (`models/linear.py:201-297`); other families ignore it, and so
      does a sparse X.
    - `data_mode`: the data tier (`search/stream.py`): ``None`` (the
      ``SST_DATA_MODE`` environment variable, else ``"device"``),
      ``"device"`` (a sparse X is densified once on the host) or
      ``"sparse"`` (a scipy-sparse X stays sparse on the device, for
      LogisticRegression and the discrete naive Bayes families);
      ``"stream"`` is not ported: a search raises on it.
    """

    device: Optional[str] = None
    dtype: Any = None
    max_tasks_per_batch: int = 8192
    bf16_matmul: bool = False
    data_mode: Optional[str] = None

    def check_supported(self) -> None:
        """Raise on any knob this slice does not implement (never ignore
        one silently)."""
        if self.dtype is not None and np.dtype(self.dtype) != np.float32:
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the PyTorch port takes None (each "
                "family's own) or float32")
        if int(self.max_tasks_per_batch) < 1:
            raise ValueError("max_tasks_per_batch must be >= 1")


def resolve_device(config: Optional[TorchConfig]) -> torch.device:
    """The device a search runs on.  ``cuda`` by default; raises when no
    card is visible and the caller did not ask for ``"cpu"``.

    On ``cuda`` this sets ``torch.backends.cuda.matmul.allow_tf32 =
    False`` (PyTorch's default, set explicitly): the reference computes
    its GEMMs in full float32, and TF32 keeps only ~3 decimal digits.
    """
    config = config or TorchConfig()
    config.check_supported()
    dev = torch.device(config.device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass "
                "TorchConfig(device='cpu') to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
