"""The logistic-regression fit's two fused epilogues (K2 and K4), each as
a hand-written CUDA kernel (``csrc/glm_epilogue.cu``) with its plain
PyTorch version beside it.

- K2 `glm_loss_grad(Z, wT, y) -> (loss (B,), G)`: per-lane weighted loss
  and dL/dZ in one pass.  Replaces `data_loss`/`data_grad` of
  `spark_sklearn_tpu/models/linear.py:221-226, 279-286`.
- K4 `glm_trial_loss(Z, Zp, wT, y, alphas) -> (T, B)`: the data loss of
  every line-search trial ``Z + alphas[t] * Zp`` from one read of Z and
  Zp.  Replaces the trial evaluation of
  `spark_sklearn_tpu/ops/solvers.py:290-306`.

Shapes follow the reference's lane-axis contract: Z is (n, B) for the
binary loss (one logit per lane) and (n, B, k) for the multinomial one;
wT (n, B) float32 fold weights; y (n,) int32 encoded labels.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"glm_loss_grad": 0, "glm_trial_loss": 0}

#: most line-search trials one K4 launch evaluates
MAX_TRIALS = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _binary_loss(Z, yb):
    # logaddexp(0, z) - y*z, in the stable form jnp.logaddexp uses
    return torch.clamp_min(Z, 0.0) + torch.log1p(torch.exp(-Z.abs())) \
        - yb[:, None] * Z


def _multinomial_loss(Z, y):
    zy = torch.gather(Z, 2, y.long()[:, None, None].expand(-1, Z.shape[1], 1))
    return torch.logsumexp(Z, dim=2) - zy[..., 0]


def _data_loss(Z, wT, y):
    if Z.dim() == 2:
        per = _binary_loss(Z, y.to(Z.dtype))
    else:
        per = _multinomial_loss(Z, y)
    return (wT * per).sum(dim=0)


def glm_loss_grad_plain(Z, wT, y):
    """K2's plain version: (Σ_n w·loss(Z), w·(dloss/dZ))."""
    if Z.dim() == 2:
        yb = y.to(Z.dtype)
        G = wT * (torch.sigmoid(Z) - yb[:, None])
    else:
        y1h = torch.nn.functional.one_hot(y.long(), Z.shape[2]).to(Z.dtype)
        G = wT[:, :, None] * (torch.softmax(Z, dim=2) - y1h[:, None, :])
    return _data_loss(Z, wT, y), G


def glm_trial_loss_plain(Z, Zp, wT, y, alphas):
    """K4's plain version: one (n, B[, k]) pass per trial."""
    out = []
    for a in alphas:
        a = a[None, :, None] if Z.dim() == 3 else a[None, :]
        out.append(_data_loss(Z + a * Zp, wT, y))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("glm_epilogue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.glm_loss_grad.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.glm_loss_grad.restype = i
    lib.glm_trial_loss.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.glm_trial_loss.restype = i
    return lib


def _check_common(Z, wT, y):
    if Z.dim() not in (2, 3):
        raise ValueError(f"Z must be (n, B) or (n, B, k), got {tuple(Z.shape)}")
    n, B = Z.shape[0], Z.shape[1]
    if n < 1 or B < 1:
        raise ValueError(f"empty Z {tuple(Z.shape)}")
    if Z.dtype != torch.float32 or wT.dtype != torch.float32:
        raise TypeError("Z and wT must be float32")
    if y.dtype != torch.int32:
        raise TypeError("y must be int32")
    if tuple(wT.shape) != (n, B) or tuple(y.shape) != (n,):
        raise ValueError(
            f"shapes disagree: Z {tuple(Z.shape)}, wT {tuple(wT.shape)}, "
            f"y {tuple(y.shape)}")
    for name, t in (("Z", Z), ("wT", wT), ("y", y)):
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Z.numel() >= 2 ** 31:
        raise ValueError("Z too large for one launch")
    binary = Z.dim() == 2
    return n, B, (2 if binary else Z.shape[2]), binary


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def glm_loss_grad(Z, wT, y):
    """K2: per-lane loss (B,) and gradient G (shape of Z).  See the
    module docstring for shapes."""
    if Z.device.type == "cpu":
        return glm_loss_grad_plain(Z, wT, y)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    n, B, k, binary = _check_common(Z, wT, y)
    G = torch.empty_like(Z)
    loss = torch.empty(B, dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = _lib().glm_loss_grad(
            Z.data_ptr(), wT.data_ptr(), y.data_ptr(), G.data_ptr(),
            loss.data_ptr(), n, B, k, int(binary),
            torch.cuda.current_stream(Z.device).cuda_stream)
    _raise_on(rc, "glm_loss_grad")
    LAUNCHES["glm_loss_grad"] += 1
    return loss, G


def glm_trial_loss(Z, Zp, wT, y, alphas):
    """K4: (T, B) data loss of each trial step ``Z + alphas[t] * Zp``."""
    if Z.device.type == "cpu":
        return glm_trial_loss_plain(Z, Zp, wT, y, alphas)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    n, B, k, binary = _check_common(Z, wT, y)
    if Zp.shape != Z.shape or Zp.dtype != Z.dtype or \
            Zp.device != Z.device or not Zp.is_contiguous():
        raise ValueError("Zp must be a contiguous float32 twin of Z")
    T = alphas.shape[0]
    if alphas.dim() != 2 or alphas.shape[1] != B or \
            not 1 <= T <= MAX_TRIALS:
        raise ValueError(
            f"alphas must be (T, B) with 1 <= T <= {MAX_TRIALS}, got "
            f"{tuple(alphas.shape)}")
    if alphas.dtype != torch.float32 or alphas.device != Z.device or \
            not alphas.is_contiguous():
        raise ValueError("alphas must be contiguous float32 on Z's device")
    out = torch.empty((T, B), dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = _lib().glm_trial_loss(
            Z.data_ptr(), Zp.data_ptr(), wT.data_ptr(), y.data_ptr(),
            alphas.data_ptr(), out.data_ptr(), n, B, k, T, int(binary),
            torch.cuda.current_stream(Z.device).cuda_stream)
    _raise_on(rc, "glm_trial_loss")
    LAUNCHES["glm_trial_loss"] += 1
    return out
