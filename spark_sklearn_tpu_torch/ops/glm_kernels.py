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

On the card both kernels run on a grid of lane tiles x S row splits and
add the splits' partial sums in a second, fixed-order launch;
`launch_plan` picks S and the scratch shape (see the source's note).

The keyed fleet's per-key fits (`ops/solvers.lbfgs_lanes`) use the
lane-major modes K2ℓ `glm_loss_grad_lanes(Z, w, y)` and K4ℓ
`glm_trial_loss_lanes(Z, Zp, w, y, alphas)`: Z (G, L) or (G, L, k) as
`torch.bmm` writes it, w (G, L), and y either (G, L) (each lane's own
labels) or (L,) (shared).  A warp takes a lane and strides its rows;
`lanes_plan` picks the row splits.  Their launches count in
`LANE_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"glm_loss_grad": 0, "glm_trial_loss": 0}
#: the same for the lane-major modes (the keyed fleet's path), apart so
#: that a search's check of its own kernels reads `LAUNCHES` alone
LANE_LAUNCHES = {"glm_loss_grad_lanes": 0, "glm_trial_loss_lanes": 0}

#: most line-search trials one K4 launch evaluates
MAX_TRIALS = 16

#: lanes of one block (one per thread of a warp) and warps of one block,
#: as `kLanes` and `kWarps` in csrc/glm_epilogue.cu
LANE_TILE, WARPS = 32, 4
#: blocks an SM holds at once at k <= 12, the launch bounds' minimum
#: (`__launch_bounds__(128, 8)` for K2, `(128, 6)` for K4)
RESIDENT_BLOCKS = {"glm_loss_grad": 8, "glm_trial_loss": 6}
#: the grid aims at about this many waves of resident blocks: enough
#: that no SM idles for long at the end, few enough that the partial sums
#: stay small; a whole number, so the last wave is (nearly) full
WAVES = 4
#: fewest rows a split gets where n allows: each warp walks several rows,
#: which amortises the block's set-up and its copy pipeline's first load
MIN_SPLIT_ROWS = 16


def reset_launches() -> None:
    for counts in (LAUNCHES, LANE_LAUNCHES):
        for name in counts:
            counts[name] = 0


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


def _lanes_loss(Z, w, y):
    """(G, L[, k]) lane-major logits' per-row losses, labels (G, L) or
    (L,)."""
    y = y.expand(Z.shape[0], Z.shape[1])
    if Z.dim() == 2:
        yb = y.to(Z.dtype)
        return torch.clamp_min(Z, 0.0) + torch.log1p(torch.exp(-Z.abs())) \
            - yb * Z
    zy = torch.gather(Z, 2, y.long()[:, :, None])[..., 0]
    return torch.logsumexp(Z, dim=2) - zy


def glm_loss_grad_lanes_plain(Z, w, y):
    """K2ℓ's plain version: (Σ_rows w·loss(Z) per lane, w·dloss/dZ)."""
    yy = y.expand(Z.shape[0], Z.shape[1])
    if Z.dim() == 2:
        G = w * (torch.sigmoid(Z) - yy.to(Z.dtype))
    else:
        y1h = torch.nn.functional.one_hot(yy.long(), Z.shape[2]).to(Z.dtype)
        G = w[:, :, None] * (torch.softmax(Z, dim=2) - y1h)
    return (w * _lanes_loss(Z, w, y)).sum(dim=1), G


def glm_trial_loss_lanes_plain(Z, Zp, w, y, alphas):
    """K4ℓ's plain version: one (G, L[, k]) pass per trial."""
    out = []
    for a in alphas:
        a = a[:, None, None] if Z.dim() == 3 else a[:, None]
        out.append((w * _lanes_loss(Z + a * Zp, w, y)).sum(dim=1))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# launch plan (host arithmetic, no card needed)
# ---------------------------------------------------------------------------

def row_splits(n: int, B: int, n_sm: int, resident: int) -> int:
    """S, the row splits of the grid: about `WAVES` waves of (lane tile x
    split) blocks at `resident` blocks per SM, but no split under
    `MIN_SPLIT_ROWS` rows (and so S <= n)."""
    tiles = -(-B // LANE_TILE)
    want = WAVES * resident * n_sm // tiles
    return max(1, min(want, -(-n // MIN_SPLIT_ROWS)))


def split_rows(n: int, S: int):
    """The rows of each split, as the kernel computes them
    (`split_begin`): split s is rows [s*n // S, (s+1)*n // S)."""
    return [range(s * n // S, (s + 1) * n // S) for s in range(S)]


def launch_plan(n: int, B: int, n_sm: int, trials: int = 0) -> dict:
    """Grid, block, row splits and scratch shape of one launch: K4's with
    `trials` > 0, K2's otherwise."""
    kernel = "glm_trial_loss" if trials else "glm_loss_grad"
    S = row_splits(n, B, n_sm, RESIDENT_BLOCKS[kernel])
    return {"grid": (-(-B // LANE_TILE), S), "block": LANE_TILE * WARPS,
            "splits": S,
            "scratch": (S, trials, B) if trials else (S, B)}


#: lanes of a lane-major block (a warp each), as `kLaneWarps`
LANE_WARPS = 4
#: fewest rows a lane-major split gets: two rows a thread of the warp
MIN_LANE_SPLIT_ROWS = 64


def lanes_plan(n: int, B: int, n_sm: int, trials: int = 0) -> dict:
    """K2ℓ's (K4ℓ's with `trials` > 0) grid: (ceil(B / 4) lane groups,
    S row splits), S about `WAVES` waves of 8 resident blocks an SM but
    no split under `MIN_LANE_SPLIT_ROWS` rows."""
    groups = -(-B // LANE_WARPS)
    want = WAVES * 8 * n_sm // groups
    S = max(1, min(want, -(-n // MIN_LANE_SPLIT_ROWS)))
    return {"grid": (groups, S), "block": LANE_TILE * WARPS, "splits": S,
            "scratch": (S, trials, B) if trials else (S, B)}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("glm_epilogue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.glm_loss_grad.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.glm_loss_grad.restype = i
    lib.glm_trial_loss.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.glm_trial_loss.restype = i
    lib.glm_loss_grad_lanes.argtypes = [p, p, p, p, p, p] + [i] * 6 + [p]
    lib.glm_loss_grad_lanes.restype = i
    lib.glm_trial_loss_lanes.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.glm_trial_loss_lanes.restype = i
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
    plan = launch_plan(n, B, _sm_count(Z.device.index))
    G = torch.empty_like(Z)
    loss = torch.empty(B, dtype=Z.dtype, device=Z.device)
    part = torch.empty(plan["scratch"], dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = _lib().glm_loss_grad(
            Z.data_ptr(), wT.data_ptr(), y.data_ptr(), G.data_ptr(),
            loss.data_ptr(), part.data_ptr(), n, B, k, int(binary),
            plan["splits"], torch.cuda.current_stream(Z.device).cuda_stream)
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
    plan = launch_plan(n, B, _sm_count(Z.device.index), T)
    out = torch.empty((T, B), dtype=Z.dtype, device=Z.device)
    part = torch.empty(plan["scratch"], dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = _lib().glm_trial_loss(
            Z.data_ptr(), Zp.data_ptr(), wT.data_ptr(), y.data_ptr(),
            alphas.data_ptr(), out.data_ptr(), part.data_ptr(), n, B, k, T,
            int(binary), plan["splits"],
            torch.cuda.current_stream(Z.device).cuda_stream)
    _raise_on(rc, "glm_trial_loss")
    LAUNCHES["glm_trial_loss"] += 1
    return out


def _check_lanes(Z, w, y):
    if Z.dim() not in (2, 3):
        raise ValueError(f"Z must be (G, L) or (G, L, k), got "
                         f"{tuple(Z.shape)}")
    B, n = Z.shape[0], Z.shape[1]
    if n < 1 or B < 1 or (Z.dim() == 3 and Z.shape[2] < 1):
        raise ValueError(f"empty Z {tuple(Z.shape)}")
    if Z.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("Z and w must be float32")
    if y.dtype != torch.int32:
        raise TypeError("y must be int32")
    if tuple(w.shape) != (B, n) or tuple(y.shape) not in ((B, n), (n,)):
        raise ValueError(
            f"shapes disagree: Z {tuple(Z.shape)}, w {tuple(w.shape)}, "
            f"y {tuple(y.shape)}")
    for name, t in (("Z", Z), ("w", w), ("y", y)):
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Z.numel() >= 2 ** 31:
        raise ValueError("Z too large for one launch")
    binary = Z.dim() == 2
    return n, B, (1 if binary else Z.shape[2]), binary, \
        (n if y.dim() == 2 else 0)


def glm_loss_grad_lanes(Z, w, y):
    """K2ℓ: per-lane loss (G,) and gradient G (shape of Z) over
    lane-major logits (see the module docstring)."""
    if Z.device.type == "cpu":
        return glm_loss_grad_lanes_plain(Z, w, y)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    n, B, k, binary, stride = _check_lanes(Z, w, y)
    plan = lanes_plan(n, B, _sm_count(Z.device.index))
    G = torch.empty_like(Z)
    loss = torch.empty(B, dtype=Z.dtype, device=Z.device)
    part = torch.empty(plan["scratch"], dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = _lib().glm_loss_grad_lanes(
            Z.data_ptr(), w.data_ptr(), y.data_ptr(), G.data_ptr(),
            loss.data_ptr(), part.data_ptr(), n, B, k, int(binary), stride,
            plan["splits"], torch.cuda.current_stream(Z.device).cuda_stream)
    _raise_on(rc, "glm_loss_grad_lanes")
    LANE_LAUNCHES["glm_loss_grad_lanes"] += 1
    return loss, G


def glm_trial_loss_lanes(Z, Zp, w, y, alphas):
    """K4ℓ: (T, G) data loss of each trial ``Z + alphas[t] * Zp`` over
    lane-major logits."""
    if Z.device.type == "cpu":
        return glm_trial_loss_lanes_plain(Z, Zp, w, y, alphas)
    if Z.device.type != "cuda":
        raise ValueError(f"unsupported device {Z.device}")
    n, B, k, binary, stride = _check_lanes(Z, w, y)
    if Zp.shape != Z.shape or Zp.dtype != Z.dtype or \
            Zp.device != Z.device or not Zp.is_contiguous():
        raise ValueError("Zp must be a contiguous float32 twin of Z")
    T = alphas.shape[0]
    if alphas.dim() != 2 or alphas.shape[1] != B or \
            not 1 <= T <= MAX_TRIALS:
        raise ValueError(
            f"alphas must be (T, G) with 1 <= T <= {MAX_TRIALS}, got "
            f"{tuple(alphas.shape)}")
    if alphas.dtype != torch.float32 or alphas.device != Z.device or \
            not alphas.is_contiguous():
        raise ValueError("alphas must be contiguous float32 on Z's device")
    plan = lanes_plan(n, B, _sm_count(Z.device.index), T)
    out = torch.empty((T, B), dtype=Z.dtype, device=Z.device)
    part = torch.empty(plan["scratch"], dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = _lib().glm_trial_loss_lanes(
            Z.data_ptr(), Zp.data_ptr(), w.data_ptr(), y.data_ptr(),
            alphas.data_ptr(), out.data_ptr(), part.data_ptr(), n, B, k, T,
            int(binary), stride, plan["splits"],
            torch.cuda.current_stream(Z.device).cuda_stream)
    _raise_on(rc, "glm_trial_loss_lanes")
    LANE_LAUNCHES["glm_trial_loss_lanes"] += 1
    return out
