"""The MLP minibatch step's three fused passes (M1-M3), each a
hand-written CUDA kernel (``csrc/mlp_step.cu``) with its plain PyTorch
version beside it.

- M1 `mlp_loss_grad(Z, w, y=None, Yt=None) -> (loss (B,), wsum (B,), G)`:
  per lane the weighted loss sum of a minibatch's logits Z (B, R, k), the
  lane's clamped weight sum and the cotangent G of the mean loss.
  Replaces `spark_sklearn_tpu/models/mlp.py:155-164, 104-107, 399-401`
  and the logits' cotangent of `jax.value_and_grad` at `:248`.
- M2 `mlp_opt_step(...)`: the L2 term, the adam or sgd-momentum update
  and the epoch's loss sum, in place on the flat (B, P) parameters and
  optimizer state, only where a lane is active.  Replaces `mlp.py:167-193`
  (`update`), the L2 gradient of `:163-164` and `:253-256`.  A lane's
  parameters spread over a thread-block cluster (`opt_plan`), and the
  l2 sum keeps one order, so launches give the same bits.
- M3 `mlp_act_forward(A, b, act)` / `mlp_act_backward(dH, H, act)`: a
  hidden layer's bias and activation, and its cotangent from the kept
  output H.  Replaces the hidden layers of `mlp.py:60-64` and their
  cotangent.  Both entry points count as M3's launches.  A thread takes
  16 bytes where the widths and the tensors' alignment allow
  (`act_plan`, `act_vec`), forward a grid row a lane; the activation is
  a template argument of the kernel.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises: it never falls back.  `LAUNCHES`
counts kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"mlp_loss_grad": 0, "mlp_opt_step": 0, "mlp_act": 0}

#: activation name -> the kernel's code (`enum Act` in csrc/mlp_step.cu)
ACTIVATIONS = {"identity": 0, "relu": 1, "tanh": 2, "logistic": 3}

#: M2's threads a block (a round of parameters), the most rounds a block
#: takes a wave and the most blocks a lane (a thread-block cluster), as
#: `kThreads`, `kOptRounds` and `kOptMaxCluster`
OPT_THREADS = 256
OPT_ROUNDS = 4
OPT_MAX_CLUSTER = 8


#: M3's threads a block and blocks a launch, at most (as `kThreads`; a
#: larger launch strides)
ACT_THREADS = 256
ACT_MAX_BLOCKS = 4096


@functools.lru_cache(maxsize=256)
def act_plan(lanes: int, per_lane: int, vec: bool) -> dict:
    """M3's launch over `lanes` x `per_lane` floats.  With `vec` a thread
    takes 16 bytes (a float4) and, forward, a lane is a row of the grid
    (the caller sets `vec` where h and the total are multiples of 4 and
    the tensors 16-byte aligned: `act_vec`); else a float a thread over
    the whole lanes x per_lane.  `grid` blocks (a lane's, with `vec` and
    several lanes), `ACT_THREADS` threads each, at most `ACT_MAX_BLOCKS`
    blocks a launch; beyond, a thread strides.  Cached: the MLP step is
    bound by its host time a launch."""
    items = -(-per_lane // 4) if vec else lanes * per_lane
    rows = lanes if vec else 1
    grid = max(1, min(-(-items // ACT_THREADS),
                      max(1, ACT_MAX_BLOCKS // rows)))
    return {"vec": vec, "threads": ACT_THREADS, "grid": grid}


def act_vec(width: int, *tensors) -> bool:
    """Whether M3 may take 16 bytes a thread: `width` (h forward, the
    total backward) a multiple of 4 and every tensor 16-byte aligned."""
    if width % 4:
        return False
    for t in tensors:
        if t.data_ptr() % 16:
            return False
    return True


def opt_plan(P: int) -> dict:
    """M2's launch for P parameters a lane: K rounds of `OPT_THREADS`, a
    cluster of C = min(K, `OPT_MAX_CLUSTER`) blocks a lane, each taking
    rb rounds a wave (at most `OPT_ROUNDS`); more waves where P is
    larger.  The widest cluster was the fastest at every shape tried on
    the H100 (BASELINE #5's P = 4810: 19 rounds, 8 blocks of 3; the
    MLPRegressor's 641: 3 blocks of 1)."""
    K = -(-P // OPT_THREADS)
    C = min(OPT_MAX_CLUSTER, K)
    rb = min(OPT_ROUNDS, -(-K // C))
    return {"cluster": C, "rounds": rb, "waves": -(-K // (C * rb))}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def mlp_loss_grad_plain(Z, w, y=None, Yt=None):
    """M1's plain version: softmax cross-entropy against labels `y`, or
    half the squared error against targets `Yt` (R, k)."""
    wsum = torch.clamp_min(w.sum(dim=1), 1.0)
    scale = (w / wsum[:, None])[:, :, None]
    if Yt is not None:
        d = Z - Yt[None]
        per = 0.5 * (d * d).sum(dim=2)
        G = scale * d
    else:
        lse = torch.logsumexp(Z, dim=2)
        idx = y.long()[None, :, None].expand(Z.shape[0], -1, 1)
        per = lse - torch.gather(Z, 2, idx)[..., 0]
        y1h = torch.nn.functional.one_hot(y.long(), Z.shape[2]).to(Z.dtype)
        G = scale * (torch.softmax(Z, dim=2) - y1h[None])
    return (w * per).sum(dim=1), wsum, G


def mlp_opt_step_plain(p, g, m, v, t, wmask, alpha, wsum, lr, active, loss,
                       acc, *, adam, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                       momentum=0.9):
    """M2's plain version, in place on p, m, v, t and acc."""
    on = active[:, None]
    wm = wmask.to(p.dtype)[None, :]
    l2 = (p * p * wm).sum(dim=1)
    a, ws, step = alpha[:, None], wsum[:, None], lr[:, None]
    acc.copy_(torch.where(active, acc + (loss / wsum + 0.5 * alpha * l2
                                         / wsum) * wsum, acc))
    gt = g + wm * (a * p / ws)
    if adam:
        tn = t + 1.0
        m_new = beta_1 * m + (1.0 - beta_1) * gt
        v_new = beta_2 * v + (1.0 - beta_2) * gt * gt
        c1 = (1.0 - torch.pow(beta_1, tn))[:, None]
        c2 = (1.0 - torch.pow(beta_2, tn))[:, None]
        p_new = p - step * (m_new / c1) / (torch.sqrt(v_new / c2) + epsilon)
        v.copy_(torch.where(on, v_new, v))
        t.copy_(torch.where(active, tn, t))
    else:
        m_new = momentum * m - step * gt
        p_new = p + m_new
    m.copy_(torch.where(on, m_new, m))
    p.copy_(torch.where(on, p_new, p))


def _act_plain(x, act):
    if act == "relu":
        return torch.clamp_min(x, 0.0)
    if act == "tanh":
        return torch.tanh(x)
    if act == "logistic":
        return torch.sigmoid(x)
    return x


def mlp_act_forward_plain(A, b, act):
    """M3's forward: act(A + b) with b (B, h) added to every row."""
    return _act_plain(A + b[:, None, :], act)


def mlp_act_backward_plain(dH, H, act):
    """M3's backward: dH * act'(H), from the activation's output."""
    if act == "relu":
        return torch.where(H > 0, dH, torch.zeros_like(dH))
    if act == "tanh":
        return (dH + dH * H) * (1.0 - H)
    if act == "logistic":
        return dH * (H * (1.0 - H))
    return dH.clone()


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("mlp_step")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.mlp_loss_grad.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.mlp_opt_step.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                                 i, i, i, i, i, f, f, f, f, p]
    lib.mlp_act_forward.argtypes = [p, p, p, i, i, i, ll, i, i, i, p]
    lib.mlp_act_backward.argtypes = [p, p, p, ll, i, i, i, p]
    for fn in (lib.mlp_loss_grad, lib.mlp_opt_step, lib.mlp_act_forward,
               lib.mlp_act_backward):
        fn.restype = i
    return lib


def _on_card(x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def mlp_loss_grad(Z, w, y=None, Yt=None):
    """M1: per-lane loss sum (B,), clamped weight sum (B,) and G (B, R,
    k).  Pass `y` (R,) int32 labels for the classifier or `Yt` (R, k)
    float32 targets for the regressor."""
    if (y is None) == (Yt is None):
        raise ValueError("pass exactly one of y (labels) and Yt (targets)")
    if not _on_card(Z):
        return mlp_loss_grad_plain(Z, w, y, Yt)
    if Z.dim() != 3:
        raise ValueError(f"Z must be (B, R, k), got {tuple(Z.shape)}")
    B, R, k = Z.shape
    dev = Z.device
    _check("Z", Z, torch.float32, (B, R, k), dev)
    _check("w", w, torch.float32, (B, R), dev)
    if Yt is not None:
        _check("Yt", Yt, torch.float32, (R, k), dev)
    else:
        _check("y", y, torch.int32, (R,), dev)
    G = torch.empty_like(Z)
    loss = torch.empty(B, dtype=Z.dtype, device=dev)
    wsum = torch.empty(B, dtype=Z.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().mlp_loss_grad(
            Z.data_ptr(), None if y is None else y.data_ptr(),
            None if Yt is None else Yt.data_ptr(), w.data_ptr(),
            G.data_ptr(), loss.data_ptr(), wsum.data_ptr(), B, R, k,
            int(Yt is not None), _stream(dev))
    _raise_on(rc, "mlp_loss_grad")
    LAUNCHES["mlp_loss_grad"] += 1
    return loss, wsum, G


def mlp_opt_step(p, g, m, v, t, wmask, alpha, wsum, lr, active, loss, acc,
                 *, adam, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 momentum=0.9):
    """M2, in place: p, g, m (B, P) float32 (m is sgd's velocity); adam's
    v (B, P) and step count t (B,) (None for sgd); wmask (P,) bool, True
    on the weights; alpha, wsum, lr, loss, acc (B,) float32; active (B,)
    bool."""
    if not _on_card(p):
        return mlp_opt_step_plain(
            p, g, m, v, t, wmask, alpha, wsum, lr, active, loss, acc,
            adam=adam, beta_1=beta_1, beta_2=beta_2, epsilon=epsilon,
            momentum=momentum)
    if p.dim() != 2:
        raise ValueError(f"p must be (B, P), got {tuple(p.shape)}")
    B, P = p.shape
    dev = p.device
    for name, x in (("p", p), ("g", g), ("m", m)) + (
            (("v", v),) if adam else ()):
        _check(name, x, torch.float32, (B, P), dev)
    for name, x in (("alpha", alpha), ("wsum", wsum), ("lr", lr),
                    ("loss", loss), ("acc", acc)) + (
            (("t", t),) if adam else ()):
        _check(name, x, torch.float32, (B,), dev)
    _check("wmask", wmask, torch.bool, (P,), dev)
    _check("active", active, torch.bool, (B,), dev)
    plan = opt_plan(P)
    with torch.cuda.device(dev):
        rc = _lib().mlp_opt_step(
            p.data_ptr(), g.data_ptr(), m.data_ptr(),
            v.data_ptr() if adam else None, t.data_ptr() if adam else None,
            wmask.data_ptr(), alpha.data_ptr(), wsum.data_ptr(),
            lr.data_ptr(), active.data_ptr(), loss.data_ptr(),
            acc.data_ptr(), B, P, plan["cluster"], plan["rounds"],
            int(adam), beta_1, beta_2, epsilon, momentum, _stream(dev))
    _raise_on(rc, "mlp_opt_step")
    LAUNCHES["mlp_opt_step"] += 1


def mlp_act_forward(A, b, act):
    """M3 forward: H = act(A + b) for A (B, R, h) and b (B, h) (its rows
    may be strided, as a slice of the flat parameters is)."""
    if not _on_card(A):
        return mlp_act_forward_plain(A, b, act)
    B, R, h = A.shape
    dev = A.device
    _check("A", A, torch.float32, (B, R, h), dev)
    if b.dtype != torch.float32 or tuple(b.shape) != (B, h) or \
            b.device != dev or (h > 1 and b.stride(1) != 1):
        raise ValueError("b must be (B, h) float32 on A's device with "
                         "unit stride along h")
    H = torch.empty_like(A)
    plan = act_plan(B, R * h, act_vec(h, A, H) and B <= 65535)
    with torch.cuda.device(dev):
        rc = _lib().mlp_act_forward(
            A.data_ptr(), b.data_ptr(), H.data_ptr(), B, R, h, b.stride(0),
            ACTIVATIONS[act], int(plan["vec"]), plan["grid"], _stream(dev))
    _raise_on(rc, "mlp_act")
    LAUNCHES["mlp_act"] += 1
    return H


def mlp_act_backward(dH, H, act):
    """M3 backward: dA = dH * act'(H)."""
    if not _on_card(dH):
        return mlp_act_backward_plain(dH, H, act)
    _check("dH", dH, torch.float32, H.shape, H.device)
    _check("H", H, torch.float32, H.shape, dH.device)
    dA = torch.empty_like(dH)
    plan = act_plan(1, dH.numel(), act_vec(dH.numel(), dH, H, dA)
                    and dH.numel() < 2 ** 33)
    with torch.cuda.device(dH.device):
        rc = _lib().mlp_act_backward(
            dH.data_ptr(), H.data_ptr(), dA.data_ptr(), dH.numel(),
            ACTIVATIONS[act], int(plan["vec"]), plan["grid"],
            _stream(dH.device))
    _raise_on(rc, "mlp_act")
    LAUNCHES["mlp_act"] += 1
    return dA
