"""The kernel-SVM fit's two device passes (S1 and S2), each as a
hand-written CUDA kernel (``csrc/svm_dual.cu``) with its plain PyTorch
version beside it.

- S1 `gram_epilogue(G, X1, X2, kind, gamma, degree, coef0) -> K`: turns
  the product G = X1 X2ᵀ into the rbf, poly or sigmoid kernel matrix.
  Replaces the elementwise part of `spark_sklearn_tpu/models/svm.py:45-56`
  (`_kernel`); the product itself stays a library GEMM.  On the card K is
  G, rewritten in place; the linear kernel is G and launches nothing.
  For X X^T the kernel takes the rbf norms from G's diagonal, so the
  diagonal of K is exactly 1 (the plain version sums the norms apart, as
  the reference does, and agrees to rounding).
- S2 `dual_step(V, z, x, yb, bound, step, coef, target=None)`: one
  Nesterov step of `_box_fista` (svm.py:94-99, :113-122) after the ascent
  product V = (z∘yb) K, with its 40-step bisection projection: onto the
  box and the hyperplane Σ yb·a = 0 (`_project_box_hyperplane`, SVC) when
  `target` is None, else onto NuSVC's two half box-sums Σ a = target per
  class sign (`_project_box_sum`, `nu_dual_ascent`).  V None projects z
  only.  Returns (x', z', w' = z'∘yb, resid), resid = max|x' − z| / step
  per row.

Shapes: X1 (n1, d), X2 (n2, d), G (n1, n2); V, z, x, yb, bound (M, n),
one row per subproblem; yb holds -1, 0 or +1 and bound is >= 0; target
(M,); step a 0-dim tensor (it stays on the device).  All float32.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
kernel launches (plain runs are not counted).  S2 stages a row in shared
memory up to `STAGED_MAX_N` elements and streams it through L2 above
(`step_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"svm_gram_epilogue": 0, "svm_dual_step": 0}

#: S1's kernel kinds, as `Kind` in csrc/svm_dual.cu
KINDS = {"linear": 0, "rbf": 1, "poly": 2, "sigmoid": 3}

#: most elements of a row S2 stages in shared memory (9 bytes each), as
#: `kStagedMaxN` in csrc/svm_dual.cu
STAGED_MAX_N = 20480
#: S2's threads a block (one block a row), as `kStepThreads`
STEP_THREADS = 512

#: bisection steps of both projections (svm.py:132, :158 `n_bisect`)
N_BISECT = 40


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def gram_epilogue_plain(G, X1, X2, kind, gamma, degree, coef0):
    """S1's plain version: the reference's `_kernel` on a given product."""
    if kind == "linear":
        return G
    if kind == "poly":
        return (gamma * G + coef0) ** degree
    if kind == "sigmoid":
        return torch.tanh(gamma * G + coef0)
    if kind != "rbf":
        raise ValueError(f"kernel={kind!r} is not supported")
    sq1 = (X1 * X1).sum(dim=1)
    sq2 = (X2 * X2).sum(dim=1)
    d2 = sq1[:, None] - 2.0 * G + sq2[None, :]
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def project_box_hyperplane(Z, yb, bound, n_bisect=N_BISECT):
    """Each row of Z onto {0 <= a <= bound} ∩ {Σ yb·a = 0}: clip(z − ν·yb,
    0, bound) for the ν that a fixed-count bisection finds (svm.py:132)."""
    lo = -(Z.abs().amax(dim=1) + bound.amax(dim=1))
    hi = -lo
    zero = torch.zeros_like(bound)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        # clip(z - mid*yb, 0, bound); mid*yb is exact (yb is -1, 0 or 1)
        a = torch.clamp(torch.addcmul(Z, mid[:, None], yb, value=-1.0),
                        zero, bound)
        take_hi = (yb * a).sum(dim=1) > 0
        lo, hi = torch.where(take_hi, mid, lo), torch.where(take_hi, hi, mid)
    nu = 0.5 * (lo + hi)
    return torch.clamp(Z - nu[:, None] * yb, zero, bound)


def project_box_sum(Z, bound, target, n_bisect=N_BISECT):
    """Each row of Z onto {0 <= a <= bound, Σ a = target}: clip(z − λ, 0,
    bound) for the λ that a fixed-count bisection finds (svm.py:158)."""
    zmax = Z.abs().amax(dim=1) + bound.amax(dim=1) + 1.0
    lo, hi = -zmax, zmax
    zero = torch.zeros_like(bound)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        g = torch.clamp(Z - mid[:, None], zero, bound).sum(dim=1)
        take_hi = g > target
        lo, hi = torch.where(take_hi, mid, lo), torch.where(take_hi, hi, mid)
    mid = 0.5 * (lo + hi)
    return torch.clamp(Z - mid[:, None], zero, bound)


def project(Z, yb, bound, target=None):
    """The SVC projection (target None) or NuSVC's two half box-sums,
    whose rows are independent and so bisect as one (2M, n) stack."""
    if target is None:
        return project_box_hyperplane(Z, yb, bound)
    zero = torch.zeros((), dtype=bound.dtype, device=bound.device)
    halves = project_box_sum(
        torch.cat([Z, Z]), torch.cat([torch.where(yb > 0, bound, zero),
                                      torch.where(yb < 0, bound, zero)]),
        torch.cat([target, target]))
    return halves[:Z.shape[0]] + halves[Z.shape[0]:]


def dual_step_plain(V, z, x, yb, bound, step, coef, target=None):
    """S2's plain version: the reference's step, term by term."""
    if V is None:
        u = z
    elif target is None:
        u = z - step * -(1.0 - yb * V)
    else:
        u = z - step * (yb * V)
    x_new = project(u, yb, bound, target)
    z_new = x_new + coef * (x_new - x)
    resid = (x_new - z).abs().amax(dim=1) / step
    return x_new, z_new, z_new * yb, resid


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("svm_dual")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.svm_gram_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, f,
                                      p]
    lib.svm_gram_epilogue.restype = i
    lib.svm_dual_step.argtypes = [p, p, p, p, p, p, f, p, p, p, p, p, i, i,
                                  i, i, p]
    lib.svm_dual_step.restype = i
    return lib


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def gram_epilogue(G, X1, X2, kind, gamma, degree, coef0):
    """S1: the kernel matrix from G = X1 X2ᵀ (see the module docstring).
    On the card G is rewritten in place and returned."""
    if G.device.type == "cpu":
        return gram_epilogue_plain(G, X1, X2, kind, gamma, degree, coef0)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    if kind not in KINDS:
        raise ValueError(f"kernel={kind!r} is not supported")
    n1, d = X1.shape
    n2 = X2.shape[0]
    _check("X1", X1, (n1, d), G.device)
    _check("X2", X2, (n2, d), G.device)
    _check("G", G, (n1, n2), G.device)
    if kind == "linear":
        return G
    same = X1.data_ptr() == X2.data_ptr() and X1.shape == X2.shape
    sq1 = torch.empty(n1, dtype=G.dtype, device=G.device)
    sq2 = sq1 if same else torch.empty(n2, dtype=G.dtype, device=G.device)
    with torch.cuda.device(G.device):
        rc = _lib().svm_gram_epilogue(
            G.data_ptr(), X1.data_ptr(), X2.data_ptr(), sq1.data_ptr(),
            sq2.data_ptr(), n1, n2, d, int(same), KINDS[kind], float(gamma),
            float(degree), float(coef0), _stream(G.device))
    _raise_on(rc, "svm_gram_epilogue")
    LAUNCHES["svm_gram_epilogue"] += 1
    return G


def step_plan(n: int) -> str:
    """S2's plan for rows of n elements: "staged" in shared memory up to
    `STAGED_MAX_N`, "streamed" through L2 above."""
    return "staged" if n <= STAGED_MAX_N else "streamed"


def dual_step(V, z, x, yb, bound, step, coef, target=None, plan=None):
    """S2: one projected Nesterov step (see the module docstring).  `plan`
    ("staged" or "streamed") overrides `step_plan(n)`, to time the two."""
    if z.device.type == "cpu":
        return dual_step_plain(V, z, x, yb, bound, step, coef, target)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    M, n = z.shape
    dev = z.device
    for name, t in (("z", z), ("x", x), ("yb", yb), ("bound", bound)):
        _check(name, t, (M, n), dev)
    if V is not None:
        _check("V", V, (M, n), dev)
    _check("step", step, (), dev)
    if target is not None:
        _check("target", target, (M,), dev)
    plan = plan or step_plan(n)
    if plan not in ("staged", "streamed"):
        raise ValueError(f"plan={plan!r} is not 'staged' or 'streamed'")
    x_new = torch.empty_like(z)
    z_new = torch.empty_like(z)
    w_new = torch.empty_like(z)
    resid = torch.empty(M, dtype=z.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().svm_dual_step(
            None if V is None else V.data_ptr(), z.data_ptr(), x.data_ptr(),
            yb.data_ptr(), bound.data_ptr(), step.data_ptr(), float(coef),
            None if target is None else target.data_ptr(), x_new.data_ptr(),
            z_new.data_ptr(), w_new.data_ptr(), resid.data_ptr(), M, n,
            0 if target is None else 1, int(plan == "staged"),
            _stream(dev))
    _raise_on(rc, "svm_dual_step")
    LAUNCHES["svm_dual_step"] += 1
    return x_new, z_new, w_new, resid
