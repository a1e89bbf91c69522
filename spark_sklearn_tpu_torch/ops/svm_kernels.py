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
  the reference does, and agrees to rounding).  One launch a call
  (`gram_plan`): rbf's norms, a grid sync and the epilogue in one
  cooperative launch; poly and sigmoid a block a tile; 16 bytes a thread
  where `gram_vec` allows.
- S2 `dual_step(V, z, x, yb, bound, step, coef, target=None)`: one
  Nesterov step of `_box_fista` (svm.py:94-99, :113-122) after the ascent
  product V = (z∘yb) K, with its 40-step bisection projection: onto the
  box and the hyperplane Σ yb·a = 0 (`_project_box_hyperplane`, SVC) when
  `target` is None, else onto NuSVC's two half box-sums Σ a = target per
  class sign (`_project_box_sum`, `nu_dual_ascent`).  V None projects z
  only.  Returns (x', z', w' = z'∘yb, resid), resid = max|x' − z| / step
  per row.

- S2's SVR mode `svr_dual_step(V, z, x, y, eps, bound_half, step, coef,
  target=None)`: the same step on the epsilon-SVR and nu-SVR duals
  (`spark_sklearn_tpu/models/svr.py:48-80`, `:117-170`), whose rows hold
  the pairs u = (a, a*) (M, 2n) with signs s = (+1ⁿ, −1ⁿ) and the bound
  `bound_half` (M, n) on both halves.  The gradient carries the linear
  term lin = s·[y, y] − eps (epsilon-SVR, eps (M,)) or s·[y, y] (nu-SVR:
  eps None, `target` (M,) the sum of each half), formed in the kernel
  from y (n,) and eps, so that no (M, 2n) tensor of it is written; V is
  the product β K (M, n) of β = a − a*, used for both halves.  The
  projection is S2's box-hyperplane with s for labels, or the two half
  box-sums, by S2's bisection.  Returns (x', z', β' = z'_a − z'_a*,
  resid): β' is the next product's operand.

Shapes: X1 (n1, d), X2 (n2, d), G (n1, n2); V, z, x, yb, bound (M, n),
one row per subproblem; yb holds -1, 0 or +1 and bound is >= 0; target
(M,); step a 0-dim tensor (it stays on the device).  All float32.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.  `LAUNCHES` counts
kernel launches (plain runs are not counted).  S2 sums each bisection
step over the elements that can move only (bound and yb nonzero, or a
non-finite value: any other element adds exactly ±0, so the sums keep
their bits), kept in a list a thread in shared memory up to
`STAGED_MAX_N` elements a row and in the output rows above
(`step_plan`), and takes 2 bisection steps a pass (1 in a row with a
non-finite value, a negative bound or a bracket past FLT_MAX / 2).  Its
SVR mode runs a row on a thread-block cluster of C CTAs (`svr_step_plan`:
C from n, at most 16, and no more than lets the card hold every row's
cluster at once), each CTA with its share's lists in its own shared
memory and one cluster reduction a pass, for rows of up to
`SVR_MAX_N` pairs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spark_sklearn_tpu_torch.ops import _build

#: kernel name -> number of launches in this process
LAUNCHES = {"svm_gram_epilogue": 0, "svm_dual_step": 0, "svm_svr_step": 0}

#: S1's kernel kinds, as `Kind` in csrc/svm_dual.cu
KINDS = {"linear": 0, "rbf": 1, "poly": 2, "sigmoid": 3}

#: S1's threads a block, columns of an epilogue tile (4 a thread) and
#: rbf's cooperative blocks an SM (held by `__launch_bounds__`), as
#: `kEpiThreads`, `kEpiCols` and `kEpiBlocksPerSm`
GRAM_THREADS = 256
GRAM_COLS = 4 * GRAM_THREADS
GRAM_BLOCKS_PER_SM = 8

#: most elements of a row S2 stages in shared memory (9 bytes each), as
#: `kStagedMaxN` in csrc/svm_dual.cu
STAGED_MAX_N = 20480
#: S2's threads a block (one block a row), as `kStepThreads`
STEP_THREADS = 512
#: S2's SVR mode (a thread-block cluster a row): threads of a CTA, most
#: CTAs a row, most pairs of a CTA's share (16 bytes each), as
#: `kSvrThreads`, `kSvrMaxCluster`, `kSvrShareMax` in csrc/svm_dual.cu;
#: the reductions' static shared memory (bytes) beside the lists; the most
#: pairs of a row; the fewest pairs of a share the plan gives a CTA (256
#: list elements, one a thread)
SVR_THREADS = 256
SVR_MAX_CLUSTER = 16
SVR_SHARE_MAX = 14080
SVR_STATIC_SMEM = 4816
SVR_MAX_N = SVR_MAX_CLUSTER * SVR_SHARE_MAX
SVR_MIN_SHARE = 128

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


def svr_dual_step_plain(V, z, x, y, eps, bound_half, step, coef,
                        target=None):
    """S2's SVR mode, plain: the reference's step on the stacked (a, a*)
    rows, term by term (svr.py:76-80 and :149-153 for the gradient, the
    box-hyperplane or the two half box-sum projections)."""
    n = y.shape[0]
    one = torch.ones(n, dtype=y.dtype, device=y.device)
    s = torch.cat([one, -one])
    if V is None:
        u = z
    else:
        lin = (s * torch.cat([y, y]))[None, :]
        if target is None:
            lin = lin - eps[:, None]
        grad = -(lin - s * torch.cat([V, V], dim=1))
        u = z - step * grad
    if target is None:
        x_new = project_box_hyperplane(
            u, s.expand_as(u), torch.cat([bound_half, bound_half], dim=1))
    else:
        zero = torch.zeros_like(bound_half)
        pos_b = torch.cat([bound_half, zero], dim=1)
        neg_b = torch.cat([zero, bound_half], dim=1)
        x_new = project_box_sum(u, pos_b, target) + \
            project_box_sum(u, neg_b, target)
    z_new = x_new + coef * (x_new - x)
    resid = (x_new - z).abs().amax(dim=1) / step
    return x_new, z_new, z_new[:, :n] - z_new[:, n:], resid


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("svm_dual")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.svm_gram_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, f,
                                      i, i, p]
    lib.svm_gram_epilogue.restype = i
    lib.svm_dual_step.argtypes = [p, p, p, p, p, p, f, p, p, p, p, p, i, i,
                                  i, i, p]
    lib.svm_dual_step.restype = i
    lib.svm_svr_step.argtypes = [p, p, p, p, p, p, p, f, p, p, p, p, p, i,
                                 i, i, i, p]
    lib.svm_svr_step.restype = i
    lib.svm_svr_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.svm_svr_clusters.restype = i
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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gram_plan(n1: int, n2: int, kind: str, n_sm: int) -> dict:
    """S1's launch for an (n1, n2) matrix: n1 x `chunks` epilogue tiles
    (tile t: row t // chunks, the `GRAM_COLS` columns of chunk t %
    chunks).  rbf: a cooperative `grid` of at most `GRAM_BLOCKS_PER_SM`
    blocks an SM, block b taking tiles b, b + grid, ... after the norms;
    poly and sigmoid: a block a tile."""
    chunks = -(-n2 // GRAM_COLS)
    tiles = n1 * chunks
    grid = min(tiles, n_sm * GRAM_BLOCKS_PER_SM) if kind == "rbf" else tiles
    return {"chunks": chunks, "tiles": tiles, "grid": grid,
            "threads": GRAM_THREADS}


def gram_vec(n2: int, G) -> bool:
    """Whether S1 takes 16 bytes a thread: rows a multiple of 4 floats and
    G 16-byte aligned."""
    return n2 % 4 == 0 and G.data_ptr() % 16 == 0


def gram_epilogue(G, X1, X2, kind, gamma, degree, coef0):
    """S1: the kernel matrix from G = X1 X2ᵀ (see the module docstring).
    On the card G is rewritten in place and returned, in one launch."""
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
    # the norms' scratch, one allocation (sq2 16-byte aligned after sq1:
    # the kernel reads it a float4 at a time)
    sq = sq1 = sq2 = None
    if kind == "rbf":
        n1_4 = -(-n1 // 4) * 4
        sq = torch.empty(n1 if same else n1_4 + n2, dtype=G.dtype,
                         device=G.device)
        sq1 = sq.data_ptr()
        sq2 = sq1 if same else sq1 + 4 * n1_4
    plan = gram_plan(n1, n2, kind, _sm_count(G.device.index))
    with torch.cuda.device(G.device):
        rc = _lib().svm_gram_epilogue(
            G.data_ptr(), X1.data_ptr(), X2.data_ptr(), sq1, sq2, n1, n2, d,
            int(same), KINDS[kind], float(gamma), float(degree),
            float(coef0), plan["grid"], int(gram_vec(n2, G)),
            _stream(G.device))
    _raise_on(rc, "svm_gram_epilogue")
    LAUNCHES["svm_gram_epilogue"] += 1
    return G


def step_plan(n: int, plan=None) -> dict:
    """S2's launch for rows of n elements: `threads` (`STEP_THREADS`) a
    row, each thread owning elements t, t + threads, ... and up to
    `slots` of them in its list of kept elements (slot q at q·threads +
    t); "staged" keeps the lists in `smem` bytes of shared memory (u,
    bound, the sign of yb: 9 bytes a slot) up to `STAGED_MAX_N`,
    "streamed" in the rows of x', z' and w' above (`plan` forces one)."""
    threads = STEP_THREADS
    slots = -(-n // threads)
    plan = plan or ("staged" if n <= STAGED_MAX_N else "streamed")
    if plan not in ("staged", "streamed"):
        raise ValueError(f"plan={plan!r} is not 'staged' or 'streamed'")
    return {"plan": plan, "threads": threads, "slots": slots,
            "smem": 9 * slots * threads if plan == "staged" else 0}


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
    plan = step_plan(n, plan)
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
            0 if target is None else 1, int(plan["plan"] == "staged"),
            _stream(dev))
    _raise_on(rc, "svm_dual_step")
    LAUNCHES["svm_dual_step"] += 1
    return x_new, z_new, w_new, resid


def svr_step_plan(n: int, rows: int = 1, cluster=None,
                  clusters=None) -> dict:
    """S2's SVR launch for `rows` rows of n pairs: a thread-block cluster
    of `cluster` CTAs a row, CTA c owning the `share` pairs from c·share,
    its thread t the pairs c·share + t, + `threads`, ..., and keeping two
    lists (a and a*) of up to `slots` kept elements each in `smem` bytes
    (u and the bound, 16 bytes a pair slot).  Unless `cluster` is given,
    the most CTAs from ceil(n / `SVR_MIN_SHARE`) (at most
    `SVR_MAX_CLUSTER`) down to the fewest the row fits, for which
    `clusters(C)` (how many clusters of C CTAs the card holds at once;
    None: no limit) holds every row's cluster, else the fewest."""
    fewest = -(-n // SVR_SHARE_MAX)
    if fewest > SVR_MAX_CLUSTER:
        raise ValueError(f"svr_step_plan: {n} pairs are over the "
                         f"{SVR_MAX_N} a row of {SVR_MAX_CLUSTER} CTAs "
                         f"holds ({SVR_SHARE_MAX} pairs each)")
    if cluster is None:
        most = min(SVR_MAX_CLUSTER, max(fewest, -(-n // SVR_MIN_SHARE)))
        cluster = next((C for C in range(most, fewest - 1, -1)
                        if clusters is None or clusters(C) >= rows), fewest)
    elif not fewest <= cluster <= SVR_MAX_CLUSTER:
        raise ValueError(f"svr_step_plan: {n} pairs do not fit {cluster} "
                         f"CTAs ({SVR_SHARE_MAX} pairs each, at most "
                         f"{SVR_MAX_CLUSTER} a row)")
    share = -(-n // cluster)
    slots = -(-share // SVR_THREADS)
    return {"threads": SVR_THREADS, "cluster": cluster, "share": share,
            "slots": slots, "smem": 16 * slots * SVR_THREADS}


@functools.cache
def svr_clusters(index: int, n: int, nu: bool, cluster: int) -> int:
    """How many clusters of `cluster` CTAs card `index` holds at once for
    S2's SVR mode on rows of n pairs (cudaOccupancyMaxActiveClusters)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _lib().svm_svr_clusters(n, int(nu), cluster, ctypes.byref(out))
    _raise_on(rc, "svm_svr_clusters")
    return out.value


def svr_dual_step(V, z, x, y, eps, bound_half, step, coef, target=None,
                  plan=None):
    """S2's SVR mode (see the module docstring): eps (M,) for
    epsilon-SVR, or None with `target` (M,) for nu-SVR.  `plan`, a plan of
    `svr_step_plan`, overrides the one it picks for this card."""
    if z.device.type == "cpu":
        return svr_dual_step_plain(V, z, x, y, eps, bound_half, step, coef,
                                   target)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    M, n = bound_half.shape
    dev = z.device
    _check("z", z, (M, 2 * n), dev)
    _check("x", x, (M, 2 * n), dev)
    _check("y", y, (n,), dev)
    _check("bound_half", bound_half, (M, n), dev)
    if V is not None:
        _check("V", V, (M, n), dev)
    _check("step", step, (), dev)
    if (eps is None) == (target is None):
        raise ValueError("svr_dual_step takes eps (SVR) or target (nu-SVR)")
    if eps is not None:
        _check("eps", eps, (M,), dev)
    if target is not None:
        _check("target", target, (M,), dev)
    nu = target is not None
    if plan is None:
        plan = svr_step_plan(n, M, clusters=functools.partial(
            svr_clusters, dev.index, n, nu))
    elif plan["cluster"] * plan["share"] < n:
        raise ValueError("svr_dual_step: the plan does not cover n pairs")
    x_new = torch.empty_like(z)
    z_new = torch.empty_like(z)
    beta = torch.empty_like(bound_half)
    resid = torch.empty(M, dtype=z.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().svm_svr_step(
            None if V is None else V.data_ptr(), z.data_ptr(), x.data_ptr(),
            y.data_ptr(), None if eps is None else eps.data_ptr(),
            bound_half.data_ptr(), step.data_ptr(), float(coef),
            None if target is None else target.data_ptr(), x_new.data_ptr(),
            z_new.data_ptr(), beta.data_ptr(), resid.data_ptr(), M, n,
            int(nu), plan["cluster"], _stream(dev))
    _raise_on(rc, "svm_svr_step")
    LAUNCHES["svm_svr_step"] += 1
    return x_new, z_new, beta, resid
