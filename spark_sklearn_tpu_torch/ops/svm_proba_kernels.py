"""SVC/NuSVC `probability=True`: Platt scaling (P1) and Wu-Lin pairwise
coupling (P2), each as a hand-written CUDA kernel
(``csrc/svm_proba.cu``) with its plain PyTorch version beside it.

- P1 `platt_fit(dec, y, train_w, pairs, binary) -> (A, B)`: the Platt
  sigmoid of every (task, pair) row, rows = B·P, task-major.  dec (B, n,
  P) is the family's cache of full-set pair decisions, y (n,) the encoded
  labels, train_w (B, n) the tasks' fold weights, pairs (P, 2).  The
  targets and weights are the reference's (`spark_sklearn_tpu/models/
  svm.py:658-687`): the rows of the pair's two classes weighted by the
  fold (all rows when binary), Platt's smoothed targets on the positive
  class (classes_[1] when binary, the pair's first class otherwise); the
  fit is `_platt_fit` (:331-393): 50 damped Newton steps from A = 0, each
  taking the first of 8 halvings that does not raise the loss.  The
  kernel leaves a row's loop at the first step that leaves A and B
  bitwise as they were, or that repeats a state of the last `N_CYCLE`
  steps (the states then repeat with that period), with the 50-step
  outputs bit for bit.
- P2 `pair_coupling(dec, platt, pairs, k) -> p (T, n, k)`: the sigmoids
  r = sigmoid(-(A f + B)) of each (task, row)'s P pair decisions, R from
  them (`_pair_probs_to_R`, :396-406, with its clip), then libsvm's
  `multiclass_probability` (`_pairwise_coupling`, :409-446): 100 sweeps
  of k normalised Gauss-Seidel steps from p = 1/k.  dec (T, n, P), platt
  (T, P, 2).  The kernel runs the sweeps in a deferred-rescale form (one
  reciprocal a step; `csrc/svm_proba.cu`) under the plan `coupling_plan`
  picks: a thread a problem to k = 12, a group of lanes a problem above.

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
LAUNCHES = {"svm_platt_fit": 0, "svm_pair_coupling": 0}

#: P1's threads a block (one block a row) and most row elements it stages
#: (9 bytes each), as `kPlattThreads`, `kPlattStagedMaxN`
PLATT_THREADS = 256
PLATT_STAGED_MAX_N = 20480
#: P1's plans, as `svm_platt_fit`'s `plan`
PLATT_PLANS = {"streamed": 0, "staged": 1, "staged_full": 2}
#: Newton steps and step halvings of `_platt_fit` (svm.py:331, :366), and
#: the longest period of a row's states P1's exit looks for (`kCycle`)
N_NEWTON = 50
N_HALVINGS = 8
N_CYCLE = 8
#: P2's most threads a block (as `kCouplingThreads`), shared memory a
#: block (bytes, the block's most, as `kMaxSmem`), the largest k of its
#: register plan (as `kRegMaxK`) and the scratch its global plans allow
#: (bytes)
COUPLING_THREADS = 128
COUPLING_SMEM_MAX = 232448
COUPLING_REG_MAX_K = 12
COUPLING_SCRATCH_BUDGET = 256 * 2**20
#: the coupling's sweeps (svm.py:409)
N_SWEEPS = 100
#: P2's plans, as `svm_pair_coupling`'s `plan`
COUPLING_PLANS = {"registers": 0, "group": 1, "shared": 2, "global": 3}
#: the group plan's spans: (lanes a problem G, the largest k it serves),
#: the first from k = `COUPLING_REG_MAX_K` + 1 (as `kGroupLanes`,
#: `kGroupLastK`)
COUPLING_GROUP_SPANS = ((4, 28), (8, 40), (16, 64))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def platt_inputs(dec, y, train_w, pairs, binary):
    """(f, t, w), each (B·P, n): the decisions, smoothed targets and
    weights `_platt_fit` is given, formed as the reference forms them
    (svm.py:658-687)."""
    B, n, P = dec.shape
    dt = dec.dtype
    if binary:
        f = dec[:, :, 0]
        yp = (y == 1).to(dt)[None, :]
        np_w = (train_w * yp).sum(dim=1)
        nn_w = (train_w * (1.0 - yp)).sum(dim=1)
        t_pos = (np_w + 1.0) / (np_w + 2.0)
        t_neg = 1.0 / (nn_w + 2.0)
        t = torch.where(yp > 0, t_pos[:, None], t_neg[:, None])
        return f, t, train_w
    ypos = y[None, :] == pairs[:, 0][:, None]
    yneg = y[None, :] == pairs[:, 1][:, None]
    yp = ypos.to(dt)                                          # (P, n)
    in_pair = (ypos | yneg).to(dt)
    f_bp = dec.transpose(1, 2)                                # (B, P, n)
    w_bp = train_w[:, None, :] * in_pair[None]
    np_w = (w_bp * yp[None]).sum(dim=2)                       # (B, P)
    nn_w = w_bp.sum(dim=2) - np_w
    t_pos = (np_w + 1.0) / (np_w + 2.0)
    t_neg = 1.0 / (nn_w + 2.0)
    t = torch.where(yp[None] > 0, t_pos[..., None], t_neg[..., None])
    return (f_bp.reshape(B * P, n), t.reshape(B * P, n),
            w_bp.reshape(B * P, n))


def platt_fit_plain(f, t, w, n_iter=N_NEWTON, exit_early=False,
                    trace=False):
    """`_platt_fit` (svm.py:331-393), term by term: (A, B) per row.  A step
    depends only on A and B (the loss is recomputed from them), so once a
    row's (A, B) after a step equals its (A, B) p steps earlier, its
    states repeat with period p: p = 1 is a fixed point.  With
    `exit_early` a row stops at its first such step (p <= `N_CYCLE`) and
    takes the state the last step would give (P1's exit).  With `trace`
    it also returns a dict of per-row counts: "steps" (the steps up to
    and including that first repeat, n_iter where none), "period" (its p,
    0 where none), "trials" (of those steps, the ones whose gradient was
    at least 1e-5: the trial passes P1 runs with its exit), "trials_all"
    (the same over all n_iter steps) and "unchanged" (n_iter, R): whether
    each step left A and B bitwise as they were."""
    R = f.shape[0]
    dt, dev = f.dtype, f.device
    wsum = w.sum(dim=1) + 1e-12
    np_w = (w * t).sum(dim=1)
    nn_w = wsum - np_w
    A = torch.zeros(R, dtype=dt, device=dev)
    Bb = torch.log((nn_w + 1.0) / (np_w + 1.0))

    def loss(A, Bb):
        u = A[..., None] * f + Bb[..., None]
        zero = torch.zeros((), dtype=dt, device=dev)
        return (w * (torch.logaddexp(zero, u) - (1.0 - t) * u)).sum(dim=-1)

    def bits(v):
        return v.view(torch.int32)

    halvings = 2.0 ** -torch.arange(N_HALVINGS, dtype=dt, device=dev)
    steps = torch.zeros(R, dtype=torch.int64, device=dev)
    period = torch.zeros(R, dtype=torch.int64, device=dev)
    trials = torch.zeros(R, dtype=torch.int64, device=dev)
    trials_all = torch.zeros(R, dtype=torch.int64, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    unchanged = []
    hist = [(A, Bb)]                 # the states after the last steps
    for s in range(1, n_iter + 1):
        u = A[:, None] * f + Bb[:, None]
        sg = torch.sigmoid(u)
        r = w * (sg - (1.0 - t))
        gA = (r * f).sum(dim=1)
        gB = r.sum(dim=1)
        h = w * sg * (1.0 - sg)
        hAA = (h * f * f).sum(dim=1) + 1e-9
        hAB = (h * f).sum(dim=1)
        hBB = h.sum(dim=1) + 1e-9
        det = hAA * hBB - hAB * hAB
        dA = (hBB * gA - hAB * gB) / det
        dB = (hAA * gB - hAB * gA) / det
        L0 = loss(A, Bb)
        Ls = loss(A[None] - halvings[:, None] * dA[None],
                  Bb[None] - halvings[:, None] * dB[None])     # (8, R)
        ok = Ls <= L0[None, :]
        first = torch.argmax(ok.to(torch.uint8), dim=0)
        step = torch.where(ok.any(dim=0), halvings[first],
                           torch.zeros((), dtype=dt, device=dev))
        moving = torch.maximum(gA.abs(), gB.abs()) >= 1e-5
        step = torch.where(moving, step,
                           torch.zeros((), dtype=dt, device=dev))
        upd = step > 0
        A_new = torch.where(upd, A - step * dA, A)
        B_new = torch.where(upd, Bb - step * dB, Bb)
        unchanged.append((bits(A_new) == bits(A)) & (bits(B_new) == bits(Bb)))
        steps += ~done
        trials += moving & ~done
        trials_all += moving
        # the first p (1 <= p <= N_CYCLE) whose state p steps back is this
        # one, and the state the last step then gives: the one after step
        # s - p + m, m = (n_iter - s) mod p
        rep = torch.zeros(R, dtype=torch.int64, device=dev)
        A_end, B_end = A_new, B_new
        for p in range(min(N_CYCLE, s), 0, -1):
            Ap, Bp = hist[-p]
            hit = (bits(A_new) == bits(Ap)) & (bits(B_new) == bits(Bp))
            rep = torch.where(hit, p, rep)
        for p in range(2, min(N_CYCLE, s) + 1):
            m = (n_iter - s) % p
            if m:
                Am, Bm = hist[-p + m]
                A_end = torch.where(rep == p, Am, A_end)
                B_end = torch.where(rep == p, Bm, B_end)
        new = (rep > 0) & ~done
        period = torch.where(new, rep, period)
        if exit_early:
            A_new = torch.where(done, A, torch.where(new, A_end, A_new))
            B_new = torch.where(done, Bb, torch.where(new, B_end, B_new))
        done = done | new
        A, Bb = A_new, B_new
        hist = (hist + [(A, Bb)])[-N_CYCLE:]
    if not trace:
        return A, Bb
    return A, Bb, {"steps": steps, "period": period, "trials": trials,
                   "trials_all": trials_all,
                   "unchanged": torch.stack(unchanged) if unchanged else
                   torch.zeros((0, R), dtype=torch.bool, device=dev)}


def platt_fit_rows_plain(dec, y, train_w, pairs, binary, **kw):
    """P1's plain version: `platt_inputs`, then `platt_fit_plain` (`kw`:
    its `exit_early` and `trace`)."""
    pairs = torch.as_tensor(pairs, device=dec.device).long()
    return platt_fit_plain(*platt_inputs(dec, y, train_w, pairs, binary),
                           **kw)


def pair_probs_to_R(r, pairs, k):
    """`_pair_probs_to_R` (svm.py:396-406): (..., P) pair probabilities to
    the (..., k, k) matrix R[i_p, j_p] = r_p, R[j_p, i_p] = 1 − r_p, r
    clipped away from 0 and 1 (the diagonal 0)."""
    r = torch.clamp(r, 1e-7, 1.0 - 1e-7)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    R = r.new_zeros(r.shape[:-1] + (k, k))
    R[..., i, j] = r
    R[..., j, i] = 1.0 - r
    return R


def pairwise_coupling(R, n_iter=N_SWEEPS):
    """`_pairwise_coupling` (svm.py:409-446): Wu and Lin's second
    approach, libsvm's normalised Gauss-Seidel sweeps, over any leading
    axes of R (..., k, k); returns (..., k)."""
    k = R.shape[-1]
    eye = torch.eye(k, dtype=R.dtype, device=R.device)
    R0 = R * (1.0 - eye)
    RT = R0.transpose(-1, -2)
    Q = -(RT * R0)
    Q = Q + eye * (RT ** 2).sum(dim=-1)[..., :, None]
    p = torch.full(R.shape[:-1], 1.0 / k, dtype=R.dtype, device=R.device)
    for _ in range(n_iter):
        Qp = torch.einsum("...tj,...j->...t", Q, p)
        pQp = (p * Qp).sum(dim=-1)
        for t in range(k):
            Qtt = Q[..., t, t]
            diff = (-Qp[..., t] + pQp) / Qtt
            pQp = (pQp + diff * (diff * Qtt + 2.0 * Qp[..., t])) \
                / (1.0 + diff) ** 2
            Qp = (Qp + diff[..., None] * Q[..., t, :]) \
                / (1.0 + diff[..., None])
            p = (p + diff[..., None] * eye[t]) / (1.0 + diff[..., None])
    return p


def pair_coupling_plain(dec, platt, pairs, k):
    """P2's plain version: the pair sigmoids (svm.py:774), R, then the
    coupling."""
    pairs = torch.as_tensor(pairs, device=dec.device).long()
    A = platt[..., 0][:, None, :]                              # (T, 1, P)
    B = platt[..., 1][:, None, :]
    r = torch.sigmoid(-(dec * A + B))
    return pairwise_coupling(pair_probs_to_R(r, pairs, k))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("svm_proba")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.svm_platt_fit.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.svm_platt_fit.restype = i
    lib.svm_pair_coupling.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.svm_pair_coupling.restype = i
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def platt_plan(n: int, plan=None) -> dict:
    """P1's launch for rows of n elements: a block of `threads` a row,
    thread t taking elements t, t + threads, ...; "staged" keeps a
    thread's kept elements (decision, weight, positive flag: 9 bytes) at
    slots q·threads + t of `smem` bytes up to `PLATT_STAGED_MAX_N`
    elements and leaves a row's Newton loop at its fixed point or first
    repeated state; "staged_full" is "staged" run for all `N_NEWTON`
    steps; "streamed" reads the row in every pass and leaves as "staged"
    (`plan` forces one)."""
    threads = PLATT_THREADS
    slots = -(-n // threads)
    plan = plan or ("staged" if n <= PLATT_STAGED_MAX_N else "streamed")
    if plan not in PLATT_PLANS:
        raise ValueError(f"plan={plan!r} is not one of "
                         f"{sorted(PLATT_PLANS)}")
    if plan != "streamed" and n > PLATT_STAGED_MAX_N:
        raise ValueError(f"platt_plan: {n} elements do not fit the staged "
                         f"list ({PLATT_STAGED_MAX_N} slots)")
    return {"plan": plan, "threads": threads, "slots": slots,
            "smem": 9 * slots * threads if plan != "streamed" else 0,
            "exit": plan != "staged_full"}


def _pairs_i32(pairs, dev):
    return torch.as_tensor(pairs, device=dev).to(torch.int32).contiguous()


def platt_fit(dec, y, train_w, pairs, binary, plan=None, steps=None):
    """P1 (see the module docstring): (A, B), each (B·P,).  `plan`
    ("staged", "staged_full" or "streamed") overrides `platt_plan`'s
    choice; `steps`, an int32 (B·P, 2) tensor on the card, gets each
    row's Newton steps and trial passes."""
    if dec.device.type == "cpu":
        return platt_fit_rows_plain(dec, y, train_w, pairs, binary)
    if dec.device.type != "cuda":
        raise ValueError(f"unsupported device {dec.device}")
    B, n, P = dec.shape
    dev = dec.device
    _build.check_tensor("dec", dec, (B, n, P), dev)
    _build.check_tensor("train_w", train_w, (B, n), dev)
    yi = y.to(torch.int32).contiguous()
    _build.check_tensor("y", yi, (n,), dev, torch.int32)
    pi = _pairs_i32(pairs, dev)
    _build.check_tensor("pairs", pi, (P, 2), dev, torch.int32)
    if steps is not None:
        _build.check_tensor("steps", steps, (B * P, 2), dev, torch.int32)
    if binary and P != 1:
        raise ValueError("platt_fit: a binary fit has one pair")
    plan = platt_plan(n, plan)
    A = torch.empty(B * P, dtype=dec.dtype, device=dev)
    Bo = torch.empty(B * P, dtype=dec.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().svm_platt_fit(
            dec.data_ptr(), yi.data_ptr(), train_w.data_ptr(), pi.data_ptr(),
            A.data_ptr(), Bo.data_ptr(),
            None if steps is None else steps.data_ptr(), B, n, P,
            int(bool(binary)), PLATT_PLANS[plan["plan"]],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "svm_platt_fit")
    LAUNCHES["svm_platt_fit"] += 1
    return A, Bo


def coupling_mem_floats(k: int) -> int:
    """Floats of one problem's state in the "shared" and
    "global" plans (as `coupling_mem_floats`): Q's k rows at an odd
    stride, p, p~ and (Qp)~."""
    return k * (k | 1) + 3 * k


def coupling_group(k: int) -> int:
    """The group plan's lanes a problem for k classes, by
    `COUPLING_GROUP_SPANS` (4 to k = 28, 8 to 40, 16 to 64: chip_sweep.py
    timed every G at these k); 0 where no group plan serves k."""
    first = COUPLING_REG_MAX_K + 1
    for G, last in COUPLING_GROUP_SPANS:
        if first <= k <= last:
            return G
        first = last + 1
    return 0


def coupling_plan(k: int, plan=None, problems: int = 1) -> dict:
    """P2's launch for `problems` problems of k classes.  "registers" (2 <=
    k <= `COUPLING_REG_MAX_K`): a thread a problem, its state in
    registers; "group" (to k = 64): `coupling_group(k)` lanes a problem,
    `slots` classes a lane, the state in registers; "shared": a warp a
    problem, its state (`coupling_mem_floats`) in shared memory, `threads`
    a block within `COUPLING_SMEM_MAX` bytes (one problem a block at most:
    k <= 239); "global" (past it): a warp a problem, the state in a
    scratch of `scratch` floats, `grid` blocks within
    `COUPLING_SCRATCH_BUDGET` walking the problems.  `plan` forces one."""
    threads = COUPLING_THREADS
    mem = 4 * coupling_mem_floats(k)
    if plan is None:
        if 2 <= k <= COUPLING_REG_MAX_K:
            plan = "registers"
        elif coupling_group(k):
            plan = "group"
        else:
            plan = ("shared" if mem <= COUPLING_SMEM_MAX
                    else "global")
    out = {"plan": plan, "threads": threads, "smem": 0, "scratch": 0,
           "group": 1, "slots": k}
    if plan == "registers":
        if not 2 <= k <= COUPLING_REG_MAX_K:
            raise ValueError(f"pair_coupling: no register plan for k={k}")
        return {**out, "grid": -(-problems // threads)}
    if plan == "group":
        G = coupling_group(k)
        if not G:
            raise ValueError(f"pair_coupling: no group plan for k={k}")
        return {**out, "group": G, "slots": -(-k // G),
                "grid": -(-problems * G // threads)}
    if plan == "shared":
        threads = min(threads, (COUPLING_SMEM_MAX // mem) * 32)
        if threads < 32:
            raise ValueError(
                f"pair_coupling: k={k} classes do not fit the kernel's "
                f"shared memory ({COUPLING_SMEM_MAX} bytes a block)")
        per_block = threads // 32
        return {**out, "threads": threads, "group": 32, "slots": -(-k // 32),
                "smem": per_block * mem,
                "grid": -(-problems // per_block)}
    if plan == "global":
        per_block = threads // 32
        grid = min(-(-problems // per_block),
                   max(1, COUPLING_SCRATCH_BUDGET // (per_block * mem)))
        return {**out, "group": 32, "slots": -(-k // 32), "grid": grid,
                "scratch": grid * per_block * mem // 4}
    raise ValueError(f"plan={plan!r} is not one of {sorted(COUPLING_PLANS)}")


def _lexicographic(pairs, k) -> bool:
    want = [(i, j) for i in range(k) for j in range(i + 1, k)]
    return [tuple(int(v) for v in row) for row in pairs.tolist()] == want


def pair_coupling(dec, platt, pairs, k, plan=None):
    """P2 (see the module docstring): p (T, n, k).  `plan` (one of
    `COUPLING_PLANS`) overrides `coupling_plan`'s choice."""
    if dec.device.type == "cpu":
        return pair_coupling_plain(dec, platt, pairs, k)
    if dec.device.type != "cuda":
        raise ValueError(f"unsupported device {dec.device}")
    T, n, P = dec.shape
    dev = dec.device
    if P != k * (k - 1) // 2:
        raise ValueError(f"pair_coupling: {P} pairs for k={k} classes")
    _build.check_tensor("dec", dec, (T, n, P), dev)
    _build.check_tensor("platt", platt, (T, P, 2), dev)
    # the kernels index the pairs by their lexicographic order
    if not _lexicographic(torch.as_tensor(pairs), k):
        raise ValueError("pair_coupling: pairs must be (i, j), i < j, in "
                         "lexicographic order")
    plan = coupling_plan(k, plan, T * n)
    out = torch.empty((T, n, k), dtype=dec.dtype, device=dev)
    scratch = (torch.empty(plan["scratch"], dtype=dec.dtype, device=dev)
               if plan["scratch"] else None)
    with torch.cuda.device(dev):
        rc = _lib().svm_pair_coupling(
            dec.data_ptr(), platt.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            T, n, P, k, plan["threads"], plan["grid"],
            COUPLING_PLANS[plan["plan"]],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "svm_pair_coupling")
    LAUNCHES["svm_pair_coupling"] += 1
    return out
