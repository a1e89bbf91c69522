"""Batched L-BFGS and proximal FISTA for GLMs.

Counterpart of `spark_sklearn_tpu/ops/solvers.py` `LBFGSResult`,
`glm_lbfgs_batched` (:26-32, :165-360) and `glm_fista_batched`
(:363-438), with the same numerics.  L-BFGS:

- logits are linear in the parameters, so along a search direction p
  they move as Z(x + a*p) = Z + a*Zp.  Carrying Z in the solver state
  makes one iteration cost two wide GEMMs (Ax(p) forward, AT(G) backward)
  and ONE pass of the line search over (Z, Zp) for all 16 trial steps —
  that pass is kernel K4, the loss/gradient epilogue is kernel K2;
- the two-loop recursion, the history update with its `sy` gate, gamma,
  the float32 stall detector and the done mask stay torch ops.

The state x holds one problem a lane along `lane_dim` (0: x (B, D), the
dense families'; the sparse LogisticRegression keeps (d + 1, B, k)
feature-major, lane_dim 1, so that SP1 reads and writes it with no
copy); a lane's reductions run over every other axis (`Lanes`).  With
lane_dim 0 and a 2-D state every operation is the one the solvers ran
before the axis was a parameter, so the dense families keep their bits.

`lax.while_loop` becomes a Python loop: it ends at the first iteration at
which every lane is done, or at `max_iter`, so `n_iter` is the
reference's count.  Testing the done mask costs one host sync per
iteration (`done.all()`).  FISTA (see `glm_fista_batched`) runs the same
way, with two GEMMs and one K2 pass an iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    grad_norm: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor


class Lanes:
    """The lane axis `dim` of a state shaped like `x`: a lane's sums and
    maxima over every other axis, and a (..., B) tensor shaped to
    broadcast against x (`b`)."""

    def __init__(self, x: torch.Tensor, dim: int = 0):
        self.B = x.shape[dim]
        red = tuple(i for i in range(x.dim()) if i != dim)
        self.red = red[0] if len(red) == 1 else red
        self.shape = tuple(self.B if i == dim else 1 for i in range(x.dim()))

    def sum(self, t):
        return t.sum(dim=self.red)

    def amax(self, t):
        return t.amax(dim=self.red)

    def all(self, t):
        return t.all(dim=self.red)

    def b(self, v):
        return v.reshape(*v.shape[:-1], *self.shape)


def _bcast(v, like):
    """(B,) -> broadcastable against Z, whose lane axis is position 1:
    Z is (n, B) or (n, B, k)."""
    if like.dim() == 3:
        return v[None, :, None]
    return v[None, :]


def glm_lbfgs_batched(
    Ax: Callable,          # x (B, D) -> Z (n, B) or (n, B, k)   ONE GEMM
    loss_grad: Callable,   # Z -> (data loss (B,), dL/dZ)        kernel K2
    trial_loss: Callable,  # Z, Zp, alphas (T, B) -> (T, B)      kernel K4
    AT: Callable,          # dL/dZ -> (B, D)                     ONE GEMM
    reg_loss: Callable,    # x (..., B, D) -> (..., B)
    reg_grad: Callable,    # x (B, D) -> (B, D)
    x0: torch.Tensor,
    max_iter: int = 100,
    tol=1e-4,
    history: int = 10,
    c1: float = 1e-4,
    ls_trials: int = 16,
    lane_dim: int = 0,
) -> LBFGSResult:
    """L-BFGS for batched GLMs: objective f(x) = data_loss(A(x)) + reg(x)
    with A linear in x, one independent problem per lane of x0 (B, D).

    Each lane stops when its max|grad| <= tol or when its relative
    objective improvement stays below float32 eps for 3 iterations; a
    done lane takes zero steps while the others continue.  x0's lanes lie
    along `lane_dim` (module docstring)."""
    m = history
    L = Lanes(x0, lane_dim)
    B = L.B
    dtype, dev = x0.dtype, x0.device
    eps = torch.finfo(dtype).eps
    tol = torch.as_tensor(tol, dtype=dtype, device=dev).expand(B)

    def gnorm(g):
        return L.amax(g.abs())

    x = x0
    Z = Ax(x0)
    loss0, G = loss_grad(Z)
    f = loss0 + reg_loss(x0)
    g = AT(G) + reg_grad(x0)

    s_mem = torch.zeros((m, *x0.shape), dtype=dtype, device=dev)
    y_mem = torch.zeros((m, *x0.shape), dtype=dtype, device=dev)
    rho = torch.zeros((m, B), dtype=dtype, device=dev)
    gamma = torch.ones(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    halvings = 0.5 ** torch.arange(ls_trials, dtype=dtype, device=dev)

    it = 0
    while it < max_iter and not bool(done.all()):
        # --- two-loop recursion over the ring of the last min(it, m)
        # pairs; slot (it - 1 - i) % m holds the i-th most recent
        n_hist = min(it, m)
        q = g
        alpha_rec = []
        for i in range(n_hist):
            idx = (it - 1 - i) % m
            a = rho[idx] * L.sum(s_mem[idx] * q)
            q = q - L.b(a) * y_mem[idx]
            alpha_rec.append(a)
        r = L.b(gamma) * q
        for j in reversed(range(n_hist)):
            idx = (it - 1 - j) % m
            b = rho[idx] * L.sum(y_mem[idx] * r)
            r = r + L.b(alpha_rec[j] - b) * s_mem[idx]
        p = -r

        dginit = L.sum(g * p)
        bad = dginit >= 0
        p = torch.where(L.b(bad), -g, p)
        dginit = torch.where(bad, -L.sum(g * g), dginit)
        # a lane whose direction went non-finite is frozen this
        # iteration: p = 0 keeps x and Z exact under x + alpha*p
        lane_bad = ~(L.all(torch.isfinite(p)) & torch.isfinite(dginit))
        p = torch.where(L.b(lane_bad), 0.0, p)
        dginit = torch.where(lane_bad, 0.0, dginit)

        if it == 0:
            a0 = torch.clamp_max(1.0 / (gnorm(g) + eps), 1.0)
        else:
            a0 = torch.ones(B, dtype=dtype, device=dev)

        # --- line search: every trial step in ONE pass over (Z, Zp)
        Zp = Ax(p)
        alphas = (halvings[:, None] * a0[None, :]).contiguous()  # (T, B)
        losses = trial_loss(Z, Zp, alphas) + reg_loss(
            x[None] + L.b(alphas) * p[None])
        armijo = losses <= f[None, :] + c1 * alphas * dginit[None, :]
        # first (largest-step) passing trial per lane; none passed ->
        # take the last (smallest) step rather than stall
        first_ok = torch.argmax(armijo.to(torch.uint8), dim=0)
        pick = torch.where(armijo.any(dim=0), first_ok, ls_trials - 1)
        alpha = torch.gather(alphas, 0, pick[None])[0]
        f_pick = torch.gather(losses, 0, pick[None])[0]

        # mask the STEP, not the state: dead lanes (done, or a non-finite
        # trial loss) take alpha = 0, so x and Z stay exact
        live = torch.isfinite(f_pick) & ~done
        alpha = torch.where(live, alpha, 0.0)
        x_new = x + L.b(alpha) * p
        # Z is not read again this iteration: update it in place, which
        # saves one (n, B, k) allocation per iteration
        Z.addcmul_(_bcast(alpha, Z), Zp)
        del Zp
        f_new = torch.where(live, f_pick, f)
        _, G = loss_grad(Z)
        g_new = AT(G) + reg_grad(x_new)
        del G

        s = x_new - x
        yv = g_new - g
        sy = L.sum(s * yv)
        update = (sy > 1e-10) & live
        slot = it % m
        s_mem[slot] = torch.where(L.b(update), s, 0.0)
        y_mem[slot] = torch.where(L.b(update), yv, 0.0)
        rho[slot] = torch.where(
            update, 1.0 / torch.where(sy > 1e-10, sy, 1.0), 0.0)
        gamma = torch.where(update, sy / (L.sum(yv * yv) + eps),
                            gamma)
        # float32 stall detector (see the reference): a lane whose
        # relative improvement stays below eps for 3 iterations is pinned
        # by rounding, above a tol it can never reach
        rel_impr = (f - f_new) / torch.clamp_min(f.abs(), eps)
        stall = torch.where(live & (rel_impr <= eps), stall + 1, 0)
        done = done | (gnorm(g_new) <= tol) | (stall >= 3)
        x, f, g = x_new, f_new, g_new
        it += 1

    gn = gnorm(g)
    return LBFGSResult(
        x=x, fun=f, grad_norm=gn,
        n_iter=torch.full((B,), it, dtype=torch.int32, device=dev),
        converged=gn <= tol)


def fista_momentum(t):
    """(t_next, beta) of FISTA's momentum sequence, in float32 on the
    host as the reference carries t: the sequence is the same for every
    lane, so it costs no device work."""
    t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
        np.float32(1.0) + np.float32(4.0) * t * t))
    return t_next, float((t - np.float32(1.0)) / t_next)


def soft_threshold(u, t):
    """The prox of t*|.|: sign(u) * max(|u| - t, 0)."""
    return torch.sign(u) * torch.clamp_min(u.abs() - t, 0.0)


def glm_fista_batched(
    Ax: Callable,          # x (B, D) -> Z (n, B) or (n, B, k)   ONE GEMM
    loss_grad: Callable,   # Z -> (data loss (B,), dL/dZ)        kernel K2
    AT: Callable,          # dL/dZ -> (B, D)                     ONE GEMM
    l1: torch.Tensor,      # (B, D) per-coefficient l1 weights (0 = none)
    l2: torch.Tensor,      # (B, D) per-coefficient l2 weights
    x0: torch.Tensor,
    max_iter: int = 1000,
    tol=1e-4,
    lane_dim: int = 0,
) -> LBFGSResult:
    """Proximal FISTA for batched GLMs with elastic-net penalties: the
    l1/elasticnet logistic regressions L-BFGS cannot fit (soft
    thresholding handles the non-smooth term).

    Logits move linearly along the momentum extrapolation
    (Zv = Zx + beta*(Zx - Zx_prev), no GEMM), so one iteration costs two
    GEMMs — the pull-back AT(dL/dZ(Zv)) and the fresh Ax(x_new) after the
    prox step — and one K2 pass.  The step is 1/L per lane, L bounded by
    20 power iterations of x -> AT(0.25*Ax(x)) plus max(l2).  The 0.25
    is the binary logistic curvature; the reference uses it for the
    multinomial fits too (its `curvature` argument is never read), and
    the port reproduces that.

    A lane is done once max|x_new - x| <= tol; done lanes are frozen.
    The loop ends when every lane is done or at `max_iter`, so `n_iter`
    is the reference's count; `converged` is the done mask.  x0's lanes
    lie along `lane_dim`, as L-BFGS's; l1 and l2 are shaped like x0."""
    lanes = Lanes(x0, lane_dim)
    B = lanes.B
    D = x0.numel() // B
    dtype, dev = x0.dtype, x0.device
    tol = torch.as_tensor(tol, dtype=dtype, device=dev).expand(B)

    v = torch.full(x0.shape, float(np.float32(1.0) / np.sqrt(np.float32(D))),
                   dtype=dtype, device=dev)
    for _ in range(20):
        u = AT(0.25 * Ax(v))
        v = u / (lanes.b(torch.sqrt(lanes.sum(u * u))) + 1e-30)
    u = AT(0.25 * Ax(v))
    L = torch.sqrt(lanes.sum(u * u)) + lanes.amax(l2) + 1e-6
    step = lanes.b(1.0 / L)                                   # (B, 1)
    step_l1 = step * l1

    x = x_prev = x0
    Zx = Zx_prev = Ax(x0)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    t = np.float32(1.0)
    it = 0
    while it < max_iter and not bool(done.all()):
        t, beta = fista_momentum(t)
        v_pt = x + beta * (x - x_prev)
        Zv = Zx + beta * (Zx - Zx_prev)
        _, G = loss_grad(Zv)
        del Zv
        g = AT(G) + l2 * v_pt
        del G
        x_new = soft_threshold(v_pt - step * g, step_l1)
        Zx_new = Ax(x_new)
        shift = lanes.amax((x_new - x).abs())
        x_new = torch.where(lanes.b(done), x, x_new)
        Zx_new = torch.where(_bcast(done, Zx), Zx, Zx_new)
        done = done | (shift <= tol)
        x_prev, x = x, x_new
        Zx_prev, Zx = Zx, Zx_new
        it += 1

    loss, _ = loss_grad(Zx)
    f = loss + lanes.sum(l1 * x.abs() + 0.5 * l2 * x * x)
    return LBFGSResult(
        x=x, fun=f, grad_norm=torch.zeros(B, dtype=dtype, device=dev),
        n_iter=torch.full((B,), it, dtype=torch.int32, device=dev),
        converged=done)


def _dot(a, b):
    """(G, 1) lane-wise dot products of a and b (G, D), one bmm."""
    return torch.bmm(a[:, None, :], b[:, :, None])[:, :, 0]


def lbfgs_lanes(
    Ax: Callable,          # x (G, D) -> Z (G, L) or (G, L, k)   ONE bmm
    loss_grad: Callable,   # Z -> (data loss (G,), dL/dZ)        kernel K2ℓ
    trial_loss: Callable,  # Z, Zp, alphas (T, G) -> (T, G)      kernel K4ℓ
    AT: Callable,          # dL/dZ -> (G, D)                     ONE bmm
    x0: torch.Tensor,      # (G, D)
    l2: torch.Tensor,      # (G,) penalty weight: l2 * ||pen * x||^2
    pen: torch.Tensor,     # (D,) 1 at the penalised coordinates, else 0
    max_iter: int = 100,
    tol=1e-4,
    history: int = 10,
    c1: float = 1e-4,
    ls_max: int = 30,
    ls_trials: int = 16,
) -> LBFGSResult:
    """The reference's scalar `lbfgs` (`spark_sklearn_tpu/ops/solvers.py:
    67-163`) run on every lane of x0 (G, D) at once, as `jax.vmap` of it
    runs: objective f(x) = data_loss(A x) + l2 ||pen x||^2 per lane.

    Each lane keeps its own history of the last `history` pairs (a pair
    stored only where s·y > 1e-10), its own iteration
    count and stop (max|g| <= tol or `max_iter`); a lane that has stopped
    is frozen while the others go on, and the loop ends when every lane
    has stopped.  The line search is the reference's halving sequence
    alpha_j = a0 2^-j, j = 0..ls_max, from a0 = min(1, 1/(max|g| + eps))
    at the first iteration and 1 after, taking the first alpha that
    passes Armijo (c1) and alpha_{ls_max} where none does.  Its trial
    losses come from one read of (Z, Zp) in K4ℓ launches of up to
    `ls_trials` trials: the first for every lane, the second (trials
    ls_trials .. ls_max) only for the lanes that still lack an Armijo
    point.  The trial penalty is the closed form l2 (ww + 2 a wp + a^2
    pp) in the lane's ||pen x||^2, pen x·p and ||pen p||^2.  A step whose
    loss is not finite is rejected (x, f, g kept); a descent direction
    that is not one (g·p >= 0) falls back to -g.

    Logits move linearly along p, so an iteration costs two bmm (Zp = A
    p and the gradient's pull-back), one K2ℓ at the new point and one or
    two K4ℓ, with two host syncs (the second launch's lanes and the
    loop's test).  Returns x, f, max|g|, each lane's n_iter and
    max|g| <= tol."""
    m = history
    G, D = x0.shape
    dtype, dev = x0.dtype, x0.device
    eps = torch.finfo(dtype).eps
    tol = torch.as_tensor(tol, dtype=dtype, device=dev).expand(G)
    pen = pen.to(dtype)

    def penalty(x):
        xp = x * pen
        return l2 * (xp * xp).sum(dim=1)

    def gnorm(g):
        return g.abs().amax(dim=1)

    x = x0
    Z = Ax(x0)
    loss, dZ = loss_grad(Z)
    f = loss + penalty(x0)
    g = AT(dZ) + (2.0 * l2)[:, None] * pen * x0
    del dZ

    # each lane's pairs newest first: position i holds its i-th most
    # recent stored pair (the reference's ring slot (n_valid - 1 - i) % m,
    # n_valid its count of stored pairs), so the two-loop reads views,
    # never per-lane gathers
    S = torch.zeros((G, m, D), dtype=dtype, device=dev)
    Yh = torch.zeros((G, m, D), dtype=dtype, device=dev)
    rho = torch.zeros((G, m), dtype=dtype, device=dev)
    gamma = torch.ones(G, dtype=dtype, device=dev)
    n_iter = torch.zeros(G, dtype=torch.int32, device=dev)
    halvings = 0.5 ** torch.arange(ls_max + 1, dtype=dtype, device=dev)

    it = 0
    while it < max_iter:
        active = gnorm(g) > tol
        if not bool(active.any()):
            break
        # --- two-loop recursion over each lane's own pairs: newest first,
        # then oldest first.  A lane's positions past its count of pairs
        # hold zeros (s, y and rho), so they add exactly zero and every
        # lane sees the reference's order without a mask
        n_hist = min(it, m)
        q = g
        alpha_rec = [None] * n_hist
        for i in range(n_hist):
            a = rho[:, i, None] * _dot(S[:, i], q)
            q = torch.addcmul(q, a, Yh[:, i], value=-1.0)
            alpha_rec[i] = a
        r = gamma[:, None] * q
        for i in reversed(range(n_hist)):
            b = rho[:, i, None] * _dot(Yh[:, i], r)
            r = torch.addcmul(r, alpha_rec[i] - b, S[:, i])
        p = -r

        dginit = (g * p).sum(dim=1)
        bad = dginit >= 0
        p = torch.where(bad[:, None], -g, p)
        dginit = torch.where(bad, -(g * g).sum(dim=1), dginit)
        if it == 0:
            a0 = torch.clamp_max(1.0 / (gnorm(g) + eps), 1.0)
        else:
            a0 = torch.ones(G, dtype=dtype, device=dev)

        # --- line search: the halving sequence's trial losses, the
        # penalty in closed form
        Zp = Ax(p)
        xp, pp_ = x * pen, p * pen
        ww, wp, pp = ((xp * xp).sum(dim=1), (xp * p).sum(dim=1),
                      (pp_ * pp_).sum(dim=1))
        alphas = (halvings[:, None] * a0[None, :]).contiguous()  # (J, G)

        def trial_f(al, data, idx=slice(None)):
            return data + l2[idx] * (ww[idx] + 2.0 * al * wp[idx]
                                     + al * al * pp[idx])

        T1 = min(ls_trials, ls_max + 1)
        f1 = trial_f(alphas[:T1], trial_loss(Z, Zp, alphas[:T1]))
        ok1 = f1 <= f[None, :] + c1 * alphas[:T1] * dginit[None, :]
        pick = torch.where(ok1.any(dim=0),
                           torch.argmax(ok1.to(torch.uint8), dim=0),
                           ls_max)
        if T1 <= ls_max:
            late = torch.nonzero(active & ~ok1.any(dim=0))[:, 0]
            if late.numel():
                rest = alphas[T1:, late].contiguous()
                f2 = trial_f(rest, trial_loss(
                    Z[late].contiguous(), Zp[late].contiguous(), rest,
                    late), late)
                ok2 = f2 <= f[late][None, :] + c1 * rest * \
                    dginit[late][None, :]
                pick[late] = torch.where(
                    ok2.any(dim=0),
                    T1 + torch.argmax(ok2.to(torch.uint8), dim=0), ls_max)
        alpha = torch.gather(alphas, 0, pick[None])[0]
        alpha = torch.where(active, alpha, 0.0)

        # --- the step, at the new point's loss and gradient (K2ℓ)
        x_new = x + alpha[:, None] * p
        ab = alpha.view(G, *([1] * (Z.dim() - 1)))
        Z_new = Z + ab * Zp
        del Zp
        loss, dZ = loss_grad(Z_new)
        f_new = loss + penalty(x_new)
        g_new = AT(dZ) + (2.0 * l2)[:, None] * pen * x_new
        del dZ
        ok = torch.isfinite(f_new) & active
        x_new = torch.where(ok[:, None], x_new, x)
        f_new = torch.where(ok, f_new, f)
        g_new = torch.where(ok[:, None], g_new, g)
        Z = torch.where(ok.view(G, *([1] * (Z.dim() - 1))), Z_new, Z)
        del Z_new

        s = x_new - x
        yv = g_new - g
        sy = (s * yv).sum(dim=1)
        update = (sy > 1e-10) & active
        # a stored pair shifts the lane's older pairs one position on
        up3 = update[:, None, None]
        S = torch.where(up3, torch.cat([s[:, None], S[:, :-1]], dim=1), S)
        Yh = torch.where(up3, torch.cat([yv[:, None], Yh[:, :-1]], dim=1),
                         Yh)
        rho = torch.where(update[:, None], torch.cat(
            [(1.0 / torch.where(update, sy, 1.0))[:, None], rho[:, :-1]],
            dim=1), rho)
        gamma = torch.where(update, sy / ((yv * yv).sum(dim=1) + eps),
                            gamma)
        n_iter = n_iter + active.to(torch.int32)
        x, f, g = x_new, f_new, g_new
        it += 1

    gn = gnorm(g)
    return LBFGSResult(x=x, fun=f, grad_norm=gn, n_iter=n_iter,
                       converged=gn <= tol)
