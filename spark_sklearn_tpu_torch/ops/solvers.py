"""Batched L-BFGS for GLMs.

Counterpart of `spark_sklearn_tpu/ops/solvers.py` `LBFGSResult` and
`glm_lbfgs_batched` (:26-32, :165-360), with the same numerics:

- logits are linear in the parameters, so along a search direction p
  they move as Z(x + a*p) = Z + a*Zp.  Carrying Z in the solver state
  makes one iteration cost two wide GEMMs (Ax(p) forward, AT(G) backward)
  and ONE pass of the line search over (Z, Zp) for all 16 trial steps —
  that pass is kernel K4, the loss/gradient epilogue is kernel K2;
- the two-loop recursion, the history update with its `sy` gate, gamma,
  the float32 stall detector and the done mask stay torch ops.

`lax.while_loop` becomes a Python loop: it ends at the first iteration at
which every lane is done, or at `max_iter`, so `n_iter` is the
reference's count.  Testing the done mask costs one host sync per
iteration (`done.all()`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    grad_norm: torch.Tensor
    n_iter: torch.Tensor
    converged: torch.Tensor


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
) -> LBFGSResult:
    """L-BFGS for batched GLMs: objective f(x) = data_loss(A(x)) + reg(x)
    with A linear in x, one independent problem per lane of x0 (B, D).

    Each lane stops when its max|grad| <= tol or when its relative
    objective improvement stays below float32 eps for 3 iterations; a
    done lane takes zero steps while the others continue."""
    m = history
    B, D = x0.shape
    dtype, dev = x0.dtype, x0.device
    eps = torch.finfo(dtype).eps
    tol = torch.as_tensor(tol, dtype=dtype, device=dev).expand(B)

    def gnorm(g):
        return g.abs().amax(dim=1)

    x = x0
    Z = Ax(x0)
    loss0, G = loss_grad(Z)
    f = loss0 + reg_loss(x0)
    g = AT(G) + reg_grad(x0)

    s_mem = torch.zeros((m, B, D), dtype=dtype, device=dev)
    y_mem = torch.zeros((m, B, D), dtype=dtype, device=dev)
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
            a = rho[idx] * (s_mem[idx] * q).sum(dim=1)
            q = q - a[:, None] * y_mem[idx]
            alpha_rec.append(a)
        r = gamma[:, None] * q
        for j in reversed(range(n_hist)):
            idx = (it - 1 - j) % m
            b = rho[idx] * (y_mem[idx] * r).sum(dim=1)
            r = r + (alpha_rec[j] - b)[:, None] * s_mem[idx]
        p = -r

        dginit = (g * p).sum(dim=1)
        bad = dginit >= 0
        p = torch.where(bad[:, None], -g, p)
        dginit = torch.where(bad, -(g * g).sum(dim=1), dginit)
        # a lane whose direction went non-finite is frozen this
        # iteration: p = 0 keeps x and Z exact under x + alpha*p
        lane_bad = ~(torch.isfinite(p).all(dim=1) & torch.isfinite(dginit))
        p = torch.where(lane_bad[:, None], 0.0, p)
        dginit = torch.where(lane_bad, 0.0, dginit)

        if it == 0:
            a0 = torch.clamp_max(1.0 / (gnorm(g) + eps), 1.0)
        else:
            a0 = torch.ones(B, dtype=dtype, device=dev)

        # --- line search: every trial step in ONE pass over (Z, Zp)
        Zp = Ax(p)
        alphas = (halvings[:, None] * a0[None, :]).contiguous()  # (T, B)
        losses = trial_loss(Z, Zp, alphas) + reg_loss(
            x[None] + alphas[:, :, None] * p[None])
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
        x_new = x + alpha[:, None] * p
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
        sy = (s * yv).sum(dim=1)
        update = (sy > 1e-10) & live
        slot = it % m
        s_mem[slot] = torch.where(update[:, None], s, 0.0)
        y_mem[slot] = torch.where(update[:, None], yv, 0.0)
        rho[slot] = torch.where(
            update, 1.0 / torch.where(sy > 1e-10, sy, 1.0), 0.0)
        gamma = torch.where(update, sy / ((yv * yv).sum(dim=1) + eps),
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
