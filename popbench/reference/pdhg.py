"""A plain PDHG for the reference's stacked lane LPs: what the control puts
in the program's place, in a lower precision than the configuration
states (``popbench/control.py``).

    minimize c.x  s.t.  K x <= q (inequality rows), K x = q (the rest),
                        l <= x <= u

Primal-dual hybrid gradient with equal step sizes 0.9 / ||K||_2 (power
iteration), restarts to the running average when its KKT score has
fallen below half the score at the last restart, and per-lane stopping
once the relative primal residual and the relative duality gap are both
under ``tol``.  Every tensor, iterate and product is in the lanes'
dtype."""

from __future__ import annotations

import torch

from .lp import kkt


def knorm(lp, iters: int = 30) -> torch.Tensor:
    v = torch.ones_like(lp.c) / lp.c.shape[1] ** 0.5
    for _ in range(iters):
        w = lp.KT(lp.K(v))
        v = w / (w.norm(dim=1, keepdim=True) + 1e-30)
    return lp.KT(lp.K(v)).norm(dim=1).sqrt() + 1e-12


def solve(lp, max_iters: int, tol: float, check_every: int = 64) -> dict:
    """Solve every lane; returns ``x``, ``y``, per-lane ``iterations``,
    ``converged`` and ``primal_obj`` (tensors in the lanes' dtype)."""
    step = (0.9 / knorm(lp))[:, None]
    x = torch.minimum(torch.maximum(torch.zeros_like(lp.c), lp.l), lp.u)
    y = torch.zeros_like(lp.q)
    k = x.shape[0]
    done = torch.zeros(k, dtype=torch.bool, device=x.device)
    its = torch.zeros(k, dtype=torch.int64, device=x.device)
    xs, ys, n_avg = torch.zeros_like(x), torch.zeros_like(y), 0
    last = torch.full((k,), float("inf"), device=x.device)
    it = 0
    while it < max_iters and not bool(done.all()):
        for _ in range(check_every):
            x_new = torch.minimum(torch.maximum(
                x - step * (lp.c + lp.KT(y)), lp.l), lp.u)
            y_new = y + step * (lp.K(2 * x_new - x) - lp.q)
            y_new = torch.where(lp.ineq, y_new.clamp_min(0.0), y_new)
            live = ~done[:, None]
            x = torch.where(live, x_new, x)
            y = torch.where(live, y_new, y)
            xs, ys = xs + x, ys + y
        it += check_every
        n_avg += check_every
        its = torch.where(done, its, its + check_every)
        xa, ya = xs / n_avg, ys / n_avg
        pc, gc, _ = kkt(lp, x, y)
        pa, ga, _ = kkt(lp, xa, ya)
        sc, sa = (pc + gc).float(), (pa + ga).float()
        use_avg = (sa < sc)[:, None]
        score = torch.minimum(sa, sc)
        conv = ~done & (torch.where(use_avg[:, 0], pa, pc) < tol) & \
            (torch.where(use_avg[:, 0], ga, gc) < tol)
        restart = (score < 0.5 * last) | conv
        sel = (restart & ~done)[:, None]
        x = torch.where(sel & use_avg, xa, x)
        y = torch.where(sel & use_avg, ya, y)
        last = torch.where(restart, score, last)
        if bool(restart.any()):
            xs, ys, n_avg = torch.zeros_like(x), torch.zeros_like(y), 0
        done = done | conv
    _, _, p_obj = kkt(lp, x, y)
    return dict(x=x, y=y, iterations=its, converged=done, primal_obj=p_obj)
