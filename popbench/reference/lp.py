"""What the two domains' references share: the LP measures the
configuration's tolerances are stated in, and the bookkeeping of the worst
reading of every number compared."""

from __future__ import annotations

import numpy as np
import torch


def kkt(lp, x: torch.Tensor, y: torch.Tensor):
    """Per lane relative primal residual, relative duality gap and primal
    objective of the iterates (x, y) of the stacked LPs ``lp`` (``K``,
    ``KT``, ``c``, ``q``, ``l``, ``u``, ``ineq``; a y >= 0 multiplier on
    every inequality row)."""
    resid = lp.K(x) - lp.q
    viol = torch.where(lp.ineq, resid.clamp_min(0.0), resid)
    prim = viol.norm(dim=1) / (1.0 + lp.q.norm(dim=1))
    r = lp.c + lp.KT(y)
    p_obj = (lp.c * x).sum(dim=1)
    d_obj = (-(lp.q * y).sum(dim=1)
             + torch.minimum(lp.l * r, lp.u * r).sum(dim=1))
    gap = (p_obj - d_obj).abs() / (1.0 + p_obj.abs() + d_obj.abs())
    return prim, gap, p_obj


class Judge:
    """The worst reading of each of ``NUMBERS`` over the judged steps
    (infinite where a step could not be judged), the steps judged and each
    judged step's lane sizes.  :meth:`observe` takes every round of the
    run in order (a split is a chain); only rounds with ``judged`` set add
    to the numbers.

    Every lane of a step is judged by what it reports.  A lane reported
    converged is held to its KKT score.  A lane that stopped at the
    iteration cap unconverged (the reference package stops there too) is
    scored by its relative primal residual plus the share by which its
    objective falls short of the lane LP's optimum, solved exactly in
    float64 (``lp.optimum``); ``capped_gap_mean`` is the mean score of the
    run's capped lanes (``capped`` keeps each lane's two parts).  The
    mean, and not the worst lane: a sound run's worst capped lane can sit
    as far from its optimum as a lane left out.  A lane reported
    unconverged before the cap was left unsolved: ``unfinished_lanes``
    counts it."""

    NUMBERS: tuple = ()

    def __init__(self, config: dict):
        self.config = config
        self.max_iters = int(config["solver"]["max_iters"])
        self.worst = dict.fromkeys(self.NUMBERS, 0.0)
        self.judged = 0
        self.sizes: list = []
        self.capped: list = []    # (residual, shortfall) of each capped lane

    def unjudgeable(self, *names) -> None:
        for name in names or self.NUMBERS:
            self.worst[name] = float("inf")

    def worse(self, **values) -> None:
        for name, v in values.items():
            if not np.isfinite(v):
                self.worst[name] = float("inf")
            elif v > self.worst[name]:
                self.worst[name] = float(v)

    def lanes(self, lp, rec: dict) -> dict:
        """``lane_kkt`` (the worst KKT score, relative primal residual
        plus relative gap from the program's x and y in float64, of the
        lanes reported converged), ``unfinished_lanes`` and
        ``objective_gap`` (the worst gap between a lane's reported
        objective and c.x) of a step; scores its capped lanes into
        ``capped_gap_mean``."""
        x = torch.as_tensor(np.asarray(rec["x"], np.float64))
        y = torch.as_tensor(np.asarray(rec["y"], np.float64))
        prim, gap, p_obj = kkt(lp, x, y)
        score = (prim + gap).numpy()
        k = score.shape[0]
        conv = np.asarray(rec.get("converged", np.zeros(k, bool)), bool)
        iters = np.asarray(rec.get("lane_iters", np.zeros(k)), np.int64)
        capped = ~conv & (iters >= self.max_iters)
        p = p_obj.numpy()
        for i in np.flatnonzero(capped):
            opt = lp.optimum(int(i))
            self.capped.append((float(prim[i]), max(0.0, float(p[i]) - opt)
                                / max(abs(opt), 1e-12)))
        if self.capped and self.worst["capped_gap_mean"] != float("inf"):
            self.worst["capped_gap_mean"] = float(
                np.mean([a + b for a, b in self.capped]))
        got = np.asarray(rec.get("primal_obj", np.full(p.shape, np.inf)),
                         np.float64)
        return dict(
            lane_kkt=float(score[conv].max()) if conv.any() else 0.0,
            unfinished_lanes=float(np.sum(~conv & ~capped)),
            objective_gap=float(np.max(np.abs(got - p) / (1.0 + np.abs(p)))))
