"""Plain reference of a Gavel POP step (max-min fairness, epigraph form).

It imports nothing of the program.  From the fleet of each round it
re-derives the split (a stable sort of the jobs by priority dealt
round-robin into k lanes on a fresh plan; on churn, survivors keep their
lane and slot and arrivals fill the vacancies, heaviest first into the
lightest lane), rebuilds every lane's LP and judges what the program
answered:

    maximize t + bonus/n * sum_m thpt_m      over X [n, 3] in [0, 1], t in [0, 10]
    s.t.     t - sum_r S[m, r] X[m, r] <= 0            every slot m
             sum_r X[m, r]             <= 1            every job m
             sum_m z_m X[m, r]         <= W_r / k      every generation r

with ``S = T / (w * max_r T)``.  The variables are ``[X.ravel(), t]`` and
the rows ``[epigraph (n), time (n), workers (3)]``, the order the program's
iterates come in.  :class:`Lanes` holds one step's stacked lane LPs as
torch tensors of any dtype on any device, so the same algebra judges the
program in float64 on the host and stands in for it, in a lower
precision, as the control (``popbench/control.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .lp import Judge

R = 3


class Split:
    """Replays the program's plan across the rounds of a session."""

    def __init__(self, config: dict):
        s = config["solver"]
        self.k_max, self.min_per_sub = int(s["k"]), int(s["min_per_sub"])
        self.idx = None
        self.ids = None

    def k_for(self, n: int) -> int:
        return max(1, min(self.k_max, n // self.min_per_sub))

    def next(self, fleet: dict) -> np.ndarray:
        """[k, n_per] positions of the round's jobs in each lane's slots,
        -1 for padding."""
        ids = np.asarray(fleet["ids"])
        scores = fleet["w"] * fleet["z"]
        n, k = ids.shape[0], self.k_for(ids.shape[0])
        if self.idx is None or self.idx.shape[0] != k:
            idx = deal(np.argsort(scores, kind="stable"), k)
        elif np.array_equal(ids, self.ids):
            idx = self.idx
        else:
            idx = repair(self.idx, self.ids, ids, scores)
        self.idx, self.ids = idx, ids
        return idx


def deal(order: np.ndarray, k: int) -> np.ndarray:
    n_per = (order.shape[0] + k - 1) // k
    out = np.full((k, n_per), -1, np.int64)
    for i in range(k):
        chunk = order[i::k]
        out[i, :chunk.shape[0]] = chunk
    return out


def repair(old_idx: np.ndarray, old_ids: np.ndarray, ids: np.ndarray,
           scores: np.ndarray) -> np.ndarray:
    """Survivors keep (lane, slot); arrivals, heaviest first, take the first
    vacancy of the lightest lane that has one (a new slot column for every
    lane once none is left); trailing all-padding columns are dropped."""
    k, n_per = old_idx.shape
    pos_of = {}
    for lane in range(k):
        for slot in range(n_per):
            e = int(old_idx[lane, slot])
            if e >= 0:
                pos_of.setdefault(old_ids[e], (lane, slot))
    slots = [[-1] * n_per for _ in range(k)]
    lane_load = np.zeros(k)
    arrivals = []
    for e in range(ids.shape[0]):
        hit = pos_of.get(ids[e])
        if hit is None:
            arrivals.append(e)
        else:
            slots[hit[0]][hit[1]] = e
            lane_load[hit[0]] += scores[e]
    arrivals.sort(key=lambda e: -scores[e])
    free = [[s for s, v in enumerate(row) if v < 0] for row in slots]
    for e in arrivals:
        open_lanes = [i for i in range(k) if free[i]]
        if not open_lanes:
            for row in slots:
                row.append(-1)
            free = [[len(slots[i]) - 1] for i in range(k)]
            open_lanes = list(range(k))
        lane = min(open_lanes, key=lambda i: lane_load[i])
        slots[lane][free[lane].pop(0)] = e
        lane_load[lane] += scores[e]
    idx = np.asarray(slots, np.int64)
    live = np.flatnonzero((idx >= 0).any(axis=0))
    return idx[:, :max(int(live.max()) + 1, 1) if live.size else 1]


class Lanes:
    """One step's k lane LPs, stacked, as tensors of ``dtype`` on
    ``device``."""

    def __init__(self, fleet: dict, idx: np.ndarray, config: dict,
                 dtype=torch.float64, device="cpu"):
        k, n = idx.shape
        valid = idx >= 0
        g = np.maximum(idx, 0)
        T = np.asarray(fleet["T"], np.float64)
        scale = 1.0 / (fleet["w"] * T.max(axis=1))
        S = np.where(valid[..., None], T[g] * scale[g][..., None], 0.0)
        z = np.where(valid, fleet["z"][g], 0.0)
        bonus = float(config["leftover_bonus"]) / max(n, 1)
        c = np.concatenate([(-bonus * S).reshape(k, -1),
                            -np.ones((k, 1))], axis=1)
        u = np.concatenate([np.repeat(valid, R, axis=1).astype(np.float64),
                            np.full((k, 1), 10.0)], axis=1)
        W = np.asarray(fleet["num_workers"], np.float64) / k
        q = np.concatenate([np.zeros((k, n)), np.ones((k, n)),
                            np.broadcast_to(W, (k, R))], axis=1)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device)
        self.k, self.n = k, n
        self.idx = idx
        self.S, self.z, self.valid = t(S), t(z), t(valid)
        self.c, self.u, self.q = t(c), t(u), t(q)
        self.l = torch.zeros_like(self.c)
        self.ineq = torch.ones_like(self.q, dtype=torch.bool)

    def K(self, x: torch.Tensor) -> torch.Tensor:
        X = x[:, :-1].reshape(self.k, self.n, R)
        t = x[:, -1:]
        return torch.cat([t - (self.S * X).sum(dim=2),
                          X.sum(dim=2) * self.valid,
                          (self.z[..., None] * X).sum(dim=1)], dim=1)

    def KT(self, y: torch.Tensor) -> torch.Tensor:
        n = self.n
        y_ep, y_tm, y_w = y[:, :n], y[:, n:2 * n], y[:, 2 * n:]
        gX = (-self.S * y_ep[..., None]
              + (y_tm * self.valid)[..., None]
              + self.z[..., None] * y_w[:, None, :])
        return torch.cat([gX.reshape(self.k, -1),
                          y_ep.sum(dim=1, keepdim=True)], dim=1)

    def throughput(self, x: torch.Tensor) -> torch.Tensor:
        """[k, n] normalised throughput of every slot."""
        X = x[:, :-1].reshape(self.k, self.n, R)
        return (self.S * X).sum(dim=2)

    def answer(self, x: torch.Tensor, n_jobs: int) -> np.ndarray:
        """The coalesced answer: each job's normalised throughput, in the
        round's job order."""
        th = self.throughput(x).double().cpu().numpy()
        rho = np.zeros(n_jobs)
        live = self.idx >= 0
        rho[self.idx[live]] = th[live]
        return rho

    def optimum(self, lane: int) -> float:
        """The exact optimum of one lane's LP (see :meth:`exact`)."""
        return float(self.exact(lane).fun)

    def exact(self, lane: int):
        """One lane's LP solved exactly in float64 (HiGHS through
        ``scipy.optimize.linprog``, independent of the program's PDHG);
        the ``OptimizeResult``."""
        import scipy.sparse as sp
        from scipy.optimize import linprog
        n = self.n
        f = lambda a: a[lane].double().cpu().numpy()
        S, z, valid = f(self.S), f(self.z), f(self.valid)
        m = np.repeat(np.arange(n), R)
        col = np.arange(R * n)
        rows = np.concatenate([m, np.arange(n), n + m,
                               2 * n + np.tile(np.arange(R), n)])
        cols = np.concatenate([col, np.full(n, R * n), col, col])
        vals = np.concatenate([-S.ravel(), np.ones(n), np.repeat(valid, R),
                               np.repeat(z, R)])
        A = sp.csr_matrix((vals, (rows, cols)), shape=(2 * n + R, R * n + 1))
        res = linprog(f(self.c), A_ub=A, b_ub=f(self.q),
                      bounds=np.stack([f(self.l), f(self.u)], axis=1),
                      method="highs")
        if res.status != 0:
            raise RuntimeError(f"lane {lane}: HiGHS status {res.status}")
        return res

    def sizes(self) -> list:
        """Per lane ``(n_var, n_con, n_coef)`` of the LP without padding:
        ``n_coef`` counts the numbers that define K (S and z of every
        job)."""
        out = []
        for row in self.idx:
            n = int((row >= 0).sum())
            out.append((R * n + 1, 2 * n + R, (R + 1) * n))
        return out


def quality(rho: np.ndarray) -> dict:
    return {"mean_norm_throughput": float(rho.mean()),
            "min_norm_throughput": float(rho.min()),
            "p10_norm_throughput": float(np.percentile(rho, 10))}


class Check(Judge):
    """Judges the program's Gavel steps (see :class:`lp.Judge`)."""

    NUMBERS = ("split_diff", "answer_gap", "lane_kkt", "capped_gap_mean",
               "unfinished_lanes", "objective_gap")

    def __init__(self, config: dict):
        super().__init__(config)
        self.split = Split(config)

    def observe(self, fleet: dict, rec: dict, judged: bool) -> None:
        idx = self.split.next(fleet)
        if not judged:
            return
        self.judged += 1
        lp = Lanes(fleet, idx, self.config)
        self.sizes.append(lp.sizes())
        split = np.asarray(rec.get("split", ()))
        if rec.get("x") is None or split.shape != idx.shape \
                or np.shape(rec["x"])[0] != lp.k:
            self.unjudgeable()
            return
        lanes = self.lanes(lp, rec)
        rho = lp.answer(torch.as_tensor(np.asarray(rec["x"], np.float64)),
                        fleet["ids"].shape[0])
        got = np.asarray(rec["alloc"], np.float64)
        answer_gap = max(
            float(np.abs(got - rho).max()) if got.shape == rho.shape
            else float("inf"),
            max(abs(float(rec["metrics"].get(key, np.inf)) - v)
                for key, v in quality(rho).items()))
        self.worse(split_diff=float(np.sum(split != idx)),
                   answer_gap=answer_gap, **lanes)


class Control:
    """The reference in the program's place: the same split, every lane
    solved by the plain PDHG of ``reference/pdhg.py`` from a cold start,
    the answer and its quality computed, all in ``dtype`` (the control
    takes bfloat16, the precision below the configuration's float32)."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        self.config = config
        self.split = Split(config)
        self.device, self.dtype = device, dtype

    def step(self, fleet: dict) -> dict:
        from . import pdhg
        idx = self.split.next(fleet)
        lp = Lanes(fleet, idx, self.config, self.dtype, self.device)
        s = self.config["solver"]
        sol = pdhg.solve(lp, int(s["max_iters"]), float(s["tol_primal"]))
        th = lp.throughput(sol["x"])                 # in the lanes' dtype
        n = fleet["ids"].shape[0]
        rho = torch.zeros(n, dtype=self.dtype, device=self.device)
        live = torch.as_tensor(idx >= 0, device=self.device)
        rho[torch.as_tensor(idx, device=self.device)[live]] = th[live]
        q = {"mean_norm_throughput": rho.mean(),
             "min_norm_throughput": rho.min(),
             "p10_norm_throughput": torch.quantile(rho.float(), 0.1)
             .to(self.dtype)}
        host = lambda a: a.double().cpu().numpy()
        return dict(status="ok", plan_cache="control", alloc=host(rho),
                    metrics={key: float(v) for key, v in q.items()},
                    split=idx, x=host(sol["x"]), y=host(sol["y"]),
                    primal_obj=host(sol["primal_obj"]),
                    lane_iters=host(sol["iterations"]),
                    converged=sol["converged"].cpu().numpy())
