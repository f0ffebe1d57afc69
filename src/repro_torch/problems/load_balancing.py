"""Query load balancing (paper §3.3): the E-Store shard-placement MILP — the
port of ``repro/problems/load_balancing.py``.

    minimize   sum_ij (1 - t_ij) r'_ij m_i          (data movement)
    s.t.       L - eps <= sum_i r_ij l_i <= L + eps   ∀ servers j
               sum_j r_ij = 1                         ∀ shards i
               sum_i r'_ij m_i <= C_j                 ∀ servers j
               r_ij <= r'_ij <= r_ij + 1,  r' binary

Solved by LP relaxation (PDHG) + rounding + greedy repair (the
``core/rounding.py`` recipe: branch-and-bound does not batch).  In the
relaxation r' = r at the optimum (movement costs are non-negative), so the
LP is in r only.

POP split is DOMAIN-AWARE here (the paper's point about careful splits):
sub-problems get disjoint *server groups*, and every shard follows its
CURRENT server into that server's sub-problem — otherwise the split itself
would force movement.  Shard-subset load totals are then equalised by the
partitioner ("ensuring that each shard subset has the same total load",
§3.3): servers are dealt into groups round-robin by their current load so
group totals concentrate.  The module therefore has its own ``pop_solve``
(the same map step, a domain split rule).

The workload draw, the rounding and repair, ``evaluate``, the warm-start
remap and the E-Store greedy are the reference's numpy code, verbatim, so
the same seeds give bit-equal arrays and placements; the LP's fields are
f32 tensors on the solve device, and the matvecs are torch.  The solver
returns numpy iterates, so the repair slices one host copy of the whole
stacked ``x``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import backends as backends_mod
from ..core import pdhg
from ..core import plan as plan_mod
from ..core.pdhg import OperatorLP, structured_from_coo


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardWorkload:
    load: np.ndarray       # [n] query load per shard
    mem: np.ndarray        # [n] memory per shard
    placement: np.ndarray  # [n] current server of each shard
    cap: np.ndarray        # [S] server memory capacity
    eps_frac: float        # tolerance as a fraction of mean server load
    # stable external shard ids (None = positional): what warm-start
    # remapping matches on when the shard population churns between ticks
    ids: Optional[np.ndarray] = None

    @property
    def n_shards(self):
        return self.load.shape[0]

    def shard_ids(self) -> np.ndarray:
        return (np.arange(self.n_shards) if self.ids is None
                else np.asarray(self.ids))

    @property
    def n_servers(self):
        return self.cap.shape[0]

    @property
    def target(self):
        return self.load.sum() / self.n_servers


def make_shard_workload(n_shards: int, n_servers: int, *, skew: float = 1.2,
                        eps_frac: float = 0.1, hot_frac: float = 0.0,
                        seed: int = 0) -> ShardWorkload:
    """Zipf-ish shard loads (optionally with 'Taylor Swift' hot shards),
    uniform-ish memory, and a load-skewed initial placement (the state a
    balancer is called to fix)."""
    rng = np.random.default_rng(seed)
    load = rng.zipf(skew + 1.0, n_shards).astype(np.float64)
    load = np.minimum(load, 50.0) + rng.uniform(0, 1, n_shards)
    if hot_frac > 0:
        n_hot = max(1, int(hot_frac * n_shards))
        hot = rng.choice(n_shards, n_hot, replace=False)
        load[hot] *= n_shards / 20.0               # single-shard hot spots
    mem = rng.uniform(0.5, 2.0, n_shards)
    # skewed initial placement: early servers got the recent (hot) shards
    p = np.exp(-np.linspace(0, 2.0, n_servers))
    placement = rng.choice(n_servers, n_shards, p=p / p.sum())
    cap = np.full(n_servers, 2.0 * mem.sum() / n_servers)
    return ShardWorkload(load=load, mem=mem, placement=placement, cap=cap,
                         eps_frac=eps_frac)



# ---------------------------------------------------------------------------
# structured operator: rows = [load<=, -load<=, mem<=, assign ==]
# ---------------------------------------------------------------------------

def _k_mv(data, x):
    l, m, _cost = data                   # [n], [n], [n, S]
    n = l.shape[0]
    S = _cost.shape[1]
    X = x.reshape(n, S)
    load = X.T @ l                       # [S]
    mem = X.T @ m                        # [S]
    one = X.sum(dim=1)                   # [n]
    return torch.cat([load, -load, mem, one])


def _kt_mv(data, y):
    l, m, _cost = data
    n = l.shape[0]
    S = _cost.shape[1]
    y_lo = y[:S]
    y_neg = y[S: 2 * S]
    y_mem = y[2 * S: 3 * S]
    y_one = y[3 * S: 3 * S + n]
    g = (l[:, None] * (y_lo - y_neg)[None, :]
         + m[:, None] * y_mem[None, :]
         + y_one[:, None])
    return g.reshape(-1)


def _k_mv_stacked(data, x):
    """:func:`_k_mv` for every lane of a ``[k]`` stack in one pass: the
    load and memory rows are one batched product ``X^T [l, m]``."""
    l, m, cost = data                    # [k, n], [k, n], [k, n, S]
    k, n, S = cost.shape
    X = x.reshape(k, n, S)
    load_mem = torch.bmm(X.transpose(1, 2), torch.stack([l, m], dim=2))
    load = load_mem[..., 0]              # [k, S]
    return torch.cat([load, -load, load_mem[..., 1], X.sum(dim=2)], dim=1)


def _kt_mv_stacked(data, y):
    """:func:`_kt_mv` for every lane of a ``[k]`` stack in one pass."""
    l, m, cost = data
    k, n, S = cost.shape
    y_lo = y[:, :S]
    y_neg = y[:, S: 2 * S]
    y_mem = y[:, 2 * S: 3 * S]
    y_one = y[:, 3 * S: 3 * S + n]
    g = (l[:, :, None] * (y_lo - y_neg)[:, None, :]
         + m[:, :, None] * y_mem[:, None, :]
         + y_one[:, :, None])
    return g.reshape(k, -1)


# engine="auto" hint consumed by pdhg.select_engine: the distribution
# matrix X is a DENSE [n, S] block — the per-server rows are matmuls
# (X.T @ l), not segment-sums — so auto resolves to the matvec engine.  The
# index metadata is still available on demand (_relax_op(structured=True),
# what the conformance matrix forces).  The matvec engine runs the stacked
# forms (``stacked``): a few launches per half-step for the whole stack,
# where the per-lane forms launch as many again for every lane.
_k_mv.preferred_engine = "matvec"
_kt_mv.preferred_engine = "matvec"
_k_mv.stacked = _k_mv_stacked
_kt_mv.stacked = _kt_mv_stacked


@dataclasses.dataclass
class LBResult:
    placement: np.ndarray
    movement: float
    max_load_dev: float     # max_j |load_j - L| / L
    feasible: bool
    solve_time_s: float
    extra: dict


class LoadBalanceProblem:
    """E-Store MILP with POP over server groups (domain-aware split)."""

    def __init__(self, wl: ShardWorkload):
        self.wl = wl
        self.n_entities = wl.n_shards

    # ------------------------------------------------------------------ LP --
    def _relax_op(self, shards: np.ndarray, servers: np.ndarray,
                  n_pad: int, s_pad: int,
                  L_target: Optional[float] = None,
                  eps_eff: Optional[float] = None,
                  structured: bool = False,
                  coef_dtype: str = "float32",
                  device=None) -> OperatorLP:
        """LP relaxation over (shard subset x server subset), padded, with
        its tensors on ``device`` (default: the CUDA device).

        ``structured=True`` additionally attaches the ELL index metadata —
        only wanted when a caller will FORCE ``engine="fused_structured"``
        (the conformance matrix does); the auto path never reads it here
        (``_k_mv.preferred_engine``), so the online re-balance skips the
        O(nnz log nnz) packing and its upload by default."""
        device = backends_mod.resolve_device(device)
        wl = self.wl
        n_r, s_r = shards.shape[0], servers.shape[0]
        l = np.zeros(n_pad); l[:n_r] = wl.load[shards]
        m = np.zeros(n_pad); m[:n_r] = wl.mem[shards]
        # movement cost matrix (1 - t_ij) * m_i
        cost = np.zeros((n_pad, s_pad))
        cost[:n_r, :s_r] = wl.mem[shards][:, None]
        cur = wl.placement[shards]
        loc = {int(s): j for j, s in enumerate(servers)}
        cur_local = np.array([loc.get(int(s), -1) for s in cur])
        for i in np.flatnonzero(cur_local >= 0):
            cost[i, cur_local[i]] = 0.0

        L_sub = (wl.load[shards].sum() / max(s_r, 1)
                 if L_target is None else L_target)
        eps = wl.eps_frac * wl.target if eps_eff is None else eps_eff
        cap_pad = np.zeros(s_pad); cap_pad[:s_r] = wl.cap[servers]
        real_s = np.arange(s_pad) < s_r
        q = np.concatenate([
            np.where(real_s, L_sub + eps, 0.0),       # load <= L+eps
            np.where(real_s, -(L_sub - eps), 0.0),    # -load <= -(L-eps)
            cap_pad,                                  # mem <= cap
            np.where(np.arange(n_pad) < n_r, 1.0, 0.0),  # assign == 1
        ])
        ineq = np.concatenate([np.ones(3 * s_pad, bool), np.zeros(n_pad, bool)])
        u = np.zeros((n_pad, s_pad))
        u[:n_r, :s_r] = 1.0

        structured_op = None
        if structured:
            # ELL index metadata (engine="fused_structured"): X[i, j] feeds
            # the three per-server rows of j (weights l_i / -l_i / m_i) and
            # shard i's assign row; load-row width is the lane's shard count
            # (the server-group split keeps lanes small — the POP effect).
            ii, jj = np.meshgrid(np.arange(n_pad), np.arange(s_pad),
                                 indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
            xcol = ii * s_pad + jj
            rows = np.concatenate([jj, s_pad + jj, 2 * s_pad + jj,
                                   3 * s_pad + ii])
            cols = np.concatenate([xcol] * 4)
            vals = np.concatenate([l[ii], -l[ii], m[ii],
                                   np.ones(ii.shape[0])])
            structured_op = pdhg.to_device(
                structured_from_coo(rows, cols, vals, 3 * s_pad + n_pad,
                                    n_pad * s_pad, coef_dtype=coef_dtype),
                device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        return OperatorLP(
            c=f32(cost.reshape(-1)),
            q=f32(q),
            l=torch.zeros(n_pad * s_pad, dtype=torch.float32, device=device),
            u=f32(u.reshape(-1)),
            ineq_mask=torch.as_tensor(ineq, device=device),
            data=(f32(l), f32(m), f32(cost)),
            structured=structured_op,
        )

    # ------------------------------------------------------------- rounding --
    def _round_repair(self, r: np.ndarray, shards: np.ndarray,
                      servers: np.ndarray,
                      L_target: Optional[float] = None,
                      eps_eff: Optional[float] = None) -> np.ndarray:
        """argmax-round the relaxation then greedily repair load bounds and
        memory caps.  Returns the GLOBAL placement for ``shards``."""
        wl = self.wl
        n_r, s_r = shards.shape[0], servers.shape[0]
        rr = r[:n_r, :s_r]
        pick = rr.argmax(axis=1)
        # keep current server on near-ties (cheap anti-movement bias)
        loc = {int(s): j for j, s in enumerate(servers)}
        cur_local = np.array([loc.get(int(s), -1) for s in wl.placement[shards]])
        for i in range(n_r):
            ci = cur_local[i]
            if ci >= 0 and rr[i, ci] >= rr[i, pick[i]] - 1e-3:
                pick[i] = ci

        load = np.zeros(s_r)
        mem_u = np.zeros(s_r)
        np.add.at(load, pick, wl.load[shards])
        np.add.at(mem_u, pick, wl.mem[shards])
        L_sub = (wl.load[shards].sum() / max(s_r, 1)
                 if L_target is None else L_target)
        eps = wl.eps_frac * wl.target if eps_eff is None else eps_eff
        sl = wl.load[shards]
        sm = wl.mem[shards]

        def load_pass():
            # repeatedly move (or swap) shards to shrink the worst
            # (over, under) pair's deviation; stop when inside the window or
            # no improving move exists.  O(moves * n_sub) — sub-problems are
            # small post-POP, which keeps this cheap (the POP effect again).
            for _ in range(4 * n_r):
                over = int(np.argmax(load))
                under = int(np.argmin(load))
                if load[over] <= L_sub + eps and load[under] >= L_sub - eps:
                    break
                cur_dev = max(load[over] - L_sub, L_sub - load[under])
                members = np.flatnonzero(pick == over)
                if members.size == 0:
                    break
                # direct move over -> under
                fits = mem_u[under] + sm[members] <= wl.cap[servers[under]]
                new_dev = np.maximum(np.abs(load[over] - sl[members] - L_sub),
                                     np.abs(load[under] + sl[members] - L_sub))
                new_dev = np.where(fits, new_dev, np.inf)
                best = int(np.argmin(new_dev + 1e-6 * sm[members]))
                if new_dev[best] < cur_dev - 1e-12:
                    i = members[best]
                    load[over] -= sl[i]; mem_u[over] -= sm[i]
                    pick[i] = under
                    load[under] += sl[i]; mem_u[under] += sm[i]
                    continue
                # swap fallback (handles memory-saturated receivers): trade
                # a hot shard from `over` for a cold shard from `under`
                mu = np.flatnonzero(pick == under)
                if mu.size == 0:
                    break
                d = sl[members][:, None] - sl[mu][None, :]      # load traded
                mem_ok = ((mem_u[under] + sm[members][:, None] - sm[mu][None, :]
                           <= wl.cap[servers[under]]) &
                          (mem_u[over] - sm[members][:, None] + sm[mu][None, :]
                           <= wl.cap[servers[over]]))
                sw_dev = np.maximum(np.abs(load[over] - d - L_sub),
                                    np.abs(load[under] + d - L_sub))
                sw_dev = np.where(mem_ok, sw_dev, np.inf)
                io, iu = np.unravel_index(int(np.argmin(sw_dev)), sw_dev.shape)
                if sw_dev[io, iu] >= cur_dev - 1e-12:
                    break
                i, o = members[io], mu[iu]
                load[over] += sl[o] - sl[i]; mem_u[over] += sm[o] - sm[i]
                load[under] += sl[i] - sl[o]; mem_u[under] += sm[i] - sm[o]
                pick[i], pick[o] = under, over

        def mem_pass():
            # shed from servers over their memory cap; prefer destinations
            # that are load-underloaded so the next load_pass has less to fix
            for _ in range(2 * n_r):
                over_m = int(np.argmax(mem_u - wl.cap[servers]))
                if mem_u[over_m] <= wl.cap[servers[over_m]]:
                    break
                members = np.flatnonzero(pick == over_m)
                if members.size == 0:
                    break
                headroom = wl.cap[servers] - mem_u
                dest = int(np.argmax(np.minimum(headroom, sm[members].max())
                                     - 0.05 * (load - L_sub)))
                fits = sm[members] <= headroom[dest]
                if not fits.any():
                    break
                # move the shard whose LOAD best fills dest's deficit and
                # whose memory fits (memory relief is the loop guarantee)
                deficit = max(L_sub - load[dest], 0.0)
                score = np.where(fits, -np.abs(sl[members] - deficit), -np.inf)
                i = members[int(np.argmax(score))]
                load[over_m] -= sl[i]; mem_u[over_m] -= sm[i]
                pick[i] = dest
                load[dest] += sl[i]; mem_u[dest] += sm[i]

        for _ in range(3):
            load_pass()
            mem_pass()
        load_pass()
        return servers[pick]

    # ------------------------------------------------------------ evaluate --
    def evaluate(self, placement: np.ndarray) -> dict:
        wl = self.wl
        moved = placement != wl.placement
        movement = float(wl.mem[moved].sum())
        load = np.zeros(wl.n_servers)
        np.add.at(load, placement, wl.load)
        mem_u = np.zeros(wl.n_servers)
        np.add.at(mem_u, placement, wl.mem)
        L = wl.target
        eps = wl.eps_frac * L
        return {
            "movement": movement,
            "n_moved": int(moved.sum()),
            "max_load_dev": float(np.abs(load - L).max() / L),
            "load_feasible": bool((np.abs(load - L) <= eps * 1.05).all()),
            "mem_feasible": bool((mem_u <= wl.cap * 1.001).all()),
        }

    # ---------------------------------------------------------------- full --
    def solve_full(self, solver_kw: Optional[dict] = None,
                   warm: Optional["LBResult"] = None,
                   backend: str = "auto", engine: str = "auto",
                   device=None) -> LBResult:
        """Unpartitioned §3.3 baseline, routed through the same
        backend/engine substrate as the POP path (a k=1 stack) on
        ``device`` (default: the CUDA device)."""
        solver_kw = dict(solver_kw or {})
        wl = self.wl
        shards = np.arange(wl.n_shards)
        servers = np.arange(wl.n_servers)
        eps_eff = 0.95 * wl.eps_frac * wl.target
        op = self._relax_op(shards, servers, wl.n_shards, wl.n_servers,
                            L_target=wl.target, eps_eff=eps_eff,
                            device=device)
        t0 = time.perf_counter()
        state = warm.extra.get("full_state") if warm is not None else None
        warm_b = None
        if state is not None and state["x"].shape == tuple(op.c.shape):
            warm_b = (state["x"], state["y"])
        res, backend_name, engine_name = backends_mod.solve_one_ex(
            op, _k_mv, _kt_mv, solver_kw, backend=backend, engine=engine,
            warm=warm_b)
        r = np.asarray(res.x).reshape(wl.n_shards, wl.n_servers)
        placement = self._round_repair(r, shards, servers,
                                       L_target=wl.target, eps_eff=eps_eff)
        dt = time.perf_counter() - t0
        ev = self.evaluate(placement)
        ev["iterations"] = int(res.iterations)
        ev["full_state"] = dict(x=np.asarray(res.x), y=np.asarray(res.y))
        # observability: what actually ran ("auto" resolved) + plan cache
        ev["backend"] = backend_name
        ev["engine"] = engine_name
        ev["plan_cache"] = "full"
        ev["k"] = 1
        return LBResult(placement=placement, movement=ev["movement"],
                        max_load_dev=ev["max_load_dev"],
                        feasible=ev["load_feasible"] and ev["mem_feasible"],
                        solve_time_s=dt, extra=ev)

    # ----------------------------------------------------------------- POP --
    def _pop_split(self, k: int, state: Optional[dict] = None):
        """The POP split of :meth:`pop_solve`: ``(groups, shard_sets,
        s_pad, n_pad, reuse, grouping_kept)`` — the server groups, each
        group's shards, the padded lane shape, and whether the previous
        ``pop_state`` was reused verbatim or its grouping kept."""
        wl = self.wl
        ids = wl.shard_ids()
        reuse = (state is not None and state["k"] == k
                 and state["n_shards"] == wl.n_shards
                 and np.array_equal(
                     state.get("ids", np.arange(state["n_shards"])), ids))
        grouping_kept = False
        if reuse:
            groups = state["groups"]
            shard_sets = state["shard_sets"]
            s_pad = state["s_pad"]
        else:
            if (state is not None and len(state["groups"]) == k
                    and np.array_equal(
                        np.sort(np.concatenate(state["groups"])),
                        np.arange(wl.n_servers))):
                # shard churn over the same server fleet: KEEP the previous
                # server grouping (shards follow their current server, so a
                # stable grouping keeps most surviving shards in their old
                # lane — the analogue of core/plan.py's repair_plan, and
                # what makes the remapped warm start land in an unchanged
                # lane context)
                groups = state["groups"]
                s_pad = state["s_pad"]
                grouping_kept = True
            else:
                # deal servers into k groups by descending current load
                # (stratified)
                cur_load = np.zeros(wl.n_servers)
                np.add.at(cur_load, wl.placement, wl.load)
                order = np.argsort(-cur_load)
                groups = [order[i::k] for i in range(k)]
                s_pad = max(len(g) for g in groups)
            shard_sets = [list(np.flatnonzero(np.isin(wl.placement, g)))
                          for g in groups]

            # §3.3 pre-pass: equalise shard-subset TOTAL loads across groups
            # (these cross-group shards must move anyway — load has to leave
            # overloaded server groups no matter how the sub-LPs come out).
            totals = np.array([wl.load[s].sum() for s in shard_sets])
            targets = np.array([wl.target * len(g) for g in groups])
            tol = 0.005 * wl.target * max(min(len(g) for g in groups), 1)
            for _ in range(wl.n_shards):
                dev = totals - targets
                hi, lo = int(np.argmax(dev)), int(np.argmin(dev))
                if (dev[hi] <= tol and -dev[lo] <= tol) or not shard_sets[hi]:
                    break
                cands = shard_sets[hi]
                loads = wl.load[cands]
                # any move that shrinks the (hi, lo) pair's worst deviation
                cur = max(dev[hi], -dev[lo])
                new_pair = np.maximum(np.abs(dev[hi] - loads),
                                      np.abs(dev[lo] + loads))
                pick = int(np.argmin(new_pair))
                if new_pair[pick] >= cur - 1e-12:
                    break                  # no improving transfer exists
                shard = cands.pop(pick)
                shard_sets[lo].append(shard)
                totals[hi] -= wl.load[shard]
                totals[lo] += wl.load[shard]

            shard_sets = [np.asarray(s, np.int64) for s in shard_sets]
        n_pad = max(len(s) for s in shard_sets)
        return groups, shard_sets, s_pad, n_pad, reuse, grouping_kept

    def _sub_windows(self, shard_sets, groups) -> list:
        """Each sub-problem's load window: tightened by its residual
        total-load deviation so sub-feasible implies globally-feasible."""
        wl = self.wl
        L = wl.target
        eps = wl.eps_frac * L
        sub_eps = []
        for s, g in zip(shard_sets, groups):
            dev = abs(wl.load[s].sum() / max(len(g), 1) - L)
            sub_eps.append(float(np.clip(0.95 * eps - dev, 0.25 * eps, eps)))
        return sub_eps

    def pop_solve(self, k: int, seed: int = 0,
                  solver_kw: Optional[dict] = None,
                  backend: str = "auto", engine: str = "auto",
                  warm: Optional["LBResult"] = None,
                  warm_start: bool = True, device=None) -> LBResult:
        """Domain-aware POP: server groups (round-robin by load), shards
        follow their current server; batched PDHG map step through the
        ``core/backends.py`` registry on ``device`` (default: the CUDA
        device); per-sub round+repair reduce.

        ``warm`` re-solves an updated workload from a previous POP
        ``LBResult`` (online path).  While the shard population is stable
        the previous server grouping and shard subsets are reused so the
        stacked sub-LPs keep their shapes, and every lane starts from its
        previous PDHG iterates.  Across churn (shards arrived/departed —
        matched via ``ShardWorkload.ids`` — or a k change) the grouping is
        recomputed and the old iterates are REMAPPED: each surviving
        shard's distribution row follows it to its new (lane, row),
        restricted to the server columns its old and new lanes share;
        per-server dual rows move with their server, per-shard assign rows
        with their shard; lanes that matched nothing start cold
        (``extra["warm_fraction"]`` reports the matched share).
        ``warm_start=False`` reuses only the grouping (the cold control of
        a warm re-solve)."""
        solver_kw = dict(solver_kw or {})
        wl = self.wl
        ids = wl.shard_ids()
        state = warm.extra.get("pop_state") if warm is not None else None
        groups, shard_sets, s_pad, n_pad, reuse, grouping_kept = \
            self._pop_split(k, state)

        t0 = time.perf_counter()
        L = wl.target
        sub_eps = self._sub_windows(shard_sets, groups)
        ops = [self._relax_op(s, g, n_pad, s_pad, L_target=L, eps_eff=e,
                              device=device)
               for s, g, e in zip(shard_sets, groups, sub_eps)]
        batched = pdhg.stack_ops(ops)
        warm_xy = None
        warm_fraction = None
        if warm_start and state is not None:
            if reuse and state["x"].shape == tuple(batched.c.shape):
                warm_xy = (state["x"], state["y"])
                warm_fraction = 1.0
            else:
                warm_xy, warm_fraction = _remap_lb_state(
                    state, ids, groups, shard_sets, n_pad, s_pad)
        backend_name, engine_run, _ = backends_mod.resolve_exec(
            batched, _k_mv, _kt_mv, backend, engine)
        res = backends_mod.solve_map(batched, _k_mv, _kt_mv, solver_kw,
                                     backend=backend_name, engine=engine_run,
                                     warm=warm_xy)
        # the solver hands back numpy iterates: one host copy of the whole
        # stack, sliced per lane here
        x_all = np.asarray(res.x)
        placement = wl.placement.copy()
        for i, (s, g) in enumerate(zip(shard_sets, groups)):
            r = x_all[i].reshape(n_pad, s_pad)
            placement[s] = self._round_repair(r, s, g, L_target=L,
                                              eps_eff=sub_eps[i])
        dt = time.perf_counter() - t0
        ev = self.evaluate(placement)
        ev["iterations"] = int(np.asarray(res.iterations).sum())
        ev["warm_fraction"] = warm_fraction
        # observability: what actually ran + how the previous grouping was
        # reused ("hit" = verbatim, "repair" = server grouping kept across
        # shard churn, "miss" = fresh grouping)
        ev["backend"] = backend_name
        ev["engine"] = pdhg.engine_name(engine_run)
        ev["plan_cache"] = ("hit" if reuse
                            else "repair" if grouping_kept else "miss")
        ev["k"] = k
        ev["pop_state"] = dict(
            k=k, n_shards=wl.n_shards, ids=ids, groups=groups,
            shard_sets=shard_sets, s_pad=s_pad, n_pad=n_pad,
            x=x_all, y=np.asarray(res.y))
        return LBResult(placement=placement, movement=ev["movement"],
                        max_load_dev=ev["max_load_dev"],
                        feasible=ev["load_feasible"] and ev["mem_feasible"],
                        solve_time_s=dt, extra=ev)


# ---------------------------------------------------------------------------
# churn-aware warm-start remap (domain-specific analogue of core/plan.py's
# remap_warm: the LB split is over SERVER GROUPS, so both axes of the
# distribution matrix have identity that must be followed across plans)
# ---------------------------------------------------------------------------

def _remap_lb_state(state: dict, ids: np.ndarray, groups, shard_sets,
                    n_pad: int, s_pad: int):
    """Scatter a previous pop_state's iterates onto a new grouping.

    x[i] is a [n_pad, s_pad] distribution of lane i's shards over lane i's
    servers: a surviving shard's row follows it to its new (lane, row) and
    each entry follows its server's column — copied only for servers the
    shard's old and new lanes share (the shard followed its current server,
    so in the common case that is most of the row).  y rows:
    [load<= (s_pad), -load<= (s_pad), mem<= (s_pad), assign== (n_pad)] —
    the three per-server blocks move with their server, assign rows with
    their shard.  ARRIVED shards have no previous row: their distribution
    starts at zero with the population-mean assign dual (a dual-only warm
    start; seeding their primal — e.g. one-hot on the current server — was
    measured WORSE at low churn, where the injected mass forces large dual
    corrections in an otherwise converged lane).  Lanes that matched no
    shard start cold via the mask.  Returns (WarmStart, warm_fraction).
    """
    k_o = state["k"]
    s_pad_o = state["s_pad"]
    x_o = np.asarray(state["x"], np.float32)
    n_pad_o = x_o.shape[1] // s_pad_o
    x_o = x_o.reshape(k_o, n_pad_o, s_pad_o)
    y_o = np.asarray(state["y"], np.float32)
    old_ids = state.get("ids", np.arange(state["n_shards"]))

    shard_pos = {}
    for o, ss in enumerate(state["shard_sets"]):
        for r, g in enumerate(np.asarray(ss)):
            shard_pos[old_ids[g]] = (o, r)
    srv_pos = {}
    for o, gg in enumerate(state["groups"]):
        for j, srv in enumerate(np.asarray(gg)):
            srv_pos[int(srv)] = (o, j)

    # population-mean assign dual: the dual-only prior for arrived shards
    assign_duals = [y_o[o, 3 * s_pad_o + r]
                    for o, ss in enumerate(state["shard_sets"])
                    for r in range(len(np.asarray(ss)))]
    avg_assign = float(np.mean(assign_duals)) if assign_duals else 0.0

    k = len(groups)
    x_w = np.zeros((k, n_pad, s_pad), np.float32)
    y_w = np.zeros((k, 3 * s_pad + n_pad), np.float32)
    mask = np.zeros(k, bool)
    matched = 0
    live = 0
    for i, (ss, gg) in enumerate(zip(shard_sets, groups)):
        gg = np.asarray(gg)
        for j, srv in enumerate(gg):
            hit = srv_pos.get(int(srv))
            if hit is not None:
                o, j_old = hit
                for blk in range(3):
                    y_w[i, blk * s_pad + j] = y_o[o, blk * s_pad_o + j_old]
        for r, g in enumerate(np.asarray(ss)):
            live += 1
            hit = shard_pos.get(ids[g])
            if hit is None:
                y_w[i, 3 * s_pad + r] = avg_assign   # arrived: dual-only
                continue
            o, r_old = hit
            matched += 1
            mask[i] = True
            y_w[i, 3 * s_pad + r] = y_o[o, 3 * s_pad_o + r_old]
            for j, srv in enumerate(gg):
                sh = srv_pos.get(int(srv))
                if sh is not None and sh[0] == o:
                    x_w[i, r, j] = x_o[o, r_old, sh[1]]
    warm_fraction = matched / max(live, 1)
    ws = plan_mod.WarmStart(
        x_w.reshape(k, -1), y_w, mask,
        dict(warm_fraction=warm_fraction, matched=matched,
             fresh=live - matched, lanes_cold=int((~mask).sum()),
             identity=False))
    return ws, warm_fraction


# ---------------------------------------------------------------------------
# shared placement entry point
# ---------------------------------------------------------------------------

def balance_placement(load: np.ndarray, n_targets: int,
                      current: Optional[np.ndarray] = None, *,
                      cap: Optional[np.ndarray] = None,
                      eps_frac: float = 0.2, pop_k: int = 4, seed: int = 0,
                      backend: str = "auto", engine: str = "auto",
                      solver_kw: Optional[dict] = None,
                      warm: Optional[LBResult] = None,
                      shard_ids: Optional[np.ndarray] = None,
                      device=None) -> LBResult:
    """Place ``load``-weighted shards onto ``n_targets`` via the §3.3 MILP
    on ``device`` (default: the CUDA device).

    The one entry point for every "shards onto servers" use: default
    sticky placement, uniform memory, the shared k_eff heuristic, and the
    POP-vs-full branch live here once.  ``backend`` names a map-step
    backend, ``engine`` a PDHG step engine (``core/backends.py`` /
    ``core/pdhg.py``).  ``warm`` chains repeated balancing calls: pass the
    previous ``LBResult`` to warm-start the re-solve when loads drift; with
    ``shard_ids`` (stable external ids) the warm start survives shard
    arrivals and departures too — surviving shards are matched by id and
    their iterates remapped onto the new grouping.
    """
    load = np.asarray(load, np.float64)
    n = load.shape[0]
    if current is None:
        current = np.arange(n) % n_targets
    if cap is None:
        cap = np.full(n_targets, float(n))
    wl = ShardWorkload(load=load, mem=np.ones(n),
                       placement=np.asarray(current, np.int64),
                       cap=cap, eps_frac=eps_frac, ids=shard_ids)
    prob = LoadBalanceProblem(wl)
    k_eff = max(1, min(pop_k, n_targets // 2))
    if k_eff > 1:
        return prob.pop_solve(k_eff, seed=seed, solver_kw=solver_kw,
                              backend=backend, engine=engine, warm=warm,
                              device=device)
    return prob.solve_full(solver_kw=solver_kw, warm=warm, device=device)


# ---------------------------------------------------------------------------
# E-Store greedy baseline
# ---------------------------------------------------------------------------

def estore_greedy(wl: ShardWorkload) -> np.ndarray:
    """E-Store's single-tier greedy: repeatedly move the hottest shard from
    the most-loaded server to the least-loaded one until within tolerance."""
    placement = wl.placement.copy()
    load = np.zeros(wl.n_servers)
    np.add.at(load, placement, wl.load)
    mem_u = np.zeros(wl.n_servers)
    np.add.at(mem_u, placement, wl.mem)
    L = wl.target
    eps = wl.eps_frac * L
    by_server = [list(np.flatnonzero(placement == j)) for j in range(wl.n_servers)]
    for j in range(wl.n_servers):
        by_server[j].sort(key=lambda i: wl.load[i])
    for _ in range(10 * wl.n_shards):
        over = int(np.argmax(load))
        if load[over] <= L + eps:
            break
        if not by_server[over]:
            break
        i = by_server[over].pop()              # hottest shard there
        under = int(np.argmin(load + 1e12 * (mem_u + wl.mem[i] > wl.cap)))
        if load[under] + wl.load[i] > load[over] - 1e-12:
            break                              # no improving move left
        placement[i] = under
        load[over] -= wl.load[i]; load[under] += wl.load[i]
        mem_u[over] -= wl.mem[i]; mem_u[under] += wl.mem[i]
        by_server[under].append(i)
        by_server[under].sort(key=lambda q: wl.load[q])
    return placement
