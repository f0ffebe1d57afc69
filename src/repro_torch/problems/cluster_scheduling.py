"""Gavel-style heterogeneous cluster scheduling (paper §3.1) — the port of
``repro/problems/cluster_scheduling.py``.

Max-min fair allocation of heterogeneous accelerators to jobs, epigraph
form (PDHG solves (X, t) jointly):

    maximize t
    s.t.     t <= scale_m * sum_{c∋m, j} T[c, j, slot_m] X[c, j]   ∀ jobs m
             sum_{c∋m, j} X[c, j] <= 1                             ∀ jobs m
             sum_c z_c X[c, j] <= num_workers_j * frac             ∀ types j
             0 <= X <= 1

Workload generation, combo construction, the COO of the structured
operator and the heuristic baseline are the reference's numpy code; the
per-lane matvecs ``_k_mv``/``_kt_mv`` are torch, with ``index_add_`` where
the reference calls ``jax.ops.segment_sum``.  Without space sharing every
sub-LP carries :class:`~repro_torch.core.pdhg.StructuredOperator` metadata,
which is what routes the solve through the structured kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.pdhg import OperatorLP, structured_from_coo
from ..core.plan import SubLayout
from ..core.pop import POPProblem


@dataclasses.dataclass
class ClusterWorkload:
    T: np.ndarray            # [n_jobs, n_types] raw throughputs
    w: np.ndarray            # [n_jobs] priorities
    z: np.ndarray            # [n_jobs] workers requested
    num_workers: np.ndarray  # [n_types]
    interference: np.ndarray  # [n_jobs] space-sharing throughput retention in (0,1]
    job_type: np.ndarray     # [n_jobs] int label (for clustered partitions)


def make_cluster_workload(n_jobs: int, num_workers=(256, 256, 256),
                          seed: int = 0) -> ClusterWorkload:
    """Synthetic Gavel-like workload: job archetypes with distinct
    speedup profiles across 3 accelerator generations (V100/P100/K80-ish)."""
    rng = np.random.default_rng(seed)
    archetypes = np.array([
        # relative throughput on [v100, p100, k80]
        [1.00, 0.45, 0.25],   # attention-heavy
        [1.00, 0.60, 0.35],   # conv-heavy
        [1.00, 0.80, 0.60],   # small model / input-bound
        [1.00, 0.35, 0.10],   # tensor-core-dependent
    ])
    jt = rng.integers(0, len(archetypes), n_jobs)
    base = rng.lognormal(0.0, 0.5, n_jobs)[:, None]
    T = archetypes[jt] * base * rng.uniform(0.9, 1.1, (n_jobs, 3))
    w = rng.choice([1.0, 2.0, 4.0], n_jobs, p=[0.7, 0.2, 0.1])
    z = np.ones(n_jobs)
    interference = rng.uniform(0.55, 0.95, n_jobs)
    return ClusterWorkload(T=T, w=w, z=z,
                           num_workers=np.asarray(num_workers, np.float64),
                           interference=interference, job_type=jt)


# ---------------------------------------------------------------------------
# operator matvecs (per lane)
# ---------------------------------------------------------------------------

def _k_mv(data, x):
    """K x for the epigraph LP.  Layout of x: [X_flat (C*R), t]; rows:
    [epigraph (n), time (n), workers (R)].  ``seg`` carries the job count
    in its shape (n_jobs + 1)."""
    S, member, z, seg = data             # S: [C, R, 2] scaled T; member: [C, 2]
    n_jobs = seg.shape[0] - 1
    C, R, _ = S.shape
    X = x[: C * R].reshape(C, R)
    t = x[C * R]
    seg_ids = member.reshape(-1).long()
    contrib = torch.einsum("crs,cr->cs", S, X)            # [C, 2]
    thpt = torch.zeros(n_jobs + 1, dtype=x.dtype, device=x.device).index_add_(
        0, seg_ids, contrib.reshape(-1))[:n_jobs]
    time_c = X.sum(dim=1)                                 # [C]
    occ = time_c[:, None].expand(member.shape).reshape(-1)
    time = torch.zeros(n_jobs + 1, dtype=x.dtype, device=x.device).index_add_(
        0, seg_ids, occ)[:n_jobs]
    workers = (z[:, None] * X).sum(dim=0)                 # [R]
    return torch.cat([t - thpt, time, workers])


def _kt_mv(data, y):
    """K^T y.  y layout: [y_ep (n), y_time (n), y_work (R)]."""
    S, member, z, seg = data
    n_jobs = seg.shape[0] - 1
    C, R, _ = S.shape
    y_ep = y[:n_jobs]
    y_time = y[n_jobs: 2 * n_jobs]
    y_work = y[2 * n_jobs: 2 * n_jobs + R]
    pad = torch.zeros(1, dtype=y.dtype, device=y.device)
    m = member.long()
    ep_m = torch.cat([y_ep, pad])[m]                      # [C, 2]
    tm_m = torch.cat([y_time, pad])[m]                    # [C, 2]
    gX = (-torch.einsum("crs,cs->cr", S, ep_m)
          + tm_m.sum(dim=1)[:, None]
          + z[:, None] * y_work[None, :])
    gt = y_ep.sum()
    return torch.cat([gX.reshape(-1), gt[None]])


def _host(a) -> np.ndarray:
    return a.numpy(force=True) if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# POP problem
# ---------------------------------------------------------------------------

class GavelProblem(POPProblem):
    """Max-min fair scheduling, POP-partitioned over JOBS."""

    K_mv = staticmethod(_k_mv)
    KT_mv = staticmethod(_kt_mv)

    def __init__(self, wl: ClusterWorkload, space_sharing: bool = False,
                 leftover_bonus: float = 0.05, coef_dtype: str = "float32"):
        self.wl = wl
        self.space_sharing = space_sharing
        self.n_entities = wl.T.shape[0]
        self.n_types = wl.T.shape[1]
        self.coef_dtype = coef_dtype
        self.scale = 1.0 / (wl.w * wl.T.max(axis=1))
        # secondary water-filling term: after the min is maximised, spend
        # leftover capacity on mean throughput (objective stays linear)
        self.leftover_bonus = leftover_bonus

    # --- partitioning hooks -------------------------------------------------
    def entity_attrs(self):
        return np.concatenate([
            self.wl.T * self.scale[:, None],
            self.wl.w[:, None], self.wl.z[:, None],
        ], axis=1)

    def entity_scores(self):
        return self.wl.w * self.wl.z

    def sub_layout(self, n_slots: int) -> SubLayout:
        """Warm-start remap layout: slot ``s`` owns X[s, :] and its
        epigraph/time rows; ``t`` and the worker rows are lane-global."""
        R = self.n_types
        C = n_slots
        if self.space_sharing:
            C += n_slots * (n_slots - 1) // 2
        x_slot = np.arange(n_slots)[:, None] * R + np.arange(R)[None, :]
        y_slot = np.stack([np.arange(n_slots), n_slots + np.arange(n_slots)],
                          axis=1)
        return SubLayout(x_slot=x_slot, y_slot=y_slot,
                         x_global=np.array([C * R]),
                         y_global=2 * n_slots + np.arange(R))

    # --- combo construction -------------------------------------------------
    def _combos(self, ids: np.ndarray):
        """Singleton + (if space sharing) within-subset pair combos."""
        n = ids.shape[0]
        singles = np.stack([ids, np.full(n, -1)], axis=1)
        if not self.space_sharing:
            return singles
        iu, ju = np.triu_indices(n, k=1)
        pairs = np.stack([ids[iu], ids[ju]], axis=1)
        dead = (pairs < 0).any(axis=1)
        pairs[dead] = -1
        return np.concatenate([singles, pairs], axis=0)

    def _structured(self, S: np.ndarray, member: np.ndarray, z: np.ndarray,
                    n_local: int):
        """ELL index metadata for the singleton-combo operator (the
        reference's COO, packed by ``structured_from_coo``)."""
        C, R, _ = S.shape
        n = n_local
        mem = np.broadcast_to(member[:, None, :], (C, R, 2))
        xcol = np.broadcast_to(
            (np.arange(C)[:, None] * R + np.arange(R)[None, :])[:, :, None],
            (C, R, 2))
        valid = mem < n                               # dump slot = n
        # epigraph rows: +1 on t, -S[c, r, s] on each member's X entries
        rows = [np.arange(n), mem[valid], n + mem[valid]]
        cols = [np.full(n, C * R), xcol[valid], xcol[valid]]
        vals = [np.ones(n), -S[valid], np.ones(int(valid.sum()))]
        # worker rows: z_c on X[c, r]
        live = np.broadcast_to((z != 0)[:, None], (C, R))
        rows.append((2 * n + np.broadcast_to(np.arange(R)[None, :],
                                             (C, R)))[live])
        cols.append((np.arange(C)[:, None] * R
                     + np.arange(R)[None, :])[live])
        vals.append(np.broadcast_to(z[:, None], (C, R))[live])
        return structured_from_coo(
            np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            2 * n + R, C * R + 1, coef_dtype=self.coef_dtype)

    def _build(self, combos_global: np.ndarray, local_of, n_local: int,
               frac: float, scale_vec: Optional[np.ndarray]) -> OperatorLP:
        wl = self.wl
        C = combos_global.shape[0]
        R = self.n_types
        S = np.zeros((C, R, 2))
        member = np.full((C, 2), n_local, np.int64)       # dump slot
        z = np.zeros(C)
        valid0 = combos_global[:, 0] >= 0
        g0 = np.maximum(combos_global[:, 0], 0)
        g1 = np.maximum(combos_global[:, 1], 0)
        is_pair = combos_global[:, 1] >= 0

        S[valid0, :, 0] = (wl.T[g0] * self.scale[g0, None])[valid0]
        member[valid0, 0] = local_of(combos_global[valid0, 0])
        inter = np.sqrt(wl.interference[g0] * wl.interference[g1])
        S[is_pair, :, 0] *= inter[is_pair, None]
        S[is_pair, :, 1] = (wl.T[g1] * self.scale[g1, None] *
                            inter[:, None])[is_pair]
        member[is_pair, 1] = local_of(combos_global[is_pair, 1])
        z[valid0] = wl.z[g0][valid0]                      # pairs share workers

        n_var = C * R + 1
        c = np.zeros(n_var); c[-1] = -1.0                 # max t
        c[: C * R] = -(self.leftover_bonus / max(n_local, 1)) * S.sum(axis=2).reshape(-1)
        l = np.zeros(n_var)
        u = np.zeros(n_var)
        u[: C * R] = np.repeat(valid0.astype(np.float64), R)
        u[-1] = 10.0
        time_rhs = (np.ones(n_local) if scale_vec is None
                    else np.asarray(scale_vec, np.float64))
        q = np.concatenate([
            np.zeros(n_local),                            # epigraph rows
            time_rhs,                                     # time rows
            wl.num_workers * frac,                        # worker rows
        ])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        data = (f32(S), torch.as_tensor(member.astype(np.int32)), f32(z),
                torch.zeros(n_local + 1, dtype=torch.float32))
        structured = (None if self.space_sharing
                      else self._structured(S, member, z, n_local))
        return OperatorLP(
            c=f32(c), q=f32(q), l=f32(l), u=f32(u),
            ineq_mask=torch.ones(q.shape[0], dtype=torch.bool), data=data,
            structured=structured)

    def build_sub(self, idx_row: np.ndarray, frac: float,
                  scale: Optional[np.ndarray] = None) -> OperatorLP:
        n_local = idx_row.shape[0]
        lut = np.full(self.n_entities + 1, n_local, np.int64)
        valid = idx_row >= 0
        lut[idx_row[valid]] = np.flatnonzero(valid)
        local_of = lambda g: lut[g]
        combos = self._combos(idx_row)
        return self._build(combos, local_of, n_local, frac, scale)

    # --- solution handling ----------------------------------------------------
    def extract(self, op: OperatorLP, x: np.ndarray, idx_row: np.ndarray):
        """Per-job normalised effective throughput rho_m."""
        S, member, z, seg = (_host(a) for a in op.data)
        n_local = seg.shape[0] - 1
        C, R, _ = S.shape
        X = np.asarray(x)[: C * R].reshape(C, R)
        contrib = np.einsum("crs,cr->cs", S, X)
        thpt = np.zeros(n_local + 1)
        np.add.at(thpt, member.reshape(-1), contrib.reshape(-1))
        return thpt[: idx_row.shape[0]]

    def evaluate(self, rho: np.ndarray) -> dict:
        return {
            "mean_norm_throughput": float(rho.mean()),
            "min_norm_throughput": float(rho.min()),
            "p10_norm_throughput": float(np.percentile(rho, 10)),
        }


# ---------------------------------------------------------------------------
# heuristic baseline (Gandiva-like introspective packing)
# ---------------------------------------------------------------------------

def gandiva_heuristic(wl: ClusterWorkload, space_sharing: bool = True,
                      seed: int = 0) -> np.ndarray:
    """Greedy affinity + opportunistic pair-packing, Gandiva-style; returns
    per-job normalised effective throughput (same metric as
    ``GavelProblem.extract``)."""
    rng = np.random.default_rng(seed)
    n, R = wl.T.shape
    scale = 1.0 / (wl.w * wl.T.max(axis=1))
    order = rng.permutation(n)
    assign = np.zeros(n, np.int64)
    count = np.zeros(R)
    for m in order:
        prefs = np.argsort(-wl.T[m])
        load = count[prefs] / wl.num_workers[prefs]
        pick = prefs[int(np.argmin(load + np.arange(R) * 0.05))]
        assign[m] = pick
        count[pick] += wl.z[m]

    rho = np.zeros(n)
    for j in range(R):
        members = np.flatnonzero(assign == j)
        if members.size == 0:
            continue
        cap = wl.num_workers[j]
        if space_sharing and members.size > cap:
            members_sorted = members[np.argsort(-wl.interference[members])]
            n_pairs = min(int(members.size - cap), members.size // 2)
            paired = members_sorted[: 2 * n_pairs]
            alone = members_sorted[2 * n_pairs:]
            eff_units = n_pairs + alone.size
            share = min(1.0, cap / max(eff_units, 1))
            inter = wl.interference[paired]
            rho[paired] = wl.T[paired, j] * scale[paired] * share * inter
            rho[alone] = wl.T[alone, j] * scale[alone] * share
        else:
            share = min(1.0, cap / members.size)
            rho[members] = wl.T[members, j] * scale[members] * share
    return rho
