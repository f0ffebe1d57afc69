"""MoE expert placement — the port of ``repro/domains/moe_placement.py``:
the fourth scenario, onboarded through the domain registry ALONE — no
:class:`~repro_torch.core.pop.POPProblem` subclass, no bespoke pipeline;
just the declarative hooks below driving the generic ``plan -> build ->
solve -> reduce`` stages.

Experts are entities, devices are resources.  The serving fleet is
OVERLOADED (routed gate load exceeds aggregate device compute — the hot
phase an MoE placer actually gets called in), so the objective is the
paper's extensive kind: place experts onto devices to maximise the gate
load actually SERVED under per-device compute and memory caps, with a
small migration penalty keeping placements sticky (expert weights are
large; migrations stall serving):

    maximize   sum_{e,d} (load_e - lam * m_e * [d != cur_e]) x_{e,d}
    s.t.       sum_e load_e x_{e,d} <= C_d      ∀ devices d  (compute)
               sum_e m_e    x_{e,d} <= M_d     ∀ devices d  (memory)
               sum_d x_{e,d} <= 1              ∀ experts e  (served once)
               0 <= x <= 1    (+ rounding & greedy repair)

POP split (the paper's recipe, same shape as traffic §3.2): EXPERTS are
partitioned into k load-stratified subsets; every sub-problem keeps ALL
devices with a 1/k slice of the compute and memory caps, so sub-feasible
solutions sum to a globally feasible one.  The demand vector comes from
the router's gate statistics (:func:`repro_torch.models.moe.
expert_gate_load`).

The constraint operator is the same dense [n, D] block as load balancing
(§3.3), so the domain reuses those matvecs verbatim — same function
identity, same memoized ``matvec`` engine (their ``preferred_engine``),
same dispatcher key.  The instance draw, the rounding and repair,
``evaluate`` and the greedy are the reference's numpy code, verbatim, so
the same seeds give bit-equal arrays; ``_build_sub`` returns f32 CPU
tensors, which the pipeline stacks and moves to the session's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from ..core.config import ExecConfig, SolveConfig
from ..core.pdhg import OperatorLP
from ..core.plan import SubLayout
from ..problems.load_balancing import _k_mv, _kt_mv
from .base import DomainSpec
from .registry import register


@dataclasses.dataclass
class MoEPlacementInstance:
    """One placement tick: the expert fleet as routed right now."""

    load: np.ndarray                      # [E] routing load (gate stats)
    mem: np.ndarray                       # [E] expert weight memory
    current: np.ndarray                   # [E] current device of each expert
    cap: np.ndarray                       # [D] device memory capacity
    compute: np.ndarray                   # [D] device compute capacity (load units)
    move_penalty: float = 0.05            # lam: served-load cost per moved mem unit
    # stable expert ids (None = positional): lets warm starts survive
    # experts being added/retired between ticks
    ids: Optional[np.ndarray] = None

    @property
    def n_experts(self) -> int:
        return self.load.shape[0]

    @property
    def n_devices(self) -> int:
        return self.cap.shape[0]


def make_placement_instance(n_experts: int, n_devices: int, *,
                            skew: float = 1.2, overload: float = 1.25,
                            seed: int = 0) -> MoEPlacementInstance:
    """Synthetic instance: Zipf-ish gate loads (a few hot experts — the
    usual router pathology), near-uniform expert memory, a load-oblivious
    current placement, and aggregate compute ``1/overload`` of the routed
    load (the overloaded phase a placer is called in)."""
    rng = np.random.default_rng(seed)
    load = np.minimum(rng.zipf(skew + 1.0, n_experts), 50.0).astype(np.float64)
    load += rng.uniform(0, 1, n_experts)
    mem = rng.uniform(0.8, 1.2, n_experts)
    current = rng.permutation(n_experts) % n_devices
    cap = np.full(n_devices, 2.0 * mem.sum() / n_devices)
    compute = np.full(n_devices, load.sum() / overload / n_devices)
    return MoEPlacementInstance(load=load, mem=mem, current=current,
                                cap=cap, compute=compute)


# ---------------------------------------------------------------------------
# declarative hooks
# ---------------------------------------------------------------------------

def _entity_attrs(inst: MoEPlacementInstance) -> np.ndarray:
    return np.stack([inst.load, inst.mem], axis=1)


def _build_sub(inst: MoEPlacementInstance, idx_row: np.ndarray, frac: float,
               scale: Optional[np.ndarray] = None) -> OperatorLP:
    """Sub-LP over expert subset ``idx_row`` (-1 padded): all D devices at
    a 1/k slice of the compute/memory caps — sub caps sum exactly to the
    full-problem caps, so sub-feasible implies globally feasible."""
    D = inst.n_devices
    n_pad = idx_row.shape[0]
    valid = idx_row >= 0
    g = np.maximum(idx_row, 0)
    load = np.where(valid, inst.load[g], 0.0)
    if scale is not None:                      # §4.3 replication scales demand
        load = load * np.asarray(scale, np.float64)
    mem = np.where(valid, inst.mem[g], 0.0)

    # value of serving expert e on device d: its load, minus the sticky
    # migration penalty off its current device (minimize -> c = -value)
    value = np.broadcast_to(load[:, None], (n_pad, D)).copy()
    penalty = inst.move_penalty * mem
    value -= penalty[:, None]
    value[np.flatnonzero(valid), inst.current[g[valid]]] += penalty[valid]
    value[~valid] = 0.0

    q = np.concatenate([
        inst.compute * frac,                   # load served <= compute/k
        np.zeros(D),                           # (-load <= 0: inactive row
                                               #  of the shared operator)
        inst.cap * frac,                       # mem <= cap/k
        np.where(valid, 1.0, 0.0),             # served at most once
    ])
    ineq = np.ones(q.shape[0], bool)           # ALL rows are <=
    u = np.zeros((n_pad, D))
    u[valid] = 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return OperatorLP(
        c=f32(-value.reshape(-1)),
        q=f32(q),
        l=torch.zeros(n_pad * D, dtype=torch.float32),
        u=f32(u.reshape(-1)),
        ineq_mask=torch.as_tensor(ineq),
        data=(f32(load), f32(mem), f32(-value)),
    )


def _sub_layout(inst: MoEPlacementInstance, n_slots: int) -> SubLayout:
    """Warm-start remap layout: slot ``s`` owns its distribution row
    x[s, :] and its served-once dual row; the 3D per-device rows are
    lane-global."""
    D = inst.n_devices
    return SubLayout(
        x_slot=np.arange(n_slots)[:, None] * D + np.arange(D)[None, :],
        y_slot=(3 * D + np.arange(n_slots))[:, None],
        x_global=np.empty(0, np.int64),
        y_global=np.arange(3 * D))


def _extract(inst: MoEPlacementInstance, op: OperatorLP, x: np.ndarray,
             idx_row: np.ndarray) -> np.ndarray:
    D = inst.n_devices
    return x[: idx_row.shape[0] * D].reshape(-1, D)


def _round(inst: MoEPlacementInstance, r: np.ndarray) -> np.ndarray:
    """Round the coalesced [E, D] distribution to a placement: argmax with
    a sticky tie bias (experts the LP left unserved stay where they are —
    their load is queued, not their weights), then greedily repair memory
    caps and shift load from saturated to starved devices while it
    increases the served total."""
    E, D = inst.n_experts, inst.n_devices
    r = np.asarray(r)[:E]
    pick = r.argmax(axis=1)
    best = r[np.arange(E), pick]
    cur = r[np.arange(E), inst.current]
    keep = (cur >= best - 1e-3) | (best < 1e-6)
    pick = np.where(keep, inst.current, pick)

    load = np.zeros(D)
    mem_u = np.zeros(D)
    np.add.at(load, pick, inst.load)
    np.add.at(mem_u, pick, inst.mem)

    # memory pass: shed from over-cap devices to the emptiest that fits
    for _ in range(2 * E):
        over = int(np.argmax(mem_u - inst.cap))
        if mem_u[over] <= inst.cap[over]:
            break
        members = np.flatnonzero(pick == over)
        if members.size == 0:
            break
        dest = int(np.argmin(mem_u / inst.cap))
        fits = inst.mem[members] <= inst.cap[dest] - mem_u[dest]
        if dest == over or not fits.any():
            break
        e = members[np.flatnonzero(fits)[0]]
        pick[e] = dest
        load[over] -= inst.load[e]; load[dest] += inst.load[e]
        mem_u[over] -= inst.mem[e]; mem_u[dest] += inst.mem[e]

    # served pass: move load from saturated devices into starved compute
    # while the move strictly increases the served total
    for _ in range(4 * E):
        surplus = load - inst.compute
        over = int(np.argmax(surplus))
        under = int(np.argmin(surplus))
        if surplus[over] <= 0 or surplus[under] >= 0:
            break
        members = np.flatnonzero(pick == over)
        if members.size == 0:
            break
        deficit = -surplus[under]
        gain = (np.minimum(inst.load[members], deficit)
                - np.maximum(inst.load[members] - surplus[over], 0.0))
        fits = mem_u[under] + inst.mem[members] <= inst.cap[under]
        gain = np.where(fits, gain, -np.inf)
        best_i = int(np.argmax(gain))
        if gain[best_i] <= 1e-9:
            break
        e = members[best_i]
        pick[e] = under
        load[over] -= inst.load[e]; load[under] += inst.load[e]
        mem_u[over] -= inst.mem[e]; mem_u[under] += inst.mem[e]
    return pick


def _evaluate(inst: MoEPlacementInstance, placement: np.ndarray) -> dict:
    placement = np.asarray(placement, np.int64)
    moved = placement != inst.current
    load = np.zeros(inst.n_devices)
    mem_u = np.zeros(inst.n_devices)
    np.add.at(load, placement, inst.load)
    np.add.at(mem_u, placement, inst.mem)
    served = float(np.minimum(load, inst.compute).sum())
    movement = float(inst.mem[moved].sum())
    return {
        "served": served,
        "served_fraction": served / float(inst.load.sum()),
        "movement": movement,
        "n_moved": int(moved.sum()),
        "compute_util": served / float(inst.compute.sum()),
        "mem_feasible": bool((mem_u <= inst.cap * 1.001).all()),
        # the bench/acceptance objective: served gate load net of the
        # sticky migration penalty (maximise)
        "objective": served - inst.move_penalty * movement,
    }


SPEC = register(DomainSpec(
    name="moe_placement",
    instance_types=(MoEPlacementInstance,),
    describe="MoE expert placement (experts onto devices: maximise served "
             "gate load under compute + memory caps)",
    n_entities=lambda inst: inst.n_experts,
    entity_attrs=_entity_attrs,
    entity_scores=lambda inst: inst.load,
    build_sub=_build_sub,
    K_mv=_k_mv,                  # the §3.3 dense-block operator, verbatim —
    KT_mv=_kt_mv,                # same function identity = shared engines
    sub_layout=_sub_layout,
    extract=_extract,
    entity_ids=lambda inst: inst.ids,
    round=_round,
    evaluate=_evaluate,
    # the SLO tuner's quality scalar (repro_torch.tuning): served gate load —
    # strictly positive, unlike the movement-penalized objective, so
    # relative quality ratios stay meaningful
    quality=lambda m: m["served"],
    # degradation-ladder fallback (defined below, resolved at call time)
    greedy=lambda inst: greedy_placement(inst),
    default_solve=SolveConfig(k=4, strategy="stratified", min_per_sub=8),
    default_exec=ExecConfig(solver_kw=dict(
        max_iters=8_000, tol_primal=1e-4, tol_gap=1e-4)),
))


# ---------------------------------------------------------------------------
# conveniences: one-shot placement + greedy baseline
# ---------------------------------------------------------------------------

def place_experts(inst: MoEPlacementInstance, *,
                  solve_cfg: Optional[SolveConfig] = None,
                  exec_cfg: Optional[ExecConfig] = None,
                  warm=None, device=None):
    """One-shot POP placement through a throwaway service session on
    ``device`` (default: the CUDA device; the one-door path: the session
    owns the k dispatch, rounding and observability; used by
    ``models.moe.plan_expert_placement``).  ``warm`` seeds the session
    from a previous call's result.  Returns ``(placement,
    POPResult-or-FullResult, metrics)``."""
    from ..service import PopService     # lazy: service imports domains

    session = PopService(device=device).session(
        "domains.place_experts", inst,
        solve=solve_cfg or SPEC.default_solve,
        exec=exec_cfg or SPEC.default_exec)
    if warm is not None:
        session.seed(warm)
    out = session.step(inst)
    return out.alloc, out.raw, out.metrics


def greedy_placement(inst: MoEPlacementInstance) -> np.ndarray:
    """Movement-oblivious greedy baseline: experts by load descending,
    each onto the least-loaded device with memory headroom."""
    order = np.argsort(-inst.load)
    pick = np.zeros(inst.n_experts, np.int64)
    load = np.zeros(inst.n_devices)
    mem_u = np.zeros(inst.n_devices)
    for e in order:
        ok = mem_u + inst.mem[e] <= inst.cap
        cand = np.where(ok, load, np.inf)
        d = int(np.argmin(cand))
        pick[e] = d
        load[d] += inst.load[e]
        mem_u[d] += inst.mem[e]
    return pick
