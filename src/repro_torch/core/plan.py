"""PopPlan: the POP planning artifact + churn-aware warm-start remapping
(a numpy copy of ``repro/core/plan.py``; stacked operators may hold torch
tensors on any device and are read back to the host here).

Planning (partition + replicate + layout) is separable from solving: a
:class:`PopPlan` is a cached, reusable description of HOW a problem is
split — the partition, the replication plan, per-entity -> (lane, slot)
placement provenance, and (after ``pop.build``) the stacked sub-LP shapes.
Online callers re-plan only when they must (entity churn, k change,
re-stratification) and re-use the plan otherwise.

The plan is also what makes warm starts survive *partition changes*.
PR-2-style warm starts required the previous partition verbatim; with two
plans in hand, :func:`remap_warm` scatters the previous solver iterates
onto the new plan's lanes:

* **primal**: each entity's per-slot variable block (``SubLayout.x_slot``)
  is copied from wherever the entity lived in the old plan to wherever it
  lives in the new one (averaged over replicas, clipped into the new
  bounds).  Lane-global variables (e.g. Gavel's epigraph ``t``) are
  averaged across old lanes and broadcast.
* **dual**: per-entity constraint rows move with their entity; lane-global
  rows (worker caps, edge caps) follow their lane's closest ancestor (the
  old lane contributing most matched entities), falling back to the
  cross-lane average.  Freshly *arrived* entities have no previous iterate
  of their own, so they get a dual-only warm start from the population:
  their constraint rows take the mean over all old entities' rows of the
  same block (truncation to the feasible cone is inherited — means of
  projected duals stay projected), plus the peer-average primal block as a
  prior (measured on Gavel: the prior cuts another ~25% of warm iterations
  at 20% churn vs leaving arrivals' primal cold).
* **mask**: lanes that matched no entity at all start cold.  The mask is
  per-lane data (``WarmStart.mask``), applied by ``backends._resolve_warm``
  / ``pdhg.solve_stacked(warm_mask=)`` with a ``torch.where`` — no
  Python-level branch, so every lane flows through the same jitted solve.

Problems opt in by implementing ``POPProblem.sub_layout`` (a
:class:`SubLayout` describing which variables/rows belong to which slot);
problems without a layout degrade gracefully to cold starts instead of
raising — ``pop_solve(warm=prev)`` is total across entity arrival,
departure, k changes and re-stratification.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .replicate import ReplicationPlan


def _host(a) -> np.ndarray:
    """numpy view of an array that may be a torch tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# frozen for immutability only — layouts are never cache keys
# popcheck: disable=config-hashability
@dataclasses.dataclass(frozen=True)
class SubLayout:
    """Variable/constraint layout of one sub-LP, for warm-start remapping.

    All indices are into a single sub-problem's flat solution vector ``x``
    (length N) / dual vector ``y`` (length M).  ``-1`` entries are ignored.

    x_slot   : [n_slots, v_per] variable ids owned by slot ``s``
    y_slot   : [n_slots, c_per] constraint row ids owned by slot ``s``
    x_global : [g] lane-global variable ids (matched positionally old->new)
    y_global : [h] lane-global constraint row ids (resource/capacity rows)
    """

    x_slot: np.ndarray
    y_slot: np.ndarray
    x_global: np.ndarray
    y_global: np.ndarray


@dataclasses.dataclass
class PopPlan:
    """A reusable POP split: partition + replication + placement provenance.

    ``idx`` holds *build ids* per (lane, slot): entity ids for plain splits,
    replica ids under §4.3 replication.  ``entity_of_slot`` always holds
    ORIGINAL entity ids (the provenance the warm-start remap matches on);
    ``entity_ids`` optionally carries stable *external* ids (job ids,
    demand ids) so entities can be matched across instances whose
    positional indexing churned.  ``shapes`` is filled by ``pop.build``.
    """

    k: int
    n_entities: int
    idx: np.ndarray                  # [k, n_per] build ids, -1 padded
    entity_of_slot: np.ndarray       # [k, n_per] original entity ids, -1 padded
    strategy: str = "random"
    seed: int = 0
    replication: Optional[ReplicationPlan] = None
    entity_ids: Optional[np.ndarray] = None   # [n_entities] stable external ids
    similarity: Optional[dict] = None
    layout: Optional[SubLayout] = None
    # filled by pop.build: {"x": (k, N), "y": (k, M)} stacked iterate shapes
    # (what remap_warm sizes cold bases from), plus
    # "ell": (Wr, Ww, Dr, Wc, Wv, Dc) when the problem attaches
    # StructuredOperator metadata — every data-dependent ELL dim (narrow
    # widths, wide-bucket widths, wide-bucket counts), so plan consumers
    # can tell when a rebuild changed the kernel shapes (any of them
    # moving retraces the jitted solve; iterate shapes do not move)
    shapes: Optional[dict] = None

    @property
    def n_per(self) -> int:
        return self.idx.shape[1]

    def external_ids(self) -> np.ndarray:
        """Stable per-entity ids (positional indices when none were given)."""
        if self.entity_ids is not None:
            return np.asarray(self.entity_ids)
        return np.arange(self.n_entities)

    def row_scale(self, lane: int) -> Optional[np.ndarray]:
        """Per-slot demand scale for ``lane`` (replication), or None."""
        if self.replication is None:
            return None
        row = self.idx[lane]
        return np.where(row >= 0,
                        self.replication.replica_scale[np.maximum(row, 0)], 0.0)


def repair_plan(old_plan: PopPlan, problem, *,
                entity_ids: Optional[np.ndarray] = None) -> PopPlan:
    """Incrementally re-plan after entity churn, disturbing the old plan as
    little as possible: surviving entities KEEP their (lane, slot), departed
    entities vacate theirs, and arrivals fill vacancies score-balanced
    (heaviest arrival to the lightest lane), growing the slot axis only when
    the arrivals outnumber the vacancies.

    Slot stability is what makes warm starts transfer: a surviving entity's
    sub-problem keeps (statistically) the same peers and the same 1/k
    resource slice, so its previous iterates stay near-optimal.  A fresh
    stratified partition of the churned entity set is still self-similar,
    but it reshuffles every entity's lane context and throws that locality
    away — measurably worse than cold at >10% churn, while the repaired
    plan keeps warm re-solves well under the cold iteration count.

    Replicated plans are not repaired (replica counts depend on the global
    demand profile); callers fall back to a fresh plan + remap.
    """
    if old_plan.replication is not None:
        raise ValueError("repair_plan does not support replicated plans; "
                         "re-plan from scratch and remap instead")
    n = problem.n_entities
    new_ids = (np.arange(n) if entity_ids is None else np.asarray(entity_ids))
    if new_ids.shape[0] != n:
        raise ValueError(f"entity_ids has {new_ids.shape[0]} entries for "
                         f"{n} entities")
    old_ids = old_plan.external_ids()
    pos_of = {}
    for lane in range(old_plan.k):
        for slot in range(old_plan.n_per):
            e = int(old_plan.entity_of_slot[lane, slot])
            if e >= 0:
                pos_of.setdefault(old_ids[e], (lane, slot))

    scores = np.asarray(problem.entity_scores(), np.float64)
    k = old_plan.k
    slots = [[-1] * old_plan.n_per for _ in range(k)]
    lane_load = np.zeros(k)
    arrivals = []
    for e in range(n):
        hit = pos_of.get(new_ids[e])
        if hit is not None:
            lane, slot = hit
            slots[lane][slot] = e
            lane_load[lane] += scores[e]
        else:
            arrivals.append(e)

    # heaviest arrivals first, each to the lightest lane with a vacancy
    # (append a fresh slot everywhere once vacancies run out)
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
    # drop trailing all-padding slot columns (departure-heavy churn)
    live = np.flatnonzero((idx >= 0).any(axis=0))
    n_per = max(int(live.max()) + 1, 1) if live.size else 1
    idx = idx[:, :n_per]

    attrs = np.asarray(problem.entity_attrs(), np.float64)
    if attrs.ndim == 1:
        attrs = attrs[:, None]
    from .partition import similarity_report
    return PopPlan(k=k, n_entities=n, idx=idx, entity_of_slot=idx,
                   strategy=old_plan.strategy, seed=old_plan.seed,
                   replication=None,
                   entity_ids=None if entity_ids is None else new_ids,
                   similarity=similarity_report(attrs, idx),
                   layout=problem.sub_layout(n_per))


class WarmStart(NamedTuple):
    """Remapped starting iterates for a stacked solve.

    ``mask`` is per-lane: False lanes are started cold by the solver (the
    blend happens inside ``backends._resolve_warm`` with a ``torch.where``).
    ``stats`` carries ``warm_fraction`` (matched slots / live slots) and
    match counts for logging.
    """

    x: Any
    y: Any
    mask: Any
    stats: dict


def _cold_base(ops) -> tuple:
    """Cold starting iterates in numpy (mirrors ``backends.cold_start``)."""
    l = _host(ops.l)
    u = _host(ops.u)
    q = _host(ops.q)
    return np.clip(np.zeros_like(l), l, u), np.zeros(q.shape, q.dtype)


def _new_shapes(new_plan: PopPlan, ops) -> Optional[tuple]:
    if ops is not None:
        return tuple(ops.c.shape), tuple(ops.q.shape)
    if new_plan.shapes is not None:
        return tuple(new_plan.shapes["x"]), tuple(new_plan.shapes["y"])
    return None


def _cold(new_plan: PopPlan, ops, reason: str) -> WarmStart:
    shp = _new_shapes(new_plan, ops)
    if shp is None:
        raise ValueError("remap_warm needs the new stacked ops (or a plan "
                         "that has been through pop.build) to size the "
                         "starting iterates")
    (kx, n_var), (ky, n_con) = shp
    if ops is not None:
        x0, y0 = _cold_base(ops)
    else:
        x0 = np.zeros((kx, n_var), np.float32)
        y0 = np.zeros((ky, n_con), np.float32)
    return WarmStart(x0, y0, np.zeros(kx, bool),
                     dict(warm_fraction=0.0, matched=0, fresh=0, dropped=0,
                          lanes_cold=int(kx), identity=False, reason=reason))


def remap_warm(old_plan: PopPlan, new_plan: PopPlan, old_result,
               *, ops=None) -> WarmStart:
    """Map a previous solve's iterates onto a (possibly different) plan.

    ``old_result`` is anything with stacked ``.x``/``.y`` (a ``POPResult``
    or ``SolveResult``) or an ``(x, y)`` pair shaped for ``old_plan``.
    ``ops`` is the NEW plan's stacked :class:`~repro_torch.core.pdhg.OperatorLP`
    (used for cold bases and bound clipping); when omitted the new plan
    must have been through ``pop.build`` so its shapes are known.

    Handles entity arrival (dual-only warm start), departure (iterates
    dropped), k changes and re-stratification.  Identity churn (same
    entities, same slots, same shapes) returns the old iterates verbatim —
    bit-for-bit the PR-2 warm path.
    """
    if hasattr(old_result, "x") and hasattr(old_result, "y"):
        ox, oy = old_result.x, old_result.y
    else:
        ox, oy = old_result
    if ox is None or oy is None:
        raise ValueError("warm result lacks solver state (x/y)")
    ox = _host(ox)
    oy = _host(oy)

    shp = _new_shapes(new_plan, ops)
    if shp is None:
        raise ValueError("remap_warm needs ops= or a built new_plan")
    (k_new, n_var), (_, n_con) = shp

    old_ids = old_plan.external_ids()
    new_ids = new_plan.external_ids()

    # ---- identity fast path: the PR-2 warm start, bit-for-bit -------------
    if (ox.shape == (k_new, n_var) and oy.shape == (k_new, n_con)
            and old_plan.entity_of_slot.shape == new_plan.entity_of_slot.shape
            and np.array_equal(old_plan.entity_of_slot,
                               new_plan.entity_of_slot)
            and np.array_equal(old_ids, new_ids)):
        n_live = int((new_plan.entity_of_slot >= 0).sum())
        return WarmStart(ox, oy, np.ones(k_new, bool),
                         dict(warm_fraction=1.0, matched=n_live, fresh=0,
                              dropped=0, lanes_cold=0, identity=True))

    lo, ln = old_plan.layout, new_plan.layout
    if lo is None or ln is None:
        return _cold(new_plan, ops, "no sub_layout")
    if (lo.x_slot.shape[1] != ln.x_slot.shape[1]
            or lo.y_slot.shape[1] != ln.y_slot.shape[1]):
        return _cold(new_plan, ops, "per-entity block widths differ")

    # ---- accumulate old per-entity blocks (averaged over replicas) --------
    k_old = old_plan.k
    sum_x: dict = {}
    sum_y: dict = {}
    count: dict = {}
    lane_of: dict = {}               # first old lane an entity appeared in
    v_per = lo.x_slot.shape[1]
    c_per = lo.y_slot.shape[1]
    xs_mask = lo.x_slot >= 0
    ys_mask = lo.y_slot >= 0
    primal_rows = []                 # per-block means: priors for arrivals
    dual_rows = []
    for lane in range(k_old):
        row = old_plan.entity_of_slot[lane]
        for slot in range(row.shape[0]):
            e = int(row[slot])
            if e < 0:
                continue
            xv = np.zeros(v_per, ox.dtype)
            xv[xs_mask[slot]] = ox[lane, lo.x_slot[slot][xs_mask[slot]]]
            yv = np.zeros(c_per, oy.dtype)
            yv[ys_mask[slot]] = oy[lane, lo.y_slot[slot][ys_mask[slot]]]
            key = old_ids[e]
            if key in count:
                sum_x[key] += xv
                sum_y[key] += yv
                count[key] += 1
            else:
                sum_x[key] = xv.copy()
                sum_y[key] = yv.copy()
                count[key] = 1
                lane_of[key] = lane
            primal_rows.append(xv)
            dual_rows.append(yv)
    avg_primal = (np.mean(primal_rows, axis=0) if primal_rows
                  else np.zeros(v_per, ox.dtype))
    avg_dual = (np.mean(dual_rows, axis=0) if dual_rows
                else np.zeros(c_per, oy.dtype))

    # ---- scatter onto the new plan ----------------------------------------
    if ops is not None:
        x_w, y_w = _cold_base(ops)
        x_w = x_w.astype(ox.dtype, copy=True)
        y_w = y_w.astype(oy.dtype, copy=True)
    else:
        x_w = np.zeros((k_new, n_var), ox.dtype)
        y_w = np.zeros((k_new, n_con), oy.dtype)

    nxs_mask = ln.x_slot >= 0
    nys_mask = ln.y_slot >= 0
    matched = 0
    fresh = 0
    lane_hit = np.zeros(k_new, bool)
    overlap = np.zeros((k_new, k_old), np.int64)   # matched entities per pair
    for lane in range(k_new):
        row = new_plan.entity_of_slot[lane]
        for slot in range(row.shape[0]):
            e = int(row[slot])
            if e < 0:
                continue
            key = new_ids[e]
            ys_idx = ln.y_slot[slot][nys_mask[slot]]
            if key in count:
                c = count[key]
                x_w[lane, ln.x_slot[slot][nxs_mask[slot]]] = \
                    (sum_x[key] / c)[nxs_mask[slot]]
                y_w[lane, ys_idx] = (sum_y[key] / c)[nys_mask[slot]]
                matched += 1
                lane_hit[lane] = True
                overlap[lane, lane_of[key]] += 1
            else:
                # arrived entity: no previous iterate of its own, so it
                # starts from the population means — the peer-average
                # primal block as a prior (clipped into its own bounds
                # below) and the mean dual row of its constraint block
                x_w[lane, ln.x_slot[slot][nxs_mask[slot]]] = \
                    avg_primal[nxs_mask[slot]]
                y_w[lane, ys_idx] = avg_dual[nys_mask[slot]]
                fresh += 1

    # ---- lane-global blocks (epigraph vars, resource-cap duals) -----------
    # each new lane inherits them from its closest ancestor — the old lane
    # contributing most of its matched entities (under an incremental
    # repair_plan that IS the same lane, so per-lane state survives
    # verbatim); lanes with no ancestor get the cross-lane average
    x_gavg = ox[:, lo.x_global].mean(axis=0) if lo.x_global.size else None
    y_gavg = oy[:, lo.y_global].mean(axis=0) if lo.y_global.size else None
    for lane in range(k_new):
        parent = int(np.argmax(overlap[lane])) if lane_hit[lane] else None
        if lo.x_global.size and lo.x_global.size == ln.x_global.size:
            x_w[lane, ln.x_global] = (ox[parent, lo.x_global]
                                      if parent is not None else x_gavg)
        if lo.y_global.size and lo.y_global.size == ln.y_global.size:
            y_w[lane, ln.y_global] = (oy[parent, lo.y_global]
                                      if parent is not None else y_gavg)

    if ops is not None:              # new bounds may be tighter than old ones
        x_w = np.clip(x_w, _host(ops.l), _host(ops.u))

    new_id_set = set(new_ids.tolist())
    dropped = sum(1 for key in count if key not in new_id_set)
    live = matched + fresh
    return WarmStart(
        x_w, y_w, lane_hit,
        dict(warm_fraction=matched / max(live, 1), matched=matched,
             fresh=fresh, dropped=dropped,
             lanes_cold=int((~lane_hit).sum()), identity=False))
