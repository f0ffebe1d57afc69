"""The SLO contract and the offline planner — the port of
``repro/tuning/slo.py``, line for line (pure Python).

:class:`SLOTarget` is the tenant's service-level objective — a frozen,
hashable config validated at construction exactly like ``SolveConfig``
(it pins sessions and keys nothing silently).  :func:`plan_for_slo`
interpolates a :class:`~repro_torch.tuning.profile.TuningProfile`'s measured
curves and picks the cheapest ``SolveConfig`` whose predicted quality
loss and step latency meet the SLO.  Candidate k values are powers of
two, so a fleet of tuned tenants grows the memoized stack shapes
O(log k_max), and —
per the granular-POP follow-up (arXiv 2110.11927) — a deadline that the
quality-feasible k cannot meet escalates **replication of hot entities**
at a larger k before it surrenders quality by shrinking the partition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..core.config import ExecConfig, SolveConfig, validate_cache_key
from .profile import DomainCurves, TuningProfile

__all__ = ["SLOTarget", "TunedPlan", "plan_for_slo", "quality_loss_at",
           "latency_at", "launch_defaults"]


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """A tenant's service-level objective.

    ``max_quality_loss`` bounds the relative quality loss vs the k=1 full
    solve (0.02 = "within 2% of optimal"); ``step_deadline_s``, when set,
    bounds a step's wall time (the online refiner shares the degradation
    ladder's measured rate model to enforce it).  Frozen + hashable so a
    session can pin it like its configs."""

    max_quality_loss: float = 0.02
    step_deadline_s: Optional[float] = None

    def __post_init__(self):
        mql = self.max_quality_loss
        if not isinstance(mql, (int, float)) or not 0.0 <= mql < 1.0:
            raise ValueError("max_quality_loss must be in [0, 1), got "
                             f"{mql!r}")
        if self.step_deadline_s is not None and self.step_deadline_s <= 0:
            raise ValueError("step_deadline_s must be positive or None, "
                             f"got {self.step_deadline_s!r}")
        validate_cache_key(self)


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """What the planner chose and why: the configs plus the predictions
    the choice was made on (``source``: ``"curves"`` — quality-feasible
    pick, ``"replicated"`` — deadline met by escalating replication,
    ``"deadline-limited"`` — deadline forced a quality-infeasible k,
    ``"no-curves"`` — profile has no curves for the domain)."""

    solve: SolveConfig
    exec: ExecConfig
    predicted_quality_loss: float = 0.0
    predicted_step_s: Optional[float] = None
    source: str = "curves"


def _interp_log2(rows, k: float, col: int) -> Optional[float]:
    """Piecewise-linear interpolation in log2(k) over curve rows sorted by
    k; extrapolates from the last segment's slope beyond the support."""
    pts = sorted((float(r[0]), float(r[col])) for r in rows)
    if not pts:
        return None
    xs = [math.log2(x) for x, _ in pts]
    ys = [y for _, y in pts]
    x = math.log2(max(k, 1.0))
    if len(pts) == 1 or x <= xs[0]:
        return ys[0]
    for i in range(1, len(xs)):
        if x <= xs[i] or i == len(xs) - 1:
            x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
            if x1 == x0:
                return y1
            return y0 + (y1 - y0) * (x - x0) / (x1 - x0)
    return ys[-1]


def quality_loss_at(curves: DomainCurves, k: int) -> float:
    """Predicted relative quality loss at k (0 = lossless), clamped to
    [0, 1]."""
    if k <= 1:
        return 0.0
    rel = _interp_log2(curves.quality_vs_k, k, 1)
    if rel is None:
        return 0.0
    return float(min(max(1.0 - rel, 0.0), 1.0))


def latency_at(curves: DomainCurves, k: int,
               n_entities: Optional[int] = None) -> Optional[float]:
    """Predicted steady solve seconds at k, scaled from the probe size by
    the fitted exponent (``None`` when the curve has no latency rows)."""
    t = _interp_log2(curves.latency_vs_k, max(k, 1), 1)
    if t is None:
        return None
    if n_entities and curves.probe_n > 0:
        t *= (n_entities / curves.probe_n) ** curves.n_exponent
    return float(max(t, 0.0))


def _pow2_candidates(curves: DomainCurves, n_entities: int) -> list:
    """Power-of-two ks inside the measured support, clamped to the
    instance size (every sub-problem keeps >= 2 entities)."""
    max_k = max((int(r[0]) for r in curves.quality_vs_k), default=1)
    ks, k = [1], 2
    while k <= max_k and k * 2 <= max(n_entities, 2):
        ks.append(k)
        k *= 2
    return ks


def plan_for_slo(profile: TuningProfile, domain: str, n_entities: int,
                 slo: SLOTarget, base_solve: Optional[SolveConfig] = None,
                 base_exec: Optional[ExecConfig] = None) -> TunedPlan:
    """The cheapest config whose interpolated curves meet ``slo``.

    Among quality-feasible ks (predicted loss <= ``max_quality_loss``;
    k=1 is always feasible) the planner takes the lowest predicted
    latency.  If a ``step_deadline_s`` is set and that pick misses it, it
    first tries the profile's replication rows at larger k (recover
    quality by replicating hot entities — granular-POP — instead of
    giving it up), then falls back to the deadline-meeting k with the
    least quality loss."""
    base_solve = base_solve or SolveConfig()
    base_exec = base_exec or ExecConfig()
    curves = profile.domains.get(domain)
    if curves is None or not curves.quality_vs_k:
        return TunedPlan(solve=base_solve, exec=base_exec,
                         source="no-curves")

    def mk(k: int, thr: Optional[float] = None) -> SolveConfig:
        # min_per_sub dropped: the planner already clamps k to the size
        return SolveConfig(k=k, strategy=base_solve.strategy,
                           seed=base_solve.seed, replicate_threshold=thr)

    ks = _pow2_candidates(curves, n_entities)
    pred = {k: (quality_loss_at(curves, k),
                latency_at(curves, k, n_entities)) for k in ks}
    feasible = [k for k in ks if pred[k][0] <= slo.max_quality_loss + 1e-12]
    best = min(feasible,
               key=lambda k: (pred[k][1] if pred[k][1] is not None
                              else float("inf"), -k))
    loss, lat = pred[best]
    deadline = slo.step_deadline_s
    if deadline is None or lat is None or lat <= deadline:
        return TunedPlan(solve=mk(best), exec=base_exec,
                         predicted_quality_loss=loss, predicted_step_s=lat)

    # quality-feasible pick misses the deadline: escalate replication at
    # larger k before shrinking quality
    rep_rows = []
    for k, thr, rel, solve_s in curves.replication:
        t = solve_s
        if n_entities and curves.probe_n > 0:
            t *= (n_entities / curves.probe_n) ** curves.n_exponent
        rep_rows.append((int(k), float(thr), 1.0 - float(rel), float(t)))
    rep_ok = [r for r in rep_rows
              if r[2] <= slo.max_quality_loss + 1e-12 and r[3] <= deadline]
    if rep_ok:
        k, thr, rloss, rt = min(rep_ok, key=lambda r: r[3])
        return TunedPlan(solve=mk(k, thr), exec=base_exec,
                         predicted_quality_loss=rloss, predicted_step_s=rt,
                         source="replicated")

    in_deadline = [k for k in ks
                   if pred[k][1] is not None and pred[k][1] <= deadline]
    pool = in_deadline or [max(ks)]
    k = min(pool, key=lambda k: (pred[k][0], pred[k][1] or 0.0))
    return TunedPlan(solve=mk(k), exec=base_exec,
                     predicted_quality_loss=pred[k][0],
                     predicted_step_s=pred[k][1], source="deadline-limited")


def launch_defaults(profile: TuningProfile) -> Optional[dict]:
    """``DispatchConfig`` defaults from the measured launch-cost line:
    the batching window is worth ~2 launch overheads of added latency,
    and a coalesced launch stops paying once its lane time dwarfs the
    overhead it amortizes.  Returns ``{"max_wait_ms", "max_lanes"}`` or
    ``None`` when the profile has no launch measurement."""
    lc = profile.launch_cost
    overhead = float(lc.get("overhead_s", 0.0) or 0.0)
    per_lane = float(lc.get("per_lane_s", 0.0) or 0.0)
    if overhead <= 0.0:
        return None
    max_wait_ms = float(min(max(2.0 * overhead * 1e3, 0.5), 20.0))
    if per_lane > 0.0:
        lanes = int(overhead / per_lane) * 4
    else:
        lanes = 64
    lanes = max(8, min(lanes, 256))
    max_lanes = 1 << (lanes.bit_length() - 1)        # floor to a pow2
    return {"max_wait_ms": max_wait_ms, "max_lanes": max_lanes}
