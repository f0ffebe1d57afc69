"""The declarative domain contract — the port of ``repro/domains/base.py``.

A domain describes itself as data (:class:`DomainSpec`) and registers the
description; :class:`~repro_torch.service.PopService` sessions look it up
by name or instance type and drive the generic ``plan -> build -> solve
-> reduce`` pipeline.  Three ways to fill a spec:

* **declarative hooks** (how MoE expert placement onboards): provide
  ``n_entities`` / ``entity_attrs`` / ``build_sub`` / ``K_mv`` /
  ``KT_mv`` / ``extract`` (+ optional ``entity_scores``, ``sub_layout``,
  ``round``, ``evaluate``) and the generic :class:`SpecProblem` adapter
  is synthesised for you;
* a ``problem`` factory (how Gavel and traffic register): map the
  instance to a :class:`~repro_torch.core.pop.POPProblem`;
* a ``step_override`` (load balancing): a domain whose split is not an
  entity partition (it splits SERVER GROUPS and shards follow their
  server) runs its own pipeline; the session calls it with the instance,
  the configs, its carried warm state and its device, and the domain
  returns a :class:`StepOutcome` — still behind the one public
  ``session.step`` door.

``quality`` names the domain's quality scalar (a step's metrics dict ->
float, higher is better): what the SLO tuner (``repro_torch.tuning``)
measures quality loss on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..core.config import ExecConfig, SolveConfig
from ..core.pop import POPProblem


@dataclasses.dataclass
class StepOutcome:
    """What a ``step_override`` returns — the fields the session needs to
    assemble an :class:`~repro_torch.service.Allocation` plus the warm
    state it should carry into the next step."""

    alloc: np.ndarray
    metrics: dict
    warm_state: Any
    backend: Optional[str] = None
    engine: Optional[str] = None
    plan_cache: str = "miss"
    warm_fraction: Optional[float] = None
    solve_time_s: float = 0.0
    build_time_s: float = 0.0
    iterations: int = 0
    k: int = 1
    raw: Any = None


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """A POP domain as data; every callable takes the domain instance
    first."""

    name: str
    # instance types session()/spec_for() infer the domain from
    instance_types: Tuple[type, ...] = ()
    describe: str = ""

    # --- path A: adapt an existing POPProblem ------------------------------
    problem: Optional[Callable[[Any], POPProblem]] = None

    # --- path B: declarative hooks (SpecProblem is synthesised) ------------
    n_entities: Optional[Callable[[Any], int]] = None
    entity_attrs: Optional[Callable[[Any], np.ndarray]] = None
    entity_scores: Optional[Callable[[Any], np.ndarray]] = None
    build_sub: Optional[Callable] = None      # (inst, idx_row, frac, scale)
    K_mv: Optional[Callable] = None
    KT_mv: Optional[Callable] = None
    sub_layout: Optional[Callable] = None     # (inst, n_slots) -> SubLayout
    extract: Optional[Callable] = None        # (inst, op, x, idx_row)

    # --- shared hooks -------------------------------------------------------
    entity_ids: Optional[Callable[[Any], Optional[np.ndarray]]] = None
    round: Optional[Callable] = None          # (inst, alloc) -> allocation
    evaluate: Optional[Callable] = None       # (inst, alloc) -> metrics
    # the domain quality scalar (metrics dict -> float, higher = better):
    # what the SLO tuner measures quality loss on; metrics["objective"]
    # when absent
    quality: Optional[Callable[[dict], float]] = None
    # solver-free fallback allocation, (inst) -> alloc: the last rung of
    # the serving ladder — what a session returns when the solve diverges
    # or misses its deadline and there is no previous allocation to repeat
    greedy: Optional[Callable] = None
    default_solve: SolveConfig = SolveConfig()
    default_exec: ExecConfig = ExecConfig()

    # --- full custom online step (domain-aware splits, e.g. LB) ------------
    # (inst, solve_cfg, exec_cfg, warm, *, device) -> StepOutcome
    step_override: Optional[Callable] = None

    def __post_init__(self):
        if self.step_override is not None:
            return
        if self.problem is None:
            needed = ("n_entities", "entity_attrs", "build_sub", "K_mv",
                      "KT_mv", "extract")
            missing = [f for f in needed if getattr(self, f) is None]
            if missing:
                raise ValueError(
                    f"domain {self.name!r}: provide a problem= factory, a "
                    f"step_override=, or the declarative hooks (missing: "
                    f"{missing})")

    def make_problem(self, instance: Any) -> POPProblem:
        """The POP-able problem for ``instance`` (builds the generic
        adapter when the spec is declarative)."""
        if self.problem is not None:
            return self.problem(instance)
        return SpecProblem(self, instance)

    def ids_of(self, instance: Any) -> Optional[np.ndarray]:
        return None if self.entity_ids is None else self.entity_ids(instance)

    def metrics_of(self, instance: Any, problem: Optional[POPProblem],
                   alloc: np.ndarray) -> dict:
        if self.evaluate is not None:
            return self.evaluate(instance, alloc)
        if problem is not None:
            return problem.evaluate(alloc)
        return {}

    def quality_of(self, metrics: Optional[dict]) -> Optional[float]:
        """The scalar the tuner tracks, from a step's metrics dict (None
        when the domain has no usable quality signal)."""
        if not isinstance(metrics, dict):
            return None
        if self.quality is not None:
            try:
                return float(self.quality(metrics))
            except (KeyError, TypeError, ValueError):
                return None
        obj = metrics.get("objective")
        return None if obj is None else float(obj)


class SpecProblem(POPProblem):
    """Generic :class:`~repro_torch.core.pop.POPProblem` synthesised from a
    declarative :class:`DomainSpec` — what lets a new scenario onboard
    through the registry alone, without subclassing anything.

    The operator matvecs are taken from the SPEC (one function object per
    domain, not per instance), so every instance of a domain shares the
    memoized step engines (``pdhg.matvec_engine``) and the dispatcher's
    ``coalesce_key``."""

    def __init__(self, spec: DomainSpec, instance: Any):
        self.spec = spec
        self.instance = instance
        self.n_entities = int(spec.n_entities(instance))
        # instance attributes shadow the POPProblem staticmethods; same
        # spec => same function identity => shared engines
        self.K_mv = spec.K_mv
        self.KT_mv = spec.KT_mv

    def entity_attrs(self) -> np.ndarray:
        return self.spec.entity_attrs(self.instance)

    def entity_scores(self) -> np.ndarray:
        if self.spec.entity_scores is not None:
            return self.spec.entity_scores(self.instance)
        return super().entity_scores()

    def build_sub(self, idx_row, frac, scale=None):
        return self.spec.build_sub(self.instance, idx_row, frac, scale)

    def sub_layout(self, n_slots: int):
        if self.spec.sub_layout is None:
            return None
        return self.spec.sub_layout(self.instance, n_slots)

    def extract(self, op, x, idx_row):
        return self.spec.extract(self.instance, op, x, idx_row)

    def evaluate(self, alloc) -> dict:
        return self.spec.metrics_of(self.instance, None, alloc)
