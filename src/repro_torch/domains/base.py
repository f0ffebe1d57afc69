"""The declarative domain contract — the port of ``repro/domains/base.py``.

A domain describes itself as data (:class:`DomainSpec`) and registers the
description; :class:`~repro_torch.service.PopService` sessions look it up
by name or instance type and drive the generic ``plan -> build -> solve
-> reduce`` pipeline.  Two styles are ported:

* a ``problem`` factory (how Gavel and traffic register): map the
  instance to a :class:`~repro_torch.core.pop.POPProblem`;
* a ``step_override`` (load balancing): a domain whose split is not an
  entity partition (it splits SERVER GROUPS and shards follow their
  server) runs its own pipeline; the session calls it with the instance,
  the configs, its carried warm state and its device, and the domain
  returns a :class:`StepOutcome` — still behind the one public
  ``session.step`` door.

The declarative-hooks style comes with the domain that needs it (ROADMAP
open items §1, item 13).
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
    # instance -> POPProblem
    problem: Optional[Callable[[Any], POPProblem]] = None
    entity_ids: Optional[Callable[[Any], Optional[np.ndarray]]] = None
    round: Optional[Callable] = None          # (inst, alloc) -> allocation
    evaluate: Optional[Callable] = None       # (inst, alloc) -> metrics
    # solver-free fallback allocation, (inst) -> alloc: the last rung of
    # the serving ladder — what a session returns when the solve diverges
    # or misses its deadline and there is no previous allocation to repeat
    greedy: Optional[Callable] = None
    default_solve: SolveConfig = SolveConfig()
    default_exec: ExecConfig = ExecConfig()
    # full custom online step (domain-aware splits, e.g. load balancing):
    # (inst, solve_cfg, exec_cfg, warm, *, device) -> StepOutcome
    step_override: Optional[Callable] = None

    def __post_init__(self):
        if self.problem is None and self.step_override is None:
            raise ValueError(
                f"domain {self.name!r}: provide a problem= factory or a "
                "step_override= (the declarative-hooks style is not ported "
                "yet)")

    def make_problem(self, instance: Any) -> POPProblem:
        return self.problem(instance)

    def ids_of(self, instance: Any) -> Optional[np.ndarray]:
        return None if self.entity_ids is None else self.entity_ids(instance)

    def metrics_of(self, instance: Any, problem: Optional[POPProblem],
                   alloc: np.ndarray) -> dict:
        if self.evaluate is not None:
            return self.evaluate(instance, alloc)
        if problem is not None:
            return problem.evaluate(alloc)
        return {}
