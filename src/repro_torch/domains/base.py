"""The declarative domain contract — the port of ``repro/domains/base.py``.

A domain describes itself as data (:class:`DomainSpec`) and registers the
description; :class:`~repro_torch.service.PopService` sessions look it up
by name or instance type and drive the generic ``plan -> build -> solve
-> reduce`` pipeline.  This slice ports the ``problem=`` factory style
(how the paper domains register); the declarative-hooks style and
``step_override`` domains come with the domains that need them (ROADMAP
open items §1, items 8 and 13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..core.config import ExecConfig, SolveConfig
from ..core.pop import POPProblem


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
    default_solve: SolveConfig = SolveConfig()
    default_exec: ExecConfig = ExecConfig()

    def __post_init__(self):
        if self.problem is None:
            raise ValueError(
                f"domain {self.name!r}: provide a problem= factory (the "
                "declarative-hooks and step_override styles are not ported "
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
