"""Query/request load balancing as a registered domain (paper §3.3) — the
port of ``repro/domains/load_balance.py``, with the reference's defaults:
k=4, ``ExecConfig()``.

The split here is NOT an entity partition: sub-problems get disjoint
*server groups* and every shard follows its current server (otherwise the
split itself would force movement).  The domain therefore registers a
``step_override``: the session still owns warm-state chaining and
observability, but the pipeline inside is
:func:`repro_torch.problems.load_balancing.balance_placement` (which also
carries the §3.3 rounding + greedy repair and the POP-vs-full ``k_eff``
rule), run on the session's device.

The instance is a :class:`BalanceInstance`: anything that places
``load``-weighted shards onto ``n_targets`` — shards onto database
servers, request groups onto replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.config import ExecConfig, SolveConfig
from ..problems.load_balancing import LBResult, balance_placement
from .base import DomainSpec, StepOutcome
from .registry import register


@dataclasses.dataclass
class BalanceInstance:
    """One balancing tick's input."""

    load: np.ndarray                        # [n] per-shard load
    n_targets: int                          # servers/replicas
    current: Optional[np.ndarray] = None    # [n] current placement (sticky)
    cap: Optional[np.ndarray] = None        # [n_targets] memory capacity
    eps_frac: float = 0.2                   # load-window tolerance
    # stable external shard/session ids (None = positional): what lets the
    # warm state survive shard arrivals/departures between ticks
    ids: Optional[np.ndarray] = None

    @property
    def n_shards(self) -> int:
        return np.asarray(self.load).shape[0]


def _step(inst: BalanceInstance, solve_cfg: SolveConfig,
          exec_cfg: ExecConfig, warm, *, device=None) -> StepOutcome:
    prev: Optional[LBResult] = warm if isinstance(warm, LBResult) else None
    res = balance_placement(
        inst.load, inst.n_targets, inst.current, cap=inst.cap,
        eps_frac=inst.eps_frac, pop_k=solve_cfg.k, seed=solve_cfg.seed,
        backend=exec_cfg.backend, engine=exec_cfg.engine,
        solver_kw=exec_cfg.solver_dict() or None,
        warm=prev, shard_ids=inst.ids, device=device)
    return StepOutcome(
        alloc=res.placement,
        metrics={k: v for k, v in res.extra.items()
                 if k not in ("pop_state", "full_state")},
        warm_state=res,
        backend=res.extra.get("backend"),
        engine=res.extra.get("engine"),
        plan_cache=res.extra.get("plan_cache", "miss"),
        warm_fraction=res.extra.get("warm_fraction"),
        solve_time_s=res.solve_time_s,
        iterations=int(res.extra.get("iterations", 0)),
        # the k that ACTUALLY ran (balance_placement's k_eff rule, or the
        # k=1 full fallback) — reported, not re-derived
        k=int(res.extra.get("k", 1)), raw=res)


SPEC = register(DomainSpec(
    name="load_balance",
    instance_types=(BalanceInstance,),
    describe="E-Store shard placement MILP (shards onto server groups)",
    step_override=_step,
    default_solve=SolveConfig(k=4),
    default_exec=ExecConfig(),
))
