"""PopService: the public door to POP — the port of the synchronous core
of ``repro/service.py``.

    from repro_torch.service import PopService
    from repro_torch.domains import GavelInstance

    service = PopService()                        # runs on the CUDA device
    session = service.session("tenant-a", instance)   # domain inferred
    alloc = session.step(instance)                # -> Allocation
    alloc = session.step(updated_instance)        # warm-started re-solve

A :class:`PopSession` holds one tenant's warm state (previous plan +
iterates).  Every ``step`` reuses the plan when the entity set is unchanged
(``plan_cache="hit"``), repairs it under churn (``"repair"``), plans afresh
otherwise (``"miss"``), or solves the unpartitioned problem when the
instance is too small to split (``"full"``); the :class:`Allocation`
reports the backend and engine that actually ran.

A domain with a ``step_override`` (load balancing) runs its own pipeline
on the service's device; the session carries the warm state the domain
hands back and reports the outcome's own metrics and verdict.

Not ported yet (ROADMAP open items §1, items 10-12): the deadline ladder
and divergence quarantine, the micro-batching dispatcher and
``step_async``, paging, checkpoints and the SLO tuner.  Their arguments
raise ``NotImplementedError``, and a step whose solve reports diverged
lanes, or whose ``step_override`` raises or returns a non-finite
allocation, raises instead of entering the quarantine path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .core import backends as backends_mod
from .core import pop as pop_mod
from .core.config import ExecConfig, SolveConfig
from .domains import DomainSpec, registry as registry_mod

__all__ = ["Allocation", "PopService", "PopSession"]


@dataclasses.dataclass
class Allocation:
    """One session step's outcome — the uniform cross-domain result.

    ``plan_cache`` is "hit" (previous plan reused verbatim), "repair"
    (incrementally repaired under churn), "miss" (fresh plan) or "full"
    (unpartitioned k=1 path); ``backend``/``engine`` are what ran."""

    domain: str
    tenant: str
    step: int
    alloc: np.ndarray
    metrics: dict
    backend: Optional[str]
    engine: Optional[str]
    plan_cache: str
    k: int
    warm_fraction: Optional[float]
    solve_time_s: float
    build_time_s: float
    iterations: int
    raw: Any = None
    status: str = "ok"
    faults: tuple = ()

    @property
    def objective(self) -> Optional[float]:
        return self.metrics.get("objective")


def _zeros() -> dict:
    return {"steps": 0, "plan_hits": 0, "plan_repairs": 0, "plan_misses": 0,
            "full_solves": 0, "solve_time_s": 0.0, "warm_fraction_sum": 0.0,
            "warm_steps": 0, "engines": {}}


def _tally(stats: dict, alloc: Allocation) -> None:
    stats["steps"] += 1
    key = {"hit": "plan_hits", "repair": "plan_repairs",
           "full": "full_solves"}.get(alloc.plan_cache, "plan_misses")
    stats[key] += 1
    stats["solve_time_s"] += alloc.solve_time_s
    if alloc.engine:
        eng = stats["engines"]
        eng[alloc.engine] = eng.get(alloc.engine, 0) + 1
    if alloc.warm_fraction is not None:
        stats["warm_fraction_sum"] += alloc.warm_fraction
        stats["warm_steps"] += 1


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP open items §1, item {item})")


def _check_diverged(res, where: str) -> None:
    div = getattr(res, "diverged", None)
    n = 0 if div is None else int(np.asarray(div).sum())
    if n:
        raise RuntimeError(
            f"{where}: {n} solver lane(s) diverged; the quarantine retry is "
            "not ported yet (ROADMAP open items §1, item 10)")


class PopSession:
    """One tenant's stateful solving loop for one domain; create through
    :meth:`PopService.session`."""

    def __init__(self, service: "PopService", tenant: str, spec: DomainSpec,
                 solve_cfg: SolveConfig, exec_cfg: ExecConfig):
        self.service = service
        self.tenant = tenant
        self.spec = spec
        self.solve_cfg = solve_cfg
        self.exec_cfg = exec_cfg
        self.steps = 0
        self.last: Optional[Allocation] = None
        self.stats = _zeros()
        self._lock = threading.RLock()
        # warm state: a POPResult (pop path) or a SolveResult (+ the ids it
        # is FOR, full path)
        self._warm: Any = None
        self._mode: Optional[str] = None
        self._full_ids: Optional[tuple] = None

    def step(self, instance: Any, *,
             deadline_s: Optional[float] = None) -> Allocation:
        """Solve the (updated) instance, warm-started from the previous
        step wherever the domain allows.  The single online entry point."""
        if deadline_s is not None:
            raise _not_ported("step(deadline_s=) — the deadline ladder", "10")
        with self._lock:
            if self.spec.step_override is not None:
                alloc = self._step_override(instance)
            else:
                alloc = self._step_generic(instance)
            self.steps += 1
            _tally(self.stats, alloc)
            with self.service._lock:
                _tally(self.service._stats, alloc)
            self.last = alloc
        return alloc

    def _step_override(self, instance: Any) -> Allocation:
        out = self.spec.step_override(instance, self.solve_cfg,
                                      self.exec_cfg, self._warm,
                                      device=self.service.device)
        if not np.isfinite(np.asarray(out.alloc, dtype=float)).all():
            raise RuntimeError(
                f"tenant {self.tenant!r}: the {self.spec.name!r} step "
                "returned a non-finite allocation; the quarantine retry is "
                "not ported yet (ROADMAP open items §1, item 10)")
        self._warm, self._mode = out.warm_state, "domain"
        return self._wrap(
            instance, out.alloc, metrics=out.metrics, problem=None,
            backend=out.backend, engine=out.engine,
            plan_cache=out.plan_cache, k=out.k,
            warm_fraction=out.warm_fraction, solve_time_s=out.solve_time_s,
            build_time_s=out.build_time_s, iterations=out.iterations,
            raw=out.raw)

    def _step_generic(self, instance: Any) -> Allocation:
        problem = self.spec.make_problem(instance)
        eids = self.spec.ids_of(instance)
        k = self.solve_cfg.k_for(problem.n_entities)
        if k > 1:
            return self._step_pop(instance, problem, eids, k)
        return self._step_full(instance, problem, eids)

    def _step_pop(self, instance, problem, eids, k: int) -> Allocation:
        warm = self._warm if self._mode == "pop" else None
        scfg = dataclasses.replace(self.solve_cfg, k=k)
        res = pop_mod.solve_instance(problem, scfg, self.exec_cfg, warm=warm,
                                     entity_ids=eids,
                                     device=self.service.device)
        _check_diverged(res, f"tenant {self.tenant!r}")
        self._warm, self._mode = res, "pop"
        cache = {"reused": "hit", "repaired": "repair"}.get(
            res.plan_source, "miss")
        wf = res.warm_stats["warm_fraction"] if res.warm_stats else None
        return self._wrap(
            instance, res.alloc, metrics=None, problem=problem,
            backend=res.backend,
            engine=res.engine, plan_cache=cache, k=res.plan.k,
            warm_fraction=wf, solve_time_s=res.solve_time_s,
            build_time_s=res.build_time_s,
            iterations=int(np.asarray(res.iterations).sum()), raw=res)

    def _step_full(self, instance, problem, eids) -> Allocation:
        # k=1: the flat LP has no per-entity remap, so warm only while the
        # entity identity sequence is unchanged
        ids_key = (tuple(np.asarray(eids).tolist()) if eids is not None
                   else ("pos", problem.n_entities))
        warm = self._warm if self._mode == "full" else None
        if warm is not None and ids_key != self._full_ids:
            warm = None
        fr = pop_mod.solve_full_ex(problem, warm=warm,
                                   exec_cfg=self.exec_cfg,
                                   device=self.service.device)
        _check_diverged(fr.res, f"tenant {self.tenant!r}")
        self._warm, self._mode = fr.res, "full"
        self._full_ids = ids_key
        return self._wrap(
            instance, fr.alloc, metrics=None, problem=problem,
            backend=fr.backend,
            engine=fr.engine, plan_cache="full", k=1,
            warm_fraction=None if warm is None else 1.0,
            solve_time_s=fr.solve_time_s, build_time_s=fr.build_time_s,
            iterations=int(np.asarray(fr.res.iterations).sum()), raw=fr)

    def _wrap(self, instance, raw_alloc, *, metrics, problem, backend,
              engine, plan_cache, k, warm_fraction, solve_time_s,
              build_time_s, iterations, raw) -> Allocation:
        """The :class:`Allocation` of a step; ``metrics`` None asks the
        domain for them (a ``step_override`` brings its own)."""
        alloc = raw_alloc
        if self.spec.round is not None and self.spec.step_override is None:
            alloc = self.spec.round(instance, raw_alloc)
        if metrics is None:
            metrics = self.spec.metrics_of(instance, problem, alloc)
        return Allocation(
            domain=self.spec.name, tenant=self.tenant, step=self.steps,
            alloc=alloc, metrics=metrics, backend=backend, engine=engine,
            plan_cache=plan_cache, k=k, warm_fraction=warm_fraction,
            solve_time_s=solve_time_s, build_time_s=build_time_s,
            iterations=iterations, raw=raw)


class PopService:
    """Long-lived, multi-tenant POP solving service on one device.

    ``device`` defaults to the CUDA device; with none present the
    constructor raises (pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, solve: Optional[SolveConfig] = None,
                 exec: Optional[ExecConfig] = None, *, device=None,
                 dispatch=None, max_resident: Optional[int] = None,
                 profile=None):
        for value, what, item in (
                (dispatch, "dispatch= — the micro-batching dispatcher", "11"),
                (max_resident, "max_resident= — session paging", "10"),
                (profile, "profile= — the SLO tuner", "12")):
            if value is not None:
                raise _not_ported(what, item)
        self.device = backends_mod.resolve_device(device)
        # None means "not set" (domain defaults win)
        self._service_solve = solve
        self._service_exec = exec
        self._lock = threading.RLock()
        self._sessions: Dict[str, PopSession] = {}
        self._stats = _zeros()

    def session(self, tenant: str, instance: Any = None, *,
                domain: Optional[str] = None,
                solve: Optional[SolveConfig] = None,
                exec: Optional[ExecConfig] = None,
                slo=None) -> PopSession:
        """The session for ``tenant``, created on first use.  The domain
        comes from ``domain=`` or is inferred from ``instance``'s type;
        configs default to the domain's registered defaults, overridden by
        the service-level configs, then by ``solve=`` / ``exec=``.  An
        existing session keeps the configs it was created with."""
        if slo is not None:
            raise _not_ported("session(slo=) — the SLO tuner", "12")
        with self._lock:
            sess = self._sessions.get(tenant)
            if sess is not None:
                if solve is not None and solve != sess.solve_cfg:
                    raise ValueError(
                        f"tenant {tenant!r} session is pinned to "
                        f"{sess.solve_cfg}; end_session() it to re-create "
                        f"with {solve} (configs are set at session creation)")
                if exec is not None and exec != sess.exec_cfg:
                    raise ValueError(
                        f"tenant {tenant!r} session is pinned to "
                        f"{sess.exec_cfg}; end_session() it to re-create "
                        f"with {exec} (configs are set at session creation)")
            if domain is not None:
                spec = registry_mod.get(domain)
            elif instance is not None:
                spec = registry_mod.spec_for(instance)
                if spec is None:
                    raise ValueError(
                        f"no registered domain matches instance type "
                        f"{type(instance).__name__!r}; register a DomainSpec "
                        "with that instance_types or pass domain=")
            elif sess is not None:
                return sess
            else:
                raise ValueError("session() needs an instance (to infer the "
                                 "domain) or an explicit domain= name")
            if sess is not None:
                if sess.spec.name != spec.name:
                    raise ValueError(
                        f"tenant {tenant!r} already has a {sess.spec.name!r} "
                        f"session; one tenant cannot switch to {spec.name!r}")
                return sess
            solve_cfg = solve or self._service_solve or spec.default_solve
            exec_cfg = exec or self._service_exec or spec.default_exec
            sess = PopSession(self, tenant, spec, solve_cfg, exec_cfg)
            self._sessions[tenant] = sess
            return sess

    def end_session(self, tenant: str) -> None:
        """Drop a tenant's session and its warm state."""
        with self._lock:
            self._sessions.pop(tenant, None)

    def tenants(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._sessions))

    def stats(self) -> dict:
        """Service-wide step counts, plan-cache hit rate, aggregate solve
        time, mean warm fraction and per-engine step counts."""
        with self._lock:
            s = dict(self._stats)
            s["engines"] = dict(s["engines"])
            s["n_sessions"] = len(self._sessions)
        steps = max(s["steps"], 1)
        s["plan_hit_rate"] = s["plan_hits"] / steps
        s["warm_fraction_mean"] = (s["warm_fraction_sum"] / s["warm_steps"]
                                   if s["warm_steps"] else None)
        return s
