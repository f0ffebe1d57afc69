"""PopService: the public door to POP — the port of the synchronous,
fault-tolerant core of ``repro/service.py``.

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

Serving is fault-tolerant, as the reference's: ``step`` never returns a
non-finite allocation.  Diverged solver lanes (``POPResult.diverged``,
flagged in-loop by ``pdhg.solve_stacked``) quarantine the poisoned warm
state and cold-restart only those lanes (``pop.solve_instance(
cold_lanes=)``); ``step(deadline_s=...)`` budgets iterations from a
measured per-iteration rate and degrades down a ladder (full solve ->
capped solve with one tolerance notch back -> a single convergence-check
chunk -> the previous allocation or the domain's ``greedy`` hook);
``Allocation.status`` reports the rung (``ok``/``degraded``/
``recovered``/``fallback``).  :meth:`PopService.checkpoint` /
:meth:`PopService.restore` serialize every tenant's warm state to bytes in
the reference's ``POPSES1`` format (``repro_torch.checkpoint``), readable
by either package; corrupt or stale blobs degrade to cold starts.
``max_resident=`` bounds how many tenants keep live warm state: the
least recently stepped page out to a host-memory blob store and restore
on ``session()`` re-entry or on a step through an old handle.

A service constructed with ``dispatch=`` (``True`` or a
:class:`DispatchConfig`) runs every session's map-step launch through a
**micro-batching dispatcher**: concurrent tenants' same-shape sub-problem
stacks go to the device as ONE ``solve_stacked`` launch
(``core/backends.py:coalesce_key`` decides which may share,
``pdhg.concat_stacks`` pads structured ELL widths across tenants).
``PopSession.step_async`` is the concurrent entry point (a
``Future[Allocation]``); lanes are independent in the solver, so a
tenant's result does not depend on who shared its launch.
:meth:`PopService.close` stops the dispatcher and the ``step_async`` pool.

``PopService(profile=...)`` takes a measured
:class:`~repro_torch.tuning.TuningProfile` (or its path): validated at the
door, it installs the measured ``backend="auto"`` thresholds, sizes
``dispatch=True``'s :class:`DispatchConfig` from its launch-cost line and
plans ``session(..., slo=SLOTarget(...))`` sessions, whose
:class:`~repro_torch.tuning.OnlineTuner` re-plans k on violated or newly
slack SLOs (``stats()["slo_violations"]``/``["retunes"]``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import tracing
from .checkpoint import paged as paged_mod
from .checkpoint import session_state as ckpt_mod
from .core import backends as backends_mod
from .core import pop as pop_mod
from .core.config import ExecConfig, SolveConfig
from .core.pdhg import SolveResult
from .core.plan import PopPlan, _host
from .domains import DomainSpec, StepOutcome, registry as registry_mod
from .tuning import (OnlineTuner, SLOTarget, TuningProfile, check_profile,
                     launch_defaults, load_profile)

__all__ = ["Allocation", "DispatchConfig", "MicroBatchDispatcher",
           "PopService", "PopSession"]

# default cap on the deadline ladder's per-(path, domain, config, shape)
# rate/overhead EMA maps — a fleet churning through instance shapes would
# otherwise grow them without bound
RATE_CACHE_SIZE = 4096


class _BoundedLRU(OrderedDict):
    """Bounded LRU mapping for the rate/overhead EMA caches: reads and
    writes refresh recency, inserts beyond ``maxsize`` evict the coldest
    key and count it.  NOT itself thread-safe — PopService holds its lock
    around every access."""

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = int(maxsize)
        self.evictions = 0

    def get(self, key, default=None):
        if key in self:
            super().move_to_end(key)
            return super().__getitem__(key)
        return default

    def __setitem__(self, key, value):
        if key in self:
            super().move_to_end(key)
        super().__setitem__(key, value)
        while len(self) > self.maxsize:
            super().popitem(last=False)
            self.evictions += 1


@dataclasses.dataclass
class Allocation:
    """One session step's outcome — the uniform cross-domain result.

    ``plan_cache`` is "hit" (previous plan reused verbatim), "repair"
    (incrementally repaired under churn), "miss" (fresh plan), "full"
    (unpartitioned k=1 path) or "fallback" (no solve ran);
    ``backend``/``engine`` are what ran.  ``status`` is the ladder rung the
    step landed on: ``"ok"``, ``"degraded"`` (a deadline-capped budget),
    ``"recovered"`` (a fault was quarantined and re-solved) or
    ``"fallback"`` (``alloc`` is the previous allocation or the domain's
    greedy); ``faults`` lists what happened on the way
    (``"divergence:2"``, ``"deadline:capped"``, ``"warm-state-mismatch"``,
    ...), empty on clean steps.  ``solve_time_s`` is the map step's wall
    time, ended by its readback; ``build_time_s`` the host's time to issue
    the build (``PreparedSolve.build_time_s``: no device synchronize of
    its own)."""

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
            "warm_steps": 0,
            # fault-tolerance counters: ladder rungs taken, solver lanes
            # cold-restarted by the divergence guard, faults recorded,
            # checkpoint restore outcomes
            "degraded_steps": 0, "recovered_steps": 0, "fallback_steps": 0,
            "quarantined_lanes": 0, "faults": 0,
            "checkpoint_restores": 0, "checkpoint_failures": 0,
            # SLO tuning counters: steps whose measured latency or quality
            # breached the session's SLOTarget, and the config moves the
            # online tuner made in response
            "slo_violations": 0, "retunes": 0,
            "engines": {}}


def _tally(stats: dict, alloc: Allocation) -> None:
    stats["steps"] += 1
    if alloc.status != "fallback":   # no solve ran: no plan-cache verdict
        key = {"hit": "plan_hits", "repair": "plan_repairs",
               "full": "full_solves"}.get(alloc.plan_cache, "plan_misses")
        stats[key] += 1
    if alloc.status != "ok":
        stats[alloc.status + "_steps"] += 1
    stats["faults"] += len(alloc.faults)
    stats["solve_time_s"] += alloc.solve_time_s
    if alloc.engine:
        eng = stats["engines"]
        eng[alloc.engine] = eng.get(alloc.engine, 0) + 1
    if alloc.warm_fraction is not None:
        stats["warm_fraction_sum"] += alloc.warm_fraction
        stats["warm_steps"] += 1


def _finite(alloc) -> bool:
    """Is every numeric entry of an allocation finite?"""
    try:
        arr = np.asarray(alloc, dtype=float)
    except (TypeError, ValueError):
        return True     # non-numeric allocation: nothing to check
    return bool(np.isfinite(arr).all())


def _pop_warm_ok(warm) -> bool:
    """Is a pop-mode warm state internally consistent (plan present,
    iterates present and shaped as the plan says)?  Catches dropped or
    mismatched warm state — a bad restore, an injector, a stale seed —
    BEFORE it reaches the solver."""
    plan = getattr(warm, "plan", None)
    x, y = getattr(warm, "x", None), getattr(warm, "y", None)
    if plan is None or x is None or y is None:
        return False
    shapes = getattr(plan, "shapes", None) or {}
    for name, arr in (("x", x), ("y", y)):
        want = shapes.get(name)
        if want is not None and tuple(np.shape(arr)) != tuple(want):
            return False
    return True


def _count_diverged(res) -> int:
    div = getattr(res, "diverged", None)
    return 0 if div is None else int(np.asarray(div).sum())


# --------------------------------------------------------------------------
# the micro-batching dispatcher: cross-tenant coalesced map-step launches
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Tuning for :class:`MicroBatchDispatcher`.

    ``max_lanes`` caps a coalesced launch's lane count (the sum of the
    grouped tenants' k); ``max_wait_ms`` is the micro-batch window: from the
    first ticket's arrival the dispatcher collects company until the window
    closes or ``max_lanes`` fills (a saturated queue fills the group with no
    added wait); ``pad_pow2`` pads each coalesced launch's lane count up to
    the next power of two with replica lanes, so variable group sizes give
    O(log max_lanes) distinct stack shapes; ``workers`` sizes the service's
    ``step_async`` thread pool."""

    max_lanes: int = 64
    max_wait_ms: float = 2.0
    pad_pow2: bool = True
    workers: int = 8


class _Ticket:
    """One tenant's prepared map-step launch, queued for dispatch."""

    __slots__ = ("key", "batch", "prep", "K_mv", "KT_mv", "future")

    def __init__(self, key, batch, prep, K_mv, KT_mv, future):
        self.key = key
        self.batch = batch
        self.prep = prep
        self.K_mv = K_mv
        self.KT_mv = KT_mv
        self.future = future


def _on_device(device):
    """A context that makes ``device`` the thread's current CUDA device
    (nothing to do for the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class MicroBatchDispatcher:
    """Coalesces concurrent tenants' prepared map-step launches.

    Sessions prepare their solves on their own threads
    (``pop.prepare_instance`` / ``pop.prepare_full``: plan, ELL packing,
    the upload to the device) and submit the launch here; one worker thread
    drains the queue, groups tickets by :func:`repro_torch.core.backends.
    coalesce_key`, runs ONE map-backend call per group and slices the
    per-tenant results back out.  Lanes are independent in
    ``solve_stacked``, so a tenant's lanes follow the trajectory of a solo
    launch; warm chains, plan provenance and the degradation ladder live in
    the session layer above and never see the sharing.

    The worker launches with ``device`` as its current CUDA device, on the
    device's default stream, the stream the callers uploaded on.  A failed
    group launch falls back to per-ticket solo launches, so one tenant's
    pathological batch cannot fail its peers: only its own caller sees the
    exception (which the session ladder then handles)."""

    def __init__(self, cfg: Optional[DispatchConfig] = None, *, device=None):
        self.cfg = cfg or DispatchConfig()
        self.device = device
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._gate = threading.Event()
        self._gate.set()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._counts = {
            "requests": 0, "launches": 0, "lanes": 0,
            "coalesced_launches": 0, "coalesced_requests": 0,
            "solo_launches": 0, "group_fallbacks": 0, "max_group": 0}
        self._thread = threading.Thread(target=self._loop,
                                        name="pop-dispatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client --
    def solve_prepared(self, prep, K_mv, KT_mv):
        """Run one :class:`~repro_torch.core.pop.PreparedSolve`'s map-step
        launch, blocking until its :class:`SolveResult` is ready.  Returns
        ``(result, solve_time_s)``, the time being this tenant's
        lane-weighted share of the launch's wall time.  Launches that
        cannot share (the single-lane streaming engine, unhashable configs)
        run inline on the calling thread, as do all launches once the
        dispatcher is closed."""
        batch = backends_mod.make_batch(prep.ops, prep.warm)
        key = backends_mod.coalesce_key(prep.ops, K_mv, KT_mv, prep.backend,
                                        prep.engine, prep.solver_kw,
                                        prep.opts)
        with self._lock:
            self._counts["requests"] += 1
        if key is None or not self._thread.is_alive():
            tk = _Ticket(None, batch, prep, K_mv, KT_mv, None)
            t1 = time.perf_counter()
            res = self._launch(batch, tk)
            wall = time.perf_counter() - t1
            with self._lock:
                self._counts["launches"] += 1
                self._counts["solo_launches"] += 1
                self._counts["lanes"] += backends_mod.batch_size(batch)
            return res, wall
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._q.put(_Ticket(key, batch, prep, K_mv, KT_mv, fut))
        return fut.result()

    def hold(self):
        """Context manager pausing batch collection: requests queue up
        while held and dispatch in one sweep on release (deterministic
        maximal coalescing for tests and benchmarks)."""
        dispatcher = self

        class _Hold:
            def __enter__(self):
                dispatcher._gate.clear()
                return dispatcher

            def __exit__(self, *exc):
                dispatcher._gate.set()
                return False

        return _Hold()

    def stats(self) -> dict:
        """The counters and two ratios: ``batching_ratio``, requests served
        per launch (above 1 when launches are shared), and
        ``lanes_per_launch``, the mean stacked lane count (replica lanes
        not counted)."""
        with self._lock:
            s = dict(self._counts)
        served = s["coalesced_requests"] + s["solo_launches"]
        s["batching_ratio"] = served / max(s["launches"], 1)
        s["lanes_per_launch"] = s["lanes"] / max(s["launches"], 1)
        return s

    def close(self) -> None:
        """Stop the worker thread and wait for it (idempotent); later
        requests launch inline on their callers' threads."""
        self._stop.set()
        self._gate.set()
        self._q.put(None)
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- worker --
    def _loop(self) -> None:
        with _on_device(self.device):
            while not self._stop.is_set():
                self._gate.wait(timeout=0.25)
                if not self._gate.is_set():
                    continue
                try:
                    first = self._q.get(timeout=0.25)
                except queue.Empty:
                    continue
                if first is None:
                    continue
                # a hold() that began while we were blocked in get(): keep
                # the ticket and wait the hold out, so it joins the sweep
                while not self._gate.is_set() and not self._stop.is_set():
                    self._gate.wait(timeout=0.25)
                tickets = [first]
                lanes = self._drain(tickets,
                                    backends_mod.batch_size(first.batch))
                if lanes < self.cfg.max_lanes and self.cfg.max_wait_ms > 0:
                    # the micro-batch window, from the first ticket's
                    # arrival: it costs latency only under sparse traffic
                    deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
                    while lanes < self.cfg.max_lanes:
                        rem = deadline - time.perf_counter()
                        if rem <= 0:
                            break
                        try:
                            t = self._q.get(timeout=rem)
                        except queue.Empty:
                            break
                        if t is None:
                            continue
                        tickets.append(t)
                        lanes += backends_mod.batch_size(t.batch)
                        lanes = self._drain(tickets, lanes)
                groups: "OrderedDict[tuple, list]" = OrderedDict()
                for t in tickets:
                    groups.setdefault(t.key, []).append(t)
                for grp in groups.values():
                    self._run_group(grp)

    def _drain(self, tickets: list, lanes: int) -> int:
        while lanes < self.cfg.max_lanes:
            try:
                t = self._q.get_nowait()
            except queue.Empty:
                return lanes
            if t is None:
                continue
            tickets.append(t)
            lanes += backends_mod.batch_size(t.batch)
        return lanes

    def _launch(self, batch, tk) -> SolveResult:
        """One map-backend call; its numpy result means the device is done
        with it."""
        prep = tk.prep
        with tracing.span("pop.solve_map", lanes=int(batch[0].c.shape[0])):
            return backends_mod.get_backend(prep.backend)(
                batch, tk.K_mv, tk.KT_mv, dict(prep.solver_kw),
                engine=prep.engine, **prep.opts)

    def _run_group(self, grp: list) -> None:
        if len(grp) > 1:
            t1 = time.perf_counter()
            try:
                batch, sizes = backends_mod.concat_batches(
                    [t.batch for t in grp])
                total = sum(sizes)
                if self.cfg.pad_pow2:
                    batch, _ = backends_mod.pad_lanes_pow2(batch)
                res = self._launch(batch, grp[0])
                parts = backends_mod.split_result(res, sizes)
                wall = time.perf_counter() - t1
                with self._lock:
                    self._counts["launches"] += 1
                    self._counts["lanes"] += total
                    self._counts["coalesced_launches"] += 1
                    self._counts["coalesced_requests"] += len(grp)
                    self._counts["max_group"] = max(
                        self._counts["max_group"], len(grp))
                for tk, part, s in zip(grp, parts, sizes):
                    tk.future.set_result((part, wall * (s / total)))
                return
            except Exception:
                # a shared launch must not take its peers down with one bad
                # tenant: every ticket retries solo, and only the bad
                # tenant's caller sees its exception
                with self._lock:
                    self._counts["group_fallbacks"] += 1
        for tk in grp:
            t1 = time.perf_counter()
            try:
                res = self._launch(tk.batch, tk)
                wall = time.perf_counter() - t1
                with self._lock:
                    self._counts["launches"] += 1
                    self._counts["solo_launches"] += 1
                    self._counts["lanes"] += backends_mod.batch_size(tk.batch)
                tk.future.set_result((res, wall))
            except BaseException as e:      # noqa: BLE001 — forwarded
                tk.future.set_exception(e)
                if not isinstance(e, Exception):
                    raise


class PopSession:
    """One tenant's stateful solving loop for one domain; create through
    :meth:`PopService.session`."""

    def __init__(self, service: "PopService", tenant: str, spec: DomainSpec,
                 solve_cfg: SolveConfig, exec_cfg: ExecConfig,
                 slo: Optional[SLOTarget] = None,
                 tuner: Optional[OnlineTuner] = None):
        self.service = service
        self.tenant = tenant
        self.spec = spec
        self.solve_cfg = solve_cfg
        self.exec_cfg = exec_cfg
        # the SLO contract + online tuner (None = untuned).  The tuner
        # retunes by REPLACING solve_cfg between steps; the change flows
        # through prepare_instance's repair/remap path so warm state
        # survives
        self.slo = slo
        self._tuner = tuner
        self.steps = 0
        self.last: Optional[Allocation] = None
        self.stats = _zeros()
        # serializes step()/checkpoint/page-out for THIS tenant.  Lock
        # order: a session lock may take the service lock (stats tally,
        # rate notes) but NEVER the reverse — service-side paths that need
        # both (eviction, checkpoint) release the service lock first
        self._lock = threading.RLock()
        # warm state: a POPResult (pop path), a SolveResult (+ the ids it
        # is FOR, full path), or whatever a step_override domain carries
        self._warm: Any = None
        self._mode: Optional[str] = None
        self._full_ids: Optional[tuple] = None
        # wall time of the most recent step (the deadline predictor for
        # step_override domains, which have no iteration-rate model)
        self._last_wall: Optional[float] = None

    # ------------------------------------------------------------------ api --
    def seed(self, warm_state: Any, mode: Optional[str] = None,
             entity_ids=None) -> "PopSession":
        """Adopt externally carried warm state (a session restored from a
        previous process, or a hand-carried result).

        ``mode`` is inferred from the state's type when omitted: a
        :class:`~repro_torch.core.pop.POPResult` seeds the pop path, a
        :class:`~repro_torch.core.pop.FullResult` / ``SolveResult`` the k=1
        full path, anything else the domain's own ``step_override`` state.
        An explicit ``mode`` is validated against the state's type.
        Full-path state also needs ``entity_ids`` — the ids the iterates
        are FOR (the plain entity COUNT for domains without an
        ``entity_ids`` hook); without them the first step starts cold."""
        if warm_state is None:
            self._warm, self._mode = None, None
            return self
        if mode is None:
            if isinstance(warm_state, pop_mod.POPResult):
                mode = "pop"
            elif isinstance(warm_state, (pop_mod.FullResult, SolveResult)):
                mode = "full"
            else:
                mode = "domain"
        elif mode not in ("pop", "full", "domain"):
            raise ValueError(f"seed(): unknown mode {mode!r}; expected "
                             "'pop', 'full' or 'domain'")
        if mode == "pop":
            if not isinstance(warm_state, pop_mod.POPResult):
                raise TypeError(
                    f"seed(mode='pop') needs a POPResult, got "
                    f"{type(warm_state).__name__} — pass mode='full' for "
                    "FullResult/SolveResult state or mode='domain' for a "
                    "step_override domain's own state")
            if warm_state.x is None or warm_state.y is None:
                raise ValueError(
                    "seed(mode='pop'): POPResult carries no solver "
                    "iterates (x/y are None) — it cannot warm-start")
        if mode == "full":
            if not isinstance(warm_state, (pop_mod.FullResult, SolveResult)):
                raise TypeError(
                    f"seed(mode='full') needs a FullResult or SolveResult, "
                    f"got {type(warm_state).__name__} — pass mode='pop' "
                    "for POPResult state")
            if isinstance(warm_state, pop_mod.FullResult):
                warm_state = warm_state.res
            if entity_ids is None:
                self._full_ids = None
            elif np.isscalar(entity_ids):
                # positional domains: the alignment key is the count
                self._full_ids = ("pos", int(entity_ids))
            else:
                self._full_ids = tuple(np.asarray(entity_ids).tolist())
        self._warm = warm_state
        self._mode = mode
        return self

    def step(self, instance: Any, *,
             deadline_s: Optional[float] = None) -> Allocation:
        """Solve the (updated) instance, warm-started from the previous
        step wherever the domain allows.  The single online entry point.

        ``deadline_s`` bounds the step's wall time: the iteration budget
        comes from the measured per-iteration rate of earlier steps with
        the same (domain, ExecConfig, shape), and the step degrades down
        the ladder when the budget is short (``Allocation.status``).
        Without a deadline the step runs the session's ExecConfig as is."""
        with tracing.span("pop.step") as span:
            with self._lock:
                self.service._reattach(self)
                t0 = time.perf_counter()
                if self.spec.step_override is not None:
                    alloc = self._step_override(instance, deadline_s, t0)
                else:
                    alloc = self._step_generic(instance, deadline_s, t0)
                self.steps += 1
                self._last_wall = time.perf_counter() - t0
                if self._tuner is not None and alloc.status != "fallback":
                    self._observe_tuned(alloc)
                _tally(self.stats, alloc)
                with self.service._lock:
                    _tally(self.service._stats, alloc)
                self.last = alloc
            self.service._after_step(self)
            span.set(plan_cache=alloc.plan_cache)
        return alloc

    def step_async(self, instance: Any, *,
                   deadline_s: Optional[float] = None
                   ) -> "concurrent.futures.Future":
        """Submit :meth:`step` to the service's thread pool; returns a
        ``Future[Allocation]``.  Steps of ONE session serialize on the
        session lock (warm chains stay ordered); steps of different
        sessions run concurrently, and when the service has a dispatcher
        their map-step launches coalesce into shared device launches."""
        return self.service._submit(self.step, instance,
                                    deadline_s=deadline_s)

    # ------------------------------------------------- step_override domains --
    def _step_override(self, instance: Any, deadline_s: Optional[float],
                       t0: float) -> Allocation:
        faults: list = []
        # no iteration-rate model for domain-run pipelines: if the last
        # step's wall time already blows the deadline, skip the solve
        if (deadline_s is not None and self._last_wall is not None
                and self._last_wall > deadline_s
                and (self.last is not None or self.spec.greedy is not None)):
            return self._fallback(instance, ["deadline"], t0)
        out = None
        attempts = [self._warm] + ([None] if self._warm is not None else [])
        for i, warm in enumerate(attempts):
            try:
                cand: StepOutcome = self.spec.step_override(
                    instance, self.solve_cfg, self.exec_cfg, warm,
                    device=self.service.device)
            except Exception as e:
                faults.append(f"step-error:{type(e).__name__}")
                continue
            if not _finite(cand.alloc):
                faults.append("nonfinite-alloc")
                continue
            out = cand
            if i > 0:
                faults.append("warm-quarantined")
            break
        if out is None:
            self._warm, self._mode = None, None
            return self._fallback(instance, faults, t0)
        self._warm, self._mode = out.warm_state, "domain"
        return self._wrap(
            instance, out.alloc, metrics=out.metrics, problem=None,
            backend=out.backend, engine=out.engine,
            plan_cache=out.plan_cache, k=out.k,
            warm_fraction=out.warm_fraction, solve_time_s=out.solve_time_s,
            build_time_s=out.build_time_s, iterations=out.iterations,
            raw=out.raw, status="recovered" if faults else "ok",
            faults=faults)

    # ------------------------------------------------------- generic domains --
    def _step_generic(self, instance: Any, deadline_s: Optional[float],
                      t0: float) -> Allocation:
        problem = self.spec.make_problem(instance)
        eids = self.spec.ids_of(instance)
        if self._tuner is not None:
            # sessions created without an instance plan on first step
            cfg = self._tuner.ensure_planned(problem.n_entities,
                                             self.solve_cfg)
            if cfg is not None:
                self.solve_cfg = cfg
        k = self.solve_cfg.k_for(problem.n_entities)
        if k > 1:
            return self._step_pop(instance, problem, eids, k, deadline_s, t0)
        return self._step_full(instance, problem, eids, deadline_s, t0)

    def _step_pop(self, instance, problem, eids, k: int,
                  deadline_s: Optional[float], t0: float) -> Allocation:
        faults: list = []
        warm = self._warm if self._mode == "pop" else None
        if warm is not None and not _pop_warm_ok(warm):
            faults.append("warm-state-mismatch")
            self._warm, self._mode = None, None
            warm = None
        scfg = dataclasses.replace(self.solve_cfg, k=k)
        rkey = ("pop", self.spec.name, self.exec_cfg, k, problem.n_entities)
        exec_run, rung = self._ladder(rkey, deadline_s, t0)
        if rung == "fallback":
            return self._fallback(instance, faults + ["deadline"], t0,
                                  problem=problem)
        if rung is not None:
            faults.append(f"deadline:{rung}")

        def _solve(w, **kw):
            return self.service._solve_instance(problem, scfg, exec_run,
                                                warm=w, entity_ids=eids, **kw)

        try:
            res = _solve(warm)
        except Exception as e:
            if warm is None:
                raise     # cold-solve errors (bad instance data) are real
            faults.append(f"warm-solve-error:{type(e).__name__}")
            self._warm, self._mode = None, None
            warm = None
            res = _solve(None)

        n_div = _count_diverged(res)
        if n_div and warm is not None:
            # quarantine: cold-restart ONLY the diverged lanes, keep the
            # plan and the healthy lanes' iterates
            faults.append(f"divergence:{n_div}")
            self._note_quarantine(n_div)
            retry = None
            try:
                retry = _solve(warm, plan=res.plan, cold_lanes=res.diverged)
            except Exception as e:
                faults.append(f"warm-solve-error:{type(e).__name__}")
            if retry is None or _count_diverged(retry):
                # the quarantine did not clear it: drop the warm state
                if retry is not None:
                    self._note_quarantine(_count_diverged(retry))
                faults.append("warm-dropped")
                self._warm, self._mode = None, None
                warm = None
                res = _solve(None)
            else:
                res = retry
            n_div = _count_diverged(res)
        if n_div:
            # a COLD solve diverged: the instance itself is pathological
            # at this config — nothing left to quarantine
            faults.append(f"cold-divergence:{n_div}")
            self._note_quarantine(n_div)
            self._warm, self._mode = None, None
            return self._fallback(instance, faults, t0, problem=problem)
        if not _finite(res.alloc):
            faults.append("nonfinite-alloc")
            self._warm, self._mode = None, None
            return self._fallback(instance, faults, t0, problem=problem)

        self._warm, self._mode = res, "pop"
        self._note_rate(rkey, int(np.asarray(res.iterations).max(initial=0)),
                        res.solve_time_s, time.perf_counter() - t0)
        cache = {"reused": "hit", "repaired": "repair"}.get(
            res.plan_source, "miss")
        wf = res.warm_stats["warm_fraction"] if res.warm_stats else None
        return self._wrap(
            instance, res.alloc, metrics=None, problem=problem,
            backend=res.backend, engine=res.engine, plan_cache=cache,
            k=res.plan.k, warm_fraction=wf, solve_time_s=res.solve_time_s,
            build_time_s=res.build_time_s,
            iterations=int(np.asarray(res.iterations).sum()), raw=res,
            status=self._status_of(faults, rung), faults=faults)

    def _step_full(self, instance, problem, eids,
                   deadline_s: Optional[float], t0: float) -> Allocation:
        # k=1: the flat LP has no per-entity remap, so warm only while the
        # entity identity sequence is unchanged; crossing the pop<->full
        # mode boundary drops warm
        faults: list = []
        ids_key = (tuple(np.asarray(eids).tolist()) if eids is not None
                   else ("pos", problem.n_entities))
        warm = self._warm if self._mode == "full" else None
        if warm is not None and (self._full_ids is None
                                 or ids_key != self._full_ids):
            warm = None
        rkey = ("full", self.spec.name, self.exec_cfg, 1, problem.n_entities)
        exec_run, rung = self._ladder(rkey, deadline_s, t0)
        if rung == "fallback":
            return self._fallback(instance, faults + ["deadline"], t0,
                                  problem=problem)
        if rung is not None:
            faults.append(f"deadline:{rung}")

        try:
            fr = self.service._solve_full(problem, warm, exec_run)
        except Exception as e:
            if warm is None:
                raise
            faults.append(f"warm-solve-error:{type(e).__name__}")
            self._warm, self._mode = None, None
            warm = None
            fr = self.service._solve_full(problem, None, exec_run)
        if _count_diverged(fr.res) and warm is not None:
            # k=1 has a single lane: quarantine == full cold restart
            faults.append("divergence:1")
            self._note_quarantine(1)
            self._warm, self._mode = None, None
            warm = None
            fr = self.service._solve_full(problem, None, exec_run)
        if _count_diverged(fr.res):
            faults.append("cold-divergence:1")
            self._note_quarantine(1)
            self._warm, self._mode = None, None
            return self._fallback(instance, faults, t0, problem=problem)
        if not _finite(fr.alloc):
            faults.append("nonfinite-alloc")
            self._warm, self._mode = None, None
            return self._fallback(instance, faults, t0, problem=problem)

        self._warm, self._mode = fr.res, "full"
        self._full_ids = ids_key
        self._note_rate(rkey,
                        int(np.asarray(fr.res.iterations).max(initial=0)),
                        fr.solve_time_s, time.perf_counter() - t0)
        return self._wrap(
            instance, fr.alloc, metrics=None, problem=problem,
            backend=fr.backend, engine=fr.engine, plan_cache="full", k=1,
            warm_fraction=None if warm is None else 1.0,
            solve_time_s=fr.solve_time_s, build_time_s=fr.build_time_s,
            iterations=int(np.asarray(fr.res.iterations).sum()), raw=fr,
            status=self._status_of(faults, rung), faults=faults)

    # ---------------------------------------------- degradation ladder rungs --
    @staticmethod
    def _status_of(faults: list, rung: Optional[str]) -> str:
        if any(not f.startswith("deadline") for f in faults):
            return "recovered"
        return "degraded" if rung is not None else "ok"

    def _ladder(self, rkey: tuple, deadline_s: Optional[float],
                t0: float):
        """Pick the ExecConfig for this step under the deadline.

        Returns ``(exec_cfg, rung)`` with rung ``None`` (full budget, the
        session's own ExecConfig), ``"capped"`` (iteration cap + one
        tolerance notch back), ``"best-effort"`` (a single
        convergence-check chunk), or ``"fallback"`` (not even one chunk
        fits — skip the solve).  Budgets are quantized to power-of-two
        multiples of ``check_every``, as the reference's, so equal rates
        pick equal rungs in both packages."""
        if deadline_s is None:
            return self.exec_cfg, None
        with self.service._lock:
            rate = self.service._rates.get(rkey)
            overhead = self.service._overheads.get(rkey, 0.0)
        if rate is None or rate <= 0.0:
            return self.exec_cfg, None     # no measurement yet: run full
        remaining = deadline_s - (time.perf_counter() - t0) - overhead
        kw = self.exec_cfg.solver_dict()
        max_it = int(kw.get("max_iters", 20_000))
        ce = int(kw.get("check_every", 40))
        budget = int(remaining / rate) if remaining > 0 else 0
        if budget >= max_it:
            return self.exec_cfg, None
        if budget < ce:
            return None, "fallback"
        q = ce
        while q * 2 <= budget:
            q *= 2
        kw["max_iters"] = int(min(q, max_it))
        # a capped solve gets one tolerance notch back: better a looser
        # answer within budget than a tight one never reached
        kw["tol_primal"] = float(kw.get("tol_primal", 1e-4)) * 10.0
        kw["tol_gap"] = float(kw.get("tol_gap", 1e-4)) * 10.0
        rung = "best-effort" if q == ce else "capped"
        return dataclasses.replace(self.exec_cfg, solver_kw=kw), rung

    def _note_rate(self, rkey: tuple, iters: int, solve_time_s: float,
                   wall_s: float) -> None:
        """EMA-update the measured per-iteration rate and per-step overhead
        (the step's wall outside the solve: plan, build, reduce) for this
        (domain, ExecConfig, shape) — what :meth:`_ladder` budgets from."""
        if iters <= 0 or solve_time_s <= 0.0:
            return
        with self.service._lock:
            rates = self.service._rates
            r = solve_time_s / iters
            old = rates.get(rkey)
            rates[rkey] = r if old is None else 0.5 * old + 0.5 * r
            overheads = self.service._overheads
            ov = max(wall_s - solve_time_s, 0.0)
            o = overheads.get(rkey)
            overheads[rkey] = ov if o is None else 0.5 * o + 0.5 * ov

    def _note_quarantine(self, n: int) -> None:
        self.stats["quarantined_lanes"] += n
        with self.service._lock:
            self.service._stats["quarantined_lanes"] += n

    # ------------------------------------------------- SLO online refiner --
    def _observe_tuned(self, alloc: Allocation) -> None:
        """Feed one step that solved into the session's OnlineTuner; count
        SLO violations and apply a retuned SolveConfig for the NEXT step
        (this step's allocation is already final).  Called under the
        session lock."""
        quality = self.spec.quality_of(alloc.metrics)
        ev = self._tuner.observe(alloc.k, alloc.solve_time_s, quality)
        if ev.violation is not None:
            self.stats["slo_violations"] += 1
            with self.service._lock:
                self.service._stats["slo_violations"] += 1
        if ev.new_solve is not None and ev.new_solve != self.solve_cfg:
            self.solve_cfg = ev.new_solve
            self.stats["retunes"] += 1
            with self.service._lock:
                self.service._stats["retunes"] += 1

    def _fallback(self, instance, faults: list, t0: float,
                  problem=None) -> Allocation:
        """The ladder's last rung: repeat the previous allocation, else ask
        the domain's greedy hook.  Never returns non-finite data; raises
        only when there is nothing to serve."""
        spec = self.spec
        alloc, source = None, None
        if self.last is not None and _finite(self.last.alloc):
            alloc, source = self.last.alloc, "previous-allocation"
        elif spec.greedy is not None:
            alloc, source = np.asarray(spec.greedy(instance)), "greedy"
        if alloc is None:
            raise RuntimeError(
                f"tenant {self.tenant!r} ({spec.name}): cannot produce an "
                f"allocation — solve failed ({', '.join(faults) or 'n/a'}) "
                "and the session has no previous allocation and the domain "
                "registers no greedy= fallback hook")
        try:
            metrics = dict(spec.metrics_of(instance, problem, alloc))
        except Exception as e:
            # fallback must not die computing metrics for an allocation
            # that was never meant for this exact instance
            metrics = {"metrics_error": f"{type(e).__name__}: {e}"}
        metrics["fallback_source"] = source
        # no rounding hook: a previous allocation is already rounded, and
        # greedy hooks return final allocations
        return Allocation(
            domain=spec.name, tenant=self.tenant, step=self.steps,
            alloc=alloc, metrics=metrics, backend=None, engine=None,
            plan_cache="fallback", k=0, warm_fraction=None,
            solve_time_s=time.perf_counter() - t0, build_time_s=0.0,
            iterations=0, raw=None, status="fallback",
            faults=tuple(faults) if faults else ("deadline",))

    def _wrap(self, instance, raw_alloc, *, metrics, problem, backend,
              engine, plan_cache, k, warm_fraction, solve_time_s,
              build_time_s, iterations, raw, status="ok",
              faults=()) -> Allocation:
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
            iterations=iterations, raw=raw, status=status,
            faults=tuple(faults))

    # ------------------------------------------------------ checkpoint hooks --
    def _checkpoint_payload(self, prefix: str):
        """(meta, host arrays) for this session — see
        :meth:`PopService.checkpoint`.  The layout is the reference's."""
        base = {
            "prefix": prefix,
            "domain": self.spec.name,
            "steps": int(self.steps),
            "solve_cfg": {
                "k": self.solve_cfg.k, "strategy": self.solve_cfg.strategy,
                "seed": self.solve_cfg.seed,
                "replicate_threshold": self.solve_cfg.replicate_threshold,
                "min_per_sub": self.solve_cfg.min_per_sub},
            "exec_cfg": {
                "backend": self.exec_cfg.backend,
                "engine": self.exec_cfg.engine,
                "solver_kw": self.exec_cfg.solver_dict(),
                "backend_opts": self.exec_cfg.opts_dict()},
            "digest": ckpt_mod.config_digest(self.solve_cfg, self.exec_cfg),
        }
        if self._mode == "pop" and isinstance(self._warm, pop_mod.POPResult):
            w = self._warm
            plan = w.plan
            if (plan is None or w.x is None or w.y is None
                    or plan.replication is not None):
                return {**base, "mode": "skipped",
                        "reason": "pop warm state without a serializable "
                                  "plan (replicated plans are v1-excluded)"}, {}
            meta = {**base, "mode": "pop", "plan": {
                "k": int(plan.k), "n_entities": int(plan.n_entities),
                "strategy": plan.strategy, "seed": int(plan.seed),
                "shapes": {name: list(v)
                           for name, v in (plan.shapes or {}).items()},
                "has_ids": plan.entity_ids is not None}}
            arrays = {f"{prefix}/x": w.x, f"{prefix}/y": w.y,
                      f"{prefix}/idx": plan.idx,
                      f"{prefix}/entity_of_slot": plan.entity_of_slot,
                      f"{prefix}/alloc": w.alloc,
                      f"{prefix}/iterations": w.iterations,
                      f"{prefix}/converged": w.converged}
            if plan.entity_ids is not None:
                arrays[f"{prefix}/entity_ids"] = plan.entity_ids
            return meta, {k: _host(v) for k, v in arrays.items()}
        if self._mode == "full" and isinstance(self._warm, SolveResult):
            r = self._warm
            if self._full_ids is None:
                ids_kind, ids_val = "none", None
            elif self._full_ids[0] == "pos":
                ids_kind, ids_val = "pos", int(self._full_ids[1])
            else:
                ids_kind, ids_val = "ids", list(self._full_ids)
            meta = {**base, "mode": "full", "full_ids_kind": ids_kind,
                    "full_ids": ids_val}
            arrays = {f"{prefix}/x": r.x, f"{prefix}/y": r.y,
                      f"{prefix}/iterations": r.iterations,
                      f"{prefix}/converged": r.converged,
                      f"{prefix}/primal_obj": r.primal_obj}
            return meta, {k: _host(v) for k, v in arrays.items()}
        if self._mode == "domain":
            return {**base, "mode": "skipped",
                    "reason": "step_override domains carry opaque warm "
                              "state (not serialized in v1)"}, {}
        return {**base, "mode": "cold"}, {}

    def _restore_payload(self, tmeta: dict, arrays: Dict[str, np.ndarray]):
        """Rebuild this session's warm state from checkpoint meta+arrays,
        the iterates as float32 on the service's device; raises
        CheckpointError on any misalignment."""
        mode = tmeta.get("mode", "cold")
        if mode in ("cold", "skipped"):
            return
        prefix = tmeta.get("prefix", "")
        device = self.service.device

        def arr(name: str) -> np.ndarray:
            key = f"{prefix}/{name}"
            if key not in arrays:
                raise ckpt_mod.CheckpointError(
                    f"checkpoint payload missing array {key!r}")
            return arrays[key]

        def iterate(name: str) -> torch.Tensor:
            return torch.as_tensor(arr(name), dtype=torch.float32,
                                   device=device)

        if mode == "pop":
            pm = tmeta.get("plan") or {}
            k, n = int(pm["k"]), int(pm["n_entities"])
            idx, eos = arr("idx"), arr("entity_of_slot")
            x, y = arr("x"), arr("y")
            shapes = {name: tuple(v)
                      for name, v in (pm.get("shapes") or {}).items()}
            if idx.ndim != 2 or idx.shape[0] != k or eos.shape != idx.shape:
                raise ckpt_mod.CheckpointError(
                    f"plan arrays misaligned: idx {idx.shape} / "
                    f"entity_of_slot {eos.shape} for k={k}")
            for name, a in (("x", x), ("y", y)):
                want = shapes.get(name)
                if want is not None and tuple(a.shape) != want:
                    raise ckpt_mod.CheckpointError(
                        f"iterate {name} has shape {tuple(a.shape)}, plan "
                        f"says {want} — stale or corrupt warm state")
            ids = arr("entity_ids") if pm.get("has_ids") else None
            if ids is not None and ids.shape[0] != n:
                raise ckpt_mod.CheckpointError(
                    f"entity_ids has {ids.shape[0]} entries for "
                    f"{n} entities")
            plan = PopPlan(k=k, n_entities=n, idx=idx, entity_of_slot=eos,
                           strategy=pm.get("strategy", "stratified"),
                           seed=int(pm.get("seed", 0)), replication=None,
                           entity_ids=ids, similarity=None, layout=None,
                           shapes=shapes or None)
            res = pop_mod.POPResult(
                alloc=arr("alloc"), idx=idx, solve_time_s=0.0,
                build_time_s=0.0, iterations=arr("iterations"),
                converged=arr("converged"), similarity={},
                sub_objectives=np.zeros(k, np.float32), x=iterate("x"),
                y=iterate("y"), plan=plan)
            self.seed(res, mode="pop")
            return
        if mode == "full":
            res = SolveResult(
                x=iterate("x"), y=iterate("y"),
                primal_obj=arr("primal_obj"), dual_obj=np.float32(0.0),
                primal_res=np.float32(np.inf), gap=np.float32(np.inf),
                iterations=arr("iterations"), converged=arr("converged"))
            kind = tmeta.get("full_ids_kind", "none")
            if kind == "pos":
                entity_ids = int(tmeta["full_ids"])
            elif kind == "ids":
                entity_ids = tmeta["full_ids"]
            else:
                entity_ids = None
            self.seed(res, mode="full", entity_ids=entity_ids)
            return
        raise ckpt_mod.CheckpointError(
            f"unknown session checkpoint mode {mode!r}")


class PopService:
    """Long-lived, multi-tenant POP solving service on one device.

    ``device`` defaults to the CUDA device; with none present the
    constructor raises (pass ``device="cpu"`` to run on the CPU).  Shared
    state (the session table, stats, the ladder's rate maps, the LRU and
    pager bookkeeping) mutates under one service lock; per-tenant warm
    state under that tenant's session lock.  ``dispatch=`` (``True`` for
    the :class:`DispatchConfig` defaults) turns on the cross-tenant
    micro-batching dispatcher; ``max_resident=`` caps the tenants that keep
    live warm state (the rest page out to host memory); ``rate_cache_size``
    bounds the ladder's rate maps.  ``profile=`` (a
    :class:`~repro_torch.tuning.TuningProfile` or the path of one) is
    validated here (version, digest seal, and that it was measured on
    this service's device type), installs its measured
    ``backend="auto"`` thresholds (process-wide, keyed by device type),
    sizes ``dispatch=True``'s window and lane cap from its launch-cost line
    and plans ``session(slo=)`` sessions.  :meth:`close` (or leaving a
    ``with`` block) stops the dispatcher and the ``step_async`` pool."""

    def __init__(self, solve: Optional[SolveConfig] = None,
                 exec: Optional[ExecConfig] = None, *, device=None,
                 dispatch: Union[bool, DispatchConfig, None] = None,
                 max_resident: Optional[int] = None,
                 rate_cache_size: int = RATE_CACHE_SIZE,
                 profile: Union[TuningProfile, str, None] = None):
        self.device = backends_mod.resolve_device(device)
        # None means "not set" (domain defaults win)
        self._service_solve = solve
        self._service_exec = exec
        if profile is not None and not isinstance(profile, TuningProfile):
            profile = load_profile(profile)
        if profile is not None:
            # a profile measured on another device type (the committed
            # CPU profile on the card) would plan k from curves that do
            # not transfer
            check_profile(profile, platform=self.device.type)
            backends_mod.install_tuned_thresholds(profile.backend_thresholds)
        self.profile = profile
        self._lock = threading.RLock()
        self._sessions: Dict[str, PopSession] = {}
        # tenant -> None, oldest-stepped first: the page-out victim order
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._stats = _zeros()
        self._stats.update({"paged_out": 0, "paged_in": 0,
                            "page_restore_failures": 0,
                            "session_reentries": 0})
        # measured per-iteration solve rates + per-step overheads, keyed
        # (path, domain, ExecConfig, k, n_entities): the ladder's budget
        # model, warmed by every fault-free step
        self._rates = _BoundedLRU(rate_cache_size)
        self._overheads = _BoundedLRU(rate_cache_size)
        self._pager = paged_mod.PagedSessionStore()
        self.max_resident = (None if max_resident is None
                             else max(int(max_resident), 1))
        self.dispatcher: Optional[MicroBatchDispatcher] = None
        if dispatch:
            if isinstance(dispatch, DispatchConfig):
                cfg = dispatch
            else:
                # dispatch=True with a profile: batching window + lane cap
                # from the measured launch-cost line
                tuned = (launch_defaults(profile)
                         if profile is not None else None)
                cfg = DispatchConfig(**tuned) if tuned else None
            self.dispatcher = MicroBatchDispatcher(cfg, device=self.device)
        self._executor: \
            Optional[concurrent.futures.ThreadPoolExecutor] = None

    # ------------------------------------------------------ solve funnels --
    def _solve_instance(self, problem, scfg, exec_cfg, *, warm,
                        entity_ids, **kw) -> "pop_mod.POPResult":
        """Every session pop-path solve funnels through here: without a
        dispatcher the one-call pipeline; with one, plan and build run on
        the calling thread and only the map-step launch goes through the
        dispatcher."""
        if self.dispatcher is None:
            return pop_mod.solve_instance(problem, scfg, exec_cfg, warm=warm,
                                          entity_ids=entity_ids,
                                          device=self.device, **kw)
        prep = pop_mod.prepare_instance(problem, scfg, exec_cfg, warm=warm,
                                        entity_ids=entity_ids,
                                        device=self.device, **kw)
        res, solve_s = self.dispatcher.solve_prepared(
            prep, problem.K_mv, problem.KT_mv)
        return pop_mod.finish_prepared(prep, res, solve_s)

    def _solve_full(self, problem, warm, exec_cfg) -> "pop_mod.FullResult":
        """The k=1 counterpart of :meth:`_solve_instance`."""
        if self.dispatcher is None:
            return pop_mod.solve_full_ex(problem, warm=warm,
                                         exec_cfg=exec_cfg,
                                         device=self.device)
        prep = pop_mod.prepare_full(problem, warm=warm, exec_cfg=exec_cfg,
                                    device=self.device)
        res, solve_s = self.dispatcher.solve_prepared(
            prep, problem.K_mv, problem.KT_mv)
        return pop_mod.finish_full(prep, res, solve_s)

    def _submit(self, fn, *args, **kw) -> "concurrent.futures.Future":
        with self._lock:
            if self._executor is None:
                workers = (self.dispatcher.cfg.workers if self.dispatcher
                           else DispatchConfig.workers)
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="pop-step")
            ex = self._executor
        return ex.submit(fn, *args, **kw)

    def session(self, tenant: str, instance: Any = None, *,
                domain: Optional[str] = None,
                solve: Optional[SolveConfig] = None,
                exec: Optional[ExecConfig] = None,
                slo: Optional[SLOTarget] = None) -> PopSession:
        """The session for ``tenant``, created on first use.  The domain
        comes from ``domain=`` or is inferred from ``instance``'s type;
        configs default to the domain's registered defaults, overridden by
        the service-level configs, then by ``solve=`` / ``exec=``.  An
        existing session keeps the configs it was created with.  A tenant
        paged out to host memory (``max_resident=``) is restored here with
        its warm state and step counter.

        ``slo=`` (a :class:`~repro_torch.tuning.SLOTarget`) makes the
        session auto-tuned: the service's ``profile=`` plans the initial
        ``SolveConfig`` for the instance (``solve=`` then only sets the
        strategy/seed baseline the planner starts from) and an online
        refiner re-plans on violated or newly slack SLOs.  The SLO is
        pinned like the configs."""
        if slo is not None and not isinstance(slo, SLOTarget):
            raise TypeError(f"slo= takes a repro_torch.tuning.SLOTarget, "
                            f"got {type(slo).__name__}")
        with self._lock:
            sess = self._sessions.get(tenant)
            if sess is None and tenant in self._pager:
                sess = self._page_in(tenant)
                if sess is not None:
                    self._stats["session_reentries"] += 1
            if sess is not None:
                if slo is not None and slo != sess.slo:
                    raise ValueError(
                        f"tenant {tenant!r} session is pinned to SLO "
                        f"{sess.slo}; end_session() it to re-create with "
                        f"{slo} (the SLO is set at session creation)")
                # a tuned session's solve_cfg drifts by design: the pin to
                # compare against is the baseline the planner started from
                pinned_solve = (sess._tuner.base_solve
                                if sess._tuner is not None
                                else sess.solve_cfg)
                if solve is not None and solve != pinned_solve:
                    raise ValueError(
                        f"tenant {tenant!r} session is pinned to "
                        f"{pinned_solve}; end_session() it to re-create "
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
                return sess              # re-entry by tenant name alone
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
            tuner = None
            if slo is not None:
                tuner = OnlineTuner(self.profile, spec.name, slo, solve_cfg,
                                    exec_cfg)
                if instance is not None and spec.step_override is None:
                    n = spec.make_problem(instance).n_entities
                    solve_cfg = tuner.plan_initial(n)
                # no instance yet: the first generic step plans
                # (ensure_planned) once it knows the entity count
            sess = PopSession(self, tenant, spec, solve_cfg, exec_cfg,
                              slo=slo, tuner=tuner)
            self._sessions[tenant] = sess
            self._lru[tenant] = None
        self._maybe_evict(keep=tenant)
        return sess

    def end_session(self, tenant: str) -> None:
        """Drop a tenant's session — live warm state, LRU slot and any
        paged-out blob."""
        with self._lock:
            self._sessions.pop(tenant, None)
            self._lru.pop(tenant, None)
        self._pager.discard(tenant)

    def tenants(self) -> tuple:
        """Every known tenant, resident or paged out."""
        with self._lock:
            names = set(self._sessions)
        return tuple(sorted(names | set(self._pager.tenants())))

    # ----------------------------------------------------- paging (LRU) --
    def _page_in(self, tenant: str) -> Optional[PopSession]:
        """Rebuild a resident session from the tenant's paged blob.
        Called under the service lock.  A corrupt or unreadable blob counts
        ``page_restore_failures`` and returns None (the caller then
        creates a fresh cold session)."""
        try:
            got = self._pager.take(tenant)
        except ckpt_mod.CheckpointError:
            got = None
        if got is None:
            self._stats["page_restore_failures"] += 1
            return None
        tmeta, arrays = got
        try:
            spec = registry_mod.get(tmeta["domain"])
            sess = PopSession(self, tenant, spec, self._cfg_solve(tmeta),
                              self._cfg_exec(tmeta))
        except Exception:
            # unknown domain / mangled config meta: the blob cannot seed a
            # session — the caller creates a fresh one
            self._stats["page_restore_failures"] += 1
            return None
        sess.steps = int(tmeta.get("steps", 0))
        st = tmeta.get("stats")
        if isinstance(st, dict):
            sess.stats = {**_zeros(), **st}
        try:
            sess._restore_payload(tmeta, arrays)
        except Exception:
            # the warm state did not survive; the session did (cold)
            self._stats["page_restore_failures"] += 1
        self._sessions[tenant] = sess
        self._lru[tenant] = None
        self._stats["paged_in"] += 1
        return sess

    def _reattach(self, sess: PopSession) -> None:
        """First thing every ``step`` does (under the session lock): make
        sure this object IS the resident session.  A handle whose tenant
        was paged out re-registers and reloads its warm state from the
        blob; a handle that still carries live state just re-registers."""
        with self._lock:
            if self._sessions.get(sess.tenant) is sess:
                return
            self._sessions[sess.tenant] = sess
            self._lru[sess.tenant] = None
            self._lru.move_to_end(sess.tenant)
        if sess._warm is not None:
            # the handle carries its own (newest) state; any blob is stale
            self._pager.discard(sess.tenant)
            return
        try:
            got = self._pager.take(sess.tenant)
        except ckpt_mod.CheckpointError:
            got = None
            with self._lock:
                self._stats["page_restore_failures"] += 1
        if got is None:
            return
        tmeta, arrays = got
        try:
            sess._restore_payload(tmeta, arrays)
            sess.steps = int(tmeta.get("steps", sess.steps))
            with self._lock:
                self._stats["paged_in"] += 1
        except Exception:
            with self._lock:
                self._stats["page_restore_failures"] += 1

    def _after_step(self, sess: PopSession) -> None:
        with self._lock:
            if sess.tenant in self._sessions:
                self._lru[sess.tenant] = None
                self._lru.move_to_end(sess.tenant)
        self._maybe_evict(keep=sess.tenant)

    def _maybe_evict(self, keep: Optional[str] = None) -> None:
        """Page the coldest resident sessions out until at most
        ``max_resident`` stay live.  One pass over the LRU order: victims
        busy in a step (a non-blocking try-acquire — the lock order
        forbids waiting on a session lock here) or carrying unserializable
        warm state are skipped, so the cap is best-effort under
        pathological loads, exact in steady state."""
        if self.max_resident is None:
            return
        with self._lock:
            over = len(self._sessions) - self.max_resident
            if over <= 0:
                return
            candidates = [t for t in self._lru
                          if t != keep and t in self._sessions]
        for tenant in candidates:
            if over <= 0:
                return
            with self._lock:
                victim = self._sessions.get(tenant)
            if victim is not None and self._page_out(victim):
                over -= 1

    def _page_out(self, sess: PopSession) -> bool:
        """Move one resident session's state to the host-memory pager.
        Returns False without side effects when the session is mid-step,
        its warm state cannot serialize (step_override domains, replicated
        plans — evicting those would destroy state), or the codec balks."""
        if not sess._lock.acquire(blocking=False):
            return False
        try:
            meta, arrays = sess._checkpoint_payload("t0")
            if meta.get("mode") == "skipped":
                return False
            meta = {**meta, "stats": dict(sess.stats,
                                          engines=dict(sess.stats["engines"]))}
            try:
                json.dumps(meta)
                self._pager.put(sess.tenant, meta, arrays)
            except (ckpt_mod.CheckpointError, TypeError, ValueError):
                return False
            # strip the object so its iterates free even while the caller
            # keeps a handle; a later step on the handle reloads from the
            # blob (see _reattach)
            sess._warm, sess._mode = None, None
            sess.last = None
            with self._lock:
                self._sessions.pop(sess.tenant, None)
                self._lru.pop(sess.tenant, None)
                self._stats["paged_out"] += 1
        finally:
            sess._lock.release()
        return True

    # --------------------------------------------------- checkpoint/restore --
    def checkpoint(self) -> bytes:
        """Serialize every tenant session's warm state to one bytes blob in
        the reference's format (``repro_torch.checkpoint.session_state``).

        Per tenant: the domain name, the pinned configs and their digest,
        the step counter, and the warm state — PopPlan arrays + solver
        iterates + entity ids (pop path) or the flat iterates + id key
        (full path), copied to the host.  Warm state the format cannot
        express (replicated plans, step_override domains' opaque state) is
        recorded as ``skipped`` and restores cold.  Paged-out tenants are
        folded in from their blobs.  Each session snapshots under its own
        lock; the service lock is never held while waiting on one."""
        with self._lock:
            resident = dict(self._sessions)
        paged: Dict[str, tuple] = {}
        for tenant in self._pager.tenants():
            if tenant in resident:
                continue
            blob = self._pager.peek_packed(tenant)
            if blob is None:
                continue
            try:
                paged[tenant] = ckpt_mod.unpack_state(blob)
            except ckpt_mod.CheckpointError:
                with self._lock:
                    self._stats["checkpoint_failures"] += 1
        tenants_meta: Dict[str, dict] = {}
        arrays: Dict[str, np.ndarray] = {}
        for i, tenant in enumerate(sorted(set(resident) | set(paged))):
            prefix = f"t{i}"
            if tenant in resident:
                sess = resident[tenant]
                with sess._lock:
                    meta, arrs = sess._checkpoint_payload(prefix)
                try:
                    json.dumps(meta)
                except (TypeError, ValueError):
                    meta = {"prefix": prefix, "domain": sess.spec.name,
                            "mode": "skipped",
                            "reason": "non-JSON-serializable session config"}
                    arrs = {}
            else:
                # a paged blob is a single-tenant checkpoint under the
                # "t0" prefix: remap its keys onto this blob's slot
                tmeta, tarrs = paged[tenant]
                meta = {k: v for k, v in tmeta.items() if k != "stats"}
                meta["prefix"] = prefix
                arrs = {f"{prefix}/{k.split('/', 1)[1]}": v
                        for k, v in tarrs.items()}
            tenants_meta[tenant] = meta
            arrays.update(arrs)
        return ckpt_mod.pack_state({"tenants": tenants_meta}, arrays)

    def restore(self, data: bytes, *, strict: bool = False) -> dict:
        """Restore tenant sessions from a :meth:`checkpoint` blob (either
        package's).

        Integrity (content hash, magic, version) is checked by the format;
        alignment (config digest, plan-vs-iterate shapes, entity-id
        counts) per tenant here.  Any failure DEGRADES: the blob — or just
        the offending tenant — restores cold and the failure lands in the
        returned report (``{"restored": [...], "cold": [...], "errors":
        {...}}``) and ``stats()["checkpoint_failures"]``; nothing raises
        unless ``strict=True``."""
        report = {"restored": [], "cold": [], "errors": {}}
        try:
            meta, arrays = ckpt_mod.unpack_state(data)
            tenants = meta["tenants"]
            if not isinstance(tenants, dict):
                raise ckpt_mod.CheckpointError("manifest meta lacks a "
                                               "tenants table")
        except (ckpt_mod.CheckpointError, KeyError, TypeError) as e:
            with self._lock:
                self._stats["checkpoint_failures"] += 1
            if strict:
                raise
            report["errors"]["<checkpoint>"] = f"{type(e).__name__}: {e}"
            return report
        for tenant in sorted(tenants):
            tmeta = tenants[tenant]
            try:
                sess = self.session(tenant, domain=tmeta["domain"],
                                    solve=self._cfg_solve(tmeta),
                                    exec=self._cfg_exec(tmeta))
                if ckpt_mod.config_digest(sess.solve_cfg, sess.exec_cfg) \
                        != tmeta.get("digest"):
                    raise ckpt_mod.CheckpointError(
                        "config digest mismatch (stale checkpoint or "
                        "changed config schema)")
                sess.steps = int(tmeta.get("steps", 0))
                with sess._lock:
                    sess._restore_payload(tmeta, arrays)
            except Exception as e:
                with self._lock:
                    self._stats["checkpoint_failures"] += 1
                if strict:
                    raise
                report["errors"][tenant] = f"{type(e).__name__}: {e}"
                report["cold"].append(tenant)
                continue
            if sess._warm is not None:
                with self._lock:
                    self._stats["checkpoint_restores"] += 1
                report["restored"].append(tenant)
            else:
                report["cold"].append(tenant)
        return report

    @staticmethod
    def _cfg_solve(tmeta: dict) -> SolveConfig:
        return SolveConfig(**dict(tmeta["solve_cfg"]))

    @staticmethod
    def _cfg_exec(tmeta: dict) -> ExecConfig:
        e = dict(tmeta["exec_cfg"])
        return ExecConfig(backend=e["backend"], engine=e["engine"],
                          solver_kw=dict(e.get("solver_kw") or {}),
                          backend_opts=dict(e.get("backend_opts") or {}))

    def stats(self) -> dict:
        """Service-wide step counts, plan-cache hit rate, aggregate solve
        time, mean warm fraction, per-engine step counts, the
        fault-tolerance counters (degraded/recovered/fallback steps,
        quarantined lanes, checkpoint restore outcomes), the paging tier
        (``resident_sessions``, ``paged_tenants``, ``paged_bytes`` and the
        ``paged_out``/``paged_in``/``page_restore_failures``/
        ``session_reentries`` traffic), the SLO tuning counters
        (``slo_violations``, ``retunes``) and the bounded ladder caches
        (``rate_evictions``, ``rate_keys``); with a dispatcher, its
        counters under ``dispatch`` (:meth:`MicroBatchDispatcher.stats`)."""
        with self._lock:
            s = dict(self._stats)
            s["engines"] = dict(s["engines"])
            s["rate_evictions"] = (self._rates.evictions
                                   + self._overheads.evictions)
            s["rate_keys"] = len(self._rates) + len(self._overheads)
            resident = len(self._sessions)
        steps = max(s["steps"], 1)
        s["plan_hit_rate"] = s["plan_hits"] / steps
        s["warm_fraction_mean"] = (s["warm_fraction_sum"] / s["warm_steps"]
                                   if s["warm_steps"] else None)
        s["resident_sessions"] = resident
        s["paged_tenants"] = len(self._pager)
        s["paged_bytes"] = self._pager.nbytes()
        s["n_sessions"] = resident + s["paged_tenants"]
        if self.dispatcher is not None:
            s["dispatch"] = self.dispatcher.stats()
        return s

    def close(self) -> None:
        """Shut down the ``step_async`` pool and the dispatcher thread
        (idempotent).  Sessions, paged blobs and stats stay readable; later
        synchronous steps launch inline."""
        with self._lock:
            ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=True)
        if self.dispatcher is not None:
            self.dispatcher.close()

    def __enter__(self) -> "PopService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
