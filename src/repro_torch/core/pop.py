"""POP orchestrator — the port of ``repro/core/pop.py``: a staged pipeline
around the :class:`~repro_torch.core.plan.PopPlan` artifact.

  ``plan()``    partition entities into k subsets (numpy);
  ``build()``   materialise the k sub-LPs, stack them, and move the stack
                to the solve device;
  ``solve()``   one batched PDHG solve through ``core/backends.py``;
  ``reduce()``  coalesce sub-allocations back to global entity order.

:func:`solve_instance` chains the four (``prepare_instance`` ->
map-step launch -> ``finish_prepared``); :func:`solve_full_ex` runs the
unpartitioned k=1 baseline through the same substrate.  Warm starts across
churn are the reference's: a reused plan keeps every lane's iterates
verbatim, a repaired plan remaps them (``plan.remap_warm``).

Every entry point takes ``device`` (default: the CUDA device; see
``backends.resolve_device``).  Results are numpy, like the reference's.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import backends as backends_mod
from . import partition as part_mod
from . import pdhg
from .config import ExecConfig, SolveConfig
from .pdhg import OperatorLP, SolveResult, map_arrays
from .plan import PopPlan, SubLayout, WarmStart, remap_warm, repair_plan
from .replicate import ReplicationPlan, plan_replication, replicated_partition
from .reduce import coalesce_concat, coalesce_replicated


class POPProblem:
    """Interface a domain problem implements to be POP-able.

    ``build_sub`` returns an :class:`OperatorLP` of CPU tensors (the
    pipeline stacks the lanes and moves them to the solve device);
    ``K_mv``/``KT_mv`` are per-lane matvecs over ``op.data``."""

    n_entities: int

    def entity_attrs(self) -> np.ndarray:
        """[n, d] attribute vectors (for similarity + stratification)."""
        raise NotImplementedError

    def entity_scores(self) -> np.ndarray:
        """[n] scalar load/demand (stratification + replication)."""
        attrs = self.entity_attrs()
        return attrs[:, 0] if attrs.ndim == 2 else attrs

    def build_sub(self, idx_row: np.ndarray, frac: float,
                  scale: Optional[np.ndarray] = None) -> OperatorLP:
        """Sub-LP over entities ``idx_row`` (-1 = padded slot) with
        ``frac`` of every resource; identical shapes for identical row
        lengths, so sub-problems stack."""
        raise NotImplementedError

    def build_full(self) -> OperatorLP:
        return self.build_sub(np.arange(self.n_entities), 1.0)

    def sub_layout(self, n_slots: int) -> Optional[SubLayout]:
        """Sub-LP layout for warm-start remapping (None disables it)."""
        return None

    K_mv = staticmethod(pdhg.dense_K_mv)
    KT_mv = staticmethod(pdhg.dense_KT_mv)

    def extract(self, op: OperatorLP, x: np.ndarray,
                idx_row: np.ndarray) -> np.ndarray:
        """Per-slot allocation rows [n_per, ...] from an LP solution.
        ``op`` is one lane's fields as views of the solve device's tensors:
        copy to the host only what is read."""
        raise NotImplementedError

    def evaluate(self, alloc: np.ndarray) -> dict:
        raise NotImplementedError


@dataclasses.dataclass
class POPResult:
    alloc: np.ndarray
    idx: np.ndarray
    solve_time_s: float
    build_time_s: float
    iterations: np.ndarray
    converged: np.ndarray
    similarity: dict
    sub_objectives: np.ndarray
    replication: Optional[ReplicationPlan] = None
    # raw stacked solver iterates [k, n_var]/[k, n_con]: the warm state
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    plan: Optional[PopPlan] = None
    warm_stats: Optional[dict] = None
    # what ACTUALLY ran ("auto" resolved) and where the plan came from:
    # "reused" / "repaired" / "fresh" / "provided"
    backend: Optional[str] = None
    engine: Optional[str] = None
    plan_source: Optional[str] = None
    diverged: Optional[np.ndarray] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# stage 1: plan
# --------------------------------------------------------------------------

def plan(
    problem: POPProblem,
    k: int,
    *,
    strategy: str = "random",
    seed: int = 0,
    replicate_threshold: Optional[float] = None,
    partition_idx: Optional[np.ndarray] = None,
    entity_ids: Optional[np.ndarray] = None,
) -> PopPlan:
    """Partition (+ optionally replicate) ``problem`` into k subsets."""
    n = problem.n_entities
    scores = np.asarray(problem.entity_scores(), np.float64)
    attrs = np.asarray(problem.entity_attrs(), np.float64)
    if attrs.ndim == 1:
        attrs = attrs[:, None]

    rep = None
    if partition_idx is not None:
        idx = np.asarray(partition_idx)
    elif replicate_threshold is not None:
        rep = plan_replication(scores, k, replicate_threshold)
        idx = replicated_partition(rep, scores, k, seed)
    else:
        idx = part_mod.make_partition(strategy, attrs, scores, n, k, seed)

    entity_of_slot = idx if rep is None else rep.entity_of(idx)
    sim = part_mod.similarity_report(attrs, entity_of_slot)
    layout = problem.sub_layout(idx.shape[1])
    if entity_ids is not None:
        entity_ids = np.asarray(entity_ids)
        if entity_ids.shape[0] != n:
            raise ValueError(f"entity_ids has {entity_ids.shape[0]} entries "
                             f"for {n} entities")
    return PopPlan(k=k, n_entities=n, idx=idx,
                   entity_of_slot=entity_of_slot, strategy=strategy,
                   seed=seed, replication=rep, entity_ids=entity_ids,
                   similarity=sim, layout=layout)


make_plan = plan


# --------------------------------------------------------------------------
# stage 2: build
# --------------------------------------------------------------------------

def build(problem: POPProblem, pop_plan: PopPlan,
          device=None) -> OperatorLP:
    """Build the plan's k sub-LPs, stack them (ELL widths padded to the
    stack maximum) and move the stack to ``device``; records the stacked
    shapes on the plan."""
    device = backends_mod.resolve_device(device)
    subs = [problem.build_sub(pop_plan.entity_of_slot[i], 1.0 / pop_plan.k,
                              scale=pop_plan.row_scale(i))
            for i in range(pop_plan.k)]
    ops = pdhg.to_device(pdhg.stack_ops(subs), device)
    pop_plan.shapes = {"x": tuple(ops.c.shape), "y": tuple(ops.q.shape)}
    if ops.structured is not None:
        s = ops.structured
        pop_plan.shapes["ell"] = (
            int(s.row_idx.shape[-2]), int(s.wrow_idx.shape[-2]),
            int(s.wrow_ids.shape[-1]),
            int(s.col_idx.shape[-2]), int(s.wcol_idx.shape[-2]),
            int(s.wcol_ids.shape[-1]))
    return ops


# --------------------------------------------------------------------------
# stage 3: solve (the map step)
# --------------------------------------------------------------------------

def solve(
    problem: POPProblem,
    pop_plan: PopPlan,
    ops: OperatorLP,
    *,
    backend: str = "auto",
    engine: str = "auto",
    solver_kw: Optional[dict] = None,
    backend_opts: Optional[dict] = None,
    warm=None,
) -> SolveResult:
    """Batched solve of the stacked sub-LPs through ``backends.solve_map``
    (waits for the device before returning)."""
    res = backends_mod.solve_map(ops, problem.K_mv, problem.KT_mv,
                                 dict(solver_kw or {}), backend=backend,
                                 engine=engine, warm=warm,
                                 **(backend_opts or {}))
    _sync(ops.c.device)
    return res


# --------------------------------------------------------------------------
# stage 4: reduce
# --------------------------------------------------------------------------

def reduce(problem: POPProblem, pop_plan: PopPlan, ops: OperatorLP,
           res: SolveResult) -> np.ndarray:
    """Coalesce per-lane allocations into the global one.  ``extract``
    gets each lane's LP fields and ``op.data`` as views of the device
    tensors and copies to the host only what it reads (a dense K stays on
    the device, so does the ELL payload)."""
    fields = ops._replace(structured=None)
    allocs = np.stack([
        np.asarray(problem.extract(map_arrays(lambda a, i=i: a[i], fields),
                                   np.asarray(res.x[i]), pop_plan.idx[i]))
        for i in range(pop_plan.k)
    ])
    if pop_plan.replication is None:
        return coalesce_concat(allocs, pop_plan.idx, pop_plan.n_entities)
    return coalesce_replicated(allocs, pop_plan.idx, pop_plan.replication)


# --------------------------------------------------------------------------
# the one-call wrapper
# --------------------------------------------------------------------------

def _require_finite_ops(ops: OperatorLP, where: str) -> None:
    """Reject NaN/inf instance data before it reaches the solver."""
    def _nonfinite(a) -> bool:
        return a.is_floating_point() and not bool(torch.isfinite(a).all())

    for name in ("c", "q", "l", "u"):
        if _nonfinite(getattr(ops, name)):
            raise ValueError(
                f"non-finite instance data reached {where}: field {name!r} "
                "contains NaN/inf — fix the instance (rates/demands/bounds) "
                "before solving")
    for group_name, group in (("data", ops.data),
                              ("structured", ops.structured)):
        leaves: list = []
        map_arrays(leaves.append, group)
        for i, leaf in enumerate(leaves):
            if _nonfinite(leaf):
                raise ValueError(
                    f"non-finite instance data reached {where}: operator "
                    f"field {group_name}[{i}] contains NaN/inf — fix the "
                    "instance (constraint matrices) before solving")


def _ids_or_positional(ids, n: int) -> np.ndarray:
    return np.arange(n) if ids is None else np.asarray(ids)


def _plan_fits(prev: PopPlan, problem: POPProblem, k: int,
               entity_ids: Optional[np.ndarray]) -> bool:
    """Can ``prev`` be reused verbatim for this instance?"""
    return (prev.k == k and prev.n_entities == problem.n_entities
            and np.array_equal(_ids_or_positional(entity_ids,
                                                  problem.n_entities),
                               prev.external_ids()))


@dataclasses.dataclass
class PreparedSolve:
    """Stages plan+build of the pipeline, stopped at the map-step launch."""

    problem: POPProblem
    plan: Optional[PopPlan]
    ops: OperatorLP
    warm: object                 # None | (x, y) | WarmStart
    warm_stats: Optional[dict]
    plan_source: str
    backend: str
    engine: object               # "matvec" | StepEngine
    opts: dict
    solver_kw: dict
    build_time_s: float


def prepare_instance(
    problem: POPProblem,
    solve_cfg: SolveConfig = SolveConfig(),
    exec_cfg: ExecConfig = ExecConfig(),
    *,
    warm: Optional[POPResult] = None,
    plan: Optional[PopPlan] = None,
    replan: bool = False,
    partition_idx: Optional[np.ndarray] = None,
    entity_ids: Optional[np.ndarray] = None,
    cold_lanes: Optional[np.ndarray] = None,
    device=None,
) -> PreparedSolve:
    """Everything :func:`solve_instance` does BEFORE the map-step launch:
    plan resolution (reuse / repair / fresh), sub-LP build + stack on the
    device, warm start resolution (remap, quarantine masking) and
    ``"auto"`` backend/engine resolution."""
    device = backends_mod.resolve_device(device)
    k = (solve_cfg.k if solve_cfg.min_per_sub is None
         else solve_cfg.k_for(problem.n_entities))
    solver_kw = exec_cfg.solver_dict()
    if warm is not None and getattr(warm, "x", None) is None:
        raise ValueError("warm result lacks solver state (x/y)")

    t0 = time.perf_counter()
    prev_plan = getattr(warm, "plan", None) if warm is not None else None
    # one side naming entities externally while the other matches by
    # position would pair arbitrary entities — refuse to match, start cold
    ids_agree = (prev_plan is None
                 or (prev_plan.entity_ids is None) == (entity_ids is None))
    source = "fresh"
    if plan is not None:
        p = plan
        source = "provided"
    elif (warm is not None and prev_plan is not None and not replan
          and partition_idx is None
          and solve_cfg.replicate_threshold is None and ids_agree):
        if _plan_fits(prev_plan, problem, k, entity_ids):
            p = prev_plan
            source = "reused"
        elif prev_plan.k == k and prev_plan.replication is None:
            # entity churn at the same k: survivors keep their (lane, slot)
            p = repair_plan(prev_plan, problem, entity_ids=entity_ids)
            source = "repaired"
        else:
            p = make_plan(problem, k, strategy=solve_cfg.strategy,
                          seed=solve_cfg.seed, entity_ids=entity_ids)
    else:
        p = make_plan(problem, k, strategy=solve_cfg.strategy,
                      seed=solve_cfg.seed,
                      replicate_threshold=solve_cfg.replicate_threshold,
                      partition_idx=partition_idx, entity_ids=entity_ids)
    ops = build(problem, p, device)
    _require_finite_ops(ops, "solve_instance")
    build_time = time.perf_counter() - t0

    warm_in = None
    warm_stats = None
    if warm is not None:
        if source == "reused":
            warm_in = (warm.x, warm.y)
            n_live = int((p.entity_of_slot >= 0).sum())
            warm_stats = dict(warm_fraction=1.0, matched=n_live, fresh=0,
                              dropped=0, lanes_cold=0, identity=True)
        elif not ids_agree:
            warm_stats = dict(warm_fraction=0.0, matched=0, fresh=0,
                              dropped=0, lanes_cold=k, identity=False,
                              reason="entity id spaces differ (one side has "
                                     "entity_ids, the other is positional)")
        elif prev_plan is not None:
            ws = remap_warm(prev_plan, p, warm, ops=ops)
            warm_in = ws
            warm_stats = ws.stats

    if cold_lanes is not None and warm_in is not None:
        # divergence quarantine: poisoned lanes restart cold, survivors
        # keep their iterates (the per-lane mask the backends blend on the
        # solve's device)
        cl = np.asarray(cold_lanes, bool).reshape(-1)
        if cl.shape[0] != p.k:
            raise ValueError(f"cold_lanes has {cl.shape[0]} entries for "
                             f"k={p.k} lanes")
        if isinstance(warm_in, WarmStart):
            wx, wy = warm_in.x, warm_in.y
            mask = np.asarray(warm_in.mask, bool) & ~cl
            stats = dict(warm_in.stats or {})
        else:
            wx, wy = warm_in
            mask = ~cl
            stats = dict(warm_stats or {})
        stats["quarantined_lanes"] = int(cl.sum())
        stats["lanes_cold"] = int((~mask).sum())
        stats["warm_fraction"] = float(
            stats.get("warm_fraction", 1.0) * mask.mean()) if p.k else 0.0
        stats["identity"] = False
        warm_in = WarmStart(x=wx, y=wy, mask=mask, stats=stats)
        warm_stats = stats

    backend_name, engine_run, opts = backends_mod.resolve_exec(
        ops, problem.K_mv, problem.KT_mv, exec_cfg.backend, exec_cfg.engine,
        exec_cfg.opts_dict())
    return PreparedSolve(
        problem=problem, plan=p, ops=ops, warm=warm_in,
        warm_stats=warm_stats, plan_source=source, backend=backend_name,
        engine=engine_run, opts=opts, solver_kw=solver_kw,
        build_time_s=build_time)


def finish_prepared(prep: PreparedSolve, res: SolveResult,
                    solve_time_s: float) -> POPResult:
    """Reduce per-lane allocations and assemble the :class:`POPResult`."""
    p = prep.plan
    alloc = reduce(prep.problem, p, prep.ops, res)
    return POPResult(
        alloc=alloc, idx=p.idx,
        solve_time_s=solve_time_s, build_time_s=prep.build_time_s,
        iterations=res.iterations, converged=res.converged,
        similarity=p.similarity or {},
        sub_objectives=res.primal_obj,
        replication=p.replication,
        x=res.x, y=res.y,
        plan=p, warm_stats=prep.warm_stats,
        backend=prep.backend, engine=pdhg.engine_name(prep.engine),
        plan_source=prep.plan_source, diverged=res.diverged)


def solve_instance(
    problem: POPProblem,
    solve_cfg: SolveConfig = SolveConfig(),
    exec_cfg: ExecConfig = ExecConfig(),
    *,
    warm: Optional[POPResult] = None,
    plan: Optional[PopPlan] = None,
    replan: bool = False,
    partition_idx: Optional[np.ndarray] = None,
    entity_ids: Optional[np.ndarray] = None,
    cold_lanes: Optional[np.ndarray] = None,
    device=None,
) -> POPResult:
    """Run POP on ``problem``: plan -> build -> solve -> reduce, configured
    by :class:`SolveConfig` (how to split) and :class:`ExecConfig` (how to
    execute); ``warm`` re-solves an updated instance from a previous
    :class:`POPResult` (see the module docstring).

    ``cold_lanes`` ([k] bool) starts those lanes cold even when a warm
    start is supplied — the divergence-quarantine retry:
    ``PopSession.step`` re-solves with ``plan=prev.plan`` and
    ``cold_lanes=prev.diverged`` so only the poisoned lanes restart while
    healthy lanes keep their iterates."""
    prep = prepare_instance(
        problem, solve_cfg, exec_cfg, warm=warm, plan=plan, replan=replan,
        partition_idx=partition_idx, entity_ids=entity_ids,
        cold_lanes=cold_lanes, device=device)
    t1 = time.perf_counter()
    res = solve(problem, prep.plan, prep.ops, backend=prep.backend,
                engine=prep.engine, solver_kw=prep.solver_kw,
                backend_opts=prep.opts, warm=prep.warm)
    return finish_prepared(prep, res, time.perf_counter() - t1)


def pop_solve(
    problem: POPProblem,
    k: int,
    *,
    strategy: str = "random",
    backend: str = "auto",
    engine: str = "auto",
    seed: int = 0,
    replicate_threshold: Optional[float] = None,
    partition_idx: Optional[np.ndarray] = None,
    solver_kw: Optional[dict] = None,
    backend_opts: Optional[dict] = None,
    warm: Optional[POPResult] = None,
    plan: Optional[PopPlan] = None,
    replan: bool = False,
    entity_ids: Optional[np.ndarray] = None,
    device=None,
) -> POPResult:
    """DEPRECATED kwarg surface over :func:`solve_instance` (the
    reference's forwarder): collapse the loose kwargs into a
    :class:`SolveConfig` + :class:`ExecConfig` (or use a
    :class:`~repro_torch.service.PopService` session) and call
    :func:`solve_instance`; results are bit-identical."""
    warnings.warn(
        "pop_solve(problem, k, ...) is deprecated: use "
        "pop.solve_instance(problem, SolveConfig(k=..., strategy=...), "
        "ExecConfig(...)) or a repro_torch.service.PopService session — "
        "results are identical when the configs mirror these kwargs (NOTE: "
        "SolveConfig defaults strategy='stratified'; pop_solve's default "
        "was 'random')",
        DeprecationWarning, stacklevel=2)
    return solve_instance(
        problem,
        SolveConfig(k=k, strategy=strategy, seed=seed,
                    replicate_threshold=replicate_threshold),
        ExecConfig(backend=backend, engine=engine,
                   solver_kw=dict(solver_kw or {}),
                   backend_opts=dict(backend_opts or {})),
        warm=warm, plan=plan, replan=replan, partition_idx=partition_idx,
        entity_ids=entity_ids, device=device)


@dataclasses.dataclass
class FullResult:
    """Unpartitioned (k=1) solve outcome."""

    alloc: np.ndarray
    res: SolveResult
    solve_time_s: float
    build_time_s: float
    backend: Optional[str] = None
    engine: Optional[str] = None


def prepare_full(problem: POPProblem, *,
                 warm: Optional[SolveResult] = None,
                 exec_cfg: Optional[ExecConfig] = None,
                 device=None) -> PreparedSolve:
    """Build the full LP as a k=1 stack on the device, resolve
    backend/engine on it and batch the warm iterates."""
    device = backends_mod.resolve_device(device)
    exec_cfg = exec_cfg or ExecConfig()
    solver_kw = exec_cfg.solver_dict()
    t0 = time.perf_counter()
    op = problem.build_full()
    opb = pdhg.to_device(map_arrays(lambda a: a[None], op), device)
    _require_finite_ops(opb, "solve_full_ex")
    build_time = time.perf_counter() - t0
    backend_name, engine_run, opts = backends_mod.resolve_exec(
        opb, problem.K_mv, problem.KT_mv, exec_cfg.backend, exec_cfg.engine,
        exec_cfg.opts_dict())
    if warm is not None:
        if hasattr(warm, "x") and hasattr(warm, "y"):
            warm = (warm.x, warm.y)
        warm = tuple(torch.as_tensor(w)[None] for w in warm)
    return PreparedSolve(
        problem=problem, plan=None, ops=opb, warm=warm, warm_stats=None,
        plan_source="full", backend=backend_name, engine=engine_run,
        opts=opts, solver_kw=solver_kw, build_time_s=build_time)


def finish_full(prep: PreparedSolve, res: SolveResult,
                solve_time_s: float) -> FullResult:
    """Unbatch a :func:`prepare_full` launch's result and extract the
    allocation."""
    res1 = map_arrays(lambda a: a[0], res)
    # views of the device tensors: extract copies only what it reads (the
    # ELL payload, 173 MB at 20,000 TE demands, stays on the device)
    op = map_arrays(lambda a: a[0], prep.ops._replace(structured=None))
    idx = np.arange(prep.problem.n_entities)
    alloc = np.asarray(prep.problem.extract(op, res1.x, idx))
    return FullResult(alloc=alloc, res=res1, solve_time_s=solve_time_s,
                      build_time_s=prep.build_time_s, backend=prep.backend,
                      engine=pdhg.engine_name(prep.engine))


def solve_full_ex(problem: POPProblem, *,
                  warm: Optional[SolveResult] = None,
                  exec_cfg: Optional[ExecConfig] = None,
                  device=None) -> FullResult:
    """Unpartitioned baseline as a k=1 stack through the same substrate."""
    prep = prepare_full(problem, warm=warm, exec_cfg=exec_cfg, device=device)
    t1 = time.perf_counter()
    res = backends_mod.solve_map(
        prep.ops, problem.K_mv, problem.KT_mv, prep.solver_kw,
        backend=prep.backend, engine=prep.engine, warm=prep.warm,
        **prep.opts)
    _sync(prep.ops.c.device)
    return finish_full(prep, res, time.perf_counter() - t1)


def solve_full(problem: POPProblem, solver_kw: Optional[dict] = None,
               warm: Optional[SolveResult] = None, *,
               backend: str = "auto", engine: str = "auto",
               backend_opts: Optional[dict] = None, device=None):
    """Tuple-returning wrapper over :func:`solve_full_ex` (the reference's
    historical surface: ``(alloc, res, solve_time, build_time)``)."""
    r = solve_full_ex(
        problem, warm=warm,
        exec_cfg=ExecConfig(backend=backend, engine=engine,
                            solver_kw=dict(solver_kw or {}),
                            backend_opts=dict(backend_opts or {})),
        device=device)
    return r.alloc, r.res, r.solve_time_s, r.build_time_s
