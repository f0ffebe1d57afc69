"""POP map-step execution backends — the port of ``repro/core/backends.py``.

Every backend has the reference's contract,

    backend(batch, K_mv, KT_mv, solver_kw, engine=..., **opts) -> SolveResult

where ``batch = (ops, warm_x, warm_y)`` is a stacked :class:`~repro_torch.
core.pdhg.OperatorLP` plus starting iterates for every lane, all on one
device (cold starts are materialised up front by :func:`solve_map`).
Backends differ only in scheduling, never in math.

Registered backends:

``serial``
    One k=1 ``solve_stacked`` per lane, in a Python loop — the reference.
``vmap``
    One batched ``solve_stacked`` over the whole ``[k]`` stack (the
    reference vmaps; here the batch axis is written out, and a half-step
    is one kernel call for all k lanes).
``chunked_vmap``
    Batched solves over fixed-size chunks of lanes (k padded to a chunk
    multiple by repeating lane 0): peak memory is bounded by the chunk.
``shard_map``
    SPMD over one axis of a ``torch.distributed`` device mesh: every rank
    of the process group calls it with the same batch, k is padded up to
    a multiple of the axis size (times ``chunk`` when the ranks walk their
    lanes in chunks; never a smaller mesh), each rank solves its
    contiguous block of lanes with the local engine, and the
    :class:`SolveResult` fields are gathered with
    ``all_gather_into_tensor`` and the padding sliced off.
``pmap``
    One process over a list of devices (default: every visible device of
    the batch's type): the lanes are split per device (k padded to a
    multiple of their count), each slice is solved on its device in turn,
    and the results come back in device order.

Every backend gives each lane the bits ``vmap`` gives it: no lane's sums
depend on the stack's lane count (``kernels/ref.py:row_reduce``), and a
slice of the stack keeps each lane at its place modulo
:data:`LANE_PHASE` (:func:`_slice_lanes`).

``backend="auto"`` picks by k, per-sub-problem size and the ranks of the
mesh the caller passes in its backend opts (one device without: only the
caller knows that every rank calls with the same batch), through
:func:`select_backend`, with the thresholds a tuning profile measured for
the operator's device type when one is installed
(:func:`install_tuned_thresholds`).

The serving dispatcher shares one launch across tenants through
:func:`coalesce_key` (which prepared batches may share),
:func:`concat_batches` / :func:`split_result` (lane concatenation and its
undo) and :func:`pad_lanes_pow2`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import tracing
from . import pdhg
from .pdhg import OperatorLP, SolveResult, StepEngine, map_arrays, zip_arrays
from .problem import resolve_device  # noqa: F401  (re-exported)

MapBackend = Callable[..., SolveResult]

MAP_BACKENDS: Dict[str, MapBackend] = {}

DEFAULT_CHUNK = 16
# on the card a plain reduction along a row (``kernels/ref.py:
# row_reduce``) sums the row's entries before its first 16-byte boundary
# apart from the rest, so a lane whose rows have an odd length (6,145
# Gavel columns) keeps the bits of its sums only at the same place in its
# stack modulo this many lanes (lane 5 of 8 against the same lane alone:
# a power iteration off by 3.81e-6, on the H100)
LANE_PHASE = 4
AUTO_VMAP_MAX_K = 64
AUTO_VMAP_MAX_ELEMS = 64_000_000

# per-device-type MEASURED overrides of the auto-selection constants above,
# installed from a TuningProfile (``PopService(profile=...)`` /
# install_tuned_thresholds); empty = the constants decide.  Process-wide
# by design, as in the reference: the thresholds describe the hardware,
# not one service.  Keyed by the operator's device type ("cuda", "cpu"),
# so a CPU profile's thresholds never apply on the card.
_TUNED_THRESHOLDS: Dict[str, dict] = {}


def install_tuned_thresholds(per_platform: Optional[dict]) -> None:
    """Install measured ``backend="auto"`` thresholds keyed by device type
    (``{"cuda": {"vmap_max_k": ..., "vmap_max_elems": ...}}`` — the
    ``backend_thresholds`` table of a validated
    :class:`repro_torch.tuning.TuningProfile`).  ``None``/empty clears
    back to the constants."""
    _TUNED_THRESHOLDS.clear()
    for platform, t in (per_platform or {}).items():
        if isinstance(t, dict):
            _TUNED_THRESHOLDS[str(platform)] = dict(t)


def _auto_thresholds(device_type: str) -> Tuple[int, int]:
    """(vmap_max_k, vmap_max_elems) for operators on ``device_type``: the
    installed measured values when a profile provided them, else the
    constants."""
    t = _TUNED_THRESHOLDS.get(device_type)
    if not t:
        return AUTO_VMAP_MAX_K, AUTO_VMAP_MAX_ELEMS
    return (int(t.get("vmap_max_k", AUTO_VMAP_MAX_K)),
            int(t.get("vmap_max_elems", AUTO_VMAP_MAX_ELEMS)))

EngineSpec = Union[str, StepEngine]


def register_backend(name: str) -> Callable[[MapBackend], MapBackend]:
    def deco(fn: MapBackend) -> MapBackend:
        MAP_BACKENDS[name] = fn
        return fn
    return deco


def available_backends() -> tuple:
    return tuple(MAP_BACKENDS)


def get_backend(name: str) -> MapBackend:
    if name not in MAP_BACKENDS:
        raise ValueError(
            f"unknown map backend {name!r}; registered: {sorted(MAP_BACKENDS)}")
    return MAP_BACKENDS[name]


def batch_size(tree) -> int:
    """Leading-axis length of any stacked tree (ops or (ops, wx, wy))."""
    leaves: list = []
    map_arrays(leaves.append, tree)
    return leaves[0].shape[0]


def pad_to_multiple(tree, m: int):
    """Pad the lane axis to a multiple of ``m`` by repeating lane 0;
    returns ``(padded, k)`` with the ORIGINAL k."""
    k = batch_size(tree)
    pad = (-k) % m
    if pad == 0:
        return tree, k
    padded = map_arrays(
        lambda a: torch.cat([a, a[:1].expand((pad,) + a.shape[1:])]), tree)
    return padded, k


def _concat_results(outs) -> SolveResult:
    return zip_arrays(lambda *xs: np.concatenate(xs), *outs)


def _slice_lanes(batch, lo: int, n: int):
    """Lanes ``lo`` to ``lo + n`` of a stacked tree, preceded by ``lo %
    LANE_PHASE`` copies of lane ``lo``, so that each lane keeps its place
    in the whole stack modulo :data:`LANE_PHASE` and with it the bits of
    its sums: ``(lanes, lead)``; the first ``lead`` lanes of their result
    are the copies'."""
    lead = lo % LANE_PHASE
    part = map_arrays(lambda a: a[lo:lo + n], batch)
    if lead:
        part = map_arrays(lambda a: torch.cat(
            [a[:1].expand((lead,) + a.shape[1:]), a]), part)
    return part, lead


def _solve_lanes(batch, lo: int, hi: int, step: int, K_mv, KT_mv,
                 solver_kw, engine) -> SolveResult:
    """Lanes ``lo`` to ``hi`` of ``batch`` solved ``step`` lanes at a time,
    each slice through :func:`_slice_lanes`."""
    outs = []
    for start in range(lo, hi, step):
        part, lead = _slice_lanes(batch, start, min(step, hi - start))
        res = _solve_batch(part, K_mv, KT_mv, solver_kw, engine)
        outs.append(map_arrays(lambda a, lead=lead: a[lead:], res))
    return _concat_results(outs)


# --------------------------------------------------------------------------
# the per-batch solver (shared by every backend)
# --------------------------------------------------------------------------

def cold_start(ops: OperatorLP) -> Tuple[torch.Tensor, torch.Tensor]:
    """x0 = clip(0, l, u), y0 = 0 — the solver's own cold start."""
    x0 = torch.minimum(torch.maximum(torch.zeros_like(ops.c), ops.l), ops.u)
    return x0, torch.zeros_like(ops.q)


def _freeze_kw(solver_kw: dict):
    """``(items, hashable)``: the solver keywords as a sorted tuple, and
    whether they sort (unorderable keys keep insertion order, unhashable)."""
    try:
        return tuple(sorted(solver_kw.items())), True
    except TypeError:
        return tuple(solver_kw.items()), False


# map solvers built for unhashable keys (each a build that no cache saw)
UNCACHED_SOLVERS = 0


@pdhg._memoized(maxsize=64)
def _cached_solver(K_mv, KT_mv, kw_items, engine):
    return _build_solver(K_mv, KT_mv, dict(kw_items), engine)


def _build_solver(K_mv, KT_mv, solver_kw: dict, engine: EngineSpec):
    if engine != "matvec" and not isinstance(engine, StepEngine):
        raise ValueError(f"unresolved engine {engine!r} reached a backend; "
                         "go through solve_map or pass a StepEngine")

    def run(batch) -> SolveResult:
        return pdhg.solve_stacked(batch[0], engine=engine, K_mv=K_mv,
                                  KT_mv=KT_mv, warm_x=batch[1],
                                  warm_y=batch[2], **solver_kw)
    return run


def make_map_solver(K_mv, KT_mv, solver_kw: Optional[dict] = None,
                    engine: EngineSpec = "matvec"):
    """``fn(batch) -> SolveResult`` for one stacked batch, where ``batch =
    (ops, warm_x, warm_y)``.  The function is cached on (matvecs,
    solver_kw, engine) when they hash, as the reference caches its jitted
    solver (``repro/core/backends.py:_cached_solver``), so equal keys give
    the same object and a warm re-solve builds nothing; unhashable keys
    build a fresh function per call.  Every map backend solves through
    it."""
    global UNCACHED_SOLVERS
    solver_kw = dict(solver_kw or {})
    kw_items, hashable = _freeze_kw(solver_kw)
    if hashable:
        try:
            return _cached_solver(K_mv, KT_mv, kw_items, engine)
        except TypeError:
            pass
    UNCACHED_SOLVERS += 1
    return _build_solver(K_mv, KT_mv, solver_kw, engine)


def _solve_batch(batch, K_mv, KT_mv, solver_kw, engine) -> SolveResult:
    return make_map_solver(K_mv, KT_mv, solver_kw, engine)(batch)


# popcheck: hot
@register_backend("serial")
def solve_serial(batch, K_mv, KT_mv, solver_kw,
                 engine: EngineSpec = "matvec") -> SolveResult:
    """One k=1 solve per sub-problem, in a Python loop."""
    outs = [_solve_batch(map_arrays(lambda a, i=i: a[i:i + 1], batch),
                         K_mv, KT_mv, solver_kw, engine)
            for i in range(batch_size(batch))]
    return _concat_results(outs)


# popcheck: hot
@register_backend("vmap")
def solve_vmap(batch, K_mv, KT_mv, solver_kw,
               engine: EngineSpec = "matvec") -> SolveResult:
    """One batched solve over the whole lane stack."""
    return _solve_batch(batch, K_mv, KT_mv, solver_kw, engine)


# popcheck: hot
@register_backend("chunked_vmap")
def solve_chunked_vmap(batch, K_mv, KT_mv, solver_kw,
                       engine: EngineSpec = "matvec",
                       chunk: int = DEFAULT_CHUNK) -> SolveResult:
    """Batched solves over chunks of ``chunk`` lanes (k padded up to a
    chunk multiple; padding lanes are sliced off the result)."""
    k = batch_size(batch)
    chunk = max(1, min(chunk, k))
    padded, _ = pad_to_multiple(batch, chunk)
    res = _solve_lanes(padded, 0, batch_size(padded), chunk, K_mv, KT_mv,
                       solver_kw, engine)
    return map_arrays(lambda a: a[:k], res)


def _default_mesh(device: torch.device, axis: str):
    """A one-axis mesh named ``axis`` over the whole process group (a world
    of one when there is none)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .placement import ensure_process_group
    ensure_process_group(device)
    return init_device_mesh(device.type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _gather_lanes(res: SolveResult, n: int, group, device) -> SolveResult:
    """Every rank's lanes of ``res`` (numpy fields, equal lane counts) in
    rank order, through ``all_gather_into_tensor`` on ``device``."""
    import torch.distributed as dist

    def one(a):
        a = np.ascontiguousarray(a)
        wire = a.view(np.uint8) if a.dtype == np.bool_ else a
        t = torch.from_numpy(wire).to(device)
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        got = out.cpu().numpy()
        return got.view(np.bool_) if a.dtype == np.bool_ else got
    return map_arrays(one, res)


def _rank_chunk(batch, n: int, device_type: str) -> int:
    """The chunk ``shard_map`` walks a rank's lanes in when the caller
    gives none: ``DEFAULT_CHUNK`` when a rank's share of the ``batch``'s
    lanes over ``n`` ranks exceeds the one-device ``vmap`` ceiling for
    ``device_type`` (lanes or stacked elements), else 0 (no chunking)."""
    per_rank = -(-batch_size(batch) // n)
    max_k, max_elems = _auto_thresholds(device_type)
    heavy = (per_rank > max_k
             or per_rank * max(_n_elems_per_sub(batch[0]), 1) > max_elems)
    return DEFAULT_CHUNK if heavy else 0


# popcheck: hot
@register_backend("shard_map")
def solve_shard_map(batch, K_mv, KT_mv, solver_kw,
                    engine: EngineSpec = "matvec", mesh=None,
                    axis: str = "pop",
                    chunk: Optional[int] = None) -> SolveResult:
    """Shard the k sub-problems over ``axis`` of ``mesh`` (default: a
    one-axis mesh named ``axis`` over the whole process group); each rank
    solves its lanes with the local engine.  No collective runs inside a
    solve: POP sub-problems are independent by construction; the results
    are gathered once at the end.  Every rank must call it with the same
    batch, as every device runs the reference's ``shard_map`` body.

    ``chunk`` bounds a rank's memory as ``chunked_vmap`` does on one
    device: each rank walks its lanes in batched chunks of that size
    (``None``: decide from the per-rank share, chunking only when it
    exceeds the one-device ``vmap`` ceiling for the batch's device type;
    ``0``: never chunk).  No lane's result depends on it."""
    device = batch[0].c.device
    if mesh is None:
        mesh = _default_mesh(device, axis)
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    dim = names.index(axis)
    n = mesh.size(dim)
    if chunk is None:
        chunk = _rank_chunk(batch, n, device.type)
    padded, k = pad_to_multiple(batch, n * chunk if chunk else n)
    per = batch_size(padded) // n
    lo = mesh.get_local_rank(dim) * per
    local = _solve_lanes(padded, lo, lo + per, chunk or per, K_mv, KT_mv,
                         solver_kw, engine)
    res = (local if n == 1 else
           _gather_lanes(local, n, mesh.get_group(dim), device))
    return map_arrays(lambda a: a[:k], res)


def _engine_on(engine: EngineSpec, ops: OperatorLP, K_mv, KT_mv):
    """``engine`` for a lane slice on another device (a resolved engine is
    built again there by its name)."""
    if engine == "matvec":
        return engine
    return pdhg.resolve_engine(pdhg.engine_name(engine), ops, K_mv, KT_mv)


def _visible(device: torch.device) -> list:
    """Every device of ``device``'s type this process sees."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


# popcheck: hot
@register_backend("pmap")
def solve_pmap(batch, K_mv, KT_mv, solver_kw,
               engine: EngineSpec = "matvec",
               devices=None) -> SolveResult:
    """Split the lanes over ``devices`` (default: every visible device of
    the batch's type, as the reference's ``jax.devices()``: ``cuda:0`` to
    ``cuda:n-1`` for a batch on the card, the CPU for one on the CPU) and
    solve each slice on its device, in turn, in this process; the results
    are joined in device order and the padding sliced off.  A card's slice
    is solved with that card current: the hand-written kernels launch on
    the current device, and a launch into another card's stream fails."""
    here = batch[0].c.device
    devices = [torch.device(d) for d in (devices or _visible(here))]
    n = len(devices)
    padded, k = pad_to_multiple(batch, n)
    per = batch_size(padded) // n
    outs = []
    for i, dev in enumerate(devices):
        part, lead = _slice_lanes(padded, i * per, per)
        eng = engine
        if dev != here:
            part = map_arrays(lambda a: a.to(dev), part)
            eng = _engine_on(engine, part[0], K_mv, KT_mv)
        with (torch.cuda.device(part[0].c.device) if dev.type == "cuda"
              else contextlib.nullcontext()):
            res = _solve_batch(part, K_mv, KT_mv, solver_kw, eng)
        outs.append(map_arrays(lambda a, lead=lead: a[lead:], res))
    return map_arrays(lambda a: a[:k], _concat_results(outs))


# --------------------------------------------------------------------------
# auto-selection + entry points
# --------------------------------------------------------------------------

def _mesh_ranks(opts: dict) -> int:
    """The ranks ``shard_map`` would spread over: the size of the ``axis``
    of the ``mesh`` the caller passed in its backend opts, else one (a
    process group alone does not say its ranks call with the same
    batch)."""
    mesh = opts.get("mesh")
    if mesh is None:
        return 1
    return mesh.size(tuple(mesh.mesh_dim_names).index(
        opts.get("axis", "pop")))


def select_backend(k: int, n_elems_per_sub: int = 0,
                   n_dev: int = 1, *, device_type: str) -> str:
    """The reference's rule: several devices and enough lanes ->
    ``shard_map``; one device -> ``vmap`` until the stack gets large, then
    ``chunked_vmap``.  ``n_dev`` is the ranks of the mesh the caller
    handed over (``resolve_exec``), one without.  The crossover
    thresholds are the constants unless a profile installed measured ones
    for ``device_type`` (:func:`install_tuned_thresholds`)."""
    if n_dev > 1 and k >= n_dev:
        return "shard_map"
    max_k, max_elems = _auto_thresholds(device_type)
    if k > max_k or k * max(n_elems_per_sub, 1) > max_elems:
        return "chunked_vmap"
    return "vmap"


def _n_elems_per_sub(ops: OperatorLP) -> int:
    leaves: list = []
    map_arrays(leaves.append, ops)
    return sum(int(np.prod(a.shape[1:])) for a in leaves)


def _resolve_warm(ops: OperatorLP, warm):
    """Starting iterates from ``warm``: None (cold), an object with
    ``.x``/``.y``, an (x, y) pair, or a masked ``WarmStart`` — each
    stacked [k, ...]; a WarmStart's per-lane mask starts False lanes cold
    (a ``torch.where`` on data)."""
    if warm is None:
        return cold_start(ops)
    mask = getattr(warm, "mask", None)
    if hasattr(warm, "x") and hasattr(warm, "y"):
        wx, wy = warm.x, warm.y
    else:
        wx, wy = warm
    dev = ops.c.device
    wx = torch.as_tensor(wx, dtype=ops.c.dtype, device=dev)
    wy = torch.as_tensor(wy, dtype=ops.q.dtype, device=dev)
    if wx.shape != ops.c.shape or wy.shape != ops.q.shape:
        raise ValueError(
            f"warm-start shapes {tuple(wx.shape)}/{tuple(wy.shape)} do not "
            f"match the stacked problem {tuple(ops.c.shape)}/"
            f"{tuple(ops.q.shape)} — for warm re-solves across partition "
            "changes go through core.plan.remap_warm")
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask, bool), device=dev)[:, None]
        cx, cy = cold_start(ops)
        wx = torch.where(m, wx, cx)
        wy = torch.where(m, wy, cy)
    return wx, wy


def make_batch(ops: OperatorLP, warm=None):
    """The ``(ops, warm_x, warm_y)`` batch a map backend consumes (a
    structured operator's bucket ids checked here, before the map step)."""
    from ..kernels import ops as kops
    kops.precheck_structured(ops.structured)
    return (ops, *_resolve_warm(ops, warm))


def resolve_exec(ops: OperatorLP, K_mv, KT_mv, backend: str = "auto",
                 engine: EngineSpec = "auto",
                 opts: Optional[dict] = None):
    """Resolve ``"auto"`` specs to the (backend name, engine, opts) that
    will actually run; ``engine`` comes back as ``"matvec"`` or a resolved
    :class:`StepEngine`.  Under ``backend="auto"`` the opts the winning
    backend does not take are dropped."""
    if engine == "auto" or engine is None:
        engine = pdhg.select_engine(ops, K_mv, KT_mv)
    if engine != "matvec":
        engine = pdhg.resolve_engine(engine, ops, K_mv, KT_mv)
    opts = dict(opts or {})
    if backend == "auto":
        backend = select_backend(batch_size(ops), _n_elems_per_sub(ops),
                                 _mesh_ranks(opts),
                                 device_type=ops.c.device.type)
        if opts:
            import inspect
            accepted = inspect.signature(get_backend(backend)).parameters
            opts = {k: v for k, v in opts.items() if k in accepted}
    else:
        get_backend(backend)          # fail fast on unknown names
    return backend, engine, opts


def solve_map(ops: OperatorLP, K_mv, KT_mv, solver_kw: Optional[dict] = None,
              backend: str = "auto", engine: EngineSpec = "auto",
              warm=None, **opts: Any) -> SolveResult:
    """Run the POP map step on stacked ``ops`` with the named backend and
    step engine (both resolved through :func:`resolve_exec`)."""
    with tracing.span("pop.solve_map", lanes=int(ops.c.shape[0])):
        solver_kw = dict(solver_kw or {})
        backend, engine, opts = resolve_exec(ops, K_mv, KT_mv, backend,
                                             engine, opts)
        batch = make_batch(ops, warm)
        return get_backend(backend)(batch, K_mv, KT_mv, solver_kw,
                                    engine=engine, **opts)


def solve_one_ex(op: OperatorLP, K_mv, KT_mv,
                 solver_kw: Optional[dict] = None,
                 backend: str = "auto", engine: EngineSpec = "auto",
                 warm=None, **opts: Any):
    """Solve ONE unbatched LP as a k=1 stack and report what ran:
    ``(result, backend_name, engine_name)``; the result is unbatched."""
    opb = map_arrays(lambda a: a[None], op)
    backend, engine, opts = resolve_exec(opb, K_mv, KT_mv, backend, engine,
                                         opts)
    if warm is not None:
        if hasattr(warm, "x") and hasattr(warm, "y"):
            warm = (warm.x, warm.y)
        warm = tuple(torch.as_tensor(w)[None] for w in warm)
    res = solve_map(opb, K_mv, KT_mv, solver_kw, backend=backend,
                    engine=engine, warm=warm, **opts)
    return (map_arrays(lambda a: a[0], res), backend,
            pdhg.engine_name(engine))


def solve_one(op: OperatorLP, K_mv, KT_mv, solver_kw: Optional[dict] = None,
              backend: str = "auto", engine: EngineSpec = "auto",
              warm=None, **opts: Any) -> SolveResult:
    """:func:`solve_one_ex` without the observability tuple."""
    res, _, _ = solve_one_ex(op, K_mv, KT_mv, solver_kw, backend=backend,
                             engine=engine, warm=warm, **opts)
    return res


# --------------------------------------------------------------------------
# cross-tenant coalescing: shared launches over concatenated batches
# --------------------------------------------------------------------------

def _dtype_name(a: torch.Tensor) -> str:
    return str(a.dtype).removeprefix("torch.")


def coalesce_key(ops: OperatorLP, K_mv, KT_mv, backend: str,
                 engine: EngineSpec, solver_kw: dict, opts: dict):
    """Hashable compatibility key for sharing one map-step launch across
    prepared batches: two batches with EQUAL keys run the same solver
    (matvecs, resolved backend and engine, solver keywords and options) on
    the same device and may be lane-concatenated into one call without
    changing any lane's trajectory.

    Per-lane layouts must match exactly except the structured ELL widths
    and wide-bucket counts, which :func:`~repro_torch.core.pdhg.
    concat_stacks` pads to the group maximum (the key records only their
    ndim and dtype).  Returns None, never coalesce, for the single-lane
    streaming engine (``fused_structured_full`` takes one lane by design)
    and for unhashable configs or matvecs.  The device is part of the key:
    tenants on two devices never share a launch."""
    kw_items, hashable = _freeze_kw(solver_kw)
    if not hashable:
        return None
    try:
        opt_items = tuple(sorted(opts.items()))
        hash((kw_items, opt_items, K_mv, KT_mv, engine))
    except TypeError:
        return None
    if isinstance(engine, StepEngine) and engine.name == "fused_structured_full":
        return None
    bare = ops._replace(structured=None)
    leaves: list = []
    map_arrays(leaves.append, bare)
    lane_shapes = tuple((tuple(a.shape[1:]), _dtype_name(a)) for a in leaves)
    s = ops.structured
    skey = None if s is None else tuple(
        None if v is None else (v.ndim, _dtype_name(v)) for v in s)
    absent = tuple(f for f, v in zip(bare._fields, bare) if v is None)
    return (absent, lane_shapes, skey, str(ops.c.device), K_mv,
            KT_mv, backend, engine, kw_items, opt_items)


def concat_batches(batches):
    """Concatenate per-tenant ``(ops, warm_x, warm_y)`` batches on the lane
    axis into one launch-sized batch (ops through :func:`~repro_torch.core.
    pdhg.concat_stacks`, which pads structured ELL widths across tenants).
    Returns ``(batch, sizes)``; :func:`split_result` undoes it."""
    from ..kernels import ops as kops
    sizes = tuple(batch_size(b) for b in batches)
    ops = pdhg.concat_stacks([b[0] for b in batches])
    kops.precheck_structured(ops.structured)
    wx = torch.cat([b[1] for b in batches])
    wy = torch.cat([b[2] for b in batches])
    return (ops, wx, wy), sizes


def split_result(res: SolveResult, sizes) -> list:
    """A concatenated launch's :class:`SolveResult` cut back into
    per-tenant results (lane ranges in submission order); each tenant's
    arrays are its own copies, and None fields stay None."""
    outs, start = [], 0
    for s in sizes:
        outs.append(map_arrays(
            lambda a, i0=start, i1=start + s: a[i0:i1].copy(), res))
        start += s
    return outs


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pad_lanes_pow2(batch):
    """Pad a coalesced batch's lane count up to the next power of two by
    repeating lane 0 (see :func:`pad_to_multiple`: replica lanes cannot
    perturb real ones), so variable group sizes give O(log) distinct lane
    counts.  Returns ``(padded, k)`` with the original k; slice results
    ``[:k]``."""
    from ..kernels import ops as kops
    padded, k = pad_to_multiple(batch, next_pow2(batch_size(batch)))
    if padded is not batch:
        kops.precheck_structured(padded[0].structured)
    return padded, k
