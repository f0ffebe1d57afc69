"""The measured substrate of the auto-tuner: the :class:`TuningProfile`
artifact and the offline profiler that builds it — the port of
``repro/tuning/profile.py``.

BENCH_pop.json shows the quality-vs-k tradeoff is sharply domain-dependent
(cluster scheduling holds 0.998 rel-quality at k=32 while traffic falls
0.95 @k=4 -> 0.53 @k=64), so no static ``SolveConfig`` default can serve
every tenant.  A profile records, per domain, the measured quality-vs-k
and latency-vs-k curves on a scaled-down probe instance (plus replication
recovery rows, the granular-POP follow-up's quality lever), the measured
launch-cost line of the micro-batch dispatcher, and the per-platform
vmap-vs-chunked crossover behind ``backend="auto"``.  The planner in
:mod:`repro_torch.tuning.slo` interpolates these curves to pick the
cheapest config that meets an :class:`~repro_torch.tuning.slo.SLOTarget`.

The artifact is **versioned and digest-sealed**: every consumer must pass
a loaded profile through :func:`check_profile` before reading curves from
it.  The JSON schema and the digest rule are the reference's, byte for
byte, so a profile sealed by either package passes the other's
:func:`check_profile`.  A profile this package measures names the torch
device type in ``platform`` (``"cuda"`` or ``"cpu"``) and
``"torch-" + torch.__version__`` in the ``jax_version`` field (the field
keeps its name so that both packages write one schema).
``scripts/tune_torch.py`` measures one on the card; the committed
``TUNING_profile.json`` is a CPU artifact of the reference and holds no
number for the card.

Timing reads the host clock after ``torch.cuda.synchronize`` on the
measured device (:func:`_sync`): without it a line would fit the time the
host takes to enqueue the work, not the time the work takes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time as _time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "PROFILE_VERSION", "ProfileError", "DomainCurves", "TuningProfile",
    "profile_digest", "save_profile", "load_profile", "check_profile",
    "build_profile",
]

PROFILE_VERSION = 1

# pow2 k sweep of the offline profiler (clamped per probe size)
_SWEEP_KS = (2, 4, 8, 16, 32)


class ProfileError(ValueError):
    """A TuningProfile failed validation (version, digest, platform)."""


@dataclasses.dataclass
class DomainCurves:
    """One domain's measured tradeoff curves, at ``probe_n`` entities.

    ``quality_vs_k`` rows are ``(k, rel_quality)`` with rel_quality the
    domain quality scalar at k over the k=1 full solve (1.0 = lossless);
    ``latency_vs_k`` rows are ``(k, solve_s, iters)`` at the probe size;
    ``n_exponent`` scales latency to other instance sizes
    (``t(n) ~ t(probe_n) * (n/probe_n)**n_exponent``); ``replication``
    rows are ``(k, threshold, rel_quality, solve_s)`` — quality recovery
    from §4.3 hot-entity replication at the same k."""

    probe_n: int
    quality_vs_k: Tuple[Tuple[float, float], ...] = ()
    latency_vs_k: Tuple[Tuple[float, float, float], ...] = ()
    n_exponent: float = 1.0
    replication: Tuple[Tuple[float, float, float, float], ...] = ()


@dataclasses.dataclass
class TuningProfile:
    """The versioned, digest-sealed measurement artifact.

    ``platform`` is the device type the profile was measured on (this
    package writes the torch device type, ``"cuda"`` or ``"cpu"``; the
    reference writes its JAX platform name) and ``jax_version`` the
    framework that measured it (this package writes ``"torch-"`` plus
    ``torch.__version__``; the field keeps the reference's name so that
    one schema serves both).  ``backend_thresholds`` maps a device type to
    measured ``backend="auto"`` selection thresholds (``{"vmap_max_k":
    ..., "vmap_max_elems": ...}``) — ``repro_torch.core.backends``
    consults them for operators on that device type when a profile is
    installed and falls back to its constants otherwise.  ``launch_cost``
    is the fitted dispatcher launch-cost line ``{"overhead_s": ...,
    "per_lane_s": ...}`` that sizes ``DispatchConfig`` defaults."""

    version: int
    platform: str
    device_count: int
    jax_version: str
    created: str
    domains: Dict[str, DomainCurves] = dataclasses.field(default_factory=dict)
    backend_thresholds: Dict[str, dict] = dataclasses.field(
        default_factory=dict)
    launch_cost: Dict[str, float] = dataclasses.field(default_factory=dict)
    digest: str = ""


# --------------------------------------------------------------------------
# (de)serialization + the digest seal
# --------------------------------------------------------------------------

def _to_json(profile: TuningProfile) -> dict:
    obj = dataclasses.asdict(profile)
    obj["domains"] = {name: dataclasses.asdict(c) if
                      isinstance(c, DomainCurves) else dict(c)
                      for name, c in profile.domains.items()}
    return obj


def _from_json(obj: dict) -> TuningProfile:
    """Parse WITHOUT validating — :func:`check_profile` is the gate."""
    domains = {}
    for name, c in (obj.get("domains") or {}).items():
        domains[name] = DomainCurves(
            probe_n=int(c["probe_n"]),
            quality_vs_k=tuple(tuple(r) for r in c.get("quality_vs_k", ())),
            latency_vs_k=tuple(tuple(r) for r in c.get("latency_vs_k", ())),
            n_exponent=float(c.get("n_exponent", 1.0)),
            replication=tuple(tuple(r) for r in c.get("replication", ())))
    return TuningProfile(
        version=int(obj.get("version", -1)),
        platform=str(obj.get("platform", "")),
        device_count=int(obj.get("device_count", 1)),
        jax_version=str(obj.get("jax_version", "")),
        created=str(obj.get("created", "")),
        domains=domains,
        backend_thresholds=dict(obj.get("backend_thresholds") or {}),
        launch_cost=dict(obj.get("launch_cost") or {}),
        digest=str(obj.get("digest", "")))


def profile_digest(profile: TuningProfile) -> str:
    """sha256 over the canonical JSON rendering, digest field excluded —
    the seal :func:`check_profile` verifies."""
    obj = _to_json(profile)
    obj.pop("digest", None)
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return "sha256:" + hashlib.sha256(blob.encode("utf-8")).hexdigest()


def save_profile(profile: TuningProfile, path: Union[str, Path]) -> Path:
    """Seal (stamp the digest) and write the artifact as JSON."""
    profile.digest = profile_digest(profile)
    p = Path(path)
    p.write_text(json.dumps(_to_json(profile), indent=2, sort_keys=True)
                 + "\n")
    return p


def load_profile(path: Union[str, Path]) -> TuningProfile:
    """Read + parse a profile.  Does NOT validate: pass the result through
    :func:`check_profile` before reading curves."""
    try:
        obj = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ProfileError(f"cannot read tuning profile {path}: "
                           f"{type(e).__name__}: {e}") from e
    if not isinstance(obj, dict):
        raise ProfileError(f"tuning profile {path} is not a JSON object")
    return _from_json(obj)


def check_profile(profile: TuningProfile,
                  platform: Optional[str] = None) -> TuningProfile:
    """Validate a profile's version and digest seal (and, when
    ``platform`` is given, that it was measured on that platform).
    Returns the profile unchanged so it chains:
    ``check_profile(load_profile(p))``.  Raises :class:`ProfileError`."""
    if profile.version != PROFILE_VERSION:
        raise ProfileError(
            f"tuning profile version {profile.version} != supported "
            f"{PROFILE_VERSION} — regenerate the profile")
    want = profile_digest(profile)
    if not profile.digest:
        raise ProfileError("tuning profile carries no digest seal — "
                           "regenerate the profile")
    if profile.digest != want:
        raise ProfileError(
            f"tuning profile digest mismatch ({profile.digest[:23]}... != "
            f"{want[:23]}...) — the artifact was edited after sealing")
    if platform is not None and profile.platform != platform:
        raise ProfileError(
            f"tuning profile was measured on {profile.platform!r}, "
            f"running on {platform!r} — latency curves do not transfer; "
            "regenerate the profile")
    return profile


# --------------------------------------------------------------------------
# the offline profiler
# --------------------------------------------------------------------------

def _sync(device) -> None:
    """Wait for the device before a clock read (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_instances(fast: bool, seed: int) -> Dict[str, tuple]:
    """Per-domain (full-size probe, half-size probe) instance pairs — the
    reference's draws.  Imports stay local so ``import
    repro_torch.tuning`` is light."""
    from ..domains.gavel import GavelInstance
    from ..domains.moe_placement import make_placement_instance
    from ..problems.cluster_scheduling import make_cluster_workload
    from ..problems.traffic_engineering import (TrafficProblem,
                                                k_shortest_paths,
                                                make_demands, make_topology)

    def traffic(n):
        topo = make_topology(20, 40, seed=seed)
        pairs, dem = make_demands(topo, n, seed=seed)
        pe = k_shortest_paths(topo, pairs, n_paths=2, max_len=10, seed=seed)
        return TrafficProblem(topo, pairs, dem, pe)

    n_gavel = 64 if fast else 192
    n_traffic = 48 if fast else 160
    n_moe = 48 if fast else 128
    return {
        "gavel": (
            GavelInstance(make_cluster_workload(n_gavel, seed=seed)),
            GavelInstance(make_cluster_workload(n_gavel // 2, seed=seed))),
        "traffic": (traffic(n_traffic), traffic(n_traffic // 2)),
        "moe_placement": (
            make_placement_instance(n_moe, 6, seed=seed),
            make_placement_instance(n_moe // 2, 6, seed=seed)),
    }


def _alloc_quality(spec, inst, problem, alloc) -> Optional[float]:
    """The domain quality scalar for a raw solver allocation (through the
    domain's rounding hook first, like a session step would)."""
    a = alloc
    if spec.round is not None:
        a = spec.round(inst, alloc)
    return spec.quality_of(spec.metrics_of(inst, problem, a))


def _solve_timed(problem, solve_cfg, exec_cfg, device):
    """(result, steady seconds): warm up once (the first call builds the
    kernels and the memoized engines), then report the better of two
    WALL-clock solves, each read after the device finished.  Wall — plan
    + build + solve — is what an SLO ``step_deadline_s`` is spent on; the
    solver-internal time alone hides the k-proportional host-side build
    cost that makes large k a net loss on small instances."""
    from ..core import pop as pop_mod

    def call():
        if solve_cfg is None or solve_cfg.k <= 1:
            return pop_mod.solve_full_ex(problem, exec_cfg=exec_cfg,
                                         device=device)
        return pop_mod.solve_instance(problem, solve_cfg, exec_cfg,
                                      device=device)

    call()                                    # build + engine warmup
    best, res = float("inf"), None
    for _ in range(2):
        _sync(device)
        t0 = _time.perf_counter()
        res = call()
        _sync(device)
        best = min(best, _time.perf_counter() - t0)
    return res, float(best)


def _profile_domain(name: str, inst, half_inst, *, fast: bool, device,
                    log=None) -> Optional[DomainCurves]:
    from ..core.config import ExecConfig, SolveConfig
    from ..domains import registry as registry_mod

    spec = registry_mod.get(name)
    if spec.step_override is not None:
        return None         # domain runs its own pipeline: no generic curves
    problem = spec.make_problem(inst)
    n = problem.n_entities
    kw = dict(spec.default_exec.solver_dict())
    kw["max_iters"] = min(int(kw.get("max_iters", 20_000)),
                          600 if fast else 4_000)
    exec_cfg = ExecConfig(backend=spec.default_exec.backend,
                          engine=spec.default_exec.engine, solver_kw=kw)
    # the k=1 reference must be CONVERGED (it anchors rel_quality=1.0);
    # give it the domain's full budget, capped well above the sweep's
    ref_kw = dict(kw)
    ref_kw["max_iters"] = min(
        int(spec.default_exec.solver_dict().get("max_iters", 20_000)),
        4_000 if fast else 20_000)
    ref_cfg = ExecConfig(backend=spec.default_exec.backend,
                         engine=spec.default_exec.engine, solver_kw=ref_kw)
    base = spec.default_solve

    full, _ = _solve_timed(problem, None, ref_cfg, device)
    q_full = _alloc_quality(spec, inst, problem, full.alloc)
    if q_full is None or q_full <= 0:
        return None         # no usable quality scalar: cannot build curves
    # the k=1 LATENCY row runs the same capped serving budget as the
    # sweep (apples-to-apples for the planner); only the quality
    # reference above needs the converged budget
    capped, full_s = _solve_timed(problem, None, exec_cfg, device)
    quality = [(1.0, 1.0)]
    latency = [(1.0, full_s,
                float(np.asarray(capped.res.iterations).max(initial=0)))]

    ks = [k for k in _SWEEP_KS if k * 2 <= n]
    for k in ks:
        scfg = SolveConfig(k=k, strategy=base.strategy, seed=base.seed)
        res, solve_s = _solve_timed(problem, scfg, exec_cfg, device)
        q = _alloc_quality(spec, inst, problem, res.alloc)
        rel = max(q / q_full, 0.0) if q is not None else 0.0
        quality.append((float(k), float(rel)))
        latency.append((float(k), solve_s,
                        float(np.asarray(res.iterations).max(initial=0))))
        if log:
            log(f"  {name}: k={k} rel_quality={rel:.4f} "
                f"solve_s={solve_s:.3f}")

    # replication recovery at the largest measured ks (granular-POP's
    # quality lever: replicate hot entities instead of shrinking k)
    replication = []
    for k in ks[-2:]:
        for thr in (0.5, 0.2):
            scfg = SolveConfig(k=k, strategy=base.strategy, seed=base.seed,
                               replicate_threshold=thr)
            try:
                res, solve_s = _solve_timed(problem, scfg, exec_cfg, device)
            except Exception:
                continue     # domain/shape rejects replication: no row
            q = _alloc_quality(spec, inst, problem, res.alloc)
            if q is None:
                continue
            replication.append((float(k), float(thr),
                                float(max(q / q_full, 0.0)), solve_s))

    # size scaling: same k on the half-size probe fits the latency exponent
    n_exponent = 1.0
    if ks:
        k_ref = ks[min(1, len(ks) - 1)]
        half_problem = spec.make_problem(half_inst)
        if half_problem.n_entities >= 2 * k_ref:
            scfg = SolveConfig(k=k_ref, strategy=base.strategy,
                               seed=base.seed)
            _, t_half = _solve_timed(half_problem, scfg, exec_cfg, device)
            t_ref = next(t for kk, t, _ in latency if kk == float(k_ref))
            if t_half > 0 and t_ref > 0:
                ratio = n / max(half_problem.n_entities, 1)
                n_exponent = float(np.clip(
                    np.log(t_ref / t_half) / np.log(ratio), 0.5, 2.5))

    return DomainCurves(probe_n=int(n), quality_vs_k=tuple(quality),
                        latency_vs_k=tuple(latency),
                        n_exponent=n_exponent,
                        replication=tuple(replication))


def _dense_stack(rng, k: int, n: int, mi: int, device):
    """k random feasible dense LPs (the reference's draw) stacked in
    operator form on ``device``, with their cold-start batch."""
    from ..core import backends as backends_mod, pdhg
    from ..core.problem import LinearProgram

    lps = []
    for _ in range(k):
        c = rng.normal(size=n)
        G = rng.normal(size=(mi, n))
        h = G @ rng.uniform(0.2, 0.8, n) + rng.uniform(0.1, 1.0, mi)
        lps.append(LinearProgram.build(c=c, G=G, h=h, l=np.zeros(n),
                                       u=np.ones(n), device=device))
    ops = pdhg.stack_ops([pdhg.dense_ops(lp) for lp in lps])
    return (ops, *backends_mod.cold_start(ops))


def _measure_launch_cost(fast: bool, seed: int,
                         device) -> Dict[str, float]:
    """Fit wall = overhead + per_lane * lanes on tiny stacked dense
    solves (the ``matvec`` engine over ``dense_K_mv``, one batched call
    per stack) — what sizes the dispatcher's batching window."""
    from ..core import backends as backends_mod, pdhg

    rng = np.random.default_rng(seed)
    n, mi = 24, 12
    kw = dict(max_iters=64, tol_primal=1e-3, tol_gap=1e-3)
    solver = backends_mod.get_backend("vmap")
    lanes = (1, 2, 4, 8) if fast else (1, 2, 4, 8, 16)
    rows = []
    for k in lanes:
        batch = _dense_stack(rng, k, n, mi, device)

        def call():
            return solver(batch, pdhg.dense_K_mv, pdhg.dense_KT_mv, kw,
                          engine="matvec")

        call()                                          # warmup
        best = float("inf")
        for _ in range(3):
            _sync(device)
            t0 = _time.perf_counter()
            call()
            _sync(device)
            best = min(best, _time.perf_counter() - t0)
        rows.append((float(k), best))
    xs = np.array([r[0] for r in rows])
    ys = np.array([r[1] for r in rows])
    per_lane, overhead = np.polyfit(xs, ys, 1)
    return {"overhead_s": float(max(overhead, 0.0)),
            "per_lane_s": float(max(per_lane, 0.0)),
            "rows": [[k, t] for k, t in rows]}


def _measure_backend_thresholds(fast: bool, seed: int,
                                device) -> Dict[str, dict]:
    """Measured vmap-vs-chunked_vmap crossover on this device type: the
    largest lane count where plain vmap still wins.  The element ceiling
    is not probed (it guards peak memory, not speed) and keeps the
    constant."""
    from ..core import backends as backends_mod, pdhg

    rng = np.random.default_rng(seed)
    n, mi = 20, 10
    kw = dict(max_iters=48, tol_primal=1e-3, tol_gap=1e-3)

    def timed(backend, batch):
        fn = backends_mod.get_backend(backend)
        fn(batch, pdhg.dense_K_mv, pdhg.dense_KT_mv, kw)
        best = float("inf")
        for _ in range(2):
            _sync(device)
            t0 = _time.perf_counter()
            fn(batch, pdhg.dense_K_mv, pdhg.dense_KT_mv, kw)
            _sync(device)
            best = min(best, _time.perf_counter() - t0)
        return best

    vmap_max_k = backends_mod.AUTO_VMAP_MAX_K
    kks = (16, 32, 64) if fast else (16, 32, 64, 128)
    winning = []
    for k in kks:
        batch = _dense_stack(rng, k, n, mi, device)
        t_v = timed("vmap", batch)
        t_c = timed("chunked_vmap", batch)
        if t_v <= t_c * 1.1:
            winning.append(k)
    if winning:
        vmap_max_k = max(winning)
    return {device.type: {
        "vmap_max_k": int(vmap_max_k),
        "vmap_max_elems": int(backends_mod.AUTO_VMAP_MAX_ELEMS),
        "measured": True}}


def build_profile(domains: Sequence[str] = ("gavel", "traffic",
                                            "moe_placement"),
                  *, fast: bool = True, seed: int = 0,
                  measure_launch: bool = True,
                  measure_backends: bool = True,
                  log=None, device=None) -> TuningProfile:
    """Sweep (k, replication) per domain on scaled-down probes on
    ``device`` (default: the CUDA device; with none present this raises
    rather than measure another device) and return an unsealed profile
    (:func:`save_profile` stamps the digest).

    ``fast=True`` is the seconds-scale smoke build; ``fast=False`` grows
    probes ~3x for a steadier artifact.  Run it with no other thread
    launching work: a concurrent Python thread's solve loop distorts the
    launch line."""
    from ..core.problem import resolve_device

    device = resolve_device(device)
    probes = _probe_instances(fast, seed)
    curves: Dict[str, DomainCurves] = {}
    for name in domains:
        pair = probes.get(name)
        if pair is None:
            continue
        if log:
            log(f"profiling domain {name} ...")
        c = _profile_domain(name, *pair, fast=fast, device=device, log=log)
        if c is not None:
            curves[name] = c
    profile = TuningProfile(
        version=PROFILE_VERSION,
        platform=device.type,
        device_count=(int(torch.cuda.device_count())
                      if device.type == "cuda" else 1),
        jax_version="torch-" + torch.__version__,
        created=_time.strftime("%Y-%m-%dT%H:%M:%S", _time.gmtime()),
        domains=curves)
    if measure_launch:
        profile.launch_cost = _measure_launch_cost(fast, seed, device)
    if measure_backends:
        profile.backend_thresholds = _measure_backend_thresholds(
            fast, seed, device)
    return profile
