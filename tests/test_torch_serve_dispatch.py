"""The micro-batching dispatcher and ``step_async`` of the port
(``repro_torch.service``), on the CPU.

The twins of ``tests/test_serve_dispatch.py``'s ``TestDispatchBitIdentity``
and ``TestCoalesceSubstrate`` run on the port alone: a tenant's coalesced
step is bit for bit its synchronous step (traffic, as the reference's test,
and the Gavel main path's domain with its equilibration), a held dispatcher
makes one launch of four tenants, no stats are lost under concurrent steps,
a checkpoint taken mid-traffic restores.  Then both packages on the same
numpy inputs: ``concat_stacks`` gives equal arrays, ``coalesce_key`` makes
the same share / do-not-share decisions, and each tenant's coalesced step
agrees with the reference's ``PopService(dispatch=True)`` within 1e-3 at
equal per-lane iterations when the port draws the reference's probes.
Last the port's own guarantees: a failed group launch retries its tickets
solo, a k=1 streaming tenant launches inline, the device is part of the
key, and ``close()`` leaves no thread behind."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SolveConfig as RefSolveConfig
from repro.core import backends as ref_backends
from repro.core import pdhg as ref_pdhg
from repro.core import pop as ref_pop
from repro.domains import GavelInstance as RefGavelInstance
from repro.problems import traffic_engineering as ref_te
from repro.problems.cluster_scheduling import make_cluster_workload
from repro.service import PopService as RefPopService
from repro_torch import testing
from repro_torch.core import backends as backends_mod
from repro_torch.core import pdhg
from repro_torch.core import pop as pop_mod
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import GavelInstance
from repro_torch.problems import traffic_engineering as te
from repro_torch.service import DispatchConfig, PopService

from test_torch_pdhg import reference_probes

KW = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
SOLVE = SolveConfig(k=3)
EXEC = ExecConfig(solver_kw=KW)
# the Gavel tenants: the session standard of tests/test_torch_service.py
GAVEL_JOBS, GAVEL_WORKERS = 64, (16, 16, 16)
GAVEL_KW = dict(k=4, strategy="stratified", min_per_sub=8)
QUALITY_TOL = 1e-3
TIMEOUT = 300


def _traffic(n=24, seed=0, scale=1.0, pkg=te):
    topo = pkg.make_topology(20, 40, seed=seed)
    pairs, dem = pkg.make_demands(topo, n, seed=seed)
    pe = pkg.k_shortest_paths(topo, pairs, n_paths=2, max_len=10, seed=seed)
    return pkg.TrafficProblem(topo, pairs, dem * scale, pe)


def _gavel_steps(seed, make_workload=None, cls=GavelInstance):
    """A Gavel tenant's three instances (cold, drift, 20% churn)."""
    return [cls(wl, job_ids=ids) for wl, ids in testing.session_workloads(
        GAVEL_JOBS, GAVEL_WORKERS, churn=0.2, make_workload=make_workload,
        seed=seed)]


def _tenants(domain):
    """{seed: [instance per round]} and the session configs of a domain."""
    if domain == "traffic":
        steps = {s: [_traffic(seed=s, scale=sc) for sc in (1.0, 1.03, 1.07)]
                 for s in range(4)}
        return steps, dict(solve=SOLVE, exec=EXEC)
    steps = {s: _gavel_steps(s) for s in range(4)}
    return steps, dict(domain="gavel", solve=SolveConfig(**GAVEL_KW))


def _sync_reference(steps, cfg):
    """Per-tenant allocations from isolated synchronous services."""
    ref = {}
    for s, insts in steps.items():
        sess = PopService(device="cpu").session(f"t{s}", insts[0], **cfg)
        ref[s] = [sess.step(inst) for inst in insts]
    return ref


def _held_round(svc, submit):
    """Submit steps while the dispatcher is held (``submit()`` returns the
    futures) and release once every request reached the dispatcher, so the
    round dispatches in one sweep."""
    before = svc.dispatcher.stats()["requests"]
    with svc.dispatcher.hold():
        futs = submit()
        t_end = time.monotonic() + TIMEOUT
        while (svc.dispatcher.stats()["requests"] - before < len(futs)
               and time.monotonic() < t_end):
            time.sleep(0.01)
        time.sleep(0.2)          # from the request count to the queue
    return futs


def _delta(after, before):
    return {k: after[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# the twins of TestDispatchBitIdentity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domain", ["traffic", "gavel"])
def test_concurrent_steps_match_sync_bit_for_bit(domain):
    steps, cfg = _tenants(domain)
    ref = _sync_reference(steps, cfg)
    svc = PopService(device="cpu", dispatch=True)
    sessions = {s: svc.session(f"t{s}", insts[0], **cfg)
                for s, insts in steps.items()}
    try:
        for rnd in range(3):
            futs = {s: sessions[s].step_async(steps[s][rnd]) for s in steps}
            for s, f in futs.items():
                a, b = f.result(timeout=TIMEOUT), ref[s][rnd]
                assert a.status == "ok" and a.plan_cache == b.plan_cache
                assert np.array_equal(a.alloc, b.alloc), \
                    f"tenant {s} round {rnd} diverged from the sync path"
                assert np.array_equal(a.raw.iterations, b.raw.iterations)
                assert np.array_equal(a.raw.x, b.raw.x)
        d = svc.dispatcher.stats()
        assert d["requests"] == 4 * 3
        assert d["group_fallbacks"] == 0
    finally:
        svc.close()


def test_held_dispatcher_coalesces_deterministically():
    """Four compatible tenants queued while the gate is held dispatch as
    ONE launch serving all four (12 lanes, padded to 16)."""
    steps, cfg = _tenants("traffic")
    svc = PopService(device="cpu", dispatch=True)
    sessions = {s: svc.session(f"t{s}", insts[0], **cfg)
                for s, insts in steps.items()}
    try:
        for s in steps:                      # warm, solo
            sessions[s].step(steps[s][0])
        before = svc.dispatcher.stats()
        futs = _held_round(svc, lambda: [
            sessions[s].step_async(_traffic(seed=s, scale=1.05))
            for s in steps])
        for f in futs:
            assert f.result(timeout=TIMEOUT).status == "ok"
        after = svc.dispatcher.stats()
        d = _delta(after, before)
        assert d["coalesced_requests"] == 4
        assert d["launches"] == 1 and d["lanes"] == 12
        assert after["max_group"] >= 4
        assert after["batching_ratio"] > 1.0
    finally:
        svc.close()


def test_no_stats_lost_under_concurrency():
    seeds, rounds = range(6), 3
    svc = PopService(device="cpu", dispatch=True)
    sessions = {s: svc.session(f"t{s}", _traffic(seed=s), solve=SOLVE,
                               exec=EXEC) for s in seeds}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        futs = []
        for rnd in range(rounds):
            futs += [sessions[s].step_async(
                _traffic(seed=s, scale=1.0 + 0.02 * rnd)) for s in seeds]
        allocs = [f.result(timeout=TIMEOUT) for f in futs]
        st = svc.stats()
        assert st["steps"] == len(seeds) * rounds == len(allocs)
        assert (st["plan_hits"] + st["plan_repairs"] + st["plan_misses"]
                + st["full_solves"] + st["fallback_steps"]) == st["steps"]
        assert sum(sessions[s].stats["steps"] for s in seeds) == st["steps"]
        d = st["dispatch"]
        assert d["requests"] == len(seeds) * rounds
        assert d["coalesced_requests"] + d["solo_launches"] == d["requests"]
    finally:
        sys.setswitchinterval(interval)
        svc.close()


def test_checkpoint_mid_traffic_restores_cleanly():
    seeds = range(4)
    svc = PopService(device="cpu", dispatch=True)
    sessions = {s: svc.session(f"t{s}", _traffic(seed=s), solve=SOLVE,
                               exec=EXEC) for s in seeds}
    try:
        for s in seeds:
            sessions[s].step(_traffic(seed=s))
        stop = threading.Event()
        blobs = []

        def snapshotter():
            while not stop.is_set():
                blobs.append(svc.checkpoint())

        t = threading.Thread(target=snapshotter)
        t.start()
        try:
            futs = [sessions[s].step_async(_traffic(seed=s, scale=1.05))
                    for s in seeds] + \
                   [sessions[s].step_async(_traffic(seed=s, scale=1.1))
                    for s in seeds]
            for f in futs:
                assert f.result(timeout=TIMEOUT).status == "ok"
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive() and blobs
        restored = PopService(device="cpu")
        rep = restored.restore(blobs[-1])
        assert not rep["errors"]
        assert sorted(rep["restored"]) == [f"t{s}" for s in seeds]
        a = restored.session("t0", domain="traffic").step(
            _traffic(seed=0, scale=1.06))
        assert a.plan_cache == "hit" and a.status == "ok"
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the twins of TestCoalesceSubstrate
# ---------------------------------------------------------------------------

def _full_stack(prob):
    return pdhg.map_arrays(lambda a: a[None], prob.build_full())


def test_concat_split_roundtrip():
    probs = [_traffic(seed=s) for s in range(3)]
    stacks = [pop_mod.build(p, pop_mod.plan(p, 3, strategy="stratified"),
                            device="cpu") for p in probs]
    merged = pdhg.concat_stacks(stacks)
    sizes = [backends_mod.batch_size(s) for s in stacks]
    assert backends_mod.batch_size(merged) == sum(sizes)
    parts = backends_mod.split_result(
        pdhg.map_arrays(lambda a: a.numpy(), merged), sizes)
    for part, stack in zip(parts, stacks):
        # the bare payload round-trips bit for bit; the structured half is
        # padded to the group's ELL widths
        flat_a, flat_b = [], []
        pdhg.map_arrays(flat_a.append, part._replace(structured=None))
        pdhg.map_arrays(flat_b.append, stack._replace(structured=None))
        assert len(flat_a) == len(flat_b)
        assert all(np.array_equal(x, y.numpy())
                   for x, y in zip(flat_a, flat_b))


def test_concat_pads_mismatched_ell_widths():
    """Seeds 0 and 2: equal bare layouts, different ELL widths."""
    ops = [_full_stack(_traffic(seed=seed)) for seed in (0, 2)]
    a_s, b_s = ops[0].structured, ops[1].structured
    assert any(x is not None and y is not None and x.shape != y.shape
               for x, y in zip(a_s, b_s)), "fixture lost its mismatch"
    merged = pdhg.concat_stacks(ops)
    assert backends_mod.batch_size(merged) == 2
    for v, x, y in zip(merged.structured, a_s, b_s):
        if v is None:
            continue
        for d in range(1, v.ndim):
            assert v.shape[d] == max(x.shape[d], y.shape[d])
    # the padded operator is the same matrix, lane by lane
    for i, op in enumerate(ops):
        got = pdhg.structured_to_dense(
            pdhg.map_arrays(lambda a, i=i: a[i:i + 1], merged.structured))
        assert torch.equal(got, pdhg.structured_to_dense(op.structured))


def test_coalesce_key_none_for_streaming_engine():
    prob = _traffic()
    op = _full_stack(prob)
    kw = dict(max_iters=100)
    base = backends_mod.coalesce_key(
        op, prob.K_mv, prob.KT_mv, "vmap",
        pdhg.matvec_engine(prob.K_mv, prob.KT_mv), kw, {})
    assert base is not None
    streaming = pdhg.StepEngine("fused_structured_full", pdhg.dense_K_mv,
                                pdhg.dense_KT_mv, pdhg.dense_K_mv,
                                pdhg.dense_KT_mv)
    assert backends_mod.coalesce_key(op, prob.K_mv, prob.KT_mv, "vmap",
                                     streaming, kw, {}) is None


def test_coalesce_key_equal_for_compatible_tenants():
    """Two tenants with equal configs resolve to the same StepEngine object
    (the engine builders are memoized) and so to equal keys."""
    keys, engines = [], []
    for seed in range(2):
        p = _traffic(seed=seed)
        op = _full_stack(p)
        _, engine, _ = backends_mod.resolve_exec(op, p.K_mv, p.KT_mv)
        engines.append(engine)
        keys.append(backends_mod.coalesce_key(
            op, p.K_mv, p.KT_mv, "vmap", engine, dict(max_iters=100), {}))
    assert engines[0] is engines[1]
    assert engines[0].name == "fused_structured"
    assert keys[0] is not None and keys[0] == keys[1]
    assert hash(keys[0]) == hash(keys[1])


def test_pow2_padding():
    assert backends_mod.next_pow2(1) == 1
    assert backends_mod.next_pow2(3) == 4
    assert backends_mod.next_pow2(4) == 4
    assert backends_mod.next_pow2(9) == 16
    assert backends_mod.next_pow2(24) == 32
    stacks = [_full_stack(_traffic(seed=s)) for s in range(3)]
    batches = [backends_mod.make_batch(s) for s in stacks]
    batch, sizes = backends_mod.concat_batches(batches)
    padded, k = backends_mod.pad_lanes_pow2(batch)
    assert (k, sizes, backends_mod.batch_size(padded)) == (3, (1, 1, 1), 4)
    # the replica lane repeats lane 0, every field
    same: list = []
    pdhg.zip_arrays(lambda a, b: same.append(torch.equal(a[3], b[0])),
                    padded, batch)
    assert same and all(same)


# ---------------------------------------------------------------------------
# both packages on the same inputs
# ---------------------------------------------------------------------------

def _ref_full_stack(prob):
    return jax.tree.map(lambda a: jnp.asarray(a)[None], prob.build_full())


def _assert_ops_equal(port, ref):
    """Every array of two stacked OperatorLPs equal, dtype and bits."""
    names = type(ref)._fields
    for name in names:
        a, b = getattr(port, name), getattr(ref, name)
        if name in ("data", "structured"):
            assert (a is None) == (b is None), name
            if a is None:
                continue
            fa, fb = [], []
            pdhg.map_arrays(fa.append, a)
            fb = jax.tree.leaves(b)
            assert len(fa) == len(fb), name
            pairs = zip(fa, fb)
        else:
            pairs = [(a, b)]
        for x, y in pairs:
            y = np.asarray(y)
            x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
            assert x.shape == y.shape, (name, x.shape, y.shape)
            assert np.array_equal(x, y.astype(x.dtype)), name


def _concat_cases():
    """(port stacks, reference stacks) for each concat case."""
    out = {}
    # one layout, three tenants of k=3 on the reference's plans
    port, ref = [], []
    for s in range(3):
        rp = _traffic(seed=s, pkg=ref_te)
        plan = ref_pop.plan(rp, 3, strategy="stratified")
        ref.append(ref_pop.build(rp, plan))
        tp = _traffic(seed=s)
        port.append(pop_mod.build(tp, pop_mod.plan(
            tp, 3, partition_idx=np.asarray(plan.idx)), device="cpu"))
    out["k3-stacks"] = (port, ref)
    # mismatched ELL widths
    out["mismatched-widths"] = (
        [_full_stack(_traffic(seed=s)) for s in (0, 2)],
        [_ref_full_stack(_traffic(seed=s, pkg=ref_te)) for s in (0, 2)])
    # mixed coefficient storage: int8 next to f32 dequantizes to f32
    p0, p1 = _full_stack(_traffic(seed=0)), _full_stack(_traffic(seed=2))
    r0 = _ref_full_stack(_traffic(seed=0, pkg=ref_te))
    r1 = _ref_full_stack(_traffic(seed=2, pkg=ref_te))
    out["int8-beside-f32"] = (
        [p0._replace(structured=pdhg.quantize_structured(p0.structured)),
         p1],
        [r0._replace(structured=ref_pdhg.quantize_structured(r0.structured)),
         r1])
    return out


@pytest.fixture(scope="module")
def concat_cases():
    return _concat_cases()


@pytest.mark.parametrize("case", ["k3-stacks", "mismatched-widths",
                                  "int8-beside-f32"])
def test_concat_stacks_equals_reference(concat_cases, case):
    port, ref = concat_cases[case]
    for p, r in zip(port, ref):
        _assert_ops_equal(p, r)          # the inputs agree first
    _assert_ops_equal(pdhg.concat_stacks(port), ref_pdhg.concat_stacks(ref))


def _key_of(pkg_backends, pkg_pdhg, stack_of, prob, engine, kw, opts):
    eng = (pkg_pdhg.matvec_engine(prob.K_mv, prob.KT_mv)
           if engine == "matvec" else engine)
    return pkg_backends.coalesce_key(stack_of(prob), prob.K_mv, prob.KT_mv,
                                     "vmap", eng, kw, opts)


M100 = {"max_iters": 100}
KEY_CASES = {
    # (tenant a, tenant b): (n, seed, engine, solver_kw, opts) each
    "compatible": ((24, 0, "matvec", M100, {}), (24, 1, "matvec", M100, {})),
    "other-lane-shapes": ((24, 0, "matvec", M100, {}),
                          (30, 0, "matvec", M100, {})),
    "other-solver-kw": ((24, 0, "matvec", M100, {}),
                        (24, 1, "matvec", {"max_iters": 200}, {})),
    "other-opts": ((24, 0, "matvec", M100, {"chunk": 4}),
                   (24, 1, "matvec", M100, {"chunk": 8})),
    "streaming-engine": ((24, 0, "streaming", M100, {}),
                         (24, 1, "streaming", M100, {})),
    "unhashable-opts": ((24, 0, "matvec", M100, {"chunk": [4]}),
                        (24, 1, "matvec", M100, {"chunk": [4]})),
}

PACKAGES = ((backends_mod, pdhg, te, _full_stack),
            (ref_backends, ref_pdhg, ref_te, _ref_full_stack))


def _streaming(pkg_pdhg):
    return pkg_pdhg.StepEngine(
        "fused_structured_full", pkg_pdhg.dense_K_mv, pkg_pdhg.dense_KT_mv,
        pkg_pdhg.dense_K_mv, pkg_pdhg.dense_KT_mv)


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_coalesce_key_decisions_match_reference(case):
    decisions = []
    for pkg_backends, pkg_pdhg, te_mod, stack_of in PACKAGES:
        keys = [_key_of(pkg_backends, pkg_pdhg, stack_of,
                        _traffic(n=n, seed=seed, pkg=te_mod),
                        _streaming(pkg_pdhg) if eng == "streaming" else eng,
                        kw, opts)
                for n, seed, eng, kw, opts in KEY_CASES[case]]
        decisions.append((keys[0] is None, keys[1] is None,
                          keys[0] is not None and keys[0] == keys[1]))
    assert decisions[0] == decisions[1], decisions


def test_unhashable_solver_kw_never_shares():
    """An unhashable solver keyword value: the port returns no key (the
    launch runs inline), where the reference's key holds the value and
    cannot be hashed (ROADMAP §3)."""
    kw = {"max_iters": [100]}
    keys = [_key_of(pkg_backends, pkg_pdhg, stack_of, _traffic(pkg=te_mod),
                    "matvec", kw, {})
            for pkg_backends, pkg_pdhg, te_mod, stack_of in PACKAGES]
    assert keys[0] is None
    with pytest.raises(TypeError, match="unhashable"):
        hash(keys[1])


@pytest.fixture(scope="module")
def reference_dispatch():
    """The reference's coalesced steps: four Gavel tenants, three held
    rounds through ``PopService(dispatch=True)``."""
    steps = {s: _gavel_steps(s, make_cluster_workload, RefGavelInstance)
             for s in range(4)}
    svc = RefPopService(dispatch=True)
    sessions = {s: svc.session(f"t{s}", domain="gavel",
                               solve=RefSolveConfig(**GAVEL_KW))
                for s in steps}
    out = {s: [] for s in steps}
    try:
        for rnd in range(3):
            futs = _held_round(svc, lambda: {
                s: sessions[s].step_async(steps[s][rnd]) for s in steps})
            for s, f in futs.items():
                out[s].append(f.result(timeout=TIMEOUT))
        stats = svc.dispatcher.stats()
    finally:
        svc.close()
    return out, stats


# (tenant, round): lanes whose iterations differ across the packages in the
# synchronous path as well: tenant 2's drift step stops lane 0 at 240
# iterations in the port against the reference's 160 (the packages' sums
# run in other orders; ROADMAP §3)
KNOWN_LANE_DIFFS = {(2, 1): {0}}


def test_coalesced_steps_match_reference_dispatcher(reference_dispatch,
                                                     monkeypatch):
    """Each tenant's coalesced step is its synchronous step in the port, and
    the reference's coalesced step within 1e-3 at equal per-lane
    iterations (but for :data:`KNOWN_LANE_DIFFS`)."""
    monkeypatch.setattr(pdhg, "rademacher_probes", reference_probes)
    ref, ref_stats = reference_dispatch
    steps = {s: _gavel_steps(s) for s in range(4)}
    sync = _sync_reference(steps, dict(domain="gavel",
                                       solve=SolveConfig(**GAVEL_KW)))
    svc = PopService(device="cpu", dispatch=True)
    sessions = {s: svc.session(f"t{s}", domain="gavel",
                               solve=SolveConfig(**GAVEL_KW)) for s in steps}
    try:
        for rnd in range(3):
            futs = _held_round(svc, lambda: {
                s: sessions[s].step_async(steps[s][rnd]) for s in steps})
            for s, f in futs.items():
                a, b = ref[s][rnd], f.result(timeout=TIMEOUT)
                assert np.array_equal(b.alloc, sync[s][rnd].alloc)
                assert a.plan_cache == b.plan_cache
                assert a.warm_fraction == b.warm_fraction
                lanes = [i for i in range(GAVEL_KW["k"])
                         if i not in KNOWN_LANE_DIFFS.get((s, rnd), ())]
                assert np.array_equal(np.asarray(a.raw.iterations)[lanes],
                                      b.raw.iterations[lanes]), (s, rnd)
                assert b.raw.converged.all()
                assert abs(a.metrics["mean_norm_throughput"]
                           - b.metrics["mean_norm_throughput"]) < QUALITY_TOL
        port_stats = svc.dispatcher.stats()
    finally:
        svc.close()
    # one launch a round in the port; the reference's first round can split
    # (its memoized engine builders race on a first concurrent miss,
    # ROADMAP §3), so its counts are not held here
    assert (port_stats["requests"], port_stats["launches"],
            port_stats["coalesced_requests"], port_stats["lanes"],
            port_stats["max_group"]) == (12, 3, 12, 48, 4)
    assert ref_stats["requests"] == 12 and ref_stats["group_fallbacks"] == 0


# ---------------------------------------------------------------------------
# the port's own guarantees
# ---------------------------------------------------------------------------

def test_group_failure_retries_solo():
    """One ticket whose launch raises: the group launch fails, every ticket
    retries solo, its peers get their synchronous results and only its own
    future carries the exception."""
    steps, cfg = _tenants("traffic")
    ref = _sync_reference(steps, cfg)
    svc = PopService(device="cpu", dispatch=True)
    sessions = {s: svc.session(f"t{s}", insts[0], **cfg)
                for s, insts in steps.items()}
    bad = steps[2][0]
    disp = svc.dispatcher
    inner = disp._launch

    def launch(batch, tk):
        if batch is not tk.batch or tk.prep.problem is bad:
            raise RuntimeError("launch failed")
        return inner(batch, tk)

    disp._launch = launch
    try:
        futs = _held_round(svc, lambda: {
            s: sessions[s].step_async(steps[s][0]) for s in steps})
        for s, f in futs.items():
            if s == 2:
                with pytest.raises(RuntimeError, match="launch failed"):
                    f.result(timeout=TIMEOUT)
                continue
            a = f.result(timeout=TIMEOUT)
            assert np.array_equal(a.alloc, ref[s][0].alloc)
        d = disp.stats()
        assert d["group_fallbacks"] == 1
        assert d["coalesced_launches"] == 0
        assert d["solo_launches"] == 3 and d["launches"] == 3
    finally:
        svc.close()


def test_streaming_tenant_launches_inline():
    """A k=1 tenant on the streaming engine has no key: it launches on its
    own thread beside a coalesced launch of two others, and every result is
    its synchronous one."""
    full_exec = ExecConfig(engine="fused_structured_full", solver_kw=KW)
    cfgs = {0: dict(solve=SOLVE, exec=EXEC), 1: dict(solve=SOLVE, exec=EXEC),
            2: dict(solve=SolveConfig(k=1), exec=full_exec)}
    insts = {s: _traffic(seed=s) for s in cfgs}
    ref = {s: PopService(device="cpu").session(f"t{s}", insts[s], **cfgs[s])
           .step(insts[s]) for s in cfgs}
    svc = PopService(device="cpu", dispatch=DispatchConfig(max_lanes=32))
    sessions = {s: svc.session(f"t{s}", insts[s], **cfgs[s]) for s in cfgs}
    try:
        futs = _held_round(svc, lambda: {
            s: sessions[s].step_async(insts[s]) for s in cfgs})
        for s, f in futs.items():
            a = f.result(timeout=TIMEOUT)
            assert np.array_equal(a.alloc, ref[s].alloc), s
        assert sessions[2].last.plan_cache == "full"
        assert sessions[2].last.engine == "fused_structured_full"
        d = svc.dispatcher.stats()
        assert (d["requests"], d["launches"], d["coalesced_launches"],
                d["coalesced_requests"], d["solo_launches"]) == (3, 2, 1, 2, 1)
    finally:
        svc.close()


def test_memoized_builders_build_once_across_threads():
    """Threads that miss a memoized engine builder together get ONE object
    (else equal tenants would get unequal keys and never share)."""
    calls = []

    @pdhg._memoized(maxsize=4)
    def slow(x):
        calls.append(x)
        time.sleep(0.05)
        return object()

    def resolve_all(fn, n=8):
        barrier, out = threading.Barrier(n), []

        def run():
            barrier.wait()
            out.append(fn())

        threads = [threading.Thread(target=run) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and len(out) == n
        return out

    got = resolve_all(lambda: slow(1))
    assert calls == [1] and all(g is got[0] for g in got)
    pdhg.fused_structured_engine.cache_clear()
    got = resolve_all(lambda: pdhg.fused_structured_engine(None))
    assert all(g is got[0] for g in got)
    assert pdhg.fused_structured_engine(None) is got[0]


@pytest.mark.parametrize("rows,n", [(8, 6_145), (3, 2 * 65_536 + 5),
                                    (40, 65_536 + 1)])
@pytest.mark.parametrize("fn", ["sum", "norm"])
def test_row_reduce_is_the_reduction_per_row(rows, n, fn):
    """``kernels/ref.py:row_reduce`` gives each row's sum (2-norm) within
    f32 rounding of the float64 one, short stacks padded and long rows
    chunked (the CUDA heuristics it fixes do not run here), and a row's
    result does not change when other rows join its stack."""
    from repro_torch.kernels import ref
    red = {"sum": ref.sum_last, "norm": ref.norm_last}[fn]
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    got = ref.row_reduce(red, a)
    want = red(a.double())
    assert got.dtype == torch.float32 and got.shape == (rows,)
    assert torch.allclose(got.double(), want, rtol=1e-5,
                          atol=1e-5 * float(a.abs().sum(-1).max()))
    more = torch.cat([a, torch.from_numpy(
        rng.standard_normal((2 * rows, n)).astype(np.float32))])
    assert torch.equal(ref.row_reduce(red, more)[:rows], got)


def test_device_is_part_of_the_key():
    prob = _traffic()
    op = _full_stack(prob)
    engine = pdhg.matvec_engine(prob.K_mv, prob.KT_mv)
    on_meta = pdhg.map_arrays(lambda a: a.to("meta"), op)
    keys = [backends_mod.coalesce_key(o, prob.K_mv, prob.KT_mv, "vmap",
                                      engine, dict(max_iters=100), {})
            for o in (op, on_meta)]
    assert None not in keys and keys[0] != keys[1]


def _service_threads():
    return [t for t in threading.enumerate()
            if t.name == "pop-dispatch" or t.name.startswith("pop-step")]


def test_close_leaves_no_thread():
    assert not _service_threads()
    with PopService(device="cpu", dispatch=True) as svc:
        sess = svc.session("t0", _traffic(), solve=SOLVE, exec=EXEC)
        assert sess.step_async(_traffic()).result(timeout=TIMEOUT).status \
            == "ok"
        assert len(_service_threads()) == 2
    assert not _service_threads()
    svc.close()                           # idempotent
    # a closed dispatcher launches inline; stats stay readable
    before = svc.stats()["dispatch"]
    a = sess.step(_traffic(scale=1.02))
    assert a.status == "ok" and a.plan_cache == "hit"
    d = _delta(svc.stats()["dispatch"], before)
    assert (d["requests"], d["solo_launches"]) == (1, 1)
    assert not _service_threads()
    # step_async without a dispatcher: the same pool, closed the same way
    plain = PopService(device="cpu")
    other = plain.session("t1", _traffic(seed=1), solve=SOLVE, exec=EXEC)
    assert other.step_async(_traffic(seed=1)).result(timeout=TIMEOUT) \
        .status == "ok"
    assert "dispatch" not in plain.stats()
    plain.close()
    assert not _service_threads()
