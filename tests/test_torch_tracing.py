"""The span recorder (``repro_torch.tracing``) on the CPU: the tree of one
``PopSession.step``, self times, a recorder that is off, results that do
not move with it, the steady-state guards with it on, one tree per
thread, the dispatcher's map step on its own thread, the spans' mirror
in a ``torch.profiler`` trace, and the reduction ``tools/step_spans.py``
makes of them."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.analysis.runtime import steady_state_guard
from repro_torch.core import ExecConfig, SolveConfig
from repro_torch.domains import GavelInstance
from repro_torch.problems.cluster_scheduling import make_cluster_workload
from repro_torch.service import PopService

KW = dict(max_iters=400, tol_primal=1e-4, tol_gap=1e-4)
PARENT = {"pop.prepare": "pop.step", "pop.build": "pop.prepare",
          "pop.solve_map": "pop.step", "pdhg.setup": "pop.solve_map",
          "pdhg.loop": "pop.solve_map", "pdhg.readback": "pop.solve_map",
          "pdhg.iterate": "pdhg.loop", "pdhg.check": "pdhg.loop",
          "pop.finish": "pop.step"}
NAMES = set(PARENT) | {"pop.step"}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _session(svc=None, tenant="fleet"):
    svc = svc or PopService(device="cpu")
    return svc.session(tenant, domain="gavel",
                       solve=SolveConfig(k=2, strategy="stratified"),
                       exec=ExecConfig(solver_kw=KW))


def _inst(seed, ids=None):
    return GavelInstance(make_cluster_workload(32, seed=seed), job_ids=ids)


def _traced_step(sess, inst):
    tracing.enable()
    try:
        alloc = sess.step(inst)
    finally:
        tracing.disable()
    return alloc, tracing.take()


def _rec(name, id, parent, start, end, step=None, **attrs):
    return tracing.SpanRecord(name, id, parent, step, 0, start, end, attrs)


def test_one_step_is_one_tree():
    sess = _session()
    sess.step(_inst(0))
    alloc, recs = _traced_step(sess, _inst(1))

    by_id = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.name == "pop.step"]
    assert root.parent is None and root.step == root.id
    assert root.attrs == {"plan_cache": alloc.plan_cache}
    assert {r.name for r in recs} == NAMES
    for r in recs:
        assert r.step == root.id and r.thread == threading.get_ident()
        if r is not root:
            parent = by_id[r.parent]
            assert parent.name == PARENT[r.name]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns

    (loop,) = [r for r in recs if r.name == "pdhg.loop"]
    (solve,) = [r for r in recs if r.name == "pop.solve_map"]
    chunks = loop.attrs["chunks"]
    assert loop.attrs["check_every"] == 40 and solve.attrs == {"lanes": 2}
    assert sum(r.name == "pdhg.iterate" for r in recs) == chunks
    assert sum(r.name == "pdhg.check" for r in recs) == chunks
    # the stack steps as long as its slowest lane
    assert chunks * 40 == int(np.asarray(alloc.raw.iterations).max())
    # one timing, not two
    (build,) = [r for r in recs if r.name == "pop.build"]
    assert alloc.build_time_s == build.ns * 1e-9


def test_self_time_is_duration_less_children():
    recs = [_rec("pop.step", 1, None, 0, 100, step=1),
            _rec("pdhg.loop", 2, 1, 10, 90, step=1),
            _rec("pdhg.iterate", 3, 2, 10, 50, step=1),
            _rec("pdhg.check", 4, 2, 55, 80, step=1)]
    assert tracing.self_ns(recs) == {1: 20, 2: 15, 3: 40, 4: 25}
    # a child missing from the list takes nothing from its parent
    assert tracing.self_ns(recs[1:]) == {2: 15, 3: 40, 4: 25}


def test_flag_wait_is_the_loop_self_time():
    sess = _session()
    sess.step(_inst(0))
    _, recs = _traced_step(sess, _inst(1))
    selfs = tracing.self_ns(recs)
    (loop,) = [r for r in recs if r.name == "pdhg.loop"]
    inner = sum(r.ns for r in recs if r.parent == loop.id)
    assert selfs[loop.id] == loop.ns - inner >= 0


def test_off_records_nothing():
    assert not tracing.enabled()
    assert tracing.span("pop.step") is tracing.span("pdhg.check", n=1)
    sess = _session()
    sess.step(_inst(0))
    sess.step(_inst(1))
    with tracing.timed("pop.build") as t:
        time.sleep(0.001)
    assert t.seconds >= 0.001
    assert tracing.take() == []


def test_timed_records_while_on():
    tracing.enable()
    with tracing.span("pop.step") as outer:
        with tracing.timed("pop.build", lanes=3) as t:
            pass
        outer.set(plan_cache="hit")
    tracing.disable()
    build, step = tracing.take()
    assert (build.name, build.parent, build.step) == ("pop.build", step.id,
                                                      step.id)
    assert build.attrs == {"lanes": 3} and step.attrs == {"plan_cache": "hit"}
    assert t.seconds == build.ns * 1e-9


def test_results_are_bit_identical_on_and_off():
    def run(traced):
        sess = _session()
        out = []
        for seed in range(3):
            if traced:
                out.append(_traced_step(sess, _inst(seed))[0])
            else:
                out.append(sess.step(_inst(seed)))
        return out

    off, on = run(False), run(True)
    for a, b in zip(off, on):
        assert np.array_equal(a.alloc, b.alloc)
        for field in a.raw.__dataclass_fields__:
            x, y = getattr(a.raw, field), getattr(b.raw, field)
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), field


def test_steady_state_guard_passes_with_tracing_on():
    sess = _session()
    ids = np.arange(32)
    sess.step(_inst(0, ids))
    sess.step(_inst(1, ids))
    tracing.enable()
    with steady_state_guard(max_retraces=0) as stats:
        for seed in range(2, 6):
            assert sess.step(_inst(seed, ids)).plan_cache == "hit"
    tracing.disable()
    assert stats.builds == 0, stats.built_names
    assert stats.syncs_denied == 0, stats.denied_sites
    assert stats.chunk_checks > 0
    assert sum(r.name == "pop.step" for r in tracing.take()) == 4


def test_two_threads_give_two_disjoint_trees():
    svc = PopService(device="cpu")
    sessions = [_session(svc, f"t{i}") for i in range(2)]
    for s in sessions:
        s.step(_inst(0))
    barrier = threading.Barrier(2, timeout=60)
    errors = []

    def work(sess, seed):
        try:
            barrier.wait()
            for i in range(2):
                sess.step(_inst(seed + i))
        except BaseException as e:      # reported below
            errors.append(e)

    tracing.enable()
    threads = [threading.Thread(target=work, args=(s, 10 * i + 1))
               for i, s in enumerate(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    tracing.disable()
    assert not errors and not any(t.is_alive() for t in threads)

    recs = tracing.take()
    by_id = {r.id: r for r in recs}
    threads_seen = {r.thread for r in recs}
    assert len(threads_seen) == 2
    steps = {}
    for r in recs:
        if r.parent is not None:
            assert by_id[r.parent].thread == r.thread
        assert by_id[r.step].name == "pop.step"
        assert by_id[r.step].thread == r.thread
        steps.setdefault(r.thread, set()).add(r.step)
    a, b = steps.values()
    assert len(a) == len(b) == 2 and not a & b


def test_dispatcher_map_step_has_no_parent():
    svc = PopService(dispatch=True, device="cpu")
    try:
        sess = _session(svc)
        sess.step(_inst(0))
        _, recs = _traced_step(sess, _inst(1))
    finally:
        svc.close()
    (step,) = [r for r in recs if r.name == "pop.step"]
    (solve,) = [r for r in recs if r.name == "pop.solve_map"]
    assert solve.parent is None and solve.step is None
    assert solve.thread != step.thread
    mine = {r.name for r in recs if r.step == step.id}
    assert mine == {"pop.step", "pop.prepare", "pop.build", "pop.finish"}
    loop = [r for r in recs if r.name == "pdhg.loop"]
    assert [r.parent for r in loop] == [solve.id]


def _mirrored(prof) -> list:
    """``(name, start, end)`` of the program spans in a profiler trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU" and e.name() in NAMES:
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda o: (o[1], -o[2]))


def test_spans_stand_in_the_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    sess = _session()
    sess.step(_inst(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.step(_inst(1))                     # recorder off: no mirror
        alloc, recs = _traced_step(sess, _inst(2))
    mirror = _mirrored(prof)
    recs = sorted(recs, key=lambda r: (r.start_ns, -r.end_ns))
    assert [m[0] for m in mirror] == [r.name for r in recs]
    # the same nesting: each span's mirror lies in its parent's mirror
    at = {r.id: m for r, m in zip(recs, mirror)}
    for r in recs:
        if r.parent is not None:
            _, s, e = at[r.id]
            _, ps, pe = at[r.parent]
            assert ps <= s <= e <= pe, r.name
    assert alloc.plan_cache == "hit"


# ---------------------------------------------------------------------------
# the reduction of tools/step_spans.py, on hand-made records
# ---------------------------------------------------------------------------

def _step_spans():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "step_spans.py"
    spec = importlib.util.spec_from_file_location("step_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hand_step(base: int):
    """One step's records: 2 chunks of 40 iterations, times in ns."""
    b, s = base, base + 1
    return [_rec("pop.step", b + 1, None, 0, 10_000, step=b + 1),
            _rec("pop.prepare", b + 2, b + 1, 0, 1_000, step=s),
            _rec("pop.build", b + 3, b + 2, 0, 600, step=s),
            _rec("pop.solve_map", b + 4, b + 1, 1_000, 9_500, step=s,
                 lanes=2),
            _rec("pdhg.setup", b + 5, b + 4, 1_000, 1_200, step=s),
            _rec("pdhg.loop", b + 6, b + 4, 1_200, 9_200, step=s,
                 check_every=40, chunks=2),
            _rec("pdhg.iterate", b + 7, b + 6, 1_300, 4_300, step=s),
            _rec("pdhg.check", b + 8, b + 6, 4_300, 5_300, step=s),
            _rec("pdhg.iterate", b + 9, b + 6, 5_400, 8_400, step=s),
            _rec("pdhg.check", b + 10, b + 6, 8_400, 9_100, step=s),
            _rec("pdhg.readback", b + 11, b + 4, 9_200, 9_400, step=s),
            _rec("pop.finish", b + 12, b + 1, 9_500, 9_900, step=s)]


def test_step_spans_split_and_averages():
    mod = _step_spans()
    split = mod.split_step(_hand_step(0))
    assert split == pytest.approx(dict(
        prepare=1e-6, build=6e-7, setup=4e-7, iterate=6e-6, check=1.7e-6,
        capture=0.0, replay=0.0, flag_wait=3e-7, reduce=4e-7,
        solve_map=8.5e-6, step=1e-5, iterations=80, replays=0))
    steps = [dict(wall_s=1.2e-5, map_s=9e-6, iters=80,
                  split=mod.split_step(_hand_step(100 * i)))
             for i in range(2)]
    avg = mod.averages(steps)
    assert avg["span_iters_equal_lane_max"]
    assert avg["prepare_s"] == pytest.approx(1e-6)
    assert avg["reduce_s"] == pytest.approx(4e-7)
    assert avg["solve_setup_s"] == pytest.approx(4e-7)
    assert avg["iterate_us"] == pytest.approx(6e-6 * 1e6 / 80)
    assert avg["check_us"] == pytest.approx(1.7e-6 * 1e6 / 80)
    assert avg["flag_wait_us"] == pytest.approx(3e-7 * 1e6 / 80)
    assert avg["ms_per_iter"] == pytest.approx(1e3 * 9e-6 / 80)
    assert avg["parts_over_ms_per_iter"] == pytest.approx(8.4e-6 / 9e-6)
    assert avg["prepare_reduce_over_host_prep"] == pytest.approx(
        1.4e-6 / 3e-6)


def test_step_spans_innermost():
    mod = _step_spans()
    ranges = [("pop.step", 0, 100), ("pdhg.loop", 10, 90),
              ("pdhg.iterate", 10, 40), ("pdhg.check", 50, 60),
              ("pop.finish", 92, 95)]
    points = [-1, 5, 10, 45, 55, 60, 61, 91, 93, 100, 101]
    assert mod.innermost(ranges, points) == [
        None, "pop.step", "pdhg.iterate", "pdhg.loop", "pdhg.check",
        "pdhg.check", "pdhg.loop", "pop.step", "pop.finish", "pop.step",
        None]


def _hand_replayed_step():
    """One step's records whose loop ran 4 chunks: one eager, one captured
    (its own iterate and check inside the capture), three replays."""
    s = 1
    return [_rec("pop.step", 1, None, 0, 20_000, step=1),
            _rec("pop.prepare", 2, 1, 0, 1_000, step=s),
            _rec("pop.build", 3, 2, 0, 600, step=s),
            _rec("pop.solve_map", 4, 1, 1_000, 19_000, step=s, lanes=2),
            _rec("pdhg.setup", 5, 4, 1_000, 1_200, step=s),
            _rec("pdhg.loop", 6, 4, 1_200, 18_800, step=s, check_every=40,
                 chunks=4, replays=3, captured=1),
            _rec("pdhg.iterate", 7, 6, 1_300, 4_300, step=s),
            _rec("pdhg.check", 8, 6, 4_300, 5_300, step=s),
            _rec("pdhg.capture", 9, 6, 5_400, 9_400, step=s),
            _rec("pdhg.iterate", 10, 9, 5_500, 8_000, step=s),
            _rec("pdhg.check", 11, 9, 8_000, 9_000, step=s),
            _rec("pdhg.replay", 12, 6, 9_500, 9_600, step=s),
            _rec("pdhg.replay", 13, 6, 12_500, 12_600, step=s),
            _rec("pdhg.replay", 14, 6, 15_500, 15_600, step=s),
            _rec("pdhg.readback", 15, 4, 18_800, 19_000, step=s),
            _rec("pop.finish", 16, 1, 19_000, 19_500, step=s)]


def test_step_spans_split_with_replays():
    """The captured chunk's own iterate and check count in ``capture``, not
    twice; the replays' launches in ``replay``; the flag wait is the loop's
    self time, labelled the device's; the parts still sum to
    ``ms_per_iter``."""
    mod = _step_spans()
    split = mod.split_step(_hand_replayed_step())
    assert split == pytest.approx(dict(
        prepare=1e-6, build=6e-7, setup=4e-7, iterate=3e-6, check=1e-6,
        capture=4e-6, replay=3e-7, flag_wait=9.3e-6, reduce=5e-7,
        solve_map=1.8e-5, step=2e-5, iterations=160, replays=3))
    avg = mod.averages([dict(wall_s=2e-5, map_s=1.8e-5, iters=160,
                             split=split)])
    assert avg["capture_s"] == pytest.approx(4e-6)
    assert avg["replay_us"] == pytest.approx(3e-7 * 1e6 / 160)
    assert avg["iterate_us"] == pytest.approx(3e-6 * 1e6 / 160)
    assert avg["flag_wait_us"] == pytest.approx(9.3e-6 * 1e6 / 160)
    assert avg["parts_over_ms_per_iter"] == pytest.approx(1.0)
    assert avg["flag_wait_is"] == mod.FLAG_WAIT[True]
    eager = mod.averages([dict(wall_s=1.2e-5, map_s=9e-6, iters=80,
                               split=mod.split_step(_hand_step(0)))])
    assert eager["flag_wait_is"] == mod.FLAG_WAIT[False]
    assert (eager["capture_s"], eager["replay_us"]) == (0.0, 0.0)


class _ReplayedOnCpu:
    """A CUDA graph's stand-in on the CPU: capturing runs nothing, each
    replay runs the chunk again and writes the loop flag in place."""

    def __init__(self, device, body):
        self.body = body
        self.outputs = torch.zeros((), dtype=torch.bool)

    def replay(self):
        self.outputs.copy_(self.body())


def test_replayed_step_tree_and_split(monkeypatch):
    """A session step whose chunks replay (the graph stood in for on the
    CPU): ``pdhg.capture`` and each ``pdhg.replay`` lie in ``pdhg.loop``,
    the loop reads ``captured`` 1 and ``replays`` ``chunks - 1``, and the
    split covers the map step's solver spans once.  (The stand-in runs the
    chunk, and so its iterate and check spans, at each replay; a captured
    graph records them once, inside ``pdhg.capture``.)"""
    from repro_torch.core import pdhg
    monkeypatch.setattr(pdhg, "_capture_on", lambda eng, dev: eng.capturable)
    monkeypatch.setattr(pdhg, "_ChunkGraph", _ReplayedOnCpu)
    sess = _session()
    sess.step(_inst(0))
    alloc, recs = _traced_step(sess, _inst(1))
    by_id = {r.id: r for r in recs}
    (loop,) = [r for r in recs if r.name == "pdhg.loop"]
    chunks = loop.attrs["chunks"]
    assert chunks > 1 and chunks * 40 == int(
        np.asarray(alloc.raw.iterations).max())
    assert (loop.attrs["captured"], loop.attrs["replays"]) == (1, chunks - 1)
    (capture,) = [r for r in recs if r.name == "pdhg.capture"]
    replays = [r for r in recs if r.name == "pdhg.replay"]
    assert capture.parent == loop.id and len(replays) == chunks - 1
    assert all(r.parent == loop.id for r in replays)
    for name in ("pdhg.iterate", "pdhg.check"):
        parents = [by_id[r.parent].name for r in recs if r.name == name]
        assert parents.count("pdhg.loop") == 1
        assert parents.count("pdhg.replay") == chunks - 1
    mod = _step_spans()
    split = mod.split_step(recs)
    assert split["replays"] == chunks - 1
    solver = sum(r.ns for r in recs if r.name in (
        "pdhg.setup", "pdhg.loop", "pdhg.readback")) * 1e-9
    parts = (split["setup"] + split["iterate"] + split["check"]
             + split["capture"] + split["replay"] + split["flag_wait"])
    assert parts == pytest.approx(solver, rel=1e-9)
