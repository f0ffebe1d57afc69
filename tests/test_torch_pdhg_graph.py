"""The solve loop's captured chunk (``core/pdhg.solve_stacked``): on a CUDA
device, with an engine whose half-steps can be captured, every chunk after
the first replays one CUDA graph, and every ``SolveResult`` field comes out
equal, bit for bit, to the eager loop's.

Each case runs twice.  ``cuda`` captures for real on the card, at the
benchmark's 16,384-job Gavel fleet (k = 8), and skips without a card.
``cpu-replayed`` runs the same loop on the CPU at 256 jobs with the graph
replaced by :class:`_EagerGraph`, which runs the captured body again at
each replay: the static state, its write-back, the loop test read from
the graph's output and the spans are the card's.  The eager loop both are
held against is reached by turning the engines' ``capturable`` flag off.
The CPU-only cases hold that the CPU loop never captures and each
engine's flag."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import testing, tracing
from repro_torch.analysis.runtime import steady_state_guard
from repro_torch.core import ExecConfig, SolveConfig, pdhg
from repro_torch.service import PopService

CHECK = 40
KW = dict(max_iters=20_000, tol_primal=1e-4, tol_gap=1e-4, equilibrate=True)
CAPTURED_ENGINES = ("fused_structured_engine", "fused_dense_engine",
                    "fused_structured_full_engine")


class _EagerGraph:
    """Stands in for ``pdhg._ChunkGraph`` on the CPU: capturing runs
    nothing, each replay runs the body and writes its loop flag into the
    one output tensor, as a replayed graph writes its outputs in place."""

    def __init__(self, device, body):
        self.body = body
        self.outputs = torch.zeros((), dtype=torch.bool, device=device)

    def replay(self):
        self.outputs.copy_(self.body())


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(params=[
    pytest.param("cpu", id="cpu-replayed"),
    pytest.param("cuda", id="cuda", marks=pytest.mark.cuda)])
def device(request, monkeypatch):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the chunk is captured as a "
                        "CUDA graph only on the GPU")
        return torch.device("cuda")
    monkeypatch.setattr(pdhg, "_capture_on",
                        lambda eng, dev: eng.capturable)
    monkeypatch.setattr(pdhg, "_ChunkGraph", _EagerGraph)
    return torch.device("cpu")


def _fleet(device, seed=0):
    """(instances of a cold / warm / 5%-churn session, its solve and exec
    configs): the benchmark's fleet on the card, a small one on the CPU;
    ``seed`` draws another tenant."""
    n, workers = ((16_384, (4_096,) * 3) if device.type == "cuda"
                  else (256, (64,) * 3))
    insts = testing.session_instances(n, workers, 0.05, seed=seed)
    return (insts, SolveConfig(k=8, strategy="stratified", min_per_sub=8),
            ExecConfig(solver_kw=KW))


def _structured_stack():
    """A small 4-lane Gavel stack on the CPU."""
    from repro_torch.core import pop
    from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                         make_cluster_workload)
    prob = GavelProblem(make_cluster_workload(64, num_workers=(16,) * 3,
                                              seed=1))
    return pop.build(prob, pop.plan(prob, 4, strategy="stratified"), "cpu")


def _dense_op():
    return testing.dense_stack(testing.random_dense_lps(3, 24, 16), "cpu")


def _eager(m) -> None:
    """Every engine builder of ``pdhg`` hands out its engine with the
    capture flag off, inside the monkeypatch context ``m`` (one object a
    key, as the memoized builders do)."""
    for name in CAPTURED_ENGINES:
        made: dict = {}

        def off(*args, _orig=getattr(pdhg, name), _made=made):
            if args not in _made:
                _made[args] = _orig(*args)._replace(capturable=False)
            return _made[args]
        m.setattr(pdhg, name, off)


def _recorded(m) -> list:
    """``[(args, kwargs, result)]`` of every ``solve_stacked`` call from
    now on, inside the monkeypatch context ``m``."""
    calls = []
    orig = pdhg.solve_stacked

    def record(*args, **kw):
        res = orig(*args, **kw)
        calls.append((args, kw, res))
        return res
    m.setattr(pdhg, "solve_stacked", record)
    return calls


def _run_session(device, insts, solve, exec_cfg, monkeypatch, eager):
    """Each step's allocation and the session's solves, the recorder on."""
    with monkeypatch.context() as m:
        if eager:
            _eager(m)
        calls = _recorded(m)
        sess = PopService(device=device).session(
            "fleet", insts[0], domain="gavel", solve=solve, exec=exec_cfg)
        tracing.enable()
        allocs = [sess.step(inst) for inst in insts]
        tracing.disable()
    return allocs, calls, tracing.take()


def _same_bits(got, want) -> None:
    for field in pdhg.SolveResult._fields:
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is b, field
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), field
        assert a.tobytes() == b.tobytes(), field


def _loops(recs) -> list:
    return [r.attrs for r in recs if r.name == "pdhg.loop"]


def _launches() -> list:
    return [dict(c) for c in pdhg._launch_counts()]


def _launched(before) -> list:
    """What the kernel wrappers' launch counts went up by since
    ``before`` (:func:`_launches`)."""
    return [{k: c[k] - b[k] for k in c}
            for c, b in zip(pdhg._launch_counts(), before)]


def _solve_traced(args, kw):
    """(result, loop attrs, records) of one ``solve_stacked`` call; the
    attrs hold ``launched``, what the wrappers' launch counts went up by."""
    before = _launches()
    tracing.enable()
    try:
        res = pdhg.solve_stacked(*args, **kw)
    finally:
        tracing.disable()
    recs = tracing.take()
    (loop,) = _loops(recs)
    return res, dict(loop, launched=_launched(before)), recs


def _both_ways(args, kw):
    """(captured result, eager result, the captured solve's loop attrs and
    records) of one ``solve_stacked`` call; both count the same kernel
    launches."""
    eng = pdhg.resolve_engine(pdhg.engine_name(kw["engine"]), args[0])
    assert eng.capturable and eng.name == "fused_structured"
    got, loop, recs = _solve_traced(args, dict(kw, engine=eng))
    want, eager_loop, _ = _solve_traced(
        args, dict(kw, engine=eng._replace(capturable=False)))
    assert eager_loop == dict(loop, replays=0, captured=0)
    return got, want, loop, recs


def _assert_replayed(loop, recs) -> None:
    """A solve of more than one chunk captures once and replays the rest;
    one of one chunk captures nothing."""
    chunks = loop["chunks"]
    assert loop["check_every"] == CHECK
    assert loop["captured"] == int(chunks > 1)
    assert loop["replays"] == max(chunks - 1, 0)
    assert sum(r.name == "pdhg.capture" for r in recs) == loop["captured"]
    assert sum(r.name == "pdhg.replay" for r in recs) == loop["replays"]


@pytest.fixture
def fleet_calls(device, monkeypatch):
    """The cold and the warm ``solve_stacked`` call of the fleet's session
    (solved with the capture flag off)."""
    insts, solve, exec_cfg = _fleet(device)
    _, calls, _ = _run_session(device, insts[:2], solve, exec_cfg,
                               monkeypatch, eager=True)
    return [(args, kw) for args, kw, _ in calls]


def test_warm_stack_replays_bit_for_bit(fleet_calls):
    """The warm step's 8-lane stack: one captured chunk replayed to the
    end gives the eager loop's x, y, iterations, restarts, flags and
    objectives."""
    args, kw = fleet_calls[1]
    assert args[0].c.shape[0] == 8 and kw["warm_x"] is not None
    got, want, loop, recs = _both_ways(args, kw)
    _same_bits(got, want)
    assert loop["chunks"] > 2
    _assert_replayed(loop, recs)
    assert loop["chunks"] * CHECK == int(got.iterations.max())


def test_lanes_freezing_at_different_chunks(fleet_calls):
    """Half the lanes start warm and half cold: they stop at different
    chunks, frozen while the stack steps on, in the graph as eagerly."""
    args, kw = fleet_calls[1]
    k = args[0].c.shape[0]
    kw = dict(kw, warm_mask=np.arange(k) % 2 == 0)
    got, want, loop, recs = _both_ways(args, kw)
    _same_bits(got, want)
    assert len(np.unique(got.iterations)) > 1
    _assert_replayed(loop, recs)


def test_lane_stopped_at_max_iters(fleet_calls):
    """The cold stack under a budget some lanes reach unconverged: they
    stop at exactly ``max_iters``, the chunk the eager loop stops at."""
    args, kw = fleet_calls[0]
    cap = 6 * CHECK
    got, want, loop, recs = _both_ways(args, dict(kw, max_iters=cap))
    _same_bits(got, want)
    assert (got.iterations == cap).any() and not got.converged.all()
    assert loop["chunks"] == cap // CHECK
    _assert_replayed(loop, recs)


def test_one_chunk_solve_captures_nothing(fleet_calls):
    args, kw = fleet_calls[1]
    got, want, loop, recs = _both_ways(args, dict(kw, max_iters=CHECK))
    _same_bits(got, want)
    assert loop["chunks"] == 1
    _assert_replayed(loop, recs)
    assert not any(r.name in ("pdhg.capture", "pdhg.replay") for r in recs)


def test_miss_hit_repair_session_bit_for_bit(device, monkeypatch):
    """A cold step (a plan miss), a warm one (a hit) and a 5% churn repair:
    the captured session's allocations and every solve equal the eager
    session's."""
    insts, solve, exec_cfg = _fleet(device)
    want, want_calls, _ = _run_session(device, insts, solve, exec_cfg,
                                       monkeypatch, eager=True)
    got, got_calls, recs = _run_session(device, insts, solve, exec_cfg,
                                        monkeypatch, eager=False)
    assert [a.plan_cache for a in got] == ["miss", "hit", "repair"]
    assert [a.plan_cache for a in want] == ["miss", "hit", "repair"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.alloc, b.alloc)
    assert len(got_calls) == len(want_calls) == 3
    for (_, _, a), (_, _, b) in zip(got_calls, want_calls):
        _same_bits(a, b)
    loops = _loops(recs)
    assert len(loops) == 3 and all(lp["captured"] == 1 for lp in loops)
    for lp in loops:
        assert lp["replays"] == lp["chunks"] - 1


def test_dispatcher_solve_beside_another_session(device, monkeypatch):
    """One tenant's solves on the serving dispatcher's thread while a
    second session steps on another thread: both capture, beside each
    other's allocations, and both equal their eager runs."""
    insts, solve, exec_cfg = _fleet(device)
    other = _fleet(device, seed=3)[0]

    def run(eager):
        with monkeypatch.context() as m:
            if eager:
                _eager(m)
            svc = PopService(device=device, dispatch=True)
            plain = PopService(device=device)
            try:
                tenant = svc.session("tenant", insts[0], domain="gavel",
                                     solve=solve, exec=exec_cfg)
                beside = plain.session("beside", other[0], domain="gavel",
                                       solve=solve, exec=exec_cfg)
                out = {"tenant": [], "beside": []}
                errors = []
                barrier = threading.Barrier(2, timeout=600)

                def work(name, sess, seq):
                    try:
                        barrier.wait()
                        for inst in seq:
                            out[name].append(sess.step(inst))
                    except BaseException as e:      # reported below
                        errors.append(e)

                tracing.enable()
                threads = [threading.Thread(target=work, args=a) for a in (
                    ("tenant", tenant, insts), ("beside", beside, other))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                tracing.disable()
                assert not errors, errors
                assert not any(t.is_alive() for t in threads)
            finally:
                svc.close()
        return out, tracing.take()

    want, _ = run(eager=True)
    got, recs = run(eager=False)
    for name in ("tenant", "beside"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a.alloc, b.alloc)
            for field in ("iterations", "converged", "x"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a.raw, field)),
                    np.asarray(getattr(b.raw, field)), err_msg=field)
    maps = {r.id: r for r in recs if r.name == "pop.solve_map"}
    loops = [r for r in recs if r.name == "pdhg.loop"]
    assert len(loops) == 6 and all(r.attrs["captured"] for r in loops)
    # the tenant's solves ran on the dispatcher's thread, beside the other
    threads = {r.thread for r in loops}
    assert len(threads) == 2
    assert sum(maps[r.parent].parent is None for r in loops) == 3


def test_steady_state_guard_passes_a_captured_step(device):
    """Warm steps whose chunks replay build nothing and sync only at the
    loop test (one a chunk, plus the loop's exit test) and the readback."""
    insts, solve, exec_cfg = _fleet(device)
    sess = PopService(device=device).session(
        "fleet", insts[0], domain="gavel", solve=solve, exec=exec_cfg)
    for inst in insts:
        sess.step(inst)
    last = insts[-1]
    rng = np.random.default_rng(5)
    drifted = [dataclasses.replace(last, wl=dataclasses.replace(
        last.wl, T=last.wl.T * rng.uniform(0.97, 1.03, last.wl.T.shape)))
        for _ in range(2)]
    lane_max = []
    tracing.enable()
    with steady_state_guard(max_retraces=0) as stats:
        for inst in drifted:
            a = sess.step(inst)
            lane_max.append(int(np.asarray(a.raw.iterations).max()))
    tracing.disable()
    loops = _loops(tracing.take())
    assert [lp["captured"] for lp in loops] == [1, 1]
    assert stats.builds == 0, stats.built_names
    assert stats.syncs_denied == 0, stats.denied_sites
    assert stats.hot_backend_calls == 2
    assert stats.chunk_checks == sum(m // CHECK + 1 for m in lane_max)
    if device.type == "cuda":
        assert stats.modes == {"cuda"} and stats.readbacks == 2 * 10
    else:
        assert stats.modes == {"cpu"} and stats.readbacks > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk is captured as a CUDA "
                    "graph only on the GPU")
    return torch.device("cuda")


def _replays_like_eager(op, eng, **kw):
    """Solve ``op`` with ``eng`` captured and with its flag off; both
    results must be the same bits."""
    eng = eng._replace(capturable=True)
    got, loop, recs = _solve_traced((op,), dict(kw, engine=eng))
    want, eager_loop, _ = _solve_traced((op,), dict(
        kw, engine=eng._replace(capturable=False)))
    _same_bits(got, want)
    assert loop["launched"] == eager_loop["launched"]
    assert loop["chunks"] > 1
    _assert_replayed(loop, recs)
    return got


@pytest.mark.cuda
def test_cuda_dense_engine_replays_bit_for_bit(cuda_device):
    """The dense ``fused`` engine's two kernels a half-step, captured."""
    op = testing.densify(pdhg.to_device(_structured_stack(), cuda_device))
    eng = pdhg.resolve_engine("fused", op)
    assert eng.capturable
    _replays_like_eager(op, eng, max_iters=2_000, tol_primal=1e-6,
                        tol_gap=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters, tol", [(400, 0.0), (8_000, 1e-4)])
def test_cuda_full_engine_replays_bit_for_bit(cuda_device, max_iters, tol):
    """The single-lane full engine's cooperative launches, captured and
    replayed: a fixed budget and a solve to tolerance on the KDL-like
    traffic instance give the eager loop's bits."""
    from repro_torch.problems.traffic_engineering import TrafficProblem
    prob = TrafficProblem(*testing.traffic_arrays(600))
    op = pdhg.to_device(pdhg.map_arrays(lambda a: a[None],
                                        prob.build_full()), cuda_device)
    eng = pdhg.resolve_engine("fused_structured_full", op)
    _replays_like_eager(op, eng, max_iters=max_iters, tol_primal=tol,
                        tol_gap=tol)


# ---------------------------------------------------------------------------
# the CPU: no capture, and each engine's flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["fused_structured", "fused", "matvec"])
def test_cpu_loop_never_captures(engine):
    """The real loop on CPU tensors, with engines that would be captured
    on a card and one that never is: every chunk runs eagerly."""
    op = _structured_stack() if engine == "fused_structured" else _dense_op()
    eng = pdhg.resolve_engine(engine, op)
    assert eng.name == engine
    res, loop, recs = _solve_traced((op,), dict(
        engine=eng, max_iters=400, tol_primal=1e-6, tol_gap=1e-6))
    assert loop["chunks"] > 1
    assert (loop["captured"], loop["replays"]) == (0, 0)
    assert not any(r.name in ("pdhg.capture", "pdhg.replay") for r in recs)
    assert sum(r.name == "pdhg.iterate" for r in recs) == loop["chunks"]
    assert loop["chunks"] * CHECK == int(res.iterations.max())


def _full_engine():
    return pdhg.fused_structured_full_engine(
        None, *pdhg._wide_block_plans(testing.ragged_operator()))


@pytest.mark.parametrize("make, capturable", [
    pytest.param(pdhg.fused_structured_engine, True, id="fused_structured"),
    pytest.param(lambda: pdhg.fused_structured_engine("ref"), True,
                 id="fused_structured_ref"),
    pytest.param(pdhg.fused_dense_engine, True, id="fused"),
    pytest.param(_full_engine, True, id="fused_structured_full"),
    pytest.param(pdhg.matvec_engine, False, id="matvec"),
    pytest.param(lambda: pdhg._engine_from_matvecs(
        "matvec_scaled", pdhg.dense_K_mv, pdhg.dense_KT_mv), False,
        id="matvec_scaled"),
    pytest.param(lambda: pdhg.StepEngine(
        "mine", pdhg.dense_K_mv, pdhg.dense_KT_mv, None, None), False,
        id="step_engine_default"),
])
def test_engine_capture_flag(make, capturable):
    """Which engines the loop captures: the fused engines, whose half-steps
    are the hand-written kernels (or their plain versions) on the current
    stream; never the problem's own matvecs, which may sync, nor an engine
    that does not say it can be.  Only on a CUDA device."""
    eng = make()
    assert eng.capturable is capturable
    assert pdhg._capture_on(eng, torch.device("cuda", 0)) is capturable
    assert pdhg._capture_on(eng, torch.device("cpu")) is False


def test_copy_state_writes_every_field():
    """The write-back of a replayed chunk: every field of the new state
    lands in the static one, whatever its dtype."""
    k, n, m = 3, 5, 4
    x0 = torch.zeros(k, n)
    src = pdhg._start_state(torch.rand(k, n), torch.rand(k, m),
                            torch.rand(k, m), torch.rand(k, n), 2.0)
    src = src._replace(it=torch.tensor([40, 80, 0], dtype=torch.int32),
                       done=torch.tensor([True, False, True]))
    dst = pdhg._start_state(x0, torch.zeros(k, m), torch.zeros(k, m),
                            torch.zeros(k, n), 1.0)
    dst = pdhg._State(*[t.clone() for t in dst])
    ptrs = [t.data_ptr() for t in dst]
    pdhg._copy_state(dst, src)
    assert [t.data_ptr() for t in dst] == ptrs
    for a, b in zip(dst, src):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_replays_count_the_captured_launches():
    """A captured body's wrapper calls leave the launch counts as they
    were, and each replay adds them, so a replayed solve counts a launch
    an iteration as the eager loop does."""
    from repro_torch.kernels import pdhg_matvec, structured_pdhg_step
    counted = {"calls": structured_pdhg_step.LAUNCHES,
               "cuda": structured_pdhg_step.CUDA_LAUNCHES,
               "matvec": pdhg_matvec.LAUNCHES}
    before = _launches()
    at = {k: dict(c) for k, c in counted.items()}

    def body():
        for _ in range(CHECK):
            counted["calls"]["structured_forward_step"] += 1
            counted["cuda"]["structured_forward_step"] += 2
        counted["matvec"]["bmatvec"] += 1
        return "outputs"

    out, launched = pdhg._counted_apart(body)
    assert out == "outputs"
    assert _launches() == before
    for _ in range(3):
        pdhg._count_launched(launched)
    went_up = {(k, name): c[name] - at[k][name]
               for k, c in counted.items() for name in c
               if c[name] != at[k][name]}
    assert went_up == {("calls", "structured_forward_step"): 3 * CHECK,
                       ("cuda", "structured_forward_step"): 6 * CHECK,
                       ("matvec", "bmatvec"): 3}
    assert sum(n for c in _launched(before) for n in c.values()) \
        == 9 * CHECK + 3
