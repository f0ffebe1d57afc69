"""Port parity for load balancing (``repro_torch.problems.load_balancing``,
the ``load_balance`` domain, ``core/rounding.py`` and ``core/maxmin.py``).

Both packages draw the same instances from the same seeds:

* the workload draw, the rounding and repair, the warm-start remap, the
  E-Store greedy and ``round_relaxation`` are the reference's numpy code,
  so their outputs are bit-equal; the relaxation's LP fields and packed
  ELL arrays are exactly equal;
* the torch matvecs agree with the reference's within 1e-5, and their
  stacked forms (what the ``matvec`` engine runs) with the per-lane forms
  within 1e-6, lane by lane;
* the ``balance`` cells of the conformance matrix
  (``tests/test_engine_conformance.py``: 18 shards on 6 servers in three
  server groups) agree with the reference's ``matvec``/``vmap`` run at
  rtol = atol = 1e-5 with equal iterations, through every engine and
  backend; so do a warm-started cell and the single-lane full case through
  ``fused_structured_full``;
* the reference's own load-balancing checks hold on the port, and a
  three-step ``load_balance`` session (cold, drift, 20% churn) gives the
  reference's placements, verdicts and warm fractions at a fixed budget."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ExecConfig as RefExecConfig
from repro.core import backends as rback, pdhg as rpdhg
from repro.core import maxmin as rmaxmin, rounding as rrounding
from repro.domains import get as ref_domain
from repro.domains.load_balance import BalanceInstance as RefBalanceInstance
from repro.problems import load_balancing as rlb
from repro.service import PopService as RefPopService
from repro_torch import domains, testing
from repro_torch.core import backends as tback, pdhg as tpdhg
from repro_torch.core import maxmin as tmaxmin, rounding as trounding
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.core.pdhg import map_arrays
from repro_torch.domains import BalanceInstance
from repro_torch.problems import load_balancing as tlb
from repro_torch.service import PopService

FIXED_KW = dict(max_iters=120, check_every=40, tol_primal=0.0, tol_gap=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's own settings (tests/test_problems.py, tests/test_plan.py,
# tests/test_step_engine.py)
SOLVER_KW = dict(max_iters=20_000, tol_primal=1e-4, tol_gap=1e-4)
CHURN_KW = dict(max_iters=12_000, tol_primal=1e-4, tol_gap=1e-4)
WARM_KW = dict(max_iters=6_000, tol_primal=1e-4, tol_gap=1e-4)
LP_FIELDS = ("c", "q", "l", "u", "ineq_mask")


def _both(n_shards, n_servers, seed, **kw):
    return (rlb.make_shard_workload(n_shards, n_servers, seed=seed, **kw),
            tlb.make_shard_workload(n_shards, n_servers, seed=seed, **kw))


def _conformance_lanes(wl):
    """The conformance matrix's split: three server groups, every shard
    in its current server's group, padded to the widest lane."""
    groups = [np.arange(6)[i::3] for i in range(3)]
    shard_sets = [np.flatnonzero(np.isin(wl.placement, g)) for g in groups]
    n_pad = max(len(s) for s in shard_sets)
    return [(s, g, n_pad, 2) for s, g in zip(shard_sets, groups)]


def _relax_args(case, wl):
    if case == "full":
        return (np.arange(18), np.arange(6), 18, 6)
    return _conformance_lanes(wl)[int(case[-1])]


# --------------------------------------------------------------------------
# the instance and the operator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(18, 6, 2), (256, 16, 0), (1024, 64, 0)],
                         ids=str)
def test_make_shard_workload_bit_equal(shape):
    ref, port = _both(*shape)
    for f in ("load", "mem", "placement", "cap"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert port.eps_frac == ref.eps_frac and port.ids is ref.ids is None
    assert port.target == ref.target


@pytest.mark.parametrize("case", ["lane0", "lane1", "lane2", "full"])
def test_relax_op_matches_reference(case):
    """The LP fields and payload exactly, and with ``structured=True`` the
    packed ELL arrays exactly."""
    rwl, twl = _both(18, 6, 2)
    args = _relax_args(case, rwl)
    rop = rlb.LoadBalanceProblem(rwl)._relax_op(*args, structured=True)
    top = tlb.LoadBalanceProblem(twl)._relax_op(*args, structured=True,
                                                device="cpu")
    for f in LP_FIELDS:
        a, b = np.asarray(getattr(rop, f)), getattr(top, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for a, b in zip(rop.data, top.data):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in rop.structured._fields:
        a, b = getattr(rop.structured, f), getattr(top.structured, f)
        if a is None:
            assert b is None, f
            continue
        assert np.asarray(a).dtype == b.numpy().dtype, f
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


def test_relax_op_stays_on_the_requested_device():
    """Every leaf, the ELL metadata included, lies on the device asked
    for (``meta`` here: no leaf can land there by default)."""
    _, wl = _both(18, 6, 2)
    op = tlb.LoadBalanceProblem(wl)._relax_op(*_relax_args("full", wl),
                                              structured=True, device="meta")
    devices = set()
    map_arrays(lambda a: devices.add(a.device.type), op)
    assert devices == {"meta"}


def test_matvecs_match_reference():
    rwl, twl = _both(64, 8, 0)
    args = (np.arange(64), np.arange(8), 64, 8)
    rop = rlb.LoadBalanceProblem(rwl)._relax_op(*args)
    top = tlb.LoadBalanceProblem(twl)._relax_op(*args, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=top.c.shape[0]).astype(np.float32)
    y = rng.normal(size=top.q.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tlb._k_mv(top.data, torch.as_tensor(x)),
                               np.asarray(rlb._k_mv(rop.data, x)), **TOL)
    np.testing.assert_allclose(tlb._kt_mv(top.data, torch.as_tensor(y)),
                               np.asarray(rlb._kt_mv(rop.data, y)), **TOL)


def test_lb_operator_adjoint():
    """The port's twin of ``tests/test_problems.py::test_lb_operator_
    adjoint``."""
    _, wl = _both(64, 8, 0)
    op = tlb.LoadBalanceProblem(wl)._relax_op(np.arange(64), np.arange(8),
                                              64, 8, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=op.c.shape[0]), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=op.q.shape[0]), dtype=torch.float32)
    lhs = float(torch.dot(tlb._k_mv(op.data, x), y))
    rhs = float(torch.dot(x, tlb._kt_mv(op.data, y)))
    assert abs(lhs - rhs) < 1e-2 * (1 + abs(lhs))


@pytest.mark.parametrize("shape", [(18, 6, 2), (256, 16, 0)], ids=str)
def test_stacked_matvecs_match_the_per_lane_forms(shape):
    """The matvec engine runs the stacked forms; lane by lane they give
    the per-lane forms within 1e-6, and the engine picks them."""
    n, s, seed = shape
    _, wl = _both(n, s, seed)
    prob = tlb.LoadBalanceProblem(wl)
    groups = [np.arange(s)[i::4] for i in range(4)]
    shard_sets = [np.flatnonzero(np.isin(wl.placement, g)) for g in groups]
    n_pad = max(len(ss) for ss in shard_sets)
    ops = tpdhg.stack_ops([prob._relax_op(ss, g, n_pad, len(groups[0]),
                                          device="cpu")
                           for ss, g in zip(shard_sets, groups)])
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=ops.c.shape), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=ops.q.shape), dtype=torch.float32)
    kx = tlb._k_mv_stacked(ops.data, x)
    kty = tlb._kt_mv_stacked(ops.data, y)
    for i in range(4):
        lane = map_arrays(lambda a, i=i: a[i], ops.data)
        np.testing.assert_allclose(kx[i], tlb._k_mv(lane, x[i]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(kty[i], tlb._kt_mv(lane, y[i]),
                                   rtol=1e-6, atol=1e-6)
    eng = tpdhg.matvec_engine(tlb._k_mv, tlb._kt_mv)
    assert eng.K is tlb._k_mv_stacked and eng.KT is tlb._kt_mv_stacked
    assert tpdhg.select_engine(ops, tlb._k_mv, tlb._kt_mv) == "matvec"


# --------------------------------------------------------------------------
# the balance cells of the conformance matrix
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def balance_cell():
    """(reference stacked ops, port stacked ops, port densified ops, the
    reference's matvec/vmap result at the fixed budget)."""
    rwl, twl = _both(18, 6, 2)
    lanes = _conformance_lanes(rwl)
    rops = rpdhg.stack_ops([rlb.LoadBalanceProblem(rwl)._relax_op(
        *a, structured=True) for a in lanes])
    tops = tpdhg.stack_ops([tlb.LoadBalanceProblem(twl)._relax_op(
        *a, structured=True, device="cpu") for a in lanes])
    dense = tops._replace(data=(tpdhg.structured_to_dense(tops.structured),),
                          structured=None)
    want = rback.solve_map(rops, rlb._k_mv, rlb._kt_mv, FIXED_KW,
                           backend="vmap", engine="matvec")
    return rops, tops, dense, want


def _engine_inputs(cell, engine):
    _, tops, dense, _ = cell
    if engine == "fused":
        return dense, tpdhg.dense_K_mv, tpdhg.dense_KT_mv
    return tops, tlb._k_mv, tlb._kt_mv


@pytest.mark.parametrize("backend", ["serial", "vmap", "chunked_vmap"])
@pytest.mark.parametrize("engine", ["matvec", "fused", "fused_structured"])
def test_balance_conformance_cells_match_reference(balance_cell, engine,
                                                   backend):
    """Every engine (the structured and dense ones through their plain
    versions, on CPU tensors) on every backend; chunked_vmap at chunk=2
    pads the k=3 stack to 4 lanes."""
    ops, k_mv, kt_mv = _engine_inputs(balance_cell, engine)
    want = balance_cell[3]
    opts = {"chunk": 2} if backend == "chunked_vmap" else {}
    got = tback.solve_map(ops, k_mv, kt_mv, FIXED_KW, backend=backend,
                          engine=engine, **opts)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))


def test_balance_conformance_warm_started(balance_cell):
    """The reference's warm-started balance cell: every port engine seeded
    with the reference's 80-iteration iterates gives the reference's warm
    matvec trajectory."""
    rops = balance_cell[0]
    seed = rback.solve_map(rops, rlb._k_mv, rlb._kt_mv,
                           dict(FIXED_KW, max_iters=80), backend="vmap",
                           engine="matvec")
    warm = (np.asarray(seed.x), np.asarray(seed.y))
    want = rback.solve_map(rops, rlb._k_mv, rlb._kt_mv, FIXED_KW,
                           backend="vmap", engine="matvec", warm=warm)
    for engine in ("matvec", "fused", "fused_structured"):
        ops, k_mv, kt_mv = _engine_inputs(balance_cell, engine)
        got = tback.solve_map(ops, k_mv, kt_mv, FIXED_KW, backend="vmap",
                              engine=engine, warm=warm)
        np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
        np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)


def test_full_case_through_the_full_engine_matches_reference():
    """The single-lane relaxation with fold maps through
    ``fused_structured_full`` (plain versions) against the reference's
    matvec solve."""
    rwl, twl = _both(18, 6, 2)
    args = _relax_args("full", rwl)
    rop = rlb.LoadBalanceProblem(rwl)._relax_op(*args)
    top = tlb.LoadBalanceProblem(twl)._relax_op(*args, structured=True,
                                                device="cpu")
    want = rback.solve_map(map_arrays(lambda a: a[None], rop), rlb._k_mv,
                           rlb._kt_mv, FIXED_KW, backend="vmap",
                           engine="matvec")
    opb = map_arrays(lambda a: a[None], top)
    got = tpdhg.solve_stacked(opb, engine="fused_structured_full",
                              **FIXED_KW)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))


# --------------------------------------------------------------------------
# the numpy halves, bit for bit
# --------------------------------------------------------------------------

def test_round_repair_bit_equal():
    """One seeded relaxation of every POP-4 lane at 256 x 16, through
    both packages' rounding and repair."""
    rwl, twl = _both(256, 16, 0)
    rng = np.random.default_rng(11)
    groups = [np.arange(16)[i::4] for i in range(4)]
    for g in groups:
        s = np.flatnonzero(np.isin(rwl.placement, g))
        r = rng.random((s.size + 3, 4))
        want = rlb.LoadBalanceProblem(rwl)._round_repair(
            r, s, g, L_target=rwl.target, eps_eff=0.05 * rwl.target)
        got = tlb.LoadBalanceProblem(twl)._round_repair(
            r, s, g, L_target=twl.target, eps_eff=0.05 * twl.target)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _churn(wl, prev_placement, n_keep=102, n_new=26):
    """The churn recipe of ``tests/test_plan.py::test_churn20_warm_le_cold_
    load_balancing``, for either package's ``ShardWorkload``."""
    make = type(wl)
    mod = tlb if make is tlb.ShardWorkload else rlb
    rng = np.random.default_rng(4)
    pool = mod.make_shard_workload(256, 16, seed=9)
    keep = np.sort(rng.choice(128, n_keep, replace=False))
    new = rng.choice(256, n_new, replace=False)
    return make(
        load=np.concatenate([wl.load[keep], pool.load[new]])
             * rng.uniform(0.97, 1.03, 128),
        mem=np.concatenate([wl.mem[keep], pool.mem[new]]),
        placement=np.concatenate([prev_placement[keep],
                                  rng.integers(0, 16, n_new)]),
        cap=wl.cap, eps_frac=wl.eps_frac,
        ids=np.concatenate([keep, 1_000 + new]))


def test_remap_lb_state_bit_equal(monkeypatch):
    """The churn case of ``tests/test_plan.py:231``: the reference's
    remap arguments handed to both packages' ``_remap_lb_state``."""
    wl, _ = _both(128, 16, 0)
    wl = dataclasses.replace(wl, ids=np.arange(128))
    short = dict(CHURN_KW, max_iters=200)
    prev = rlb.LoadBalanceProblem(wl).pop_solve(4, solver_kw=short)
    calls = []
    remap = rlb._remap_lb_state
    monkeypatch.setattr(rlb, "_remap_lb_state", lambda *a: calls.append(
        (a, remap(*a))) or calls[-1][1])
    rlb.LoadBalanceProblem(_churn(wl, prev.placement)).pop_solve(
        4, solver_kw=short, warm=prev)
    (args, (want, want_fraction)), = calls
    got, got_fraction = tlb._remap_lb_state(*args)
    assert got_fraction == want_fraction == 102 / 128
    for f in ("x", "y", "mask"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.stats == want.stats


@pytest.mark.parametrize("shape", [(256, 16, 0), (128, 8, 3)], ids=str)
def test_estore_greedy_and_evaluate_bit_equal(shape):
    rwl, twl = _both(*shape)
    want, got = rlb.estore_greedy(rwl), tlb.estore_greedy(twl)
    np.testing.assert_array_equal(got, want)
    assert (tlb.LoadBalanceProblem(twl).evaluate(got)
            == rlb.LoadBalanceProblem(rwl).evaluate(want))


def test_round_relaxation_bit_equal():
    rng = np.random.default_rng(3)
    x = rng.random(40)
    mask = rng.random(40) < 0.6
    hooks = dict(feasible=lambda v: v.sum() <= 20.0,
                 objective=lambda v: float(-(v * np.arange(40)).sum()),
                 repair=lambda v: np.minimum(v, 0.9))
    for seed in (0, 5):
        want = rrounding.round_relaxation(x, mask, seed=seed, **hooks)
        got = trounding.round_relaxation(x, mask, seed=seed, **hooks)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_maxmin_helpers_equal():
    S = np.random.default_rng(2).random((5, 7))
    for a, b in zip(tmaxmin.epigraph_rows(S), rmaxmin.epigraph_rows(S)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmaxmin.maxmin_objective(7),
                                  rmaxmin.maxmin_objective(7))


# --------------------------------------------------------------------------
# the reference's own load-balancing checks, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2, 4])
def test_lb_full_and_pop_feasible(seed):
    _, wl = _both(256, 16, seed)
    prob = tlb.LoadBalanceProblem(wl)
    full = prob.solve_full(solver_kw=SOLVER_KW, device="cpu")
    assert full.feasible
    r = prob.pop_solve(4, solver_kw=SOLVER_KW, device="cpu")
    assert r.max_load_dev < 2.0 * wl.eps_frac
    assert r.movement < 2.0 * full.movement + 1e-9


def test_lb_beats_greedy_on_balance():
    _, wl = _both(256, 16, 0)
    prob = tlb.LoadBalanceProblem(wl)
    full = prob.solve_full(solver_kw=SOLVER_KW, device="cpu")
    ev_g = prob.evaluate(tlb.estore_greedy(wl))
    assert full.max_load_dev < ev_g["max_load_dev"]


def test_lb_placement_valid():
    _, wl = _both(128, 8, 1)
    r = tlb.LoadBalanceProblem(wl).pop_solve(2, solver_kw=SOLVER_KW,
                                             device="cpu")
    assert r.placement.shape == (128,)
    assert ((r.placement >= 0) & (r.placement < 8)).all()


def test_churn20_warm_le_cold_load_balancing():
    _, wl = _both(128, 16, 0)
    wl = dataclasses.replace(wl, ids=np.arange(128))
    prev = tlb.LoadBalanceProblem(wl).pop_solve(4, solver_kw=CHURN_KW,
                                                device="cpu")
    prob2 = tlb.LoadBalanceProblem(_churn(wl, prev.placement))
    cold = prob2.pop_solve(4, solver_kw=CHURN_KW, warm=prev,
                           warm_start=False, device="cpu")
    warm = prob2.pop_solve(4, solver_kw=CHURN_KW, warm=prev, device="cpu")
    assert warm.extra["warm_fraction"] == pytest.approx(102 / 128)
    assert warm.extra["plan_cache"] == "repair"
    assert warm.extra["iterations"] <= cold.extra["iterations"]


def test_lb_warm_resolve():
    _, wl = _both(48, 8, 2)
    prev = tlb.LoadBalanceProblem(wl).pop_solve(4, solver_kw=WARM_KW,
                                                device="cpu")
    rng = np.random.default_rng(5)
    wl2 = dataclasses.replace(
        wl, load=wl.load * rng.uniform(0.98, 1.02, wl.load.shape),
        placement=prev.placement)
    prob2 = tlb.LoadBalanceProblem(wl2)
    cold = prob2.pop_solve(4, solver_kw=WARM_KW, warm=prev, warm_start=False,
                           device="cpu")
    warm = prob2.pop_solve(4, solver_kw=WARM_KW, warm=prev, device="cpu")
    assert warm.extra["plan_cache"] == "hit"
    assert warm.extra["iterations"] <= cold.extra["iterations"]
    assert warm.feasible == cold.feasible


# --------------------------------------------------------------------------
# the load_balance domain through the service
# --------------------------------------------------------------------------

@pytest.mark.parametrize("budget", ["fixed", "defaults"])
def test_load_balance_session_matches_reference(budget):
    """Cold, drift, then 20% churn at 128 shards on 16 servers
    (``testing.balance_session``).  At a fixed budget (tolerances 0):
    equal placements, verdicts and warm fractions, the relaxations within
    1e-5.  At the domain's defaults: equal feasibility."""
    kw = dict(max_iters=400, check_every=40, tol_primal=0.0, tol_gap=0.0)
    ref_exec = RefExecConfig(solver_kw=kw) if budget == "fixed" else None
    port_exec = ExecConfig(solver_kw=kw) if budget == "fixed" else None
    ref = RefPopService().session("lb", domain="load_balance", exec=ref_exec)
    _, want = testing.balance_session(
        ref.step, 128, 16, 0.2, make_workload=rlb.make_shard_workload,
        instance=RefBalanceInstance)
    port = PopService(device="cpu").session("lb", domain="load_balance",
                                            exec=port_exec)
    _, got = testing.balance_session(port.step, 128, 16, 0.2)
    assert [a.plan_cache for a in got] == ["miss", "hit", "repair"]
    for a, b in zip(got, want):
        assert a.plan_cache == b.plan_cache
        assert a.warm_fraction == b.warm_fraction
        assert a.k == b.k == 4 and a.engine == b.engine == "matvec"
        assert (a.metrics["load_feasible"] and a.metrics["mem_feasible"]) \
            == (b.metrics["load_feasible"] and b.metrics["mem_feasible"])
        if budget == "fixed":
            np.testing.assert_array_equal(a.alloc, b.alloc)
            assert a.iterations == b.iterations
            np.testing.assert_allclose(
                a.raw.extra["pop_state"]["x"],
                np.asarray(b.raw.extra["pop_state"]["x"]), **TOL)
    assert got[2].warm_fraction == 103 / 128


def test_domain_registered_with_reference_defaults():
    spec, ref = domains.get("load_balance"), ref_domain("load_balance")
    assert spec.default_solve == SolveConfig(**{
        f: getattr(ref.default_solve, f)
        for f in ("k", "strategy", "seed", "replicate_threshold",
                  "min_per_sub")})
    assert spec.default_exec.solver_dict() == ref.default_exec.solver_dict()
    assert spec.step_override is not None and spec.problem is None
    inst = BalanceInstance(np.ones(8), 4)
    assert domains.spec_for(inst) is spec and inst.n_shards == 8


def test_step_override_that_returns_nan_raises(monkeypatch):
    """The reference's quarantine of a ``step_override`` domain, in both
    packages on the same instances: a first step whose every attempt
    returns a non-finite placement has no warm state to drop and no
    previous allocation or greedy hook to fall back on, so it raises;
    with warm state, a broken warm attempt is retried cold
    (``warm-quarantined``) and the step serves the cold placement."""
    insts = (np.arange(1.0, 17.0), np.arange(1.0, 17.0) * 1.05)

    def broken_for(spec, when):
        def broken(inst, solve_cfg, exec_cfg, warm, **kw):
            out = spec.step_override(inst, solve_cfg, exec_cfg, warm, **kw)
            if when == "always" or warm is not None:
                out = dataclasses.replace(
                    out, alloc=np.full(out.alloc.shape, np.nan))
            return out
        return broken

    got = {}
    for name, svc, inst_type in (
            ("reference", RefPopService(), RefBalanceInstance),
            ("port", PopService(device="cpu"), BalanceInstance)):
        sess = svc.session("lb", domain="load_balance")
        spec = sess.spec
        sess.spec = dataclasses.replace(
            spec, step_override=broken_for(spec, "always"))
        with pytest.raises(RuntimeError, match="no previous allocation"):
            sess.step(inst_type(insts[0], 4))
        assert sess.steps == 0 and sess._warm is None
        sess.spec = dataclasses.replace(
            spec, step_override=broken_for(spec, "warm"))
        first = sess.step(inst_type(insts[0], 4))
        second = sess.step(inst_type(insts[1], 4))
        assert first.status == "ok" and first.faults == ()
        assert second.status == "recovered"
        assert second.faults == ("nonfinite-alloc", "warm-quarantined")
        assert np.isfinite(second.alloc).all()
        got[name] = (second.alloc, second.plan_cache, second.warm_fraction,
                     svc.stats()["recovered_steps"], svc.stats()["faults"])
    ref, port = got["reference"], got["port"]
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1:] == ref[1:] == ("miss", None, 1, 2)
