"""Port parity for the full-problem (k=1) path: quantized ELL storage, the
ragged wide-block plan, the full oracles and the ``fused_structured_full``
engine (``repro_torch.core.pdhg``, ``repro_torch.kernels.ref``).

Both packages are fed the same seeded inputs through numpy:

* ``quantize_structured`` int8 / bf16 payloads and scales are bit-equal to
  the reference's (the int8 scale is ``max(|v|, 1e-30) / 127`` in f32 and
  the payload rounds half to even in both);
* the full problem's ELL arrays and fold maps (cluster and traffic) are
  exactly equal, and ``_wide_block_plans`` gives the reference's
  ``_wide_block_plan`` tuples;
* the full oracles agree with the reference's Pallas kernel bodies run in
  interpret mode (``block_m=128, block_w=8, block_d=128``, as
  ``tests/test_engine_conformance.py`` runs them) for all three coefficient
  types at 1e-5, on the conformance matrix's small traffic case and on a
  ragged operator whose wide buckets span several plan blocks;
* fixed-budget ``fused_structured_full`` solves (tolerances 0, 120
  iterations) agree with the reference's at the conformance standard: x
  and y within 1e-5, equal iteration counts;
* ``select_engine`` takes the full engine exactly where the reference's
  rule does.

The hand-written CUDA kernels are held against the same oracles on the
card in ``tests/test_torch_cuda.py``."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as rback, pdhg as rpdhg, pop as rpop
from repro.core.config import ExecConfig as RExecConfig
from repro.kernels import ops as rkops
from repro.problems import traffic_engineering as rte
from repro.problems.cluster_scheduling import (GavelProblem as RefGavel,
                                               make_cluster_workload)
from repro_torch import interop, testing
from repro_torch.core import backends as tback, pdhg as tpdhg, pop as tpop
from repro_torch.core.config import ExecConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels import structured_full_pdhg_step as kfull
from repro_torch.problems.cluster_scheduling import GavelProblem
from repro_torch.problems.traffic_engineering import TrafficProblem

FIXED_KW = dict(max_iters=120, check_every=40, tol_primal=0.0, tol_gap=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)
COEF_DTYPES = ("float32", "bfloat16", "int8")
# the conformance matrix's small traffic case
SMALL_TE = dict(n_nodes=24, target_edges=48, n_paths=3, max_len=12,
                topo_seed=1, demand_seed=1, path_seed=1)


def _problems(domain, coef_dtype="float32"):
    """(reference problem, port problem) of the same full instance."""
    if domain == "traffic":
        arrays = testing.traffic_arrays(14, make=rte, **SMALL_TE)
        return (rte.TrafficProblem(*arrays, coef_dtype=coef_dtype),
                TrafficProblem(*testing.traffic_arrays(14, **SMALL_TE),
                               coef_dtype=coef_dtype))
    wl = make_cluster_workload(16, num_workers=(6, 6, 6), seed=3)
    return (RefGavel(wl, space_sharing=False, coef_dtype=coef_dtype),
            GavelProblem(wl, coef_dtype=coef_dtype))


def _np(a):
    """Leaf as numpy with bf16 as its raw 16 bits (bit-equality)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_struct_equal(ref_s, port_s):
    for f in rpdhg.StructuredOperator._fields:
        a, b = getattr(ref_s, f), getattr(port_s, f)
        if a is None:
            assert b is None, f
            continue
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)


def _ref_fields(s):
    return {f: (None if v is None else np.asarray(v))
            for f, v in s._asdict().items()}


@pytest.mark.parametrize("coef_dtype", COEF_DTYPES)
@pytest.mark.parametrize("domain", ["cluster", "traffic"])
def test_full_ell_and_quantized_payload_bit_equal(domain, coef_dtype):
    """``build_full`` through ``structured_from_coo(coef_dtype=)``: every
    ELL array, fold map, payload and scale equal, bit for bit."""
    rprob, tprob = _problems(domain, coef_dtype)
    rop, top = rprob.build_full(), tprob.build_full()
    assert top.structured.coef_dtype == coef_dtype
    _assert_struct_equal(rop.structured, top.structured)
    for f in ("c", "q", "l", "u", "ineq_mask"):
        np.testing.assert_array_equal(getattr(top, f).numpy(),
                                      np.asarray(getattr(rop, f)))


@pytest.mark.parametrize("coef_dtype", ["bfloat16", "int8"])
def test_quantize_structured_bit_equal_on_ragged_values(coef_dtype):
    """Normal-distributed coefficients (ties and tiny values included),
    quantized by both packages; the interop brings the reference's
    quantized leaves across unchanged; dequantizing agrees exactly."""
    rows, cols, vals, m, n = testing.ragged_coo()
    vals = vals * np.where(np.arange(vals.size) % 7 == 0, 1e-6, 3.0)
    rs = rpdhg.structured_from_coo(rows, cols, vals, m, n)
    ts = tpdhg.structured_from_coo(rows, cols, vals, m, n)
    rq = rpdhg.quantize_structured(rs, coef_dtype)
    tq = tpdhg.quantize_structured(ts, coef_dtype)
    _assert_struct_equal(rq, tq)
    _assert_struct_equal(rq, interop.operator_from_numpy(_ref_fields(rq),
                                                         device="cpu"))
    _assert_struct_equal(rpdhg.dequantize_structured(rq),
                         tpdhg.dequantize_structured(tq))
    with pytest.raises(ValueError, match="already stores"):
        tpdhg.quantize_structured(tq, "int8")
    # mixed storage cannot stack: the stack degrades to f32, as the
    # reference's does
    lanes = [tpdhg.OperatorLP(c=torch.zeros(n), q=torch.zeros(m),
                              l=torch.zeros(n), u=torch.zeros(n),
                              ineq_mask=torch.ones(m, dtype=torch.bool),
                              data=(), structured=st) for st in (ts, tq)]
    assert tpdhg.stack_ops(lanes).structured.coef_dtype == "float32"


def _plan_cases():
    yield "ragged", lambda: testing.ragged_coo()
    yield "ragged_deep", lambda: testing.ragged_coo(n_wide=500,
                                                    max_width=900, seed=4)


@pytest.mark.parametrize("coef_dtype", COEF_DTYPES)
@pytest.mark.parametrize("case", ["ragged", "ragged_deep", "cluster",
                                  "traffic"])
def test_wide_block_plan_matches_reference(case, coef_dtype):
    if case in ("cluster", "traffic"):
        rprob, tprob = _problems(case, coef_dtype)
        rs, ts = rprob.build_full().structured, tprob.build_full().structured
    else:
        coo = dict(_plan_cases())[case]()
        rs = rpdhg.quantize_structured(rpdhg.structured_from_coo(*coo),
                                       coef_dtype)
        ts = tpdhg.structured_from_coo(*coo, coef_dtype=coef_dtype)
    want = (rpdhg._wide_block_plan(rs.wrow_val),
            rpdhg._wide_block_plan(rs.wcol_val))
    assert tpdhg._wide_block_plans(ts) == want
    if case.startswith("ragged"):
        assert len(want[0]) >= 3 and len(want[1]) >= 3


def test_plan_block_limit_matches_kernel_source():
    """The wrapper's block size, rows per thread and most plan blocks are
    the CUDA source's, and the largest plan fits the 48 KB of shared memory
    a launch may ask for beside the wide pass's row-group sums, with no room
    for one block more."""
    src = (Path(kfull.__file__).parent / "csrc"
           / "structured_full_pdhg_step.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))
             for name in ("kThreads", "kWideIters", "kMaxPlanBlocks")}
    assert (kfull.THREADS, kfull.WIDE_ITERS, kfull.MAX_PLAN_BLOCKS) == (
        const["kThreads"], const["kWideIters"], const["kMaxPlanBlocks"])
    used = lambda blocks: 12 * blocks + 4 * kfull.THREADS
    assert used(kfull.MAX_PLAN_BLOCKS) <= 48 * 1024 < used(
        kfull.MAX_PLAN_BLOCKS + 1)


def test_plan_layout_refuses_plans_beyond_the_limit():
    limit = kfull.MAX_PLAN_BLOCKS
    plan = tuple((c, c + 1, 8) for c in range(limit))
    tc, n_tiles, n_chunks = kfull.plan_layout(plan, limit, 8)
    assert (tc, n_tiles, n_chunks) == (1, limit, 1)
    with pytest.raises(ValueError, match="at most"):
        kfull.plan_layout(plan + ((limit, limit + 1, 8),), limit + 1, 8)


def _oracle_operands(M, N, seed=7):
    rng = np.random.default_rng(seed)
    f = lambda shape: rng.standard_normal(shape).astype(np.float32)
    return dict(x=f((1, N)), c=f((1, N)), kty=f((1, N)),
                l=np.zeros((1, N), np.float32),
                u=np.full((1, N), 10.0, np.float32),
                tau=np.full((1,), 0.3, np.float32),
                y=f((1, M)), q=f((1, M)), kxn=f((1, M)), kxp=f((1, M)),
                mask=rng.random((1, M)) < 0.6,
                sigma=np.full((1,), 0.2, np.float32))


@pytest.mark.parametrize("coef_dtype", COEF_DTYPES)
@pytest.mark.parametrize("case", ["traffic_small", "ragged"])
def test_full_oracles_match_reference_kernels(case, coef_dtype):
    """The port's full oracles (what the CPU path runs and what the CUDA
    kernels are held against) against the reference's Pallas kernel
    bodies in interpret mode, and against the reference's own oracles."""
    if case == "ragged":
        rs = rpdhg.quantize_structured(
            rpdhg.structured_from_coo(*testing.ragged_coo()), coef_dtype)
    else:
        rs = _problems("traffic", coef_dtype)[0].build_full().structured
    ts = interop.operator_from_numpy(_ref_fields(rs), device="cpu")
    sb = jax.tree.map(lambda a: jnp.asarray(a)[None], rs)
    tb = tpdhg.map_arrays(lambda a: a[None], ts)
    rplan, cplan = tpdhg._wide_block_plans(ts)
    M, N = rs.row_idx.shape[-1], rs.col_idx.shape[-1]
    o = _oracle_operands(M, N)
    j = {k: jnp.asarray(v) for k, v in o.items()}
    t = {k: torch.as_tensor(v) for k, v in o.items()}
    kw = dict(block_m=128, block_w=8, block_d=128)
    fwd = (j["x"], j["c"], j["l"], j["u"], j["tau"], j["kty"])
    bwd = (j["y"], j["q"], j["sigma"], j["mask"].astype(jnp.float32),
           j["kxn"], j["kxp"])
    want = (
        rkops.structured_full_forward_step(sb, *fwd, plan=rplan,
                                           backend="interpret", **kw),
        rkops.structured_full_backward_step(sb, *bwd, plan=cplan,
                                            backend="interpret", **kw))
    want_xla = (
        rkops.structured_full_forward_step(sb, *fwd, plan=rplan,
                                           backend="xla"),
        rkops.structured_full_backward_step(
            sb, j["y"], j["q"], j["sigma"], j["mask"], j["kxn"], j["kxp"],
            plan=cplan, backend="xla"))
    got = (
        ops.structured_full_forward_step(tb, t["x"], t["c"], t["l"], t["u"],
                                         t["tau"], t["kty"], plan=rplan),
        ops.structured_full_backward_step(tb, t["y"], t["q"], t["sigma"],
                                          t["mask"], t["kxn"], t["kxp"],
                                          plan=cplan))
    for w, wx, g in zip(want, want_xla, got):
        for a, ax, b in zip(w, wx, g):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
            np.testing.assert_allclose(b.numpy(), np.asarray(ax), **TOL)
    # the out-of-loop products are the same oracles' products
    np.testing.assert_allclose(
        ops.smatvec_full(tb, got[0][0], plan=rplan).numpy(),
        got[0][1].numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(
        ref.smatvec_t_full(tb, got[1][0], cplan).numpy(),
        got[1][1].numpy(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def ref_full_solves():
    """The reference's fixed-budget full-engine solves, by domain."""
    out = {}
    for domain in ("cluster", "traffic"):
        rprob, _ = _problems(domain)
        res, _, eng = rback.solve_one_ex(
            rprob.build_full(), rprob.K_mv, rprob.KT_mv, FIXED_KW,
            backend="vmap", engine="fused_structured_full")
        assert eng == "fused_structured_full"
        out[domain] = res
    return out


@pytest.mark.parametrize("domain", ["cluster", "traffic"])
def test_full_engine_fixed_budget_matches_reference(domain, ref_full_solves):
    want = ref_full_solves[domain]
    _, tprob = _problems(domain)
    got, backend, eng = tback.solve_one_ex(
        tprob.build_full(), tprob.K_mv, tprob.KT_mv, FIXED_KW,
        backend="vmap", engine="fused_structured_full")
    assert (backend, eng) == ("vmap", "fused_structured_full")
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    assert int(got.iterations) == int(want.iterations)
    assert not got.diverged


def test_int8_full_trajectory_equals_f32():
    """Traffic coefficients are all 1.0, so int8 storage is exact: the
    fixed-budget full-engine trajectory equals f32 storage's bit for bit
    (as the reference holds its own, tests/test_engine_conformance.py)."""
    runs = []
    for dt in ("float32", "int8"):
        _, tprob = _problems("traffic", dt)
        res, _, eng = tback.solve_one_ex(
            tprob.build_full(), tprob.K_mv, tprob.KT_mv, FIXED_KW,
            engine="fused_structured_full")
        assert eng == "fused_structured_full"
        runs.append(res)
    np.testing.assert_array_equal(runs[1].x, runs[0].x)
    np.testing.assert_array_equal(runs[1].y, runs[0].y)


def test_select_engine_threshold_matches_reference(monkeypatch):
    """auto takes the full engine exactly when the operator is single-lane,
    carries fold maps and stores at least FULL_ENGINE_MIN_WIDE_ELEMS
    wide-bucket elements — the reference's rule, on the same operators."""
    rprob, tprob = _problems("traffic")
    rop = jax.tree.map(lambda a: jnp.asarray(a)[None], rprob.build_full())
    top = tpdhg.map_arrays(lambda a: a[None], tprob.build_full())
    top3 = tpdhg.map_arrays(lambda a: torch.cat([a] * 3), top)
    bare = top._replace(structured=top.structured._replace(row_fold=None,
                                                           col_fold=None))
    assert tpdhg.FULL_ENGINE_MIN_WIDE_ELEMS == \
        rpdhg.FULL_ENGINE_MIN_WIDE_ELEMS
    assert tpdhg.WIDE_BLOCK_COLS == rpdhg.WIDE_BLOCK_COLS

    def rules():
        return (tpdhg.select_engine(top, tprob.K_mv, tprob.KT_mv),
                tpdhg.select_engine(top3, tprob.K_mv, tprob.KT_mv),
                tpdhg.select_engine(bare, tprob.K_mv, tprob.KT_mv))

    assert rules() == ("fused_structured",) * 3
    assert rpdhg.select_engine(rop, rprob.K_mv,
                               rprob.KT_mv) == "fused_structured"
    for mod in (tpdhg, rpdhg):
        monkeypatch.setattr(mod, "FULL_ENGINE_MIN_WIDE_ELEMS", 1)
    assert rules() == ("fused_structured_full", "fused_structured",
                       "fused_structured")
    assert rpdhg.select_engine(rop, rprob.K_mv,
                               rprob.KT_mv) == "fused_structured_full"
    with pytest.raises(ValueError, match="fold"):
        tpdhg.resolve_engine("fused_structured_full", bare)
    with pytest.raises(ValueError, match="single-lane"):
        tpdhg.resolve_engine("fused_structured_full", top3)


def test_solve_full_ex_total_flow_matches_reference():
    """The unpartitioned baseline at the traffic domain's tolerances, on
    the full engine in both packages: total flow within 1e-3 relative;
    ``solve_full`` is the tuple form of the same call."""
    rprob, tprob = _problems("traffic")
    kw = dict(max_iters=8_000, tol_primal=1e-4, tol_gap=1e-4)
    want = rpop.solve_full_ex(rprob, exec_cfg=RExecConfig(
        engine="fused_structured_full", solver_kw=kw))
    cfg = ExecConfig(engine="fused_structured_full", solver_kw=kw)
    got = tpop.solve_full_ex(tprob, exec_cfg=cfg, device="cpu")
    assert got.engine == want.engine == "fused_structured_full"
    assert bool(got.res.converged) and bool(want.res.converged)
    flow = tprob.evaluate(got.alloc)["total_flow"]
    ref_flow = rprob.evaluate(np.asarray(want.alloc))["total_flow"]
    assert abs(flow - ref_flow) <= 1e-3 * abs(ref_flow)
    alloc, res, _, _ = tpop.solve_full(tprob, kw,
                                       engine="fused_structured_full",
                                       device="cpu")
    np.testing.assert_array_equal(alloc, got.alloc)
    assert int(res.iterations) == int(got.res.iterations)
