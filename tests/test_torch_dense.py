"""Port parity for the dense path (``repro_torch.core.problem``, the dense
kernels' plain versions, the ``fused`` engine, Ruiz equilibration,
``solve_dense`` and ``solve_batched``).

Both packages get the same inputs, drawn by numpy from a seed, and are
compared through numpy:

* ``LinearProgram.build`` / ``stack_lps`` / ``stacked()``: the padded
  arrays exactly equal; ``violations`` exactly equal on integer data,
  where every product and sum is exact in f32;
* the four plain versions (``kernels/ref.py``, what the CPU path runs)
  against the reference's Pallas kernels in interpret mode on the shapes
  of ``tests/test_kernels.py``: 1e-5 in f32, the reference's 2e-2 for bf16
  coefficients (rows 7-8);
* ``dense_ops`` exactly, ``ruiz_equilibrate``'s scalings within 1e-6;
* the conformance matrix's densified cluster and traffic cells
  (``tests/test_engine_conformance.py``) through ``solve_map(engine=
  "fused")`` against the reference's ``fused`` cells at its fixed budget:
  x and y within 1e-5, equal iterations;
* ``solve_dense`` and ``solve_batched`` against the reference at a fixed
  budget, and ``solve_batched``'s lanes against independent solves.

The hand-written CUDA kernels are held against the same plain versions on
the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as rback, pdhg as rpdhg, pop as rpop
from repro.core.problem import LinearProgram as RefLP, stack_lps as ref_stack
from repro.kernels import ops as rops
from repro.problems.cluster_scheduling import (GavelProblem as RefGavel,
                                               make_cluster_workload)
from repro.problems.traffic_engineering import (TrafficProblem as RefTraffic,
                                                k_shortest_paths,
                                                make_demands, make_topology)
from repro_torch import interop, testing
from repro_torch.core import backends as tback, pdhg as tpdhg
from repro_torch.core.problem import (LinearProgram, MixedIntegerProgram,
                                      stack_lps)
from repro_torch.kernels import ref

SHAPES = [(1, 128, 128), (2, 256, 256), (3, 300, 180), (4, 64, 512),
          (2, 512, 64), (8, 129, 257)]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FIXED_KW = dict(max_iters=120, check_every=40, tol_primal=0.0, tol_gap=0.0)
LP_FIELDS = ("c", "G", "h", "A", "b", "l", "u")


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _lp_parts(seed, n=40, mi=20, me=5, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        G = rng.integers(-3, 4, size=(mi, n)).astype(np.float64)
        A = rng.integers(-3, 4, size=(me, n)).astype(np.float64)
        return dict(c=rng.integers(-5, 6, n).astype(np.float64), G=G,
                    h=rng.integers(0, 10, mi).astype(np.float64), A=A,
                    b=rng.integers(-4, 5, me).astype(np.float64),
                    l=np.zeros(n), u=np.full(n, 2.0))
    c, G, h = testing.random_dense_lps(1, n, mi, seed)[0]
    A = rng.normal(size=(me, n))
    return dict(c=c, G=G, h=h, A=A, b=A @ rng.uniform(0.2, 0.8, n),
                l=np.zeros(n), u=np.ones(n))


def _ref_fields(lp):
    out = {f: np.asarray(getattr(lp, f)) for f in LP_FIELDS}
    out.update(n_var=lp.n_var, n_ineq=lp.n_ineq, n_eq=lp.n_eq)
    return out


def _assert_lp_equal(got, want):
    for f in LP_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
        assert getattr(got, f).dtype == torch.float32
    assert (got.n_var, got.n_ineq, got.n_eq) == (want.n_var, want.n_ineq,
                                                 want.n_eq)
    assert got.shape == want.shape


# --------------------------------------------------------------------------
# LinearProgram / stack_lps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ineq_eq", "ineq_only", "eq_only_free"])
def test_linear_program_padding_matches_reference(case):
    parts = _lp_parts(3, n=150, mi=90, me=7)
    if case == "ineq_only":
        parts = {f: parts[f] for f in ("c", "G", "h", "l", "u")}
    elif case == "eq_only_free":
        parts = {f: parts[f] for f in ("c", "A", "b")}
    want = RefLP.build(**parts)
    got = LinearProgram.build(**parts, device="cpu")
    _assert_lp_equal(got, want)
    for g, w in zip(got.stacked(), want.stacked()):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    x = np.random.default_rng(0).uniform(0, 1, got.c.shape[0])
    np.testing.assert_allclose(
        float(got.objective(torch.as_tensor(x, dtype=torch.float32))),
        float(want.objective(jnp.asarray(x, jnp.float32))), rtol=1e-6)


def test_stack_lps_and_violations_match_reference():
    parts = [_lp_parts(s, integer=True) for s in range(3)]
    want = ref_stack([RefLP.build(**p) for p in parts])
    got = stack_lps([LinearProgram.build(**p, device="cpu") for p in parts])
    _assert_lp_equal(got, want)
    with pytest.raises(AssertionError, match="same-shaped"):
        stack_lps([LinearProgram.build(**parts[0], device="cpu"),
                   LinearProgram.build(c=np.ones(300), device="cpu")])
    # integer data and iterates: every product and sum is exact in f32
    x = np.random.default_rng(1).integers(-1, 4, 128).astype(np.float32)
    lp_r, lp_t = RefLP.build(**parts[0]), LinearProgram.build(**parts[0],
                                                             device="cpu")
    want_v = lp_r.violations(jnp.asarray(x))
    got_v = lp_t.violations(torch.as_tensor(x))
    assert set(got_v) == set(want_v) == {"ineq_max", "eq_max", "box_max"}
    for key in want_v:
        assert float(got_v[key]) == float(want_v[key]), key
    assert float(got_v["box_max"]) > 0 and float(got_v["ineq_max"]) > 0
    mip = MixedIntegerProgram.build(np.array([True, False, True]),
                                    **parts[0], device="cpu")
    assert mip.binary_mask.shape == (128,)
    assert mip.binary_mask[:3].tolist() == [True, False, True]
    assert not bool(mip.binary_mask[3:].any())


def test_linear_program_from_numpy_matches_build():
    parts = _lp_parts(5)
    want = LinearProgram.build(**parts, device="cpu")
    got = interop.linear_program_from_numpy(_ref_fields(RefLP.build(**parts)),
                                            device="cpu")
    _assert_lp_equal(got, want)


# --------------------------------------------------------------------------
# the four plain versions against the reference's interpret-mode kernels
# --------------------------------------------------------------------------

def _mk(shape, seed):
    rng = np.random.default_rng(seed)
    k, M, N = shape
    A = rng.normal(size=(k, M, N)).astype(np.float32)
    return A, rng.normal(size=(k, N)).astype(np.float32), \
        rng.normal(size=(k, M)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matvecs_match_reference_kernels(shape, dtype):
    A, x, y = _mk(shape, 0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    Aj, xj, yj = (jnp.asarray(a, jdt) for a in (A, x, y))
    # the same (bf16-rounded) values on both sides
    At, xt, yt = (torch.tensor(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)) for a in (Aj, xj, yj))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(
        _np(ref.bmatvec(At, xt)),
        np.asarray(rops.bmatvec(Aj, xj, backend="interpret")), **tol)
    np.testing.assert_allclose(
        _np(ref.bmatvec_t(At, yt)),
        np.asarray(rops.bmatvec_t(Aj, yj, backend="interpret")), **tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_steps_match_reference_kernels(shape):
    k, M, N = shape
    A, _, _ = _mk(shape, 1)
    o = testing.step_operands(k, M, N, seed=2)
    j = {key: jnp.asarray(v) for key, v in o.items()}
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    want_f = rops.fused_forward_step(Aj, j["x"], j["c"], j["l"], j["u"],
                                     j["tau"], j["kty"], backend="interpret")
    got_f = ref.fused_forward_step(At, t["x"], t["c"], t["l"], t["u"],
                                   t["tau"][:, None], t["kty"])
    want_b = rops.fused_backward_step(Aj, j["y"], j["q"], j["sigma"],
                                      j["mask"], j["kxn"], j["kxp"],
                                      backend="interpret")
    got_b = ref.fused_backward_step(At, t["y"], t["q"], t["sigma"][:, None],
                                    t["mask"], t["kxn"], t["kxp"])
    for got, want in ((got_f, want_f), (got_b, want_b)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


# --------------------------------------------------------------------------
# dense_ops, Ruiz equilibration
# --------------------------------------------------------------------------

def test_dense_ops_and_ruiz_match_reference():
    parts = _lp_parts(11, n=150, mi=90, me=7)
    lp_r, lp_t = RefLP.build(**parts), LinearProgram.build(**parts,
                                                           device="cpu")
    op_r, op_t = rpdhg.dense_ops(lp_r), tpdhg.dense_ops(lp_t)
    for f in ("c", "q", "l", "u", "ineq_mask"):
        np.testing.assert_array_equal(_np(getattr(op_t, f)),
                                      np.asarray(getattr(op_r, f)))
    np.testing.assert_array_equal(_np(op_t.data[0]), np.asarray(op_r.data[0]))
    sop_r, dr_r, dc_r = rpdhg.ruiz_equilibrate(op_r)
    sop_t, dr_t, dc_t = tpdhg.ruiz_equilibrate(op_t)
    np.testing.assert_allclose(_np(dr_t), np.asarray(dr_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(dc_t), np.asarray(dc_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(sop_t.data[0]), np.asarray(sop_r.data[0]),
                               rtol=1e-6, atol=1e-6)
    for f in ("c", "q", "l", "u"):
        np.testing.assert_allclose(_np(getattr(sop_t, f)),
                                   np.asarray(getattr(sop_r, f)), rtol=1e-6)


# --------------------------------------------------------------------------
# the densified conformance cells through the fused engine
# --------------------------------------------------------------------------

def _cluster_case():
    wl = make_cluster_workload(16, num_workers=(6, 6, 6), seed=3)
    prob = RefGavel(wl, space_sharing=False)
    return rpop.build(prob, rpop.plan(prob, 3, strategy="stratified"))


def _traffic_case():
    topo = make_topology(24, 48, seed=1)
    pairs, dem = make_demands(topo, 14, seed=1)
    pe = k_shortest_paths(topo, pairs, n_paths=3, max_len=12, seed=1)
    prob = RefTraffic(topo, pairs, dem, pe)
    return rpop.build(prob, rpop.plan(prob, 3, strategy="stratified"))


@pytest.fixture(scope="module")
def dense_cells():
    """domain -> (reference dense ops, port dense ops, reference result of
    the fused engine at the fixed budget)."""
    out = {}
    for name, build in (("cluster", _cluster_case),
                        ("traffic", _traffic_case)):
        ops = build()
        dense = ops._replace(
            data=(rpdhg.structured_to_dense(ops.structured),),
            structured=None)
        fields = {f: np.asarray(getattr(dense, f))
                  for f in ("c", "q", "l", "u", "ineq_mask")}
        fields["data"] = (np.asarray(dense.data[0]),)
        port = interop.operator_from_numpy(fields, device="cpu")
        want = rback.solve_map(dense, rpdhg.dense_K_mv, rpdhg.dense_KT_mv,
                               FIXED_KW, backend="vmap", engine="fused")
        out[name] = (dense, port, want)
    return out


@pytest.mark.parametrize("backend", ["serial", "vmap", "chunked_vmap"])
@pytest.mark.parametrize("domain", ["cluster", "traffic"])
def test_densified_conformance_cells_match_reference(dense_cells, domain,
                                                     backend):
    _, ops, want = dense_cells[domain]
    opts = {"chunk": 2} if backend == "chunked_vmap" else {}
    got = tback.solve_map(ops, tpdhg.dense_K_mv, tpdhg.dense_KT_mv, FIXED_KW,
                          backend=backend, engine="fused", **opts)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))
    # the densified K is the structured operator's, entry for entry
    name, eng, _ = tback.resolve_exec(ops, tpdhg.dense_K_mv,
                                      tpdhg.dense_KT_mv, backend, "fused")
    assert eng is tpdhg.fused_dense_engine() and eng.name == "fused"


def test_fused_engine_equilibrated_matches_reference(dense_cells,
                                                     monkeypatch):
    """Equilibration through the dense engine's ``scale_data``, the port
    handed the reference's Rademacher probes."""
    from test_torch_pdhg import reference_probes
    monkeypatch.setattr(tpdhg, "rademacher_probes", reference_probes)
    dense, ops, _ = dense_cells["cluster"]
    kw = dict(FIXED_KW, equilibrate=True)
    want = rpdhg.solve_stacked(dense, engine="fused", **kw)
    got = tpdhg.solve_stacked(ops, engine="fused", **kw)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.n_restarts,
                                  np.asarray(want.n_restarts))


# --------------------------------------------------------------------------
# solve_dense, solve_batched
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_eq", [False, True], ids=["ineq", "ineq_eq"])
def test_solve_dense_matches_reference(with_eq):
    parts = _lp_parts(21, n=60, mi=30, me=5 if with_eq else 0)
    if not with_eq:
        parts = {f: parts[f] for f in ("c", "G", "h", "l", "u")}
    want = rpdhg.solve_dense(RefLP.build(**parts), max_iters=200,
                             tol_primal=0.0, tol_gap=0.0)
    got = tpdhg.solve_dense(LinearProgram.build(**parts, device="cpu"),
                            max_iters=200, tol_primal=0.0, tol_gap=0.0)
    for f in ("x", "y", "primal_obj", "dual_obj", "primal_res", "gap"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    assert int(got.iterations) == int(want.iterations) == 200
    assert np.shape(got.primal_obj) == ()


def _lp_stack(k=3):
    parts = testing.random_dense_lps(k, 60, 30, seed=4)
    return (rpdhg.stack_ops([rpdhg.dense_ops(RefLP.build(
                c=c, G=G, h=h, l=np.zeros(60), u=np.ones(60)))
                for c, G, h in parts]),
            testing.dense_stack(parts, "cpu"))


def test_solve_batched_matches_reference_and_independent_solves():
    ref_ops, ops = _lp_stack()
    want = rpdhg.solve_batched(ref_ops, **FIXED_KW)
    got = tpdhg.solve_batched(ops, **FIXED_KW)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))
    # converging: each lane stops on its own, as k independent solves do
    kw = dict(max_iters=2_000, tol_primal=1e-3, tol_gap=1e-3)
    batched = tpdhg.solve_batched(ops, **kw)
    for i in range(ops.c.shape[0]):
        one = tpdhg.solve(tpdhg.map_arrays(lambda a, i=i: a[i], ops), **kw)
        assert int(one.iterations) == int(batched.iterations[i])
        assert bool(one.converged) == bool(batched.converged[i])
        np.testing.assert_allclose(one.x, batched.x[i], **TOL)
        np.testing.assert_allclose(one.y, batched.y[i], **TOL)
    assert len(set(batched.iterations.tolist())) > 1
