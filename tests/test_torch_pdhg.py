"""Port parity for the restarted-PDHG solver (``repro_torch.core.pdhg``).

The port is held against ``repro.core.pdhg.solve_stacked`` on the
conformance matrix's cluster case (16 Gavel jobs over k=3 ragged lanes,
``tests/test_engine_conformance.py``), both packages fed the identical
stacked payload through numpy (``repro_torch.interop``):

* a fixed budget (tolerances 0, so every lane runs ``max_iters``): x and y
  within 1e-5 of the reference and equal iteration counts, for the
  ``matvec`` and ``fused_structured`` engines, with and without
  equilibration.  The reference's own spread between those two engines at
  this setting is below 1e-7, so 1e-5 is the conformance matrix's bound
  unchanged.  Equilibration draws Rademacher probes, which the port takes
  from a ``torch.Generator``; here the port is handed the reference's
  probes (``jax.random`` bits, passed as numpy) instead;
* warm starts: warm trajectories are chaotic in the reference itself (its
  engines disagree after 120 warm iterations), so a masked warm start is
  held on converged quality: objective within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pdhg as rpdhg, pop as rpop
from repro.problems.cluster_scheduling import (GavelProblem as RefGavel,
                                               make_cluster_workload)
from repro_torch import interop, testing
from repro_torch.core import backends as tback, pdhg as tpdhg
from repro_torch.core.pdhg import map_arrays
from repro_torch.problems.cluster_scheduling import GavelProblem

FIXED_KW = dict(max_iters=120, check_every=40, tol_primal=0.0, tol_gap=0.0)
CONVERGED_KW = dict(max_iters=5_000, tol_primal=1e-4, tol_gap=1e-4,
                    equilibrate=True)
TOL = dict(rtol=1e-5, atol=1e-5)


def reference_probes(iters, n_probes, n_var, n_con, seed=7):
    """The probes ``repro.core.pdhg._equilibrate`` draws, as CPU tensors
    (another ``seed`` draws the reference's probes from another key)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for i in range(iters):
        kr, kc = jax.random.split(jax.random.fold_in(key, i))
        draw = lambda kk, n: torch.tensor(np.asarray(
            jax.random.rademacher(kk, (n_probes, n), jnp.float32)))
        out.append((draw(kr, n_var), draw(kc, n_con)))
    return out


@pytest.fixture
def ref_probes(monkeypatch):
    monkeypatch.setattr(tpdhg, "rademacher_probes", reference_probes)


@pytest.fixture(scope="module")
def cluster():
    """(reference stacked ops, port stacked ops, reference problem)."""
    wl = make_cluster_workload(16, num_workers=(6, 6, 6), seed=3)
    rprob = RefGavel(wl, space_sharing=False)
    rops = rpop.build(rprob, rpop.plan(rprob, 3, strategy="stratified"))
    fields = {f: np.asarray(getattr(rops, f))
              for f in ("c", "q", "l", "u", "ineq_mask")}
    fields["data"] = tuple(np.asarray(a) for a in rops.data)
    fields["structured"] = {f: (None if v is None else np.asarray(v))
                            for f, v in rops.structured._asdict().items()}
    return rops, interop.operator_from_numpy(fields, device="cpu"), rprob


def _ref_solve(cluster, engine, **kw):
    rops, _, rprob = cluster
    return rpdhg.solve_stacked(rops, engine=engine, K_mv=rprob.K_mv,
                               KT_mv=rprob.KT_mv, **kw)


def _port_solve(cluster, engine, **kw):
    _, ops, _ = cluster
    return tpdhg.solve_stacked(ops, engine=engine, K_mv=GavelProblem.K_mv,
                               KT_mv=GavelProblem.KT_mv, **kw)


@pytest.fixture(scope="module")
def ref_fixed(cluster):
    """The reference's fixed-budget solves, cold and equilibrated."""
    return {eq: _ref_solve(cluster, "fused_structured", equilibrate=eq,
                           **FIXED_KW)
            for eq in (False, True)}


@pytest.mark.parametrize("equilibrate", [False, True],
                         ids=["plain", "equilibrated"])
@pytest.mark.parametrize("engine", ["matvec", "fused_structured"])
def test_fixed_budget_cold_matches_reference(cluster, ref_fixed, ref_probes,
                                             engine, equilibrate):
    want = ref_fixed[equilibrate]
    got = _port_solve(cluster, engine, equilibrate=equilibrate, **FIXED_KW)
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))
    np.testing.assert_array_equal(got.n_restarts,
                                  np.asarray(want.n_restarts))
    assert not got.diverged.any()


@pytest.mark.parametrize("backend", ["serial", "vmap", "chunked_vmap"])
def test_map_backends_match_reference(cluster, ref_fixed, backend):
    """Every ported backend schedules the same math (chunked_vmap at chunk=2
    pads k=3 to 4 lanes)."""
    _, ops, _ = cluster
    opts = {"chunk": 2} if backend == "chunked_vmap" else {}
    got = tback.solve_map(ops, GavelProblem.K_mv, GavelProblem.KT_mv,
                          FIXED_KW, backend=backend, engine="auto", **opts)
    want = ref_fixed[False]
    np.testing.assert_allclose(got.x, np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.y, np.asarray(want.y), **TOL)
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))


def test_standalone_kkt_matches_inloop_bitwise(cluster):
    """The carried products never drift: fresh operator passes at every
    check give the same trajectory, bit for bit (as in the reference)."""
    a = _port_solve(cluster, "fused_structured", kkt="inloop", **FIXED_KW)
    b = _port_solve(cluster, "fused_structured", kkt="standalone", **FIXED_KW)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


def test_masked_warm_start_converges_like_reference(cluster, ref_fixed,
                                                   ref_probes):
    """Warm from the reference's own fixed-budget iterates with lane 1
    forced cold: both packages converge to the same quality."""
    _, ops, _ = cluster
    seed = ref_fixed[False]
    mask = np.array([True, False, True])
    want = _ref_solve(cluster, "fused_structured", warm_x=seed.x,
                      warm_y=seed.y, warm_mask=jnp.asarray(mask),
                      **CONVERGED_KW)
    ws = interop.warm_from_numpy(np.asarray(seed.x), np.asarray(seed.y),
                                 mask=mask, device="cpu")
    got = tback.solve_map(ops, GavelProblem.K_mv, GavelProblem.KT_mv,
                          CONVERGED_KW, backend="vmap",
                          engine="fused_structured", warm=ws)
    assert got.converged.all() and np.asarray(want.converged).all()
    np.testing.assert_allclose(got.primal_obj, np.asarray(want.primal_obj),
                               rtol=1e-3, atol=1e-3)


def test_poisoned_lane_is_quarantined(cluster):
    """A NaN warm start trips the divergence guard on its lane only."""
    _, ops, _ = cluster
    wx = torch.zeros_like(ops.c)
    wx[1, 0] = float("nan")
    res = tpdhg.solve_stacked(ops, engine="fused_structured",
                              warm_x=wx, warm_y=torch.zeros_like(ops.q),
                              max_iters=400)
    assert res.diverged.tolist() == [False, True, False]
    assert not res.converged[1]


def test_engine_rule_and_unported_engines(cluster):
    _, ops, _ = cluster
    km, ktm = GavelProblem.K_mv, GavelProblem.KT_mv
    assert tpdhg.select_engine(ops, km, ktm) == "fused_structured"
    bare = ops._replace(structured=None)
    assert tpdhg.select_engine(bare, km, ktm) == "matvec"
    with pytest.raises(ValueError, match="fused_structured"):
        tpdhg.resolve_engine("fused_structured", bare)
    # dense operators off the accelerator take matvec, as the reference's
    # rule gives off the TPU
    dense = ops._replace(
        data=(tpdhg.structured_to_dense(ops.structured),), structured=None)
    assert tpdhg.select_engine(dense) == "matvec"
    # the dense fused engine resolves on dense operators, and refuses
    # structured ones with the reference's ValueError
    assert tpdhg.resolve_engine("fused", dense) is tpdhg.fused_dense_engine()
    with pytest.raises(ValueError, match="needs dense operator data"):
        tpdhg.resolve_engine("fused", ops, km, ktm)
    # the streaming full engine runs the single-lane problem only, and
    # resolves on one lane of the stack with its ragged wide-block plans
    with pytest.raises(ValueError, match="single-lane"):
        tpdhg.resolve_engine("fused_structured_full", ops, km, ktm)
    lane = map_arrays(lambda a: a[:1], ops)
    eng = tpdhg.resolve_engine("fused_structured_full", lane, km, ktm)
    assert eng.name == "fused_structured_full"
    assert eng is tpdhg.fused_structured_full_engine(
        None, *tpdhg._wide_block_plans(lane.structured))
    # the multi-device backends run now (ROADMAP item 14.5): on one rank
    # and over two "devices" each lane's bits are vmap's
    want = tback.solve_map(ops, km, ktm, FIXED_KW, backend="vmap")
    with testing.gloo_world():
        for backend, opts in (("shard_map", {}),
                              ("pmap", {"devices": ("cpu", "cpu")})):
            got = tback.solve_map(ops, km, ktm, FIXED_KW, backend=backend,
                                  **opts)
            np.testing.assert_array_equal(got.x, want.x)
            np.testing.assert_array_equal(got.iterations, want.iterations)


def test_single_lane_solve_matches_reference():
    """``solve`` and ``backends.solve_one_ex`` run one LP as a k=1 stack: a
    dense LP through the matvec engine (dense ops off the accelerator)."""
    rng = np.random.default_rng(0)
    K = rng.normal(size=(6, 9)).astype(np.float32)
    fields = dict(c=rng.normal(size=9), q=np.abs(rng.normal(size=6)),
                  l=np.zeros(9), u=np.ones(9), ineq_mask=np.ones(6, bool))
    rop = rpdhg.OperatorLP(**{f: jnp.asarray(v, jnp.float32 if v.dtype
                                             != bool else bool)
                              for f, v in fields.items()},
                           data=(jnp.asarray(K),))
    op = interop.operator_from_numpy(dict(fields, data=(K,)), device="cpu")
    want = rpdhg.solve(rop, **FIXED_KW)
    got = tpdhg.solve(op, **FIXED_KW)
    one, backend, engine = tback.solve_one_ex(op, tpdhg.dense_K_mv,
                                              tpdhg.dense_KT_mv, FIXED_KW)
    assert (backend, engine) == ("vmap", "matvec")
    for res in (got, one):
        np.testing.assert_allclose(res.x, np.asarray(want.x), **TOL)
        np.testing.assert_allclose(res.y, np.asarray(want.y), **TOL)
        assert int(res.iterations) == int(want.iterations)
