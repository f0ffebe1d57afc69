"""Port parity for traffic engineering (``repro_torch.problems.
traffic_engineering``, the ``traffic`` domain) and the partitioners the
paper's traffic experiments use (``clustered_partition``,
``skewed_partition``).

Both packages draw the same instance from the same seeds:

* the topology, demands and k-shortest paths are the reference's numpy
  code, so the arrays are bit-equal;
* POP's stacked sub-LPs (``pop.build``) carry bit-equal ELL arrays and fold
  maps, and the per-lane torch matvecs (``index_add_`` for the reference's
  ``segment_sum``) agree with the reference's within 1e-6;
* a k=3 session on the conformance matrix's small case (a cold step, then
  every demand x 1.05: a plan-cache hit, warm) and the unpartitioned
  baseline reach the reference's ``total_flow`` within 1e-3 relative."""

import functools

import numpy as np
import pytest
import torch

from repro.core import SolveConfig as RefSolveConfig
from repro.core import partition as rpart, pop as rpop
from repro.domains import get as ref_domain
from repro.problems import traffic_engineering as rte
from repro.service import PopService as RefPopService
from repro_torch import domains, testing
from repro_torch.core import partition as tpart, pop as tpop
from repro_torch.core.config import SolveConfig
from repro_torch.problems import traffic_engineering as tte
from repro_torch.service import PopService

# the conformance matrix's small traffic case, and a larger one whose
# edge rows fill a wide bucket
CASES = {
    "small": (14, dict(n_nodes=24, target_edges=48, n_paths=3, max_len=12,
                       topo_seed=1, demand_seed=1, path_seed=1)),
    "medium": (300, dict(n_nodes=80, target_edges=160, n_paths=4,
                         max_len=24)),
}
FLOW_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def _arrays(case, package):
    n, kw = CASES[case]
    return testing.traffic_arrays(n, make=rte if package == "ref" else None,
                                  **kw)


def _problems(case, demand_scale=1.0):
    (rtopo, rpairs, rdem, rpe) = _arrays(case, "ref")
    (ttopo, tpairs, tdem, tpe) = _arrays(case, "port")
    return (rte.TrafficProblem(rtopo, rpairs, rdem * demand_scale, rpe),
            tte.TrafficProblem(ttopo, tpairs, tdem * demand_scale, tpe))


@pytest.mark.parametrize("case", sorted(CASES))
def test_instance_arrays_bit_equal(case):
    ref, port = _arrays(case, "ref"), _arrays(case, "port")
    assert port[0].n_nodes == ref[0].n_nodes
    assert port[0].adj == ref[0].adj
    for a, b in ((ref[0].edges, port[0].edges),
                 (ref[0].capacity, port[0].capacity),
                 *zip(ref[1:], port[1:])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pop_build_ell_bit_equal(case):
    rprob, tprob = _problems(case)
    rops = rpop.build(rprob, rpop.plan(rprob, 3, strategy="stratified"))
    tops = tpop.build(tprob, tpop.plan(tprob, 3, strategy="stratified"),
                      "cpu")
    for f in rops.structured._fields:
        a, b = getattr(rops.structured, f), getattr(tops.structured, f)
        if a is None:
            assert b is None, f
            continue
        assert np.asarray(a).dtype == b.numpy().dtype, f
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    for f in ("c", "q", "l", "u", "ineq_mask"):
        np.testing.assert_array_equal(getattr(tops, f).numpy(),
                                      np.asarray(getattr(rops, f)))
    for a, b in zip(rops.data, tops.data):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if case == "medium":
        assert int((tops.structured.row_fold
                    < tops.structured.wrow_ids.shape[-1]).sum()) > 0


def test_matvecs_match_reference():
    rprob, tprob = _problems("medium")
    rop, top = rprob.build_full(), tprob.build_full()
    rng = np.random.default_rng(5)
    x = rng.normal(size=top.c.shape[0]).astype(np.float32)
    y = rng.normal(size=top.q.shape[0]).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tprob.K_mv(top.data, torch.as_tensor(x)),
                               np.asarray(rprob.K_mv(rop.data, x)), **tol)
    np.testing.assert_allclose(tprob.KT_mv(top.data, torch.as_tensor(y)),
                               np.asarray(rprob.KT_mv(rop.data, y)), **tol)


def test_cspf_and_evaluate_match_reference():
    rprob, tprob = _problems("medium")
    f_ref = rte.cspf_heuristic(rprob)
    f = tte.cspf_heuristic(tprob)
    np.testing.assert_array_equal(f, f_ref)
    assert tprob.evaluate(f) == rprob.evaluate(f_ref)


def test_partitions_match_reference():
    """The partitioners called directly, and the Fig. 6 skewed split
    (same-source commodities in one lane) passed as ``partition_idx``."""
    rprob, tprob = _problems("medium")
    labels = np.random.default_rng(3).integers(0, 5, 300)
    np.testing.assert_array_equal(tpart.clustered_partition(labels, 4, 2),
                                  rpart.clustered_partition(labels, 4, 2))
    groups = tprob.source_groups()
    np.testing.assert_array_equal(groups, rprob.source_groups())
    idx = tpart.skewed_partition(groups, 4)
    np.testing.assert_array_equal(idx, rpart.skewed_partition(groups, 4))
    plan = tpop.plan(tprob, 4, partition_idx=idx)
    np.testing.assert_array_equal(
        plan.idx, rpop.plan(rprob, 4, partition_idx=idx).idx)
    # every source's commodities share one lane
    lane_of = {}
    for lane, row in enumerate(plan.idx):
        for e in row[row >= 0]:
            assert lane_of.setdefault(groups[e], lane) == lane
    assert "skewed" not in tpart.STRATEGIES


def test_domain_registered_with_reference_defaults():
    spec, ref = domains.get("traffic"), ref_domain("traffic")
    assert spec.default_solve == SolveConfig(**{
        f: getattr(ref.default_solve, f)
        for f in ("k", "strategy", "seed", "replicate_threshold",
                  "min_per_sub")})
    assert spec.default_exec.solver_dict() == ref.default_exec.solver_dict()
    _, tprob = _problems("small")
    assert domains.spec_for(tprob) is spec


@pytest.fixture(scope="module")
def reference_session():
    sess = RefPopService().session("wan", domain="traffic",
                                   solve=RefSolveConfig(k=3,
                                                        strategy="stratified"))
    steps = [sess.step(_problems("small", s)[0]) for s in (1.0, 1.05)]
    full = rpop.solve_full_ex(_problems("small")[0])
    return steps, full


def test_traffic_session_matches_reference(reference_session):
    want, want_full = reference_session
    sess = PopService(device="cpu").session(
        "wan", domain="traffic", solve=SolveConfig(k=3, strategy="stratified"))
    got = [sess.step(_problems("small", s)[1]) for s in (1.0, 1.05)]
    assert [a.plan_cache for a in got] == ["miss", "hit"]
    assert [a.plan_cache for a in got] == [a.plan_cache for a in want]
    for a, b in zip(got, want):
        assert a.engine == b.engine == "fused_structured"
        assert np.asarray(a.raw.converged).all()
        flow, ref_flow = (a.metrics["total_flow"], b.metrics["total_flow"])
        assert abs(flow - ref_flow) <= FLOW_TOL * abs(ref_flow)
    assert got[1].warm_fraction == 1.0
    full = tpop.solve_full_ex(_problems("small")[1], device="cpu")
    _, tprob = _problems("small")
    flow = tprob.evaluate(full.alloc)["total_flow"]
    ref_flow = tprob.evaluate(np.asarray(want_full.alloc))["total_flow"]
    assert full.engine == want_full.engine
    assert abs(flow - ref_flow) <= FLOW_TOL * abs(ref_flow)
