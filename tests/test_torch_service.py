"""Port parity for the synchronous service (``repro_torch.service``).

One Gavel session (64 jobs, k=4, registry defaults otherwise) runs three
steps in both packages: cold, a +-3% throughput drift on the same jobs,
then 20% job churn under stable ``job_ids``.  The port must give the
reference's plan-cache verdicts (miss, hit, repair), its warm fractions,
and its ``mean_norm_throughput`` at convergence within 1e-3 at every step
when both packages draw their equilibration probes from the reference's
``jax.random`` bits.  With the port's own probes (a ``torch.Generator``)
the bound is 2e-3: see ``PROBE_QUALITY_TOL``."""

import numpy as np
import pytest

from repro.core import ExecConfig as RefExecConfig
from repro.core import SolveConfig as RefSolveConfig
from repro.core import plan as rplan, pop as rpop, reduce as rreduce
from repro.domains import GavelInstance as RefGavelInstance
from repro.problems.cluster_scheduling import GavelProblem as RefGavel
from repro.problems.cluster_scheduling import make_cluster_workload
from repro.service import PopService as RefPopService
from repro_torch import testing
from repro_torch.core import pdhg as tpdhg
from repro_torch.core import plan as tplan, pop as tpop, reduce as treduce
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import GavelInstance
from repro_torch.problems.cluster_scheduling import GavelProblem
from repro_torch.service import DispatchConfig, PopService

from test_torch_pdhg import reference_probes

QUALITY_TOL = 1e-3


def _workloads():
    """(workload, job ids) for cold, drift and 20% churn."""
    return testing.session_workloads(64, (16, 16, 16), churn=0.2,
                                     make_workload=make_cluster_workload)


SESSION_KW = dict(k=4, strategy="stratified", min_per_sub=8)
# with its own probes the port equilibrates differently from the
# reference, and the converged quality can differ by more than 1e-3
PROBE_QUALITY_TOL = {"reference": QUALITY_TOL, "port": 2e-3}


@pytest.fixture(scope="module")
def reference_session():
    sess = RefPopService().session("t", domain="gavel",
                                   solve=RefSolveConfig(**SESSION_KW))
    return [sess.step(RefGavelInstance(wl, job_ids=ids))
            for wl, ids in _workloads()]


@pytest.mark.parametrize("probes", ["reference", "port"])
def test_gavel_session_matches_reference(reference_session, monkeypatch,
                                         probes):
    if probes == "reference":
        monkeypatch.setattr(tpdhg, "rademacher_probes", reference_probes)
    port = PopService(device="cpu").session("t", domain="gavel",
                                            solve=SolveConfig(**SESSION_KW))
    steps = zip(_workloads(), reference_session, ("miss", "hit", "repair"))
    for (wl, ids), a, verdict in steps:
        b = port.step(GavelInstance(wl, job_ids=ids))
        assert a.plan_cache == b.plan_cache == verdict
        assert b.engine == "fused_structured" and b.backend == "vmap"
        assert a.warm_fraction == b.warm_fraction
        assert b.raw.converged.all()
        if probes == "reference":
            assert a.iterations == b.iterations
        assert abs(a.metrics["mean_norm_throughput"]
                   - b.metrics["mean_norm_throughput"]) \
            < PROBE_QUALITY_TOL[probes]
        assert b.alloc.shape == (wl.T.shape[0],)
    assert 0.5 < port.last.warm_fraction < 1.0
    stats = port.service.stats()
    assert (stats["plan_hits"], stats["plan_repairs"],
            stats["plan_misses"]) == (1, 1, 1)
    assert stats["engines"] == {"fused_structured": 3}


def test_small_instance_takes_full_path():
    """Fewer jobs than k * min_per_sub: the unpartitioned k=1 solve, warm
    on the next step while the job ids are unchanged."""
    kw = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
    wl = make_cluster_workload(12, seed=0)
    ids = np.arange(12)
    ref = RefPopService().session("tiny", domain="gavel",
                                  solve=RefSolveConfig(k=8, min_per_sub=8),
                                  exec=RefExecConfig(solver_kw=kw))
    port = PopService(device="cpu").session(
        "tiny", domain="gavel", solve=SolveConfig(k=8, min_per_sub=8),
        exec=ExecConfig(solver_kw=kw))
    for warm_fraction in (None, 1.0):
        a = ref.step(RefGavelInstance(wl, job_ids=ids))
        b = port.step(GavelInstance(wl, job_ids=ids))
        assert a.plan_cache == b.plan_cache == "full" and b.k == 1
        assert a.warm_fraction == b.warm_fraction == warm_fraction
        assert a.iterations == b.iterations
        assert abs(a.metrics["mean_norm_throughput"]
                   - b.metrics["mean_norm_throughput"]) < QUALITY_TOL


def test_unported_options_raise(tmp_path):
    """Every service option is ported now; the tuner's arguments reject
    bad input as the reference's do (a tampered profile raises
    ``ProfileError``, a non-``SLOTarget`` SLO ``TypeError``).  The
    dispatcher (item 11), paging and the deadline ladder (item 10):
    ``dispatch=True`` without a profile starts a dispatcher on the
    ``DispatchConfig()`` defaults that ``close()`` stops, a capped service
    pages its coldest tenant out, and a deadline with no measured rate yet
    runs the full solve."""
    import json
    import threading
    from pathlib import Path
    from repro_torch.tuning import ProfileError
    with PopService(device="cpu", dispatch=True) as disp:
        assert disp.dispatcher is not None
        assert disp.dispatcher.cfg == DispatchConfig()
        assert disp.stats()["dispatch"]["requests"] == 0
    assert not disp.dispatcher._thread.is_alive()
    assert not any(t.name == "pop-dispatch" for t in threading.enumerate())
    fixture = (Path(__file__).resolve().parent / "fixtures" / "tuning"
               / "profile_fixture.json")
    obj = json.loads(fixture.read_text())
    obj["launch_cost"]["overhead_s"] = 1.0
    tampered = tmp_path / "tampered.json"
    tampered.write_text(json.dumps(obj))
    with pytest.raises(ProfileError, match="digest mismatch"):
        PopService(device="cpu", profile=str(tampered))
    svc = PopService(device="cpu", max_resident=1)
    assert svc.max_resident == 1
    with pytest.raises(TypeError, match="SLOTarget"):
        svc.session("t", domain="gavel", slo=0.02)
    kw = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
    sess = svc.session("t", domain="gavel", solve=SolveConfig(**SESSION_KW),
                       exec=ExecConfig(solver_kw=kw))
    wl = make_cluster_workload(64, seed=0)
    a = sess.step(GavelInstance(wl), deadline_s=1.0)
    assert a.status == "ok" and a.faults == () and a.plan_cache == "miss"
    svc.session("u", domain="gavel")
    assert svc.stats()["paged_out"] == 1 and svc.tenants() == ("t", "u")
    b = sess.step(GavelInstance(wl), deadline_s=100.0)
    assert b.status == "ok" and b.plan_cache == "hit"
    assert b.warm_fraction == 1.0 and svc.stats()["paged_in"] == 1


def test_sessions_are_pinned_and_isolated():
    svc = PopService(device="cpu")
    a = svc.session("a", domain="gavel", solve=SolveConfig(k=2))
    assert svc.session("a") is a
    with pytest.raises(ValueError, match="pinned"):
        svc.session("a", solve=SolveConfig(k=3))
    b = svc.session("b", domain="gavel")
    assert b is not a and b.solve_cfg.k == 8
    assert svc.tenants() == ("a", "b")
    svc.end_session("a")
    assert svc.tenants() == ("b",)
    with pytest.raises(ValueError, match="needs an instance"):
        svc.session("c")


@pytest.mark.parametrize("strategy,replicate", [
    ("random", None), ("stratified", None), ("stratified_multidim", None),
    ("stratified", 0.5)])
def test_plans_and_repairs_match_reference(strategy, replicate):
    """The numpy planning copies (partition, replication, repair under
    churn, coalescing) place every entity where the reference does."""
    (wl, ids), _, (wl3, ids3) = _workloads()
    kw = dict(strategy=strategy, seed=3, replicate_threshold=replicate,
              entity_ids=ids)
    a = rpop.plan(RefGavel(wl), 4, **kw)
    b = tpop.plan(GavelProblem(wl), 4, **kw)
    np.testing.assert_array_equal(b.idx, a.idx)
    np.testing.assert_array_equal(b.entity_of_slot, a.entity_of_slot)
    assert b.similarity == pytest.approx(a.similarity)
    sub = np.random.default_rng(0).random(a.idx.shape)
    if replicate is None:
        np.testing.assert_array_equal(
            treduce.coalesce_concat(sub, b.idx, b.n_entities),
            rreduce.coalesce_concat(sub, a.idx, a.n_entities))
        ra = rplan.repair_plan(a, RefGavel(wl3), entity_ids=ids3)
        rb = tplan.repair_plan(b, GavelProblem(wl3), entity_ids=ids3)
        np.testing.assert_array_equal(rb.idx, ra.idx)
        np.testing.assert_array_equal(rb.external_ids(), ra.external_ids())
    else:
        assert b.replication is not None and b.idx.size > b.n_entities
        np.testing.assert_array_equal(
            treduce.coalesce_replicated(sub, b.idx, b.replication),
            rreduce.coalesce_replicated(sub, a.idx, a.replication))
