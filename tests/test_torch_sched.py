"""The scheduler shims of the port (``repro_torch.sched``) and the
``examples_torch/schedule_cluster.py`` twin against the reference's, on
the CPU.

``GavelScheduler`` runs three rounds (cold, a throughput report, churn) in
both packages with the port drawing its equilibration probes from the
reference's ``jax.random`` bits (ROADMAP §3, known differences): equal
iterations, plan-cache verdicts and warm fractions, allocations within
1e-3.  It also forwards onto a hand-driven session bit for bit, as the
reference's shim test holds it.  The ``sched/elastic`` twins of
``tests/test_substrate.py`` run both packages on equal inputs."""

import warnings

import numpy as np
import pytest

from repro.sched import elastic as relastic
from repro.sched.gavel_service import GavelScheduler as RefScheduler
from repro.sched.gavel_service import JobSpec as RefJobSpec
from repro.sched.gavel_service import SchedulerConfig as RefSchedulerConfig
from repro_torch.configs import ARCH_IDS
from repro_torch.core import pdhg as tpdhg
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import GavelInstance
from repro_torch.sched import elastic as telastic
from repro_torch.sched.gavel_service import (GavelScheduler, JobSpec,
                                             SchedulerConfig)
from repro_torch.service import PopService

from test_torch_pdhg import reference_probes

KW = dict(max_iters=300, tol_primal=1e-5, tol_gap=1e-5)
ALLOC_TOL = 1e-3


def _submit_fleet(sched, job_spec):
    rng = np.random.default_rng(0)
    for i in range(32):
        sched.submit(job_spec(
            job_id=f"j{i}", arch=ARCH_IDS[i % len(ARCH_IDS)],
            priority=float(rng.choice([1.0, 2.0])),
            throughputs=np.abs(rng.normal([1.0, 0.6, 0.8], 0.2)) + 0.05))


def _before_round(sched, job_spec, round_no):
    """Round 1: a throughput report on j0; round 2: j1 out, j99 in."""
    if round_no == 1:
        sched.report_throughput("j0", np.array([0.2, 0.1, 0.15]))
    if round_no == 2:
        sched.remove("j1")
        sched.submit(job_spec(job_id="j99", arch="llama3_8b",
                              throughputs=np.array([1.0, 0.5, 0.7])))


def _rounds(sched, job_spec):
    """Three rounds: the allocation per job, the fairness report, the
    plan-cache verdict and the per-lane iterations of each."""
    _submit_fleet(sched, job_spec)
    out = []
    for round_no in range(3):
        _before_round(sched, job_spec, round_no)
        alloc = sched.allocate()
        out.append((alloc, sched.fairness_report(),
                    sched._session.last.plan_cache,
                    sched._session.last.iterations))
    return out


def test_gavel_scheduler_matches_reference(monkeypatch):
    monkeypatch.setattr(tpdhg, "rademacher_probes", reference_probes)
    with pytest.warns(DeprecationWarning, match="GavelScheduler"):
        ref = RefScheduler(RefSchedulerConfig(pop_k=2, solver_kw=dict(KW)))
    with pytest.warns(DeprecationWarning, match="GavelScheduler"):
        port = GavelScheduler(SchedulerConfig(pop_k=2, solver_kw=dict(KW)),
                              device="cpu")
    want, got = _rounds(ref, RefJobSpec), _rounds(port, JobSpec)
    assert [g[2] for g in got] == ["miss", "hit", "repair"]
    for round_no, ((a_ref, r_ref, v_ref, it_ref), (a, r, v, it)) in \
            enumerate(zip(want, got)):
        assert list(a) == list(a_ref) and v == v_ref
        if round_no < 2:
            # the churned round's warm lanes may stop a check apart
            # (ROADMAP §3: warm trajectories are chaotic on Gavel)
            assert it == it_ref
        np.testing.assert_allclose(
            np.concatenate([np.atleast_1d(x) for x in a.values()]),
            np.concatenate([np.atleast_1d(x) for x in a_ref.values()]),
            rtol=0, atol=ALLOC_TOL)
        assert r["n_jobs"] == r_ref["n_jobs"]
        assert r["warm_fraction"] == r_ref["warm_fraction"]
        assert abs(r["min_norm_throughput"]
                   - r_ref["min_norm_throughput"]) < ALLOC_TOL


def test_gavel_scheduler_forwards_onto_session():
    """The shim's rounds are a hand-driven session's steps, bit for bit
    (the twin of ``tests/test_compat_shims.py``'s Gavel case)."""
    with pytest.warns(DeprecationWarning, match="GavelScheduler"):
        sched = GavelScheduler(SchedulerConfig(pop_k=2, solver_kw=dict(KW)),
                               device="cpu")
    sess = PopService(device="cpu").session(
        "fleet", domain="gavel",
        solve=SolveConfig(k=2, strategy="stratified", min_per_sub=8),
        exec=ExecConfig(backend=sched.cfg.map_backend, solver_kw=dict(KW)))
    _submit_fleet(sched, JobSpec)
    for round_no in range(3):
        _before_round(sched, JobSpec, round_no)
        alloc = sched.allocate()
        eids = np.array([sched._eids[j] for j in sched.jobs], np.int64)
        mine = sess.step(GavelInstance(sched._workload(), job_ids=eids))
        np.testing.assert_array_equal(
            np.stack([np.atleast_1d(v) for v in alloc.values()]).ravel(),
            np.asarray(mine.alloc).ravel())
    assert sched.last_warm_fraction == mine.warm_fraction
    assert mine.plan_cache == "repair"
    assert "j1" not in alloc and "j99" in alloc


def test_default_device_refuses_without_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GavelScheduler(SchedulerConfig())


# ---------------------------------------------------------------------------
# sched/elastic: twins of tests/test_substrate.py on equal inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [relastic, telastic],
                         ids=["reference", "port"])
def test_heartbeat_states(pkg):
    hb = pkg.HeartbeatMonitor(timeout_s=30, suspect_s=10)
    hb.beat(0, now=0.0)
    hb.beat(1, now=0.0)
    hb.beat(1, now=24.0)
    st_ = hb.status(now=36.0)
    assert st_[0] == "dead" and st_[1] == "suspect"
    assert hb.alive(now=36.0) == [1]


def test_straggler_detection():
    got = []
    for pkg in (relastic, telastic):
        sd = pkg.StragglerDetector(k=4.0)
        for w in range(8):
            for _ in range(16):
                sd.record(w, 1.0 + 0.01 * w)
        for _ in range(16):
            sd.record(8, 3.0)
        got.append(sd.stragglers())
    assert got[1] == got[0] == [8]


def test_plan_remesh_equal():
    for n_alive, mp in ((480, 16), (8, 16), (1024, 8), (1030, 16),
                        (512, 4), (96, 8)):
        assert telastic.plan_remesh(n_alive, mp) == \
            relastic.plan_remesh(n_alive, mp)
    plan = telastic.plan_remesh(n_alive=480, model_parallel=16)
    assert plan["ok"] and plan["mesh_shape"][-1] == 16
    assert plan["chips_used"] <= 480 and plan["chips_used"] % 16 == 0
    assert not telastic.plan_remesh(8, 16)["ok"]


def test_scale_microbatches_equal():
    for args in ((256, 8, 16, 8), (256, 8, 16, 4), (1024, 4, 32, 16)):
        n_new = telastic.scale_microbatches(*args)
        assert n_new == relastic.scale_microbatches(*args)
        assert args[0] % (n_new * args[3]) == 0


def test_redispatch_covers_all_subproblems():
    assign = {0: [0, 1], 1: [2, 3], 2: [4, 5]}
    new = telastic.redispatch(assign, dead=[1], alive=[0, 2])
    assert new == relastic.redispatch(assign, dead=[1], alive=[0, 2])
    assert sorted(sum(new.values(), [])) == [0, 1, 2, 3, 4, 5]
    assert 1 not in new and assign[1] == [2, 3]


def test_speculative_backups_past_deadline():
    pending = {10: 0.0, 11: 5.0, 12: 1.5}
    assert telastic.speculative_backups(pending, now=12.0, deadline_s=10.0) \
        == relastic.speculative_backups(pending, now=12.0,
                                        deadline_s=10.0) == [10, 12]


def test_schedule_cluster_example_on_cpu(capsys):
    """The twin of ``examples/schedule_cluster.py --fast``: jobs named
    after the 10 architectures, three rounds (a miss, a warm hit, a
    repaired plan after churn), every allocation a time fraction."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        "schedule_cluster.py"
    spec = importlib.util.spec_from_file_location("schedule_cluster_twin",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names, rounds = mod.main(["--fast", "--device", "cpu"])
    assert len(names) == 48
    assert {n.rsplit("-", 1)[0] for n in names} == set(ARCH_IDS)
    assert [r.plan_cache for r in rounds] == ["miss", "hit", "repair"]
    for r in rounds:
        rho = np.atleast_1d(r.alloc)
        assert rho.shape == (48,)
        assert (rho >= 0).all() and (rho <= 1 + 1e-6).all()
    assert "service stats" in capsys.readouterr().out
