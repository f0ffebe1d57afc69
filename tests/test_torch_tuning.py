"""The SLO auto-tuner of the port (``repro_torch.tuning`` and its service
wiring) against the reference's (``repro.tuning``).

The first half twins every test of ``tests/test_tuning.py`` on the port at
``device="cpu"``, against the same committed fixture profile.  The second
half puts the same inputs through both packages: a profile sealed by
either passes the other's ``check_profile`` (a tampered one fails both);
``plan_for_slo``, ``OnlineTuner`` and ``launch_defaults`` decide exactly
alike; and the 96-job retune session takes the same ks and plan-cache
verdicts.  The profiler itself is held in ``test_torch_tuning_profile.py``."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro import tuning as rtuning
from repro.core import ExecConfig as RefExecConfig
from repro.core import SolveConfig as RefSolveConfig
from repro.domains import GavelInstance as RefGavelInstance
from repro.problems.cluster_scheduling import make_cluster_workload
from repro.service import PopService as RefPopService
from repro_torch.core import backends as tbackends
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import GavelInstance
from repro_torch.problems.traffic_engineering import (TrafficProblem,
                                                      k_shortest_paths,
                                                      make_demands,
                                                      make_topology)
from repro_torch.service import DispatchConfig, PopService
from repro_torch.tuning import (OnlineTuner, ProfileError, SLOTarget,
                                TuningProfile,
                                check_profile, latency_at, launch_defaults,
                                load_profile, plan_for_slo, profile_digest,
                                quality_loss_at, save_profile)
from repro_torch.tuning import online as tonline

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "tuning" / \
    "profile_fixture.json"

KW = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
CPU = "cpu"


def _traffic(n=24, seed=0, scale=1.0):
    topo = make_topology(20, 40, seed=seed)
    pairs, dem = make_demands(topo, n, seed=seed)
    pe = k_shortest_paths(topo, pairs, n_paths=2, max_len=10, seed=seed)
    return TrafficProblem(topo, pairs, dem * scale, pe)


@pytest.fixture(scope="module")
def profile():
    return check_profile(load_profile(FIXTURE))


@pytest.fixture(autouse=True)
def _clear_thresholds():
    """A service built with a profile installs its thresholds process-wide:
    clear them after every test, so no later test on this worker sees
    them."""
    yield
    tbackends.install_tuned_thresholds(None)


def _service(**kw):
    return PopService(device=CPU, **kw)


# ---------------------------------------------------------------------------
# the SLO contract
# ---------------------------------------------------------------------------

class TestSLOTarget:
    def test_frozen_hashable_validated(self):
        a = SLOTarget(max_quality_loss=0.02, step_deadline_s=1.5)
        b = SLOTarget(max_quality_loss=0.02, step_deadline_s=1.5)
        assert a == b and hash(a) == hash(b)
        with pytest.raises(dataclasses.FrozenInstanceError):
            a.max_quality_loss = 0.5

    @pytest.mark.parametrize("kw", [
        dict(max_quality_loss=-0.1),
        dict(max_quality_loss=1.0),
        dict(step_deadline_s=0.0),
        dict(step_deadline_s=-2.0),
    ])
    def test_rejects_out_of_range(self, kw):
        with pytest.raises(ValueError):
            SLOTarget(**kw)


# ---------------------------------------------------------------------------
# the artifact seal
# ---------------------------------------------------------------------------

class TestProfileSeal:
    def test_fixture_is_sealed(self, profile):
        assert profile.digest == profile_digest(profile)
        assert {"gavel", "traffic"} <= set(profile.domains)

    def test_digest_rejects_tampering(self, tmp_path):
        obj = json.loads(FIXTURE.read_text())
        obj["domains"]["traffic"]["n_exponent"] = 9.9   # hand-edit
        p = tmp_path / "edited.json"
        p.write_text(json.dumps(obj))
        with pytest.raises(ProfileError, match="digest mismatch"):
            check_profile(load_profile(p))

    def test_version_gate(self, tmp_path, profile):
        stale = dataclasses.replace(profile, version=0)
        p = save_profile(stale, tmp_path / "stale.json")  # reseals digest
        with pytest.raises(ProfileError, match="version"):
            check_profile(load_profile(p))

    def test_platform_gate(self, profile):
        with pytest.raises(ProfileError, match="measured on"):
            check_profile(profile, platform="tpu9000")
        assert check_profile(profile, platform="cpu") is profile

    def test_load_does_not_validate(self, tmp_path):
        obj = json.loads(FIXTURE.read_text())
        obj["digest"] = "sha256:bogus"
        p = tmp_path / "bogus.json"
        p.write_text(json.dumps(obj))
        prof = load_profile(p)               # parse-only door
        with pytest.raises(ProfileError):
            check_profile(prof)

    def test_unreadable_raises_profile_error(self, tmp_path):
        with pytest.raises(ProfileError):
            load_profile(tmp_path / "nope.json")


# ---------------------------------------------------------------------------
# the offline planner
# ---------------------------------------------------------------------------

class TestPlanner:
    def test_gavel_flat_curve_picks_large_k(self, profile):
        plan = plan_for_slo(profile, "gavel", 512, SLOTarget(0.02))
        assert plan.solve.k >= 16
        assert plan.predicted_quality_loss <= 0.02
        assert plan.source == "curves"

    def test_traffic_steep_curve_picks_small_k(self, profile):
        plan = plan_for_slo(profile, "traffic", 400, SLOTarget(0.02))
        assert plan.solve.k <= 4
        assert plan.predicted_quality_loss <= 0.02

    def test_deadline_escalates_replication_before_quality(self, profile):
        slo = SLOTarget(max_quality_loss=0.05, step_deadline_s=20.0)
        plan = plan_for_slo(profile, "traffic", 400, slo)
        assert plan.source in ("replicated", "deadline-limited")
        if plan.source == "replicated":
            assert plan.solve.replicate_threshold is not None
            assert plan.predicted_quality_loss <= 0.05

    def test_latency_scales_with_n(self, profile):
        curves = profile.domains["gavel"]
        t_probe = latency_at(curves, 8, curves.probe_n)
        t_big = latency_at(curves, 8, curves.probe_n * 4)
        assert t_big > t_probe * 2       # superlinear exponent (1.4)

    def test_quality_loss_interpolates(self, profile):
        curves = profile.domains["traffic"]
        loss8 = quality_loss_at(curves, 8)
        assert 0.049 < loss8 < 0.20

    def test_base_solve_fields_survive_planning(self, profile):
        base = SolveConfig(k=8, strategy="stratified", seed=7)
        plan = plan_for_slo(profile, "gavel", 512, SLOTarget(0.02),
                            base_solve=base)
        assert plan.solve.strategy == "stratified"
        assert plan.solve.seed == 7

    def test_unknown_domain_keeps_base(self, profile):
        base = SolveConfig(k=8)
        plan = plan_for_slo(profile, "warehouse", 100, SLOTarget(0.02),
                            base_solve=base)
        assert plan.solve == base
        assert plan.source == "no-curves"

    def test_launch_defaults_from_cost_line(self, profile):
        d = launch_defaults(profile)
        assert d is not None
        assert 0.5 <= d["max_wait_ms"] <= 20.0
        assert d["max_lanes"] >= 8
        assert d["max_lanes"] & (d["max_lanes"] - 1) == 0


# ---------------------------------------------------------------------------
# the online refiner
# ---------------------------------------------------------------------------

class TestOnlineTuner:
    def _tuner(self, profile, slo, base=None, domain="gavel"):
        return OnlineTuner(profile, domain, slo,
                           base or SolveConfig(k=8), ExecConfig())

    def test_latency_violation_doubles_k_after_patience(self, profile):
        t = self._tuner(None, SLOTarget(0.5, step_deadline_s=0.01))
        t.plan_initial(256)
        ev1 = t.observe(8, 0.5, 1.0)
        assert ev1.violation == "latency" and ev1.new_solve is None
        ev2 = t.observe(8, 0.5, 1.0)
        assert ev2.new_solve is not None and ev2.new_solve.k == 16

    def test_cooldown_holds_after_move(self, profile):
        t = self._tuner(None, SLOTarget(0.5, step_deadline_s=0.01))
        t.plan_initial(256)
        t.observe(8, 0.5, 1.0)
        assert t.observe(8, 0.5, 1.0).new_solve.k == 16
        for _ in range(2):
            assert t.observe(16, 0.5, 1.0).new_solve is None
        assert t.observe(16, 0.5, 1.0).new_solve is not None

    def test_quality_violation_escalates_replication_first(self, profile):
        t = self._tuner(profile, SLOTarget(max_quality_loss=0.02),
                        base=SolveConfig(k=16), domain="gavel")
        t.plan_initial(512)
        t.solve_cfg = SolveConfig(k=16)
        t.observe(8, 0.1, 1.00)
        t.observe(16, 0.1, 0.90)
        ev = t.observe(16, 0.1, 0.90)
        assert ev.violation == "quality"
        assert ev.new_solve is not None
        assert ev.new_solve.k == 16
        assert ev.new_solve.replicate_threshold is not None

    def test_quality_violation_without_rows_halves_k(self):
        t = self._tuner(None, SLOTarget(max_quality_loss=0.02))
        t.plan_initial(256)
        t.observe(4, 0.1, 1.00)
        t.observe(8, 0.1, 0.80)
        ev = t.observe(8, 0.1, 0.80)
        assert ev.new_solve is not None and ev.new_solve.k == 4
        assert ev.new_solve.replicate_threshold is None

    def test_min_per_sub_clamped_move_is_skipped(self):
        base = SolveConfig(k=12, min_per_sub=8)
        t = self._tuner(None, SLOTarget(0.5, step_deadline_s=0.01),
                        base=base)
        t.plan_initial(96)
        t.observe(12, 0.5, 1.0)
        ev = t.observe(12, 0.5, 1.0)
        assert ev.violation == "latency" and ev.new_solve is None


# ---------------------------------------------------------------------------
# service integration
# ---------------------------------------------------------------------------

def _retune_session(svc_cls, inst_cls, exec_cls, slo):
    """The reference test's retune session: four steps of 96 jobs under an
    impossible deadline, then 10 jobs churned; (allocations, session)."""
    svc = svc_cls(exec=exec_cls(solver_kw=KW), **(
        {"device": CPU} if svc_cls is PopService else {}))
    wl = make_cluster_workload(96, seed=0)
    ids = np.arange(96)
    sess = svc.session("t", domain="gavel", slo=slo)
    allocs = [sess.step(inst_cls(wl, job_ids=ids)) for _ in range(4)]
    wl2 = make_cluster_workload(96, seed=1)
    ids2 = ids.copy()
    ids2[:10] = np.arange(1000, 1010)
    allocs.append(sess.step(inst_cls(wl2, job_ids=ids2)))
    return allocs, sess


class TestServiceIntegration:
    def test_profile_plans_session_and_counts_nothing_when_met(self, profile):
        svc = _service(exec=ExecConfig(solver_kw=KW), profile=profile)
        wl = make_cluster_workload(96, seed=0)
        sess = svc.session("t", GavelInstance(wl), slo=SLOTarget(0.02))
        assert sess.solve_cfg.k >= 16
        a = sess.step(GavelInstance(wl))
        assert a.status == "ok"
        st = svc.stats()
        assert st["slo_violations"] == 0
        assert st["retunes"] == 0

    def test_str_profile_path_is_loaded_and_checked(self):
        svc = _service(exec=ExecConfig(solver_kw=KW), profile=str(FIXTURE))
        assert svc.profile is not None
        assert "gavel" in svc.profile.domains

    def test_tampered_profile_rejected_at_service_door(self, tmp_path):
        obj = json.loads(FIXTURE.read_text())
        obj["version"] = 99
        p = tmp_path / "bad.json"
        p.write_text(json.dumps(obj))
        with pytest.raises(ProfileError):
            _service(profile=str(p))

    def test_profile_of_another_device_type_rejected_at_service_door(
            self, profile):
        """A profile measured on the card does not plan a CPU service (nor
        the committed CPU profile a service on the card): its latency
        curves do not transfer, so the door checks ``platform``."""
        card = dataclasses.replace(profile, platform="cuda")
        card = dataclasses.replace(card, digest=profile_digest(card))
        with pytest.raises(ProfileError, match="measured on 'cuda'"):
            _service(profile=card)

    def test_slo_requires_slotarget_type(self):
        svc = _service(exec=ExecConfig(solver_kw=KW))
        with pytest.raises(TypeError, match="SLOTarget"):
            svc.session("t", _traffic(), slo=0.02)

    def test_reentry_pins_slo(self, profile):
        svc = _service(exec=ExecConfig(solver_kw=KW), profile=profile)
        prob = _traffic()
        svc.session("t", prob, slo=SLOTarget(0.02))
        svc.session("t", prob, slo=SLOTarget(0.02))
        with pytest.raises(ValueError, match="SLO"):
            svc.session("t", prob, slo=SLOTarget(0.10))

    def test_retune_under_churn_keeps_warm_state(self):
        slo = SLOTarget(max_quality_loss=0.5, step_deadline_s=1e-4)
        allocs, sess = _retune_session(PopService, GavelInstance, ExecConfig,
                                       slo)
        ks = [a.k for a in allocs[:4]]
        for a in allocs[:4]:
            if a.plan_cache != "miss":
                assert a.warm_fraction is not None
                assert a.warm_fraction > 0.0
        assert ks[-1] > ks[0]
        a = allocs[4]
        assert a.plan_cache in ("repair", "hit")
        assert a.warm_fraction is not None and a.warm_fraction > 0.0
        st = sess.service.stats()
        assert st["slo_violations"] > 0
        assert st["retunes"] >= 1
        assert sess.stats["retunes"] >= 1

    def test_untuned_sessions_never_touch_counters(self):
        svc = _service(exec=ExecConfig(solver_kw=KW))
        sess = svc.session("t", _traffic())
        sess.step(_traffic())
        st = svc.stats()
        assert st["slo_violations"] == 0 and st["retunes"] == 0
        assert sess.slo is None

    def test_dispatch_sized_by_launch_line(self, profile):
        """``dispatch=True`` with a profile takes its window and lane cap
        from ``launch_defaults``; an explicit config wins."""
        with _service(profile=profile, dispatch=True) as svc:
            assert svc.dispatcher.cfg == DispatchConfig(
                **launch_defaults(profile))
        mine = DispatchConfig(max_lanes=16)
        with _service(profile=profile, dispatch=mine) as svc:
            assert svc.dispatcher.cfg is mine

    def test_profile_installs_thresholds_by_device_type(self, profile):
        """A profile's thresholds apply to operators on the device type it
        names, never to another."""
        cuda_only = dataclasses.replace(profile, backend_thresholds={
            "cuda": {"vmap_max_k": 2, "vmap_max_elems": 10}})
        select = tbackends.select_backend
        _service(profile=dataclasses.replace(
            cuda_only, digest=profile_digest(cuda_only)))
        assert select(4, 1, device_type="cuda") == "chunked_vmap"
        assert select(4, 1, device_type="cpu") == "vmap"
        tbackends.install_tuned_thresholds(None)
        assert select(4, 1, device_type="cuda") == "vmap"


# ---------------------------------------------------------------------------
# cross-package: one format, one decision
# ---------------------------------------------------------------------------

def _ref_profile(profile: TuningProfile):
    """The reference's TuningProfile with the same fields."""
    return rtuning.profile._from_json(
        json.loads(json.dumps(dataclasses.asdict(profile))))


class TestAcrossPackages:
    def test_seals_cross_check(self, tmp_path, profile):
        """A profile sealed by either package passes the other's
        check_profile; a tampered one fails both."""
        mine = dataclasses.replace(profile, platform="cuda",
                                   jax_version="torch-2", created="now")
        p_port = save_profile(mine, tmp_path / "port.json")
        ref = rtuning.check_profile(rtuning.load_profile(p_port))
        assert ref.digest == mine.digest
        ref_mine = rtuning.profile._from_json(json.loads(p_port.read_text()))
        ref_mine.created = "later"
        p_ref = rtuning.save_profile(ref_mine, tmp_path / "ref.json")
        got = check_profile(load_profile(p_ref))
        assert got.created == "later"
        assert p_port.read_text().replace('"now"', '"later"').replace(
            mine.digest, got.digest) == p_ref.read_text()
        for path in (p_port, p_ref):
            obj = json.loads(path.read_text())
            obj["launch_cost"]["overhead_s"] = 1.0
            bad = tmp_path / f"bad_{path.name}"
            bad.write_text(json.dumps(obj))
            with pytest.raises(ProfileError, match="digest"):
                check_profile(load_profile(bad))
            with pytest.raises(rtuning.ProfileError, match="digest"):
                rtuning.check_profile(rtuning.load_profile(bad))

    @pytest.mark.parametrize("domain", ["gavel", "traffic"])
    @pytest.mark.parametrize("n", [96, 1_024, 16_384])
    @pytest.mark.parametrize("deadline", [None, 2.0, 20.0])
    def test_plan_for_slo_matches(self, profile, domain, n, deadline):
        ref = _ref_profile(profile)
        slo = SLOTarget(0.02, step_deadline_s=deadline)
        rslo = rtuning.SLOTarget(0.02, step_deadline_s=deadline)
        base = SolveConfig(k=8, strategy="stratified", seed=3)
        rbase = RefSolveConfig(k=8, strategy="stratified", seed=3)
        a = plan_for_slo(profile, domain, n, slo, base)
        b = rtuning.plan_for_slo(ref, domain, n, rslo, rbase)
        assert dataclasses.asdict(a.solve) == dataclasses.asdict(b.solve)
        assert a.source == b.source
        assert a.predicted_quality_loss == b.predicted_quality_loss
        assert a.predicted_step_s == b.predicted_step_s
        curves, rcurves = profile.domains[domain], ref.domains[domain]
        for k in (1, 2, 3, 8, 48, 128):
            assert quality_loss_at(curves, k) == \
                rtuning.quality_loss_at(rcurves, k)
            assert latency_at(curves, k, n) == \
                rtuning.latency_at(rcurves, k, n)

    def test_launch_defaults_match(self, profile):
        assert launch_defaults(profile) == \
            rtuning.launch_defaults(_ref_profile(profile))
        none = dataclasses.replace(profile, launch_cost={})
        assert launch_defaults(none) is None
        assert rtuning.launch_defaults(_ref_profile(none)) is None

    @pytest.mark.parametrize("with_profile", [False, True])
    def test_online_tuner_matches(self, profile, with_profile):
        """One sequence of (k, solve_s, quality) observations: equal
        TuneEvents, step by step."""
        rng = np.random.default_rng(0)
        slo = SLOTarget(max_quality_loss=0.02, step_deadline_s=0.5)
        rslo = rtuning.SLOTarget(max_quality_loss=0.02, step_deadline_s=0.5)
        t = OnlineTuner(profile if with_profile else None, "gavel", slo,
                        SolveConfig(k=8), ExecConfig())
        r = rtuning.OnlineTuner(_ref_profile(profile) if with_profile
                                else None, "gavel", rslo,
                                RefSolveConfig(k=8), RefExecConfig())
        assert dataclasses.asdict(t.plan_initial(512)) == \
            dataclasses.asdict(r.plan_initial(512))
        moves = 0
        for _ in range(60):
            k = (t.solve_cfg or t.base_solve).k
            obs = (k, float(rng.choice([0.1, 0.9])),
                   float(rng.uniform(0.9, 1.0)))
            a, b = t.observe(*obs), r.observe(*obs)
            assert a.violation == b.violation
            assert (a.new_solve is None) == (b.new_solve is None)
            if a.new_solve is not None:
                moves += 1
                assert dataclasses.asdict(a.new_solve) == \
                    dataclasses.asdict(b.new_solve)
        assert moves > 0
        assert tonline.quality_loss_at_or_zero(profile, "gavel", 16) == \
            rtuning.online.quality_loss_at_or_zero(_ref_profile(profile),
                                                   "gavel", 16)

    def test_retune_session_matches(self):
        """The 96-job retune session in both packages: the same ks, plan
        cache verdicts and counters."""
        slo = SLOTarget(max_quality_loss=0.5, step_deadline_s=1e-4)
        rslo = rtuning.SLOTarget(max_quality_loss=0.5, step_deadline_s=1e-4)
        mine, sess = _retune_session(PopService, GavelInstance, ExecConfig,
                                     slo)
        ref, rsess = _retune_session(RefPopService, RefGavelInstance,
                                     RefExecConfig, rslo)
        assert [a.k for a in mine] == [a.k for a in ref]
        assert [a.plan_cache for a in mine] == [a.plan_cache for a in ref]
        assert max(a.k for a in mine) > mine[0].k
        for key in ("slo_violations", "retunes"):
            assert sess.stats[key] == rsess.stats[key]
