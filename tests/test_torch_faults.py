"""The chaos suite of ``tests/test_faults.py`` on the port
(``repro_torch.service``, ``repro_torch.analysis.faults``), on the CPU.

Every case the port's domains can run goes through both packages on the
same seeded traffic instance (24 demands, k=4, ``max_iters=250``) and must
come out the same: the ladder rung (``status``), the ``faults`` tuple, the
service's counters, the quarantine's ``warm_stats`` and, for equal
measured rates, the rung and capped ``solver_kw`` the deadline ladder
picks.  Allocations agree within 1e-3, the session standard of
``tests/test_torch_service.py``.  The greedy rung runs twice: on
``moe_placement`` with the domain's registered hook (the reference's own
case), and on a traffic session whose spec carries a test-local
``greedy=`` hook."""

import dataclasses
import time
import types

import numpy as np
import pytest

import repro.domains as ref_domains
import repro.service as ref_service
from repro.analysis import faults as ref_faults
from repro.core import ExecConfig as RefExecConfig
from repro.core import SolveConfig as RefSolveConfig
from repro.core import pop as ref_pop
from repro.domains import StepOutcome as RefStepOutcome
from repro.domains import get as ref_domain
from repro.problems import traffic_engineering as ref_te
import repro_torch.domains as port_domains
import repro_torch.service as port_service
from repro_torch.analysis import faults as port_faults
from repro_torch.core import pop as port_pop
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import StepOutcome
from repro_torch.domains import get as port_domain
from repro_torch.problems import traffic_engineering as port_te

KW = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
ALLOC_TOL = 1e-3

REF = types.SimpleNamespace(
    name="reference", service=ref_service, faults=ref_faults, pop=ref_pop,
    te=ref_te, SolveConfig=RefSolveConfig, ExecConfig=RefExecConfig,
    StepOutcome=RefStepOutcome, domain=ref_domain, domains=ref_domains,
    device={})
PORT = types.SimpleNamespace(
    name="port", service=port_service, faults=port_faults, pop=port_pop,
    te=port_te, SolveConfig=SolveConfig, ExecConfig=ExecConfig,
    StepOutcome=StepOutcome, domain=port_domain, domains=port_domains,
    device={"device": "cpu"})

# the service counters both packages keep
COUNTERS = ("steps", "plan_hits", "plan_repairs", "plan_misses",
            "full_solves", "warm_steps", "degraded_steps", "recovered_steps",
            "fallback_steps", "quarantined_lanes", "faults",
            "checkpoint_restores", "checkpoint_failures", "paged_out",
            "paged_in", "page_restore_failures", "session_reentries")
WARM_KEYS = ("quarantined_lanes", "lanes_cold", "warm_fraction")


def traffic(pkg, n=24, seed=0, scale=1.0):
    topo = pkg.te.make_topology(20, 40, seed=seed)
    pairs, dem = pkg.te.make_demands(topo, n, seed=seed)
    pe = pkg.te.k_shortest_paths(topo, pairs, n_paths=2, max_len=10,
                                 seed=seed)
    return pkg.te.TrafficProblem(topo, pairs, dem * scale, pe)


def service(pkg, k=4, **kw):
    return pkg.service.PopService(solve=pkg.SolveConfig(k=k),
                                  exec=pkg.ExecConfig(solver_kw=KW),
                                  **pkg.device, **kw)


def warmed(pkg, svc, tenant="t", steps=2):
    inst = traffic(pkg)
    sess = svc.session(tenant, inst)
    sess.step(inst)
    for i in range(1, steps):
        sess.step(traffic(pkg, scale=1.0 + 0.1 * i))
    return sess


def summary(alloc, svc) -> dict:
    """What must agree across the packages about one step."""
    ws = getattr(alloc.raw, "warm_stats", None) or {}
    stats = svc.stats()
    return dict(status=alloc.status, faults=alloc.faults,
                plan_cache=alloc.plan_cache, k=alloc.k,
                warm={key: ws.get(key) for key in WARM_KEYS},
                stats={key: stats[key] for key in COUNTERS},
                fallback_source=alloc.metrics.get("fallback_source"),
                alloc=np.asarray(alloc.alloc, float))


def assert_same(ref: dict, port: dict) -> None:
    ref, port = dict(ref), dict(port)
    ra, pa = ref.pop("alloc"), port.pop("alloc")
    assert port == ref
    assert pa.shape == ra.shape and np.isfinite(pa).all()
    np.testing.assert_allclose(pa, ra, atol=ALLOC_TOL)


def both(scenario):
    """Run ``scenario(pkg)`` through each package; hold the port's summary
    to the reference's and return it."""
    ref, port = scenario(REF), scenario(PORT)
    assert_same(ref, port)
    return port


# ---------------------------------------------------------------------------
# divergence quarantine
# ---------------------------------------------------------------------------

def _poisoned(lanes):
    def scenario(pkg):
        svc = service(pkg)
        sess = warmed(pkg, svc)
        pkg.faults.poison_warm(sess, lanes=lanes)
        return summary(sess.step(traffic(pkg, scale=1.3)), svc)
    return scenario


class TestDivergenceQuarantine:
    def test_poisoned_lane_recovers(self):
        s = both(_poisoned([1]))
        assert s["status"] == "recovered"
        assert s["faults"] == ("divergence:1",)
        assert s["stats"]["recovered_steps"] == 1
        assert s["stats"]["quarantined_lanes"] == 1
        assert s["stats"]["faults"] == 1

    def test_healthy_lanes_keep_iterates(self):
        s = both(_poisoned([0]))
        # the retry kept the plan and the surviving lanes' iterates
        assert s["warm"] == {"quarantined_lanes": 1, "lanes_cold": 1,
                             "warm_fraction": 0.75}

    def test_next_step_is_clean(self):
        def scenario(pkg):
            svc = service(pkg)
            sess = warmed(pkg, svc)
            pkg.faults.poison_warm(sess, lanes=[1])
            sess.step(traffic(pkg, scale=1.3))
            return summary(sess.step(traffic(pkg, scale=1.35)), svc)
        s = both(scenario)
        assert s["status"] == "ok" and s["faults"] == ()
        assert s["plan_cache"] == "hit"

    def test_all_lanes_poisoned_still_finite(self):
        s = both(_poisoned(list(range(4))))
        assert s["status"] == "recovered"
        assert s["faults"] == ("divergence:4",)
        assert s["warm"]["warm_fraction"] == 0.0

    def test_poison_keeps_the_previous_result(self):
        """The injector replaces the warm iterates; the previous step's
        result keeps its own."""
        svc = service(PORT)
        sess = warmed(PORT, svc)
        before = sess.last.raw.x
        kept = np.array(before)
        port_faults.poison_warm(sess, lanes=[2])
        assert sess._warm.x is not before
        np.testing.assert_array_equal(before, kept)
        assert np.isnan(np.asarray(sess._warm.x)[2]).all()

    def test_full_path_quarantine(self):
        """k=1 has a single lane: a diverged warm start is a full cold
        restart (``divergence:1``)."""
        def scenario(pkg):
            svc = service(pkg, k=1)
            sess = warmed(pkg, svc)
            w = sess._warm
            sess._warm = w._replace(x=np.full(np.shape(w.x), np.nan,
                                              np.float32))
            return summary(sess.step(traffic(pkg, scale=1.3)), svc)
        s = both(scenario)
        assert s["status"] == "recovered" and s["plan_cache"] == "full"
        assert s["faults"] == ("divergence:1",)
        assert s["stats"]["quarantined_lanes"] == 1


class TestColdLanes:
    """``pop.solve_instance(cold_lanes=)``, the quarantine retry's door."""

    def _prev(self, pkg):
        svc = service(pkg)
        return warmed(pkg, svc)._warm

    @pytest.mark.parametrize("source", ["reused", "provided"])
    def test_mask_and_warm_stats_match_reference(self, source):
        def scenario(pkg):
            prev = self._prev(pkg)
            kw = {} if source == "reused" else {"plan": prev.plan}
            res = pkg.pop.solve_instance(
                traffic(pkg, scale=1.3), pkg.SolveConfig(k=4),
                pkg.ExecConfig(solver_kw=KW), warm=prev,
                cold_lanes=np.array([False, True, False, True]),
                **pkg.device, **kw)
            return res.warm_stats, np.asarray(res.alloc, float)
        (ws_ref, a_ref), (ws_port, a_port) = scenario(REF), scenario(PORT)
        assert ws_port == ws_ref
        assert ws_port["quarantined_lanes"] == 2
        assert ws_port["lanes_cold"] == 2
        assert ws_port["warm_fraction"] == 0.5
        assert ws_port["identity"] is False
        np.testing.assert_allclose(a_port, a_ref, atol=ALLOC_TOL)

    def test_wrong_length_raises(self):
        prev = self._prev(PORT)
        with pytest.raises(ValueError, match="cold_lanes has 3 entries"):
            port_pop.solve_instance(
                traffic(PORT), SolveConfig(k=4), ExecConfig(solver_kw=KW),
                warm=prev, cold_lanes=np.zeros(3, bool), device="cpu")

    def test_cold_lanes_start_cold(self):
        """A cold lane's solve equals the cold solve's lane: the mask
        reaches the solver."""
        prev = self._prev(PORT)
        inst = traffic(PORT, scale=1.3)
        cold = port_pop.solve_instance(inst, SolveConfig(k=4),
                                       ExecConfig(solver_kw=KW),
                                       plan=prev.plan, device="cpu")
        mixed = port_pop.solve_instance(
            inst, SolveConfig(k=4), ExecConfig(solver_kw=KW), warm=prev,
            plan=prev.plan, cold_lanes=np.array([True, False, False, False]),
            device="cpu")
        np.testing.assert_array_equal(mixed.x[0], cold.x[0])
        assert mixed.iterations[0] == cold.iterations[0]


class TestWarmStateDamage:
    @pytest.mark.parametrize("injector", ["drop-warm-plan", "mismatch-warm"])
    def test_damage_flags_mismatch(self, injector):
        def scenario(pkg):
            svc = service(pkg)
            sess = warmed(pkg, svc)
            pkg.faults.FAULTS[injector](sess)
            return summary(sess.step(traffic(pkg, scale=1.3)), svc)
        s = both(scenario)
        assert s["status"] == "recovered"
        assert s["faults"] == ("warm-state-mismatch",)
        assert s["plan_cache"] == "miss"

    def test_injectors_demand_warm_state(self):
        svc = service(PORT)
        sess = svc.session("cold", domain="traffic")
        for injector in (port_faults.poison_warm, port_faults.drop_warm_plan,
                         port_faults.mismatch_warm):
            with pytest.raises(ValueError, match="warm state"):
                injector(sess)
        with pytest.raises(ValueError, match="no measured rates"):
            port_faults.inflate_rates(svc)

    def test_injectors_on_device_tensors(self):
        """Restored warm state holds torch tensors: the injectors keep
        them tensors on their device."""
        import torch
        svc = service(PORT)
        sess = warmed(PORT, svc)
        fresh = service(PORT)
        fresh.restore(svc.checkpoint())
        restored = fresh.session("t", domain="traffic")
        x = restored._warm.x
        assert isinstance(x, torch.Tensor)
        port_faults.poison_warm(restored, lanes=[1])
        assert isinstance(restored._warm.x, torch.Tensor)
        assert torch.isnan(restored._warm.x[1]).all()
        assert not torch.isnan(x).any()
        port_faults.mismatch_warm(restored, extra_cols=2)
        assert restored._warm.x.shape == (x.shape[0], x.shape[1] + 2)
        alloc = restored.step(traffic(PORT, scale=1.2))
        assert alloc.faults == ("warm-state-mismatch",)
        assert sess.step(traffic(PORT, scale=1.2)).status == "ok"


# ---------------------------------------------------------------------------
# deadline ladder
# ---------------------------------------------------------------------------

def _pop_key(sess, k=4, n=24):
    return ("pop", sess.spec.name, sess.exec_cfg, k, n)


class TestDeadlineLadder:
    def test_unmeasured_rate_runs_full(self):
        def scenario(pkg):
            svc = service(pkg)
            inst = traffic(pkg)
            sess = svc.session("t", inst)
            return summary(sess.step(inst, deadline_s=0.001), svc)
        s = both(scenario)
        assert s["status"] == "ok" and s["faults"] == ()

    def test_inflated_rate_falls_back_within_deadline(self):
        deadline = 0.5
        walls = {}

        def scenario(pkg):
            svc = service(pkg)
            sess = warmed(pkg, svc)
            pkg.faults.inflate_rates(svc, factor=1e6)
            t0 = time.perf_counter()
            alloc = sess.step(traffic(pkg, scale=1.3), deadline_s=deadline)
            walls[pkg.name] = time.perf_counter() - t0
            np.testing.assert_array_equal(alloc.alloc,
                                          np.asarray(sess.last.alloc))
            return summary(alloc, svc)
        s = both(scenario)
        assert s["status"] == "fallback" and s["faults"] == ("deadline",)
        assert s["fallback_source"] == "previous-allocation"
        assert s["stats"]["fallback_steps"] == 1
        assert walls["port"] < 2 * deadline

    def test_tight_budget_degrades(self):
        def scenario(pkg):
            svc = service(pkg)
            sess = warmed(pkg, svc)
            key = next(k for k in svc._rates if k[0] == "pop")
            svc._rates[key] = 2e-5
            svc._overheads[key] = 0.0
            # the ladder budgets the deadline less the host time since the
            # step began: with 2 ms at 2e-5 s an iteration, 1.2 ms of it
            # (a loaded host) would leave less than one chunk and take the
            # fallback rung.  Re-reading the step's start at the ladder
            # pins that time near zero, so the budget is 100 iterations.
            ladder = sess._ladder
            sess._ladder = lambda rkey, deadline_s, t0: ladder(
                rkey, deadline_s, time.perf_counter())
            alloc = sess.step(traffic(pkg, scale=1.3), deadline_s=0.002)
            assert alloc.status == "degraded"
            assert len(alloc.faults) == 1
            assert alloc.faults[0] in ("deadline:capped",
                                       "deadline:best-effort")
            assert np.isfinite(np.asarray(alloc.alloc, float)).all()
            assert svc.stats()["degraded_steps"] == 1
            return alloc.raw.iterations
        for pkg in (REF, PORT):
            # the cap (80 iterations) bounds every lane
            assert int(np.max(scenario(pkg))) <= 80

    def test_loose_deadline_is_clean(self):
        def scenario(pkg):
            svc = service(pkg)
            sess = warmed(pkg, svc)
            return summary(sess.step(traffic(pkg, scale=1.3),
                                     deadline_s=100.0), svc)
        s = both(scenario)
        assert s["status"] == "ok" and s["faults"] == ()

    @pytest.mark.parametrize("deadline,rung,max_iters", [
        (0.3, None, 250), (0.2, "capped", 160), (0.06, "best-effort", 40),
        (0.02, "fallback", None)])
    def test_equal_rates_pick_equal_rungs(self, deadline, rung, max_iters):
        """A measured 1 ms per iteration and no overhead: both packages'
        ladders quantize the budget to the same rung and ``solver_kw``."""
        got = {}
        for pkg in (REF, PORT):
            svc = service(pkg)
            sess = warmed(pkg, svc, steps=1)
            key = _pop_key(sess)
            assert key in svc._rates
            svc._rates[key] = 1e-3
            svc._overheads[key] = 0.0
            exec_run, r = sess._ladder(key, deadline, time.perf_counter())
            got[pkg.name] = (r, None if exec_run is None
                             else exec_run.solver_dict())
        assert got["port"] == got["reference"]
        r, kw = got["port"]
        assert r == rung
        if rung is None:
            assert kw == KW
        elif rung != "fallback":
            assert kw == dict(max_iters=max_iters, tol_primal=1e-3,
                              tol_gap=1e-3)

    def test_overhead_counts_against_the_budget(self):
        svc = service(PORT)
        sess = warmed(PORT, svc, steps=1)
        key = _pop_key(sess)
        svc._rates[key] = 1e-3
        svc._overheads[key] = 0.15
        _, rung = sess._ladder(key, 0.2, time.perf_counter())
        assert rung == "best-effort"     # 50 ms left: one chunk

    def test_rates_learn_from_steps(self):
        """Every clean step folds its measured rate and overhead into the
        service's EMA; a fallback step measures nothing."""
        svc = service(PORT)
        sess = warmed(PORT, svc, steps=1)
        key = _pop_key(sess)
        first = sess.last
        rate = first.solve_time_s / int(np.max(first.raw.iterations))
        assert svc._rates[key] == pytest.approx(rate)
        assert 0.0 <= svc._overheads[key]
        second = sess.step(traffic(PORT, scale=1.1))
        rate2 = second.solve_time_s / int(np.max(second.raw.iterations))
        assert svc._rates[key] == pytest.approx(0.5 * rate + 0.5 * rate2)
        port_faults.inflate_rates(svc, factor=1e6)
        inflated = svc._rates[key]
        assert sess.step(traffic(PORT), deadline_s=0.5).status == "fallback"
        assert svc._rates[key] == inflated

    def test_fallback_without_history_uses_greedy(self):
        """Rates are service-level: a fresh tenant of the same (domain,
        config, shape) inherits them, so its first deadline-bound step can
        land on the last rung — the domain's greedy hook."""
        def scenario(pkg):
            svc = service(pkg)
            warm = warmed(pkg, svc, tenant="a", steps=1)
            pkg.faults.inflate_rates(svc, factor=1e6)
            fresh = svc.session("b", domain="traffic")
            zeros = np.zeros_like(np.asarray(warm.last.alloc, float))
            fresh.spec = dataclasses.replace(fresh.spec,
                                             greedy=lambda inst: zeros)
            return summary(fresh.step(traffic(pkg, scale=1.3),
                                      deadline_s=0.5), svc)
        s = both(scenario)
        assert s["status"] == "fallback"
        assert s["fallback_source"] == "greedy"
        assert not s["alloc"].any()

    def test_fallback_without_history_uses_moe_greedy(self):
        """The reference's own case on ``moe_placement``: the fresh
        tenant's fallback comes from the domain's registered ``greedy``
        hook (``greedy_placement``), in both packages."""
        def scenario(pkg):
            svc = service(pkg)
            inst = pkg.domains.make_placement_instance(32, 8, seed=0)
            svc.session("a", inst).step(inst)
            pkg.faults.inflate_rates(svc, factor=1e6)
            fresh = svc.session("b", domain="moe_placement")
            alloc = fresh.step(inst, deadline_s=0.5)
            np.testing.assert_array_equal(
                np.asarray(alloc.alloc),
                pkg.domains.greedy_placement(inst))
            return summary(alloc, svc)
        s = both(scenario)
        assert s["status"] == "fallback" and s["faults"] == ("deadline",)
        assert s["fallback_source"] == "greedy"
        assert s["stats"]["fallback_steps"] == 1

    def test_no_history_no_greedy_raises(self):
        for pkg in (REF, PORT):
            svc = service(pkg)
            warmed(pkg, svc, tenant="a")
            pkg.faults.inflate_rates(svc, factor=1e6)
            fresh = svc.session("b", domain="traffic")
            with pytest.raises(RuntimeError, match="no previous allocation"):
                fresh.step(traffic(pkg, scale=1.3), deadline_s=0.5)


# ---------------------------------------------------------------------------
# step_override domains: deadline skip, warm-then-cold retry, fallback
# ---------------------------------------------------------------------------

def _toy_session(pkg, behaviour: dict):
    """A session of a test-local ``step_override`` domain whose outcome the
    test steers: ``behaviour["nan"]`` in ("never", "warm", "always"),
    ``behaviour["sleep"]`` seconds per call."""
    def step(inst, solve_cfg, exec_cfg, warm, **kw):
        time.sleep(behaviour.get("sleep", 0.0))
        bad = (behaviour["nan"] == "always"
               or (behaviour["nan"] == "warm" and warm is not None))
        alloc = np.full(4, np.nan if bad else float(inst))
        return pkg.StepOutcome(alloc=alloc, metrics={"value": float(inst)},
                               warm_state=("state", inst))
    spec = dataclasses.replace(pkg.domain("load_balance"), name="toy",
                               step_override=step)
    svc = pkg.service.PopService(**pkg.device)
    return svc, pkg.service.PopSession(svc, "toy", spec, pkg.SolveConfig(),
                                       pkg.ExecConfig())


def _toy_summary(alloc, svc):
    return summary(alloc, svc) | {"warm": None}


class TestStepOverride:
    def test_broken_warm_attempt_retries_cold(self):
        def scenario(pkg):
            behaviour = {"nan": "never"}
            svc, sess = _toy_session(pkg, behaviour)
            sess.step(1.0)
            behaviour["nan"] = "warm"
            out = _toy_summary(sess.step(2.0), svc)
            assert sess._warm == ("state", 2.0)
            return out
        s = both(scenario)
        assert s["status"] == "recovered"
        assert s["faults"] == ("nonfinite-alloc", "warm-quarantined")
        assert (s["alloc"] == 2.0).all()

    def test_every_attempt_broken_falls_back(self):
        def scenario(pkg):
            behaviour = {"nan": "never"}
            svc, sess = _toy_session(pkg, behaviour)
            sess.step(1.0)
            behaviour["nan"] = "always"
            out = _toy_summary(sess.step(2.0), svc)
            assert sess._warm is None
            return out
        s = both(scenario)
        assert s["status"] == "fallback"
        assert s["faults"] == ("nonfinite-alloc", "nonfinite-alloc")
        assert s["fallback_source"] == "previous-allocation"
        assert (s["alloc"] == 1.0).all()

    def test_slow_last_step_skips_the_solve(self):
        def scenario(pkg):
            behaviour = {"nan": "never", "sleep": 0.05}
            svc, sess = _toy_session(pkg, behaviour)
            sess.step(1.0)
            return _toy_summary(sess.step(2.0, deadline_s=0.01), svc)
        s = both(scenario)
        assert s["status"] == "fallback" and s["faults"] == ("deadline",)
        assert (s["alloc"] == 1.0).all()


# ---------------------------------------------------------------------------
# input validation at the solve boundary
# ---------------------------------------------------------------------------

def _bad_traffic(pkg, fill):
    inst = traffic(pkg)
    demand = fill(inst.demand)
    return pkg.te.TrafficProblem(inst.topo, inst.pairs, demand,
                                 inst.path_edges)


class TestNonFiniteRejection:
    def test_solve_instance_rejects_nan_demand(self):
        bad = _bad_traffic(PORT, lambda d: np.where(np.arange(len(d)) == 3,
                                                    np.nan, d))
        with pytest.raises(ValueError, match="non-finite instance data"):
            port_pop.solve_instance(bad, SolveConfig(k=4),
                                    ExecConfig(solver_kw=KW), device="cpu")

    def test_solve_full_ex_rejects_inf_demand(self):
        bad = _bad_traffic(PORT, lambda d: np.where(np.arange(len(d)) == 3,
                                                    np.inf, d))
        with pytest.raises(ValueError, match="non-finite instance data"):
            port_pop.solve_full_ex(bad, exec_cfg=ExecConfig(solver_kw=KW),
                                   device="cpu")

    def test_error_names_the_field(self):
        bad = _bad_traffic(PORT, lambda d: np.full_like(d, np.nan))
        with pytest.raises(ValueError, match="field"):
            port_pop.solve_instance(bad, SolveConfig(k=4),
                                    ExecConfig(solver_kw=KW), device="cpu")

    def test_cold_bad_instance_raises_through_step(self):
        """A cold solve's error is the instance's: it is raised, not
        served around."""
        svc = service(PORT)
        bad = _bad_traffic(PORT, lambda d: np.full_like(d, np.nan))
        with pytest.raises(ValueError, match="non-finite instance data"):
            svc.session("t", bad).step(bad)


# ---------------------------------------------------------------------------
# seed() validation (warm-state type vs mode)
# ---------------------------------------------------------------------------

class TestSeedValidation:
    def test_unknown_mode_rejected(self):
        sess = service(PORT).session("t", domain="traffic")
        with pytest.raises(ValueError, match="unknown mode"):
            sess.seed(object(), mode="warm")

    def test_pop_mode_needs_popresult(self):
        sess = warmed(PORT, service(PORT))
        full = port_pop.solve_full_ex(traffic(PORT),
                                      exec_cfg=ExecConfig(solver_kw=KW),
                                      device="cpu")
        with pytest.raises(TypeError, match="needs a POPResult"):
            sess.seed(full, mode="pop")

    def test_full_mode_needs_solveresult(self):
        sess = warmed(PORT, service(PORT))
        with pytest.raises(TypeError, match="FullResult or SolveResult"):
            sess.seed(sess._warm, mode="full")

    def test_pop_mode_needs_iterates(self):
        sess = warmed(PORT, service(PORT))
        hollow = dataclasses.replace(sess._warm, x=None, y=None)
        with pytest.raises(ValueError, match="no solver"):
            sess.seed(hollow, mode="pop")

    def test_seeded_state_warm_starts(self):
        """A hand-carried POPResult seeds a fresh session: its next step
        is a plan hit, and a FullResult seeds the k=1 path by count."""
        src = warmed(PORT, service(PORT))
        sess = service(PORT).session("t", domain="traffic").seed(src._warm)
        assert sess._mode == "pop"
        a = sess.step(traffic(PORT, scale=1.2))
        assert a.plan_cache == "hit" and a.warm_fraction == 1.0
        full = port_pop.solve_full_ex(traffic(PORT),
                                      exec_cfg=ExecConfig(solver_kw=KW),
                                      device="cpu")
        k1 = service(PORT, k=1).session("f", domain="traffic")
        k1.seed(full, entity_ids=24)
        assert k1._mode == "full" and k1._full_ids == ("pos", 24)
        assert k1.step(traffic(PORT, scale=1.1)).warm_fraction == 1.0
        assert k1.seed(None)._warm is None


# ---------------------------------------------------------------------------
# the whole table, one sweep: no fault class crashes or emits non-finite data
# ---------------------------------------------------------------------------

class TestChaosSweep:
    @pytest.mark.parametrize("name", ["poison-warm", "drop-warm-plan",
                                      "mismatch-warm", "inflate-rates"])
    def test_session_faults_never_crash(self, name):
        def scenario(pkg):
            svc = service(pkg)
            sess = warmed(pkg, svc)
            if name == "inflate-rates":
                pkg.faults.FAULTS[name](svc, 1e6)
                alloc = sess.step(traffic(pkg, scale=1.3), deadline_s=0.5)
            else:
                pkg.faults.FAULTS[name](sess)
                alloc = sess.step(traffic(pkg, scale=1.3))
            return summary(alloc, svc)
        s = both(scenario)
        assert s["status"] == ("fallback" if name == "inflate-rates"
                               else "recovered")
        assert s["faults"]
        assert s["stats"]["faults"] >= 1
        assert s["stats"]["recovered_steps"] + s["stats"]["fallback_steps"] \
            == 1

    @pytest.mark.parametrize("name", ["truncate-checkpoint",
                                      "corrupt-checkpoint"])
    def test_checkpoint_faults_degrade_to_cold(self, name):
        def scenario(pkg):
            svc = service(pkg)
            warmed(pkg, svc)
            damaged = pkg.faults.FAULTS[name](svc.checkpoint())
            fresh = service(pkg)
            report = fresh.restore(damaged)
            assert report["restored"] == [] and report["errors"]
            assert fresh.stats()["checkpoint_failures"] == 1
            # the service still serves — cold
            sess = fresh.session("t", domain="traffic")
            return summary(sess.step(traffic(pkg)), fresh)
        s = both(scenario)
        assert s["status"] == "ok" and s["plan_cache"] == "miss"
        assert s["stats"]["checkpoint_failures"] == 1

    def test_fault_table_matches_reference(self):
        assert sorted(port_faults.FAULTS) == sorted(ref_faults.FAULTS)
        assert port_faults.__all__ == ref_faults.__all__
        blob = bytes(range(256)) * 4
        for name in ("truncate-checkpoint", "corrupt-checkpoint"):
            assert port_faults.FAULTS[name](blob) \
                == ref_faults.FAULTS[name](blob)
        with pytest.raises(ValueError, match="empty checkpoint blob"):
            port_faults.corrupt_checkpoint(b"")
