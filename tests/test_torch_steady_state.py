"""The port's runtime sanitizers (``repro_torch.analysis.runtime``) on the
CPU — the twins of ``tests/test_retrace_guard.py``: a steady-state
``PopSession.step()`` must run the map-step backends with ZERO builds and
no host sync beyond the loop's by-design chunk check and result readback.
The guards are unit-tested first (they must actually trip), then armed
over a 10-tick warm session including one churn repair, and over four
coalesced tenants of the serving dispatcher."""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.runtime import (ALLOWED_SYNC_SITES, HostSyncError,
                                          RetraceError, host_sync_tripwire,
                                          retrace_guard, steady_state_guard)
from repro_torch.core import ExecConfig, SolveConfig, backends, pdhg
from repro_torch.domains import GavelInstance
from repro_torch.kernels import build
from repro_torch.problems.cluster_scheduling import make_cluster_workload
from repro_torch.service import PopService

KW = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
LINTS = Path(__file__).resolve().parent.parent / "docs" / "LINTS_torch.md"

# every door the CPU tripwire patches, and a call through it
DOORS = {
    "item": lambda t: t.sum().item(),
    "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(),
    "cpu": lambda t: t.cpu(),
    "__bool__": lambda t: bool(t.sum()),
    "__float__": lambda t: float(t.sum()),
    "__int__": lambda t: int(t.sum()),
    "np.asarray": lambda t: np.asarray(t),
    "np.array": lambda t: np.array(t),
}


# ---------------------------------------------------------------------------
# the guards must trip (a sanitizer that can't fire proves nothing)
# ---------------------------------------------------------------------------

class TestGuardsTrip:
    def test_retrace_guard_counts_a_fresh_build(self):
        with pytest.raises(RetraceError, match="build"):
            with retrace_guard(max_retraces=0):
                pdhg.matvec_engine(lambda d, x: x, lambda d, y: y)

    def test_retrace_guard_budget_and_stats(self):
        with retrace_guard(max_retraces=1) as stats:
            pdhg.matvec_engine(lambda d, x: 2 * x, lambda d, y: 2 * y)
        assert stats.builds == 1
        assert stats.built_names == [
            "repro_torch.core.pdhg.matvec_engine"]

    def test_retrace_guard_silent_on_cached_call(self):
        K = lambda d, x: x + 1.0   # noqa: E731
        KT = lambda d, y: y + 1.0  # noqa: E731
        first = pdhg.matvec_engine(K, KT)          # built outside
        with retrace_guard(max_retraces=0) as stats:
            again = pdhg.matvec_engine(K, KT)      # cache hit
        assert again is first and stats.builds == 0

    def test_map_solver_cached_and_uncached_builds(self):
        """``make_map_solver`` on a new hashable key is one build, on the
        same key none; unhashable keywords build a fresh solver every
        call, each counted."""
        K = lambda d, x: x * 3.0   # noqa: E731
        with retrace_guard(max_retraces=3) as stats:
            a = backends.make_map_solver(K, K, {"max_iters": 7})
            b = backends.make_map_solver(K, K, {"max_iters": 7})
            backends.make_map_solver(K, K, {"probe": [1]})
            backends.make_map_solver(K, K, {"probe": [1]})
        assert a is b
        assert stats.builds == 3
        assert stats.built_names.count("uncached map solver") == 2

    def test_kernel_library_load_is_a_build(self, monkeypatch):
        monkeypatch.setattr(build, "_libs", dict(build._libs))
        with pytest.raises(RetraceError, match="kernel library load"):
            with retrace_guard(max_retraces=0):
                build._libs["structured_pdhg_step"] = object()

    @pytest.mark.parametrize("door", sorted(DOORS))
    def test_tripwire_denies_each_door(self, door):
        t = torch.ones(3)
        with pytest.raises(HostSyncError, match=re.escape(
                door if door.startswith("np.") else f"Tensor.{door}")):
            with host_sync_tripwire(mode="cpu") as stats:
                DOORS[door](t)
        assert stats.syncs_denied == 1 and stats.modes == {"cpu"}
        assert "test_torch_steady_state.py" in stats.denied_sites[0]

    @pytest.mark.parametrize("door", sorted(DOORS))
    def test_tripwire_passes_on_another_thread(self, door):
        """Arming is per thread: the armed thread waits inside its block
        while another thread goes through the same door."""
        t = torch.ones(3)
        out, errors = [], []

        def other():
            try:
                out.append(DOORS[door](t))
            except BaseException as e:     # reported below
                errors.append(e)

        with host_sync_tripwire(mode="cpu") as stats:
            th = threading.Thread(target=other)
            th.start()
            th.join()
        assert not errors and len(out) == 1
        assert stats.syncs_denied == 0

    def test_tripwire_allows_pure_host_numpy(self):
        with host_sync_tripwire(mode="cpu"):
            out = np.asarray([1.0, 2.0]) + np.array(3.0)
        assert out.shape == (2,)

    def test_tripwire_restores_patches(self):
        orig_asarray, orig_item = np.asarray, torch.Tensor.item
        had_bool = "__bool__" in torch.Tensor.__dict__
        with host_sync_tripwire(mode="cpu"):
            assert np.asarray is not orig_asarray
            assert torch.Tensor.item is not orig_item
        assert np.asarray is orig_asarray
        assert torch.Tensor.item is orig_item
        assert ("__bool__" in torch.Tensor.__dict__) == had_bool
        assert torch.ones(2).sum().item() == 2.0       # fine again

    def test_guard_fails_a_swallowed_denied_sync(self):
        """A denied sync inside a backend raises there; a caller that
        swallows it still fails the guard at its exit."""
        saved = dict(backends.MAP_BACKENDS)

        def leaky(batch, *args, **kw):
            return float(batch[0].c.sum())        # a sync of its own
        backends.MAP_BACKENDS["leaky"] = leaky
        try:
            with pytest.raises(HostSyncError, match="denied"):
                with steady_state_guard() as stats:
                    ops = pdhg.OperatorLP(
                        c=torch.ones(1, 2), q=torch.ones(1, 1),
                        l=torch.zeros(1, 2), u=torch.ones(1, 2),
                        ineq_mask=torch.ones(1, 1, dtype=torch.bool),
                        data=None)
                    try:
                        backends.MAP_BACKENDS["leaky"]((ops, None, None))
                    except HostSyncError:
                        pass
            assert stats.syncs_denied == 1
        finally:
            backends.MAP_BACKENDS.clear()
            backends.MAP_BACKENDS.update(saved)


# ---------------------------------------------------------------------------
# the acceptance claim: warm session ticks build nothing and sync only
# where the loop does by design
# ---------------------------------------------------------------------------

class TestSteadyStateSession:
    def test_ten_warm_ticks_zero_builds_zero_denied_syncs(self):
        svc = PopService(device="cpu")
        sess = svc.session("fleet", domain="gavel",
                           solve=SolveConfig(k=2, strategy="stratified"),
                           exec=ExecConfig(solver_kw=KW))
        ids = np.arange(32)

        # warm-up covers every step TYPE once, outside the guard: the
        # cold first solve, a plan hit, and one churn repair
        sess.step(GavelInstance(make_cluster_workload(32, seed=0),
                                job_ids=ids))
        sess.step(GavelInstance(make_cluster_workload(32, seed=1),
                                job_ids=ids))
        ids = np.concatenate([ids[4:], 100 + np.arange(4)])
        warm = sess.step(GavelInstance(make_cluster_workload(32, seed=2),
                                       job_ids=ids))
        assert warm.plan_cache == "repair"

        lane_max = []
        with steady_state_guard(max_retraces=0) as stats:
            for tick in range(3, 11):
                if tick == 7:
                    # a SECOND churn, inside the guard: 4 more jobs leave,
                    # 4 arrive — the plan repairs in place, builds nothing
                    ids = np.concatenate([ids[4:], 200 + np.arange(4)])
                wl = make_cluster_workload(32, seed=tick)
                a = sess.step(GavelInstance(wl, job_ids=ids))
                assert a.plan_cache == ("repair" if tick == 7 else "hit")
                assert a.k == 2
                lane_max.append(int(np.asarray(a.raw.iterations).max()))

        assert stats.builds == 0, stats.built_names
        assert stats.syncs_denied == 0, stats.denied_sites
        assert stats.hot_backend_calls >= 8
        # the by-design syncs were seen, and only those: one chunk check a
        # chunk plus the loop's exit test; ten fields read back a solve
        # (the CPU counts door calls: .cpu() and .numpy() each)
        assert stats.chunk_checks == sum(m // 40 + 1 for m in lane_max)
        assert stats.readbacks == 8 * 10 * 2
        assert stats.modes == {"cpu"}


class TestSteadyStateDispatcher:
    """The serving dispatcher's steady state: a coalesced multi-tenant
    step must build NOTHING and take no denied sync inside the map
    backends (which run on the dispatcher's worker thread)."""

    def test_coalesced_multi_tenant_step_is_clean(self):
        from repro_torch.problems.traffic_engineering import (
            TrafficProblem, k_shortest_paths, make_demands, make_topology)

        def traffic(seed, scale=1.0):
            topo = make_topology(20, 40, seed=seed)
            pairs, dem = make_demands(topo, 24, seed=seed)
            pe = k_shortest_paths(topo, pairs, n_paths=2, max_len=10,
                                  seed=seed)
            return TrafficProblem(topo, pairs, dem * scale, pe)

        svc = PopService(dispatch=True, device="cpu")
        seeds = range(4)
        sessions = {s: svc.session(f"t{s}", traffic(s),
                                   solve=SolveConfig(k=2),
                                   exec=ExecConfig(solver_kw=KW))
                    for s in seeds}
        try:
            def sweep(scale):
                # the hold gate makes the group deterministic: all four
                # tenants' tickets queue, then dispatch as ONE launch
                before = svc.dispatcher.stats()["requests"]
                with svc.dispatcher.hold():
                    futs = [sessions[s].step_async(traffic(s, scale))
                            for s in seeds]
                    t_end = time.monotonic() + 120
                    while (svc.dispatcher.stats()["requests"] - before < 4
                           and time.monotonic() < t_end):
                        time.sleep(0.01)
                    time.sleep(0.2)
                return [f.result(timeout=300) for f in futs]

            # warm-up outside the guard: the cold coalesced launch, then
            # the warm-started (plan hit) coalesced launch
            sweep(1.0)
            sweep(1.02)

            with steady_state_guard(max_retraces=0) as stats:
                for rnd in range(3):
                    allocs = sweep(1.04 + 0.02 * rnd)
                    assert all(a.status == "ok" for a in allocs)
                    assert all(a.plan_cache == "hit" for a in allocs)

            assert stats.builds == 0, stats.built_names
            assert stats.syncs_denied == 0, stats.denied_sites
            assert stats.hot_backend_calls >= 3
            assert stats.chunk_checks > 0 and stats.readbacks > 0
            d = svc.dispatcher.stats()
            assert d["coalesced_launches"] >= 5
            assert d["batching_ratio"] > 1.0
        finally:
            svc.close()


def test_allowed_sites_are_the_baselines_by_design_entries():
    """``runtime.ALLOWED_SYNC_SITES`` and the rows of docs/LINTS_torch.md's
    baseline table marked "by design" name the same (file, function)
    pairs: the tripwire lets through exactly what the static rule's
    baseline accepts by design."""
    by_design = set()
    for ln in LINTS.read_text().splitlines():
        m = re.match(r"\|\s*`` host-sync-in-hot-path::(\S+)::in (\w+):.*``"
                     r"\s*\|\s*yes\s*\|", ln)
        if m:
            by_design.add((m.group(1), m.group(2)))
    assert by_design == {(path, fn) for path, fn, _ in ALLOWED_SYNC_SITES}
    assert {kind for _, _, kind in ALLOWED_SYNC_SITES} == {"chunk_check",
                                                          "readback"}
