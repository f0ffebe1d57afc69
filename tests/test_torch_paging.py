"""The paging tier of the port (``PopService(max_resident=)``,
``repro_torch.checkpoint.paged``) and the deadline ladder's bounded rate
caches, on the CPU: the twins of ``tests/test_serve_dispatch.py``'s
paging and cache cases, held to the reference's counters on the same
traffic tenants (24 demands, k=3, ``max_iters=250``)."""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest

from repro_torch.checkpoint import CheckpointError, PagedSessionStore
from repro_torch.service import _BoundedLRU

from test_torch_faults import ALLOC_TOL, COUNTERS, KW, PORT, REF, traffic

PAGE_COUNTERS = ("resident_sessions", "paged_tenants", "n_sessions")


def _service(pkg, **kw):
    return pkg.service.PopService(**pkg.device, **kw)


def _open(pkg, svc, tenant, seed, **kw):
    return svc.session(tenant, traffic(pkg, seed=seed, **kw),
                       solve=pkg.SolveConfig(k=3),
                       exec=pkg.ExecConfig(solver_kw=KW))


class TestPaging:
    def test_eviction_and_transparent_warm_reentry(self):
        got = {}
        for pkg in (REF, PORT):
            svc = _service(pkg, max_resident=2)
            for s in range(5):
                _open(pkg, svc, f"t{s}", s).step(traffic(pkg, seed=s))
            st = svc.stats()
            assert st["resident_sessions"] <= 2
            assert st["paged_tenants"] == 3 and st["paged_bytes"] > 0
            assert st["n_sessions"] == 5
            # re-entry by name restores the evicted tenant's warm state: a
            # verbatim plan hit with a fully warm start
            a = svc.session("t0", domain="traffic").step(
                traffic(pkg, seed=0, scale=1.02))
            assert a.plan_cache == "hit" and a.warm_fraction == 1.0
            st = svc.stats()
            assert st["paged_in"] >= 1 and st["session_reentries"] >= 1
            assert st["page_restore_failures"] == 0
            got[pkg.name] = ({k: st[k] for k in COUNTERS + PAGE_COUNTERS},
                             svc.tenants(), np.asarray(a.alloc, float))
        (s_ref, t_ref, a_ref), (s_port, t_port, a_port) = \
            got["reference"], got["port"]
        assert s_port == s_ref and t_port == t_ref
        np.testing.assert_allclose(a_port, a_ref, atol=ALLOC_TOL)

    def test_stale_handle_step_reattaches_warm(self):
        svc = _service(PORT, max_resident=1)
        handles = {}
        for s in range(3):
            handles[s] = _open(PORT, svc, f"t{s}", s)
            handles[s].step(traffic(PORT, seed=s))
        # t0 and t1 are paged out and their handles stripped; a step on
        # the old handle reloads the blob instead of starting cold
        assert handles[0]._warm is None and handles[0].last is None
        a = handles[0].step(traffic(PORT, seed=0, scale=1.03))
        assert a.plan_cache == "hit" and a.warm_fraction == 1.0
        assert handles[0].steps == 2
        assert svc.stats()["n_sessions"] == 3

    def test_live_handle_drops_its_stale_blob(self):
        """A handle that still holds newer state than its blob keeps it
        and the blob is discarded."""
        svc = _service(PORT, max_resident=1)
        a = _open(PORT, svc, "a", 0)
        a.step(traffic(PORT, seed=0))
        _open(PORT, svc, "b", 1).step(traffic(PORT, seed=1))
        assert "a" in svc._pager
        a.seed(_open(PORT, _service(PORT), "x", 0).step(
            traffic(PORT, seed=0)).raw)
        a.step(traffic(PORT, seed=0, scale=1.01))
        assert "a" not in svc._pager
        assert svc.stats()["paged_in"] == 0

    def test_page_out_releases_the_iterates(self):
        """After a page-out neither the session object, its last
        allocation nor the service holds the tenant's solver result."""
        svc = _service(PORT, max_resident=1)
        a = _open(PORT, svc, "a", 0)
        res = a.step(traffic(PORT, seed=0)).raw
        ref = weakref.ref(res)
        del res
        gc.collect()
        assert ref() is not None              # the session holds it
        _open(PORT, svc, "b", 1)              # creating b evicts a
        gc.collect()
        assert ref() is None
        assert svc.stats()["paged_out"] == 1
        assert "a" not in svc._sessions and "a" in svc._pager

    def test_end_session_clears_both_tiers_memory_flat(self):
        svc = _service(PORT, max_resident=2)
        for s in range(4):
            _open(PORT, svc, f"warm{s}", s).step(traffic(PORT, seed=s))
        refs = []
        for i in range(1000):
            sess = svc.session(f"churn{i}", domain="traffic",
                               solve=PORT.SolveConfig(k=3),
                               exec=PORT.ExecConfig(solver_kw=KW))
            refs.append(weakref.ref(sess))
            del sess
            svc.end_session(f"churn{i}")
        for s in range(4):
            svc.end_session(f"warm{s}")
        gc.collect()
        assert not svc._sessions and not svc._lru
        assert len(svc._pager) == 0 and svc._pager.nbytes() == 0
        assert svc.stats()["n_sessions"] == 0
        alive = sum(r() is not None for r in refs)
        assert alive == 0, f"{alive} ended sessions still referenced"

    def test_corrupt_blob_degrades_to_cold_session(self):
        got = {}
        for pkg in (REF, PORT):
            svc = _service(pkg, max_resident=1)
            for s in range(2):
                _open(pkg, svc, f"t{s}", s).step(traffic(pkg, seed=s))
            assert "t0" in svc._pager
            blob = svc._pager.peek_packed("t0")
            svc._pager._blobs["t0"] = blob[:-8] + b"\x00" * 8
            sess = _open(pkg, svc, "t0", 0)
            a = sess.step(traffic(pkg, seed=0, scale=1.01))
            assert a.status == "ok" and a.plan_cache == "miss"
            st = svc.stats()
            assert st["page_restore_failures"] >= 1
            got[pkg.name] = {k: st[k] for k in COUNTERS + PAGE_COUNTERS}
        assert got["port"] == got["reference"]

    def test_checkpoint_folds_in_paged_tenants(self):
        """A paged tenant's blob is folded into a service checkpoint
        without paging it in; the restore is warm."""
        svc = _service(PORT, max_resident=1)
        for s in range(2):
            _open(PORT, svc, f"t{s}", s).step(traffic(PORT, seed=s))
        assert "t0" in svc._pager
        fresh = _service(PORT)
        report = fresh.restore(svc.checkpoint())
        assert report["restored"] == ["t0", "t1"]
        assert "t0" in svc._pager and svc.stats()["paged_in"] == 0
        a = fresh.session("t0").step(traffic(PORT, seed=0, scale=1.02))
        assert a.plan_cache == "hit" and a.warm_fraction == 1.0

    def test_step_override_sessions_stay_resident(self):
        """Opaque warm state cannot page out: evicting it would destroy
        it, so the cap is best-effort."""
        svc = _service(PORT, max_resident=1)
        lb = svc.session("lb", domain="load_balance")
        lb._warm, lb._mode = object(), "domain"
        _open(PORT, svc, "t", 0)
        assert set(svc._sessions) == {"lb", "t"}
        assert svc.stats()["paged_out"] == 0

    def test_concurrent_steps_under_a_cap(self):
        """More stepping threads than cores on a service that keeps two
        tenants resident: every step is served, no count is lost, and a
        tenant's steps stay ordered (session lock) while others page in
        and out around it."""
        svc = _service(PORT, max_resident=2)
        insts = {s: [traffic(PORT, seed=s, scale=1.0 + 0.01 * i)
                     for i in range(2)] for s in range(9)}
        handles = {s: _open(PORT, svc, f"t{s}", s) for s in insts}
        errors, steps = [], {s: [] for s in insts}

        def tenant(s):
            try:
                for inst in insts[s]:
                    steps[s].append(handles[s].step(inst))
            except Exception as e:          # reported below
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=tenant, args=(s,))
                       for s in insts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        st = svc.stats()
        assert st["steps"] == 18 and st["n_sessions"] == 9
        assert st["paged_out"] >= 7 and st["page_restore_failures"] == 0
        for s, got in steps.items():
            assert [a.step for a in got] == [0, 1]
            assert all(np.isfinite(a.alloc).all() for a in got)
            assert handles[s].steps == 2


class TestPagedStore:
    def test_put_take_peek_discard(self):
        store = PagedSessionStore()
        n = store.put("a", {"mode": "cold"}, {"t0/x": np.zeros(3)})
        assert n == len(store.peek_packed("a")) == store.nbytes()
        assert "a" in store and len(store) == 1 and store.tenants() == ("a",)
        meta, arrays = store.take("a")
        assert meta == {"mode": "cold"} and "a" not in store
        assert store.take("a") is None
        store.put("b", {}, {})
        assert store.discard("b") and not store.discard("b")

    def test_corrupt_blob_is_consumed(self):
        store = PagedSessionStore()
        store.put("a", {}, {"t0/x": np.ones(4)})
        store._blobs["a"] = store._blobs["a"][:-3]
        with pytest.raises(CheckpointError):
            store.take("a")
        assert "a" not in store


class TestBoundedRateCaches:
    def test_bounded_lru_unit(self):
        lru = _BoundedLRU(3)
        for i in range(5):
            lru[i] = i * 10
        assert len(lru) == 3 and lru.evictions == 2
        assert list(lru) == [2, 3, 4]
        assert lru.get(2) == 20                  # refreshes recency
        lru[5] = 50
        assert list(lru) == [4, 2, 5] and lru.evictions == 3
        assert lru.get(3) is None

    def test_service_rate_caches_bounded_and_reported(self):
        svc = _service(PORT, rate_cache_size=2)
        for s in range(4):
            sess = svc.session(f"t{s}", traffic(PORT, n=20 + s, seed=s),
                               solve=PORT.SolveConfig(k=3),
                               exec=PORT.ExecConfig(solver_kw=KW))
            sess.step(traffic(PORT, n=20 + s, seed=s))
        assert len(svc._rates) <= 2 and len(svc._overheads) <= 2
        st = svc.stats()
        assert st["rate_evictions"] >= 4
        assert st["rate_keys"] <= 4
