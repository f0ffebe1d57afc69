"""Session checkpoints on the port (``repro_torch.checkpoint``,
``PopService.checkpoint``/``restore``), on the CPU: the twins of
``tests/test_session_checkpoint.py`` — byte-format integrity, service
round trips, degrade-to-cold on damage, a restore in a fresh process —
and the cross-package contract: a blob written by either package restores
warm in the other, and equal configs give equal digests in both.

``tests/fixtures/session/`` holds two blobs the reference wrote (the
two-step traffic session below, k=4 and k=1), which the CUDA tests restore
onto the card where no JAX is installed; ``python
tests/test_torch_session_checkpoint.py`` writes them anew, and
``test_reference_fixtures_are_current`` holds them to what the reference
writes today."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _subproc import repro_env
from repro.checkpoint import config_digest as ref_digest
from repro.checkpoint import pack_state as ref_pack
from repro.checkpoint import unpack_state as ref_unpack
from repro.core import ExecConfig as RefExecConfig
from repro.core import SolveConfig as RefSolveConfig
from repro_torch.checkpoint import (CheckpointError, config_digest,
                                    pack_state, unpack_state)
from repro_torch.checkpoint import session_state
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.service import PopService

from test_torch_faults import ALLOC_TOL, KW, PORT, REF, service, traffic

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "session"


def fixture_path(k: int) -> Path:
    return FIXTURES / f"reference_traffic24_k{k}.popses"


# ---------------------------------------------------------------------------
# the byte format
# ---------------------------------------------------------------------------


class TestByteFormat:
    def test_round_trip(self):
        meta = {"tenants": {"a": {"mode": "pop", "steps": 3}}}
        arrays = {"t0/x": np.arange(12.0).reshape(3, 4),
                  "t0/idx": np.arange(6).reshape(2, 3)}
        m2, a2 = unpack_state(pack_state(meta, arrays))
        assert m2 == meta
        for k in arrays:
            np.testing.assert_array_equal(a2[k], arrays[k])

    def test_not_bytes(self):
        with pytest.raises(CheckpointError, match="must be bytes"):
            unpack_state("not bytes")

    def test_bad_magic(self):
        blob = pack_state({}, {})
        with pytest.raises(CheckpointError, match="magic"):
            unpack_state(b"NOTMAGIC" + blob[8:])

    def test_truncated_header(self):
        with pytest.raises(CheckpointError, match="truncated"):
            unpack_state(pack_state({}, {})[:10])

    def test_truncated_payload(self):
        blob = pack_state({}, {"t0/x": np.zeros(8)})
        with pytest.raises(CheckpointError, match="truncated"):
            unpack_state(blob[:-20])

    def test_flipped_payload_byte(self):
        bad = bytearray(pack_state({}, {"t0/x": np.zeros(8)}))
        bad[-5] ^= 0xFF
        with pytest.raises(CheckpointError, match="hash mismatch"):
            unpack_state(bytes(bad))

    def test_version_pinned(self):
        tampered = pack_state({}, {}).replace(b'"version": 1',
                                              b'"version": 9')
        with pytest.raises(CheckpointError, match="version"):
            unpack_state(tampered)

    def test_undecodable_manifest(self):
        blob = pack_state({}, {})
        bad = blob[:16] + b"\xff" + blob[17:]
        with pytest.raises(CheckpointError, match="undecodable"):
            unpack_state(bad)

    def test_checkpoint_error_is_a_value_error(self):
        assert issubclass(CheckpointError, ValueError)
        assert session_state.MAGIC == b"POPSES1\n"
        assert session_state.VERSION == 1

    def test_config_digest_tracks_configs(self):
        a = config_digest(SolveConfig(k=4), ExecConfig(solver_kw=KW))
        b = config_digest(SolveConfig(k=4), ExecConfig(solver_kw=KW))
        c = config_digest(SolveConfig(k=8), ExecConfig(solver_kw=KW))
        assert a == b != c


CONFIGS = {
    "defaults": (dict(), dict()),
    "traffic-k4": (dict(k=4), dict(solver_kw=KW)),
    "gavel": (dict(k=8, strategy="stratified", min_per_sub=8),
              dict(solver_kw=dict(max_iters=20_000, tol_primal=1e-4,
                                  tol_gap=1e-4, equilibrate=True))),
    "replicated": (dict(k=2, strategy="stratified", seed=3,
                        replicate_threshold=0.5),
                   dict(backend="vmap", engine="fused_structured",
                        backend_opts={"chunk": 4})),
}


class TestCrossPackageFormat:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_config_digest_equal_across_packages(self, name):
        solve, exe = CONFIGS[name]
        assert config_digest(SolveConfig(**solve), ExecConfig(**exe)) \
            == ref_digest(RefSolveConfig(**solve), RefExecConfig(**exe))

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_codec_reads_the_other_package(self, writer):
        meta = {"tenants": {"a": {"mode": "pop", "steps": 2}}}
        arrays = {"t0/x": np.linspace(0, 1, 12, dtype=np.float32)
                  .reshape(3, 4), "t0/ids": np.arange(5, dtype=np.int64)}
        pack, unpack = ((ref_pack, unpack_state) if writer == "reference"
                        else (pack_state, ref_unpack))
        m2, a2 = unpack(pack(meta, arrays))
        assert m2 == meta
        for k, v in arrays.items():
            assert a2[k].dtype == v.dtype
            np.testing.assert_array_equal(a2[k], v)


# ---------------------------------------------------------------------------
# service round trips
# ---------------------------------------------------------------------------

def _stepped(pkg, k=4, tenant="a", seed=0, steps=2):
    svc = service(pkg, k=k)
    inst = traffic(pkg, seed=seed)
    sess = svc.session(tenant, inst)
    sess.step(inst)
    for i in range(1, steps):
        sess.step(traffic(pkg, seed=seed, scale=1.0 + 0.1 * i))
    return svc, sess


class TestServiceRoundTrip:
    def test_pop_path_restores_warm(self):
        svc, sess = _stepped(PORT)
        fresh = service(PORT)
        report = fresh.restore(svc.checkpoint())
        assert report == {"restored": ["a"], "cold": [], "errors": {}}
        assert fresh.stats()["checkpoint_restores"] == 1
        restored = fresh.session("a", domain="traffic")
        assert restored.steps == sess.steps
        # the iterates come back as float32 tensors on the service's device
        for it in (restored._warm.x, restored._warm.y):
            assert isinstance(it, torch.Tensor)
            assert it.dtype == torch.float32 and it.device == fresh.device
        nxt = traffic(PORT, scale=1.2)
        a_fresh = restored.step(nxt)
        a_cont = sess.step(nxt)
        assert a_fresh.warm_fraction == 1.0 and a_fresh.plan_cache == "hit"
        np.testing.assert_allclose(a_fresh.alloc, a_cont.alloc)
        np.testing.assert_array_equal(a_fresh.raw.iterations,
                                      a_cont.raw.iterations)

    def test_full_path_restores_warm(self):
        svc, _ = _stepped(PORT, k=1, steps=1)
        fresh = service(PORT, k=1)
        assert fresh.restore(svc.checkpoint())["restored"] == ["a"]
        sess = fresh.session("a", domain="traffic")
        assert isinstance(sess._warm.x, torch.Tensor)
        alloc = sess.step(traffic(PORT, scale=1.05))
        assert alloc.warm_fraction == 1.0 and alloc.plan_cache == "full"

    def test_cold_session_round_trips(self):
        svc = service(PORT)
        svc.session("idle", domain="traffic")
        report = service(PORT).restore(svc.checkpoint())
        assert report["cold"] == ["idle"] and not report["errors"]

    def test_step_override_state_is_skipped(self):
        svc = PopService(device="cpu")
        svc.session("lb", domain="load_balance")._mode = "domain"
        meta, arrays = unpack_state(svc.checkpoint())
        assert meta["tenants"]["lb"]["mode"] == "skipped" and not arrays

    def test_multi_tenant(self):
        svc = service(PORT)
        for t, seed in (("a", 0), ("b", 1)):
            inst = traffic(PORT, seed=seed)
            svc.session(t, inst).step(inst)
        report = service(PORT).restore(svc.checkpoint())
        assert sorted(report["restored"]) == ["a", "b"]

    def test_stale_digest_degrades_to_cold(self):
        svc, _ = _stepped(PORT, steps=1)
        meta, arrays = unpack_state(svc.checkpoint())
        meta["tenants"]["a"]["digest"] = "0" * 16
        fresh = service(PORT)
        report = fresh.restore(pack_state(meta, arrays))
        assert report["cold"] == ["a"]
        assert "digest mismatch" in report["errors"]["a"]
        assert fresh.stats()["checkpoint_failures"] == 1

    @pytest.mark.parametrize("dropped", ["x", "idx"])
    def test_missing_array_degrades_to_cold(self, dropped):
        svc, _ = _stepped(PORT, steps=1)
        meta, arrays = unpack_state(svc.checkpoint())
        arrays = {k: v for k, v in arrays.items()
                  if not k.endswith("/" + dropped)}
        fresh = service(PORT)
        report = fresh.restore(pack_state(meta, arrays))
        assert report["cold"] == ["a"]
        assert "missing array" in report["errors"]["a"]
        assert fresh.session("a")._warm is None

    def test_misshapen_iterate_degrades_to_cold(self):
        svc, _ = _stepped(PORT, steps=1)
        meta, arrays = unpack_state(svc.checkpoint())
        arrays["t0/x"] = arrays["t0/x"][:, :-1]
        report = service(PORT).restore(pack_state(meta, arrays))
        assert "stale or corrupt warm state" in report["errors"]["a"]

    def test_strict_restore_raises(self):
        with pytest.raises(CheckpointError):
            service(PORT).restore(b"garbage-bytes-here", strict=True)

    def test_garbage_blob_never_crashes(self):
        fresh = service(PORT)
        report = fresh.restore(b"\x00" * 64)
        assert report["restored"] == [] and report["errors"]
        assert fresh.stats()["checkpoint_failures"] == 1


# ---------------------------------------------------------------------------
# blobs cross packages: written by one, restored warm by the other
# ---------------------------------------------------------------------------

class TestCrossPackageRestore:
    @pytest.mark.parametrize("k", [4, 1], ids=["pop", "full"])
    @pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                             ids=["reference-to-port", "port-to-reference"])
    def test_blob_restores_warm_in_the_other(self, writer, reader, k):
        w_svc, _ = _stepped(writer, k=k)
        blob = w_svc.checkpoint()
        r_svc = service(reader, k=k)
        report = r_svc.restore(blob, strict=True)
        assert report == {"restored": ["a"], "cold": [], "errors": {}}
        restored = r_svc.session("a", domain="traffic")
        assert restored.steps == 2
        # the reader's own uninterrupted session, same next instance
        _, cont = _stepped(reader, k=k)
        nxt = traffic(reader, scale=1.2)
        a, b = restored.step(nxt), cont.step(nxt)
        assert a.warm_fraction == b.warm_fraction == 1.0
        assert a.plan_cache == b.plan_cache == ("hit" if k > 1 else "full")
        np.testing.assert_allclose(np.asarray(a.alloc, float),
                                   np.asarray(b.alloc, float),
                                   atol=ALLOC_TOL)


class TestReferenceFixtures:
    @pytest.mark.parametrize("k", [4, 1], ids=["pop", "full"])
    def test_reference_fixtures_are_current(self, k):
        """The committed blobs hold what the reference writes for the same
        session (zip times aside: meta equal, arrays within 1e-6)."""
        meta, arrays = unpack_state(fixture_path(k).read_bytes())
        want_meta, want = ref_unpack(_stepped(REF, k=k)[0].checkpoint())
        assert meta == want_meta and sorted(arrays) == sorted(want)
        for name, v in want.items():
            assert arrays[name].dtype == v.dtype, name
            np.testing.assert_allclose(arrays[name], v, rtol=1e-6,
                                       atol=1e-6, err_msg=name)

    @pytest.mark.parametrize("k", [4, 1], ids=["pop", "full"])
    def test_reference_fixture_restores_warm(self, k):
        svc = service(PORT, k=k)
        assert svc.restore(fixture_path(k).read_bytes(), strict=True) \
            == {"restored": ["a"], "cold": [], "errors": {}}
        a = svc.session("a").step(traffic(PORT, scale=1.2))
        _, cont = _stepped(PORT, k=k)
        b = cont.step(traffic(PORT, scale=1.2))
        assert a.warm_fraction == 1.0
        np.testing.assert_allclose(a.alloc, b.alloc, atol=ALLOC_TOL)


# ---------------------------------------------------------------------------
# a restore in a fresh process: the rolling restart
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.core.config import ExecConfig, SolveConfig
    from repro_torch.problems.traffic_engineering import (TrafficProblem,
        k_shortest_paths, make_demands, make_topology)
    from repro_torch.service import PopService

    KW = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
    topo = make_topology(20, 40, seed=0)
    pairs, dem = make_demands(topo, 24, seed=0)
    pe = k_shortest_paths(topo, pairs, n_paths=2, max_len=10, seed=0)
    nxt = TrafficProblem(topo, pairs, dem * 1.2, pe)

    svc = PopService(solve=SolveConfig(k=4), exec=ExecConfig(solver_kw=KW),
                     device="cpu")
    report = svc.restore(open(sys.argv[1], "rb").read(), strict=True)
    assert report["restored"] == ["a"], report
    alloc = svc.session("a", domain="traffic").step(nxt)
    assert alloc.warm_fraction == 1.0, alloc.warm_fraction
    assert alloc.plan_cache == "hit", alloc.plan_cache
    assert "jax" not in sys.modules
    np.save(sys.argv[2], np.asarray(alloc.alloc, dtype=np.float64))
""")


def test_restore_in_fresh_process_matches_uninterrupted(tmp_path):
    svc, sess = _stepped(PORT)
    blob_path = tmp_path / "session.ckpt"
    blob_path.write_bytes(svc.checkpoint())
    out_path = tmp_path / "alloc.npy"
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(blob_path), str(out_path)],
        env=repro_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    cont = sess.step(traffic(PORT, scale=1.2))
    np.testing.assert_allclose(np.load(out_path), cont.alloc, rtol=1e-6)


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for k in (4, 1):
        fixture_path(k).write_bytes(_stepped(REF, k=k)[0].checkpoint())
        print(fixture_path(k), fixture_path(k).stat().st_size, "bytes")
