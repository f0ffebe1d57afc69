"""The port's data pipeline, checkpointer and training drivers
(``repro_torch.data``, ``repro_torch.checkpoint.Checkpointer``,
``repro_torch.launch.train``, ``examples_torch/train_e2e.py``) against the
reference's, on the CPU.

``TokenPipeline`` draws the reference's batches bit for bit.  Either
package restores the other's checkpoint (the same keys in the same order,
shapes, dtypes and bits).  The rest twins the reference's own checks
(``tests/test_substrate.py``'s checkpoint and pipeline tests,
``tests/test_system.py``'s restart check, ``tests/test_examples.py``'s
``train_e2e.py`` case) on the port."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subproc import repro_env
from repro import configs as rconfigs
from repro import models as rmodels
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.data import TokenPipeline as RTokenPipeline
from repro.train import optimizer as ropt
from repro.train.train_step import TrainConfig as RTrainConfig
from repro.train.train_step import make_train_step as rmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import testing
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DevicePrefetcher, TokenPipeline
from repro_torch.interop import (_paths, opt_state_from_numpy,
                                 params_from_numpy)
from repro_torch.models.transformer import leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc_seq", [0, 6])
def test_token_pipeline_equals_reference(enc_seq):
    kw = dict(vocab=300, batch=3, seq=17, seed=5, enc_seq=enc_seq,
              d_model=8)
    ref, port = RTokenPipeline(**kw), TokenPipeline(**kw)
    ri, ti = iter(ref), iter(port)
    for _ in range(3):
        a, b = next(ri), next(ti)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state() == ref.state() == {"cursor": 3, "seed": 5}
    ref2, port2 = RTokenPipeline(**kw), TokenPipeline(**kw)
    ref2.restore(ref.state())
    port2.restore(port.state())
    np.testing.assert_array_equal(next(iter(port2))["tokens"],
                                  next(iter(ref2))["tokens"])


def test_pipeline_deterministic_and_restorable():
    """The reference's check on the port."""
    p1 = TokenPipeline(vocab=100, batch=4, seq=16, seed=9)
    it1 = iter(p1)
    batches = [next(it1) for _ in range(3)]
    cursor = p1.state()
    p2 = TokenPipeline(vocab=100, batch=4, seq=16, seed=9)
    p2.restore(cursor)
    np.testing.assert_array_equal(next(iter(p2))["tokens"],
                                  next(it1)["tokens"])
    np.testing.assert_array_equal(batches[0]["tokens"][:, 1:],
                                  batches[0]["labels"][:, :-1])


def test_prefetcher_stages_batches_and_tracks_the_cursor():
    pipe = TokenPipeline(vocab=50, batch=2, seq=5, seed=1, enc_seq=3,
                         d_model=4)
    want = [TokenPipeline(vocab=50, batch=2, seq=5, seed=1, enc_seq=3,
                          d_model=4)._make(i) for i in range(4)]
    pre = DevicePrefetcher(pipe, "cpu", depth=2)
    try:
        assert pre.state() == {"cursor": 0, "seed": 1}
        for i in range(4):
            got = next(pre)
            assert pre.state() == {"cursor": i + 1, "seed": 1}
            for k, v in want[i].items():
                assert isinstance(got[k], torch.Tensor)
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), v)
        assert pipe.state()["cursor"] >= 4          # the thread runs ahead
    finally:
        pre.close()
    assert not pre._thread.is_alive()


def test_prefetcher_close_with_a_full_queue_and_errors():
    pre = DevicePrefetcher(TokenPipeline(vocab=50, batch=2, seq=5),
                           "cpu", depth=1)
    deadline = time.monotonic() + 10
    while not pre.q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pre.q.full()
    t0 = time.monotonic()
    pre.close()
    assert time.monotonic() - t0 < 5 and not pre._thread.is_alive()

    class Broken(TokenPipeline):
        def _make(self, idx):
            raise OSError("shard unreadable")
    bad = DevicePrefetcher(Broken(vocab=5, batch=1, seq=2), "cpu")
    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        next(bad)
    bad.close()
    # a mesh is taken (ROADMAP item 14.5): a batch on a gloo world of one
    # comes back as DTensors with its rows on the data axis
    with testing.gloo_world() as mesh:
        on_mesh = DevicePrefetcher(TokenPipeline(vocab=5, batch=2, seq=3),
                                   "cpu", mesh=mesh)
        try:
            got = next(on_mesh)
            want = next(iter(TokenPipeline(vocab=5, batch=2, seq=3)))
            for k, v in want.items():
                assert got[k].placements[0].is_shard(0)
                np.testing.assert_array_equal(got[k].full_tensor().numpy(), v)
        finally:
            on_mesh.close()


# ---------------------------------------------------------------------------
# checkpointing: the reference's checks on the port
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
            "b": {"c": torch.tensor(rng.normal(size=(3,)),
                                    dtype=torch.float32),
                  "d": torch.tensor(rng.integers(0, 5, (2, 2)),
                                    dtype=torch.int32)}}


def _zeros_like(tree):
    return {"a": torch.zeros_like(tree["a"]),
            "b": {k: torch.zeros_like(v) for k, v in tree["b"].items()}}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(7, t, extras={"data_cursor": 42})
    assert ck.latest() == 7
    restored, extras = ck.restore(7, _zeros_like(t))
    assert extras["data_cursor"] == 42
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_async_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    for s in (1, 3, 2):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert ck.latest() == 3


def test_checkpoint_async_snapshot_survives_in_place_updates(tmp_path):
    """``save_async`` copies the leaves before it returns, so a step that
    updates them in place right after does not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = {k: v.clone() for k, v in _paths(t).items()}
    ck.save_async(1, t)
    for leaf in leaves(t):
        leaf.add_(1)
    ck.wait()
    restored, _ = ck.restore(1, _zeros_like(t))
    for k, v in _paths(restored).items():
        assert torch.equal(v, want[k]), k


def test_checkpoint_atomicity_no_tmp_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ck.latest() == 1


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    bad = {"a": torch.zeros(8, 4), "b": {"c": torch.zeros(3)}}  # missing d
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(1, bad)
    wrong_shape = _zeros_like(_tree())
    wrong_shape["a"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, wrong_shape)
    # placements need the mesh they lie on (sharded restores: ROADMAP item
    # 14.5, tests/test_torch_mesh.py)
    with pytest.raises(ValueError, match="mesh="):
        ck.restore(1, _tree(), shardings={})


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _trained(arch="xlstm_350m"):
    """One train step of a reduced model in both packages from the same
    parameters: (reference cfg, params, state; port cfg, params, state)."""
    rcfg, tcfg = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    rp = rmodels.init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    batch = testing.train_batch(tcfg, 2, 8, seed=0)
    rp, ro, _ = jax.jit(rmake_train_step(rcfg, RTrainConfig()))(
        rp, ropt.init_state(rp),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    tp, to, _ = make_train_step(tcfg, TrainConfig())(
        tp, topt.init_state(tp), batch)
    return rcfg, rp, ro, tcfg, tp, to


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rcfg, rp, ro, tcfg, tp, to = _trained()
    extras = {"pipeline": {"cursor": 3, "seed": 0}, "step": 3}
    RCheckpointer(str(tmp_path)).save(3, {"params": rp, "opt": ro},
                                      extras=extras)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest() == 3
    restored, got_extras = ck.restore(3, {"params": tp, "opt": to})
    assert got_extras == extras
    assert isinstance(restored["opt"], topt.AdamWState)
    assert restored["opt"].step.dtype == torch.int32
    assert int(restored["opt"].step) == int(ro.step) == 1
    want = {"params": _paths(_np(rp)), "m": _paths(_np(ro.m)),
            "v": _paths(_np(ro.v))}
    got = {"params": _paths(restored["params"]),
           "m": _paths(restored["opt"].m), "v": _paths(restored["opt"].v)}
    for part in want:
        assert set(got[part]) == set(want[part])
        for k, w in want[part].items():
            assert got[part][k].dtype == torch.float32
            np.testing.assert_array_equal(got[part][k].numpy(), w)
    # the same state carried by interop equals the restored one
    via = opt_state_from_numpy(np.asarray(ro.step), _np(ro.m), _np(ro.v),
                               tcfg, "cpu")
    for a, b in zip(leaves([via.m, via.v]),
                    leaves([restored["opt"].m, restored["opt"].v])):
        assert torch.equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rcfg, rp, ro, tcfg, tp, to = _trained()
    Checkpointer(str(tmp_path)).save(5, {"params": tp, "opt": to},
                                     extras={"step": 5})
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["opt/.step"] == "int32"
    assert manifest["keys"][:2] == ["opt/.step", "opt/.m/embed/table"]
    ck = RCheckpointer(str(tmp_path))
    restored, extras = ck.restore(5, {"params": rp, "opt": ro})
    assert extras == {"step": 5}
    assert int(restored["opt"].step) == int(to.step)
    want = {"params": _paths(tp), "m": _paths(to.m), "v": _paths(to.v)}
    got = {"params": _paths(_np(restored["params"])),
           "m": _paths(_np(restored["opt"].m)),
           "v": _paths(_np(restored["opt"].v))}
    for part in want:
        for k, w in want[part].items():
            assert got[part][k].dtype == np.float32
            np.testing.assert_array_equal(got[part][k], w.numpy())


def test_opt_state_from_numpy_checks_the_tree():
    cfg = tconfigs.get_reduced("llama3_8b")
    rp = _np(rmodels.init_params(jax.random.PRNGKey(0),
                                 rconfigs.get_reduced("llama3_8b")))
    st = opt_state_from_numpy(np.int32(4), rp, rp, cfg, "cpu")
    assert int(st.step) == 4 and st.step.dtype == torch.int32
    del rp["unembed"]
    with pytest.raises(ValueError, match="missing"):
        opt_state_from_numpy(np.int32(4), rp, rp, cfg, "cpu")


# ---------------------------------------------------------------------------
# restart, the drivers
# ---------------------------------------------------------------------------

def test_train_checkpoint_restart_bitexact(tmp_path):
    """Restart from a checkpoint reproduces the exact same next step (the
    reference's check, on the port)."""
    cfg = tconfigs.get_reduced("llama3_8b")
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg)
    opt = topt.init_state(params)
    step = make_train_step(cfg, TrainConfig(
        n_microbatches=1, adamw=topt.AdamWConfig(
            peak_lr=1e-3, warmup_steps=2, total_steps=10)))
    pipe = TokenPipeline(vocab=cfg.vocab, batch=2, seq=32, seed=3)
    it = iter(pipe)

    def t(b):
        return {k: torch.as_tensor(v) for k, v in b.items()}

    ck = Checkpointer(str(tmp_path))
    params, opt, _ = step(params, opt, t(next(it)))
    ck.save(1, {"params": params, "opt": opt}, extras={"pipe": pipe.state()})
    b2 = next(it)
    params_a, opt_a, m_a = step(params, opt, t(b2))
    restored, extras = ck.restore(1, {"params": params_a, "opt": opt_a})
    pipe2 = TokenPipeline(vocab=cfg.vocab, batch=2, seq=32, seed=3)
    pipe2.restore(extras["pipe"])
    b2r = next(iter(pipe2))
    np.testing.assert_array_equal(b2["tokens"], b2r["tokens"])
    params_b, opt_b, m_b = step(restored["params"], restored["opt"], t(b2r))
    assert float(m_a["loss"]) == float(m_b["loss"])
    for a, b in zip(leaves([params_a, opt_a.m, opt_a.v]),
                    leaves([params_b, opt_b.m, opt_b.v])):
        assert torch.equal(a, b)


def test_train_driver_resumes_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", "llama3_8b", "--reduced", "--batch", "4", "--seq",
            "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "training llama3-8b-reduced" in out and "step     0 loss=" in out
    assert "resumed" not in out and "done: final loss" in out
    assert Checkpointer(str(tmp_path)).latest() == 2
    _, _, m = train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert np.isfinite(float(m["loss"]))
    assert Checkpointer(str(tmp_path)).latest() == 4
    assert train.perf_policy(tconfigs.get_reduced("gemma3_4b"), None) == {}


def test_train_driver_default_device_refuses_without_card(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])


def test_train_e2e_twin_on_cpu():
    """The twin of ``tests/test_examples.py``'s ``train_e2e.py`` case, with
    the reference's arguments, on the CPU."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "train_e2e.py"),
         "--steps", "8", "--fail-at", "4", "--ckpt-every", "2",
         "--device", "cpu"],
        env=repro_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "across restart" in proc.stdout, proc.stdout[-2000:]
    assert "restored step 2 (data cursor 3)" in proc.stdout
