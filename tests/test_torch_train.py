"""The training substrate of the port (``repro_torch.train``: AdamW,
gradient compression, remat in ``forward_train``, the mesh refusals)
against the reference's, on the CPU.  Inputs are drawn with numpy from
seeds and fed to both packages; the port's per-architecture train step
against the reference's is ``tests/test_torch_train_step.py``.

Tolerances: AdamW on equal inputs runs the same f32 formulas in both
packages, so parameters, moments, lr and grad_norm agree within
``ADAMW_RTOL`` (a few f32 roundings: the two libraries may fuse a
multiply-add where the other rounds twice).  The int8 payloads of the
compression are equal (both round half to even) and the scales within
``SCALE_RTOL``.  Remat on against off is bit-equal on the CPU.  The bf16
loss of llama3-8b reduced lies within twice the reference's own distance
between its bf16 and f32 losses (the rule of
``testing.bf16_logit_tol``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.train import compression as rcomp
from repro.train import optimizer as ropt
from repro.train.train_step import TrainConfig as RTrainConfig
from repro.train.train_step import make_loss_fn as rmake_loss_fn
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import testing
from repro_torch.interop import _paths, params_from_numpy
from repro_torch.models.transformer import leaves
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ADAMW_RTOL = 1e-6
SCALE_RTOL = 1e-7
NO_DECAY = ("scale", "bias", "a_log", "dt_bias", "d_skip", "norm_scale")


def _named_tree(seed: int, scale: float = 1.0) -> dict:
    """A numpy tree whose leaf names hold every no-decay name, sLSTM's
    ``r``, matrices and a list (stacked segments)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {
        "embed": {"table": a(16, 8)},
        "final_norm": {"scale": a(8)},
        "ln": {"scale": a(8), "bias": a(8)},
        "segments": [{
            "b0": {"mixer": {"r": a(2, 4, 16), "w_in": a(8, 2, 16),
                             "a_log": a(2), "dt_bias": a(2), "d_skip": a(2),
                             "norm_scale": a(8)},
                   "norm1": {"scale": a(2, 8)}},
            "b1": {"ffn": {"w_up": a(2, 8, 12)}},
        }],
        "stack": [a(3, 3), a(5)],
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.tensor(tree)


def _assert_close(got, want, rtol=ADAMW_RTOL, what=""):
    got = {k: v.numpy() for k, v in _paths(got).items()}
    want = {k: np.asarray(v) for k, v in _paths(want).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * float(np.abs(want[k]).max()),
                                   err_msg=f"{what} {k}")


def _both_apply(cfg_kw: dict, grad_scale: float, steps: int = 3):
    """``steps`` AdamW updates of one tree in both packages with the same
    gradients: (port params, port state, port metrics, reference's)."""
    params = _named_tree(0)
    rp, tp = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    rs, ts = ropt.init_state(rp), topt.init_state(tp)
    rcfg, tcfg = ropt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    for i in range(steps):
        grads = _named_tree(10 + i, grad_scale)
        rp, rs, rm = ropt.apply_updates(rcfg, rp, jax.tree.map(jnp.asarray,
                                                               grads), rs)
        tp, ts, tm = topt.apply_updates(tcfg, tp, _torch_tree(grads), ts)
    return tp, ts, tm, rp, rs, rm


@pytest.mark.parametrize("grad_scale", [1e-3, 100.0],
                         ids=["unclipped", "clipped"])
def test_apply_updates_matches_reference(grad_scale):
    """Every no-decay name skipped and ``r`` decayed as in the reference;
    the clip scale with (gradient norm about 1,300) and without (about
    0.013) clipping."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    tp, ts, tm, rp, rs, rm = _both_apply(kw, grad_scale)
    assert (float(tm["grad_norm"]) > 1.0) == (grad_scale > 1.0)
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                   rtol=ADAMW_RTOL)
    assert int(ts.step) == int(rs.step) == 3
    assert ts.step.dtype == torch.int32
    _assert_close(tp, jax.tree.map(np.asarray, rp), what="params")
    _assert_close(ts.m, jax.tree.map(np.asarray, rs.m), what="m")
    _assert_close(ts.v, jax.tree.map(np.asarray, rs.v), what="v")


def test_weight_decay_mask_matches_reference():
    """With zero gradients only the decay moves a parameter: the six
    no-decay names stay bit for bit, every other leaf (``r`` too) moves,
    in both packages."""
    kw = dict(peak_lr=0.1, warmup_steps=0, total_steps=10, weight_decay=1.0)
    params = _named_tree(0)
    zeros = jax.tree.map(np.zeros_like, params)
    rp, _, _ = ropt.apply_updates(ropt.AdamWConfig(**kw),
                                  jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, zeros),
                                  ropt.init_state(jax.tree.map(jnp.asarray,
                                                               params)))
    tp = _torch_tree(params)
    tp, _, _ = topt.apply_updates(topt.AdamWConfig(**kw), tp,
                                  _torch_tree(zeros), topt.init_state(tp))
    before, ref = _paths(params), _paths(jax.tree.map(np.asarray, rp))
    for k, v in _paths(tp).items():
        kept = k.split(".")[-1] in NO_DECAY
        moved = not np.array_equal(v.numpy(), before[k])
        assert moved == (not kept), k
        assert np.array_equal(v.numpy(), before[k]) == \
            np.array_equal(ref[k], before[k]), k
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=ADAMW_RTOL)
    assert not np.array_equal(_paths(tp)["segments.0.b0.mixer.r"].numpy(),
                              before["segments.0.b0.mixer.r"])


def test_schedule_matches_reference():
    for cfg_kw in (dict(), dict(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                                total_steps=100),
                   dict(warmup_steps=1, total_steps=4)):
        rcfg, tcfg = ropt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
        for s in range(tcfg.total_steps + 2):
            np.testing.assert_allclose(
                float(topt.schedule(tcfg, torch.tensor(s, dtype=torch.int32))),
                float(ropt.schedule(rcfg, jnp.asarray(s, jnp.int32))),
                rtol=ADAMW_RTOL, err_msg=f"{cfg_kw} step {s}")


def test_adamw_config_defaults_equal_reference():
    import dataclasses
    assert dataclasses.asdict(topt.AdamWConfig()) == \
        dataclasses.asdict(ropt.AdamWConfig())
    r = dataclasses.asdict(RTrainConfig())
    t = dataclasses.asdict(tts.TrainConfig())
    assert r == t


# the reference's own optimizer checks (tests/test_substrate.py), on the port

def test_adamw_decreases_quadratic():
    cfg = topt.AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=100,
                           weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = topt.init_state(params)
    for _ in range(50):
        grads = {"w": 2.0 * params["w"]}
        params, state, _ = topt.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule_shape():
    cfg = topt.AdamWConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                           total_steps=100)
    lrs = [float(topt.schedule(cfg, torch.tensor(s))) for s in
           [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


def test_global_norm_sums_pairwise():
    """The clip's norm over a large leaf agrees with an f64 norm (a lane
    accumulation in f32 is 1% low at 10^8 elements on the CPU)."""
    g = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0))
    want = float(torch.linalg.vector_norm(g, dtype=torch.float64))
    np.testing.assert_allclose(float(topt.global_norm({"g": g})), want,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 513, 4096])
def test_quantize_int8_matches_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * rng.uniform(0.1, 10)).astype(np.float32)
    rq, rs = rcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=SCALE_RTOL)
    np.testing.assert_allclose(
        tcomp.dequantize_int8(tq, ts, (n,)).numpy(),
        np.asarray(rcomp.dequantize_int8(rq, rs, (n,))), rtol=SCALE_RTOL,
        atol=SCALE_RTOL * float(np.abs(x).max()))


def test_error_feedback_matches_reference_over_five_rounds():
    rng = np.random.default_rng(0)
    shape = (3, 300)
    rr, tr = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    for _ in range(5):
        g = rng.normal(size=shape).astype(np.float32)
        rq, rs, rr = rcomp.compress_with_feedback(jnp.asarray(g), rr)
        tq, ts, tr = tcomp.compress_with_feedback(torch.tensor(g), tr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs),
                                   rtol=SCALE_RTOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(rr), rtol=0,
                                   atol=SCALE_RTOL * float(np.abs(g).max()))


def test_error_feedback_unbiased_over_steps():
    """The reference's check on the port: the running sum of dequantised
    gradients plus the residual tracks the true running sum."""
    rng = np.random.default_rng(0)
    g_true = [torch.tensor(rng.normal(size=(300,)), dtype=torch.float32)
              for _ in range(20)]
    r = torch.zeros(300)
    sent = torch.zeros(300)
    for g in g_true:
        q, s, r = tcomp.compress_with_feedback(g, r)
        sent = sent + tcomp.dequantize_int8(q, s, g.shape)
    total = sum(g.numpy().astype(np.float64) for g in g_true)
    np.testing.assert_allclose((sent + r).numpy(), total, rtol=1e-4,
                               atol=1e-4)
    assert float(r.abs().max()) < 0.5


def test_init_residuals_and_compressed_psum_refusal():
    """``compressed_psum`` runs over a process group now (ROADMAP item
    14.5): on a gloo world of one its mean is the rank's own dequantised
    payload and its residual the local error feedback, tree for tree (four
    ranks against the reference: tests/test_torch_mesh.py)."""
    params = {"w": torch.ones(4, 3), "b": [torch.ones(2)]}
    res = tcomp.init_residuals(params)
    assert res["w"].shape == (4, 3) and res["b"][0].dtype == torch.float32
    assert float(res["w"].abs().sum()) == 0.0
    grads = {"w": torch.linspace(-1, 1, 12).reshape(4, 3),
             "b": [torch.tensor([0.3, -2.0])]}
    with testing.gloo_world():
        mean, new_res = tcomp.compressed_psum(grads, res)
    for g, m, r in zip(leaves(grads), leaves(mean), leaves(new_res)):
        q, s, want_r = tcomp.compress_with_feedback(g, torch.zeros_like(g))
        assert torch.equal(m, tcomp.dequantize_int8(q, s, g.shape))
        assert torch.equal(r, want_r)


# ---------------------------------------------------------------------------
# remat, bf16, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_remat_on_and_off_bit_equal(arch):
    """One train step (2 microbatches, f32) with remat on and off: loss,
    grad_norm, every parameter, m and v bit for bit."""
    cfg = tconfigs.get_reduced(arch)
    runs = []
    for remat in (True, False):
        params = tmodels.init_params(torch.Generator().manual_seed(1), cfg)
        step = tts.make_train_step(cfg, tts.TrainConfig(
            n_microbatches=2, compute_dtype="float32", remat=remat,
            adamw=topt.AdamWConfig(**testing.PARITY_ADAMW)))
        runs.append(step(params, topt.init_state(params),
                         testing.train_batch(cfg, 4, 8, seed=0)))
    (pa, oa, ma), (pb, ob, mb) = runs
    for key in ("loss", "grad_norm"):
        assert torch.equal(ma[key], mb[key]), key
    for a, b in zip(leaves([pa, oa.m, oa.v]), leaves([pb, ob.m, ob.v])):
        assert torch.equal(a, b)


def test_remat_leaves_forward_and_no_grad_unchanged():
    """Without autograd ``remat`` changes nothing; with it the logits are
    bit-equal and each stacked leaf takes one gradient of its full
    shape."""
    cfg = tconfigs.get_reduced("gemma3_4b")
    params = tmodels.init_params(torch.Generator().manual_seed(1), cfg)
    toks = testing.train_batch(cfg, 2, 8)["tokens"]
    with torch.no_grad():
        a = tmodels.forward_train(params, cfg, toks, remat=True,
                                  compute_dtype=torch.float32)
    b = tmodels.forward_train(params, cfg, toks, remat=False,
                              compute_dtype=torch.float32)
    assert torch.equal(a, b)
    for p in leaves(params):
        p.requires_grad_(True)
    c = tmodels.forward_train(params, cfg, toks, remat=True,
                              compute_dtype=torch.float32)
    assert torch.equal(a, c.detach())
    c.float().sum().backward()
    stacked = params["segments"][0]["b0"]["mixer"]["wq"]
    assert stacked.grad is not None and stacked.grad.shape == stacked.shape
    assert float(stacked.grad.abs().sum()) > 0


def test_bf16_loss_within_reference_bound():
    """llama3-8b reduced in bf16: the port's loss within twice the
    reference's own distance between its bf16 and f32 losses (one batch
    of 4 x 16; the port's embedding gradients round elsewhere, which a
    loss does not see)."""
    rcfg = rconfigs.get_reduced("llama3_8b")
    tcfg = tconfigs.get_reduced("llama3_8b")
    rp = rmodels.init_params(jax.random.PRNGKey(1), rcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    batch = testing.train_batch(tcfg, 4, 16, seed=0)
    rbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref = {dt: float(rmake_loss_fn(rcfg, RTrainConfig(compute_dtype=dt),
                                   None)(rp, rbatch))
           for dt in ("float32", "bfloat16")}
    with torch.no_grad():
        got = float(tts.make_loss_fn(tcfg, tts.TrainConfig(
            compute_dtype="bfloat16"))(tp, batch))
    bound = 2.0 * abs(ref["bfloat16"] - ref["float32"])
    assert bound > 0
    assert abs(got - ref["bfloat16"]) <= bound, (got, ref)


def test_cross_entropy_matches_reference():
    from repro.train.train_step import cross_entropy as rce
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, (2, 5))
    np.testing.assert_allclose(
        float(tts.cross_entropy(torch.tensor(logits), torch.tensor(labels))),
        float(rce(jnp.asarray(logits), jnp.asarray(labels, jnp.int32))),
        rtol=1e-6)


def test_mesh_paths_refused(monkeypatch):
    """The mesh paths run now (ROADMAP item 14.5; tests/test_torch_mesh.py):
    ``jit_train_step`` refuses a mesh off the card unless the caller names
    its device type, ``unroll_segments`` is the reference's cost probe and
    changes nothing; a batch that does not split into the microbatches is
    refused."""
    cfg = tconfigs.get_reduced("llama3_8b")

    class CpuMesh:
        device_type = "cpu"
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tts.jit_train_step(cfg, tts.TrainConfig(), CpuMesh())
    with pytest.raises(ValueError, match="lies on 'cpu'"):
        tts.jit_train_step(cfg, tts.TrainConfig(), CpuMesh(), device="meta")
    batch = testing.train_batch(cfg, 2, 8, seed=0)
    runs = []
    for unroll in (False, True):
        params = tmodels.init_params(torch.Generator().manual_seed(0), cfg)
        step = tts.make_train_step(cfg, tts.TrainConfig(
            compute_dtype="float32", unroll_segments=unroll))
        params, _, m = step(params, topt.init_state(params), batch)
        runs.append((float(m["loss"]), list(leaves(params))))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    step = tts.make_train_step(cfg, tts.TrainConfig(n_microbatches=3))
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, topt.init_state(params),
             testing.train_batch(cfg, 4, 8))
