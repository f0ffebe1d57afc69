"""The LM substrate of the port (``repro_torch.configs``,
``repro_torch.models``) against the reference's, on the CPU.

Every config field of the 10 architectures equals the reference's, and so
does every full config's parameter count.  Parameters come from the
reference's ``init_params`` (or its per-module ``init_*``) carried across
by ``interop.params_from_numpy``; inputs are drawn with numpy from a seed.
Each reduced architecture's ``forward_train`` and an 8-step
``forward_decode`` agree with the reference within ``F32_TOL`` in f32, with
equal greedy tokens; one bf16 case (llama3-8b reduced) is held to
``testing.bf16_logit_tol``.  The second half twins ``tests/test_models.py`` on the port:
decode against teacher forcing, the SWA band, causality, soft-capping, the
MoE mixture, the recurrent forms against their sequence forms, the ring
buffer's wrap and encoder-decoder cross-attention."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.models import xlstm as rxlstm
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import testing
from repro_torch.testing import bf16_logit_tol
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txlstm

# f32 on the CPU: both packages run the same f32 products in another
# order (measured: at most 6e-6 on these models' logits)
F32_TOL = 1e-4
B, S = 2, 8
ARCHS = rconfigs.ARCH_IDS

UNGUARDED_ROUTE = tmoe._route

# the reference's decode-equivalence architectures (tests/test_models.py)
DECODE_EQUIV_ARCHS = ["llama3_8b", "h2o_danube3_4b", "gemma2_27b",
                      "gemma3_4b", "mixtral_8x22b", "zamba2_2_7b",
                      "xlstm_350m", "chameleon_34b"]


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def module_params(tree):
    """A module's reference params (one level of a dict) as f32 tensors."""
    if isinstance(tree, dict):
        return {k: module_params(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def t(a, dtype=None):
    x = torch.tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


@pytest.fixture(scope="module")
def ref_models():
    """{arch: (reference cfg, reference params, port cfg, port params)},
    built once per arch on first use."""
    cache = {}

    def get(arch, seed=1):
        if (arch, seed) not in cache:
            rcfg, tcfg = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
            rp = rmodels.init_params(jax.random.PRNGKey(seed), rcfg)
            cache[arch, seed] = (rcfg, rp, tcfg,
                                 params_from_numpy(to_np(rp), tcfg, "cpu"))
        return cache[arch, seed]
    return get


@pytest.fixture(autouse=True)
def no_router_ties():
    """``torch.topk`` and ``jax.lax.top_k`` may order equal gates
    differently: every routing in these tests must have no tie at the
    top-k cutoff, or the test fails here rather than on a tolerance."""
    with testing.router_tie_guard():
        yield


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert _fields(tconfigs.get_config(arch)) == \
        _fields(rconfigs.get_config(arch))
    assert _fields(tconfigs.get_reduced(arch)) == \
        _fields(rconfigs.get_reduced(arch))
    assert tconfigs.ALIASES == rconfigs.ALIASES
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_reference(arch):
    assert tconfigs.get_config(arch).param_count() == \
        rconfigs.get_config(arch).param_count()


def test_llama3_8b_full_width():
    """The slice's full-width model: 32 layers at d_model 4,096, about
    8.03 B parameters."""
    cfg = tconfigs.get_config("llama3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
            cfg.d_ff, cfg.vocab) == (32, 4096, 32, 8, 128, 14336, 128256)
    assert cfg.param_count() == 8_030_261_248


def _inputs(cfg, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, seq))
    enc = (rng.normal(0, 1, (B, 6, cfg.d_model)).astype(np.float32)
           if cfg.enc_segments else None)
    return toks, enc


def _reference_run(rcfg, rp, toks, enc, dtype, steps):
    """The reference's teacher-forced logits, its per-step decode logits
    and its cache after ``steps // 2`` steps (numpy)."""
    jenc = None if enc is None else jnp.asarray(enc)
    train = rmodels.forward_train(rp, rcfg, jnp.asarray(toks, jnp.int32),
                                  enc_embeddings=jenc, compute_dtype=dtype,
                                  remat=False)
    mem = (None if enc is None
           else rmodels.encode(rp, rcfg, jenc, compute_dtype=dtype))
    cache = rmodels.init_cache(rcfg, B, steps, kv_dtype=dtype)
    step = jax.jit(lambda tok, c: rmodels.forward_decode(
        rp, rcfg, tok, c, enc_memory=mem, compute_dtype=dtype))
    logits, half = [], None
    for i in range(steps):
        if i == steps // 2:
            half = jax.tree.map(np.asarray, cache)
        lg, cache = step(jnp.asarray(toks[:, i: i + 1], jnp.int32), cache)
        logits.append(np.asarray(lg[:, 0], np.float32))
    return np.asarray(train, np.float32), np.stack(logits, 1), half


def _port_decode(tp, tcfg, toks, enc, dtype, cache, start=0):
    mem = (None if enc is None
           else tmodels.encode(tp, tcfg, t(enc), compute_dtype=dtype))
    out = []
    for i in range(start, toks.shape[1]):
        lg, cache = tmodels.forward_decode(tp, tcfg, t(toks[:, i: i + 1]),
                                           cache, enc_memory=mem,
                                           compute_dtype=dtype)
        out.append(lg[:, 0].float().numpy())
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(ref_models, arch):
    """forward_train and 8 decode steps within F32_TOL of the reference,
    equal greedy tokens; the reference's cache after 4 steps, carried
    across by ``cache_from_numpy``, decodes the last 4 like the
    reference."""
    rcfg, rp, tcfg, tp = ref_models(arch)
    toks, enc = _inputs(rcfg)
    want_train, want_dec, half = _reference_run(rcfg, rp, toks, enc,
                                                jnp.float32, S)
    got_train = tmodels.forward_train(
        tp, tcfg, t(toks), enc_embeddings=None if enc is None else t(enc),
        compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got_train, want_train, rtol=0, atol=F32_TOL)
    cache = tmodels.init_cache(tcfg, B, S, kv_dtype=torch.float32,
                               device="cpu")
    got_dec = _port_decode(tp, tcfg, toks, enc, torch.float32, cache)
    np.testing.assert_allclose(got_dec, want_dec, rtol=0, atol=F32_TOL)
    np.testing.assert_array_equal(got_dec.argmax(-1), want_dec.argmax(-1))
    np.testing.assert_array_equal(got_train.argmax(-1),
                                  want_train.argmax(-1))
    carried = cache_from_numpy(half, tcfg, "cpu")
    assert int(carried["pos"]) == S // 2
    resumed = _port_decode(tp, tcfg, toks, enc, torch.float32, carried,
                           start=S // 2)
    np.testing.assert_allclose(resumed, want_dec[:, S // 2:], rtol=0,
                               atol=F32_TOL)


def test_forward_matches_reference_bf16(ref_models):
    """llama3-8b reduced in bf16 (a bf16 KV cache): within
    ``bf16_logit_tol`` of the reference in bf16 (twice the reference's own
    bf16 distance from its f32 logits), and the same greedy token wherever
    the reference's best logit leads its second by more than twice that
    bound."""
    rcfg, rp, tcfg, tp = ref_models("llama3_8b")
    toks, _ = _inputs(rcfg)
    want_train, want_dec, _ = _reference_run(rcfg, rp, toks, None,
                                             jnp.bfloat16, S)
    f32_train, f32_dec, _ = _reference_run(rcfg, rp, toks, None,
                                           jnp.float32, S)
    got_train = tmodels.forward_train(tp, tcfg, t(toks),
                                      compute_dtype=torch.bfloat16)
    got_train = got_train.float().numpy()
    cache = tmodels.init_cache(tcfg, B, S, kv_dtype=torch.bfloat16,
                               device="cpu")
    got_dec = _port_decode(tp, tcfg, toks, None, torch.bfloat16, cache)
    for got, want, f32 in ((got_train, want_train, f32_train),
                           (got_dec, want_dec, f32_dec)):
        tol = bf16_logit_tol(f32, want)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        top2 = np.sort(want, -1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
        assert clear.any()
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


def test_interop_refuses_mismatched_trees(ref_models):
    rcfg, rp, tcfg, _ = ref_models("llama3_8b")
    tree = to_np(rp)
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(extra, tcfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(missing, tcfg, "cpu")
    wrong = dict(tree, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(wrong, tcfg, "cpu")
    cache = jax.tree.map(np.asarray, rmodels.init_cache(rcfg, B, S))
    cache["seg_caches"] = cache["seg_caches"] + cache["seg_caches"]
    with pytest.raises(ValueError, match="cache tree"):
        cache_from_numpy(cache, tcfg, "cpu")


def test_param_paths_and_stacking(ref_models):
    """One port leaf per reference leaf, at the same path, with the
    segment leaves stacked on their period axis."""
    rcfg, rp, tcfg, tp = ref_models("zamba2_2_7b")
    flat = jax.tree_util.tree_flatten_with_path(rp)[0]
    ref_paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path): leaf.shape for path, leaf in flat}
    from repro_torch.interop import _paths
    got = {p: tuple(v.shape) for p, v in _paths(tp).items()}
    assert got == {p: tuple(s) for p, s in ref_paths.items()}
    assert got["segments.0.b0.mixer.w_z"][0] == rcfg.segments[0].n_periods
    assert "shared_attn.wq" in got


# ---------------------------------------------------------------------------
# the layers and mixers, module by module, against the reference
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    scale = rng.normal(0, 0.1, 16).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5))
    xh = rng.normal(0, 1, (2, 5, 3, 8)).astype(np.float32)
    pairs = [
        (rlayers.rmsnorm({"scale": scale}, x),
         tlayers.rmsnorm({"scale": t(scale)}, t(x))),
        (rlayers.layernorm({"scale": scale, "bias": bias}, x),
         tlayers.layernorm({"scale": t(scale), "bias": t(bias)}, t(x))),
        (rlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 5e5),
         tlayers.apply_rope(t(xh), t(pos), 5e5)),
    ]
    for act in ("silu", "gelu"):
        p = rlayers.init_mlp(jax.random.PRNGKey(0), 16, 24)
        pairs.append((rlayers.mlp(p, x, act),
                      tlayers.mlp(module_params(p), t(x), act)))
    table = rlayers.init_embedding(jax.random.PRNGKey(1), 50, 16)
    toks = rng.integers(0, 50, (2, 5))
    pairs.append((rlayers.embed(table, jnp.asarray(toks), jnp.float32),
                  tlayers.embed(module_params(table), t(toks),
                                torch.float32)))
    pairs.append((rlayers.unembed(table, x),
                  tlayers.unembed(module_params(table), t(x))))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    # embed gathers then casts: the same bits as the reference's
    # cast-then-gather
    np.testing.assert_array_equal(
        tlayers.embed(module_params(table), t(toks)).float().numpy(),
        np.asarray(rlayers.embed(table, jnp.asarray(toks)), np.float32))


@pytest.mark.parametrize("window,softcap,causal", [
    (100.0, 0.0, True), (3.0, 0.0, True), (100.0, 5.0, True),
    (100.0, 0.0, False)])
def test_attention_train_matches_reference(window, softcap, causal):
    p = rattn.init_attention(jax.random.PRNGKey(0), 32, 4, 2, 8)
    x = np.random.default_rng(1).normal(0, 1, (2, 10, 32)).astype(np.float32)
    want = jax.jit(lambda p, x: rattn.attention_train(
        p, x, window=window, softcap=jnp.asarray(softcap), rope_theta=1e4,
        causal=causal))(p, jnp.asarray(x))
    got = tattn.attention_train(module_params(p), t(x), window=window,
                                softcap=softcap, rope_theta=1e4,
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_attention_cross_matches_reference():
    p = rattn.init_attention(jax.random.PRNGKey(0), 32, 4, 4, 8)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
    mem = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    want = rattn.attention_train(p, jnp.asarray(x), window=8.0, softcap=0.0,
                                 rope_theta=1e4, causal=False,
                                 memory=jnp.asarray(mem))
    got = tattn.attention_train(module_params(p), t(x), window=8.0,
                                softcap=0.0, rope_theta=1e4, causal=False,
                                memory=t(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    want_d, _ = rattn.attention_decode(p, jnp.asarray(x[:, :1]), None, 0,
                                       window=2.0 ** 31, softcap=0.0,
                                       rope_theta=1e4,
                                       memory=jnp.asarray(mem))
    got_d, _ = tattn.attention_decode(module_params(p), t(x[:, :1]), None,
                                      torch.tensor(0), window=2.0 ** 31,
                                      softcap=0.0, rope_theta=1e4,
                                      memory=t(mem))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("window", [2.0 ** 31, 4.0])
def test_attention_decode_ring_matches_reference(window):
    """Decode past a 4-slot ring buffer: the outputs and the cache (in the
    reference's layout) agree step by step."""
    p = rattn.init_attention(jax.random.PRNGKey(0), 32, 4, 2, 8)
    x = np.random.default_rng(3).normal(0, 1, (2, 9, 32)).astype(np.float32)
    L = 4 if window == 4.0 else 9
    rc = rattn.KVCache.zeros(2, L, 2, 8, dtype=jnp.float32)
    tc = tattn.KVCache.zeros(2, L, 2, 8, dtype=torch.float32)
    tp = module_params(p)
    step = jax.jit(lambda p, x, c, pos: rattn.attention_decode(
        p, x, c, pos, window=window, softcap=0.0, rope_theta=1e4))
    for pos in range(9):
        want, rc = step(p, jnp.asarray(x[:, pos: pos + 1]), rc,
                        jnp.asarray(pos, jnp.int32))
        got, tc = tattn.attention_decode(tp, t(x[:, pos: pos + 1]), tc,
                                         torch.tensor(pos), window=window,
                                         softcap=0.0, rope_theta=1e4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tc.k.transpose(1, 2).numpy(),
                                   np.asarray(rc.k), rtol=0, atol=1e-5)


def test_grouped_heads_equal_expanded_kv():
    """The port's grouped GQA products equal the reference's ``_expand_kv``
    formulation (query head h reads KV head h // group)."""
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 3, 8, 4)).astype(np.float32)
    k = rng.normal(0, 1, (2, 5, 2, 4)).astype(np.float32)
    v = rng.normal(0, 1, (2, 5, 2, 4)).astype(np.float32)
    s = rattn._gqa_scores(jnp.asarray(q), jnp.asarray(k), 0.5)
    got = tattn._gqa_scores(t(q), t(k).transpose(1, 2), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(s), rtol=0,
                               atol=1e-6)
    w = np.asarray(jax.nn.softmax(s, -1))
    want = rattn._gqa_out(jnp.asarray(w), jnp.asarray(v))
    got = tattn._gqa_out(t(w), t(v).transpose(1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("S_,n_shared,cf", [(8, 0, 1.25), (8, 2, 4.0),
                                             (1, 0, 1.25), (16, 0, 0.5)])
def test_moe_matches_reference(S_, n_shared, cf):
    """Capacity-bounded dispatch (``cf=0.5`` drops choices, ``S=1`` is
    decode's capacity of 1) and the shared expert."""
    p = rmoe.init_moe(jax.random.PRNGKey(0), 16, 32, n_experts=4,
                      n_shared=n_shared, d_ff_shared=24)
    x = np.random.default_rng(5).normal(0, 1, (2, S_, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: rmoe.moe(p, x, top_k=2,
                                         capacity_factor=cf))(
        p, jnp.asarray(x))
    got = tmoe.moe(module_params(p), t(x), top_k=2, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


MIXERS = {
    "mamba2": (lambda: rssm.init_mamba2(jax.random.PRNGKey(0), 32,
                                        d_state=8, expand=2, head_dim=8),
               lambda p, x: rssm.mamba2_train(p, x, chunk=4),
               lambda p, x: tssm.mamba2_train(p, x, chunk=4),
               rssm.mamba2_init_state, tssm.mamba2_init_state,
               rssm.mamba2_decode, tssm.mamba2_decode),
    "mlstm": (lambda: rxlstm.init_mlstm(jax.random.PRNGKey(0), 32,
                                        n_heads=2),
              rxlstm.mlstm_train, txlstm.mlstm_train,
              rxlstm.mlstm_init_state, txlstm.mlstm_init_state,
              rxlstm.mlstm_decode, txlstm.mlstm_decode),
    "slstm": (lambda: rxlstm.init_slstm(jax.random.PRNGKey(0), 32,
                                        n_heads=2),
              rxlstm.slstm_train, txlstm.slstm_train,
              rxlstm.slstm_init_state, txlstm.slstm_init_state,
              rxlstm.slstm_decode, txlstm.slstm_decode),
}


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_matches_reference(mixer):
    """Mamba2 (chunked, chunk 4 over 16 steps), mLSTM and sLSTM, each in
    its sequence form and 4 steps of its recurrent form, with the states,
    against the reference."""
    init, r_train, t_train, r_init, t_init, r_dec, t_dec = MIXERS[mixer]
    p = init()
    x = (np.random.default_rng(6).normal(0, 1, (2, 16, 32)) * 0.5
         ).astype(np.float32)
    tp = module_params(p)
    np.testing.assert_allclose(t_train(tp, t(x)).numpy(),
                               np.asarray(jax.jit(r_train)(p,
                                                           jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    r_step = jax.jit(r_dec)
    rs, ts = r_init(p, 2), t_init(tp, 2)
    for i in range(4):
        want, rs = r_step(p, jnp.asarray(x[:, i: i + 1]), rs)
        got, ts = t_dec(tp, t(x[:, i: i + 1]), ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        for key in rs:
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(rs[key]),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# twins of tests/test_models.py on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODE_EQUIV_ARCHS)
def test_decode_matches_teacher_forcing(ref_models, arch):
    rcfg, _, cfg, params = ref_models(arch)
    tokens = t(np.random.default_rng(0).integers(0, cfg.vocab, (B, 24)))
    ref = tmodels.forward_train(params, cfg, tokens,
                                compute_dtype=torch.float32)
    cache = tmodels.init_cache(cfg, B, 24, kv_dtype=torch.float32,
                               device="cpu")
    outs = []
    for i in range(24):
        lg, cache = tmodels.forward_decode(params, cfg, tokens[:, i: i + 1],
                                           cache,
                                           compute_dtype=torch.float32)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=1e-3, atol=1e-3)


def _attn_params():
    return module_params(rattn.init_attention(jax.random.PRNGKey(0), 32, 4,
                                              2, 8))


def test_swa_window_masks_old_tokens():
    p = _attn_params()
    W = 4
    x = t(np.random.default_rng(1).normal(0, 1, (1, 12, 32))
          .astype(np.float32))
    y1 = tattn.attention_train(p, x, window=float(W), softcap=0.0,
                               rope_theta=1e4)
    x2 = x.clone()
    x2[:, 0] += 10.0
    y2 = tattn.attention_train(p, x2, window=float(W), softcap=0.0,
                               rope_theta=1e4)
    np.testing.assert_allclose(y1[:, W:].numpy(), y2[:, W:].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float((y1[:, 1] - y2[:, 1]).abs().max()) > 1e-4


def test_causality():
    p = _attn_params()
    x = t(np.random.default_rng(1).normal(0, 1, (1, 10, 32))
          .astype(np.float32))
    y1 = tattn.attention_train(p, x, window=100.0, softcap=0.0,
                               rope_theta=1e4)
    x2 = x.clone()
    x2[:, -1] += 10.0
    y2 = tattn.attention_train(p, x2, window=100.0, softcap=0.0,
                               rope_theta=1e4)
    np.testing.assert_allclose(y1[:, :-1].numpy(), y2[:, :-1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_softcap_bounds_logit_influence():
    logits = torch.linspace(-1000, 1000, 64)
    capped = tattn._soft_cap(logits, torch.tensor(50.0))
    assert float(capped.abs().max()) <= 50.0 + 1e-4
    np.testing.assert_allclose(tattn._soft_cap(logits, 0.0).numpy(),
                               logits.numpy())
    np.testing.assert_allclose(
        capped.numpy(),
        np.asarray(rattn._soft_cap(jnp.asarray(logits.numpy()),
                                   jnp.asarray(50.0))), rtol=1e-6,
        atol=1e-4)


def test_moe_expert_mixture_sums_to_one():
    p = module_params(rmoe.init_moe(jax.random.PRNGKey(0), 16, 32,
                                    n_experts=4, n_shared=0))
    x = t(np.random.default_rng(1).normal(0, 1, (2, 8, 16))
          .astype(np.float32))
    y = tmoe.moe(p, x, top_k=2, capacity_factor=4.0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    gates, _ = tmoe._route(p["router"], x, 2)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-6)


def test_moe_zero_input_gives_zero_output(monkeypatch):
    """The reference's zero-input case.  Every gate ties at zero input, so
    the tie guard fails it loudly; without the guard the routed output is
    zero whichever experts win."""
    p = module_params(rmoe.init_moe(jax.random.PRNGKey(0), 16, 32,
                                    n_experts=4, n_shared=0))
    zeros = torch.zeros(2, 8, 16)
    with pytest.raises(AssertionError, match="tied router gates"):
        tmoe.moe(p, zeros, top_k=2)
    monkeypatch.setattr(tmoe, "_route", UNGUARDED_ROUTE)
    np.testing.assert_allclose(tmoe.moe(p, zeros, top_k=2).numpy(), 0.0,
                               atol=1e-6)


def _recurrence_case(init, train, init_state, decode, S_):
    x = t((np.random.default_rng(1).normal(0, 1, (2, S_, 32)) * 0.5)
          .astype(np.float32))
    p = module_params(init)
    y_par = train(p, x)
    state = init_state(p, 2)
    outs = []
    for i in range(S_):
        y, state = decode(p, x[:, i: i + 1], state)
        outs.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), y_par.numpy(),
                               rtol=3e-3, atol=3e-3)


def test_mamba2_decode_matches_train():
    _recurrence_case(rssm.init_mamba2(jax.random.PRNGKey(0), 32, d_state=8,
                                      expand=2, head_dim=8),
                     lambda p, x: tssm.mamba2_train(p, x, chunk=4),
                     tssm.mamba2_init_state, tssm.mamba2_decode, 16)


def test_mlstm_decode_matches_train():
    _recurrence_case(rxlstm.init_mlstm(jax.random.PRNGKey(0), 32, n_heads=2),
                     txlstm.mlstm_train, txlstm.mlstm_init_state,
                     txlstm.mlstm_decode, 12)


def test_slstm_decode_matches_train():
    _recurrence_case(rxlstm.init_slstm(jax.random.PRNGKey(0), 32, n_heads=2),
                     txlstm.slstm_train, txlstm.slstm_init_state,
                     txlstm.slstm_decode, 10)


def test_ring_buffer_cache_wraps_correctly(ref_models):
    """Decoding 48 tokens past danube's 32-slot window with a ring cache
    equals the teacher-forced forward (the reference's bound: its cache is
    bf16 here, as in the reference's test)."""
    _, _, cfg, params = ref_models("h2o_danube3_4b", seed=2)
    tokens = t(np.random.default_rng(3).integers(0, cfg.vocab, (1, 48)))
    ref = tmodels.forward_train(params, cfg, tokens,
                                compute_dtype=torch.float32)
    cache = tmodels.init_cache(cfg, 1, 48, device="cpu")
    assert cache["seg_caches"][0]["b0"].k.shape[3] == 32
    outs = []
    for i in range(48):
        lg, cache = tmodels.forward_decode(params, cfg, tokens[:, i: i + 1],
                                           cache,
                                           compute_dtype=torch.float32)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_encoder_decoder_cross_attention(ref_models):
    _, _, cfg, params = ref_models("seamless_m4t_medium", seed=0)
    enc = t(np.random.default_rng(0).normal(0, 1, (B, 16, cfg.d_model))
            .astype(np.float32))
    memory = tmodels.encode(params, cfg, enc)
    assert memory.shape == (B, 16, cfg.d_model)
    tokens = torch.zeros((B, 8), dtype=torch.int64)
    lg1 = tmodels.forward_train(params, cfg, tokens, enc_embeddings=enc,
                                compute_dtype=torch.float32)
    lg2 = tmodels.forward_train(params, cfg, tokens, enc_embeddings=enc * 2,
                                compute_dtype=torch.float32)
    assert float((lg1 - lg2).abs().max()) > 1e-4


def test_mesh_refused():
    """The reference's sharding knobs construct and change nothing, with
    or without a mesh: the port's steps have no tensor parallelism for
    them to act on.  A mesh is taken (ROADMAP item 14.5; the sharded
    paths: tests/test_torch_mesh.py)."""
    cfg = tconfigs.get_reduced("llama3_8b")
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    want = ttf.forward_train(params, cfg, tokens,
                             compute_dtype=torch.float32)
    x = torch.ones(2, 4, 8)
    with testing.gloo_world() as mesh:
        for m in (None, mesh):
            opts = ttf.ModelOpts(sp_residual=True, gather_once=True,
                                 bf16_barrier=True, cache_seq_on_model=True,
                                 mesh=m)
            assert opts.gathered({"w": x}, None)["w"] is x
            got = ttf.forward_train(params, cfg, tokens,
                                    compute_dtype=torch.float32, opts=opts)
            assert torch.equal(got, want)
    assert not any(hasattr(ttf.ModelOpts, name)
                   for name in ("constrain", "unconstrain", "pin"))
