"""The serving path of the port (``repro_torch.serve.engine``,
``repro_torch.launch.serve``, ``examples_torch/serve_balanced.py``) against
the reference's, on the CPU.

Twins of ``tests/test_serve.py`` (the greedy step against the argmax of
the teacher-forced forward, a deterministic rollout, prefill then decode)
run on the port with the reference's llama3-8b reduced parameters carried
across; the greedy serve step's tokens equal the reference's; the serving
cast keeps the leaves the reference reads in f32 and changes no bit of a
step; ``balance_requests`` gives the reference's placements at a fixed
budget; ``cache_policy`` decides as the reference's for every arch; the
serving driver and the balanced-serving example run end to end."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.launch.serve import cache_policy as ref_cache_policy
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import balance_requests as ref_balance_requests
from repro.serve.engine import make_serve_step as ref_make_serve_step
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import (ServeConfig, balance_requests,
                                      make_serve_step, prefill)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small_model():
    """llama3-8b reduced: (reference cfg, reference params, port cfg, port
    params from the reference's)."""
    rcfg = rconfigs.get_reduced("llama3_8b")
    cfg = tconfigs.get_reduced("llama3_8b")
    rp = rmodels.init_params(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, CPU)


def test_serve_step_greedy_matches_argmax(small_model):
    _, _, cfg, params = small_model
    step = make_serve_step(cfg, ServeConfig(batch=2, max_seq=32))
    cache = tmodels.init_cache(cfg, 2, 32, device="cpu")
    tok = torch.tensor([[1], [2]])
    nxt, cache2 = step(params, cache, tok)
    logits = tmodels.forward_train(params, cfg, tok,
                                   compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(nxt[:, 0].numpy(),
                                  logits[:, -1].argmax(-1).numpy())
    assert int(cache2["pos"]) == 1


def test_decode_deterministic(small_model):
    _, _, cfg, params = small_model
    step = make_serve_step(cfg, ServeConfig(batch=1, max_seq=16))

    def rollout():
        cache = tmodels.init_cache(cfg, 1, 16, device="cpu")
        tok = torch.tensor([[3]])
        out = []
        for _ in range(8):
            tok, cache = step(params, cache, tok)
            out.append(int(tok[0, 0]))
        return out

    assert rollout() == rollout()


def test_prefill_then_decode_consistent(small_model):
    """prefill(tokens) leaves the cache that decoding every token one by
    one leaves."""
    _, _, cfg, params = small_model
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (1, 6)))
    cache_a = prefill(params, cfg, toks,
                      tmodels.init_cache(cfg, 1, 16, device="cpu"),
                      compute_dtype=torch.float32)
    cache_b = tmodels.init_cache(cfg, 1, 16, device="cpu")
    for i in range(6):
        _, cache_b = tmodels.forward_decode(params, cfg, toks[:, i: i + 1],
                                            cache_b,
                                            compute_dtype=torch.float32)
    for a, b in zip(ttf.leaves(cache_a), ttf.leaves(cache_b)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert int(cache_a["pos"]) == int(cache_b["pos"]) == 6


def test_serve_step_tokens_equal_reference(small_model):
    """Eight greedy f32 steps from the same prompt: the same tokens as the
    reference's serve step, with an f32 cache in both."""
    rcfg, rp, cfg, params = small_model
    ref_step = jax.jit(ref_make_serve_step(
        rcfg, RefServeConfig(batch=2, max_seq=16, compute_dtype="float32")))
    step = make_serve_step(cfg, ServeConfig(batch=2, max_seq=16,
                                            compute_dtype="float32"))
    rc = rmodels.init_cache(rcfg, 2, 16, kv_dtype=jnp.float32)
    tc = tmodels.init_cache(cfg, 2, 16, kv_dtype=torch.float32, device="cpu")
    rtok, ttok = jnp.asarray([[5], [7]], jnp.int32), torch.tensor([[5], [7]])
    for _ in range(8):
        rtok, rc = ref_step(rp, rc, rtok)
        ttok, tc = step(params, tc, ttok)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok))


def _named_leaves(tree, name=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named_leaves(v, name)
    else:
        yield name, tree


def test_serving_cast_keeps_f32_leaves_and_bits():
    """``serving_params`` casts each weight once where the reference casts
    it at every use, and keeps the leaves the reference reads as f32
    (``F32_LEAVES``: norm scales and biases, Mamba2's decay, step bias,
    skip and gate norm, sLSTM's recurrent weights) f32: two bf16 decode
    steps over the cast tree give the bits of steps over the f32 master.
    Those leaves are moved off their init values by a seeded draw, so a
    bf16 cast of any of them would change the bits.  llama3-8b, zamba2
    and xLSTM reduced: between them every name of ``F32_LEAVES`` that a
    leaf of any architecture bears."""
    seen = set()
    for arch in ("llama3_8b", "zamba2_2_7b", "xlstm_350m"):
        cfg = tconfigs.get_reduced(arch)
        master = tmodels.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        for name, leaf in _named_leaves(master):
            if name in ttf.F32_LEAVES:
                leaf += torch.as_tensor(rng.normal(0.0, 0.1, leaf.shape),
                                        dtype=torch.float32)
        cast = ttf.serving_params(_clone(master), torch.bfloat16)
        kept = {n for n, leaf in _named_leaves(cast)
                if leaf.dtype == torch.float32}
        assert kept and kept <= ttf.F32_LEAVES, arch
        assert all(leaf.dtype == torch.bfloat16
                   for n, leaf in _named_leaves(cast) if n not in kept), arch
        seen |= kept
        tok = torch.tensor([[1], [2]])
        caches = [tmodels.init_cache(cfg, 2, 8, device="cpu")
                  for _ in range(2)]
        for _ in range(2):
            a, caches[0] = tmodels.forward_decode(master, cfg, tok,
                                                  caches[0])
            b, caches[1] = tmodels.forward_decode(cast, cfg, tok, caches[1])
            assert torch.equal(a, b), arch
    borne = {n for arch in rconfigs.ARCH_IDS
             for n, _ in _named_leaves(tmodels.init_params(
                 None, tconfigs.get_reduced(arch)))}
    assert seen == borne & ttf.F32_LEAVES


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_cache_policy_equals_reference(arch):
    for seq in (256, 16_384, 32_768):
        for get_r, get_t in ((rconfigs.get_config, tconfigs.get_config),
                             (rconfigs.get_reduced, tconfigs.get_reduced)):
            assert tserve.cache_policy(get_t(arch), seq) == \
                ref_cache_policy(get_r(arch), seq)


def test_balance_requests_matches_reference():
    """Two ticks at a fixed budget (tolerances 0): the reference's
    placements, moves and warm fraction, and the same deprecation."""
    rng = np.random.default_rng(1)
    n, rep = 40, 6
    load = rng.uniform(1.0, 8.0, n)
    current = rng.integers(0, rep, n)
    gids = np.arange(n)
    kw = dict(max_iters=400, check_every=40, tol_primal=0.0, tol_gap=0.0)
    with pytest.warns(DeprecationWarning, match="balance_requests"):
        old = ref_balance_requests(load, rep, current, pop_k=2,
                                   eps_frac=0.25, solver_kw=kw,
                                   group_ids=gids)
    with pytest.warns(DeprecationWarning, match="balance_requests"):
        new = balance_requests(load, rep, current, pop_k=2, eps_frac=0.25,
                               solver_kw=kw, group_ids=gids, device=CPU)
    np.testing.assert_array_equal(new.placement, old.placement)
    assert new.moved == old.moved
    assert new.warm_fraction == old.warm_fraction
    keep = np.arange(5, n)
    load2 = np.concatenate([load[keep] * 1.05, rng.uniform(1.0, 8.0, 5)])
    cur2 = np.concatenate([old.placement[keep], rng.integers(0, rep, 5)])
    gids2 = np.concatenate([gids[keep], n + np.arange(5)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        old2 = ref_balance_requests(load2, rep, cur2, pop_k=2, eps_frac=0.25,
                                    solver_kw=kw, warm=old, group_ids=gids2)
        new2 = balance_requests(load2, rep, cur2, pop_k=2, eps_frac=0.25,
                                solver_kw=kw, warm=new, group_ids=gids2,
                                device=CPU)
    np.testing.assert_array_equal(new2.placement, old2.placement)
    assert new2.warm_fraction == old2.warm_fraction == 35 / 40
    assert abs(new2.max_load_dev - old2.max_load_dev) < 1e-6


def test_serve_driver_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu``: prefill through
    the decode path, greedy tokens in the vocabulary, finite logits, the
    byte counts from the shapes; the same seed, the same tokens."""
    argv = ["--arch", "llama3_8b", "--reduced", "--batch", "2",
            "--max-seq", "32", "--prompt", "5", "--tokens", "6",
            "--device", "cpu"]
    run = tserve.main(argv)
    assert run.tokens.shape == (2, 6) and run.step_ms is None
    assert bool(((run.tokens >= 0) & (run.tokens < 512)).all())
    assert bool(torch.isfinite(run.final_logits).all())
    cfg = tconfigs.get_reduced("llama3_8b")
    # bf16 matrices read once, the f32 norm scales (two a layer and the
    # final one), the embedding table only gathered (untied unembedding)
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model
    n_table = cfg.vocab * cfg.d_model
    assert run.weight_bytes == (2 * (cfg.param_count() - n_table - n_norm)
                                + 4 * n_norm)
    # k and v: layers x batch x kv heads x slots x head_dim, bf16
    assert run.cache_bytes == 2 * 2 * 2 * 2 * 32 * 16 * 2
    assert torch.equal(tserve.main(argv).tokens, run.tokens)
    assert "llama3-8b-reduced" in capsys.readouterr().out


def test_serve_driver_default_device_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced"])


def test_serve_balanced_example_on_cpu(capsys):
    """The twin of ``examples/serve_balanced.py --fast``: valid placements
    of the churned groups on 4 replicas (the warm tick a plan hit, the
    churn tick a repair) and tokens in the vocabulary for every
    replica."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        "serve_balanced.py"
    spec = importlib.util.spec_from_file_location("serve_balanced_twin",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--fast", "--device", "cpu"])
    placement, load = out["placement"], out["load"]
    assert placement.shape == load.shape
    assert ((placement >= 0) & (placement < out["n_replicas"])).all()
    assert [s.plan_cache for s in out["steps"]] == ["miss", "hit", "repair"]
    vocab = tconfigs.get_reduced("xlstm_350m").vocab
    assert sorted(out["tokens"]) == sorted(set(placement.tolist()))
    for r, toks in out["tokens"].items():
        assert toks.shape[0] == int((placement == r).sum())
        assert bool(((toks >= 0) & (toks < vocab)).all())
    assert "decoded" in capsys.readouterr().out
