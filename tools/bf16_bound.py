"""Readings behind ``repro_torch.testing.bf16_logit_tol``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bf16_bound.py [--seeds 8]
    PYTHONPATH=src python tools/bf16_bound.py --device cuda

The bound on two bf16 evaluations of one model is ``2 e``, ``e`` the
largest distance of a trusted bf16 evaluation from the same path in f32.
Each line is one run: the largest difference divided by ``e`` (the bound
is 2.0 on this scale), for a sound run and for controls, each a defect
patched into the port for the run alone:

* ``rmsnorm-bf16``: RMSNorm computed in bf16 (the reference upcasts);
* ``rmsnorm-eps``: RMSNorm's epsilon 1e-3 instead of 1e-6;
* ``rope-interleaved``: RoPE rotating interleaved pairs, not halves;
* ``f32-leaves-cast``: the serving cast taking every leaf to bf16, the
  leaves the reference reads as f32 too (zamba2, whose Mamba2 leaves are
  not exact in bf16).

On the CPU (the default) the port in bf16 is held against the reference
in bf16 on the reduced architectures, ``e`` from the reference (needs
JAX).  With ``--device cuda``, llama3-8b at full width: the decode path
against teacher forcing in bf16 on 8 x 16 tokens after the serving cast,
``e`` from teacher forcing in bf16 against f32 (TF32 off).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from repro_torch import configs, models, testing
from repro_torch.models import attention, layers, transformer

CONTROLS = ("rmsnorm-bf16", "rmsnorm-eps", "rope-interleaved")


def _rmsnorm_bf16(p, x, eps: float = 1e-6):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + p["scale"].to(x.dtype))


def _rope_interleaved(x, positions, theta: float = 10_000.0):
    freqs = layers._rope_freqs_on(x.shape[-1], float(theta), x.device)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float()[..., 0::2], x.float()[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.flatten(-2).to(x.dtype)


@contextlib.contextmanager
def control(name):
    """The port with one defect, for the block's length."""
    norm, rope = transformer.rmsnorm, attention.apply_rope
    if name == "rmsnorm-bf16":
        transformer.rmsnorm = _rmsnorm_bf16
    elif name == "rmsnorm-eps":
        transformer.rmsnorm = lambda p, x, eps=1e-6: norm(p, x, 1e-3)
    elif name == "rope-interleaved":
        attention.apply_rope = _rope_interleaved
    try:
        yield
    finally:
        transformer.rmsnorm, attention.apply_rope = norm, rope


def _cast(params, all_leaves=False):
    kept = transformer.F32_LEAVES
    transformer.F32_LEAVES = frozenset() if all_leaves else kept
    try:
        return transformer.serving_params(params, torch.bfloat16)
    finally:
        transformer.F32_LEAVES = kept


def _gap(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


def on_cpu(archs, seeds):
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro import models as rmodels
    from repro_torch.interop import params_from_numpy
    B, S = 2, 8
    for arch in archs:
        rcfg, cfg = rconfigs.get_reduced(arch), configs.get_reduced(arch)
        for seed in range(seeds):
            rp = rmodels.init_params(jax.random.PRNGKey(seed), rcfg)
            tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
            toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
            ref = {}
            for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
                train = rmodels.forward_train(
                    rp, rcfg, jnp.asarray(toks, jnp.int32), compute_dtype=dt,
                    remat=False)
                cache = rmodels.init_cache(rcfg, B, S, kv_dtype=dt)
                dec = []
                for i in range(S):
                    lg, cache = rmodels.forward_decode(
                        rp, rcfg, jnp.asarray(toks[:, i: i + 1], jnp.int32),
                        cache, compute_dtype=dt)
                    dec.append(np.asarray(lg[:, 0], np.float32))
                ref[name] = (np.asarray(train, np.float32), np.stack(dec, 1))
            e = _gap(ref["bf16"], ref["f32"])
            runs = [(c, False) for c in ("sound",) + CONTROLS]
            if arch == "zamba2_2_7b":
                runs.append(("f32-leaves-cast", True))
            for name, all_leaves in runs:
                params = _cast(params_from_numpy(tree, cfg, "cpu"), all_leaves)
                with control(name):
                    got = testing.teacher_forcing(
                        params, cfg, torch.as_tensor(toks), torch.bfloat16)
                print(json.dumps({"arch": arch, "seed": seed, "run": name,
                                  "e": e, "gap_over_e":
                                  _gap(got, ref["bf16"]) / e}), flush=True)


def on_card(seed):
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    cfg = configs.get_config("llama3_8b")
    params = models.init_params(torch.Generator(device).manual_seed(seed),
                                cfg)
    prefix = serve.random_prompt(cfg, 8, 16, seed, device)
    f32_train, _ = testing.teacher_forcing(params, cfg, prefix,
                                           torch.float32)
    params = _cast(params)
    for name in ("sound",) + CONTROLS:
        with control(name):
            train, dec = testing.teacher_forcing(params, cfg, prefix,
                                                 torch.bfloat16)
        if name == "sound":
            e, trusted = float((train - f32_train).abs().max()), train
        print(json.dumps({"arch": cfg.name, "seed": seed, "run": name,
                          "e": e, "gap_over_e":
                          float((dec - trusted).abs().max()) / e}),
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--archs", default="llama3_8b,zamba2_2_7b")
    ap.add_argument("--seeds", type=int, default=8)
    a = ap.parse_args(argv)
    if a.device == "cpu":
        on_cpu(a.archs.split(","), a.seeds)
    else:
        on_card(0)


if __name__ == "__main__":
    main()
