"""Base layers: norms, embeddings, RoPE, gated MLPs — the port of
``repro/models/layers.py``.

Functional style, as in the reference: ``init_*`` returns a dict of
tensors, the apply functions consume it.  Parameters are drawn from an
explicit ``torch.Generator`` on the generator's device; ``gen=None`` gives
shapes only, on the meta device (``ArchCfg.param_count``).

Dtype policy (the reference's): parameters are stored f32, activations are
computed in the compute dtype and each weight is cast where it is used.
A cast of a tensor already in the compute dtype is free, so serving casts
its matrices once (``transformer.serving_params``) and every later use
reads them as they are.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def normal(gen: Optional[torch.Generator], shape, scale: float = 1.0):
    """``scale`` times a standard normal draw of ``shape`` in f32 on the
    generator's device, or an f32 meta tensor of that shape when ``gen`` is
    None."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x if scale == 1.0 else x.mul_(scale)


def zeros(gen: Optional[torch.Generator], shape):
    return torch.zeros(shape, dtype=torch.float32,
                       device="meta" if gen is None else gen.device)


def ones(gen: Optional[torch.Generator], shape):
    return torch.ones(shape, dtype=torch.float32,
                      device="meta" if gen is None else gen.device)


def cast(p, dtype):
    """Every tensor leaf of a nested dict/list/tuple cast to ``dtype``."""
    if isinstance(p, dict):
        return {k: cast(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(cast(v, dtype) for v in p)
    return p.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(gen, d: int):
    return {"scale": zeros(gen, (d,))}              # (1 + scale) convention


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].float())).to(dt)


def init_layernorm(gen, d: int):
    return {"scale": ones(gen, (d,)), "bias": zeros(gen, (d,))}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"] + p["bias"]).to(dt)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int):
    return {"table": normal(gen, (vocab, d), 0.02)}


def embed(p, tokens, compute_dtype=torch.bfloat16):
    """Rows of the table in the compute dtype.  The reference casts the
    whole table and then gathers; gathering first and casting the rows is
    the same result without a table-sized cast every step (the backward
    then sums a token's gradients in f32, where the reference sums them
    in the compute dtype).  ``F.embedding``'s backward adds each row's
    gradients in a fixed order on the CPU and the card, so a step is
    bit-reproducible; indexing's backward (``index_put_`` with
    accumulate) adds them with atomics on a multi-threaded CPU."""
    return F.embedding(tokens.long(), p["table"]).to(compute_dtype)


def unembed(p, x):
    """Logits against the (possibly tied) embedding table."""
    return torch.matmul(x, p["table"].to(x.dtype).t())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10_000.0):
    return theta ** (-np.arange(0, head_dim // 2, dtype=np.float32)
                     / (head_dim // 2))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` as a tensor on ``device``, copied there once (a copy
    from host memory each call would wait for the device every layer)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, hd]; positions: [..., S] integers.  Rotates the two
    halves of the head dimension (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., :, None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def activation_fn(activation: str):
    """SiLU, or GELU with the tanh approximation (the reference's
    ``jax.nn.gelu(approximate=True)``)."""
    if activation == "silu":
        return F.silu
    return lambda a: F.gelu(a, approximate="tanh")


def init_mlp(gen, d: int, d_ff: int):
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": normal(gen, (d, d_ff), s_in),
        "w_up": normal(gen, (d, d_ff), s_in),
        "w_down": normal(gen, (d_ff, d), s_out),
    }


def mlp(p, x, activation: str = "silu"):
    dt = x.dtype
    g = torch.matmul(x, p["w_gate"].to(dt))
    u = torch.matmul(x, p["w_up"].to(dt))
    h = activation_fn(activation)(g) * u
    return torch.matmul(h, p["w_down"].to(dt))


def init_dense(gen, d_in: int, d_out: int):
    return {"w": normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in))}


def dense(p, x):
    return torch.matmul(x, p["w"].to(x.dtype))
