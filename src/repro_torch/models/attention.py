"""Attention: GQA/MQA/MHA with RoPE, sliding windows, logit soft-capping,
causal and bidirectional modes, cross-attention and KV-cached decoding —
the port of ``repro/models/attention.py``.

* ``window`` is a per-layer number (``window >= seq`` means full
  attention; decode passes ``2**31`` as a float), so a local:global
  pattern is one code path with exact masking.
* Decode keeps a ring-buffer cache of ``cache_len = min(seq, window)``
  slots for SWA layers: slot ``pos % cache_len`` takes the new key and
  value, written in place (the counterpart of the reference's donated
  cache).
* Soft-capping (gemma2) is tanh-based and applied before the softmax;
  logits and softmax are f32, cast back to the compute dtype after.

Layout: the cache holds ``[B, Kv, cache_len, hd]`` (the reference's is
``[B, cache_len, Kv, hd]``; ``interop.cache_from_numpy`` transposes).  A
query head ``h`` reads KV head ``h // group``, the reference's
``_expand_kv`` mapping; the port groups the query heads per KV head
(``[B, Kv, group * S, hd]``) and multiplies against the cache as it lies,
instead of materialising the KV heads ``group`` times.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .layers import apply_rope, normal

NEG_INF = -2.0 ** 30


def init_attention(gen, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int):
    s = 1.0 / math.sqrt(d_model)
    so = 1.0 / math.sqrt(n_heads * head_dim)
    return {
        "wq": normal(gen, (d_model, n_heads, head_dim), s),
        "wk": normal(gen, (d_model, n_kv, head_dim), s),
        "wv": normal(gen, (d_model, n_kv, head_dim), s),
        "wo": normal(gen, (n_heads, head_dim, d_model), so),
    }


def _soft_cap(logits, cap):
    """gemma2 logit soft-capping; ``cap <= 0`` disables it."""
    cap = float(cap)
    if cap <= 0.0:
        return logits
    return torch.tanh(logits / max(cap, 1e-6)) * cap


def _project(x, w):
    """x: [B, S, D], w: [D, H, hd] -> [B, S, H, hd]."""
    B, S, _ = x.shape
    return torch.matmul(x, w.flatten(1)).view(B, S, w.shape[1], w.shape[2])


def _grouped(q, n_kv: int):
    """[B, S, H, hd] -> [B, Kv, group * S, hd]: the query heads that read
    one KV head, side by side."""
    B, S, H, hd = q.shape
    g = H // n_kv
    return q.view(B, S, n_kv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        B, n_kv, g * S, hd)


def _gqa_scores(q, k, scale: float):
    """q: [B, S, H, hd], k: [B, Kv, T, hd] -> [B, H, S, T]."""
    B, S, H, _ = q.shape
    Kv, T = k.shape[1], k.shape[2]
    s = torch.matmul(_grouped(q * scale, Kv), k.transpose(-1, -2))
    return s.view(B, H, S, T)


def _gqa_out(w, v):
    """w: [B, H, S, T], v: [B, Kv, T, hd] -> [B, S, H, hd]."""
    B, H, S, T = w.shape
    Kv, hd = v.shape[1], v.shape[3]
    o = torch.matmul(w.reshape(B, Kv, (H // Kv) * S, T), v)
    return o.view(B, H, S, hd).transpose(1, 2)


def _out_proj(o, wo):
    """o: [B, S, H, hd], wo: [H, hd, D] -> [B, S, D]."""
    return torch.matmul(o.flatten(2), wo.flatten(0, 1))


def _softmax(logits, dt):
    return torch.softmax(logits, dim=-1).to(dt)


def attention_train(p, x, *, window, softcap, rope_theta: float,
                    causal: bool = True, memory=None, positions=None):
    """Full-sequence attention (training / prefill).

    ``memory`` switches to cross-attention (keys and values from memory,
    no rotation, no mask)."""
    B, S, _ = x.shape
    dt = x.dtype
    q = _project(x, p["wq"].to(dt))
    src = x if memory is None else memory
    k = _project(src, p["wk"].to(dt))
    v = _project(src, p["wv"].to(dt))
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if memory is None:                     # self-attention: rotate q & k
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _gqa_scores(q, k.transpose(1, 2), scale).float()  # [B,H,S,T]
    logits = _soft_cap(logits, softcap)

    if memory is None:
        qp = positions[:, None, :, None]                    # [B,1,S,1]
        kp = positions[:, None, None, :]                    # [B,1,1,T]
        mask = (qp - kp) < window                           # SWA band
        if causal:
            mask = mask & (kp <= qp)
        logits = torch.where(mask, logits, NEG_INF)

    w = _softmax(logits, dt)
    o = _gqa_out(w, v.transpose(1, 2))
    return _out_proj(o, p["wo"].to(dt))


class KVCache(NamedTuple):
    """Ring-buffer KV cache.  ``k``/``v``: ``[B, Kv, cache_len, hd]``
    (under a segment, with a leading ``[n_periods]`` axis).  For SWA layers
    ``cache_len == window``; writes wrap (``slot = pos % cache_len``)."""
    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, B, cache_len, n_kv, head_dim, dtype=torch.bfloat16,
              device=None, periods: Optional[int] = None):
        shape = (B, n_kv, cache_len, head_dim)
        if periods is not None:
            shape = (periods,) + shape
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(p, x, cache: Optional[KVCache], pos, *, window,
                     softcap, rope_theta: float, memory=None):
    """One-token decode step.  x: [B, 1, D]; ``pos``: the current position
    (a 0-d integer tensor on x's device).  The new key and value are
    written into ``cache`` in place; returns ``(out, cache)``.

    Cross-attention (``memory`` given) reads the memory directly and
    ignores the cache."""
    B = x.shape[0]
    dt = x.dtype
    scale = 1.0 / math.sqrt(p["wq"].shape[-1])
    q = _project(x, p["wq"].to(dt))

    if memory is not None:
        k = _project(memory, p["wk"].to(dt)).transpose(1, 2)
        v = _project(memory, p["wv"].to(dt)).transpose(1, 2)
        logits = _soft_cap(_gqa_scores(q, k, scale).float(), softcap)
        return _out_proj(_gqa_out(_softmax(logits, dt), v),
                         p["wo"].to(dt)), cache

    pos_b = pos.expand(B, 1)
    q = apply_rope(q, pos_b, rope_theta)
    k_new = apply_rope(_project(x, p["wk"].to(dt)), pos_b, rope_theta)
    v_new = _project(x, p["wv"].to(dt))

    L = cache.k.shape[2]
    slot = torch.remainder(pos, L).view(1)
    cache.k.index_copy_(2, slot, k_new.transpose(1, 2).to(cache.k.dtype))
    cache.v.index_copy_(2, slot, v_new.transpose(1, 2).to(cache.v.dtype))

    logits = _gqa_scores(q, cache.k.to(dt), scale).float()
    logits = _soft_cap(logits, softcap)                      # [B,H,1,L]

    # ring-buffer validity: slot s holds absolute position p_s with
    # p_s = pos - ((pos - s) mod L); valid iff p_s >= 0 and pos - p_s <
    # window
    age = torch.remainder(pos - torch.arange(L, device=x.device), L)
    valid = ((pos - age) >= 0) & (age < window)
    logits = torch.where(valid, logits, NEG_INF)

    o = _gqa_out(_softmax(logits, dt), cache.v.to(dt))
    return _out_proj(o, p["wo"].to(dt)), cache
