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
import torch.distributed as dist

from ..core.placement import Places, block_range, gather, shard_dims
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


class CacheShard(NamedTuple):
    """Where a rank's block of a ``[B, Kv, cache_len, hd]`` KV cache lies in
    the whole: the DTensor ``places`` of the leaf on ``mesh``.  Its batch
    dim holds this rank's own rows and is never split here."""
    mesh: object
    places: tuple


def attention_decode(p, x, cache: Optional[KVCache], pos, *, window,
                     softcap, rope_theta: float, memory=None,
                     shard: Optional[CacheShard] = None):
    """One-token decode step.  x: [B, 1, D]; ``pos``: the current position
    (a 0-d integer tensor on x's device).  The new key and value are
    written into ``cache`` in place; returns ``(out, cache)``.

    Cross-attention (``memory`` given) reads the memory directly and
    ignores the cache.  With ``shard`` the cache is this rank's block of
    a cache split over a mesh (see :func:`_decode_on_block`)."""
    if shard is not None and memory is None and any(
            shard.mesh.size(i) > 1 for i, _ in shard_dims(shard.places)):
        return _decode_on_block(p, x, cache, pos, shard, window=window,
                                softcap=softcap, rope_theta=rope_theta)
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


def _stack_over(t, mesh, i: int):
    """``t`` from every rank of mesh dim ``i``, stacked in rank order."""
    out = t.new_empty((mesh.size(i),) + tuple(t.shape))
    dist.all_gather_into_tensor(out, t.unsqueeze(0).contiguous(),
                                group=mesh.get_group(i))
    return out


def _decode_on_block(p, x, cache: KVCache, pos, shard: CacheShard, *,
                     window, softcap, rope_theta: float):
    """:func:`attention_decode` on this rank's block of the cache, which
    may be split over its KV heads, its slots or its head_dim (the
    placements ``kv_cache_specs`` gives).  The block is read and written
    in place and never gathered; what crosses the mesh is per query head:

    * KV heads: each rank attends with the query heads that read its KV
      heads, and the head outputs are gathered;
    * head_dim: each rank's partial scores (f32) are summed over its
      group, and the output's head_dim blocks are gathered;
    * slots: each rank takes the softmax over its own slots, then the
      ranks' maxima, sums and unnormalised outputs are combined (the
      flash-decoding merge).  The new key and value go to the rank whose
      block holds slot ``pos % cache_len``.

    The rounding differs from the whole cache's attention where the
    head_dim or the slots are split (partial sums are added in another
    order); a split over KV heads alone computes each head as the whole
    cache does."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, places = shard.mesh, shard.places
    B, dt = x.shape[0], x.dtype
    H, hd = p["wq"].shape[1], p["wq"].shape[2]
    Kv = p["wk"].shape[1]
    g = H // Kv
    split = {d: [i for i, dd in shard_dims(places)
                 if dd == d and mesh.size(i) > 1] for d in (1, 2, 3)}
    L = cache.k.shape[2] * math.prod(mesh.size(i) for i in split[2])
    kv0, n_kv = block_range(Kv, 1, places, mesh)
    l0, n_l = block_range(L, 2, places, mesh)
    d0, n_d = block_range(hd, 3, places, mesh)

    pos_b = pos.expand(B, 1)
    q = apply_rope(_project(x, p["wq"].to(dt)), pos_b, rope_theta)
    q = q[:, :, kv0 * g:(kv0 + n_kv) * g, d0:d0 + n_d]
    k_new = apply_rope(_project(x, p["wk"].to(dt)), pos_b, rope_theta)
    v_new = _project(x, p["wv"].to(dt))

    slot = torch.remainder(pos, L).view(1) - l0
    inside = (slot >= 0) & (slot < n_l)
    at = slot.clamp(0, n_l - 1)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new[:, :, kv0:kv0 + n_kv, d0:d0 + n_d].transpose(1, 2)
        buf.index_copy_(2, at, torch.where(inside, new.to(buf.dtype),
                                           buf.index_select(2, at)))

    if split[3]:                 # partial dot products: add them in f32
        logits = _gqa_scores(q.float(), cache.k.float(), 1.0 / math.sqrt(hd))
        for i in split[3]:
            dist.all_reduce(logits, group=mesh.get_group(i))
    else:
        logits = _gqa_scores(q, cache.k.to(dt), 1.0 / math.sqrt(hd)).float()
    logits = _soft_cap(logits, softcap)                      # [B,Hl,1,Ll]
    age = torch.remainder(
        pos - (l0 + torch.arange(n_l, device=x.device)), L)
    valid = ((pos - age) >= 0) & (age < window)
    logits = torch.where(valid, logits, NEG_INF)

    if not split[2]:
        o = _gqa_out(_softmax(logits, dt), cache.v.to(dt))  # [B,1,Hl,hdl]
    else:
        m = logits.amax(-1, keepdim=True)                    # [B,Hl,1,1]
        e = torch.exp(logits - m)
        s = e.sum(-1, keepdim=True)
        o = _gqa_out(e.to(dt), cache.v.to(dt)).float()
        for i in split[2]:
            ms, ss, os_ = (_stack_over(t, mesh, i) for t in (m, s, o))
            m = ms.amax(0)
            w = torch.exp(ms - m)                            # 0 off-window
            s = (w * ss).sum(0)
            o = (w.transpose(2, 3) * os_).sum(0)
        o = (o / s.transpose(1, 2)).to(dt)

    o_places = Places(Shard(2) if i in split[1] else
                      Shard(3) if i in split[3] else Replicate()
                      for i in range(len(places)))
    o = gather(o, o_places, mesh)                            # [B,1,H,hd]
    return _out_proj(o, p["wo"].to(dt)), cache
