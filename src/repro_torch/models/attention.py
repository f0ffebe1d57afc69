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

On a mesh (``ax``, a :class:`~repro_torch.core.placement.ModelAxis`, and
the leaves' ``places``) each rank computes its share of the heads: its
query heads where ``wq`` is split on heads, reading its KV heads (``wk``
and ``wv`` split alike) or the KV heads its query heads group into
(``wk``/``wv`` replicated: their gradient is then partial); where
``wq`` is split on head_dim instead (the heads do not divide the axis),
its head_dim block of ``q``, gathered for the rotation, the attention
computed whole and ``wo`` row-parallel on its head_dim block.  ``wo``
is row-parallel: its partial outputs are summed once.
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


def _core(q, k, v, positions, *, window, softcap, rope_theta: float,
          causal: bool, self_attn: bool, dt):
    """q: [B, S, H, hd], k/v: [B, T, Kv, hd] -> [B, S, H, hd]: rotation
    (self-attention), scores, mask and the weighted values."""
    if self_attn:                          # self-attention: rotate q & k
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _gqa_scores(q, k.transpose(1, 2), scale).float()  # [B,H,S,T]
    logits = _soft_cap(logits, softcap)

    if self_attn:
        qp = positions[:, None, :, None]                    # [B,1,S,1]
        kp = positions[:, None, None, :]                    # [B,1,1,T]
        mask = (qp - kp) < window                           # SWA band
        if causal:
            mask = mask & (kp <= qp)
        logits = torch.where(mask, logits, NEG_INF)

    w = _softmax(logits, dt)
    return _gqa_out(w, v.transpose(1, 2))


def attention_train(p, x, *, window, softcap, rope_theta: float,
                    causal: bool = True, memory=None, positions=None,
                    ax=None, places=None, sp: bool = False):
    """Full-sequence attention (training / prefill).

    ``memory`` switches to cross-attention (keys and values from memory,
    no rotation, no mask).  With ``ax`` (and the leaves' ``places``) ``x``
    is the block's norm output (this rank's sequence slice under ``sp``),
    each rank computes its share of the heads and the result is summed
    over the model axis (see the module docstring)."""
    if ax is not None:
        return _train_on_axis(p, x, ax, places, sp, window=window,
                              softcap=softcap, rope_theta=rope_theta,
                              causal=causal, memory=memory)
    B, S, _ = x.shape
    dt = x.dtype
    q = _project(x, p["wq"].to(dt))
    src = x if memory is None else memory
    k = _project(src, p["wk"].to(dt))
    v = _project(src, p["wv"].to(dt))
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    o = _core(q, k, v, positions, window=window, softcap=softcap,
              rope_theta=rope_theta, causal=causal,
              self_attn=memory is None, dt=dt)
    return _out_proj(o, p["wo"].to(dt))


class Layout(NamedTuple):
    """Where a rank's attention leaves lie on the model axis: the global
    head counts, ``q_dim`` (1: ``wq`` split on heads, 2: on head_dim,
    None: whole; ``wo`` alike), ``kv_split`` (``wk``/``wv`` split on KV
    heads) and this rank's query heads ``(h0, nh)`` and head_dim block
    ``(d0, nd)``."""
    H: int
    Kv: int
    hd: int
    q_dim: Optional[int]
    kv_split: bool
    heads: tuple
    dims: tuple


def layout(p, ax, places) -> Layout:
    q_dim = ax.dim(places["wq"])
    kv_split = ax.dim(places["wk"]) is not None
    o_dim = ax.dim(places["wo"])
    _, Hl, hdl = p["wq"].shape
    H = Hl * ax.size if q_dim == 1 else Hl
    hd = hdl * ax.size if q_dim == 2 else hdl
    Kv = p["wk"].shape[1] * (ax.size if kv_split else 1)
    want_o = {None: None, 1: 0, 2: 1}.get(q_dim, -1)
    if o_dim != want_o or (kv_split and q_dim != 1) or \
            (kv_split and ax.dim(places["wk"]) != 1):
        raise ValueError(
            f"attention leaves wq/wk/wo placed {places['wq']}/"
            f"{places['wk']}/{places['wo']} on {ax}: no split of the heads "
            "fits them")
    heads = ax.block(H) if q_dim == 1 else (0, H)
    dims = ax.block(hd) if q_dim == 2 else (0, hd)
    return Layout(H, Kv, hd, q_dim, kv_split, heads, dims)


def partial_leaves(p, ax, places) -> frozenset:
    """The replicated leaves whose gradient is partial on this rank:
    ``wk``/``wv`` where a rank reads them on the KV heads its query
    heads group into (``wq`` split on heads, ``wk`` not)."""
    lay = layout(p, ax, places)
    if lay.q_dim == 1 and not lay.kv_split:
        return frozenset({"wk", "wv"})
    return frozenset()


def _kv_for_heads(lay: Layout, h0: int, nh: int):
    """The KV heads ``[lo, hi)`` that query heads ``[h0, h0 + nh)`` read,
    and the index of each query head's KV head within them when the
    heads do not group evenly (else None)."""
    g = lay.H // lay.Kv
    lo, hi = h0 // g, (h0 + nh - 1) // g + 1
    even = (nh % g == 0 and h0 % g == 0) or (g % nh == 0 and hi - lo == 1)
    idx = None if even else [h // g - lo for h in range(h0, h0 + nh)]
    return lo, hi, idx


def _pick(t, idx, dim: int):
    return t if idx is None else t[(slice(None),) * dim + (idx,)]


def _train_on_axis(p, x, ax, places, sp, *, window, softcap, rope_theta,
                   causal, memory):
    lay = layout(p, ax, places)
    dt = x.dtype
    hp, hr = ax.enter(x, sp)
    if memory is None:
        src_p, src_r = hp, hr
    else:
        src_p, src_r = ax.copy(memory), memory
    S = hp.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    kw = dict(window=window, softcap=softcap, rope_theta=rope_theta,
              causal=causal, self_attn=memory is None, dt=dt)

    if lay.q_dim is None:                     # every leaf whole
        k = _project(src_r, p["wk"].to(dt))
        v = _project(src_r, p["wv"].to(dt))
        o = _core(_project(hr, p["wq"].to(dt)), k, v, positions, **kw)
        return ax.leave_whole(_out_proj(o, p["wo"].to(dt)), sp)

    if lay.q_dim == 1:                        # this rank's query heads
        q = _project(hp, p["wq"].to(dt))
        if lay.kv_split:
            wk, wv, idx = p["wk"], p["wv"], None
        else:                                 # the KV heads they read
            lo, hi, idx = _kv_for_heads(lay, *lay.heads)
            wk, wv = p["wk"][:, lo:hi], p["wv"][:, lo:hi]
        k = _pick(_project(src_p, wk.to(dt)), idx, 2)
        v = _pick(_project(src_p, wv.to(dt)), idx, 2)
        o = _core(q, k, v, positions, **kw)
    else:                                     # this rank's head_dim block
        q = ax.gather(_project(hp, p["wq"].to(dt)), 3)
        k = _project(src_r, p["wk"].to(dt))
        v = _project(src_r, p["wv"].to(dt))
        o = ax.scatter(_core(q, k, v, positions, **kw), 3)
    return ax.leave(_out_proj(o, p["wo"].to(dt)), sp)


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
                     shard: Optional[CacheShard] = None, ax=None,
                     places=None):
    """One-token decode step.  x: [B, 1, D]; ``pos``: the current position
    (a 0-d integer tensor on x's device).  The new key and value are
    written into ``cache`` in place; returns ``(out, cache)``.

    Cross-attention (``memory`` given) reads the memory directly and
    ignores the cache.  With ``shard`` the cache is this rank's block of
    a cache split over a mesh, and with ``ax`` the rank holds its blocks
    of the leaves (see :func:`_decode_on_block`)."""
    if memory is not None and ax is not None:
        return _train_on_axis(p, x, ax, places, False, window=window,
                              softcap=softcap, rope_theta=rope_theta,
                              causal=False, memory=memory), cache
    if memory is None and (ax is not None or (shard is not None and any(
            shard.mesh.size(i) > 1 for i, _ in shard_dims(shard.places)))):
        return _decode_on_block(p, x, cache, pos, shard, ax, places,
                                window=window, softcap=softcap,
                                rope_theta=rope_theta)
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


def _decode_on_block(p, x, cache: KVCache, pos, shard, ax, places, *,
                     window, softcap, rope_theta: float):
    """:func:`attention_decode` on this rank's block of the cache, which
    may be split over its KV heads, its slots or its head_dim (the
    placements ``kv_cache_specs`` gives), with this rank's blocks of the
    leaves (``ax``).  The block is read and written in place and never
    gathered, and no leaf crosses the mesh; what does is per query head:

    * KV heads: each rank attends with its query heads, which read its KV
      heads;
    * head_dim: each rank attends for every head on its head_dim block,
      the partial scores (f32) are summed over the ranks, and the output's
      head_dim blocks are gathered where ``wo`` wants every head_dim;
    * slots: each rank attends for every head over its own slots, then
      the ranks' maxima, sums and unnormalised outputs are combined (the
      flash-decoding merge).  The new key and value go to the rank whose
      block holds slot ``pos % cache_len``.

    Where the block holds other heads than this rank's query heads, the
    queries of every head are gathered (a few KB a token) and each rank
    keeps its heads' outputs for its rows of ``wo``.  The rounding differs
    from the whole cache's attention where the head_dim or the slots are
    split (partial sums are added in another order)."""
    from torch.distributed.tensor import Replicate, Shard
    B, dt = x.shape[0], x.dtype
    if ax is None:
        _, H, hd = p["wq"].shape
        lay = Layout(H, p["wk"].shape[1], hd, None, False, (0, H), (0, hd))
    else:
        lay = layout(p, ax, places)
    if shard is None:
        mesh, split = None, {1: [], 2: [], 3: []}
        L = cache.k.shape[2]
        (kv0, n_kv), (l0, n_l), (d0, n_d) = (0, lay.Kv), (0, L), (0, lay.hd)
    else:
        mesh, cp = shard.mesh, shard.places
        split = {d: [i for i, dd in shard_dims(cp)
                     if dd == d and mesh.size(i) > 1] for d in (1, 2, 3)}
        L = cache.k.shape[2] * math.prod(mesh.size(i) for i in split[2])
        kv0, n_kv = block_range(lay.Kv, 1, cp, mesh)
        l0, n_l = block_range(L, 2, cp, mesh)
        d0, n_d = block_range(lay.hd, 3, cp, mesh)
    names = () if mesh is None else tuple(mesh.mesh_dim_names)

    def on_model(d):
        return any(names[i] == "model" for i in split[d])

    pos_b = pos.expand(B, 1)
    # the new key and value: the block's KV heads, every head_dim (for the
    # rotation), then the block's head_dim
    if lay.kv_split:
        base, n_w = ax.block(lay.Kv)
        k_new, v_new = (_project(x, p[n].to(dt)) for n in ("wk", "wv"))
        if (kv0, n_kv) != (base, n_w):
            k_new, v_new = ax.gather(k_new, 2), ax.gather(v_new, 2)
            base = 0
    else:
        base = kv0
        k_new, v_new = (_project(x, p[n][:, kv0:kv0 + n_kv].to(dt))
                        for n in ("wk", "wv"))
    k_new = apply_rope(k_new, pos_b, rope_theta)
    slot = torch.remainder(pos, L).view(1) - l0
    inside = (slot >= 0) & (slot < n_l)
    at = slot.clamp(0, n_l - 1)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new[:, :, kv0 - base:kv0 - base + n_kv,
                  d0:d0 + n_d].transpose(1, 2)
        buf.index_copy_(2, at, torch.where(inside, new.to(buf.dtype),
                                           buf.index_select(2, at)))

    # the query heads this rank attends for: its own where the block's KV
    # heads are its own or the block is whole over `model`, else every head
    mine = lay.q_dim == 1 and not (on_model(2) or on_model(3))
    hs0, nhs = lay.heads if mine else (0, lay.H)
    if lay.q_dim == 2:
        q = apply_rope(ax.gather(_project(x, p["wq"].to(dt)), 3), pos_b,
                       rope_theta)
    else:
        q = apply_rope(_project(x, p["wq"].to(dt)), pos_b, rope_theta)
        if lay.q_dim == 1 and not mine:
            q = ax.gather(q, 2)
    lo, hi, idx = _kv_for_heads(lay, hs0, nhs)
    if lo < kv0 or hi > kv0 + n_kv:
        raise ValueError(f"query heads {hs0}..{hs0 + nhs - 1} read KV heads "
                         f"{lo}..{hi - 1} outside the cache block "
                         f"{kv0}..{kv0 + n_kv - 1}")
    ck, cv = (_pick(t[:, lo - kv0:hi - kv0], idx, 1)
              for t in (cache.k, cache.v))
    q = q[:, :, :, d0:d0 + n_d]

    if split[3]:                 # partial dot products: add them in f32
        logits = _gqa_scores(q.float(), ck.float(),
                             1.0 / math.sqrt(lay.hd))
        for i in split[3]:
            dist.all_reduce(logits, group=mesh.get_group(i))
    else:
        logits = _gqa_scores(q, ck.to(dt), 1.0 / math.sqrt(lay.hd)).float()
    logits = _soft_cap(logits, softcap)                      # [B,h,1,Ll]
    age = torch.remainder(
        pos - (l0 + torch.arange(n_l, device=x.device)), L)
    valid = ((pos - age) >= 0) & (age < window)
    logits = torch.where(valid, logits, NEG_INF)

    if not split[2]:
        o = _gqa_out(_softmax(logits, dt), cv.to(dt))       # [B,1,h,hdl]
    else:
        m = logits.amax(-1, keepdim=True)                    # [B,h,1,1]
        e = torch.exp(logits - m)
        s = e.sum(-1, keepdim=True)
        o = _gqa_out(e.to(dt), cv.to(dt)).float()
        for i in split[2]:
            ms, ss, os_ = (_stack_over(t, mesh, i) for t in (m, s, o))
            m = ms.amax(0)
            w = torch.exp(ms - m)                            # 0 off-window
            s = (w * ss).sum(0)
            o = (w.transpose(2, 3) * os_).sum(0)
        o = (o / s.transpose(1, 2)).to(dt)

    if split[3] and not (lay.q_dim == 2 and (d0, n_d) == lay.dims):
        o = gather(o, Places(Shard(3) if i in split[3] else Replicate()
                             for i in range(mesh.ndim)), mesh)  # all hd
    if lay.q_dim == 1 and nhs != lay.heads[1]:
        o = o[:, :, lay.heads[0]:lay.heads[0] + lay.heads[1]]
    elif lay.q_dim == 2 and o.shape[3] == lay.hd:
        o = o[..., lay.dims[0]:lay.dims[0] + lay.dims[1]]
    y = _out_proj(o, p["wo"].to(dt))
    return (y if lay.q_dim is None else ax.reduce(y)), cache
