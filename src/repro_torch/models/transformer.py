"""Composable decoder and encoder-decoder stacks over heterogeneous blocks —
the port of ``repro/models/transformer.py``.

The unit of composition is a **period**, a short sequence of blocks (e.g.
gemma3's [local x5, global], gemma2's [local, global], zamba2's
[mamba x6, shared-attn]); a **segment** stacks ``n_periods`` identical
periods.  Parameters are nested dicts of tensors whose leaf paths are the
reference's (``segments.0.b0.mixer.wq``, ...), and a segment's leaves carry
a leading ``[n_periods]`` axis, as the reference's scanned stacks do; a
loop over the periods takes the place of ``lax.scan`` (each period reads a
view of the stacked leaves).  Under autograd ``forward_train`` recomputes
each period in its backward (``remat``, the reference's ``jax.checkpoint``
around the scanned body), so a step keeps one residual a period.

Weight-shared blocks (zamba2's shared attention) live outside the stacked
parameters and are applied once a period with the same weights, while
their KV caches stay per application (stacked on the period axis).

Decode caches are written in place: the KV ring buffers by
``attention_decode``, the recurrent states by copying each block's new
state into its period's slot.  ``init_cache``'s ``kv_dtype`` must match
the compute dtype (see its docstring).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.placement import Places, gather_leaf, local_slice, zip_map
from ..core.problem import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .attention import KVCache
from .layers import (dense, embed, init_dense, init_embedding, init_mlp,
                     init_rmsnorm, mlp, rmsnorm, unembed)

# leaves the reference reads in f32 whatever the compute dtype: norm
# scales and biases, Mamba2's decay, step bias, skip and gate-norm scale,
# and sLSTM's recurrent weights (multiplied with its f32 state)
F32_LEAVES = frozenset({"scale", "bias", "a_log", "dt_bias", "d_skip",
                        "norm_scale", "r"})


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockCfg:
    mixer: str = "attn"          # attn | mamba2 | mlstm | slstm | shared_attn
    ffn: str = "dense"           # dense | moe | none
    window: Optional[int] = None  # None = full attention (SWA band otherwise)
    cross_attn: bool = False     # decoder block with encoder cross-attention


@dataclasses.dataclass(frozen=True)
class Segment:
    period: tuple                # tuple[BlockCfg, ...]
    n_periods: int


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    """The reference's sharding knobs and the mesh the model runs on.

    ``mesh`` with ``places`` (and ``cache_places`` for decode) is the
    port's sharded step: parameters (and cache leaves) come in as this
    rank's blocks, ``places`` holds each leaf's DTensor placements, and
    the model gathers a period's parameter blocks whole where it uses
    them (``gathered``; inside the period's ``checkpoint``, so remat
    gathers them again in the backward).  Attention reads its KV cache
    block where it lies (``attention.attention_decode(shard=)``).

    ``sp_residual``, ``gather_once`` and ``bf16_barrier`` are kept so the
    reference's configurations construct, and do nothing: the port's
    sharded steps run every op on local tensors (this rank's rows, the
    parameters gathered whole), where the reference's
    ``with_sharding_constraint`` has nothing to act on, and eager ops are
    never re-ordered.  ``launch.perf`` refuses them.
    ``cache_seq_on_model`` acts where the cache is placed
    (``kv_cache_specs(seq_on_model=)`` in ``serve.engine.jit_serve_step``).
    With ``mesh=None`` every knob is a no-op, as in the reference."""
    sp_residual: bool = False
    bf16_barrier: bool = False
    gather_once: bool = False
    cache_seq_on_model: bool = False
    mesh: object = None
    places: object = None
    cache_places: object = None

    def gathered(self, tree, places):
        """``tree``'s blocks gathered whole under ``places`` (a no-op
        without a mesh or placements)."""
        if self.mesh is None or places is None:
            return tree
        return zip_map(lambda t, pl: gather_leaf(t, pl, self.mesh), tree,
                       places)


def _unstacked(places, rows_local: bool = False):
    """A stacked leaf's placements for one period's view (the leading
    period axis dropped; it is never sharded).  ``rows_local``: a cache's
    batch dim stays this rank's rows (each data rank decodes its own
    rows), so it is neither gathered nor sliced."""
    from torch.distributed.tensor import Replicate, Shard

    def one(pl):
        out = []
        for p in pl:
            if p.is_shard():
                if p.dim == 0:
                    raise ValueError("a stacked leaf sharded on its "
                                     "period axis")
                p = (Replicate() if rows_local and p.dim == 1
                     else Shard(p.dim - 1))
            out.append(p)
        return Places(out)
    if places is None:
        return None
    return zip_map(one, places)


DEFAULT_OPTS = ModelOpts()


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    name: str
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    segments: tuple               # decoder/main stack
    enc_segments: tuple = ()      # encoder stack (enc-dec archs)
    softcap: float = 0.0
    rope_theta: float = 10_000.0
    act: str = "silu"
    tied_embeddings: bool = True
    moe: Optional[MoECfg] = None
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    frontend: Optional[str] = None   # None | "audio" | "vision"
    family: str = "dense"            # dense | moe | hybrid | ssm | audio | vlm
    # which shapes are runnable (long_500k needs sub-quadratic attention)
    supports_long: bool = False

    @property
    def n_layers(self) -> int:
        return sum(len(s.period) * s.n_periods for s in self.segments)

    def param_count(self) -> int:
        """Parameter count from the shapes ``init_params`` gives (drawn on
        the meta device: no memory, no random numbers)."""
        return sum(t.numel() for t in leaves(init_params(None, self)))


def leaves(tree):
    """The tensors of a nested dict/list/tuple, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def serving_params(params, compute_dtype=torch.bfloat16):
    """``params`` with every leaf the reference casts at its use cast to
    ``compute_dtype`` once, and the ``F32_LEAVES`` kept f32 (the reference
    reads those as f32, so casting them would change the result).  Leaves
    are replaced one at a time, so a caller that drops its own reference to
    ``params`` holds at most one f32 leaf beside the cast tree."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            for k in list(tree):
                tree[k] = walk(tree[k], k)
            return tree
        if isinstance(tree, list):
            for i, v in enumerate(tree):
                tree[i] = walk(v, name)
            return tree
        return tree if name in F32_LEAVES else tree.to(compute_dtype)
    return walk(params)


# ---------------------------------------------------------------------------
# per-block init/apply
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ArchCfg, bcfg: BlockCfg):
    p = {"norm1": init_rmsnorm(gen, cfg.d_model)}
    if bcfg.mixer == "attn":
        p["mixer"] = attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    elif bcfg.mixer == "mamba2":
        p["mixer"] = ssm_mod.init_mamba2(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
            cfg.ssm_head_dim)
    elif bcfg.mixer == "mlstm":
        p["mixer"] = xlstm_mod.init_mlstm(gen, cfg.d_model, cfg.n_heads)
    elif bcfg.mixer == "slstm":
        p["mixer"] = xlstm_mod.init_slstm(gen, cfg.d_model, cfg.n_heads)
    elif bcfg.mixer != "shared_attn":      # shared weights live outside
        raise ValueError(bcfg.mixer)

    if bcfg.cross_attn:
        p["norm_cross"] = init_rmsnorm(gen, cfg.d_model)
        p["cross"] = attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim)

    if bcfg.ffn == "dense":
        p["norm2"] = init_rmsnorm(gen, cfg.d_model)
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
    elif bcfg.ffn == "moe":
        m = cfg.moe
        p["norm2"] = init_rmsnorm(gen, cfg.d_model)
        p["ffn"] = moe_mod.init_moe(gen, cfg.d_model, m.d_ff_expert,
                                    m.n_experts, m.n_shared, m.d_ff_shared)
    return p


def _mixer_cache_init(cfg: ArchCfg, bcfg: BlockCfg, batch: int, seq: int,
                      periods: int, kv_dtype, device):
    """Zero cache for one block position of a segment, stacked over its
    periods.  SWA layers get window-sized ring buffers."""
    if bcfg.mixer in ("attn", "shared_attn"):
        cache_len = min(seq, bcfg.window) if bcfg.window else seq
        return KVCache.zeros(batch, cache_len, cfg.n_kv, cfg.head_dim,
                             dtype=kv_dtype, device=device, periods=periods)
    if bcfg.mixer == "mamba2":
        shapes = ssm_mod.init_mamba2(None, cfg.d_model, cfg.ssm_state,
                                     cfg.ssm_expand, cfg.ssm_head_dim)
        state = ssm_mod.mamba2_init_state(shapes, batch, device=device)
    elif bcfg.mixer == "mlstm":
        shapes = xlstm_mod.init_mlstm(None, cfg.d_model, cfg.n_heads)
        state = xlstm_mod.mlstm_init_state(shapes, batch, device=device)
    elif bcfg.mixer == "slstm":
        shapes = xlstm_mod.init_slstm(None, cfg.d_model, cfg.n_heads)
        state = xlstm_mod.slstm_init_state(shapes, batch, device=device)
    else:
        raise ValueError(bcfg.mixer)
    return {k: v.expand(periods, *v.shape).clone() for k, v in state.items()}


def _mixer_train(p, cfg, bcfg, h, shared_attn_params, window, causal):
    if bcfg.mixer in ("attn", "shared_attn"):
        mp = p["mixer"] if bcfg.mixer == "attn" else shared_attn_params
        return attn_mod.attention_train(
            mp, h, window=window, softcap=cfg.softcap,
            rope_theta=cfg.rope_theta, causal=causal)
    if bcfg.mixer == "mamba2":
        return ssm_mod.mamba2_train(p["mixer"], h)
    if bcfg.mixer == "mlstm":
        return xlstm_mod.mlstm_train(p["mixer"], h)
    return xlstm_mod.slstm_train(p["mixer"], h)


def _ffn(p, cfg: ArchCfg, bcfg: BlockCfg, x):
    if bcfg.ffn == "dense":
        return x + mlp(p["ffn"], rmsnorm(p["norm2"], x), cfg.act)
    if bcfg.ffn == "moe":
        return x + moe_mod.moe(p["ffn"], rmsnorm(p["norm2"], x),
                               top_k=cfg.moe.top_k,
                               capacity_factor=cfg.moe.capacity_factor,
                               activation=cfg.act)
    return x


def _apply_block_train(p, cfg: ArchCfg, bcfg: BlockCfg, x,
                       shared_attn_params, memory=None, causal=True):
    window = float(bcfg.window) if bcfg.window else float(x.shape[1] + 1)
    h = rmsnorm(p["norm1"], x)
    x = x + _mixer_train(p, cfg, bcfg, h, shared_attn_params, window, causal)
    if bcfg.cross_attn:
        h = rmsnorm(p["norm_cross"], x)
        x = x + attn_mod.attention_train(
            p["cross"], h, window=float(memory.shape[1] + 1),
            softcap=cfg.softcap, rope_theta=cfg.rope_theta,
            causal=False, memory=memory)
    return _ffn(p, cfg, bcfg, x)


def _apply_block_decode(p, cfg: ArchCfg, bcfg: BlockCfg, x, cache, pos,
                        shared_attn_params, memory=None, shard=None):
    """One block at one position.  A KV cache is written in place (on a
    mesh ``shard`` says where its block lies); a recurrent state comes
    back new.  Returns ``(x, cache)``."""
    window = float(bcfg.window) if bcfg.window else 2.0 ** 31
    h = rmsnorm(p["norm1"], x)
    if bcfg.mixer in ("attn", "shared_attn"):
        mp = p["mixer"] if bcfg.mixer == "attn" else shared_attn_params
        h, cache = attn_mod.attention_decode(
            mp, h, cache, pos, window=window, softcap=cfg.softcap,
            rope_theta=cfg.rope_theta, shard=shard)
    elif bcfg.mixer == "mamba2":
        h, cache = ssm_mod.mamba2_decode(p["mixer"], h, cache)
    elif bcfg.mixer == "mlstm":
        h, cache = xlstm_mod.mlstm_decode(p["mixer"], h, cache)
    elif bcfg.mixer == "slstm":
        h, cache = xlstm_mod.slstm_decode(p["mixer"], h, cache)
    x = x + h

    if bcfg.cross_attn:
        h = rmsnorm(p["norm_cross"], x)
        h, _ = attn_mod.attention_decode(
            p["cross"], h, cache=None, pos=pos, window=2.0 ** 31,
            softcap=cfg.softcap, rope_theta=cfg.rope_theta, memory=memory)
        x = x + h
    return _ffn(p, cfg, bcfg, x), cache


# ---------------------------------------------------------------------------
# segments (a loop over stacked periods)
# ---------------------------------------------------------------------------

def _period(tree, i: int):
    """The ``i``-th period's view of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(tree.k[i], tree.v[i])
    return tree[i]


def _stacked_like(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _set_period(stacked, tree, i: int):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _set_period(stacked[k], v, i)
    else:
        stacked[i].copy_(tree)


def _whole(tree):
    return tree


def _init_segment(gen, cfg: ArchCfg, seg: Segment, keep=_whole):
    """Stacked period params: leaves get a leading [n_periods] axis.  Each
    period is drawn, handed to ``keep`` and copied into its slot in turn,
    so at most one period's draws live beside the stack."""
    def one_period():
        return keep({f"b{i}": _init_block(gen, cfg, b)
                     for i, b in enumerate(seg.period)})
    first = one_period()
    stacked = _stacked_like(first, seg.n_periods)
    _set_period(stacked, first, 0)
    del first
    for n in range(1, seg.n_periods):
        _set_period(stacked, one_period(), n)
    return stacked


def _periods(tree, n: int) -> list:
    """The ``n`` period views of a stacked tree, each leaf split once by
    ``unbind``: its backward stacks the periods' gradients into the
    stacked leaf in one copy (``tree[i]`` would add a zero-filled stack
    per period)."""
    if isinstance(tree, dict):
        per_key = {k: _periods(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _segment_train(seg_params, cfg: ArchCfg, seg: Segment, x,
                   shared_attn_params, memory=None, causal=True,
                   remat: bool = True, opts=DEFAULT_OPTS, places=None):
    """The segment's periods in turn.  With ``remat`` and autograd on, each
    period's blocks run under ``checkpoint``: the backward keeps only the
    period's input and recomputes the rest (no random numbers are drawn,
    so no generator state is kept).  On a mesh (``places`` the stacked
    leaves' placements) a period's blocks are gathered inside its
    checkpoint, so the backward gathers them again."""
    period_places = _unstacked(places)

    def body(h, pp):
        pp = opts.gathered(pp, period_places)
        for i, b in enumerate(seg.period):
            h = _apply_block_train(pp[f"b{i}"], cfg, b, h,
                                   shared_attn_params, memory, causal)
        return h

    recompute = remat and torch.is_grad_enabled()
    for pp in _periods(seg_params, seg.n_periods):
        x = (checkpoint(body, x, pp, use_reentrant=False,
                        preserve_rng_state=False)
             if recompute else body(x, pp))
    return x


def _segment_decode(seg_params, cfg: ArchCfg, seg: Segment, x, seg_cache,
                    pos, shared_attn_params, memory=None, opts=DEFAULT_OPTS,
                    places=None, cache_places=None):
    """The segment's periods in turn, each cache slot written in place.  On
    a mesh a period's parameter blocks are gathered whole; attention reads
    and writes its KV cache block where it lies, and a recurrent state's
    block is gathered whole and this rank's block of the new state copied
    back."""
    period_places = _unstacked(places)
    cache_period = _unstacked(cache_places, rows_local=True)
    for n in range(seg.n_periods):
        pp = opts.gathered(_period(seg_params, n), period_places)
        for i, b in enumerate(seg.period):
            stacked = seg_cache[f"b{i}"]
            c_places = None if cache_period is None else cache_period[f"b{i}"]
            if isinstance(stacked, KVCache):
                shard = (None if c_places is None else
                         attn_mod.CacheShard(opts.mesh, c_places.k))
                x, _ = _apply_block_decode(
                    pp[f"b{i}"], cfg, b, x, _period(stacked, n), pos,
                    shared_attn_params, memory, shard)
                continue
            state = opts.gathered(_period(stacked, n), c_places)
            x, c = _apply_block_decode(pp[f"b{i}"], cfg, b, x, state, pos,
                                       shared_attn_params, memory)
            for key, v in c.items():
                stacked[key][n].copy_(v if c_places is None else local_slice(
                    v, c_places[key], opts.mesh))
    return x


def _init_segment_cache(cfg: ArchCfg, seg: Segment, batch: int, seq: int,
                        kv_dtype, device):
    return {f"b{i}": _mixer_cache_init(cfg, b, batch, seq, seg.n_periods,
                                       kv_dtype, device)
            for i, b in enumerate(seg.period)}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _has_shared_attn(cfg: ArchCfg) -> bool:
    return any(b.mixer == "shared_attn"
               for s in cfg.segments for b in s.period)


def init_params(gen: Optional[torch.Generator], cfg: ArchCfg, keep=_whole):
    """f32 parameters drawn from ``gen`` on its device (``gen=None``:
    shapes only, on the meta device).  The draws are the port's own; the
    tests carry the reference's parameters across with
    ``interop.params_from_numpy``.

    ``keep(subtree) -> subtree`` sees each part as it is drawn (one
    period of a stack, or one top-level entry such as the embedding) and
    returns what to keep of it, so a caller can keep one rank's blocks
    and free the rest (``train.train_step.init_placed_params``); a stack
    is built from what ``keep`` returns.  The draws do not depend on it."""
    p = {
        "embed": keep(init_embedding(gen, cfg.vocab, cfg.d_model)),
        "final_norm": keep(init_rmsnorm(gen, cfg.d_model)),
        "segments": [_init_segment(gen, cfg, s, keep) for s in cfg.segments],
    }
    if not cfg.tied_embeddings:
        p["unembed"] = keep(init_dense(gen, cfg.d_model, cfg.vocab))
    if _has_shared_attn(cfg):
        p["shared_attn"] = keep(attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim))
    if cfg.enc_segments:
        p["enc_segments"] = [_init_segment(gen, cfg, s, keep)
                             for s in cfg.enc_segments]
        p["enc_norm"] = keep(init_rmsnorm(gen, cfg.d_model))
    if cfg.frontend is not None:
        # modality stub: a linear adapter over precomputed frame/patch
        # embeddings, as in the reference
        p["frontend"] = keep(init_dense(gen, cfg.d_model, cfg.d_model))
    return p


def _encode(params, cfg: ArchCfg, enc_embeddings, remat: bool = True,
            opts=DEFAULT_OPTS, places=None):
    x = (dense(params["frontend"], enc_embeddings) if cfg.frontend
         else enc_embeddings)
    seg_places = (places or {}).get("enc_segments") or [None] * len(
        cfg.enc_segments)
    for seg_p, seg, sp in zip(params["enc_segments"], cfg.enc_segments,
                              seg_places):
        x = _segment_train(seg_p, cfg, seg, x, None, causal=False,
                           remat=remat, opts=opts, places=sp)
    return rmsnorm(params["enc_norm"], x)


_STACKED = ("segments", "enc_segments")


def _gather_unstacked(params, opts):
    """``params`` with every leaf outside the stacked segments gathered
    whole (the embedding, norms, shared attention, frontend); the segments
    are gathered a period at a time where they are used."""
    if opts.mesh is None or opts.places is None:
        return params
    return {k: v if k in _STACKED else opts.gathered(v, opts.places[k])
            for k, v in params.items()}


def _seg_places(opts, key: str, n: int):
    if opts.places is None:
        return [None] * n
    return opts.places[key]


def _embed_scaled(params, cfg: ArchCfg, tokens, compute_dtype):
    x = embed(params["embed"], tokens, compute_dtype)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)


def _logits(params, cfg: ArchCfg, x):
    x = rmsnorm(params["final_norm"], x)
    if cfg.tied_embeddings:
        return unembed(params["embed"], x)
    return dense(params["unembed"], x)


def forward_train(params, cfg: ArchCfg, tokens, enc_embeddings=None,
                  remat: bool = True, compute_dtype=torch.bfloat16,
                  unroll: bool = False, opts=DEFAULT_OPTS):
    """Logits for next-token prediction.  tokens: [B, S] integers.

    ``remat`` recomputes each period in the backward when autograd is on
    (the reference's per-period ``jax.checkpoint``); without autograd it
    changes nothing.  ``unroll`` is accepted and changes nothing: the
    reference unrolls its ``lax.scan`` for the dry run's cost probe, and
    the port's period loop is already unrolled Python.  On a mesh
    (``opts.mesh``/``opts.places``) ``params`` are this rank's blocks."""
    del unroll
    params = _gather_unstacked(params, opts)
    memory = None
    if cfg.enc_segments:
        memory = _encode(params, cfg, enc_embeddings.to(compute_dtype),
                         remat=remat, opts=opts, places=opts.places)
    x = _embed_scaled(params, cfg, tokens, compute_dtype)
    shared = params.get("shared_attn")
    for seg_p, seg, sp in zip(params["segments"], cfg.segments,
                              _seg_places(opts, "segments",
                                          len(cfg.segments))):
        x = _segment_train(seg_p, cfg, seg, x, shared, memory=memory,
                           remat=remat, opts=opts, places=sp)
    return _logits(params, cfg, x)


def init_cache(cfg: ArchCfg, batch: int, seq: int, kv_dtype=torch.bfloat16,
               device=None):
    """Decode cache for a maximum context of ``seq`` on ``device`` (the
    card unless the caller names another; no card and no ``device``
    raises).

    ``kv_dtype`` is the KV-cache storage dtype.  It must match the serving
    compute dtype: a bf16 cache under float32 decode truncates the KV
    history every step, so decode drifts ~1e-3 relative from the
    teacher-forcing forward (amplified further by MoE gate
    renormalisation).  Recurrent states are f32, as in the reference."""
    device = resolve_device(device)
    return {
        "seg_caches": [_init_segment_cache(cfg, s, batch, seq, kv_dtype,
                                           device)
                       for s in cfg.segments],
        "pos": torch.zeros((), dtype=torch.int64, device=device),
    }


def forward_decode(params, cfg: ArchCfg, token, cache, enc_memory=None,
                   compute_dtype=torch.bfloat16, unroll: bool = False,
                   opts=DEFAULT_OPTS):
    """One decode step.  token: [B, 1] integers -> ``(logits [B, 1, V],
    cache)``; the cache is updated in place and returned with ``pos``
    advanced.  On a mesh (``opts.mesh`` with ``opts.places`` and
    ``opts.cache_places``) ``params`` and the cache are this rank's
    blocks.  ``unroll`` changes nothing (see ``forward_train``)."""
    del unroll
    params = _gather_unstacked(params, opts)
    x = _embed_scaled(params, cfg, token, compute_dtype)
    pos = cache["pos"]
    shared = params.get("shared_attn")
    n = len(cfg.segments)
    cache_places = ([None] * n if opts.cache_places is None
                    else opts.cache_places["seg_caches"])
    for seg_p, seg, seg_c, sp, cp in zip(
            params["segments"], cfg.segments, cache["seg_caches"],
            _seg_places(opts, "segments", n), cache_places):
        x = _segment_decode(seg_p, cfg, seg, x, seg_c, pos, shared,
                            memory=enc_memory, opts=opts, places=sp,
                            cache_places=cp)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache


def encode(params, cfg: ArchCfg, enc_embeddings,
           compute_dtype=torch.bfloat16):
    """Public encoder entry (serving: run once per request batch)."""
    return _encode(params, cfg, enc_embeddings.to(compute_dtype))
