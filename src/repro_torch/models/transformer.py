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

On a mesh (``ModelOpts(mesh=, places=)``) the parameters are this rank's
blocks and each block computes its share of every product the rules
place over ``model`` (tensor parallelism with explicit collectives on
local tensors, ``core.placement.ModelAxis``): a block's norm output
enters the model axis once, the column-parallel products (q/k/v heads,
gate/up, the experts' hidden dim, Mamba2's ``d_inner``, the xLSTM
columns) run on this rank's block, and the row-parallel output is summed
once.  No parameter block crosses the mesh; only activations do.  The
embedding and the logits are vocab-parallel where the table splits on
its vocab.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.placement import Places, model_axis, zip_map
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
    each block computes its share over the mesh's ``model`` axis
    (``axis``, a ``core.placement.ModelAxis``; None where the axis has
    one rank, and then every op is the unsharded path's).  Attention
    reads its KV cache block where it lies
    (``attention.attention_decode(shard=)``).

    * ``sp_residual``: the residual stream between blocks is this rank's
      slice of the sequence (where the sequence splits over ``model``; a
      decode step's one position never does).  The row-parallel outputs
      are reduce-scattered, the norms run on the slice, and a norm's
      output is all-gathered before the column-parallel products; the
      slice is gathered back before ``final_norm``.
    * ``gather_once``: that all-gather runs once a norm output, for q/k/v
      or gate/up together.  The port's blocks always gather so (an eager
      op runs where it is written), so the flag selects what runs anyway.
    * ``bf16_barrier``: the collectives move the compute dtype.  A norm
      output is cast to the compute dtype before it enters the model
      axis, so the flag, too, selects what runs anyway.  The collectives
      that move f32 are those the math asks for in f32: partial attention
      scores, the Mamba2 gate norm's sum of squares and the vocab-parallel
      cross-entropy's statistics.
    * ``cache_seq_on_model`` acts where the cache is placed
      (``kv_cache_specs(seq_on_model=)`` in
      ``serve.engine.jit_serve_step``).

    With ``mesh=None`` every knob is a no-op, as in the reference."""
    sp_residual: bool = False
    bf16_barrier: bool = False
    gather_once: bool = False
    cache_seq_on_model: bool = False
    mesh: object = None
    places: object = None
    cache_places: object = None
    axis: object = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.axis is None and self.places is not None:
            object.__setattr__(self, "axis",
                               model_axis(self.mesh, self.sp_residual))

    def vocab_block(self, cfg) -> Optional[tuple]:
        """``(start, length)`` of this rank's vocab block of the logits,
        or None where every rank has them whole."""
        ax = self.axis
        if ax is None:
            return None
        if cfg.tied_embeddings:
            split = ax.dim(self.places["embed"]["table"]) == 0
        else:
            split = ax.dim(self.places["unembed"]["w"]) == 1
        return ax.block(cfg.vocab) if split else None


def _sub(places, *keys):
    """``places[k0][k1]...``, None along a missing path."""
    for k in keys:
        if places is None:
            return None
        places = places.get(k) if isinstance(places, dict) else places[k]
    return places


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


def _mixer_train(p, cfg, bcfg, h, shared_attn_params, window, causal,
                 ax=None, places=None, shared_places=None, sp=False):
    kw = dict(ax=ax, places=_sub(places, "mixer"), sp=sp)
    if bcfg.mixer in ("attn", "shared_attn"):
        mp = p["mixer"] if bcfg.mixer == "attn" else shared_attn_params
        if bcfg.mixer == "shared_attn":
            kw["places"] = shared_places
        return attn_mod.attention_train(
            mp, h, window=window, softcap=cfg.softcap,
            rope_theta=cfg.rope_theta, causal=causal, **kw)
    if bcfg.mixer == "mamba2":
        return ssm_mod.mamba2_train(p["mixer"], h, **kw)
    if bcfg.mixer == "mlstm":
        return xlstm_mod.mlstm_train(p["mixer"], h, **kw)
    return xlstm_mod.slstm_train(p["mixer"], h, **kw)


def _ffn(p, cfg: ArchCfg, bcfg: BlockCfg, x, ax=None, places=None,
         sp=False):
    if bcfg.ffn == "none":
        return x
    h = rmsnorm(p["norm2"], x)
    if bcfg.ffn == "dense":
        if ax is None:
            return x + mlp(p["ffn"], h, cfg.act)
        hp, hr = ax.enter(h, sp)
        if ax.dim(places["ffn"]["w_gate"]) is None:
            return x + ax.leave_whole(mlp(p["ffn"], hr, cfg.act), sp)
        return x + ax.leave(mlp(p["ffn"], hp, cfg.act), sp)
    return x + moe_mod.moe(p["ffn"], h, top_k=cfg.moe.top_k,
                           capacity_factor=cfg.moe.capacity_factor,
                           activation=cfg.act, ax=ax,
                           places=_sub(places, "ffn"), sp=sp)


def _apply_block_train(p, cfg: ArchCfg, bcfg: BlockCfg, x,
                       shared_attn_params, memory=None, causal=True,
                       ax=None, places=None, shared_places=None, sp=False):
    S = x.shape[1] * (ax.size if sp else 1)
    window = float(bcfg.window) if bcfg.window else float(S + 1)
    h = rmsnorm(p["norm1"], x)
    x = x + _mixer_train(p, cfg, bcfg, h, shared_attn_params, window,
                         causal, ax, places, shared_places, sp)
    if bcfg.cross_attn:
        h = rmsnorm(p["norm_cross"], x)
        x = x + attn_mod.attention_train(
            p["cross"], h, window=float(memory.shape[1] + 1),
            softcap=cfg.softcap, rope_theta=cfg.rope_theta,
            causal=False, memory=memory, ax=ax,
            places=_sub(places, "cross"), sp=sp)
    return _ffn(p, cfg, bcfg, x, ax, places, sp)


def _apply_block_decode(p, cfg: ArchCfg, bcfg: BlockCfg, x, cache, pos,
                        shared_attn_params, memory=None, shard=None,
                        ax=None, places=None, shared_places=None,
                        state_places=None):
    """One block at one position.  A KV cache is written in place (on a
    mesh ``shard`` says where its block lies); a recurrent state comes
    back new (on a mesh, this rank's block of it).  Returns ``(x,
    cache)``."""
    window = float(bcfg.window) if bcfg.window else 2.0 ** 31
    h = rmsnorm(p["norm1"], x)
    if bcfg.mixer in ("attn", "shared_attn"):
        if bcfg.mixer == "attn":
            mp, mpl = p["mixer"], _sub(places, "mixer")
        else:
            mp, mpl = shared_attn_params, shared_places
        h, cache = attn_mod.attention_decode(
            mp, h, cache, pos, window=window, softcap=cfg.softcap,
            rope_theta=cfg.rope_theta, shard=shard, ax=ax, places=mpl)
    else:
        fn = {"mamba2": ssm_mod.mamba2_decode,
              "mlstm": xlstm_mod.mlstm_decode,
              "slstm": xlstm_mod.slstm_decode}[bcfg.mixer]
        h, cache = fn(p["mixer"], h, cache, ax=ax,
                      places=_sub(places, "mixer"),
                      state_places=state_places)
    x = x + h

    if bcfg.cross_attn:
        h = rmsnorm(p["norm_cross"], x)
        h, _ = attn_mod.attention_decode(
            p["cross"], h, cache=None, pos=pos, window=2.0 ** 31,
            softcap=cfg.softcap, rope_theta=cfg.rope_theta, memory=memory,
            ax=ax, places=_sub(places, "cross"))
        x = x + h
    return _ffn(p, cfg, bcfg, x, ax, places), cache


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
                   remat: bool = True, ax=None, places=None,
                   shared_places=None, sp=False):
    """The segment's periods in turn.  With ``remat`` and autograd on, each
    period's blocks run under ``checkpoint``: the backward keeps only the
    period's input and recomputes the rest (no random numbers are drawn,
    so no generator state is kept; the recomputation runs the period's
    collectives again, in the same order on every rank).  On a mesh
    (``ax``; ``places`` the stacked leaves' placements) each block runs
    its share on this rank's blocks."""
    period_places = _unstacked(places)

    def body(h, pp):
        for i, b in enumerate(seg.period):
            h = _apply_block_train(pp[f"b{i}"], cfg, b, h,
                                   shared_attn_params, memory, causal, ax,
                                   _sub(period_places, f"b{i}"),
                                   shared_places, sp)
        return h

    recompute = remat and torch.is_grad_enabled()
    for pp in _periods(seg_params, seg.n_periods):
        x = (checkpoint(body, x, pp, use_reentrant=False,
                        preserve_rng_state=False)
             if recompute else body(x, pp))
    return x


def _segment_decode(seg_params, cfg: ArchCfg, seg: Segment, x, seg_cache,
                    pos, shared_attn_params, memory=None, opts=DEFAULT_OPTS,
                    places=None, cache_places=None, shared_places=None):
    """The segment's periods in turn, each cache slot written in place.  On
    a mesh each block runs its share on this rank's parameter blocks;
    attention reads and writes its KV cache block where it lies, and a
    recurrent state's new block is copied back into its slot."""
    ax = opts.axis
    period_places = _unstacked(places)
    cache_period = _unstacked(cache_places, rows_local=True)
    for n in range(seg.n_periods):
        pp = _period(seg_params, n)
        for i, b in enumerate(seg.period):
            stacked = seg_cache[f"b{i}"]
            c_places = _sub(cache_period, f"b{i}")
            kw = dict(ax=ax, places=_sub(period_places, f"b{i}"),
                      shared_places=shared_places)
            if isinstance(stacked, KVCache):
                shard = (None if c_places is None else
                         attn_mod.CacheShard(opts.mesh, c_places.k))
                x, _ = _apply_block_decode(
                    pp[f"b{i}"], cfg, b, x, _period(stacked, n), pos,
                    shared_attn_params, memory, shard, **kw)
                continue
            x, c = _apply_block_decode(pp[f"b{i}"], cfg, b, x,
                                       _period(stacked, n), pos,
                                       shared_attn_params, memory,
                                       state_places=c_places, **kw)
            for key, v in c.items():
                stacked[key][n].copy_(v)
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
            opts=DEFAULT_OPTS):
    ax, places = opts.axis, opts.places
    x = enc_embeddings
    if cfg.frontend:
        x = _dense_whole(params["frontend"], x, ax,
                         _sub(places, "frontend"))
    sp = ax is not None and ax.sp_on(x)
    if sp:
        x = ax.scatter(x, 1)
    seg_places = _sub(places, "enc_segments") or [None] * len(
        cfg.enc_segments)
    for seg_p, seg, spl in zip(params["enc_segments"], cfg.enc_segments,
                               seg_places):
        x = _segment_train(seg_p, cfg, seg, x, None, causal=False,
                           remat=remat, ax=ax, places=spl, sp=sp)
    if sp:
        x = ax.gather(x, 1)
    return rmsnorm(params["enc_norm"], x)


def _dense_whole(p, x, ax, places):
    """``dense`` whose output every rank needs whole: a ``w`` split on its
    columns multiplies by this rank's columns and gathers them."""
    if ax is None or ax.dim(places["w"]) is None:
        return dense(p, x)
    return ax.gather(dense(p, ax.copy(x)), -1)


def _seg_places(opts, key: str, n: int):
    if opts.places is None:
        return [None] * n
    return opts.places[key]


def _embed_scaled(params, cfg: ArchCfg, tokens, compute_dtype, ax=None,
                  places=None, sp=False):
    x = embed(params["embed"], tokens, compute_dtype, ax=ax,
              places=_sub(places, "embed"), sp=sp)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)


def _logits(params, cfg: ArchCfg, x, ax=None, places=None, sp=False):
    """The final norm and the logits: whole, or this rank's vocab block
    where the table (or ``unembed``) splits on its vocab."""
    if ax is None:
        x = rmsnorm(params["final_norm"], x)
        if cfg.tied_embeddings:
            return unembed(params["embed"], x)
        return dense(params["unembed"], x)
    if cfg.tied_embeddings:
        w, d = params["embed"]["table"], ax.dim(places["embed"]["table"])
        vocab_split, w = d == 0, w.t()
    else:
        w, d = params["unembed"]["w"], ax.dim(places["unembed"]["w"])
        vocab_split = d == 1
    if vocab_split:
        if sp:
            h = rmsnorm(params["final_norm"],
                        ax.gather(x, 1, partial=True))
        else:
            h = ax.copy(rmsnorm(params["final_norm"], x))
        return torch.matmul(h, w.to(h.dtype))
    h = rmsnorm(params["final_norm"], ax.gather(x, 1) if sp else x)
    if d is None:
        return torch.matmul(h, w.to(h.dtype))
    # a tied table split on d_model: partial logits summed
    return ax.reduce(torch.matmul(ax.scatter(h, -1), w.to(h.dtype)))


def forward_train(params, cfg: ArchCfg, tokens, enc_embeddings=None,
                  remat: bool = True, compute_dtype=torch.bfloat16,
                  unroll: bool = False, opts=DEFAULT_OPTS):
    """Logits for next-token prediction.  tokens: [B, S] integers.

    ``remat`` recomputes each period in the backward when autograd is on
    (the reference's per-period ``jax.checkpoint``); without autograd it
    changes nothing.  ``unroll`` is accepted and changes nothing: the
    reference unrolls its ``lax.scan`` for the dry run's cost probe, and
    the port's period loop is already unrolled Python.  On a mesh
    (``opts.mesh``/``opts.places``) ``params`` are this rank's blocks and
    the logits this rank's vocab block where the vocab splits
    (``opts.vocab_block``)."""
    del unroll
    ax, places = opts.axis, opts.places
    sp = ax is not None and ax.sp_on(tokens)
    memory = None
    if cfg.enc_segments:
        memory = _encode(params, cfg, enc_embeddings.to(compute_dtype),
                         remat=remat, opts=opts)
    x = _embed_scaled(params, cfg, tokens, compute_dtype, ax, places, sp)
    shared = params.get("shared_attn")
    for seg_p, seg, spl in zip(params["segments"], cfg.segments,
                               _seg_places(opts, "segments",
                                           len(cfg.segments))):
        x = _segment_train(seg_p, cfg, seg, x, shared, memory=memory,
                           remat=remat, ax=ax, places=spl,
                           shared_places=_sub(places, "shared_attn"),
                           sp=sp)
    return _logits(params, cfg, x, ax, places, sp)


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
    blocks, and the logits this rank's vocab block where the vocab splits
    (``opts.vocab_block``).  ``unroll`` changes nothing (see
    ``forward_train``)."""
    del unroll
    ax, places = opts.axis, opts.places
    x = _embed_scaled(params, cfg, token, compute_dtype, ax, places)
    pos = cache["pos"]
    shared = params.get("shared_attn")
    n = len(cfg.segments)
    cache_places = ([None] * n if opts.cache_places is None
                    else opts.cache_places["seg_caches"])
    for seg_p, seg, seg_c, spl, cp in zip(
            params["segments"], cfg.segments, cache["seg_caches"],
            _seg_places(opts, "segments", n), cache_places):
        x = _segment_decode(seg_p, cfg, seg, x, seg_c, pos, shared,
                            memory=enc_memory, opts=opts, places=spl,
                            cache_places=cp,
                            shared_places=_sub(places, "shared_attn"))
    cache["pos"] = pos + 1
    return _logits(params, cfg, x, ax, places), cache


def partial_leaves(params, cfg: ArchCfg, opts, tokens,
                   enc_embeddings=None) -> list:
    """The paths (tuples of keys and list indices) of the replicated
    leaves whose gradient on this rank is a part of the whole's, in
    ``forward_train`` on a mesh with these inputs (``params`` this rank's
    blocks): ``wk``/``wv`` read on the KV heads of this rank's query
    heads, a router feeding split experts, Mamba2's replicated
    projections and per-head leaves, mLSTM's ``w_if``, and under
    ``sp_residual`` the norm scales run on a sequence slice.  Decided by
    the placements and the layouts each module checks, never by what a
    forward pass recorded; a train step sums these gradients over
    ``model`` before AdamW.  Empty without a model axis."""
    ax, places = opts.axis, opts.places
    if ax is None:
        return []
    out = []

    def add(path, names):
        out.extend(path + (n,) for n in sorted(names))

    def segments(key, sp):
        for s, (seg_p, seg) in enumerate(zip(params[key],
                                             getattr(cfg, key))):
            pp = _period(seg_p, 0)
            period_places = _unstacked(places[key][s])
            for i, b in enumerate(seg.period):
                path, p = (key, s, f"b{i}"), pp[f"b{i}"]
                pl = _sub(period_places, f"b{i}")
                if sp:      # the norms run on this rank's sequence slice
                    norms = ["norm1"] + ["norm_cross"] * b.cross_attn + \
                        ["norm2"] * (b.ffn != "none")
                    out.extend(path + (n, "scale") for n in norms)
                rule = {"attn": attn_mod.partial_leaves,
                        "mamba2": ssm_mod.partial_leaves,
                        "mlstm": xlstm_mod.mlstm_partial_leaves}.get(
                            b.mixer)
                if rule is not None:
                    add(path + ("mixer",),
                        rule(p["mixer"], ax, _sub(pl, "mixer")))
                if b.cross_attn:
                    add(path + ("cross",), attn_mod.partial_leaves(
                        p["cross"], ax, _sub(pl, "cross")))
                if b.ffn == "moe":
                    add(path + ("ffn",),
                        moe_mod.partial_leaves(ax, _sub(pl, "ffn")))

    if "shared_attn" in params:
        add(("shared_attn",), attn_mod.partial_leaves(
            params["shared_attn"], ax, places["shared_attn"]))
    if cfg.enc_segments:
        segments("enc_segments", ax.sp_on(enc_embeddings))
    sp = ax.sp_on(tokens)
    segments("segments", sp)
    if sp and opts.vocab_block(cfg) is not None:
        out.append(("final_norm", "scale"))
    return out


def encode(params, cfg: ArchCfg, enc_embeddings,
           compute_dtype=torch.bfloat16):
    """Public encoder entry (serving: run once per request batch)."""
    return _encode(params, cfg, enc_embeddings.to(compute_dtype))
