"""Serving engine: batched prefill and greedy decode against caches written
in place, plus the POP request balancer that places request groups onto
decode replicas — the port of ``repro/serve/engine.py``.

``serve_step`` is one new token a sequence against a KV/state cache of
``max_seq``.  ``balance_requests`` is the serving-path use of the paper:
request groups are shards, replicas are servers, and the §3.3
load-balancing MILP is solved through POP (a deprecated door onto a
:class:`~repro_torch.service.PopService` session).  ``jit_serve_step``
runs the step on a device mesh: parameters placed by ``param_shardings``,
the cache by ``kv_cache_specs``, the tokens on the data axes when the
batch divides them.  Each rank decodes its own rows and, over the
``model`` axis, its share of every product (no parameter block crosses
the mesh); attention reads and writes its KV cache block where it lies
(``models.attention.attention_decode(shard=)``).  The logits stay split
on the vocab where the table is, and the greedy token is the best of the
ranks' local maxima.  The module docstring of ``train/train_step.py`` has
the design.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import placement as pl
from ..core.placement import P
from ..launch import shardings as sh
from ..models import transformer as tf


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_seq: int
    compute_dtype: str = "bfloat16"
    shard_cache_seq: bool = False     # long-context mode (batch too small)
    unroll_segments: bool = False     # the dry run's cost probe (a no-op)
    # the flash-decode cache layout over a mesh's ``model`` axis: a no-op
    # without a mesh, as in the reference
    cache_seq_on_model: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


def make_serve_step(cfg: tf.ArchCfg, scfg: ServeConfig, mesh=None,
                    places=None, cache_places=None,
                    with_logits: bool = False):
    """``serve_step(params, cache, token, enc_memory=None) -> (next_token
    [B, 1], cache)``: one decode step and the greedy next token (and the
    step's logits ``[B, 1, V]`` after them with ``with_logits``).  On a
    mesh, ``places``/``cache_places`` are the placements of the
    parameters and the cache, and every argument holds this rank's blocks
    (see :func:`jit_serve_step`)."""
    dtype = scfg.dtype
    opts = tf.ModelOpts(mesh=mesh, places=places, cache_places=cache_places)
    vocab = opts.vocab_block(cfg)

    def serve_step(params, cache, token, enc_memory=None):
        logits, cache = tf.forward_decode(params, cfg, token, cache,
                                          enc_memory=enc_memory,
                                          compute_dtype=dtype,
                                          unroll=scfg.unroll_segments,
                                          opts=opts)
        # greedy next token (sampling plugs in here)
        if vocab is None:
            nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        else:
            nxt = greedy_over_vocab_blocks(logits[:, -1, :], vocab[0],
                                           opts.axis)
        return (nxt, cache, logits) if with_logits else (nxt, cache)

    serve_step.opts = opts
    return serve_step


def greedy_over_vocab_blocks(logits, v0: int, ax):
    """``argmax`` over logits split on the vocab: each rank's local maximum
    and its global index, all-gathered; the best value wins and ties go
    to the lowest global index, as ``torch.argmax`` breaks them (the
    ranks hold the vocab in rank order).  logits: ``[B, V_local]`` ->
    ``[B, 1]``."""
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[:, None])[:, 0]
    vals, idxs = ax.stack(val), ax.stack(idx + v0)               # [m, B]
    best = torch.argmax(vals, dim=0)
    return torch.gather(idxs, 0, best[None])[0][:, None]


def _row_places(mesh, scfg: ServeConfig, ndim: int):
    """Tokens (and encoder memory) on the data axes when the batch divides
    them, else replicated.  Each rank decodes the rows its cache block
    holds, so in the long-context mode (the cache's sequence on the data
    axes, its batch whole) the tokens are replicated too, where the
    reference lets GSPMD move them."""
    on_dp = (scfg.batch % max(pl.dp_size(mesh), 1) == 0
             and not scfg.shard_cache_seq)
    return pl.placements(pl.leading_spec(mesh, ndim) if on_dp
                         else P(*(None,) * ndim), mesh)


def place_cache(cache, cfg_batch: int, mesh, scfg: ServeConfig):
    """A global decode cache placed by ``kv_cache_specs``."""
    specs = sh.kv_cache_specs(cache, mesh, cfg_batch,
                              shard_seq=scfg.shard_cache_seq,
                              seq_on_model=scfg.cache_seq_on_model)
    return pl.distribute_tree(cache, specs, mesh)


def jit_serve_step(cfg: tf.ArchCfg, scfg: ServeConfig, mesh,
                   params_shape=None, cache_shape=None,
                   has_memory: bool = False, device=None,
                   with_logits: bool = False):
    """The decode step on ``mesh`` with the reference's placements:
    parameters by ``param_shardings``, the cache by ``kv_cache_specs``,
    tokens (and the encoder memory) on the data axes when ``scfg.batch``
    divides them (``_row_places``).  Inputs that are not DTensors yet
    (global tensors, equal on every rank) are placed on the way in; the
    step returns the next tokens as a DTensor and the same cache
    DTensors, written in place (the reference's donation), and with
    ``with_logits`` the step's logits as a DTensor too, ``Shard`` on the
    vocab over ``model`` where the vocab splits.  The mesh must
    lie on the card unless ``device`` names its device type."""
    del params_shape, cache_shape, has_memory
    from torch.distributed.tensor import DTensor

    from ..train.train_step import check_mesh_device, place_params
    check_mesh_device(mesh, device)
    state = {}

    def step(params, cache, token, enc_memory=None):
        if not isinstance(next(tf.leaves(params)), DTensor):
            params = place_params(params, mesh)
        if not isinstance(next(tf.leaves(cache["seg_caches"])), DTensor):
            cache = place_cache(cache, scfg.batch, mesh, scfg)
        t_places = _row_places(mesh, scfg, 2)
        if not isinstance(token, DTensor):
            token = pl.distribute(token, t_places, mesh)
        if enc_memory is not None and not isinstance(enc_memory, DTensor):
            enc_memory = pl.distribute(
                enc_memory, _row_places(mesh, scfg, enc_memory.ndim),
                mesh)
        if "fn" not in state:
            state["fn"] = make_serve_step(
                cfg, scfg, mesh, places=pl.places_of(params),
                cache_places=pl.places_of(cache), with_logits=True)
        local_cache = pl.local_tree(cache)
        nxt, local_cache, logits = state["fn"](
            pl.local_tree(params), local_cache, token._local_tensor,
            None if enc_memory is None else enc_memory._local_tensor)
        # the decode step replaces ``pos`` (a new tensor), not in place
        cache["pos"] = DTensor.from_local(local_cache["pos"], mesh,
                                          cache["pos"].placements,
                                          run_check=False)
        nxt = pl.from_local(nxt, t_places, mesh, token.shape)
        if not with_logits:
            return nxt, cache
        l_places = _row_places(mesh, scfg, 3)
        if state["fn"].opts.vocab_block(cfg) is not None:
            from torch.distributed.tensor import Shard
            l_places = pl.Places(
                Shard(2) if name == "model" else p
                for name, p in zip(pl.axis_names(mesh), l_places))
        return nxt, cache, pl.from_local(
            logits, l_places, mesh, (token.shape[0], 1, cfg.vocab))

    return step


@dataclasses.dataclass
class BalanceResult:
    placement: np.ndarray        # replica id per request group
    moved: int                   # sticky groups that changed replica
    max_load_dev: float
    solve_time_s: float
    # full LBResult (carries the PDHG warm-start state): pass back as
    # ``warm=`` on the next balancing tick for a warm-started re-solve
    lb: Optional[object] = None
    # share of request groups whose previous iterates seeded this solve
    # (1.0 = stable population, None = cold solve)
    warm_fraction: Optional[float] = None


def balance_requests(load: np.ndarray, n_replicas: int,
                     current: Optional[np.ndarray] = None,
                     *, pop_k: int = 2, eps_frac: float = 0.25,
                     backend: str = "auto", engine: str = "auto",
                     solver_kw: Optional[dict] = None,
                     warm: Optional[BalanceResult] = None,
                     group_ids: Optional[np.ndarray] = None,
                     device=None) -> BalanceResult:
    """DEPRECATED: place request groups onto decode replicas — the paper's
    §3.3 MILP with request groups as shards — by forwarding onto a
    :class:`~repro_torch.service.PopService` session over the registered
    ``load_balance`` domain on ``device`` (default: the CUDA device).  New
    code should hold a long-lived session instead of hand-carrying the
    previous tick's :class:`BalanceResult` through ``warm=``:

        session = service.session("balancer", BalanceInstance(...))
        alloc = session.step(BalanceInstance(load, n_replicas, current,
                                             eps_frac=0.25, ids=group_ids))
    """
    import warnings

    from ..core.config import ExecConfig, SolveConfig
    from ..domains.load_balance import BalanceInstance
    from ..service import PopService

    warnings.warn(
        "balance_requests is deprecated: use repro_torch.service.PopService"
        ".session(tenant, repro_torch.domains.BalanceInstance(...)) — this "
        "function forwards onto that session (results are identical)",
        DeprecationWarning, stacklevel=2)
    load = np.asarray(load, np.float64)
    if current is None:
        current = np.arange(load.shape[0]) % n_replicas
    if solver_kw is None:           # explicit {} means "solver defaults"
        solver_kw = dict(max_iters=6_000)
    inst = BalanceInstance(load=load, n_targets=n_replicas,
                           current=np.asarray(current, np.int64),
                           eps_frac=eps_frac, ids=group_ids)
    session = PopService(device=device).session(
        "serve.balance_requests", inst,
        solve=SolveConfig(k=pop_k),
        exec=ExecConfig(backend=backend, engine=engine,
                        solver_kw=dict(solver_kw)))
    session.seed(None if warm is None else warm.lb)
    res = session.step(inst).raw
    return BalanceResult(
        placement=res.placement,
        moved=int((res.placement != current).sum()),
        max_load_dev=float(res.max_load_dev),
        solve_time_s=float(res.solve_time_s),
        lb=res,
        warm_fraction=res.extra.get("warm_fraction"),
    )


def prefill(params, cfg: tf.ArchCfg, tokens, cache,
            compute_dtype=torch.bfloat16):
    """Sequential prefill through the decode path (right for ring buffers
    and recurrent state): one ``forward_decode`` a prompt position.  The
    cache is written in place and returned."""
    for t in range(tokens.shape[1]):
        _, cache = tf.forward_decode(params, cfg, tokens[:, t: t + 1], cache,
                                     compute_dtype=compute_dtype)
    return cache
