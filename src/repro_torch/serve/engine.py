"""Serving engine: batched prefill and greedy decode against caches written
in place, plus the POP request balancer that places request groups onto
decode replicas — the port of ``repro/serve/engine.py``.

``serve_step`` is one new token a sequence against a KV/state cache of
``max_seq``.  ``balance_requests`` is the serving-path use of the paper:
request groups are shards, replicas are servers, and the §3.3
load-balancing MILP is solved through POP (a deprecated door onto a
:class:`~repro_torch.service.PopService` session).  The reference's
``jit_serve_step`` shards the step over a device mesh; that is ROADMAP
item 14.5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import transformer as tf


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_seq: int
    compute_dtype: str = "bfloat16"
    # the flash-decode cache layout over a mesh's ``model`` axis: a no-op
    # without a mesh, as in the reference
    cache_seq_on_model: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


def make_serve_step(cfg: tf.ArchCfg, scfg: ServeConfig, mesh=None):
    """``serve_step(params, cache, token, enc_memory=None) -> (next_token
    [B, 1], cache)``: one decode step and the greedy next token.  A mesh
    raises ``NotImplementedError`` (ROADMAP item 14.5)."""
    dtype = scfg.dtype
    opts = tf.ModelOpts(cache_seq_on_model=scfg.cache_seq_on_model,
                        mesh=mesh)

    def serve_step(params, cache, token, enc_memory=None):
        logits, cache = tf.forward_decode(params, cfg, token, cache,
                                          enc_memory=enc_memory,
                                          compute_dtype=dtype, opts=opts)
        # greedy next token (sampling plugs in here)
        return torch.argmax(logits[:, -1, :], dim=-1)[:, None], cache

    return serve_step


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
