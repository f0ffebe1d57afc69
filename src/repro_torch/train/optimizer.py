"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule — the port of ``repro/train/optimizer.py``.

Parameters, gradients and the moments are nested dicts (and lists) of
tensors with the reference's leaf paths.  ``apply_updates`` writes the
parameters and both moments in place under ``torch.no_grad()``, as
``torch.optim`` does: the counterpart of the reference's donated buffers,
so a step holds one copy of the optimizer state.  The metrics stay device
tensors (no host synchronisation)."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.transformer import leaves

# the last dict key of a leaf's path that exempts it from weight decay
# (the reference's ``_wd_mask``; sLSTM's recurrent ``r`` is decayed)
NO_DECAY = frozenset({"scale", "bias", "a_log", "dt_bias", "d_skip",
                      "norm_scale"})


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32 on the parameters' device
    m: object             # tree like params, f32
    v: object             # tree like params, f32


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _zip_named(tree, *others, name=None):
    """``(last dict key, leaf, the others' leaves at its path)`` over
    ``tree``'s structure (dicts matched by key, whatever their order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_named(v, *(o[k] for o in others), name=k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _zip_named(v, *(o[i] for o in others), name=name)
    else:
        yield (name, tree, *others)


def init_state(params) -> AdamWState:
    zeros = _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = next(leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=_map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _wd_mask(name) -> bool:
    """Decay matrices only: skip norms, scales, biases and the SSM's 1-d
    leaves, judged by the last dict key of the path."""
    return name not in NO_DECAY


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient element squared, in f32, summed
    as the reference sums it.  (``torch.linalg.vector_norm`` on the CPU
    accumulates each lane in turn: 1.1% low at 10^8 elements, where
    ``torch.sum`` sums pairwise.)"""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(grads)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState,
                  gnorm=None):
    """One AdamW step: the parameters and ``state``'s moments are written in
    place (and ``grads`` scaled in place by the clip).  Returns
    ``(params, new_state, metrics)``; ``new_state`` holds the same moment
    tensors and the next step count.  ``gnorm``: the gradients' global
    norm when the caller has it (a sharded step holds blocks of the
    gradients, whose norm needs a collective); else computed here."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    for name, p, g, m, v in _zip_named(params, grads, state.m, state.v):
        g = g.to(torch.float32).mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay > 0 and _wd_mask(name):
            upd.add_(p, alpha=cfg.weight_decay)
        p.sub_(upd.mul_(lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "lr": lr, "grad_norm": gnorm}
