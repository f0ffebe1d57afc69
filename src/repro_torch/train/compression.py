"""Gradient compression for the data-parallel all-reduce: int8 blockwise
quantisation with error feedback — the port of
``repro/train/compression.py``.

Error feedback keeps the quantisation noise from biasing the trajectory:
the residual of each round is added back before the next quantisation
(Seide et al. / Karimireddy et al.).  Rounding is half to even, as
``jnp.round``'s, so the int8 payloads equal the reference's.

``compressed_psum`` is the collective over a data-parallel process group:
the wire carries each rank's int8 payload and its scales (``all_gather``),
and every rank dequantises and sums them in rank order, so the mean does
not depend on the backend's reduction order and is the same on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .optimizer import _map

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 of ``x`` flattened and zero-padded to whole
    blocks: ``(q [n_blocks, BLOCK] int8, scale [n_blocks, 1] f32)``."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor):
    """Returns ``(q, scale, new_residual)``; ``residual`` has grad's shape."""
    target = grad + residual
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale, grad.shape)
    return q, scale, target - deq


def compressed_psum(grad_tree, residual_tree, group=None):
    """The int8 all-reduce with error feedback over ``group`` (a process
    group; None is the default group): ``(mean_grad_tree,
    new_residual_tree)``, the mean over the group of each rank's
    dequantised int8 gradient, as the reference's ``compressed_psum``
    under ``shard_map``.

    Wire cost: 1 byte a parameter plus 4/BLOCK bytes of scales a rank,
    against 4 bytes a parameter for an f32 all-reduce."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(g, r):
        q, s, r_new = compress_with_feedback(g, r)
        qs = q.new_empty((n * q.shape[0],) + tuple(q.shape[1:]))
        ss = s.new_empty((n * s.shape[0],) + tuple(s.shape[1:]))
        dist.all_gather_into_tensor(qs, q, group=group)
        dist.all_gather_into_tensor(ss, s, group=group)
        qs, ss = qs.view((n,) + tuple(q.shape)), ss.view((n,) + tuple(s.shape))
        total = qs[0].to(torch.float32) * ss[0]
        for i in range(1, n):
            total = total + qs[i].to(torch.float32) * ss[i]
        mean = (total / float(n)).reshape(-1)[:g.numel()].reshape(g.shape)
        return mean, r_new

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(v, r[k]) for k, v in g.items()}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        if isinstance(g, (list, tuple)):
            pairs = [walk(v, w) for v, w in zip(g, r)]
            return (type(g)(p[0] for p in pairs),
                    type(g)(p[1] for p in pairs))
        return one(g, r)

    return walk(grad_tree, residual_tree)


def init_residuals(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
