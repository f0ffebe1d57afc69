"""Gradient compression for the data-parallel all-reduce: int8 blockwise
quantisation with error feedback — the port of
``repro/train/compression.py``.

Error feedback keeps the quantisation noise from biasing the trajectory:
the residual of each round is added back before the next quantisation
(Seide et al. / Karimireddy et al.).  Rounding is half to even, as
``jnp.round``'s, so the int8 payloads equal the reference's.

``compressed_psum`` is the collective over a data-parallel mesh axis; it
moves to ``torch.distributed`` with ROADMAP item 14.5.
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


def compressed_psum(grad_tree, residual_tree, axis_name: str):
    """The int8 all-reduce with error feedback over a data-parallel axis.
    A mesh collective: ROADMAP item 14.5."""
    raise NotImplementedError(
        "compressed_psum is a collective over a device mesh axis: "
        "multi-device training on torch.distributed is ROADMAP item 14.5")


def init_residuals(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
