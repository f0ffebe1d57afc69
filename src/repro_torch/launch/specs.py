"""Shape stand-ins for every (arch x input-shape) dry-run cell — the port of
``repro/launch/specs.py``.

No memory is ever allocated here: parameters, optimizer state, caches and
batches are tensors on ``torch.device("meta")`` (the reference's
``jax.eval_shape`` products), which is what lets the 40-cell matrix run
full-size 4B-140B configs on a CPU host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import transformer as tf
from ..train import optimizer as opt_mod

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# encoder memory length for enc-dec archs (speech frames, precomputed
# embeddings per the frontend-stub assignment)
ENC_MEMORY_LEN = 4_096


def microbatches_for(cell: ShapeCell, n_dp: int) -> int:
    """Grad-accumulation depth: keep the per-device micro batch about one
    sequence at 4k, so activation carries stay bounded."""
    if cell.kind != "train":
        return 1
    per_dev = max(cell.global_batch // n_dp, 1)
    return min(per_dev, 8)


def params_shape(cfg: tf.ArchCfg):
    return tf.init_params(None, cfg)


def opt_shape(p_shape):
    return opt_mod.init_state(p_shape)


def cache_shape(cfg: tf.ArchCfg, batch: int, seq: int):
    return tf.init_cache(cfg, batch, seq, device=META)


def batch_specs(cfg: tf.ArchCfg, cell: ShapeCell) -> dict:
    """Training/prefill batch stand-ins."""
    B, S = cell.global_batch, cell.seq_len
    out = {
        "tokens": torch.empty((B, S), dtype=torch.int32, device=META),
        "labels": torch.empty((B, S), dtype=torch.int32, device=META),
    }
    if cfg.enc_segments:
        out["enc_embeddings"] = torch.empty(
            (B, ENC_MEMORY_LEN, cfg.d_model), dtype=torch.float32,
            device=META)
    return out


def decode_specs(cfg: tf.ArchCfg, cell: ShapeCell):
    """(token, cache, memory?) stand-ins for serve_step."""
    B, S = cell.global_batch, cell.seq_len
    token = torch.empty((B, 1), dtype=torch.int32, device=META)
    cache = cache_shape(cfg, B, S)
    memory = None
    if cfg.enc_segments:
        memory = torch.empty((B, ENC_MEMORY_LEN, cfg.d_model),
                             dtype=torch.bfloat16, device=META)
    return token, cache, memory


def cell_is_runnable(cfg: tf.ArchCfg, cell: ShapeCell) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention."""
    if cell.name == "long_500k" and not cfg.supports_long:
        return False, ("full-attention arch: 500k-token KV decode is "
                       "quadratic-prefill / unbounded-KV — skipped per "
                       "DESIGN.md §5")
    return True, ""
