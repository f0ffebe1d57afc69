"""LM substrate (the port of ``repro/models``): composable blocks
(attention, MoE, Mamba2, xLSTM) assembled into decoder-only and
encoder-decoder stacks over stacked periods, plus the MoE routing
statistics that POP expert placement reads
(:func:`~repro_torch.models.moe.expert_gate_load`,
:func:`~repro_torch.models.moe.plan_expert_placement`)."""

from .moe import expert_gate_load, plan_expert_placement
from .transformer import (
    ArchCfg, BlockCfg, MoECfg, ModelOpts, Segment,
    encode, forward_decode, forward_train, init_cache, init_params,
    serving_params,
)

__all__ = [
    "ArchCfg", "BlockCfg", "MoECfg", "ModelOpts", "Segment",
    "init_params", "init_cache", "forward_train", "forward_decode",
    "encode", "serving_params",
    "expert_gate_load", "plan_expert_placement",
]
