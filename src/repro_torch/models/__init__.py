"""The language-model substrate's MoE routing statistics (the port of the
parts of ``repro/models`` that POP expert placement needs):
:func:`~repro_torch.models.moe.expert_gate_load` and
:func:`~repro_torch.models.moe.plan_expert_placement`.  The transformer
stacks themselves are ROADMAP open items §1, item 14."""

from .moe import expert_gate_load, plan_expert_placement

__all__ = ["expert_gate_load", "plan_expert_placement"]
