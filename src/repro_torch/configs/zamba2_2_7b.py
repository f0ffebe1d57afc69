"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention blocks
(one set of attention+MLP weights applied every 6 mamba layers).
[arXiv:2411.15242; hf]"""

from ..models.transformer import ArchCfg, BlockCfg, Segment


def _segments(n_periods):
    mamba = BlockCfg(mixer="mamba2", ffn="none")
    shared = BlockCfg(mixer="shared_attn", ffn="dense")
    return (Segment(period=(mamba,) * 6 + (shared,), n_periods=n_periods),)


def config() -> ArchCfg:
    return ArchCfg(
        name="zamba2-2.7b",
        d_model=2560, n_heads=32, n_kv=32, head_dim=80,
        d_ff=10240, vocab=32000,
        segments=_segments(9),          # 54 mamba + 9 shared-attn applications
        ssm_state=64, ssm_expand=2, ssm_head_dim=64,
        rope_theta=10_000.0, act="gelu", tied_embeddings=True,
        family="hybrid",
        supports_long=True,             # O(1) SSM state dominates
    )


def reduced_config() -> ArchCfg:
    mamba = BlockCfg(mixer="mamba2", ffn="none")
    shared = BlockCfg(mixer="shared_attn", ffn="dense")
    return ArchCfg(
        name="zamba2-2.7b-reduced",
        d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=256,
        segments=(Segment(period=(mamba, mamba, shared), n_periods=2),),
        ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        act="gelu", tied_embeddings=True, family="hybrid", supports_long=True,
    )
