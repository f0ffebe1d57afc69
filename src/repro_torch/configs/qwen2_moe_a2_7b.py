"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from ..models.transformer import ArchCfg, BlockCfg, MoECfg, Segment


def config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="moe", window=None)
    return ArchCfg(
        name="qwen2-moe-a2.7b",
        d_model=2048, n_heads=16, n_kv=16, head_dim=128,
        d_ff=1408, vocab=151936,
        segments=(Segment(period=(block,), n_periods=24),),
        moe=MoECfg(n_experts=60, top_k=4, d_ff_expert=1408,
                   n_shared=4, d_ff_shared=5632),
        rope_theta=1_000_000.0, act="silu", tied_embeddings=True,
        family="moe",
        supports_long=False,   # full attention
    )


def reduced_config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="moe", window=None)
    return ArchCfg(
        name="qwen2-moe-a2.7b-reduced",
        d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=64, vocab=512,
        segments=(Segment(period=(block,), n_periods=2),),
        moe=MoECfg(n_experts=8, top_k=4, d_ff_expert=64,
                   n_shared=2, d_ff_shared=128, capacity_factor=4.0),
        act="silu", tied_embeddings=True, family="moe", supports_long=False,
    )
