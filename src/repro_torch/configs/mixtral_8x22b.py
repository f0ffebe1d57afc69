"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""

from ..models.transformer import ArchCfg, BlockCfg, MoECfg, Segment

SWA_WINDOW = 4096


def config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="moe", window=SWA_WINDOW)
    return ArchCfg(
        name="mixtral-8x22b",
        d_model=6144, n_heads=48, n_kv=8, head_dim=128,
        d_ff=16384, vocab=32768,
        segments=(Segment(period=(block,), n_periods=56),),
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=16384),
        rope_theta=1_000_000.0, act="silu", tied_embeddings=False,
        family="moe",
        supports_long=True,    # SWA bounds the KV cache
    )


def reduced_config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="moe", window=32)
    return ArchCfg(
        name="mixtral-8x22b-reduced",
        d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256,
        segments=(Segment(period=(block,), n_periods=2),),
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=128,
                   capacity_factor=4.0),
        act="silu", tied_embeddings=False, family="moe", supports_long=True,
    )
