"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""

from ..models.transformer import ArchCfg, BlockCfg, Segment

SWA_WINDOW = 4096


def config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=SWA_WINDOW)
    return ArchCfg(
        name="h2o-danube-3-4b",
        d_model=3840, n_heads=32, n_kv=8, head_dim=120,
        d_ff=10240, vocab=32000,
        segments=(Segment(period=(block,), n_periods=24),),
        rope_theta=10_000.0, act="silu", tied_embeddings=True,
        family="dense",
        supports_long=True,            # SWA bounds the KV cache
    )


def reduced_config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=32)
    return ArchCfg(
        name="h2o-danube-3-4b-reduced",
        d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256,
        segments=(Segment(period=(block,), n_periods=2),),
        act="silu", tied_embeddings=True, family="dense", supports_long=True,
    )
