"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k-vocab.  [arXiv:2407.21783; unverified]"""

from ..models.transformer import ArchCfg, BlockCfg, Segment


def config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=None)
    return ArchCfg(
        name="llama3-8b",
        d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=14336, vocab=128256,
        segments=(Segment(period=(block,), n_periods=32),),
        rope_theta=500_000.0, act="silu", tied_embeddings=False,
        family="dense",
        supports_long=False,   # pure full attention
    )


def reduced_config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=None)
    return ArchCfg(
        name="llama3-8b-reduced",
        d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=160, vocab=512,
        segments=(Segment(period=(block,), n_periods=2),),
        act="silu", tied_embeddings=False, family="dense", supports_long=False,
    )
