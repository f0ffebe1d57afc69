"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion: images are discrete VQ tokens inside the
vocabulary, so the "frontend" is the shared token embedding itself
(input_specs supplies mixed text+VQ token ids).  [arXiv:2405.09818;
unverified]"""

from ..models.transformer import ArchCfg, BlockCfg, Segment


def config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=None)
    return ArchCfg(
        name="chameleon-34b",
        d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=22016, vocab=65536,
        segments=(Segment(period=(block,), n_periods=48),),
        rope_theta=10_000.0, act="silu", tied_embeddings=False,
        family="vlm",
        supports_long=False,   # pure full attention
    )


def reduced_config() -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=None)
    return ArchCfg(
        name="chameleon-34b-reduced",
        d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=160, vocab=512,
        segments=(Segment(period=(block,), n_periods=2),),
        act="silu", tied_embeddings=False, family="vlm", supports_long=False,
    )
