"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — encoder-decoder, multimodal.  The speech frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (per assignment).
[arXiv:2308.11596; hf]

Interpreted as 12 encoder + 12 decoder layers (m4t-medium text stack).
"""

from ..models.transformer import ArchCfg, BlockCfg, Segment


def config() -> ArchCfg:
    enc = BlockCfg(mixer="attn", ffn="dense", window=None)
    dec = BlockCfg(mixer="attn", ffn="dense", window=None, cross_attn=True)
    return ArchCfg(
        name="seamless-m4t-medium",
        d_model=1024, n_heads=16, n_kv=16, head_dim=64,
        d_ff=4096, vocab=256206,
        segments=(Segment(period=(dec,), n_periods=12),),
        enc_segments=(Segment(period=(enc,), n_periods=12),),
        rope_theta=10_000.0, act="silu", tied_embeddings=True,
        frontend="audio",
        family="audio",
        supports_long=False,   # full self+cross attention decoder
    )


def reduced_config() -> ArchCfg:
    enc = BlockCfg(mixer="attn", ffn="dense", window=None)
    dec = BlockCfg(mixer="attn", ffn="dense", window=None, cross_attn=True)
    return ArchCfg(
        name="seamless-m4t-medium-reduced",
        d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512,
        segments=(Segment(period=(dec,), n_periods=2),),
        enc_segments=(Segment(period=(enc,), n_periods=2),),
        act="silu", tied_embeddings=True, frontend="audio",
        family="audio", supports_long=False,
    )
