"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — alternating local/global attention, logit softcap.
[arXiv:2408.00118; hf]"""

from ..models.transformer import ArchCfg, BlockCfg, Segment

LOCAL_WINDOW = 4096
ATTN_SOFTCAP = 50.0


def _segments(local_window):
    loc = BlockCfg(mixer="attn", ffn="dense", window=local_window)
    glob = BlockCfg(mixer="attn", ffn="dense", window=None)
    return (Segment(period=(loc, glob), n_periods=23),)


def config() -> ArchCfg:
    return ArchCfg(
        name="gemma2-27b",
        d_model=4608, n_heads=32, n_kv=16, head_dim=144,
        d_ff=36864, vocab=256000,
        segments=_segments(LOCAL_WINDOW),
        softcap=ATTN_SOFTCAP,
        rope_theta=10_000.0, act="gelu", tied_embeddings=True,
        family="dense",
        supports_long=False,   # half the layers are full-attention globals
    )


def reduced_config() -> ArchCfg:
    loc = BlockCfg(mixer="attn", ffn="dense", window=16)
    glob = BlockCfg(mixer="attn", ffn="dense", window=None)
    return ArchCfg(
        name="gemma2-27b-reduced",
        d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=192, vocab=512,
        segments=(Segment(period=(loc, glob), n_periods=2),),
        softcap=ATTN_SOFTCAP, act="gelu", tied_embeddings=True,
        family="dense", supports_long=False,
    )
