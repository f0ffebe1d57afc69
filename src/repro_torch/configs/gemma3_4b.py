"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

34 layers = 5 periods of (5 local + 1 global) + 4 trailing local layers.
"""

from ..models.transformer import ArchCfg, BlockCfg, Segment

LOCAL_WINDOW = 1024


def _segments(local_window, n_full_periods, n_tail):
    loc = BlockCfg(mixer="attn", ffn="dense", window=local_window)
    glob = BlockCfg(mixer="attn", ffn="dense", window=None)
    segs = (Segment(period=(loc,) * 5 + (glob,), n_periods=n_full_periods),)
    if n_tail:
        segs += (Segment(period=(loc,) * n_tail, n_periods=1),)
    return segs


def config() -> ArchCfg:
    return ArchCfg(
        name="gemma3-4b",
        d_model=2560, n_heads=8, n_kv=4, head_dim=320,
        d_ff=10240, vocab=262144,
        segments=_segments(LOCAL_WINDOW, 5, 4),
        rope_theta=1_000_000.0, act="gelu", tied_embeddings=True,
        family="dense",
        # 5:1 local:global — globals decode O(S) per step with seq-sharded
        # KV; locals hold 1k ring buffers.  Runnable at 500k (DESIGN.md §5).
        supports_long=True,
    )


def reduced_config() -> ArchCfg:
    return ArchCfg(
        name="gemma3-4b-reduced",
        d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512,
        segments=_segments(16, 1, 2),
        act="gelu", tied_embeddings=True, family="dense", supports_long=True,
    )
