"""xlstm-350m [ssm]: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks (d_ff=0: xLSTM blocks carry their own projections,
no separate FFN).  [arXiv:2405.04517; unverified]

Pattern: (mLSTM x5, sLSTM) x4 = 24 layers (xLSTM interleaves a minority of
sLSTM blocks; sLSTM is sequential — see DESIGN.md).
"""

from ..models.transformer import ArchCfg, BlockCfg, Segment


def config() -> ArchCfg:
    m = BlockCfg(mixer="mlstm", ffn="none")
    s = BlockCfg(mixer="slstm", ffn="none")
    return ArchCfg(
        name="xlstm-350m",
        d_model=1024, n_heads=4, n_kv=4, head_dim=256,
        d_ff=0, vocab=50304,
        segments=(Segment(period=(m,) * 5 + (s,), n_periods=4),),
        act="silu", tied_embeddings=True,
        family="ssm",
        supports_long=True,    # O(d^2) recurrent state, no KV cache
    )


def reduced_config() -> ArchCfg:
    m = BlockCfg(mixer="mlstm", ffn="none")
    s = BlockCfg(mixer="slstm", ffn="none")
    return ArchCfg(
        name="xlstm-350m-reduced",
        d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=0, vocab=256,
        segments=(Segment(period=(m, m, s), n_periods=2),),
        act="silu", tied_embeddings=True, family="ssm", supports_long=True,
    )
