"""xLSTM-350M: mLSTM + sLSTM blocks (7:1 ratio) [arXiv:2405.04517].
d_ff=0: xLSTM blocks carry their own gated up/down projections."""
from .base import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8, slstm_offset=1, mamba_expand=2,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
                        vocab=256, slstm_every=4, slstm_offset=1,
                        attn_block_q=16)
