"""Yi-9B: llama-arch dense GQA [arXiv:2403.04652]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, attn_block_q=16)
