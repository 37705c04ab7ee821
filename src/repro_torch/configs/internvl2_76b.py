"""InternVL2-76B backbone (InternLM2): VLM, patch frontend stubbed
[arXiv:2404.16821]. input_specs() supplies precomputed patch embeddings."""
from .base import ModelConfig

FULL = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    n_vision_tokens=256,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, n_vision_tokens=8,
                        attn_block_q=16)
