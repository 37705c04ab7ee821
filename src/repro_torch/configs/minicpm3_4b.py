"""MiniCPM3-4B: MLA latent attention [hf:openbmb/MiniCPM3-4B]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    attention="mla", head_dim=64,
    q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=256, head_dim=16,
                        q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                        attn_block_q=16)
