"""Mixtral-8x7B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, sliding_window=4096,
)

# The configuration served on one H100: every width as published (d_model
# 4096, 32 / 8 heads of 128, d_ff 14336, the router's 8 outputs and top-2,
# vocabulary 32,000, window 4096) and all 32 layers, cut as listed in
# REDUCED.  Weights 24,154,214,400 parameters, 44.99 GiB in bf16.
SERVED = FULL.replace(name="mixtral-8x7b-ep2", experts_held=4,
                      expert_offset=0)

REDUCED = {
    "experts_held": "8 -> 4 per MoE layer: experts 0-3, the share of card 0 "
                    "of the 2 cards that split every MoE layer (expert "
                    "parallelism); the router keeps its 8 outputs and top-2 "
                    "over all 8, capacity is reckoned with 8, and the card "
                    "adds only what its own experts give",
}


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, n_experts=4, top_k=2,
                        sliding_window=32, attn_block_q=16)
