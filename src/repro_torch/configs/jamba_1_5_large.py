"""Jamba-1.5-Large-398B: Mamba+attention 1:7 interleave, MoE 16e top-2 on
every other layer [arXiv:2403.19887]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    d_state=16, d_conv=4, mamba_expand=2,
)

# The configuration served on one H100: every width as published (d_model
# 8192, 64 / 8 heads of 128, d_ff 24576, d_inner 16384, d_state 16, the
# router's 16 outputs and top-2, vocabulary 65,536), cut as listed in
# REDUCED.  Weights 25,793,183,744 parameters, 48.0 GiB in bf16.
SERVED = FULL.replace(name="jamba-1.5-large", n_layers=8, experts_held=8,
                      expert_offset=0)

REDUCED = {
    "n_layers": "72 -> 8: one whole supercell (1 attention layer at 4, 7 "
                "Mamba layers; 4 MoE FFNs on the odd layers, 4 dense FFNs); "
                "the other 8 supercells would lie on further cards, as "
                "pipeline stages",
    "experts_held": "16 -> 8 per MoE layer: experts 0-7, the share of card 0 "
                    "of the 2 cards that split every MoE layer (expert "
                    "parallelism); the router keeps its 16 outputs and "
                    "top-2 over all 16, capacity is reckoned with 16, and "
                    "the card adds only what its own experts give",
}


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=256, n_experts=4, top_k=2,
                        attn_every=4, attn_offset=2, moe_every=2,
                        moe_offset=1, attn_block_q=16)
