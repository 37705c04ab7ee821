"""Whisper-tiny: enc-dec, conv frontend stubbed to precomputed frame
embeddings [arXiv:2212.04356]."""
from .base import ModelConfig

FULL = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    n_enc_layers=4, enc_seq=1500,
)


def smoke() -> ModelConfig:
    return FULL.replace(n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
                        d_ff=96, vocab=256, n_enc_layers=2, enc_seq=32,
                        attn_block_q=16)
