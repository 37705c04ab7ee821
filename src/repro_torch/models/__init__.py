"""Model stack of the port: dense and MoE attention decoders, xLSTM, the
Jamba hybrid, the Whisper encoder-decoder and the InternVL2 VLM
(``transformer``) over the blocks of ``layers``, ``xlstm``, ``mamba`` and
``moe``, with the high-level API of ``model``."""
from . import layers, mamba, model, moe, transformer, xlstm
from .model import (
    decode_step,
    forward,
    greedy_generate,
    init_params,
    loss_fn,
    prefill,
    serve_params,
)

__all__ = ["layers", "mamba", "model", "moe", "transformer", "xlstm",
           "decode_step", "forward", "greedy_generate", "init_params",
           "loss_fn", "prefill", "serve_params"]
