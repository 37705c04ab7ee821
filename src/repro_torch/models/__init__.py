"""Model stack of the port: dense attention decoders and xLSTM
(``transformer``) over the blocks of ``layers`` and ``xlstm``, with the
high-level API of ``model``."""
from . import layers, model, transformer, xlstm
from .model import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
    serve_params,
)

__all__ = ["layers", "model", "transformer", "xlstm", "decode_step",
           "greedy_generate", "init_params", "prefill", "serve_params"]
