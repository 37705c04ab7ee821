"""Model stack of the port: dense attention decoders (``transformer``)
over the layers of ``layers``, with the high-level API of ``model``."""
from . import layers, model, transformer
from .model import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
    serve_params,
)

__all__ = ["layers", "model", "transformer", "decode_step",
           "greedy_generate", "init_params", "prefill", "serve_params"]
