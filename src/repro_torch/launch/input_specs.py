"""Meta-tensor stand-ins for every (arch x shape) dry-run cell: the
reference's shapes and dtypes, no storage, nothing drawn.

Counterpart of ``repro.launch.input_specs`` (``jax.ShapeDtypeStruct`` ->
tensors on the ``meta`` device).  :func:`param_structs` and
:func:`cache_structs` build the model's own trees through its init
functions on ``meta`` (``models.layers.dense_init`` draws nothing there),
so every leaf has the shape and dtype the card would hold.  Only the
dry-run reaches this path: the entry points keep their card-or-CPU rule.
"""
from __future__ import annotations

import torch

from ..configs import SHAPES, get_config

__all__ = ["META", "sds", "input_specs", "cache_structs", "param_structs"]

META = torch.device("meta")


class _ShapeOnly:
    """What the init functions take for a generator on the shape-only
    path: its device is ``meta``, and nothing is drawn from it."""
    device = META


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=META)


def input_specs(arch: str, shape_name: str, cfg=None,
                batch: int | None = None, seq: int | None = None) -> dict:
    """Model inputs for one cell.  For ``train``/``prefill``: the batch
    dict.  For ``decode``: tokens only (caches come from
    :func:`cache_structs`).  ``cfg``, ``batch`` and ``seq`` default to
    ``arch``'s config and the shape's global batch and length."""
    cfg = cfg or get_config(arch)
    sh = SHAPES[shape_name]
    b, s = batch or sh.global_batch, seq or sh.seq_len
    if sh.kind == "train":
        batch = {
            "tokens": sds((b, s), torch.int32),
            "labels": sds((b, s), torch.int32),
        }
    elif sh.kind == "prefill":
        batch = {"tokens": sds((b, s), torch.int32)}
    else:  # decode: one new token against a cache of length s
        batch = {"tokens": sds((b, 1), torch.int32)}
    if cfg.family == "vlm" and sh.kind != "decode":
        batch["vision_embeds"] = sds((b, cfg.n_vision_tokens, cfg.d_model),
                                     torch.float32)
    if cfg.is_encdec and sh.kind != "decode":
        batch["frames"] = sds((b, cfg.enc_seq, cfg.d_model), torch.float32)
    return batch


def cache_structs(cfg, batch: int, max_len: int) -> list:
    """Meta tree mirroring ``models.transformer.init_cache``."""
    from ..models.transformer import init_cache
    return init_cache(cfg, batch, max_len, META)


def param_structs(cfg) -> dict:
    """Meta tree mirroring ``models.transformer.init_params``."""
    from ..models.transformer import init_params
    return init_params(_ShapeOnly(), cfg)
