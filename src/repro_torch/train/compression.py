"""Int8 gradient compression with error feedback for the data-parallel
axis.

Counterpart of ``repro.train.compression``: each tensor quantized to int8
with one f32 scale, the quantization error carried into the next step
(error feedback keeps convergence unbiased).  ``compressed_psum``, the
reduction over a process group, is not ported yet (ROADMAP queue 1, item
10: it needs more than one process).
"""
from __future__ import annotations

import torch

from ..tree import leaves, tree_map, unflatten

__all__ = ["compress_grads", "decompress_grads", "dequantize_int8",
           "init_error", "quantize_int8"]


def quantize_int8(x: torch.Tensor) -> tuple:
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, error):
    """Returns ((q_tree, scale_tree), new error-feedback tree).  ``error``
    is carried state shaped like grads (zeros at step 0)."""
    qs, ss, errs = [], [], []
    for g, e in zip(leaves(grads), leaves(error)):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        qs.append(q)
        ss.append(s)
        errs.append(corrected - dequantize_int8(q, s))
    return ((unflatten(grads, qs), unflatten(grads, ss)),
            unflatten(grads, errs))


def decompress_grads(qs):
    q_tree, s_tree = qs
    return tree_map(dequantize_int8, q_tree, s_tree)


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
