"""Plain PyTorch version of the flash-decode kernel: one query token
against a KV cache, keys at positions ``<= length``.

Counterpart of ``repro.kernels.decode_attention.ref.decode_attention_ref``.
Two extensions, what the reference model's decode computes: ``length`` may
be one value per batch row (a ``(B,)`` tensor: what the reference engine
gets by ``vmap``-ing the scalar version over its lanes), and a sliding
``window`` hides keys at positions ``<= length - window`` (the mask of
``chunked_attention(..., window=W, q_offset=length)``, the length taken as
given).  ``length >= S`` sees to the end of the cache.  A row that sees no
key (``length < 0``, or a window wholly past the cache) returns 0, as
``chunked_attention`` does.
"""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref"]


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length, window: int = 0) -> torch.Tensor:
    """q: (B, 1, H, dh); k/v: (B, S, KV, dh); length: int, 0-d or (B,)
    integer tensor, the last visible cache index; window: the sliding
    window (0: none).  Returns (B, 1, H, dh) in q's type."""
    b, _, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * (dh ** -0.5)
    ln = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
    kp = torch.arange(sk, device=q.device)[None, None, None, :]
    hidden = kp > ln
    if window:
        hidden |= kp <= ln - window
    s = s.masked_fill(hidden, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr.float()).to(q.dtype)
