"""Plain PyTorch version of the MLA latent attention kernel: the reference
model's weight-absorbed attention over the latent cache.

The reference (``repro.models.layers.mla_attention``, its ``kv_cache``
branch) computes, in f32, ``s = (q_lat . c + q_rope . k_rope) * scale``
with ``scale = (head_dim + rope_head_dim) ** -0.5``, masks every key past
the query's position, and returns ``ctx = softmax(s) . c`` cast to the
activation type: one key/value head (the latent ``c``, with the shared
``k_rope``) for every query head.  This is that formula, line for line,
with the positions of :func:`mla_prefill_ref` and :func:`mla_decode_ref`.
A row that sees no key returns 0 (the reference never makes one: its query
always sees key 0).
"""
from __future__ import annotations

import torch

__all__ = ["mla_attention_ref", "mla_decode_ref", "mla_prefill_ref"]


def mla_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c: torch.Tensor, k_rope: torch.Tensor, scale: float,
                      length=None) -> torch.Tensor:
    """q_lat (B, Sq, H, R), q_rope (B, Sq, H, Dr); the cache c (B, Sk, R)
    and k_rope (B, Sk, Dr).  Query row i sits at ``length + i`` (an int,
    0-d or (B,) tensor: one per lane) or, with ``length=None``, at ``Sk -
    Sq + i`` (end-aligned), and sees the keys at or before its position.
    Returns (B, Sq, H, R) in q_lat's type."""
    sq, sk = q_lat.shape[1], c.shape[1]
    dev = q_lat.device
    s = torch.einsum("bshr,bkr->bhsk", q_lat.float(), c.float())
    s += torch.einsum("bshd,bkd->bhsk", q_rope.float(), k_rope.float())
    s *= scale
    rows = torch.arange(sq, device=dev)
    if length is None:
        q_pos = (rows + (sk - sq))[None]                       # (1, Sq)
    else:
        q_pos = torch.as_tensor(length, device=dev).reshape(-1, 1) + rows
    hidden = torch.arange(sk, device=dev)[None, None] > q_pos[:, :, None]
    s.masked_fill_(hidden[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    p.nan_to_num_(nan=0.0)                                     # rows seeing none
    return torch.einsum("bhsk,bkr->bshr", p, c.float()).to(q_lat.dtype)


def mla_prefill_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                    c: torch.Tensor, k_rope: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal, end-aligned: query row i sees keys ``[0, Sk - Sq + i]``."""
    return mla_attention_ref(q_lat, q_rope, c, k_rope, scale)


def mla_decode_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                   c: torch.Tensor, k_rope: torch.Tensor, length,
                   scale: float) -> torch.Tensor:
    """One query a lane (Sq = 1) at ``length`` (a scalar or one per lane):
    keys ``[0, min(length, Sk - 1)]``, none when ``length < 0``."""
    return mla_attention_ref(q_lat, q_rope, c, k_rope, scale, length)
