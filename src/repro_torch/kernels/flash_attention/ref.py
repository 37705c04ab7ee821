"""Plain PyTorch version of the flash-attention kernel: causal/windowed
GQA attention with an f32 softmax.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref``, line
for line.  A query row that sees no key returns 0, as the oracle does.
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Sk, KV, dh).  Returns (B, Sq, H, dh)
    in q's type.  Query positions are end-aligned: row i sits at
    ``Sk - Sq + i``."""
    _, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * (dh ** -0.5)
    qp = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)            # fully masked rows
    return torch.einsum("bhqk,bkhd->bqhd", p, vr.float()).to(q.dtype)
