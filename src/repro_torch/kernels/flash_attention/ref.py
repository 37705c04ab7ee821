"""Plain PyTorch versions of the flash-attention kernels: causal/windowed
GQA attention with an f32 softmax, the same with each row's log-sum-exp,
and its gradient.

``attention_ref`` is the counterpart of
``repro.kernels.flash_attention.ref.attention_ref``, line for line.  A
query row that sees no key returns 0, as the oracle does, and gets no
gradient.  ``attention_lse_ref`` and ``attention_bwd_ref`` are the plain
versions of the forward kernel's log-sum-exp output and of the backward
kernel (``csrc/flash_attention_bwd.cu``), which the reference has no
counterpart of: JAX differentiates its jnp attention.
"""
from __future__ import annotations

import torch

__all__ = ["attention_bwd_ref", "attention_lse_ref", "attention_ref"]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in f64 if it is f64 (the f64 gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mask(sq: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, Sk) True where end-aligned query row i sees key j."""
    qp = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= kp > qp - window
    return mask


def _scores(q, k, causal, window):
    """The masked f32 scores (B, H, Sq, Sk), scaled, -inf where masked, and
    the mask."""
    _, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(kr)) * (dh ** -0.5)
    mask = _mask(sq, sk, causal, window, q.device)
    return s.masked_fill(~mask, float("-inf")), mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Sk, KV, dh).  Returns (B, Sq, H, dh)
    in q's type.  Query positions are end-aligned: row i sits at
    ``Sk - Sq + i``."""
    h, kvh = q.shape[2], k.shape[2]
    vr = v.repeat_interleave(h // kvh, dim=2)
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)            # fully masked rows
    return torch.einsum("bhqk,bkhd->bqhd", p, _wide(vr)).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0) -> tuple:
    """:func:`attention_ref`'s output and each row's log-sum-exp of the
    scaled scores, f32 (B, H, Sq), -inf for a row that sees no key: what
    the forward kernel writes when it is given a pointer for it."""
    s, _ = _scores(q, k, causal, window)
    return attention_ref(q, k, v, causal, window), torch.logsumexp(s, -1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool = True, window: int = 0) -> tuple:
    """The gradient of :func:`attention_ref` by the explicit formula, in
    f32 (f64 for f64 inputs), as the backward kernel computes it: with P = exp(S scale - lse)
    (0 where masked) and D = rowsum(dO o O) from the forward output ``o``,
    dV = P^T dO, dS = P o (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale,
    each kv head's dK and dV summed over its group of query heads.
    Returns (dq, dk, dv) in the inputs' types."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = dh ** -0.5
    kr = _wide(k.repeat_interleave(rep, dim=2))
    vr = _wide(v.repeat_interleave(rep, dim=2))
    s, mask = _scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dof = _wide(do)
    dsum = (dof * _wide(o)).sum(-1).transpose(1, 2)          # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _wide(q)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kvh, rep, dh).sum(3)
    dv = dv.reshape(b, sk, kvh, rep, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
