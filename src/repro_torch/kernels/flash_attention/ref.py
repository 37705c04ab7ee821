"""Plain PyTorch versions of the flash-attention kernels: causal/windowed
GQA attention with an f32 softmax, the same with each row's log-sum-exp,
and its gradient.  q and k share one width (dqk) and v may have another
(dv, as MLA's cacheless branch has: q/k 96, v 64); the output, dO and dV
are dv wide, dQ and dK dqk wide, and the scale is dqk^-0.5.

``attention_ref`` is the counterpart of
``repro.kernels.flash_attention.ref.attention_ref``, line for line.  A
query row that sees no key returns 0, as the oracle does, and gets no
gradient.  ``attention_lse_ref`` and ``attention_bwd_ref`` are the plain
versions of the forward kernel's log-sum-exp output and of the backward
kernel (``csrc/flash_attention_bwd.cu``), which the reference has no
counterpart of: JAX differentiates its jnp attention.
``attention_bwd_tiles`` models the bf16 backward kernel's own arithmetic
(its roundings and its order of sums), so that the card can hold the
kernel to it more tightly than to the plain version.
"""
from __future__ import annotations

import torch

__all__ = ["BWD_KV_STEP", "BWD_Q_STEP", "attention_bwd_ref",
           "attention_bwd_tiles", "attention_lse_ref", "attention_ref"]

# the bf16 backward kernel's steps (csrc/flash_attention_bwd.cu): query rows
# a step of the dK/dV kernel (KvCfg::BQ), keys a step of the dQ kernel
# (QCfg::BK)
BWD_KV_STEP = 64
BWD_Q_STEP = 64
_LOG2E = 1.4426950408889634


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
    """q: (B, Sq, H, dqk); k: (B, Sk, KV, dqk); v: (B, Sk, KV, dv).
    Returns (B, Sq, H, dv) in q's type.  Query positions are end-aligned:
    row i sits at ``Sk - Sq + i``."""
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
    f32 (f64 for f64 inputs), as the backward kernel computes it: with
    P = exp(S scale - lse) (0 where masked) and D = rowsum(dO o O) from
    the forward output ``o``, dV = P^T dO, dS = P o (dO V^T - D),
    dQ = dS K scale, dK = dS^T Q scale, each kv head's dK and dV summed
    over its group of query heads.
    Returns (dq, dk, dv) in the inputs' types."""
    b, sq, h, dqk = q.shape
    sk, kvh, dvw = k.shape[1], k.shape[2], v.shape[3]
    rep = h // kvh
    scale = dqk ** -0.5
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
    dk = dk.reshape(b, sk, kvh, rep, dqk).sum(3)
    dv = dv.reshape(b, sk, kvh, rep, dvw).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0) -> tuple:
    """A plain model of the bf16 backward kernel's arithmetic on bf16
    inputs: f32 (dq, dk, dv) as the kernel holds them before it rounds
    them to bf16.  S = Q K^T and dP = dO V^T are f32 sums of exact
    products; P = exp2(fma(S, scale log2 e, -lse log2 e)), 0 where masked;
    D = rowsum(dO o O) in f32; dS = P o (dP - D).  P and dS are rounded to
    bf16 before their products, as the kernel rounds its register A
    operands.  Each kv head's dK and dV are summed in f32 over its group's
    heads in head order and, within a head, over steps of
    ``BWD_KV_STEP`` query rows in order; dQ over steps of
    ``BWD_Q_STEP`` keys in order (steps no pair of which is visible add
    zeros, which the kernel skips).  dq and dk carry the scale."""
    _, sq, h, dqk = q.shape
    sk, kvh, dvw = k.shape[1], k.shape[2], v.shape[3]
    rep = h // kvh
    f32 = torch.float32
    scale = torch.tensor(dqk ** -0.5, dtype=f32)
    sl2 = (scale * torch.tensor(_LOG2E, dtype=f32)).double()
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    kr = kf.repeat_interleave(rep, dim=2)
    vr = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    l2 = (lse.to(f32) * torch.tensor(_LOG2E, dtype=f32)).double()
    mask = _mask(sq, sk, causal, window, q.device)
    arg = (s.double() * sl2 - l2[..., None]).to(f32)        # one fma
    # 2^arg exact in f64, then rounded: the kernel's ex2.approx is within
    # 2 ulps of it
    p = torch.where(mask, torch.exp2(arg.double()).to(f32), 0.0)
    dsum = (dof * o.to(f32)).sum(-1).transpose(1, 2)         # (B, H, Sq)
    ds = p * (dp - dsum[..., None])
    pb, dsb = (t.to(torch.bfloat16).to(f32) for t in (p, ds))
    del s, dp, arg, p, ds
    dk = torch.zeros(k.shape[0], kvh, sk, dqk, dtype=f32, device=q.device)
    dv = torch.zeros(k.shape[0], kvh, sk, dvw, dtype=f32, device=q.device)
    step = BWD_KV_STEP
    for hh in range(rep):
        heads = torch.arange(kvh, device=q.device) * rep + hh
        for q0 in range(0, sq, step):
            rows = slice(q0, q0 + step)
            dv += torch.einsum("bgqk,bqgd->bgkd", pb[:, heads, rows],
                               dof[:, rows][:, :, heads])
            dk += torch.einsum("bgqk,bqgd->bgkd", dsb[:, heads, rows],
                               qf[:, rows][:, :, heads])
    dq = torch.zeros(q.shape[0], h, sq, dqk, dtype=f32, device=q.device)
    for k0 in range(0, sk, BWD_Q_STEP):
        keys = slice(k0, k0 + BWD_Q_STEP)
        dq += torch.einsum("bhqk,bkhd->bhqd", dsb[..., keys], kr[:, keys])
    return ((dq * scale).transpose(1, 2), (dk * scale).transpose(1, 2),
            dv.transpose(1, 2))
