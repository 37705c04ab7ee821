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

:func:`mla_prefill_tiles` and :func:`mla_decode_splits` are plain models of
the order in which ``mla_attention.cu``'s kernels compute the same function
(tiles, splits, the online softmax, where P is rounded), for the tests to
hold the kernels' arithmetic on the CPU and the kernels to it on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mla_attention_ref", "mla_decode_ref", "mla_decode_splits",
           "mla_prefill_ref", "mla_prefill_tiles"]

LOG2E = 1.4426950408889634


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


def _online_tile(s, v, m, lsum, acc, sl2, work):
    """One tile of the online softmax in log2 units: scores ``s`` (rows,
    keys; -inf where masked), values ``v``; P rounded to ``work`` before P V,
    l summing P unrounded."""
    mn = torch.maximum(m, s.max(-1).values * sl2)
    mu = torch.where(mn == -math.inf, 0.0, mn)
    al = torch.exp2(m - mu)
    p = torch.exp2(s * sl2 - mu[:, None])
    return (mn, lsum * al + p.sum(-1),
            acc * al[:, None] + p.to(work).float() @ v)


def mla_prefill_tiles(q_lat, q_rope, c, k_rope, scale, rows=128, tile=64):
    """A plain model of the bf16 prefill kernel: the flattened rows r = i H
    + h in blocks of ``rows`` (two warpgroups of 64), each block walking the
    ``tile``-key tiles up to its last row's causal limit (keys past Sk arrive
    as zeros and are masked with the rest past a row's limit), an online
    softmax in f32 and log2 units, O rescaled by each tile's factors and P
    rounded to the working type (q_lat's) before P V, as the register
    operand of ``wgmma`` takes it; l sums P unrounded; each row's output is
    O times 1 / l (0 for a row that sees nothing), in the working type."""
    b, sq, h, r = q_lat.shape
    sk, dev, work = c.shape[1], q_lat.device, q_lat.dtype
    sl2 = scale * LOG2E
    n_rows = sq * h
    q = torch.cat([q_lat, q_rope], -1).float().reshape(b, n_rows, -1)
    k = torch.cat([c, k_rope], -1).float()
    out = torch.zeros((b, n_rows, r), device=dev)
    for bb in range(b):
        for m0 in range(0, n_rows, rows):
            rr = torch.arange(m0, min(m0 + rows, n_rows), device=dev)
            lim = (sk - sq + rr // h + 1).clamp(0, sk)
            m = torch.full((len(rr),), -math.inf, device=dev)
            lsum = torch.zeros(len(rr), device=dev)
            acc = torch.zeros(len(rr), r, device=dev)
            for k0 in range(0, int(lim.max()), tile):
                kt = torch.zeros(tile, k.shape[-1], device=dev)
                kt[:min(k0 + tile, sk) - k0] = k[bb, k0:k0 + tile]
                s = (q[bb, rr] @ kt.T).masked_fill(
                    torch.arange(k0, k0 + tile, device=dev)[None]
                    >= lim[:, None], -math.inf)
                m, lsum, acc = _online_tile(s, kt[:, :r], m, lsum, acc, sl2,
                                            work)
            inv = torch.where(lsum > 0, 1.0 / lsum.clamp(min=1e-30), 0.0)
            out[bb, rr] = acc * inv[:, None]
    return out.reshape(b, sq, h, r).to(work)


def mla_decode_splits(q_lat, q_rope, c, k_rope, length, scale, nsplit,
                      tile=64):
    """A plain model of the decode kernels: each lane's visible keys [0, hi)
    cut into ``nsplit`` shares of equal length, rounded up to the tile (64
    keys in bf16, 32 in f32), in split order; each split an online softmax
    over its tiles in log2 units, (m, l, acc), P rounded to the working type
    (q_lat's) before P V and l summing P unrounded; the combine adds the
    splits' partials in split order, weighted by exp2(m_s - m)."""
    b, _, h, r = q_lat.shape
    sk, dev, work = c.shape[1], q_lat.device, q_lat.dtype
    sl2 = scale * LOG2E
    ql, qr, cf, kr = (t.float() for t in (q_lat, q_rope, c, k_rope))
    lengths = torch.as_tensor(length).reshape(-1).expand(b).tolist()
    out = torch.zeros((b, 1, h, r), device=dev)
    for lane in range(b):
        ln = int(lengths[lane])
        hi = 0 if ln < 0 else min(ln, sk - 1) + 1
        share = -(-(-(-hi // nsplit)) // tile) * tile
        parts = []
        for sp in range(nsplit):
            m = torch.full((h,), -math.inf, device=dev)
            lsum = torch.zeros(h, device=dev)
            acc = torch.zeros(h, r, device=dev)
            for t0 in range(sp * share, min(hi, sp * share + share), tile):
                t1 = min(hi, sp * share + share, t0 + tile)
                s = (ql[lane, 0] @ cf[lane, t0:t1].T
                     + qr[lane, 0] @ kr[lane, t0:t1].T)
                m, lsum, acc = _online_tile(s, cf[lane, t0:t1], m, lsum, acc,
                                            sl2, work)
            parts.append((m, lsum, acc))
        mm = torch.stack([p[0] for p in parts]).max(0).values
        tot = torch.zeros(h, device=dev)
        num = torch.zeros(h, r, device=dev)
        for ms, ls, acs in parts:
            w = torch.where(ms == -math.inf, 0.0, torch.exp2(ms - mm))
            tot = tot + ls * w
            num = num + acs * w[:, None]
        out[lane, 0] = torch.where(tot[:, None] > 0,
                                   num / tot.clamp(min=1e-30)[:, None], 0.0)
    return out.to(work)
