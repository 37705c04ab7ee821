"""Mamba (S6) block: the selective state-space scan.

Counterpart of ``repro.models.mamba`` with the same parameter tree
(``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``, ``dt_bias``, ``a_log``,
``d_skip``, ``out_proj``) and the same serving state: an f32 ``(B,
d_inner, d_state)`` SSM state and an f32 ``(B, d_conv - 1, d_inner)`` conv
buffer.  A multi-token call (prefill) runs the scan, its discretisation
fused in, through ``kernels.mamba_scan.ops.selective_scan``, which
launches the hand-written CUDA kernel on the card and takes its plain
version on the CPU; ``plain=True`` calls the plain version on any device
(a check-only switch; serving never sets it).  Under a gradient (training,
from the zero state) the same call goes through the ``SelectiveScan``
autograd Function, whose backward is the hand-written backward kernel on
the card (``kernels.mamba_scan_bwd``), so Jamba's Mamba layers train on
the card.  One token with a state is the reference's plain recurrence
step, as in its decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ops as scan_ops
from ..kernels.mamba_scan.ref import selective_scan_ref
from .layers import dense_init

__all__ = ["init_mamba", "causal_conv", "mamba_block", "init_mamba_state"]


def init_mamba(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.d_state
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(di, n)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype),
        "conv_w": dense_init(gen, (cfg.d_conv, di), dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, 2 * n + 1), dtype),
        "dt_bias": torch.full((1,), 0.5, dtype=dtype, device=dev),
        "a_log": a_log.contiguous().to(dtype),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """u: (B, S, di); w: (K, di) depthwise causal conv, as the reference's
    ``_causal_conv`` sums its taps."""
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = sum(up[:, i:i + u.shape[1], :] * w[i] for i in range(k))
    return out + b


def mamba_block(p: dict, x: torch.Tensor, cfg, state: tuple | None = None,
                plain: bool = False) -> tuple:
    """x: (B, S, d).  ``state = (ssm (B, di, n), conv_buf (B, K-1, di))``
    for serving: prefill (S > 1) from it, or one decode step (S = 1).
    Returns (out, new state or None)."""
    b, s, _ = x.shape
    n = cfg.d_state
    dt_ = x.dtype
    xz = x @ p["in_proj"].to(dt_)
    u, z = xz.chunk(2, dim=-1)                         # (B, S, di)

    new_state = None
    if state is not None:
        ssm, conv_buf = state
        kk = p["conv_w"].shape[0]
        upad = torch.cat([conv_buf.to(dt_), u], dim=1)
        w = p["conv_w"].to(dt_)
        uc = sum(upad[:, i:i + s, :] * w[i] for i in range(kk))
        uc = uc + p["conv_b"].to(dt_)
        new_conv = upad[:, upad.shape[1] - (kk - 1):]
    else:
        uc = causal_conv(u, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    uc = F.silu(uc)

    proj = uc @ p["x_proj"].to(dt_)                    # (B, S, 2n+1)
    bmat, cmat, dt = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:]
    dt = F.softplus(dt + p["dt_bias"].to(dt_))         # (B, S, 1)
    a = -torch.exp(p["a_log"].float())                 # (di, n)
    dtf = dt[..., 0].float()                           # (B, S)

    if state is not None and s == 1:
        # the reference's decode step: one recurrence step, no scan
        a_bar = torch.exp(dtf[:, 0, None, None] * a)
        b_bar = (dtf[:, 0, None, None] * bmat[:, 0, None, :].float()
                 * uc[:, 0, :, None].float())
        h_last = a_bar * ssm.float() + b_bar
        y = torch.einsum("bdn,bn->bd", h_last, cmat[:, 0].float())[:, None]
    else:
        h0 = None if state is None else ssm.float().contiguous()
        scan = selective_scan_ref if plain else scan_ops.selective_scan
        y, h_last = scan(dtf.contiguous(), a.contiguous(), bmat, cmat,
                         uc.contiguous(), h0)
    if state is not None:
        new_state = (h_last.to(ssm.dtype), new_conv)

    y = y.to(dt_) + uc * p["d_skip"].to(dt_)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(dt_), new_state


def init_mamba_state(cfg, batch: int, device,
                     dtype: torch.dtype = torch.float32) -> tuple:
    """A fresh serving state: zero SSM state (B, di, n) and conv buffer
    (B, K-1, di)."""
    di = cfg.mamba_expand * cfg.d_model
    return (torch.zeros((batch, di, cfg.d_state), dtype=dtype, device=device),
            torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                        device=device))

