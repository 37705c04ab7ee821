"""Plain PyTorch version of the chunkwise mLSTM kernel, with a state in
and a state out.

Counterpart of ``repro.models.xlstm.mlstm_chunkwise`` (the oracle that
``repro.kernels.mlstm.ref`` re-exports), step for step, chunk 256 and its
padding included.  When ``S > 256`` and 256 does not divide ``S``, the
reference pads the sequence with zero inputs and zero gates; the outputs at
real positions do not change, but the final state does: its stabiliser
``m`` becomes ``max(m_S, 0)`` and ``C``, ``n`` are rescaled by
``exp(m_S - m)``.  The kernel reproduces that state exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "M_INIT", "mlstm_chunkwise_ref", "pads"]

CHUNK = 256        # the reference's chunk
M_INIT = -1e30     # the stabiliser of a missing state, as in the reference


def pads(s: int, chunk: int = CHUNK) -> bool:
    """Whether the reference pads a sequence of ``s`` positions."""
    return (-s) % min(chunk, s) != 0


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logi: torch.Tensor, logf: torch.Tensor,
                        state: tuple | None = None,
                        chunk: int = CHUNK) -> tuple:
    """q, k, v: (B, S, H, dh); logi, logf: (B, S, H) log-space gates;
    ``state`` ``(C (B, H, dh, dh), n (B, H, dh), m (B, H))`` or None (zero
    state, ``m`` at -1e30).  Returns (out (B, S, H, dh), final state), f32
    as in the reference."""
    b, s, h, dh = q.shape
    q, k, v, logi, logf = (a.float() for a in (q, k, v, logi, logf))
    qn = min(chunk, s)
    pad = (-s) % qn
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad))
        logf = F.pad(logf, (0, 0, 0, pad))
    nc = q.shape[1] // qn
    scale = dh ** -0.5
    if state is None:
        c = torch.zeros((b, h, dh, dh), device=q.device)
        n = torch.zeros((b, h, dh), device=q.device)
        m = torch.full((b, h), M_INIT, device=q.device)
    else:
        c, n, m = (t.float() for t in state)
    mask = torch.tril(torch.ones((qn, qn), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    outs = []
    for j in range(nc):
        sl = slice(j * qn, (j + 1) * qn)
        qi, ki, vi, li, lf = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], \
            logf[:, sl]
        fcum = torch.cumsum(lf, dim=1)                   # (B, Q, H)
        src = li - fcum                                  # logi_u - F_u
        g = torch.maximum(m[:, None], torch.cummax(src, dim=1).values)
        m_t = fcum + g
        inter_c = torch.exp(m[:, None] - g)              # (B, Q, H)
        dmat = src[:, None, :, :] - g[:, :, None, :]     # (B, Qt, Qu, H)
        dstab = torch.exp(dmat.masked_fill(~mask, float("-inf")))
        scores = torch.einsum("bthd,buhd->btuh", qi, ki) * scale
        w = scores * dstab
        num = (torch.einsum("btuh,buhd->bthd", w, vi)
               + inter_c[..., None]
               * torch.einsum("bthd,bhde->bthe", qi * scale, c))
        den_intra = w.sum(dim=2)
        den_inter = inter_c * torch.einsum("bthd,bhd->bth", qi * scale, n)
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_t))
        outs.append(num / (den[..., None] + 1e-6))
        # end-of-chunk state at stabiliser m_last = F_last + g_last
        f_last, g_last = fcum[:, -1], g[:, -1]           # (B, H)
        coeff_u = torch.exp(src - g_last[:, None])       # (B, Q, H)
        decay = torch.exp(m - g_last)
        c = (decay[..., None, None] * c
             + torch.einsum("buhd,buhe->bhde", coeff_u[..., None] * ki, vi))
        n = decay[..., None] * n + torch.einsum("buh,buhd->bhd", coeff_u, ki)
        m = f_last + g_last
    out = torch.cat(outs, dim=1)[:, :s]
    return out, (c, n, m)
