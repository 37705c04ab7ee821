"""Plain PyTorch version of the chunkwise mLSTM kernel, with a state in
and a state out.

Counterpart of ``repro.models.xlstm.mlstm_chunkwise`` (the oracle that
``repro.kernels.mlstm.ref`` re-exports), step for step, chunk 256 and its
padding included.  :func:`mlstm_chunkwise_bwd_ref` is its explicit
gradient (zero state in, the final state unused): the function the backward
kernel (``kernels/csrc/mlstm_bwd.cu``) computes.  When ``S > 256`` and 256 does not divide ``S``, the
reference pads the sequence with zero inputs and zero gates; the outputs at
real positions do not change, but the final state does: its stabiliser
``m`` becomes ``max(m_S, 0)`` and ``C``, ``n`` are rescaled by
``exp(m_S - m)``.  The kernel reproduces that state exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "M_INIT", "mlstm_chunkwise_bwd_ref", "mlstm_chunkwise_ref",
           "pads"]

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
    as in the reference (f64 for f64 inputs)."""
    b, s, h, dh = q.shape
    ft = torch.promote_types(q.dtype, torch.float32)   # f64 stays f64
    q, k, v, logi, logf = (a.to(ft) for a in (q, k, v, logi, logf))
    qn = min(chunk, s)
    pad = (-s) % qn
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad))
        logf = F.pad(logf, (0, 0, 0, pad))
    nc = q.shape[1] // qn
    scale = dh ** -0.5
    if state is None:
        c = torch.zeros((b, h, dh, dh), dtype=ft, device=q.device)
        n = torch.zeros((b, h, dh), dtype=ft, device=q.device)
        m = torch.full((b, h), M_INIT, dtype=ft, device=q.device)
    else:
        c, n, m = (t.to(ft) for t in state)
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


def mlstm_chunkwise_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, logi: torch.Tensor,
                            logf: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor,
                            chunk: int = CHUNK, *, drop_carry: bool = False,
                            drop_stabiliser: bool = False) -> tuple:
    """The gradient of :func:`mlstm_chunkwise_ref`'s ``out`` (zero state in,
    the final state unused) given ``out`` and its cotangent ``dout``:
    (dq, dk, dv, dlogi, dlogf), in the inputs' float type (f32 at least).

    Written as a chunked reverse recurrence, the backward kernel's order
    of work: the gates and the state (C, n) entering each chunk again; per
    position ``Z_t = max(|den_t|, e^{-m_t}) + 1e-6`` and the two branches'
    gradients (``torch.maximum`` splits a tie); a reverse pass carrying
    ``dC`` (dh x dh) and ``dn`` (dh) from the last chunk to the first,
    stabilised as the forward's states are (``dC`` entering chunk j from
    the right is ``sum_{t >= j} e^{G_{j-1} - G_t} q_t/sqrt(dh) (x)
    dout_t / Z_t``); each chunk's dq, dk, dv from its own rows, the state
    entering it and ``dC`` leaving it.  The gates: with ``a_u = logi_u -
    F_u`` (F the running sum of logf over the sequence), ``G_t`` the running
    max of ``a`` and ``m_t = F_t + G_t``, ``out`` depends on ``a`` through
    every ``e^{a_u - G_t}`` (whose gradient sums to ``k_u . dk_u``), on
    ``G_t`` through the same weights and the stabiliser (``-q_t . dq_t``,
    which is ``-(dout_t . out_t + dden_t den_t)``, plus the floor's
    ``dm_t``), and on ``F_t`` through ``m_t``.  ``G_t``'s gradient goes to
    the position its running max took (the later one at a tie, as
    ``torch.cummax``); ``dlogi = da``, ``dlogf`` the reverse running sum of
    ``dm - da``.  The chunking does not change the function (``m_t`` is the
    running max whatever the chunks), so the kernel's 64-position chunks
    compute the same gradient.

    ``drop_carry`` (dC and dn not carried from chunk to chunk) and
    ``drop_stabiliser`` (no gradient through the stabiliser ``m_t``: the
    floor ``e^{-m_t}`` held constant) give broken gradients, the controls of
    the backward kernel's checks."""
    b, s, h, dh = q.shape
    ft = torch.promote_types(q.dtype, torch.float32)
    q, k, v, logi, logf, out, dout = (
        x.to(ft) for x in (q, k, v, logi, logf, out, dout))
    scale = dh ** -0.5
    qn = min(chunk, s)
    bounds = [(j, min(j + qn, s)) for j in range(0, s, qn)]
    dev = q.device
    # the gates and the state entering each chunk, as the forward forms them
    c = torch.zeros((b, h, dh, dh), dtype=ft, device=dev)
    n = torch.zeros((b, h, dh), dtype=ft, device=dev)
    m = torch.full((b, h), M_INIT, dtype=ft, device=dev)
    fwd = []
    for j0, j1 in bounds:
        ki, vi, li, lf = k[:, j0:j1], v[:, j0:j1], logi[:, j0:j1], \
            logf[:, j0:j1]
        fcum = torch.cumsum(lf, dim=1)                   # (B, Q, H)
        src = li - fcum
        run = torch.cummax(src, dim=1).values
        g = torch.maximum(m[:, None], run)
        g_last = g[:, -1]
        # before t, the running max the cummax compares a_t with
        prev = torch.maximum(m[:, None], torch.cat(
            [torch.full_like(run[:, :1], M_INIT), run[:, :-1]], dim=1))
        fwd.append(dict(src=src, g=g, m_t=fcum + g, record=src >= prev,
                        inter=torch.exp(m[:, None] - g),
                        coeff=torch.exp(src - g_last[:, None]),
                        decay=torch.exp(m - g_last), c=c, n=n))
        coeff = fwd[-1]["coeff"]
        c = (fwd[-1]["decay"][..., None, None] * c
             + torch.einsum("buhd,buhe->bhde", coeff[..., None] * ki, vi))
        n = (fwd[-1]["decay"][..., None] * n
             + torch.einsum("buh,buhd->bhd", coeff, ki))
        m = fcum[:, -1] + g_last
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    dm = torch.zeros_like(logi)
    row = torch.zeros_like(logi)       # q_t . dq_t
    dc = torch.zeros((b, h, dh, dh), dtype=ft, device=dev)
    dn = torch.zeros((b, h, dh), dtype=ft, device=dev)
    for (j0, j1), f in reversed(list(zip(bounds, fwd))):
        if drop_carry:
            dc, dn = torch.zeros_like(dc), torch.zeros_like(dn)
        qi, ki, vi = q[:, j0:j1], k[:, j0:j1], v[:, j0:j1]
        oi, doi = out[:, j0:j1], dout[:, j0:j1]
        ln = j1 - j0
        mask = torch.tril(torch.ones((ln, ln), dtype=torch.bool,
                                     device=dev))[None, :, :, None]
        dmat = torch.exp((f["src"][:, None, :, :] - f["g"][:, :, None, :])
                         .masked_fill(~mask, float("-inf")))  # (B, Qt, Qu, H)
        sc = torch.einsum("bthd,buhd->btuh", qi, ki) * scale
        w = sc * dmat
        qs = qi * scale
        inter = f["inter"]
        den = w.sum(dim=2) + inter * torch.einsum("bthd,bhd->bth", qs, f["n"])
        floor = torch.exp(-f["m_t"])
        z = torch.maximum(den.abs(), floor) + 1e-6
        dz = -(doi * oi).sum(-1) / z
        half = torch.where(den.abs() == floor, 0.5, 1.0).to(ft)
        dden = torch.where(den.abs() >= floor, dz * half, 0.0) * torch.sign(den)
        dm[:, j0:j1] = torch.where(den.abs() <= floor, -dz * half * floor, 0.0)
        row[:, j0:j1] = (doi * oi).sum(-1) + dden * den
        dnum = doi / z[..., None]
        # dW = dnum . v + dden; dS = dW e^{a - G}, masked
        dw = torch.einsum("bthe,buhe->btuh", dnum, vi) + dden[:, :, None]
        ds = dw * dmat
        coeff = f["coeff"]
        dq[:, j0:j1] = scale * (
            torch.einsum("btuh,buhd->bthd", ds, ki)
            + inter[..., None] * (torch.einsum("bthe,bhde->bthd", dnum, f["c"])
                                  + dden[..., None] * f["n"][:, None]))
        dk[:, j0:j1] = (scale * torch.einsum("btuh,bthd->buhd", ds, qi)
                        + coeff[..., None] * (
                            torch.einsum("buhe,bhde->buhd", vi, dc)
                            + dn[:, None]))
        dv[:, j0:j1] = (torch.einsum("btuh,bthe->buhe", w, dnum)
                        + coeff[..., None]
                        * torch.einsum("buhd,bhde->buhe", ki, dc))
        qw = inter[..., None] * qs                       # (B, Q, H, dh)
        dc = (f["decay"][..., None, None] * dc
              + torch.einsum("bthd,bthe->bhde", qw, dnum))
        dn = (f["decay"][..., None] * dn
              + torch.einsum("bth,bthd->bhd", dden, qw))
    # the gates: e^{a_u - G_t} and G_t's stabiliser, routed through the
    # running max to the position it took, then F's reverse running sum
    da = (k * dk).sum(-1)
    if drop_stabiliser:
        dm = torch.zeros_like(dm)
    dg = dm - row
    record = torch.cat([f["record"] for f in fwd], dim=1)
    run_id = torch.cumsum(record.to(torch.long), dim=1) - 1   # (B, S, H)
    routed = torch.zeros_like(dg).scatter_add_(1, run_id, dg)
    da = da + torch.where(record, routed.gather(1, run_id), 0.0)
    dfc = dm - da
    dlogf = torch.flip(torch.cumsum(torch.flip(dfc, [1]), dim=1), [1])
    return dq, dk, dv, da, dlogf
