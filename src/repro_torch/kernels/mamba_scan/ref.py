"""Plain PyTorch versions of the selective scan.

:func:`mamba_scan_ref` is the oracle of the Pallas kernel
(``repro.kernels.mamba_scan.ref.mamba_scan_ref``): discretised inputs
``a_bar``, ``b_bar`` (B, S, D, N) and ``c`` (B, S, N), zero state in, ``y``
out.  :func:`selective_scan_ref` is the function the model runs and the
CUDA kernel computes: the reference model's ``_chunked_selective_scan``
(``repro/models/mamba.py``) followed by the ``bsdn,bsn->bsd``
contraction, with the discretisation of the undiscretised inputs done
inside, in the reference's order of operations
(``a_bar = exp(dt a)``, ``b_bar = (dt B_n) u_d``), a state in and a state
out.  Both run the recurrence ``h_t = a_t h_{t-1} + b_t`` one position at
a time, which is the kernel's order; the reference's associative scan
within a chunk groups the products differently, within f32 rounding.  The
reference pads a ragged last chunk with ``a = 1``, ``b = 0``, which leaves
the final state as it is: nothing to reproduce.  The discretised
``(Q, D, N)`` tensors are formed one chunk of :data:`CHUNK` positions at a
time, as the reference forms them.  :func:`selective_scan_bwd_ref` is
the gradient of :func:`selective_scan_ref`'s ``y`` (zero state in, the final
state unused), the function the backward kernel
(``kernels/csrc/mamba_scan_bwd.cu``) computes.
"""
from __future__ import annotations

import torch

__all__ = ["CHUNK", "mamba_scan_ref", "selective_scan_bwd_ref",
           "selective_scan_ref"]

CHUNK = 256        # the reference's chunk


def mamba_scan_ref(a_bar: torch.Tensor, b_bar: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """a_bar, b_bar: (B, S, D, N); c: (B, S, N) -> y: (B, S, D), f32."""
    b, s, d, n = a_bar.shape
    a_bar, b_bar, c = a_bar.float(), b_bar.float(), c.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=a_bar.device)
    ys = []
    for t in range(s):
        h = a_bar[:, t] * h + b_bar[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1)


def selective_scan_ref(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, u: torch.Tensor,
                       h0: torch.Tensor | None = None,
                       chunk: int = CHUNK) -> tuple:
    """dt (B, S) after the softplus; a (D, N) = -exp(a_log); bmat, cmat
    (B, S, N); u (B, S, D), the activation after the conv and SiLU; h0
    (B, D, N) or None (zero state).  Returns (y (B, S, D), h_last
    (B, D, N)), f32, as the reference computes them (f64 for an f64
    ``dt``)."""
    b, s = dt.shape
    d, n = a.shape
    ft = torch.promote_types(dt.dtype, torch.float32)   # f64 stays f64
    dt, a, bmat, cmat, u = (x.to(ft) for x in (dt, a, bmat, cmat, u))
    h = (torch.zeros((b, d, n), dtype=ft, device=dt.device)
         if h0 is None else h0.to(ft))
    ys = []
    for j in range(0, s, chunk):
        sl = slice(j, min(j + chunk, s))
        dtc = dt[:, sl, None, None]                          # (B, Q, 1, 1)
        a_bar = torch.exp(dtc * a)                           # (B, Q, D, N)
        b_bar = dtc * bmat[:, sl, None, :] * u[:, sl, :, None]
        for t in range(a_bar.shape[1]):
            h = a_bar[:, t] * h + b_bar[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, j + t]))
    return torch.stack(ys, dim=1), h


def selective_scan_bwd_ref(dt: torch.Tensor, a: torch.Tensor,
                           bmat: torch.Tensor, cmat: torch.Tensor,
                           u: torch.Tensor, dy: torch.Tensor,
                           chunk: int = CHUNK, *, drop_carry: bool = False,
                           drop_decay_term: bool = False) -> tuple:
    """The gradient of :func:`selective_scan_ref`'s ``y`` (zero state in,
    the final state unused) given its cotangent ``dy`` (B, S, D): (ddt
    (B, S), da (D, N), dB, dC (B, S, N), du (B, S, D)), f32 (f64 for an f64
    ``dt``).  The explicit reverse recurrence, one position at a time, with
    the discretisation in the reference's order (``a_bar = exp(dt a)``,
    ``b_bar = (dt B) u``):

        dh_t  = a_bar_{t+1} dh_{t+1} + C_t (x) dy_t
        dC_t  = sum_d h_t dy_t           du_t = sum_n dh_t (dt_t B_t)
        dB_t  = dt_t sum_d dh_t u_t
        ddt_t = sum_{d,n} dh_t (a a_bar_t h_{t-1} + B_t u_t)
        da    = sum_{b,t} dh_t dt_t a_bar_t h_{t-1}

    The states are recomputed a chunk of :data:`CHUNK` positions at a time
    from the state entering it (kept for every chunk), so memory is one
    chunk's ``(Q, B, D, N)``.  ``drop_carry`` (dh not carried from chunk to
    chunk) and ``drop_decay_term`` (ddt without ``a a_bar h``) give broken
    gradients, the controls of the backward kernel's checks."""
    b, s = dt.shape
    d, n = a.shape
    ft = torch.promote_types(dt.dtype, torch.float32)
    dt, a, bmat, cmat, u, dy = (x.to(ft)
                                for x in (dt, a, bmat, cmat, u, dy))
    dev = dt.device
    h = torch.zeros((b, d, n), dtype=ft, device=dev)
    starts = []
    for j in range(0, s, chunk):
        starts.append(h)
        for t in range(j, min(j + chunk, s)):
            h = (torch.exp(dt[:, t, None, None] * a) * h
                 + (dt[:, t, None] * bmat[:, t])[:, None, :]
                 * u[:, t, :, None])
    ddt = torch.zeros_like(dt)
    dbm, dcm = torch.zeros_like(bmat), torch.zeros_like(cmat)
    du = torch.zeros_like(u)
    da = torch.zeros_like(a)
    dh = torch.zeros((b, d, n), dtype=ft, device=dev)
    a_next = None                                # a_bar_{t+1}
    for j, h in reversed(list(zip(range(0, s, chunk), starts))):
        ts = range(j, min(j + chunk, s))
        if drop_carry:
            a_next = None
        hs = []                                  # h_{t-1} of each t
        for t in ts:
            hs.append(h)
            h = (torch.exp(dt[:, t, None, None] * a) * h
                 + (dt[:, t, None] * bmat[:, t])[:, None, :]
                 * u[:, t, :, None])
        for t, hp in zip(reversed(ts), reversed(hs)):
            a_bar = torch.exp(dt[:, t, None, None] * a)
            dtb = dt[:, t, None] * bmat[:, t]                   # (B, N)
            h_t = a_bar * hp + dtb[:, None, :] * u[:, t, :, None]
            dh = dy[:, t, :, None] * cmat[:, t, None, :] + (
                0.0 if a_next is None else a_next * dh)
            dcm[:, t] = torch.einsum("bdn,bd->bn", h_t, dy[:, t])
            du[:, t] = torch.einsum("bdn,bn->bd", dh, dtb)
            dhu = torch.einsum("bdn,bd->bn", dh, u[:, t])       # d(dt B)
            dbm[:, t] = dhu * dt[:, t, None]
            dabar = dh * hp * a_bar                            # d(dt a)
            ddt[:, t] = (dhu * bmat[:, t]).sum(-1)
            if not drop_decay_term:
                ddt[:, t] += (dabar * a).sum((1, 2))
            da += (dabar * dt[:, t, None, None]).sum(0)
            a_next = a_bar
    return ddt, da, dbm, dcm, du
