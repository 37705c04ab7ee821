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
time, as the reference forms them.
"""
from __future__ import annotations

import torch

__all__ = ["CHUNK", "mamba_scan_ref", "selective_scan_ref"]

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
    (B, D, N)), f32, as the reference computes them."""
    b, s = dt.shape
    d, n = a.shape
    dt, a = dt.float(), a.float()
    bmat, cmat, u = bmat.float(), cmat.float(), u.float()
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
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
