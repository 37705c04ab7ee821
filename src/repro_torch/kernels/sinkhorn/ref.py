"""Plain PyTorch Sinkhorn projection: the oracle of the CUDA kernel.

Counterpart of ``repro.kernels.sinkhorn.ref.sinkhorn_ref``: clamp at
``eps``, then ``iters`` rounds of row and column normalization.  It
computes in the input's float type (f32 or f64); a half-precision input
(bf16, f16) is cast to f32 first, as ``sinkhorn_pallas`` does.

:func:`sinkhorn_kernel_order` is a plain model of the CUDA kernel's
cluster path in its own order of summation; the card checks hold the
kernel to it bit for bit.  Nothing on the main path calls it.
"""
from __future__ import annotations

import torch

__all__ = ["sinkhorn_ref", "sinkhorn_kernel_order"]

GROUP = 16   # rows of one column partial (sinkhorn.cu)
WARP = 32    # lanes of a warp: a block's threads are n rounded up to it


def _float(m: torch.Tensor) -> torch.Tensor:
    return m if m.dtype in (torch.float32, torch.float64) else m.to(
        torch.float32)


def sinkhorn_ref(m: torch.Tensor, iters: int = 20,
                 eps: float = 1e-12) -> torch.Tensor:
    m = torch.clamp_min(_float(m), eps)
    for _ in range(iters):
        m = m / m.sum(dim=1, keepdim=True)
        m = m / m.sum(dim=0, keepdim=True)
    return m


def sinkhorn_kernel_order(m: torch.Tensor, iters: int = 20,
                          eps: float = 1e-12,
                          cluster: int = 16) -> torch.Tensor:
    """``sinkhorn.cu``'s cluster path, operation for operation, with
    elementwise PyTorch ops (each one IEEE-rounded, on the CPU as on the
    card):

    * the matrix is padded with zeros to whole groups of 16 rows for each
      of ``cluster`` blocks (a block may hold none) and to columns of a
      whole warp; padding is never divided;
    * a row's sum: each warp's 32 lanes fold in halves (lane l + lane
      l + 16, then + 8, + 4, + 2, + 1), then the warps' sums add in order;
    * a column's total: each block sums its groups' 16 rows in row order
      into a partial, and the total adds the partials of every group in
      group order, each read from the block that holds it;
    * each division is ``x / s``.
    """
    m = _float(m)
    n = m.shape[0]
    groups = -(-n // GROUP)
    gpb = -(-groups // cluster)
    rows, cols = cluster * gpb * GROUP, -(-n // WARP) * WARP
    x = m.new_zeros(rows, cols)
    x[:n, :n] = torch.where(m < eps, torch.full_like(m, eps), m)
    valid = torch.zeros(rows, cols, dtype=torch.bool, device=m.device)
    valid[:n, :n] = True
    for _ in range(iters):
        s = x.view(rows, cols // WARP, WARP)
        while s.shape[-1] > 1:
            h = s.shape[-1] // 2
            s = s[..., :h] + s[..., h:]
        s = s[..., 0]
        tot = s[:, 0]
        for w in range(1, s.shape[1]):
            tot = tot + s[:, w]
        x = torch.where(valid, x / tot[:, None], x)
        slabs = x.view(cluster, gpb, GROUP, cols)
        part = slabs[:, :, 0]
        for i in range(1, GROUP):
            part = part + slabs[:, :, i]
        col = part[0, 0]
        for g in range(1, groups):
            col = col + part[g // gpb, g % gpb]
        x = torch.where(valid, x / col, x)
    return x[:n, :n].clone()
