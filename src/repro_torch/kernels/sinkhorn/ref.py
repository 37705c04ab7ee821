"""Plain PyTorch Sinkhorn projection: the oracle of the CUDA kernel.

Counterpart of ``repro.kernels.sinkhorn.ref.sinkhorn_ref``: clamp at
``eps``, then ``iters`` rounds of row and column normalization.  It
computes in the input's float type (f32 or f64); a half-precision input
(bf16, f16) is cast to f32 first, as ``sinkhorn_pallas`` does.
"""
from __future__ import annotations

import torch

__all__ = ["sinkhorn_ref"]


def sinkhorn_ref(m: torch.Tensor, iters: int = 20,
                 eps: float = 1e-12) -> torch.Tensor:
    if m.dtype not in (torch.float32, torch.float64):
        m = m.to(torch.float32)
    m = torch.clamp_min(m, eps)
    for _ in range(iters):
        m = m / m.sum(dim=1, keepdim=True)
        m = m / m.sum(dim=0, keepdim=True)
    return m
