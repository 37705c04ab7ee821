"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that takes the plain version
for a CPU tensor and launches the kernel for a CUDA tensor.

Flash attention, the chunkwise mLSTM and the selective scan have backward
kernels (``flash_attention_bwd``, ``mlstm_bwd``, ``mamba_scan_bwd``), each
behind a ``torch.autograd.Function``.  The wrappers of the MLA and
decode-attention kernels, which serve only, refuse a CUDA tensor that needs
a gradient (:func:`no_backward`): a ctypes launch returns a tensor without
one, and a loss through it would silently train nothing below it."""
from __future__ import annotations

__all__ = ["no_backward"]


def no_backward(kernel: str, item: str | None, *tensors,
                instead: str | None = None) -> None:
    """Raise ``NotImplementedError`` if grad mode is on and any of
    ``tensors`` requires a gradient: ``kernel`` has no backward kernel yet
    (ROADMAP ``item``; None where none is queued, because training does
    not reach the kernel).  ``instead`` names the path that trains in its
    place, for a kernel that serves only."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        if instead:
            raise NotImplementedError(
                f"the {kernel} kernel serves only and has no backward "
                f"kernel: training runs {instead}; call it under "
                f"torch.no_grad()")
        why = (f"no backward kernel yet, so it cannot train on the card "
               f"(ROADMAP queue 1, {item})" if item else
               "no backward kernel, so it cannot train on the card")
        raise NotImplementedError(
            f"the {kernel} kernel has {why}; call it under "
            f"torch.no_grad(), or train on the CPU's plain path")
