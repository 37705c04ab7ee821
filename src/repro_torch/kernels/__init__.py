"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that takes the plain version
for a CPU tensor and launches the kernel for a CUDA tensor.

Flash attention, the chunkwise mLSTM and the selective scan have backward
kernels (``flash_attention_bwd``, ``mlstm_bwd``, ``mamba_scan_bwd``), each
behind a ``torch.autograd.Function``.  The wrappers of the MLA and
decode-attention kernels, which serve only, refuse a CUDA tensor that needs
a gradient (:func:`no_backward`): a ctypes launch returns a tensor without
one, and a loss through it would silently train nothing below it.

Every ``*_kernel`` function also has a meta rule, reached only when all its
tensors lie on the ``meta`` device (the dry-run, ``launch.dryrun``): it
checks its arguments as the launch does and raises where the kernel would,
allocates its outputs and scratch on ``meta``, adds the kernel's operations
(as PERF.md's bound counts them) to the open dry-run trace
(:func:`count_flops`), launches nothing and adds nothing to ``launches``."""
from __future__ import annotations

__all__ = ["H100_SMS", "count_flops", "no_backward", "on_meta",
           "visible_pairs"]

# what a meta rule plans a split count for: the H100 SXM's SMs (a meta
# tensor has no card to ask)
H100_SMS = 132

def on_meta(*tensors) -> bool:
    """True when every tensor given (None skipped) is on ``meta``."""
    return all(t.device.type == "meta" for t in tensors if t is not None)


def count_flops(n: float) -> None:
    """Hand a meta rule's operations to every open dry-run trace: each
    dispatch mode on this thread's stack that takes them (``add_flops``,
    ``launch.dryrun.Trace``)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "add_flops"):
            mode.add_flops(float(n))


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a causal / windowed mask lets through, query row
    i at key position ``sk - sq + i`` (end-aligned), summed row by row in
    closed form."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


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
