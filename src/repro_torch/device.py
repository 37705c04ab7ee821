"""Device and dtype policy of the port.

``device=None`` means the CUDA card.  The CPU runs only when the caller
asks for it by name (``device="cpu"``): a missing card is an error, never
a silent switch to the CPU.  On the CPU every kernel wrapper takes its
plain PyTorch version; on a CUDA tensor it launches its kernel or raises.
``device="meta"``, never a default, is the dry-run's (``launch.dryrun``):
shapes without storage, on which every kernel takes its meta rule.
"""
from __future__ import annotations

import torch

__all__ = ["DATA_DTYPE", "resolve_device"]

# The data plane serves in f32, like the reference kernels; the host flow
# ledgers (numpy) are exact f64, as in the reference.
DATA_DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means ``cuda``.  Raises ``RuntimeError`` if a CUDA device is
    requested and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; entry points of repro_torch run "
            "on the card by default — pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu; "
                         f"meta for the dry-run)")
    return dev
