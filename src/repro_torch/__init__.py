"""PyTorch/CUDA port of the Vermilion reproduction (``repro``).

Laid out like the JAX package — ``core/``, ``kernels/``, ``analysis/`` —
with each module named after its counterpart.  The port imports ``torch``,
``numpy`` and ``scipy`` only: nothing of ``jax`` and nothing of ``repro``
(host code it needs is kept as its own copy).

Entry points that do device work (``kernels.sinkhorn.ops.sinkhorn``,
``core.traffic.saturate``, ``core.schedule.vermilion_schedule(s)`` under
``normalize="saturate"``, ``core.simulator.run_sweep``) take
``device=None``, which means the CUDA card; without a card they raise
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from .device import DATA_DTYPE, resolve_device

__all__ = ["DATA_DTYPE", "resolve_device"]
