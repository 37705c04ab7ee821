from .ops import sinkhorn, sinkhorn_kernel
from .ref import sinkhorn_ref

__all__ = ["sinkhorn", "sinkhorn_kernel", "sinkhorn_ref"]
