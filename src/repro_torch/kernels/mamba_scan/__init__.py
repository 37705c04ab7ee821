from .ops import selective_scan, selective_scan_kernel
from .ref import mamba_scan_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_kernel", "mamba_scan_ref",
           "selective_scan_ref"]
