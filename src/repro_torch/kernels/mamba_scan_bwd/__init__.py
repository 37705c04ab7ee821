from .ops import selective_scan_bwd, selective_scan_bwd_kernel

__all__ = ["selective_scan_bwd", "selective_scan_bwd_kernel"]
