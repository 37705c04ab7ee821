from .ops import mlstm_bwd, mlstm_bwd_kernel

__all__ = ["mlstm_bwd", "mlstm_bwd_kernel"]
