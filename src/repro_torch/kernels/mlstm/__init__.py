from .ops import mlstm, mlstm_kernel
from .ref import mlstm_chunkwise_ref

__all__ = ["mlstm", "mlstm_kernel", "mlstm_chunkwise_ref"]
