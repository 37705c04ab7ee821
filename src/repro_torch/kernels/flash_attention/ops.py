"""Flash-attention entry point: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_attention.ops.attention``.  The kernel
(``kernels/csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``flash_attention`` (``repro/kernels/flash_attention/flash_attention.py``)
and is instantiated for f32 and bf16 at head dims 64 and 128.
``launches`` counts the calls that ran the kernel; nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "attention", "attention_kernel", "launches",
           "reset_launches"]

HEAD_DIMS = (64, 128)

launches = 0

_FNS = {torch.float32: "flash_attention_f32",
        torch.bfloat16: "flash_attention_bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


def _entry(dtype: torch.dtype):
    lib = _build.load("flash_attention")
    fn = getattr(lib, _FNS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def _check_heads_packed(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name} must have dh contiguous and its heads "
                         f"packed (got strides {tuple(t.stride())})")


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel.  q (B, Sq, H, dh) and k/v (B, Sk, KV, dh)
    CUDA tensors of one type (f32 or bf16), dh in :data:`HEAD_DIMS`, heads
    packed and dh contiguous (batch and sequence strides are free; k and v
    share theirs).  Returns a new contiguous (B, Sq, H, dh) tensor."""
    global launches
    if not (q.device.type == k.device.type == v.device.type == "cuda"):
        raise ValueError("attention_kernel needs CUDA tensors (got "
                         f"{q.device}, {k.device}, {v.device})")
    if q.dtype not in _FNS or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention_kernel takes float32 or bfloat16 q, k, v "
                        f"of one type (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention_kernel takes q (B, Sq, H, dh) and k, v "
                         f"(B, Sk, KV, dh) (got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)})")
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention_kernel takes head dims {HEAD_DIMS} "
                         f"(got {dh})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_packed(name, t)
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    fn, err_str = _entry(q.dtype)
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kvh, dh, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), int(causal), int(window),
                 dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal/windowed GQA attention, end-aligned query positions.  CPU
    tensors take the plain version (:func:`attention_ref`); CUDA tensors
    launch the kernel, or raise if it does not take them."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return attention_kernel(q, k, v, causal=causal, window=window)
