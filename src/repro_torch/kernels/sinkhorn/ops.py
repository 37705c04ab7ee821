"""Sinkhorn entry point: the CUDA kernel on the card, the plain version on
the CPU.

Counterpart of ``repro.kernels.sinkhorn.ops.sinkhorn``.  The kernel
(``kernels/csrc/sinkhorn.cu``) replaces the Pallas TPU kernel
``sinkhorn_pallas`` (``repro/kernels/sinkhorn/sinkhorn.py``) and is
instantiated for f32 and f64.  ``launches`` counts the calls that ran the
kernel (one call issues ``2 * iters`` CUDA launches); nothing else adds
to it.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import resolve_device
from .. import _build
from .ref import sinkhorn_ref

__all__ = ["sinkhorn", "sinkhorn_kernel", "launches", "reset_launches"]

launches = 0

_FNS = {torch.float32: ("sinkhorn_f32", ctypes.c_float),
        torch.float64: ("sinkhorn_f64", ctypes.c_double)}


def reset_launches() -> None:
    global launches
    launches = 0


def _entry(dtype: torch.dtype):
    name, c_eps = _FNS[dtype]
    lib = _build.load("sinkhorn")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, c_eps, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def sinkhorn_kernel(m: torch.Tensor, iters: int = 20,
                    eps: float = 1e-12) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous 2-D square f32/f64 CUDA
    tensor; returns a new tensor (the input is left as it was)."""
    global launches
    if m.device.type != "cuda":
        raise ValueError(f"sinkhorn_kernel needs a CUDA tensor (got {m.device})")
    if m.dtype not in _FNS:
        raise TypeError(f"sinkhorn_kernel takes float32 or float64 "
                        f"(got {m.dtype})")
    if m.dim() != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"sinkhorn_kernel takes a square matrix "
                         f"(got shape {tuple(m.shape)})")
    if not m.is_contiguous():
        raise ValueError("sinkhorn_kernel takes a contiguous tensor")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    fn, err_str = _entry(m.dtype)
    out = torch.empty_like(m)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = fn(m.data_ptr(), out.data_ptr(), m.shape[0], iters, eps,
                 stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return out


def sinkhorn(m, iters: int = 20, eps: float = 1e-12,
             device=None) -> torch.Tensor:
    """Sinkhorn projection of the square matrix ``m`` on ``device``
    (``None``: the card).  A CUDA tensor runs the kernel, a CPU tensor the
    plain version (:func:`sinkhorn_ref`).  f32 and f64 compute in their
    own type; any other float type is cast to f32 first."""
    dev = resolve_device(device)
    m = torch.as_tensor(m, device=dev)
    if m.dtype not in _FNS:
        m = m.to(torch.float32)
    if dev.type == "cpu":
        return sinkhorn_ref(m, iters=iters, eps=eps)
    return sinkhorn_kernel(m.contiguous(), iters=iters, eps=eps)
