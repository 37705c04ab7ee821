"""Sinkhorn entry point: the CUDA kernel on the card, the plain version on
the CPU.

Counterpart of ``repro.kernels.sinkhorn.ops.sinkhorn``.  The kernel
(``kernels/csrc/sinkhorn.cu``) replaces the Pallas TPU kernel
``sinkhorn_pallas`` (``repro/kernels/sinkhorn/sinkhorn.py``) and is
instantiated for f32 and f64.  A matrix that one thread-block cluster
holds (:func:`variant` ``"cluster"``: f64 up to n = 512, f32 up to 736 on
a card that schedules clusters of 16 blocks, :func:`max_cluster_n`) is one
CUDA launch a call, for all ``iters`` rounds; a larger one takes two
launches a round (``"two_pass"``).  The path depends on n, the type and
the card's cluster size (:func:`cluster_size`) alone.  ``launches`` counts
the calls that ran the kernel; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...device import resolve_device
from .. import _build
from .ref import sinkhorn_ref

__all__ = ["sinkhorn", "sinkhorn_kernel", "launches", "reset_launches",
           "plan", "variant", "cluster_size", "max_cluster_n"]

launches = 0

_FNS = {torch.float32: ("sinkhorn_f32", ctypes.c_float),
        torch.float64: ("sinkhorn_f64", ctypes.c_double)}


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' signatures set."""
    lib = _build.load("sinkhorn")
    for dtype, (name, c_eps) in _FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, c_eps, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    p_int = ctypes.POINTER(ctypes.c_int)
    lib.sinkhorn_plan.argtypes = [ctypes.c_int, ctypes.c_int, p_int, p_int,
                                  p_int]
    lib.sinkhorn_plan.restype = ctypes.c_int
    lib.sinkhorn_cluster_max_n.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sinkhorn_cluster_max_n.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(what: str, err: int) -> None:
    raise RuntimeError(f"{what} failed: CUDA error {err} "
                       f"({_lib().cuda_error_string(err).decode()})")


def _dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in _FNS:
        raise TypeError(f"sinkhorn_kernel takes float32 or float64 "
                        f"(got {dtype})")
    return dtype


def plan(n: int, dtype: torch.dtype) -> tuple[str, int, int]:
    """``(variant, cluster, threads)`` of a call on an (n, n) ``dtype``
    matrix on the current card: ``"cluster"`` (one launch) or
    ``"two_pass"`` (two a round), the card's cluster size (16 where it
    schedules clusters of 16 blocks, else 8; chosen at first use) and the
    cluster path's threads a block (0 for two passes)."""
    elem = torch.finfo(_dtype(dtype)).bits // 8
    out = [ctypes.c_int() for _ in range(3)]
    err = _lib().sinkhorn_plan(n, elem, *(ctypes.byref(x) for x in out))
    if err != 0:
        _raise("sinkhorn plan", err)
    var, cluster, threads = (x.value for x in out)
    return ("cluster" if var else "two_pass"), cluster, threads


def variant(n: int, dtype: torch.dtype) -> str:
    """``"cluster"`` or ``"two_pass"``: the path an (n, n) call takes."""
    return plan(n, dtype)[0]


def cluster_size() -> int:
    """The current card's cluster size C (16 or 8)."""
    return plan(1, torch.float64)[1]


def max_cluster_n(dtype: torch.dtype) -> int:
    """The largest n the cluster path takes on the current card."""
    elem = torch.finfo(_dtype(dtype)).bits // 8
    return _lib().sinkhorn_cluster_max_n(elem, cluster_size())


def sinkhorn_kernel(m: torch.Tensor, iters: int = 20,
                    eps: float = 1e-12) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous 2-D square f32/f64 CUDA
    tensor; returns a new tensor (the input is left as it was)."""
    global launches
    if m.device.type != "cuda":
        raise ValueError(f"sinkhorn_kernel needs a CUDA tensor (got {m.device})")
    _dtype(m.dtype)
    if m.dim() != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"sinkhorn_kernel takes a square matrix "
                         f"(got shape {tuple(m.shape)})")
    if not m.is_contiguous():
        raise ValueError("sinkhorn_kernel takes a contiguous tensor")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    fn = getattr(_lib(), _FNS[m.dtype][0])
    out = torch.empty_like(m)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = fn(m.data_ptr(), out.data_ptr(), m.shape[0], iters, eps,
                 stream)
    if err != 0:
        _raise("sinkhorn kernel launch", err)
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
