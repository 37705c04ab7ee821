"""Flash-attention backward entry point: the CUDA kernel on the card, the
plain version on the CPU.

The kernel (``kernels/csrc/flash_attention_bwd.cu``) computes dQ, dK and
dV of the flash-attention forward kernel's function from q, k, v, the
forward output and its rows' log-sum-exp, at the (q/k width, v width)
pairs of :data:`HEAD_DIMS` (those of the forward kernel: (96, 64) is MLA's
cacheless branch, MiniCPM3's training), in f32 or bf16; it replaces no
Pallas kernel (the reference differentiates its jnp attention).  Three
CUDA launches a call: D = rowsum(dO o O), then dK and dV (a block per
64-key tile, the GQA group's heads summed in a fixed order), then dQ (a
block per 64-query tile); no atomics, so two calls give the same bits.

Bound: five products a visible (query, key) pair, 2 (3 dqk + 2 dv) FLOP
(10 dh at dqk = dv = dh); the operations bound it (0.174 ms at Qwen's
8 x 2048, H 16, dh 64 on the tensor cores; 0.565 ms at MiniCPM3's
8 x 2048, H 40, (96, 64)).  The split recomputes S and dP for dQ: 7
products (a 0.243-ms floor at Qwen's shape) and two exponentials a pair
(0.128 ms on the special-function units).  bf16 runs ``wgmma`` on
TMA-fed tiles, one consumer warpgroup and a producer warp a block, P and
dS rounded to bf16 in registers before their products: the only
roundings beyond :func:`attention_bwd_ref`'s, which
``attention_bwd_tiles`` models.  f32 stays on the CUDA cores: TF32 would
not hold the f32 checks.  TMA and
the D pass's 16-byte loads need 16-byte aligned bases: :func:`tma_ready`
copies a bf16 input that is not (never to the plain version).

:class:`repro_torch.kernels.flash_attention.ops.FlashAttention` calls
:func:`attention_bwd` from its ``backward``.  ``launches`` counts the
calls that ran the kernel; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, count_flops, on_meta, visible_pairs
from ..flash_attention.ref import attention_bwd_ref

__all__ = ["HEAD_DIMS", "attention_bwd", "attention_bwd_kernel", "launches",
           "reset_launches", "tma_ready"]

HEAD_DIMS = ((64, 64), (128, 128), (96, 64))   # (dqk, dv), the forward's

launches = 0

_FNS = {torch.float32: "flash_attention_bwd_f32",
        torch.bfloat16: "flash_attention_bwd_bf16"}
_TMAP_ERROR = 100000    # + CUresult: a tensor map the library could not encode


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache     # the library's entry point, typed once
def _entry(dtype: torch.dtype):
    lib = _build.load("flash_attention_bwd")
    fn = getattr(lib, _FNS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 kernels' 16-byte loads (TMA tiles of q, k, v, dO;
    the D pass's vector loads of O and dO) take it: contiguous, its base on
    a 16-byte boundary (the rows of a contiguous (B, S, heads, width)
    tensor of width 64, 96 or 128 are then too).  Anything else is copied
    into a fresh allocation, which the allocator aligns."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor, causal: bool = True,
                         window: int = 0) -> tuple:
    """Launch the CUDA kernel.  q (B, Sq, H, dqk), o, do (B, Sq, H, dv), k
    (B, Sk, KV, dqk) and v (B, Sk, KV, dv) CUDA tensors of one type (f32 or
    bf16), (dqk, dv) in :data:`HEAD_DIMS`; ``lse`` the forward's (B, H, Sq)
    f32 log-sum-exp.
    Non-contiguous inputs are copied, and so in bf16 is any input whose
    base is off a 16-byte boundary (:func:`tma_ready`).
    Returns new contiguous (dq, dk, dv) in the inputs' type."""
    global launches
    ts = (q, k, v, o, do)
    meta = on_meta(*ts, lse)
    if not (meta or all(t.device.type == "cuda" for t in ts + (lse,))):
        raise ValueError("attention_bwd_kernel needs CUDA tensors")
    if q.dtype not in _FNS or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"attention_bwd_kernel takes float32 or bfloat16 "
                        f"q, k, v, o, do of one type (got "
                        f"{[t.dtype for t in ts]})")
    if any(t.dim() != 4 for t in ts) or k.shape[:3] != v.shape[:3] \
            or o.shape != q.shape[:3] + v.shape[3:] or do.shape != o.shape:
        raise ValueError(f"attention_bwd_kernel takes q (B, Sq, H, dqk), o, "
                         f"do (B, Sq, H, dv), k (B, Sk, KV, dqk) and v (B, "
                         f"Sk, KV, dv) (got {[tuple(t.shape) for t in ts]})")
    b, sq, h, dqk = q.shape
    sk, kvh, dvw = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != dqk or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if (dqk, dvw) not in HEAD_DIMS:
        raise ValueError(f"attention_bwd_kernel takes head dims (dqk, dv) in "
                         f"{HEAD_DIMS} (got {(dqk, dvw)})")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be f32 (B, H, Sq) = {(b, h, sq)} (got "
                         f"{lse.dtype} {tuple(lse.shape)})")
    prep = tma_ready if q.dtype == torch.bfloat16 else torch.Tensor.contiguous
    q, k, v, o, do, lse = (prep(t) for t in (q, k, v, o, do, lse))
    if meta:    # the dry-run's rule: 5 products a visible pair
        count_flops(2.0 * b * h * (3 * dqk + 2 * dvw)
                    * visible_pairs(sq, sk, causal, window))
    else:
        fn, err_str = _entry(q.dtype)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if meta:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, sq, sk, h, kvh, dqk, dvw, int(causal), int(window),
                 dqk ** -0.5, stream)
    if err >= _TMAP_ERROR:
        raise RuntimeError(f"flash_attention_bwd: cuTensorMapEncodeTiled "
                           f"failed (CUresult {err - _TMAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches += 1
    return dq, dk, dv


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool = True, window: int = 0) -> tuple:
    """(dq, dk, dv) of causal/windowed GQA attention, end-aligned query
    positions.  CPU tensors take the plain version
    (:func:`attention_bwd_ref`); CUDA tensors launch the kernel, or raise
    if it does not take them."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    return attention_bwd_kernel(q, k, v, o, lse, do, causal, window)
