"""Flash-attention entry point: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_attention.ops.attention``.  The kernel
(``kernels/csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``flash_attention`` (``repro/kernels/flash_attention/flash_attention.py``)
and is instantiated for f32 and bf16 at the (q/k width, v width) pairs of
:data:`HEAD_DIMS`: (64, 64) and (128, 128), and (96, 64) for MLA's
cacheless branch (MiniCPM3's training: a 64-wide nope part and a 32-wide
RoPE part, v 64 wide).  bf16 runs ``wgmma`` on tiles that TMA loads, f32
the CUDA-core kernel.  TMA takes 16-byte aligned base pointers and strides
that are multiples of 16 bytes; :func:`tma_strides` checks them and raises
where they fail.
``launches`` counts the calls that ran the kernel; nothing else adds to it.

Under autograd (grad mode on and q, k or v requiring a gradient)
:func:`attention` goes through :class:`FlashAttention`: its forward is the
same kernel, which then also writes each row's log-sum-exp, and its
backward the kernel of ``csrc/flash_attention_bwd.cu``
(``kernels.flash_attention_bwd``); on CPU tensors the same Function runs
the plain versions (``attention_lse_ref``, ``attention_bwd_ref``).
Serving runs without a gradient, and its launches are unchanged.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...parallel import spmd
from .. import _build, count_flops, on_meta, visible_pairs
from ..flash_attention_bwd import ops as bwd_ops
from .ref import attention_lse_ref, attention_ref

__all__ = ["HEAD_DIMS", "FlashAttention", "attention", "attention_kernel",
           "launches", "reset_launches", "tma_strides"]

# (dqk, dv): q and k dqk wide, v and the output dv wide
HEAD_DIMS = ((64, 64), (128, 128), (96, 64))

launches = 0

_FNS = {torch.float32: "flash_attention_f32",
        torch.bfloat16: "flash_attention_bf16"}
_TMAP_ERROR = 100000    # + CUresult: a tensor map the library could not encode


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache     # the library's entry point, typed once
def _entry(dtype: torch.dtype):
    lib = _build.load("flash_attention")
    fn = getattr(lib, _FNS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def _check_heads_packed(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name} must have dh contiguous and its heads "
                         f"packed (got strides {tuple(t.stride())})")


def tma_strides(name: str, t: torch.Tensor) -> tuple:
    """(batch, sequence) strides in elements of a (B, S, heads, dh) tensor
    that the bf16 kernel's tensor maps take: its base 16-byte aligned and
    every stride a multiple of 16 bytes, else ``ValueError``.  A batch of
    one has no batch stride to honour: it is given the one a contiguous
    tensor would have."""
    size = t.element_size()
    sb, ss = t.stride(0), t.stride(1)
    if t.shape[0] == 1:
        sb = max(t.shape[1], 1) * ss
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the "
                         f"kernel's TMA loads (address {t.data_ptr():#x})")
    for what, st in (("batch", sb), ("sequence", ss)):
        if (st * size) % 16 or st <= 0 or st * size >= 2 ** 40:
            raise ValueError(f"{name}'s {what} stride ({st} elements) must "
                             f"be a positive multiple of 16 bytes for the "
                             f"kernel's TMA loads")
    return sb, ss


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, window: int = 0,
                     with_lse: bool = False):
    """Launch the CUDA kernel.  q (B, Sq, H, dqk), k (B, Sk, KV, dqk) and
    v (B, Sk, KV, dv) CUDA tensors of one type (f32 or bf16), (dqk, dv) in
    :data:`HEAD_DIMS`, heads packed and the last dim contiguous (batch and
    sequence strides are free, each tensor its own, in bf16 as far as
    :func:`tma_strides` allows).  Returns a new contiguous (B, Sq, H, dv)
    tensor; with ``with_lse``, also each row's log-sum-exp of the scaled
    scores, f32 (B, H, Sq)."""
    global launches
    meta = on_meta(q, k, v)
    if not (meta or q.device.type == k.device.type == v.device.type
            == "cuda"):
        raise ValueError("attention_kernel needs CUDA tensors (got "
                         f"{q.device}, {k.device}, {v.device})")
    if q.dtype not in _FNS or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention_kernel takes float32 or bfloat16 q, k, v "
                        f"of one type (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"attention_kernel takes q (B, Sq, H, dqk), k (B, "
                         f"Sk, KV, dqk) and v (B, Sk, KV, dv) (got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    b, sq, h, dqk = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != dqk or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if (dqk, dv) not in HEAD_DIMS:
        raise ValueError(f"attention_kernel takes head dims (dqk, dv) in "
                         f"{HEAD_DIMS} (got {(dqk, dv)})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_packed(name, t)
    if meta:    # the dry-run's rule: Q K^T and P V, 2 (dqk + dv) a pair
        count_flops(2.0 * b * h * (dqk + dv)
                    * visible_pairs(sq, sk, causal, window))
        out = q.new_empty((b, sq, h, dv))
        return (out, q.new_empty((b, h, sq), dtype=torch.float32)) \
            if with_lse else out
    strides = [(t.stride(0), t.stride(1)) for t in (q, k, v)]
    if q.dtype == torch.bfloat16:
        strides = [tma_strides(name, t)
                   for name, t in (("q", q), ("k", k), ("v", v))]
    fn, err_str = _entry(q.dtype)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kvh, dqk, dv, *strides[0], *strides[1],
                 *strides[2], int(causal), int(window), dqk ** -0.5,
                 None if lse is None else lse.data_ptr(), stream)
    if err >= _TMAP_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _TMAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches += 1
    if lse is None:
        return out
    if sk == 0 and lse.numel():      # no key: the kernel wrote no row
        lse.fill_(float("-inf"))
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel with its log-sum-exp,
    the backward kernel (``kernels.flash_attention_bwd``); their plain
    versions on CPU tensors.  ``apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, causal, window)
        else:
            out, lse = attention_kernel(q, k, v, causal, window,
                                        with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd_ops.attention_bwd(q, k, v, out, lse, do,
                                           ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal/windowed GQA attention, end-aligned query positions.  CPU
    tensors take the plain version (:func:`attention_ref`); CUDA tensors
    launch the kernel, or raise if it does not take them.  Where a gradient
    is wanted the call goes through :class:`FlashAttention`.  DTensors run
    on each rank's shards (``parallel.spmd.attention``)."""
    if spmd.is_dtensor(q):
        return spmd.attention(attention, q, k, v, causal=causal,
                              window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return attention_kernel(q, k, v, causal=causal, window=window)
