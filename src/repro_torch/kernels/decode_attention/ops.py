"""Flash-decode entry point: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attn``.  The
kernel (``kernels/csrc/decode_attention.cu``) replaces the Pallas TPU
kernel ``decode_attention``
(``repro/kernels/decode_attention/decode_attention.py``) and is
instantiated for f32 and bf16 at head dims 64 and 128.  One call issues two
CUDA launches (the split partials, then their combine) and adds one to
``launches``; nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decode_attention_ref

__all__ = ["HEAD_DIMS", "MAX_REP", "SPLIT", "decode_attn", "decode_kernel",
           "launches", "reset_launches"]

HEAD_DIMS = (64, 128)
MAX_REP = 32        # query heads per kv head (kernel's shared-memory plan)
SPLIT = 256         # cache rows per block of the first launch

launches = 0

_FNS = {torch.float32: "decode_attention_f32",
        torch.bfloat16: "decode_attention_bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


def _entry(dtype: torch.dtype):
    lib = _build.load("decode_attention")
    fn = getattr(lib, _FNS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def lengths_vector(length, batch: int, device) -> torch.Tensor:
    """``length`` (int, 0-d or (B,) tensor) as a contiguous (B,) int32
    tensor on ``device``, without a host synchronisation."""
    ln = torch.as_tensor(length, device=device).to(torch.int32)
    if ln.dim() == 0:
        ln = ln.expand(batch)
    if ln.shape != (batch,):
        raise ValueError(f"length must be a scalar or have shape ({batch},) "
                         f"(got {tuple(ln.shape)})")
    return ln.contiguous()


def decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length) -> torch.Tensor:
    """Launch the CUDA kernel.  q (B, 1, H, dh) and a cache k/v
    (B, S, KV, dh), CUDA tensors of one type (f32 or bf16), dh in
    :data:`HEAD_DIMS`, H / KV <= :data:`MAX_REP`, heads packed and dh
    contiguous (k and v share their batch and sequence strides); ``length``
    the last visible index, a scalar or one per batch row.  Returns a new
    contiguous (B, 1, H, dh) tensor."""
    global launches
    if not (q.device.type == k.device.type == v.device.type == "cuda"):
        raise ValueError("decode_kernel needs CUDA tensors (got "
                         f"{q.device}, {k.device}, {v.device})")
    if q.dtype not in _FNS or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_kernel takes float32 or bfloat16 q, k, v of "
                        f"one type (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_kernel takes q (B, 1, H, dh) and k, v "
                         f"(B, S, KV, dh) (got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)})")
    b, _, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_kernel takes head dims {HEAD_DIMS} "
                         f"(got {dh})")
    if h // kvh > MAX_REP:
        raise ValueError(f"decode_kernel takes at most {MAX_REP} query heads "
                         f"per kv head (got {h // kvh})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.stride(-2) != dh:
            raise ValueError(f"{name} must have dh contiguous and its heads "
                             f"packed (got strides {tuple(t.stride())})")
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    lengths = lengths_vector(length, b, q.device)
    fn, err_str = _entry(q.dtype)
    nsplit = -(-s // SPLIT)
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    part_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, h, nsplit, dh), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                 b, s, h, kvh, dh, q.stride(0), k.stride(0), k.stride(1),
                 SPLIT, dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches += 1
    return out


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length) -> torch.Tensor:
    """One query token against a KV cache, keys at positions <= ``length``
    (a scalar or one per batch row; ``>= S`` sees the whole cache).  CPU
    tensors take the plain version (:func:`decode_attention_ref`); CUDA
    tensors launch the kernel, or raise if it does not take them."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length)
    return decode_kernel(q, k, v, length)
