"""Flash-decode entry point: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attn``.  The
kernel (``kernels/csrc/decode_attention.cu``) replaces the Pallas TPU
kernel ``decode_attention``
(``repro/kernels/decode_attention/decode_attention.py``) and is
instantiated for f32 and bf16 at head dims 64 and 128, with an optional
sliding window (``window``: keys at ``length - window < pos <= length``,
the reference model's decode mask).  One call issues two
CUDA launches (the split partials, then their combine) and adds one to
``launches``; nothing else adds to it.  The number of splits of each lane's
visible keys is :func:`split_plan`'s; the kernel divides the keys by the
lengths on the card.  The split scratch is allocated once per shape,
device and stream and reused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...parallel import spmd
from .. import H100_SMS, _build, count_flops, no_backward, on_meta
from .ref import decode_attention_ref

__all__ = ["HEAD_DIMS", "MAX_REP", "TILE", "check_aligned", "check_q",
           "decode_attn", "decode_kernel", "launches", "reset_launches",
           "sm_count", "split_plan", "visible_keys"]

HEAD_DIMS = (64, 128)
MAX_REP = 32        # query heads per kv head (kernel's register plan)
TILE = 32           # f32 cache rows per staged tile (bf16: 64)

launches = 0

_FNS = {torch.float32: "decode_attention_f32",
        torch.bfloat16: "decode_attention_bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache     # the library's entry point, typed once
def _entry(dtype: torch.dtype):
    lib = _build.load("decode_attention")
    fn = getattr(lib, _FNS[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def split_plan(batch: int, kvh: int, s: int, sms: int,
               window: int = 0) -> int:
    """Splits of each lane's visible keys (one block each per lane and kv
    head): enough that the ``batch * kvh * nsplit`` blocks fill ``sms`` SMs
    about twice, and no more than a lane's visible keys have tiles: those
    of ``S``, or of ``window`` where that is shorter."""
    want = -(-2 * sms // max(1, batch * kvh))
    seen = min(s, window) if window else s
    return max(1, min(want, -(-seen // TILE)))


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SMs of ``device``, the split plan's ``sms``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_SCRATCH: dict = {}


def _scratch(b: int, h: int, nsplit: int, dh: int, device,
             stream: int) -> tuple:
    """The split partials' (m, l) and accumulators, one pair per shape,
    device and stream, reused by every call on that stream (calls on one
    stream run in order, so none overwrites another's partials before its
    combine has read them)."""
    key = (device, stream, b, h, nsplit, dh)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = _SCRATCH[key] = (
            torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=device),
            torch.empty((b, h, nsplit, dh), dtype=torch.float32,
                        device=device))
    return bufs


def check_aligned(name: str, t: torch.Tensor) -> None:
    """``ValueError`` unless the cache ``t`` (B, S, KV, dh) starts on a
    16-byte boundary and its batch and sequence strides are multiples of 16
    bytes: the kernel copies its rows 16 bytes at a time."""
    size = t.element_size()
    if t.data_ptr() % 16 or any((st * size) % 16 for st in t.stride()[:2]):
        raise ValueError(f"{name} must start on a 16-byte boundary and have "
                         f"batch and sequence strides that are multiples of "
                         f"16 bytes for the kernel's 16-byte copies (got "
                         f"address {t.data_ptr():#x}, strides "
                         f"{tuple(t.stride())})")


def check_q(q: torch.Tensor) -> None:
    """``ValueError`` unless a bf16 ``q`` (B, 1, H, dh) starts on a 4-byte
    boundary and has an even batch stride: the kernel reads bf16 q two
    elements at a time.  f32 q is read one element at a time."""
    if q.dtype == torch.bfloat16 and (q.data_ptr() % 4 or q.stride(0) % 2):
        raise ValueError(f"a bfloat16 q must start on a 4-byte boundary and "
                         f"have an even batch stride for the kernel's 4-byte "
                         f"reads (got address {q.data_ptr():#x}, strides "
                         f"{tuple(q.stride())})")


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


def visible_keys(length, b: int, s: int, window: int = 0) -> int:
    """Keys the lanes see in all at an int ``length`` (positions ``<=
    length``, above ``length - window``, within ``[0, S)``); at a tensor
    ``length``, whose values a meta rule cannot read, every key a window
    lets through: S, or ``window`` where that is shorter."""
    if not isinstance(length, int):
        return b * (min(s, window) if window else s)
    lo = max(0, length - window + 1) if window else 0
    return b * max(0, min(length, s - 1) - lo + 1)


def decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel.  q (B, 1, H, dh) and a cache k/v
    (B, S, KV, dh), CUDA tensors of one type (f32 or bf16), dh in
    :data:`HEAD_DIMS`, H / KV <= :data:`MAX_REP`, heads packed and dh
    contiguous (k and v share their batch and sequence strides, which with
    k's base are 16-byte aligned for the kernel's 16-byte copies); ``length``
    the last visible index, a scalar or one per batch row; ``window`` the
    sliding window (0: none), which hides keys at or below ``length -
    window``.  Returns a new contiguous (B, 1, H, dh) tensor."""
    global launches
    meta = on_meta(q, k, v)
    if not (meta or q.device.type == k.device.type == v.device.type
            == "cuda"):
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
    if not 0 <= window < 2 ** 31:
        raise ValueError(f"window must be 0 (none) or a positive int32 "
                         f"(got {window})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.stride(-2) != dh:
            raise ValueError(f"{name} must have dh contiguous and its heads "
                             f"packed (got strides {tuple(t.stride())})")
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    check_q(q)
    check_aligned("k", k)
    check_aligned("v", v)
    lengths = lengths_vector(length, b, q.device)
    if meta:    # the dry-run's rule: the split scratch, 4 dh a visible key
        nsplit = split_plan(b, kvh, s, H100_SMS, window)
        scratch = (q.new_empty((b, h, nsplit, 2), dtype=torch.float32),
                   q.new_empty((b, h, nsplit, dh), dtype=torch.float32))
        count_flops(4.0 * h * dh * visible_keys(length, b, s, window))
        out = q.new_empty((b, 1, h, dh))
        del scratch
        return out
    fn, err_str = _entry(q.dtype)
    nsplit = split_plan(b, kvh, s, sm_count(q.device), window)
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part_ml, part_acc = _scratch(b, h, nsplit, dh, q.device, stream)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                 b, s, h, kvh, dh, q.stride(0), k.stride(0), k.stride(1),
                 nsplit, window, dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches += 1
    return out


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length, window: int = 0) -> torch.Tensor:
    """One query token against a KV cache, keys at positions <= ``length``
    (a scalar or one per batch row; ``>= S`` sees the whole cache) and,
    with a sliding ``window``, above ``length - window``.  CPU tensors take
    the plain version (:func:`decode_attention_ref`); CUDA tensors launch
    the kernel, or raise if it does not take them or need a gradient (a
    loss has no cache, and its one-query cross-attention takes the flash
    kernel).  DTensors run on each rank's shards, a sequence-sharded cache
    gathered whole first (``parallel.spmd.attention``)."""
    if spmd.is_dtensor(q):
        return spmd.attention(decode_attn, q, k, v, length=length,
                              window=window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length, window)
    no_backward("decode-attention", None, q, k, v)
    return decode_kernel(q, k, v, length, window)
