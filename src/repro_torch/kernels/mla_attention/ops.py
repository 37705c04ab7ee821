"""MLA latent attention entry points: the CUDA kernels on the card, the
plain versions on the CPU.

The kernels (``kernels/csrc/mla_attention.cu``) replace no Pallas kernel:
they compute the attention that the reference model's ``mla_attention``
computes in jnp over the latent cache (``repro/models/layers.py``, the
``kv_cache`` branch), which serves every MLA prefill and decode step.  They
are instantiated for f32 (the CUDA cores) and bf16 (``wgmma`` on key tiles
that TMA loads) at the latent width :data:`LATENT` (256) and the rope width
:data:`ROPE` (32); other widths raise.  The softmax scale is an argument.
:func:`mla_prefill` is one CUDA launch a call; :func:`mla_decode` two (the
split partials, then their combine), its splits by :func:`split_plan`, its
scratch allocated once per shape, device and stream.  Each entry point
counts its kernel's calls in its own counter (:data:`PREFILL`,
:data:`DECODE`); nothing else adds to them.  Every base address and stride
must be 16-byte aligned (the kernels copy 16 bytes at a time); in bf16,
where every operand reaches the kernel through a TMA map, no stride may
be 0 and H must divide 8 or be a multiple of 8.  :func:`strides` and
:func:`tma_strides` raise where a stride does not fit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...parallel import spmd
from .. import H100_SMS, _build, count_flops, no_backward, on_meta, \
    visible_pairs
from ..decode_attention import ops as decode_ops
from .ref import mla_decode_ref, mla_prefill_ref

__all__ = ["DECODE", "LATENT", "PREFILL", "ROPE", "ROWS", "TILE",
           "Launches", "mla_decode", "mla_decode_kernel", "mla_prefill",
           "mla_prefill_kernel", "reset_launches", "split_plan", "strides",
           "tma_strides"]

LATENT, ROPE = 256, 32      # the widths the kernels take
ROWS = 64                   # a decode block's query rows (a lane's heads)
TILE = 64                   # keys a bf16 tile; the f32 kernel's are 32
_TMAP_ERROR = 100000        # + CUresult: a tensor map the library could not encode


class Launches:
    """One entry point's count of kernel calls."""

    def __init__(self) -> None:
        self.launches = 0

    def reset_launches(self) -> None:
        self.launches = 0


PREFILL, DECODE = Launches(), Launches()

_FNS = {("prefill", torch.float32): "mla_prefill_f32",
        ("prefill", torch.bfloat16): "mla_prefill_bf16",
        ("decode", torch.float32): "mla_decode_f32",
        ("decode", torch.bfloat16): "mla_decode_bf16"}


def reset_launches() -> None:
    PREFILL.reset_launches()
    DECODE.reset_launches()


@functools.cache     # the library's entry point, typed once
def _entry(kind: str, dtype: torch.dtype):
    lib = _build.load("mla_attention")
    fn = getattr(lib, _FNS[kind, dtype])
    ptrs = 5 if kind == "prefill" else 8
    fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def split_plan(batch: int, h: int, s: int, sms: int) -> int:
    """Splits of each decode lane's keys: as many as let the blocks (one
    per lane, split and 64 heads; two fit an SM) fill ``sms`` SMs in one
    wave, at least one, and no more than a cache of ``s`` keys has 64-key
    tiles."""
    blocks = batch * -(-h // ROWS)
    return max(1, min(2 * sms // max(1, blocks), -(-s // TILE)))


def strides(name: str, t: torch.Tensor) -> list:
    """Element strides of every dimension of ``t`` but the last, which must
    be contiguous; ``ValueError`` unless the base and each stride are
    16-byte aligned.  A dimension of size 1 is never stepped: its stride is
    given as 0."""
    size = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have its last dimension contiguous "
                         f"(got strides {tuple(t.stride())})")
    out = [0 if n == 1 else st for n, st in zip(t.shape[:-1],
                                                t.stride()[:-1])]
    if t.data_ptr() % 16 or any((st * size) % 16 for st in out):
        raise ValueError(f"{name} must start on a 16-byte boundary and have "
                         f"strides that are multiples of 16 bytes for the "
                         f"kernel's 16-byte copies (got address "
                         f"{t.data_ptr():#x}, strides {tuple(t.stride())})")
    return out


def tma_strides(name: str, t: torch.Tensor) -> list:
    """Element strides of every dimension of ``t`` but the last, for a TMA
    map of its rows (every bf16 operand): the base 16-byte aligned and every
    stride a positive multiple of 16 bytes below 2^40, else ``ValueError``.
    A dimension of size 1 is never stepped: it is given the stride a
    contiguous tensor would have."""
    size = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have its last dimension contiguous "
                         f"(got strides {tuple(t.stride())})")
    out, step = [], t.shape[-1]
    for n, st in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        st = step if n == 1 else st
        out.insert(0, st)
        step = max(n, 1) * st
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the "
                         f"kernel's TMA loads (address {t.data_ptr():#x})")
    for st in out:
        if st <= 0 or (st * size) % 16 or st * size >= 2 ** 40:
            raise ValueError(f"{name}'s strides must be positive multiples "
                             f"of 16 bytes for the kernel's TMA loads (got "
                             f"{tuple(t.stride())})")
    return out


def _check(q_lat, q_rope, c, k_rope, scale) -> list:
    """The kernels' shared checks; returns the ten strides of the C
    interface."""
    ts = (q_lat, q_rope, c, k_rope)
    if not (on_meta(*ts) or all(t.device.type == "cuda" for t in ts)):
        raise ValueError("the MLA kernels need CUDA tensors (got "
                         f"{', '.join(str(t.device) for t in ts)})")
    if q_lat.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q_lat.dtype for t in ts):
        raise TypeError(f"the MLA kernels take float32 or bfloat16 q_lat, "
                        f"q_rope, c, k_rope of one type (got "
                        f"{', '.join(str(t.dtype) for t in ts)})")
    if q_lat.dim() != 4 or q_rope.dim() != 4 or c.dim() != 3 or \
            k_rope.dim() != 3:
        raise ValueError(f"the MLA kernels take q_lat (B, Sq, H, R), q_rope "
                         f"(B, Sq, H, Dr), c (B, Sk, R), k_rope (B, Sk, Dr) "
                         f"(got {[tuple(t.shape) for t in ts]})")
    b, sq, h, r = q_lat.shape
    if (q_rope.shape[:3] != q_lat.shape[:3] or c.shape[0] != b
            or k_rope.shape[:2] != c.shape[:2] or c.shape[2] != r):
        raise ValueError(f"the MLA operands do not fit together: "
                         f"{[tuple(t.shape) for t in ts]}")
    if r != LATENT or q_rope.shape[3] != ROPE or k_rope.shape[2] != ROPE:
        raise ValueError(f"the MLA kernels take latent width {LATENT} and "
                         f"rope width {ROPE} (got {r} and "
                         f"{q_rope.shape[3]}, {k_rope.shape[2]})")
    if not 0.0 < scale < float("inf"):
        raise ValueError(f"the softmax scale must be positive (got {scale})")
    if q_lat.dtype == torch.float32:
        return (strides("q_lat", q_lat) + strides("q_rope", q_rope)
                + strides("c", c) + strides("k_rope", k_rope))
    if h % 8 and 8 % h:
        raise ValueError(f"the bf16 MLA kernels load q in boxes of 8 "
                         f"(position, head) rows: H must divide 8 or be a "
                         f"multiple of 8 (got {h})")
    return (tma_strides("q_lat", q_lat) + tma_strides("q_rope", q_rope)
            + tma_strides("c", c) + tma_strides("k_rope", k_rope))


def _raise_on(err: int, err_str, what: str) -> None:
    if err >= _TMAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _TMAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def mla_prefill_kernel(q_lat: torch.Tensor, q_rope: torch.Tensor,
                       c: torch.Tensor, k_rope: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Launch the prefill kernel: causal, query row i at ``Sk - Sq + i``.
    CUDA tensors of one type (f32 or bf16) at the widths :data:`LATENT` and
    :data:`ROPE`, ``Sq <= Sk``.  Returns a new contiguous (B, Sq, H, R)
    tensor."""
    st = _check(q_lat, q_rope, c, k_rope, scale)
    b, sq, h, r = q_lat.shape
    sk = c.shape[1]
    if sq > sk:
        raise ValueError(f"a prefill of {sq} queries needs at least as many "
                         f"keys (got {sk})")
    if on_meta(q_lat):  # the dry-run's rule: 2 (2 R + Dr) a visible pair
        count_flops(2.0 * b * h * (2 * r + ROPE)
                    * visible_pairs(sq, sk, True, 0))
        return q_lat.new_empty((b, sq, h, r))
    fn, err_str = _entry("prefill", q_lat.dtype)
    out = torch.empty((b, sq, h, r), dtype=q_lat.dtype, device=q_lat.device)
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream(q_lat.device).cuda_stream
        err = fn(q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(),
                 k_rope.data_ptr(), out.data_ptr(), b, sq, sk, h, r, ROPE,
                 (ctypes.c_longlong * 10)(*st), scale, stream)
    _raise_on(err, err_str, "mla_prefill")
    PREFILL.launches += 1
    return out


_SCRATCH: dict = {}


def _scratch(b: int, h: int, nsplit: int, device, stream: int) -> tuple:
    """The split partials' (m, l) and accumulators, one pair per shape,
    device and stream, reused by every call on that stream (calls on one
    stream run in order)."""
    key = (device, stream, b, h, nsplit)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = _SCRATCH[key] = (
            torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=device),
            torch.empty((b, h, nsplit, LATENT), dtype=torch.float32,
                        device=device))
    return bufs


def mla_decode_kernel(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c: torch.Tensor, k_rope: torch.Tensor, length,
                      scale: float) -> torch.Tensor:
    """Launch the decode kernels: one query a lane (Sq = 1) at ``length``
    (a scalar or one per lane, read on the card), seeing the keys ``[0,
    min(length, S - 1)]``.  Returns a new contiguous (B, 1, H, R)
    tensor."""
    st = _check(q_lat, q_rope, c, k_rope, scale)
    b, sq, h, r = q_lat.shape
    s = c.shape[1]
    if sq != 1:
        raise ValueError(f"mla_decode takes one query a lane (got {sq})")
    lengths = decode_ops.lengths_vector(length, b, q_lat.device)
    if on_meta(q_lat):  # the dry-run's rule: the split scratch, 2 (2 R + Dr)
        nsplit = split_plan(b, h, s, H100_SMS)      # a visible key
        scratch = (q_lat.new_empty((b, h, nsplit, 2), dtype=torch.float32),
                   q_lat.new_empty((b, h, nsplit, LATENT),
                                   dtype=torch.float32))
        count_flops(2.0 * h * (2 * r + ROPE)
                    * decode_ops.visible_keys(length, b, s))
        out = q_lat.new_empty((b, 1, h, r))
        del scratch
        return out
    fn, err_str = _entry("decode", q_lat.dtype)
    nsplit = split_plan(b, h, s, decode_ops.sm_count(q_lat.device))
    out = torch.empty((b, 1, h, r), dtype=q_lat.dtype, device=q_lat.device)
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream(q_lat.device).cuda_stream
        part_ml, part_acc = _scratch(b, h, nsplit, q_lat.device, stream)
        err = fn(q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(),
                 k_rope.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(), b, s, h, r, ROPE,
                 nsplit, (ctypes.c_longlong * 10)(*st), scale, stream)
    _raise_on(err, err_str, "mla_decode")
    DECODE.launches += 1
    return out


# what trains where the latent-cache kernels serve only
_TRAINS_INSTEAD = ("MLA through its cacheless branch (models.layers."
                   "mla_attention without a cache: the flash-attention "
                   "forward and backward kernels)")


def mla_prefill(q_lat: torch.Tensor, q_rope: torch.Tensor, c: torch.Tensor,
                k_rope: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal latent attention, end-aligned query positions.  CPU tensors
    take the plain version (:func:`mla_prefill_ref`); CUDA tensors launch
    the kernel, or raise if it does not take them.  DTensors run on each
    rank's shards (``parallel.spmd.latent_attention``)."""
    if spmd.is_dtensor(q_lat):
        return spmd.latent_attention(mla_prefill, q_lat, q_rope, c, k_rope,
                                     scale)
    if q_lat.device.type == "cpu":
        return mla_prefill_ref(q_lat, q_rope, c, k_rope, scale)
    no_backward("MLA prefill", None, q_lat, q_rope, c, k_rope,
                instead=_TRAINS_INSTEAD)
    return mla_prefill_kernel(q_lat, q_rope, c, k_rope, scale)


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor, c: torch.Tensor,
               k_rope: torch.Tensor, length, scale: float) -> torch.Tensor:
    """One query a lane against the latent cache up to ``length``.  CPU
    tensors take the plain version (:func:`mla_decode_ref`); CUDA tensors
    launch the kernels, or raise if they do not take them.  DTensors run on
    each rank's shards, a sequence-sharded cache gathered whole first
    (``parallel.spmd.latent_attention``)."""
    if spmd.is_dtensor(q_lat):
        return spmd.latent_attention(mla_decode, q_lat, q_rope, c, k_rope,
                                     length, scale)
    if q_lat.device.type == "cpu":
        return mla_decode_ref(q_lat, q_rope, c, k_rope, length, scale)
    no_backward("MLA decode", None, q_lat, q_rope, c, k_rope,
                instead=_TRAINS_INSTEAD)
    return mla_decode_kernel(q_lat, q_rope, c, k_rope, length, scale)
