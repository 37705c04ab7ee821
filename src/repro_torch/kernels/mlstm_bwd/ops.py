"""Chunkwise mLSTM backward entry point: the CUDA kernel on the card, the
plain version on the CPU.

The kernel (``kernels/csrc/mlstm_bwd.cu``) computes dq, dk, dv, dlogi and
dlogf of the forward kernel's output from a zero state in, the final state
unused (:func:`~repro_torch.kernels.mlstm.ref.mlstm_chunkwise_bwd_ref`), in
f32, every dh^2 product on the tensor cores as three TF32 passes, at the
forward's head dims (:data:`HEAD_DIMS`); it replaces no Pallas kernel (the
reference differentiates its jnp ``mlstm_chunkwise``).  A call makes seven
CUDA launches (the forward's gates, each chunk's share of n, the scores
and per-position scalars, the forward and reverse walks of the states in
one launch, dv, the gates' gradients) on a workspace allocated for the
call (~1.13 GB at xLSTM-350M's training shape, B 8 x 2048, H 4, dh 512,
most of it dC leaving each chunk); no atomics, so two calls give the same
bits.

Bound: ~4 dh^2 multiply-adds a position and head (the recurrent form's
gradient), ~137 GFLOP at the training shape, ~2.05 ms at the CUDA cores'
f32 peak, ~0.83 ms as three TF32 passes at the tensor cores' peak.

:class:`repro_torch.kernels.mlstm.ops.MLSTM` calls :func:`mlstm_bwd` from
its ``backward``.  ``launches`` counts the calls that ran the kernel;
nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, count_flops, on_meta
from ..mlstm.ref import mlstm_chunkwise_bwd_ref

__all__ = ["HEAD_DIMS", "launches", "mlstm_bwd", "mlstm_bwd_kernel",
           "reset_launches"]

HEAD_DIMS = (32, 64, 128, 512)   # the forward kernel's

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache     # the library's entry points, typed once
def _entry():
    lib = _build.load("mlstm_bwd")
    fn = lib.mlstm_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mlstm_bwd_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.mlstm_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.mlstm_bwd_workspace_floats, lib.cuda_error_string


def workspace_floats(b: int, s: int, h: int, dh: int) -> int:
    """``mlstm_bwd_workspace_floats`` of ``csrc/mlstm_bwd.cu`` in Python
    (what a meta rule allocates): its seven parts, each rounded up to 64
    floats."""
    q, npos, nmat, ngate = 64, 4, 3, 5
    nc = -(-s // q)
    bh, sp = b * h, nc * q
    tiles = dh // min(dh, 64)
    sizes = (bh * (ngate * nc * q + nc + 1), bh * npos * sp, bh * sp * tiles,
             2 * bh, nc * bh * dh, nc * bh * nmat * q * q, nc * bh * dh * dh)
    return sum(-(-x // 64) * 64 for x in sizes)


def mlstm_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logi: torch.Tensor, logf: torch.Tensor,
                     out: torch.Tensor, dout: torch.Tensor) -> tuple:
    """Launch the CUDA kernel.  q, k, v, out (B, S, H, dh) and logi, logf
    (B, S, H) contiguous f32 CUDA tensors (the forward's inputs and output),
    S >= 2, dh in :data:`HEAD_DIMS`; ``dout`` f32 of ``out``'s shape, copied
    if it is not contiguous.  q, k, v, out and dout off a 16-byte boundary
    are copied.  Returns new (dq, dk, dv, dlogi, dlogf), f32."""
    global launches
    ins = (("q", q), ("k", k), ("v", v), ("logi", logi), ("logf", logf),
           ("out", out), ("dout", dout))
    meta = on_meta(*(t for _, t in ins))
    if not meta and any(t.device.type != "cuda" for _, t in ins):
        raise ValueError("mlstm_bwd_kernel needs CUDA tensors (got "
                         f"{[str(t.device) for _, t in ins]})")
    if any(t.dtype != torch.float32 for _, t in ins):
        raise TypeError("mlstm_bwd_kernel takes float32 tensors (got "
                        f"{[str(t.dtype) for _, t in ins]})")
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, out, dout)):
        raise ValueError(f"mlstm_bwd_kernel takes q, k, v, out, dout of one "
                         f"shape (B, S, H, dh) (got "
                         f"{[tuple(t.shape) for t in (q, k, v, out, dout)]})")
    b, s, h, dh = q.shape
    if logi.shape != (b, s, h) or logf.shape != (b, s, h):
        raise ValueError(f"logi, logf must have shape {(b, s, h)} (got "
                         f"{tuple(logi.shape)}, {tuple(logf.shape)})")
    if s < 2:
        raise ValueError(f"mlstm_bwd_kernel takes S >= 2 (got {s}), as the "
                         f"forward kernel")
    if dh not in HEAD_DIMS:
        raise ValueError(f"mlstm_bwd_kernel takes head dims {HEAD_DIMS} "
                         f"(got {dh})")
    for name, t in ins[:-1]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dout = dout.contiguous()
    q, k, v, out, dout = (t.clone() if t.data_ptr() % 16 else t
                          for t in (q, k, v, out, dout))
    if meta:    # the dry-run's rule: the workspace, ~4 dh^2 MACs a position
        work = q.new_empty(workspace_floats(b, s, h, dh))     # and head
        count_flops(2.0 * 4 * dh * dh * b * s * h)
        grads = tuple(torch.empty_like(t) for t in (q, k, v, logi, logf))
        del work
        return grads
    fn, work_floats, err_str = _entry()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dli, dlf = torch.empty_like(logi), torch.empty_like(logf)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        work = torch.empty(work_floats(b, s, h, dh), dtype=torch.float32,
                           device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
                 logf.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
                 dlf.data_ptr(), work.data_ptr(), b, s, h, dh, dh ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f"mlstm_bwd kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return dq, dk, dv, dli, dlf


def mlstm_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logi: torch.Tensor, logf: torch.Tensor, out: torch.Tensor,
              dout: torch.Tensor) -> tuple:
    """(dq, dk, dv, dlogi, dlogf) of the chunkwise mLSTM's output from a
    zero state.  CPU tensors take the plain version
    (:func:`mlstm_chunkwise_bwd_ref`); CUDA tensors launch the kernel, or
    raise if it does not take them."""
    if q.device.type == "cpu":
        return mlstm_chunkwise_bwd_ref(q, k, v, logi, logf, out, dout)
    return mlstm_bwd_kernel(q, k, v, logi, logf, out, dout)
