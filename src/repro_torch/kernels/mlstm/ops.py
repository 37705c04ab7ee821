"""Chunkwise mLSTM entry point: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.mlstm.ops.mlstm``, with a state in and a
state out (the serving path starts each prefill from ``init_mlstm_state``
and hands its final state to decode).  The kernel
(``kernels/csrc/mlstm.cu``) replaces the Pallas TPU kernel
``mlstm_chunkwise_pallas`` (``repro/kernels/mlstm/mlstm.py``), which is the
special case "zero state in, no state out", and is instantiated in f32 at
head dims :data:`HEAD_DIMS`.  A call makes several CUDA launches (its
passes, ``mlstm.cu``) on a workspace allocated for the call.  The kernel
reads q, k and v by 16-byte copies: one that does not start on a 16-byte
boundary is copied first (a new tensor does).  ``launches`` counts the
calls that ran the kernel, one a call; nothing else adds to it.

Under autograd (grad mode on and an input requiring a gradient)
:func:`mlstm` goes through :class:`MLSTM`: its forward is the same kernel,
its backward the kernel of ``csrc/mlstm_bwd.cu`` (``kernels.mlstm_bwd``);
on CPU tensors the same Function runs the plain versions
(:func:`mlstm_chunkwise_ref`, ``mlstm_chunkwise_bwd_ref``).  The gradient
starts from the zero state and leaves the final state out, as training
runs the layer: a state in, or a gradient arriving for the final state,
raises ``NotImplementedError``.  Serving runs without a gradient, and its
launches are unchanged.
"""
from __future__ import annotations

import ctypes

import torch

from ...parallel import spmd
from .. import _build, count_flops, on_meta
from ..mlstm_bwd import ops as bwd_ops
from .ref import M_INIT, mlstm_chunkwise_ref, pads

__all__ = ["HEAD_DIMS", "MLSTM", "launches", "mlstm", "mlstm_kernel",
           "reset_launches"]

HEAD_DIMS = (32, 64, 128, 512)   # the tests' and xLSTM-350M's

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _entry():
    lib = _build.load("mlstm")
    fn = lib.mlstm_chunkwise_f32
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mlstm_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.mlstm_workspace_floats.restype = ctypes.c_longlong
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.mlstm_workspace_floats, lib.cuda_error_string


def workspace_floats(b: int, s: int, h: int, dh: int) -> int:
    """``mlstm_workspace_floats`` of ``csrc/mlstm.cu`` in Python (what a
    meta rule allocates): the gates, a window of 16 chunks' partial scores
    (dh / 128 splits from dh 256 on), states and normalisers."""
    q, slots, ngate = 64, 16, 5
    nc = -(-s // q)
    win, bh = min(nc, slots), b * h
    splits = dh // 128 if dh >= 256 else 1
    gates = -(-bh * (ngate * nc * q + nc + 1) // 64) * 64
    return gates + win * bh * (splits * q * q + dh * dh + dh)


def _zero_state(b: int, h: int, dh: int, device) -> tuple:
    return (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            torch.full((b, h), M_INIT, dtype=torch.float32, device=device))


def mlstm_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logi: torch.Tensor, logf: torch.Tensor,
                 state: tuple | None = None) -> tuple:
    """Launch the CUDA kernel.  q, k, v (B, S, H, dh) and logi, logf
    (B, S, H) contiguous f32 CUDA tensors, S >= 2, dh in
    :data:`HEAD_DIMS`; ``state`` ``(C (B, H, dh, dh), n (B, H, dh),
    m (B, H))`` contiguous f32 on the same card, or None (zero state, ``m``
    at -1e30).  Returns (out (B, S, H, dh), (C, n, m)), new f32 tensors."""
    global launches
    ins = (("q", q), ("k", k), ("v", v), ("logi", logi), ("logf", logf))
    if state is not None:
        if len(state) != 3:
            raise ValueError("state must be (C, n, m)")
        ins += tuple(zip(("C", "n", "m"), state))
    meta = on_meta(*(t for _, t in ins))
    if not meta and any(t.device.type != "cuda" for _, t in ins):
        raise ValueError("mlstm_kernel needs CUDA tensors (got "
                         f"{[str(t.device) for _, t in ins]})")
    if any(t.dtype != torch.float32 for _, t in ins):
        raise TypeError("mlstm_kernel takes float32 tensors (got "
                        f"{[str(t.dtype) for _, t in ins]})")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_kernel takes q, k, v of one shape (B, S, H, "
                         f"dh) (got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    b, s, h, dh = q.shape
    if logi.shape != (b, s, h) or logf.shape != (b, s, h):
        raise ValueError(f"logi, logf must have shape {(b, s, h)} (got "
                         f"{tuple(logi.shape)}, {tuple(logf.shape)})")
    if s < 2:
        raise ValueError(f"mlstm_kernel takes S >= 2 (got {s}); one token "
                         f"is the recurrence step of mlstm_block")
    if dh not in HEAD_DIMS:
        raise ValueError(f"mlstm_kernel takes head dims {HEAD_DIMS} "
                         f"(got {dh})")
    if state is None:
        state = _zero_state(b, h, dh, q.device)
    shapes = ((b, h, dh, dh), (b, h, dh), (b, h))
    for name, t, want in zip(("C", "n", "m"), state, shapes):
        if tuple(t.shape) != want:
            raise ValueError(f"state {name} must have shape {want} (got "
                             f"{tuple(t.shape)})")
    for name, t in ins:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    c0, n0, m0 = state
    if meta:    # the dry-run's rule: the workspace, the recurrent form's
        work = q.new_empty(workspace_floats(b, s, h, dh))     # operations
        count_flops(2.0 * b * s * h * (2 * dh * dh + 2 * dh))
        out = torch.empty_like(q)
        c1, n1, m1 = (torch.empty_like(t) for t in state)
        del work
        return out, (c1, n1, m1)
    fn, work_floats, err_str = _entry()
    out = torch.empty_like(q)
    c1, n1, m1 = (torch.empty_like(t) for t in state)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        work = torch.empty(work_floats(b, s, h, dh), dtype=torch.float32,
                           device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
                 logf.data_ptr(), c0.data_ptr(), n0.data_ptr(),
                 m0.data_ptr(), out.data_ptr(), c1.data_ptr(),
                 n1.data_ptr(), m1.data_ptr(), work.data_ptr(), b, s, h, dh,
                 int(pads(s)), dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"mlstm kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return out, (c1, n1, m1)


class MLSTM(torch.autograd.Function):
    """The chunkwise mLSTM from the zero state with a gradient: the forward
    kernel, the backward kernel (``kernels.mlstm_bwd``); their plain
    versions on CPU tensors.  ``apply(q, k, v, logi, logf) -> (out, C, n,
    m)``; the final state takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf):
        if q.device.type == "cpu":
            out, (c, n, m) = mlstm_chunkwise_ref(q, k, v, logi, logf)
        else:
            out, (c, n, m) = mlstm_kernel(q, k, v, logi, logf)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, logi, logf, out)
        return out, c, n, m

    @staticmethod
    def backward(ctx, dout, dc, dn, dm):
        if dc is not None or dn is not None or dm is not None:
            raise NotImplementedError(
                "the mLSTM's backward takes no gradient of the final state "
                "(C, n, m): training drops it")
        ins = ctx.saved_tensors
        if dout is None:
            return (None,) * 5
        grads = bwd_ops.mlstm_bwd(*ins, dout)
        return tuple(g.to(x.dtype) for g, x in zip(grads, ins))


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logi: torch.Tensor, logf: torch.Tensor,
          state: tuple | None = None) -> tuple:
    """Chunkwise mLSTM with a state in and out: (out, (C, n, m)).  CPU
    tensors take the plain version (:func:`mlstm_chunkwise_ref`); CUDA
    tensors launch the kernel, or raise if it does not take them.  Where a
    gradient is wanted the call goes through :class:`MLSTM`, from the zero
    state only.  DTensors run on each rank's shards
    (``parallel.spmd.mlstm``)."""
    if spmd.is_dtensor(q):
        return spmd.mlstm(mlstm, q, k, v, logi, logf, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, logi, logf, *(state or ()))):
        if state is not None:
            raise NotImplementedError(
                "the mLSTM's backward starts from the zero state: a state "
                "(C, n, m) in takes no gradient; pass state=None, or call "
                "under torch.no_grad()")
        out, c, n, m = MLSTM.apply(q, k, v, logi, logf)
        return out, (c, n, m)
    if q.device.type == "cpu":
        return mlstm_chunkwise_ref(q, k, v, logi, logf, state)
    return mlstm_kernel(q, k, v, logi, logf, state)
