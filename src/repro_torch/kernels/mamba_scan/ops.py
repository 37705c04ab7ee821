"""Selective-scan entry point: the CUDA kernel on the card, the plain
version on the CPU.

The kernel (``kernels/csrc/mamba_scan.cu``) replaces the Pallas TPU kernel
``mamba_scan`` (``repro/kernels/mamba_scan/mamba_scan.py``) and computes
what the model runs (:func:`~.ref.selective_scan_ref`): the discretisation
fused into the scan, so the ``(S, D, N)`` tensors never reach device
memory, a state in and a state out.  It takes any S, B and D, d_state
in :data:`D_STATES`, ``u`` in f32 or bf16.  The kernel reads B and C rows
by 16-byte copies and bf16 u as pairs of channels: B and C are taken as
contiguous f32 and copied when they do not start on a 16-byte boundary (a
new tensor does), and bf16 u with an odd D or address is widened to f32.
``launches`` counts the calls that ran the kernel; nothing else adds to it.

Under autograd (grad mode on and an input requiring a gradient)
:func:`selective_scan` goes through :class:`SelectiveScan`: its forward is
the same kernel, which then also keeps the state entering each 64-position
tile, its backward the kernel of ``csrc/mamba_scan_bwd.cu``
(``kernels.mamba_scan_bwd``), which takes those states; on CPU tensors the
same Function runs the plain versions (:func:`selective_scan_ref`,
``selective_scan_bwd_ref``).
The gradient starts from the zero state and leaves the final state out, as
training runs the layer: an ``h0``, or a gradient arriving for ``h_last``,
raises ``NotImplementedError``.  Serving runs without a gradient, and its
launches are unchanged.
"""
from __future__ import annotations

import ctypes

import torch

from ...parallel import spmd
from .. import _build, count_flops, on_meta
from ..mamba_scan_bwd import ops as bwd_ops
from .ref import selective_scan_ref

__all__ = ["D_STATES", "SelectiveScan", "launches", "reset_launches",
           "selective_scan", "selective_scan_kernel"]

D_STATES = (8, 16)   # the reference test's and the models' d_state

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _entry():
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.cuda_error_string


def selective_scan_kernel(dt: torch.Tensor, a: torch.Tensor,
                          bmat: torch.Tensor, cmat: torch.Tensor,
                          u: torch.Tensor,
                          h0: torch.Tensor | None = None,
                          keep_states: bool = False) -> tuple:
    """Launch the CUDA kernel.  dt (B, S) and a (D, N) f32; bmat, cmat
    (B, S, N), any float type (cast to f32 here: they are small); u
    (B, S, D) f32 or bf16; h0 (B, D, N) f32 or None (zero state); all on one
    card.  Returns (y (B, S, D), h_last (B, D, N)), new f32 tensors, and
    with ``keep_states`` also the state entering each 64-position tile,
    (B, ceil(S / 64), D, N) f32, which the backward kernel takes in place of
    its own forward sweep."""
    global launches
    ins = {"dt": dt, "a": a, "bmat": bmat, "cmat": cmat, "u": u}
    if h0 is not None:
        ins["h0"] = h0
    meta = on_meta(*ins.values())
    if not meta and any(t.device.type != "cuda" for t in ins.values()):
        raise ValueError("selective_scan_kernel needs CUDA tensors (got "
                         f"{[str(t.device) for t in ins.values()]})")
    if dt.dim() != 2 or a.dim() != 2 or u.dim() != 3:
        raise ValueError(f"dt (B, S), a (D, N), u (B, S, D) expected (got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(u.shape)})")
    b, s = dt.shape
    d, n = a.shape
    if n not in D_STATES:
        raise ValueError(f"selective_scan_kernel takes d_state in {D_STATES} "
                         f"(got {n})")
    want = {"bmat": (b, s, n), "cmat": (b, s, n), "u": (b, s, d),
            "h0": (b, d, n)}
    for name, shape in want.items():
        if name in ins and tuple(ins[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape} (got "
                             f"{tuple(ins[name].shape)})")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise TypeError("dt, a and h0 must be float32")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16 (got {u.dtype})")
    if any(not t.is_contiguous() for t in (dt, a, u, *(() if h0 is None
                                                       else (h0,)))):
        raise ValueError("dt, a, u and h0 must be contiguous")
    bmat, cmat = (m.float().contiguous() for m in (bmat, cmat))
    bmat, cmat = (m.clone() if m.data_ptr() % 16 else m
                  for m in (bmat, cmat))
    if u.dtype == torch.bfloat16 and (d % 2 or u.data_ptr() % 4):
        u = u.float()
    if meta:    # the dry-run's rule: 7 operations a (position, channel,
        count_flops(7.0 * b * s * d * n + b * s * n)        # state), 1 dt B
    else:
        fn, err_str = _entry()
    y = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=u.device)
    hs = (torch.empty((b, -(-s // bwd_ops.TILE), d, n),
                      dtype=torch.float32, device=u.device)
          if keep_states else None)
    if meta:
        return (y, h_last, hs) if keep_states else (y, h_last)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), u.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), 0 if hs is None else hs.data_ptr(), b,
                 s, d, n, int(u.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return (y, h_last, hs) if keep_states else (y, h_last)


class SelectiveScan(torch.autograd.Function):
    """The selective scan from the zero state with a gradient: the forward
    kernel, the backward kernel (``kernels.mamba_scan_bwd``); their plain
    versions on CPU tensors.  ``apply(dt, a, bmat, cmat, u) -> (y,
    h_last)``; ``h_last`` takes no gradient.  Each input's gradient comes
    back in its own type (bf16 ``bmat``, ``cmat`` slices of the model's
    projection, bf16 ``u``)."""

    @staticmethod
    def forward(ctx, dt, a, bmat, cmat, u):
        hs = None
        if u.device.type == "cpu":
            y, h_last = selective_scan_ref(dt, a, bmat, cmat, u)
        else:
            y, h_last, hs = selective_scan_kernel(dt, a, bmat, cmat, u,
                                                  keep_states=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, a, bmat, cmat, u, hs)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        if dh_last is not None:
            raise NotImplementedError(
                "the selective scan's backward takes no gradient of the "
                "final state h_last: training drops it")
        *ins, hs = ctx.saved_tensors
        if dy is None:
            return (None,) * 5
        grads = bwd_ops.selective_scan_bwd(*ins, dy, hs)
        return tuple(g.to(x.dtype) for g, x in zip(grads, ins))


def selective_scan(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, u: torch.Tensor,
                   h0: torch.Tensor | None = None) -> tuple:
    """The selective scan with the discretisation fused, a state in and
    out: (y (B, S, D), h_last (B, D, N)), f32.  CPU tensors take the plain
    version (:func:`selective_scan_ref`); CUDA tensors launch the kernel,
    or raise if it does not take them.  Where a gradient is wanted the call
    goes through :class:`SelectiveScan`, from the zero state only.
    DTensors run on each rank's shards (``parallel.spmd.selective_scan``)."""
    if spmd.is_dtensor(u):
        return spmd.selective_scan(selective_scan, dt, a, bmat, cmat, u, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (dt, a, bmat, cmat, u, h0)):
        if h0 is not None:
            raise NotImplementedError(
                "the selective scan's backward starts from the zero state: "
                "a state h0 takes no gradient; pass h0=None, or call under "
                "torch.no_grad()")
        return SelectiveScan.apply(dt, a, bmat, cmat, u)
    if u.device.type == "cpu":
        return selective_scan_ref(dt, a, bmat, cmat, u, h0)
    return selective_scan_kernel(dt, a, bmat, cmat, u, h0)
