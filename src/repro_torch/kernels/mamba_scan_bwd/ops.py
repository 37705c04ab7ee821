"""Selective-scan backward entry point: the CUDA kernel on the card, the
plain version on the CPU.

The kernel (``kernels/csrc/mamba_scan_bwd.cu``) computes the gradients of
the forward kernel's ``y`` in dt, a, B, C and u from a zero state in, the
final state unused
(:func:`~repro_torch.kernels.mamba_scan.ref.selective_scan_bwd_ref`), at
d_state in :data:`D_STATES`, ``u`` in f32 or bf16 (du in u's type), any
S >= 1 and D >= 1; it replaces no Pallas kernel (the reference
differentiates its jnp scan).  It takes the state entering each
64-position tile as the forward kernel keeps it under a gradient
(``selective_scan_kernel(..., keep_states=True)``).  Two CUDA launches a
call: the reverse sweep, which writes each 32-channel block's share of the
sums over channels, then those shares summed in a fixed order; no atomics,
so two calls give the same bits.  The workspace (the shares; ~280 MB at
Jamba's training shape, B 2 x 2048, D 16384, N 16) is allocated for the
call.

Bound: one exponential a (position, channel, state) on the special-function
units, ~0.25 ms at the training shape, above the bytes of u, dy and du.

:class:`repro_torch.kernels.mamba_scan.ops.SelectiveScan` calls
:func:`selective_scan_bwd` from its ``backward``.  ``launches`` counts the
calls that ran the kernel; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, count_flops, on_meta
from ..mamba_scan.ref import selective_scan_bwd_ref

__all__ = ["D_STATES", "TILE", "launches", "reset_launches",
           "selective_scan_bwd", "selective_scan_bwd_kernel"]

D_STATES = (8, 16)   # the forward kernel's
TILE = 64            # positions a tile of both kernels: a kept state each

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@functools.cache     # the library's entry points, typed once
def _entry():
    lib = _build.load("mamba_scan_bwd")
    fn = lib.mamba_scan_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mamba_scan_bwd_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.mamba_scan_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.mamba_scan_bwd_workspace_floats, lib.cuda_error_string


def workspace_floats(b: int, s: int, d: int, n: int) -> int:
    """``mamba_scan_bwd_workspace_floats`` of ``csrc/mamba_scan_bwd.cu`` in
    Python (what a meta rule allocates): the blocks' partial sums, 32
    channels a block."""
    nblk = -(-d // 32)
    return b * (2 * nblk * s * n + nblk * s + d * n)


def selective_scan_bwd_kernel(dt: torch.Tensor, a: torch.Tensor,
                              bmat: torch.Tensor, cmat: torch.Tensor,
                              u: torch.Tensor, dy: torch.Tensor,
                              hs: torch.Tensor) -> tuple:
    """Launch the CUDA kernel.  dt (B, S) and a (D, N) contiguous f32;
    bmat, cmat (B, S, N), any float type (widened to contiguous f32 here:
    they are small); u (B, S, D) contiguous f32 or bf16; dy (B, S, D) f32,
    copied if not contiguous; ``hs`` the state entering each 64-position
    tile as the forward kernel keeps it (``keep_states``), (B, ceil(S /
    64), D, N) contiguous f32; all on one card.  Returns new (ddt (B, S),
    da (D, N), dB, dC (B, S, N) f32, du (B, S, D) in u's type)."""
    global launches
    ins = {"dt": dt, "a": a, "bmat": bmat, "cmat": cmat, "u": u, "dy": dy,
           "hs": hs}
    meta = on_meta(*ins.values())
    if not meta and any(t.device.type != "cuda" for t in ins.values()):
        raise ValueError("selective_scan_bwd_kernel needs CUDA tensors (got "
                         f"{[str(t.device) for t in ins.values()]})")
    if dt.dim() != 2 or a.dim() != 2 or u.dim() != 3:
        raise ValueError(f"dt (B, S), a (D, N), u (B, S, D) expected (got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(u.shape)})")
    b, s = dt.shape
    d, n = a.shape
    if n not in D_STATES:
        raise ValueError(f"selective_scan_bwd_kernel takes d_state in "
                         f"{D_STATES} (got {n})")
    if s < 1:
        raise ValueError("selective_scan_bwd_kernel takes S >= 1")
    want = {"bmat": (b, s, n), "cmat": (b, s, n), "u": (b, s, d),
            "dy": (b, s, d), "hs": (b, -(-s // TILE), d, n)}
    for name, shape in want.items():
        if tuple(ins[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape} (got "
                             f"{tuple(ins[name].shape)})")
    if any(t.dtype != torch.float32 for t in (dt, a, dy, hs)):
        raise TypeError("dt, a, dy and hs must be float32")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16 (got {u.dtype})")
    if any(not t.is_contiguous() for t in (dt, a, u, hs)):
        raise ValueError("dt, a, u and hs must be contiguous")
    bmat, cmat = (m.float().contiguous() for m in (bmat, cmat))
    dy = dy.contiguous()
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a)
    dbm, dcm = torch.empty_like(bmat), torch.empty_like(cmat)
    du = torch.empty_like(u)
    if meta:    # the dry-run's rule: the workspace, one exponential a
        work = dt.new_empty(workspace_floats(b, s, d, n))   # (position,
        count_flops(1.0 * b * s * d * n)                   # channel, state)
        del work
        return ddt, da, dbm, dcm, du
    fn, work_floats, err_str = _entry()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        work = torch.empty(work_floats(b, s, d, n), dtype=torch.float32,
                           device=u.device)
        err = fn(dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), u.data_ptr(), dy.data_ptr(), du.data_ptr(),
                 ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(),
                 dcm.data_ptr(), work.data_ptr(), hs.data_ptr(), b, s, d, n,
                 int(u.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches += 1
    return ddt, da, dbm, dcm, du


def selective_scan_bwd(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                       hs: torch.Tensor | None) -> tuple:
    """(ddt, da, dB, dC, du) of the selective scan's ``y`` from a zero
    state.  CPU tensors take the plain version
    (:func:`selective_scan_bwd_ref`; ``hs`` unused, None there); CUDA
    tensors launch the kernel with the forward kernel's kept states ``hs``,
    or raise if it does not take them."""
    if u.device.type == "cpu":
        return selective_scan_bwd_ref(dt, a, bmat, cmat, u, dy)
    if hs is None:
        raise ValueError("the selective scan's backward kernel takes the "
                         "forward kernel's tile states: "
                         "selective_scan_kernel(..., keep_states=True)")
    return selective_scan_bwd_kernel(dt, a, bmat, cmat, u, dy, hs)
