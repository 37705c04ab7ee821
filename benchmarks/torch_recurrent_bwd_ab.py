#!/usr/bin/env python3
"""The port's mLSTM and selective-scan backward kernels against their
parents and against variants of themselves, on one NVIDIA card.

    python3 benchmarks/torch_recurrent_bwd_ab.py \\
        --old-mlstm OLD_MLSTM.cu --old-scan OLD_SCAN.cu --old-fwd OLD_FWD.cu

``OLD_MLSTM.cu``, ``OLD_SCAN.cu`` and ``OLD_FWD.cu`` are earlier
``src/repro_torch/kernels/csrc/mlstm_bwd.cu``, ``mamba_scan_bwd.cu`` and
``mamba_scan.cu`` (``git show <commit>:src/repro_torch/kernels/csrc/
mlstm_bwd.cu > OLD_MLSTM.cu``, written where the run can read it), built
against the headers in ``--old-include`` (that commit's ``csrc/*.cuh``,
written there the same way; default: this tree's).  The script builds
them, this tree's sources and text variants of them with ``nvcc`` (the
port's flags) under ``--build`` (default ``build/ab``, git-ignored), all
at once (``torch_ab_common.build``), and prints each build's ``ptxas``
registers, spills and shared memory.  Then, at each shape of
:data:`MLSTM_SHAPES` and :data:`SCAN_SHAPES` (the training shapes first),
it:

1. holds every build to the plain version (``mlstm_chunkwise_bwd_ref``,
   ``selective_scan_bwd_ref``) within ``chip_smoke.RECURRENT_BWD_TOL`` of
   each gradient's largest magnitude (``chip_smoke.recurrent_rel``), two
   calls bitwise equal; a variant marked ``gate: False`` is measured and
   reported, not held;
2. times old and new in turns (old, new, new, old) with
   ``chip_smoke.device_ms`` (CUDA-graph replay: the card's time alone),
   each variant once beside them;
3. prints each time beside its bounds: the mLSTM's
   (``chip_smoke.mlstm_bwd_bound_ms``: ~4 dh^2 multiply-adds a position and
   head as three TF32 passes at the tensor cores' peak) and the same work
   on the CUDA cores in f32; the scan's SFU floor of one exponential a
   (position, channel, state) (``chip_smoke.scan_bwd_bound_ms``);
4. splits old's and new's time by kernel from a profiler trace of three
   calls, and, from the ``stamps`` variants, each scan build's cycles by
   phase (``clock64()`` read by thread 0 of every block at the phase
   edges: the forward sweep, a tile's loads, the per-state loop, the
   tile's sums and stores), summed over its blocks.

Variants (this tree's source, text substitutions):

- ``mlstm_tf32x1``: one TF32 pass (hi x hi) for the three, to show what
  the split costs and what it buys in accuracy (``gate: False``);
- ``mlstm_walk_fwd_only``: the walks' launch without the reverse walk's
  blocks, to split the walks' time (``gate: False``);
- ``mlstm_no_dc_store``: the reverse walk without its stores of dC, to
  show what they cost (``gate: False``);
- ``mlstm_state_in_mma``: the walk's update accumulating onto the decayed
  state in the tensor cores, not summing the chunk apart and adding it
  in f32 arithmetic;
- ``mlstm_stamps``: the walk's cycles by phase (a chunk's start, a piece's
  syncs and waits, a piece's products, a chunk's end), as the scan's;
- ``scan_stamps_old``, ``scan_stamps_new``: the phase stamps above (this
  tree's has no forward sweep: its first phase is the block's setup).
  The parent's anchors are those of the CUDA-core scan backward with its
  own forward sweep; a parent without them builds no stamps variant.

This tree's scan backward takes the tile states the forward kernel keeps
under a gradient (as training calls it); the parent formed them in a
forward sweep of its own, and its forward kernel had no argument for
them.  At each shape of :data:`FWD_SHAPES` the parent's forward and this
tree's are held to the plain version (``selective_scan_ref``, within
``chip_smoke.MAMBA_TOL``) and to each other's bits, and timed in turns
without the kept states (old, new, new, old), then this tree's once with
them.

Writes the results to ``--json`` (default
``build/ab/ab_recurrent_bwd.json``).  Needs the card; exits 1 if a check
that is held fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from torch_ab_common import ROOT, build, kernel_split, log, substituted

sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    selective_scan_bwd_ref,
    selective_scan_ref,
)
from repro_torch.kernels.mamba_scan import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.mamba_scan_bwd.ops import TILE  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_bwd_ref  # noqa: E402

# (label, B, S, H, dh) and (label, B, S, D, N, u type): the training shapes
# (xLSTM-350M, Jamba-1.5-Large) and a ragged one each
MLSTM_SHAPES = (("xlstm-train", 8, 2048, 4, 512),
                ("ragged-dh64", 1, 1100, 4, 64))
SCAN_SHAPES = (("jamba-train", 2, 2048, 16384, 16, torch.bfloat16),
               ("odd-d", 2, 130, 101, 16, torch.bfloat16))
# the forward scan's (label, B, S, D, N, u type, state): Jamba's longest
# served prompt (chip_smoke.mamba_phases' reported call, a fresh lane's
# zero state) and its training shape (no state)
FWD_SHAPES = (("served-prefill", 1, 980, 16384, 16, torch.bfloat16, "fresh"),
              ("jamba-train", 2, 2048, 16384, 16, torch.bfloat16, "none"))

# clock64() stamps: thread 0 of each block adds the cycles since the last
# stamp to slot i; the totals go to a device array read by ab_stamps_read
STAMP_DEFS = """
#include <cstdint>
__device__ unsigned long long ab_stamps[1 << 20];
#define AB_BEGIN long long ab_t = clock64(); long long ab_acc[4] = {0, 0, 0, 0};
#define AB_STAMP(i) { const long long ab_n = clock64(); ab_acc[i] += ab_n - ab_t; ab_t = ab_n; }
#define AB_END if (threadIdx.x == 0) { const long long ab_b = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; for (int ab_i = 0; ab_i < 4; ++ab_i) ab_stamps[ab_b * 4 + ab_i] = ab_acc[ab_i]; }
extern "C" int ab_stamps_read(void* dst, long long n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, ab_stamps, n * 8));
}
extern "C" int ab_stamps_zero() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, ab_stamps);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(ab_stamps)));
}
"""
STAMP_PHASES = ("forward sweep", "tile loads", "per-state loop",
                "tile sums and stores")
WALK_PHASES = ("chunk start", "piece waits", "piece products",
               "chunk end")
# anchors of each scan source: (text, text with the stamp after or before)
STAMPS_OLD = [
    ('#include "mamba_scan.cuh"\n', '#include "mamba_scan.cuh"\n' + STAMP_DEFS),
    ("  const int ntiles = (s + TS - 1) / TS;\n",
     "  const int ntiles = (s + TS - 1) / TS;\n  AB_BEGIN\n"),
    ("  __syncthreads();   // every tile's entering state is written\n",
     "  __syncthreads();   // every tile's entering state is written\n"
     "  AB_STAMP(0)\n"),
    ("    load(t0, true);\n    __syncthreads();\n",
     "    load(t0, true);\n    __syncthreads();\n    AB_STAMP(1)\n"),
    ("#pragma unroll\n    for (int x = 0; x < K; ++x) {\n"
     "      const float tt = group_sum(dtk[x]);\n",
     "    AB_STAMP(2)\n#pragma unroll\n    for (int x = 0; x < K; ++x) {\n"
     "      const float tt = group_sum(dtk[x]);\n"),
    ("    __syncthreads();   // the tile's shared memory is free\n  }\n",
     "    __syncthreads();   // the tile's shared memory is free\n"
     "    AB_STAMP(3)\n  }\n  AB_END\n"),
]
NEW_PHASES = ("setup",) + STAMP_PHASES[1:]   # no forward sweep
STAMPS_NEW = [
    ('#include "mamba_scan.cuh"\n', '#include "mamba_scan.cuh"\n' + STAMP_DEFS),
    ("  const int ntiles = (s + TS - 1) / TS;\n",
     "  const int ntiles = (s + TS - 1) / TS;\n  AB_BEGIN\n"),
    ("  // the tiles in reverse\n", "  AB_STAMP(0)\n  // the tiles in reverse\n"),
    ("    __syncthreads();   // the tile is in\n",
     "    __syncthreads();   // the tile is in\n    AB_STAMP(1)\n"),
    ("      __syncthreads();   // the warps' rows are in\n",
     "      AB_STAMP(2)\n      __syncthreads();   // the warps' rows are in\n"),
    ("      __syncthreads();   // the rows are read\n",
     "      __syncthreads();   // the rows are read\n      AB_STAMP(3)\n"),
    ("  // da: the lanes' partials", "  AB_END\n  // da: the lanes' partials"),
]
# the mLSTM walk's stamps: a chunk's start (its scalars, the wait for its
# tiles, the update's operand, its own term), a piece's syncs and waits, a
# piece's products, the chunk's end (the halves' exchange, the stores)
STAMPS_WALK = [
    ('#include "mlstm.cuh"\n', '#include "mlstm.cuh"\n' + STAMP_DEFS),
    ("  int item = 0;       // pieces walked, over all chunks: the stage's parity\n",
     "  int item = 0;       // pieces walked, over all chunks: the stage's parity\n"
     "  AB_BEGIN\n"),
    ("    for (int i = 0; i < NP; ++i, ++item) {\n",
     "    AB_STAMP(0)\n    for (int i = 0; i < NP; ++i, ++item) {\n"),
    ("      const float* zs = stage + (item & 1) * W::STAGE;\n",
     "      AB_STAMP(1)\n      const float* zs = stage + (item & 1) * W::STAGE;\n"),
    ("big[n][3] + small[n][3]));\n      }\n    }\n",
     "big[n][3] + small[n][3]));\n      }\n      AB_STAMP(2)\n    }\n"),
    ("    __syncthreads();   // the chunk's scalars are read\n  }\n",
     "    __syncthreads();   // the chunk's scalars are read\n    AB_STAMP(3)\n"
     "  }\n  AB_END\n"),
]
MLSTM_TF32X1 = [(
    "  mma_tf32(d, a.lo, b.hi);\n  mma_tf32(d, a.hi, b.lo);\n", "")]
# variants of mlstm_bwd.cu: (name, substitutions, held to the gate)
MLSTM_VARIANTS = [
    # the forward walk alone (the reverse walk's blocks not launched)
    ("mlstm_walk_fwd_only", [("dim3(Wk::TILES, bh, 2)",
                              "dim3(Wk::TILES, bh, 1)")], False),
    # the reverse walk without its stores of dC (dv then reads garbage)
    ("mlstm_no_dc_store", [("      if (rev) {   // dC leaving chunk j, for dv",
                            "      if (false) {")], False),
    # the walk's update accumulating onto the decayed state in the tensor
    # cores (as first built), not summing the chunk apart
    ("mlstm_state_in_mma", [
        ("        for (int c = 0; c < 4; ++c) big[n][c] = small[n][c] = 0.f;\n",
         "        for (int c = 0; c < 4; ++c) {\n"
         "          big[n][c] = dc * xa[n][c];\n          small[n][c] = 0.f;\n"
         "        }\n"),
        ("fmaf(dc, x0.x, big[n][0] + small[n][0])",
         "big[n][0] + small[n][0]"),
        ("fmaf(dc, x0.y, big[n][1] + small[n][1])",
         "big[n][1] + small[n][1]"),
        ("fmaf(dc, x1.x, big[n][2] + small[n][2])",
         "big[n][2] + small[n][2]"),
        ("fmaf(dc, x1.y, big[n][3] + small[n][3])",
         "big[n][3] + small[n][3]")], True),
]


def mlstm_caller(lib):
    """The mLSTM backward through ``lib``'s C interface, as
    ``mlstm_bwd_kernel`` calls it on contiguous aligned inputs."""
    fn = lib.mlstm_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    wf = lib.mlstm_bwd_workspace_floats
    wf.argtypes = [ctypes.c_int] * 4
    wf.restype = ctypes.c_longlong

    def call(q, k, v, li, lf, out, dout):
        b, s, h, dh = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        dli, dlf = torch.empty_like(li), torch.empty_like(lf)
        work = torch.empty(wf(b, s, h, dh), dtype=torch.float32,
                           device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                 lf.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
                 dlf.data_ptr(), work.data_ptr(), b, s, h, dh, dh ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mlstm_bwd_f32: CUDA error {err}")
        return dq, dk, dv, dli, dlf
    return call


def scan_caller(lib, hs=None):
    """The scan backward through ``lib``'s C interface, as
    ``selective_scan_bwd_kernel`` calls it; a build that takes the forward
    kernel's kept tile states (this tree's) is given ``hs``."""
    fn = lib.mamba_scan_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * (12 if hs is None else 13) + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    wf = lib.mamba_scan_bwd_workspace_floats
    wf.argtypes = [ctypes.c_int] * 4
    wf.restype = ctypes.c_longlong

    def call(dt, a, bmat, cmat, u, dy):
        b, s = dt.shape
        d, n = a.shape
        ddt, da = torch.empty_like(dt), torch.empty_like(a)
        dbm, dcm, du = (torch.empty_like(bmat), torch.empty_like(cmat),
                        torch.empty_like(u))
        work = torch.empty(wf(b, s, d, n), dtype=torch.float32,
                           device=u.device)
        kept = () if hs is None else (hs.data_ptr(),)
        err = fn(dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), u.data_ptr(), dy.data_ptr(), du.data_ptr(),
                 ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(),
                 dcm.data_ptr(), work.data_ptr(), *kept, b, s, d, n,
                 int(u.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mamba_scan_bwd_f32: CUDA error {err}")
        return ddt, da, dbm, dcm, du
    return call


def fwd_caller(lib, keep: bool | None):
    """The forward scan through ``lib``'s C interface, as
    ``selective_scan_kernel`` calls it: ``keep`` None for a build without
    the kept-states argument (the parent's), else whether this tree's build
    writes them."""
    fn = lib.mamba_scan
    fn.argtypes = [ctypes.c_void_p] * (8 if keep is None else 9) + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(dt, a, bmat, cmat, u, h0):
        b, s = dt.shape
        d, n = a.shape
        y = torch.empty((b, s, d), dtype=torch.float32, device=u.device)
        h_last = torch.empty((b, d, n), dtype=torch.float32, device=u.device)
        hs = torch.empty((b, -(-s // TILE), d, n), dtype=torch.float32,
                         device=u.device) if keep else None
        kept = () if keep is None else (0 if hs is None else hs.data_ptr(),)
        err = fn(dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), u.data_ptr(),
                 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), *kept, b, s, d, n,
                 int(u.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mamba_scan: CUDA error {err}")
        return y, h_last
    return call


def mlstm_args(b, s, h, dh):
    """``chip_smoke.mlstm_bwd_phases``'s inputs: the forward kernel's
    output and a seeded cotangent."""
    ins, _ = cs.mlstm_inputs(b, s, h, dh, "none")
    out, _ = mlstm_ops.mlstm_kernel(*ins)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7 * s + dh)
    dout = torch.randn(b, s, h, dh, generator=gen, device="cuda")
    return (*ins, out, dout)


def scan_args(b, s, d, n, u_dtype):
    """``chip_smoke.mamba_bwd_phases``'s inputs."""
    dt, a, bmat, cmat, u, _ = cs.mamba_inputs(b, s, d, n, u_dtype, "none")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7 * s + d)
    dy = torch.randn(b, s, d, generator=gen, device="cuda")
    return dt, a, bmat, cmat, u, dy


def held(name, call, args, plain_out, gate: bool) -> dict:
    got = call(*args)
    again = call(*args)
    torch.cuda.synchronize()
    rel = cs.recurrent_rel(got, plain_out)
    ratio = max(rel) / cs.RECURRENT_BWD_TOL
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    verdict = ("ok" if ratio <= 1 and same else "FAIL") if gate else \
        "measured"
    log(f"  {name:16s} of each gradient's largest "
        f"{', '.join(f'{x:.2e}' for x in rel)} ({ratio:.3f} x the gate "
        f"{cs.RECURRENT_BWD_TOL:g}); repeatable {same}: {verdict}")
    return {"rel": rel, "x_gate": ratio, "repeatable": same,
            "ok": (ratio <= 1 and same) or not gate, "gate": gate}


def timed(calls: dict, args, order: list, bounds: dict) -> dict:
    times: dict = {}
    for name in order:
        ms = cs.device_ms(lambda: calls[name](*args), 3)
        times.setdefault(name, []).append(ms)
        log(f"  {name:16s} {ms:.4f} ms"
            + "".join(f", x {k} {ms / v:.2f}" for k, v in bounds.items()))
    return times


def stamps(lib, call, args, phases=STAMP_PHASES) -> dict:
    """Cycles by phase summed over the blocks of one call of a stamps
    build, and each phase's share."""
    fn = lib.ab_stamps_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    fn.restype = ctypes.c_int
    lib.ab_stamps_zero.restype = ctypes.c_int
    torch.cuda.synchronize()
    if lib.ab_stamps_zero():
        raise RuntimeError("ab_stamps_zero failed")
    call(*args)
    torch.cuda.synchronize()
    buf = torch.zeros(1 << 20, dtype=torch.int64)
    if fn(buf.data_ptr(), buf.numel()):
        raise RuntimeError("ab_stamps_read failed")
    per = buf.view(-1, 4)
    blocks = int((per.sum(1) > 0).sum())
    tot = per.sum(0).double()
    share = (tot / tot.sum()).tolist()
    return {"blocks": blocks,
            "cycles_per_block": (tot / max(blocks, 1)).tolist(),
            "share": dict(zip(phases, share))}


def run_mlstm(libs: dict) -> tuple:
    calls = {k: mlstm_caller(v) for k, v in libs.items()
             if k.startswith("mlstm")}
    ok, res = True, {}
    for label, b, s, h, dh in MLSTM_SHAPES:
        args = mlstm_args(b, s, h, dh)
        want = mlstm_chunkwise_bwd_ref(*args)
        bound, by, f32 = cs.mlstm_bwd_bound_ms(b, s, h, dh)
        key = f"{label} {b}x{s} H{h} dh{dh}"
        log(f"== mLSTM backward {key}: bound {bound:.6f} ms ({by}), on "
            f"the CUDA cores in f32 {f32:.6f} ms")
        row = {"shape": [b, s, h, dh], "bound_ms": bound, "bound_by": by,
               "f32_bound_ms": f32, "checks": {}}
        for name, call in calls.items():
            gate = name != "mlstm_tf32x1" and all(
                g for v, _, g in MLSTM_VARIANTS if v == name)
            row["checks"][name] = held(name, call, args, want, gate)
            ok &= row["checks"][name]["ok"]
        del want
        order = ["mlstm_old", "mlstm_new", "mlstm_new", "mlstm_old"] + [
            n for n in calls if n not in ("mlstm_old", "mlstm_new")]
        row["ms"] = timed(calls, args, order, {"bound": bound,
                                               "f32 bound": f32})
        log(f"  new / old {sum(row['ms']['mlstm_new']) / sum(row['ms']['mlstm_old']):.3f}")
        row["split_ms"] = {}
        for name in ("mlstm_old", "mlstm_new"):
            split = kernel_split(calls[name], args, "mlstm_bwd")
            row["split_ms"][name] = split
            log(f"  {name} by kernel (profiler: ms a launch, launches a "
                f"call): {json.dumps(split)}")
        if "mlstm_stamps" in libs:
            st = stamps(libs["mlstm_stamps"], calls["mlstm_stamps"], args,
                        WALK_PHASES)
            row["stamps"] = st
            log(f"  mlstm_stamps walk cycles a block by phase "
                f"{[round(x) for x in st['cycles_per_block']]} over "
                f"{st['blocks']} blocks; shares "
                f"{json.dumps({k: round(x, 3) for k, x in st['share'].items()})}")
        res[key] = row
        del args
        torch.cuda.empty_cache()
    return ok, res


def run_scan(libs: dict) -> tuple:
    ok, res = True, {}
    for label, b, s, d, n, u_dtype in SCAN_SHAPES:
        args = scan_args(b, s, d, n, u_dtype)
        want = selective_scan_bwd_ref(*args)
        # this tree's backward takes the tile states the forward kernel
        # keeps under a gradient (training's path); the parent's forms them
        *_, hs = mamba_ops.selective_scan_kernel(*args[:5], keep_states=True)
        calls = {k: scan_caller(v, None if "old" in k else hs)
                 for k, v in libs.items() if k.startswith("scan")}
        bound, by = cs.scan_bwd_bound_ms(b, s, d, n, args[4].element_size())
        key = f"{label} {b}x{s} D{d} N{n} u {cs._dname(u_dtype)}"
        log(f"== scan backward {key}: bound {bound:.6f} ms ({by})")
        row = {"shape": [b, s, d, n], "u_dtype": cs._dname(u_dtype),
               "bound_ms": bound, "bound_by": by, "checks": {}}
        for name, call in calls.items():
            row["checks"][name] = held(name, call, args, want, True)
            ok &= row["checks"][name]["ok"]
        del want
        order = ["scan_old", "scan_new", "scan_new", "scan_old"] + [
            x for x in calls if x not in ("scan_old", "scan_new")]
        row["ms"] = timed(calls, args, order, {"bound": bound})
        log(f"  new / old {sum(row['ms']['scan_new']) / sum(row['ms']['scan_old']):.3f}")
        row["split_ms"], row["stamps"] = {}, {}
        for name in ("scan_old", "scan_new"):
            split = kernel_split(calls[name], args, "mamba_scan_bwd")
            row["split_ms"][name] = split
            log(f"  {name} by kernel (profiler: ms a launch, launches a "
                f"call): {json.dumps(split)}")
        for name in calls:
            if name.startswith("scan_stamps"):
                st = stamps(libs[name], calls[name], args,
                            STAMP_PHASES if "old" in name else NEW_PHASES)
                row["stamps"][name] = st
                log(f"  {name} cycles a block by phase "
                    f"{[round(x) for x in st['cycles_per_block']]} over "
                    f"{st['blocks']} blocks; shares "
                    f"{json.dumps({k: round(x, 3) for k, x in st['share'].items()})}")
        res[key] = row
        del args, hs, calls
        torch.cuda.empty_cache()
    return ok, res


def run_fwd(libs: dict) -> tuple:
    """The forward scan's parent against this tree's, without the kept
    states (the serving path's call) and with them (training's)."""
    calls = {"fwd_old": fwd_caller(libs["fwd_old"], None),
             "fwd_new": fwd_caller(libs["fwd_new"], False),
             "fwd_new_keeping": fwd_caller(libs["fwd_new"], True)}
    ok, res = True, {}
    for label, b, s, d, n, u_dtype, state in FWD_SHAPES:
        args = cs.mamba_inputs(b, s, d, n, u_dtype, state)
        want = selective_scan_ref(*args)
        key = f"{label} {b}x{s} D{d} N{n} u {cs._dname(u_dtype)} {state}"
        log(f"== forward scan {key}")
        row = {"shape": [b, s, d, n], "u_dtype": cs._dname(u_dtype),
               "state": state, "checks": {}}
        base = calls["fwd_old"](*args)
        rtol, atol = cs.MAMBA_TOL
        for name, call in calls.items():
            got = call(*args)
            good = all(bool(((g - w).abs() <= atol + rtol * w.abs()).all())
                       for g, w in zip(got, want))
            same = all(torch.equal(g, x) for g, x in zip(got, base))
            log(f"  {name:16s} y and h_last within (rtol {rtol:g}, atol "
                f"{atol:g}) of the plain version: {good}; the parent's bits: "
                f"{same}")
            row["checks"][name] = {"plain_ok": good, "parents_bits": same}
            ok &= good
        del want, base
        row["ms"] = timed(calls, args, ["fwd_old", "fwd_new", "fwd_new",
                                        "fwd_old", "fwd_new_keeping"], {})
        log(f"  new / old {sum(row['ms']['fwd_new']) / sum(row['ms']['fwd_old']):.3f}")
        res[key] = row
        del args
        torch.cuda.empty_cache()
    return ok, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-mlstm", type=Path, required=True)
    ap.add_argument("--old-scan", type=Path, required=True)
    ap.add_argument("--old-fwd", type=Path, required=True)
    ap.add_argument("--old-include", type=Path, default=None)
    ap.add_argument("--build", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--json", type=Path,
                    default=ROOT / "build" / "ab" / "ab_recurrent_bwd.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 1
    card = cs.nvidia_smi()
    log(f"card: {card}")
    new_m = (_build.CSRC / "mlstm_bwd.cu").read_text()
    new_s = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    old_s = args.old_scan.read_text()
    sources = {"mlstm_old": args.old_mlstm.read_text(), "mlstm_new": new_m,
               "scan_old": old_s, "scan_new": new_s,
               "fwd_old": args.old_fwd.read_text(),
               "fwd_new": (_build.CSRC / "mamba_scan.cu").read_text()}
    # the 3xTF32 product lives in mlstm.cuh: the variant is a copy of the
    # header beside the source, which the source then includes
    hdr = substituted((_build.CSRC / "mlstm.cuh").read_text(), MLSTM_TF32X1,
                      "mlstm_tf32x1")
    if hdr is not None:
        args.build.mkdir(parents=True, exist_ok=True)
        (args.build / "mlstm_tf32x1.cuh").write_text(hdr)
        sources["mlstm_tf32x1"] = new_m.replace(
            '#include "mlstm.cuh"', '#include "mlstm_tf32x1.cuh"')
    for name, subs, _ in MLSTM_VARIANTS + [("mlstm_stamps", STAMPS_WALK,
                                            True)]:
        text = substituted(new_m, subs, name)
        if text is not None:
            sources[name] = text
    for name, base, subs in (("scan_stamps_old", old_s, STAMPS_OLD),
                             ("scan_stamps_new", new_s, STAMPS_NEW)):
        text = substituted(base, subs, name)
        if text is not None:
            sources[name] = text
    # the parents against their own headers, when given
    libs, reports = build(
        sources, args.build,
        lambda n: [args.old_include] if args.old_include is not None
        and n.endswith("_old") else [])
    if not {f"{k}_{v}" for k in ("mlstm", "scan", "fwd")
            for v in ("old", "new")} <= set(libs):
        log("a build failed")
        return 1
    ok_m, res_m = run_mlstm(libs)
    ok_s, res_s = run_scan(libs)
    ok_f, res_f = run_fwd(libs)
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps({"card": card, "ptxas": reports,
                                     "mlstm": res_m, "scan": res_s,
                                     "forward_scan": res_f}, indent=1))
    ok = ok_m and ok_s and ok_f
    log(f"checks {'passed' if ok else 'FAILED'}; wrote {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
