#!/usr/bin/env python3
"""The port's bf16 flash-attention backward kernel against its parent and
against variants of itself, on one NVIDIA card.

    python3 benchmarks/torch_flash_bwd_ab.py --old OLD.cu

``OLD.cu`` is an earlier ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
(``git show <commit>:src/repro_torch/kernels/csrc/flash_attention_bwd.cu >
OLD.cu``, written where the run can read it).  The script builds it, this
tree's source and text variants of this tree's source with ``nvcc`` (the
port's flags) under ``--build`` (default ``build/ab``, git-ignored), all at
once, and prints each build's ``ptxas`` report.  Then, at every bf16 entry
of ``chip_smoke.BWD_SHAPES``, it:

1. holds every build to the plain version (``attention_bwd_ref``) within
   ``chip_smoke.BWD_TOL``, two calls bitwise equal, and this tree's build
   also to the plain model of its arithmetic (``attention_bwd_tiles``)
   within ``chip_smoke.TILE_TOL``;
2. times old and new in turns (old, new, new, old) with
   ``chip_smoke.device_ms`` (CUDA-graph replay: the card's time alone), each
   variant once beside them, and ``scaled_dot_product_attention``'s
   backward under the same mask as ``chip_smoke.check_flash_bwd`` times it;
3. prints each time beside its bound (``chip_smoke.attn_bound_ms``:
   2 (3 dqk + 2 dv) FLOP a visible pair, 10 dh where q, k and v are dh
   wide, the five products), the rate of those five products
   in TFLOP/s, and the SFU floor of the exponentials (two a visible pair:
   the dK/dV and the dQ kernels each recompute P).

Every build is called through the same C interface as the wrapper calls
it (``flash_attention_bwd_bf16``), on contiguous inputs, and each build's
distance from the tile model is printed for dQ, dK and dV apart; a
profiler trace splits old's and new's time between their three kernels.
Variants (each keeps the arithmetic but ``exp2f``, so each is checked):

- ``kv_overlap``: dV's product issued before dS is formed, so that the
  two overlap (in the source both products issue once dS is formed,
  which keeps the dK/dV kernel within two blocks' registers at dh 64);
- ``exp2f``: ``exp2f`` for ``ex2.approx.ftz``;
- ``stages2``: rings of 2 stages at dh 64 and (96, 64) too (3 in the
  source).

Writes the results to ``--json`` (default ``build/ab/ab_flash_bwd.json``).
Needs the card; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from torch_ab_common import ROOT, build, kernel_split, log, substituted

sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_bwd_tiles,
)

BF16 = torch.bfloat16
VARIANTS = {
    "kv_overlap": [(
        "    hopper::wgmma_fence();\n"
        "    issue_frags_by_tile<BQ, DV>(dva, pa, dos, C::Q_PANEL);\n"
        "    issue_frags_by_tile<BQ, DQK>(dka, da, qs, C::Q_PANEL);\n",
        "    hopper::wgmma_fence();\n"
        "    issue_frags_by_tile<BQ, DQK>(dka, da, qs, C::Q_PANEL);\n"), (
        "    hopper::wgmma_wait<0>();\n    hopper::fence_regs(dpa);\n"
        "    // dS^T",
        "    hopper::wgmma_fence();\n"
        "    issue_frags_by_tile<BQ, DV>(dva, pa, dos, C::Q_PANEL);\n"
        "    hopper::wgmma_wait<1>();\n    hopper::fence_regs(dpa);\n"
        "    // dS^T"), (
        "    uint32_t pa[BQ / 16][4], da[BQ / 16][4];\n#pragma unroll\n"
        "    for (int i = 0; i < BQ / 2; i += 2) {\n"
        "      const float2 d =",
        "    uint32_t da[BQ / 16][4];\n#pragma unroll\n"
        "    for (int i = 0; i < BQ / 2; i += 2) {\n"
        "      const float2 d ="), (
        "      pa[i / 8][(i % 8) / 2] = pack_bf16(sa[i], sa[i + 1]);\n", ""), (
        "      sa[i] = p0;\n      sa[i + 1] = p1;\n",
        "      sa[i] = p0;\n      sa[i + 1] = p1;\n"
        "      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);\n"), (
        "    const bool edge = k0 + 64 > sk || q0 + BQ > sq ||",
        "    uint32_t pa[BQ / 16][4];\n"
        "    const bool edge = k0 + 64 > sk || q0 + BQ > sq ||")],
    "exp2f": [("= ex2(fmaf(", "= exp2f(fmaf(")],
    "stages2": [("STAGES = DQK == 128 ? 2 : 3;  // steps in the ring",
                 "STAGES = 2;  // steps in the ring"),
                ("STAGES = DQK == 128 ? 2 : 3;  // key tiles in the ring",
                 "STAGES = 2;  // key tiles in the ring")],
}
SHAPES = [s for s in cs.BWD_SHAPES if BF16 in s[-1]]


def sources(old: Path) -> dict:
    """The parent, this tree's source and its variants, by name."""
    text = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    out = {"old": old.read_text(), "new": text}
    for name, subs in VARIANTS.items():
        t = substituted(text, subs, name)
        if t is not None:
            out[name] = t
    return out


def caller(lib):
    """The backward through ``lib``'s C interface, as
    ``attention_bwd_kernel`` calls it on contiguous inputs."""
    fn = lib.flash_attention_bwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, o, lse, do, causal, window):
        b, sq, h, dh = q.shape
        sk, kvh, dvw = k.shape[1], k.shape[2], v.shape[3]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
                 kvh, dh, dvw, int(causal), int(window), dh ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd_bf16: error {err}")
        return dq, dk, dv
    return call


def inputs(b, sq, sk, h, kv, dh, dv, causal, window):
    """``chip_smoke.check_flash_bwd``'s inputs: the same seed, the forward
    kernel's output and log-sum-exp."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + sq + sk + h)
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device="cuda").to(BF16)
    q, k, v = rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dv)
    do = rnd(b, sq, h, dv)
    o, lse = flash_ops.attention_kernel(q, k, v, causal, window,
                                        with_lse=True)
    return q, k, v, o, lse, do


def sdpa_bwd_ms(q, k, v, do, causal, window) -> float:
    """``scaled_dot_product_attention``'s backward on the card alone, as
    ``chip_smoke.check_flash_bwd`` times it."""
    sq, sk, h, kv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if causal and sq == sk and not window:
        mask = dict(is_causal=True)
    elif not causal and not window:
        mask = {}
    else:
        mask = dict(attn_mask=cs._end_aligned_mask(sq, sk, causal, window,
                                                   "cuda"))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=h != kv, **mask)
    dot = do.transpose(1, 2)
    return cs.device_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), 5) - cs.device_ms(sdpa, 5)


def run(libs: dict) -> tuple:
    calls = {name: caller(lib) for name, lib in libs.items()}
    ok, res = True, {}
    order = ["old", "new", "new", "old"]
    for label, b, sq, sk, h, kv, dh, dv, causal, window, _ in SHAPES:
        args = inputs(b, sq, sk, h, kv, dh, dv, causal, window)
        want = cs.by_rows(attention_bwd_ref, *args, causal, window)
        model = cs.by_rows(attention_bwd_tiles, *args, causal, window)
        pairs = cs.visible_pairs(sq, sk, causal, window)
        flop = 2.0 * b * h * (3 * dh + 2 * dv) * pairs
        bound, by = cs.attn_bound_ms(
            (2 * b * sq * h + 2 * b * sk * kv) * (dh + dv) * 2
            + 4 * b * h * sq, flop, BF16)
        sfu = 2.0 * b * h * pairs / cs.SFU_EX2_PER_S * 1e3
        key = f"{label} {b}x{sq}x{sk} H{h}/{kv} dh{dh} dv{dv}"
        log(f"== {key} causal={int(causal)} window={window}: bound "
            f"{bound:.6f} ms ({by}), SFU floor {sfu:.6f} ms")
        row = {"bound_ms": bound, "bound_by": by, "flop": flop,
               "sfu_floor_ms": sfu, "shape": [b, sq, sk, h, kv, dh, dv],
               "causal": causal, "window": window}
        for name, call in calls.items():
            got = call(*args, causal, window)
            again = call(*args, causal, window)
            torch.cuda.synchronize()
            ratio = cs.bwd_ratio(got, want, BF16)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            # beyond one rounding of the tile model, each of dq, dk, dv
            tile = [cs.tile_excess([g], [m]) for g, m in zip(got, model)]
            log(f"  {name:11s} x the gate {ratio:.3f} "
                f"{'ok' if ratio <= 1 else 'FAIL'}; repeatable {same}; "
                f"beyond one rounding of the tile model (dq, dk, dv) "
                f"{', '.join(f'{x:.2e}' for x in tile)} (gate "
                f"{cs.TILE_TOL:g}, held by new)")
            good = ratio <= 1 and same
            if name == "new":
                good &= max(tile) <= cs.TILE_TOL
                row["tile_excess"] = tile
            ok &= good
            del got, again
        del want, model
        times: dict = {}
        for name in order + [v for v in calls if v not in ("old", "new")]:
            call = calls[name]
            ms = cs.device_ms(lambda: call(*args, causal, window), 5)
            times.setdefault(name, []).append(ms)
            log(f"  {name:11s} {ms:.4f} ms, x bound {ms / bound:.2f}, "
                f"{flop / ms / 1e9:.1f} TFLOP/s")
        lib_ms = sdpa_bwd_ms(args[0], args[1], args[2], args[5], causal,
                             window)
        log(f"  sdpa backward {lib_ms:.4f} ms; new / old "
            f"{sum(times['new']) / sum(times['old']):.3f}, new / sdpa "
            f"{min(times['new']) / lib_ms:.2f}")
        row["split_ms"] = {}
        for name in ("old", "new"):
            split = kernel_split(lambda *a: calls[name](*a, causal, window),
                                 args, r"bwd_(?:dsum|dkdv|dq)")
            row["split_ms"][name] = split
            log(f"  {name} by kernel (profiler: ms a launch, launches a "
                f"call): {json.dumps(split)}")
        row["ms"] = times
        row["library_ms"] = lib_ms
        res[key] = row
        del args
        torch.cuda.empty_cache()
    return ok, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--build", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--json", type=Path,
                    default=ROOT / "build" / "ab" / "ab_flash_bwd.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 1
    card = cs.nvidia_smi()
    log(f"card: {card}")
    libs, reports = build(sources(args.old), args.build)
    if "new" not in libs or "old" not in libs:
        log("a build failed")
        return 1
    ok, res = run(libs)
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps({"card": card, "ptxas": reports,
                                     "results": res}, indent=1))
    log(f"checks {'passed' if ok else 'FAILED'}; wrote {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
