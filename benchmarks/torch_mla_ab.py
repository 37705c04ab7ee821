#!/usr/bin/env python3
"""The port's bf16 MLA latent attention kernels against their parent and
against timing variants of themselves, on one NVIDIA card.

    python3 benchmarks/torch_mla_ab.py --old OLD.cu

``OLD.cu`` is an earlier ``src/repro_torch/kernels/csrc/mla_attention.cu``
(``git show <commit>:src/repro_torch/kernels/csrc/mla_attention.cu >
OLD.cu``, written where the run can read it).  The script builds it, this
tree's source and text variants of this tree's source with ``nvcc`` (the
port's flags) under ``--build`` (default ``build/ab``, git-ignored), all at
once, and prints each build's ``ptxas`` report.  Then it:

1. holds every build to the plain versions (``mla_prefill_ref``,
   ``mla_decode_ref``) within ``chip_smoke.ATTN_TOL`` at the timed shapes,
   two calls bitwise equal;
2. times old and new in turns (old, new, new, old) with
   ``chip_smoke.device_ms`` (CUDA-graph replay: the card's time alone) at
   the served shapes: prefill 1 x 5000 and 1 x 1000 at H 40, decode at 8
   and 10 lanes of a cache of 8192 (the 10 lanes are ``chip_smoke``'s
   served decode, 26,714 visible rows); each variant once beside them;
3. prints each time beside its bound (``chip_smoke.attn_bound_ms``) and
   the achieved TFLOP/s.

The old source is called through the same C interface with its own split
plan (:func:`old_split_plan`, that of the 32-key-tile kernel: the blocks
fill the SMs twice).  Variants (each keeps the arithmetic, so each is checked):

- ``no_turns``: the prefill's two warpgroups issue their products without
  taking turns (no named barriers);
- ``prefill_st3``: the prefill's ring of 3 stages (4 in the source);
- ``decode_1x4``: the decode's ring of 4 stages and one block an SM (2 and
  two in the source), its split plan filling the SMs once;
- ``rescale_always``: O takes every tile's factors (the source skips them
  in warps where no row's max moved).

Writes the results to ``--json`` (default ``build/ab/ab_mla.json``).
Needs the card; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.mla_attention import ops  # noqa: E402
from repro_torch.kernels.mla_attention.ref import (  # noqa: E402
    mla_decode_ref,
    mla_prefill_ref,
)

BF16 = torch.bfloat16
SCALE = cs.MLA_SCALE
VARIANTS = {
    "no_turns": [("constexpr bool TURNS = NWG == 2;",
                  "constexpr bool TURNS = false;")],
    "prefill_st3": [("STAGES = NWG == 2 ? 4 : 2;", "STAGES = NWG == 2 ? 3 : 2;")],
    "decode_1x4": [("STAGES = NWG == 2 ? 4 : 2;", "STAGES = NWG == 2 ? 4 : 4;"),
                   ("MIN_BLOCKS = NWG == 2 ? 1 : 2;", "MIN_BLOCKS = 1;")],
}
VARIANTS["rescale_always"] = [(
    "      if (__any_sync(0xffffffffu, al[0] != 1.f || al[1] != 1.f)) {",
    "      {")]
PLANS = {"old": lambda b, h, s, sms: old_split_plan(b, h, s, sms),
         "decode_1x4": lambda b, h, s, sms: ops.split_plan(b, h, s, sms // 2)}
PREFILLS = [(1, 5000), (1, 1000)]
DECODES = {"8 lanes": [4200, 4800, 5400, 6000, 128, 400, 700, 1024],
           "10 lanes": [-1, 0, 1, 63, 64, 100, 4095, 6000, 8191, 8291]}
S, H = 8192, 40


def log(msg: str = "") -> None:
    print(msg, flush=True)


def old_split_plan(batch: int, h: int, s: int, sms: int) -> int:
    """The 32-key-tile kernel's plan: the blocks (a lane, a split, 64
    heads) fill the SMs about twice, capped by the cache's 32-key tiles."""
    blocks = batch * -(-h // 64)
    return max(1, min(-(-2 * sms // max(1, blocks)), -(-s // 32)))


def build(old: Path, out: Path) -> dict:
    """Every source built at once; returns the loaded libraries by name."""
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    text = (_build.CSRC / "mla_attention.cu").read_text()
    sources = {"old": old.read_text(), "new": text}
    for name, subs in VARIANTS.items():
        t = text
        for a, b in subs:
            if a not in t:
                raise SystemExit(f"variant {name}: anchor not in the source: "
                                 f"{a[:60]!r}")
            t = t.replace(a, b)
        sources[name] = t
    procs = {}
    for name, t in sources.items():
        (out / f"mla_{name}.cu").write_text(t)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"mla_{name}.so"), str(out / f"mla_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        report, _ = p.communicate()
        log(f"== nvcc {name}: rc {p.returncode}")
        for line in report.splitlines():
            if ("error" in line.lower() or "warning" in line.lower()
                    or "Used" in line or "Compiling entry" in line
                    or ("spill" in line and " 0 bytes spill stores" not in line)):
                log(f"  {line.strip()}")
        if p.returncode == 0:
            libs[name] = ctypes.CDLL(str(out / f"mla_{name}.so"))
    log(f"build wall {time.perf_counter() - t0:.1f} s")
    return libs


def callers(lib, plan):
    """(prefill, decode) through ``lib``'s C interface, as
    ``ops.mla_prefill_kernel`` / ``ops.mla_decode_kernel`` call theirs;
    decode's scratch is allocated here, outside the timed calls."""
    pf, df = lib.mla_prefill_bf16, lib.mla_decode_bf16
    pf.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    df.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    pf.restype = df.restype = ctypes.c_int
    scratch = {}

    def prefill(ql, qr, c, kr):
        st = ops._check(ql, qr, c, kr, SCALE)
        b, sq, h, r = ql.shape
        out = torch.empty_like(ql)
        err = pf(ql.data_ptr(), qr.data_ptr(), c.data_ptr(), kr.data_ptr(),
                 out.data_ptr(), b, sq, c.shape[1], h, r, ops.ROPE,
                 (ctypes.c_longlong * 10)(*st), SCALE,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"prefill: CUDA error {err}")
        return out

    def decode(ql, qr, c, kr, length):
        st = ops._check(ql, qr, c, kr, SCALE)
        b, _, h, r = ql.shape
        s = c.shape[1]
        ns = plan(b, h, s, decode_ops.sm_count(ql.device))
        key = (b, h, ns)
        if key not in scratch:
            scratch[key] = (torch.empty(b, h, ns, 2, device="cuda"),
                            torch.empty(b, h, ns, r, device="cuda"))
        ml, acc = scratch[key]
        out = torch.empty_like(ql)
        err = df(ql.data_ptr(), qr.data_ptr(), c.data_ptr(), kr.data_ptr(),
                 length.data_ptr(), out.data_ptr(), ml.data_ptr(),
                 acc.data_ptr(), b, s, h, r, ops.ROPE, ns,
                 (ctypes.c_longlong * 10)(*st), SCALE,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode: CUDA error {err}")
        return out
    return prefill, decode


def held(label, got, again, want) -> bool:
    diff = (got.float() - want.float()).abs()
    tol = cs.ATTN_TOL[BF16]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    same = torch.equal(got, again)
    log(f"  {label}: max_abs_err {float(diff.max()):.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}; repeatable {same}")
    return ok and same


def prefill_bound(sq: int, sk: int) -> tuple:
    pairs = cs.visible_pairs(sq, sk, True, 0)
    flop = 2.0 * H * pairs * (2 * ops.LATENT + ops.ROPE)
    return flop, *cs.attn_bound_ms(
        (sq * H * (2 * ops.LATENT + ops.ROPE)
         + sk * (ops.LATENT + ops.ROPE)) * 2, flop, BF16)


def decode_bound(lens: list) -> tuple:
    rows = sum(hi - lo for lo, hi in (cs.visible_range(x, S, 0) for x in lens))
    flop = 2.0 * rows * H * (2 * ops.LATENT + ops.ROPE)
    return flop, *cs.attn_bound_ms(
        rows * (ops.LATENT + ops.ROPE) * 2
        + len(lens) * H * (2 * ops.LATENT + ops.ROPE) * 2 + 4 * len(lens),
        flop, BF16)


def run(libs: dict) -> tuple:
    calls = {name: callers(lib, PLANS.get(name, ops.split_plan))
             for name, lib in libs.items()}
    ok, res = True, {}
    order = ["old", "new", "new", "old"]
    for b, n in PREFILLS:
        ql, qr, c, kr = cs.mla_inputs(b, n, n, H, BF16, cs.SEED + n)
        want = mla_prefill_ref(ql, qr, c, kr, SCALE)
        flop, bound, by = prefill_bound(n, n)
        key = f"prefill 1 x {n} H {H}"
        log(f"== {key}: bound {bound:.6f} ms ({by})")
        row = {"bound_ms": bound, "bound_by": by, "flop": flop}
        for name, (pf, _) in calls.items():
            ok &= held(f"{name:12s}", pf(ql, qr, c, kr), pf(ql, qr, c, kr),
                       want)
        times: dict = {}
        for name in order + [v for v in calls if v not in ("old", "new")]:
            pf = calls[name][0]
            ms = cs.device_ms(lambda: pf(ql, qr, c, kr), 5 if n > 2000 else 20)
            times.setdefault(name, []).append(ms)
            log(f"  {name:12s} {ms:.4f} ms, x bound {ms / bound:.2f}, "
                f"{flop / ms / 1e9:.1f} TFLOP/s")
        row["ms"] = times
        res[key] = row
    for key, lens in DECODES.items():
        ql, qr, c, kr = cs.mla_inputs(len(lens), 1, S, H, BF16,
                                      cs.SEED + len(lens))
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = mla_decode_ref(ql, qr, c, kr, length, SCALE)
        flop, bound, by = decode_bound(lens)
        key = f"decode {key} of {S} H {H}"
        log(f"== {key}: lengths {lens}, bound {bound:.6f} ms ({by})")
        row = {"bound_ms": bound, "bound_by": by, "lengths": lens}
        for name, (_, df) in calls.items():
            ok &= held(f"{name:12s}", df(ql, qr, c, kr, length),
                       df(ql, qr, c, kr, length), want)
        times = {}
        for name in order + [v for v in calls if v not in ("old", "new")]:
            df = calls[name][1]
            ms = cs.device_ms(lambda: df(ql, qr, c, kr, length), 50)
            times.setdefault(name, []).append(ms)
            log(f"  {name:12s} {ms:.4f} ms, x bound {ms / bound:.2f}")
        row["ms"] = times
        res[key] = row
    return ok, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--build", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--json", type=Path,
                    default=ROOT / "build" / "ab" / "ab_mla.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 1
    card = cs.nvidia_smi()
    log(f"card: {card}")
    libs = build(args.old, args.build)
    if "new" not in libs or "old" not in libs:
        log("a build failed")
        return 1
    ok, res = run(libs)
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps({"card": card, "results": res}, indent=1))
    log(f"checks {'passed' if ok else 'FAILED'}; wrote {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
