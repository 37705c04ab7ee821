#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from a checkout on a machine with an NVIDIA Hopper card and ``nvcc``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, drives
the port's main path once at full size — Vermilion schedules built with
``normalize="saturate"`` (Sinkhorn on the card), then a batched single-hop
sweep whose data plane runs on the card, with per-flow FCTs from the host
credit replay — and checks the card's result against the port's CPU run
of the same schedules.  Any failure raises: no phase is caught.

The deployment: n = 256 ToRs, d_hat = 8 uplinks, k = 3, recfg_frac = 1/9,
100 Gb/s links with 4.5 us slots; websearch traffic (DCTCP CDF),
rack-permutation, at loads 0.15 / 0.3 / 0.45 / 0.6, 2000 slots, seed 1.

Output: readable lines, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a card or outside a checkout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core.schedule import vermilion_schedule  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    SweepCase,
    run_sweep,
    websearch_workload,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops  # noqa: E402
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref  # noqa: E402

N, D_HAT, K, RECFG = 256, 8, 3, 1 / 9
BITS_PER_SLOT = 100e9 * 4.5e-6
LOADS = (0.15, 0.3, 0.45, 0.6)
HORIZON, SEED = 2000, 1

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# non-tensor-core f32 / f64 rates
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# kernel vs plain tolerances: f32 as in tests/test_kernels.py (reduction
# order only), f64 near its precision (200 iterations of it)
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 0.0)}

# card vs CPU FCTs: CUDA index_add_ adds several arrivals of one pair in
# one slot in a varying order; the drain reconciliation absorbs most such
# ulp residues, not every one
FCT_MAX_DIFF_FRAC, FCT_MAX_DIFF_SLOTS = 1e-3, 1.0

TRACE_ACTIVITIES = (ProfilerActivity.CPU, ProfilerActivity.CUDA)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    from CUDA events, after ``warm`` unmeasured calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sinkhorn_bound_ms(n: int, iters: int, dtype: torch.dtype) -> tuple:
    """Least time for the work on this card: bytes (input read once,
    output written once) over HBM rate vs ~4 iters n^2 operations over the
    type's peak.  Returns (ms, "bytes" | "operations")."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = 2 * n * n * size / HBM_BPS
    t_ops = 4 * iters * n * n / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def saturate_input(n: int, load: float) -> np.ndarray:
    """What ``saturate`` hands the kernel on the main path: the websearch
    demand matrix with nonpositive entries clamped to 1e-12."""
    m = websearch_workload(n, load, HORIZON, BITS_PER_SLOT, d_hat=D_HAT,
                           seed=SEED).demand_matrix()
    return np.where(m <= 0, 1e-12, m)


def check_kernel(m: torch.Tensor, iters: int, eps: float, reps: int,
                 plain_reps: int) -> dict:
    n, dtype = m.shape[0], m.dtype
    got = sinkhorn_ops.sinkhorn_kernel(m, iters=iters, eps=eps)
    torch.cuda.synchronize()
    want = sinkhorn_ref(m, iters=iters, eps=eps)
    again = sinkhorn_ops.sinkhorn_kernel(m, iters=iters, eps=eps)
    err = (got - want).abs()
    rtol, atol = TOL[dtype]
    max_abs = float(err.max())
    max_rel = float((err / want.abs()).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    same = bool(torch.equal(got, again))
    ms = time_ms(lambda: sinkhorn_ops.sinkhorn_kernel(m, iters, eps), reps)
    plain_ms = time_ms(lambda: sinkhorn_ref(m, iters, eps), plain_reps)
    bound_ms, bound_by = sinkhorn_bound_ms(n, iters, dtype)
    name = str(dtype).replace("torch.", "")
    log(f"  {name:8s} n={n:5d} iters={iters:3d}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (rtol {rtol:g}, atol {atol:g}) "
        f"{'ok' if ok else 'FAIL'}; deterministic={same}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"sinkhorn kernel disagrees with its plain "
                             f"version: {name} n={n}")
    if not same:
        raise AssertionError(f"sinkhorn kernel is not deterministic: "
                             f"{name} n={n}")
    return {"dtype": name, "n": n, "iters": iters, "max_abs_err": max_abs,
            "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device 0: {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ----------------------------------------------------------
    log("== build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    infos = _build.build_all()
    log(f"  build wall {time.perf_counter() - t0:.2f} s")
    for info in infos:
        log(f"  {info.name}: {'built' if info.built else 'cached'} "
            f"in {info.seconds:.2f} s -> {info.path.name}")
        for line in info.ptxas.splitlines():
            log(f"    {line}")

    # -- 2. each kernel against its plain version --------------------------
    log("== sinkhorn kernel vs plain PyTorch version on the card")
    rng = np.random.default_rng(SEED)
    f32 = []
    for n in (64, 250, 256, 512, 1024):
        m = torch.from_numpy(rng.random((n, n)) + 0.01).to(
            "cuda", torch.float32)
        f32.append(check_kernel(m, iters=20, eps=1e-12, reps=50,
                                plain_reps=10))
    f64 = []
    for n in (250, 256):
        m = torch.from_numpy(saturate_input(n, 0.3)).to("cuda")
        f64.append(check_kernel(m, iters=200, eps=0.0, reps=20,
                                plain_reps=5))
    main_shape = f64[-1]                    # n = 256, iters 200: saturate
    log("  no single PyTorch call computes Sinkhorn: library time n/a")

    # -- 3. the main path at full size --------------------------------------
    log(f"== main path: n={N}, d_hat={D_HAT}, k={K}, loads {LOADS}, "
        f"{HORIZON} slots, seed {SEED}")
    sinkhorn_ops.reset_launches()
    phases = {}
    t0 = time.perf_counter()
    wls = [websearch_workload(N, load, HORIZON, BITS_PER_SLOT, d_hat=D_HAT,
                              seed=SEED) for load in LOADS]
    phases["workloads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheds = [vermilion_schedule(wl.demand_matrix(), k=K, d_hat=D_HAT,
                                 recfg_frac=RECFG, normalize="saturate")
              for wl in wls]
    phases["schedules_s"] = time.perf_counter() - t0
    cases = [SweepCase(s, wl, "single_hop", f"vermilion@{load}",
                       {"load": load})
             for s, wl, load in zip(scheds, wls, LOADS)]
    timings: dict = {}
    t0 = time.perf_counter()
    rows = run_sweep(cases, BITS_PER_SLOT, device="cuda", sanitize=True,
                     timings=timings)
    phases["sweep_s"] = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    flows = sum(wl.num_flows for wl in wls)
    log(f"  flows {flows}, sinkhorn launches {launches}")
    if launches != len(LOADS):
        raise AssertionError(f"main path launched the sinkhorn kernel "
                             f"{launches} times (expected {len(LOADS)})")
    for r in rows:
        res = r.result
        fin = np.isfinite(res.fct_slots)
        if not fin.any() or not np.isfinite(res.utilization):
            raise AssertionError(f"{r.label}: no finite result")
        log(f"  {r.label}: util {res.utilization:.6f}, delivered "
            f"{res.delivered_bits:.6e} b of {res.offered_bits:.6e}, "
            f"completed {res.completed_frac:.6f}, FCT p50 "
            f"{res.fct_percentile(50):.3f} p99 {res.fct_percentile(99):.3f} "
            f"slots")
    per_slot_us = timings["device_loop_s"] / timings["slots"] * 1e6
    for key, val in {**phases, **timings}.items():
        log(f"  phase {key}: {val:.6f}" if key != "slots"
            else f"  slots served {val}")
    log(f"  device slot loop: {per_slot_us:.3f} us per slot")

    # -- 4. the card's result against the port's CPU run -------------------
    log("== card vs CPU on the same schedules")
    t0 = time.perf_counter()
    rows_cpu = run_sweep(cases, BITS_PER_SLOT, device="cpu", sanitize=True)
    log(f"  CPU sweep {time.perf_counter() - t0:.3f} s")
    for a, b in zip(rows, rows_cpu):
        ra, rb = a.result, b.result
        rel = abs(ra.delivered_bits - rb.delivered_bits) / rb.delivered_bits
        fa, fb = ra.fct_slots, rb.fct_slots
        differ = ~((fa == fb) | (np.isnan(fa) & np.isnan(fb)))
        n_diff = int(differ.sum())
        max_diff = float(np.abs(fa[differ] - fb[differ]).max()) \
            if n_diff else 0.0
        log(f"  {a.label}: delivered rel diff {rel:.3e}; FCTs differ on "
            f"{n_diff} of {len(fa)} flows, by at most {max_diff} slots")
        if rel > 1e-5:
            raise AssertionError(f"{a.label}: delivered bits differ by "
                                 f"{rel:.3e} (rtol 1e-5)")
        if n_diff > FCT_MAX_DIFF_FRAC * len(fa) \
                or max_diff > FCT_MAX_DIFF_SLOTS:
            raise AssertionError(f"{a.label}: FCTs differ on {n_diff} flows "
                                 f"by up to {max_diff} slots")
    t0 = time.perf_counter()
    scheds_cpu = [vermilion_schedule(wl.demand_matrix(), k=K, d_hat=D_HAT,
                                     recfg_frac=RECFG, normalize="saturate",
                                     device="cpu") for wl in wls]
    same = [bool(np.array_equal(a.perms, b.perms))
            for a, b in zip(scheds, scheds_cpu)]
    log(f"  schedules rebuilt on the CPU in "
        f"{time.perf_counter() - t0:.3f} s; perms equal to the card's: "
        f"{same}")

    # -- 5. a traced rerun: where the data plane's time goes on the card ---
    log("== traced rerun of the card sweep (torch.profiler)")
    traced: dict = {}
    t0 = time.perf_counter()
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        run_sweep(cases, BITS_PER_SLOT, device="cuda", timings=traced)
    traced_s = time.perf_counter() - t0
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in on_dev if e.name.startswith(("Memcpy", "Memset"))]
    kern = [e for e in on_dev if not e.name.startswith(("Memcpy", "Memset"))]
    log(f"  traced sweep {traced_s:.6f} s (untraced {phases['sweep_s']:.6f} "
        f"s); traced device loop {traced['device_loop_s']:.6f} s")
    if kern:
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
        copy = sum(e.time_range.elapsed_us() for e in copies) / 1e6
        log(f"  data plane: {len(kern)} kernels "
            f"({len(kern) / traced['slots']:.3f} per slot), device busy "
            f"{busy:.6f} s of the {traced['device_loop_s']:.6f} s loop "
            f"(idle share {1 - busy / traced['device_loop_s']:.4f}); "
            f"copies {copy:.6f} s")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")

    # -- 6. results -----------------------------------------------------------
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(f"f32 instances: {json.dumps(f32)}")
    kernels = [{
        "name": "sinkhorn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sinkhorn.cu",
        "replaces": "src/repro/kernels/sinkhorn/sinkhorn.py:39",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "dtype": main_shape["dtype"],
        "n": main_shape["n"],
        "iters": main_shape["iters"],
    }]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
