"""Benchmark harness of the port: one section per paper table/figure, in
the reference's order (``benchmarks/run.py``), each on ``--device``
(default: the card; ``--device cpu`` runs the plain PyTorch paths).

Prints ``name,us_per_call,derived`` CSV and, after each section, a
``# section <name>: <s> s`` line with its wall time.  Sections:
  - throughput_fig7     (Fig 7: throughput across demand matrices)
  - bound_fig8a/b       (Fig 8: convergence to (k-1)/k)
  - fct_fig5            (Fig 5/6: FCT + utilization, websearch)
  - adaptive            (closed estimation->schedule loop, phase shifts)
  - twohop              (two-hop relay planes, CPU vs device)
  - schedule_time_fig10 (Fig 10: schedule computation latency)
  - interconnect        (pod-axis collective pricing)

The reference's ``roofline`` section reads XLA HLO and a TPU cost model
(``benchmarks/analytic.py``); it waits on the port of the dryrun
launcher (ROADMAP queue 1, item 10) and is left out.

Persists, under ``--out`` (default ``chiprun_out/bench/``, git-ignored):
  - BENCH_schedule.json — construction latency per method per n
    (per-stage breakdown + hk/euler end-to-end speedup)
  - BENCH_adaptive.json — closed-loop utilization, with and without
    construction charging, the epoch-length x reconfiguration-penalty
    tradeoff grid, the gather-staleness -> schedule-disagreement ->
    utilization sweep, the fault-injection recovery sweep (fault type x
    severity x policy, with per-epoch utilization recovery curves), and
    ``device_speedup`` (the CPU's run against the device's on the
    disagreement grid, with per-flow FCT percentiles from the device's
    rows)
  - BENCH_twohop.json — two-hop relay planes' wall clock per
    (n, mode, device), CPU vs device (min-of-N)

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu] \\
        [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from ..device import resolve_device

OUT = pathlib.Path("chiprun_out") / "bench"


def _adaptive_row_json(row) -> dict:
    r = row.result
    return {
        "label": row.label,
        "policy": row.policy,
        "utilization": r.utilization,
        "completed_frac": r.completed_frac,
        "recomputes": row.recomputes,
        "stale_slots": row.stale_slots,
        "dark_slots": row.dark_slots,
        "construction_s": row.construction_s,
        "mean_disagreement": float(row.epoch_disagreement.mean()),
        "mean_collision_loss": float(row.epoch_collision_loss.mean()),
        "collision_lost_bits": row.collision_lost_bits,
        "schedule_groups_max": row.schedule_groups_max,
        "fault_lost_bits": row.fault_lost_bits,
        "fault_refused_bits": row.fault_refused_bits,
        "dark_plane_slots": row.dark_plane_slots,
        "excised_nodes": row.excised_nodes,
        "excised_planes": row.excised_planes,
        "epoch_utilization": [round(float(u), 6)
                              for u in row.epoch_utilization],
        "sim_s": row.sim_s,
        "meta": row.meta,
    }


def main(argv: list[str] | None = None) -> dict:
    from . import (
        adaptive_bench,
        bound_convergence,
        fct_bench,
        interconnect_bench,
        schedule_time,
        throughput_bench,
    )

    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", type=pathlib.Path, default=OUT,
                    help="directory for the BENCH_*.json files")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dev_args = ["--device", dev.type]
    seconds: dict[str, float] = {}

    def section(name: str, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"# section {name}: {seconds[name]:.3f} s")
        sys.stdout.flush()
        return out

    section("throughput_fig7", lambda: throughput_bench.main(dev_args))
    section("bound_fig8", bound_convergence.main)
    section("fct_fig5", lambda: fct_bench.main(dev_args))
    (adaptive_rows, charged_rows, tradeoff_rows, disagreement_rows,
     fault_rows, device_speedup) = section(
        "adaptive", lambda: adaptive_bench.main(dev_args))
    twohop_rows = section("twohop", lambda: fct_bench.twohop_table(device=dev))
    sched_rows = section("schedule_time_fig10",
                         lambda: schedule_time.main(dev_args))
    section("interconnect", lambda: interconnect_bench.main(dev_args))

    args.out.mkdir(parents=True, exist_ok=True)
    payloads = {
        "BENCH_schedule.json": sched_rows,
        "BENCH_adaptive.json": {
            "sweep": [_adaptive_row_json(r) for r in adaptive_rows],
            "charged": [_adaptive_row_json(r) for r in charged_rows],
            "epoch_tradeoff": [_adaptive_row_json(r) for r in tradeoff_rows],
            "disagreement": [_adaptive_row_json(r)
                             for r in disagreement_rows],
            "faults": [_adaptive_row_json(r) for r in fault_rows],
            "device_speedup": device_speedup,
        },
        "BENCH_twohop.json": twohop_rows,
    }
    for name, obj in payloads.items():
        (args.out / name).write_text(json.dumps(obj, indent=2) + "\n")
    print("# sections (s): " + json.dumps(seconds))
    return {"seconds": seconds, **payloads}


if __name__ == "__main__":
    main()
