"""Paper Fig 5 + Fig 6: flow completion times and link utilization for the
websearch workload, 5%..70% load, all systems.  The port of
``benchmarks/fct_bench.py``.

The whole load x system grid goes through
:func:`repro_torch.core.simulator.run_sweep` in one call on ``device``
(``None``: the card): the single-hop systems (Vermilion, the greedy
matching baseline, single-hop on the oblivious round-robin) through the
``singlehop`` plane, rotorlb / vlb through the two-hop relay planes, each
batch on the route the reference takes (per-flow FCTs where the relay
attribution fits).  Every Vermilion schedule is ``normalize="saturate"``:
one Sinkhorn launch per load on the card.

:func:`timing_table` times the port's CPU run against its run on
``device`` per group (single-hop, two-hop, all); the reference times its
pre-vectorization scalar engine against the new one instead, an oracle the
port keeps no copy of.  :func:`twohop_table` times the two-hop relay
planes CPU against ``device`` per (n, mode) with min-of-N wall clocks, the
rows ``repro_torch.benchmarks.run`` persists to ``BENCH_twohop.json``; the
reference's jit compile-cache counters have no counterpart in the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.fct_bench \\
        [--n 8 --horizon 300 --timing-n 24 | --no-timing] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.schedule import (
    greedy_matching_schedule,
    oblivious_schedule,
    vermilion_schedule,
)
from ..core.simulator import SweepCase, run_sweep, websearch_workload
from ..device import resolve_device

RECFG = 1 / 9
BITS_PER_SLOT = 100e9 * 4.5e-6          # 100G links, 4.5us slots (paper)
SHORT = 100e3 * 8                        # <=100KB flows
LONG = 1e6 * 8                           # >1MB flows
LOADS = (0.05, 0.15, 0.3, 0.45, 0.6, 0.7)


def build_grid(n: int, d_hat: int, horizon: int, loads=LOADS,
               seed: int = 1, device=None) -> list[SweepCase]:
    """The benchmark's load x system grid as sweep cases; each load's
    saturate Vermilion schedule is projected on ``device``."""
    cases = []
    obl = oblivious_schedule(n, d_hat=d_hat, recfg_frac=RECFG)
    for load in loads:
        wl = websearch_workload(n, load, horizon, BITS_PER_SLOT,
                                d_hat=d_hat, seed=seed)
        m = wl.demand_matrix()
        systems = {
            "vermilion": (vermilion_schedule(
                m, k=3, d_hat=d_hat, recfg_frac=RECFG,
                normalize="saturate", device=device), "single_hop"),
            "greedy": (greedy_matching_schedule(
                m, n_matchings=3 * n, d_hat=d_hat, recfg_frac=RECFG),
                "single_hop"),
            "rotorlb": (obl, "rotorlb"),
            "vlb": (obl, "vlb"),
            "obl-singlehop": (obl, "single_hop"),
        }
        for name, (sched, mode) in systems.items():
            cases.append(SweepCase(
                sched=sched, wl=wl, mode=mode, label=name,
                meta={"load": load}))
    return cases


def run(n: int = 16, d_hat: int = 4, horizon: int = 4000,
        loads=LOADS, seed: int = 1, device=None,
        sweep_rows: list | None = None) -> list[dict]:
    """The Fig. 5/6 rows, grid and sweep on ``device``.  ``sweep_rows``, a
    list, receives the sweep's :class:`SweepRow` objects."""
    dev = resolve_device(device)
    srs = run_sweep(build_grid(n, d_hat, horizon, loads, seed, device=dev),
                    BITS_PER_SLOT, device=dev)
    if sweep_rows is not None:
        sweep_rows.extend(srs)
    rows = []
    for sr in srs:
        r = sr.result
        rows.append({
            "system": sr.label, "load": sr.meta["load"],
            "device": dev.type,
            "p99_short": r.fct_percentile(99, short_cutoff=SHORT),
            "p99_long": r.fct_percentile(99, long_cutoff=LONG),
            "p50_short": r.fct_percentile(50, short_cutoff=SHORT),
            "util": r.utilization,
            "done": r.completed_frac,
            "hops": r.avg_hops,
            "us": sr.sim_s * 1e6,
        })
    return rows


def twohop_table(ns=(32, 64, 128, 256), d_hat: int = 2, horizon: int = 300,
                 load: float = 0.4, repeats: int = 3, seed: int = 1,
                 device=None) -> list[dict]:
    """Two-hop relay planes' wall clock per (n, mode, device), min-of-N:
    the CPU's run, then ``device``'s, warmed up once per shape so that the
    minimum leaves out first-call costs.  Rows feed ``BENCH_twohop.json``;
    ``speedup_vs_cpu`` is the CPU's minimum over the row's."""
    dev = resolve_device(device)
    rows = []
    print(f"# twohop engine timing: websearch uniform load={load} "
          f"d_hat={d_hat} horizon={horizon} (min of {repeats})")
    print("name,us_per_call,derived")
    for n in ns:
        wl = websearch_workload(n, load, horizon, BITS_PER_SLOT,
                                d_hat=d_hat, seed=seed, pattern="uniform")
        sched = oblivious_schedule(n, d_hat=d_hat, recfg_frac=RECFG)
        for mode in ("rotorlb", "vlb"):
            cases = [SweepCase(sched, wl, mode, mode)]
            cpu_s = None
            for d in (torch.device("cpu"), dev):
                if d is dev:
                    run_sweep(cases, BITS_PER_SLOT, device=dev)  # warmup
                best, row = None, None
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    sr = run_sweep(cases, BITS_PER_SLOT, device=d)[0]
                    dt = time.perf_counter() - t0
                    if best is None or dt < best:
                        best, row = dt, sr
                cpu_s = best if cpu_s is None else cpu_s
                speedup = cpu_s / best
                rows.append({
                    "n": n, "mode": mode, "device": d.type,
                    "horizon": horizon, "seconds": best,
                    "speedup_vs_cpu": speedup,
                    "util": row.result.utilization,
                    "avg_hops": row.result.avg_hops,
                })
                print(f"twohop[{mode},n={n},{d.type}],{best * 1e6:.0f},"
                      f"speedup={speedup:.1f}x;"
                      f"util={row.result.utilization:.3f};"
                      f"hops={row.result.avg_hops:.2f}")
    return rows


def timing_table(n: int = 64, d_hat: int = 4, horizon: int = 1500,
                 loads=(0.05, 0.3, 0.6), seed: int = 1,
                 device=None) -> dict:
    """Wall time of the CPU's run against ``device``'s on the websearch
    grid, per group; the schedules are built once, on ``device``.  Returns
    each group's seconds (``"groups"``: group -> (cpu_s, card_s)) and both
    runs' sweep rows in the grid's order (``"rows"``: ``"cpu"`` and
    ``"card"``, the run on ``device``).  With ``device="cpu"`` both
    columns time the CPU."""
    dev = resolve_device(device)
    cases = build_grid(n, d_hat, horizon, loads, seed, device=dev)
    # run_sweep partitions into one single-hop and one two-hop batch
    # internally, so the group times sum to the whole-grid time
    idx = {"single_hop": [i for i, c in enumerate(cases)
                          if c.mode == "single_hop"],
           "two_hop": [i for i, c in enumerate(cases)
                       if c.mode != "single_hop"]}
    secs: dict[str, list[float]] = {g: [] for g in idx}
    rows: dict[str, list] = {}
    for role, d in (("cpu", torch.device("cpu")), ("card", dev)):
        got = [None] * len(cases)
        for group, ii in idx.items():
            t0 = time.perf_counter()
            srs = run_sweep([cases[i] for i in ii], BITS_PER_SLOT, device=d)
            secs[group].append(time.perf_counter() - t0)
            for i, sr in zip(ii, srs):
                got[i] = sr
        rows[role] = got
    groups = {g: tuple(s) for g, s in secs.items()}
    groups["all"] = tuple(sum(s[i] for s in secs.values()) for i in (0, 1))

    print(f"# engine timing: websearch n={n} d_hat={d_hat} "
          f"horizon={horizon} ({len(cases)} cases, {dev.type})")
    print("# group,cpu_s,card_s,speedup")
    for g, (c, t) in groups.items():
        print(f"timing[{g},n={n}],{c:.2f},{t:.2f},{c / t:.1f}x")
    return {"groups": groups, "rows": rows}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.fct_bench")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=4000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--timing-n", type=int, default=64)
    ap.add_argument("--twohop-timing", action="store_true",
                    help="also run the CPU-vs-device twohop_table")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = run(n=args.n, horizon=args.horizon, device=dev)
    print("name,us_per_call,derived")
    for r in rows:
        print(f"fct_fig5[{r['system']},load={r['load']},{r['device']}],"
              f"{r['us']:.0f},"
              f"p99short={r['p99_short']:.0f};p99long={r['p99_long']:.0f};"
              f"util={r['util']:.3f};done={r['done']:.3f};hops={r['hops']:.2f}")
    if not args.no_timing:
        timing_table(n=args.timing_n, device=dev)
    if args.twohop_timing:
        twohop_table(device=dev)


if __name__ == "__main__":
    main()
