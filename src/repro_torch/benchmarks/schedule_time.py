"""Paper Fig 10: schedule-construction latency vs network size.  The port
of ``benchmarks/schedule_time.py``, timing the port's own host copies of
the pipeline (``traffic.hose_normalize``, ``rounding.round_matrix`` /
``round_matrices``, ``matching.decompose_matchings`` /
``decompose_matchings_euler``, ``schedule.spread_matchings`` and
``vermilion_schedule``).  Under ``normalize="hose"`` construction does no
device work, as in the reference: the numbers are the host CPU's of the
machine the run is on (on a card's machine, its host's), and ``device``
only names where a run would project under ``"saturate"``.

The paper leans on a CUDA decomposition helper because matching
decomposition dominates ``vermilion_schedule`` beyond a few hundred ToRs —
and the adaptive loop puts construction on a per-epoch latency path.
This benchmark sweeps the full construction pipeline per stage
(normalize / round / decompose / spread) for both decomposition methods:

  * ``hk``    — one Hopcroft-Karp matching per round (the historical
                default, O(D * (n^2 + E sqrt(n)))).
  * ``euler`` — the batched Euler-split fast path with the free
                residual-shift peel (production path).

``run()`` returns machine-readable rows; ``repro_torch.benchmarks.run``
persists them to ``BENCH_schedule.json``.  The headline number is
``speedup`` = hk end-to-end / euler end-to-end at each n.

HK is skipped beyond ``--hk-max-n`` (it is minutes-slow at n >= 1024); the
Euler path sweeps to n = 512 (2048 with ``--full``).

    PYTHONPATH=src python -m repro_torch.benchmarks.schedule_time \
        [--full] [--hk-max-n 512] [--repeats 3] [--json out.json] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core import traffic as T
from ..core.matching import decompose_matchings, decompose_matchings_euler
from ..core.rounding import round_matrices, round_matrix
from ..core.schedule import (
    spread_matchings,
    vermilion_emulated_topology,
    vermilion_schedule,
)
from ..core.traffic import hose_normalize
from ..device import resolve_device

DEFAULT_NS = (16, 64, 128, 256, 512)
FULL_NS = (16, 64, 128, 256, 512, 1024, 2048)


def bench(fn, repeats: int = 3) -> float:
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts)) * 1e6


def run(ns=DEFAULT_NS, k: int = 3, hk_max_n: int = 512,
        repeats: int = 3, device=None) -> list[dict]:
    """One row per n: each stage's min-of-N microseconds, both methods'
    end to end (HK up to ``hk_max_n``) and their ratio ``speedup``."""
    rows = []
    for n in ns:
        m = T.random_hose(n, seed=0)
        reps = repeats if n <= 256 else 1
        e = vermilion_emulated_topology(m, k=k, seed=0)
        shifts = (np.arange(n)[None, :] + np.arange(1, n)[:, None]) % n
        perms = decompose_matchings_euler(e, known=shifts)
        norm = hose_normalize(m)
        batch = [(k - 1) * n * hose_normalize(T.random_hose(n, seed=s))
                 for s in range(8)]
        row = {
            "n": n,
            "k": k,
            "normalize_us": bench(lambda: hose_normalize(m), repeats),
            "round_us": bench(
                lambda: round_matrix((k - 1) * n * norm), reps),
            # batched rounding amortization (one flow call for 8 epochs'
            # worth of oracle matrices), per-matrix cost
            "round_batch8_us": bench(lambda: round_matrices(batch), 1) / 8.0,
            "decomp_euler_us": bench(
                lambda: decompose_matchings_euler(e, known=shifts), reps),
            "spread_us": bench(lambda: spread_matchings(perms), repeats),
            "end_to_end_euler_us": bench(
                lambda: vermilion_schedule(m, k=k, seed=0, method="euler",
                                           device=device),
                reps),
        }
        if n <= hk_max_n:
            hk_reps = repeats if n <= 64 else 1
            row["decomp_hk_us"] = bench(
                lambda: decompose_matchings(e), hk_reps)
            row["end_to_end_hk_us"] = bench(
                lambda: vermilion_schedule(m, k=k, seed=0, method="hk",
                                           device=device),
                hk_reps)
            row["speedup"] = (row["end_to_end_hk_us"]
                              / row["end_to_end_euler_us"])
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.schedule_time")
    ap.add_argument("--full", action="store_true",
                    help="sweep n up to 2048 (euler only beyond --hk-max-n)")
    ap.add_argument("--hk-max-n", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", type=str, default=None,
                    help="also dump rows to this path")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = run(ns=FULL_NS if args.full else DEFAULT_NS,
               hk_max_n=args.hk_max_n, repeats=args.repeats, device=dev)
    print("name,us_per_call,derived")
    for r in rows:
        hk = (f"hk_e2e={r['end_to_end_hk_us']:.0f}us;"
              f"hk_decomp={r['decomp_hk_us']:.0f}us;"
              f"speedup={r['speedup']:.1f}x;"
              if "speedup" in r else "")
        print(f"schedule_time_fig10[n={r['n']}],"
              f"{r['end_to_end_euler_us']:.0f},"
              f"norm={r['normalize_us']:.0f}us;round={r['round_us']:.0f}us;"
              f"euler={r['decomp_euler_us']:.0f}us;"
              f"spread={r['spread_us']:.0f}us;{hk}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
