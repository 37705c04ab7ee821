"""Paper Fig 7 / Fig 11: throughput across demand matrices and systems.

The port of ``benchmarks/throughput_bench.py``.  Besides the analytic
throughput numbers (host code, no device work), ``main`` cross-checks a
few demand matrices in the flow-level simulator through
:func:`repro_torch.core.simulator.run_sweep`: each demand's saturate
Vermilion schedule (one Sinkhorn call) and the oblivious schedule's
``rotorlb`` and single-hop rows, in one sweep on ``device``.

    PYTHONPATH=src python -m repro_torch.benchmarks.throughput_bench \\
        [n] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import traffic as T
from ..core.schedule import oblivious_schedule, vermilion_schedule
from ..core.simulator import SweepCase, Workload, run_sweep
from ..core.throughput import (
    oblivious_throughput,
    theorem3_bound,
    vermilion_throughput,
)

RECFG = 0.5 / 4.5  # 0.5us reconfiguration, 4.5us slot (9x) — paper config
BITS_PER_SLOT = 100e9 * 4.5e-6


def demand_suite(n: int) -> dict:
    return {
        "dlrm-dp": T.dlrm_data_parallel(n),
        "dlrm-hybrid": T.dlrm_hybrid_parallel(n, groups=4),
        "dlrm-perm": T.permutation(n, seed=3),
        "uniform": T.uniform(n),
        "skew-0.1": T.skewed(n, 0.1),
        "skew-0.5": T.skewed(n, 0.5),
        "skew-0.9": T.skewed(n, 0.9),
        "ring": T.ring(n),
    }


def run(n: int = 16, d_hat: int = 4, ks=(3, 6)) -> list[dict]:
    rows = []
    for name, m in demand_suite(n).items():
        t0 = time.perf_counter()
        row = {
            "demand": name, "n": n,
            "oblivious_multihop": oblivious_throughput(
                m, d_hat=d_hat, recfg_frac=RECFG, multi_hop=True),
            "oblivious_singlehop": oblivious_throughput(
                m, d_hat=d_hat, recfg_frac=RECFG, multi_hop=False),
        }
        for k in ks:
            row[f"vermilion_k{k}"] = vermilion_throughput(
                m, k=k, d_hat=d_hat, recfg_frac=RECFG)
            row[f"bound_k{k}"] = theorem3_bound(k, RECFG)
        row["us"] = (time.perf_counter() - t0) * 1e6
        rows.append(row)
    return rows


def demand_workload(m: np.ndarray, d_hat: int, horizon: int,
                    load: float = 0.9, seed: int = 0) -> Workload:
    """Poisson flow arrivals whose per-pair rates follow ``m``, scaled so
    each node offers ``load`` of its egress capacity; unit-size flows."""
    rng = np.random.default_rng(seed)
    n = m.shape[0]
    rate = m / max(m.sum(axis=1).max(), m.sum(axis=0).max())
    flow_bits = 50e3 * 8
    lam = rate * load * d_hat * BITS_PER_SLOT / flow_bits  # flows/slot/pair
    src, dst, arr = [], [], []
    for (u, v), r in np.ndenumerate(lam):
        if u == v or r <= 0:
            continue
        k = rng.poisson(r * horizon)
        src.append(np.full(k, u))
        dst.append(np.full(k, v))
        arr.append(rng.integers(0, horizon, size=k))
    src, dst, arr = (np.concatenate(x) for x in (src, dst, arr))
    order = np.argsort(arr, kind="stable")
    return Workload(src=src[order], dst=dst[order],
                    size=np.full(len(src), flow_bits),
                    arrival=arr[order], n=n, horizon=horizon)


def simulated_cases(n: int = 16, d_hat: int = 4, horizon: int = 800,
                    demands=("ring", "skew-0.5", "uniform"),
                    device=None) -> list[SweepCase]:
    """The cross-check's sweep: per demand its saturate Vermilion schedule
    (projected on ``device``; ``None``: the card), then ``rotorlb`` and
    single-hop rows on the oblivious schedule."""
    suite = demand_suite(n)
    cases = []
    for name in demands:
        m = suite[name]
        wl = demand_workload(m, d_hat, horizon)
        sv = vermilion_schedule(m, k=3, d_hat=d_hat, recfg_frac=RECFG,
                                normalize="saturate", device=device)
        so = oblivious_schedule(n, d_hat=d_hat, recfg_frac=RECFG)
        cases += [
            SweepCase(sv, wl, "single_hop", f"{name}/vermilion"),
            SweepCase(so, wl, "rotorlb", f"{name}/rotorlb"),
            SweepCase(so, wl, "single_hop", f"{name}/obl-singlehop"),
        ]
    return cases


def run_simulated(n: int = 16, d_hat: int = 4, horizon: int = 800,
                  demands=("ring", "skew-0.5", "uniform"),
                  device=None) -> list[dict]:
    """Flow-level cross-check of the analytic numbers (one batched sweep
    on ``device``; ``None``: the card)."""
    cases = simulated_cases(n, d_hat, horizon, demands, device=device)
    return [{"label": r.label, "util": r.result.utilization,
             "done": r.result.completed_frac, "us": r.sim_s * 1e6}
            for r in run_sweep(cases, BITS_PER_SLOT, device=device)]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.throughput_bench")
    ap.add_argument("n", nargs="?", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n = args.n
    rows = run(n)
    cols = ["demand", "vermilion_k3", "vermilion_k6", "oblivious_multihop",
            "oblivious_singlehop"]
    print("name,us_per_call,derived")
    for r in rows:
        derived = ";".join(f"{c}={r[c]:.3f}" for c in cols[1:])
        print(f"throughput_fig7[{r['demand']},n={n}],{r['us']:.0f},{derived}")
    for r in run_simulated(n, device=args.device):
        print(f"throughput_sim[{r['label']},n={n}],{r['us']:.0f},"
              f"util={r['util']:.3f};done={r['done']:.3f}")


if __name__ == "__main__":
    main()
