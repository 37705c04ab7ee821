"""Paper Fig 8: throughput vs k (8a) and vs network size (8b) — convergence
to the (k-1)/k lower bound.  The port of ``benchmarks/bound_convergence.py``
(host code: hose schedules and the single-hop closed form).

    PYTHONPATH=src python -m repro_torch.benchmarks.bound_convergence
"""
from __future__ import annotations

import time

import numpy as np

from ..core import traffic as T
from ..core.throughput import theorem3_bound, vermilion_throughput

RECFG = 0.5 / 4.5


def vs_k(n: int = 16, d_hat: int = 4, ks=(2, 3, 4, 6, 8)) -> list[dict]:
    rows = []
    for k in ks:
        ths = [vermilion_throughput(T.random_hose(n, seed=s), k=k,
                                    d_hat=d_hat, recfg_frac=RECFG, seed=s)
               for s in range(5)]
        rows.append({"k": k, "min": min(ths), "mean": float(np.mean(ths)),
                     "bound": theorem3_bound(k, RECFG)})
    return rows


def vs_n(k: int = 3, d_hat: int = 4, ns=(8, 16, 24, 32, 48)) -> list[dict]:
    rows = []
    for n in ns:
        ths = [vermilion_throughput(T.random_hose(n, seed=s), k=k,
                                    d_hat=d_hat, recfg_frac=RECFG, seed=s)
               for s in range(3)]
        rows.append({"n": n, "min": min(ths), "mean": float(np.mean(ths)),
                     "bound": theorem3_bound(k, RECFG)})
    return rows


def main() -> None:
    print("name,us_per_call,derived")
    t0 = time.perf_counter()
    for r in vs_k():
        print(f"bound_fig8a[k={r['k']}],"
              f"{(time.perf_counter() - t0) * 1e6:.0f},"
              f"min={r['min']:.3f};bound={r['bound']:.3f}")
        t0 = time.perf_counter()
    for r in vs_n():
        print(f"bound_fig8b[n={r['n']}],"
              f"{(time.perf_counter() - t0) * 1e6:.0f},"
              f"min={r['min']:.3f};bound={r['bound']:.3f}")
        t0 = time.perf_counter()


if __name__ == "__main__":
    main()
