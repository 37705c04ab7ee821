"""Level-B bridge: inter-pod collective pricing under Vermilion vs oblivious.

The port of ``benchmarks/interconnect_bench.py``.  For each architecture
of the port's registry, derive the pod-axis traffic matrix of one training
step (DP gradient ring + MoE all-to-all spillover), price it on the
optical interconnect under each scheduling system (host code), and report
the resulting collective step time.

``main`` additionally validates the analytic step time with the flow-level
simulator: every architecture's traffic matrix is drained through a
saturate Vermilion schedule (one Sinkhorn call each) in one
:func:`repro_torch.core.simulator.run_sweep` batch on ``device``.

    PYTHONPATH=src python -m repro_torch.benchmarks.interconnect_bench \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import REGISTRY, get_config
from ..core.collectives import InterconnectModel, training_step_traffic
from ..core.schedule import vermilion_schedule
from ..core.simulator import SweepCase, Workload, run_sweep

N_PODS = 8          # a plausible optical fabric: 8 pods of 256 chips
IC = InterconnectModel(link_gbps=400, d_hat=8, recfg_frac=1 / 9, k=3)
SLOT_S = 4.5e-6
BITS_PER_SLOT = IC.link_gbps * 1e9 * SLOT_S


def step_matrix(cfg, compression: float = 1.0) -> np.ndarray:
    """The arch's per-step inter-pod traffic matrix (bytes)."""
    grad_bytes = cfg.param_count() * 4 / 256              # per-pod shard, fp32
    moe = cfg.d_model * 4096 * 256 * 2 * 0.1 if cfg.n_experts else 0.0
    return training_step_traffic(N_PODS, grad_bytes, moe_alltoall_bytes=moe,
                                 compression=compression)


def run() -> list[dict]:
    rows = []
    for arch in sorted(REGISTRY):
        cfg = get_config(arch)
        m = step_matrix(cfg)
        t0 = time.perf_counter()
        row = {
            "arch": arch,
            "t_vermilion": IC.step_time(m, "vermilion"),
            "t_oblivious": IC.step_time(m, "oblivious"),
            "t_obl_singlehop": IC.step_time(m, "oblivious-singlehop"),
        }
        m_c = step_matrix(cfg, compression=0.25)
        row["t_vermilion_int8"] = IC.step_time(m_c, "vermilion")
        row["speedup"] = row["t_oblivious"] / row["t_vermilion"]
        row["us"] = (time.perf_counter() - t0) * 1e6
        rows.append(row)
    return rows


def drain_workload(m: np.ndarray, horizon: int) -> Workload:
    """One flow per pod pair carrying that pair's step traffic (bits)."""
    src, dst = np.nonzero(m)
    bits = m[src, dst] * 8.0
    return Workload(src=src, dst=dst, size=bits,
                    arrival=np.zeros(len(src), dtype=np.int64),
                    n=m.shape[0], horizon=horizon)


def drain_cases(horizon: int = 30000, device=None) -> list[SweepCase]:
    """Each arch's step matrix on its saturate Vermilion schedule
    (projected on ``device``; ``None``: the card)."""
    cases = []
    for arch in sorted(REGISTRY):
        m = step_matrix(get_config(arch))
        sched = vermilion_schedule(m, k=IC.k, d_hat=IC.d_hat,
                                   recfg_frac=IC.recfg_frac,
                                   normalize="saturate", device=device)
        cases.append(SweepCase(
            sched=sched, wl=drain_workload(m, horizon),
            mode="single_hop", label=arch))
    return cases


def drain_times(rows) -> list[dict]:
    """Each sweep row's drain: its last FCT in seconds (inf if a flow did
    not finish)."""
    out = []
    for r in rows:
        fct = r.result.fct_slots
        drain = float(fct.max()) * SLOT_S if np.isfinite(fct).all() \
            else float("inf")
        out.append({"arch": r.label, "t_sim": drain, "us": r.sim_s * 1e6})
    return out


def run_simulated(horizon: int = 30000, device=None) -> list[dict]:
    """Flow-level drain of each arch's step matrix (one batched sweep on
    ``device``; ``None``: the card)."""
    return drain_times(run_sweep(drain_cases(horizon, device=device),
                                 BITS_PER_SLOT, device=device))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.interconnect_bench")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    sim = {r["arch"]: r for r in run_simulated(device=args.device)}
    for r in run():
        s = sim[r["arch"]]
        print(f"interconnect[{r['arch']}],{r['us']:.0f},"
              f"verm={r['t_vermilion'] * 1e3:.2f}ms;"
              f"obl={r['t_oblivious'] * 1e3:.2f}ms;"
              f"verm_int8={r['t_vermilion_int8'] * 1e3:.2f}ms;"
              f"speedup={r['speedup']:.2f}x;"
              f"verm_simulated={s['t_sim'] * 1e3:.2f}ms")


if __name__ == "__main__":
    main()
