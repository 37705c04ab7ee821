"""Quickstart on the port: derive a Vermilion schedule for a skewed traffic
matrix, compare throughput against the oblivious baseline, and simulate
FCTs, with every data plane and Sinkhorn projection on the card.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``: the same nine sections, values and
line formats.  Its ``run_sweep(..., backend="jax")`` and
``run_adaptive(..., backend="jax")`` runs, and the numpy runs beside them,
become the port's ``run_sweep(..., device=)`` and ``run_adaptive(...,
device=)``; section 6 runs the port's lint and section 9 the port's
op-level analyzer.  Without a card it raises unless given ``--device
cpu``.
"""
import argparse
import os

import numpy as np

from repro_torch import core
from repro_torch.analysis.certify import certify_schedule
from repro_torch.analysis.ir import analyze_kernel
from repro_torch.analysis.lint import main as lint_main
from repro_torch.core import traffic as T
from repro_torch.core.faults import FaultEvent, FaultSchedule
from repro_torch.core.schedule import oblivious_schedule, vermilion_schedule
from repro_torch.core.simulator import (
    AdaptiveCase,
    SweepCase,
    phase_shifting_workload,
    run_adaptive,
    run_sweep,
    websearch_workload,
)
from repro_torch.core.throughput import (
    oblivious_throughput,
    theorem3_bound,
    vermilion_throughput,
)
from repro_torch.device import resolve_device

CORE_DIR = os.path.dirname(os.path.abspath(core.__file__))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d_hat, k = 16, 4, 3
    recfg = 1 / 9

    print("=== 1. Throughput (paper Fig 7) ===")
    for name, m in [("ring", T.ring(n)), ("skew-0.5", T.skewed(n, 0.5)),
                    ("uniform", T.uniform(n))]:
        tv = vermilion_throughput(m, k=k, d_hat=d_hat, recfg_frac=recfg)
        to = oblivious_throughput(m, d_hat=d_hat, recfg_frac=recfg)
        print(f"  {name:10s} vermilion={tv:.3f}  oblivious(mh)={to:.3f}  "
              f"bound={theorem3_bound(k, recfg):.3f}")

    print("=== 2. The schedule itself (Algorithm 1) ===")
    sched = vermilion_schedule(T.skewed(n, 0.7), k=k, d_hat=d_hat,
                               recfg_frac=recfg)
    print(f"  {sched.T} matchings over {sched.n_slots} timeslots "
          f"(d_hat={d_hat} port planes); first matching: {sched.perms[0]}")

    print("=== 3. Flow-level simulation (paper Fig 5) ===")
    bits_per_slot = 100e9 * 4.5e-6
    wl = websearch_workload(n, 0.4, 2000, bits_per_slot, d_hat=d_hat, seed=0)
    # the saturate projection runs the Sinkhorn kernel on the card
    sv = vermilion_schedule(wl.demand_matrix(), k=k, d_hat=d_hat,
                            recfg_frac=recfg, normalize="saturate",
                            device=dev)
    so = oblivious_schedule(n, d_hat=d_hat, recfg_frac=recfg)
    # both systems batched through the sweep API in one call: the
    # single-hop and two-hop data planes on the device, per-flow FCTs from
    # the host's exact credit replay
    rv, ro = (row.result for row in run_sweep(
        [SweepCase(sv, wl, "single_hop", "vermilion"),
         SweepCase(so, wl, "rotorlb", "rotorlb")], bits_per_slot,
        device=dev))
    print(f"  vermilion: p99short={rv.fct_percentile(99, short_cutoff=8e5):.0f} "
          f"slots util={rv.utilization:.3f}")
    print(f"  rotorlb  : p99short={ro.fct_percentile(99, short_cutoff=8e5):.0f} "
          f"slots util={ro.utilization:.3f} hops={ro.avg_hops:.2f}")
    print(f"  (both rows ran on {dev.type}: run_sweep(device=) is the port "
          "of run_sweep(backend='jax'))")

    print("=== 4. Closed-loop adaptive scheduling (Appendix A) ===")
    # traffic shifts permutation -> uniform mid-run; the adaptive policy
    # re-estimates each epoch (EWMA + quantized AllGather) and hot-swaps
    # the schedule, the stale policy keeps its epoch-0 schedule forever
    wp = phase_shifting_workload(n, 0.5, 2000, bits_per_slot, d_hat=d_hat,
                                 seed=0, phases=("permutation", "uniform"),
                                 shift_period=1000)
    ra, rs = run_adaptive(
        [AdaptiveCase(wp, 200, "adaptive", d_hat=d_hat, recfg_frac=recfg,
                      alpha=0.5, label="adaptive"),
         AdaptiveCase(wp, 200, "stale", d_hat=d_hat, recfg_frac=recfg,
                      label="stale")], bits_per_slot, device=dev)
    for row in (ra, rs):
        u = row.epoch_utilization
        print(f"  {row.label:8s}: util={row.result.utilization:.3f} "
              f"(pre-shift {u[:5].mean():.3f}, post-shift {u[5:].mean():.3f})"
              f" recomputes={row.recomputes}")

    print("=== 5. Per-node schedule disagreement (partial gather) ===")
    # if the ring AllGather is cut short, every ToR assembles a different
    # partial matrix and swaps to the schedule of ITS OWN view: circuits
    # stop forming global matchings, and contested output ports cost real
    # capacity (collision="drop" is the pessimistic fabric)
    for steps in (n - 1, n // 4):
        rd = run_adaptive(
            [AdaptiveCase(wp, 200, "adaptive", d_hat=d_hat,
                          recfg_frac=recfg, alpha=0.5, gather_steps=steps,
                          collision="drop", label=f"steps={steps}")],
            bits_per_slot, device=dev)[0]
        print(f"  gather steps={steps:2d}: util={rd.result.utilization:.3f} "
              f"disagreement={np.mean(rd.epoch_disagreement):.3f} "
              f"collision_loss={np.mean(rd.epoch_collision_loss):.3f} "
              f"distinct schedules={rd.schedule_groups_max}")

    print("=== 6. Invariants & analysis (repro_torch.analysis) ===")
    # every engine accepts sanitize=True (or REPRO_SANITIZE=1): read-only
    # contract checks that raise SanitizeError on violation and are
    # bit-identical when they pass
    rows = run_sweep(
        [SweepCase(sched, wl, "single_hop", "sanitized")],
        bits_per_slot, sanitize=True, device=dev)
    print(f"  sanitized sweep: util={rows[0].result.utilization:.3f} "
          "(all contract checks passed)")
    # the static half is the port's lint: python -m
    # repro_torch.analysis.lint (rules R1-R4; non-core findings frozen in
    # src/repro_torch/analysis/baseline.json, core stays at zero)
    lint_rc = lint_main([CORE_DIR, "--no-baseline"])
    print(f"  lint src/repro_torch/core: exit {lint_rc}")

    print("=== 7. Fault injection & self-healing (repro_torch.core.faults) ===")
    # kill a whole port plane mid-run and watch the repair loop notice
    # (persistent NACKs on the dead plane's circuits), excise the plane
    # and rebuild the schedule for the survivors, vs a blind adaptive loop
    # that keeps scheduling into it
    nf, df, horizon, fault_slot = 12, 3, 2400, 900
    wf = phase_shifting_workload(nf, 0.95, horizon, bits_per_slot,
                                 d_hat=df, seed=1, phases=("uniform",),
                                 shift_period=horizon)
    fs = FaultSchedule((FaultEvent(fault_slot, "plane_down", plane=0),))
    for label, rep in (("repair", True), ("blind", False)):
        rf = run_adaptive(
            [AdaptiveCase(wf, 150, "adaptive", d_hat=df, recfg_frac=recfg,
                          reconfig_penalty_slots=30, faults=fs, repair=rep,
                          swap_tv_threshold=0.3 if rep else 0.0,
                          label=label)],
            bits_per_slot, sanitize=True, device=dev)[0]
        post = np.mean(rf.epoch_utilization[fault_slot // 150 + 2:])
        print(f"  {label:6s}: util={rf.result.utilization:.3f} "
              f"post-fault={post:.3f} "
              f"excised_planes={rf.excised_planes} "
              f"fault_lost={rf.result.fault_lost_bits:.2e}")

    print(f"=== 8. The adaptive loop on {dev.type} ===")
    # the whole closed loop (estimation, per-node schedule construction,
    # hot swaps, collisions) compiles each case's control trace to a
    # device plan and serves the slots in one data-plane run; the per-flow
    # credit replay then recovers every flow's completion slot
    ja = run_adaptive(
        [AdaptiveCase(wp, 200, "adaptive", d_hat=d_hat,
                      recfg_frac=recfg, alpha=0.5, gather_steps=n // 4,
                      collision="lowest", label="device-adaptive")],
        bits_per_slot, device=dev)[0]
    f = ja.result.fct_slots
    print(f"  {dev.type} adaptive: util={ja.result.utilization:.3f} "
          f"p50={ja.result.fct_percentile(50):.0f} "
          f"p99={ja.result.fct_percentile(99):.0f} slots "
          f"({np.isfinite(f).sum()} of {len(f)} flows completed)")

    print("=== 9. IR budgets & schedule certificates (repro_torch.analysis) ===")
    # the schedule certificate: statically verify Theorem-3 properties of
    # a built schedule (rounding slack, period, partial matchings,
    # capacity domination, worst-case throughput vs the quantized bound)
    # without running a single simulated slot
    cert = certify_schedule(T.skewed(n, 0.7), sched, device=dev)
    print(f"  certificate: ok={cert.ok} theta={cert.theta:.3f} "
          f">= quantized bound {cert.quantized_bound:.3f} "
          f"({sum(v == 'pass' for v in cert.checks.values())}"
          f"/{len(cert.checks)} checks)")
    # the op-level analyzer runs each slot kernel under a dispatch mode
    # and counts flops, peak live bytes and the slot carry's n-scaling
    # exponent, gated against ir_budget.json
    reports = {}
    for kern in ("twohop_dense", "twohop_fct"):
        r = reports[kern] = analyze_kernel(kern, device=dev)
        print(f"  {kern:13s}: {r.flops/1e3:.0f} kflops "
              f"peak={r.peak_bytes/1e3:.1f} kB "
              f"carry~n^{r.carry_exponent:.2f} "
              f"dtype_leaks={len(r.dtype_leaks)}")
    print("  (the reference's HLO-against-jaxpr cross-check of "
          "benchmarks/roofline.py waits on the port's dry run)")
    return {"lint_rc": lint_rc, "certificate": cert, "ir": reports}


if __name__ == "__main__":
    main()
