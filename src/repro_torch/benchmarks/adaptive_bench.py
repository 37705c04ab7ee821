"""Closed-loop adaptive scheduling under non-stationary traffic.  The port
of ``benchmarks/adaptive_bench.py``: every grid goes through
:func:`repro_torch.core.simulator.run_adaptive` on ``device`` (``None``:
the card).

Compares four control policies on one phase-shifting websearch workload
(permutation -> uniform -> dlrm phase train):

  * oracle     — clairvoyant: recomputes Vermilion each epoch from the true
                 generating phase rates (upper bound for any estimator).
  * adaptive   — the paper's Appendix-A loop: VOQ byte counters -> EWMA ->
                 quantize -> ring-AllGather -> recompute -> hot-swap.
                 Swept over EWMA alpha and over partial-gather staleness.
  * stale      — the oracle schedule of epoch 0, never recomputed (an open
                 control loop: great until the first phase shift).
  * oblivious  — round-robin baseline, never recomputed.

Prints the repo's ``name,us_per_call,derived`` CSV plus a ``# summary``
block checking the headline claims: adaptive beats oblivious, tracks the
oracle's utilization, and the stale schedule degrades after a shift.

``run_disagreement()`` sweeps gather staleness -> per-node schedule
disagreement -> utilization (every ToR schedules from its own partial
view; output-port collisions resolved per ``AdaptiveCase.collision``),
and ``--smoke`` runs its smallest grid as a CI guard.

``run_device_speedup()`` times the CPU's run against ``device``'s on the
disagreement grid (interleaved reps, min-of-N) and cross-checks per-case
utilization; the full suite persists it under
``BENCH_adaptive.json["device_speedup"]``.

``run_faults()`` sweeps fault type x severity x policy on both a
stationary train and the shifting phase train: adaptive-with-repair
(NACK/silence detection -> excision -> rebuild over the surviving
fabric, with churn hysteresis) vs adaptive-blind vs the oblivious
baseline, persisting per-epoch utilization recovery curves; its cases
come from :func:`faults_cases`.  The headline check: after a plane
failure on the saturated stationary train adaptive-with-repair recovers
above the oblivious baseline while adaptive-blind — still paying dark
windows for schedules that keep routing into the dead plane — does not.
``run_faults --smoke`` runs a reduced grid as a CI guard.

Every schedule here is ``normalize="hose"`` (``AdaptiveCase``'s default),
so the control plane does no device work; the data plane, the degraded-
service engine's slots included, runs on ``device``.

    PYTHONPATH=src python -m repro_torch.benchmarks.adaptive_bench \\
        [run_faults] [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.faults import FaultEvent, FaultSchedule
from ..core.simulator import (
    AdaptiveCase,
    AdaptiveRow,
    phase_shifting_workload,
    run_adaptive,
)
from ..core.traffic import phase_train
from ..device import resolve_device

RECFG = 1 / 9
BITS_PER_SLOT = 100e9 * 4.5e-6          # 100G links, 4.5us slots (paper)
SHORT = 100e3 * 8                        # <=100KB flows
PHASES = ("permutation", "uniform", "dlrm")
ALPHAS = (0.1, 0.3, 0.5, 0.9)


def build_cases(
    n: int, d_hat: int, load: float, horizon: int, shift_period: int,
    epoch_slots: int, seed: int, alphas=ALPHAS,
) -> list[AdaptiveCase]:
    wl = phase_shifting_workload(
        n, load, horizon, BITS_PER_SLOT, d_hat=d_hat, seed=seed,
        phases=PHASES, shift_period=shift_period)
    mats = phase_train(n, PHASES, seed=seed)
    n_epochs = -(-horizon // epoch_slots)
    oracle_demand = np.stack([
        mats[((e * epoch_slots) // shift_period) % len(mats)]
        for e in range(n_epochs)
    ])
    common = dict(wl=wl, epoch_slots=epoch_slots, d_hat=d_hat,
                  recfg_frac=RECFG, seed=seed)
    cases = [
        AdaptiveCase(policy="oracle", oracle_demand=oracle_demand,
                     label="oracle", **common),
        AdaptiveCase(policy="stale", oracle_demand=oracle_demand,
                     label="stale", **common),
        AdaptiveCase(policy="oblivious", label="oblivious", **common),
    ]
    for a in alphas:
        cases.append(AdaptiveCase(policy="adaptive", alpha=a,
                                  label=f"adaptive-a{a}", **common))
    # partial (mid-phase-failure) gather: only n//4 of the n-1 slots ran
    cases.append(AdaptiveCase(policy="adaptive", alpha=0.5,
                              gather_steps=max(n // 4, 1),
                              label=f"adaptive-gather{max(n // 4, 1)}",
                              **common))
    return cases


def _shift_epochs(horizon: int, shift_period: int, epoch_slots: int):
    """Epoch index ranges of the first phase vs everything after."""
    first = range(0, max(shift_period // epoch_slots, 1))
    rest = range(first.stop, -(-horizon // epoch_slots))
    return first, rest


def run(n: int = 16, d_hat: int = 4, load: float = 0.5,
        horizon: int = 3000, shift_period: int = 1000,
        epoch_slots: int = 150, seed: int = 1,
        device=None) -> list[AdaptiveRow]:
    return run_adaptive(
        build_cases(n, d_hat, load, horizon, shift_period, epoch_slots,
                    seed), BITS_PER_SLOT, device=device)


def run_charging(n: int = 32, d_hat: int = 2, load: float = 0.5,
                 horizon: int = 12000, shift_period: int = 4000,
                 epoch_slots: int = 1500, seed: int = 1,
                 slot_seconds: float = 4.5e-6,
                 device=None) -> list[AdaptiveRow]:
    """Charge schedule construction for real (see
    ``AdaptiveCase.construction_slots``): each recompute's measured
    wall-clock is converted to slots at the paper's 4.5 us slot time, and
    the stale schedule serves until construction finishes.  At these epoch
    lengths the Euler fast path fits inside an epoch while the
    Hopcroft-Karp path is superseded before it ever activates — the
    epoch-length / construction-cost tradeoff made visible in delivered
    utilization rather than wall-clock.  The charged rows' trajectories
    follow the host's clock, so they differ run to run."""
    wl = phase_shifting_workload(
        n, load, horizon, BITS_PER_SLOT, d_hat=d_hat, seed=seed,
        phases=PHASES, shift_period=shift_period)
    common = dict(wl=wl, epoch_slots=epoch_slots, policy="adaptive",
                  d_hat=d_hat, recfg_frac=RECFG, seed=seed, alpha=0.5)
    return run_adaptive([
        AdaptiveCase(label="free-euler", method="euler", **common),
        AdaptiveCase(label="charged-euler", method="euler",
                     construction_slots="measured",
                     slot_seconds=slot_seconds, **common),
        AdaptiveCase(label="charged-hk", method="hk",
                     construction_slots="measured",
                     slot_seconds=slot_seconds, **common),
    ], BITS_PER_SLOT, device=device)


def disagreement_cases(n: int = 16, d_hat: int = 4, load: float = 0.5,
                       horizon: int = 6000, shift_period: int = 2000,
                       epoch_slots: int = 250, seed: int = 1,
                       steps_grid: tuple[int, ...] | None = None,
                       collisions: tuple[str, ...] = ("drop", "lowest",
                                                      "receiver", "fullest"),
                       ) -> list[AdaptiveCase]:
    """The staleness x arbiter grid of :func:`run_disagreement`."""
    if steps_grid is None:
        steps_grid = (n - 1, n // 2, n // 4, 2)
    wl = phase_shifting_workload(
        n, load, horizon, BITS_PER_SLOT, d_hat=d_hat, seed=seed,
        phases=PHASES, shift_period=shift_period)
    return [
        AdaptiveCase(wl=wl, epoch_slots=epoch_slots, policy="adaptive",
                     d_hat=d_hat, recfg_frac=RECFG, seed=seed, alpha=0.5,
                     gather_steps=s, collision=c, label=f"steps{s}-{c}",
                     meta={"gather_steps": s, "collision": c})
        for c in collisions for s in steps_grid
    ]


def run_disagreement(n: int = 16, d_hat: int = 4, load: float = 0.5,
                     horizon: int = 6000, shift_period: int = 2000,
                     epoch_slots: int = 250, seed: int = 1,
                     steps_grid: tuple[int, ...] | None = None,
                     collisions: tuple[str, ...] = ("drop", "lowest",
                                                    "receiver", "fullest"),
                     device=None,
                     ) -> list[AdaptiveRow]:
    """Gather staleness -> schedule disagreement -> utilization.

    Every ToR computes the next schedule from its own (possibly partial)
    ring-gather view, so fewer gather steps mean more disagreeing
    schedules, more contested output ports, and more capacity lost to
    collisions — swept here on the phase-shifting train for each
    data-plane resolution mode (see ``AdaptiveCase.collision``).  A
    complete gather (``steps = n - 1``) is the consistent-fabric baseline:
    zero disagreement, zero collision loss, identical across modes."""
    return run_adaptive(
        disagreement_cases(n, d_hat, load, horizon, shift_period,
                           epoch_slots, seed, steps_grid, collisions),
        BITS_PER_SLOT, device=device)


def run_epoch_tradeoff(n: int = 16, d_hat: int = 4, load: float = 0.5,
                       horizon: int = 6000, shift_period: int = 2000,
                       epoch_grid: tuple[int, ...] = (100, 250, 500, 1000),
                       penalties: tuple[int, ...] = (0, 25, 100),
                       seed: int = 1, device=None) -> list[AdaptiveRow]:
    """Epoch-length x reconfiguration-cost tradeoff (see
    ``AdaptiveCase.reconfig_penalty_slots``): every hot-swap darkens the
    fabric for the penalty window, so short epochs track phase shifts
    faster but pay the dark window more often — the optimum epoch length
    grows with the penalty.  One workload, one grid, one ``run_adaptive``
    call."""
    wl = phase_shifting_workload(
        n, load, horizon, BITS_PER_SLOT, d_hat=d_hat, seed=seed,
        phases=PHASES, shift_period=shift_period)
    cases = [
        AdaptiveCase(wl=wl, epoch_slots=E, policy="adaptive", d_hat=d_hat,
                     recfg_frac=RECFG, seed=seed, alpha=0.5,
                     reconfig_penalty_slots=p, label=f"E{E}-dark{p}",
                     meta={"epoch_slots": E, "penalty": p})
        for p in penalties for E in epoch_grid
    ]
    return run_adaptive(cases, BITS_PER_SLOT, device=device)


FAULT_KINDS_SWEEP = ("plane_down", "tor_fail", "tor_drain")


def _fault_schedule(kind: str, severity: int, slot: int) -> FaultSchedule:
    if kind == "none" or severity == 0:
        return FaultSchedule()
    if kind == "plane_down":
        return FaultSchedule([FaultEvent(slot, "plane_down", plane=p)
                              for p in range(severity)])
    return FaultSchedule([FaultEvent(slot, kind, node=x)
                          for x in range(severity)])


def _post_fault_util(row: AdaptiveRow) -> float:
    """Mean per-epoch utilization from two epochs after the fault on
    (detection + one rebuild settle), the recovery plateau."""
    return float(row.epoch_utilization[row.meta["fault_epoch"] + 2:].mean())


def faults_cases(n: int = 16, d_hat: int = 4, load: float = 0.95,
                 horizon: int = 4500, epoch_slots: int = 150,
                 fault_slot: int = 1500, penalty: int = 40,
                 swap_tv: float = 0.3, seed: int = 1,
                 kinds: tuple[str, ...] = FAULT_KINDS_SWEEP,
                 severities: tuple[int, ...] = (1, 2),
                 trains: tuple[str, ...] = ("stationary", "shifting"),
                 ) -> list[AdaptiveCase]:
    """:func:`run_faults`' cases: per train, a fault-free scenario and
    each fault kind x severity, each under repair / blind / oblivious."""
    fault_epoch = fault_slot // epoch_slots
    cases = []
    for train in trains:
        wl = phase_shifting_workload(
            n, load, horizon, BITS_PER_SLOT, d_hat=d_hat, seed=seed,
            phases=("uniform",) if train == "stationary" else PHASES,
            shift_period=horizon if train == "stationary" else 1500)
        common = dict(wl=wl, epoch_slots=epoch_slots, d_hat=d_hat,
                      recfg_frac=RECFG, seed=seed,
                      reconfig_penalty_slots=penalty)
        policies = (
            ("repair", dict(policy="adaptive", repair=True,
                            swap_tv_threshold=swap_tv)),
            ("blind", dict(policy="adaptive")),
            ("oblivious", dict(policy="oblivious")),
        )
        scenarios = [("none", 0)] + [(k, s) for k in kinds
                                     for s in severities]
        for kind, sev in scenarios:
            fs = _fault_schedule(kind, sev, fault_slot)
            for pname, pkw in policies:
                cases.append(AdaptiveCase(
                    faults=fs if fs else None,
                    label=f"{train}-{kind}{sev}-{pname}",
                    meta={"train": train, "fault": kind, "severity": sev,
                          "policy": pname, "fault_slot": fault_slot,
                          "fault_epoch": fault_epoch},
                    **pkw, **common))
    return cases


def run_faults(n: int = 16, d_hat: int = 4, load: float = 0.95,
               horizon: int = 4500, epoch_slots: int = 150,
               fault_slot: int = 1500, penalty: int = 40,
               swap_tv: float = 0.3, seed: int = 1,
               kinds: tuple[str, ...] = FAULT_KINDS_SWEEP,
               severities: tuple[int, ...] = (1, 2),
               trains: tuple[str, ...] = ("stationary", "shifting"),
               device=None) -> list[AdaptiveRow]:
    """Fault type x severity x policy sweep with recovery curves.

    Policies per scenario: ``repair`` (adaptive + NACK/silence detection
    -> excision -> rebuild over the surviving fabric, with churn
    hysteresis so a converged schedule stops paying the reconfiguration
    dark window), ``blind`` (the plain adaptive loop: keeps rebuilding
    the full-fabric schedule every epoch, routing into the failure) and
    the never-reconfiguring ``oblivious`` round-robin.  Trains:
    ``stationary`` (saturated uniform — the oblivious baseline is
    near-optimal, so failing to recover is visible) and ``shifting``
    (the permutation -> uniform -> dlrm phase train).  Every case also
    runs fault-free (``fault=none``) for its own recovery reference, and
    every run is sanitized so the bit ledger (injected = delivered +
    queued + fault_lost) is enforced under every scenario.
    """
    cases = faults_cases(n, d_hat, load, horizon, epoch_slots, fault_slot,
                         penalty, swap_tv, seed, kinds, severities, trains)
    return run_adaptive(cases, BITS_PER_SLOT, device=device, sanitize=True)


def _print_faults(rows: list[AdaptiveRow], check: bool = True) -> None:
    by = {r.label: r for r in rows}
    for row in rows:
        r = row.result
        print(f"adaptive_faults[{row.label}],{row.sim_s * 1e6:.0f},"
              f"util={r.utilization:.3f};"
              f"post={_post_fault_util(row):.3f};"
              f"lost={r.fault_lost_bits:.3e};"
              f"refused={r.fault_refused_bits:.3e};"
              f"excised_nodes={row.excised_nodes};"
              f"excised_planes={row.excised_planes};"
              f"recomputes={row.recomputes}")
    # ledger sanity on the abrupt-failure scenarios (the sanitized run
    # already enforced conservation; these pin the ledger's visible side)
    for label, row in by.items():
        if "-tor_fail" in label:
            assert row.result.fault_lost_bits >= 0.0
        if "-tor_drain" in label:
            assert row.result.fault_lost_bits == 0.0, label
            assert row.result.fault_refused_bits > 0.0, label
    if not check:
        return
    # headline: after one dead plane on the saturated stationary train,
    # repair recovers above the oblivious baseline; blind does not
    rep = _post_fault_util(by["stationary-plane_down1-repair"])
    bli = _post_fault_util(by["stationary-plane_down1-blind"])
    obl = _post_fault_util(by["stationary-plane_down1-oblivious"])
    assert by["stationary-plane_down1-repair"].excised_planes == 1
    assert rep >= obl > bli, (rep, obl, bli)
    print(f"# faults: plane_down recovery repair {rep:.3f} >= "
          f"oblivious {obl:.3f} > blind {bli:.3f} (self-healing holds)")


def smoke_faults(n: int = 12, device=None) -> list[AdaptiveRow]:
    """Reduced fault grid for CI: one severity, stationary train only,
    sanitized — exercises detection, excision, rebuild, and the fault
    ledger in a few seconds."""
    rows = run_faults(n=n, d_hat=3, load=0.95, horizon=2400,
                      epoch_slots=150, fault_slot=900, penalty=30,
                      severities=(1,), trains=("stationary",),
                      device=device)
    _print_faults(rows, check=False)
    by = {r.label: r for r in rows}
    rep = by["stationary-plane_down1-repair"]
    assert rep.excised_planes == 1, "repair failed to excise the dead plane"
    assert _post_fault_util(rep) > _post_fault_util(
        by["stationary-plane_down1-blind"])
    assert by["stationary-tor_fail1-blind"].result.fault_lost_bits > 0.0
    assert by["stationary-none0-repair"].result.fault_lost_bits == 0.0
    print("# faults smoke: ok (ledger closes, drain lossless, repair "
          "excises and recovers above blind)")
    return rows


def _print_disagreement(rows: list[AdaptiveRow]) -> None:
    by_steps: dict[int, AdaptiveRow] = {}
    for row in rows:
        r = row.result
        print(f"adaptive_disagree[{row.label}],{row.sim_s * 1e6:.0f},"
              f"util={r.utilization:.3f};"
              f"disagree={np.mean(row.epoch_disagreement):.3f};"
              f"coll_loss={np.mean(row.epoch_collision_loss):.3f};"
              f"groups={row.schedule_groups_max};"
              f"recomputes={row.recomputes}")
        s = row.meta["gather_steps"]
        if row.meta["collision"] == "drop":
            by_steps[s] = row
    trail = ", ".join(
        f"steps={s} -> dis {np.mean(by_steps[s].epoch_disagreement):.2f} "
        f"util {by_steps[s].result.utilization:.3f}"
        for s in sorted(by_steps, reverse=True))
    print(f"# staleness -> disagreement -> utilization (drop): {trail}")


def smoke(n: int = 8, device=None) -> list[AdaptiveRow]:
    """Smallest-grid disagreement sweep for CI: exercises the per-node
    control plane, both extreme staleness points, and two collision modes
    in a few seconds, so the benchmark entry points cannot rot."""
    rows = run_disagreement(
        n=n, d_hat=2, load=0.4, horizon=600, shift_period=300,
        epoch_slots=150, steps_grid=(n - 1, 2),
        collisions=("drop", "lowest"), device=device)
    _print_disagreement(rows)
    full = [r for r in rows if r.meta["gather_steps"] == n - 1]
    partial = [r for r in rows if r.meta["gather_steps"] == 2]
    assert all(np.all(r.epoch_disagreement == 0.0) for r in full)
    assert all(r.collision_lost_bits > 0 for r in partial)
    print("# smoke: ok (consistent baseline clean, partial gather "
          "disagrees and loses capacity)")
    return rows


def run_device_speedup(n: int = 16, d_hat: int = 4, load: float = 0.5,
                       horizon: int = 6000, shift_period: int = 2000,
                       epoch_slots: int = 250, seed: int = 1,
                       steps_grid: tuple[int, ...] | None = None,
                       reps: int = 3, device=None) -> dict:
    """Wall-clock comparison of the CPU's run and ``device``'s on the
    disagreement sweep: the staleness x {drop, lowest, receiver} grid
    (``fullest`` left out, as the reference leaves it out of its engine
    comparison), one cold call on ``device`` (first-call costs included),
    then ``reps`` interleaved pairs.  The headline ``speedup`` is
    min(CPU) / min(warm device): min-of-N filters scheduler noise on a
    shared host, and interleaving makes any drift hit both alike.
    Per-case utilization is cross-checked between the two (the parity
    tests gate it; here the observed max abs diff is recorded), and the
    per-flow FCT percentiles come from the device's rows.
    """
    dev = resolve_device(device)
    cases = disagreement_cases(n, d_hat, load, horizon, shift_period,
                               epoch_slots, seed, steps_grid,
                               ("drop", "lowest", "receiver"))
    t0 = time.perf_counter()
    card_rows = run_adaptive(cases, BITS_PER_SLOT, device=dev)
    card_cold = time.perf_counter() - t0
    cpu_s: list[float] = []
    card_s: list[float] = []
    cpu_rows = None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        card_rows = run_adaptive(cases, BITS_PER_SLOT, device=dev)
        card_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cpu_rows = run_adaptive(cases, BITS_PER_SLOT, device="cpu")
        cpu_s.append(time.perf_counter() - t0)

    rows = []
    max_diff = 0.0
    for cr, hr in zip(card_rows, cpu_rows):
        max_diff = max(max_diff, abs(cr.result.utilization
                                     - hr.result.utilization))
        rows.append({
            "label": cr.label,
            "util_cpu": hr.result.utilization,
            "util_card": cr.result.utilization,
            "p50_short": cr.result.fct_percentile(50, short_cutoff=SHORT),
            "p99_short": cr.result.fct_percentile(99, short_cutoff=SHORT),
        })
    cpu_min, card_warm = min(cpu_s), min(card_s)
    return {
        "n": n,
        "device": dev.type,
        "cases": len(rows),
        "reps": reps,
        "cpu_s": cpu_min,
        "card_cold_s": card_cold,
        "card_warm_s": card_warm,
        "speedup_cold": cpu_min / card_cold,
        "speedup_warm": cpu_min / card_warm,
        "speedup": cpu_min / card_warm,
        "max_util_abs_diff": max_diff,
        "rows": rows,
    }


def _print_device_speedup(sp: dict) -> None:
    print(f"adaptive_device[sweep],{sp['card_warm_s'] * 1e6:.0f},"
          f"cpu_s={sp['cpu_s']:.2f};card_cold_s={sp['card_cold_s']:.2f};"
          f"card_warm_s={sp['card_warm_s']:.2f};"
          f"speedup={sp['speedup']:.2f};"
          f"max_util_diff={sp['max_util_abs_diff']:.2e}")
    for row in sp["rows"]:
        print(f"adaptive_device[{row['label']}],,"
              f"util={row['util_card']:.3f};"
              f"p50short={row['p50_short']:.0f};"
              f"p99short={row['p99_short']:.0f}")
    print(f"# {sp['device']} adaptive: {sp['cases']} cases, warm speedup "
          f"{sp['speedup']:.2f}x over the CPU (min of {sp['reps']} "
          f"interleaved reps), utils agree to "
          f"{sp['max_util_abs_diff']:.1e}")


def print_summary(rows: list[AdaptiveRow], horizon: int = 3000,
                  shift_period: int = 1000, epoch_slots: int = 150) -> None:
    """:func:`run`'s rows and the ``# summary`` block."""
    first, rest = _shift_epochs(horizon, shift_period, epoch_slots)
    by_label = {}
    print("name,us_per_call,derived")
    for row in rows:
        by_label[row.label] = row
        r = row.result
        u = row.epoch_utilization
        tv = row.epoch_estimate_tv
        tv_s = (f"est_tv={np.nanmean(tv):.3f};"
                if np.isfinite(tv).any() else "")
        print(f"adaptive[{row.label}],{row.sim_s * 1e6:.0f},"
              f"util={r.utilization:.3f};"
              f"util_pre={u[list(first)].mean():.3f};"
              f"util_post={u[list(rest)].mean():.3f};"
              f"p99short={r.fct_percentile(99, short_cutoff=SHORT):.0f};"
              f"done={r.completed_frac:.3f};{tv_s}"
              f"recomputes={row.recomputes}")

    oracle = by_label["oracle"].result.utilization
    obliv = by_label["oblivious"].result.utilization
    best = max((r for r in rows if r.policy == "adaptive"),
               key=lambda r: r.result.utilization)
    stale = by_label["stale"]
    s_pre = stale.epoch_utilization[list(first)].mean()
    s_post = stale.epoch_utilization[list(rest)].mean()
    print(f"# summary: best adaptive = {best.label} "
          f"util={best.result.utilization:.3f} "
          f"(oracle {oracle:.3f}, oblivious {obliv:.3f})")
    print(f"# adaptive/oracle = {best.result.utilization / oracle:.3f} "
          f"(want >= 0.9), adaptive/oblivious = "
          f"{best.result.utilization / obliv:.3f} (want > 1)")
    print(f"# stale pre-shift {s_pre:.3f} -> post-shift {s_post:.3f} "
          f"({(1 - s_post / s_pre) * 100:.0f}% degradation after shift)")


def print_charged(rows: list[AdaptiveRow]) -> None:
    for row in rows:
        r = row.result
        print(f"adaptive_charged[{row.label}],{row.sim_s * 1e6:.0f},"
              f"util={r.utilization:.3f};stale_slots={row.stale_slots};"
              f"recomputes={row.recomputes};"
              f"constr_ms={row.construction_s * 1e3:.0f}")


def print_tradeoff(rows: list[AdaptiveRow]) -> None:
    """The tradeoff rows and the best epoch length per penalty."""
    best_by_p: dict[int, AdaptiveRow] = {}
    for row in rows:
        print(f"adaptive_tradeoff[{row.label}],{row.sim_s * 1e6:.0f},"
              f"util={row.result.utilization:.3f};"
              f"dark_slots={row.dark_slots};recomputes={row.recomputes}")
        p = row.meta["penalty"]
        if (p not in best_by_p
                or row.result.utilization > best_by_p[p].result.utilization):
            best_by_p[p] = row
    print("# epoch tradeoff: best epoch length per reconfig penalty: "
          + ", ".join(f"dark={p} -> E{best_by_p[p].meta['epoch_slots']} "
                      f"(util {best_by_p[p].result.utilization:.3f})"
                      for p in sorted(best_by_p)))


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.adaptive_bench")
    ap.add_argument("section", nargs="?", default=None,
                    choices=(None, "run_faults"),
                    help="run one section instead of the full suite")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--d-hat", type=int, default=4)
    ap.add_argument("--load", type=float, default=0.5)
    ap.add_argument("--horizon", type=int, default=3000)
    ap.add_argument("--shift-period", type=int, default=1000)
    ap.add_argument("--epoch-slots", type=int, default=150)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="run the smallest grid of the selected section "
                         "(default: the disagreement sweep) and exit")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.section == "run_faults":
        if args.smoke:
            smoke_faults(device=dev)
            return None
        faults = run_faults(device=dev)
        _print_faults(faults)
        return faults
    if args.smoke:
        smoke(device=dev)
        return None

    rows = run(args.n, args.d_hat, args.load, args.horizon,
               args.shift_period, args.epoch_slots, args.seed, device=dev)
    print_summary(rows, args.horizon, args.shift_period, args.epoch_slots)

    charged = run_charging(device=dev)
    print_charged(charged)

    tradeoff = run_epoch_tradeoff(device=dev)
    print_tradeoff(tradeoff)

    disagree = run_disagreement(device=dev)
    _print_disagreement(disagree)

    device_speedup = run_device_speedup(device=dev)
    _print_device_speedup(device_speedup)

    faults = run_faults(device=dev)
    _print_faults(faults)
    return rows, charged, tradeoff, disagree, faults, device_speedup


if __name__ == "__main__":
    main()
