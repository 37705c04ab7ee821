"""Schedule throughput certificates: static Theorem-3 verification.

The paper's headline claim is a *formal* worst-case throughput guarantee
(Theorem 3: theta >= (k-1)/k * (1 - recfg) for any hose-admissible
demand), but until now the repo only ever observed it dynamically, through
simulation.  This module verifies the guarantee *statically* — no
simulation, no slot loop — from the schedule artifact and the demand
matrix alone, replaying the paper's proof chain as concrete matrix checks:

* **C1 perms** — every matching row of ``Schedule.perms`` is a permutation
  (the doubly-stochastic premise of the emulated graph).
* **C2 period** — the period is exactly ``T = k*n`` matchings spanning
  ``n_slots = ceil(k*n / d_hat)`` timeslots (Algorithm 1's ceiling bound:
  (k-1)*n traffic-aware + n-1 residual + padding rounds to k*n).
* **C3 rounding** — the Bacharach-rounded matrix sits within quantization
  slack of the scaled demand (entrywise ``|R - (k-1)*n*norm| < 1``) and is
  doubly *sub*stochastic at the (k-1)*n scale (all row/col sums <=
  (k-1)*n), via :func:`repro_torch.core.schedule.vermilion_rounded` — exactly
  the matrices the construction rounds.
* **C4 emulation** — the schedule's edge-count multigraph dominates
  ``R + 1`` off-diagonal (traffic-aware + oblivious residual edges all
  survived decomposition and reordering) and is k*n-regular.
* **C5 matchings** — every per-slot circuit set is a partial matching:
  per-source / per-destination capacity within ``d_hat * (1 - recfg)``,
  no self-loops, no negative capacity.
* **C6 domination** — emulated capacity dominates ``bound_q * demand``
  entrywise, with ``demand`` the normalized matrix at hose rate d_hat and
  ``bound_q = quantized_theorem3_bound(k, d_hat, n, recfg)`` (the finite-
  period form of (1 - eps) in the paper's capacity-domination lemma).
* **C7 throughput** — the closed-form single-hop worst case
  ``theta = min cap/demand`` meets ``bound_q`` (and is reported against
  the asymptotic ``theorem3_bound(k)``).

C3 entails C6/C7 analytically (counts >= R + 1 > scaled demand, so
cap >= demand * bound_q); checking every link in the chain separately
means a violation names the *stage* that broke — rounding, decomposition,
spread, or capacity accounting.

``--batch-check`` additionally pins the batched ``vermilion_schedules``
construction bit-identical to the solo path on the same demands (the
batched Bacharach flow + merged Euler cascade must not change a single
permutation).

The port's own copy of ``repro.analysis.certify``.  Every check is host
numpy; under ``normalize="saturate"`` the scaled demand is re-derived
through the Sinkhorn projection on ``device`` (``None``: the card;
``"cpu"``: the plain version), as the construction derived it.  Under
``"hose"`` nothing runs on a device.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.certify --case skewed \\
        --n 16 --k 3 --d-hat 2 --json cert.json
    PYTHONPATH=src python -m repro_torch.analysis.certify --demand m.npy \\
        --k 3 --device cpu

``--device`` defaults to the card and raises without one unless given
``--device cpu``.

Violations print in the lint's report format (``check: RULE[tag] msg``)
and exit 1; a clean run prints the certificate summary and exits 0.  The
emitted JSON certificate (``--json``) is machine-readable and pinned by
tests and CI.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

from ..core.schedule import (
    vermilion_rounded,
    vermilion_scaled_demands,
    vermilion_schedule,
    vermilion_schedules,
)
from ..core.simulator import websearch_workload
from ..core.throughput import (
    quantized_theorem3_bound,
    theorem3_bound,
    throughput_single_hop,
)
from ..device import resolve_device

__all__ = [
    "CertifyResult",
    "certify_schedule",
    "batch_parity",
    "demand_case",
    "DEMAND_CASES",
    "main",
]


# -- golden demand generators ----------------------------------------------

def _demand_uniform(n: int, seed: int) -> np.ndarray:
    m = np.ones((n, n))
    np.fill_diagonal(m, 0.0)
    return m


def _demand_skewed(n: int, seed: int) -> np.ndarray:
    """A few elephant rows over a light all-to-all mouse floor — the
    traffic-aware layer's bread and butter."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.01, 0.05, size=(n, n))
    hot = rng.choice(n, size=max(2, n // 4), replace=False)
    for s in hot:
        m[s, rng.choice(n, size=max(1, n // 4), replace=False)] += \
            rng.uniform(2.0, 8.0, size=max(1, n // 4))
    np.fill_diagonal(m, 0.0)
    return m


def _demand_websearch(n: int, seed: int) -> np.ndarray:
    """Aggregate a websearch-distribution workload into one demand
    matrix (the generator behind the sweep engine's golden cases)."""
    wl = websearch_workload(n=n, load=0.6, horizon=256,
                            bits_per_slot=1e7, pattern="uniform",
                            seed=seed)
    m = np.zeros((n, n))
    np.add.at(m, (wl.src, wl.dst), wl.size)
    return m


DEMAND_CASES = {
    "uniform": _demand_uniform,
    "skewed": _demand_skewed,
    "websearch": _demand_websearch,
}


def demand_case(name: str, n: int, seed: int = 0) -> np.ndarray:
    try:
        return DEMAND_CASES[name](n, seed)
    except KeyError:
        raise ValueError(
            f"unknown demand case {name!r} (have {sorted(DEMAND_CASES)})"
        ) from None


# -- the certificate checks -------------------------------------------------

class CertifyResult:
    """Outcome of one certification: per-check status, violations,
    achieved bounds, and the machine-readable certificate dict."""

    def __init__(self) -> None:
        self.checks: dict[str, str] = {}
        self.violations: list[str] = []
        self.theta: float = float("nan")
        self.quantized_bound: float = float("nan")
        self.asymptotic_bound: float = float("nan")
        self.certificate: dict = {}

    @property
    def ok(self) -> bool:
        return not self.violations

    def _record(self, check: str, violations: list[str]) -> None:
        self.checks[check] = "pass" if not violations else "fail"
        self.violations.extend(violations)


def _c1_perms(sched) -> list[str]:
    perms, n = sched.perms, sched.n
    if perms.ndim != 2 or not np.issubdtype(perms.dtype, np.integer):
        return [f"perms: C1[perms] perms must be 2-D integer "
                f"(got {perms.dtype} ndim={perms.ndim})"]
    ok = (np.sort(perms, axis=1) == np.arange(n)).all(axis=1)
    if not ok.all():
        bad = np.flatnonzero(~ok)[:4].tolist()
        return [f"perms: C1[perms] rows {bad} are not permutations of "
                f"range({n}) — invalid matchings in the period"]
    return []


def _c2_period(sched, k: int) -> list[str]:
    out = []
    if sched.T != k * sched.n:
        out.append(
            f"period: C2[period] T = {sched.T} != k*n = {k * sched.n} — "
            "Algorithm 1 emits exactly k*n matchings")
    want = -(-sched.T // sched.d_hat)
    if sched.n_slots != want:
        out.append(
            f"period: C2[period] n_slots = {sched.n_slots} != "
            f"ceil(T/d_hat) = {want}")
    return out


def _c3_rounding(scaled: np.ndarray, rounded: np.ndarray, k: int,
                 n: int, tol: float) -> list[str]:
    out = []
    if (rounded < 0).any() or not np.issubdtype(rounded.dtype, np.integer):
        out.append("rounding: C3[rounding] rounded matrix must be "
                   "nonnegative integer")
        return out
    if np.diagonal(rounded).any():
        out.append("rounding: C3[rounding] rounded matrix has self-loop "
                   "demand (diagonal was zeroed before rounding)")
    err = np.abs(rounded - scaled)
    if err.max(initial=0.0) >= 1.0 + tol:
        i, j = np.unravel_index(int(np.argmax(err)), err.shape)
        out.append(
            f"rounding: C3[rounding] |R - scaled| = {err[i, j]:.6g} >= 1 "
            f"at ({i}, {j}) — Bacharach quantization slack exceeded")
    cap = (k - 1) * n
    for axis, word in ((1, "row"), (0, "col")):
        s = rounded.sum(axis=axis)
        if s.max(initial=0) > cap:
            node = int(np.argmax(s))
            out.append(
                f"rounding: C3[rounding] {word} sum {int(s.max())} > "
                f"(k-1)*n = {cap} at node {node} — not doubly "
                "substochastic at the quantization scale")
    return out


def _c4_emulation(sched, rounded: np.ndarray, k: int) -> list[str]:
    out = []
    n = sched.n
    counts = sched.edge_counts()
    off = ~np.eye(n, dtype=bool)
    need = rounded + 1            # traffic-aware + oblivious residual edge
    short = (counts < need) & off
    if short.any():
        i, j = map(int, np.argwhere(short)[0])
        out.append(
            f"emulation: C4[emulation] edge ({i}, {j}) appears "
            f"{int(counts[i, j])} < R+1 = {int(need[i, j])} times per "
            "period — decomposition/spread dropped a guaranteed circuit")
    for axis, word in ((1, "out"), (0, "in")):
        s = counts.sum(axis=axis)
        if not (s == k * n).all():
            node = int(np.argmax(np.abs(s - k * n)))
            out.append(
                f"emulation: C4[emulation] {word}-degree {int(s[node])} != "
                f"k*n = {k * n} at node {node} — the emulated multigraph "
                "is not k*n-regular")
    return out


def _c5_matchings(sched, tol: float) -> list[str]:
    out = []
    n = sched.n
    budget = sched.d_hat * (1.0 - sched.recfg_frac)
    for s, (src, dst, cap) in enumerate(sched.slot_circuits(1.0)):
        if (cap < 0).any():
            out.append(f"matchings: C5[matching] slot {s} has negative "
                       "circuit capacity")
        if (src == dst).any():
            out.append(f"matchings: C5[matching] slot {s} serves a "
                       "self-loop circuit")
        per_src = np.bincount(src, weights=cap, minlength=n)
        per_dst = np.bincount(dst, weights=cap, minlength=n)
        if per_src.max(initial=0.0) > budget + tol \
                or per_dst.max(initial=0.0) > budget + tol:
            out.append(
                f"matchings: C5[matching] slot {s} port commitment "
                f"{max(per_src.max(), per_dst.max()):.6g} > "
                f"d_hat*(1-recfg) = {budget:.6g} — not a partial matching")
        if out and len(out) >= 4:
            out.append("matchings: C5[matching] ... (truncated)")
            break
    return out


def _c6_domination(cap: np.ndarray, demand: np.ndarray, bound_q: float,
                   tol: float) -> list[str]:
    short = cap < bound_q * demand - tol
    if short.any():
        i, j = map(int, np.argwhere(short)[0])
        return [
            f"domination: C6[capacity] emulated capacity {cap[i, j]:.6g} "
            f"< bound * demand = {bound_q * demand[i, j]:.6g} at "
            f"({i}, {j}) — the capacity-domination lemma fails"]
    return []


def certify_schedule(m: np.ndarray, sched, k: int | None = None,
                     normalize: str | None = None,
                     tol: float = 1e-9, device=None) -> CertifyResult:
    """Statically verify Theorem-3-level properties of ``sched`` against
    demand ``m``.  ``k``/``normalize`` default to the schedule's own
    ``meta`` (a solo or batched Vermilion build records both).  Pure
    matrix checks — nothing is simulated.  ``device``: where
    ``normalize="saturate"`` re-derives the scaled demand (``None``: the
    card)."""
    m = np.asarray(m, dtype=np.float64)
    n = sched.n
    if m.shape != (n, n):
        raise ValueError(f"demand shape {m.shape} != schedule n = {n}")
    k = int(sched.meta.get("k", 0)) if k is None else int(k)
    if k < 2:
        raise ValueError("k >= 2 required (pass k= or build with meta)")
    normalize = (sched.meta.get("normalize", "hose")
                 if normalize is None else normalize)

    res = CertifyResult()
    scaled = vermilion_scaled_demands([m], k=k, normalize=normalize,
                                      device=device)[0]
    rounded = vermilion_rounded([m], k=k, normalize=normalize,
                                device=device)[0]
    # the normalized demand at hose rate d_hat: what Theorem 3 guarantees
    # against, recovered from the exact matrix the construction scaled
    norm = scaled / ((k - 1) * n)
    demand = norm * sched.d_hat

    res.quantized_bound = quantized_theorem3_bound(
        k, sched.d_hat, n, sched.recfg_frac)
    res.asymptotic_bound = theorem3_bound(k, sched.recfg_frac)

    res._record("C1_perms", _c1_perms(sched))
    res._record("C2_period", _c2_period(sched, k))
    res._record("C3_rounding", _c3_rounding(scaled, rounded, k, n, tol))
    res._record("C4_emulation", _c4_emulation(sched, rounded, k))
    res._record("C5_matchings", _c5_matchings(sched, tol))

    cap = sched.emulated_capacity(1.0)
    res._record("C6_domination",
                _c6_domination(cap, demand, res.quantized_bound, tol))

    res.theta = throughput_single_hop(cap, demand)
    c7 = []
    if res.theta < res.quantized_bound - tol:
        c7.append(
            f"throughput: C7[theta] worst-case theta {res.theta:.6g} < "
            f"quantized Theorem-3 bound {res.quantized_bound:.6g} — the "
            "formal guarantee does not hold for this schedule")
    res._record("C7_throughput", c7)

    res.certificate = {
        "version": 1,
        "schedule": {
            "name": sched.name, "n": n, "T": sched.T,
            "n_slots": sched.n_slots, "d_hat": sched.d_hat,
            "recfg_frac": sched.recfg_frac, "k": k,
            "normalize": normalize,
            "meta": {k_: v for k_, v in sched.meta.items()
                     if isinstance(v, (int, float, str, bool))},
        },
        "demand": {
            "shape": list(m.shape),
            "sum": float(m.sum()),
            "sha256": hashlib.sha256(
                np.ascontiguousarray(m).tobytes()).hexdigest(),
        },
        "bounds": {
            "theta": res.theta,
            "quantized_theorem3": res.quantized_bound,
            "asymptotic_theorem3": res.asymptotic_bound,
        },
        "checks": dict(res.checks),
        "violations": list(res.violations),
    }
    return res


def batch_parity(mats, k: int = 3, d_hat: int = 1, recfg_frac: float = 0.0,
                 seed: int = 0, normalize: str = "hose",
                 method: str = "euler", device=None) -> list[str]:
    """Pin the batched construction against the solo path: the batched
    Bacharach flow + merged Euler cascade must reproduce every solo
    schedule's permutations bit-for-bit.  ``device``: where
    ``normalize="saturate"`` projects (``None``: the card)."""
    batch = vermilion_schedules(list(mats), k=k, d_hat=d_hat,
                                recfg_frac=recfg_frac, seed=seed,
                                normalize=normalize, method=method,
                                device=device)
    out = []
    for i, m in enumerate(mats):
        solo = vermilion_schedule(m, k=k, d_hat=d_hat,
                                  recfg_frac=recfg_frac, seed=seed,
                                  normalize=normalize, method=method,
                                  device=device)
        if not np.array_equal(batch[i].perms, solo.perms):
            diff = int((batch[i].perms != solo.perms).sum())
            out.append(
                f"batch: C8[batch] matrix {i}: batched perms differ from "
                f"the solo construction in {diff} entries — "
                "vermilion_schedules lost bit-parity with "
                "vermilion_schedule")
    return out


# -- CLI --------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.certify",
        description="Static Theorem-3 certification of a built schedule.")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--demand", default=None, metavar="PATH",
                     help="demand matrix as .npy (square, nonnegative)")
    src.add_argument("--case", default="skewed",
                     choices=sorted(DEMAND_CASES),
                     help="builtin golden demand generator (default: "
                          "skewed)")
    ap.add_argument("--n", type=int, default=16,
                    help="fabric size for --case (default: 16)")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--d-hat", type=int, default=2)
    ap.add_argument("--recfg-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--normalize", default="hose",
                    choices=("hose", "saturate"))
    ap.add_argument("--method", default="euler", choices=("euler", "hk"))
    ap.add_argument("--no-spread", action="store_true",
                    help="build without the golden-ratio matching spread")
    ap.add_argument("--batch-check", action="store_true",
                    help="also pin batched vs solo construction parity")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable certificate here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where a saturate "
                         "projection runs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.demand:
        m = np.load(args.demand)
    else:
        m = demand_case(args.case, args.n, seed=args.seed)

    sched = vermilion_schedule(
        m, k=args.k, d_hat=args.d_hat, recfg_frac=args.recfg_frac,
        seed=args.seed, spread=not args.no_spread,
        normalize=args.normalize, method=args.method, device=dev)

    res = certify_schedule(m, sched, k=args.k, normalize=args.normalize,
                           device=dev)
    if args.batch_check:
        bv = batch_parity(
            [m, demand_case("uniform", m.shape[0], seed=args.seed)],
            k=args.k, d_hat=args.d_hat, recfg_frac=args.recfg_frac,
            seed=args.seed, normalize=args.normalize, method=args.method,
            device=dev)
        res.checks["C8_batch"] = "pass" if not bv else "fail"
        res.violations.extend(bv)
        res.certificate["checks"] = dict(res.checks)
        res.certificate["violations"] = list(res.violations)

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(res.certificate, f, indent=1)
            f.write("\n")

    for check, status in res.checks.items():
        print(f"{check}: {status}")
    print(f"theta = {res.theta:.6f}  (quantized bound "
          f"{res.quantized_bound:.6f}, asymptotic (k-1)/k "
          f"{res.asymptotic_bound:.6f})")
    for v in res.violations:
        print(v)
    if res.violations:
        print(f"\n{len(res.violations)} certificate violation(s)")
        return 1
    print("\ncertificate holds: worst-case throughput formally >= "
          f"{res.quantized_bound:.6f} with no simulation")
    return 0


if __name__ == "__main__":
    sys.exit(main())
