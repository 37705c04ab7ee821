"""Runtime simulation sanitizer of the port: per-run contract checks.

The port's copy of the parts of ``repro.analysis.sanitize`` that the
single-hop sweep and the adaptive loop use.  Enabled with
``REPRO_SANITIZE=1`` (read at call time) or explicitly via
``run_sweep(..., sanitize=True)`` / ``run_adaptive(..., sanitize=True)``.  Checks only
*observe* state the engine already holds — a sanitized run is
bit-identical to an unsanitized one.

Contracts:

* **Bit conservation** — injected bits = delivered + still-queued +
  fault-lost (bits stranded by ``tor_fail``).
* **Schedule validity** — every ``Schedule.perms`` row is a permutation,
  and every installed per-slot circuit set is a partial matching
  post-arbitration: per-source and per-destination capacity within
  ``d_hat * bits_per_slot * (1 - recfg_frac)``, no self-loops.
* **Disagreement-accounting closure** — a merged per-node plan's
  ``lost[s]`` (capacity lost to output-port collisions) never exceeds the
  capacity of that slot's contested traffic-carrying claims.
* **Flow-credit closure** — bits credited to flows by the processor-
  sharing tracker match the bits the data plane delivered.
* **Shape/dtype contracts** — on workloads and ring views.

``rtol`` covers float64 host engines, ``rtol32`` the float32 data plane.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["SanitizeError", "Sanitizer", "make_sanitizer", "sanitize_enabled"]


class SanitizeError(AssertionError):
    """A simulation contract was violated (see :class:`Sanitizer`)."""


def sanitize_enabled(flag: bool | None = None) -> bool:
    """Resolve an engine's ``sanitize=`` argument: an explicit True/False
    wins; ``None`` defers to the ``REPRO_SANITIZE`` environment variable
    (read at call time, so ``monkeypatch.setenv`` works)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() not in (
        "", "0", "false", "no", "off")


def make_sanitizer(flag: bool | None = None, **kwargs) -> "Sanitizer | None":
    """A :class:`Sanitizer` if sanitizing is enabled, else ``None`` — the
    engines guard every check site with ``if san is not None``."""
    return Sanitizer(**kwargs) if sanitize_enabled(flag) else None


class Sanitizer:
    """Read-only contract checks over engine state.

    ``counts`` records how many times each named check ran, so tests can
    assert coverage (that a sanitized run actually exercised the checks)
    without peeking into engine internals.
    """

    def __init__(self, rtol: float = 1e-5, atol: float = 1e-3,
                 rtol32: float = 5e-3):
        self.rtol = float(rtol)      # float64 engines
        self.atol = float(atol)      # absolute slack, in bits
        self.rtol32 = float(rtol32)  # float32 (jax) engines
        self.counts: dict[str, int] = {}
        self.context: str | None = None

    # -- plumbing -----------------------------------------------------------

    def _ran(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def set_context(self, context: str | None) -> None:
        """Ambient run context (case label / epoch / slot) prefixed to every
        violation message — a ledger break at slot 4000 of a 48-case grid
        names its case instead of being a needle in a haystack."""
        self.context = context

    def _fail(self, name: str, msg: str) -> None:
        ctx = f" [{self.context}]" if self.context else ""
        raise SanitizeError(f"[sanitize:{name}]{ctx} {msg}")

    def _tol(self, scale: float, float32: bool = False) -> float:
        return (self.rtol32 if float32 else self.rtol) * max(
            abs(scale), 1.0) + self.atol

    # -- shape/dtype contracts ----------------------------------------------

    def check_workload(self, wl) -> None:
        """Entry contract of ``simulate``/``run_sweep``/``run_adaptive``:
        index dtypes, bounds, sorted arrivals, nonnegative finite sizes,
        no self-directed flows (a circuit fabric never serves src == dst —
        such bits would sit queued forever)."""
        self._ran("workload")
        name = "workload"
        fields = {"src": wl.src, "dst": wl.dst, "arrival": wl.arrival}
        F = len(wl.size)
        for fname, arr in fields.items():
            if not isinstance(arr, np.ndarray) or arr.shape != (F,):
                self._fail(name, f"{fname} must be a ({F},) ndarray "
                                 f"(got {type(arr).__name__} "
                                 f"{getattr(arr, 'shape', None)})")
            if not np.issubdtype(arr.dtype, np.integer):
                self._fail(name, f"{fname} must be integer-typed "
                                 f"(got {arr.dtype})")
        if not np.issubdtype(np.asarray(wl.size).dtype, np.floating):
            self._fail(name, f"size must be float-typed (got "
                             f"{np.asarray(wl.size).dtype})")
        if F == 0:
            return
        if wl.src.min() < 0 or wl.src.max() >= wl.n \
                or wl.dst.min() < 0 or wl.dst.max() >= wl.n:
            self._fail(name, f"src/dst out of [0, {wl.n})")
        if (wl.src == wl.dst).any():
            self._fail(name, "self-directed flows (src == dst) are never "
                             "served by a circuit fabric")
        if not np.isfinite(wl.size).all() or (np.asarray(wl.size) < 0).any():
            self._fail(name, "flow sizes must be finite and >= 0")
        if wl.arrival.min() < 0:
            self._fail(name, "arrival slots must be >= 0")
        if (np.diff(wl.arrival) < 0).any():
            self._fail(name, "arrivals must be sorted ascending "
                             "(the engines bucket by contiguous slices)")

    def check_schedule(self, sched) -> None:
        """Every perms row must be a permutation of range(n) (the paper's
        doubly-stochastic emulated-graph premise), footprint fields sane."""
        self._ran("schedule")
        name = f"schedule:{getattr(sched, 'name', '?')}"
        perms = sched.perms
        if perms.ndim != 2 or not np.issubdtype(perms.dtype, np.integer):
            self._fail(name, f"perms must be a 2-D integer array "
                             f"(got {perms.dtype} ndim={perms.ndim})")
        t_count, n = perms.shape
        if t_count == 0 or n == 0:
            self._fail(name, f"degenerate perms shape {(t_count, n)}")
        # row r is a permutation iff its sorted values are exactly 0..n-1
        if not np.array_equal(np.sort(perms, axis=1),
                              np.broadcast_to(np.arange(n), (t_count, n))):
            bad = np.flatnonzero(~(np.sort(perms, axis=1)
                                   == np.arange(n)).all(axis=1))[:4]
            self._fail(name, f"perms rows {bad.tolist()} are not "
                             "permutations of range(n) — the matching "
                             "decomposition emitted an invalid circuit set")
        if sched.d_hat < 1:
            self._fail(name, f"d_hat must be >= 1 (got {sched.d_hat})")
        if not (0.0 <= sched.recfg_frac < 1.0):
            self._fail(name, f"recfg_frac must be in [0, 1) "
                             f"(got {sched.recfg_frac})")

    def check_views(self, views) -> None:
        """Ring-AllGather output contract (``estimate_all_views``): boolean
        square ownership mask with every node holding its own row, finite
        nonnegative dequantized rows of matching shape."""
        self._ran("views")
        name = "views"
        have, rows = views.have, views.rows
        if have.dtype != np.bool_ or have.ndim != 2 \
                or have.shape[0] != have.shape[1]:
            self._fail(name, f"have must be a square bool mask "
                             f"(got {have.dtype} {have.shape})")
        if rows.shape[0] != have.shape[0]:
            self._fail(name, f"rows/have node counts differ: "
                             f"{rows.shape[0]} != {have.shape[0]}")
        if not np.diagonal(have).all():
            self._fail(name, "every node must hold its own row from slot 0 "
                             "(have diagonal contains False)")
        if not np.isfinite(rows).all() or (rows < 0).any():
            self._fail(name, "dequantized rows must be finite and >= 0 "
                             "(quantizer ticks cannot go negative)")

    # -- partial-matching / plan validity -----------------------------------

    def check_support(self, src: np.ndarray, dst: np.ndarray,
                      cap: np.ndarray, n: int, d_hat: int, w: float,
                      label: str = "support") -> None:
        """One slot's circuit set is a partial matching post-arbitration:
        capacities nonnegative, no self-loops, and per-source / per-
        destination totals within ``d_hat * w`` (w = per-circuit bits after
        the reconfiguration guard band)."""
        self._ran("support")
        name = label
        if (cap < 0).any():
            self._fail(name, "negative circuit capacity")
        if (src == dst).any():
            self._fail(name, "self-loop circuit in the served support "
                             "(self-loops must be dropped pre-merge)")
        budget = d_hat * w
        tol = self._tol(budget)
        per_src = np.bincount(src, weights=cap, minlength=n)
        per_dst = np.bincount(dst, weights=cap, minlength=n)
        if per_src.max(initial=0.0) > budget + tol:
            self._fail(name, f"source port over-committed: "
                             f"{per_src.max():.6g} > d_hat*w = {budget:.6g} "
                             "(slot support is not a partial matching)")
        if per_dst.max(initial=0.0) > budget + tol:
            self._fail(name, f"output port over-claimed: "
                             f"{per_dst.max():.6g} > d_hat*w = {budget:.6g} "
                             "(collision resolution must leave one winner)")

    def check_plan_pairs(self, pid: np.ndarray, cap: np.ndarray, n: int,
                         d_hat: int, w: float,
                         label: str = "plan") -> None:
        """:meth:`check_support` for flattened ``src * n + dst`` pair ids
        (the sparse engines' native plan format)."""
        self.check_support(pid // n, pid % n, cap, n, d_hat, w, label=label)

    def check_fabric_plan(self, fp, n: int, d_hat: int, w: float) -> None:
        """A merged (collision-resolved) circuit plan: every slot a partial
        matching, loss accounting nonnegative and — when the plan carries
        per-slot contested-claim counts — closed: ``lost[s]`` can never
        exceed the capacity of slot s's contested traffic-carrying claims
        (arbitration recovers claims, it never invents loss).  Dynamic
        plans (``fp.plans is None`` — queue-aware arbitration resolves
        winners per served slot) skip the per-slot support checks."""
        self._ran("fabric_plan")
        name = f"fabric_plan:g{fp.groups}"
        if fp.plans is not None and len(fp.plans) != fp.n_slots:
            self._fail(name, f"plan length != n_slots ({fp.n_slots})")
        if len(fp.lost) != fp.n_slots:
            self._fail(name, f"lost length != n_slots ({fp.n_slots})")
        if not (0.0 <= fp.disagreement <= 1.0):
            self._fail(name, f"disagreement {fp.disagreement} not in [0, 1]")
        if (fp.lost < 0).any():
            self._fail(name, "negative collision loss")
        for s, (pid, cap) in enumerate(fp.plans or ()):
            self.check_plan_pairs(pid, cap, n, d_hat, w,
                                  label=f"{name}:slot{s}")
        bound = fp.contested * w
        tol = self._tol(float(bound.max(initial=0.0)))
        if (fp.lost > bound + tol).any():
            s = int(np.argmax(fp.lost - bound))
            self._fail(name, f"slot {s} collision loss {fp.lost[s]:.6g} "
                             f"exceeds its contested-claim capacity "
                             f"{bound[s]:.6g} — disagreement accounting "
                             "does not close")
        if fp.groups == 1:
            if fp.disagreement != 0.0 or fp.lost.any():
                self._fail(name, "a consistent fabric (one schedule) must "
                                 "have zero disagreement and zero loss")

    def check_caps_dense(self, caps: np.ndarray, d_hat: int, w: float,
                         label: str = "caps") -> None:
        """Dense ``(n_slots, n, n)`` per-slot capacity LUT contract (the
        dense engines): nonnegative, zero diagonal, per-source and per-
        destination slot totals within ``d_hat * w``."""
        self._ran("caps_dense")
        name = label
        if caps.ndim != 3 or caps.shape[1] != caps.shape[2]:
            self._fail(name, f"expected (n_slots, n, n) caps "
                             f"(got {caps.shape})")
        if (caps < 0).any():
            self._fail(name, "negative capacity")
        n = caps.shape[1]
        if caps[:, np.arange(n), np.arange(n)].any():
            self._fail(name, "self-loop capacity on the served support")
        budget = d_hat * w
        tol = self._tol(budget)
        if caps.sum(axis=2).max(initial=0.0) > budget + tol:
            self._fail(name, "source port over-committed in a slot "
                             "(not a partial matching)")
        if caps.sum(axis=1).max(initial=0.0) > budget + tol:
            self._fail(name, "output port over-claimed in a slot "
                             "(not a partial matching)")

    # -- conservation / closure ---------------------------------------------

    def check_conservation(self, injected: float, delivered: float,
                           queued: float, label: str = "conservation",
                           float32: bool = False,
                           fault_lost: float = 0.0) -> None:
        """Bit ledger: injected = delivered + still-queued + fault-lost,
        within the engine's float budget.  ``queued`` must include every
        holding structure (VOQ + relay buckets); capacity-side losses
        (collisions, dark windows) leave bits queued and so never appear
        here.  ``fault_lost`` is the explicit ledger of bits stranded by
        abrupt failures (``tor_fail`` VOQ flushes) — zero on a fault-free
        run, and the only term that may absorb bits the data plane will
        never deliver."""
        self._ran("conservation")
        if fault_lost < 0:
            self._fail(label, f"negative fault_lost ledger ({fault_lost:.6g})")
        resid = injected - (delivered + queued + fault_lost)
        if abs(resid) > self._tol(injected, float32=float32):
            self._fail(label,
                       f"bits not conserved: injected {injected:.6g} != "
                       f"delivered {delivered:.6g} + queued {queued:.6g} "
                       f"+ fault_lost {fault_lost:.6g} "
                       f"(residual {resid:.6g})")

    def check_credit_closure(self, injected: float, delivered: float,
                             remaining_active: float, completed: int,
                             label: str = "credit",
                             float32: bool = False) -> None:
        """Processor-sharing credit closure: bits credited to flows
        (injected - remaining on active flows) match bits the data plane
        delivered.  Completed flows may each strand up to the tracker's
        1e-6-bit completion threshold, hence the per-completion slack.
        ``float32``: the delivered amounts came from an f32 device scan
        (the jax engines) — widen to the f32 relative budget."""
        self._ran("credit")
        credited = injected - remaining_active
        tol = self._tol(injected, float32=float32) + 2e-6 * (completed + 1)
        if abs(credited - delivered) > tol:
            self._fail(label,
                       f"flow credit does not close: credited "
                       f"{credited:.6g} (injected {injected:.6g} - active "
                       f"remaining {remaining_active:.6g}) != delivered "
                       f"{delivered:.6g}")

    def check_matrix(self, m: np.ndarray, n: int | None = None,
                     label: str = "matrix", nonneg: bool = True) -> None:
        """Square finite (optionally nonnegative) matrix contract for the
        estimation/schedule entry points."""
        self._ran("matrix")
        m = np.asarray(m)
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            self._fail(label, f"expected a square matrix (got {m.shape})")
        if n is not None and m.shape[0] != n:
            self._fail(label, f"expected ({n}, {n}) (got {m.shape})")
        if not np.isfinite(m).all():
            self._fail(label, "non-finite entries")
        if nonneg and (m < 0).any():
            self._fail(label, "negative entries")
