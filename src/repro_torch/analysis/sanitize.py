"""Runtime simulation sanitizer of the port: per-run contract checks.

The port's copy of the parts of ``repro.analysis.sanitize`` that the
single-hop sweep uses.  Enabled with ``REPRO_SANITIZE=1`` (read at call
time) or explicitly via ``run_sweep(..., sanitize=True)``.  Checks only
*observe* state the engine already holds — a sanitized run is
bit-identical to an unsanitized one.

Contracts:

* **Bit conservation** — injected bits = delivered + still-queued.
* **Schedule validity** — every ``Schedule.perms`` row is a permutation.
* **Flow-credit closure** — bits credited to flows by the processor-
  sharing tracker match the bits the data plane delivered.
* **Shape/dtype contracts** — on workloads.

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

