"""Timed fault injection for the fabric: events, validation, and the
compiled per-slot fault timeline the engines consume.

The port's own copy of ``repro.core.faults`` (host numpy; it imports
nothing of ``repro``).  The paper's model assumes a pristine fabric;
production fabrics lose port planes, drain ToRs for maintenance, and flap
links.  A :class:`FaultSchedule` is a validated, immutable list of timed
:class:`FaultEvent`\\ s over the simulation horizon:

* ``plane_down`` / ``plane_up`` — an entire port plane (one of the
  ``d_hat`` parallel matching planes) goes dark / recovers.  Every
  circuit formed by a matching on that plane carries nothing.
* ``port_down``  — one ToR's transceiver on one plane dies permanently
  (both its transmit and receive side: the plane's circuits into and out
  of that node go dark).
* ``link_flap``  — the same transceiver goes dark for ``duration`` slots
  and then recovers on its own.
* ``tor_drain``  — graceful maintenance drain: the ToR stops *injecting*
  (new flow arrivals at that node are refused at the ingress and never
  enter a VOQ) but keeps forwarding, so every already-queued bit drains
  out.  No bits are ever lost to a drain.
* ``tor_fail``   — abrupt ToR death: its rows and columns go dark on
  every plane, injection stops, and the bits sitting in its VOQs at the
  failure slot are stranded.  The engines charge those bits to an
  explicit ``fault_lost_bits`` ledger so the sanitizer's bit-conservation
  invariant (injected = delivered + queued + fault_lost) still closes.

:meth:`FaultSchedule.compile` produces a :class:`FaultTimeline` — a tiny
per-run state machine advanced once per slot.  The timeline depends on
the slot alone, so the sweep replays it on the host before serving and
lays out the masked plans, the refused arrivals and the flushed rows
ahead of the data plane.  It is *clean* until the first event fires, so
a run's prefix before any fault (and the whole run, for an empty
schedule) takes the engines' unchanged fast paths and stays bit-identical
to a fault-free run.  State is O(n * d_hat) booleans.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultSchedule",
    "FaultTimeline",
    "claims_fault_mask",
]

FAULT_KINDS = ("plane_down", "plane_up", "port_down", "tor_drain",
               "tor_fail", "link_flap")

# which fields each kind requires (node / plane targets; duration)
_NEEDS_NODE = frozenset({"port_down", "tor_drain", "tor_fail", "link_flap"})
_NEEDS_PLANE = frozenset({"plane_down", "plane_up", "port_down",
                          "link_flap"})


@dataclass(frozen=True)
class FaultEvent:
    """One timed fault event.  ``node`` / ``plane`` / ``duration`` are
    required or forbidden per ``kind`` (see :data:`FAULT_KINDS` and
    :meth:`FaultSchedule.validate`); unused targets stay -1 / 0."""

    slot: int
    kind: str
    node: int = -1
    plane: int = -1
    duration: int = 0


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, validated set of timed fault events.

    Falsy when empty — the engines treat an empty schedule exactly like
    no schedule at all (golden-pinned bit-identical in
    tests/test_faults.py).
    """

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))

    def __bool__(self) -> bool:
        return bool(self.events)

    def validate(self, n: int, d_hat: int) -> None:
        """Raise ``ValueError`` on any malformed event: unknown kind,
        negative slot, out-of-range node/plane target, a target supplied
        for a kind that takes none, or a non-positive flap duration."""
        for i, ev in enumerate(self.events):
            tag = f"fault event {i} ({ev.kind!r} @ slot {ev.slot})"
            if not isinstance(ev, FaultEvent):
                raise ValueError(f"fault event {i} must be a FaultEvent "
                                 f"(got {type(ev).__name__})")
            if ev.kind not in FAULT_KINDS:
                raise ValueError(
                    f"{tag}: unknown kind; must be one of {FAULT_KINDS}")
            if not isinstance(ev.slot, (int, np.integer)) or ev.slot < 0:
                raise ValueError(f"{tag}: slot must be a nonnegative int "
                                 f"(got {ev.slot!r})")
            if ev.kind in _NEEDS_NODE:
                if not (0 <= ev.node < n):
                    raise ValueError(
                        f"{tag}: node must be in [0, {n}) (got {ev.node})")
            elif ev.node != -1:
                raise ValueError(f"{tag}: takes no node target "
                                 f"(got node={ev.node})")
            if ev.kind in _NEEDS_PLANE:
                if not (0 <= ev.plane < d_hat):
                    raise ValueError(
                        f"{tag}: plane must be in [0, {d_hat}) "
                        f"(got {ev.plane})")
            elif ev.plane != -1:
                raise ValueError(f"{tag}: takes no plane target "
                                 f"(got plane={ev.plane})")
            if ev.kind == "link_flap":
                if ev.duration < 1:
                    raise ValueError(f"{tag}: flap duration must be >= 1 "
                                     f"(got {ev.duration})")
            elif ev.duration:
                raise ValueError(f"{tag}: takes no duration "
                                 f"(got {ev.duration})")

    def compile(self, n: int, d_hat: int) -> "FaultTimeline":
        """Validate and compile into a runtime :class:`FaultTimeline`."""
        self.validate(n, d_hat)
        return FaultTimeline(self.events, n, d_hat)


class FaultTimeline:
    """Per-run fault state machine: the engines call :meth:`advance`
    once per slot (slots strictly increasing) and read the boolean state
    arrays between calls.

    State (all small, O(n * d_hat)):

    * ``plane_ok``    — (d_hat,) plane is up (plane_down / plane_up).
    * ``port_dead``   — (n, d_hat) transceiver permanently dead
      (port_down), plus ``flap_dark`` transient counts (link_flap).
    * ``node_alive``  — (n,) False after ``tor_fail``.
    * ``inject_ok``   — (n,) False after ``tor_drain`` or ``tor_fail``.

    ``version`` bumps on every state change, so engines can memoize
    fault-masked slot plans on it.  ``clean`` is True while nothing has
    ever degraded — the engines' unchanged fast path.
    """

    def __init__(self, events: tuple[FaultEvent, ...], n: int,
                 d_hat: int) -> None:
        self.n = n
        self.d_hat = d_hat
        self.plane_ok = np.ones(d_hat, dtype=bool)
        self.port_dead = np.zeros((n, d_hat), dtype=bool)
        self.flap_dark = np.zeros((n, d_hat), dtype=np.int64)
        self.node_alive = np.ones(n, dtype=bool)
        self.inject_ok = np.ones(n, dtype=bool)
        self.version = 0
        self.clean = True
        # expand flaps into down/up pairs, then sort the op list by slot
        ops: list[tuple[int, str, int, int]] = []
        for ev in events:
            if ev.kind == "link_flap":
                ops.append((ev.slot, "flap_down", ev.node, ev.plane))
                ops.append((ev.slot + ev.duration, "flap_up", ev.node,
                            ev.plane))
            else:
                ops.append((ev.slot, ev.kind, ev.node, ev.plane))
        self._ops = sorted(ops, key=lambda o: o[0])
        self._next = 0

    def advance(self, slot: int) -> np.ndarray:
        """Apply every op scheduled at or before ``slot``; returns the
        array of node ids that *newly* tor_failed this call (the engine
        must flush their VOQs to the fault-lost ledger)."""
        failed: list[int] = []
        while self._next < len(self._ops) and self._ops[self._next][0] <= slot:
            _, kind, node, plane = self._ops[self._next]
            self._next += 1
            self.version += 1
            self.clean = False
            if kind == "plane_down":
                self.plane_ok[plane] = False
            elif kind == "plane_up":
                self.plane_ok[plane] = True
            elif kind == "port_down":
                self.port_dead[node, plane] = True
            elif kind == "flap_down":
                self.flap_dark[node, plane] += 1
            elif kind == "flap_up":
                self.flap_dark[node, plane] -= 1
            elif kind == "tor_drain":
                self.inject_ok[node] = False
            elif kind == "tor_fail":
                if self.node_alive[node]:
                    failed.append(node)
                self.node_alive[node] = False
                self.inject_ok[node] = False
        return np.asarray(failed, dtype=np.int64)

    def link_ok(self) -> np.ndarray:
        """(n, d_hat) bool: node i's plane-p transceiver is usable —
        the node is alive, the plane is up, the port is neither dead nor
        mid-flap.  A circuit u -> v on plane p is live iff
        ``link_ok[u, p] & link_ok[v, p]``."""
        return (self.node_alive[:, None] & self.plane_ok[None, :]
                & ~self.port_dead & (self.flap_dark == 0))


def claims_fault_mask(claims: np.ndarray, link_ok: np.ndarray,
                      plane_map: np.ndarray | None = None) -> np.ndarray:
    """Which per-slot circuit claims survive the current fault state.

    ``claims`` is the (P, n) block of effective perms rows serving one
    slot (row p = the matching on *logical* plane p; ``claims[p, i]`` the
    output port input i is tuned to).  ``plane_map`` maps logical plane
    rows to physical planes (identity by default; a repaired schedule
    built for the surviving planes passes the survivors).  Returns a
    (P, n) bool mask: both endpoints' transceivers on the physical plane
    are up.
    """
    P, n = claims.shape
    planes = (np.arange(P, dtype=np.int64) if plane_map is None
              else np.asarray(plane_map, dtype=np.int64)[:P])
    tx = link_ok.T[planes]                       # (P, n): sender side up
    rx = link_ok[claims, planes[:, None]]        # (P, n): receiver side up
    return tx & rx
