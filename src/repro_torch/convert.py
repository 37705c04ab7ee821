"""Carry schedules and workloads across from the JAX package.

Duck-typed: any object with the reference's fields converts, so the port
never imports ``repro``.  The tests use it to run both packages on the
same objects, which makes the data-plane parity independent of the
construction parity.
"""
from __future__ import annotations

import numpy as np

from .core.schedule import Schedule
from .core.simulator import Workload

__all__ = ["schedule_from", "workload_from"]


def schedule_from(s) -> Schedule:
    """The port's :class:`Schedule` with ``s``'s ``perms``, ``d_hat``,
    ``recfg_frac``, ``name`` and ``meta``."""
    return Schedule(perms=np.array(s.perms, dtype=np.int64),
                    d_hat=int(s.d_hat), recfg_frac=float(s.recfg_frac),
                    name=str(s.name), meta=dict(s.meta))


def workload_from(wl) -> Workload:
    """The port's :class:`Workload` with ``wl``'s ``src``, ``dst``,
    ``size``, ``arrival``, ``n`` and ``horizon``."""
    return Workload(src=np.array(wl.src, dtype=np.int64),
                    dst=np.array(wl.dst, dtype=np.int64),
                    size=np.array(wl.size, dtype=np.float64),
                    arrival=np.array(wl.arrival, dtype=np.int64),
                    n=int(wl.n), horizon=int(wl.horizon))
