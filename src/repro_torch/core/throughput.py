"""Throughput (Definition 2) of emulated graphs: exact LP + closed forms.

Max concurrent flow with source-aggregated commodities (n^3 variables rather
than the n^4 of the paper's Appendix C formulation — same optimum), solved
with scipy/HiGHS.  Single-hop throughput has the closed form
``min_{m_uv>0} cap_uv / m_uv``.

The port's own copy of ``repro.core.throughput``: host numpy/scipy code,
built as the reference builds it, so equal inputs give equal results.  It
does no device work: :func:`vermilion_throughput` builds its schedule
under ``normalize="hose"``, which projects nothing.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linprog
from scipy.sparse import coo_matrix

from .schedule import (
    Schedule,
    oblivious_schedule,
    vermilion_schedule,
)
from .traffic import hose_normalize

__all__ = [
    "throughput_single_hop",
    "throughput_multi_hop",
    "schedule_throughput",
    "vermilion_throughput",
    "oblivious_throughput",
    "theorem3_bound",
    "quantized_theorem3_bound",
]


def throughput_single_hop(cap: np.ndarray, m: np.ndarray) -> float:
    """theta = min over demands of direct capacity / demand."""
    cap = np.asarray(cap, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    mask = m > 0
    if not mask.any():
        return float("inf")
    with np.errstate(divide="ignore"):
        ratio = np.where(mask, cap / np.where(mask, m, 1.0), np.inf)
    return float(ratio[mask].min())


def throughput_multi_hop(cap: np.ndarray, m: np.ndarray) -> float:
    """Max concurrent flow (ideal routing) on capacity graph ``cap``.

    Variables: theta, f[s, e] for each source s and directed edge e with
    cap > 0. Conservation at every node j != s:
        sum_in f - sum_out f = theta * m[s, j]
    Capacity per edge: sum_s f[s, e] <= cap[e].
    """
    cap = np.asarray(cap, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    n = cap.shape[0]
    ei, ej = np.nonzero(cap > 0)
    ne = len(ei)
    if (m > 0).sum() == 0:
        return float("inf")
    if ne == 0:
        return 0.0
    nvar = 1 + n * ne  # theta, then f[s, e] row-major

    def fvar(s: int, e: np.ndarray) -> np.ndarray:
        return 1 + s * ne + e

    rows, cols, vals = [], [], []
    # conservation rows: (s, j) for j != s  -> row id s*(n) + j (skip j==s)
    beq_rows = []
    rid = 0
    edge_ids = np.arange(ne)
    in_edges = [edge_ids[ej == j] for j in range(n)]
    out_edges = [edge_ids[ei == j] for j in range(n)]
    for s in range(n):
        for j in range(n):
            if j == s:
                continue
            ie, oe = in_edges[j], out_edges[j]
            rows += [rid] * (len(ie) + len(oe) + 1)
            cols += list(fvar(s, ie)) + list(fvar(s, oe)) + [0]
            vals += [1.0] * len(ie) + [-1.0] * len(oe) + [-float(m[s, j])]
            beq_rows.append(0.0)
            rid += 1
    a_eq = coo_matrix((vals, (rows, cols)), shape=(rid, nvar))
    b_eq = np.asarray(beq_rows)

    # capacity rows
    rows2 = np.tile(edge_ids, n)
    cols2 = np.concatenate([fvar(s, edge_ids) for s in range(n)])
    a_ub = coo_matrix(
        (np.ones(n * ne), (rows2, cols2)), shape=(ne, nvar)
    )
    b_ub = cap[ei, ej]

    c = np.zeros(nvar)
    c[0] = -1.0
    res = linprog(
        c, A_ub=a_ub.tocsr(), b_ub=b_ub, A_eq=a_eq.tocsr(), b_eq=b_eq,
        bounds=(0, None), method="highs",
    )
    if not res.success:  # pragma: no cover
        raise RuntimeError(f"throughput LP failed: {res.message}")
    return float(res.x[0])


def schedule_throughput(
    sched: Schedule, m: np.ndarray, c: float = 1.0, multi_hop: bool = False
) -> float:
    cap = sched.emulated_capacity(c)
    fn = throughput_multi_hop if multi_hop else throughput_single_hop
    return fn(cap, m)


def vermilion_throughput(
    m: np.ndarray, k: int = 3, d_hat: int = 1,
    recfg_frac: float = 0.0, seed: int = 0,
) -> float:
    """Vermilion is evaluated single-hop only (its design point)."""
    sched = vermilion_schedule(m, k=k, d_hat=d_hat,
                               recfg_frac=recfg_frac, seed=seed)
    # demand within the hose model at d_hat links of capacity c=d_hat here:
    # normalize demand the same way Theorem 3 does (hose w.r.t. d_hat*c).
    demand = hose_normalize(m, d_hat=float(d_hat))
    return schedule_throughput(sched, demand, c=1.0, multi_hop=False)


def oblivious_throughput(
    m: np.ndarray, d_hat: int = 1, recfg_frac: float = 0.0,
    multi_hop: bool = True,
) -> float:
    n = m.shape[0]
    sched = oblivious_schedule(n, d_hat=d_hat, recfg_frac=recfg_frac)
    demand = hose_normalize(m, d_hat=float(d_hat))
    return schedule_throughput(sched, demand, c=1.0, multi_hop=multi_hop)


def theorem3_bound(k: int, recfg_frac: float = 0.0) -> float:
    return (k - 1) / k * (1.0 - recfg_frac)


def quantized_theorem3_bound(
    k: int, d_hat: int, n: int, recfg_frac: float = 0.0
) -> float:
    """Theorem 3's guarantee as a *finite* period actually achieves it.

    A Vermilion period is T = k*n matchings on d_hat planes, so it spans
    ``n_slots = ceil(k*n / d_hat)`` timeslots; the traffic-aware layer
    guarantees at least (k-1)*n * (1 - recfg_frac) circuit-slots of direct
    capacity per demand unit over those slots.  When ``d_hat | k*n`` this
    is exactly ``theorem3_bound(k, recfg_frac)``; otherwise the ceiling
    rounds the period up and the achievable bound dips by the slack slot.
    This is the statically-checkable form :mod:`repro_torch.analysis.certify`
    verifies a built schedule against.
    """
    n_slots = -(-(k * n) // d_hat)
    return (k - 1) * n * (1.0 - recfg_frac) / (d_hat * n_slots)
