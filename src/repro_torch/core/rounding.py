"""Matrix rounding (Bacharach 1966) — the key primitive of Vermilion.

The port's own copy of ``repro.core.rounding`` (host numpy/scipy code; the
port imports nothing of the JAX package).

Given a nonnegative real matrix A, produce an integer matrix R with

* ``R[i, j] in {floor(A[i, j]), ceil(A[i, j])}`` for every entry,
* every row sum of R in ``{floor(rowsum_i), ceil(rowsum_i)}``,
* every column sum of R in ``{floor(colsum_j), ceil(colsum_j)}``.

Such a rounding always exists (Bacharach 1966); we compute one with a single
integral max-flow (scipy's C Dinic implementation), after augmenting A with a
slack row/column that makes every row and column sum integral.  The
fractional matrix itself is a feasible fractional flow for the constructed
network, so by flow integrality the max-flow saturates the source and yields
the rounding.

The flow network is built directly from the *fractional support* in COO
form — one dense floor pass over the input, then everything is O(F) for F
fractional cells (no dense augmented/frac/up temporaries).  Cost: one
O(n_r * n_c) floor plus an O(F * sqrt(V)) max-flow on F unit-capacity cell
arcs — sub-millisecond for n <= 64, ~tens of milliseconds at n = 512 (cf.
paper Fig 10).  :func:`round_matrices` batches several roundings into one
block-diagonal flow call, amortizing graph construction and solver dispatch
for callers holding a batch of matrices up front (an oracle's per-epoch
demand train, benchmark sweeps).  Batching pays off for many *small*
matrices (~3x per-matrix at n = 16) and breaks even around n ~ 128 —
beyond that the merged Dinic solve outweighs the saved dispatch (tracked
in ``benchmarks/schedule_time.py`` as ``round_batch8_us``).
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_flow

__all__ = ["round_matrix", "round_matrices", "check_rounding"]

_EPS = 1e-9


def _snap(a: np.ndarray, eps: float = _EPS) -> np.ndarray:
    """Snap near-integer values exactly to integers (float-noise hygiene)."""
    r = np.rint(a)
    return np.where(np.abs(a - r) <= eps, r, a)


def _frac_network(a: np.ndarray):
    """Fractional-support COO pieces of the Bacharach flow network for ``a``.

    Returns (base, cell_r, cell_c, e, g) where ``base = floor(a)``, the
    cells are the fractional positions of the (virtually) augmented matrix
    (slack column index n_c, slack row index n_r), and e / g are the
    integer per-row / per-column round-up budgets of the augmented matrix.
    """
    n_r, n_c = a.shape
    base = np.floor(a + _EPS)
    fr = _snap(a - base)
    fr[fr <= _EPS] = 0.0
    rows, cols = np.nonzero(fr)
    fvals = fr[rows, cols]

    rs = a.sum(axis=1)
    cs = a.sum(axis=0)
    slack_col = _snap(np.ceil(rs - _EPS) - rs)          # in [0, 1]
    slack_row = _snap(np.ceil(cs - _EPS) - cs)
    # corner = frac(total): makes both the slack row's and the slack
    # column's sums integral (their fractional parts are each -total mod 1).
    corner = float(_snap(np.asarray(a.sum() % 1.0)).item() % 1.0)
    scf = np.where(np.abs(slack_col - np.rint(slack_col)) <= _EPS,
                   0.0, slack_col)
    srf = np.where(np.abs(slack_row - np.rint(slack_row)) <= _EPS,
                   0.0, slack_row)

    e = np.rint(np.concatenate([
        np.bincount(rows, weights=fvals, minlength=n_r) + scf,
        [srf.sum() + corner],
    ])).astype(np.int64)
    g = np.rint(np.concatenate([
        np.bincount(cols, weights=fvals, minlength=n_c) + srf,
        [scf.sum() + corner],
    ])).astype(np.int64)
    if e.sum() != g.sum():  # pragma: no cover - defensive
        raise AssertionError("augmentation failed to balance round-ups")

    sc_i = np.flatnonzero(scf)
    sr_j = np.flatnonzero(srf)
    cell_r = np.concatenate([rows, sc_i, np.full(len(sr_j), n_r)])
    cell_c = np.concatenate([cols, np.full(len(sc_i), n_c), sr_j])
    if corner > _EPS:
        cell_r = np.concatenate([cell_r, [n_r]])
        cell_c = np.concatenate([cell_c, [n_c]])
    return base, cell_r.astype(np.int64), cell_c.astype(np.int64), e, g


def round_matrices(mats, seed: int | None = None) -> list[np.ndarray]:
    """Bacharach-round every matrix in ``mats`` with ONE max-flow call.

    The per-matrix flow networks are disjoint, so stacking them block-
    diagonally around a shared source/sink preserves integrality and
    feasibility: the batch's max flow is the sum of the per-block maxima,
    hence every block saturates and carries the same rounding guarantees as
    a solo :func:`round_matrix` call.  One scipy Dinic solve rounds the
    whole batch, amortizing graph construction and solver dispatch — for
    callers that hold several matrices up front (an oracle's per-epoch
    demand train, sweep grids); the adaptive loop's own recomputes are
    inherently sequential and cannot batch.  Worth ~3x per matrix at
    n = 16, break-even near n ~ 128, slower beyond (the merged Dinic
    solve grows faster than the saved dispatch).  Deterministic (``seed``
    accepted for API symmetry, unused).
    """
    nets = []
    off = 0
    for m in mats:
        a = _snap(np.asarray(m, dtype=np.float64))
        if a.ndim != 2:
            raise ValueError("expected a matrix")
        if (a < 0).any():
            raise ValueError("matrix must be nonnegative")
        base, cr, cc, e, g = _frac_network(a)
        nr, nc = a.shape[0] + 1, a.shape[1] + 1
        nets.append((a.shape, base, cr, cc, e, g, off, nr, nc))
        off += nr + nc
    outs = [base[:sh[0], :sh[1]].astype(np.int64)
            for sh, base, *_ in nets]
    need = sum(int(net[4].sum()) for net in nets)
    if need == 0:
        return outs

    src, snk = off, off + 1
    u_parts, v_parts, c_parts = [], [], []
    for (_, _, cr, cc, e, g, o, nr, nc) in nets:
        row0, col0 = o, o + nr
        u_parts += [np.full(nr, src), row0 + cr, col0 + np.arange(nc)]
        v_parts += [row0 + np.arange(nr), col0 + cc, np.full(nc, snk)]
        c_parts += [e, np.ones(len(cr), dtype=np.int64), g]
    graph = csr_matrix(
        (np.concatenate(c_parts),
         (np.concatenate(u_parts), np.concatenate(v_parts))),
        shape=(off + 2, off + 2))
    res = maximum_flow(graph, src, snk)
    if res.flow_value != need:  # pragma: no cover - theory guarantees this
        raise AssertionError(
            f"rounding flow infeasible: {res.flow_value} != {need}")
    flow = res.flow.tocoo()
    m_cell = (flow.data > 0) & (flow.row != src) & (flow.col != snk)
    fu, fv = flow.row[m_cell], flow.col[m_cell]
    offs = np.array([net[6] for net in nets], dtype=np.int64)
    which = np.searchsorted(offs, fu, side="right") - 1
    for b, (sh, _, _, _, _, _, o, nr, nc) in enumerate(nets):
        sel = which == b
        r_loc = fu[sel] - o
        c_loc = fv[sel] - o - nr
        real = (r_loc < sh[0]) & (c_loc < sh[1])
        outs[b][r_loc[real], c_loc[real]] += 1
    return outs


def round_matrix(a: np.ndarray, seed: int | None = None) -> np.ndarray:
    """Bacharach-round ``a``. Deterministic; ``seed`` is accepted for API
    symmetry with the randomized steps of Algorithm 1 but unused."""
    return round_matrices([a])[0]


def check_rounding(a: np.ndarray, r: np.ndarray, tol: float = 1e-6) -> None:
    """Assert the three Bacharach properties; raises AssertionError if violated."""
    a = np.asarray(a, dtype=np.float64)
    r = np.asarray(r)
    lo, hi = np.floor(a - tol), np.ceil(a + tol)
    assert ((r >= lo - tol) & (r <= hi + tol)).all(), "entry not floor/ceil"
    for axis in (0, 1):
        s, t = a.sum(axis=axis), r.sum(axis=axis)
        assert (t >= np.floor(s - tol) - tol).all(), "sum below floor"
        assert (t <= np.ceil(s + tol) + tol).all(), "sum above ceil"
