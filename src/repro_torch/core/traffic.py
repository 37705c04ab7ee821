"""Traffic matrices for the hose model (Definition 1 of the paper).

A traffic matrix is an (n, n) nonnegative array, entry (u, v) = demand from
node u to node v in units of link capacity (c = 1 after normalization).
The hose model requires every row sum and column sum <= d_hat (the node's
in/out physical degree).

The port's copy of ``repro.core.traffic``.  The control plane is numpy
(like the paper's), except :func:`saturate`, whose Sinkhorn projection runs
through the CUDA kernel of :mod:`repro_torch.kernels.sinkhorn` on the card
(or numpy's own loop, the reference's, on the CPU, when asked for).
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..kernels.sinkhorn.ops import sinkhorn

__all__ = [
    "hose_normalize",
    "is_hose",
    "saturate",
    "uniform",
    "ring",
    "permutation",
    "skewed",
    "dlrm_data_parallel",
    "dlrm_hybrid_parallel",
    "random_hose",
    "pattern_matrix",
    "phase_train",
]


def hose_normalize(m: np.ndarray, d_hat: float = 1.0) -> np.ndarray:
    """Scale ``m`` so that max(row sum, col sum) == d_hat (paper Alg. 1 l.12).

    Zero matrices are returned unchanged.
    """
    m = np.asarray(m, dtype=np.float64)
    if m.min() < 0:
        raise ValueError("traffic matrix must be nonnegative")
    top = max(m.sum(axis=1).max(initial=0.0), m.sum(axis=0).max(initial=0.0))
    if top <= 0:
        return m.copy()
    return m * (d_hat / top)


def is_hose(m: np.ndarray, d_hat: float = 1.0, tol: float = 1e-9) -> bool:
    m = np.asarray(m, dtype=np.float64)
    return bool(
        (m >= -tol).all()
        and m.sum(axis=1).max(initial=0.0) <= d_hat + tol
        and m.sum(axis=0).max(initial=0.0) <= d_hat + tol
    )


def saturate(m: np.ndarray, iters: int = 200, device=None) -> np.ndarray:
    """Sinkhorn-project ``m`` toward a doubly stochastic (saturated) matrix.

    Saturated hose matrices (all row/col sums == capacity) are the worst case
    per Namyar et al.; Theorem 1's proof decomposes exactly these.

    The projection runs in f64 on ``device`` (``None``: the card) through
    :func:`repro_torch.kernels.sinkhorn.ops.sinkhorn` with ``eps=0``: the
    clamp of nonpositive entries to 1e-12 happens here, so the kernel's own
    clamp is the identity and the semantics are those of the reference.
    On the CPU (``device="cpu"``) it divides by numpy's own row and column
    sums, as the reference does, so the result equals the reference's bit
    for bit: ties of equal entries that later steps break by their last
    bits (BvN's largest-remainder fill) fall as they fall there.
    """
    dev = resolve_device(device)
    m = np.asarray(m, dtype=np.float64).copy()
    if (m <= 0).all():
        return m
    m = np.where(m <= 0, 1e-12, m)
    if dev.type == "cpu":
        for _ in range(iters):
            m /= m.sum(axis=1, keepdims=True)
            m /= m.sum(axis=0, keepdims=True)
        return m
    return sinkhorn(m, iters=iters, eps=0.0, device=dev).cpu().numpy()


# ---------------------------------------------------------------------------
# Canonical demand patterns used in the paper's evaluation (§4.2)
# ---------------------------------------------------------------------------

def uniform(n: int) -> np.ndarray:
    """All-to-all uniform demand (the pattern oblivious designs emulate)."""
    m = np.full((n, n), 1.0 / (n - 1))
    np.fill_diagonal(m, 0.0)
    return m


def ring(n: int) -> np.ndarray:
    """Ring permutation: the worst case for oblivious networks (§2.2)."""
    m = np.zeros((n, n))
    m[np.arange(n), (np.arange(n) + 1) % n] = 1.0
    return m


def permutation(n: int, seed: int = 0) -> np.ndarray:
    """A random permutation demand matrix (saturated, maximally skewed)."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(n)
    # avoid fixed points (self-demand is meaningless)
    for i in range(n):
        if p[i] == i:
            j = (i + 1) % n
            p[i], p[j] = p[j], p[i]
    m = np.zeros((n, n))
    m[np.arange(n), p] = 1.0
    return m


def skewed(n: int, skew: float, seed: int = 0) -> np.ndarray:
    """``skew``-weighted mix of a permutation and uniform (paper Fig 7)."""
    if not 0.0 <= skew <= 1.0:
        raise ValueError("skew in [0, 1]")
    return skew * permutation(n, seed) + (1.0 - skew) * uniform(n)


def dlrm_data_parallel(n: int) -> np.ndarray:
    """DLRM data-parallel pattern (paper Fig 4a): ring all-reduce dominant
    plus a light uniform all-to-all for embedding exchange."""
    m = 0.75 * ring(n) + 0.25 * uniform(n)
    return hose_normalize(m)


def dlrm_hybrid_parallel(n: int, groups: int = 4) -> np.ndarray:
    """Hybrid parallelism: dense all-to-all within groups (model parallel)
    plus a ring across group leaders (data parallel)."""
    assert n % groups == 0
    g = n // groups
    m = np.zeros((n, n))
    for b in range(groups):
        s = slice(b * g, (b + 1) * g)
        blk = np.full((g, g), 1.0 / max(g - 1, 1))
        np.fill_diagonal(blk, 0.0)
        m[s, s] = blk
    leaders = np.arange(0, n, g)
    for i, u in enumerate(leaders):
        m[u, leaders[(i + 1) % groups]] += 1.0
    return hose_normalize(m)


def random_hose(n: int, seed: int = 0, density: float = 0.5) -> np.ndarray:
    """Random nonnegative matrix, hose-normalized. Used by property tests."""
    rng = np.random.default_rng(seed)
    m = rng.gamma(0.5, 1.0, size=(n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(m, 0.0)
    return hose_normalize(m)


# ---------------------------------------------------------------------------
# Non-stationary traffic: named patterns and phase trains
# ---------------------------------------------------------------------------

_PATTERNS = {
    "uniform": lambda n, seed: uniform(n),
    "ring": lambda n, seed: ring(n),
    "permutation": permutation,
    "dlrm": lambda n, seed: dlrm_data_parallel(n),
    "dlrm_data_parallel": lambda n, seed: dlrm_data_parallel(n),
    "dlrm_hybrid_parallel": lambda n, seed: dlrm_hybrid_parallel(n),
    "random_hose": random_hose,
}


def pattern_matrix(name: str, n: int, seed: int = 0) -> np.ndarray:
    """Named demand pattern, hose-normalized.  ``skew-<x>`` selects
    :func:`skewed` with ``skew=x`` (e.g. ``"skew-0.7"``)."""
    if name.startswith("skew-"):
        return hose_normalize(skewed(n, float(name[5:]), seed=seed))
    try:
        fn = _PATTERNS[name]
    except KeyError:
        raise ValueError(
            f"unknown pattern {name!r} (have {sorted(_PATTERNS)} or skew-<x>)"
        ) from None
    return hose_normalize(fn(n, seed))


def phase_train(
    n: int, phases: tuple[str, ...], seed: int = 0
) -> list[np.ndarray]:
    """One hose-normalized demand matrix per phase of a non-stationary
    workload (e.g. ``("permutation", "uniform", "dlrm")``).  Each phase gets
    a distinct seed so repeated pattern names differ (two "permutation"
    phases are two *different* permutations — a genuine shift)."""
    return [pattern_matrix(p, n, seed=seed + 97 * i)
            for i, p in enumerate(phases)]
