"""Decomposition of regular directed multigraphs into perfect matchings.

The port's own copy of ``repro.core.matching`` (host numpy/scipy code; the
port imports nothing of the JAX package).

A directed multigraph on n nodes with all in-degrees == all out-degrees == D
(represented as an integer matrix E, E[u, v] = edge multiplicity) decomposes
into exactly D perfect matchings (Koenig / Birkhoff for integer matrices).
These matchings ARE Vermilion's periodic schedule.

Two algorithms:

* :func:`decompose_matchings` (``method="hk"``) — D rounds of Hopcroft-Karp
  (scipy's C implementation).  O(D * (n^2 + E * sqrt(n))): every round
  rebuilds the support and runs one maximum bipartite matching.  The
  reference path; dominates schedule construction beyond n ~ 512.
* :func:`decompose_matchings_euler` — batched level-wise Euler splitting:
  an even-D regular bipartite multigraph splits into two D/2-regular halves
  by 2-coloring the edges along alternating Euler trails.  All subproblems
  of a recursion level are split in one shot on flat stub arrays (the trail
  coloring is a cycle-labeling of an edge permutation, solved by int32
  pointer doubling), so one level costs O(E log L) vectorized work (L = the
  longest trail) and the whole decomposition O(E log D log L) — in practice
  within a small factor of the advertised O(E log D), with C-speed
  constants.  Odd regularity at *sub*-levels is handled matching-free by an
  Alon-style extraction (dummy-padded halving); at most one Hopcroft-Karp
  peel ever runs, at the top level, and only when D itself is odd.  This is
  our TPU-era answer to the paper's CUDA decomposition helper (Fig 10),
  benchmarked in ``benchmarks/schedule_time.py``.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

__all__ = [
    "is_regular",
    "extract_perfect_matching",
    "decompose_matchings",
    "decompose_matchings_euler",
    "decompose_matchings_euler_batch",
]


def is_regular(e: np.ndarray) -> bool:
    e = np.asarray(e)
    rs, cs = e.sum(axis=1), e.sum(axis=0)
    return bool((rs == rs[0]).all() and (cs == rs[0]).all())


def extract_perfect_matching(e: np.ndarray) -> np.ndarray:
    """Return perm with perm[u] = v, a perfect matching on the support of e.

    Raises ValueError if none exists (cannot happen for regular e, by Hall).
    """
    support = csr_matrix((e > 0).astype(np.int8))
    match = maximum_bipartite_matching(support, perm_type="column")
    if (match < 0).any():
        raise ValueError("no perfect matching on support (graph not regular?)")
    return match.astype(np.int64)


def decompose_matchings(e: np.ndarray, method: str = "hk") -> np.ndarray:
    """Decompose regular integer matrix ``e`` into a (D, n) permutation array.

    ``method="hk"`` peels one Hopcroft-Karp matching per round (the
    historical default, kept as the golden reference); ``method="euler"``
    dispatches to :func:`decompose_matchings_euler`.  Both return the same
    *multiset* of matchings reassembling ``e`` exactly; the order (and, for
    multigraphs with several valid decompositions, the split) may differ.
    """
    if method == "euler":
        return decompose_matchings_euler(e)
    if method != "hk":
        raise ValueError(f"unknown decomposition method {method!r}")
    e = np.asarray(e, dtype=np.int64).copy()
    if not is_regular(e):
        raise ValueError("matrix is not regular (row sums != col sums)")
    d = int(e.sum(axis=1)[0])
    n = e.shape[0]
    out = np.empty((d, n), dtype=np.int64)
    idx = np.arange(n)
    for t in range(d):
        perm = extract_perfect_matching(e)
        out[t] = perm
        e[idx, perm] -= 1
    assert (e == 0).all()
    return out


# ---------------------------------------------------------------------------
# Euler-split fast path
# ---------------------------------------------------------------------------

def _cycle_min_labels(sigma: np.ndarray) -> np.ndarray:
    """Label every element with the minimum index of its ``sigma``-orbit.

    Pointer doubling (lab = min(lab, lab[p]); p = p[p]) in int32 with
    in-place updates: two random gathers and one fused min per iteration,
    ceil(log2(L)) iterations for longest cycle L.  Fixed points label
    themselves for free via the compressed subset.
    """
    E = len(sigma)
    lab = np.arange(E, dtype=np.int32)
    sigma = sigma.astype(np.int32, copy=False)
    nf = np.flatnonzero(sigma != lab)
    if nf.size == 0:
        return lab
    if nf.size == E:
        p = sigma.copy()
        loc = lab.copy()
        back = None
    else:
        inv = np.empty(E, dtype=np.int32)
        inv[nf] = np.arange(nf.size, dtype=np.int32)
        p = np.take(inv, np.take(sigma, nf))
        loc = np.arange(nf.size, dtype=np.int32)
        back = nf
    g = np.empty_like(loc)
    p2 = np.empty_like(p)
    lt = np.empty(len(loc), dtype=bool)
    for it in range(64):  # ceil(log2(L)) + 1 passes; 64 is unreachable
        np.take(loc, p, out=g, mode="clip")
        if it & 1:
            np.less(g, loc, out=lt)
            if not lt.any():
                break
        np.minimum(loc, g, out=loc)
        np.take(p, p, out=p2, mode="clip")
        p, p2 = p2, p
    if back is None:
        return loc
    lab[nf] = back[loc]
    return lab


def _pair_adjacent(order: np.ndarray) -> np.ndarray:
    """Involution pairing order[2i] <-> order[2i+1] (positions -> indices)."""
    p = np.empty(len(order), dtype=order.dtype)
    p[order[0::2]] = order[1::2]
    p[order[1::2]] = order[0::2]
    return p


def _euler_colors(eu: np.ndarray, ev: np.ndarray, sub: np.ndarray,
                  n: int) -> np.ndarray:
    """2-color a batch of even-degree bipartite multigraphs so that every
    (subproblem, vertex) sees both colors equally often.

    Pairing consecutive stubs at each vertex chains the edges into closed
    alternating trails; trails 2-color consistently because the two pairing
    classes (left / right) alternate.  The orbit labels of the edge
    permutation ``pL o pR`` identify each trail's two color classes.
    """
    E = len(eu)
    if E == 0:
        return np.zeros(0, dtype=bool)
    base = sub * n
    pL = _pair_adjacent(np.argsort(base + eu, kind="stable"))
    pR = _pair_adjacent(np.argsort(base + ev, kind="stable"))
    lab = _cycle_min_labels(pL[pR])
    return lab > lab[pR]


def _extract_matchings_alon(eu: np.ndarray, ev: np.ndarray, sub: np.ndarray,
                            n: int, d: int, S: int
                            ) -> tuple[np.ndarray, np.ndarray]:
    """One perfect matching per subproblem (each d-regular, d odd >= 3)
    without any bipartite-matching subroutine (Alon, IPL 2003).

    Weight every real edge alpha and pad with r cyclic-shift dummies so
    alpha*d + r = 2^t >= n*d.  Halve t times by weighted Euler splits,
    always keeping the half with less dummy mass: the dummy mass r*n < 2^t
    shrinks below one edge, leaving a 1-regular all-real graph — a perfect
    matching per subproblem.  Returns (perms (S, n), matched edge indices).
    """
    t = max(int(np.ceil(np.log2(max(n * d, 2)))), 1)
    big = 1 << t
    alpha, r = divmod(big, d)
    E = len(eu)
    sh = 1 + (np.arange(S * r * n) // n) % r
    du = np.tile(np.arange(n), S * r)
    weu = np.concatenate([eu, du])
    wev = np.concatenate([ev, (du + sh) % n])
    wsub = np.concatenate([sub, np.repeat(np.arange(S), r * n)])
    wc = np.concatenate([np.full(E, alpha, dtype=np.int64),
                         np.ones(S * r * n, dtype=np.int64)])
    worig = np.concatenate([np.arange(E), np.full(S * r * n, -1)])
    for _ in range(t):
        odd = (wc & 1).astype(bool)
        c = np.zeros(len(wc), dtype=bool)
        c[odd] = _euler_colors(weu[odd], wev[odd], wsub[odd], n)
        half = wc >> 1
        dummy = worig < 0
        base_bad = np.where(dummy, half, 0).astype(np.float64)
        bad0 = np.bincount(wsub, weights=base_bad + (dummy & odd & ~c),
                           minlength=S)
        bad1 = np.bincount(wsub, weights=base_bad + (dummy & odd & c),
                           minlength=S)
        pick = bad1 < bad0
        wc = half + (odd & (c == pick[wsub]))
        keep = wc > 0
        weu, wev, wsub, wc, worig = (
            weu[keep], wev[keep], wsub[keep], wc[keep], worig[keep])
    if not ((worig >= 0).all() and len(wc) == S * n):  # pragma: no cover
        raise AssertionError("Alon extraction left dummy edges behind")
    perms = np.empty((S, n), dtype=np.int64)
    perms[wsub, weu] = wev
    return perms, worig


def _euler_split(e: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split an even-regular matrix into two D/2-regular halves via Euler
    trails — stub-array rewrite of the old dense O(n^2)-scan walk; costs
    O(E) expansion plus the vectorized trail coloring."""
    e = np.asarray(e, dtype=np.int64)
    n = e.shape[0]
    ui, vi = np.nonzero(e)
    mult = e[ui, vi]
    eu = np.repeat(ui, mult)
    ev = np.repeat(vi, mult)
    c = _euler_colors(eu, ev, np.zeros(len(eu), dtype=np.int64), n)
    a = np.zeros_like(e)
    b = np.zeros_like(e)
    np.add.at(a, (eu[~c], ev[~c]), 1)
    np.add.at(b, (eu[c], ev[c]), 1)
    return a, b


_CHUNK_ELEMS = 65536      # depth-first recursion piece size (L2-resident)


def _decompose_stubs(ev: np.ndarray, byr: np.ndarray, n: int, d: int,
                     out: list, mid: np.ndarray | None = None) -> None:
    """Batched level-wise Euler decomposition of uniform-degree stub arrays.

    Physical layout invariant: edges sorted by (subproblem, src, dst), each
    (subproblem, src) block holding exactly ``d`` edges — so src and
    subproblem ids never need storing (they are index arithmetic) and the
    left pairing is simply "adjacent position" (x ^ 1).  ``byr`` is the
    same edge set ordered by (subproblem, dst, src), maintained
    incrementally across levels so no level ever sorts.  One level is ~15
    flat O(E) passes plus the pointer-doubling trail labeling.

    Subproblems never interact, so once the piece spans several of them the
    recursion goes depth-first on cache-sized halves (subproblem-aligned):
    all remaining levels of a piece run on L2-resident arrays, which on a
    memory-bound box is worth ~2x over breadth-first whole-array sweeps.

    ``mid`` optionally tags each subproblem with an originating-matrix id
    (several *independent* regular matrices stacked as sibling subproblems
    share one cascade); ``out`` then receives ``(perms, mid)`` pairs whose
    rows can be routed back per matrix.  Every color decision compares
    orbit labels confined to one subproblem's positions, so stacking only
    shifts those positions uniformly and each matrix's split is
    bit-identical to a solo run.  With ``mid=None`` plain perm arrays are
    appended (the historical single-matrix contract).
    """
    ev = ev.astype(np.int32, copy=False)
    byr = byr.astype(np.int32, copy=False)
    while d > 1:
        S = len(ev) // (n * d)
        if len(ev) > _CHUNK_ELEMS and S >= 2:
            h = (S // 2) * n * d
            _decompose_stubs(ev[:h], byr[:h], n, d, out,
                             None if mid is None else mid[:S // 2])
            _decompose_stubs(ev[h:], byr[h:] - np.int32(h), n, d, out,
                             None if mid is None else mid[S // 2:])
            return
        if d % 2 == 1:
            eu = np.tile(np.repeat(np.arange(n), d), S)
            sub = np.repeat(np.arange(S), n * d)
            perms, pos = _extract_matchings_alon(ev=ev.astype(np.int64),
                                                 eu=eu, sub=sub,
                                                 n=n, d=d, S=S)
            out.append(perms if mid is None else (perms, mid.copy()))
            keep = np.ones(len(ev), dtype=bool)
            keep[pos] = False
            newidx = (np.cumsum(keep, dtype=np.int64) - 1).astype(np.int32)
            byr = newidx[byr[keep[byr]]]
            ev = ev[keep]
            d -= 1
            continue
        E = len(ev)
        # right pairing from byr order; left pairing is adjacent-position
        pr = _pair_adjacent(byr)
        lab = _cycle_min_labels(pr ^ 1)          # sigma = pL o pR, pL = ^1
        c = lab > np.take(lab, pr, mode="clip")
        # stable partition by color within each subproblem block: both
        # children are exactly (n*d/2)-sized, so block offsets are closed
        # form.  The same partition, applied in byr space, keeps byr sorted
        # by (subproblem, dst, src) for the next level.
        blk = n * d
        half = blk >> 1
        # zeros land at s*blk + rank0 with rank0 = cz[i]-1 - s*half, ones at
        # s*blk + half + rank1 with rank1 = i - cz[i] - s*blk + s*half; both
        # collapse to (class expression) + s*half.
        soff = np.repeat(
            np.arange(E // blk, dtype=np.int32) * np.int32(half), blk)
        ar = np.arange(E, dtype=np.int32)
        cz = np.cumsum(~c, dtype=np.int32)
        dest = np.where(c, half + ar - cz, cz - 1) + soff
        cb = np.take(c, byr, mode="clip")
        czb = np.cumsum(~cb, dtype=np.int32)
        destb = np.where(cb, half + ar - czb, czb - 1) + soff
        ev_new = np.empty_like(ev)
        ev_new[dest] = ev
        byr_new = np.empty_like(byr)
        byr_new[destb] = np.take(dest, byr, mode="clip")
        ev, byr = ev_new, byr_new
        d //= 2
        if mid is not None:
            # block s split in place into halves -> new subs 2s, 2s + 1
            mid = np.repeat(mid, 2)
    if d == 1:
        perms = ev.reshape(-1, n).astype(np.int64)
        out.append(perms if mid is None else (perms, mid))


def decompose_matchings_euler(
    e: np.ndarray, known: np.ndarray | None = None
) -> np.ndarray:
    """Euler-split decomposition (fast path).  Same output contract as
    :func:`decompose_matchings` (multiset of matchings reassembling ``e``;
    order may differ).

    ``known``: optional (M, n) array of perfect matchings already known to
    be contained in ``e`` (entrywise ``e >= sum of their indicators``).
    They are peeled for free and returned first — ``vermilion_schedule``
    passes the n-1 cyclic shifts of the traffic-oblivious residual, which
    leaves a (k-1)*n + 1 regular remainder whose single Hopcroft-Karp peel
    opens a pure even-split cascade whenever (k-1)*n is a power of two.

    At most one Hopcroft-Karp peel happens per decomposition (only when the
    post-peel regularity is odd); odd regularity at deeper levels is
    resolved matching-free (see :func:`_extract_matchings_alon`).
    """
    return decompose_matchings_euler_batch([e], known=known)[0]


def decompose_matchings_euler_batch(
    es, known: np.ndarray | None = None
) -> list[np.ndarray]:
    """Decompose a batch of same-shape regular matrices in ONE stub cascade.

    Independent matrices ride the Euler split as sibling subproblems of a
    single :func:`_decompose_stubs` call, amortizing the trail labelings,
    flat O(E) passes, and numpy dispatch across the batch — the dominant
    construction cost of the per-node control plane, where every epoch
    decomposes up to n same-regularity view matrices.  ``known`` (M, n) is
    peeled from *every* matrix.  Each matrix's matching multiset is
    bit-identical to its solo :func:`decompose_matchings_euler` run (the
    color decisions compare orbit labels confined to one subproblem, so
    batching only shifts them uniformly); a batch of one is the solo call.
    Matrices whose post-peel regularity differs (or that finish before the
    cascade) are handled individually, so mixed batches stay correct.
    """
    es = [np.asarray(e, dtype=np.int64) for e in es]
    if not es:
        return []
    n = es[0].shape[0]
    if any(e.shape != (n, n) for e in es):
        raise ValueError("batch matrices must share shape")
    if known is not None and len(known):
        known = np.asarray(known, dtype=np.int64)
    else:
        known = None
    results: list = [None] * len(es)
    pend = []                     # (g, head, eu, ev, d) awaiting the cascade
    for g, e in enumerate(es):
        if not is_regular(e):
            raise ValueError("matrix is not regular")
        d = int(e.sum(axis=1)[0])
        head: list[np.ndarray] = []
        if known is not None:
            rest = e.copy()
            np.add.at(rest,
                      (np.tile(np.arange(n), len(known)), known.reshape(-1)),
                      -1)
            if (rest < 0).any():
                raise ValueError("known matchings are not contained in e")
            head.append(known)
            e = rest
            d -= len(known)
        if d == 0:
            results[g] = (np.concatenate(head) if head
                          else np.empty((0, n), dtype=np.int64))
            continue
        if n == 1:
            head.append(np.zeros((d, 1), dtype=np.int64))
            results[g] = np.concatenate(head)
            continue
        ui, vi = np.nonzero(e)
        mult = e[ui, vi]
        eu = np.repeat(ui, mult)
        ev = np.repeat(vi, mult)
        if d % 2 == 1 and d > 1:
            # the one permitted Hopcroft-Karp peel: evens the top regularity
            perm = extract_perfect_matching(e)
            head.append(perm[None, :])
            key = eu * n + ev                      # sorted (construction)
            pos = np.searchsorted(key, np.arange(n) * n + perm)
            keep = np.ones(len(eu), dtype=bool)
            keep[pos] = False
            eu, ev = eu[keep], ev[keep]
            d -= 1
        if d == 1:
            head.append(ev[None, :])
            results[g] = np.concatenate(head)
            continue
        pend.append((g, head, eu, ev, d))
    if not pend:
        return results
    d0 = pend[0][4]
    if any(p[4] != d0 for p in pend):              # mixed regularity: solo
        for g, head, eu, ev, d in pend:
            byr = np.argsort(ev.astype(np.int64) * n + eu, kind="stable")
            out = list(head)
            _decompose_stubs(ev, byr, n, d, out)
            results[g] = np.concatenate(out)
        return results
    offs = np.cumsum([0] + [len(ev) for *_, ev, _ in pend])
    ev_all = np.concatenate([ev for *_, ev, _ in pend])
    byr_all = np.concatenate([
        np.argsort(ev.astype(np.int64) * n + eu, kind="stable")
        + np.int64(off)
        for (_, _, eu, ev, _), off in zip(pend, offs[:-1])])
    sout: list = []
    _decompose_stubs(ev_all, byr_all, n, d0, sout,
                     mid=np.arange(len(pend), dtype=np.int32))
    for u, (g, head, *_) in enumerate(pend):
        parts = head + [p[m == u] for p, m in sout if (m == u).any()]
        results[g] = np.concatenate(parts)
    return results
