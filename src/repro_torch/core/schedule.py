"""Periodic circuit-switching schedules: Vermilion (Algorithm 1) + baselines.

A schedule is a sequence of perfect matchings executed round-robin at fixed
slot duration on d_hat parallel port planes.  The *emulated graph* (paper
§2.1 / Appendix B) is the time-collapsed capacity matrix over one period.

The port's counterpart of ``repro.core.schedule``: the :class:`Schedule`
container, Algorithm 1 (``vermilion_*``), the per-node control plane of
the adaptive loop (``per_node_schedules`` and the merge helpers) and the
oblivious and greedy baselines.  Construction stays on the host
(rounding, Euler / Hopcroft-Karp decomposition), except the Sinkhorn
projection of ``normalize="saturate"``, which runs on ``device``
(``None``: the card) through :func:`repro_torch.core.traffic.saturate`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.optimize import linear_sum_assignment

from .matching import (
    decompose_matchings,
    decompose_matchings_euler,
    decompose_matchings_euler_batch,
)
from .rounding import round_matrices
from .traffic import hose_normalize, saturate

__all__ = [
    "Schedule",
    "vermilion_scaled_demands",
    "vermilion_rounded",
    "vermilion_emulated_topology",
    "vermilion_emulated_topologies",
    "vermilion_schedule",
    "vermilion_schedules",
    "per_node_schedules",
    "effective_perms",
    "planes_changed",
    "schedule_disagreement",
    "spread_matchings",
    "oblivious_schedule",
    "greedy_matching_schedule",
]

@dataclass(frozen=True)
class Schedule:
    """A periodic fixed-duration circuit-switching schedule.

    perms[t, u] = v means matching t provides circuit u -> v for one slot.
    ``d_hat`` matchings execute concurrently (one per port plane), so a
    period lasts ``n_slots = ceil(T / d_hat)`` timeslots.
    """

    perms: np.ndarray                 # (T, n) int64
    d_hat: int = 1
    recfg_frac: float = 0.0           # Delta_r: fraction of slot lost to reconfig
    name: str = "schedule"
    meta: dict = field(default_factory=dict)

    @property
    def T(self) -> int:
        return int(self.perms.shape[0])

    @property
    def n(self) -> int:
        return int(self.perms.shape[1])

    @property
    def n_slots(self) -> int:
        return -(-self.T // self.d_hat)

    def edge_counts(self) -> np.ndarray:
        """(n, n) count of circuit appearances per period (self-loops kept)."""
        c = np.zeros((self.n, self.n), dtype=np.int64)
        np.add.at(
            c, (np.tile(np.arange(self.n), self.T), self.perms.reshape(-1)), 1
        )
        return c

    def emulated_capacity(self, c: float = 1.0) -> np.ndarray:
        """Time-averaged rate between every pair (self-loops dropped):
        each appearance contributes c * (1 - recfg_frac) / n_slots."""
        counts = self.edge_counts().astype(np.float64)
        np.fill_diagonal(counts, 0.0)
        return counts * (c * (1.0 - self.recfg_frac) / self.n_slots)

    def capacity_per_slot(self, c: float = 1.0) -> np.ndarray:
        """(n_slots, n, n) instantaneous capacity (bits per slot-time at
        c=1 meaning one slot's worth). Used by the dense simulator paths;
        costs ~8 * n^2 * n_slots bytes — prefer :meth:`slot_circuits` for
        the sparse engines at large n."""
        t, n = self.T, self.n
        # deliberately dense (documented small-n path; the sparse engines
        # consume slot_circuits() instead)  # lint: allow-dense
        out = np.zeros((self.n_slots, n, n), dtype=np.float64)
        slot_of = np.repeat(np.arange(self.n_slots), self.d_hat)[:t]
        np.add.at(
            out,
            (np.repeat(slot_of, n), np.tile(np.arange(n), t),
             self.perms.reshape(-1)),
            c * (1.0 - self.recfg_frac),
        )
        out[:, np.arange(n), np.arange(n)] = 0.0
        return out

    def slot_circuits(self, c: float = 1.0) -> list[tuple[np.ndarray,
                                                          np.ndarray,
                                                          np.ndarray]]:
        """Sparse per-slot circuit plan: for each period slot, the
        ``(src, dst, cap)`` arrays of its <= n * d_hat distinct circuits,
        lexicographically sorted by (src, dst) with parallel-circuit
        capacities accumulated and self-loops dropped — entry-for-entry
        (and float-for-float) what ``np.nonzero`` applied to
        :meth:`capacity_per_slot` yields, without ever materializing the
        ~8 * n^3 / d_hat byte dense array."""
        n = self.n
        w = c * (1.0 - self.recfg_frac)
        src0 = np.arange(n)
        out = []
        for s in range(self.n_slots):
            blk = self.perms[s * self.d_hat:(s + 1) * self.d_hat]
            pid = (src0[None, :] * n + blk).reshape(-1)
            upid, inv = np.unique(pid, return_inverse=True)
            # accumulate in input order (matches the dense path's add.at)
            cap = np.bincount(inv, weights=np.full(len(pid), w),
                              minlength=len(upid))
            src, dst = upid // n, upid % n
            keep = src != dst
            out.append((src[keep], dst[keep], cap[keep]))
        return out

    def slot_circuits_padded(
        self, c: float = 1.0, pair_base: int = 0, j_pad: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Device-friendly export of :meth:`slot_circuits`: rectangular
        ``(n_slots, J)`` pair-id and capacity arrays a scan kernel can
        gather per slot without ragged shapes.  Pair ids are the flat
        ``src * n + dst`` offset by ``pair_base`` (a batch engine passes
        ``case_index * n * n``); padded entries carry ``pair_base`` itself
        (pair (0, 0) — never a real circuit, self-loops are dropped) with
        zero capacity, so serving them is an exact no-op.  ``j_pad`` rounds
        J up to a bucket multiple so near-miss support sizes share one
        compiled kernel signature."""
        plans = self.slot_circuits(c)
        n = self.n
        J = max((len(src) for src, _, _ in plans), default=0)
        if j_pad is not None:
            J = max(j_pad, -(-J // j_pad) * j_pad)
        pid = np.full((self.n_slots, J), pair_base, dtype=np.int32)
        cap = np.zeros((self.n_slots, J), dtype=np.float32)
        for s, (src, dst, w) in enumerate(plans):
            pid[s, :len(src)] = pair_base + src * n + dst
            cap[s, :len(src)] = w
        return pid, cap


# ---------------------------------------------------------------------------
# Vermilion — Algorithm 1
# ---------------------------------------------------------------------------

def _configuration_model(
    x_out: np.ndarray, x_in: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Random directed multigraph with the given degree sequences (stubs
    paired uniformly at random). Self-loops / multi-edges allowed, as in the
    paper — they only waste capacity, never break the matchings."""
    assert x_out.sum() == x_in.sum(), "unbalanced degree sequences"
    n = len(x_out)
    out_stubs = np.repeat(np.arange(n), x_out)
    in_stubs = np.repeat(np.arange(n), x_in)
    rng.shuffle(in_stubs)
    return np.bincount(out_stubs * n + in_stubs,
                       minlength=n * n).reshape(n, n)


def vermilion_emulated_topology(
    m: np.ndarray, k: int = 3, seed: int = 0, normalize: str = "hose",
    device=None,
) -> np.ndarray:
    """Algorithm 1, ``emulatedTopology``: the k*n-regular multigraph.

    ``normalize``:
      * ``"hose"`` — divide by the max row/col sum (Algorithm 1 verbatim;
        what Theorem 3's adversarial analysis assumes). Default.
      * ``"saturate"`` — Sinkhorn-project the estimate toward a saturated
        doubly-stochastic matrix first (deployment option).  Real traffic
        estimates are noisy and far from saturated; max-row normalization
        lets one hot row crush every other node's allocation, while
        saturating gives each node its full capacity share proportionally
        to its *own* demand profile; tail FCTs improve dramatically
        (EXPERIMENTS.md §Perf).  Note: Theorem 3's bound formally holds for
        the matrix *as saturated*; if true demand is far from saturated the
        per-entry guarantee can dip (use "hose" when the bound must hold
        verbatim — the theory tests do).
    """
    return vermilion_emulated_topologies([m], k=k, seed=seed,
                                         normalize=normalize,
                                         device=device)[0]


def vermilion_scaled_demands(
    mats, k: int = 3, normalize: str = "hose", device=None,
) -> list[np.ndarray]:
    """Algorithm 1 step 1 per matrix: normalize (max row/col sum <= 1 under
    ``"hose"``, Sinkhorn-saturate under ``"saturate"``), zero the diagonal,
    scale by ``(k-1) * n``.  Exposed so a certificate checker can re-derive
    the rounding contract from *exactly* the matrices the construction
    rounds.  ``device`` is where ``"saturate"`` projects (``None``: the
    card); ``"hose"`` does no device work."""
    if k < 2:
        raise ValueError("k >= 2 (k-1 must be positive)")
    pre = []
    for m in mats:
        m = np.asarray(m, dtype=np.float64)
        n = m.shape[0]
        if normalize == "saturate":
            norm = saturate(m, device=device)
        elif normalize == "hose":
            norm = hose_normalize(m)
        else:
            raise ValueError(normalize)
        np.fill_diagonal(norm, 0.0)
        pre.append((k - 1) * n * norm)
    return pre


def vermilion_rounded(
    mats, k: int = 3, normalize: str = "hose", device=None,
) -> list[np.ndarray]:
    """Algorithm 1 steps 1-2: the integer Bacharach rounding of the scaled
    demands (one shared flow for the whole batch).  Every entry differs
    from its scaled demand by < 1 with row/col sums <= (k-1) * n — the
    doubly-substochastic quantization contract Theorem 3 builds on."""
    return round_matrices(vermilion_scaled_demands(mats, k=k,
                                                   normalize=normalize,
                                                   device=device))


def vermilion_emulated_topologies(
    mats, k: int = 3, seed: int = 0, normalize: str = "hose", device=None,
) -> list[np.ndarray]:
    """Batched ``emulatedTopology``: one Bacharach flow rounds every matrix.

    The per-matrix steps are unchanged (normalize, round, residual,
    configuration-model padding, each view reseeded from the shared epoch
    ``seed``); only the rounding is merged into a single
    :func:`round_matrices` call, amortizing the scipy flow dispatch that
    dominates construction at small n.  A batch of one is bit-identical to
    the historical solo call (``round_matrix`` *is* the one-element batch).
    """
    out = []
    for r in vermilion_rounded(mats, k=k, normalize=normalize,
                               device=device):
        n = r.shape[0]
        rng = np.random.default_rng(seed)
        # 2. traffic-aware multigraph + 3. oblivious residual (one per pair)
        e = r + (1 - np.eye(n, dtype=np.int64))

        # 4. pad to k*n-regularity with the configuration model
        x_out = k * n - e.sum(axis=1)
        x_in = k * n - e.sum(axis=0)
        if (x_out < 0).any() or (x_in < 0).any():  # pragma: no cover
            raise AssertionError("rounding exceeded degree budget")
        e += _configuration_model(x_out, x_in, rng)
        out.append(e)
    return out


_PHI = (np.sqrt(5.0) - 1.0) / 2.0


def spread_matchings(perms: np.ndarray) -> np.ndarray:
    """Reorder matchings by a golden-ratio low-discrepancy sequence.

    The Birkhoff-style decomposition emits identical hot matchings in
    consecutive runs; executed in that order, a pair's circuits bunch up and
    leave long gaps, inflating tail latency.  Sorting index i by
    frac(i * phi) spreads any consecutive run nearly evenly over the period
    (beyond-paper optimization; the paper leaves round-robin order free).
    Emulated capacity is invariant to this reordering.
    """
    t = perms.shape[0]
    return perms[np.argsort((np.arange(t) * _PHI) % 1.0, kind="stable")]


def vermilion_schedule(
    m: np.ndarray,
    k: int = 3,
    d_hat: int = 1,
    recfg_frac: float = 0.0,
    seed: int = 0,
    spread: bool = True,
    normalize: str = "hose",
    method: str = "euler",
    device=None,
) -> Schedule:
    """Algorithm 1, ``generateSchedule``: k*n perfect matchings, round-robin.

    ``method`` selects the decomposition of the emulated multigraph:

      * ``"euler"`` (default) — the batched Euler-split fast path.  The
        traffic-oblivious residual (one edge per ordered pair, Algorithm 1
        step 3) is peeled for free as the n-1 cyclic shifts, so only the
        (k-1)*n + 1 regular traffic+padding remainder is decomposed —
        ~10-20x faster than "hk" by n = 512 and the production path of the
        adaptive loop.
      * ``"hk"``   — one Hopcroft-Karp matching per round (the original
        reference path).

    Both methods decompose the *same* emulated multigraph, so regularity
    and emulated capacity are identical; only the matching multiset's
    split/order may differ (round-robin order is free, cf. paper §2.1).

    ``device``: where ``normalize="saturate"`` runs its Sinkhorn projection
    (``None``: the card; ``"cpu"``: the plain version).  ``"hose"`` does no
    device work and ignores it.
    """
    return vermilion_schedules([m], k=k, d_hat=d_hat, recfg_frac=recfg_frac,
                               seed=seed, spread=spread, normalize=normalize,
                               method=method, device=device)[0]


def vermilion_schedules(
    mats,
    k: int = 3,
    d_hat: int = 1,
    recfg_frac: float = 0.0,
    seed: int = 0,
    spread: bool = True,
    normalize: str = "hose",
    method: str = "euler",
    device=None,
) -> list[Schedule]:
    """Batched Algorithm 1: one schedule per matrix, built together.

    All matrices share one Bacharach flow (rounding) and — under
    ``method="euler"`` with a common shape — one merged Euler stub cascade
    (:func:`decompose_matchings_euler_batch`), amortizing the solver
    dispatch that dominates construction at small n.  Per-matrix output is
    bit-identical to a solo :func:`vermilion_schedule` call.  Under
    ``normalize="saturate"`` each matrix is projected on ``device``
    (``None``: the card), one Sinkhorn kernel call per matrix.
    """
    es = vermilion_emulated_topologies(mats, k=k, seed=seed,
                                      normalize=normalize, device=device)
    if method == "euler":
        same = len({e.shape[0] for e in es}) == 1
        n = es[0].shape[0] if es else 0
        shifts = (np.arange(n)[None, :] + np.arange(1, n)[:, None]) % n
        if same:
            perms_all = decompose_matchings_euler_batch(es, known=shifts)
        else:  # pragma: no cover - callers pass same-shape batches
            perms_all = [
                decompose_matchings_euler(
                    e, known=(np.arange(e.shape[0])[None, :]
                              + np.arange(1, e.shape[0])[:, None])
                    % e.shape[0])
                for e in es]
    elif method == "hk":
        perms_all = [decompose_matchings(e) for e in es]
    else:
        raise ValueError(f"unknown decomposition method {method!r}")
    if spread:
        perms_all = [spread_matchings(p) for p in perms_all]
    return [
        Schedule(
            perms=perms,
            d_hat=d_hat,
            recfg_frac=recfg_frac,
            name=f"vermilion-k{k}",
            meta={"k": k, "seed": seed, "spread": spread,
                  "normalize": normalize, "method": method},
        )
        for perms in perms_all
    ]


# ---------------------------------------------------------------------------
# Per-node control plane (Appendix A under a partial gather)
# ---------------------------------------------------------------------------

def per_node_schedules(
    views,
    k: int = 3,
    d_hat: int = 1,
    recfg_frac: float = 0.0,
    seed: int = 0,
    spread: bool = True,
    normalize: str = "hose",
    method: str = "euler",
    unique: tuple[np.ndarray, np.ndarray] | None = None,
    device=None,
) -> tuple[list[Schedule], np.ndarray]:
    """Each ToR's next schedule from *its own* assembled matrix.

    ``views`` is a :class:`repro_torch.core.estimation.RingViews`
    (dequantized rows + ownership mask).  Appendix A has every node run
    ``generateSchedule`` locally on whatever matrix it assembled; identical
    views are deduplicated before construction (two nodes holding the same
    set of nonzero rows compute the same schedule), so a *complete* gather
    builds exactly one schedule — bit-identical to the single-leader path —
    while a partial gather builds up to n.  All schedules share the same
    ``(T, n_slots, d_hat)`` footprint (k*n matchings regardless of the
    view, including all-zero views, which degenerate to the traffic-
    oblivious residual plus random padding), so their port planes line up
    slot-for-slot and :func:`effective_perms` can merge them.

    Every unique view uses the *same* ``seed``: nodes derandomize the
    configuration model from shared epoch state, not per-node entropy —
    and two nodes with equal views must emit equal schedules for the
    dedup to be faithful.

    Returns ``(schedules, owner)`` with ``owner[i]`` the index into
    ``schedules`` of node i's plan.  ``unique`` optionally passes a
    precomputed ``views.unique()`` result so callers that already
    deduplicated (e.g. for the estimate-error metric) don't pay twice.
    ``device`` is where ``normalize="saturate"`` projects each unique view
    (``None``: the card), one Sinkhorn kernel call per view.
    """
    masks, owner = views.unique() if unique is None else unique
    scheds = vermilion_schedules(
        [views.rows * masks[g][:, None] for g in range(masks.shape[0])],
        k=k, d_hat=d_hat, recfg_frac=recfg_frac, seed=seed, spread=spread,
        normalize=normalize, method=method, device=device)
    return scheds, owner


def effective_perms(
    schedules: list[Schedule], owner: np.ndarray
) -> np.ndarray:
    """The fabric's *actual* port configuration when each input port
    follows its own node's plan: ``eff[t, i]`` is the output port node i
    tunes its plane-t transmitter to, i.e. ``schedules[owner[i]].perms[t,
    i]``.  Under disagreement the rows are generally *not* permutations —
    that contention is exactly what :func:`schedule_disagreement` measures
    and the simulator's collision resolution charges for.
    """
    base = schedules[0]
    n = base.n
    if len(owner) != n:
        raise ValueError(f"owner must map all {n} nodes (got {len(owner)})")
    for s in schedules[1:]:
        if s.T != base.T or s.n != n or s.d_hat != base.d_hat:
            raise ValueError(
                "per-node schedules must share (T, n, d_hat) to be merged: "
                f"{(s.T, s.n, s.d_hat)} != {(base.T, base.n, base.d_hat)}")
    perms = np.stack([s.perms for s in schedules])       # (G, T, n)
    return perms[np.asarray(owner), :, np.arange(n)].T   # (T, n)


def planes_changed(
    old_eff: np.ndarray, new_eff: np.ndarray, d_hat: int
) -> np.ndarray:
    """Which port planes a schedule swap actually retunes.

    Plane p executes the matching subsequence ``eff[p::d_hat]``; a swap
    only forces plane p through the reconfiguration dark window when that
    subsequence differs between the outgoing and incoming effective
    plans.  Returns a (d_hat,) bool mask.  Plans with different periods
    (e.g. an oblivious T = n-1 plan replaced by a vermilion T = k*n one)
    retune everything: all True.  Phase alignment at the swap slot is
    deliberately ignored — a plane whose matching *cycle* is unchanged
    keeps serving through the swap even if the swap shifts its phase,
    matching the fabric model where retuning (not re-phasing) costs the
    dark window.
    """
    if old_eff.shape != new_eff.shape:
        return np.ones(d_hat, dtype=bool)
    changed = np.zeros(d_hat, dtype=bool)
    for p in range(d_hat):
        changed[p] = not np.array_equal(old_eff[p::d_hat],
                                        new_eff[p::d_hat])
    return changed


def schedule_disagreement(
    schedules: list[Schedule], owner: np.ndarray
) -> float:
    """Fraction of (matching, input-port) assignments that are contested:
    the input claims an output port some other input of the same matching
    also claims, so the row is not a matching there.  0.0 iff every
    matching of the merged plan is conflict-free — in particular whenever
    all nodes share one schedule (each row is then a permutation).
    """
    eff = effective_perms(schedules, owner)
    t_count, n = eff.shape
    claims = np.bincount(
        (np.arange(t_count)[:, None] * n + eff).reshape(-1),
        minlength=t_count * n).reshape(t_count, n)
    return float((claims[np.arange(t_count)[:, None], eff] > 1).mean())


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def oblivious_schedule(
    n: int, d_hat: int = 1, recfg_frac: float = 0.0
) -> Schedule:
    """RotorNet/Sirius-style round-robin over the n-1 cyclic shifts,
    emulating a uniform all-to-all mesh."""
    shifts = np.arange(1, n)
    perms = (np.arange(n)[None, :] + shifts[:, None]) % n
    return Schedule(perms=perms, d_hat=d_hat, recfg_frac=recfg_frac,
                    name="oblivious")


def greedy_matching_schedule(
    m: np.ndarray,
    n_matchings: int | None = None,
    d_hat: int = 1,
    recfg_frac: float = 0.0,
) -> Schedule:
    """Negotiator-style: repeatedly pick the maximum-weight matching of the
    residual demand. Served capacity per matching = one slot's share."""
    m = hose_normalize(np.asarray(m, dtype=np.float64))
    n = m.shape[0]
    t = n_matchings or n
    resid = m.copy()
    perms = np.empty((t, n), dtype=np.int64)
    slot_cap = 1.0 / t  # each matching carries 1/t of the period's capacity
    for i in range(t):
        row, col = linear_sum_assignment(resid, maximize=True)
        perms[i] = col[np.argsort(row)]
        resid[row, col] = np.maximum(resid[row, col] - slot_cap, 0.0)
    return Schedule(perms=perms, d_hat=d_hat, recfg_frac=recfg_frac,
                    name="greedy")


