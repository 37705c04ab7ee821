"""Distributed traffic-matrix estimation (paper Appendix A, Q1-Q4).

The port's copy of ``repro.core.estimation``.  Each node keeps an EWMA of
its outgoing traffic (one row of the global matrix).  During the
round-robin (traffic-oblivious residual) phase of Vermilion's schedule,
nodes AllGather their quantized rows so that by the end of the phase every
node holds the full (normalized, rounded) matrix and can compute the next
schedule locally — no central controller on the fast path.

Quantization follows A1: each entry is scaled by (k-1)/k * 1/(c*Delta),
floored, and clipped to 16 bits (65535), supporting up to n = 21845 ToRs.

Under a *partial* gather (fewer than n-1 exchange slots ran) the per-node
views differ: node j holds exactly the rows i with (j - i) mod n <= steps.
:func:`ring_all_views` / :func:`estimate_all_views` expose all n views in
O(n^2) via that banded mask (see :class:`RingViews`); downstream,
:func:`repro_torch.core.schedule.per_node_schedules` turns them into each
node's own next schedule and the simulator resolves the resulting
disagreement.

The host pipeline is numpy in f64, as in the reference; the adaptive loop
uses it, bit for bit.  :func:`fleet_update_quantize` and
:func:`dequantize_device` are the f32 PyTorch counterparts of the
reference's jitted fleet ops, on ``device`` (``None``: the card); they are
API of their own and the adaptive loop does not call them (their f32
arithmetic can land a tick away from the f64 pipeline).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "RingViews",
    "TrafficEstimator",
    "allgather_rows",
    "dequantize",
    "dequantize_device",
    "estimate_all_views",
    "estimate_global_matrix",
    "fleet_update_quantize",
    "quantize_row",
    "ring_all_views",
    "ring_leader_view",
    "ring_view_mask",
]


def _check_steps(n: int, steps: int | None) -> int:
    # every node holds its own row from slot 0 on; negative step counts
    # have no physical reading (and would silently zero even the diagonal
    # out of the closed-form band masks)
    steps = n - 1 if steps is None else steps
    if steps < 0:
        raise ValueError(f"steps must be >= 0 (got {steps})")
    return steps


def _check_k(k: int) -> None:
    # k = 1 makes the (k-1)/k scale exactly 0: quantize_row would return
    # silent all-zeros and dequantize would divide by zero (inf ticks)
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k}): the quantizer scale "
                         "(k-1)/k degenerates at k = 1")


def quantize_row(
    row: np.ndarray, k: int, bits_per_slot: float
) -> np.ndarray:
    """A1's two-step transform: normalize then floor; 16-bit saturating."""
    _check_k(k)
    scaled = row * ((k - 1) / k) / bits_per_slot
    return np.clip(np.floor(scaled), 0, 65535).astype(np.uint16)


def allgather_rows(local_rows: np.ndarray, steps: int | None = None) -> np.ndarray:
    """Ring AllGather of per-node rows over the round-robin phase.

    ``local_rows[i]`` is node i's row.  Each of the n-1 round-robin slots
    forwards one more row to the direct neighbor, mimicking the pipelined
    exchange of Figure 9.  Returns the (n, n, n) per-node views; view[i] is
    the matrix node i has assembled.  With ``steps < n-1`` the gather is
    partial (models mid-phase failure); missing rows are zero.

    This is the simulated reference for the exchange model; the closed
    forms (:func:`ring_view_mask` / :func:`ring_all_views`) are pinned
    equal to it in tests/test_torch_estimation.py and serve the adaptive
    loop.
    """
    n = local_rows.shape[0]
    steps = _check_steps(n, steps)
    # the simulated exchange reference is deliberately an (n, n, r) tensor;
    # the closed forms below stay O(n^2)  # lint: allow-dense
    views = np.zeros((n, n, local_rows.shape[1]), dtype=local_rows.dtype)
    views[np.arange(n), np.arange(n)] = local_rows
    # slot t: node i forwards everything it has to neighbor (i+1) mod n;
    # after n-1 slots all views are complete (linear pipeline).  One step
    # is a simultaneous shift of ownership down the ring: node j gains
    # exactly the rows its predecessor held that it lacked.
    have = np.eye(n, dtype=bool)
    for _ in range(steps):
        prev_have = np.roll(have, 1, axis=0)        # what (j-1) mod n held
        gained = prev_have & ~have                  # (n, n) rows node j gains
        j_idx, i_idx = np.nonzero(gained)
        views[j_idx, i_idx] = views[(j_idx - 1) % n, i_idx]
        have |= prev_have
    return views


def ring_view_mask(n: int, steps: int | None = None) -> np.ndarray:
    """Closed-form ownership mask of the ring AllGather after ``steps``
    slots: ``have[j, i]`` is True iff node j holds row i, i.e. iff
    ``(j - i) mod n <= steps`` (the forward-ring pipeline delivers row i
    to node j after exactly ``(j - i) mod n`` slots).  This banded (n, n)
    mask is the whole exchange state — every per-node view is a masked
    copy of the same row matrix, so all n views cost O(n^2), never an
    (n, n, n) tensor.
    """
    steps = _check_steps(n, steps)
    idx = np.arange(n)
    return ((idx[:, None] - idx[None, :]) % n) <= steps


@dataclass(frozen=True)
class RingViews:
    """All n per-node views of a (possibly partial) ring AllGather, in
    O(n^2) storage: node j's assembled matrix is ``rows`` with the rows it
    has not yet received zeroed (``view(j)``).

    ``unique()`` deduplicates *identical* views: two nodes see the same
    matrix iff they hold the same set of rows with nonzero content (rows
    missing from a view are zero-filled, so all-zero rows never
    distinguish views).  With a complete gather every node's view is the
    full matrix and all n collapse into one group — which is what keeps
    the consistent-fabric fast path of the adaptive loop exact.
    """

    rows: np.ndarray        # (n, r) per-node rows (any dtype / units)
    have: np.ndarray        # (n, n) bool; have[j, i]: node j holds row i

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def view(self, j: int) -> np.ndarray:
        """Node j's assembled matrix (missing rows zero)."""
        return np.where(self.have[j][:, None], self.rows, 0)

    def unique(self) -> tuple[np.ndarray, np.ndarray]:
        """(masks, owner): ``masks`` (g, n) bool are the distinct effective
        row sets, ``owner[j]`` the group of node j.  Group g's view is
        ``rows * masks[g][:, None]``."""
        eff = self.have & self.rows.astype(bool).any(axis=1)[None, :]
        masks, owner = np.unique(eff, axis=0, return_inverse=True)
        return masks, owner.reshape(-1)

    def excise(self, dead_tx: np.ndarray, dead_rx: np.ndarray) -> "RingViews":
        """Remove failed nodes from the estimated demand: zero the rows of
        dead senders and the columns toward dead receivers, so the
        schedule rebuilt from these views allocates no circuits to either
        and healthy ports reclaim the freed capacity.  ``dead_tx`` /
        ``dead_rx`` are (n,) bool masks; returns a new RingViews (``have``
        is unchanged — the gather still ran, the content is excised)."""
        rows = self.rows.copy()
        rows[np.asarray(dead_tx, dtype=bool), :] = 0
        rows[:, np.asarray(dead_rx, dtype=bool)] = 0
        return RingViews(rows=rows, have=self.have)


def ring_all_views(
    local_rows: np.ndarray, steps: int | None = None
) -> RingViews:
    """Closed form of *every* node's view after ``steps`` ring-AllGather
    slots, generalizing :func:`ring_leader_view` from one leader to the
    whole fabric.  The banded mask ``(j - i) mod n <= steps`` gives all n
    views in O(n^2) storage (see :class:`RingViews`) — no (n, n, n)
    exchange tensor.  Pinned equal to the simulated
    :func:`allgather_rows` in tests/test_torch_estimation.py.
    """
    return RingViews(rows=local_rows,
                     have=ring_view_mask(local_rows.shape[0], steps))


def ring_leader_view(
    local_rows: np.ndarray, steps: int | None = None, leader: int = 0
) -> np.ndarray:
    """Closed form of one node's view after ``steps`` ring-AllGather slots.

    The forward-ring pipeline of :func:`allgather_rows` delivers row ``i``
    to node ``j`` exactly when ``(j - i) mod n <= steps``, so the leader's
    assembled matrix needs no simulation of the other n-1 views: O(n^2)
    instead of the (n, n, n) exchange tensor.  Equal to
    ``allgather_rows(local_rows, steps)[leader]``.  One row of
    :func:`ring_all_views`.
    """
    n = local_rows.shape[0]
    steps = _check_steps(n, steps)
    have = ((leader - np.arange(n)) % n) <= steps
    out = np.zeros_like(local_rows)
    out[have] = local_rows[have]
    return out


@dataclass
class TrafficEstimator:
    """Per-node EWMA of VOQ byte counters (A2/A4).

    One instance tracks one node's outgoing row by default;
    :meth:`fleet` builds a batched instance whose ``ewma`` is the whole
    (n, n) matrix — row i is node i's estimator — so one :meth:`update`
    folds every node's counters in a single vector op (float-identical to
    n per-node instances updated one by one).
    """

    n: int
    alpha: float = 0.3                      # EWMA weight of the newest period
    ewma: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.ewma is None:
            self.ewma = np.zeros((self.n,), dtype=np.float64)

    @classmethod
    def fleet(cls, n: int, alpha: float = 0.3) -> "TrafficEstimator":
        """All n per-node estimators as one batched instance
        (``ewma.shape == (n, n)``; row i is node i's EWMA)."""
        return cls(n=n, alpha=alpha, ewma=np.zeros((n, n), dtype=np.float64))

    def update(self, period_bits: np.ndarray) -> np.ndarray:
        """Fold one period's VOQ counters into the EWMA and return it.

        ``period_bits`` is read only — the caller owns (and resets) its
        counters; this method never mutates its input.
        """
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * period_bits
        return self.ewma


def dequantize(q: np.ndarray, k: int, bits_per_slot: float) -> np.ndarray:
    """Invert :func:`quantize_row`'s scaling (up to the floor): quantized
    counts are in units of ``bits_per_slot * k/(k-1)`` bits."""
    _check_k(k)
    return q.astype(np.float64) * (bits_per_slot * k / (k - 1))


def estimate_global_matrix(
    per_node_period_bits: np.ndarray,
    estimators: list[TrafficEstimator],
    k: int,
    bits_per_slot: float,
    steps: int | None = None,
    leader: int = 0,
) -> np.ndarray:
    """One full estimation round: EWMA update, quantize, AllGather,
    dequantize.  Returns the global matrix in the *input's* units (bits):
    quantized uint16 counts are rescaled by ``bits_per_slot * k/(k-1)`` so a
    consumer (``vermilion_schedule``) sees demand on the same scale it was
    measured, not raw quantizer ticks.

    ``steps``: AllGather slots actually executed (default: the full n-1).
    With a *complete* gather every node ends up with the identical matrix;
    with a *partial* gather (``steps < n-1``, mid-phase failure) views
    differ and we return ``leader``'s view, whose missing rows are zero —
    the stale/partial information a real node would act on.  The leader's
    view comes from the closed form :func:`ring_leader_view` (O(n^2)).
    """
    rows = np.stack([
        quantize_row(est.update(per_node_period_bits[i]), k, bits_per_slot)
        for i, est in enumerate(estimators)
    ])
    view = ring_leader_view(rows, steps=steps, leader=leader)
    return dequantize(view, k, bits_per_slot)


def estimate_all_views(
    per_node_period_bits: np.ndarray,
    estimator: TrafficEstimator,
    k: int,
    bits_per_slot: float,
    steps: int | None = None,
) -> RingViews:
    """Batched estimation round yielding *every* node's dequantized view.

    The per-node pipeline of :func:`estimate_global_matrix` (EWMA update,
    quantize, AllGather, dequantize), run for the whole fabric at once:
    ``estimator`` is a fleet instance (:meth:`TrafficEstimator.fleet`)
    whose one vectorized update replaces the n per-node updates
    float-for-float, quantization and dequantization act on all n rows in
    one shot, and the (possibly partial) gather is the closed-form banded
    mask of :func:`ring_all_views` — all n views in O(n^2).

    Returns a :class:`RingViews` whose ``rows`` are already dequantized to
    the input's units; node j's matrix is ``.view(j)`` and
    ``.unique()`` groups nodes with identical views (a complete gather
    collapses to one group, reproducing the single-leader estimate
    exactly).  Missing rows are zero at the holding node — zero quantized
    ticks dequantize to zero, so masking before or after dequantization is
    equivalent.
    """
    if estimator.ewma.shape != per_node_period_bits.shape:
        raise ValueError(
            f"need a fleet estimator of shape {per_node_period_bits.shape} "
            f"(got ewma shape {estimator.ewma.shape}); build one with "
            "TrafficEstimator.fleet(n)")
    rows = quantize_row(estimator.update(per_node_period_bits), k,
                        bits_per_slot)
    views = ring_all_views(rows, steps=steps)
    return RingViews(rows=dequantize(views.rows, k, bits_per_slot),
                     have=views.have)


# ---------------------------------------------------------------------------
# Device estimation ops (f32 PyTorch counterparts of the fleet pipeline)
# ---------------------------------------------------------------------------

def _f32(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=dev, dtype=torch.float32)


def fleet_update_quantize(
    ewma, period_bits, alpha: float, k: int, bits_per_slot: float,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fleet round on ``device`` (``None``: the card): fold a period's
    counters into the (n, n) fleet EWMA and quantize every row (A1/A2).

    The port of the reference's ``fleet_update_quantize_jax``, in f32 with
    its operations and scalars: ``(1 - alpha) * ewma + alpha *
    period_bits``, then ``clamp(floor(x * k_scale), 0, 65535)`` with
    ``k_scale = f32(((k-1)/k) / bits_per_slot)``, saturated before the
    cast so that nothing wraps.  Returns ``(new_ewma, q)``: f32 and
    ``torch.uint16`` tensors on ``device``, so repeated rounds can keep the
    EWMA there."""
    _check_k(k)
    dev = resolve_device(device)
    a = np.float32(alpha)
    keep = torch.tensor(np.float32(1.0) - a, dtype=torch.float32, device=dev)
    new_ewma = keep * _f32(ewma, dev) + torch.tensor(
        a, dtype=torch.float32, device=dev) * _f32(period_bits, dev)
    k_scale = torch.tensor(np.float32(((k - 1) / k) / bits_per_slot),
                           dtype=torch.float32, device=dev)
    q = torch.clamp(torch.floor(new_ewma * k_scale), 0.0, 65535.0)
    return new_ewma, q.to(torch.uint16)


def dequantize_device(q: torch.Tensor, k: int,
                      bits_per_slot: float) -> torch.Tensor:
    """The counterpart of :func:`dequantize` on ``q``'s device, in f32:
    ticks times ``f32(bits_per_slot * k/(k-1))``, as the reference's
    ``dequantize_jax``."""
    _check_k(k)
    unit = torch.tensor(np.float32(bits_per_slot * k / (k - 1)),
                        dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * unit
