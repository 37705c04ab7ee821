"""Flow-level timeslot simulator of the port: the batched sweep (single-hop
and two-hop), the aggregate plane and the adaptive control loop.

The port's counterpart of the device paths of ``repro.core.simulator``
(``run_sweep(..., backend="jax")``, ``simulate_aggregate_jax`` and
``run_adaptive(..., backend="jax")``): per (src, dst) virtual output
queues, FIFO within a queue, transmissions paused during reconfiguration
(the ``1 - recfg_frac`` capacity factor), processor-sharing flow
completion.

A single-hop sweep is three layers:

1. **Host layout.**  The cases' padded per-slot circuit plans
   (``Schedule.slot_circuits_padded``) are laid side by side into one
   ``(H, Jtot)`` plan of flat global pair ids ``(case * n + src) * n + dst``
   and f32 capacities; the flows of every case are sorted by arrival slot
   into one arrival list with per-slot bounds.
2. **Device data plane** (:func:`singlehop`).  One flat ``(B n^2)`` f32 VOQ
   on ``device``; each slot scatters its arrivals, gathers the queues of its
   circuits, serves ``tx = min(q, cap)``, and records ``tx`` and a
   ``drained`` flag per circuit.  Everything is uploaded once and read back
   once.
3. **Host credit replay.**  The per-slot delivered amounts go through the
   exact f64 processor-sharing ledger (:class:`_CreditState`), with drain
   reconciliation (``drained`` flags + ``_F32_DRAIN_REL``), which gives
   per-flow FCTs.

:func:`run_adaptive` (see :class:`AdaptiveCase`) closes the paper's
Appendix-A loop on top of the same two lower layers.  The epoch counters
that drive its control plane accumulate *arrivals* only, so the host
replays the whole control trajectory before any serving
(:func:`_compile_adaptive_plan`: fleet EWMA, quantized ring gather,
per-node schedules, collision-resolved fabric plans, construction and
reconfiguration charging) and emits, per slot, an index into a registry of
circuit plans; the batch's plans are laid out as per-case column blocks
and served in one :func:`singlehop` run on ``device``.  Under
``normalize="saturate"`` every schedule the loop builds projects through
the Sinkhorn kernel on ``device``.

Two-hop sweeps (``rotorlb``: RotorNet's direct hop plus VLB offload;
``vlb``: every bit through a relay) run the same three layers on dense
per-slot capacity matrices (:func:`_twohop_batch`): the relay data plane
in one of three formulations, chosen as the reference chooses
(:func:`twohop_fct`, with per-flow FCTs from the credit replay, at small
n; :func:`twohop_dense` or :func:`twohop_sparse`, aggregates only,
beyond).  :func:`simulate_aggregate` serves dense per-slot arrivals
through :func:`agg`; :func:`simulate` runs one case through the sweep's
engines.

The reference's numpy engine features run here too.  **Fault injection
in the sweep** (``SweepCase.faults``, single-hop): the fault timeline
depends on the slot alone, so the host replays it before serving
(:func:`_fault_layout`): masked supports into the case's plan columns,
refused arrivals out of the arrival list; :func:`singlehop` flushes the
VOQ rows of failed ToRs on the card.  **The adaptive loop's faults,
repair, ``collision="fullest"`` and activation jitter** read the data
plane (NACKs from VOQ occupancy, winners by VOQ depth), so such a case
runs on the degraded-service engine (:func:`_run_degraded_case`), one
case at a time, epoch by epoch: the control plane on the host at each
epoch boundary, each slot's flush, arrivals, arbitration
(:func:`_resolve_slot_claims`), fault mask, NACK counters and serve on
the card in f64, the credit replay on the host after the run.

The host ledger (workloads, ``SimResult``, ``_CreditState``) and the
control plane are the port's own copies of the reference's.
"""
from __future__ import annotations

import hashlib
import inspect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analysis.sanitize import make_sanitizer
from ..device import DATA_DTYPE, resolve_device
from .estimation import TrafficEstimator, estimate_all_views
from .faults import FaultSchedule, claims_fault_mask
from .schedule import (
    Schedule,
    effective_perms,
    oblivious_schedule,
    per_node_schedules,
    planes_changed,
    vermilion_schedule,
)
from .traffic import phase_train

__all__ = [
    "Workload",
    "websearch_workload",
    "phase_shifting_workload",
    "SimResult",
    "SweepCase",
    "SweepRow",
    "AdaptiveCase",
    "AdaptiveRow",
    "simulate",
    "run_sweep",
    "run_adaptive",
    "simulate_aggregate",
    "singlehop",
    "WEBSEARCH_CDF",
]

# DCTCP websearch flow-size CDF (bytes, cumulative prob) — standard benchmark
WEBSEARCH_CDF = np.array([
    (6_000, 0.15), (13_000, 0.30), (19_000, 0.40), (33_000, 0.53),
    (53_000, 0.60), (133_000, 0.70), (667_000, 0.80), (1_467_000, 0.90),
    (2_107_000, 0.95), (6_667_000, 0.98), (20_000_000, 1.00),
])

_MODES = ("single_hop", "rotorlb", "vlb")


@dataclass(frozen=True)
class Workload:
    src: np.ndarray          # (F,) int
    dst: np.ndarray          # (F,) int
    size: np.ndarray         # (F,) float, bits
    arrival: np.ndarray      # (F,) int, slot index (sorted)
    n: int
    horizon: int             # slots

    @property
    def num_flows(self) -> int:
        return len(self.src)

    def arrival_matrix(self) -> np.ndarray:
        """(horizon, n, n) dense bits arriving per slot (small n only)."""
        a = np.zeros((self.horizon, self.n, self.n))  # lint: allow-dense
        np.add.at(a, (self.arrival, self.src, self.dst), self.size)
        return a

    def demand_matrix(self) -> np.ndarray:
        """Average offered rate per pair, bits/slot (Vermilion's input)."""
        m = np.zeros((self.n, self.n))
        np.add.at(m, (self.src, self.dst), self.size)
        return m / self.horizon


def _sample_websearch(rng: np.random.Generator, size: int) -> np.ndarray:
    u = rng.random(size)
    sizes_b, probs = WEBSEARCH_CDF[:, 0], WEBSEARCH_CDF[:, 1]
    lo_p = np.concatenate([[0.0], probs[:-1]])
    lo_s = np.concatenate([[100.0], sizes_b[:-1]])
    idx = np.searchsorted(probs, u, side="left")
    frac = (u - lo_p[idx]) / (probs[idx] - lo_p[idx])
    return (lo_s[idx] + frac * (sizes_b[idx] - lo_s[idx])) * 8.0  # bits


def websearch_workload(
    n: int,
    load: float,
    horizon: int,
    bits_per_slot: float,
    d_hat: int = 1,
    seed: int = 0,
    pattern: str = "rack_permutation",
) -> Workload:
    """Poisson flow arrivals at ``load`` fraction of each node's egress
    capacity (d_hat * bits_per_slot per slot), websearch sizes.

    ``rack_permutation`` is the paper's pair-wise rack communication pattern;
    ``uniform`` sprays destinations uniformly.
    """
    rng = np.random.default_rng(seed)
    mean_size = float(np.mean(_sample_websearch(rng, 20000)))
    lam = load * d_hat * bits_per_slot / mean_size  # flows/slot/node
    srcs, dsts, sizes, arrs = [], [], [], []
    shift = 1 + int(rng.integers(0, n - 1))
    perm = (np.arange(n) + shift) % n
    for s in range(n):
        k = rng.poisson(lam * horizon)
        t = rng.integers(0, horizon, size=k)
        srcs.append(np.full(k, s))
        arrs.append(t)
        sizes.append(_sample_websearch(rng, k))
        if pattern == "rack_permutation":
            dsts.append(np.full(k, perm[s]))
        elif pattern == "uniform":
            d = rng.integers(0, n - 1, size=k)
            dsts.append(np.where(d >= s, d + 1, d))
        else:
            raise ValueError(pattern)
    order = np.argsort(np.concatenate(arrs), kind="stable")
    return Workload(
        src=np.concatenate(srcs)[order].astype(np.int64),
        dst=np.concatenate(dsts)[order].astype(np.int64),
        size=np.concatenate(sizes)[order],
        arrival=np.concatenate(arrs)[order].astype(np.int64),
        n=n,
        horizon=horizon,
    )



def phase_shifting_workload(
    n: int,
    load: float,
    horizon: int,
    bits_per_slot: float,
    d_hat: int = 1,
    seed: int = 0,
    phases: tuple[str, ...] = ("permutation", "uniform", "dlrm"),
    shift_period: int | None = None,
) -> Workload:
    """Non-stationary websearch traffic: the destination pattern follows a
    phase train (see :func:`repro_torch.core.traffic.phase_train`),
    shifting every ``shift_period`` slots (default: the horizon split
    evenly across the phases, cycling if it is longer).

    Within a phase with hose-normalized demand matrix ``m``, node ``s``
    opens Poisson flow arrivals at ``load * rowsum(m)[s]`` of its egress
    capacity (``d_hat * bits_per_slot``/slot), websearch flow sizes, and
    destinations drawn from ``m[s]``'s profile — so the *offered* matrix of
    each phase tracks its demand matrix while flow-level burstiness stays.
    """
    rng = np.random.default_rng(seed)
    mean_size = float(np.mean(_sample_websearch(rng, 20000)))
    if shift_period is None:
        shift_period = -(-horizon // len(phases))
    if shift_period <= 0:
        raise ValueError("shift_period must be positive")
    mats = phase_train(n, tuple(phases), seed=seed)
    srcs, dsts, sizes, arrs = [], [], [], []
    for t0 in range(0, horizon, shift_period):
        t1 = min(t0 + shift_period, horizon)
        m = mats[(t0 // shift_period) % len(mats)]
        row_tot = m.sum(axis=1)
        for s in range(n):
            if row_tot[s] <= 0:
                continue
            lam = load * d_hat * bits_per_slot * row_tot[s] / mean_size
            kf = int(rng.poisson(lam * (t1 - t0)))
            if kf == 0:
                continue
            srcs.append(np.full(kf, s))
            arrs.append(rng.integers(t0, t1, size=kf))
            sizes.append(_sample_websearch(rng, kf))
            dsts.append(rng.choice(n, size=kf, p=m[s] / row_tot[s]))
    if not srcs:
        srcs, dsts = [np.empty(0, np.int64)], [np.empty(0, np.int64)]
        sizes, arrs = [np.empty(0)], [np.empty(0, np.int64)]
    order = np.argsort(np.concatenate(arrs), kind="stable")
    return Workload(
        src=np.concatenate(srcs)[order].astype(np.int64),
        dst=np.concatenate(dsts)[order].astype(np.int64),
        size=np.concatenate(sizes)[order],
        arrival=np.concatenate(arrs)[order].astype(np.int64),
        n=n,
        horizon=horizon,
    )


@dataclass
class SimResult:
    fct_slots: np.ndarray        # (F,) float; np.inf if unfinished at horizon
    flow_size: np.ndarray        # (F,) bits
    utilization: float           # delivered / ideal egress capacity
    delivered_bits: float
    offered_bits: float
    avg_hops: float = 1.0
    fault_lost_bits: float = 0.0     # VOQ bits stranded by abrupt failures
    fault_refused_bits: float = 0.0  # offered bits refused at a dead or
                                     # draining ingress (never injected)

    def fct_percentile(self, q: float, short_cutoff: float | None = None,
                       long_cutoff: float | None = None) -> float:
        m = np.isfinite(self.fct_slots)
        if short_cutoff is not None:
            m &= self.flow_size <= short_cutoff
        if long_cutoff is not None:
            m &= self.flow_size > long_cutoff
        if not m.any():
            return float("nan")
        return float(np.percentile(self.fct_slots[m], q))

    @property
    def completed_frac(self) -> float:
        if len(self.fct_slots) == 0:
            return float("nan")
        return float(np.isfinite(self.fct_slots).mean())



# ---------------------------------------------------------------------------
# Host flow-credit ledger
# ---------------------------------------------------------------------------

_PAD_W = 8           # water-level search depth before exact fallback
_KEY_DT = np.dtype([("p", np.int64), ("r", np.float64)])


def _ranged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    out = np.arange(total)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    return out - np.repeat(starts, counts)


class _CreditState:
    """Processor-sharing flow-completion bookkeeping, O(pairs) per slot.

    Active flows are kept in arrays sorted by (pair id, stored size).  A
    water-fill step subtracts the same level from every surviving flow of a
    pair, so the engine stores per-pair *offsets* instead of rewriting
    per-flow remainders: ``true_remaining = stored - off[pair]``.  A slot
    then costs O(1) per delivered pair (advance the offset, complete the
    sorted prefix that sank below the level) instead of O(active flows).
    Completions are tombstoned via per-pair skip counters and physically
    removed in periodic compactions, which also rebase offsets before they
    grow past float precision.

    Matches :class:`_FlowTracker.credit` semantics (per pair, bits are
    water-filled across active flows sorted by remaining size; flows
    dropping to <= 1e-6 bits complete with ``fct = slot + 1 - arrival``)
    up to ~ulp-level float drift from the offset representation.
    """

    def __init__(self, n_pairs: int, pid: np.ndarray, size: np.ndarray,
                 arrival: np.ndarray, fct: np.ndarray):
        self.pid = pid
        self.size = size
        self.arrival = arrival
        self.fct = fct
        self.off = np.zeros(n_pairs)      # per-pair water level served
        self.psum = np.zeros(n_pairs)     # approx total remaining per pair
        self.ctr = np.zeros(n_pairs, dtype=np.int64)   # tombstoned prefix
        self.keys = np.empty(0, dtype=_KEY_DT)         # (pair, stored)
        self.act = np.empty(0, dtype=np.int64)         # flow ids
        self.dead = 0

    def arrive(self, newf: np.ndarray) -> None:
        # the insert below rewrites the whole keys/act arrays, so shedding
        # tombstones first keeps every later O(active) pass proportional
        # to genuinely alive flows (the batched replay ledger otherwise
        # drags ~1/3 dead entries through each rebuild)
        if self.dead * 4 > len(self.act) and self.dead > 1024:
            self._compact()
        npid = self.pid[newf]
        stored = self.size[newf] + self.off[npid]
        o = np.lexsort((stored, npid))
        newf, npid, stored = newf[o], npid[o], stored[o]
        np.add.at(self.psum, npid, self.size[newf])
        q = np.empty(len(newf), dtype=_KEY_DT)
        q["p"] = npid
        q["r"] = stored
        if self.keys.size:
            # hand-rolled sorted insert (np.insert x2 costs several passes)
            K, A = len(q), len(self.keys)
            tgt = np.searchsorted(self.keys, q, side="left") + np.arange(K)
            keys = np.empty(A + K, dtype=_KEY_DT)
            act = np.empty(A + K, dtype=np.int64)
            keep = np.ones(A + K, dtype=bool)
            keep[tgt] = False
            keys[tgt] = q
            act[tgt] = newf
            keys[keep] = self.keys
            act[keep] = self.act
            self.keys, self.act = keys, act
        else:
            self.keys = q
            self.act = newf.copy()

    def remaining_active(self) -> tuple[float, int]:
        """(total bits still stored for uncompleted flows, completed count)
        — the sanitizer's credit-closure probe; read-only."""
        completed = int(np.isfinite(self.fct).sum())
        if not self.act.size:
            return 0.0, completed
        alive = np.isinf(self.fct[self.act])
        rem = (self.keys["r"][alive]
               - self.off[self.keys["p"][alive]])
        return float(np.maximum(rem, 0.0).sum()), completed

    def _compact(self) -> None:
        alive = np.isinf(self.fct[self.act])
        self.act = self.act[alive]
        self.keys = self.keys[alive]
        self.ctr[:] = 0
        self.dead = 0
        # rebase offsets into stored values before they swamp the mantissa
        if self.off.max() > 1e9 and self.act.size:
            self.keys["r"] -= self.off[self.keys["p"]]
            self.off[:] = 0.0

    def credit(self, delivered_flat: np.ndarray, slot: int,
               drain_rel: float = 0.0, level_rel: float = 0.0) -> None:
        pids = np.flatnonzero(delivered_flat > 1e-9)
        self.credit_pairs(pids, delivered_flat[pids], slot,
                          drain_rel=drain_rel, level_rel=level_rel)

    def credit_pairs(self, pids: np.ndarray, s: np.ndarray,
                     slot: int, drain: np.ndarray | None = None,
                     drain_rel: float = 0.0,
                     level_rel: float = 0.0) -> None:
        """Credit ``s`` bits to each (unique) pair in ``pids`` — the sparse
        entry point for engines that know the delivered support.

        ``drain``/``drain_rel`` reconcile float32 engines with the f64
        ledger: a pair flagged in ``drain`` (the device observed the queue
        empty) or whose credit lands within ``drain_rel`` of its exact
        remaining total is forced to complete fully, so f32 rounding in the
        delivered amounts cannot leave 1-ulp residues that stall FCTs.
        """
        if not self.act.size or not pids.size:
            return
        keep = s > 1e-9
        if drain is not None:
            keep |= drain
        if not keep.all():
            pids, s = pids[keep], s[keep]
            if drain is not None:
                drain = drain[keep]
        if not pids.size:
            return
        kp = self.keys["p"]
        lo = np.searchsorted(kp, pids, side="left") + self.ctr[pids]
        hi = np.searchsorted(kp, pids, side="right")
        m = hi - lo
        g = m > 0
        if not g.all():
            if not g.any():
                return
            pids, lo, hi, m, s = pids[g], lo[g], hi[g], m[g], s[g]
            if drain is not None:
                drain = drain[g]
        S = len(pids)
        off_g = self.off[pids]
        stored = self.keys["r"]

        # fast path: when the pair's smallest remaining (the head of its
        # sorted run) sits above the no-completion water level s/m plus
        # every epsilon the slow path could apply, nothing completes:
        # head_rem > s/m implies head_rem*m > s >= s_eff so no flow sinks
        # (j = 0), the level is exactly s/m — the same float op the full
        # path performs as (s - 0.0) / max(m - 0, 1) — and head_rem
        # clearing the guard keeps k = 0 and every drain_rel force off
        head_rem = stored[lo] - off_g
        lvl = s / m
        guard = 1e-6 + 1.01 * drain_rel * s
        if level_rel:
            guard = guard + level_rel * (lvl + off_g)
        easy = head_rem > lvl + guard
        if drain is not None:
            easy &= ~drain
        if easy.all():
            self.off[pids] = off_g + lvl
            self.psum[pids] -= s
            return
        if easy.any():
            pe = pids[easy]
            self.off[pe] = off_g[easy] + lvl[easy]
            self.psum[pe] -= s[easy]
            hard = ~easy
            pids, lo, hi, m, s = (pids[hard], lo[hard], hi[hard], m[hard],
                                  s[hard])
            off_g = off_g[hard]
            if drain is not None:
                drain = drain[hard]
            S = len(pids)

        # exact remaining totals only where the budget might drain the pair
        s_eff = s
        need_mask = 4.0 * s >= np.maximum(self.psum[pids], 0.0)
        if drain is not None:
            need_mask |= drain
        need = np.flatnonzero(need_mask)
        if need.size:
            mm = m[need]
            flat = np.repeat(lo[need], mm) + _ranged_arange(mm)
            bounds = np.concatenate([[0], np.cumsum(mm[:-1])])
            tot = (np.add.reduceat(stored[flat], bounds)
                   - mm * off_g[need])
            s_eff = s.copy()
            s_eff[need] = np.minimum(s[need], tot)
            # force full completion where the device saw the queue drain, or
            # where f32 rounding left the credit within drain_rel of exact
            force = np.zeros(need.size, dtype=bool)
            if drain is not None:
                force |= drain[need]
            if drain_rel > 0.0:
                force |= (tot >= 0.0) & (tot - s[need] <= drain_rel * tot)
            if force.any():
                s_eff[need[force]] = np.maximum(tot[force], 0.0)

        # water level from the sorted prefix (true rem = stored - off)
        W = min(_PAD_W, int(m.max()))
        col = np.arange(W)
        valid = col[None, :] < np.minimum(m, W)[:, None]
        safe = np.where(valid, lo[:, None] + col[None, :], 0)
        r_pre = np.where(valid, stored[safe] - off_g[:, None], 0.0)
        csum = np.cumsum(r_pre, axis=1)
        fill = csum + r_pre * (m[:, None] - 1 - col[None, :])
        below = (fill < s_eff[:, None]) & valid
        j = below.sum(axis=1)

        full = j >= m                                  # drain: level = max
        r_last = stored[hi - 1] - off_g
        prev = np.where(j > 0, csum[np.arange(S), np.maximum(j - 1, 0)], 0.0)
        level = np.where(full, r_last,
                         (s_eff - prev) / np.maximum(m - j, 1))
        # completion epsilon: exact engines (level_rel=0) use the absolute
        # 1e-6 sliver; f32 pro-rata replays widen it by the accumulated
        # drift scale (rounding in the credited amounts grows with the
        # pair's cumulative water level), so a residue cannot stall a
        # completion past its f64 slot.  Engines with per-pair drain flags
        # (single-hop) keep level_rel=0 — their boundary is already exact.
        eps = 1e-6 + level_rel * (np.maximum(level, 0.0) + off_g)
        k = ((r_pre <= (level + eps)[:, None]) & valid).sum(axis=1)
        k[full] = m[full]

        # level search (or completion count) overran the pad: exact solve
        ovf = np.flatnonzero(((j >= W) | (k >= W)) & (m > W))
        for i in ovf:
            r_g = stored[lo[i]:hi[i]] - off_g[i]
            mi = int(m[i])
            c_g = np.cumsum(r_g)
            f_g = c_g + r_g * np.arange(mi - 1, -1, -1)
            ji = int(np.searchsorted(f_g, s_eff[i], side="left"))
            level[i] = (r_g[-1] if ji >= mi else
                        (s_eff[i] - (c_g[ji - 1] if ji else 0.0)) / (mi - ji))
            eps_i = 1e-6 + level_rel * (max(level[i], 0.0) + off_g[i])
            k[i] = mi if ji >= mi else int(
                np.searchsorted(r_g, level[i] + eps_i, side="right"))

        # complete the sunken prefix, advance offsets and totals
        self.off[pids] = off_g + level
        self.psum[pids] = np.where(k == m, 0.0, self.psum[pids] - s_eff)
        if k.any():
            kc = np.minimum(k, W)
            fmask = (col[None, :] < kc[:, None]) & valid
            done = self.act[safe[fmask]]
            big = np.flatnonzero(k > W)
            if big.size:
                ext = (np.repeat(lo[big] + W, k[big] - W)
                       + _ranged_arange(k[big] - W))
                done = np.concatenate([done, self.act[ext]])
            self.fct[done] = slot + 1 - self.arrival[done]
            self.ctr[pids] += k
            self.dead += int(k.sum())
            if self.dead * 2 > len(self.act) and self.dead > 4096:
                self._compact()




# ---------------------------------------------------------------------------
# Single-hop sweep: host layout, device data plane, host replay
# ---------------------------------------------------------------------------

_PAD_J = 64          # circuit support -> multiple of 64 pairs (per case)

# f32 serving vs f64 flow ledger: when a credited amount lands within this
# relative distance of a pair's exact remaining bits, treat the pair as
# fully drained (f32 has ~1.2e-7 ulp; slack covers a few hundred slots of
# accumulated rounding in the per-slot tx sums).
_F32_DRAIN_REL = 2e-5


def singlehop(voq: torch.Tensor, arr_pid: torch.Tensor,
              arr_size: torch.Tensor, arr_bounds: np.ndarray,
              p_pid: torch.Tensor, p_cap: torch.Tensor,
              tx: torch.Tensor, drained: torch.Tensor,
              flush: dict | None = None,
              fault_lost: torch.Tensor | None = None) -> torch.Tensor:
    """Serve ``H = p_pid.shape[0]`` slots of the single-hop data plane.

    The port of the reference's ``singlehop`` scan, one Python iteration per
    slot.  ``voq`` is the flat ``(B n^2)`` f32 queue carry, updated in
    place and returned.  Slot ``h`` scatters the arrivals
    ``arr_pid/arr_size[arr_bounds[h]:arr_bounds[h + 1]]``, gathers the
    queues of its plan row ``p_pid[h]``, serves ``min(q, p_cap[h])`` into
    ``tx[h]`` and flags ``drained[h]`` where the circuit emptied its queue.
    Padded plan entries (zero capacity) are exact no-ops.

    ``flush`` (fault injection) maps a slot to ``(rows, cases)``: the
    ``(k, n)`` flat pair ids of the VOQ rows that the slot's ``tor_fail``
    events strand (one row per failed node) and each row's case.  Before
    the slot's arrivals, as in the reference's numpy engine, each row's
    bits are summed in f64 into ``fault_lost[case]`` and the row is
    zeroed."""
    for h in range(p_pid.shape[0]):
        if flush and h in flush:
            rows, cases = flush[h]
            fault_lost.index_add_(
                0, cases, voq[rows].to(fault_lost.dtype).sum(dim=1))
            voq[rows.view(-1)] = 0.0
        a, b = int(arr_bounds[h]), int(arr_bounds[h + 1])
        if b > a:
            voq.index_add_(0, arr_pid[a:b], arr_size[a:b])
        pid = p_pid[h]
        q = voq[pid]
        t = torch.minimum(q, p_cap[h], out=tx[h])
        voq.index_add_(0, pid, -t)
        torch.logical_and(t >= q, t > 0, out=drained[h])
    return voq


def _batch_flows(wls: list[Workload], n: int, horizons: np.ndarray,
                 H: int, refused: np.ndarray | None = None):
    """Concatenated flow state and the arrival list of a batch, single-hop
    or two-hop: flat global pair ids ``(case * n + src) * n + dst``; flows
    that arrive within their case's horizon, sorted by arrival slot
    (stable), with per-slot bounds ``bucket`` (slot h's arrivals are
    ``order[bucket[h]:bucket[h + 1]]``).  ``refused`` (per concatenated
    flow) leaves out the flows a fault refused at their ingress: they
    never arrive, and their FCTs stay inf.  Returns
    (f_off, fct, credit, order, bucket, apid, asz)."""
    f_off = np.concatenate(
        [[0], np.cumsum([wl.num_flows for wl in wls])]).astype(np.int64)
    f_item = np.concatenate(
        [np.full(wl.num_flows, b, dtype=np.int64)
         for b, wl in enumerate(wls)])
    f_src = np.concatenate([wl.src for wl in wls]).astype(np.int64)
    f_dst = np.concatenate([wl.dst for wl in wls]).astype(np.int64)
    f_size = np.concatenate([wl.size for wl in wls]).astype(np.float64)
    f_arr = np.concatenate([wl.arrival for wl in wls]).astype(np.int64)
    pid = (f_item * n + f_src) * n + f_dst
    fct = np.full(len(f_size), np.inf)
    credit = _CreditState(len(wls) * n * n, pid, f_size, f_arr, fct)
    valid = f_arr < horizons[f_item]
    if refused is not None:
        valid &= ~refused
    order = np.argsort(f_arr, kind="stable")
    order = order[valid[order]]
    bucket = np.searchsorted(f_arr[order], np.arange(H + 1))
    apid = pid[order]
    asz = f_size[order].astype(np.float32)
    return f_off, fct, credit, order, bucket, apid, asz


def _replay_credit(credit: _CreditState, order: np.ndarray,
                   bucket: np.ndarray, p_pid: np.ndarray, tx, drained,
                   H: int) -> np.ndarray:
    """Replay the data plane's per-slot delivered support through the
    exact f64 flow-credit ledger: arrivals enter in the same stable order
    as the reference engines, then each slot's (pid, tx) support is
    credited with drain reconciliation (``drain`` flags +
    ``_F32_DRAIN_REL``).  Returns the per-slot tx widened to f64 for the
    delivered-bits sums."""
    pid64 = np.asarray(p_pid, np.int64)
    tx64 = np.asarray(tx, np.float64)
    dr = np.asarray(drained, bool)
    # one vectorized pass extracts each slot's nonzero support (np.nonzero
    # is row-major, so per-slot runs are contiguous); the loop then feeds
    # credit_pairs pre-filtered columns and skips dark/empty slots outright
    live = (tx64[:H] > 1e-9) | dr[:H]
    nz_row, nz_col = np.nonzero(live)
    bnd = np.concatenate([[0], np.cumsum(live.sum(axis=1))])
    pid_nz = pid64[nz_row, nz_col]
    s_nz = tx64[nz_row, nz_col]
    dr_nz = dr[nz_row, nz_col]
    for slot in range(H):
        newf = order[bucket[slot]:bucket[slot + 1]]
        if newf.size:
            credit.arrive(newf)
        a, b = bnd[slot], bnd[slot + 1]
        if a == b:
            continue
        credit.credit_pairs(pid_nz[a:b], s_nz[a:b], slot,
                            drain=dr_nz[a:b], drain_rel=_F32_DRAIN_REL)
    return tx64


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lapper(timings: dict | None):
    """A ``lap(key)`` that adds the wall seconds since the previous lap
    (or since this call) to ``timings[key]``; a no-op sink when
    ``timings`` is None."""
    last = [time.perf_counter()]

    def lap(key: str) -> None:
        now = time.perf_counter()
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + now - last[0]
        last[0] = now
    return lap


def _serve(wls: list[Workload], horizons: np.ndarray, p_pid: np.ndarray,
           p_cap: np.ndarray, dev: torch.device, lap, timings: dict | None,
           refused: np.ndarray | None = None, flush: dict | None = None):
    """Serve the ``(H, Jtot)`` plan ``p_pid`` / ``p_cap`` (int64 global
    pair ids, f32 capacities; case b's pairs offset by ``b * n * n``) to
    the flows of ``wls`` on ``dev`` and replay the delivered amounts
    through the f64 credit ledger.  ``refused`` and ``flush`` carry a
    fault replay's refused flows and flushed VOQ rows (slot -> list of
    ``(case, node)``; see :func:`_fault_layout`).  Returns (f_off, fct,
    credit, tx64, voq, fault_lost): flow offsets per case, per-flow FCTs,
    the ledger, the per-slot tx in f64, the final VOQ on the host and the
    f64 bits each case's flushes stranded."""
    n = wls[0].n
    H = p_pid.shape[0]
    f_off, fct, credit, order, bucket, apid, asz = _batch_flows(
        wls, n, horizons, H, refused=refused)
    lap("layout_s")

    # the plan, the arrival list and the VOQ go up once
    d_pid = torch.from_numpy(p_pid).to(dev)
    d_cap = torch.from_numpy(p_cap).to(dev)
    d_apid = torch.from_numpy(apid).to(dev)
    d_asz = torch.from_numpy(asz).to(dev)
    voq = torch.zeros(len(wls) * n * n, dtype=DATA_DTYPE, device=dev)  # lint: allow-dense
    tx = torch.empty(p_pid.shape, dtype=DATA_DTYPE, device=dev)
    drained = torch.empty(p_pid.shape, dtype=torch.bool, device=dev)
    fault_lost = torch.zeros(len(wls), dtype=torch.float64, device=dev)
    d_flush = None
    if flush:
        d_flush = {}
        for h, items in flush.items():
            rows = np.array([(b * n + node) * n + np.arange(n)
                             for b, node in items], dtype=np.int64)
            cases = np.array([b for b, _ in items], dtype=np.int64)
            d_flush[h] = (torch.from_numpy(rows).to(dev),
                          torch.from_numpy(cases).to(dev))
    _sync(dev)
    lap("upload_s")
    _launch("singlehop", singlehop, voq, d_apid, d_asz, bucket, d_pid,
            d_cap, tx, drained, flush=d_flush, fault_lost=fault_lost)
    _sync(dev)
    lap("device_loop_s")
    tx_h = tx.cpu().numpy()
    dr_h = drained.cpu().numpy()
    voq_h = voq.cpu().numpy()
    lost_h = fault_lost.cpu().numpy()
    lap("download_s")
    if timings is not None:
        timings["slots"] = timings.get("slots", 0) + H
    tx64 = _replay_credit(credit, order, bucket, p_pid, tx_h, dr_h, H)
    lap("replay_s")
    return f_off, fct, credit, tx64, voq_h, lost_h


def _fault_layout(cases: list[tuple[Schedule, Workload]], faults: list,
                  bits_per_slot: float, p_pid: np.ndarray,
                  p_cap: np.ndarray, offs: np.ndarray,
                  horizons: np.ndarray, san=None):
    """Replay each faulted case's :class:`FaultTimeline` on the host, over
    every slot of the batch, before anything is served (the timeline
    depends on the slot alone), as the reference's numpy engine advances
    it slot by slot (``_simulate_batch_singlehop``).

    From a case's first event on, its column block of the ``(H, Jtot)``
    plan is rewritten in place with the masked support of each slot: the
    period slot's matching block under ``claims_fault_mask`` with
    self-loops dropped and parallel survivors accumulated (memoized per
    (period slot, timeline version)), padded with pair ``(0, 0)`` at zero
    capacity.  Returns ``(refused, flush)``: per concatenated flow,
    whether its ingress was refusing injection at its arrival slot; and
    slot -> ``[(case, node), ...]``, the nodes whose ``tor_fail`` strands
    their VOQ rows at that slot, in the reference's order."""
    n = cases[0][1].n
    H = p_pid.shape[0]
    src0 = np.arange(n)
    flush: dict[int, list] = {}
    refused = []
    for b, ((sched, wl), fs) in enumerate(zip(cases, faults)):
        if not fs:
            refused.append(np.zeros(wl.num_flows, dtype=bool))
            continue
        tl = fs.compile(n, sched.d_hat)
        base = b * n * n
        cols = slice(int(offs[b]), int(offs[b + 1]))
        jc = int(offs[b + 1] - offs[b])
        w_b = bits_per_slot * (1.0 - sched.recfg_frac)
        memo: dict[tuple, int] = {}
        ent_pid: list[np.ndarray] = []
        ent_cap: list[np.ndarray] = []
        f_slots, f_ids = [], []
        inj_slots, inj_states = [], []
        version = 0
        for slot in range(H):
            for node in tl.advance(slot):
                flush.setdefault(slot, []).append((b, int(node)))
            if tl.clean:
                continue
            if tl.version != version:
                version = tl.version
                inj_slots.append(slot)
                inj_states.append(tl.inject_ok.copy())
            ps = slot % sched.n_slots
            key = (ps, version)
            idx = memo.get(key)
            if idx is None:
                blk = sched.perms[ps * sched.d_hat:(ps + 1) * sched.d_hat]
                keep = claims_fault_mask(blk, tl.link_ok()) & (blk != src0)
                cpid = (base + np.broadcast_to(src0, blk.shape) * n
                        + blk)[keep]
                upid, inv = np.unique(cpid, return_inverse=True)
                cap = np.bincount(inv, weights=np.full(len(cpid), w_b),
                                  minlength=len(upid))
                if san is not None:
                    san.check_plan_pairs(
                        upid % (n * n), cap, n, sched.d_hat, w_b,
                        label=f"singlehop:case{b}:slot{ps}:faulted")
                row_p = np.full(jc, base, dtype=np.int64)
                row_c = np.zeros(jc, dtype=np.float32)
                row_p[:len(upid)] = upid
                row_c[:len(upid)] = cap
                idx = memo[key] = len(ent_pid)
                ent_pid.append(row_p)
                ent_cap.append(row_c)
            f_slots.append(slot)
            f_ids.append(idx)
        if f_slots:
            sl = np.asarray(f_slots)
            ids = np.asarray(f_ids)
            p_pid[sl, cols] = np.stack(ent_pid)[ids]
            live = sl < horizons[b]
            p_cap[sl[live], cols] = np.stack(ent_cap)[ids[live]]
        # the ingress state each flow met at its arrival slot
        ref_b = np.zeros(wl.num_flows, dtype=bool)
        if inj_slots:
            k = np.searchsorted(np.asarray(inj_slots), wl.arrival,
                                side="right") - 1
            states = np.stack(inj_states)
            at = k >= 0
            ref_b[at] = ~states[k[at], wl.src[at]]
        refused.append(ref_b)
    return np.concatenate(refused), flush


def _singlehop_batch(
    cases: list[tuple[Schedule, Workload]], bits_per_slot: float,
    dev: torch.device, san=None, timings: dict | None = None,
    faults: list | None = None,
) -> list[SimResult]:
    """Single-hop dynamics for a batch of same-n cases, with per-flow FCTs:
    the data plane serves the padded per-slot circuit plan in f32 on
    ``dev`` and the host replays the delivered amounts through the exact
    f64 processor-sharing credit ledger.  ``timings``, if given, receives
    the wall seconds of each phase (accumulated over batches).

    ``faults`` optionally carries one :class:`FaultSchedule` (or None) per
    case: the host replays each timeline ahead of serving
    (:func:`_fault_layout`), a case's plan stays the fault-free one until
    its first event fires (bit-identical prefix), refused arrivals never
    enter the fabric (``fault_refused_bits``, f64 in arrival order) and
    the VOQ rows of failed ToRs are flushed on the card into
    ``fault_lost_bits``."""
    lap = _lapper(timings)
    B = len(cases)
    n = cases[0][1].n
    for sched, wl in cases:
        if wl.n != n:
            raise ValueError("all workloads in a batch must share n")
        if sched.n != n:
            raise ValueError("schedule/workload size mismatch")
    horizons = np.array([wl.horizon for _, wl in cases], dtype=np.int64)
    H = int(horizons.max())

    # per-case padded circuit plans -> per-case column blocks of one
    # (H, Jtot) plan; capacities zero past a case's horizon
    padded = [sched.slot_circuits_padded(bits_per_slot,
                                         pair_base=b * n * n, j_pad=_PAD_J)
              for b, (sched, _) in enumerate(cases)]
    offs = np.concatenate(
        [[0], np.cumsum([p[0].shape[1] for p in padded])]).astype(np.int64)
    Jtot = int(offs[-1])
    p_pid = np.zeros((H, Jtot), dtype=np.int64)
    p_cap = np.zeros((H, Jtot), dtype=np.float32)
    slots = np.arange(H)
    for b, (ppid, pcap) in enumerate(padded):
        ps = slots % ppid.shape[0]
        h_b = int(horizons[b])
        p_pid[:, offs[b]:offs[b + 1]] = ppid[ps]
        p_cap[:h_b, offs[b]:offs[b + 1]] = pcap[ps[:h_b]]
    wls = [wl for _, wl in cases]
    refused = flush = None
    fault_refused = np.zeros(B)
    if faults is not None and any(faults):
        refused, flush = _fault_layout(cases, faults, bits_per_slot, p_pid,
                                       p_cap, offs, horizons, san=san)
        # refused bits per case, added in the reference's order: by
        # arrival slot, stable
        f_item = np.concatenate([np.full(wl.num_flows, b, dtype=np.int64)
                                 for b, wl in enumerate(wls)])
        f_arr = np.concatenate([wl.arrival for wl in wls])
        f_size = np.concatenate([wl.size for wl in wls]).astype(np.float64)
        o = np.argsort(f_arr, kind="stable")
        o = o[(refused & (f_arr < horizons[f_item]))[o]]
        np.add.at(fault_refused, f_item[o], f_size[o])
    f_off, fct, credit, tx64, voq_h, fault_lost = _serve(
        wls, horizons, p_pid, p_cap, dev, lap, timings, refused=refused,
        flush=flush)

    results = []
    for b, (sched, wl) in enumerate(cases):
        cols = slice(int(offs[b]), int(offs[b + 1]))
        delivered = float(tx64[:int(horizons[b]), cols].sum())
        offered = float(wl.size[wl.arrival < wl.horizon].sum())
        ideal = wl.horizon * n * sched.d_hat * bits_per_slot
        results.append(SimResult(
            fct_slots=fct[f_off[b]:f_off[b + 1]],
            flow_size=wl.size,
            utilization=delivered / ideal,
            delivered_bits=delivered,
            offered_bits=offered,
            avg_hops=1.0,
            fault_lost_bits=float(fault_lost[b]),
            fault_refused_bits=float(fault_refused[b]),
        ))
    if san is not None:
        voq64 = np.asarray(voq_h, np.float64)
        for b, (sched, wl) in enumerate(cases):
            san.check_workload(wl)
            san.check_schedule(sched)
            queued = float(voq64[b * n * n:(b + 1) * n * n].sum())
            r = results[b]
            san.check_conservation(
                r.offered_bits - r.fault_refused_bits, r.delivered_bits,
                queued, label=f"{dev.type}:case{b}:conservation",
                float32=True, fault_lost=r.fault_lost_bits)
        rem, completed = credit.remaining_active()
        # flushed bits stay on their never-completing flows, inside
        # remaining_active: the closure needs no fault term
        san.check_credit_closure(
            sum(r.offered_bits - r.fault_refused_bits for r in results),
            sum(r.delivered_bits for r in results), rem, completed,
            label=f"{dev.type}:singlehop:credit", float32=True)
        lap("sanitize_s")
    return results


# ---------------------------------------------------------------------------
# Aggregate and two-hop data planes
# ---------------------------------------------------------------------------

# Water-fill completion-boundary forgiveness for the pro-rata relay replay
# (no per-pair drain observation there): scaled by the pair's cumulative
# water level, since that is where credited-amount rounding accumulates.
_F32_LEVEL_REL = 1e-6

# The two-hop FCT step carries the full per-(at, src, dst) relay
# attribution tensor (B, n, n, n) and emits per-slot (B, n, n) delivered
# matrices — affordable at small n only.  Beyond these bounds the two-hop
# path stays aggregate-only (fct_slots all inf), as in the reference.
_TWOHOP_FCT_MAX_N = 64

# The reference pads the horizon to a multiple of this for its jit cache
# and sizes the FCT bound on the padded horizon.  The port pads nothing,
# but it computes the same padded horizon, so every batch takes the
# reference's route (and keeps or loses its FCTs as there).
_PAD_H = 128

# Dense (one batched matrix product over the full (B, n, n) relay-bucket
# matrix) vs sparse (circuit-support gathers + index_add_) crossover: the
# reference's, by n.
_TWOHOP_DENSE_MAX_N = 256

_JEPS = 1e-12


def _pad_to(x: int, q: int) -> int:
    return max(q, -(-x // q) * q)


def _twohop_fct_ok(B: int, n: int, H_pad: int) -> bool:
    return n <= _TWOHOP_FCT_MAX_N and H_pad * B * n * n * 4 <= (1 << 27)


def _twohop_route(B: int, n: int, H: int, kernel: str | None = None) -> str:
    """The step a two-hop batch of ``B`` cases, ``n`` nodes and ``H``
    slots runs: ``"twohop_fct"`` (per-flow FCTs) where the attribution
    tensor fits, else ``"twohop_dense"`` up to ``_TWOHOP_DENSE_MAX_N``
    nodes and ``"twohop_sparse"`` beyond; ``kernel`` (``"dense"`` or
    ``"sparse"``) forces an aggregate-only formulation.  The reference's
    choice in ``_twohop_batch_jax``."""
    if kernel is None:
        if _twohop_fct_ok(B, n, _pad_to(H, _PAD_H)):
            return "twohop_fct"
        kernel = "dense" if n <= _TWOHOP_DENSE_MAX_N else "sparse"
    if kernel not in ("dense", "sparse"):
        raise ValueError(f"kernel must be 'dense' or 'sparse' "
                         f"(got {kernel!r})")
    return f"twohop_{kernel}"


def agg(voq: torch.Tensor, caps: torch.Tensor, cap_idx: torch.Tensor,
        arr: torch.Tensor, delivered: torch.Tensor) -> torch.Tensor:
    """Serve ``H = arr.shape[0]`` slots of the aggregate single-hop plane.

    The port of the reference's ``agg`` scan, one Python iteration per
    slot: ``voq`` is the ``(B, n, n)`` f32 queue carry, updated in place
    and returned; slot ``h`` adds the dense arrivals ``arr[h]``, serves
    ``min(voq, caps[cap_idx[h]])`` and writes the bits served per case
    into ``delivered[h]``."""
    for h in range(arr.shape[0]):
        voq.add_(arr[h])
        tx = torch.minimum(voq, caps[cap_idx[h]])
        voq.sub_(tx)
        torch.sum(tx, dim=(1, 2), out=delivered[h])
    return voq


def simulate_aggregate(sched: Schedule, arrivals: np.ndarray,
                       bits_per_slot: float, device=None):
    """Single-hop aggregate dynamics of ``sched`` on ``device`` (``None``:
    the card; ``"cpu"``: the same PyTorch ops on the CPU).  The port of
    ``simulate_aggregate_jax``; returns ``(delivered_per_slot,
    final_voq)`` as f32 numpy arrays.

    ``arrivals``: ``(horizon, n, n)`` bits arriving per slot, uploaded
    once; the per-slot delivered bits and the final VOQ are read back
    once."""
    dev = resolve_device(device)
    arrivals = np.asarray(arrivals, dtype=np.float32)
    horizon = arrivals.shape[0]
    caps = sched.capacity_per_slot(bits_per_slot).astype(np.float32)
    cap_idx = (np.arange(horizon) % caps.shape[0]).reshape(horizon, 1)
    voq = torch.zeros((1, sched.n, sched.n), dtype=DATA_DTYPE, device=dev)
    delivered = torch.empty((horizon, 1), dtype=DATA_DTYPE, device=dev)
    _launch("agg", agg, voq, torch.from_numpy(caps).to(dev),
            torch.from_numpy(cap_idx).to(dev),
            torch.from_numpy(arrivals).to(dev).unsqueeze(1), delivered)
    return delivered[:, 0].cpu().numpy(), voq[0].cpu().numpy()


# The two-hop steps below serve in f32 like the reference's scans.  The
# dense step's batched product and the FCT step's sums rely on full f32
# arithmetic on the card: TF32 must stay off for f32 matrix products
# (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

def _arrive(voq_flat: torch.Tensor, arr_pid: torch.Tensor,
            arr_size: torch.Tensor, arr_bounds: np.ndarray, h: int) -> None:
    a, b = int(arr_bounds[h]), int(arr_bounds[h + 1])
    if b > a:
        voq_flat.index_add_(0, arr_pid[a:b], arr_size[a:b])


def _offload_shares(cap: torch.Tensor, voq: torch.Tensor,
                    row_sum=torch.sum):
    """The proportional spray of the leftover capacity: per (case, node
    u), ``send_u = min(leftover, queue)``, each circuit's share ``ls`` of
    the leftover and each destination's share ``qs`` of the queue, the row
    sums taken by ``row_sum(x, 2)``."""
    leftover = row_sum(cap, 2)
    queue = row_sum(voq, 2)
    send_u = torch.minimum(leftover, queue)
    ls = torch.where(leftover[:, :, None] > _JEPS,
                     cap / leftover.clamp_min(_JEPS)[:, :, None], 0.0)
    qs = torch.where(queue[:, :, None] > _JEPS,
                     voq / queue.clamp_min(_JEPS)[:, :, None], 0.0)
    return send_u, ls, qs


def twohop_dense(voq: torch.Tensor, relay: torch.Tensor, caps: torch.Tensor,
                 cap_idx: torch.Tensor, arr_pid: torch.Tensor,
                 arr_size: torch.Tensor, arr_bounds: np.ndarray,
                 direct: torch.Tensor, delivered: torch.Tensor,
                 second: torch.Tensor) -> None:
    """Serve ``H = cap_idx.shape[0]`` slots of the two-hop relay plane in
    its dense formulation.

    The port of the reference's ``twohop_dense`` scan, one Python
    iteration per slot.  ``voq`` and ``relay`` are the ``(B, n, n)`` f32
    carries (``relay[b, at, dst]``: bits waiting at relay ``at`` for
    ``dst``), updated in place.  Slot ``h`` scatters its arrivals (flat
    pair ids, as :func:`singlehop`), then on ``caps[cap_idx[h]]`` drains
    the relays first, serves the direct hop (masked by ``direct`` for
    vlb), and sprays the leftover capacity into the relays in proportion
    (``moved = (send_u ls)^T @ qs``), bits whose relay is their
    destination landing at once.  It writes the bits delivered and the
    second-hop bits per case into ``delivered[h]`` and ``second[h]``."""
    n = voq.shape[1]
    offdiag = 1.0 - torch.eye(n, dtype=voq.dtype, device=voq.device)
    voq_flat = voq.view(-1)
    for h in range(cap_idx.shape[0]):
        _arrive(voq_flat, arr_pid, arr_size, arr_bounds, h)
        cap = caps[cap_idx[h]]
        # priority 1: second-hop relay traffic (at u, destined v)
        send1 = torch.minimum(relay, cap)
        relay.sub_(send1)
        torch.sum(send1, dim=(1, 2), out=second[h])
        cap.sub_(send1)
        tx = torch.minimum(voq, cap).mul_(direct)   # vlb: no direct hop
        voq.sub_(tx)
        torch.add(second[h], tx.sum(dim=(1, 2)), out=delivered[h])
        cap.sub_(tx)
        # moved[b, v, d] = sum_u send_u * link_share[u, v] * q_share[u, d]
        send_u, ls, qs = _offload_shares(cap, voq)
        moved = torch.bmm((send_u[:, :, None] * ls).transpose(1, 2), qs)
        voq.sub_(send_u[:, :, None] * qs).clamp_min_(0.0)
        # bits whose relay node IS the destination arrive at once
        delivered[h].add_(moved.diagonal(dim1=1, dim2=2).sum(dim=1))
        relay.add_(moved.mul_(offdiag))


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)`` in one fixed pairwise order (element i with element
    i + h of the 2h leading ones, the last one of an odd count carried),
    built of elementwise adds: the same bits on the card as on the CPU,
    where ``torch.sum``'s order differs between the two."""
    k = x.shape[dim]
    while k > 1:
        h = k // 2
        y = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        if k % 2:
            y = torch.cat([y, x.narrow(dim, k - 1, 1)], dim)
        x, k = y, y.shape[dim]
    return x.squeeze(dim)


def _arrival_rounds(apid: np.ndarray, bucket: np.ndarray) -> tuple:
    """Each slot's arrivals regrouped into rounds of distinct pair ids, the
    k-th arrival of each pair in round k, so that an ``index_add_`` of a
    round adds to each pair once: the card's atomics then give the bits of
    the CPU's adds in arrival order.  Returns (the arrivals' permutation,
    the rounds' bounds in it, slot h's rounds ``slot_rounds[h]:
    slot_rounds[h + 1]``)."""
    A, H = len(apid), len(bucket) - 1
    slot = np.repeat(np.arange(H), np.diff(bucket))
    idx = np.arange(A)
    by_pair = np.lexsort((idx, apid, slot))
    first = np.ones(A, dtype=bool)
    first[1:] = ((slot[by_pair][1:] != slot[by_pair][:-1])
                 | (apid[by_pair][1:] != apid[by_pair][:-1]))
    rank = np.empty(A, dtype=np.int64)
    rank[by_pair] = idx - np.maximum.accumulate(np.where(first, idx, 0))
    perm = np.lexsort((idx, rank, slot))
    new = np.ones(A, dtype=bool)
    new[1:] = ((slot[perm][1:] != slot[perm][:-1])
               | (rank[perm][1:] != rank[perm][:-1]))
    starts = np.flatnonzero(new)
    bounds = np.append(starts, A)
    slot_rounds = np.searchsorted(slot[perm][starts], np.arange(H + 1))
    return perm, bounds, slot_rounds


def twohop_fct(voq: torch.Tensor, relay3: torch.Tensor, caps: torch.Tensor,
               cap_idx: torch.Tensor, arr_pid: torch.Tensor,
               arr_size: torch.Tensor, arr_rounds: tuple,
               direct: torch.Tensor, dp: torch.Tensor,
               second: torch.Tensor) -> None:
    """Serve ``H = cap_idx.shape[0]`` slots of the two-hop relay plane,
    keeping the per-source attribution that per-flow FCTs need.

    The port of the reference's ``twohop_fct`` scan: ``relay3[b, at, src,
    dst]`` carries whose bits sit in each relay bucket; relay drains and
    offload sprays are proportional within a bucket.  Slot ``h`` writes
    the ``(B, n, n)`` bits delivered per (src, dst) into ``dp[h]`` and
    the second-hop bits per case into ``second[h]``.

    Every value the FCTs read is computed in an order that does not
    depend on the device: the arrivals by rounds of distinct pairs
    (``arr_rounds``: the bounds and per-slot rounds of
    :func:`_arrival_rounds`, ``arr_pid`` / ``arr_size`` in its order) and
    the sums by :func:`_tree_sum`.  An ulp of difference in a relay
    bucket moves a flow's last bits by many slots, so the card's FCTs
    equal the CPU's only when its bits do."""
    n = voq.shape[1]
    offdiag = 1.0 - torch.eye(n, dtype=voq.dtype, device=voq.device)
    voq_flat = voq.view(-1)
    bounds, slot_rounds = arr_rounds
    for h in range(cap_idx.shape[0]):
        for r in range(int(slot_rounds[h]), int(slot_rounds[h + 1])):
            a, b = int(bounds[r]), int(bounds[r + 1])
            voq_flat.index_add_(0, arr_pid[a:b], arr_size[a:b])
        cap = caps[cap_idx[h]]
        # priority 1: drain relay buckets, attributed pro-rata to src
        tot = _tree_sum(relay3, 2)                   # [b, at, dst] totals
        send1 = torch.minimum(tot, cap)
        frac = torch.where(tot > _JEPS, send1 / tot.clamp_min(_JEPS), 0.0)
        out = dp[h]
        out.copy_(_tree_sum(relay3 * frac[:, :, None, :], 1))
        relay3.mul_((1.0 - frac)[:, :, None, :])
        torch.sum(send1, dim=(1, 2), out=second[h])
        cap.sub_(send1)
        # direct hop (vlb cases masked), already (src, dst) resolved
        tx = torch.minimum(voq, cap).mul_(direct)
        voq.sub_(tx)
        out.add_(tx)
        cap.sub_(tx)
        # offload leftover capacity into relays, keeping src labels:
        # moved[b, u, v, d] = send_u * link_share[u, v] * q_share[u, d]
        send_u, ls, qs = _offload_shares(cap, voq, _tree_sum)
        moved = (send_u[:, :, None] * ls)[:, :, :, None] * qs[:, :, None, :]
        voq.sub_(send_u[:, :, None] * qs).clamp_min_(0.0)
        # bits whose relay node IS the destination arrive at once,
        # delivered for (src = u, dst = v)
        out.add_(moved.diagonal(dim1=2, dim2=3))
        # relay bucket at v gains src-u bits destined d
        relay3.add_(moved.mul_(offdiag).transpose(1, 2))


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int):
    return x.new_zeros(num).index_add_(0, seg, x)


def twohop_sparse(voq: torch.Tensor, relay: torch.Tensor,
                  caps: torch.Tensor, cap_idx: torch.Tensor,
                  arr_pid: torch.Tensor, arr_size: torch.Tensor,
                  arr_bounds: np.ndarray, plan_idx: np.ndarray,
                  plan_bounds: np.ndarray, plan: dict,
                  direct: torch.Tensor, delivered: torch.Tensor,
                  second: torch.Tensor) -> None:
    """Serve ``H = cap_idx.shape[0]`` slots of the two-hop relay plane in
    its sparse formulation: relay drain and offload touch only the
    circuit support.

    The port of the reference's ``twohop_sparse`` scan (``segment_sum``
    as ``index_add_``, ``take_along_axis`` as ``gather``).  ``relay`` is
    the ``(B n, n)`` carry ``relay[b n + at, dst]``.  Slot ``h`` runs on
    support plan ``p = plan_idx[h]``: entries ``plan_bounds[p]`` to
    ``plan_bounds[p + 1]`` of the flat arrays ``plan["pf"]`` (pair id
    ``(b n + at) n + v``), ``"row"`` (``b n + at``), ``"v"``, ``"b"`` and
    ``"bv"`` (``b n + v``) — the reference's plan rows without their
    padding, whose entries are exact no-ops there."""
    B, n = voq.shape[0], voq.shape[1]
    voq_flat = voq.view(-1)
    voq3 = voq.view(B * n, n)
    relay_flat = relay.view(-1)
    for h in range(cap_idx.shape[0]):
        _arrive(voq_flat, arr_pid, arr_size, arr_bounds, h)
        cap = caps[cap_idx[h]]
        cap3 = cap.view(B * n, n)
        cap_flat = cap.view(-1)
        p = int(plan_idx[h])
        lo, hi = int(plan_bounds[p]), int(plan_bounds[p + 1])
        pf, row, v, b, bv = (plan[k][lo:hi]
                             for k in ("pf", "row", "v", "b", "bv"))
        # priority 1: drain relayed bits over the support circuits (a
        # plan holds each support pair once)
        rs = relay_flat[pf]
        cap_j = cap_flat[pf]
        send1 = torch.minimum(rs, cap_j)
        relay_flat[pf] = rs - send1
        cap_flat[pf] = cap_j - send1
        second[h].zero_().index_add_(0, b, send1)
        # direct hop (vlb cases masked)
        tx = torch.minimum(voq, cap).mul_(direct)
        voq.sub_(tx)
        torch.add(second[h], tx.sum(dim=(1, 2)), out=delivered[h])
        cap.sub_(tx)
        # offload leftover capacity, support rows only
        leftover = cap3.sum(dim=1)
        queue = voq3.sum(dim=1)
        send_u = torch.minimum(leftover, queue)
        lo_j = leftover[row]
        ls = torch.where(lo_j > _JEPS,
                         cap_flat[pf] / lo_j.clamp_min(_JEPS), 0.0)
        coeff = send_u[row] * ls
        q_j = queue[row]
        qs = torch.where((q_j > _JEPS)[:, None],
                         voq3[row] / q_j.clamp_min(_JEPS)[:, None], 0.0)
        moved = coeff[:, None] * qs                 # (J, n) over dst
        dec = _segment_sum(coeff, row, B * n)
        scale = torch.where(queue > _JEPS,
                            dec / queue.clamp_min(_JEPS), 0.0)
        voq3.sub_(voq3 * scale[:, None]).clamp_min_(0.0)
        # bits whose relay node IS the destination arrive at once
        dd = moved.gather(1, v[:, None])[:, 0]
        delivered[h].add_(_segment_sum(dd, b, B))
        moved.scatter_(1, v[:, None], 0.0)
        relay.index_add_(0, bv, moved)          # -> bucket [(b, at v), dst]


class _SupportPlans:
    """Per-slot circuit-support plans of a two-hop batch (the port's copy
    of the reference's, for the sparse step).

    Per (case, period slot), the <= n*d_hat (at, dst) pairs with nonzero
    capacity; relay drain/fill only ever touches these rows (everything
    else is an exact multiply-by-one / add-zero), so the per-slot relay
    work is O(n^2 d_hat), not O(n^3).  The merged plan of a slot depends
    only on ``slot % ns_b`` per case (the residue tuple :meth:`key`), so
    plans are memoized on that tuple."""

    _CAT = ("pf", "row", "v", "b", "bv")

    def __init__(self, caps_list: list[np.ndarray], n: int):
        self.ns = [c.shape[0] for c in caps_list]
        self.per_case: list[list[dict]] = []
        for b, caps in enumerate(caps_list):
            plans = []
            for ps in range(caps.shape[0]):
                at, v = np.nonzero(caps[ps])  # lex-sorted by (at, v)
                row = b * n + at
                plans.append({"pf": row * n + v, "row": row, "v": v,
                              "b": np.full(len(at), b), "bv": b * n + v})
            self.per_case.append(plans)
        self._memo: dict[tuple, dict] = {}

    def key(self, slot: int) -> tuple:
        return tuple(slot % p for p in self.ns)

    def plan(self, slot: int) -> dict:
        key = self.key(slot)
        plan = self._memo.get(key)
        if plan is not None:
            return plan
        sd = [self.per_case[b][key[b]] for b in range(len(self.per_case))]
        plan = {k: np.concatenate([d[k] for d in sd]) for k in self._CAT}
        if len(self._memo) < 1024:  # bound memory for long aperiodic batches
            self._memo[key] = plan
        return plan


def _support_lut(caps_list: list[np.ndarray], n: int, H: int):
    """The sparse step's plan table: each distinct residue tuple's merged
    support once, as flat int64 arrays with per-plan bounds, and the plan
    each slot runs.  Returns (plan_idx, plan_bounds, plan)."""
    plans = _SupportPlans(caps_list, n)
    keys: dict[tuple, int] = {}
    plan_idx = np.zeros(H, dtype=np.int64)
    plan_list: list[dict] = []
    for slot in range(H):
        key = plans.key(slot)
        pi = keys.get(key)
        if pi is None:
            pi = keys[key] = len(plan_list)
            plan_list.append(plans.plan(slot))
        plan_idx[slot] = pi
    plan_bounds = np.concatenate(
        [[0], np.cumsum([len(p["v"]) for p in plan_list])]).astype(np.int64)
    plan = {k: np.concatenate([p[k] for p in plan_list]).astype(np.int64)
            for k in _SupportPlans._CAT}
    return plan_idx, plan_bounds, plan


def _twohop_batch(
    cases: list[tuple[Schedule, Workload]], bits_per_slot: float,
    modes: list[str], dev: torch.device, kernel: str | None = None,
    san=None, timings: dict | None = None,
) -> list[SimResult]:
    """Two-hop (rotorlb / vlb, mixed freely) relay dynamics for a batch of
    same-n cases on ``dev``: the port of the reference's
    ``_twohop_batch_jax``.

    The route is the reference's (:func:`_twohop_route`): where the
    per-(at, src, dst) attribution tensor fits, :func:`twohop_fct` emits
    per-slot delivered (src, dst) matrices and the host replays them
    through the exact f64 credit ledger, so ``fct_slots`` are real;
    otherwise :func:`twohop_dense` (``n <= _TWOHOP_DENSE_MAX_N``) or
    :func:`twohop_sparse` give aggregates only (utilization, delivered
    bits, ``avg_hops``; ``fct_slots`` all inf).  ``kernel`` forces
    ``"dense"`` or ``"sparse"``.  Everything is uploaded once and read
    back once; ``timings``, if given, receives the wall seconds of each
    phase, as :func:`_singlehop_batch`'s."""
    for m in modes:
        if m not in ("rotorlb", "vlb"):
            raise ValueError(f"not a two-hop mode: {m}")
    lap = _lapper(timings)
    B = len(cases)
    n = cases[0][1].n
    for sched, wl in cases:
        if wl.n != n:
            raise ValueError("all workloads in a batch must share n")
        if sched.n != n:
            raise ValueError("schedule/workload size mismatch")
    horizons = np.array([wl.horizon for _, wl in cases], dtype=np.int64)
    H = int(horizons.max())
    route = _twohop_route(B, n, H, kernel)

    # the capacity LUT: every case's period slots, then one zero matrix
    # that each case's slots past its horizon index
    caps_list = [sched.capacity_per_slot(bits_per_slot)
                 for sched, _ in cases]
    ns = np.array([c.shape[0] for c in caps_list], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(ns)])
    caps_flat = np.concatenate(
        caps_list + [np.zeros((1, n, n))]).astype(np.float32)
    slots = np.arange(H)[:, None]
    cap_idx = np.where(slots < horizons[None, :],
                       offs[None, :-1] + slots % ns[None, :], offs[-1])
    f_off, fct, credit, order, bucket, apid, asz = _batch_flows(
        [wl for _, wl in cases], n, horizons, H)
    direct = np.array([m != "vlb" for m in modes],
                      dtype=np.float32).reshape(B, 1, 1)
    if route == "twohop_sparse":
        plan_idx, plan_bounds, plan = _support_lut(caps_list, n, H)
    lap("layout_s")

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    if route == "twohop_fct":
        perm, bounds, slot_rounds = _arrival_rounds(apid, bucket)
        args = (up(caps_flat), up(cap_idx), up(apid[perm]), up(asz[perm]),
                (bounds, slot_rounds))
    else:
        args = (up(caps_flat), up(cap_idx), up(apid), up(asz), bucket)
    d_direct = up(direct)
    voq = torch.zeros((B, n, n), dtype=DATA_DTYPE, device=dev)  # lint: allow-dense
    second = torch.empty((H, B), dtype=DATA_DTYPE, device=dev)
    if route == "twohop_fct":
        relay = torch.zeros((B, n, n, n), dtype=DATA_DTYPE, device=dev)  # lint: allow-dense
        out = torch.empty((H, B, n, n), dtype=DATA_DTYPE, device=dev)  # lint: allow-dense
    else:
        relay = torch.zeros((B, n, n), dtype=DATA_DTYPE, device=dev)  # lint: allow-dense
        out = torch.empty((H, B), dtype=DATA_DTYPE, device=dev)
    if route == "twohop_sparse":
        relay = relay.view(B * n, n)
        plan = {k: up(a) for k, a in plan.items()}
    _sync(dev)
    lap("upload_s")
    if route == "twohop_fct":
        _launch(route, twohop_fct, voq, relay, *args, d_direct, out,
                second)
    elif route == "twohop_dense":
        _launch(route, twohop_dense, voq, relay, *args, d_direct, out,
                second)
    else:
        _launch(route, twohop_sparse, voq, relay, *args, plan_idx,
                plan_bounds, plan, d_direct, out, second)
    _sync(dev)
    lap("device_loop_s")
    out64 = np.asarray(out.cpu().numpy(), np.float64)
    second64 = np.asarray(second.cpu().numpy(), np.float64)
    voq64 = np.asarray(voq.cpu().numpy(), np.float64)
    relay64 = np.asarray(relay.cpu().numpy(), np.float64)
    lap("download_s")
    if timings is not None:
        timings["slots"] = timings.get("slots", 0) + H

    if route == "twohop_fct":
        # per-flow FCTs: the per-slot delivered (src, dst) matrices through
        # the exact f64 ledger, with the pro-rata replay's level slack
        for slot in range(H):
            newf = order[bucket[slot]:bucket[slot + 1]]
            if newf.size:
                credit.arrive(newf)
            credit.credit(out64[slot].reshape(-1), slot,
                          drain_rel=_F32_DRAIN_REL, level_rel=_F32_LEVEL_REL)
        lap("replay_s")
        delivered = [float(out64[:, b].sum()) for b in range(B)]
    else:
        delivered = out64.sum(axis=0)
    sec = second64.sum(axis=0)
    results = []
    for b, (sched, wl) in enumerate(cases):
        d = float(delivered[b])
        results.append(SimResult(
            # aggregate-only routes never credit: their FCTs stay all inf
            fct_slots=fct[f_off[b]:f_off[b + 1]],
            flow_size=wl.size,
            utilization=d / (wl.horizon * n * sched.d_hat * bits_per_slot),
            delivered_bits=d,
            offered_bits=float(wl.size[wl.arrival < wl.horizon].sum()),
            avg_hops=1.0 + float(sec[b]) / max(d, 1e-9),
        ))
    if san is not None:
        # relay-queued bits close each case's conservation ledger
        relay_queued = relay64.reshape(B, -1).sum(axis=1)
        for b, (sched, wl) in enumerate(cases):
            san.check_workload(wl)
            san.check_schedule(sched)
            san.check_caps_dense(
                caps_list[b], sched.d_hat,
                bits_per_slot * (1.0 - sched.recfg_frac),
                label=f"{dev.type}:case{b}:caps")
            san.check_conservation(
                results[b].offered_bits, results[b].delivered_bits,
                float(voq64[b].sum()) + float(relay_queued[b]),
                label=f"{dev.type}:case{b}:conservation", float32=True)
        if route == "twohop_fct":
            rem, completed = credit.remaining_active()
            san.check_credit_closure(
                sum(r.offered_bits for r in results),
                sum(r.delivered_bits for r in results), rem, completed,
                label=f"{dev.type}:twohop_fct:credit", float32=True)
        lap("sanitize_s")
    return results


# ---------------------------------------------------------------------------
# The slot kernels as one table, for the op-level analyzer
# ---------------------------------------------------------------------------

# The arguments each slot kernel carries from slot to slot: the state whose
# footprint repro_torch.analysis.ir measures at two fabric sizes.
KERNEL_CARRIES = {
    "agg": ("voq",),
    "singlehop": ("voq",),
    "twohop_dense": ("voq", "relay"),
    "twohop_fct": ("voq", "relay3"),
    "twohop_sparse": ("voq", "relay"),
}


def slot_kernels() -> dict:
    """The five slot kernels by name: the counterpart of the reference's
    ``jax_kernels`` table, which :mod:`repro_torch.analysis.ir` runs."""
    return {"agg": agg, "singlehop": singlehop, "twohop_dense": twohop_dense,
            "twohop_fct": twohop_fct, "twohop_sparse": twohop_sparse}


# The analyzer's stand-in for a slot kernel's call (:func:`drive_slot_kernel`):
# while set, ``hook(name, fn, kwargs)`` runs in place of ``fn(**kwargs)``.
_slot_hook = None


def _launch(name: str, fn, *args, **kwargs):
    """Run the slot kernel ``fn`` (``name`` in :func:`slot_kernels`), or hand
    it and its arguments by name to the analyzer's hook where one is set."""
    if _slot_hook is None:
        return fn(*args, **kwargs)
    bound = inspect.signature(fn).bind(*args, **kwargs)
    return _slot_hook(name, fn, bound.arguments)


# The small batch the analyzer drives: the reference bucket's 128 slots,
# the quickstart's slot of 100 Gb/s x 4.5 us, websearch flows at load 0.6.
_DRIVE_BITS = 100e9 * 4.5e-6
_DRIVE_LOAD = 0.6


def drive_slot_kernel(kernel: str, hook, *, B: int = 2, n: int = 8,
                      device=None) -> None:
    """Drive the engine path that launches slot kernel ``kernel`` once, on a
    seeded batch, with ``hook(kernel, fn, kwargs)`` called in place of the
    kernel (``kwargs``: its arguments by name, as the engine built them).

    The counterpart of the reference's ``kernel_abstract_inputs``: what the
    hook sees is the engine's own layout and carry, not a copy of it.  The
    batch is ``B`` cases of ``n`` nodes over 128 slots, case b a uniform
    websearch workload (seed b) on the oblivious schedule with two port
    planes.  ``singlehop`` runs through :func:`_singlehop_batch`, the two-hop
    kernels through :func:`_twohop_batch` on their own routes (the cases
    alternate ``rotorlb`` and ``vlb``), and ``agg`` through
    :func:`simulate_aggregate`, which serves one case: ``B`` must be 1
    there.  On ``device`` (``None``: the card)."""
    global _slot_hook
    if kernel not in KERNEL_CARRIES:
        raise ValueError(f"unknown kernel {kernel!r} "
                         f"(have {sorted(KERNEL_CARRIES)})")
    if kernel == "agg" and B != 1:
        raise ValueError(f"agg's engine path serves one case (got B={B})")
    dev = resolve_device(device)
    sched = oblivious_schedule(n, d_hat=2)
    wls = [websearch_workload(n, _DRIVE_LOAD, _PAD_H, _DRIVE_BITS,
                              d_hat=2, seed=b, pattern="uniform")
           for b in range(B)]
    prev, _slot_hook = _slot_hook, hook
    try:
        if kernel == "agg":
            simulate_aggregate(sched, wls[0].arrival_matrix(), _DRIVE_BITS,
                               device=dev)
        elif kernel == "singlehop":
            _singlehop_batch([(sched, wl) for wl in wls], _DRIVE_BITS, dev)
        else:
            force = {"twohop_fct": None, "twohop_dense": "dense",
                     "twohop_sparse": "sparse"}[kernel]
            if force is None and _twohop_route(B, n, _PAD_H) != kernel:
                raise ValueError(f"B={B}, n={n} is past twohop_fct's "
                                 "attribution bound")
            _twohop_batch([(sched, wl) for wl in wls], _DRIVE_BITS,
                          [("rotorlb", "vlb")[b % 2] for b in range(B)],
                          dev, kernel=force)
    finally:
        _slot_hook = prev


def simulate(
    sched: Schedule,
    wl: Workload,
    bits_per_slot: float,
    mode: str = "single_hop",
    sanitize: bool | None = None,
    faults: FaultSchedule | None = None,
    device=None,
) -> SimResult:
    """Run ``wl`` over ``sched`` for ``wl.horizon`` slots on ``device``
    (``None``: the card; ``"cpu"``: the same PyTorch ops on the CPU).  The
    port of the reference's ``simulate``: single-hop through
    :func:`_singlehop_batch`, ``rotorlb`` / ``vlb`` through
    :func:`_twohop_batch` on the route :func:`run_sweep` takes.

    ``sanitize``: run the :mod:`repro_torch.analysis.sanitize` contract
    checks (default: the ``REPRO_SANITIZE`` env var).  ``faults``: an
    optional :class:`FaultSchedule` of timed failure events (single_hop
    mode only — the two-hop relay planes don't model per-circuit
    failure); an empty schedule is bit-identical to passing None.
    """
    if mode not in _MODES:
        raise ValueError(mode)
    if faults:
        if not isinstance(faults, FaultSchedule):
            raise ValueError("faults must be a FaultSchedule "
                             f"(got {type(faults).__name__})")
        if mode != "single_hop":
            raise ValueError(
                "fault injection is only supported on the single_hop "
                f"engine (got mode={mode!r})")
        faults.validate(wl.n, sched.d_hat)
    dev = resolve_device(device)
    san = make_sanitizer(sanitize)
    if mode == "single_hop":
        return _singlehop_batch([(sched, wl)], bits_per_slot, dev, san=san,
                                faults=[faults] if faults else None)[0]
    return _twohop_batch([(sched, wl)], bits_per_slot, [mode], dev,
                         san=san)[0]


# ---------------------------------------------------------------------------
# Sweep API
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepCase:
    """One (schedule, workload, mode) point of a sweep grid.

    ``mode``: ``"single_hop"`` (circuits carry their own pair's traffic),
    ``"rotorlb"`` (RotorNet: direct hop, then two-hop VLB offload of the
    leftover capacity) or ``"vlb"`` (every bit through a relay).
    ``faults`` optionally injects a timed :class:`FaultSchedule`
    (single-hop cases only); an empty schedule behaves exactly like None.
    Malformed cases — unknown mode, bad fault events — raise
    ``ValueError`` at construction."""
    sched: Schedule
    wl: Workload
    mode: str = "single_hop"
    label: str = ""
    meta: dict = field(default_factory=dict)
    faults: FaultSchedule | None = None

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES} "
                             f"(got {self.mode!r})")
        if self.faults is not None:
            if not isinstance(self.faults, FaultSchedule):
                raise ValueError("faults must be a FaultSchedule "
                                 f"(got {type(self.faults).__name__})")
            if self.faults and self.mode != "single_hop":
                raise ValueError(
                    "fault injection is only supported on single_hop "
                    f"cases (got mode={self.mode!r})")
            self.faults.validate(self.wl.n, self.sched.d_hat)


@dataclass
class SweepRow:
    label: str
    mode: str
    result: SimResult
    meta: dict
    sim_s: float          # batch wall time amortized over the batch


def run_sweep(
    cases: list[SweepCase],
    bits_per_slot: float,
    device=None,
    sanitize: bool | None = None,
    timings: dict | None = None,
) -> list[SweepRow]:
    """Evaluate a grid of simulation cases; results come back in input
    order.  The port of ``run_sweep(..., backend="jax")``.

    Cases batch by node count and by single-hop or two-hop mode (``rotorlb``
    and ``vlb`` mix freely in one batch); each batch's data plane runs on
    ``device`` (``None``: the card; ``"cpu"``: the same PyTorch ops on the
    CPU).  Single-hop batches get per-flow FCTs from the host's exact f64
    credit replay; two-hop batches take the reference's route
    (:func:`_twohop_batch`): per-flow FCTs where the relay attribution
    tensor fits (small n and horizon), else aggregates only, with
    ``fct_slots`` all inf.

    ``sanitize``: run the :mod:`repro_torch.analysis.sanitize` contract
    checks on every batch (default: the ``REPRO_SANITIZE`` env var);
    results are bit-identical either way.  ``timings``: a dict that
    receives the wall seconds of each phase summed over the batches
    (``layout_s``, ``upload_s``, ``device_loop_s``, ``download_s``,
    ``replay_s``, ``sanitize_s``), the number of slots served, and under
    ``"batches"`` one dict per batch: its ``route`` (``"singlehop"``,
    ``"twohop_fct"``, ``"twohop_dense"`` or ``"twohop_sparse"``), its
    number of ``cases`` and its own phase seconds and slots.

    Single-hop cases may carry ``faults`` (:class:`SweepCase`): the host
    replays each timeline before serving, the masked plans and the
    refused arrivals are laid out ahead, and the card flushes the VOQ rows
    of failed ToRs (:func:`_singlehop_batch`); the reference runs these on
    its numpy backend only.
    """
    for c in cases:
        if c.mode not in _MODES:
            raise ValueError(c.mode)
    dev = resolve_device(device)
    san = make_sanitizer(sanitize)
    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(cases):
        groups.setdefault((c.wl.n, c.mode == "single_hop"), []).append(i)
    rows: list[SweepRow | None] = [None] * len(cases)
    for (n, single), idxs in groups.items():
        batch = [(cases[i].sched, cases[i].wl) for i in idxs]
        bt = None if timings is None else {}
        t0 = time.perf_counter()
        if single:
            route = "singlehop"
            batch_faults = [cases[i].faults for i in idxs]
            results = _singlehop_batch(
                batch, bits_per_slot, dev, san=san, timings=bt,
                faults=batch_faults if any(batch_faults) else None)
        else:
            route = _twohop_route(len(idxs), n,
                                  max(wl.horizon for _, wl in batch))
            results = _twohop_batch(batch, bits_per_slot,
                                    [cases[i].mode for i in idxs], dev,
                                    san=san, timings=bt)
        dt = (time.perf_counter() - t0) / len(idxs)
        if bt is not None:
            for key, val in bt.items():
                timings[key] = timings.get(key, 0) + val
            timings.setdefault("batches", []).append(
                dict(bt, route=route, cases=len(idxs)))
        for i, r in zip(idxs, results):
            rows[i] = SweepRow(label=cases[i].label, mode=cases[i].mode,
                               result=r, meta=dict(cases[i].meta), sim_s=dt)
    return rows  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Adaptive epoch-driven scheduling (closed estimation -> schedule loop)
# ---------------------------------------------------------------------------

_POLICIES = ("adaptive", "oracle", "stale", "oblivious")
_COLLISIONS = ("drop", "lowest", "receiver", "fullest")


@dataclass(frozen=True)
class _FabricPlan:
    """The fabric's merged per-slot circuit plan when every input port
    follows its own node's schedule, with output-port collisions already
    resolved.  ``plans[s]`` is the period-slot-s ``(pair_id, capacity)``
    support the data plane serves; ``lost[s]`` the capacity (bits) that
    slot loses to contention; ``disagreement`` the contested fraction of
    (matching, port) claims (see ``schedule_disagreement``).  A consistent
    fabric (one schedule) has zero loss and zero disagreement and its
    plans are byte-identical to ``Schedule.slot_circuits``.

    ``contested[s]`` counts slot s's contested traffic-carrying claims
    (src != dst inputs whose output port at least one other input also
    claims) — the capacity ``contested * w`` bounds ``lost`` from above
    for every arbitration policy, which is the disagreement-accounting
    closure the sanitizer enforces.

    ``eff``/``nonself``/``win`` carry the raw (T, n) claim structure so
    the degraded-service paths (fault masks, partially-dark planes, mixed
    old/new activation) can rebuild any slot's support from first
    principles: ``eff[t, i]`` the port input i is tuned to, ``win`` the
    statically-arbitrated winners.  ``win`` (and ``plans``) are ``None``
    for queue-aware arbitration (``collision="fullest"`` under
    disagreement), where winners depend on per-slot VOQ depth and the
    engine resolves each served slot on the device
    (:func:`_resolve_slot_claims`).  ``plane_map`` maps the plan's logical
    plane rows to physical fabric planes — the identity except for
    repaired schedules rebuilt over the surviving planes."""

    plans: list | None
    n_slots: int
    disagreement: float
    lost: np.ndarray
    groups: int
    contested: np.ndarray
    eff: np.ndarray                    # (T, n) effective port claims
    nonself: np.ndarray                # (T, n) claim would carry traffic
    win: np.ndarray | None             # (T, n) static winners; None=dynamic
    w: float                           # bits per circuit-slot after guard
    plane_map: np.ndarray | None = None


def _fabric_plan(
    scheds: list[Schedule],
    owner: np.ndarray,
    bits_per_slot: float,
    collision: str,
    plane_map: np.ndarray | None = None,
) -> _FabricPlan:
    """Merge per-node schedules into the fabric's effective circuit plan.

    With one schedule (all nodes agree) this is exactly the consistent
    plan of ``Schedule.slot_circuits``.  With several, each input port i is
    configured by *its own* node's matching row, so a merged row is
    generally not a permutation: two or more inputs can claim the same
    output port of the same plane.  ``collision`` picks the data-plane
    resolution:

      * ``"drop"``     — every contested claim is lost (an optical
        receiver locked by two carriers recovers neither); the
        pessimistic, arbitration-free fabric.
      * ``"lowest"``   — the lowest-index input wins the port (a fixed-
        priority electrical arbiter); deterministic but unfair.
      * ``"receiver"`` — receiver-plane arbitration with rotating
        priority: matching t's port grants the contender whose index is
        next at/after ``t mod n``, spreading wins evenly over a period.

    Self-loop claims (the configuration model allows them) contend for
    the output port like any other claim but never carry traffic —
    matching the consistent path, where self-loops are dropped from the
    circuit support.  Lost capacity counts only claims that would have
    carried traffic (src != dst) had the port not been contested.

    ``"fullest"`` (queue-aware arbitration) cannot be precomputed — the
    winner depends on per-slot VOQ depth — so under disagreement the
    returned plan is *dynamic*: ``plans``/``win`` are None, ``lost`` is
    zero (the engine charges collision loss per served slot via
    :func:`_resolve_slot_claims`), and the static claim structure
    (``eff``/``nonself``/``contested``/disagreement) is still carried.

    ``plane_map`` records which physical planes the schedules' logical
    plane rows occupy (identity by default) — repaired schedules rebuilt
    over the surviving planes of a degraded fabric pass the survivors.
    """
    if collision not in _COLLISIONS:
        raise ValueError(f"collision must be one of {_COLLISIONS} "
                         f"(got {collision!r})")
    if plane_map is None:
        plane_map = np.arange(scheds[0].d_hat, dtype=np.int64)
    if len(scheds) == 1:
        sched = scheds[0]
        n = sched.n
        plans = [(at * n + v, cap)
                 for at, v, cap in sched.slot_circuits(bits_per_slot)]
        perms = sched.perms
        return _FabricPlan(plans=plans, n_slots=sched.n_slots,
                           disagreement=0.0,
                           lost=np.zeros(sched.n_slots), groups=1,
                           contested=np.zeros(sched.n_slots),
                           eff=perms, nonself=perms != np.arange(n)[None, :],
                           win=np.ones(perms.shape, dtype=bool),
                           w=bits_per_slot * (1.0 - sched.recfg_frac),
                           plane_map=plane_map)

    base = scheds[0]
    n, T, d_hat, n_slots = base.n, base.T, base.d_hat, base.n_slots
    for s in scheds[1:]:
        # effective_perms (below) checks the (T, n, d_hat) footprint;
        # capacity pricing additionally needs one reconfiguration fraction
        if s.recfg_frac != base.recfg_frac:
            raise ValueError(
                "per-node schedules must share recfg_frac to be merged: "
                f"{s.recfg_frac} != {base.recfg_frac}")
    eff = effective_perms(scheds, owner)                 # (T, n)
    w = bits_per_slot * (1.0 - base.recfg_frac)
    src = np.arange(n)
    kf = (np.arange(T)[:, None] * n + eff).reshape(-1)   # claim key (t, v)
    claims = np.bincount(kf, minlength=T * n)
    contested = (claims[kf] > 1).reshape(T, n)
    nonself = eff != src[None, :]
    slot_of = np.arange(T) // d_hat
    # same claim counting as schedule_disagreement(scheds, owner), reused
    contested_n = np.bincount(
        slot_of, weights=(nonself & contested).sum(axis=1),
        minlength=n_slots)

    if collision == "fullest":
        # queue-aware winners are a per-slot function of VOQ state: the
        # engine resolves each served slot and charges its loss there
        return _FabricPlan(plans=None, n_slots=n_slots,
                           disagreement=float(contested.mean()),
                           lost=np.zeros(n_slots), groups=len(scheds),
                           contested=contested_n,
                           eff=eff, nonself=nonself, win=None, w=w,
                           plane_map=plane_map)

    if collision == "drop":
        win = ~contested
    else:
        if collision == "lowest":
            order = np.argsort(kf, kind="stable")        # src asc per claim
        else:  # receiver: rotating priority (t mod n) over source index
            prio = (src[None, :] - np.arange(T)[:, None] % n) % n
            order = np.lexsort((prio.reshape(-1), kf))
        ks = kf[order]
        first = np.r_[True, ks[1:] != ks[:-1]]
        win = np.zeros(T * n, dtype=bool)
        win[order[first]] = True
        win = win.reshape(T, n)

    live = win & nonself
    lost = np.bincount(slot_of, weights=(nonself & ~live).sum(axis=1) * w,
                       minlength=n_slots)

    t_idx, s_idx = np.nonzero(live)
    key = slot_of[t_idx] * (n * n) + s_idx * n + eff[t_idx, s_idx]
    upid, inv = np.unique(key, return_inverse=True)
    cap = np.bincount(inv, weights=np.full(len(key), w))
    bounds = np.searchsorted(upid // (n * n), np.arange(n_slots + 1))
    pid_u = upid % (n * n)
    plans = [(pid_u[bounds[s]:bounds[s + 1]], cap[bounds[s]:bounds[s + 1]])
             for s in range(n_slots)]
    return _FabricPlan(plans=plans, n_slots=n_slots,
                       disagreement=float(contested.mean()),
                       lost=lost, groups=len(scheds),
                       contested=contested_n,
                       eff=eff, nonself=nonself, win=win, w=w,
                       plane_map=plane_map)


def _resolve_slot_claims(
    claims: torch.Tensor,
    valid: torch.Tensor,
    planes: torch.Tensor,
    rot: torch.Tensor,
    collision: str,
    voq: torch.Tensor,
    n: int,
    n_planes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Arbitrate one slot's output-port contention on the claims' device,
    at a fixed size: the port of the reference's ``_resolve_slot_claims``.

    ``claims``/``valid``: (R, n) configured output ports and which of them
    exist; ``planes``: (R,) the physical plane of each claim row —
    contention groups by (physical plane, output port); ``rot``: (R,) the
    rotating-priority base for ``"receiver"``; ``voq``: the flat (n^2)
    queues ``"fullest"`` reads (src * n + dst); ``n_planes``: the number
    of physical planes (default: read from ``planes``, which waits for
    the device).  Each contention group's winner is the claim of least
    priority, the reference's sort order: ``"lowest"`` the (row, input)
    position, ``"receiver"`` ``(input - rot) mod n`` then position,
    ``"fullest"`` the deepest VOQ toward the port then the input then the
    row; ``"drop"`` loses every contested claim.  Group reductions are
    ``scatter_reduce_`` over the ``n_planes * n`` (plane, port) groups
    (invalid claims go to a spare group): no ``nonzero`` or ``unique``,
    so the slot never waits on the host.  Self-loop claims contend but
    never carry traffic.

    Returns ``(win, lost)``: the (R, n) winner mask among valid claims,
    and the 0-d count of traffic-carrying claims that lost."""
    R = claims.shape[0]
    dev = claims.device
    if n_planes is None:
        n_planes = int(planes.max()) + 1 if R else 1
    G = n_planes * n
    ii = torch.arange(n, device=dev).expand(R, n)
    rr = torch.arange(R, device=dev)[:, None].expand(R, n)
    key = torch.where(valid, planes[:, None] * n + claims,
                      torch.full_like(claims, G)).reshape(-1)
    if collision == "drop":
        cnt = torch.zeros(G + 1, dtype=torch.int64, device=dev)
        cnt.index_add_(0, key, torch.ones_like(key))
        win = valid & (cnt[key] == 1).view(R, n)
    else:
        flat = (rr * n + ii).reshape(-1)      # the reference's scan order
        if collision == "lowest":
            prio = flat
        elif collision == "receiver":
            prio = (torch.remainder(ii - rot[:, None], n).reshape(-1)
                    * (R * n) + flat)
        elif collision == "fullest":
            depth = voq[(ii * n + claims).reshape(-1)]
            top = torch.full((G + 1,), -torch.inf, dtype=voq.dtype,
                             device=dev)
            top.scatter_reduce_(0, key, depth, "amax")
            prio = torch.where(depth == top[key], (ii * R + rr).reshape(-1),
                               R * n)
        else:
            raise ValueError(f"collision must be one of {_COLLISIONS} "
                             f"(got {collision!r})")
        least = torch.full((G + 1,), 2 * R * n * n, dtype=torch.int64,
                           device=dev)
        least.scatter_reduce_(0, key, prio, "amin")
        win = valid & (prio == least[key]).view(R, n)
    lost = (valid & ~win & (claims != ii)).sum()
    return win, lost


def _quantizer_unit(
    epoch_slots: int, k: int, d_hat: int, bits_per_slot: float
) -> float:
    """Quantization unit for an epoch's VOQ byte counters.

    A1's quantizer clips at 65535 ticks; raw epoch totals reach
    ``epoch_slots * d_hat`` slot-equivalents, which for long epochs would
    saturate silently and flatten the estimate toward uniform.  Coarsen the
    unit just enough that one epoch at line rate stays representable —
    the schedule is scale-invariant, so resolution is all that changes.
    """
    full_ticks = epoch_slots * d_hat * k / (k - 1)
    return bits_per_slot * max(1.0, full_ticks / 65535.0)


@dataclass(frozen=True)
class AdaptiveCase:
    """One closed-loop simulation case for :func:`run_adaptive`; the
    port's copy of the reference's ``AdaptiveCase``, with the same fields
    and checks.

    ``policy``:
      * ``"adaptive"``  — cold-start on the oblivious round-robin, then at
        every epoch boundary run the Appendix-A estimation round over the
        epoch's VOQ byte counters and hot-swap to the recomputed
        ``vermilion_schedule``.
      * ``"oracle"``    — clairvoyant: recompute each epoch from the *next*
        epoch's true offered matrix (upper bound for any estimator).
      * ``"stale"``     — the oracle schedule of epoch 0, never recomputed
        (what an open control loop actually ships).
      * ``"oblivious"`` — round-robin baseline, never recomputed.

    ``gather_steps``: AllGather slots executed per estimation round; fewer
    than ``n - 1`` models a partial (mid-phase-failure) gather, under
    which every node swaps to the schedule of *its own* view (identical
    views deduplicated) and the data plane serves the merged port
    configuration with output-port contention resolved per ``collision``
    (``"drop"``, ``"lowest"`` or ``"receiver"``; see ``_fabric_plan``).

    ``oracle_demand``: optional (n_epochs, n, n) true demand-*rate*
    matrices for the oracle/stale policies; without it they fall back to
    each epoch's realized offered matrix.

    ``construction_slots`` charges schedule construction: a recomputed
    schedule only takes effect that many slots into the epoch, the
    previous one serving in the interim; ``"measured"`` charges each
    recompute its wall-clock construction time at ``slot_seconds`` a slot
    (so its trajectory differs run to run).  ``reconfig_penalty_slots``
    darkens the planes a swap retunes (``planes_changed``) for that many
    slots.  ``swap_tv_threshold`` > 0 skips a recompute while the
    normalized estimate stays within that total-variation distance of the
    last installed one.  ``normalize="saturate"`` projects every estimate
    through the Sinkhorn kernel on the run's device.

    ``faults``: an optional timed :class:`FaultSchedule` injected into the
    run; an empty schedule is bit-identical to None.
    ``activation_jitter_slots``: per-node asynchronous activation — each
    ToR activates a newly-swapped schedule at its own slot, drawn
    uniformly from the window after the swap (seeded from ``seed``); the
    data plane serves the mixed old/new configuration, re-arbitrated per
    slot under ``collision``.  ``collision="fullest"`` grants a contested
    port to the input with the deepest VOQ toward it.  ``repair``
    (``policy="adaptive"`` only) closes the detection/repair loop: the
    control plane excises senders whose gather rows stay silent for
    ``repair_after_epochs`` consecutive epochs and, from the data plane's
    per-destination / per-plane NACK counters, dead receivers and dead
    planes, then rebuilds on the surviving matrix and planes.  A case with
    any of these four runs on the degraded-service engine
    (:func:`_run_degraded_case`).
    """

    wl: Workload
    epoch_slots: int
    policy: str = "adaptive"
    k: int = 3
    d_hat: int = 1
    recfg_frac: float = 0.0
    alpha: float = 0.3                # EWMA weight of the newest epoch
    gather_steps: int | None = None
    collision: str = "drop"
    normalize: str = "hose"
    seed: int = 0
    oracle_demand: np.ndarray | None = None
    construction_slots: int | str = 0
    slot_seconds: float = 4.5e-6
    method: str = "euler"
    reconfig_penalty_slots: int = 0
    faults: FaultSchedule | None = None
    activation_jitter_slots: int = 0
    repair: bool = False
    repair_after_epochs: int = 2
    swap_tv_threshold: float = 0.0
    label: str = ""
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES} "
                             f"(got {self.policy!r})")
        if not isinstance(self.epoch_slots, (int, np.integer)) \
                or self.epoch_slots < 1:
            raise ValueError(f"epoch_slots must be an int >= 1 "
                             f"(got {self.epoch_slots!r})")
        if self.collision not in _COLLISIONS:
            raise ValueError(f"collision must be one of {_COLLISIONS} "
                             f"(got {self.collision!r})")
        cs = self.construction_slots
        if cs != "measured" and not (isinstance(cs, (int, np.integer))
                                     and cs >= 0):
            raise ValueError(
                "construction_slots must be a nonnegative int or "
                f"'measured' (got {cs!r})")
        if self.slot_seconds <= 0:
            raise ValueError(f"slot_seconds must be positive "
                             f"(got {self.slot_seconds!r})")
        if not isinstance(self.reconfig_penalty_slots, (int, np.integer)) \
                or self.reconfig_penalty_slots < 0:
            raise ValueError(
                "reconfig_penalty_slots must be a nonnegative int "
                f"(got {self.reconfig_penalty_slots!r})")
        gs = self.gather_steps
        if gs is not None and not (0 <= gs <= self.wl.n - 1):
            raise ValueError(
                f"gather_steps must be in [0, n - 1] = [0, {self.wl.n - 1}] "
                f"— a ring AllGather finishes in n - 1 steps (got {gs!r})")
        if not isinstance(self.activation_jitter_slots, (int, np.integer)) \
                or self.activation_jitter_slots < 0:
            raise ValueError(
                "activation_jitter_slots must be a nonnegative int "
                f"(got {self.activation_jitter_slots!r})")
        if not isinstance(self.repair_after_epochs, (int, np.integer)) \
                or self.repair_after_epochs < 1:
            raise ValueError(f"repair_after_epochs must be an int >= 1 "
                             f"(got {self.repair_after_epochs!r})")
        if self.swap_tv_threshold < 0:
            raise ValueError(f"swap_tv_threshold must be nonnegative "
                             f"(got {self.swap_tv_threshold!r})")
        if self.repair and self.policy != "adaptive":
            raise ValueError(
                "repair requires policy='adaptive' (the other policies "
                f"never recompute; got policy={self.policy!r})")
        if self.faults is not None:
            if not isinstance(self.faults, FaultSchedule):
                raise ValueError("faults must be a FaultSchedule "
                                 f"(got {type(self.faults).__name__})")
            self.faults.validate(self.wl.n, self.d_hat)


@dataclass
class AdaptiveRow:
    label: str
    policy: str
    result: SimResult
    epoch_utilization: np.ndarray   # (n_epochs,) delivered / epoch capacity
    epoch_estimate_tv: np.ndarray   # (n_epochs,) estimate-vs-truth total-
                                    # variation distance (nan if no estimate)
    recomputes: int                 # schedule recomputations performed
    sim_s: float
    meta: dict
    stale_slots: int = 0            # slots served by an outdated schedule
                                    # while construction was still running
    construction_s: float = 0.0     # wall-clock spent constructing schedules
                                    # (summed over all unique per-node views)
    dark_slots: int = 0             # slots lost to reconfiguration darkness
    epoch_disagreement: np.ndarray = None   # type: ignore[assignment]
                                    # (n_epochs,) contested fraction of the
                                    # installed plan's (matching, port)
                                    # claims, time-weighted over the epoch
    epoch_collision_loss: np.ndarray = None  # type: ignore[assignment]
                                    # (n_epochs,) fraction of the epoch's
                                    # fabric capacity lost to collisions
    collision_lost_bits: float = 0.0  # total capacity lost to collisions
    schedule_groups_max: int = 1    # most distinct per-node schedules that
                                    # were ever live at once
    dark_plane_slots: float = 0.0   # plane-slots dark to reconfiguration
    fault_lost_bits: float = 0.0    # VOQ bits stranded by abrupt tor_fail
    fault_refused_bits: float = 0.0  # arrivals refused at drained/dead ToRs
    excised_nodes: int = 0          # ToRs the repair loop excised
    excised_planes: int = 0         # planes the repair loop excised
    plan_digest: str = ""           # SHA-1 of the control trajectory (the
                                    # compiled path: per-slot plan ids and
                                    # the circuit registry; the degraded
                                    # engine: each slot's kind and claims):
                                    # equal digests, equal served plans


def _compile_adaptive_plan(case: AdaptiveCase, bits_per_slot: float,
                           san=None, sched_cache: dict | None = None,
                           device=None):
    """Host-side replay of the adaptive control loop WITHOUT serving.

    The epoch counters that drive the control plane accumulate *arrival*
    bits only — never served bits — so the whole control trajectory
    (fleet EWMA → quantized ring gather → per-node schedules →
    collision-resolved fabric plans → construction charging → activation
    dark windows → churn hysteresis) is computable before any serving
    happens.  The port of the reference's ``_compile_adaptive_plan``,
    decision for decision: one ``np.add.at`` over the epoch's
    stable-ordered arrival slice builds the counters, and the estimation
    round is the f64 :func:`estimate_all_views`.  Emits, per slot, an index
    into a registry of ``(pair_id, capacity)`` circuit plans; registry id
    0 is the empty plan (fully-dark slots).  Schedules are built with
    ``device`` (where ``normalize="saturate"`` projects).

    ``sched_cache`` (shared across a batch) memoizes schedule
    *construction* on the exact estimator inputs, so a grid that varies
    only the collision policy pays construction once; the (cheap,
    collision-specific) ``_fabric_plan`` merge always runs.  Disabled for
    ``construction_slots="measured"``, where the charge is the actual
    wall-clock of a fresh construction.
    """
    wl, n = case.wl, case.wl.n
    E, H = case.epoch_slots, wl.horizon
    n_epochs = -(-H // E)
    cs = case.construction_slots
    measured = cs == "measured"
    if measured:
        sched_cache = None
    penalty = int(case.reconfig_penalty_slots)
    if san is not None:
        san.set_context(f"case={case.label}")
        san.check_workload(wl)
    san_w = bits_per_slot * (1.0 - case.recfg_frac)

    f_size = wl.size.astype(np.float64)
    valid = wl.arrival < H
    order = np.argsort(wl.arrival, kind="stable")
    order = order[valid[order]]
    bucket = np.searchsorted(wl.arrival[order], np.arange(H + 1))

    true_epoch = np.zeros((n_epochs, n, n))  # lint: allow-dense
    np.add.at(true_epoch,
              (wl.arrival[order] // E, wl.src[order], wl.dst[order]),
              f_size[order])
    oracle_m = case.oracle_demand
    if oracle_m is not None and oracle_m.shape != (n_epochs, n, n):
        raise ValueError(
            f"oracle_demand shape {oracle_m.shape} != {(n_epochs, n, n)}")
    if oracle_m is None:
        oracle_m = true_epoch / E

    fleet = TrafficEstimator.fleet(n, alpha=case.alpha)
    q_unit = _quantizer_unit(E, case.k, case.d_hat, bits_per_slot)

    construction_s = 0.0
    last_construction = 0.0
    cache_key_base = (case.k, case.d_hat, case.recfg_frac, case.normalize,
                      case.method)

    def consistent_plan(sched: Schedule) -> _FabricPlan:
        fp = _fabric_plan([sched], np.zeros(n, dtype=np.int64),
                          bits_per_slot, case.collision)
        if san is not None:
            san.check_schedule(sched)
            san.check_fabric_plan(fp, n, sched.d_hat, san_w)
        return fp

    def vsched(m: np.ndarray, seed: int) -> Schedule:
        nonlocal construction_s, last_construction
        key = None
        if sched_cache is not None:
            key = ("v", m.tobytes(), seed) + cache_key_base
            hit = sched_cache.get(key)
            if hit is not None:
                s, dt = hit
                last_construction = dt
                construction_s += dt
                return s
        t0 = time.perf_counter()
        s = vermilion_schedule(
            m, k=case.k, d_hat=case.d_hat, recfg_frac=case.recfg_frac,
            seed=seed, normalize=case.normalize, method=case.method,
            device=device)
        last_construction = time.perf_counter() - t0
        construction_s += last_construction
        if key is not None:
            sched_cache[key] = (s, last_construction)
        return s

    def vsched_per_node(views, seed: int, unique) -> _FabricPlan:
        nonlocal construction_s, last_construction
        masks, owner = unique
        hit = None
        if sched_cache is not None:
            key = ("pn", views.rows.tobytes(), masks.tobytes(),
                   owner.tobytes(), seed) + cache_key_base
            hit = sched_cache.get(key)
        if hit is not None:
            scheds, sowner, dt = hit
        else:
            t0 = time.perf_counter()
            scheds, sowner = per_node_schedules(
                views, k=case.k, d_hat=case.d_hat,
                recfg_frac=case.recfg_frac, seed=seed,
                normalize=case.normalize, method=case.method, unique=unique,
                device=device)
            dt = time.perf_counter() - t0
            if sched_cache is not None:
                sched_cache[key] = (scheds, sowner, dt)
        construction_s += dt
        # the fabric waits for one local construction: every ToR builds
        # only its own schedule, all concurrently
        last_construction = dt / len(scheds)
        fp = _fabric_plan(scheds, sowner, bits_per_slot, case.collision)
        if san is not None:
            for s in scheds:
                san.check_schedule(s)
            san.check_fabric_plan(fp, n, case.d_hat, san_w)
        return fp

    if case.policy in ("oracle", "stale"):
        fp = consistent_plan(vsched(oracle_m[0], case.seed))
    else:
        fp = consistent_plan(oblivious_schedule(n, d_hat=case.d_hat,
                                                recfg_frac=case.recfg_frac))
    sched_t0 = 0
    pending: tuple[int, _FabricPlan] | None = None

    est_tv = np.full(n_epochs, np.nan)
    dis_slot = np.zeros(H)
    coll_slot = np.zeros(H)
    plan_ids = np.zeros(H, dtype=np.int32)
    registry: list[tuple[np.ndarray, np.ndarray]] = [
        (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64))]
    memo: dict[tuple, int] = {}
    keep_alive: list = [fp]        # plans are memo-keyed by id(); pin them
    recomputes = 0
    stale_slots = 0
    dark_slots = 0
    dark_plane_slots = 0.0
    groups_max = 1
    plane_dark_until = np.zeros(case.d_hat, dtype=np.int64)
    counters = np.zeros((n, n))
    last_est: np.ndarray | None = None

    def activate(new_fp: _FabricPlan, s: int) -> None:
        nonlocal fp, sched_t0, groups_max
        if penalty:
            ch = planes_changed(fp.eff, new_fp.eff, case.d_hat)
            plane_dark_until[ch] = s + penalty
        fp, sched_t0 = new_fp, s
        keep_alive.append(new_fp)
        groups_max = max(groups_max, new_fp.groups)

    slot = 0
    while slot < H:
        if pending is not None and slot >= pending[0]:
            swap_fp = pending[1]
            pending = None
            activate(swap_fp, slot)
        if slot and slot % E == 0:
            epoch = slot // E
            if san is not None:
                san.set_context(
                    f"case={case.label} epoch={epoch} slot={slot}")
            swap = None
            if case.policy == "adaptive":
                # the estimation round and its TV-accuracy metric are
                # collision-independent, so a grid varying only the
                # data-plane resolution computes each epoch's views once
                # (keyed per epoch: the fleet EWMA is stateful, so a case
                # either hits every epoch of a cached trajectory or
                # replays the whole chain itself)
                ctl_key = None
                ctl = None
                if sched_cache is not None and san is None:
                    ctl_key = ("ctl", id(wl), epoch, case.gather_steps,
                               case.alpha, E, case.seed) + cache_key_base
                    ctl = sched_cache.get(ctl_key)
                if ctl is None:
                    counters[:] = 0.0
                    seg = order[bucket[(epoch - 1) * E]:bucket[epoch * E]]
                    np.add.at(counters, (wl.src[seg], wl.dst[seg]),
                              f_size[seg])
                    views = estimate_all_views(
                        counters, fleet, case.k, q_unit,
                        steps=case.gather_steps)
                    if san is not None:
                        san.check_views(views)
                    t = true_epoch[epoch - 1]
                    masks, owner = views.unique()
                    counts = np.bincount(owner, minlength=masks.shape[0])
                    t_sum = t.sum()
                    tn = t / t_sum if t_sum > 0 else None
                    nonempty = (masks @ views.rows.sum(axis=1)) > 0
                    tvs, wts = [], []
                    for g in range(masks.shape[0]):
                        if tn is not None and nonempty[g]:
                            est_g = views.rows * masks[g][:, None]
                            tvs.append(0.5 * np.abs(
                                est_g / est_g.sum() - tn).sum())
                            wts.append(counts[g])
                    tv_val = (float(np.average(tvs, weights=wts))
                              if tvs else None)
                    if ctl_key is not None:
                        sched_cache[ctl_key] = (views, masks, owner, tv_val)
                else:
                    views, masks, owner, tv_val = ctl
                if tv_val is not None:
                    est_tv[epoch - 1] = tv_val
                build = views.rows.sum() > 0
                if build and case.swap_tv_threshold > 0.0:
                    # no repair state on this path: the churn test reads
                    # the estimate alone
                    cur = views.rows / views.rows.sum()
                    if (last_est is not None
                            and 0.5 * np.abs(cur - last_est).sum()
                            < case.swap_tv_threshold):
                        build = False
                    else:
                        last_est = cur
                if build:
                    swap = vsched_per_node(views, case.seed + epoch,
                                           (masks, owner))
            elif case.policy == "oracle":
                if oracle_m[epoch].sum() > 0:
                    swap = consistent_plan(
                        vsched(oracle_m[epoch], case.seed + epoch))
            if swap is not None:
                recomputes += 1
                charge = (int(np.ceil(last_construction
                                      / case.slot_seconds))
                          if measured else int(cs))
                if charge == 0:
                    pending = None
                    activate(swap, slot)
                else:
                    pending = (slot + charge, swap)
        # per-slot state (fabric, pending status, per-plane darkness) is
        # constant until the next control event, so the whole run of slots
        # up to it is classified and filled in one vectorized pass
        nxt = min(H, (slot // E + 1) * E)
        if pending is not None:
            nxt = min(nxt, int(pending[0]))
        for t in plane_dark_until:
            if slot < t < nxt:
                nxt = int(t)
        seg = np.arange(slot, nxt)
        if pending is not None:
            stale_slots += nxt - slot

        dark = plane_dark_until > slot
        if dark.all():                 # plan id 0: fully-dark, serve nothing
            dark_slots += nxt - slot
            dark_plane_slots += float(dark.sum()) * (nxt - slot)
            slot = nxt
            continue
        ps_arr = (seg - sched_t0) % fp.n_slots
        ids_u = np.zeros(fp.n_slots, dtype=np.int32)
        if not dark.any():
            # fast path: the precomputed period-slot plans
            dis_slot[seg] = fp.disagreement
            coll_slot[seg] = fp.lost[ps_arr]
            for p in np.unique(ps_arr):
                key = (id(fp), int(p))
                idx = memo.get(key)
                if idx is None:
                    idx = memo[key] = len(registry)
                    registry.append(fp.plans[int(p)])
                ids_u[p] = idx
            plan_ids[seg] = ids_u[ps_arr]
            slot = nxt
            continue
        # partially-dark slots: rebuild from raw claims with the statically
        # arbitrated winners
        dark_plane_slots += float(dark.sum()) * (nxt - slot)
        dis_slot[seg] = fp.disagreement
        dl = case.d_hat
        coll_u = np.zeros(fp.n_slots)
        for p in np.unique(ps_arr):
            lo = int(p) * dl
            hi = min(lo + dl, fp.eff.shape[0])
            rows_e = fp.eff[lo:hi]
            live = (plane_dark_until[:hi - lo] <= slot)[:, None]
            nonself = fp.nonself[lo:hi]
            win = fp.win[lo:hi]
            coll_u[p] = float((nonself & live & ~win).sum()) * fp.w
            key = (id(fp), lo, live.tobytes())
            idx = memo.get(key)
            if idx is None:
                served = win & nonself & live
                srr, sii = np.nonzero(served)
                if srr.size:
                    spid, inv = np.unique(sii * n + rows_e[srr, sii],
                                          return_inverse=True)
                    scap = np.bincount(inv).astype(np.float64) * fp.w
                else:
                    spid = np.empty(0, dtype=np.int64)
                    scap = np.empty(0, dtype=np.float64)
                idx = memo[key] = len(registry)
                registry.append((spid, scap))
            ids_u[p] = idx
        coll_slot[seg] = coll_u[ps_arr]
        plan_ids[seg] = ids_u[ps_arr]
        slot = nxt

    if san is not None:
        san.set_context(None)
    return {
        "registry": registry, "plan_ids": plan_ids,
        "dis_slot": dis_slot, "coll_slot": coll_slot, "est_tv": est_tv,
        "recomputes": recomputes, "stale_slots": stale_slots,
        "dark_slots": dark_slots, "dark_plane_slots": dark_plane_slots,
        "groups_max": groups_max, "construction_s": construction_s,
        "n_epochs": n_epochs, "keep_alive": keep_alive,
    }


def _plan_digest(cp: dict) -> str:
    """SHA-1 of a compiled trajectory's per-slot plan ids and registry."""
    hsh = hashlib.sha1(cp["plan_ids"].tobytes())
    for spid_l, scap_l in cp["registry"]:
        hsh.update(spid_l.tobytes())
        hsh.update(scap_l.tobytes())
    return hsh.hexdigest()


def _run_adaptive_batch(
    cases: list[AdaptiveCase], bits_per_slot: float, dev: torch.device,
    san=None, timings: dict | None = None,
) -> list[AdaptiveRow]:
    """One batch of same-n cases: compile every case's control trajectory
    on the host (:func:`_compile_adaptive_plan`, construction shared
    across cases through the batch's schedule cache), lay the per-slot
    circuit plans out as per-case column blocks of one ``(H, Jtot)`` plan,
    serve it in ONE :func:`singlehop` run on ``dev``, and recover exact
    per-flow FCTs through the host credit replay.  The port of the
    reference's ``_run_adaptive_batch_jax``, without its shape padding
    (the slot loop compiles nothing)."""
    lap = _lapper(timings)
    B = len(cases)
    n = cases[0].wl.n
    horizons = np.array([c.wl.horizon for c in cases], dtype=np.int64)
    H = int(horizons.max())
    sched_cache: dict = {}
    compiled = [_compile_adaptive_plan(c, bits_per_slot, san=san,
                                       sched_cache=sched_cache, device=dev)
                for c in cases]
    lap("control_s")
    digests = [_plan_digest(cp) for cp in compiled]

    # cases whose compiled data plane is byte-identical (same workload
    # object, horizon and per-slot circuit plan) have identical device
    # dynamics and identical per-flow FCTs, so they are served and
    # replayed once — e.g. the complete-gather case under every collision
    # mode.  Disabled under the sanitizer so its per-case
    # conservation/closure ledgers stay 1:1.
    rep_of = list(range(B))
    if san is None:
        seen: dict = {}
        for b, case in enumerate(cases):
            key = (id(case.wl), int(horizons[b]), digests[b])
            rep_of[b] = seen.setdefault(key, b)
    reps = sorted(set(rep_of))
    uidx = {b: u for u, b in enumerate(reps)}

    col_offs = [0]
    for b in reps:
        max_j = max((len(p[0]) for p in compiled[b]["registry"]), default=0)
        col_offs.append(col_offs[-1] + -(-max(max_j, 1) // _PAD_J) * _PAD_J)
    Jtot = col_offs[-1]
    p_pid = np.zeros((H, Jtot), dtype=np.int64)
    p_cap = np.zeros((H, Jtot), dtype=np.float32)
    for u, b in enumerate(reps):
        cp = compiled[b]
        base = u * n * n
        cols = slice(col_offs[u], col_offs[u + 1])
        jc = col_offs[u + 1] - col_offs[u]
        reg = cp["registry"]
        # padded entries and rows past the case's horizon: pair id `base`
        # (pair (0, 0), never a circuit) at zero capacity, exact no-ops
        ent_pid = np.full((len(reg), jc), base, dtype=np.int64)
        ent_cap = np.zeros((len(reg), jc), dtype=np.float32)
        for i, (spid_l, scap_l) in enumerate(reg):
            ent_pid[i, :len(spid_l)] = base + spid_l
            ent_cap[i, :len(spid_l)] = scap_l
        h_b = int(horizons[b])
        p_pid[:h_b, cols] = ent_pid[cp["plan_ids"]]
        p_cap[:h_b, cols] = ent_cap[cp["plan_ids"]]
        p_pid[h_b:, cols] = base
    f_off, fct, credit, tx64, voq_h, _ = _serve(
        [cases[b].wl for b in reps], horizons[reps], p_pid, p_cap, dev, lap,
        timings)
    voq64 = np.asarray(voq_h, np.float64)

    rows = []
    for b, (case, cp) in enumerate(zip(cases, compiled)):
        wl, E = case.wl, case.epoch_slots
        h_b = int(horizons[b])
        n_epochs = cp["n_epochs"]
        u = uidx[rep_of[b]]
        cols = slice(col_offs[u], col_offs[u + 1])
        # strictly sequential per-epoch accumulation (np.add.at, not
        # reduceat: reduceat's pairwise float reduction drifts ~1 ulp from
        # the reference loop's slot-by-slot `+=`)
        ep_idx = np.arange(h_b) // E
        per_slot = tx64[:h_b, cols].sum(axis=1)
        delivered_ep = np.zeros(n_epochs)
        np.add.at(delivered_ep, ep_idx, per_slot)
        dis_ep = np.zeros(n_epochs)
        np.add.at(dis_ep, ep_idx, cp["dis_slot"])
        coll_ep = np.zeros(n_epochs)
        np.add.at(coll_ep, ep_idx, cp["coll_slot"])
        ep_len = np.minimum(E, h_b - E * np.arange(n_epochs))
        ep_cap = ep_len * n * case.d_hat * bits_per_slot
        ideal = h_b * n * case.d_hat * bits_per_slot
        delivered = float(delivered_ep.sum())
        offered = float(wl.size[wl.arrival < h_b].sum())
        if san is not None:
            queued = float(voq64[u * n * n:(u + 1) * n * n].sum())
            san.check_conservation(
                offered, delivered, queued,
                label=f"{dev.type}:adaptive{b}:conservation", float32=True)
        result = SimResult(
            fct_slots=fct[f_off[u]:f_off[u + 1]],
            flow_size=wl.size,
            utilization=delivered / ideal,
            delivered_bits=delivered,
            offered_bits=offered,
        )
        rows.append(AdaptiveRow(
            label=case.label, policy=case.policy, result=result,
            epoch_utilization=delivered_ep / ep_cap,
            epoch_estimate_tv=cp["est_tv"],
            recomputes=cp["recomputes"], sim_s=0.0, meta=dict(case.meta),
            stale_slots=cp["stale_slots"],
            construction_s=cp["construction_s"],
            dark_slots=cp["dark_slots"],
            epoch_disagreement=dis_ep / ep_len,
            epoch_collision_loss=coll_ep / ep_cap,
            collision_lost_bits=float(coll_ep.sum()),
            schedule_groups_max=cp["groups_max"],
            dark_plane_slots=cp["dark_plane_slots"],
            plan_digest=digests[b]))
    if san is not None:
        rem, completed = credit.remaining_active()
        san.check_credit_closure(
            sum(r.result.offered_bits for r in rows),
            sum(r.result.delivered_bits for r in rows), rem, completed,
            label=f"{dev.type}:adaptive:credit", float32=True)
        lap("sanitize_s")
    return rows


# ---------------------------------------------------------------------------
# Degraded-service engine: faults, repair, fullest arbitration, jitter
# ---------------------------------------------------------------------------

# slot kinds of the degraded-service engine: fully dark (serves nothing),
# a precomputed plan (the historical fast path), claims with statically
# arbitrated winners, claims arbitrated on the device each slot
_DARK, _PLAN, _STATIC, _DYNAMIC = 0, 1, 2, 3


def _degraded(case: AdaptiveCase) -> bool:
    """Whether ``case`` needs the degraded-service engine: a data plane
    that the host cannot lay out ahead of serving."""
    return (bool(case.faults) or case.repair or case.collision == "fullest"
            or case.activation_jitter_slots > 0)


def _serve_claims(voq: torch.Tensor, pid: torch.Tensor, rows: torch.Tensor,
                  served: torch.Tensor, w: float, earlier: torch.Tensor,
                  tx_out: torch.Tensor, mem_out: torch.Tensor) -> None:
    """Serve one slot's ``(R, n)`` circuit claims (``rows[r, i]`` the port
    input i is tuned to on claim row r, ``pid = i * n + rows``), of which
    ``served`` carry traffic: the reference's degraded-path serve at a
    fixed size.  Each served pair's capacity is ``w`` times its number of
    served claims; its first served claim in row order (``earlier[r', r,
    0]``: r' < r) carries ``tx = min(q, cap)`` and is flagged in
    ``mem_out``, the others carry nothing.  Writes the per-claim tx into
    ``tx_out``."""
    same = (rows[:, None, :] == rows[None, :, :]) & served[:, None, :]
    member = served & ~(same & earlier).any(dim=0)
    cap = same.sum(dim=0).to(voq.dtype) * w
    q = voq[pid]
    tx = torch.where(member, torch.minimum(q, cap), 0.0).view(-1)
    voq.index_add_(0, pid.view(-1), tx, alpha=-1)
    tx_out.copy_(tx)
    mem_out.copy_(member.view(-1))


def _count_nacks(nack: torch.Tensor, idx: torch.Tensor, voq: torch.Tensor,
                 pid: torch.Tensor, served: torch.Tensor, ok: torch.Tensor,
                 rxok: torch.Tensor) -> None:
    """The repair loop's NACK counters on the device: a served claim whose
    VOQ holds bits wants its circuit; it NACKs where the fault mask
    (``ok``: both ends up) kills it.  ``nack`` holds ``[rx_want (n),
    rx_nack (n), plane_want (d), plane_nack (d)]``; ``idx`` is the slot's
    scatter index (per row its plane twice, then per claim its
    destination twice), built on the host."""
    wanting = served & (voq[pid] > 0.0)
    vals = torch.cat([wanting.sum(dim=1), (wanting & ~ok).sum(dim=1),
                      wanting.view(-1).long(),
                      (wanting & ~rxok).view(-1).long()])
    nack.index_add_(0, idx, vals)


def _run_degraded_case(case: AdaptiveCase, bits_per_slot: float,
                       dev: torch.device, san=None,
                       timings: dict | None = None) -> AdaptiveRow:
    """The port of the reference's ``_run_adaptive_case`` (its numpy
    engine), for one case with faults, repair, ``collision="fullest"`` or
    activation jitter.

    Two of these features read the data plane — repair counts NACKs from
    ``voq[pid] > 0`` on every served claim and decides excisions at each
    epoch boundary; ``fullest`` picks winners by VOQ depth every slot — so
    the trajectory cannot be compiled ahead.  The run goes one epoch at a
    time.  At each epoch boundary the host runs the control plane
    (estimation, views, excision, ``per_node_schedules`` over the
    surviving planes, hysteresis, construction charge, per-plane dark
    windows, jitter draws), then walks the epoch's slots as the reference
    does, minus serving: it knows every slot's flushes, refusals, dark
    planes, transition blocks and fault masks from the timeline, and lays
    each slot out as fully dark, a plan of served pairs (the precomputed
    fast path, or static winners under a known fault mask, whose pairs
    the host derives as the reference does) or ``(R, n)`` claims whose
    winners depend on the VOQ.  The epoch's layout goes up at once and
    the device serves it slot by slot: flush, arrivals, arbitration
    (:func:`_resolve_slot_claims`), NACK counters, the fault mask after
    arbitration (a dead claim still jams its port), ``tx = min(q,
    cap)``.  The VOQ is f64, as in the
    reference: ``fullest``'s depth comparisons and repair's ``> 0`` tests
    would flip near f32 drains.  The only reads inside the run are the
    NACK counters at each epoch boundary of a repair case.  Each slot's
    tx and its served pairs are recorded; after the run the host replays
    them through the exact credit ledger, in the reference's order, and
    sums the per-epoch books as the reference does."""
    lap = _lapper(timings)
    cs = case.construction_slots
    measured = cs == "measured"
    penalty = int(case.reconfig_penalty_slots)
    wl, n = case.wl, case.wl.n
    E, H = case.epoch_slots, wl.horizon
    d_hat = case.d_hat
    n_epochs = -(-H // E)
    if san is not None:
        san.set_context(f"case={case.label}")
        san.check_workload(wl)
    w = bits_per_slot * (1.0 - case.recfg_frac)

    f_size = wl.size.astype(np.float64)
    pid_f = (wl.src * n + wl.dst).astype(np.int64)
    valid = wl.arrival < H
    order = np.argsort(wl.arrival, kind="stable")
    order = order[valid[order]]
    bucket = np.searchsorted(wl.arrival[order], np.arange(H + 1))
    accepted = np.ones(wl.num_flows, dtype=bool)

    true_epoch = np.zeros((n_epochs, n, n))  # lint: allow-dense
    np.add.at(true_epoch,
              (wl.arrival[order] // E, wl.src[order], wl.dst[order]),
              f_size[order])
    oracle_m = case.oracle_demand
    if oracle_m is not None and oracle_m.shape != (n_epochs, n, n):
        raise ValueError(
            f"oracle_demand shape {oracle_m.shape} != {(n_epochs, n, n)}")
    if oracle_m is None:
        oracle_m = true_epoch / E

    counters = np.zeros((n, n))
    fleet = TrafficEstimator.fleet(n, alpha=case.alpha)
    q_unit = _quantizer_unit(E, case.k, d_hat, bits_per_slot)
    construction_s = 0.0
    last_construction = 0.0

    def consistent_plan(sched: Schedule) -> _FabricPlan:
        fp = _fabric_plan([sched], np.zeros(n, dtype=np.int64),
                          bits_per_slot, case.collision)
        if san is not None:
            san.check_schedule(sched)
            san.check_fabric_plan(fp, n, sched.d_hat, w)
        return fp

    def vsched(m: np.ndarray, seed: int) -> Schedule:
        nonlocal construction_s, last_construction
        t0 = time.perf_counter()
        s = vermilion_schedule(
            m, k=case.k, d_hat=d_hat, recfg_frac=case.recfg_frac,
            seed=seed, normalize=case.normalize, method=case.method,
            device=dev)
        last_construction = time.perf_counter() - t0
        construction_s += last_construction
        return s

    def vsched_per_node(views, seed: int, unique, dl: int | None = None,
                        plane_map: np.ndarray | None = None) -> _FabricPlan:
        nonlocal construction_s, last_construction
        dh = d_hat if dl is None else dl
        t0 = time.perf_counter()
        scheds, owner = per_node_schedules(
            views, k=case.k, d_hat=dh, recfg_frac=case.recfg_frac,
            seed=seed, normalize=case.normalize, method=case.method,
            unique=unique, device=dev)
        dt = time.perf_counter() - t0
        construction_s += dt
        # every ToR builds only its own schedule, all concurrently
        last_construction = dt / len(scheds)
        fp = _fabric_plan(scheds, owner, bits_per_slot, case.collision,
                          plane_map=plane_map)
        if san is not None:
            for s in scheds:
                san.check_schedule(s)
            san.check_fabric_plan(fp, n, dh, w)
        return fp

    if case.policy in ("oracle", "stale"):
        fp = consistent_plan(vsched(oracle_m[0], case.seed))
    else:
        fp = consistent_plan(oblivious_schedule(n, d_hat=d_hat,
                                                recfg_frac=case.recfg_frac))
    sched_t0 = 0
    pending: tuple[int, _FabricPlan] | None = None

    est_tv = np.full(n_epochs, np.nan)
    dis_ep = np.zeros(n_epochs)
    coll_slot = np.zeros(H)          # host-known collision loss a slot
    recomputes = stale_slots = dark_slots = 0
    groups_max = 1
    injected_cum = 0.0
    injected_at = np.zeros(n_epochs)  # the sanitizer's ledger at each end

    src0 = np.arange(n)
    tl = case.faults.compile(n, d_hat) if case.faults else None
    fault_refused = 0.0
    plane_dark_until = np.zeros(d_hat, dtype=np.int64)
    dark_plane_slots = 0.0
    jit = int(case.activation_jitter_slots)
    act_rng = np.random.default_rng([abs(int(case.seed)), 0xAC7])
    transition: tuple[_FabricPlan, int, np.ndarray, int] | None = None
    tx_silent = np.zeros(n, dtype=np.int64)
    excised_tx = np.zeros(n, dtype=bool)
    excised_rx = np.zeros(n, dtype=bool)
    plane_alive = np.ones(d_hat, dtype=bool)
    last_est: np.ndarray | None = None
    last_sig: tuple | None = None
    lok_memo: dict[int, np.ndarray] = {}
    static_memo: dict[tuple, tuple] = {}   # the current plan's, by slot

    def activate(new_fp: _FabricPlan, s: int) -> None:
        nonlocal fp, sched_t0, transition, groups_max
        if penalty:
            om, nm = fp.plane_map, new_fp.plane_map
            if fp.eff.shape != new_fp.eff.shape \
                    or not np.array_equal(om, nm):
                plane_dark_until[nm] = s + penalty   # everything retargets
            else:
                ch = planes_changed(fp.eff, new_fp.eff, len(nm))
                plane_dark_until[nm[ch]] = s + penalty
        if jit:
            act = s + act_rng.integers(0, jit + 1, size=n)
            transition = (fp, sched_t0, act, s + jit + 1)
        fp, sched_t0 = new_fp, s
        groups_max = max(groups_max, new_fp.groups)
        static_memo.clear()

    # device state: the f64 VOQ, the NACK counters, per-slot records
    R = 2 * d_hat                    # claim rows: old + new generation
    W = R * n
    voq = torch.zeros(n * n, dtype=torch.float64, device=dev)
    nack = torch.zeros(2 * n + 2 * d_hat, dtype=torch.int64, device=dev)
    rec_tx = torch.zeros((H, W), dtype=torch.float64, device=dev)
    rec_mem = torch.zeros((H, W), dtype=torch.bool, device=dev)
    lost_cnt = torch.zeros(H, dtype=torch.int64, device=dev)
    snap = torch.zeros(n_epochs, dtype=torch.float64, device=dev)
    earlier = (torch.arange(R, device=dev)[:, None]
               < torch.arange(R, device=dev)[None, :])[:, :, None]
    ii_d = torch.arange(n, device=dev)
    flushed: list[torch.Tensor] = []
    flush_at: list[int] = []
    rec_pid = np.zeros((H, W), dtype=np.int64)
    plan_mem = np.zeros((H, W), dtype=bool)
    kinds = np.zeros(H, dtype=np.int8)
    digest = hashlib.sha1()
    epoch_reads = 0

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    lap("control_s")
    for s0 in range(0, H, E):
        s1 = min(H, s0 + E)
        S = s1 - s0
        # -- host: the control plane at the boundary, then the epoch's
        # slots laid out as the reference walks them
        p_pid = np.zeros((S, W), dtype=np.int64)
        p_cap = np.zeros((S, W))
        c_rows = np.broadcast_to(src0, (S, R, n)).copy()
        c_mask = np.zeros((S, R, n), dtype=bool)  # static: served; dyn: valid
        c_planes = np.zeros((S, R), dtype=np.int64)
        c_rot = np.zeros((S, R), dtype=np.int64)
        c_ok = np.ones((S, R, n), dtype=bool)
        c_rxok = np.ones((S, R, n), dtype=bool)
        faulty_s = np.zeros(S, dtype=bool)
        flush_s: dict[int, np.ndarray] = {}
        arr_s: list[np.ndarray] = []
        for slot in range(s0, s1):
            h = slot - s0
            if pending is not None and slot >= pending[0]:
                swap_fp = pending[1]
                pending = None
                activate(swap_fp, slot)
            if slot and slot % E == 0:
                epoch = slot // E
                if san is not None:
                    san.set_context(
                        f"case={case.label} epoch={epoch} slot={slot}")
                    injected_at[epoch - 1] = injected_cum
                repair_now = case.repair and case.policy == "adaptive"
                if repair_now:
                    silent = counters.sum(axis=1) <= 0.0
                    tx_silent[:] = np.where(silent, tx_silent + 1, 0)
                    excised_tx |= tx_silent >= case.repair_after_epochs
                    # the epoch's NACK counters: the run's one read
                    c = nack.cpu().numpy().astype(np.float64)
                    nack.zero_()
                    epoch_reads += 1
                    rx_want, rx_nack = c[:n], c[n:2 * n]
                    plane_want = c[2 * n:2 * n + d_hat]
                    plane_nack = c[2 * n + d_hat:]
                    excised_rx |= (rx_want > 10) & (rx_nack > 0.9 * rx_want)
                    plane_alive &= ~((plane_want > 10)
                                     & (plane_nack > 0.9 * plane_want))
                swap = None
                if case.policy == "adaptive":
                    views = estimate_all_views(
                        counters, fleet, case.k, q_unit,
                        steps=case.gather_steps)
                    if san is not None:
                        san.check_views(views)
                    if repair_now and (excised_tx.any()
                                       or excised_rx.any()):
                        views = views.excise(excised_tx, excised_rx)
                    t = true_epoch[epoch - 1]
                    masks, owner = views.unique()
                    counts = np.bincount(owner, minlength=masks.shape[0])
                    t_sum = t.sum()
                    tn = t / t_sum if t_sum > 0 else None
                    nonempty = (masks @ views.rows.sum(axis=1)) > 0
                    tvs, wts = [], []
                    for g in range(masks.shape[0]):
                        if tn is not None and nonempty[g]:
                            est_g = views.rows * masks[g][:, None]
                            tvs.append(0.5 * np.abs(
                                est_g / est_g.sum() - tn).sum())
                            wts.append(counts[g])
                    if tvs:
                        est_tv[epoch - 1] = float(
                            np.average(tvs, weights=wts))
                    build = views.rows.sum() > 0
                    if build and case.swap_tv_threshold > 0.0:
                        cur = views.rows / views.rows.sum()
                        sig = (plane_alive.tobytes(), excised_tx.tobytes(),
                               excised_rx.tobytes())
                        if (last_est is not None and sig == last_sig
                                and 0.5 * np.abs(cur - last_est).sum()
                                < case.swap_tv_threshold):
                            build = False
                        else:
                            last_est, last_sig = cur, sig
                    if build:
                        if repair_now and not plane_alive.all():
                            dl = int(plane_alive.sum())
                            if dl > 0:  # rebuild over the surviving planes
                                swap = vsched_per_node(
                                    views, case.seed + epoch, (masks, owner),
                                    dl=dl,
                                    plane_map=np.nonzero(plane_alive)[0])
                        else:
                            swap = vsched_per_node(views, case.seed + epoch,
                                                   (masks, owner))
                elif case.policy == "oracle":
                    if oracle_m[epoch].sum() > 0:
                        swap = consistent_plan(
                            vsched(oracle_m[epoch], case.seed + epoch))
                if swap is not None:
                    recomputes += 1
                    charge = (int(np.ceil(last_construction
                                          / case.slot_seconds))
                              if measured else int(cs))
                    if charge == 0:
                        pending = None
                        activate(swap, slot)
                    else:
                        pending = (slot + charge, swap)
                counters[:] = 0.0
            if pending is not None:
                stale_slots += 1

            if tl is not None:
                failed = tl.advance(slot)
                if failed.size:
                    flush_s[h] = failed
            newf = order[bucket[slot]:bucket[slot + 1]]
            if newf.size and tl is not None and not tl.clean:
                ok = tl.inject_ok[wl.src[newf]]
                if not ok.all():    # refused at the ingress
                    fault_refused += float(f_size[newf[~ok]].sum())
                    accepted[newf[~ok]] = False
                    newf = newf[ok]
            if newf.size:
                arr_s.append(newf)
                np.add.at(counters, (wl.src[newf], wl.dst[newf]),
                          f_size[newf])
                if san is not None:
                    injected_cum += float(f_size[newf].sum())

            dark = plane_dark_until[fp.plane_map] > slot
            if dark.all():              # every plane retargeting
                dark_slots += 1
                dark_plane_slots += float(dark.sum())
                continue                # kind _DARK
            if transition is not None and slot >= transition[3]:
                transition = None
            faulty = tl is not None and not tl.clean
            e = slot // E
            dis_ep[e] += fp.disagreement
            if (not faulty and transition is None and not dark.any()
                    and fp.plans is not None):
                # historical fast path: the precomputed period-slot plan
                ps = (slot - sched_t0) % fp.n_slots
                coll_slot[slot] = fp.lost[ps]
                spid, scap = fp.plans[ps]
                kinds[slot] = _PLAN
                p_pid[h, :len(spid)] = spid
                p_cap[h, :len(spid)] = scap
                rec_pid[slot, :len(spid)] = spid
                plan_mem[slot, :len(spid)] = True
                continue
            # degraded service: the slot from raw claims
            dark_plane_slots += float(dark.sum())
            if transition is None:
                dl = len(fp.plane_map)
                lo = ((slot - sched_t0) % fp.n_slots) * dl
                hi = min(lo + dl, fp.eff.shape[0])
                rows = fp.eff[lo:hi]
                planes = fp.plane_map[:hi - lo]
                live = (plane_dark_until[planes] <= slot)[:, None]
                if fp.win is not None:   # static arbitration, precomputed
                    win = fp.win[lo:hi]
                    nonself = fp.nonself[lo:hi]
                    coll_slot[slot] = float(
                        (nonself & live & ~win).sum()) * fp.w
                    kinds[slot] = _STATIC
                    mask = win & nonself & live
                else:                    # queue-aware: resolve on the card
                    kinds[slot] = _DYNAMIC
                    mask = np.broadcast_to(live, rows.shape)
                    c_rot[h, :hi - lo] = (lo + np.arange(hi - lo)) % n
            else:
                # mixed old/new activation: each node serves its own
                # generation, re-arbitrated per slot on the card
                ofp, ot0, act, _ = transition
                blocks = []
                for p, t0 in ((ofp, ot0), (fp, sched_t0)):
                    dlp = len(p.plane_map)
                    lo = ((slot - t0) % p.n_slots) * dlp
                    hi = min(lo + dlp, p.eff.shape[0])
                    blocks.append((p.eff[lo:hi], p.plane_map[:hi - lo],
                                   (lo + np.arange(hi - lo)) % n))
                rows = np.vstack([b[0] for b in blocks])
                planes = np.concatenate([b[1] for b in blocks])
                c_rot[h, :len(rows)] = np.concatenate([b[2] for b in blocks])
                gen_new = np.zeros(len(rows), dtype=bool)
                gen_new[len(blocks[0][0]):] = True
                on = act <= slot
                mask = np.where(gen_new[:, None], on[None, :], ~on[None, :])
                mask &= (plane_dark_until[planes] <= slot)[:, None]
                kinds[slot] = _DYNAMIC
            r = len(rows)
            c_rows[h, :r] = rows
            c_mask[h, :r] = mask
            c_planes[h, :r] = planes
            if faulty:               # fault masking after arbitration
                faulty_s[h] = True
                lok = lok_memo.get(tl.version)
                if lok is None:
                    lok = lok_memo[tl.version] = tl.link_ok()
                rxok = lok[rows, planes[:, None]]
                c_ok[h, :r] = lok.T[planes] & rxok
                c_rxok[h, :r] = rxok
            if kinds[slot] == _DYNAMIC:
                rec_pid[slot] = (src0[None, :] * n + c_rows[h]).reshape(-1)
                continue
            # static winners and a known fault mask: the served pairs are
            # the host's, laid out as a plan (the reference's unique
            # pairs, capacity = served claims x w), memoized per period
            # slot, dark planes and fault state
            key = (lo, live.tobytes(), tl.version if faulty else -1)
            plan = static_memo.get(key)
            if plan is None:
                srr, sii = np.nonzero(mask & c_ok[h, :r])
                spid, inv = np.unique(sii * n + rows[srr, sii],
                                      return_inverse=True)
                plan = (spid, np.bincount(inv).astype(np.float64) * fp.w)
                if len(static_memo) < 4096:
                    static_memo[key] = plan
            spid, scap = plan
            p_pid[h, :len(spid)] = spid
            p_cap[h, :len(spid)] = scap
            rec_pid[slot, :len(spid)] = spid
            plan_mem[slot, :len(spid)] = True
        if san is not None and s1 == H:
            injected_at[n_epochs - 1] = injected_cum
        digest.update(kinds[s0:s1].tobytes())
        digest.update(rec_pid[s0:s1].tobytes())
        for a in (p_cap, c_mask, c_ok):
            digest.update(a.tobytes())
        lap("control_s")

        # -- the epoch's layout goes up at once
        newf = (np.concatenate(arr_s) if arr_s
                else np.empty(0, dtype=np.int64))
        a_bounds = np.searchsorted(wl.arrival[newf], np.arange(s0, s1 + 1))
        d_apid, d_asz = up(pid_f[newf]), up(f_size[newf])
        d_ppid, d_pcap = up(p_pid), up(p_cap)
        d_rows, d_mask = up(c_rows), up(c_mask)
        d_cpid = d_rows + (ii_d * n)[None, None, :]
        d_planes, d_rot = up(c_planes), up(c_rot)
        d_ok, d_rxok = up(c_ok), up(c_rxok)
        if case.repair and faulty_s.any():
            nidx = np.concatenate(
                [2 * n + c_planes, 2 * n + d_hat + c_planes,
                 c_rows.reshape(S, -1), n + c_rows.reshape(S, -1)], axis=1)
            d_nidx = up(nidx)
        lap("upload_s")

        # -- the device serves the epoch slot by slot
        for h in range(S):
            g = s0 + h
            if h in flush_s:            # abrupt death strands the VOQs
                for f in flush_s[h]:
                    row = voq[int(f) * n:(int(f) + 1) * n]
                    flushed.append(row.clone())
                    flush_at.append(g)
                    row.zero_()
            a, b = int(a_bounds[h]), int(a_bounds[h + 1])
            if b > a:
                voq.index_add_(0, d_apid[a:b], d_asz[a:b])
            k = kinds[g]
            if k == _DARK:
                continue
            if k != _DYNAMIC:
                if k == _STATIC and faulty_s[h] and case.repair:
                    _count_nacks(nack, d_nidx[h], voq, d_cpid[h], d_mask[h],
                                 d_ok[h], d_rxok[h])
                pp = d_ppid[h]
                q = voq[pp]
                t = torch.minimum(q, d_pcap[h], out=rec_tx[g])
                voq.index_add_(0, pp, t, alpha=-1)
                continue
            rows, pidc = d_rows[h], d_cpid[h]
            win, lost = _resolve_slot_claims(
                rows, d_mask[h], d_planes[h], d_rot[h], case.collision, voq,
                n, n_planes=d_hat)
            lost_cnt[g] = lost
            served = win & (rows != ii_d)
            if faulty_s[h]:
                if case.repair:
                    _count_nacks(nack, d_nidx[h], voq, pidc, served,
                                 d_ok[h], d_rxok[h])
                served = served & d_ok[h]
            _serve_claims(voq, pidc, rows, served, w, earlier,
                          rec_tx[g], rec_mem[g])
        if san is not None:
            snap[s0 // E] = voq.sum()
        lap("device_loop_s")

    # -- the books: one read of the records, the credit replay
    _sync(dev)
    lap("device_loop_s")
    tx_h = rec_tx.cpu().numpy()
    mem_h = np.where((kinds == _DYNAMIC)[:, None], rec_mem.cpu().numpy(),
                     plan_mem)
    lost_h = lost_cnt.cpu().numpy()
    voq_sum = snap.cpu().numpy()
    voq_final = voq.cpu().numpy()
    flush_h = [f.cpu().numpy() for f in flushed]
    lap("download_s")
    fault_lost = 0.0
    lost_at = []                     # fault_lost after each flush
    for row in flush_h:
        fault_lost += float(row.sum())
        lost_at.append(fault_lost)

    fct = np.full(wl.num_flows, np.inf)
    credit = _CreditState(n * n, pid_f, f_size, wl.arrival, fct)
    order_acc = order[accepted[order]]
    bucket_acc = np.searchsorted(wl.arrival[order_acc], np.arange(H + 1))
    # each slot's served pairs in the reference's order (sorted pair ids),
    # extracted in one pass: per-slot runs are contiguous
    nz_row, nz_col = np.nonzero(mem_h)
    pid_nz = rec_pid[nz_row, nz_col]
    o = np.lexsort((pid_nz, nz_row))
    pid_nz, tx_nz = pid_nz[o], tx_h[nz_row, nz_col][o]
    bnd = np.concatenate([[0], np.cumsum(mem_h.sum(axis=1))])
    per_slot = np.zeros(H)
    for slot in range(H):
        newf = order_acc[bucket_acc[slot]:bucket_acc[slot + 1]]
        if newf.size:
            credit.arrive(newf)
        a, b = bnd[slot], bnd[slot + 1]
        if a == b:
            continue
        tx = tx_nz[a:b]
        per_slot[slot] = tx.sum()
        credit.credit_pairs(pid_nz[a:b], tx, slot)
    lap("replay_s")
    dyn = kinds == _DYNAMIC
    coll_slot[dyn] = lost_h[dyn] * w
    ep_idx = np.arange(H) // E
    delivered_ep = np.zeros(n_epochs)
    np.add.at(delivered_ep, ep_idx, per_slot)
    coll_ep = np.zeros(n_epochs)
    np.add.at(coll_ep, ep_idx, coll_slot)

    if san is not None:
        # each epoch's ledger, closed at its end with the bits that the
        # flushes before its end had stranded
        lost_at = np.concatenate([[0.0], lost_at])
        n_before = np.searchsorted(np.asarray(flush_at, dtype=np.int64),
                                   E * np.arange(1, n_epochs))
        for e in range(n_epochs - 1):
            san.set_context(f"case={case.label} epoch={e + 1}")
            san.check_conservation(
                injected_at[e], float(delivered_ep[:e + 1].sum()),
                float(voq_sum[e]), fault_lost=float(lost_at[n_before[e]]),
                label=f"adaptive:epoch{e}:conservation")
        delivered_all = float(delivered_ep.sum())
        san.check_conservation(injected_cum, delivered_all,
                               float(voq_final.sum()), fault_lost=fault_lost,
                               label="adaptive:final:conservation")
        rem, completed = credit.remaining_active()
        san.check_credit_closure(injected_cum, delivered_all, rem,
                                 completed, label="adaptive:credit")
        san.set_context(None)
        lap("sanitize_s")
    if timings is not None:
        timings["slots"] = timings.get("slots", 0) + H
        timings["degraded_slots"] = (timings.get("degraded_slots", 0)
                                     + int((kinds >= _STATIC).sum()))
        timings["epoch_reads"] = timings.get("epoch_reads", 0) + epoch_reads

    ep_len = np.minimum(E, H - E * np.arange(n_epochs))
    ep_cap = ep_len * n * d_hat * bits_per_slot
    ideal = H * n * d_hat * bits_per_slot
    result = SimResult(
        fct_slots=fct,
        flow_size=wl.size,
        utilization=float(delivered_ep.sum()) / ideal,
        delivered_bits=float(delivered_ep.sum()),
        offered_bits=float(wl.size[valid].sum()),
        fault_lost_bits=fault_lost,
        fault_refused_bits=fault_refused,
    )
    return AdaptiveRow(
        label=case.label, policy=case.policy, result=result,
        epoch_utilization=delivered_ep / ep_cap, epoch_estimate_tv=est_tv,
        recomputes=recomputes, sim_s=0.0, meta=dict(case.meta),
        stale_slots=stale_slots, construction_s=construction_s,
        dark_slots=dark_slots,
        epoch_disagreement=dis_ep / ep_len,
        epoch_collision_loss=coll_ep / ep_cap,
        collision_lost_bits=float(coll_ep.sum()),
        schedule_groups_max=groups_max,
        dark_plane_slots=dark_plane_slots,
        fault_lost_bits=fault_lost,
        fault_refused_bits=fault_refused,
        excised_nodes=int((excised_tx | excised_rx).sum()),
        excised_planes=int((~plane_alive).sum()),
        plan_digest=digest.hexdigest())


def run_adaptive(
    cases: list[AdaptiveCase],
    bits_per_slot: float,
    device=None,
    sanitize: bool | None = None,
    timings: dict | None = None,
) -> list[AdaptiveRow]:
    """Closed-loop epoch-driven simulation of each case (see
    :class:`AdaptiveCase`); results come back in input order.  The port of
    ``run_adaptive(..., backend="jax")``.

    Cases batch by node count.  Each batch's control plane (estimation →
    per-node schedules → collision-resolved plans → activation and dark
    windows) is replayed on the host exactly; its schedules project on
    ``device`` under ``normalize="saturate"``; the resulting per-slot
    circuit plans of every case are served in one data-plane run on
    ``device`` (``None``: the card; ``"cpu"``: the same PyTorch ops on the
    CPU), with per-flow FCTs from the host's f64 credit replay.

    Cases with ``faults``, ``repair=True``, ``collision="fullest"`` or
    activation jitter (the reference runs them on its numpy backend only)
    run one at a time on the degraded-service engine
    (:func:`_run_degraded_case`): the control plane on the host at each
    epoch boundary, every slot's flush, arrivals, arbitration, fault mask,
    NACK counters and serve on ``device`` in f64, the credit replay on the
    host after the run.  Every other case keeps the compiled batch path.

    ``sanitize``: run the :mod:`repro_torch.analysis.sanitize` contract
    checks on every case (default: the ``REPRO_SANITIZE`` env var);
    results are bit-identical either way.  ``timings``: a dict that
    receives the wall seconds of each phase — ``control_s`` (the host
    control plane, schedule construction included), then the sweep's
    ``layout_s``, ``upload_s``, ``device_loop_s``, ``download_s``,
    ``replay_s`` and ``sanitize_s`` — and the number of slots served;
    the degraded-service engine's cases report the same phases under
    ``timings["degraded"]``, with ``degraded_slots`` (slots served from
    claims rather than a precomputed plan) and ``epoch_reads`` (NACK
    counter reads).
    """
    dev = resolve_device(device)
    san = make_sanitizer(sanitize)
    groups: dict[int, list[int]] = {}
    rows: list[AdaptiveRow | None] = [None] * len(cases)
    for i, case in enumerate(cases):
        if _degraded(case):
            t0 = time.perf_counter()
            rows[i] = _run_degraded_case(
                case, bits_per_slot, dev, san=san,
                timings=(None if timings is None
                         else timings.setdefault("degraded", {})))
            rows[i].sim_s = time.perf_counter() - t0
        else:
            groups.setdefault(case.wl.n, []).append(i)
    for idxs in groups.values():
        t0 = time.perf_counter()
        batch_rows = _run_adaptive_batch([cases[i] for i in idxs],
                                         bits_per_slot, dev, san=san,
                                         timings=timings)
        dt = (time.perf_counter() - t0) / len(idxs)
        for i, row in zip(idxs, batch_rows):
            row.sim_s = dt
            rows[i] = row
    return rows  # type: ignore[return-value]
