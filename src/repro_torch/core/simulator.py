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
through :func:`agg`.

The host ledger (workloads, ``SimResult``, ``_CreditState``) and the
control plane are the port's own copies of the reference's.  Fault
injection, the repair loop, ``collision="fullest"`` and activation jitter
are not ported yet and raise before any case runs.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analysis.sanitize import make_sanitizer
from ..device import DATA_DTYPE, resolve_device
from .estimation import TrafficEstimator, estimate_all_views
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
              tx: torch.Tensor, drained: torch.Tensor) -> torch.Tensor:
    """Serve ``H = p_pid.shape[0]`` slots of the single-hop data plane.

    The port of the reference's ``singlehop`` scan, one Python iteration per
    slot.  ``voq`` is the flat ``(B n^2)`` f32 queue carry, updated in
    place and returned.  Slot ``h`` scatters the arrivals
    ``arr_pid/arr_size[arr_bounds[h]:arr_bounds[h + 1]]``, gathers the
    queues of its plan row ``p_pid[h]``, serves ``min(q, p_cap[h])`` into
    ``tx[h]`` and flags ``drained[h]`` where the circuit emptied its queue.
    Padded plan entries (zero capacity) are exact no-ops."""
    for h in range(p_pid.shape[0]):
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
                 H: int):
    """Concatenated flow state and the arrival list of a batch, single-hop
    or two-hop: flat global pair ids ``(case * n + src) * n + dst``; flows
    that arrive within their case's horizon, sorted by arrival slot
    (stable), with per-slot bounds ``bucket`` (slot h's arrivals are
    ``order[bucket[h]:bucket[h + 1]]``).  Returns
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
           p_cap: np.ndarray, dev: torch.device, lap, timings: dict | None):
    """Serve the ``(H, Jtot)`` plan ``p_pid`` / ``p_cap`` (int64 global
    pair ids, f32 capacities; case b's pairs offset by ``b * n * n``) to
    the flows of ``wls`` on ``dev`` and replay the delivered amounts
    through the f64 credit ledger.  Returns (f_off, fct, credit, tx64,
    voq): flow offsets per case, per-flow FCTs, the ledger, the per-slot
    tx in f64 and the final VOQ on the host."""
    n = wls[0].n
    H = p_pid.shape[0]
    f_off, fct, credit, order, bucket, apid, asz = _batch_flows(
        wls, n, horizons, H)
    lap("layout_s")

    # the plan, the arrival list and the VOQ go up once
    d_pid = torch.from_numpy(p_pid).to(dev)
    d_cap = torch.from_numpy(p_cap).to(dev)
    d_apid = torch.from_numpy(apid).to(dev)
    d_asz = torch.from_numpy(asz).to(dev)
    voq = torch.zeros(len(wls) * n * n, dtype=DATA_DTYPE, device=dev)
    tx = torch.empty(p_pid.shape, dtype=DATA_DTYPE, device=dev)
    drained = torch.empty(p_pid.shape, dtype=torch.bool, device=dev)
    _sync(dev)
    lap("upload_s")
    singlehop(voq, d_apid, d_asz, bucket, d_pid, d_cap, tx, drained)
    _sync(dev)
    lap("device_loop_s")
    tx_h = tx.cpu().numpy()
    dr_h = drained.cpu().numpy()
    voq_h = voq.cpu().numpy()
    lap("download_s")
    if timings is not None:
        timings["slots"] = timings.get("slots", 0) + H
    tx64 = _replay_credit(credit, order, bucket, p_pid, tx_h, dr_h, H)
    lap("replay_s")
    return f_off, fct, credit, tx64, voq_h


def _singlehop_batch(
    cases: list[tuple[Schedule, Workload]], bits_per_slot: float,
    dev: torch.device, san=None, timings: dict | None = None,
) -> list[SimResult]:
    """Single-hop dynamics for a batch of same-n cases, with per-flow FCTs:
    the data plane serves the padded per-slot circuit plan in f32 on
    ``dev`` and the host replays the delivered amounts through the exact
    f64 processor-sharing credit ledger.  ``timings``, if given, receives
    the wall seconds of each phase (accumulated over batches)."""
    lap = _lapper(timings)
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
    f_off, fct, credit, tx64, voq_h = _serve(
        [wl for _, wl in cases], horizons, p_pid, p_cap, dev, lap, timings)

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
        ))
    if san is not None:
        voq64 = np.asarray(voq_h, np.float64)
        for b, (sched, wl) in enumerate(cases):
            san.check_workload(wl)
            san.check_schedule(sched)
            queued = float(voq64[b * n * n:(b + 1) * n * n].sum())
            san.check_conservation(
                results[b].offered_bits, results[b].delivered_bits, queued,
                label=f"{dev.type}:case{b}:conservation", float32=True)
        rem, completed = credit.remaining_active()
        san.check_credit_closure(
            sum(r.offered_bits for r in results),
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
    agg(voq, torch.from_numpy(caps).to(dev),
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


def _offload_shares(cap: torch.Tensor, voq: torch.Tensor):
    """The proportional spray of the leftover capacity: per (case, node
    u), ``send_u = min(leftover, queue)``, each circuit's share ``ls`` of
    the leftover and each destination's share ``qs`` of the queue."""
    leftover = cap.sum(dim=2)
    queue = voq.sum(dim=2)
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


def twohop_fct(voq: torch.Tensor, relay3: torch.Tensor, caps: torch.Tensor,
               cap_idx: torch.Tensor, arr_pid: torch.Tensor,
               arr_size: torch.Tensor, arr_bounds: np.ndarray,
               direct: torch.Tensor, dp: torch.Tensor,
               second: torch.Tensor) -> None:
    """Serve ``H = cap_idx.shape[0]`` slots of the two-hop relay plane,
    keeping the per-source attribution that per-flow FCTs need.

    The port of the reference's ``twohop_fct`` scan: ``relay3[b, at, src,
    dst]`` carries whose bits sit in each relay bucket; relay drains and
    offload sprays are proportional within a bucket.  Slot ``h`` writes
    the ``(B, n, n)`` bits delivered per (src, dst) into ``dp[h]`` and
    the second-hop bits per case into ``second[h]``."""
    n = voq.shape[1]
    offdiag = 1.0 - torch.eye(n, dtype=voq.dtype, device=voq.device)
    voq_flat = voq.view(-1)
    for h in range(cap_idx.shape[0]):
        _arrive(voq_flat, arr_pid, arr_size, arr_bounds, h)
        cap = caps[cap_idx[h]]
        # priority 1: drain relay buckets, attributed pro-rata to src
        tot = relay3.sum(dim=2)                      # [b, at, dst] totals
        send1 = torch.minimum(tot, cap)
        frac = torch.where(tot > _JEPS, send1 / tot.clamp_min(_JEPS), 0.0)
        out = dp[h]
        torch.sum(relay3 * frac[:, :, None, :], dim=1, out=out)
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
        send_u, ls, qs = _offload_shares(cap, voq)
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

    args = (up(caps_flat), up(cap_idx), up(apid), up(asz), bucket)
    d_direct = up(direct)
    voq = torch.zeros((B, n, n), dtype=DATA_DTYPE, device=dev)
    second = torch.empty((H, B), dtype=DATA_DTYPE, device=dev)
    if route == "twohop_fct":
        relay = torch.zeros((B, n, n, n), dtype=DATA_DTYPE, device=dev)
        out = torch.empty((H, B, n, n), dtype=DATA_DTYPE, device=dev)
    else:
        relay = torch.zeros((B, n, n), dtype=DATA_DTYPE, device=dev)
        out = torch.empty((H, B), dtype=DATA_DTYPE, device=dev)
    if route == "twohop_sparse":
        relay = relay.view(B * n, n)
        plan = {k: up(a) for k, a in plan.items()}
    _sync(dev)
    lap("upload_s")
    if route == "twohop_fct":
        twohop_fct(voq, relay, *args, d_direct, out, second)
    elif route == "twohop_dense":
        twohop_dense(voq, relay, *args, d_direct, out, second)
    else:
        twohop_sparse(voq, relay, *args, plan_idx, plan_bounds, plan,
                      d_direct, out, second)
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
# Sweep API
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepCase:
    """One (schedule, workload, mode) point of a sweep grid.

    ``mode``: ``"single_hop"`` (circuits carry their own pair's traffic),
    ``"rotorlb"`` (RotorNet: direct hop, then two-hop VLB offload of the
    leftover capacity) or ``"vlb"`` (every bit through a relay).
    ``faults`` is accepted for the reference's shape but must be empty
    (see :func:`run_sweep`).  An unknown mode raises ``ValueError`` at
    construction."""
    sched: Schedule
    wl: Workload
    mode: str = "single_hop"
    label: str = ""
    meta: dict = field(default_factory=dict)
    faults: object | None = None

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES} "
                             f"(got {self.mode!r})")


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

    Fault injection is not ported yet: such a case raises
    ``NotImplementedError`` before any case runs.
    """
    for i, c in enumerate(cases):
        if c.mode not in _MODES:
            raise ValueError(c.mode)
        if c.faults:
            raise NotImplementedError(
                f"cases[{i}] ({c.label!r}): fault injection is not "
                "implemented in repro_torch — its data plane has no "
                "per-slot fault mask (ROADMAP queue 1, item 4, the numpy "
                "engine's features)")
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
            results = _singlehop_batch(batch, bits_per_slot, dev, san=san,
                                       timings=bt)
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
# the arbiters whose winners _fabric_plan can precompute
_STATIC_COLLISIONS = ("drop", "lowest", "receiver")


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
    partially-dark planes can rebuild any slot's support from first
    principles: ``eff[t, i]`` the port input i is tuned to, ``win`` the
    statically-arbitrated winners; row t runs on plane ``t % d_hat``."""

    plans: list
    n_slots: int
    disagreement: float
    lost: np.ndarray
    groups: int
    contested: np.ndarray
    eff: np.ndarray                    # (T, n) effective port claims
    nonself: np.ndarray                # (T, n) claim would carry traffic
    win: np.ndarray                    # (T, n) statically arbitrated winners
    w: float                           # bits per circuit-slot after guard


def _fabric_plan(
    scheds: list[Schedule],
    owner: np.ndarray,
    bits_per_slot: float,
    collision: str,
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

    The reference's queue-aware ``"fullest"`` cannot be precomputed (its
    winners depend on per-slot VOQ depth); it is not ported and raises.
    """
    if collision not in _STATIC_COLLISIONS:
        raise ValueError(f"collision must be one of {_STATIC_COLLISIONS} "
                         f"(got {collision!r})")
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
                           w=bits_per_slot * (1.0 - sched.recfg_frac))

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
                       eff=eff, nonself=nonself, win=win, w=w)


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

    ``faults``, ``activation_jitter_slots`` and ``repair`` are accepted
    for the reference's shape; :func:`run_adaptive` rejects a case that
    sets them (ROADMAP queue 1, item 4).
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
    faults: object | None = None
    activation_jitter_slots: int = 0
    repair: bool = False
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
        if self.swap_tv_threshold < 0:
            raise ValueError(f"swap_tv_threshold must be nonnegative "
                             f"(got {self.swap_tv_threshold!r})")
        if self.repair and self.policy != "adaptive":
            raise ValueError(
                "repair requires policy='adaptive' (the other policies "
                f"never recompute; got policy={self.policy!r})")


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
    plan_digest: str = ""           # SHA-1 of the compiled control
                                    # trajectory (per-slot plan ids and the
                                    # circuit registry): equal digests, equal
                                    # served plans


def _check_adaptive_supported(case: AdaptiveCase, i: int) -> None:
    """Raise for AdaptiveCase features the port's loop cannot express
    (they need per-slot host decisions inside the serving loop), as the
    reference's jax backend does: fault injection ``NotImplementedError``,
    the repair loop, ``collision="fullest"`` and activation jitter
    ``ValueError``."""
    if case.faults:
        raise NotImplementedError(
            f"cases[{i}] ({case.label!r}): fault injection is not "
            "implemented in repro_torch — it requires per-slot host "
            "decisions the data plane cannot replay (the reference runs it "
            "on its numpy backend; ROADMAP queue 1, item 4)")
    reason = None
    if case.repair:
        reason = "the repair loop (repair=True)"
    elif case.collision == "fullest":
        reason = "queue-aware arbitration (collision='fullest')"
    elif case.activation_jitter_slots > 0:
        reason = "per-node activation jitter"
    if reason is not None:
        raise ValueError(
            f"cases[{i}] ({case.label!r}): {reason} is not supported by "
            "repro_torch's run_adaptive — it requires per-slot host "
            "decisions the data plane cannot replay (the reference's numpy "
            "backend only; ROADMAP queue 1, item 4)")


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
    f_off, fct, credit, tx64, voq_h = _serve(
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

    Cases the port cannot express raise before any case runs:
    ``NotImplementedError`` for fault injection, ``ValueError`` for
    ``repair=True``, ``collision="fullest"`` and activation jitter.

    ``sanitize``: run the :mod:`repro_torch.analysis.sanitize` contract
    checks on every case (default: the ``REPRO_SANITIZE`` env var);
    results are bit-identical either way.  ``timings``: a dict that
    receives the wall seconds of each phase — ``control_s`` (the host
    control plane, schedule construction included), then the sweep's
    ``layout_s``, ``upload_s``, ``device_loop_s``, ``download_s``,
    ``replay_s`` and ``sanitize_s`` — and the number of slots served.
    """
    for i, case in enumerate(cases):
        _check_adaptive_supported(case, i)
    dev = resolve_device(device)
    san = make_sanitizer(sanitize)
    groups: dict[int, list[int]] = {}
    for i, case in enumerate(cases):
        groups.setdefault(case.wl.n, []).append(i)
    rows: list[AdaptiveRow | None] = [None] * len(cases)
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
