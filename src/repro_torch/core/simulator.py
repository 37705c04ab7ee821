"""Flow-level timeslot simulator of the port: the batched single-hop sweep
and the adaptive control loop.

The port's counterpart of the single-hop path of ``repro.core.simulator``
(``run_sweep(..., backend="jax")`` and ``run_adaptive(...,
backend="jax")``): per (src, dst) virtual output queues, FIFO within a
queue, transmissions paused during reconfiguration (the
``1 - recfg_frac`` capacity factor), processor-sharing flow completion.

A sweep is three layers:

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

The host ledger (workloads, ``SimResult``, ``_CreditState``) and the
control plane are the port's own copies of the reference's.  Two-hop modes
(``rotorlb`` / ``vlb``), fault injection, the repair loop,
``collision="fullest"`` and activation jitter are not ported yet and raise
before any case runs; the aggregate plane is not ported.
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


def _singlehop_flows(wls: list[Workload], n: int, horizons: np.ndarray,
                     H: int):
    """Concatenated flow state and the arrival list of the whole batch:
    flat global pair ids ``(case * n + src) * n + dst``; flows that arrive
    within their case's horizon, sorted by arrival slot (stable), with
    per-slot bounds ``bucket`` (slot h's arrivals are
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
    f_off, fct, credit, order, bucket, apid, asz = _singlehop_flows(
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
# Sweep API
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepCase:
    """One (schedule, workload, mode) point of a sweep grid.

    Only ``mode="single_hop"`` runs in the port so far; ``faults`` is
    accepted for the reference's shape but must be empty (see
    :func:`run_sweep`).  An unknown mode raises ``ValueError`` at
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
    """Evaluate a grid of single-hop simulation cases; results come back in
    input order.

    Cases batch by node count: each batch's data plane runs on ``device``
    (``None``: the card; ``"cpu"``: the same PyTorch ops on the CPU) and
    its per-flow FCTs come from the host's exact f64 credit replay — the
    port of ``run_sweep(..., backend="jax")``.

    ``sanitize``: run the :mod:`repro_torch.analysis.sanitize` contract
    checks on every batch (default: the ``REPRO_SANITIZE`` env var);
    results are bit-identical either way.  ``timings``: a dict that
    receives the wall seconds of each phase (``layout_s``, ``upload_s``,
    ``device_loop_s``, ``download_s``, ``replay_s``, ``sanitize_s``) and
    the number of slots served.

    Two-hop modes and fault injection are not ported yet: such a case
    raises ``NotImplementedError`` before any case runs.
    """
    for i, c in enumerate(cases):
        if c.mode not in _MODES:
            raise ValueError(c.mode)
        if c.mode != "single_hop":
            raise NotImplementedError(
                f"cases[{i}] ({c.label!r}): mode {c.mode!r} is not ported "
                "to repro_torch yet — the two-hop data planes are ROADMAP "
                "queue 1, item 2 ('aggregate and two-hop data planes')")
        if c.faults:
            raise NotImplementedError(
                f"cases[{i}] ({c.label!r}): fault injection is not "
                "implemented in repro_torch — its data plane has no "
                "per-slot fault mask (ROADMAP queue 1, item 4, the numpy "
                "engine's features)")
    dev = resolve_device(device)
    san = make_sanitizer(sanitize)
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(cases):
        groups.setdefault(c.wl.n, []).append(i)
    rows: list[SweepRow | None] = [None] * len(cases)
    for idxs in groups.values():
        batch = [(cases[i].sched, cases[i].wl) for i in idxs]
        t0 = time.perf_counter()
        results = _singlehop_batch(batch, bits_per_slot, dev, san=san,
                                   timings=timings)
        dt = (time.perf_counter() - t0) / len(idxs)
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
