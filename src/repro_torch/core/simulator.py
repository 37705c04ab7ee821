"""Flow-level timeslot simulator of the port: the batched single-hop sweep.

The port's counterpart of the single-hop path of ``repro.core.simulator``
(``run_sweep(..., backend="jax")``): per (src, dst) virtual output queues,
FIFO within a queue, transmissions paused during reconfiguration (the
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

The host ledger (workloads, ``SimResult``, ``_CreditState``) is the port's
own copy of the reference's.  Two-hop modes (``rotorlb`` / ``vlb``) and
fault injection are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analysis.sanitize import make_sanitizer
from ..device import DATA_DTYPE, resolve_device
from .schedule import Schedule

__all__ = [
    "Workload",
    "websearch_workload",
    "SimResult",
    "SweepCase",
    "SweepRow",
    "run_sweep",
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


def _singlehop_batch(
    cases: list[tuple[Schedule, Workload]], bits_per_slot: float,
    dev: torch.device, san=None, timings: dict | None = None,
) -> list[SimResult]:
    """Single-hop dynamics for a batch of same-n cases, with per-flow FCTs:
    the data plane serves the padded per-slot circuit plan in f32 on
    ``dev`` and the host replays the delivered amounts through the exact
    f64 processor-sharing credit ledger.  ``timings``, if given, receives
    the wall seconds of each phase (accumulated over batches)."""
    t_phase = time.perf_counter()

    def lap(key: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + now - t_phase
        t_phase = now

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
    f_off, fct, credit, order, bucket, apid, asz = _singlehop_flows(
        [wl for _, wl in cases], n, horizons, H)
    lap("layout_s")

    # the padded plan, the arrival list and the VOQ go up once
    d_pid = torch.from_numpy(p_pid).to(dev)
    d_cap = torch.from_numpy(p_cap).to(dev)
    d_apid = torch.from_numpy(apid).to(dev)
    d_asz = torch.from_numpy(asz).to(dev)
    voq = torch.zeros(B * n * n, dtype=DATA_DTYPE, device=dev)
    tx = torch.empty((H, Jtot), dtype=DATA_DTYPE, device=dev)
    drained = torch.empty((H, Jtot), dtype=torch.bool, device=dev)
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
                "queue 1 ('aggregate and two-hop data planes')")
        if c.faults:
            raise NotImplementedError(
                f"cases[{i}] ({c.label!r}): fault injection is not "
                "implemented in repro_torch — its data plane has no "
                "per-slot fault mask (ROADMAP queue 1, the numpy engine's "
                "features)")
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
