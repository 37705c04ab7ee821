"""Parallelism -> inter-pod traffic matrices, and interconnect pricing.

This is the bridge between the training framework (Level B) and the paper
(Level A): a parallelism layout over pods generates a per-step traffic
matrix; Vermilion (or a baseline) schedules the optical interconnect for it;
the resulting throughput scales the effective inter-pod bandwidth used by
the roofline's collective term (DESIGN.md §7).

The port's own copy of ``repro.core.collectives`` (host numpy; pricing
builds its schedules under ``normalize="hose"`` and does no device work).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .throughput import (
    oblivious_throughput,
    vermilion_throughput,
)

__all__ = [
    "ring_allreduce_traffic",
    "all_to_all_traffic",
    "pipeline_traffic",
    "hierarchical_traffic",
    "training_step_traffic",
    "InterconnectModel",
]


def ring_allreduce_traffic(n: int, nbytes: float) -> np.ndarray:
    """Ring all-reduce of ``nbytes``: each node ships 2*(n-1)/n * nbytes to
    its ring successor over a step (reduce-scatter + all-gather)."""
    m = np.zeros((n, n))
    if n == 1:
        return m
    per_link = 2.0 * (n - 1) / n * nbytes
    m[np.arange(n), (np.arange(n) + 1) % n] = per_link
    return m


def all_to_all_traffic(n: int, nbytes: float) -> np.ndarray:
    """MoE dispatch/combine: ``nbytes`` leaves each node, uniformly spread."""
    m = np.full((n, n), nbytes / max(n - 1, 1))
    np.fill_diagonal(m, 0.0)
    return m


def pipeline_traffic(n: int, nbytes: float) -> np.ndarray:
    """GPipe stage handoff: activations flow stage i -> i+1 (and grads back,
    captured as the reverse direction)."""
    m = np.zeros((n, n))
    for i in range(n - 1):
        m[i, i + 1] += nbytes
        m[i + 1, i] += nbytes
    return m


def hierarchical_traffic(n: int, groups: int, intra: float, inter: float) -> np.ndarray:
    """Hybrid parallel: all-to-all of ``intra`` bytes within groups, ring of
    ``inter`` bytes across group leaders."""
    assert n % groups == 0
    g = n // groups
    m = np.zeros((n, n))
    for b in range(groups):
        s = slice(b * g, (b + 1) * g)
        blk = np.full((g, g), intra / max(g - 1, 1))
        np.fill_diagonal(blk, 0.0)
        m[s, s] = blk
    leaders = np.arange(0, n, g)
    for i, u in enumerate(leaders):
        m[u, leaders[(i + 1) % groups]] += inter
    return m


def training_step_traffic(
    n_pods: int,
    grad_bytes: float,
    moe_alltoall_bytes: float = 0.0,
    pp_bytes: float = 0.0,
    compression: float = 1.0,
) -> np.ndarray:
    """Per-step inter-pod traffic of a DP(+EP/PP) job.  ``compression`` < 1
    models int8 gradient compression (``repro/train/compression.py``)."""
    m = ring_allreduce_traffic(n_pods, grad_bytes * compression)
    if moe_alltoall_bytes:
        m = m + all_to_all_traffic(n_pods, moe_alltoall_bytes)
    if pp_bytes:
        m = m + pipeline_traffic(n_pods, pp_bytes)
    return m


@dataclass(frozen=True)
class InterconnectModel:
    """Prices a traffic matrix on the optical interconnect.

    ``link_gbps`` per-pod-pair physical link rate, ``d_hat`` parallel optical
    ports per pod, ``recfg_frac`` reconfiguration duty loss.
    """

    link_gbps: float = 400.0
    d_hat: int = 8
    recfg_frac: float = 1.0 / 9.0
    k: int = 3

    def effective_bandwidth(
        self, m: np.ndarray, system: str = "vermilion", seed: int = 0
    ) -> float:
        """Sustainable aggregate rate (bytes/s) for pattern ``m``:
        throughput(theta) * total offered rate at saturation."""
        if m.sum() <= 0:
            return float("inf")
        if system == "vermilion":
            theta = vermilion_throughput(
                m, k=self.k, d_hat=self.d_hat,
                recfg_frac=self.recfg_frac, seed=seed)
        elif system == "oblivious":
            theta = oblivious_throughput(
                m, d_hat=self.d_hat, recfg_frac=self.recfg_frac,
                multi_hop=True)
        elif system == "oblivious-singlehop":
            theta = oblivious_throughput(
                m, d_hat=self.d_hat, recfg_frac=self.recfg_frac,
                multi_hop=False)
        else:
            raise ValueError(system)
        # hose-saturated rate per pod = d_hat * link rate; theta scales it
        cap_bytes = self.d_hat * self.link_gbps * 1e9 / 8.0
        return theta * cap_bytes

    def step_time(self, m: np.ndarray, system: str = "vermilion") -> float:
        """Seconds to drain traffic matrix ``m`` (bytes) through the fabric."""
        if m.sum() <= 0:
            return 0.0
        bw = self.effective_bandwidth(m, system)
        busiest = max(m.sum(axis=1).max(), m.sum(axis=0).max())
        cap_bytes = self.d_hat * self.link_gbps * 1e9 / 8.0
        theta = bw / cap_bytes
        return float(busiest / (theta * cap_bytes))
