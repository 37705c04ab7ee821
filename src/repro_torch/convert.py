"""Carry schedules, workloads, adaptive cases and model parameters across
from the JAX package.

Duck-typed: any object with the reference's fields converts, so the port
never imports ``repro``.  The tests use it to run both packages on the
same objects, which makes the data-plane parity independent of the
construction parity, and the model parity independent of the two
packages' random generators.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.schedule import Schedule
from .core.simulator import AdaptiveCase, Workload
from .models.transformer import check_supported

__all__ = ["adaptive_case_from", "params_from", "schedule_from",
           "workload_from"]


def schedule_from(s) -> Schedule:
    """The port's :class:`Schedule` with ``s``'s ``perms``, ``d_hat``,
    ``recfg_frac``, ``name`` and ``meta``."""
    return Schedule(perms=np.array(s.perms, dtype=np.int64),
                    d_hat=int(s.d_hat), recfg_frac=float(s.recfg_frac),
                    name=str(s.name), meta=dict(s.meta))


def workload_from(wl) -> Workload:
    """The port's :class:`Workload` with ``wl``'s ``src``, ``dst``,
    ``size``, ``arrival``, ``n`` and ``horizon``."""
    return Workload(src=np.array(wl.src, dtype=np.int64),
                    dst=np.array(wl.dst, dtype=np.int64),
                    size=np.array(wl.size, dtype=np.float64),
                    arrival=np.array(wl.arrival, dtype=np.int64),
                    n=int(wl.n), horizon=int(wl.horizon))


def adaptive_case_from(case, wl: Workload | None = None) -> AdaptiveCase:
    """The port's :class:`AdaptiveCase` with ``case``'s fields, its
    ``oracle_demand`` as f64.  ``wl`` is the port's copy of ``case.wl``
    (default: a new one): pass one copy for every case that shares a
    workload, since the loop's caches key on the workload object, as the
    reference's do.  A case's ``faults`` is carried as it is (the port's
    loop rejects a case that has any)."""
    od = case.oracle_demand
    return AdaptiveCase(
        wl=workload_from(case.wl) if wl is None else wl,
        epoch_slots=int(case.epoch_slots), policy=str(case.policy),
        k=int(case.k), d_hat=int(case.d_hat),
        recfg_frac=float(case.recfg_frac), alpha=float(case.alpha),
        gather_steps=(None if case.gather_steps is None
                      else int(case.gather_steps)),
        collision=str(case.collision), normalize=str(case.normalize),
        seed=int(case.seed),
        oracle_demand=(None if od is None
                       else np.array(od, dtype=np.float64)),
        construction_slots=case.construction_slots,
        slot_seconds=float(case.slot_seconds), method=str(case.method),
        reconfig_penalty_slots=int(case.reconfig_penalty_slots),
        faults=case.faults,
        activation_jitter_slots=int(case.activation_jitter_slots),
        repair=bool(case.repair),
        swap_tv_threshold=float(case.swap_tv_threshold),
        label=str(case.label), meta=dict(case.meta))


def params_from(jax_params, cfg) -> dict:
    """The port's model parameters, CPU tensors, from the reference's
    parameter tree as numpy arrays (``jax.tree.map(np.asarray, params)``).

    The two trees have one layout: weights ``(d_in, d_out)`` and norm
    vectors (attention blocks' ``{"scale": ...}``, the xLSTM blocks'
    ``"norm"``) stacked with a leading repetition axis under
    ``["cells"][j]``, so each leaf is copied as it is and nothing is split
    or transposed, with one exception: where ``cfg`` holds a share of the
    experts (``experts_held``), the MoE layers' ``(R, E, d, ff)`` expert
    stacks are cut to the share's ``[expert_offset, expert_offset +
    experts_held)`` on their expert axis (the router stays whole)."""
    check_supported(cfg)
    share = slice(cfg.expert_offset, cfg.expert_offset + cfg.n_held)

    def conv(tree, in_moe=False):
        if isinstance(tree, dict):
            return {k: conv(v, k == "moe" or (in_moe and k != "router"))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        a = np.array(tree)
        return torch.from_numpy(np.ascontiguousarray(a[:, share]) if in_moe
                                else a)

    return conv(jax_params)
