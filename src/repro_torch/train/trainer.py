"""Fault-tolerant training loop: checkpoint/restart, failure injection,
elastic resume, straggler monitoring.

Counterpart of ``repro.train.trainer`` with the same restart semantics: a
crash loses at most ``ckpt_every`` steps, a restart (possibly on another
number of hosts) reproduces the exact batch sequence (the data pipeline is
counter-based), and persistent stragglers are flagged from step times.
The parameters come from a ``torch.Generator`` seeded by ``tc.seed`` on
the trainer's device (default: the card; ``device="cpu"`` runs the plain
paths on the CPU).  Batch size and length are read as the reference reads
them, ``getattr(tc, "global_batch", 8)`` and ``getattr(tc, "seq_len",
64)``, so a caller sizes a run with a config object that carries them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..data.pipeline import DataConfig, Prefetcher, SyntheticLM
from ..device import resolve_device
from .train_step import TrainState, init_state, make_train_step

__all__ = ["InjectedFailure", "StragglerMonitor", "Trainer"]


class InjectedFailure(RuntimeError):
    pass


@dataclass
class StragglerMonitor:
    """EWMA per-host step times; flags hosts persistently slower than the
    fleet median by ``threshold``x (recorded and surfaced)."""

    n_hosts: int
    alpha: float = 0.2
    threshold: float = 1.5
    ewma: np.ndarray = field(default=None)  # type: ignore[assignment]
    flags: list = field(default_factory=list)

    def __post_init__(self):
        if self.ewma is None:
            self.ewma = np.zeros(self.n_hosts)

    def record(self, step: int, host_times: np.ndarray) -> list[int]:
        self.ewma = np.where(
            self.ewma == 0, host_times,
            (1 - self.alpha) * self.ewma + self.alpha * host_times)
        med = float(np.median(self.ewma))
        slow = [h for h in range(self.n_hosts)
                if self.ewma[h] > self.threshold * med]
        if slow:
            self.flags.append((step, tuple(slow)))
        return slow


@dataclass
class Trainer:
    cfg: object                  # ModelConfig
    tc: object                   # TrainConfig
    host_id: int = 0
    n_hosts: int = 1
    fail_at_step: int | None = None      # failure injection (tests)
    device: object = None                # None: the card

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        self.step_fn = make_train_step(self.cfg, self.tc, self.dev)
        self.monitor = StragglerMonitor(self.n_hosts)

    def _data(self, start_step: int) -> Prefetcher:
        dc = DataConfig(
            vocab=self.cfg.vocab, seq_len=getattr(self.tc, "seq_len", 64),
            global_batch=getattr(self.tc, "global_batch", 8),
            seed=self.tc.seed, family=self.cfg.family,
            n_vision_tokens=self.cfg.n_vision_tokens,
            d_model=self.cfg.d_model, enc_seq=self.cfg.enc_seq,
        )
        return Prefetcher(SyntheticLM(dc), start_step=start_step,
                          host_id=self.host_id, n_hosts=self.n_hosts)

    def init_or_restore(self, gen=None) -> tuple[TrainState, int]:
        from ..models import init_params
        if gen is None:
            gen = torch.Generator(device=self.dev).manual_seed(self.tc.seed)
        params = init_params(gen, self.cfg, self.dev)
        state = init_state(params, self.tc)
        start = 0
        latest = ckpt.latest_step(self.tc.ckpt_dir)
        if latest is not None:
            state, start = ckpt.restore(state, self.tc.ckpt_dir,
                                        host_id=self.host_id)
            start += 1
        return state, start

    def run(self, steps: int | None = None, gen=None) -> dict:
        """Train from the latest checkpoint (or from fresh weights) to
        ``steps`` (default ``tc.total_steps``).  Returns the losses, the
        final step, the straggler flags and each step's seconds (host clock
        around the step, ending when its loss is read)."""
        state, start = self.init_or_restore(gen)
        total = steps if steps is not None else self.tc.total_steps
        data = self._data(start)
        losses, seconds = [], []
        pending = None
        try:
            for step in range(start, total):
                got_step, batch = data.next()
                assert got_step == step
                if self.fail_at_step is not None and step == self.fail_at_step:
                    raise InjectedFailure(f"injected failure at {step}")
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.monitor.record(
                    step, np.full(self.n_hosts, dt))
                losses.append(loss)
                seconds.append(dt)
                if (step + 1) % self.tc.ckpt_every == 0 or step + 1 == total:
                    if pending is not None:
                        pending.join()
                    pending = ckpt.save(
                        state, self.tc.ckpt_dir, step,
                        host_id=self.host_id, keep=self.tc.keep_ckpts,
                        blocking=False)
            if pending is not None:
                pending.join()
        finally:
            # graceful shutdown (caught failures too): flush the in-flight
            # async checkpoint, so the restart point is the last initiated
            # save, not a torn or dropped one
            if pending is not None:
                pending.join()
            data.close()
        return {"losses": losses, "final_step": total - 1,
                "straggler_flags": self.monitor.flags,
                "step_seconds": seconds}
