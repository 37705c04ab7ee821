"""Deterministic synthetic LM data pipeline: host-sharded, prefetched.

Counterpart of ``repro.data.pipeline``, line for line: numpy only, so
``batch_at`` gives the reference's batches bit for bit for any (step,
host_id, n_hosts).  Each host materializes only its shard of the global
batch, generated from a counter-based PRNG, so any host can regenerate any
step and a resumed run at step k sees the same batches whatever the number
of hosts now.  Batches stay numpy; the trainer moves each one to its
device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_vision_tokens: int = 0
    d_model: int = 0            # for vision/frame stubs
    enc_seq: int = 0
    family: str = "dense"


class SyntheticLM:
    """Structured synthetic tokens (Zipf-ish unigram + copy spans) so the
    loss actually decreases during training runs."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(1, cfg.vocab + 1) ** 1.1
        self.probs = probs / probs.sum()

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % n_hosts == 0
        b = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        toks = rng.choice(cfg.vocab, size=(b, cfg.seq_len + 1), p=self.probs)
        # copy spans: the second half repeats the first (learnable signal)
        half = (cfg.seq_len + 1) // 2
        toks[:, half:half * 2] = toks[:, :half]
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.family == "vlm" and cfg.n_vision_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (b, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
        if cfg.family == "encdec" and cfg.enc_seq:
            batch["frames"] = rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        return batch


class Prefetcher:
    """Background-thread prefetch of the next ``depth`` batches."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1, depth: int = 2):
        self.ds = ds
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self.q.put(
                        (step, ds.batch_at(step, host_id, n_hosts)),
                        timeout=0.1)
                    step += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2)
