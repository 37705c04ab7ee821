"""Batched serving engine: continuous batching over cache lanes.

Counterpart of ``repro.serve.engine``.  ``ServeEngine`` owns a fixed pool
of cache lanes (KV caches, recurrent states, or both: every cache tensor
has the lane at axis 1).  Requests are admitted into free lanes (a prefill
each, whose caches are spliced into the lane); every ``step()`` decodes
one token for all lanes in one batched ``decode_step`` and retires
finished requests.  The reference ``vmap``s a
one-lane decode over the lanes; here the lane is the batch dimension of
every tensor, with the per-lane cache fill held as a ``(L,)`` int32 device
tensor that the decode kernel reads (a host copy drives retirement, so the
loop reads nothing back but the new tokens).  As in the reference, every
lane's length grows by one each step, active or not; an idle lane's
writes are clamped to the last cache slot and never read by another lane.
An MoE FFN routes each lane's token as a group of its own
(``per_lane=True``), as the reference's one-lane decode does: batched
over lanes, the capacity would otherwise couple them.

An encoder-decoder model is refused at construction: the reference's
engine admits a request by a prefill without frames, which its encoder
cannot run, so it has no such path to match.

``stats`` accumulates host wall time (each phase ends by reading its
tokens back, so the card has finished) and work counts: ``prefill_s``,
``prefill_tokens``, ``decode_s``, ``decode_steps``, ``decode_tokens``
(tokens of active lanes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import model as M
from ..models import transformer as T

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, params, cfg, n_lanes: int = 4, max_len: int = 256,
                 device=None):
        if cfg.is_encdec:
            raise NotImplementedError(
                f"ServeEngine does not serve {cfg.name}, an encoder-decoder "
                f"model: the reference's engine admits a request by a "
                f"prefill without frames (src/repro/serve/engine.py, "
                f"_admit); serve it through models.prefill(..., frames=) "
                f"and decode_step(..., cross_kv=)")
        self.device = M._device(params, device)
        self.params, self.cfg = M.serve_params(params, cfg), cfg
        self.n_lanes, self.max_len = n_lanes, max_len
        self.caches = T.init_cache(cfg, n_lanes, max_len, self.device)
        self.lengths = torch.zeros((n_lanes,), dtype=torch.int32,
                                   device=self.device)
        self._lengths = np.zeros(n_lanes, np.int64)   # host copy
        self.active: list[Request | None] = [None] * n_lanes
        self.cur_tok = torch.zeros((n_lanes, 1), dtype=torch.int64,
                                   device=self.device)
        self.budget = np.zeros(n_lanes, np.int64)
        self.stats = dict(prefill_s=0.0, prefill_tokens=0, decode_s=0.0,
                          decode_steps=0, decode_tokens=0)

    # -- admission ---------------------------------------------------------
    def try_admit(self, req: Request) -> bool:
        for lane in range(self.n_lanes):
            if self.active[lane] is None:
                self._admit(lane, req)
                return True
        return False

    def _admit(self, lane: int, req: Request) -> None:
        # per-lane prefill, then its cache replaces the lane's in the pool
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64)
        logits, caches_1, ln = M.prefill(self.params, self.cfg, prompt[None],
                                         self.max_len, self.device)
        tok = torch.argmax(logits, dim=-1)
        for pool, one in zip(self.caches, caches_1):
            for a, o in zip(pool, one):     # (R, L, ...) <- (R, 1, ...)
                a[:, lane] = o[:, 0]
        self.lengths[lane] = ln
        self._lengths[lane] = ln
        self.cur_tok[lane] = tok
        self.active[lane] = req
        self.budget[lane] = req.max_new_tokens
        req.out_tokens.append(int(tok[0]))
        self.budget[lane] -= 1
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += ln

    # -- decode ------------------------------------------------------------
    def step(self) -> list[Request]:
        """One token for all active lanes; returns requests finished now."""
        if all(a is None for a in self.active):
            return []
        t0 = time.perf_counter()
        logits, self.caches = M.decode_step(self.params, self.cfg,
                                            self.cur_tok, self.caches,
                                            self.lengths, self.device,
                                            per_lane=True)
        toks = torch.argmax(logits, dim=-1)
        self.cur_tok = toks[:, None]
        self.lengths += 1
        self._lengths += 1
        toks = toks.tolist()
        finished = []
        for lane, req in enumerate(self.active):
            if req is None:
                continue
            req.out_tokens.append(toks[lane])
            self.budget[lane] -= 1
            self.stats["decode_tokens"] += 1
            if (self.budget[lane] <= 0
                    or self._lengths[lane] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.active[lane] = None
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Drive the admit/step loop until all requests complete."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(a is not None for a in self.active):
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            done.extend(self.step())
        return done
