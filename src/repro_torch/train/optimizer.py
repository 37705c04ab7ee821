"""AdamW with cosine schedule and global-norm clipping, over trees of
tensors.

Counterpart of ``repro.train.optimizer``.  The optimizer state mirrors the
parameters (f32 moments); its math is f32 on the parameters' device, as
the reference's, and each parameter keeps its dtype.  The step counter and
the learning rate stay tensors on the device, so an update never waits on
the host.  :meth:`AdamW.update` writes the moments and the parameters in
place and returns them: the trainer holds one copy of each.  Weight decay
goes to every leaf with ``ndim >= 2``, as in the reference; on the stacked
parameter tree that includes the ``(R, d)`` norm scales, and the port
keeps it so.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..tree import leaves, tree_map

__all__ = ["AdamState", "AdamW", "cosine_schedule", "global_norm"]


class AdamState(NamedTuple):
    step: torch.Tensor         # scalar int32
    mu: Any                    # first moment, tree like params (f32)
    nu: Any                    # second moment


def cosine_schedule(lr: float, warmup: int, total: int) -> Callable:
    """step (an int or a tensor) -> the learning rate, an f32 tensor."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves added in
    the reference's order."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        dev = leaves(params)[0].device if leaves(params) else None
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """One step: (params, the new state), both updated in place."""
        step = state.step.add_(1)
        g32 = [g.to(torch.float32) for g in leaves(grads)]
        if self.grad_clip:
            gn = global_norm(g32)
            scale = torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)
            g32 = [g * scale for g in g32]
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=step.device) ** stepf
        lr = self.lr(step) if callable(self.lr) else self.lr
        for p, m, v, g in zip(leaves(params), leaves(state.mu),
                              leaves(state.nu), g32):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            pf = p.to(torch.float32)
            if self.weight_decay and p.dim() >= 2:   # decay matrices only
                delta = delta + self.weight_decay * pf
            p.copy_(pf - lr * delta)
        return params, state
