"""Train step assembly: loss -> grads -> (optional compression) -> AdamW.

Counterpart of ``repro.train.train_step``, as plain Python over trees of
tensors (the reference jit-compiles its step; the port runs eagerly and
has no counterpart of that).  Microbatch gradients are accumulated in f32
in order, then averaged; ``grad_wire_dtype`` casts the gradients before
the (here absent) data-parallel reduction, and ``grad_compression``
quantizes them to int8 with error feedback, as the reference does; the
optimizer's math stays f32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import loss_fn
from ..tree import leaves, tree_map, unflatten
from .compression import compress_grads, decompress_grads, init_error
from .optimizer import AdamState, AdamW, cosine_schedule, global_norm

__all__ = ["TrainState", "init_state", "make_optimizer", "make_train_step"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    err: Any | None           # error-feedback state (compression) or None


def make_optimizer(tc) -> AdamW:
    return AdamW(
        lr=cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps),
        b1=tc.b1, b2=tc.b2,
        weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
    )


def init_state(params, tc) -> TrainState:
    opt = make_optimizer(tc).init(params)
    err = init_error(params) if tc.grad_compression else None
    return TrainState(params=params, opt=opt, err=err)


def _split(batch: dict, n: int) -> list[dict]:
    """``batch`` cut into ``n`` microbatches along its leading axis."""
    b = len(batch["tokens"])
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg, tc, device=None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` a dict of
    numpy arrays (or tensors), moved to ``device`` (default: the card, as
    every entry point).  The state is updated in place."""
    optimizer = make_optimizer(tc)

    def value_and_grad(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = loss_fn(p, cfg, batch, device=device)
        flat = leaves(p)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for t, g in zip(flat, gs)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten(params, gs))

    def compute_grads(params, batch):
        if tc.microbatches > 1:
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for t in leaves(params)]
            losses, metrics = [], []
            for mb in _split(batch, tc.microbatches):
                loss, m, g = value_and_grad(params, mb)
                acc = [a + x for a, x in zip(acc, leaves(g))]
                losses.append(loss)
                metrics.append(m)
            grads = unflatten(params, [a / tc.microbatches for a in acc])
            mean = {k: torch.stack([m[k] for m in metrics]).mean()
                    for k in metrics[0]}
            return torch.stack(losses).mean(), mean, grads
        return value_and_grad(params, batch)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grads = compute_grads(state.params, batch)
        if tc.grad_wire_dtype != "float32":
            wd = getattr(torch, tc.grad_wire_dtype)
            grads = tree_map(lambda g: g.to(wd), grads)
        err = state.err
        if err is not None:
            qs, err = compress_grads(grads, err)
            grads = decompress_grads(qs)
        new_params, new_opt = optimizer.update(grads, state.opt, state.params)
        out = dict(metrics)
        out["loss"] = loss
        out["grad_norm"] = global_norm(grads)
        return TrainState(new_params, new_opt, err), out

    return train_step
