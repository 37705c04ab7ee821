"""High-level model API: init / prefill / decode, for dense and MoE
attention models, MLA models (MiniCPM3), xLSTM and the Jamba hybrid.

Counterpart of ``repro.models.model``.  Every entry point takes
``device=None``, meaning the card, and raises without one unless given
``device="cpu"``; the parameters must already be on that device.  The
caches are written in place.  ``loss_fn`` waits for the training slice.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import transformer as T

__all__ = ["init_params", "serve_params", "prefill", "decode_step",
           "greedy_generate"]


def _device(params, device) -> torch.device:
    dev = resolve_device(device)
    where = params["embed"].device
    if where.type != dev.type:
        raise ValueError(f"the parameters are on {where}, not on {dev}")
    return dev


def init_params(gen: torch.Generator, cfg, device=None,
                serve: bool = False) -> dict:
    """Seeded weights (f32, ``cfg.param_dtype``) drawn from ``gen``, which
    must live on ``device``.  ``serve=True`` returns what
    :func:`serve_params` would make of them, cast leaf by leaf as they are
    drawn: the way to build a model whose f32 weights do not fit the card
    beside their served copy."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, not on {dev}")
    return T.init_params(
        gen, cfg, (lambda tree: serve_params(tree, cfg)) if serve else None)


# leaves kept as they are: norm scales (RMSNorm multiplies in f32; the
# xLSTM blocks keep theirs under "norm"), the sLSTM's gate weights, which
# its recurrence reads in f32, and the Mamba decay rates' log, which the
# scan reads in f32 (bf16 would move A = -exp(a_log) by up to 0.4 %)
_KEEP = frozenset({"scale", "norm", "w_gates", "r_gates", "a_log"})


def serve_params(params, cfg) -> dict:
    """``params`` with every weight, bias and the embedding cast once to the
    activation type ``cfg.dtype``, which is what each product casts them to
    anyway, so the results are the same; the leaves named in ``_KEEP``
    stay as they are."""
    dt = getattr(torch, cfg.dtype)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: (v if k in _KEEP else cast(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dt)

    return cast(params)


def prefill(params, cfg, tokens, max_len: int, device=None,
            plain: bool = False):
    """Run the prompt ``tokens`` (B, S) through the model, filling fresh
    caches (``max_len`` positions for attention; recurrent states hold the
    prompt's final state).  Returns (logits of the last position
    (B, V), caches, length S).  ``plain=True`` is a check-only switch: it
    takes the kernels' plain versions on any device, to hold the kernels
    against them on the card; serving never sets it."""
    dev = _device(params, device)
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    caches = T.init_cache(cfg, b, max_len, dev)
    x = T.embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=dev).expand(b, s)
    x = T.run_cells(params, x, cfg, positions, caches, 0, plain)
    h = T.rms_norm_final(params, cfg, x[:, -1:])
    return T.logits_fn(params, cfg, h)[:, -1], caches, s


def decode_step(params, cfg, tokens, caches, length, device=None,
                plain: bool = False, per_lane: bool = False):
    """One token (B, 1) at cache fill ``length`` (an int, or a (B,) tensor,
    one per lane).  Returns (logits (B, V), caches).  ``plain=True`` is the
    check-only switch of :func:`prefill`.  ``per_lane=True`` routes each
    row's MoE tokens as a group of their own, as a serving engine decodes
    independent lanes; by default the B tokens form one group, as in the
    reference's ``decode_step``."""
    dev = _device(params, device)
    tokens = torch.as_tensor(tokens, device=dev)
    return T.decode_step(params, cfg, tokens, caches, length, plain,
                         per_lane)


def greedy_generate(params, cfg, prompt, steps: int, max_len: int,
                    device=None):
    """Greedy continuation of ``prompt`` (B, S): (B, steps) tokens."""
    logits, caches, length = prefill(params, cfg, prompt, max_len, device)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        logits, caches = decode_step(params, cfg, tok, caches, length,
                                     device)
        length = length + 1
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
