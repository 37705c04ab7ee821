"""High-level model API: init / prefill / decode / teacher-forced forward /
loss, for dense and MoE attention models, MLA models (MiniCPM3), xLSTM,
the Jamba hybrid, the Whisper encoder-decoder and the InternVL2 VLM.

Counterpart of ``repro.models.model``.  Every entry point takes
``device=None``, meaning the card, and raises without one unless given
``device="cpu"``; the parameters must already be on that device.  The
caches are written in place.  An encoder-decoder model is served through
``prefill(..., frames=)``, which also returns the encoder output, and
``decode_step(..., cross_kv=)``, which takes it.  A VLM's
``vision_embeds`` reach ``forward`` and ``loss_fn`` only; its prefill and
decode are text-only, as the reference's are.  ``loss_fn`` is the
training loss; under autograd on the card its attention runs the
flash-attention forward and backward kernels.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import transformer as T

__all__ = ["init_params", "serve_params", "prefill", "decode_step",
           "forward", "loss_fn", "greedy_generate"]


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


def _frames(cfg, frames, dev):
    """``frames`` on ``dev``: required by an encoder-decoder model, refused
    by any other."""
    if cfg.is_encdec and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: prefill "
                         f"and forward take its frames (B, {cfg.enc_seq}, "
                         f"{cfg.d_model})")
    if not cfg.is_encdec and frames is not None:
        raise ValueError(f"{cfg.name} has no encoder: frames are for an "
                         f"encoder-decoder model")
    return None if frames is None else torch.as_tensor(frames, device=dev)


def prefill(params, cfg, tokens, max_len: int, device=None,
            plain: bool = False, frames=None, caches=None):
    """Run the prompt ``tokens`` (B, S) through the model, filling fresh
    caches (``max_len`` positions for attention; recurrent states hold the
    prompt's final state).  Returns (logits of the last position
    (B, V), caches, length S).  An encoder-decoder model (``cfg.is_encdec``)
    needs ``frames`` (B, enc_seq, d), the stubbed frame embeddings, and
    returns the reference's 4-tuple (logits, caches, length, cross_kv), with
    ``cross_kv`` the encoder output (B, enc_seq, d) in ``cfg.dtype`` that
    each :func:`decode_step` takes; any other model refuses ``frames``.
    ``plain=True`` is a check-only switch: it takes the kernels' plain
    versions on any device, to hold the kernels against them on the card;
    serving never sets it.  ``caches``, fresh caches of ``max_len`` to fill
    (``T.init_cache``'s layout), default new ones: the dry-run passes
    sharded ones."""
    dev = _device(params, device)
    tokens = torch.as_tensor(tokens, device=dev)
    frames = _frames(cfg, frames, dev)
    b, s = tokens.shape
    if caches is None:
        caches = T.init_cache(cfg, b, max_len, dev)
    cross_kv = (None if frames is None
                else T.encode(params, cfg, frames, plain))
    x = T.embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=dev).expand(b, s)
    x = T.run_cells(params, x, cfg, positions, caches, 0, plain,
                    cross_kv=cross_kv)
    h = T.rms_norm_final(params, cfg, x[:, -1:])
    logits = T.logits_fn(params, cfg, h)[:, -1]
    if cross_kv is None:
        return logits, caches, s
    return logits, caches, s, cross_kv


def decode_step(params, cfg, tokens, caches, length, device=None,
                plain: bool = False, per_lane: bool = False,
                cross_kv=None):
    """One token (B, 1) at cache fill ``length`` (an int, or a (B,) tensor,
    one per lane).  Returns (logits (B, V), caches).  ``plain=True`` is the
    check-only switch of :func:`prefill`.  ``per_lane=True`` routes each
    row's MoE tokens as a group of their own, as a serving engine decodes
    independent lanes; by default the B tokens form one group, as in the
    reference's ``decode_step``.  An encoder-decoder model needs
    ``cross_kv``, the encoder output :func:`prefill` returned (row b is lane
    b's); any other model refuses it."""
    dev = _device(params, device)
    tokens = torch.as_tensor(tokens, device=dev)
    if cfg.is_encdec and cross_kv is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                         f"decode_step takes the cross_kv prefill returned")
    if not cfg.is_encdec and cross_kv is not None:
        raise ValueError(f"{cfg.name} has no encoder: cross_kv is for an "
                         f"encoder-decoder model")
    if cross_kv is not None:
        cross_kv = torch.as_tensor(cross_kv, device=dev)
    return T.decode_step(params, cfg, tokens, caches, length, plain,
                         per_lane, cross_kv)


def _vision(cfg, vision_embeds, dev):
    """``vision_embeds`` on ``dev``: a VLM's optional prefix, refused by any
    other model."""
    if vision_embeds is None:
        return None
    if cfg.family != "vlm":
        raise ValueError(f"{cfg.name} is not a VLM: vision_embeds are for "
                         f"the vlm family")
    return torch.as_tensor(vision_embeds, device=dev)


def forward(params, cfg, tokens, frames=None, device=None,
            plain: bool = False, vision_embeds=None):
    """Teacher-forced forward of ``tokens`` (B, S), no caches: (the
    final-normed hidden states (B, S', d), the MoE aux loss), as the
    reference's ``transformer.forward``; :func:`repro_torch.models.
    transformer.logits_fn` turns the states into logits.  An
    encoder-decoder model needs ``frames``, as in :func:`prefill`; a VLM
    takes ``vision_embeds`` (B, Nv, d) as a prefix (S' = Nv + S).
    ``plain=True`` is the check-only switch of :func:`prefill`."""
    dev = _device(params, device)
    tokens = torch.as_tensor(tokens, device=dev)
    return T.forward(params, cfg, tokens, _frames(cfg, frames, dev), plain,
                     _vision(cfg, vision_embeds, dev))


def loss_fn(params, cfg, batch: dict, device=None,
            plain: bool = False) -> tuple:
    """The training loss of ``batch``, as the reference's ``loss_fn``:
    ``tokens`` and ``labels`` (B, S) int (label -100 masked), optional
    ``vision_embeds`` / ``frames``; numpy arrays or tensors, moved to the
    device.  Returns (ce + 0.01 aux, {"ce": ce, "aux": aux}), f32
    scalars.  A VLM's labels are padded with -100 over its vision prefix.
    ``plain=True`` is the check-only switch of :func:`prefill`."""
    dev = _device(params, device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    vision = _vision(cfg, batch.get("vision_embeds"), dev)
    h, aux = T.forward(params, cfg, tokens,
                       _frames(cfg, batch.get("frames"), dev), plain, vision)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    if vision is not None:
        pad = torch.full((labels.shape[0], vision.shape[1]), -100,
                         dtype=labels.dtype, device=dev)
        labels = torch.cat([pad, labels], dim=1)
    mask = (labels >= 0).to(torch.float32)
    labels = torch.clamp(labels, min=0)
    ce = T.chunked_softmax_xent(params, cfg, h, labels, mask)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def greedy_generate(params, cfg, prompt, steps: int, max_len: int,
                    device=None):
    """Greedy continuation of ``prompt`` (B, S): (B, steps) tokens.  An
    encoder-decoder model raises: the reference's ``greedy_generate``
    passes its prefill no frames, so it has no such path to match; serve
    one through :func:`prefill` (``frames=``) and :func:`decode_step`
    (``cross_kv=``)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"greedy_generate does not run {cfg.name}, an encoder-decoder "
            f"model: the reference's greedy_generate passes its prefill no "
            f"frames; call prefill(..., frames=) and decode_step(..., "
            f"cross_kv=)")
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
