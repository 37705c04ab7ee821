"""Decoder LM for dense and MoE attention models (Mixtral), MLA models
(MiniCPM3), xLSTM, the Jamba hybrid, the Whisper encoder-decoder and the
InternVL2 VLM: init, the encoder, prefill/decode, teacher-forced forward,
the chunked cross-entropy, caches.

Counterpart of ``repro.models.transformer`` with the same parameter tree:
layers grouped into repeating supercells, each cell position's parameters
stacked with a leading repetition axis under ``params["cells"][j]``, and
one cache per cell position in the layout of the reference's
``init_cache``: an attention block's ``(k, v)`` pair of ``(R, B, max_len,
KV, dh)`` tensors (MLA's latent pair ``(c_kv, k_rope)`` of ``(R, B,
max_len, kv_lora_rank)`` and ``(R, B, max_len, rope_head_dim)``), an mLSTM
block's ``(C, n, m)``, an sLSTM block's
``(c, h, n, m)`` and a Mamba block's ``(ssm, conv_buf)`` recurrent states,
f32 with the leading ``(R, B)`` axes.  An FFN is dense or MoE (holding the
config's share of the experts, ``models.moe``).  The reference scans over
repetitions; the port loops over them in Python (serving needs no
rematerialisation) and updates every cache in place.  An encoder-decoder
model adds the reference's encoder tree (``encoder``, stacked over its
layers; ``enc_pos``; ``enc_ln_f``) and a cross-attention ``{ln, attn}`` per
decoder repetition under ``cross``; its decoder blocks attend to the
encoder output (``cross_kv``, ``(B, enc_seq, d)``) after their
self-attention, and it keeps no cross-attention cache.  A VLM adds
``vis_proj`` (d, d): :func:`forward` given ``vision_embeds`` (B, Nv, d)
puts their projection before the token embeddings, as the reference's
``embed_tokens`` does; prefill and decode stay text-only, as the
reference's are.

Training runs :func:`forward` under autograd: with ``cfg.remat ==
"block"`` each block is checkpointed (``torch.utils.checkpoint``,
recomputed in backward), as the reference's ``jax.checkpoint`` does, and
:func:`chunked_softmax_xent` recomputes each chunk's logits in backward,
so that only one chunk's ``(B, c, V)`` logits are alive at a time.
Neither changes a number.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import spmd
from . import layers as L
from . import mamba as MB
from . import moe as MOE
from . import xlstm as X

__all__ = ["supercell_size", "cell_structure", "check_supported",
           "init_params", "embed_tokens", "encode", "forward",
           "rms_norm_final", "logits_fn", "chunked_softmax_xent",
           "run_cells", "init_cache", "decode_step"]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1: the model families "
        f"that wait)")


def supercell_size(cfg) -> int:
    g = 1
    if cfg.attn_every > 1:
        g = math.lcm(g, cfg.attn_every)
    if cfg.family == "ssm" and cfg.slstm_every:
        g = math.lcm(g, cfg.slstm_every)
    if cfg.n_experts and cfg.moe_every > 1:
        g = math.lcm(g, cfg.moe_every)
    if cfg.n_layers % g != 0:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by cell={g}")
    return g


def cell_structure(cfg) -> list[tuple[str, str]]:
    """[(block_kind, ffn_kind)] per position in one supercell."""
    kinds = cfg.layer_kinds()[: supercell_size(cfg)]
    out = []
    for i, kind in enumerate(kinds):
        if cfg.family == "ssm":
            ffn_kind = "none"
        elif cfg.layer_is_moe(i):
            ffn_kind = "moe"
        elif cfg.d_ff:
            ffn_kind = "dense"
        else:
            ffn_kind = "none"
        out.append((kind, ffn_kind))
    return out


# recurrent block kinds: (init of its parameters, init of its state)
_RECURRENT = {"mlstm": (X.init_mlstm, X.init_mlstm_state),
              "slstm": (X.init_slstm, X.init_slstm_state),
              "mamba": (MB.init_mamba, MB.init_mamba_state)}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a model the port cannot run yet."""
    for kind, _ in cell_structure(cfg):
        if kind not in _RECURRENT and kind != "attn":
            raise _unported(f"the {kind} block ({cfg.name})")


def _init_block(gen, cfg, kind: str, ffn_kind: str, dtype, cast,
                store) -> dict:
    """One block's weights, each part passed through ``cast`` as soon as it
    is drawn (the experts are drawn one at a time into ``store``)."""
    p: dict = {"ln1": L.init_rms_norm(cfg.d_model, dtype, gen.device)}
    if kind == "attn":
        init = L.init_mla if cfg.attention == "mla" else L.init_gqa
        p["attn"] = cast(init(gen, cfg, dtype))
    else:
        p[kind] = cast(_RECURRENT[kind][0](gen, cfg, dtype))
    if ffn_kind != "none":
        p["ln2"] = L.init_rms_norm(cfg.d_model, dtype, gen.device)
        if ffn_kind == "moe":
            p["moe"] = cast(MOE.init_moe(gen, cfg, dtype, store))
        else:
            p["ffn"] = cast(L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype))
    return p


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_into(dst, src, r: int) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k], r)
    else:
        dst[r].copy_(src)


def _stacked(draw, reps: int):
    """``reps`` trees from ``draw()``, stacked on a new leading axis.  Each
    is copied into its slot as soon as it is drawn, so the stack never
    sits beside a second copy of itself (one repetition is a view)."""
    first = draw()
    if reps == 1:
        return _tree_map(lambda t: t.unsqueeze(0), first)
    out = _tree_map(lambda t: t.new_empty((reps,) + tuple(t.shape)), first)
    _copy_into(out, first, 0)
    del first
    for r in range(1, reps):
        _copy_into(out, draw(), r)
    return out


def init_params(gen: torch.Generator, cfg, serve_cast=None) -> dict:
    """Seeded weights on ``gen``'s device, with the reference's tree and
    distributions (not its bits), in ``cfg.param_dtype``.  ``serve_cast``
    (a function of a subtree) is applied to each block's parts and to the
    embeddings as soon as they are drawn, and the experts are drawn one at a
    time into ``cfg.dtype``: the served copy is made leaf by leaf, never
    beside a whole f32 tree."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    cast = serve_cast or (lambda tree: tree)
    store = getattr(torch, cfg.dtype) if serve_cast else None
    reps = cfg.n_layers // supercell_size(cfg)
    cells = [_stacked(lambda: _init_block(gen, cfg, kind, ffn_kind, dtype,
                                          cast, store), reps)
             for kind, ffn_kind in cell_structure(cfg)]
    p = {
        "embed": cast(L.dense_init(gen, (cfg.vocab, cfg.d_model), dtype)),
        "cells": cells,
        "ln_f": L.init_rms_norm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = cast(L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                         dtype))
    if cfg.family == "vlm":
        p["vis_proj"] = cast(L.dense_init(gen, (cfg.d_model, cfg.d_model),
                                          dtype))
    if cfg.is_encdec:
        dev = gen.device
        p["encoder"] = _stacked(lambda: {
            "ln1": L.init_rms_norm(cfg.d_model, dtype, dev),
            "attn": cast(L.init_gqa(gen, cfg, dtype)),
            "ln2": L.init_rms_norm(cfg.d_model, dtype, dev),
            "ffn": cast(L.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype)),
        }, cfg.n_enc_layers)
        p["enc_pos"] = cast(L.dense_init(gen, (cfg.enc_seq, cfg.d_model),
                                         dtype))
        p["enc_ln_f"] = L.init_rms_norm(cfg.d_model, dtype, dev)
        p["cross"] = _stacked(lambda: {
            "ln": L.init_rms_norm(cfg.d_model, dtype, dev),
            "attn": cast(L.init_gqa(gen, cfg, dtype)),
        }, reps)
    return p


def _layer(tree, r: int):
    """Repetition ``r`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _block_forward(bp, x, cfg, kind, ffn_kind, positions, cache=None,
                   plain=False, per_lane=False, cross_kv=None, cross_p=None):
    """One block; returns (x, the new recurrent state or None, the MoE
    FFN's aux loss or None).  An attention block writes its KV cache in
    place and, given ``cross_p`` (a repetition of ``params["cross"]``),
    adds cross-attention to ``cross_kv`` after its own, as the reference
    does.  ``per_lane`` groups an MoE FFN's tokens within each batch row
    (see :func:`run_cells`)."""
    x, bp, cross_p = spmd.block_inputs(x, bp, cross_p)
    h = L.rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    new_state = aux = None
    if kind == "attn":
        fn = L.mla_attention if cfg.attention == "mla" else L.gqa_attention
        o, _ = fn(bp["attn"], h, cfg, positions, kv_cache=cache, plain=plain)
        if cross_p is not None:
            x = x + spmd.batch_layout(o)
            hc = L.rms_norm(x, cross_p["ln"]["scale"], cfg.norm_eps)
            o, _ = L.gqa_attention(cross_p["attn"], hc, cfg, positions,
                                   cross_kv=cross_kv, plain=plain)
    elif kind == "mlstm":
        o, new_state = X.mlstm_block(bp["mlstm"], h, cfg, state=cache,
                                     plain=plain)
    elif kind == "mamba":
        o, new_state = MB.mamba_block(bp["mamba"], h, cfg, state=cache,
                                      plain=plain)
    else:
        o, new_state = X.slstm_block(bp["slstm"], h, cfg, state=cache)
    x = x + spmd.batch_layout(o)
    if ffn_kind == "dense":
        x = x + spmd.batch_layout(L.ffn(bp["ffn"], L.rms_norm(
            x, bp["ln2"]["scale"], cfg.norm_eps)))
    elif ffn_kind == "moe":
        o, aux = MOE.moe_ffn(bp["moe"], L.rms_norm(x, bp["ln2"]["scale"],
                                                   cfg.norm_eps), cfg,
                             per_row=per_lane)
        x = x + spmd.batch_layout(o)
    return x, new_state, aux


def _cache_in(kind: str, cache: tuple, r: int, length) -> tuple:
    """Repetition ``r`` of a cell position's cache, as its block takes it:
    ``(k, v, length)`` for attention (MLA: ``(c_kv, k_rope, length)``), the
    state tensors otherwise."""
    if kind == "attn":
        ck, cv = cache
        return ck[r], cv[r], length
    return tuple(t[r] for t in cache)


def _cache_out(kind: str, cache: tuple, r: int, new_state) -> None:
    """Write a recurrent block's new state into repetition ``r`` of its
    cache (an attention block has written its own)."""
    if kind != "attn":
        for dst, src in zip(cache, new_state):
            dst[r].copy_(src)


def run_cells(params, x, cfg, positions, caches=None, length=0,
              plain=False, per_lane=False, cross_kv=None, aux=None):
    """All layers in order.  ``caches``: per cell position the cache of
    its block kind (see the module docstring), updated in place, with
    ``length`` the attention caches' fill (an int, or a ``(B,)`` tensor
    for a one-token step; recurrent blocks do not read it); None runs
    without caches (the teacher-forced path).  ``per_lane``
    groups each MoE FFN's tokens within each batch row instead of over the
    whole batch: the capacity then couples no two lanes, as in the
    reference engine's per-lane decode.  ``cross_kv``: an encoder-decoder's
    encoder output, which repetition ``r``'s attention blocks attend to
    through ``params["cross"]``'s repetition ``r``.  ``aux``, a list,
    collects the MoE FFNs' aux losses.  Without caches, under grad and with
    ``cfg.remat == "block"``, each block is checkpointed: its activations
    are recomputed in backward, as the reference's ``jax.checkpoint``
    recomputes them."""
    struct = cell_structure(cfg)
    reps = cfg.n_layers // len(struct)
    remat = (caches is None and cfg.remat == "block"
             and torch.is_grad_enabled())
    for r in range(reps):
        cross_p = (None if cross_kv is None
                   else _layer(params["cross"], r))
        for j, (kind, ffn_kind) in enumerate(struct):
            cache = (None if caches is None
                     else _cache_in(kind, caches[j], r, length))
            args = (_layer(params["cells"][j], r), x, cfg, kind, ffn_kind,
                    positions, cache, plain, per_lane, cross_kv, cross_p)
            if remat:
                x, new_state, a = checkpoint(_block_forward, *args,
                                             use_reentrant=False,
                                             preserve_rng_state=False)
            else:
                x, new_state, a = _block_forward(*args)
            if caches is not None:
                _cache_out(kind, caches[j], r, new_state)
            if aux is not None and a is not None:
                aux.append(a)
    return x


def embed_tokens(params, cfg, tokens, vision_embeds=None):
    """Token embeddings in ``cfg.dtype``; a VLM given ``vision_embeds``
    (B, Nv, d) puts ``vision_embeds @ vis_proj`` before them."""
    x = spmd.embed(spmd.fsdp_gather(params["embed"]), tokens).to(
        getattr(torch, cfg.dtype))
    if cfg.family == "vlm" and vision_embeds is not None:
        vis = (vision_embeds.to(x.dtype)
               @ spmd.fsdp_gather(params["vis_proj"]).to(x.dtype))
        x = torch.cat([vis, x], dim=1)
    return x


def encode(params, cfg, frames, plain=False):
    """The encoder over stubbed frame embeddings ``frames`` (B, enc_seq, d)
    -> (B, enc_seq, d) in ``cfg.dtype``: ``enc_pos`` added, then per layer
    RMSNorm, non-causal self-attention with RoPE on q and k (the
    reference's path without a cache, under ``cfg.sliding_window``), the
    residual, RMSNorm, the SwiGLU FFN and the residual; ``enc_ln_f`` last.
    ``plain`` as in :func:`run_cells`."""
    want = (cfg.enc_seq, cfg.d_model)
    if frames.dim() != 3 or tuple(frames.shape[1:]) != want:
        raise ValueError(f"frames must have shape (B, {want[0]}, {want[1]}) "
                         f"(got {tuple(frames.shape)})")
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt) + params["enc_pos"].to(dt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for r in range(cfg.n_enc_layers):
        x, lp = spmd.block_inputs(x, _layer(params["encoder"], r))
        h = L.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps)
        o, _ = L.gqa_attention(lp["attn"], h, cfg, positions, causal=False,
                               plain=plain)
        x = x + spmd.batch_layout(o)
        x = x + spmd.batch_layout(L.ffn(lp["ffn"], L.rms_norm(
            x, lp["ln2"]["scale"], cfg.norm_eps)))
    return L.rms_norm(x, params["enc_ln_f"]["scale"], cfg.norm_eps)


def forward(params, cfg, tokens, frames=None, plain=False,
            vision_embeds=None):
    """Teacher-forced forward of ``tokens`` (B, S) without caches -> (the
    final-normed hidden states (B, S', d), the sum of the MoE FFNs' aux
    losses, an f32 scalar), as the reference's ``forward``; an
    encoder-decoder model encodes ``frames`` first, and a VLM given
    ``vision_embeds`` (B, Nv, d) runs them as a prefix (S' = Nv + S).  MLA
    models attend through :func:`repro_torch.models.layers.mla_attention`'s
    cacheless branch."""
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    cross_kv = encode(params, cfg, frames, plain) if cfg.is_encdec else None
    aux: list = []
    x = run_cells(params, x, cfg, positions, plain=plain, cross_kv=cross_kv,
                  aux=aux)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    return rms_norm_final(params, cfg, x), total


def rms_norm_final(params, cfg, x):
    return L.rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)


def _unembed(params, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return spmd.fsdp_gather(w)


def logits_fn(params, cfg, h):
    return h @ _unembed(params, cfg).to(h.dtype)


def _chunk_nll(w, h, labels, mask):
    """Sum over one chunk of the masked negative log-likelihood, from its
    f32 logits ``h @ w``."""
    logits = spmd.vocab_logits(h, w)
    logz = spmd.logsumexp(logits)
    gold = spmd.label_logits(logits, labels)
    return ((logz - gold) * mask).sum()


def chunked_softmax_xent(params, cfg, h, labels, mask, chunk: int = 512):
    """Cross-entropy without materializing (B, S, V) logits: the
    reference's chunks of ``chunk`` positions (S padded to a multiple),
    each chunk's f32 logsumexp, the masked sum over chunks in order over
    the mask's count.  Under grad each chunk is checkpointed, so backward
    recomputes its logits and keeps one chunk's alive at a time."""
    b, s, d = h.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:     # (a DTensor pad of nothing trips some torch versions)
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    w = _unembed(params, cfg)
    remat = torch.is_grad_enabled() and (h.requires_grad or w.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(h.shape[1] // c):
        part = (w, h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                mask[:, i * c:(i + 1) * c])
        nll = (checkpoint(_chunk_nll, *part, use_reentrant=False,
                          preserve_rng_state=False)
               if remat else _chunk_nll(*part))
        tot = tot + nll
        cnt = cnt + part[3].sum()
    return tot / torch.clamp(cnt, min=1.0)


def init_cache(cfg, batch: int, max_len: int, device) -> list:
    """Per cell position: for attention a ``(k, v)`` pair of zero ``(R, B,
    max_len, KV, dh)`` tensors in the activation type (MLA: the latent
    ``(c_kv, k_rope)`` pair of ``(R, B, max_len, kv_lora_rank)`` and ``(R,
    B, max_len, rope_head_dim)``); for an mLSTM, sLSTM
    or Mamba block its fresh state (``init_*_state``, f32; the xLSTM
    stabilisers ``m`` at -1e9) repeated to ``(R, B, ...)``.  Recurrent
    states stay f32, as in the reference: they are small beside KV caches
    and accumulate over every decode step."""
    check_supported(cfg)
    reps = cfg.n_layers // supercell_size(cfg)
    lead = (reps, batch, max_len)
    if cfg.attention == "mla":
        shapes = (lead + (cfg.kv_lora_rank,), lead + (cfg.rope_head_dim,))
    else:
        shapes = (lead + (cfg.n_kv_heads, cfg.head_dim),) * 2
    dt = getattr(torch, cfg.dtype)
    caches = []
    for kind, _ in cell_structure(cfg):
        if kind == "attn":
            caches.append(tuple(torch.zeros(sh, dtype=dt, device=device)
                                for sh in shapes))
        else:
            st = _RECURRENT[kind][1](cfg, batch, device)
            caches.append(tuple(t.expand((reps,) + t.shape).contiguous()
                                for t in st))
    return caches


def decode_step(params, cfg, tokens, caches, length, plain=False,
                per_lane=False, cross_kv=None):
    """One-token decode.  tokens: (B, 1); length: the cache fill, an int or
    a (B,) int tensor (one per lane); ``per_lane`` and ``cross_kv`` (an
    encoder-decoder's encoder output) as in :func:`run_cells`.  Writes the
    caches in place; returns (logits (B, V), caches)."""
    x = embed_tokens(params, cfg, tokens)
    if isinstance(length, torch.Tensor):
        positions = length.reshape(-1, 1).expand(tokens.shape)
    else:
        positions = torch.full(tokens.shape, length, dtype=torch.int32,
                               device=tokens.device)
    x = run_cells(params, x, cfg, positions, caches, length, plain,
                  per_lane, cross_kv)
    h = rms_norm_final(params, cfg, x)
    return logits_fn(params, cfg, h)[:, -1], caches
