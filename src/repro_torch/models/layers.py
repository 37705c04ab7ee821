"""Shared model layers: RMSNorm, RoPE, GQA and MLA attention, SwiGLU FFN.

Counterpart of ``repro.models.layers`` for dense GQA and MLA models, over plain
dicts of tensors with the reference's layout: weights are
``(d_in, d_out)`` and used as ``x @ W``, cast to the activation type at
each product (a copy already in that type, as :func:`repro_torch.models.
model.serve_params` makes, casts to itself at no cost).  RMSNorm and the
RoPE angles compute in f32, as the reference does.

Attention goes through the port's kernels: prefill through
``kernels.flash_attention.ops.attention`` and each decode step through
``kernels.decode_attention.ops.decode_attn``, which launch the hand-written
CUDA kernels on the card and take their plain versions on the CPU.
``plain=True`` calls the plain versions on any device: a check-only switch,
for holding the kernels against them on the card; serving never sets it.
A sliding window (``cfg.sliding_window``) reaches both kernels.
Cross-attention (an encoder-decoder's, ``cross_kv``) goes through the same
two kernels with no mask: several queries through the flash kernel, one
query through the decode kernel.  MLA attention with a cache takes the
reference's weight-absorbed path over the latent cache, prefill through
``kernels.mla_attention.ops.mla_prefill`` and each decode step through
``mla_decode``; without a cache (training's ``forward``) it up-projects
K and V and attends through the flash kernel at q/k width
``head_dim + rope_head_dim`` and v width ``head_dim`` (its forward and
backward kernels' (96, 64) instances at MiniCPM3's widths).

On DTensors (the dry-run, ``launch.dryrun``) the kernel ops run on each
rank's shards and the caches are written shard by shard
(``parallel.spmd``); a sharded cache is filled from position 0, and a
decode step reads it at an int length, gathered whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.decode_attention.ref import decode_attention_ref
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import attention_ref
from ..kernels.mla_attention import ops as mla_ops
from ..kernels.mla_attention.ref import mla_decode_ref, mla_prefill_ref
from ..parallel import spmd

__all__ = ["dense_init", "rms_norm", "init_rms_norm", "rope", "init_gqa",
           "gqa_qkv", "gqa_attention", "write_cache", "prompt_keys", "init_mla",
           "mla_attention",
           "init_ffn", "ffn"]

# truncated_normal(stddev) of jax.nn.initializers: a standard normal cut at
# +-2 and scaled so that the cut distribution has the requested stddev
_TRUNC_STD = 0.87962566103423978

def dense_init(gen: torch.Generator, shape: tuple,
               dtype: torch.dtype) -> torch.Tensor:
    """Weights drawn as the reference's ``_dense_init`` draws them,
    truncated normal with stddev 0.02 (its distribution, not its bits: the
    generators differ).  On the meta device (``launch.input_specs``'s
    shape-only tree) it draws nothing."""
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    if t.is_meta:
        return t
    return torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0,
                                       generator=gen).mul_(0.02 / _TRUNC_STD)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(dt)


def init_rms_norm(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_gqa(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype),
        "wk": dense_init(gen, (d, kv * hd), dtype),
        "wv": dense_init(gen, (d, kv * hd), dtype),
        "wo": dense_init(gen, (h * hd, d), dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def gqa_qkv(p: dict, x: torch.Tensor, cfg):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (spmd.split_last(q, h, hd), spmd.split_last(k, kv, hd),
            spmd.split_last(v, kv, hd))


def gqa_attention(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                  kv_cache: tuple | None = None, causal: bool = True,
                  cross_kv=None, plain: bool = False):
    """Full GQA block; returns ``(out, new_cache)``.

    Without a cache, attention over ``x``'s own keys.  With
    ``kv_cache=(k, v, length)`` (k/v ``(B, max_len, KV, dh)``, updated in
    place) the new keys are written at ``length`` and:

    * ``S > 1`` tokens (prefill; ``length`` an int): the queries attend over
      the cache prefix ``[0, length + S)`` with end-aligned positions,
      which is the reference's ``q_offset = length`` mask; at ``length``
      0 that is the prompt's own keys, so the tail of the cache adds
      nothing, as in the reference;
    * one token (decode; ``length`` an int or a ``(B,)`` tensor, one per
      lane): the write index is clamped to ``max_len - 1`` as the
      reference's ``dynamic_update_slice`` clamps it, and the query sees
      cache positions ``<= length`` (all of them once ``length >=
      max_len``) and, under a sliding window ``W``, above ``length - W``,
      with ``length`` not clamped, as the reference's ``q_offset``.

    With ``cross_kv`` (the encoder output ``(B, Se, d)``), cross-attention
    as the reference computes it: q is ``x @ wq`` (plus ``bq``) without
    RoPE, k and v are ``cross_kv`` projected by ``wk`` and ``wv`` (no bias,
    even under ``qkv_bias``), and every query sees all ``Se`` keys of its
    own batch row: no mask, no window, no cache.  Several queries go
    through the flash kernel, one through the decode kernel, whose splits
    spread the lane's keys over the card; one query that needs a gradient
    takes the flash kernel, which has a backward.

    ``plain=True`` is a check-only switch: the kernels' plain versions on
    any device.  The cache returned is ``(k, v, length + S)`` (None without
    a cache)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    attend = attention_ref if plain else flash_ops.attention
    decode = decode_attention_ref if plain else decode_ops.decode_attn
    new_cache = None
    if cross_kv is not None:
        q = x @ p["wq"].to(x.dtype)
        if cfg.qkv_bias:
            q = q + p["bq"].to(x.dtype)
        q = spmd.split_last(q, h, hd)
        se, kvh = cross_kv.shape[1], cfg.n_kv_heads
        enc = cross_kv.to(x.dtype)
        k = spmd.split_last(enc @ p["wk"].to(x.dtype), kvh, hd)
        v = spmd.split_last(enc @ p["wv"].to(x.dtype), kvh, hd)
        if s == 1 and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v))):
            o = decode(q, k, v, length=se - 1)
        else:
            o = attend(q, k, v, causal=False)
    else:
        q, k, v = gqa_qkv(p, x, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if kv_cache is None:
            o = attend(q, k, v, causal=causal, window=cfg.sliding_window)
        else:
            ck, cv, ln = kv_cache
            write_cache((ck, cv), (k, v), ln)
            if s == 1:
                o = decode(q, ck, cv, ln, cfg.sliding_window)
            else:
                o = attend(q, *prompt_keys((ck, cv), (k, v), ln),
                           causal=True, window=cfg.sliding_window)
            new_cache = (ck, cv, ln + s)
    o = spmd.merge_last(o) @ p["wo"].to(x.dtype)
    return o, new_cache


def prompt_keys(caches: tuple, news: tuple, ln) -> tuple:
    """The keys a prompt of S tokens written at ``ln`` attends over: the
    caches' prefix ``[0, ln + S)`` (a sharded cache: the prompt's own
    ``news``, ``parallel.spmd.prompt_keys``)."""
    if spmd.is_dtensor(caches[0]):
        return spmd.prompt_keys(news, ln)
    s = news[0].shape[1]
    return tuple(c[:, :ln + s] for c in caches)


def init_mla(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    rq = cfg.q_lora_rank or d
    rkv, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    return {
        "w_dq": dense_init(gen, (d, rq), dtype),
        "w_uq": dense_init(gen, (rq, h * (hd + rd)), dtype),
        "w_dkv": dense_init(gen, (d, rkv), dtype),
        "w_ukv": dense_init(gen, (rkv, h * (hd + hd)), dtype),
        "w_kr": dense_init(gen, (d, rd), dtype),
        "wo": dense_init(gen, (h * hd, d), dtype),
    }


def write_cache(caches: tuple, news: tuple, ln) -> None:
    """Each ``new`` (B, S, ...) into its ``cache`` (B, max_len, ...) at
    ``ln``: a prompt at an int offset, or one token a lane at ``ln`` (an int
    or a ``(B,)`` tensor) clamped to ``max_len - 1``, as the reference's
    ``dynamic_update_slice`` clamps it.  A sharded cache: each rank writes
    its shard (``parallel.spmd.write_cache``)."""
    if spmd.is_dtensor(caches[0]):
        return spmd.write_cache(caches, news, ln)
    b, s = news[0].shape[:2]
    n = caches[0].shape[1]
    if s == 1:
        dev = caches[0].device
        idx = decode_ops.lengths_vector(ln, b, dev).clamp(max=n - 1)
        lanes = torch.arange(b, device=dev)
        for cache, new in zip(caches, news):
            cache[lanes, idx] = new[:, 0].to(cache.dtype)
        return
    if not isinstance(ln, int):
        raise TypeError("a multi-token cache write takes an int length")
    if ln + s > n:
        raise ValueError(f"{s} tokens at {ln} do not fit a cache of {n}")
    for cache, new in zip(caches, news):
        cache[:, ln:ln + s] = new.to(cache.dtype)


def mla_attention(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                  kv_cache: tuple | None = None, causal: bool = True,
                  plain: bool = False):
    """MLA block; returns ``(out, new_cache)``.

    With the latent cache ``kv_cache=(c_kv, k_rope, length)``
    (``(B, max_len, kv_lora_rank)`` and ``(B, max_len, rope_head_dim)``,
    updated in place), the reference's weight-absorbed path, step by step:
    the down and up projections, RoPE on ``q_rope`` and the one-head
    ``k_rope``, the cache write at ``length`` (:func:`write_cache`),
    ``q_lat = q_nope . W_uk``, attention over the latent (scores ``(q_lat .
    c + q_rope . k_rope) (head_dim + rope_head_dim)^-0.5``, causal from
    ``length``; ``S > 1`` tokens through ``mla_prefill`` over the cache
    prefix ``[0, length + S)``, one token through ``mla_decode``), the
    context in the activation type, then ``W_uv`` and ``wo``; the cache
    returned is ``(c_kv, k_rope, length + S)``.

    Without a cache (training's ``forward``), the reference's other
    branch: ``c_kv`` up-projected by ``w_ukv`` into ``k_nope`` and ``v``
    per head, ``k = [k_nope, k_rope]`` with the one ``k_rope`` broadcast
    over the heads, ``q = [q_nope, q_rope]``, attention over ``x``'s own
    keys through ``flash_ops.attention`` (q/k ``head_dim + rope_head_dim``
    wide, v ``head_dim``, scale the q/k width^-0.5; under grad its forward
    and backward kernels), then ``wo``; no cache (None).  ``v`` is a
    strided slice of the up-projection, copied contiguous for the kernel.
    ``plain=True`` is the check-only switch of :func:`gqa_attention`."""
    b, s, _ = x.shape
    h, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    rkv = cfg.kv_lora_rank
    cq = x @ p["w_dq"].to(x.dtype)
    q = spmd.split_last(cq @ p["w_uq"].to(x.dtype), h, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ p["w_dkv"].to(x.dtype)                   # (B, S, rkv)
    k_rope = rope((x @ p["w_kr"].to(x.dtype))[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]           # (B, S, rd)
    if kv_cache is None:
        kv = spmd.split_last(c_kv @ p["w_ukv"].to(x.dtype), h, 2 * hd)
        k_nope, v = kv[..., :hd], kv[..., hd:].contiguous()
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        attend = attention_ref if plain else flash_ops.attention
        o = attend(q_full, k_full, v, causal=causal)
        return spmd.merge_last(o) @ p["wo"].to(x.dtype), None
    cc, ckr, ln = kv_cache
    write_cache((cc, ckr), (c_kv, k_rope), ln)
    w_ukv = spmd.split_last(p["w_ukv"].to(x.dtype), h, 2 * hd)
    w_uk, w_uv = w_ukv[..., :hd], w_ukv[..., hd:]
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    scale = (hd + rd) ** -0.5
    if s == 1:
        decode = mla_decode_ref if plain else mla_ops.mla_decode
        ctx = decode(q_lat, q_rope, cc, ckr, ln, scale)
    else:
        attend = mla_prefill_ref if plain else mla_ops.mla_prefill
        ctx = attend(q_lat, q_rope,
                     *prompt_keys((cc, ckr), (c_kv, k_rope), ln), scale)
    o = torch.einsum("bshr,rhd->bshd", ctx.to(x.dtype), w_uv)
    o = spmd.merge_last(o) @ p["wo"].to(x.dtype)
    return o, (cc, ckr, ln + s)


def init_ffn(gen: torch.Generator, d: int, ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "w_gate": dense_init(gen, (d, ff), dtype),
        "w_in": dense_init(gen, (d, ff), dtype),
        "w_out": dense_init(gen, (ff, d), dtype),
    }


def ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    h = x @ p["w_in"].to(x.dtype)
    return (g * h) @ p["w_out"].to(x.dtype)
