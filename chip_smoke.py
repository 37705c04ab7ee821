#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from a checkout on a machine with an NVIDIA Hopper card and ``nvcc``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), holds each kernel against its
plain PyTorch version on the card, and drives the port's two paths once
at full size, each with the kernels' launch counts set to 0 just before
it and read just after:

1. Vermilion schedules built with ``normalize="saturate"`` (Sinkhorn on
   the card), then a batched single-hop sweep whose data plane runs on the
   card, with per-flow FCTs from the host credit replay; the card's result
   is checked against the port's CPU run of the same schedules.  The
   deployment: n = 256 ToRs, d_hat = 8 uplinks, k = 3, recfg_frac = 1/9,
   100 Gb/s links with 4.5 us slots; websearch traffic (DCTCP CDF),
   rack-permutation, at loads 0.15 / 0.3 / 0.45 / 0.6, 2000 slots, seed 1.
2. Serving: ``ServeEngine`` with Qwen1.5-0.5B at full width and depth
   (24 layers, d_model 1024, 16 heads, vocab 151,936) on seeded random
   weights, bf16, 8 lanes of 2048 positions, 16 requests with prompts of
   128-1024 tokens and 32 new tokens each; prefill runs the flash-attention
   kernel, every decode step the flash-decode kernel.  Two requests are
   then rerun one at a time, fed the tokens the engine served them,
   through the kernels and through the plain versions, in bf16 and in
   f32, and their logits compared at every step; two deliberately broken
   uses of the kernels are read the same way (controls: the gate must sit
   between them and the kernels), and each token the engine served must
   be a near-argmax of the plain version's logits.

Any failure raises: no phase is caught.

Output: readable lines, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a card or outside a checkout.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.schedule import vermilion_schedule  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    SweepCase,
    run_sweep,
    websearch_workload,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops  # noqa: E402
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

N, D_HAT, K, RECFG = 256, 8, 3, 1 / 9
BITS_PER_SLOT = 100e9 * 4.5e-6
LOADS = (0.15, 0.3, 0.45, 0.6)
HORIZON, SEED = 2000, 1

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor-core f32 / f64 rates and the dense bf16 tensor-core rate
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12}

# kernel vs plain tolerances: f32 as in tests/test_kernels.py (reduction
# order only), f64 near its precision (200 iterations of it)
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 0.0)}

# card vs CPU FCTs: CUDA index_add_ adds several arrivals of one pair in
# one slot in a varying order; the drain reconciliation absorbs most such
# ulp residues, not every one
FCT_MAX_DIFF_FRAC, FCT_MAX_DIFF_SLOTS = 1e-3, 1.0

TRACE_ACTIVITIES = (ProfilerActivity.CPU, ProfilerActivity.CUDA)

# the card; the attention and serving phases read it (a rehearsal on the
# CPU sets it to "cpu")
DEV = "cuda"

# serving: Qwen1.5-0.5B at full width and depth, the repo's default
# serving model (src/repro/launch/serve.py)
ARCH = "qwen1.5-0.5b"
LANES, MAX_LEN = 8, 2048
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 16, 128, 1024, 32
CHECK_REQUESTS, CHECK_STEPS = 2, 8
TRACED_STEPS = 8

# attention kernel vs plain, as tests/test_kernels.py holds the Pallas
# attention kernels: f32 reduction order only; bf16 one output rounding
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# served logits, kernels vs plain versions on the same tokens, bound on
# max |diff| relative to the largest |logit|: the two differ by reduction
# order inside attention (f32: ~1e-6 of a value per call), carried through
# 24 layers, and in bf16 also by the roundings that order flips (one bf16
# ulp is 0.4-0.8 % of a value)
LOGIT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
# a served token's plain logit may sit below the plain maximum by twice
# the bf16 gate: the engine's logits and the plain ones each lie within
# LOGIT_TOL of the kernel path's
TOKEN_GAP = 2 * LOGIT_TOL[torch.bfloat16]


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    from CUDA events, after ``warm`` unmeasured calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@functools.cache
def capture_stream() -> torch.cuda.Stream:
    """The one stream :func:`device_ms` warms up and captures on."""
    return torch.cuda.Stream()


def device_ms(fn, reps: int, warm: int = 2, replays: int = 3) -> float:
    """Mean device time of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events after one
    unmeasured replay.  The host's work around each call (the wrapper's
    Python, its ctypes call, its allocations) is not replayed, so this is
    the card's time alone.  Every capture uses one stream: cuBLAS keeps a
    workspace for each stream it has run on, for the life of the
    process."""
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (reps * replays)


def sinkhorn_bound_ms(n: int, iters: int, dtype: torch.dtype) -> tuple:
    """Least time for the work on this card: bytes (input read once,
    output written once) over HBM rate vs ~4 iters n^2 operations over the
    type's peak.  Returns (ms, "bytes" | "operations")."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = 2 * n * n * size / HBM_BPS
    t_ops = 4 * iters * n * n / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def saturate_input(n: int, load: float) -> np.ndarray:
    """What ``saturate`` hands the kernel on the main path: the websearch
    demand matrix with nonpositive entries clamped to 1e-12."""
    m = websearch_workload(n, load, HORIZON, BITS_PER_SLOT, d_hat=D_HAT,
                           seed=SEED).demand_matrix()
    return np.where(m <= 0, 1e-12, m)


def check_kernel(m: torch.Tensor, iters: int, eps: float, reps: int,
                 plain_reps: int) -> dict:
    n, dtype = m.shape[0], m.dtype
    got = sinkhorn_ops.sinkhorn_kernel(m, iters=iters, eps=eps)
    torch.cuda.synchronize()
    want = sinkhorn_ref(m, iters=iters, eps=eps)
    again = sinkhorn_ops.sinkhorn_kernel(m, iters=iters, eps=eps)
    err = (got - want).abs()
    rtol, atol = TOL[dtype]
    max_abs = float(err.max())
    max_rel = float((err / want.abs()).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    same = bool(torch.equal(got, again))
    ms = time_ms(lambda: sinkhorn_ops.sinkhorn_kernel(m, iters, eps), reps)
    plain_ms = time_ms(lambda: sinkhorn_ref(m, iters, eps), plain_reps)
    bound_ms, bound_by = sinkhorn_bound_ms(n, iters, dtype)
    name = str(dtype).replace("torch.", "")
    log(f"  {name:8s} n={n:5d} iters={iters:3d}: max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (rtol {rtol:g}, atol {atol:g}) "
        f"{'ok' if ok else 'FAIL'}; deterministic={same}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"sinkhorn kernel disagrees with its plain "
                             f"version: {name} n={n}")
    if not same:
        raise AssertionError(f"sinkhorn kernel is not deterministic: "
                             f"{name} n={n}")
    return {"dtype": name, "n": n, "iters": iters, "max_abs_err": max_abs,
            "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def attn_bound_ms(bytes_moved: float, flops: float,
                  dtype: torch.dtype) -> tuple:
    """(least ms for the work on this card, "bytes" | "operations")."""
    t_bytes = bytes_moved / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, end-aligned positions."""
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return int(ok.sum())


def _end_aligned_mask(sq: int, sk: int, causal: bool, window: int,
                      dev) -> torch.Tensor:
    qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=dev)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def check_flash(label: str, b: int, sq: int, sk: int, h: int, kv: int,
                dh: int, dtype: torch.dtype, causal: bool = True,
                window: int = 0, reps: int = 20, seed: int = SEED) -> dict:
    """The flash-attention kernel against its plain version on one input;
    times kernel, plain version and ``scaled_dot_product_attention`` on the
    card alone (:func:`device_ms`), and the kernel's calls with the host's
    share (:func:`time_ms`)."""
    gen = torch.Generator(device=DEV).manual_seed(seed + sq + sk + h)
    q = torch.randn(b, sq, h, dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, sk, kv, dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, sk, kv, dh, generator=gen, device=DEV).to(dtype)
    got = flash_ops.attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal, window=window)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol = ATTN_TOL[dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    call = lambda: flash_ops.attention_kernel(  # noqa: E731
        q, k, v, causal, window)
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal, window),
                         max(2, reps // 4))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if causal and sq == sk and not window:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=h != kv)
    else:
        mask = _end_aligned_mask(sq, sk, causal, window, DEV)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
    library_ms = device_ms(lib, reps)
    size = torch.finfo(dtype).bits // 8
    pairs = visible_pairs(sq, sk, causal, window)
    bound_ms, bound_by = attn_bound_ms(
        (2 * b * sq * h + 2 * b * sk * kv) * dh * size,
        4.0 * b * h * dh * pairs, dtype)
    log(f"  {label:14s} {_dname(dtype):8s} B={b} Sq={sq} Sk={sk} H={h} "
        f"KV={kv} dh={dh} causal={int(causal)} window={window}: "
        f"max_abs_err={err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}; "
        f"kernel {ms:.4f} ms (with the host {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"flash-attention kernel disagrees with its "
                             f"plain version: {label} {_dname(dtype)}")
    return {"label": label, "dtype": _dname(dtype),
            "shape": [b, sq, sk, h, kv, dh], "causal": causal,
            "window": window, "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_decode(label: str, lens: list, s: int, h: int, kv: int, dh: int,
                 dtype: torch.dtype, reps: int = 20,
                 seed: int = SEED) -> dict:
    """The flash-decode kernel against its plain version with one length
    per lane; checks two calls bitwise; times kernel, plain version and
    ``scaled_dot_product_attention`` with the same per-lane mask on the card
    alone (:func:`device_ms`), and the kernel's calls with the host's share
    (:func:`time_ms`)."""
    b = len(lens)
    gen = torch.Generator(device=DEV).manual_seed(seed + s + h)
    q = torch.randn(b, 1, h, dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, s, kv, dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, s, kv, dh, generator=gen, device=DEV).to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device=DEV)
    got = decode_ops.decode_kernel(q, k, v, length)
    again = decode_ops.decode_kernel(q, k, v, length)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, length)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol = ATTN_TOL[dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    same = bool(torch.equal(got, again))
    call = lambda: decode_ops.decode_kernel(q, k, v, length)  # noqa: E731
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, length),
                         max(2, reps // 4))
    kpos = torch.arange(s, device=DEV)[None, :]
    mask = (kpos <= length[:, None].long())[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=h != kv), reps)
    size = torch.finfo(dtype).bits // 8
    rows = sum(min(x, s - 1) + 1 for x in lens if x >= 0)
    bound_ms, bound_by = attn_bound_ms(
        2 * rows * kv * dh * size + 2 * b * h * dh * size + 4 * b,
        4.0 * rows * (h // kv) * kv * dh, dtype)
    log(f"  {label:14s} {_dname(dtype):8s} B={b} S={s} H={h} KV={kv} "
        f"dh={dh} lengths={lens}: max_abs_err={err:.3e} "
        f"(tol {tol:g}) {'ok' if ok else 'FAIL'}; deterministic={same}; "
        f"kernel {ms:.4f} ms (with the host {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"flash-decode kernel disagrees with its plain "
                             f"version: {label} {_dname(dtype)}")
    if not same:
        raise AssertionError(f"flash-decode kernel is not deterministic: "
                             f"{label}")
    return {"label": label, "dtype": _dname(dtype),
            "shape": [b, s, h, kv, dh], "lengths": lens,
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def serving_requests(vocab: int) -> list:
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LO, PROMPT_HI + 1, size=N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(1, vocab, size=int(n)),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(lens)]


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def decode_split_dropped(q, k, v, length):
    """Control: the decode kernel with the first cache split's keys left
    out, what a combine that lost one partial would return."""
    s = decode_ops.SPLIT
    ln = decode_ops.lengths_vector(length, q.shape[0], q.device) - s
    return decode_ops.decode_kernel(q, k[:, s:], v[:, s:], ln)


def flash_unscaled(q, k, v, causal=True, window=0):
    """Control: the flash kernel with the 1/sqrt(dh) softmax scale left
    out."""
    return flash_ops.attention_kernel(q * q.shape[-1] ** 0.5, k, v, causal,
                                      window)


# the controls: module, wrapper name, the broken use of the kernel
CONTROLS = {"decode_split_dropped": (decode_ops, "decode_attn",
                                     decode_split_dropped),
            "flash_unscaled": (flash_ops, "attention", flash_unscaled)}


def logits_path(p, cfg, prompt: torch.Tensor, feed: list,
                plain: bool = False) -> list:
    """Logits (f32, (V,)) of one request at B = 1: its prefill, then one
    decode step per token of ``feed``."""
    lg, caches, ln = prefill(p, cfg, prompt, MAX_LEN, DEV, plain=plain)
    out = [lg[0].float()]
    for i, tok in enumerate(feed):
        t = torch.tensor([[tok]], device=DEV)
        lg, caches = decode_step(p, cfg, t, caches, ln + i, DEV, plain=plain)
        out.append(lg[0].float())
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (at least 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _gaps(logits: list, tokens: list) -> list:
    """How far below the maximum each token's logit sits, over the largest
    |logit| (0 for the argmax)."""
    return [(float(lg.max()) - float(lg[t])) / max(1.0, float(lg.abs().max()))
            for lg, t in zip(logits, tokens)]


def check_logits(p, cfg, req: Request) -> tuple:
    """Prefill plus CHECK_STEPS decode steps of one request, fed the tokens
    the engine served it, through the kernels, through the plain versions
    and through each control; per position the max |logit diff| against
    the plain versions over their largest |logit|.  Returns (readings, the
    plain versions' logits)."""
    prompt = torch.as_tensor(req.prompt, device=DEV)[None]
    feed = req.out_tokens[:CHECK_STEPS]
    kern = logits_path(p, cfg, prompt, feed)
    plain = logits_path(p, cfg, prompt, feed, plain=True)
    controls = {}
    for name, (module, attr, fn) in CONTROLS.items():
        with swapped(module, attr, fn):
            bad = logits_path(p, cfg, prompt, feed)
        controls[name] = max(_rel(a, b) for a, b in zip(bad, plain))
    rel = [_rel(a, b) for a, b in zip(kern, plain)]
    return {"rid": req.rid, "prompt": len(req.prompt),
            "dtype": _dname(getattr(torch, cfg.dtype)),
            "max_rel_diff": max(rel), "per_step": rel,
            "controls": controls, "positions": len(rel)}, plain


def attention_phases() -> tuple:
    """Both attention kernels against their plain versions at the main
    path's shapes and beside them; returns (flash instances, the one the
    kernel line reports, decode instances, likewise)."""
    log("== flash-attention kernel vs plain PyTorch version on the card")
    reqs = serving_requests(get_config(ARCH).vocab)
    prompt_lens = sorted({len(r.prompt) for r in reqs})
    flash = [check_flash("served prefill", 1, n, n, 16, 16, 64,
                         torch.bfloat16) for n in prompt_lens]
    flash_main = flash[-1]              # the longest prompt of the main path
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32:
            for n in (prompt_lens[0], prompt_lens[-1]):
                flash.append(check_flash("served prefill", 1, n, n, 16, 16,
                                         64, dt))
        flash.append(check_flash("ragged", 1, 1000, 1000, 16, 16, 64, dt))
        flash.append(check_flash("llama GQA", 1, 1024, 1024, 24, 8, 128, dt))
        flash.append(check_flash("MQA", 1, 1024, 1024, 8, 1, 64, dt))
        flash.append(check_flash("window 256", 1, 1024, 1024, 16, 16, 64, dt,
                                 window=256))
        flash.append(check_flash("Sq<Sk", 1, 128, 512, 8, 8, 128, dt))
    log("== flash-decode kernel vs plain PyTorch version on the card")
    mid = [len(r.prompt) + NEW_TOKENS // 2 for r in reqs[:LANES]]
    edge = [0, 1, 255, 256, MAX_LEN - 1, MAX_LEN, MAX_LEN + 40, 1000]
    decode = [check_decode("served decode", mid, MAX_LEN, 16, 16, 64,
                           torch.bfloat16)]
    decode_main = decode[0]
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32:
            decode.append(check_decode("served decode", mid, MAX_LEN, 16, 16,
                                       64, dt))
        decode.append(check_decode("edge lengths", edge, MAX_LEN, 16, 16, 64,
                                   dt))
        decode.append(check_decode("llama GQA", mid, MAX_LEN, 24, 8, 128, dt))
        decode.append(check_decode("MQA", mid, MAX_LEN, 8, 1, 64, dt))
    return flash, flash_main, decode, decode_main


def serving_phases() -> dict:
    """The serving main path at full size, its traced decode steps and the
    logits check; returns what they measured, launch counts included."""
    cfg = get_config(ARCH)
    reqs = serving_requests(cfg.vocab)
    log(f"== serving: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
        f"head_dim {cfg.head_dim}, vocab {cfg.vocab}, {cfg.dtype}; "
        f"{LANES} lanes x {MAX_LEN}, {N_REQUESTS} requests, prompts "
        f"{PROMPT_LO}-{PROMPT_HI}, {NEW_TOKENS} new tokens, seed {SEED}")
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=DEV).manual_seed(SEED),
                         cfg, DEV)
    eng = ServeEngine(params, cfg, n_lanes=LANES, max_len=MAX_LEN,
                      device=DEV)
    del params
    n_params = _numel(eng.params)
    torch.cuda.synchronize()
    log(f"  weights: {n_params} parameters, init + bf16 copy "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    flash_ops.reset_launches()
    decode_ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    serve_wall = time.perf_counter() - t0
    serve_launches = {"flash_attention": flash_ops.launches,
                      "decode_attention": decode_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)
    log(f"  launches: {serve_launches}")
    for name, n in serve_launches.items():
        if n <= 0:
            raise AssertionError(f"the serving path launched {name} no time")
    if len(done) != N_REQUESTS or any(
            len(r.out_tokens) != NEW_TOKENS
            or not all(0 <= t < cfg.vocab for t in r.out_tokens)
            for r in reqs):
        raise AssertionError("the engine did not serve every request")
    prefill_tps = st["prefill_tokens"] / st["prefill_s"]
    step_ms = st["decode_s"] / st["decode_steps"] * 1e3
    decode_tps = st["decode_tokens"] / st["decode_s"]
    serving = {"wall_s": serve_wall, "prefill_s": st["prefill_s"],
               "prefill_tokens": st["prefill_tokens"],
               "prefill_tok_per_s": prefill_tps,
               "decode_s": st["decode_s"], "decode_steps": st["decode_steps"],
               "decode_tokens": st["decode_tokens"],
               "decode_ms_per_step": step_ms, "decode_tok_per_s": decode_tps,
               "peak_mem_bytes": peak, "launches": serve_launches}
    log(f"  engine wall {serve_wall:.6f} s; prefill {st['prefill_tokens']} "
        f"tokens in {st['prefill_s']:.6f} s ({prefill_tps:.1f} tok/s); "
        f"decode {st['decode_steps']} steps, {st['decode_tokens']} tokens "
        f"in {st['decode_s']:.6f} s ({step_ms:.4f} ms/step, "
        f"{decode_tps:.1f} tok/s); peak memory {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    log(f"  request 0: {len(reqs[0].prompt)} prompt tokens -> "
        f"{reqs[0].out_tokens[:8]}...")

    # a traced rerun of decode steps: the device's idle share
    log(f"== traced decode: {LANES} lanes admitted, {TRACED_STEPS} steps "
        f"(torch.profiler)")
    for r in serving_requests(cfg.vocab)[:LANES]:
        r.max_new_tokens = TRACED_STEPS + 2
        eng.try_admit(r)
    before = eng.stats["decode_s"]
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        for _ in range(TRACED_STEPS):
            eng.step()
    traced_wall = eng.stats["decode_s"] - before
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if on_dev:
        busy = sum(e.time_range.elapsed_us() for e in on_dev) / 1e6
        by_name: dict = {}
        for e in on_dev:
            key = ("flash_fwd" if "flash_fwd" in e.name else
                   "decode_partial" if "decode_partial" in e.name else
                   "decode_combine" if "decode_combine" in e.name else
                   "gemm" if "gemm" in e.name.lower() else "other")
            by_name[key] = by_name.get(key, 0.0) + \
                e.time_range.elapsed_us() / 1e6
        serving["traced_idle_share"] = 1 - busy / traced_wall
        serving["traced_busy_s"] = busy
        serving["traced_wall_s"] = traced_wall
        serving["traced_device_s_by_kind"] = by_name
        log(f"  {len(on_dev)} device events ({len(on_dev) / TRACED_STEPS:.1f}"
            f" per step); device busy {busy:.6f} s of {traced_wall:.6f} s "
            f"(idle share {1 - busy / traced_wall:.4f}); by kind (s): "
            f"{json.dumps(by_name)}")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")
    while any(a is not None for a in eng.active):
        eng.step()

    # served logits: kernels against plain versions, in bf16 (the served
    # type) and in f32 (the same weights), each beside its controls; the
    # engine's tokens against the plain versions' logits
    cfg32 = cfg.replace(dtype="float32")
    params32 = init_params(torch.Generator(device=DEV).manual_seed(SEED),
                           cfg32, DEV)
    checks, plain_bf16 = [], []
    for p, c in ((eng.params, cfg), (params32, cfg32)):
        dt = getattr(torch, c.dtype)
        log(f"== logits of {CHECK_REQUESTS} requests fed their served "
            f"tokens, {c.dtype}: kernels vs plain versions, prefill + "
            f"{CHECK_STEPS} decode steps (tol {LOGIT_TOL[dt]:g} of the "
            f"largest |logit|), and the controls")
        for r in reqs[:CHECK_REQUESTS]:
            chk, plain = check_logits(p, c, r)
            checks.append(chk)
            if dt == torch.bfloat16:
                plain_bf16.append(plain)
            log(f"  request {chk['rid']} ({chk['prompt']} prompt tokens): "
                f"max rel diff {chk['max_rel_diff']:.3e}; per position "
                f"{[f'{x:.2e}' for x in chk['per_step']]}; controls "
                f"{json.dumps(chk['controls'])}")
            if not chk["max_rel_diff"] <= LOGIT_TOL[dt]:
                raise AssertionError(
                    f"request {chk['rid']} ({c.dtype}): logits through the "
                    f"kernels differ from the plain versions' by "
                    f"{chk['max_rel_diff']:.3e}")
            if dt == torch.float32:
                for name, x in chk["controls"].items():
                    if not x > LOGIT_TOL[dt]:
                        raise AssertionError(
                            f"control {name} reads {x:.3e}, inside the f32 "
                            f"gate: the check cannot tell that kernel fault")
    log(f"== served tokens against the plain versions' bf16 logits (a "
        f"token may sit at most {TOKEN_GAP:g} of the largest |logit| below "
        f"the maximum); control: the other request's tokens")
    tokens = []
    for i, r in enumerate(reqs[:CHECK_REQUESTS]):
        own = r.out_tokens[:CHECK_STEPS + 1]
        other = reqs[(i + 1) % CHECK_REQUESTS].out_tokens[:CHECK_STEPS + 1]
        gaps = _gaps(plain_bf16[i], own)
        swapped_gaps = _gaps(plain_bf16[i], other)
        exact = sum(g == 0.0 for g in gaps)
        tokens.append({"rid": r.rid, "max_gap": max(gaps), "gaps": gaps,
                       "argmax_agree": exact, "positions": len(gaps),
                       "other_request_max_gap": max(swapped_gaps)})
        log(f"  request {r.rid}: served tokens {own}; max gap "
            f"{max(gaps):.3e}, argmax of the plain logits at {exact} of "
            f"{len(gaps)} positions; request "
            f"{reqs[(i + 1) % CHECK_REQUESTS].rid}'s tokens here: max gap "
            f"{max(swapped_gaps):.3e}")
        if not max(gaps) <= TOKEN_GAP:
            raise AssertionError(f"request {r.rid}: a served token sits "
                                 f"{max(gaps):.3e} below the plain maximum")
    serving["served_tokens"] = tokens
    serving["logit_checks"] = checks
    return serving


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device 0: {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ----------------------------------------------------------
    log("== build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    infos = _build.build_all()
    log(f"  build wall {time.perf_counter() - t0:.2f} s")
    for info in infos:
        log(f"  {info.name}: {'built' if info.built else 'cached'} "
            f"in {info.seconds:.2f} s -> {info.path.name}")
        for line in info.ptxas.splitlines():
            log(f"    {line}")

    # -- 2. each kernel against its plain version --------------------------
    log("== sinkhorn kernel vs plain PyTorch version on the card")
    rng = np.random.default_rng(SEED)
    f32 = []
    for n in (64, 250, 256, 512, 1024):
        m = torch.from_numpy(rng.random((n, n)) + 0.01).to(
            "cuda", torch.float32)
        f32.append(check_kernel(m, iters=20, eps=1e-12, reps=50,
                                plain_reps=10))
    f64 = []
    for n in (250, 256):
        m = torch.from_numpy(saturate_input(n, 0.3)).to("cuda")
        f64.append(check_kernel(m, iters=200, eps=0.0, reps=20,
                                plain_reps=5))
    main_shape = f64[-1]                    # n = 256, iters 200: saturate
    log("  no single PyTorch call computes Sinkhorn: library time n/a")

    # -- 3. the main path at full size --------------------------------------
    log(f"== main path: n={N}, d_hat={D_HAT}, k={K}, loads {LOADS}, "
        f"{HORIZON} slots, seed {SEED}")
    sinkhorn_ops.reset_launches()
    phases = {}
    t0 = time.perf_counter()
    wls = [websearch_workload(N, load, HORIZON, BITS_PER_SLOT, d_hat=D_HAT,
                              seed=SEED) for load in LOADS]
    phases["workloads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheds = [vermilion_schedule(wl.demand_matrix(), k=K, d_hat=D_HAT,
                                 recfg_frac=RECFG, normalize="saturate")
              for wl in wls]
    phases["schedules_s"] = time.perf_counter() - t0
    cases = [SweepCase(s, wl, "single_hop", f"vermilion@{load}",
                       {"load": load})
             for s, wl, load in zip(scheds, wls, LOADS)]
    timings: dict = {}
    t0 = time.perf_counter()
    rows = run_sweep(cases, BITS_PER_SLOT, device="cuda", sanitize=True,
                     timings=timings)
    phases["sweep_s"] = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    flows = sum(wl.num_flows for wl in wls)
    log(f"  flows {flows}, sinkhorn launches {launches}")
    if launches != len(LOADS):
        raise AssertionError(f"main path launched the sinkhorn kernel "
                             f"{launches} times (expected {len(LOADS)})")
    for r in rows:
        res = r.result
        fin = np.isfinite(res.fct_slots)
        if not fin.any() or not np.isfinite(res.utilization):
            raise AssertionError(f"{r.label}: no finite result")
        log(f"  {r.label}: util {res.utilization:.6f}, delivered "
            f"{res.delivered_bits:.6e} b of {res.offered_bits:.6e}, "
            f"completed {res.completed_frac:.6f}, FCT p50 "
            f"{res.fct_percentile(50):.3f} p99 {res.fct_percentile(99):.3f} "
            f"slots")
    per_slot_us = timings["device_loop_s"] / timings["slots"] * 1e6
    for key, val in {**phases, **timings}.items():
        log(f"  phase {key}: {val:.6f}" if key != "slots"
            else f"  slots served {val}")
    log(f"  device slot loop: {per_slot_us:.3f} us per slot")

    # -- 4. the card's result against the port's CPU run -------------------
    log("== card vs CPU on the same schedules")
    t0 = time.perf_counter()
    rows_cpu = run_sweep(cases, BITS_PER_SLOT, device="cpu", sanitize=True)
    log(f"  CPU sweep {time.perf_counter() - t0:.3f} s")
    for a, b in zip(rows, rows_cpu):
        ra, rb = a.result, b.result
        rel = abs(ra.delivered_bits - rb.delivered_bits) / rb.delivered_bits
        fa, fb = ra.fct_slots, rb.fct_slots
        differ = ~((fa == fb) | (np.isnan(fa) & np.isnan(fb)))
        n_diff = int(differ.sum())
        max_diff = float(np.abs(fa[differ] - fb[differ]).max()) \
            if n_diff else 0.0
        log(f"  {a.label}: delivered rel diff {rel:.3e}; FCTs differ on "
            f"{n_diff} of {len(fa)} flows, by at most {max_diff} slots")
        if rel > 1e-5:
            raise AssertionError(f"{a.label}: delivered bits differ by "
                                 f"{rel:.3e} (rtol 1e-5)")
        if n_diff > FCT_MAX_DIFF_FRAC * len(fa) \
                or max_diff > FCT_MAX_DIFF_SLOTS:
            raise AssertionError(f"{a.label}: FCTs differ on {n_diff} flows "
                                 f"by up to {max_diff} slots")
    t0 = time.perf_counter()
    scheds_cpu = [vermilion_schedule(wl.demand_matrix(), k=K, d_hat=D_HAT,
                                     recfg_frac=RECFG, normalize="saturate",
                                     device="cpu") for wl in wls]
    same = [bool(np.array_equal(a.perms, b.perms))
            for a, b in zip(scheds, scheds_cpu)]
    log(f"  schedules rebuilt on the CPU in "
        f"{time.perf_counter() - t0:.3f} s; perms equal to the card's: "
        f"{same}")

    # -- 5. a traced rerun: where the data plane's time goes on the card ---
    log("== traced rerun of the card sweep (torch.profiler)")
    traced: dict = {}
    t0 = time.perf_counter()
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        run_sweep(cases, BITS_PER_SLOT, device="cuda", timings=traced)
    traced_s = time.perf_counter() - t0
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in on_dev if e.name.startswith(("Memcpy", "Memset"))]
    kern = [e for e in on_dev if not e.name.startswith(("Memcpy", "Memset"))]
    log(f"  traced sweep {traced_s:.6f} s (untraced {phases['sweep_s']:.6f} "
        f"s); traced device loop {traced['device_loop_s']:.6f} s")
    if kern:
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
        copy = sum(e.time_range.elapsed_us() for e in copies) / 1e6
        log(f"  data plane: {len(kern)} kernels "
            f"({len(kern) / traced['slots']:.3f} per slot), device busy "
            f"{busy:.6f} s of the {traced['device_loop_s']:.6f} s loop "
            f"(idle share {1 - busy / traced['device_loop_s']:.4f}); "
            f"copies {copy:.6f} s")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")

    # -- 5b. the attention kernels; the serving path ------------------------
    flash, flash_main, decode, decode_main = attention_phases()
    serving = serving_phases()
    serve_launches = serving["launches"]

    # -- 6. results -----------------------------------------------------------
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(f"f32 instances: {json.dumps(f32)}")
    log(f"flash instances: {json.dumps(flash)}")
    log(f"decode instances: {json.dumps(decode)}")
    log(f"serving: {json.dumps(serving)}")
    kernels = [{
        "name": "sinkhorn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sinkhorn.cu",
        "replaces": "src/repro/kernels/sinkhorn/sinkhorn.py:39",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "dtype": main_shape["dtype"],
        "n": main_shape["n"],
        "iters": main_shape["iters"],
    }]
    # `launches` counts wrapper calls; a decode call is two CUDA launches
    # (split partials, combine), and `ms` is the device time of both
    for name, inst, replaces, per_call in (
            ("flash_attention", flash_main,
             "src/repro/kernels/flash_attention/flash_attention.py:59", 1),
            ("decode_attention", decode_main,
             "src/repro/kernels/decode_attention/decode_attention.py:58",
             2)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": serve_launches[name],
            **{k: inst[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "call_ms", "dtype", "shape")},
            "cuda_launches_per_call": per_call})
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
