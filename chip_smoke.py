#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from a checkout on a machine with an NVIDIA Hopper card and ``nvcc``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), holds each kernel against its
plain PyTorch version on the card, and drives the port's paths once at
full size, each with the kernels' launch counts set to 0 just before it
and read just after:

1. Vermilion schedules built with ``normalize="saturate"`` (Sinkhorn on
   the card, one CUDA launch a call, counted from a traced schedule), then
   a batched single-hop sweep whose data plane runs on the card, with
   per-flow FCTs from the host credit replay; the card's result is checked
   against the port's CPU run of the same schedules, and the card's
   schedules must equal the CPU's.  The
   deployment: n = 256 ToRs, d_hat = 8 uplinks, k = 3, recfg_frac = 1/9,
   100 Gb/s links with 4.5 us slots; websearch traffic (DCTCP CDF),
   rack-permutation, at loads 0.15 / 0.3 / 0.45 / 0.6, 2000 slots, seed 1.
1b. The adaptive control loop (``run_adaptive``, Appendix A closed:
   estimation each epoch, per-node schedules, a collision-resolved fabric
   plan, one data-plane run on the card for the whole batch, the host
   credit replay), every schedule ``normalize="saturate"`` through the
   Sinkhorn kernel.  Grid (a): the sweep's fabric under phase-shifting
   websearch traffic (permutation -> uniform -> dlrm every 2000 slots),
   load 0.5, 6000 slots in epochs of 500; oracle and stale (the phase
   train's rates), oblivious, adaptive at EWMA weights 0.1 / 0.3 / 0.5 /
   0.9, complete gathers.  Grid (b): ``run_disagreement``'s sizes (n = 16,
   d_hat = 4, epochs of 250), gathers of 15 / 8 / 4 / 2 steps under the
   drop / lowest / receiver arbiters, whose partial views put zero rows
   through the kernel.  Each grid runs with the sanitizer; its Sinkhorn
   launches must equal the saturate calls that ran, and its rows those of
   the port's CPU run of the same cases: the compiled control trajectory
   (``plan_digest``), counters and epoch arrays exactly, FCTs within the
   sweep's bar, utilization within rtol 1e-5; full gathers never
   disagree, 2-step gathers lose capacity.  A traced rerun of grid (a),
   without the host's credit replay, reads the slot loop's idle share and
   the kernel's device time.
2. Serving: ``ServeEngine`` with Qwen1.5-0.5B at full width and depth
   (24 layers, d_model 1024, 16 heads, vocab 151,936) on seeded random
   weights, bf16, 8 lanes of 2048 positions, 16 requests with prompts of
   128-1024 tokens and 32 new tokens each; prefill runs the flash-attention
   kernel, every decode step the flash-decode kernel.  Two requests are
   then rerun one at a time, fed the tokens the engine served them,
   through the kernels and through the plain versions, in bf16, and their
   logits compared at every step; in f32 the same, after a two-lane f32
   engine has served those two requests (its tokens are fed).  Two
   deliberately broken uses of the kernels are read the same way
   (controls: the f32 gate must sit between them and the kernels), and
   each token an engine served must be a near-argmax of the plain
   version's logits of its type.
3. Serving xLSTM-350M the same way at full width and depth (24 layers:
   21 mLSTM, sLSTM at 1, 9 and 17; d_model 1024, 4 heads of dim 512,
   vocab 50,304), on the same deployment and requests: every prefill runs
   the chunkwise mLSTM kernel once per mLSTM layer (16 x 21 = 336 launches),
   decode is the plain recurrence.  The logits check is Qwen's, with two
   broken uses of the mLSTM kernel as controls (the prompt's final state
   not handed to decode; q's 1/sqrt(dh) scale left out); its bf16 logits
   and tokens are read, not gated (see ``SERVED``), and the f32 checks,
   the two-lane engine's included, are its gates.

4. Serving Jamba-1.5-Large cut to what one card holds (``jamba-1.5-large``:
   one supercell of 8 layers at full width, d_model 8192, 64 / 8 heads of
   128, 7 Mamba layers of d_inner 16384 and d_state 16, 4 MoE FFNs holding
   experts 0-7 of 16 with the router whole, 4 dense FFNs, vocab 65,536;
   25.8 B parameters drawn straight into bf16) on the same deployment and
   requests: every prefill runs the selective-scan kernel once per Mamba
   layer (16 x 7 = 112 launches) and the flash kernel once, every decode
   step the flash-decode kernel once.  The logits check is xLSTM's, with
   two broken uses of the scan kernel as controls (C left out of y; B left
   out of the input), its f32 weights holding 2 of the 16
   experts so that they fit the card.

Before the serving paths each kernel is held against its plain version at
the main path's shapes and beside them (Sinkhorn also bit for bit against
``sinkhorn_kernel_order``, the model of its cluster path's order, in f32
at 20 and f64 at 200 iterations: n of 1 and 17, around its tile of 16
rows and 32 columns, the largest n the one-cluster path takes and one past
it, which takes two passes a round, iters 0 and 1 on both paths, the clamp
and a NaN entry; the attention kernels at Qwen's
and Jamba's head shapes and at the bf16 kernels' tile edges: Sq = Sk of
63-255 around the 64-row query and 64- and 128-key tiles, ragged Sq < Sk,
a window edge inside key tiles, rep 1, 3, 8 and 32, decode lengths of
none, one key, a split-share boundary and S - 1 to past S; each twice,
bitwise; the mLSTM kernel in f32 with its states: the
served prefills from a fresh state, a carried nonzero state, S <= 256, S a
multiple of 256, ragged S, head dims 32-512, S at a 64-position chunk and
one past it, more chunks than the kernel's workspace holds (two and three
windows of 16), 65 chunks, q, k, v off a 16-byte boundary; the scan
kernel on y and the final state: the served prefills, a carried nonzero
state, S = 1, ragged S, bf16 and f32 inputs, B 2 at a narrow D, d_state
8, S at a lane's 16 positions and a 64-position tile and one past each,
an odd D).

Any failure raises: no phase is caught.

Output: readable lines, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a card or outside a checkout.
"""
from __future__ import annotations

import contextlib
import functools
import gc
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
from repro_torch.core import schedule as schedule_mod  # noqa: E402
from repro_torch.core import simulator as sim_mod  # noqa: E402
from repro_torch.core import traffic as traffic_mod  # noqa: E402
from repro_torch.core.estimation import (  # noqa: E402
    TrafficEstimator,
    estimate_all_views,
)
from repro_torch.core.schedule import vermilion_schedule  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    AdaptiveCase,
    SweepCase,
    phase_shifting_workload,
    run_adaptive,
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
from repro_torch.kernels.mamba_scan import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref  # noqa: E402
from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops  # noqa: E402
from repro_torch.kernels.sinkhorn.ref import (  # noqa: E402
    sinkhorn_kernel_order,
    sinkhorn_ref,
)
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
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

# the adaptive loop, grid (a): the sweep's fabric in closed loop under
# phase-shifting traffic (permutation -> uniform -> dlrm every 2000 slots,
# benchmarks/adaptive_bench.py's phase train) at load 0.5, 6000 slots in
# epochs of 500; oracle and stale from the phase train's rates,
# oblivious, and the adaptive loop at four EWMA weights, all with a
# complete gather, every schedule Sinkhorn-saturated
ADAPTIVE_LOAD, ADAPTIVE_HORIZON, ADAPTIVE_SHIFT = 0.5, 6000, 2000
ADAPTIVE_EPOCH = 500
ADAPTIVE_PHASES = ("permutation", "uniform", "dlrm")
ADAPTIVE_ALPHAS = (0.1, 0.3, 0.5, 0.9)
# grid (b): run_disagreement's sizes (adaptive_bench.py), every partial
# gather under the three static arbiters, saturated: zero rows of the
# partial views go through the kernel
DISAGREE_N, DISAGREE_D_HAT, DISAGREE_EPOCH = 16, 4, 250
DISAGREE_STEPS = (15, 8, 4, 2)
DISAGREE_COLLISIONS = ("drop", "lowest", "receiver")
# card vs CPU utilization, whole run and per epoch
UTIL_RTOL = 1e-5
SHORT_FLOW_BITS = 100e3 * 8          # flows up to 100 KB

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
# the gate of its type: the engine's logits and the plain ones each lie
# within that gate of the kernel path's

# the second served model: xLSTM-350M at full width and depth, on the same
# deployment and requests (src/repro/configs/xlstm_350m.py)
XLSTM_ARCH = "xlstm-350m"

# mLSTM kernel vs plain, f32, on the outputs and the final states: the
# kernel's chunks are 64 positions, the plain version's 256, so its sums
# and exponent arguments are grouped differently (|diff| <= atol + rtol
# |plain|)
MLSTM_TOL = (1e-4, 1e-4)

# the third served model: Jamba-1.5-Large cut to what one card holds, one
# supercell (1 attention, 7 Mamba layers, 4 MoE and 4 dense FFNs) at full
# width with experts 0-7 of its 16 (src/repro_torch/configs/
# jamba_1_5_large.py, SERVED and REDUCED), on the same deployment and
# requests; its f32 checks hold 2 of the 16 experts, so that the f32
# weights (42.1 GiB) fit the card
JAMBA_ARCH = "jamba-1.5-large"
JAMBA_F32_HELD = 2

# H100 SXM's special-function units: 16 ex2 a clock on each of 132 SMs at
# the 1.98 GHz boost clock (CUDA C programming guide, compute capability
# 9.0, arithmetic instructions): the selective scan's exponentials have this
# floor of their own beside its bound
SFU_EX2_PER_S = 16 * 132 * 1.98e9

# selective-scan kernel vs plain, f32, on y and the final state: the
# tolerance of the reference's own test of the Pallas kernel
# (tests/test_kernels.py); the two differ by FMA contraction and the order
# of the sum over the 16 states (|diff| <= atol + rtol |plain|)
MAMBA_TOL = (1e-4, 1e-4)


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


def partial_view_input(n: int) -> np.ndarray:
    """What ``saturate`` hands the kernel from a 2-step gather's view in
    the adaptive loop (grid (b)'s n): n - 3 of its rows all zero, clamped
    to 1e-12."""
    period = np.random.default_rng(SEED).gamma(0.6, 1e8, size=(n, n))
    np.fill_diagonal(period, 0.0)
    views = estimate_all_views(period, TrafficEstimator.fleet(n, alpha=0.5),
                               K, BITS_PER_SLOT, steps=2)
    m = views.view(n // 2)
    return np.where(m <= 0, 1e-12, m)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, a NaN matching a NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def check_sinkhorn(label: str, m: torch.Tensor, iters: int, eps: float,
                   reps: int) -> dict:
    """The Sinkhorn kernel against its plain version on one input (within
    :data:`TOL`, NaN where it has NaN) and, on the cluster path, against
    ``sinkhorn_kernel_order`` (the CPU model of its order) bit for bit;
    two calls bitwise; the kernel timed on the card alone
    (:func:`device_ms`) and with the host's share (:func:`time_ms`), the
    plain version on the card alone."""
    n, dtype = m.shape[0], m.dtype
    var, cluster, threads = sinkhorn_ops.plan(n, dtype)
    got = sinkhorn_ops.sinkhorn_kernel(m, iters=iters, eps=eps)
    again = sinkhorn_ops.sinkhorn_kernel(m, iters=iters, eps=eps)
    torch.cuda.synchronize()
    want = sinkhorn_ref(m, iters=iters, eps=eps)
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    rtol, atol = TOL[dtype]
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want[fin].abs()).max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want[fin].abs()).all()) and \
        torch.equal(torch.isnan(got), torch.isnan(want))
    same = _same_bits(got, again)
    bits = (_same_bits(got.cpu(), sinkhorn_kernel_order(
        m.cpu(), iters, eps, cluster)) if var == "cluster" else None)
    call = lambda: sinkhorn_ops.sinkhorn_kernel(m, iters, eps)  # noqa: E731
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: sinkhorn_ref(m, iters, eps), 1, warm=1,
                         replays=1)
    bound_ms, bound_by = sinkhorn_bound_ms(n, iters, dtype)
    name = _dname(dtype)
    log(f"  {label:22s} {name:8s} n={n:5d} iters={iters:3d} {var} "
        f"(C {cluster}, {threads} threads): max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} (rtol {rtol:g}, atol {atol:g}) "
        f"{'ok' if ok else 'FAIL'}; bits equal to the kernel-order model: "
        f"{bits}; deterministic={same}; kernel {ms:.4f} ms (with the host "
        f"{call_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}), x bound {ms / bound_ms:.1f}")
    if not ok:
        raise AssertionError(f"sinkhorn kernel disagrees with its plain "
                             f"version: {label} {name} n={n}")
    if bits is False:
        raise AssertionError(f"sinkhorn kernel's bits differ from "
                             f"sinkhorn_kernel_order: {label} {name} n={n}")
    if not same:
        raise AssertionError(f"sinkhorn kernel is not deterministic: "
                             f"{label} {name} n={n}")
    return {"label": label, "dtype": name, "n": n, "shape": [n, n],
            "iters": iters, "variant": var, "cluster": cluster,
            "threads": threads, "max_abs_err": max_abs,
            "max_rel_err": max_rel, "bitwise_vs_model": bits, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "x_bound": ms / bound_ms}


def sinkhorn_phases() -> tuple:
    """The Sinkhorn kernel against its plain version and its order's model
    at the main path's instance (f64, n = 256, 200 iterations, the
    saturate input) and beside it: a 2-step gather's view (zero rows
    clamped) at grid (b)'s n; f32 at 20 iterations, n from 1 to 1024;
    the largest n the cluster path takes and one past it (two passes) in
    both types; iters 0 and 1 on both paths; the clamp; a NaN entry.
    Returns (instances, the main path's)."""
    log("== sinkhorn kernel vs plain PyTorch version on the card")
    f32, f64 = torch.float32, torch.float64
    top = {d: sinkhorn_ops.max_cluster_n(d) for d in (f32, f64)}
    log(f"  cluster size {sinkhorn_ops.cluster_size()}; the cluster path "
        f"takes n <= {top[f32]} (f32), <= {top[f64]} (f64), larger n two "
        f"passes a round")
    rng = np.random.default_rng(SEED)

    def rand(n: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(rng.random((n, n)) + 0.01).to(DEV, dtype)

    inst = []
    for n in (64, 250, 256, 512, 1024, 1, 17, top[f32], top[f32] + 1):
        inst.append(check_sinkhorn("random", rand(n, f32), 20, 1e-12,
                                   reps=50 if n <= top[f32] else 10))
    for n in (250, 256):
        m = torch.from_numpy(saturate_input(n, 0.3)).to(DEV)
        inst.append(check_sinkhorn("saturate input", m, 200, 0.0, reps=20))
    main = inst[-1]                         # n = 256, iters 200: saturate
    inst.append(check_sinkhorn("partial view", torch.from_numpy(
        partial_view_input(DISAGREE_N)).to(DEV), 200, 0.0, reps=20))
    for n in (1, 17, top[f64], top[f64] + 1):
        inst.append(check_sinkhorn("random", rand(n, f64), 200, 0.0,
                                   reps=20 if n <= top[f64] else 3))
    for n in (250, top[f64] + 1):           # both paths
        for iters in (0, 1):
            inst.append(check_sinkhorn(f"iters {iters}", rand(n, f64), iters,
                                       0.0, reps=10))
    z = torch.zeros(40, 40, device=DEV)
    z[:5] = rand(40, f32)[:5]
    z[7, 3] = -2.0
    inst.append(check_sinkhorn("clamp at 0.25", z, 3, 0.25, reps=10))
    for n, dtype in ((64, f64), (top[f32] + 1, f32)):
        m = rand(n, dtype)
        m[7, 9] = float("nan")
        inst.append(check_sinkhorn("a NaN entry", m, 5, 0.0, reps=5))
    paths = {v: sum(i["variant"] == v for i in inst)
             for v in ("cluster", "two_pass")}
    log(f"  instances by path: {json.dumps(paths)}")
    log("  no single PyTorch call computes Sinkhorn: library time n/a")
    return inst, main


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
    again = flash_ops.attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal, window=window)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol = ATTN_TOL[dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    same = bool(torch.equal(got, again))
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
        f"deterministic={same}; "
        f"kernel {ms:.4f} ms (with the host {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}); x bound {ms / bound_ms:.1f}, "
        f"x sdpa {ms / library_ms:.2f}")
    if not ok:
        raise AssertionError(f"flash-attention kernel disagrees with its "
                             f"plain version: {label} {_dname(dtype)}")
    if not same:
        raise AssertionError(f"flash-attention kernel is not deterministic: "
                             f"{label} {_dname(dtype)}")
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
        f"{bound_ms:.6f} ms ({bound_by}); x bound {ms / bound_ms:.1f}, "
        f"x sdpa {ms / library_ms:.2f}")
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


def mlstm_bound_ms(b: int, s: int, h: int, dh: int) -> tuple:
    """(least ms for the mLSTM's work on this card, "bytes" | "operations"):
    inputs (q, k, v, gates, state) read once and outputs (out, state)
    written once, over HBM rate; against the least operations the function
    needs, those of its recurrent form: per position and head, C's update
    (k^T v) and q C, dh^2 multiply-adds each, and n's update and q . n, dh
    each, over the f32 peak of the CUDA cores.  The chunkwise forms' causal
    q k^T and W v within a chunk are work a chunk size chooses, not work the
    function needs, and are not counted."""
    state = b * h * (dh * dh + dh + 1)
    t_bytes = 4 * (4 * b * s * h * dh + 2 * b * s * h + 2 * state) / HBM_BPS
    macs = b * s * h * (2 * dh * dh + 2 * dh)
    t_ops = 2 * macs / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mlstm_inputs(b: int, s: int, h: int, dh: int, state: str,
                 seed: int = SEED) -> tuple:
    """q, k, v, logi, logf at the scale of xLSTM-350M's projections on its
    random weights (std ~0.58), and a state: None, the serving path's fresh
    one (``init_mlstm_state``), or a nonzero one."""
    gen = torch.Generator(device=DEV).manual_seed(seed + s + dh)
    r = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                   device=DEV)
    q, k, v = r(b, s, h, dh) * 0.58, r(b, s, h, dh) * 0.58, \
        r(b, s, h, dh) * 0.58
    li, lf = r(b, s, h) * 0.58, F.logsigmoid(r(b, s, h) * 0.58)
    if state == "fresh":
        st = (torch.zeros(b, h, dh, dh, device=DEV),
              torch.zeros(b, h, dh, device=DEV),
              torch.full((b, h), -1e9, device=DEV))
    elif state == "carried":
        st = (r(b, h, dh, dh) * 0.1, r(b, h, dh) * 0.1, r(b, h))
    else:
        st = None
    return (q, k, v, li, lf), st


def _off_boundary(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view_as(t).copy_(t)


def check_mlstm(label: str, b: int, s: int, h: int, dh: int, state: str,
                reps: int = 5, misaligned: bool = False) -> dict:
    """The mLSTM kernel against its plain version on one input, outputs and
    final states (with ``misaligned``, q, k and v off a 16-byte boundary);
    checks two calls bitwise; times kernel and plain version on the card
    alone (:func:`device_ms`), and the kernel's calls with the host's share
    (:func:`time_ms`).  No single PyTorch call computes the mLSTM: no
    library time."""
    ins, st = mlstm_inputs(b, s, h, dh, state)
    if misaligned:
        ins = (*map(_off_boundary, ins[:3]), *ins[3:])
    out, fin = mlstm_ops.mlstm_kernel(*ins, st)
    again, again_fin = mlstm_ops.mlstm_kernel(*ins, st)
    torch.cuda.synchronize()
    want, want_fin = mlstm_chunkwise_ref(*ins, st)
    rtol, atol = MLSTM_TOL
    errs, ok = [], True
    for got, w in zip((out, *fin), (want, *want_fin)):
        diff = (got - w).abs()
        errs.append(float(diff.max()))
        ok &= bool((diff <= atol + rtol * w.abs()).all())
    same = all(torch.equal(a, w) for a, w in zip((out, *fin),
                                                   (again, *again_fin)))
    call = lambda: mlstm_ops.mlstm_kernel(*ins, st)  # noqa: E731
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: mlstm_chunkwise_ref(*ins, st), 2)
    bound_ms, bound_by = mlstm_bound_ms(b, s, h, dh)
    log(f"  {label:16s} float32  B={b} S={s} H={h} dh={dh} state={state}: "
        f"max_abs_err out {errs[0]:.3e}, C {errs[1]:.3e}, n {errs[2]:.3e}, "
        f"m {errs[3]:.3e} (rtol {rtol:g}, atol {atol:g}) "
        f"{'ok' if ok else 'FAIL'}; deterministic={same}; kernel {ms:.4f} ms "
        f"(with the host {call_ms:.4f}), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"mLSTM kernel disagrees with its plain "
                             f"version: {label} S={s} dh={dh} {state}")
    if not same:
        raise AssertionError(f"mLSTM kernel is not deterministic: {label}")
    return {"label": label, "dtype": "float32", "shape": [b, s, h, dh],
            "state": state, "max_abs_err": max(errs),
            "max_abs_err_out_c_n_m": errs, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}


def mamba_bound_ms(b: int, s: int, d: int, n: int, u_bytes: int,
                   with_h0: bool) -> tuple:
    """(least ms for the selective scan's work on this card, "bytes" |
    "operations"): inputs (dt, a, B, C, u, and h0 when one is given) read
    once and outputs (y f32, h_last f32) written once, over HBM rate;
    against its f32 operations over the CUDA cores' f32 peak: per
    (position, channel, state) one exponential (counted as one operation),
    dt a, the input product, the state's multiply-add and the output's
    multiply-add (7), and per (position, state) dt B (1)."""
    ins = 4 * (b * s + d * n + 2 * b * s * n) + u_bytes * b * s * d
    if with_h0:
        ins += 4 * b * d * n
    outs = 4 * (b * s * d + b * d * n)
    t_bytes = (ins + outs) / HBM_BPS
    t_ops = (7 * b * s * d * n + b * s * n) / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mamba_inputs(b: int, s: int, d: int, n: int, u_dtype: torch.dtype,
                 state: str, seed: int = SEED) -> tuple:
    """dt, a, B, C, u at the scale of Jamba's Mamba layers on its random
    weights (dt = softplus(~0.5), a = -(1..N), unit B, C, u), and a state:
    the serving path's fresh one (zeros, as a prefill from a new lane
    passes it), a nonzero one, or None."""
    gen = torch.Generator(device=DEV).manual_seed(seed + s + d + n)
    r = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                   device=DEV)
    dt = F.softplus(0.5 + 0.1 * r(b, s))
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=DEV).expand(d, n).contiguous()
    bmat, cmat, u = r(b, s, n), r(b, s, n), r(b, s, d).to(u_dtype)
    h0 = {"fresh": torch.zeros(b, d, n, device=DEV),
          "carried": r(b, d, n)}.get(state)
    return dt, a, bmat, cmat, u, h0


def check_mamba(label: str, b: int, s: int, d: int, n: int,
                u_dtype: torch.dtype, state: str, reps: int = 10) -> dict:
    """The selective-scan kernel against its plain version on one input, y
    and the final state; checks two calls bitwise; times kernel and plain
    version on the card alone (:func:`device_ms`), and the kernel's calls
    with the host's share (:func:`time_ms`).  No single PyTorch call
    computes a selective scan: no library time."""
    ins = mamba_inputs(b, s, d, n, u_dtype, state)
    y, h = mamba_ops.selective_scan_kernel(*ins)
    again, again_h = mamba_ops.selective_scan_kernel(*ins)
    torch.cuda.synchronize()
    want_y, want_h = selective_scan_ref(*ins)
    rtol, atol = MAMBA_TOL
    errs, ok = [], True
    for got, w in ((y, want_y), (h, want_h)):
        diff = (got - w).abs()
        errs.append(float(diff.max()))
        ok &= bool((diff <= atol + rtol * w.abs()).all())
    same = torch.equal(y, again) and torch.equal(h, again_h)
    call = lambda: mamba_ops.selective_scan_kernel(*ins)  # noqa: E731
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: selective_scan_ref(*ins), 1, warm=1,
                         replays=1)
    bound_ms, bound_by = mamba_bound_ms(b, s, d, n, ins[4].element_size(),
                                        ins[5] is not None)
    sfu_ms = b * s * d * n / SFU_EX2_PER_S * 1e3
    log(f"  {label:16s} u {_dname(u_dtype):8s} B={b} S={s} D={d} N={n} "
        f"state={state}: max_abs_err y {errs[0]:.3e}, h_last {errs[1]:.3e} "
        f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}; "
        f"deterministic={same}; kernel {ms:.4f} ms (with the host "
        f"{call_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}), x bound {ms / bound_ms:.1f}; the exponentials' SFU "
        f"floor {sfu_ms:.6f} ms")
    if not ok:
        raise AssertionError(f"mamba_scan kernel disagrees with its plain "
                             f"version: {label} S={s} D={d} {state}")
    if not same:
        raise AssertionError(f"mamba_scan kernel is not deterministic: "
                             f"{label}")
    return {"label": label, "dtype": "float32", "u_dtype": _dname(u_dtype),
            "shape": [b, s, d, n], "state": state, "max_abs_err": max(errs),
            "max_abs_err_y_h": errs, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "x_bound": ms / bound_ms,
            "deterministic": same}


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


# keys the decode control leaves out (a split's worth of the first version)
DROPPED_KEYS = 256


def decode_split_dropped(q, k, v, length):
    """Control: the decode kernel with the first DROPPED_KEYS cache keys
    left out, what a combine that lost one partial would return."""
    s = DROPPED_KEYS
    ln = decode_ops.lengths_vector(length, q.shape[0], q.device) - s
    return decode_ops.decode_kernel(q, k[:, s:], v[:, s:], ln)


def flash_unscaled(q, k, v, causal=True, window=0):
    """Control: the flash kernel with the 1/sqrt(dh) softmax scale left
    out."""
    return flash_ops.attention_kernel(q * q.shape[-1] ** 0.5, k, v, causal,
                                      window)


def mlstm_unscaled(q, k, v, logi, logf, state=None):
    """Control: the mLSTM kernel with the 1/sqrt(dh) scale of q left
    out."""
    return mlstm_ops.mlstm_kernel(q * q.shape[-1] ** 0.5, k, v, logi, logf,
                                  state)


def mlstm_state_lost(q, k, v, logi, logf, state=None):
    """Control: the mLSTM kernel's outputs, but the state it was given
    handed on in place of its final state (decode starts from the lane's
    fresh state)."""
    out, _ = mlstm_ops.mlstm_kernel(q, k, v, logi, logf, state)
    return out, state


def mamba_c_ignored(dt, a, bmat, cmat, u, h0=None):
    """Control: the scan kernel with C left out of the output,
    y = sum_n h."""
    return mamba_ops.selective_scan_kernel(dt, a, bmat,
                                           torch.ones_like(cmat), u, h0)


def mamba_b_ignored(dt, a, bmat, cmat, u, h0=None):
    """Control: the scan kernel with B left out of the input,
    b_bar = dt u."""
    return mamba_ops.selective_scan_kernel(dt, a, torch.ones_like(bmat), cmat,
                                           u, h0)


# the controls: module, wrapper name, the broken use of the kernel
CONTROLS = {"decode_split_dropped": (decode_ops, "decode_attn",
                                     decode_split_dropped),
            "flash_unscaled": (flash_ops, "attention", flash_unscaled)}
MLSTM_CONTROLS = {"mlstm_state_lost": (mlstm_ops, "mlstm", mlstm_state_lost),
                  "mlstm_unscaled": (mlstm_ops, "mlstm", mlstm_unscaled)}
MAMBA_CONTROLS = {"mamba_c_ignored": (mamba_ops, "selective_scan",
                                      mamba_c_ignored),
                  "mamba_b_ignored": (mamba_ops, "selective_scan",
                                      mamba_b_ignored)}

# xLSTM-350M in bf16 on random weights turns any change in the mLSTM's f32
# rounding into a large change of the logits (on an H100, ~0.11 of the
# largest logit where the f32 logits move by ~3e-5, and as much from the
# plain version run in f64): its bf16 logits and served tokens are read,
# held to no gate.  Its f32 logits, and the logits and tokens of a
# two-lane f32 engine, carry the gates, as they do for Qwen.  Jamba's
# likewise: a bf16 rounding flipped by an f32 reordering can flip a top-2
# expert choice of its router.

# the served models: the wrappers of their kernels (whose launches the
# serving run counts), the broken uses the logits check reads as controls,
# and whether the bf16 logits and tokens are gated (else read)
SERVED = {ARCH: ({"flash_attention": flash_ops,
                  "decode_attention": decode_ops}, CONTROLS, True),
          XLSTM_ARCH: ({"mlstm": mlstm_ops}, MLSTM_CONTROLS, False),
          JAMBA_ARCH: ({"mamba_scan": mamba_ops,
                        "flash_attention": flash_ops,
                        "decode_attention": decode_ops}, MAMBA_CONTROLS,
                       False)}

# the __global__ functions each wrapper launches, by a part of their names
KERNEL_EVENTS = {"sinkhorn": ("sinkhorn_",),
                 "flash_attention": ("flash_fwd",),
                 "decode_attention": ("decode_partial", "decode_combine"),
                 "mlstm": ("mlstm_",), "mamba_scan": ("mamba_scan_fwd",)}


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


def engine_logits(p, cfg, reqs: list) -> list:
    """Serve ``reqs`` on an engine of one lane each (all admitted at once,
    request i in lane i), recording the logits (f32, (V,)) the engine
    computed for each: its prefill's, then its lane's at each decode step
    while it is active."""
    eng = ServeEngine(p, cfg, n_lanes=len(reqs), max_len=MAX_LEN, device=DEV)
    seen: list = []

    def rec(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            seen.append(out[0].float())
            return out
        return call

    with swapped(M, "prefill", rec(M.prefill)), \
            swapped(M, "decode_step", rec(M.decode_step)):
        eng.run(reqs)
    n = len(reqs)
    return [[seen[i][0]] + [lg[i] for lg in seen[n:n + len(r.out_tokens) - 1]]
            for i, r in enumerate(reqs)]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (at least 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _gaps(logits: list, tokens: list) -> list:
    """How far below the maximum each token's logit sits, over the largest
    |logit| (0 for the argmax)."""
    return [(float(lg.max()) - float(lg[t])) / max(1.0, float(lg.abs().max()))
            for lg, t in zip(logits, tokens)]


def check_logits(p, cfg, req: Request, controls: dict) -> tuple:
    """Prefill plus CHECK_STEPS decode steps of one request, fed the tokens
    it was served, through the kernels, through the plain versions and
    through each broken use of ``controls`` (name: module, wrapper name,
    broken use); per position the max |logit diff| against the plain
    versions over their largest |logit|.  Returns (readings, the plain
    versions' logits)."""
    prompt = torch.as_tensor(req.prompt, device=DEV)[None]
    feed = req.out_tokens[:CHECK_STEPS]
    kern = logits_path(p, cfg, prompt, feed)
    plain = logits_path(p, cfg, prompt, feed, plain=True)
    readings: dict = {}
    for name, (module, attr, fn) in controls.items():
        with swapped(module, attr, fn):
            bad = logits_path(p, cfg, prompt, feed)
        readings[name] = max(_rel(a, b) for a, b in zip(bad, plain))
    rel = [_rel(a, b) for a, b in zip(kern, plain)]
    return {"rid": req.rid, "prompt": len(req.prompt),
            "dtype": _dname(getattr(torch, cfg.dtype)),
            "max_rel_diff": max(rel), "per_step": rel, "controls": readings,
            "positions": len(rel)}, plain


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
        # Jamba's attention layer: H 64 / KV 8 at dh 128, its served
        # prefills' shortest and longest prompts
        for n in (prompt_lens[0], prompt_lens[-1]):
            flash.append(check_flash("Jamba prefill", 1, n, n, 64, 8, 128,
                                     dt))
        # the bf16 kernel's edges: 64-row query tiles, 128-key tiles at dh
        # 64 and 64-key tiles at dh 128 (B 2 x 64 heads: a full grid),
        # ragged Sq < Sk, a window whose edge falls inside key tiles, rep
        # 1, 3, 8 and 32
        for n in (63, 64, 65, 127, 128, 129, 255):
            flash.append(check_flash("tile edge", 1, n, n, 8, 8, 64, dt,
                                     reps=5))
        for n in (65, 129, 255):
            flash.append(check_flash("tile edge dh128", 2, n, n, 64, 8, 128,
                                     dt, reps=5))
        for sq, sk, h, kv, dh in ((100, 612, 8, 8, 128), (77, 301, 6, 3, 64)):
            flash.append(check_flash("Sq<Sk ragged", 1, sq, sk, h, kv, dh, dt,
                                     reps=5))
        for h, kv, dh in ((16, 16, 64), (64, 8, 128)):
            flash.append(check_flash("window 256", 1, 1000, 1000, h, kv, dh,
                                     dt, window=256, reps=5))
        for h, kv, dh in ((32, 32, 64), (24, 8, 128), (64, 8, 64),
                          (32, 1, 128)):
            flash.append(check_flash(f"rep {h // kv}", 1, 300, 300, h, kv,
                                     dh, dt, reps=5))
    log("== flash-decode kernel vs plain PyTorch version on the card")
    mid = [len(r.prompt) + NEW_TOKENS // 2 for r in reqs[:LANES]]

    def edge(kv: int) -> list:
        # every length class the device split meets: none, one key, a
        # share boundary (visible keys a multiple of the splits times 128
        # rows, then one more), 255 and 256, S - 1, S, past S
        sms = decode_ops.sm_count(torch.device(DEV))
        b = decode_ops.split_plan(LANES, kv, MAX_LEN, sms) * 128
        return [0, 1, b - 1, b, 255, 256, MAX_LEN - 1, MAX_LEN,
                MAX_LEN + 40, 1000]

    decode = [check_decode("served decode", mid, MAX_LEN, 16, 16, 64,
                           torch.bfloat16)]
    decode_main = decode[0]
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32:
            decode.append(check_decode("served decode", mid, MAX_LEN, 16, 16,
                                       64, dt))
        decode.append(check_decode("edge lengths", edge(16), MAX_LEN, 16, 16,
                                   64, dt))
        decode.append(check_decode("llama GQA", mid, MAX_LEN, 24, 8, 128, dt))
        decode.append(check_decode("MQA", mid, MAX_LEN, 8, 1, 64, dt))
        decode.append(check_decode("Jamba decode", mid, MAX_LEN, 64, 8, 128,
                                   dt))
        decode.append(check_decode("Jamba edges", edge(8), MAX_LEN, 64, 8,
                                   128, dt))
        decode.append(check_decode("rep 32", mid, MAX_LEN, 32, 1, 128, dt))
    return flash, flash_main, decode, decode_main


def _device_kind(name: str) -> str:
    return ("flash_fwd" if "flash_fwd" in name else
            "mlstm" if "mlstm_" in name else   # its four passes
            "mamba_scan_fwd" if "mamba_scan_fwd" in name else
            "decode_partial" if "decode_partial" in name else
            "decode_combine" if "decode_combine" in name else
            "gemm" if "gemm" in name.lower() else "other")


def _device_time(prof) -> tuple:
    """(events on the card, busy s, busy s by kind) of a profile."""
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kind: dict = {}
    for e in on_dev:
        key = _device_kind(e.name)
        by_kind[key] = by_kind.get(key, 0.0) + e.time_range.elapsed_us() / 1e6
    return len(on_dev), sum(by_kind.values()), by_kind


def cuda_launches_per_call(prof, calls: dict) -> dict:
    """Each wrapper's CUDA launches a call in a traced run: the device
    events of its kernels (:data:`KERNEL_EVENTS`) over its calls in that
    run (``calls``: wrapper name -> calls); None where the profiler
    recorded no device events."""
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {w: (sum(any(k in nm for k in KERNEL_EVENTS[w]) for nm in names)
                / c if names else None)
            for w, c in calls.items() if c}


def prefill_breakdown(p, cfg, req: Request, wrappers: dict) -> dict:
    """Where one prefill's time goes (B = 1): its wall time; the host-clock
    time of each block kind (its mixer: attn, mamba, mlstm, slstm) and each
    FFN kind (moe, dense ffn), each between two synchronisations (a second
    run); the card's busy time by kernel kind, its idle share and the CUDA
    launches of each kernel wrapper's calls (a third run, under
    torch.profiler)."""
    prompt = torch.as_tensor(req.prompt, device=DEV)[None]
    run = lambda: prefill(p, cfg, prompt, MAX_LEN, DEV)  # noqa: E731
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_block: dict = {}
    inside: list = []                   # the block kind being run

    def add(key: str, dt: float) -> None:
        by_block[key] = by_block.get(key, 0.0) + dt

    def block(bp, x, cfg_, kind, *args, **kw):
        inside.append(kind)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(bp, x, cfg_, kind, *args, **kw)
        torch.cuda.synchronize()
        add(kind, time.perf_counter() - t)
        inside.pop()
        return out

    def ffn_timed(fn, key: str):
        # an FFN runs inside its block: its time is moved to its own key
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            add(key, dt)
            add(inside[-1], -dt)
            return out
        return call

    fwd = T._block_forward
    with swapped(T, "_block_forward", block), \
            swapped(MOE, "moe_ffn", ffn_timed(MOE.moe_ffn, "moe")), \
            swapped(L, "ffn", ffn_timed(L.ffn, "ffn")):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
    calls = {w: -ops.launches for w, ops in wrappers.items()}
    t0 = time.perf_counter()
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        run()
        torch.cuda.synchronize()
    traced_wall = time.perf_counter() - t0
    calls = {w: n + wrappers[w].launches for w, n in calls.items()}
    per_call = cuda_launches_per_call(prof, calls)
    n_ev, busy, by_kind = _device_time(prof)
    out = {"prompt": len(req.prompt), "wall_s": wall,
           "timed_wall_s": timed_wall, "block_s": by_block,
           "block_share": {k: v / timed_wall for k, v in by_block.items()},
           "traced_wall_s": traced_wall, "device_events": n_ev,
           "device_busy_s": busy, "device_s_by_kind": by_kind,
           "idle_share": 1 - busy / traced_wall if n_ev else None,
           "cuda_launches_per_call": per_call}
    log(f"== one prefill of {len(req.prompt)} tokens: wall {wall:.6f} s; "
        f"blocks between synchronisations (run of {timed_wall:.6f} s): "
        + ", ".join(f"{k} {v:.6f} s ({v / timed_wall:.3f})"
                    for k, v in by_block.items())
        + (f"; traced: {n_ev} device events, busy {busy:.6f} s of "
           f"{traced_wall:.6f} s (idle share {1 - busy / traced_wall:.4f}), "
           f"by kind (s) {json.dumps(by_kind)}" if n_ev else
           "; the profiler recorded no device events")
        + f"; CUDA launches a wrapper call {json.dumps(per_call)}")
    return out


def mlstm_phases() -> tuple:
    """The mLSTM kernel against its plain version at the main path's shapes
    and beside them; returns (instances, the one the kernel line
    reports)."""
    log("== mLSTM kernel vs plain PyTorch version on the card (f32, outputs "
        "and final states)")
    cfg = get_config(XLSTM_ARCH)
    h = cfg.n_heads
    dh = cfg.mamba_expand * cfg.d_model // h
    lens = [len(r.prompt) for r in serving_requests(cfg.vocab)]
    served = [min(lens), lens[0], max(lens)]
    inst = [check_mlstm("served prefill", 1, n, h, dh, "fresh")
            for n in served]
    main = inst[-1]                     # the longest prompt of the main path
    inst.append(check_mlstm("carried state", 1, lens[0], h, dh, "carried"))
    inst.append(check_mlstm("S = 4 x 256", 1, 1024, h, dh, "fresh", reps=3))
    inst.append(check_mlstm("ragged, no state", 1, 1000, h, dh, "none",
                            reps=3))
    inst.append(check_mlstm("dh 32", 2, 300, 8, 32, "carried"))
    inst.append(check_mlstm("dh 64", 2, 256, 4, 64, "none"))
    inst.append(check_mlstm("dh 128", 2, 1000, 4, 128, "fresh"))
    inst.append(check_mlstm("S = 2", 1, 2, h, dh, "carried"))
    # the kernel's edges: a chunk of 64 and one past it; more chunks than
    # the workspace's 16 slots (two and three windows); one chunk past the
    # gates pass's window of 64 chunks
    inst.append(check_mlstm("S = 64", 1, 64, h, dh, "carried"))
    inst.append(check_mlstm("S = 65", 1, 65, h, dh, "fresh"))
    inst.append(check_mlstm("2 windows", 1, 1025, h, dh, "carried", reps=3))
    inst.append(check_mlstm("3 windows", 1, 2100, h, dh, "none", reps=2))
    inst.append(check_mlstm("65 chunks", 1, 4097, h, dh, "carried", reps=2))
    inst.append(check_mlstm("q, k, v off 16 B", 1, 130, h, dh, "carried",
                            misaligned=True))
    log("  no single PyTorch call computes the mLSTM: library time n/a")
    return inst, main


def mamba_phases() -> tuple:
    """The selective-scan kernel against its plain version at the main
    path's shapes and beside them; returns (instances, the one the kernel
    line reports)."""
    log("== selective-scan kernel vs plain PyTorch version on the card "
        "(f32 state, y and the final state)")
    cfg = get_config(JAMBA_ARCH)
    d, n = cfg.mamba_expand * cfg.d_model, cfg.d_state
    lens = [len(r.prompt) for r in serving_requests(cfg.vocab)]
    bf16 = torch.bfloat16
    inst = [check_mamba("served prefill", 1, max(lens), d, n, bf16, "fresh")]
    main = inst[0]                      # the longest prompt of the main path
    inst.append(check_mamba("served prefill", 1, min(lens), d, n, bf16,
                            "fresh"))
    inst.append(check_mamba("carried state", 1, lens[0], d, n, bf16,
                            "carried"))
    inst.append(check_mamba("f32 u (f32 path)", 1, max(lens), d, n,
                            torch.float32, "fresh"))
    inst.append(check_mamba("S = 1", 1, 1, d, n, bf16, "carried"))
    inst.append(check_mamba("ragged, no state", 1, 1000, d, n, bf16, "none"))
    inst.append(check_mamba("B 2, narrow D", 2, 333, 96, n, torch.float32,
                            "carried"))
    inst.append(check_mamba("N 8", 2, 300, 512, 8, torch.float32, "none"))
    # the kernel's edges: a lane's 16 positions, a tile of 64 and one past
    # each; a D that is no multiple of the block's 64 channels, odd for bf16
    inst.append(check_mamba("S = 16", 1, 16, d, n, bf16, "carried"))
    inst.append(check_mamba("S = 17", 1, 17, d, n, bf16, "carried"))
    inst.append(check_mamba("S = 64", 1, 64, d, n, bf16, "carried"))
    inst.append(check_mamba("S = 65", 1, 65, d, n, bf16, "fresh"))
    inst.append(check_mamba("odd D, bf16", 2, 130, 101, n, bf16, "carried"))
    log("  no single PyTorch call computes a selective scan: library time "
        "n/a")
    return inst, main


def serving_phases(arch: str) -> dict:
    """The serving main path of ``arch`` at full size, its traced decode
    steps and the logits check; returns what they measured, launch counts
    included."""
    wrappers, controls, bf16_gated = SERVED[arch]
    cfg = get_config(arch)
    kinds = cfg.layer_kinds()
    reqs = serving_requests(cfg.vocab)
    torch.cuda.empty_cache()            # what an earlier phase left cached
    log(f"== serving: {cfg.name}, {cfg.n_layers} layers "
        f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}"
        f"), d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"kv, head_dim {cfg.head_dim}, vocab {cfg.vocab}"
        + (f", experts {cfg.expert_offset}-"
           f"{cfg.expert_offset + cfg.n_held - 1} of {cfg.n_experts} held, "
           f"top-{cfg.top_k}" if cfg.n_experts else "")
        + f", {cfg.dtype}; {LANES} lanes x {MAX_LEN}, {N_REQUESTS} requests, "
        f"prompts {PROMPT_LO}-{PROMPT_HI}, {NEW_TOKENS} new tokens, seed "
        f"{SEED}")
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=DEV).manual_seed(SEED),
                         cfg, DEV, serve=True)
    eng = ServeEngine(params, cfg, n_lanes=LANES, max_len=MAX_LEN,
                      device=DEV)
    del params
    n_params = _numel(eng.params)
    torch.cuda.synchronize()
    log(f"  weights: {n_params} parameters, drawn into {cfg.dtype} in "
        f"{time.perf_counter() - t0:.3f} s; {torch.cuda.memory_allocated()} "
        f"B allocated")
    torch.cuda.reset_peak_memory_stats()
    for ops in wrappers.values():
        ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    serve_wall = time.perf_counter() - t0
    serve_launches = {name: ops.launches for name, ops in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)
    log(f"  launches: {serve_launches}")
    # a call per prefill (every prompt has >= 2 tokens) or per decode step,
    # for each layer of the kernel's kind
    expected = {"flash_attention": N_REQUESTS * kinds.count("attn"),
                "decode_attention": st["decode_steps"] * kinds.count("attn"),
                "mlstm": N_REQUESTS * kinds.count("mlstm"),
                "mamba_scan": N_REQUESTS * kinds.count("mamba")}
    for name, n in serve_launches.items():
        want = expected[name]
        if n != want or n <= 0:
            raise AssertionError(f"the serving path launched {name} {n} "
                                 f"times (expected {want})")
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
    serving["prefill_breakdown"] = prefill_breakdown(
        eng.params, cfg, max(reqs, key=lambda r: len(r.prompt)), wrappers)

    # a traced rerun of decode steps: the device's idle share
    log(f"== traced decode: {LANES} lanes admitted, {TRACED_STEPS} steps "
        f"(torch.profiler)")
    for r in serving_requests(cfg.vocab)[:LANES]:
        r.max_new_tokens = TRACED_STEPS + 2
        eng.try_admit(r)
    before = eng.stats["decode_s"]
    calls = {w: -ops.launches for w, ops in wrappers.items()}
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        for _ in range(TRACED_STEPS):
            eng.step()
    traced_wall = eng.stats["decode_s"] - before
    calls = {w: n + wrappers[w].launches for w, n in calls.items()}
    serving["traced_cuda_launches_per_call"] = cuda_launches_per_call(
        prof, calls)
    n_ev, busy, by_name = _device_time(prof)
    if n_ev:
        serving["traced_idle_share"] = 1 - busy / traced_wall
        serving["traced_busy_s"] = busy
        serving["traced_wall_s"] = traced_wall
        serving["traced_device_s_by_kind"] = by_name
        log(f"  {n_ev} device events ({n_ev / TRACED_STEPS:.1f} per step); "
            f"device busy {busy:.6f} s of {traced_wall:.6f} s (idle share "
            f"{1 - busy / traced_wall:.4f}); by kind (s): "
            f"{json.dumps(by_name)}; CUDA launches a wrapper call "
            f"{json.dumps(serving['traced_cuda_launches_per_call'])}")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")
    while any(a is not None for a in eng.active):
        eng.step()

    # served logits: kernels against plain versions, in bf16 (the served
    # type) and in f32 (the same weights drawn anew in f32, after the bf16
    # engine is freed; a model that holds a share of its experts holds
    # JAMBA_F32_HELD of them in f32, so that its f32 weights fit the card),
    # each beside its controls.  In f32 the check requests are first served
    # by a two-lane engine whose own logits are recorded, so that the
    # engine's path (prefill caches spliced into lanes, lanes decoded as one
    # batch) is held in f32 too; each type's requests are then fed the
    # tokens their engine served
    reqs32 = [Request(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=CHECK_STEPS + 1)
              for r in reqs[:CHECK_REQUESTS]]
    checks, tokens, failures = [], [], []
    for is32 in (False, True):
        if is32:
            p = eng = None
            torch.cuda.empty_cache()
            c = cfg.replace(dtype="float32")
            if cfg.experts_held:
                c = c.replace(experts_held=JAMBA_F32_HELD)
            p = init_params(torch.Generator(device=DEV).manual_seed(SEED), c,
                            DEV)
            served = reqs32
            served32 = engine_logits(p, c, reqs32)
        else:
            p, c, served = eng.params, cfg, reqs[:CHECK_REQUESTS]
        dt = getattr(torch, c.dtype)
        gate = LOGIT_TOL[dt] if bf16_gated or is32 else None
        where = (f"a {CHECK_REQUESTS}-lane engine" if is32 else
                 f"the engine's {LANES} lanes")
        log(f"== logits of {CHECK_REQUESTS} requests fed the tokens "
            f"{where} served them, {c.dtype}: kernels vs plain versions, "
            f"prefill + {CHECK_STEPS} decode steps"
            + (", and the engine's own logits vs plain" if is32 else "")
            + " (" + (f"gate {gate:g} of the largest |logit|" if gate else
                      "read, no gate") + "), and the controls")
        plains = []
        for i, r in enumerate(served):
            chk, plain = check_logits(p, c, r, controls)
            chk["gate"] = gate
            if is32:
                eng_rel = [_rel(a, b) for a, b in zip(served32[i], plain)]
                chk["engine_max_rel_diff"] = max(eng_rel)
                if len(eng_rel) != len(plain) or not max(eng_rel) <= gate:
                    failures.append(
                        f"request {r.rid}: the {CHECK_REQUESTS}-lane f32 "
                        f"engine's logits differ from the plain versions' "
                        f"by {max(eng_rel):.3e} at {len(eng_rel)} of "
                        f"{len(plain)} positions (gate {gate:g})")
            checks.append(chk)
            plains.append(plain)
            log(f"  request {chk['rid']} ({chk['prompt']} prompt tokens): "
                f"max rel diff {chk['max_rel_diff']:.3e}; per position "
                f"{[f'{x:.2e}' for x in chk['per_step']]}; "
                + (f"the engine's own logits: max rel diff "
                   f"{chk['engine_max_rel_diff']:.3e}; "
                   if "engine_max_rel_diff" in chk else "")
                + f"controls {json.dumps(chk['controls'])}")
            if gate is not None and not chk["max_rel_diff"] <= gate:
                failures.append(
                    f"request {chk['rid']} ({c.dtype}): logits through the "
                    f"kernels differ from the plain versions' by "
                    f"{chk['max_rel_diff']:.3e} (gate {gate:g})")
            if is32:
                for name, x in chk["controls"].items():
                    if not x > gate:
                        failures.append(
                            f"control {name} reads {x:.3e}, inside the f32 "
                            f"gate: the check cannot tell that kernel fault")
        limit = 2 * gate if gate is not None else None
        log(f"== tokens {where} served against the plain versions' "
            f"{c.dtype} logits ("
            + (f"a token may sit at most {limit:g} of the largest |logit| "
               f"below the maximum, twice the logits gate" if limit else
               "read, no limit")
            + "); control: the other request's tokens")
        for i, r in enumerate(served):
            own = r.out_tokens[:CHECK_STEPS + 1]
            other = served[(i + 1) % CHECK_REQUESTS]
            gaps = _gaps(plains[i], own)
            other_gap = max(_gaps(plains[i],
                                  other.out_tokens[:CHECK_STEPS + 1]))
            exact = sum(g == 0.0 for g in gaps)
            tokens.append({"rid": r.rid, "dtype": c.dtype,
                           "max_gap": max(gaps), "gaps": gaps,
                           "gap_limit": limit, "argmax_agree": exact,
                           "positions": len(gaps),
                           "other_request_max_gap": other_gap})
            log(f"  request {r.rid}: served tokens {own}; max gap "
                f"{max(gaps):.3e}, argmax of the plain logits at {exact} of "
                f"{len(gaps)} positions; request {other.rid}'s tokens here: "
                f"max gap {other_gap:.3e}")
            if limit is not None and not max(gaps) <= limit:
                failures.append(f"request {r.rid} ({c.dtype}): a served "
                                f"token sits {max(gaps):.3e} below the "
                                f"plain maximum (limit {limit:g})")
    if failures:
        raise AssertionError("; ".join(failures))
    serving["served_tokens"] = tokens
    serving["logit_checks"] = checks
    return serving


def adaptive_grid_a() -> list:
    """Grid (a): oracle and stale (the phase train's rates as
    ``oracle_demand``, as ``adaptive_bench.build_cases`` builds them),
    oblivious, and adaptive at each of :data:`ADAPTIVE_ALPHAS`."""
    wl = phase_shifting_workload(
        N, ADAPTIVE_LOAD, ADAPTIVE_HORIZON, BITS_PER_SLOT, d_hat=D_HAT,
        seed=SEED, phases=ADAPTIVE_PHASES, shift_period=ADAPTIVE_SHIFT)
    mats = traffic_mod.phase_train(N, ADAPTIVE_PHASES, seed=SEED)
    n_epochs = -(-ADAPTIVE_HORIZON // ADAPTIVE_EPOCH)
    oracle = np.stack([
        mats[(e * ADAPTIVE_EPOCH // ADAPTIVE_SHIFT) % len(mats)]
        for e in range(n_epochs)])
    common = dict(wl=wl, epoch_slots=ADAPTIVE_EPOCH, k=K, d_hat=D_HAT,
                  recfg_frac=RECFG, seed=SEED, normalize="saturate",
                  method="euler")
    cases = [AdaptiveCase(policy="oracle", oracle_demand=oracle,
                          label="oracle", **common),
             AdaptiveCase(policy="stale", oracle_demand=oracle,
                          label="stale", **common),
             AdaptiveCase(policy="oblivious", label="oblivious", **common)]
    cases += [AdaptiveCase(policy="adaptive", alpha=a,
                           label=f"adaptive-a{a}", **common)
              for a in ADAPTIVE_ALPHAS]
    return cases


def adaptive_grid_b() -> list:
    """Grid (b): ``run_disagreement``'s staleness x arbiter grid."""
    wl = phase_shifting_workload(
        DISAGREE_N, ADAPTIVE_LOAD, ADAPTIVE_HORIZON, BITS_PER_SLOT,
        d_hat=DISAGREE_D_HAT, seed=SEED, phases=ADAPTIVE_PHASES,
        shift_period=ADAPTIVE_SHIFT)
    return [AdaptiveCase(wl=wl, epoch_slots=DISAGREE_EPOCH,
                         policy="adaptive", k=K, d_hat=DISAGREE_D_HAT,
                         recfg_frac=RECFG, seed=SEED, alpha=0.5,
                         gather_steps=st, collision=c, normalize="saturate",
                         label=f"steps{st}-{c}",
                         meta={"gather_steps": st, "collision": c})
            for c in DISAGREE_COLLISIONS for st in DISAGREE_STEPS]


def counting_saturate(calls: list):
    """``saturate`` as the schedules call it, adding one to ``calls[0]``
    for each call that hands the Sinkhorn projection a matrix (an all-zero
    one returns before it)."""
    inner = schedule_mod.saturate

    def counted(m, iters=200, device=None):
        if not (np.asarray(m) <= 0).all():
            calls[0] += 1
        return inner(m, iters=iters, device=device)
    return swapped(schedule_mod, "saturate", counted)


def first_divergence(case, dev) -> str:
    """Where ``case``'s control trajectory built on ``dev`` first parts
    from the CPU's: the first slot whose plan differs, its epoch, and the
    matrix (that epoch's estimate or oracle rate) whose schedule it
    installs."""
    plans = [sim_mod._compile_adaptive_plan(case, BITS_PER_SLOT,
                                            sched_cache={}, device=d)
             for d in (dev, "cpu")]
    a, b = (p["plan_ids"] for p in plans)
    reg = [p["registry"] for p in plans]
    for slot in range(len(a)):
        (pa, ca), (pb, cb) = reg[0][a[slot]], reg[1][b[slot]]
        if not (np.array_equal(pa, pb) and np.array_equal(ca, cb)):
            epoch = slot // case.epoch_slots
            return (f"{case.label}: first differing slot {slot}, epoch "
                    f"{epoch} (the schedule built from epoch "
                    f"{epoch if case.policy == 'oracle' else epoch - 1}'s "
                    f"{'oracle rate' if case.policy == 'oracle' else 'estimate'})")
    return f"{case.label}: plans equal slot by slot"


def compare_adaptive(rows: list, rows_cpu: list) -> list:
    """The card's rows against the CPU's: the names of the cases whose
    compiled trajectory (``plan_digest``) differs.  Every other gate
    raises."""
    parted = []
    for a, b in zip(rows, rows_cpu):
        if a.plan_digest != b.plan_digest:
            parted.append(a.label)
            continue
        for f in ("recomputes", "stale_slots", "dark_slots",
                  "schedule_groups_max"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{a.label}: {f} {getattr(a, f)} on "
                                     f"the card, {getattr(b, f)} on the CPU")
        for f in ("epoch_estimate_tv", "epoch_disagreement",
                  "epoch_collision_loss"):
            if not np.array_equal(getattr(a, f), getattr(b, f),
                                  equal_nan=True):
                raise AssertionError(f"{a.label}: {f} differs from the "
                                     "CPU's")
        ra, rb = a.result, b.result
        fa, fb = ra.fct_slots, rb.fct_slots
        differ = ~((fa == fb) | (np.isnan(fa) & np.isnan(fb)))
        n_diff = int(differ.sum())
        max_diff = float(np.abs(fa[differ] - fb[differ]).max()) \
            if n_diff else 0.0
        rel = abs(ra.utilization - rb.utilization) / rb.utilization
        ep_rel = float(np.max(np.abs(a.epoch_utilization
                                     - b.epoch_utilization)
                              / np.maximum(b.epoch_utilization, 1e-300)))
        log(f"  {a.label}: card vs CPU: trajectory equal, util rel diff "
            f"{rel:.3e} (epochs {ep_rel:.3e}); FCTs differ on {n_diff} of "
            f"{len(fa)} flows, by at most {max_diff} slots")
        if rel > UTIL_RTOL or ep_rel > UTIL_RTOL:
            raise AssertionError(f"{a.label}: utilization differs by "
                                 f"{max(rel, ep_rel):.3e} (rtol {UTIL_RTOL})")
        if n_diff > FCT_MAX_DIFF_FRAC * len(fa) \
                or max_diff > FCT_MAX_DIFF_SLOTS:
            raise AssertionError(f"{a.label}: FCTs differ on {n_diff} flows "
                                 f"by up to {max_diff} slots")
    return parted


def adaptive_grid(name: str, cases: list) -> dict:
    """One grid: run on the card with the sanitizer, Sinkhorn launches
    counted from 0 against the saturate calls that ran; the CPU's run of
    the same cases; the gates; the numbers."""
    log(f"== adaptive loop, grid ({name}): n={cases[0].wl.n}, "
        f"d_hat={cases[0].d_hat}, {cases[0].wl.horizon} slots, epochs of "
        f"{cases[0].epoch_slots}, {len(cases)} cases, "
        f"{cases[0].wl.num_flows} flows a case, normalize=saturate")
    timings: dict = {}
    calls = [0]
    sinkhorn_ops.reset_launches()
    t0 = time.perf_counter()
    with counting_saturate(calls):
        rows = run_adaptive(cases, BITS_PER_SLOT, device=DEV, sanitize=True,
                            timings=timings)
    wall = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    log(f"  run_adaptive on the card {wall:.6f} s; saturate calls "
        f"{calls[0]}, sinkhorn launches {launches}")
    if launches != calls[0]:
        raise AssertionError(f"grid ({name}) launched the sinkhorn kernel "
                             f"{launches} times for {calls[0]} saturate "
                             "calls")
    for key, val in timings.items():
        log(f"  phase {key}: {val:.6f}" if key != "slots"
            else f"  slots served {val}")
    per_slot_us = timings["device_loop_s"] / timings["slots"] * 1e6
    log(f"  device slot loop: {per_slot_us:.3f} us per slot")
    for r in rows:
        res = r.result
        if not np.isfinite(res.fct_slots).any() \
                or not np.isfinite(res.utilization):
            raise AssertionError(f"{r.label}: no finite result")
        log(f"  {r.label}: util {res.utilization:.6f}, completed "
            f"{res.completed_frac:.6f}, short-flow FCT p99 "
            f"{res.fct_percentile(99, short_cutoff=SHORT_FLOW_BITS):.3f} "
            f"slots, recomputes {r.recomputes}, groups max "
            f"{r.schedule_groups_max}, collision loss "
            f"{r.collision_lost_bits:.6e} b, construction_s "
            f"{r.construction_s:.6f}")
    by_policy: dict = {}
    for r in rows:
        by_policy.setdefault(r.policy, []).append(r)
    policies = {}
    for pol, rs in by_policy.items():
        policies[pol] = {
            "util": float(np.mean([r.result.utilization for r in rs])),
            "short_p99": float(np.mean([r.result.fct_percentile(
                99, short_cutoff=SHORT_FLOW_BITS) for r in rs])),
            "recomputes": [r.recomputes for r in rs]}
        log(f"  policy {pol}: mean util {policies[pol]['util']:.6f}, "
            f"short-flow FCT p99 {policies[pol]['short_p99']:.3f} slots, "
            f"recomputes {policies[pol]['recomputes']}")

    t0 = time.perf_counter()
    rows_cpu = run_adaptive(cases, BITS_PER_SLOT, device="cpu",
                            sanitize=True)
    log(f"  the same cases on the CPU {time.perf_counter() - t0:.6f} s")
    parted = compare_adaptive(rows, rows_cpu)
    for i, r in enumerate(rows):
        if r.label in parted:
            log(f"  trajectory parts from the CPU's: "
                f"{first_divergence(cases[i], DEV)}")
    if parted:
        raise AssertionError(f"grid ({name}): the card's control "
                             f"trajectories differ from the CPU's: {parted}")
    return {"rows": rows, "launches": launches, "saturate_calls": calls[0],
            "wall_s": wall, "timings": timings, "us_per_slot": per_slot_us,
            "policies": policies,
            "construction_s": {r.label: r.construction_s for r in rows}}


def replay_skipped(credit, order, bucket, p_pid, tx, drained, H):
    """``_replay_credit`` without the ledger: the per-slot tx in f64 and no
    FCTs, for a rerun that reads only the device's trace."""
    return np.asarray(tx, np.float64)


def adaptive_phases() -> dict:
    """Grids (a) and (b) on the card against the CPU, then a traced rerun
    of grid (a) without the host's credit replay: the device's idle share
    in the slot loop and the Sinkhorn kernel's device time in the control
    plane.  Returns each grid's numbers without its rows."""
    grid_a = adaptive_grid_a()
    res_a = adaptive_grid("a", grid_a)
    res_b = adaptive_grid("b", adaptive_grid_b())
    for r in res_b.pop("rows"):
        st = r.meta["gather_steps"]
        if st == DISAGREE_N - 1 and np.any(r.epoch_disagreement != 0.0):
            raise AssertionError(f"{r.label}: a full gather disagrees")
        if st == 2 and not r.collision_lost_bits > 0:
            raise AssertionError(f"{r.label}: a 2-step gather lost no "
                                 "capacity to collisions")
    log("  grid (b): full gathers never disagree, every 2-step gather "
        "loses capacity to collisions")
    del res_a["rows"]

    log("== traced rerun of grid (a) on the card (torch.profiler; no "
        "credit replay)")
    traced: dict = {}
    t0 = time.perf_counter()
    with swapped(sim_mod, "_replay_credit", replay_skipped), \
            profile(activities=list(TRACE_ACTIVITIES)) as prof:
        run_adaptive(grid_a, BITS_PER_SLOT, device=DEV, timings=traced)
    traced_s = time.perf_counter() - t0
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    sink = [e for e in on_dev if "sinkhorn_" in e.name]
    copies = [e for e in on_dev if e.name.startswith(("Memcpy", "Memset"))]
    plane = [e for e in on_dev if "sinkhorn_" not in e.name
             and not e.name.startswith(("Memcpy", "Memset"))]
    trace = {"traced_s": traced_s, "timings": traced}
    if on_dev:
        busy = sum(e.time_range.elapsed_us() for e in plane) / 1e6
        sink_s = sum(e.time_range.elapsed_us() for e in sink) / 1e6
        copy = sum(e.time_range.elapsed_us() for e in copies) / 1e6
        idle = 1 - busy / traced["device_loop_s"]
        trace.update(plane_kernels=len(plane), plane_busy_s=busy,
                     idle_share=idle, sinkhorn_kernels=len(sink),
                     sinkhorn_s=sink_s, copies_s=copy)
        log(f"  traced run {traced_s:.6f} s: control {traced['control_s']:.6f} "
            f"s, of it {len(sink)} sinkhorn kernels {sink_s:.6f} s on the "
            f"card; data plane {len(plane)} kernels "
            f"({len(plane) / traced['slots']:.3f} per slot), device busy "
            f"{busy:.6f} s of the {traced['device_loop_s']:.6f} s loop "
            f"(idle share {idle:.4f}); copies {copy:.6f} s")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")
    return {"a": res_a, "b": res_b, "trace": trace}


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
    sinkhorn, main_shape = sinkhorn_phases()

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
    # one schedule's saturate, traced: the kernel's CUDA launches a call
    calls = -sinkhorn_ops.launches
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        vermilion_schedule(wls[0].demand_matrix(), k=K, d_hat=D_HAT,
                           recfg_frac=RECFG, normalize="saturate")
        torch.cuda.synchronize()
    calls += sinkhorn_ops.launches
    sinkhorn_per_call = cuda_launches_per_call(
        prof, {"sinkhorn": calls})["sinkhorn"]
    log(f"  traced schedule: {calls} sinkhorn call(s), CUDA launches a "
        f"call {sinkhorn_per_call} ({main_shape['variant']} path)")
    if sinkhorn_per_call not in (None, 1.0):
        raise AssertionError(f"a main-path sinkhorn call made "
                             f"{sinkhorn_per_call} CUDA launches (expected 1)")
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
    if not all(same):
        raise AssertionError(f"schedules built on the card differ from the "
                             f"CPU's: perms equal {same}")

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

    # -- 5a. the adaptive loop: grids (a) and (b) on the card --------------
    adaptive = adaptive_phases()
    gc.collect()

    # -- 5b. the attention, mLSTM and scan kernels; the serving paths -------
    flash, flash_main, decode, decode_main = attention_phases()
    mlstm, mlstm_main = mlstm_phases()
    mamba, mamba_main = mamba_phases()
    served = {arch: serving_phases(arch)
              for arch in (ARCH, XLSTM_ARCH, JAMBA_ARCH)}
    # each kernel's launches on every serving path that runs it, each path
    # read between its own resets
    by_path: dict = {}
    for arch, res in served.items():
        for name, n in res["launches"].items():
            by_path.setdefault(name, {})[arch] = n

    # -- 6. results -----------------------------------------------------------
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(f"sinkhorn instances: {json.dumps(sinkhorn)}")
    log(f"flash instances: {json.dumps(flash)}")
    log(f"decode instances: {json.dumps(decode)}")
    log(f"mlstm instances: {json.dumps(mlstm)}")
    log(f"mamba_scan instances: {json.dumps(mamba)}")
    for arch, res in served.items():
        log(f"serving {arch}: {json.dumps(res)}")
    log("adaptive: " + json.dumps(adaptive))
    sinkhorn_by_path = {"sweep": launches,
                        "adaptive_a": adaptive["a"]["launches"],
                        "adaptive_b": adaptive["b"]["launches"]}
    kernels = [{
        "name": "sinkhorn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sinkhorn.cu",
        "replaces": "src/repro/kernels/sinkhorn/sinkhorn.py:39",
        "launches": sum(sinkhorn_by_path.values()),
        "launches_by_path": sinkhorn_by_path,
        **{k: main_shape[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "dtype", "shape", "iters", "variant",
            "cluster")},
        "cuda_launches_per_call": sinkhorn_per_call,
    }]
    # sinkhorn's `launches` counts wrapper calls on the sweep's schedules
    # and the two adaptive grids, each read between its own resets
    # (`launches_by_path`), its `cuda_launches_per_call` those of one traced
    # schedule; for the others `launches` counts wrapper calls on the
    # serving paths, summed
    # over the paths that run the kernel (`launches_by_path`); a call may be
    # several CUDA launches (`cuda_launches_per_call`, from the first
    # serving path's traced prefill or decode that calls it), and `ms` is
    # the device time of all of a call's; `x_bound` and `x_library` are
    # `ms` over `bound_ms` and `library_ms` at the reported (served) shape
    per_call: dict = {}
    for res in served.values():
        for traced in (res["prefill_breakdown"]["cuda_launches_per_call"],
                       res.get("traced_cuda_launches_per_call", {})):
            for name, n in traced.items():
                per_call.setdefault(name, n)
    for name, inst, replaces in (
            ("flash_attention", flash_main,
             "src/repro/kernels/flash_attention/flash_attention.py:59"),
            ("decode_attention", decode_main,
             "src/repro/kernels/decode_attention/decode_attention.py:58"),
            ("mlstm", mlstm_main, "src/repro/kernels/mlstm/mlstm.py:73"),
            ("mamba_scan", mamba_main,
             "src/repro/kernels/mamba_scan/mamba_scan.py:54")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            **{k: inst[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "call_ms", "dtype", "shape")},
            "cuda_launches_per_call": per_call.get(name)})
    for entry in kernels:
        entry["x_bound"] = entry["ms"] / entry["bound_ms"]
        entry["x_library"] = (entry["ms"] / entry["library_ms"]
                              if entry["library_ms"] else None)
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
