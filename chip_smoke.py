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
   Beside each Vermilion row the sweep carries RotorNet's (``rotorlb``)
   and pure VLB's (``vlb``) rows on the oblivious round-robin, as
   ``benchmarks/fct_bench.py`` builds them: one two-hop batch of 8
   cases, which at n = 256 takes the reference's dense, aggregate-only
   route (utilization, delivered bits, ``avg_hops``; FCTs all inf).  The
   same 8 cases forced through the sparse formulation must match the
   dense within rtol 1e-3; the CPU run holds the card's two-hop
   aggregates to rtol 1e-4.  Traced reruns of the single-hop and the
   two-hop batch read each data plane's device events a slot and idle
   share.
1a. The n = 64 grid of ``fct_bench.timing_table`` (d_hat = 4, load 0.6,
   seed 1; cut from its 1500 slots to ``HORIZON64``): Vermilion (one Sinkhorn launch), rotorlb and vlb,
   whose batch takes ``twohop_fct`` and so has per-flow FCTs, gated
   against the CPU run like the sweep's; ``simulate_aggregate`` on the
   Vermilion schedule, card against CPU (per-slot delivered rtol 1e-5,
   final VOQ within 1e-3 bits); a traced rerun of the two-hop batch.
1b. The adaptive control loop (``run_adaptive``, Appendix A closed:
   estimation each epoch, per-node schedules, a collision-resolved fabric
   plan, one data-plane run on the card for the whole batch, the host
   credit replay), every schedule ``normalize="saturate"`` through the
   Sinkhorn kernel.  Grid (a): the sweep's fabric under phase-shifting
   websearch traffic (permutation -> uniform -> dlrm every 1000 slots),
   load 0.5, 3000 slots in epochs of 500; oracle and stale (the phase
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
1c. The paper's throughput analysis (``throughput_phases``), at the
   reference benchmarks' own sizes, each card path with the Sinkhorn count
   set to 0 just before it and read just after: Fig. 7's table (n = 16,
   d_hat = 4, eight demands, oblivious multi-hop LP and single-hop,
   Vermilion at k 3 and 6, every entry at or above Theorem 3) and its
   flow-level cross-check (ring, skew-0.5, uniform over 800 slots: each
   demand's saturate schedule, ``rotorlb`` and single-hop on the
   oblivious one, one ``run_sweep`` on the card, held to the CPU run at
   the sweep's bar); Fig. 8 (k 2-8, n 8-48; every minimum at or above
   the bound); the sweep's four n = 256 saturate schedules certified on
   the card (checks C1-C7 pass, theta at or above the quantized bound),
   the CI's two golden certificates and the saturate golden through
   ``python -m repro_torch.analysis.certify``, each equal to the CPU's
   certificate (theta rtol 1e-9); BvN on the Theorem-1 input at n 6 and
   16 (ideal BvN serves it fully; decomposition equal to the CPU's,
   lambdas within 1e-9) beside the quantized strawman's and Vermilion's
   throughput at 3n slots; the interconnect pricing of every registry
   architecture and its drain through saturate schedules over 30,000
   slots, one ``run_sweep`` on the card, held to the CPU run.
1d. Fault injection (``faults_phases``), each run on the card and on the
   CPU: the sweep's deployment on its load-0.6 saturate schedule under
   four scenarios in one batch, all firing at slot 600 (one plane down,
   two ToRs failed, two ToRs drained, a port death plus a 200-slot link
   flap), sanitized, FCTs within the sweep's bar and bits rtol 1e-5; the
   drain loses no bits, the failure some.  ``run_faults`` as
   ``benchmarks/adaptive_bench.py`` builds it (n = 16, d_hat = 4, load
   0.95, epochs of 150: plane_down / tor_fail / tor_drain x severity 1 /
   2 x repair / blind / oblivious, cut to its stationary train: 21 cases,
   and to 2100 slots with the faults at slot 900, from 4500 and 1500)
   with its headline on the card (one plane down on the stationary train:
   the repair loop excises it and recovers at or above the oblivious
   baseline, which stays above the blind loop); grid (b)'s sizes under
   ``collision="fullest"`` at every gather and one jittered activation
   window under ``receiver`` (cut to 1500 slots, the phase train shifting
   every 500), every rebuild through the Sinkhorn kernel (launches
   counted).  The degraded-service engine's rows equal the CPU's in
   trajectory, counters and excisions, bits within rtol 1e-9, FCTs within
   the sweep's bar.
1e. The paper's evaluation drivers (``evaluation_phases``), each on the
   card against the port's CPU run of the same driver: Fig. 5/6 as
   ``repro_torch.benchmarks.fct_bench.run`` builds it at its defaults
   (n = 16, d_hat = 4, 4000 slots, loads 0.05-0.7 in 6 steps; Vermilion
   with one Sinkhorn launch a load, the greedy matching baseline,
   rotorlb, vlb and single-hop on the oblivious round-robin: 30 rows, the
   sweep's bars), its table logged; ``fct_bench.timing_table`` at n = 64
   (3 launches), the CPU's and the card's times per group; the adaptive
   suite's ``run`` (8 cases, the partial gather included),
   ``run_epoch_tradeoff`` (12 cases) and ``run_charging`` (its
   ``free-euler`` row gated; the clock-charged rows read), at the adaptive
   loop's bars, with the reference's summary lines; Fig. 10's
   ``schedule_time.run`` at n 16-256 (host only, 0 launches).
1f. The port's analysis and examples (``analysis_phases``): the
   quickstart (``examples/torch_quickstart.py``, the reference
   quickstart's nine sections: n = 16, d_hat = 4, k = 3) on the card and
   on the CPU, every printed line equal but for the device's name, its
   lint of ``src/repro_torch/core`` clean, its certificate ok and its
   saturate schedule through the Sinkhorn kernel; the op-level analyzer
   (``repro_torch.analysis.ir``) over the five slot kernels on the card,
   each report equal to the CPU's field by field and within the port's
   ``ir_budget.json``; the serving example
   (``examples/torch_serve_decode.py``: Qwen1.5-0.5B at full width, 2
   lanes of 64, five requests of 4-12 tokens, 8 new tokens each) through
   the flash and decode kernels, and the same as ``--smoke``, the
   reference's example (2 layers, 4 heads of 64); every distinct flash and
   decode call each run made (its shapes, type and lane lengths: a cache
   of 64, prompts of 4-12) held against the plain version on seeded
   inputs.
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
3. Serving xLSTM-350M the same way at full width, cut to one of its
   three 8-layer supercells (``SERVED_LAYERS``: 7 mLSTM, sLSTM at 1;
   d_model 1024, 4 heads of dim 512, vocab 50,304), on the same
   deployment and requests: every prefill runs the chunkwise mLSTM kernel
   once per mLSTM layer (16 x 7 = 112 launches),
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
5. Serving Mixtral-8x7B as card 0 of an expert-parallel pair
   (``mixtral-8x7b-ep2`` at full width, cut to 8 of its 32 layers by
   ``SERVED_LAYERS``: d_model 4096, 32 / 8 heads of 128, MoE FFNs of d_ff
   14336 holding experts 0-3 of 8 with the router whole, vocab 32,000,
   sliding window 4096) on a deployment of its own, a long-context chat or
   retrieval service: 8 lanes x 8192, 12 requests (4 prompts of 4200-6000
   tokens, past the window, then 8 of 128-1024), 32 new tokens.  Every
   prefill runs the flash kernel and every decode step the decode kernel
   once per layer, both with the window; the decode steps with an active
   lane past the window are counted (> 0).  The logits check is Jamba's,
   on two requests past the window, with Qwen's two controls and a third,
   the decode kernel without its window; its f32 weights hold 2 of the 8
   experts.  Jamba's and Mixtral's bf16 checks also read the
   share of router decisions the two paths make differently, and the plain
   path against itself with q nudged by 2^-9 in its attention (the size of
   the bf16 kernels' roundings of P): the model's own sensitivity.
6. Serving MiniCPM3-4B (``minicpm3-4b`` at full width, cut to 8 of its
   62 layers by ``SERVED_LAYERS``: d_model 2560, 40 heads of 64, MLA with
   q_lora_rank 768, kv_lora_rank 256 and rope_head_dim 32, d_ff 6400,
   vocab 73,448) on Mixtral's long-context deployment.
   Every prefill runs the MLA prefill kernel and every decode step the MLA
   decode kernel once per layer (attention over the latent cache, the
   reference's weight-absorbed path).  The logits check is Qwen's, its f32
   weights whole, with three controls: the scale worked out
   from the key width, the q_rope . k_rope term dropped, and a decode split
   dropped.  Its bf16 logits are gated at Qwen's bar unless the plain path
   nudged by 2^-9 already moves past it; then they are read.
7. Serving Whisper-tiny whole (``whisper-tiny``: 4 encoder and 4 decoder
   layers, d_model 384, 6 heads of 64, d_ff 1536, vocab 51,865, 1500
   stubbed frames; 61,065,984 parameters by ``param_count``, drawn
   straight into bf16) through ``prefill(frames=)`` and a loop of
   ``decode_step(cross_kv=)``, batched as the reference's
   ``test_whisper_decode`` batches it (the reference's engine takes no
   frames): 8 lanes, each with its own seeded frames, a 4-token prompt and
   224 greedy tokens (openai/whisper's ``sample_len``) in a cache of 448
   (``n_text_ctx``).  The prefill runs the flash kernel 12 times (4
   non-causal encoder layers over 8 x 1500 frames, 4 causal decoder
   layers, 4 cross-attention layers of the prompt over the 1500 encoder
   rows), every decode step the decode kernel 8 times (4 self, 4 cross
   over all 1500 rows).  Before it both kernels are held against their
   plain versions at Whisper's shapes.  An f32 build's prefill and
   decode steps are gated at 1e-3 against the plain path, with Qwen's two
   controls and a third, cross decode over 1499 of the 1500 keys, and
   against the f32 teacher-forced ``forward`` on the card; its bf16
   logits and tokens take MiniCPM3's nudge rule.

8. Training (``training_phases``), after the flash-attention backward
   kernel is held against its plain version (``flash_bwd_phases``: dQ, dK,
   dV and the forward's log-sum-exp at Qwen's training shape 8 x 2048 in
   bf16 and f32, Mixtral's window 1 x 5000 (H 32 / KV 8, dh 128, window
   4096) in bf16 and f32, Whisper's encoder 8 x 1500^2 and cross-attention
   8 x 448 x 1500, a ragged 1 x 130 x 1473, MiniCPM3's 8 x 2048 (H 40, q/k
   96 and v 64 wide: MLA's cacheless branch) and a ragged 1 x 1001 at its
   widths in bf16 and f32; the GQA sum left out and the D
   term dropped as controls, at least 10x past the gate in each type; in
   bf16 also the plain model of the kernel's arithmetic,
   ``attention_bwd_tiles``, within ``TILE_TOL`` beyond one rounding).
   Qwen1.5-0.5B at full width and depth: one f32 loss and gradient at B
   2 x 1024 through the kernels against the plain versions (loss rtol
   1e-5, every gradient leaf within 1e-3 of its largest magnitude), then
   the ``Trainer`` in bf16
   at B 8 x 2048 (warmup 2, 12 steps, its one checkpoint at the end under
   ``chiprun_out/train_ckpt``, removed after): the flash kernels' calls
   gated (each layer's forward once plus once under remat, its backward
   once), losses finite and falling; then a run checkpointing every 4
   steps fails at step 6 and resumes from the step-3 checkpoint through
   step 7, whose losses hold to the uninterrupted run's at rtol 1e-4; a
   traced step reads the idle share and the device time by kind.
   Whisper-tiny whole: the same f32 check at B 2 x 448 with
   its 1500 seeded frames, then 4 bf16 Trainer steps at 8 x 448.
   InternVL2-76B at full width cut to 4 of its 80 layers: ``forward`` and
   ``loss_fn`` with 256 vision tokens before 768 text tokens, B 2, under
   no_grad, f32 kernels against plain within 1e-3, bf16 by MiniCPM3's
   nudge rule.  MiniCPM3-4B at full width, cut to 32 of its 62 layers
   (2,381,455,360 weights), through MLA's cacheless branch (the flash
   kernels' (96, 64) instances): Qwen's f32 check at B 2 x 1024, then 4
   bf16 ``Trainer`` steps at 8 x 2048 (warmup 1; its checkpoint left out:
   28.6 GB of state), losses finite and falling, flash calls gated; then
   a traced step.
9. Training xLSTM-350M and Jamba (``xlstm_training``, ``jamba_training``),
   after the mLSTM and scan backward kernels are held against their plain
   versions (``mlstm_bwd_phases``, ``mamba_bwd_phases``: every gradient
   within 1e-4 of its largest magnitude, bitwise on repeat, two broken
   plain backwards as controls at least 10x past the gate; the mLSTM at
   xLSTM-350M's 8 x 2048, H 4, dh 512, S 2, 63, 64, 65, 256, 300 and 1100,
   dh 32-512 and q, k, v, out, dout off a 16-byte boundary; the scan at
   Jamba's 2 x 2048, D 16384, N 16 with u in bf16 and f32, S = 1, ragged S,
   S 16, 17, 64, 65, N 8, a narrow and an odd D).  xLSTM-350M whole (21
   mLSTM and 3 sLSTM layers, 556,154,880 weights): Qwen's f32 check at B
   2 x 1024, 4 bf16 ``Trainer`` steps at 8 x 2048 (warmup 1, no
   checkpoint; a step 42 mLSTM forward and 21 backward calls, gated), a
   traced step, and the sLSTM blocks' share of a step (timed alone).
   Jamba at full width cut to layers 0-1 of its supercell (two Mamba
   layers, a dense and an MoE FFN holding one of 16 experts: 3,088,875,520
   weights): the f32 check at B 1 x 1024, the first gradient of the MoE
   dispatch on the card, then 4 bf16 steps at 2 x 2048 (4 scan forward
   and 2 backward calls a step), a traced step.

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
none, one key, a split-share boundary and S - 1 to past S, Mixtral's
windowed prefill (1 x 5000, window 4096) and decode (S 8192, window 4096,
lengths from none through the window's edges to an idle lane whose window
lies past the cache, with the unwindowed kernel as a control); the MLA
kernels at MiniCPM3's widths (prefill 1 x 5000, Sq = Sk of 16-257 around
the bf16 kernel's 128-row blocks and 64-key tiles and the f32 kernel's
64-row blocks and 32-key tiles at H 40 and H 1, ragged Sq < Sk at a tile
edge, B 2 on strided views of a cache; decode at S 8192, lengths -1 to
8191 + 100, the 64-key tile's edges, split-share edges, H 1, 40 and 64,
B 2 on views of a cache; each with its achieved TFLOP/s beside its bound);
each twice, bitwise; the mLSTM kernel in f32 with its states: the
served prefills from a fresh state, a carried nonzero state, S <= 256, S a
multiple of 256, ragged S, head dims 32-512, S at a 64-position chunk and
one past it, more chunks than the kernel's workspace holds (two and three
windows of 16), 65 chunks, q, k, v off a 16-byte boundary; the scan
kernel on y and the final state: the served prefills, a carried nonzero
state, S = 1, ragged S, bf16 and f32 inputs, B 2 at a narrow D, d_state
8, S at a lane's 16 positions and a 64-position tile and one past each,
an odd D).

7. The dry-run (``repro_torch.launch.dryrun``), in subprocesses that see
   no card (all four started together after the training phase, the
   script's last, so that no host-timed phase runs beside them): the
   reference tests' two cells, Qwen1.5-0.5B's ``train_4k`` on the 16 x 16
   mesh and Whisper-tiny's ``decode_32k`` on 2 x 16 x 16, each printed on
   a ``dryrun:`` line and ``ok``; and the estimator on a (1, 1) mesh for
   two configurations this script runs on the card, Qwen's train step at
   ``TRAIN_BATCH`` x ``TRAIN_SEQ`` and its serving decode at ``SERVING``'s
   lanes and cache: the estimate's argument bytes must equal the card's
   train state (params, moments, step) and the engine's served weights
   and caches exactly, and its training peak lie within ``PEAK_BAND`` of
   the traced step's ``max_memory_allocated``.  The meta rules' Python
   copies of the mLSTM forward and backward and the scan backward's
   workspace formulas must equal the built libraries' own at every shape
   the checks and the training and serving paths give those kernels.

Any failure raises: no phase is caught.

Output: readable lines, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a card or outside a checkout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import certify  # noqa: E402
from repro_torch.analysis import ir as ir_mod  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.benchmarks import adaptive_bench  # noqa: E402
from repro_torch.benchmarks import bound_convergence  # noqa: E402
from repro_torch.benchmarks import fct_bench  # noqa: E402
from repro_torch.benchmarks import interconnect_bench  # noqa: E402
from repro_torch.benchmarks import schedule_time  # noqa: E402
from repro_torch.benchmarks import throughput_bench  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import faults as faults_mod  # noqa: E402
from repro_torch.core import schedule as schedule_mod  # noqa: E402
from repro_torch.core import simulator as sim_mod  # noqa: E402
from repro_torch.core import traffic as traffic_mod  # noqa: E402
from repro_torch.core.estimation import (  # noqa: E402
    TrafficEstimator,
    estimate_all_views,
)
from repro_torch.core.schedule import (  # noqa: E402
    bvn_decompose,
    bvn_schedule,
    oblivious_schedule,
    vermilion_schedule,
)
from repro_torch.core.throughput import (  # noqa: E402
    quantized_theorem3_bound,
    schedule_throughput,
    theorem3_bound,
    throughput_single_hop,
)
from repro_torch.core.simulator import (  # noqa: E402
    AdaptiveCase,
    SweepCase,
    phase_shifting_workload,
    run_adaptive,
    run_sweep,
    simulate_aggregate,
    websearch_workload,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_bwd_tiles,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.mla_attention import ops as mla_ops  # noqa: E402
from repro_torch.kernels.mla_attention.ref import (  # noqa: E402
    mla_decode_ref,
    mla_prefill_ref,
)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    selective_scan_bwd_ref,
    selective_scan_ref,
)
from repro_torch.kernels.mamba_scan_bwd import ops as scan_bwd_ops  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm.ref import (  # noqa: E402
    mlstm_chunkwise_bwd_ref,
    mlstm_chunkwise_ref,
)
from repro_torch.kernels.mlstm_bwd import ops as mlstm_bwd_ops  # noqa: E402
from repro_torch.kernels.sinkhorn import ops as sinkhorn_ops  # noqa: E402
from repro_torch.kernels.sinkhorn.ref import (  # noqa: E402
    sinkhorn_kernel_order,
    sinkhorn_ref,
)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    forward,
    init_params,
    loss_fn,
    prefill,
    serve_params,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import (  # noqa: E402
    InjectedFailure,
    Trainer,
    init_state,
    make_train_step,
)
from repro_torch.tree import flatten_with_keys, leaves, tree_map  # noqa: E402

N, D_HAT, K, RECFG = 256, 8, 3, 1 / 9
BITS_PER_SLOT = 100e9 * 4.5e-6
LOADS = (0.15, 0.3, 0.45, 0.6)
HORIZON, SEED = 2000, 1

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor-core f32 / f64 rates and the dense bf16 tensor-core rate
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12}
# the tensor cores' TF32 rate (f32 operands read as TF32)
PEAK_TF32_FLOPS = 495e12

# kernel vs plain tolerances: f32 as in tests/test_kernels.py (reduction
# order only), f64 near its precision (200 iterations of it)
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 0.0)}

# card vs CPU FCTs: CUDA index_add_ adds several arrivals of one pair in
# one slot in a varying order; the drain reconciliation absorbs most such
# ulp residues, not every one
FCT_MAX_DIFF_FRAC, FCT_MAX_DIFF_SLOTS = 1e-3, 1.0

# the sweep's baselines beside Vermilion, as benchmarks/fct_bench.py's
# build_grid sets them: RotorNet (direct hop + VLB offload) and pure VLB
# on the oblivious round-robin
TWOHOP_MODES = ("rotorlb", "vlb")
# two-hop aggregates (delivered bits, utilization, avg_hops): card vs CPU
# in one formulation; sparse vs dense, the reference's own bar between
# formulations (tests/test_simulator.py)
TWOHOP_RTOL, SPARSE_RTOL = 1e-4, 1e-3
# the n = 64 grid: fct_bench.timing_table's deployment (n = 64, d_hat =
# 4, load 0.6, seed 1), where the two-hop batch takes the
# twohop_fct route (per-flow FCTs), and the aggregate plane on its
# Vermilion schedule: card vs CPU per-slot delivered rtol 1e-5, final VOQ
# within 1e-3 bits
# (cut from the deployment's 1500 slots to 750 when the dry-run phase came:
# the phase took 74.9 s of the script's 807.9 s)
N64, D_HAT64, LOAD64, HORIZON64 = 64, 4, 0.6, 750
AGG_RTOL, AGG_VOQ_ATOL = 1e-5, 1e-3

# the adaptive loop, grid (a): the sweep's fabric in closed loop under
# phase-shifting traffic (permutation -> uniform -> dlrm every 1000 slots,
# benchmarks/adaptive_bench.py's phase train) at load 0.5, 3000 slots in
# epochs of 500; oracle and stale from the phase train's rates,
# oblivious, and the adaptive loop at four EWMA weights, all with a
# complete gather, every schedule Sinkhorn-saturated
# (cut from 6000 slots shifting every 2000, so that the script keeps its
# time as it grows with each served model: PERF.md section 5)
ADAPTIVE_LOAD, ADAPTIVE_HORIZON, ADAPTIVE_SHIFT = 0.5, 3000, 1000
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

# the throughput analysis, at the reference benchmarks' own sizes: Fig. 7
# (benchmarks/throughput_bench.py: n = 16, d_hat = 4, k 3 and 6, the
# flow-level cross-check over 800 slots), Fig. 8
# (benchmarks/bound_convergence.py), the BvN strawman on
# tests/test_throughput.py's Theorem-1 input at n 6 and 16, the CI's two
# golden certificates (.github/workflows/ci.yml) and the saturate golden
# of tests/test_ir_certify.py, and the interconnect drain
# (benchmarks/interconnect_bench.py: 8 pods, 30,000 slots)
FIG7_N, FIG7_D_HAT, FIG7_KS, FIG7_HORIZON = 16, 4, (3, 6), 800
FIG7_DEMANDS = ("ring", "skew-0.5", "uniform")
BVN_NS = (6, 16)
DRAIN_HORIZON = 30000
CERTIFY_GOLDENS = {
    "ci-skewed": ["--case", "skewed", "--n", "16", "--k", "3", "--d-hat",
                  "2", "--batch-check"],
    "ci-websearch": ["--case", "websearch", "--n", "12", "--k", "3",
                     "--d-hat", "4", "--recfg-frac", "0.1111"],
    "saturate": ["--case", "skewed", "--n", "12", "--seed", "3", "--k", "3",
                 "--d-hat", "2", "--recfg-frac", repr(1 / 9), "--normalize",
                 "saturate", "--no-spread", "--batch-check"],
}
# card vs CPU: a saturate certificate's theta (min cap / demand of the
# projected demand); BvN's lambdas (the projections differ in the last
# bits: the card's is bit-equal to sinkhorn_kernel_order)
THETA_RTOL, BVN_LAM_ATOL = 1e-9, 1e-9

# the faults phase: the sweep's deployment (its load-0.6 saturate
# schedule) under four fault scenarios firing at slot 600 (a flap lasts 200
# slots), card vs CPU bits rtol 1e-5 (the sweep's f32 VOQ);
# benchmarks/adaptive_bench.py's run_faults grid, as the port's
# adaptive_bench.faults_cases builds it (n = 16, d_hat = 4, load 0.95,
# epochs of 150, dark windows of 40, hysteresis 0.3); grid (b) under
# fullest and one jittered activation window of 40 slots; the
# degraded-service engine (f64 VOQ) card vs CPU bits rtol 1e-9
FAULT_SLOT, FAULT_FLAP, SWEEP_FAULT_RTOL = 600, 200, 1e-5
# run_faults' stationary train only (21 cases): with the shifting train
# too (42 cases) the phase took 204 s of the script on an NVIDIA H100
# 80GB HBM3 at 700 W, over its ~120-s allowance (PERF.md section 4)
RF_TRAINS = ("stationary",)
# run_faults cut from 4500 slots with the faults at slot 1500 to 2100 and
# 900 (8 epochs after the fault's), and grid (b) under fullest from 3000
# slots shifting every 1000 to 1500 shifting every 500, to make room for
# the analysis and examples phase: the faults phase took 101.8 s of an
# 801.7-s script on an NVIDIA H100 80GB HBM3 at 700 W, 67 s of it
# run_faults on the card and the CPU (PERF.md section 5)
RF_HORIZON, RF_FAULT_SLOT = 2100, 900
FAULT_GRID_B_HORIZON, FAULT_GRID_B_SHIFT = 1500, 500
JITTER_SLOTS = 40
ENGINE_RTOL = 1e-9

TRACE_ACTIVITIES = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
# a traced train step reads device events alone; recording the host's ops
# too doubled the events of an xLSTM step (its sLSTM loops: ~10^6)
TRAIN_TRACE_ACTIVITIES = (ProfilerActivity.CUDA,)

# the card; the attention and serving phases read it (a rehearsal on the
# CPU sets it to "cpu")
DEV = "cuda"

# serving: Qwen1.5-0.5B at full width and depth, the repo's default
# serving model (src/repro/launch/serve.py), on the deployment SERVING
# (below)
ARCH = "qwen1.5-0.5b"
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

# the fourth served model: Mixtral-8x7B as card 0 of an expert-parallel
# pair, at full width with experts 0-3 of its 8 and its sliding window of
# 4096 (src/repro_torch/configs/mixtral_8x7b.py, SERVED and REDUCED), its
# depth cut by SERVED_LAYERS, on a deployment of its own (below); its f32
# checks hold 2 of the 8 experts
MIXTRAL_ARCH = "mixtral-8x7b-ep2"

# the fifth served model: MiniCPM3-4B at full width (MLA latent attention;
# src/repro_torch/configs/minicpm3_4b.py), its depth cut by SERVED_LAYERS,
# on Mixtral's long-context deployment
MINICPM3_ARCH = "minicpm3-4b"

# the sixth served model: Whisper-tiny whole (src/repro_torch/configs/
# whisper_tiny.py, the published widths), served as a speech-to-text
# transcription service batches it: WHISPER_LANES lanes, each transcribing
# its own 30-s window (enc_seq stubbed frames, seeded), a
# start-of-transcript prompt of WHISPER_PROMPT tokens, openai/whisper's
# sample_len (n_text_ctx // 2) greedy tokens in a cache of n_text_ctx
WHISPER_ARCH = "whisper-tiny"
WHISPER_LANES, WHISPER_PROMPT = 8, 4
WHISPER_NEW, WHISPER_MAX_LEN = 224, 448

# experts the f32 logits checks hold, where the served model holds a share
F32_HELD = {JAMBA_ARCH: 2, MIXTRAL_ARCH: 2}


@dataclasses.dataclass(frozen=True)
class Deployment:
    """A serving deployment: ``lanes`` cache lanes of ``max_len``
    positions; requests drawn from SEED, ``groups`` of (count, shortest,
    longest prompt) in that order, each asking ``new_tokens`` tokens."""
    lanes: int
    max_len: int
    groups: tuple
    new_tokens: int

    @property
    def n_requests(self) -> int:
        return sum(g[0] for g in self.groups)

    def describe(self) -> str:
        return (f"{self.lanes} lanes x {self.max_len}, {self.n_requests} "
                f"requests, prompts "
                + " and ".join(f"{n} of {lo}-{hi}" for n, lo, hi in
                               self.groups)
                + f", {self.new_tokens} new tokens, seed {SEED}")


# Qwen's, xLSTM's and Jamba's: 8 lanes of 2048, 16 requests of 128-1024
# tokens
SERVING = Deployment(8, 2048, ((16, 128, 1024),), 32)
# Mixtral's: a chat or retrieval-augmented service with long contexts on a
# card's expert share, 8 lanes of 8192 (a KV cache of 8 GiB beside its
# 44.99 GiB of weights); 4 prompts past the window first (the logits
# checks take the first CHECK_REQUESTS), then 8 short ones.  MiniCPM3's
# too: a long-document chat or retrieval service on a small MLA model (a
# latent cache of 2.18 GiB beside its 7.94 GiB of weights)
MIXTRAL_SERVING = Deployment(8, 8192, ((4, 4200, 6000), (8, 128, 1024)), 32)
DEPLOYMENTS = {MIXTRAL_ARCH: MIXTRAL_SERVING, MINICPM3_ARCH: MIXTRAL_SERVING}

# the serving paths cut in depth, every width kept, so that the script with
# its training phases stays well inside its 1,200-s limit: xLSTM to one of
# its three 8-layer supercells (7 mLSTM, 1 sLSTM), Mixtral to 8 of its 32
# layers; their host-bound phases had grown to 92 and 102 s on a slower
# host.  MiniCPM3 to 8 of its 62 layers (its host-bound phase took ~105 s
# whole) when its training phase came.  Qwen, Jamba's supercell and
# Whisper keep their depth; Qwen also trains at full depth
SERVED_LAYERS = {XLSTM_ARCH: 8, MIXTRAL_ARCH: 8, MINICPM3_ARCH: 8}

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


def throughput_inputs() -> dict:
    """What ``saturate`` hands the kernel on the throughput phase's paths
    (nonpositive entries clamped to 1e-12): BvN's Theorem-1 input at n 6
    and 16, the saturate golden certificate's demand at n 12, the
    interconnect drain's step matrix at n 8, Fig. 7's ring at n 16."""
    out = {f"bvn n={n}": traffic_mod.skewed(n, 0.5, seed=4) + 1e-6
           for n in BVN_NS}
    out["certify golden"] = certify.demand_case("skewed", 12, seed=3)
    out["drain"] = interconnect_bench.step_matrix(get_config("mixtral-8x7b"))
    out["fig7 ring"] = throughput_bench.demand_suite(FIG7_N)["ring"]
    return {k: np.where(m <= 0, 1e-12, m) for k, m in out.items()}


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
    clamped) at grid (b)'s n; the throughput phase's inputs at n 6, 8, 12
    and 16; f32 at 20 iterations, n from 1 to 1024;
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
    for label, m in throughput_inputs().items():
        inst.append(check_sinkhorn(label, torch.from_numpy(m).to(DEV), 200,
                                   0.0, reps=20))
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
                window: int = 0, reps: int = 20, seed: int = SEED,
                dv: int | None = None) -> dict:
    """The flash-attention kernel against its plain version on one input,
    q and k ``dh`` wide and v ``dv`` (default ``dh``); times kernel, plain
    version and ``scaled_dot_product_attention`` (its backend logged) on
    the card alone (:func:`device_ms`), and the kernel's calls with the
    host's share (:func:`time_ms`)."""
    dv = dh if dv is None else dv
    gen = torch.Generator(device=DEV).manual_seed(seed + sq + sk + h)
    q = torch.randn(b, sq, h, dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, sk, kv, dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, sk, kv, dv, generator=gen, device=DEV).to(dtype)
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
        mask = dict(is_causal=True)
    elif not causal and not window:     # every key visible: no mask
        mask = {}
    else:
        mask = dict(attn_mask=_end_aligned_mask(sq, sk, causal, window, DEV))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=h != kv, **mask)
    library_ms = device_ms(lib, reps)
    backend = sdpa_backend(qt, kt, vt, mask.get("attn_mask"), 0.0,
                           bool(mask.get("is_causal")), enable_gqa=h != kv)
    size = torch.finfo(dtype).bits // 8
    pairs = visible_pairs(sq, sk, causal, window)
    # Q K^T and P V: 2 (dh + dv) FLOP a visible pair
    bound_ms, bound_by = attn_bound_ms(
        (b * sq * h + b * sk * kv) * (dh + dv) * size,
        2.0 * b * h * (dh + dv) * pairs, dtype)
    log(f"  {label:14s} {_dname(dtype):8s} B={b} Sq={sq} Sk={sk} H={h} "
        f"KV={kv} dh={dh}{'' if dv == dh else f' dv={dv}'} "
        f"causal={int(causal)} window={window}: "
        f"max_abs_err={err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}; "
        f"deterministic={same}; "
        f"kernel {ms:.4f} ms (with the host {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms ({backend}), bound "
        f"{bound_ms:.6f} ms ({bound_by}); x bound {ms / bound_ms:.1f}, "
        f"x sdpa {ms / library_ms:.2f}")
    if not ok:
        raise AssertionError(f"flash-attention kernel disagrees with its "
                             f"plain version: {label} {_dname(dtype)}")
    if not same:
        raise AssertionError(f"flash-attention kernel is not deterministic: "
                             f"{label} {_dname(dtype)}")
    return {"label": label, "dtype": _dname(dtype),
            "shape": [b, sq, sk, h, kv, dh], "dv": dv, "causal": causal,
            "window": window, "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_backend": backend,
            "bound_ms": bound_ms, "bound_by": bound_by}


def visible_range(length: int, s: int, window: int) -> tuple:
    """The keys [lo, hi) a decode lane of ``length`` sees in a cache of
    ``s`` under ``window`` (0: none), as the kernel reckons them."""
    if length < 0:
        return 0, 0
    hi = min(length, s - 1) + 1
    return min(max(0, length - window + 1) if window else 0, hi), hi


def check_decode(label: str, lens: list, s: int, h: int, kv: int, dh: int,
                 dtype: torch.dtype, window: int = 0, reps: int = 20,
                 seed: int = SEED) -> dict:
    """The flash-decode kernel against its plain version with one length
    per lane and a sliding ``window`` (0: none); checks two calls bitwise;
    times kernel, plain version and ``scaled_dot_product_attention`` with
    the same per-lane mask on the card alone (:func:`device_ms`), and the
    kernel's calls with the host's share (:func:`time_ms`).  With a window,
    a control: the unwindowed kernel must miss the windowed plain version,
    beyond the tolerance, on every lane whose window hides at least as
    many keys as it shows (its misses on all lanes past the window are
    logged), so that a window that is dropped shows."""
    b = len(lens)
    gen = torch.Generator(device=DEV).manual_seed(seed + s + h)
    q = torch.randn(b, 1, h, dh, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, s, kv, dh, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, s, kv, dh, generator=gen, device=DEV).to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device=DEV)
    got = decode_ops.decode_kernel(q, k, v, length, window)
    again = decode_ops.decode_kernel(q, k, v, length, window)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, length, window)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol = ATTN_TOL[dtype]
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    same = bool(torch.equal(got, again))
    ranges = [visible_range(x, s, window) for x in lens]
    control: dict = {}
    if window:
        nowin = decode_ops.decode_kernel(q, k, v, length).float()
        miss = ((nowin - want.float()).abs()
                - tol * (1 + want.float().abs())).flatten(1).amax(1)
        control = {x: float(miss[i]) for i, x in enumerate(lens)
                   if ranges[i][0] > 0}
        gated = [x for x, (lo, hi) in zip(lens, ranges)
                 if 0 < lo and hi - lo <= lo]
        control_ok = bool(gated) and all(control[x] > 0 for x in gated)
    call = lambda: decode_ops.decode_kernel(  # noqa: E731
        q, k, v, length, window)
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, length,
                                                      window),
                         max(2, reps // 4))
    kpos = torch.arange(s, device=DEV)[None, :]
    ln = length[:, None].long()
    mask = kpos <= ln
    if window:
        mask &= kpos > ln - window
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=h != kv), reps)
    size = torch.finfo(dtype).bits // 8
    rows = sum(hi - lo for lo, hi in ranges)
    bound_ms, bound_by = attn_bound_ms(
        2 * rows * kv * dh * size + 2 * b * h * dh * size + 4 * b,
        4.0 * rows * (h // kv) * kv * dh, dtype)
    log(f"  {label:14s} {_dname(dtype):8s} B={b} S={s} H={h} KV={kv} "
        f"dh={dh} window={window} lengths={lens}: max_abs_err={err:.3e} "
        f"(tol {tol:g}) {'ok' if ok else 'FAIL'}; deterministic={same}; "
        f"kernel {ms:.4f} ms (with the host {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}); x bound {ms / bound_ms:.1f}, "
        f"x sdpa {ms / library_ms:.2f}"
        + (f"; control, the unwindowed kernel's miss beyond the tolerance "
           f"by length (gated where the window hides at least half): "
           f"{json.dumps(control)} {'ok' if control_ok else 'FAIL'}"
           if window else ""))
    if not ok:
        raise AssertionError(f"flash-decode kernel disagrees with its plain "
                             f"version: {label} {_dname(dtype)}")
    if not same:
        raise AssertionError(f"flash-decode kernel is not deterministic: "
                             f"{label}")
    if window and not control_ok:
        raise AssertionError(f"the unwindowed decode kernel passes for the "
                             f"windowed one: {label} {_dname(dtype)}")
    return {"label": label, "dtype": _dname(dtype),
            "shape": [b, s, h, kv, dh], "lengths": lens, "window": window,
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "control_miss": control}


# MiniCPM3's latent attention: the softmax scale the model passes, (head_dim
# + rope_head_dim)^-0.5, not the key width's (R + Dr)^-0.5
MLA_SCALE = 96 ** -0.5
MLA_R, MLA_DR = mla_ops.LATENT, mla_ops.ROPE


def mla_inputs(b: int, sq: int, sk: int, h: int, dtype: torch.dtype,
               seed: int) -> tuple:
    """q_lat (B, Sq, H, R), q_rope (B, Sq, H, Dr), c (B, Sk, R), k_rope
    (B, Sk, Dr), standard normal: scores of std ~1.7 at MLA_SCALE."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return tuple(torch.randn(*shape, generator=gen, device=DEV).to(dtype)
                 for shape in ((b, sq, h, MLA_R), (b, sq, h, MLA_DR),
                               (b, sk, MLA_R), (b, sk, MLA_DR)))


def sdpa_backend(*args, **kw) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    arguments."""
    if not hasattr(torch, "_fused_sdp_choice"):
        return "not reported by this torch"
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name


def _mla_log(label: str, shape: str, dtype: torch.dtype, res: dict) -> None:
    log(f"  {label:16s} {_dname(dtype):8s} {shape}: "
        f"max_abs_err={res['max_abs_err']:.3e} (tol {ATTN_TOL[dtype]:g}) "
        f"ok; deterministic=True; kernel {res['ms']:.4f} ms (with the host "
        f"{res['call_ms']:.4f}), plain {res['plain_ms']:.4f} ms, sdpa "
        f"{res['library_ms']:.4f} ms ({res['library_backend']}), bound "
        f"{res['bound_ms']:.6f} ms ({res['bound_by']}); x bound "
        f"{res['ms'] / res['bound_ms']:.1f}, x sdpa "
        f"{res['ms'] / res['library_ms']:.2f}; {res['tflops']:.1f} TFLOP/s "
        f"of the bound's {res['flop'] / res['bound_ms'] / 1e9:.1f}")


def _mla_views(b: int, sq: int, sk: int, h: int, dtype: torch.dtype,
               seed: int) -> tuple:
    """As :func:`mla_inputs`, as the model hands them over: c and k_rope
    views of the first ``sk`` keys of one repetition of a (3, B, sk + 88,
    .) cache, q_lat with its heads unpacked (a transposed (B, H, Sq, R))."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=gen, device=DEV).to(dtype)
    cache, kcache = rnd(3, b, sk + 88, MLA_R), rnd(3, b, sk + 88, MLA_DR)
    return (rnd(b, h, sq, MLA_R).transpose(1, 2), rnd(b, sq, h, MLA_DR),
            cache[1, :, :sk], kcache[1, :, :sk])


def _held(label: str, got, again, want, dtype) -> float:
    """max |got - want|; raises unless within ATTN_TOL and got == again
    bitwise."""
    diff = (got.float() - want.float()).abs()
    tol = ATTN_TOL[dtype]
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"MLA kernel disagrees with its plain version: "
                             f"{label} {_dname(dtype)}: max abs err "
                             f"{float(diff.max()):.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"MLA kernel is not deterministic: {label} "
                             f"{_dname(dtype)}")
    return float(diff.max())


def check_mla_prefill(label: str, b: int, sq: int, sk: int, h: int,
                      dtype: torch.dtype, reps: int = 10,
                      views: bool = False) -> dict:
    """``mla_prefill`` against its plain version (twice, bitwise); times
    kernel, plain version and ``scaled_dot_product_attention`` on the same
    function (q and k of width R + Dr = 288, v of width R, one kv head for
    the H query heads, the same scale and end-aligned causal mask; q and k
    concatenated outside the timed call) on the card alone, and the kernel's
    calls with the host's share.  ``views``: the operands as the model hands
    them over (:func:`_mla_views`)."""
    ql, qr, c, kr = (_mla_views if views else mla_inputs)(
        b, sq, sk, h, dtype, SEED + sq + 3 * sk + h)
    got = mla_ops.mla_prefill_kernel(ql, qr, c, kr, MLA_SCALE)
    again = mla_ops.mla_prefill_kernel(ql, qr, c, kr, MLA_SCALE)
    torch.cuda.synchronize()
    err = _held(label, got, again, mla_prefill_ref(ql, qr, c, kr, MLA_SCALE),
                dtype)
    call = lambda: mla_ops.mla_prefill_kernel(  # noqa: E731
        ql, qr, c, kr, MLA_SCALE)
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: mla_prefill_ref(ql, qr, c, kr, MLA_SCALE),
                         max(1, reps // 4))
    qt = torch.cat([ql, qr], -1).transpose(1, 2)
    kt = torch.cat([c, kr], -1)[:, None]
    vt = c[:, None]
    causal = dict(is_causal=True) if sq == sk else dict(
        attn_mask=_end_aligned_mask(sq, sk, True, 0, DEV))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, scale=MLA_SCALE, enable_gqa=True, **causal)
    library_ms = device_ms(lib, reps)
    backend = sdpa_backend(qt, kt, vt, causal.get("attn_mask"), 0.0,
                           sq == sk, scale=MLA_SCALE, enable_gqa=True)
    del qt, kt, vt
    size = torch.finfo(dtype).bits // 8
    pairs = visible_pairs(sq, sk, True, 0)
    flop = 2.0 * b * h * pairs * (2 * MLA_R + MLA_DR)
    bound_ms, bound_by = attn_bound_ms(
        (b * sq * h * (2 * MLA_R + MLA_DR) + b * sk * (MLA_R + MLA_DR))
        * size, flop, dtype)
    res = {"label": label, "dtype": _dname(dtype), "shape": [b, sq, sk, h],
           "max_abs_err": err, "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_backend": backend, "bound_ms": bound_ms,
           "bound_by": bound_by, "flop": flop, "tflops": flop / ms / 1e9}
    _mla_log(label, f"B={b} Sq={sq} Sk={sk} H={h}", dtype, res)
    return res


def check_mla_decode(label: str, lens: list, s: int, h: int,
                     dtype: torch.dtype, reps: int = 20,
                     views: bool = False) -> dict:
    """``mla_decode`` against its plain version with one length per lane
    (twice, bitwise); times kernel, plain version and
    ``scaled_dot_product_attention`` with the same per-lane mask as
    :func:`check_mla_prefill` does, views likewise."""
    b = len(lens)
    ql, qr, c, kr = (_mla_views if views else mla_inputs)(
        b, 1, s, h, dtype, SEED + s + h + b)
    length = torch.tensor(lens, dtype=torch.int32, device=DEV)
    got = mla_ops.mla_decode_kernel(ql, qr, c, kr, length, MLA_SCALE)
    again = mla_ops.mla_decode_kernel(ql, qr, c, kr, length, MLA_SCALE)
    torch.cuda.synchronize()
    err = _held(label, got, again,
                mla_decode_ref(ql, qr, c, kr, length, MLA_SCALE), dtype)
    call = lambda: mla_ops.mla_decode_kernel(  # noqa: E731
        ql, qr, c, kr, length, MLA_SCALE)
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: mla_decode_ref(ql, qr, c, kr, length,
                                                MLA_SCALE), max(2, reps // 4))
    qt = torch.cat([ql, qr], -1).transpose(1, 2)
    kt = torch.cat([c, kr], -1)[:, None]
    vt = c[:, None]
    mask = (torch.arange(s, device=DEV)[None, :]
            <= length[:, None].long())[:, None, None, :]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True), reps)
    backend = sdpa_backend(qt, kt, vt, mask, 0.0, False, scale=MLA_SCALE,
                           enable_gqa=True)
    del qt, kt, vt
    size = torch.finfo(dtype).bits // 8
    rows = sum(hi - lo for lo, hi in (visible_range(x, s, 0) for x in lens))
    flop = 2.0 * rows * h * (2 * MLA_R + MLA_DR)
    bound_ms, bound_by = attn_bound_ms(
        rows * (MLA_R + MLA_DR) * size
        + b * h * (2 * MLA_R + MLA_DR) * size + 4 * b, flop, dtype)
    res = {"label": label, "dtype": _dname(dtype), "shape": [b, s, h],
           "lengths": lens, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_backend": backend, "bound_ms": bound_ms,
           "bound_by": bound_by, "flop": flop, "tflops": flop / ms / 1e9}
    _mla_log(label, f"B={b} S={s} H={h} lengths={lens}", dtype, res)
    return res


def mla_phases() -> tuple:
    """The MLA kernels against their plain versions at MiniCPM3's shapes
    (H 40, R 256, Dr 32) and beside them; returns (prefill instances, the
    one the kernel line reports, decode instances, likewise)."""
    log("== MLA latent attention kernels vs plain PyTorch versions on the "
        "card (MiniCPM3: H 40, R 256, Dr 32, scale 96^-0.5)")
    cfg = get_config(MINICPM3_ARCH)
    h, s = cfg.n_heads, MIXTRAL_SERVING.max_len
    sms = decode_ops.sm_count(torch.device(DEV))
    prefill_inst, decode_inst = [], []
    for dt in (torch.bfloat16, torch.float32):
        f32 = dt == torch.float32
        prefill_inst.append(check_mla_prefill("served prefill", 1, 5000,
                                              5000, h, dt, reps=2 if f32
                                              else 5))
        # the tiles: bf16's 128-row blocks and 64-key tiles, f32's 64-row
        # blocks and 32-key tiles; Sq = Sk around them at H 40 (rows n x
        # 40: 16 and 32 fill 5 and 10 blocks exactly) and H 1 (rows =
        # positions); ragged Sq < Sk (a prefill at an offset, Sk at a tile
        # edge), B 2 on views of a cache
        for n in (16, 32, 63, 64, 65, 127, 128, 129, 255):
            prefill_inst.append(check_mla_prefill("tile edge", 1, n, n, h,
                                                  dt, reps=3))
        for n in (31, 32, 33, 63, 64, 65, 127, 128, 129, 257):
            prefill_inst.append(check_mla_prefill("tile edge H 1", 1, n, n, 1,
                                                  dt, reps=3))
        for b, sq, sk in ((1, 100, 612), (1, 77, 301), (1, 65, 192),
                          (2, 33, 1000)):
            prefill_inst.append(check_mla_prefill("Sq<Sk ragged", b, sq, sk,
                                                  h, dt, reps=3))
        prefill_inst.append(check_mla_prefill("cache views", 2, 120, 300, h,
                                              dt, reps=3, views=True))
        lens = [-1, 0, 1, 63, 64, 100, 4095, 6000, s - 1, s - 1 + 100]
        decode_inst.append(check_mla_decode("served decode", lens, s, h, dt))
        decode_inst.append(check_mla_decode(
            "tile edges", [63, 64, 65, 127, 128, 129, 191, 192], s, h, dt,
            reps=5))
        decode_inst.append(check_mla_decode("cache views", [299, 650], 700,
                                            h, dt, reps=5, views=True))
        # a share boundary of the 8 lanes' split plan: visible keys a
        # multiple of the splits times the tile, and one more
        unit = mla_ops.split_plan(8, h, s, sms) * mla_ops.TILE
        decode_inst.append(check_mla_decode(
            "split edges", [31, 32, 33, unit - 1, unit, unit + 1,
                            2 * unit - 1, 2 * unit], s, h, dt, reps=5))
        for hh in (1, 64):
            decode_inst.append(check_mla_decode(f"H {hh}", lens, s, hh, dt,
                                                reps=5))
    return (prefill_inst, prefill_inst[0], decode_inst, decode_inst[0])


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


def _nbytes(tree) -> int:
    """Bytes of a tree's tensors (a train state, weights, caches)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def serving_requests(vocab: int, dep: Deployment = SERVING) -> list:
    rng = np.random.default_rng(SEED)
    lens = np.concatenate([rng.integers(lo, hi + 1, size=n)
                           for n, lo, hi in dep.groups])
    return [Request(rid=i, prompt=rng.integers(1, vocab, size=int(n)),
                    max_new_tokens=dep.new_tokens)
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


def decode_split_dropped(q, k, v, length, window=0):
    """Control: the decode kernel with the first DROPPED_KEYS keys of each
    lane's visible range left out, what a combine that lost one partial
    would return (the cache from DROPPED_KEYS on, the length and a window
    both shorter by as much)."""
    s = DROPPED_KEYS
    if 0 < window <= s:
        raise ValueError(f"the control needs a window over {s} keys")
    ln = decode_ops.lengths_vector(length, q.shape[0], q.device) - s
    return decode_ops.decode_kernel(q, k[:, s:], v[:, s:], ln,
                                    window - s if window else 0)


def cross_key_dropped(q, k, v, length, window=0):
    """Control: cross-attention's decode (keys as many as Whisper's
    encoder rows) over all of them but the last, the one in the tail of
    the last key tile; self-attention's decode as it is."""
    if k.shape[1] != get_config(WHISPER_ARCH).enc_seq:
        return decode_ops.decode_kernel(q, k, v, length, window)
    ln = decode_ops.lengths_vector(length, q.shape[0], q.device) - 1
    return decode_ops.decode_kernel(q, k[:, :-1], v[:, :-1], ln, window)


def decode_window_dropped(q, k, v, length, window=0):
    """Control: the decode kernel without its sliding window, what a window
    that never reached the kernel would return."""
    return decode_ops.decode_kernel(q, k, v, length)


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


def mla_prefill_key_width(q_lat, q_rope, c, k_rope, scale):
    """Control: the prefill kernel with the scale worked out from the key
    width, (R + Dr)^-0.5, in place of the model's."""
    return mla_ops.mla_prefill_kernel(
        q_lat, q_rope, c, k_rope, (q_lat.shape[-1] + q_rope.shape[-1]) ** -0.5)


def mla_decode_key_width(q_lat, q_rope, c, k_rope, length, scale):
    """Control: the decode kernel with the key width's scale."""
    return mla_ops.mla_decode_kernel(
        q_lat, q_rope, c, k_rope, length,
        (q_lat.shape[-1] + q_rope.shape[-1]) ** -0.5)


def mla_prefill_rope_dropped(q_lat, q_rope, c, k_rope, scale):
    """Control: the prefill kernel without the q_rope . k_rope term."""
    return mla_ops.mla_prefill_kernel(q_lat, torch.zeros_like(q_rope), c,
                                      k_rope, scale)


def mla_decode_rope_dropped(q_lat, q_rope, c, k_rope, length, scale):
    """Control: the decode kernel without the q_rope . k_rope term."""
    return mla_ops.mla_decode_kernel(q_lat, torch.zeros_like(q_rope), c,
                                     k_rope, length, scale)


def mla_decode_split_dropped(q_lat, q_rope, c, k_rope, length, scale):
    """Control: the decode kernel with the first DROPPED_KEYS keys of each
    lane left out, what a combine that lost one partial would return."""
    ln = decode_ops.lengths_vector(length, q_lat.shape[0], q_lat.device)
    return mla_ops.mla_decode_kernel(q_lat, q_rope, c[:, DROPPED_KEYS:],
                                     k_rope[:, DROPPED_KEYS:],
                                     ln - DROPPED_KEYS, scale)


# the controls: module, wrapper name, the broken use of the kernel (or a
# list of such swaps, made together)
CONTROLS = {"decode_split_dropped": (decode_ops, "decode_attn",
                                     decode_split_dropped),
            "flash_unscaled": (flash_ops, "attention", flash_unscaled)}
# Mixtral's check requests are past its window, so dropping the window
# shows in their decode logits
MIXTRAL_CONTROLS = {**CONTROLS,
                    "decode_window_dropped": (decode_ops, "decode_attn",
                                              decode_window_dropped)}
WHISPER_CONTROLS = {**CONTROLS,
                    "cross_key_dropped": (decode_ops, "decode_attn",
                                          cross_key_dropped)}
MLSTM_CONTROLS = {"mlstm_state_lost": (mlstm_ops, "mlstm", mlstm_state_lost),
                  "mlstm_unscaled": (mlstm_ops, "mlstm", mlstm_unscaled)}
MAMBA_CONTROLS = {"mamba_c_ignored": (mamba_ops, "selective_scan",
                                      mamba_c_ignored),
                  "mamba_b_ignored": (mamba_ops, "selective_scan",
                                      mamba_b_ignored)}
MLA_CONTROLS = {
    "mla_scale_of_key_width": [
        (mla_ops, "mla_prefill", mla_prefill_key_width),
        (mla_ops, "mla_decode", mla_decode_key_width)],
    "mla_rope_dropped": [(mla_ops, "mla_prefill", mla_prefill_rope_dropped),
                         (mla_ops, "mla_decode", mla_decode_rope_dropped)],
    "mla_split_dropped": (mla_ops, "mla_decode", mla_decode_split_dropped)}

# xLSTM-350M in bf16 on random weights turns any change in the mLSTM's f32
# rounding into a large change of the logits (on an H100, ~0.11 of the
# largest logit where the f32 logits move by ~3e-5, and as much from the
# plain version run in f64): its bf16 logits and served tokens are read,
# held to no gate.  Its f32 logits, and the logits and tokens of a
# two-lane f32 engine, carry the gates, as they do for Qwen.  Jamba's and
# Mixtral's likewise: a bf16 rounding flipped by an f32 reordering can flip
# a top-2 expert choice of their routers.

# the served models: the wrappers of their kernels (whose launches the
# serving run counts), the broken uses the logits check reads as controls,
# and whether the bf16 logits and tokens are gated (True), read (False), or
# gated unless the plain path against itself with q nudged by 2^-9 already
# moves past the gate ("nudge": the model's own sensitivity decides)
SERVED = {ARCH: ({"flash_attention": flash_ops,
                  "decode_attention": decode_ops}, CONTROLS, True),
          XLSTM_ARCH: ({"mlstm": mlstm_ops}, MLSTM_CONTROLS, False),
          JAMBA_ARCH: ({"mamba_scan": mamba_ops,
                        "flash_attention": flash_ops,
                        "decode_attention": decode_ops}, MAMBA_CONTROLS,
                       False),
          MIXTRAL_ARCH: ({"flash_attention": flash_ops,
                          "decode_attention": decode_ops}, MIXTRAL_CONTROLS,
                         False),
          MINICPM3_ARCH: ({"mla_prefill": mla_ops.PREFILL,
                           "mla_decode": mla_ops.DECODE}, MLA_CONTROLS,
                          "nudge")}

# the __global__ functions each wrapper launches, by a part of their names
KERNEL_EVENTS = {"sinkhorn": ("sinkhorn_",),
                 "flash_attention": ("flash_fwd",),
                 "flash_attention_bwd": ("bwd_dsum", "bwd_dkdv", "bwd_dq"),
                 "decode_attention": ("decode_partial", "decode_combine"),
                 "mlstm": ("mlstm_gates", "mlstm_states", "mlstm_scores",
                           "mlstm_outputs"),
                 "mlstm_bwd": ("mlstm_bwd_",),
                 "mamba_scan": ("mamba_scan_fwd",),
                 "mamba_scan_bwd": ("mamba_scan_bwd",),
                 "mla_prefill": ("mla_prefill_fwd",),
                 "mla_decode": ("mla_decode_",)}


def logits_path(p, cfg, prompt: torch.Tensor, feed: list, max_len: int,
                plain: bool = False) -> list:
    """Logits (f32, (V,)) of one request at B = 1 in a cache of
    ``max_len``: its prefill, then one decode step per token of
    ``feed``."""
    lg, caches, ln = prefill(p, cfg, prompt, max_len, DEV, plain=plain)
    out = [lg[0].float()]
    for i, tok in enumerate(feed):
        t = torch.tensor([[tok]], device=DEV)
        lg, caches = decode_step(p, cfg, t, caches, ln + i, DEV, plain=plain)
        out.append(lg[0].float())
    return out


def engine_logits(p, cfg, reqs: list, max_len: int) -> list:
    """Serve ``reqs`` on an engine of one lane of ``max_len`` each (all
    admitted at once, request i in lane i), recording the logits (f32,
    (V,)) the engine computed for each: its prefill's, then its lane's at
    each decode step while it is active."""
    eng = ServeEngine(p, cfg, n_lanes=len(reqs), max_len=max_len, device=DEV)
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


def routed(fn) -> tuple:
    """(``fn()``, the expert choices (tokens, k) of every MoE router call
    it made, in order)."""
    seen: list = []
    real = MOE.route

    def rec(logits, cfg):
        out = real(logits, cfg)
        seen.append(out[2])
        return out

    with swapped(MOE, "route", rec):
        return fn(), seen


def router_flips(a: list, b: list):
    """The share of tokens whose top-k expert set differs between two
    runs' router calls (None without a router)."""
    if not a:
        return None
    flips = [(x.sort(-1).values != y.sort(-1).values).any(-1)
             for x, y in zip(a, b, strict=True)]
    return float(sum(int(f.sum()) for f in flips)
                 / sum(f.numel() for f in flips))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (at least 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _gaps(logits: list, tokens: list) -> list:
    """How far below the maximum each token's logit sits, over the largest
    |logit| (0 for the argmax)."""
    return [(float(lg.max()) - float(lg[t])) / max(1.0, float(lg.abs().max()))
            for lg, t in zip(logits, tokens)]


# a nudge of half a bf16 ulp, the size of the roundings the bf16 attention
# kernels make in P
NUDGE = 2.0 ** -9


def q_nudged(ref):
    """``ref``, a plain attention version, with q scaled by 1 + NUDGE in
    f32 and the result in q's type."""
    def call(q, *args, **kw):
        return ref(q.float() * (1 + NUDGE), *args, **kw).to(q.dtype)
    return call


def check_logits(p, cfg, req: Request, controls: dict, max_len: int,
                 nudged: bool = False) -> tuple:
    """Prefill plus CHECK_STEPS decode steps of one request, fed the tokens
    it was served, through the kernels, through the plain versions and
    through each broken use of ``controls`` (name: module, wrapper name,
    broken use); per position the max |logit diff| against the plain
    versions over their largest |logit|; for an MoE model, the share of
    router decisions in which the two chose other experts.  ``nudged``
    also reads the plain versions against themselves with q nudged by
    NUDGE in their attention: how far the model moves under roundings of
    the bf16 kernels' size alone.  Returns (readings, the plain versions'
    logits)."""
    prompt = torch.as_tensor(req.prompt, device=DEV)[None]
    feed = req.out_tokens[:CHECK_STEPS]
    kern, kern_routes = routed(
        lambda: logits_path(p, cfg, prompt, feed, max_len))
    plain, plain_routes = routed(
        lambda: logits_path(p, cfg, prompt, feed, max_len, plain=True))
    readings: dict = {}
    for name, spec in controls.items():
        with contextlib.ExitStack() as stack:
            for module, attr, fn in (spec if isinstance(spec, list)
                                     else [spec]):
                stack.enter_context(swapped(module, attr, fn))
            bad = logits_path(p, cfg, prompt, feed, max_len)
        readings[name] = max(_rel(a, b) for a, b in zip(bad, plain))
    rel = [_rel(a, b) for a, b in zip(kern, plain)]
    out = {"rid": req.rid, "prompt": len(req.prompt),
           "dtype": _dname(getattr(torch, cfg.dtype)),
           "max_rel_diff": max(rel), "per_step": rel, "controls": readings,
           "router_flips": router_flips(kern_routes, plain_routes),
           "positions": len(rel)}
    if nudged:
        with swapped(L, "attention_ref", q_nudged(attention_ref)), \
                swapped(L, "decode_attention_ref",
                        q_nudged(decode_attention_ref)), \
                swapped(L, "mla_prefill_ref", q_nudged(mla_prefill_ref)), \
                swapped(L, "mla_decode_ref", q_nudged(mla_decode_ref)):
            nudge, nudge_routes = routed(lambda: logits_path(
                p, cfg, prompt, feed, max_len, plain=True))
        out["plain_nudged"] = {
            "max_rel_diff": max(_rel(a, b) for a, b in zip(nudge, plain)),
            "router_flips": router_flips(nudge_routes, plain_routes)}
    return out, plain


def attention_phases() -> tuple:
    """Both attention kernels against their plain versions at the main
    path's shapes and beside them; returns (flash instances, the one the
    kernel line reports, decode instances, likewise)."""
    log("== flash-attention kernel vs plain PyTorch version on the card")
    reqs = serving_requests(get_config(ARCH).vocab)
    mixtral = get_config(MIXTRAL_ARCH)
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
        # Mixtral's windowed prefill: H 32 / KV 8 at dh 128, window 4096,
        # past the window
        flash.append(check_flash("Mixtral prefill", 1, 5000, 5000, 32, 8,
                                 128, dt, window=mixtral.sliding_window,
                                 reps=5))
        # MiniCPM3's training attention (MLA's cacheless branch: q/k 96,
        # v 64, H = KV = 40) at the Trainer's 8 x 2048, and a ragged
        # 1 x 1001 (tail tiles, Sq % 4 != 0)
        for b, n in ((8, MINICPM3_TRAIN_SEQ), (1, 1001)):
            flash.append(check_flash("MiniCPM3 train" if b > 1 else
                                     "MiniCPM3 ragged", b, n, n, 40, 40, 96,
                                     dt, dv=64, reps=10 if b > 1 else 5))
    log("== flash-decode kernel vs plain PyTorch version on the card")
    lanes, max_len = SERVING.lanes, SERVING.max_len
    mid = [len(r.prompt) + SERVING.new_tokens // 2 for r in reqs[:lanes]]

    def edge(kv: int) -> list:
        # every length class the device split meets: none, one key, a
        # share boundary (visible keys a multiple of the splits times 128
        # rows, then one more), 255 and 256, S - 1, S, past S
        sms = decode_ops.sm_count(torch.device(DEV))
        b = decode_ops.split_plan(lanes, kv, max_len, sms) * 128
        return [0, 1, b - 1, b, 255, 256, max_len - 1, max_len,
                max_len + 40, 1000]

    decode = [check_decode("served decode", mid, max_len, 16, 16, 64,
                           torch.bfloat16)]
    decode_main = decode[0]
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32:
            decode.append(check_decode("served decode", mid, max_len, 16, 16,
                                       64, dt))
        decode.append(check_decode("edge lengths", edge(16), max_len, 16, 16,
                                   64, dt))
        decode.append(check_decode("llama GQA", mid, max_len, 24, 8, 128, dt))
        decode.append(check_decode("MQA", mid, max_len, 8, 1, 64, dt))
        decode.append(check_decode("Jamba decode", mid, max_len, 64, 8, 128,
                                   dt))
        decode.append(check_decode("Jamba edges", edge(8), max_len, 64, 8,
                                   128, dt))
        decode.append(check_decode("rep 32", mid, max_len, 32, 1, 128, dt))
        # Mixtral's windowed decode: H 32 / KV 8 at dh 128, its cache of
        # 8192 and window of 4096; lanes with nothing visible, below, at and
        # past the window, at S - 1, and an idle lane whose window lies past
        # the cache
        w, sm = mixtral.sliding_window, MIXTRAL_SERVING.max_len
        decode.append(check_decode(
            "Mixtral decode", [-1, 0, 100, w - 1, w, w + 1, 6000, sm - 1,
                               sm - 1 + 4200],
            sm, mixtral.n_heads, mixtral.n_kv_heads, mixtral.head_dim, dt,
            window=w))
    return flash, flash_main, decode, decode_main


def _device_kind(name: str) -> str:
    return ("flash_fwd" if "flash_fwd" in name else
            "flash_bwd" if any(k in name for k in
                               KERNEL_EVENTS["flash_attention_bwd"]) else
            "mla_prefill" if "mla_prefill_fwd" in name else
            "mla_decode" if "mla_decode_" in name else
            "mlstm_bwd" if "mlstm_bwd_" in name else
            "mlstm" if "mlstm_" in name else   # its four passes
            "mamba_scan_fwd" if "mamba_scan_fwd" in name else
            "mamba_scan_bwd" if "mamba_scan_bwd" in name else
            "decode_partial" if "decode_partial" in name else
            "decode_combine" if "decode_combine" in name else
            "gemm" if "gemm" in name.lower() or "nvjet" in name else
            "other")


def device_events(prof) -> list:
    """(name, seconds) of each event a profile recorded on the card, read
    from the profiler's raw results: parsing them into ``prof.events()``
    takes minutes at an xLSTM training step's ~10^6 events (its sLSTM
    loops), and these reads need no more than the name and duration."""
    return [(e.name(), e.duration_ns() / 1e9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _device_time(prof) -> tuple:
    """(events on the card, busy s, busy s by kind) of a profile."""
    on_dev = device_events(prof)
    by_kind: dict = {}
    for name, secs in on_dev:
        key = _device_kind(name)
        by_kind[key] = by_kind.get(key, 0.0) + secs
    return len(on_dev), sum(by_kind.values()), by_kind


def cuda_launches_per_call(prof, calls: dict) -> dict:
    """Each wrapper's CUDA launches a call in a traced run: the device
    events of its kernels (:data:`KERNEL_EVENTS`) over its calls in that
    run (``calls``: wrapper name -> calls); None where the profiler
    recorded no device events."""
    names = [name for name, _ in device_events(prof)]
    return {w: (sum(any(k in nm for k in KERNEL_EVENTS[w]) for nm in names)
                / c if names else None)
            for w, c in calls.items() if c}


def prefill_breakdown(p, cfg, req: Request, wrappers: dict,
                      max_len: int) -> dict:
    """Where one prefill's time goes (B = 1): its wall time; the host-clock
    time of each block kind (its mixer: attn, mamba, mlstm, slstm) and each
    FFN kind (moe, dense ffn), each between two synchronisations (a second
    run); the card's busy time by kernel kind, its idle share and the CUDA
    launches of each kernel wrapper's calls (a third run, under
    torch.profiler)."""
    prompt = torch.as_tensor(req.prompt, device=DEV)[None]
    run = lambda: prefill(p, cfg, prompt, max_len, DEV)  # noqa: E731
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
    # xLSTM-350M's training shape (the forward under grad, no state)
    inst.append(check_mlstm("xlstm-train", 8, 2048, h, dh, "none", reps=3))
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
    dep = DEPLOYMENTS.get(arch, SERVING)
    cfg = get_config(arch)
    if arch in SERVED_LAYERS:
        cfg = cfg.replace(n_layers=SERVED_LAYERS[arch])
    kinds = cfg.layer_kinds()
    reqs = serving_requests(cfg.vocab, dep)
    window = cfg.sliding_window
    if window and not all(len(r.prompt) > window
                          for r in reqs[:CHECK_REQUESTS]):
        raise AssertionError("the logits checks' requests must be longer "
                             "than the window")
    torch.cuda.empty_cache()            # what an earlier phase left cached
    log(f"== serving: {cfg.name}, {cfg.n_layers} layers "
        f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}"
        f"), d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"kv, head_dim {cfg.head_dim}, vocab {cfg.vocab}"
        + (f", MLA: q_lora_rank {cfg.q_lora_rank}, kv_lora_rank "
           f"{cfg.kv_lora_rank}, rope_head_dim {cfg.rope_head_dim}"
           if cfg.attention == "mla" else "")
        + (f", experts {cfg.expert_offset}-"
           f"{cfg.expert_offset + cfg.n_held - 1} of {cfg.n_experts} held, "
           f"top-{cfg.top_k}" if cfg.n_experts else "")
        + (f", sliding window {window}" if window else "")
        + f", {cfg.dtype}; {dep.describe()}")
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=DEV).manual_seed(SEED),
                         cfg, DEV, serve=True)
    eng = ServeEngine(params, cfg, n_lanes=dep.lanes, max_len=dep.max_len,
                      device=DEV)
    del params
    n_params = _numel(eng.params)
    held = {"params": _nbytes(eng.params), "caches": _nbytes(eng.caches)}
    torch.cuda.synchronize()
    log(f"  weights: {n_params} parameters, drawn into {cfg.dtype} in "
        f"{time.perf_counter() - t0:.3f} s; {torch.cuda.memory_allocated()} "
        f"B allocated")
    torch.cuda.reset_peak_memory_stats()
    # decode steps in which an active lane's window hides the first keys
    # (length >= window), read from the engine's host lengths before each
    # step: no synchronisation
    past = [0]

    def step_past_window():
        past[0] += any(r is not None and n >= window
                       for r, n in zip(eng.active, eng._lengths))
        return ServeEngine.step(eng)

    if window:
        eng.step = step_past_window
    for ops in wrappers.values():
        ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    serve_wall = time.perf_counter() - t0
    serve_launches = {name: ops.launches for name, ops in wrappers.items()}
    eng.__dict__.pop("step", None)
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)
    log(f"  launches: {serve_launches}")
    # a call per prefill (every prompt has >= 2 tokens) or per decode step,
    # for each layer of the kernel's kind
    n_req = dep.n_requests
    expected = {"flash_attention": n_req * kinds.count("attn"),
                "decode_attention": st["decode_steps"] * kinds.count("attn"),
                "mlstm": n_req * kinds.count("mlstm"),
                "mamba_scan": n_req * kinds.count("mamba"),
                "mla_prefill": n_req * kinds.count("attn"),
                "mla_decode": st["decode_steps"] * kinds.count("attn")}
    for name, n in serve_launches.items():
        want = expected[name]
        if n != want or n <= 0:
            raise AssertionError(f"the serving path launched {name} {n} "
                                 f"times (expected {want})")
    if len(done) != n_req or any(
            len(r.out_tokens) != dep.new_tokens
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
               "peak_mem_bytes": peak, "launches": serve_launches,
               "held_bytes": held,
               "weights": n_params}
    log(f"  engine wall {serve_wall:.6f} s; prefill {st['prefill_tokens']} "
        f"tokens in {st['prefill_s']:.6f} s ({prefill_tps:.1f} tok/s); "
        f"decode {st['decode_steps']} steps, {st['decode_tokens']} tokens "
        f"in {st['decode_s']:.6f} s ({step_ms:.4f} ms/step, "
        f"{decode_tps:.1f} tok/s); peak memory {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    if window:
        n_past = past[0] * kinds.count("attn")
        serving["decode_steps_past_window"] = past[0]
        serving["decode_launches_past_window"] = n_past
        log(f"  decode steps with an active lane past the window ({window} "
            f"keys): {past[0]} of {st['decode_steps']}, {n_past} decode "
            f"launches")
        if not n_past > 0:
            raise AssertionError("no decode launch had a lane past the "
                                 "window")
    log(f"  request 0: {len(reqs[0].prompt)} prompt tokens -> "
        f"{reqs[0].out_tokens[:8]}...")
    serving["prefill_breakdown"] = prefill_breakdown(
        eng.params, cfg, max(reqs, key=lambda r: len(r.prompt)), wrappers,
        dep.max_len)

    # a traced rerun of decode steps: the device's idle share
    log(f"== traced decode: {dep.lanes} lanes admitted, {TRACED_STEPS} steps "
        f"(torch.profiler)")
    for r in serving_requests(cfg.vocab, dep)[:dep.lanes]:
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
    # F32_HELD of them in f32, so that its f32 weights fit the card),
    # each beside its controls.  In f32 the check requests are first served
    # by a two-lane engine whose own logits are recorded, so that the
    # engine's path (prefill caches spliced into lanes, lanes decoded as one
    # batch) is held in f32 too; each type's requests are then fed the
    # tokens their engine served
    reqs32 = [Request(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=CHECK_STEPS + 1)
              for r in reqs[:CHECK_REQUESTS]]
    checks, tokens, failures = [], [], []
    serving["checks_s"] = {}
    for is32 in (False, True):
        t_checks = time.perf_counter()
        if is32:
            p = eng = None
            torch.cuda.empty_cache()
            c = cfg.replace(dtype="float32")
            if arch in F32_HELD:
                c = c.replace(experts_held=F32_HELD[arch])
            p = init_params(torch.Generator(device=DEV).manual_seed(SEED), c,
                            DEV)
            served = reqs32
            served32 = engine_logits(p, c, reqs32, dep.max_len)
        else:
            p, c, served = eng.params, cfg, reqs[:CHECK_REQUESTS]
        dt = getattr(torch, c.dtype)
        where = (f"a {CHECK_REQUESTS}-lane engine" if is32 else
                 f"the engine's {dep.lanes} lanes")
        nudge = not is32 and bf16_gated is not True and "attn" in kinds
        chks, plains = [], []
        for r in served:
            chk, plain = check_logits(p, c, r, controls, dep.max_len,
                                      nudged=nudge)
            chks.append(chk)
            plains.append(plain)
        # "nudge": the bf16 gate holds unless the plain path against itself
        # with q nudged by 2^-9 already moves past it
        steady = nudge and all(x["plain_nudged"]["max_rel_diff"]
                               <= LOGIT_TOL[dt] for x in chks)
        gated = is32 or bf16_gated is True or (bf16_gated == "nudge"
                                               and steady)
        gate = LOGIT_TOL[dt] if gated else None
        log(f"== logits of {CHECK_REQUESTS} requests fed the tokens "
            f"{where} served them, {c.dtype}: kernels vs plain versions, "
            f"prefill + {CHECK_STEPS} decode steps"
            + (", and the engine's own logits vs plain" if is32 else "")
            + " (" + (f"gate {gate:g} of the largest |logit|" if gate else
                      "read, no gate") + "), and the controls"
            + (f"; gated as the plain path nudged by 2^-9 stays within "
               f"{LOGIT_TOL[dt]:g}" if bf16_gated == "nudge" and gated
               and not is32 else
               f"; read, as the plain path nudged by 2^-9 moves past "
               f"{LOGIT_TOL[dt]:g}" if bf16_gated == "nudge" and not is32
               else ""))
        for i, (r, chk, plain) in enumerate(zip(served, chks, plains)):
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
            log(f"  request {chk['rid']} ({chk['prompt']} prompt tokens): "
                f"max rel diff {chk['max_rel_diff']:.3e}; per position "
                f"{[f'{x:.2e}' for x in chk['per_step']]}; "
                + (f"the engine's own logits: max rel diff "
                   f"{chk['engine_max_rel_diff']:.3e}; "
                   if "engine_max_rel_diff" in chk else "")
                + (f"router decisions flipped {chk['router_flips']:.3e}; "
                   if chk["router_flips"] is not None else "")
                + (f"the plain versions with q nudged by 2^-9: "
                   f"{json.dumps(chk['plain_nudged'])}; "
                   if "plain_nudged" in chk else "")
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
        serving["checks_s"][c.dtype] = time.perf_counter() - t_checks
        log(f"  {c.dtype} checks {serving['checks_s'][c.dtype]:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    serving["served_tokens"] = tokens
    serving["logit_checks"] = checks
    return serving


def whisper_kernel_checks() -> tuple:
    """Both attention kernels against their plain versions at Whisper's
    shapes: the encoder's non-causal self-attention over its frames, the
    cross-attention prefill (the prompt over the encoder rows, Sq != Sk),
    the decoder's causal prefill, key counts at the tail of the last key
    tile (a full tile, one key past it), the cross decode (every lane over
    all encoder rows) and the self decode; returns (flash instances,
    decode instances), the encoder's and the cross decode's bf16 first."""
    log("== attention kernels vs plain PyTorch versions at Whisper-tiny's "
        "shapes")
    cfg = get_config(WHISPER_ARCH)
    h, dh, se, b = cfg.n_heads, cfg.head_dim, cfg.enc_seq, WHISPER_LANES
    tail = se - se % 64                 # the last full 64-key tile's end
    flash, decode = [], []
    for dt in (torch.bfloat16, torch.float32):
        flash.append(check_flash("Whisper encoder", b, se, se, h, h, dh, dt,
                                 causal=False, reps=5))
        flash.append(check_flash("Whisper cross", b, WHISPER_PROMPT, se, h, h,
                                 dh, dt, causal=False))
        flash.append(check_flash("Whisper prefill", b, WHISPER_PROMPT,
                                 WHISPER_PROMPT, h, h, dh, dt))
        for sq, sk in ((1, se), (130, se), (130, tail), (130, tail + 1)):
            flash.append(check_flash("Whisper tail", 2 if sq == 1 else 1, sq,
                                     sk, h, h, dh, dt, causal=False, reps=5))
        decode.append(check_decode("Whisper cross", [se - 1] * b, se, h, h,
                                   dh, dt))
        decode.append(check_decode(
            "Whisper self", [WHISPER_PROMPT + WHISPER_NEW // 2] * b,
            WHISPER_MAX_LEN, h, h, dh, dt))
    return flash, decode


def whisper_inputs(cfg) -> tuple:
    """Each lane's stubbed frames (WHISPER_LANES, enc_seq, d), f32, and its
    WHISPER_PROMPT-token prompt, both from SEED."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    frames = torch.randn(WHISPER_LANES, cfg.enc_seq, cfg.d_model,
                         generator=gen, device=DEV)
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(
        1, cfg.vocab, size=(WHISPER_LANES, WHISPER_PROMPT)), device=DEV)
    return frames, prompt


def whisper_logits(p, cfg, frames, prompt, feed, plain: bool = False):
    """Logits (f32, (B, V)) of ``prefill(frames=)``, then of one
    ``decode_step(cross_kv=)`` per column of ``feed`` (B, n), or, with
    ``feed`` an int n, per token of the path's own greedy choice.  Returns
    (the logits, the tokens fed (B, n))."""
    lg, caches, ln, cross = prefill(p, cfg, prompt, WHISPER_MAX_LEN, DEV,
                                    plain=plain, frames=frames)
    out, fed = [lg.float()], []
    n = feed if isinstance(feed, int) else feed.shape[1]
    for i in range(n):
        tok = (torch.argmax(lg, dim=-1)[:, None] if isinstance(feed, int)
               else feed[:, i:i + 1])
        fed.append(tok)
        lg, caches = decode_step(p, cfg, tok, caches, ln + i, DEV,
                                 plain=plain, cross_kv=cross)
        out.append(lg.float())
    return out, torch.cat(fed, dim=1)


def _lane_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """:func:`_rel` of each lane (row) of two (B, V) logits, the largest."""
    return max(_rel(x, y) for x, y in zip(a, b))


def whisper_phases() -> dict:
    """Whisper-tiny served whole: 8 lanes through ``prefill(frames=)`` and
    ``decode_step(cross_kv=)`` with the launch counts set to 0 just before
    and read just after; its encode, prefill and decode times, a traced
    decode, peak memory; then the logits checks (bf16 by the nudge rule,
    f32 gated against the plain path with its controls and against the
    teacher-forced ``forward``).  Returns what they measured."""
    cfg = get_config(WHISPER_ARCH)
    card = nvidia_smi()
    wrappers = {"flash_attention": flash_ops, "decode_attention": decode_ops}
    torch.cuda.empty_cache()
    log(f"== serving: {cfg.name}, {cfg.n_enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.enc_seq} "
        f"frames, {cfg.dtype}; {WHISPER_LANES} lanes, prompts of "
        f"{WHISPER_PROMPT} tokens, {WHISPER_NEW} new tokens, cache "
        f"{WHISPER_MAX_LEN}, seed {SEED}; prefill(frames=) and "
        f"decode_step(cross_kv=)")
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=DEV).manual_seed(SEED), cfg,
                         DEV, serve=True)
    frames, prompt = whisper_inputs(cfg)
    n_params = _numel(params)
    torch.cuda.synchronize()
    log(f"  weights: {n_params} tensor entries ({cfg.param_count()} by "
        f"param_count), drawn into {cfg.dtype} in "
        f"{time.perf_counter() - t0:.3f} s")

    # a warm-up of the path (its first prefill pays one-time set-up: 48.4
    # ms against 3.9 for the encoder, NVIDIA H100 80GB HBM3, 700 W), then
    # the encoder alone at B lanes, both outside the counted run
    lg, caches, ln, cross = prefill(params, cfg, prompt, WHISPER_MAX_LEN,
                                    DEV, frames=frames)
    for i in range(2):
        lg, caches = decode_step(params, cfg, torch.argmax(lg, -1)[:, None],
                                 caches, ln + i, DEV, cross_kv=cross)
    del caches, cross
    torch.cuda.synchronize()
    enc_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        T.encode(params, cfg, frames)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
    encode_ms = sum(enc_s) / len(enc_s) * 1e3

    # the main path: prefill, then a decode step a token, each step's
    # tokens read back as a transcription service streams them
    torch.cuda.reset_peak_memory_stats()
    for ops in wrappers.values():
        ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches, ln, cross = prefill(params, cfg, prompt, WHISPER_MAX_LEN,
                                    DEV, frames=frames)
    tok = torch.argmax(lg, dim=-1)[:, None]
    first = lg
    toks = [tok.flatten().tolist()]
    prefill_s = time.perf_counter() - t0
    steps = WHISPER_NEW - 1
    t0 = time.perf_counter()
    for i in range(steps):
        lg, caches = decode_step(params, cfg, tok, caches, ln + i, DEV,
                                 cross_kv=cross)
        tok = torch.argmax(lg, dim=-1)[:, None]
        toks.append(tok.flatten().tolist())
    decode_s = time.perf_counter() - t0
    launches = {name: ops.launches for name, ops in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    expected = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
                "decode_attention": steps * 2 * cfg.n_layers}
    log(f"  launches: {launches} (expected {expected})")
    for name, n in launches.items():
        if n != expected[name] or n <= 0:
            raise AssertionError(f"the Whisper path launched {name} {n} "
                                 f"times (expected {expected[name]})")
    tokens = np.array(toks).T                   # (lanes, WHISPER_NEW)
    if (tokens.shape != (WHISPER_LANES, WHISPER_NEW)
            or not ((tokens >= 0) & (tokens < cfg.vocab)).all()
            or not bool(torch.isfinite(first).all())
            or not bool(torch.isfinite(lg).all())):
        raise AssertionError("the Whisper path gave tokens out of range or "
                             "logits that are not finite")
    want = (WHISPER_LANES, cfg.enc_seq, cfg.d_model)
    if (tuple(cross.shape) != want or cross.dtype != getattr(torch, cfg.dtype)
            or not bool(torch.isfinite(cross).all())):
        raise AssertionError(f"the encoder output is {tuple(cross.shape)} "
                             f"{cross.dtype} (expected {want} {cfg.dtype}, "
                             f"finite)")
    step_ms = decode_s / steps * 1e3
    tok_s = WHISPER_LANES * steps / decode_s
    res = {"card": card, "encode_ms": encode_ms,
           "prefill_ms": prefill_s * 1e3, "decode_s": decode_s,
           "decode_steps": steps, "decode_ms_per_step": step_ms,
           "decode_tok_per_s": tok_s, "peak_mem_bytes": peak,
           "launches": launches, "weights": n_params,
           "tokens_lane0": tokens[0, :16].tolist()}
    log(f"  [{card}] encode {encode_ms:.4f} ms at B {WHISPER_LANES}; "
        f"prefill (encode included) {prefill_s * 1e3:.4f} ms; decode "
        f"{steps} steps in {decode_s:.6f} s ({step_ms:.4f} ms/step, "
        f"{tok_s:.1f} tok/s); peak memory {peak} B "
        f"({peak / 2**30:.3f} GiB); lane 0: {tokens[0, :16].tolist()}...")

    # a traced rerun of decode steps: the device's idle share
    lg, caches, ln, cross = prefill(params, cfg, prompt, WHISPER_MAX_LEN,
                                    DEV, frames=frames)
    tok = torch.argmax(lg, dim=-1)[:, None]
    calls = {w: -ops.launches for w, ops in wrappers.items()}
    torch.cuda.synchronize()
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        t0 = time.perf_counter()
        for i in range(TRACED_STEPS):
            lg, caches = decode_step(params, cfg, tok, caches, ln + i, DEV,
                                     cross_kv=cross)
            tok = torch.argmax(lg, dim=-1)[:, None]
            tok.flatten().tolist()
        traced_wall = time.perf_counter() - t0
    calls = {w: n + wrappers[w].launches for w, n in calls.items()}
    res["traced_cuda_launches_per_call"] = cuda_launches_per_call(prof,
                                                                  calls)
    n_ev, busy, by_kind = _device_time(prof)
    if n_ev:
        res.update(traced_idle_share=1 - busy / traced_wall,
                   traced_busy_s=busy, traced_wall_s=traced_wall,
                   traced_events_per_step=n_ev / TRACED_STEPS,
                   traced_device_s_by_kind=by_kind)
        log(f"  [{card}] traced decode, {TRACED_STEPS} steps: {n_ev} device "
            f"events ({n_ev / TRACED_STEPS:.1f} per step); device busy "
            f"{busy:.6f} s of {traced_wall:.6f} s (idle share "
            f"{1 - busy / traced_wall:.4f}); by kind (s): "
            f"{json.dumps(by_kind)}; CUDA launches a wrapper call "
            f"{json.dumps(res['traced_cuda_launches_per_call'])}")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")
    del caches, cross, lg

    failures = []
    # bf16: kernels against plain versions, fed the served tokens; gated
    # unless the plain path nudged by 2^-9 already moves past the gate
    t_checks = time.perf_counter()
    feed = torch.as_tensor(tokens[:, :CHECK_STEPS], device=DEV)
    kern, _ = whisper_logits(params, cfg, frames, prompt, feed)
    plain, _ = whisper_logits(params, cfg, frames, prompt, feed, plain=True)
    with swapped(L, "attention_ref", q_nudged(attention_ref)), \
            swapped(L, "decode_attention_ref",
                    q_nudged(decode_attention_ref)):
        nudge, _ = whisper_logits(params, cfg, frames, prompt, feed,
                                  plain=True)
    bf16 = torch.bfloat16
    rel = [_lane_rel(a, b) for a, b in zip(kern, plain)]
    nudged = max(_lane_rel(a, b) for a, b in zip(nudge, plain))
    gate = LOGIT_TOL[bf16] if nudged <= LOGIT_TOL[bf16] else None
    own = tokens[:, :CHECK_STEPS + 1]
    gaps = [max(_gaps([x[i] for x in plain], own[i].tolist()))
            for i in range(WHISPER_LANES)]
    res["bf16_check"] = {"max_rel_diff": max(rel), "per_step": rel,
                         "plain_nudged": nudged, "gate": gate,
                         "token_max_gap": max(gaps), "token_gaps": gaps}
    log(f"== Whisper logits, bf16, {WHISPER_LANES} lanes fed their served "
        f"tokens: kernels vs plain versions, prefill + {CHECK_STEPS} decode "
        f"steps: max rel diff {max(rel):.3e}, per position "
        f"{[f'{x:.2e}' for x in rel]}; the plain versions with q nudged by "
        f"2^-9: {nudged:.3e} ("
        + (f"gate {gate:g}" if gate else
           f"read, as the nudge moves past {LOGIT_TOL[bf16]:g}")
        + f"); served tokens' largest gap below the plain maximum "
        f"{max(gaps):.3e}")
    if gate is not None:
        if not max(rel) <= gate:
            failures.append(f"bf16 Whisper logits differ from the plain "
                            f"versions' by {max(rel):.3e} (gate {gate:g})")
        if not max(gaps) <= 2 * gate:
            failures.append(f"a served bf16 Whisper token sits "
                            f"{max(gaps):.3e} below the plain maximum "
                            f"(limit {2 * gate:g})")
    del params, kern, plain, nudge
    torch.cuda.empty_cache()

    # f32: the same weights drawn anew in f32; the kernel path's own greedy
    # tokens fed to the plain versions, the controls and forward
    c32 = cfg.replace(dtype="float32")
    p32 = init_params(torch.Generator(device=DEV).manual_seed(SEED), c32,
                      DEV)
    gate = LOGIT_TOL[torch.float32]
    kern, fed = whisper_logits(p32, c32, frames, prompt, CHECK_STEPS)
    plain, _ = whisper_logits(p32, c32, frames, prompt, fed, plain=True)
    rel = [_lane_rel(a, b) for a, b in zip(kern, plain)]
    readings = {}
    for name, (module, attr, fn) in WHISPER_CONTROLS.items():
        with swapped(module, attr, fn):
            bad, _ = whisper_logits(p32, c32, frames, prompt, fed)
        readings[name] = max(_lane_rel(a, b) for a, b in zip(bad, plain))
    h, _ = forward(p32, c32, torch.cat([prompt, fed], dim=1), frames=frames,
                   device=DEV)
    full = T.logits_fn(p32, c32, h[:, WHISPER_PROMPT - 1:]).float()
    fwd = [_lane_rel(full[:, j], kern[j]) for j in range(CHECK_STEPS + 1)]
    own = torch.cat([fed, torch.argmax(kern[-1], dim=-1)[:, None]], 1)
    gaps = [max(_gaps([x[i] for x in plain], own[i].tolist()))
            for i in range(WHISPER_LANES)]
    res["f32_check"] = {"max_rel_diff": max(rel), "per_step": rel,
                        "controls": readings, "gate": gate,
                        "forward_max_rel_diff": max(fwd),
                        "forward_per_step": fwd,
                        "token_max_gap": max(gaps)}
    log(f"== Whisper logits, f32, {WHISPER_LANES} lanes fed the kernel "
        f"path's greedy tokens: kernels vs plain versions, prefill + "
        f"{CHECK_STEPS} decode steps (gate {gate:g}): max rel diff "
        f"{max(rel):.3e}, per position {[f'{x:.2e}' for x in rel]}; "
        f"controls {json.dumps(readings)}; the served logits vs the "
        f"teacher-forced forward on the card: {max(fwd):.3e}; greedy "
        f"tokens' largest gap below the plain maximum {max(gaps):.3e}")
    if not max(rel) <= gate:
        failures.append(f"f32 Whisper logits differ from the plain "
                        f"versions' by {max(rel):.3e} (gate {gate:g})")
    for name, x in readings.items():
        if not x > gate:
            failures.append(f"control {name} reads {x:.3e}, inside the f32 "
                            f"gate: the check cannot tell that kernel fault")
    if not max(fwd) <= gate:
        failures.append(f"the served f32 Whisper logits differ from the "
                        f"teacher-forced forward's by {max(fwd):.3e} (gate "
                        f"{gate:g})")
    if not max(gaps) <= 2 * gate:
        failures.append(f"an f32 Whisper token sits {max(gaps):.3e} below "
                        f"the plain maximum (limit {2 * gate:g})")
    res["checks_s"] = time.perf_counter() - t_checks
    log(f"  checks {res['checks_s']:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return res


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


def fct_diff(fa: np.ndarray, fb: np.ndarray) -> tuple:
    """(flows whose FCTs differ, the largest difference in slots)."""
    differ = ~((fa == fb) | (np.isnan(fa) & np.isnan(fb)))
    n_diff = int(differ.sum())
    return n_diff, (float(np.abs(fa[differ] - fb[differ]).max())
                    if n_diff else 0.0)


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
        fa = ra.fct_slots
        n_diff, max_diff = fct_diff(fa, rb.fct_slots)
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


def check_sweep_rows(rows: list, twohop_fcts: bool) -> None:
    """Each sweep row is finite and sane: single-hop rows, and two-hop
    rows where their route keeps per-flow FCTs (``twohop_fcts``), have
    finite FCTs; aggregate-only two-hop rows have FCTs all inf, as in the
    reference; two-hop rows average at least one hop, vlb's at least
    rotorlb's on the same load."""
    hops = {}
    for r in rows:
        res = r.result
        fin = np.isfinite(res.fct_slots)
        if not (np.isfinite(res.utilization) and res.utilization > 0):
            raise AssertionError(f"{r.label}: no finite utilization")
        if r.mode == "single_hop" or twohop_fcts:
            if not fin.any():
                raise AssertionError(f"{r.label}: no finite FCT")
        elif fin.any():
            raise AssertionError(f"{r.label}: an aggregate-only route "
                                 "gave finite FCTs")
        if r.mode != "single_hop":
            if not res.avg_hops >= 1.0:
                raise AssertionError(f"{r.label}: avg_hops {res.avg_hops}")
            hops[(r.meta["load"], r.mode)] = res.avg_hops
        log(f"  {r.label}: util {res.utilization:.6f}, delivered "
            f"{res.delivered_bits:.6e} b of {res.offered_bits:.6e}, "
            f"avg_hops {res.avg_hops:.6f}, completed "
            f"{res.completed_frac:.6f}, FCT p50 "
            f"{res.fct_percentile(50):.3f} p99 {res.fct_percentile(99):.3f} "
            f"slots")
    for (load, mode), h in hops.items():
        if mode == "vlb" and h < hops.get((load, "rotorlb"), 1.0):
            raise AssertionError(f"vlb@{load}: avg_hops {h} below "
                                 f"rotorlb's {hops[(load, 'rotorlb')]}")


def compare_sweep(rows: list, rows_cpu: list) -> None:
    """The card's sweep rows against the port's CPU run of the same
    cases: delivered bits, utilization and avg_hops within rtol 1e-5
    (single-hop) or ``TWOHOP_RTOL`` (two-hop), FCTs within the sweep's
    bar."""
    for a, b in zip(rows, rows_cpu):
        ra, rb = a.result, b.result
        rtol = 1e-5 if a.mode == "single_hop" else TWOHOP_RTOL
        rel = max(abs(getattr(ra, f) - getattr(rb, f)) / abs(getattr(rb, f))
                  for f in ("delivered_bits", "utilization", "avg_hops"))
        n_diff, max_diff = fct_diff(ra.fct_slots, rb.fct_slots)
        log(f"  {a.label}: aggregates rel diff {rel:.3e}; FCTs differ on "
            f"{n_diff} of {len(ra.fct_slots)} flows, by at most {max_diff} "
            f"slots")
        if rel > rtol:
            raise AssertionError(f"{a.label}: aggregates differ by "
                                 f"{rel:.3e} (rtol {rtol})")
        if n_diff > FCT_MAX_DIFF_FRAC * len(ra.fct_slots) \
                or max_diff > FCT_MAX_DIFF_SLOTS:
            raise AssertionError(f"{a.label}: FCTs differ on {n_diff} flows "
                                 f"by up to {max_diff} slots")


def log_batches(timings: dict) -> None:
    """Each batch's route, cases, slots and slot loop of a run_sweep."""
    for bt in timings["batches"]:
        log(f"  batch {bt['route']}: {bt['cases']} cases, {bt['slots']} "
            f"slots, layout {bt['layout_s']:.6f} s, device loop "
            f"{bt['device_loop_s']:.6f} s "
            f"({bt['device_loop_s'] / bt['slots'] * 1e6:.3f} us per slot)"
            + (f", replay {bt['replay_s']:.6f} s" if "replay_s" in bt
               else ""))


def traced_sweep(label: str, cases: list) -> dict:
    """A rerun of ``cases`` through ``run_sweep`` on the card under
    torch.profiler: the data plane's device events a slot, its slot loop
    (traced) and the loop's idle share."""
    log(f"== traced rerun of the card sweep, {label} (torch.profiler)")
    traced: dict = {}
    t0 = time.perf_counter()
    with profile(activities=list(TRACE_ACTIVITIES)) as prof:
        run_sweep(cases, BITS_PER_SLOT, device=DEV, timings=traced)
    traced_s = time.perf_counter() - t0
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in on_dev if e.name.startswith(("Memcpy", "Memset"))]
    kern = [e for e in on_dev if not e.name.startswith(("Memcpy", "Memset"))]
    loop = traced["device_loop_s"]
    out = {"traced_s": traced_s, "device_loop_s": loop,
           "slots": traced["slots"],
           "us_per_slot": loop / traced["slots"] * 1e6}
    log(f"  traced sweep {traced_s:.6f} s; traced device loop {loop:.6f} s "
        f"({out['us_per_slot']:.3f} us per slot)")
    if kern:
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
        copy = sum(e.time_range.elapsed_us() for e in copies) / 1e6
        out.update(kernels=len(kern),
                   events_per_slot=len(kern) / traced["slots"],
                   busy_s=busy, idle_share=1 - busy / loop, copies_s=copy)
        log(f"  data plane: {len(kern)} kernels "
            f"({out['events_per_slot']:.3f} per slot), device busy "
            f"{busy:.6f} s of the {loop:.6f} s loop (idle share "
            f"{out['idle_share']:.4f}); copies {copy:.6f} s")
    else:
        log("  the profiler recorded no device events: device busy time "
            "not measured")
    return out


def sweep_n64_phases() -> dict:
    """The n = 64 grid: Vermilion (one Sinkhorn launch, counted from 0),
    rotorlb and vlb in one ``run_sweep`` on the card, the two-hop batch
    through ``twohop_fct`` with per-flow FCTs; the port's CPU run of the
    same cases; ``simulate_aggregate`` on the Vermilion schedule, card
    against CPU; a traced rerun of the two-hop batch."""
    log(f"== n={N64} grid: d_hat={D_HAT64}, load {LOAD64}, {HORIZON64} "
        f"slots, seed {SEED}: vermilion, {', '.join(TWOHOP_MODES)}")
    sinkhorn_ops.reset_launches()
    wl = websearch_workload(N64, LOAD64, HORIZON64, BITS_PER_SLOT,
                            d_hat=D_HAT64, seed=SEED)
    sv = vermilion_schedule(wl.demand_matrix(), k=K, d_hat=D_HAT64,
                            recfg_frac=RECFG, normalize="saturate")
    so = oblivious_schedule(N64, d_hat=D_HAT64, recfg_frac=RECFG)
    meta = {"load": LOAD64}
    cases = [SweepCase(sv, wl, "single_hop", "vermilion", meta)]
    cases += [SweepCase(so, wl, m, m, meta) for m in TWOHOP_MODES]
    timings: dict = {}
    t0 = time.perf_counter()
    rows = run_sweep(cases, BITS_PER_SLOT, device=DEV, sanitize=True,
                     timings=timings)
    wall = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    log(f"  run_sweep on the card {wall:.6f} s, flows {wl.num_flows}, "
        f"sinkhorn launches {launches}")
    if launches != 1:
        raise AssertionError(f"the n={N64} grid launched the sinkhorn "
                             f"kernel {launches} times (expected 1)")
    log_batches(timings)
    routes = [(bt["route"], bt["cases"]) for bt in timings["batches"]]
    if routes != [("singlehop", 1), ("twohop_fct", len(TWOHOP_MODES))]:
        raise AssertionError(f"the n={N64} grid ran the batches {routes}")
    check_sweep_rows(rows, twohop_fcts=True)
    t0 = time.perf_counter()
    rows_cpu = run_sweep(cases, BITS_PER_SLOT, device="cpu", sanitize=True)
    cpu_s = time.perf_counter() - t0
    log(f"  the same cases on the CPU {cpu_s:.6f} s")
    compare_sweep(rows, rows_cpu)

    log(f"== aggregate plane: simulate_aggregate on the n={N64} Vermilion "
        f"schedule, {HORIZON64} x {N64} x {N64} arrivals")
    arr = wl.arrival_matrix()
    t0 = time.perf_counter()
    d_card, voq_card = simulate_aggregate(sv, arr, BITS_PER_SLOT, device=DEV)
    agg_s = time.perf_counter() - t0
    d_cpu, voq_cpu = simulate_aggregate(sv, arr, BITS_PER_SLOT, device="cpu")
    rel = float(np.max(np.abs(d_card - d_cpu)
                       / np.maximum(np.abs(d_cpu), 1e-300)))
    voq_diff = float(np.abs(voq_card - voq_cpu).max())
    sweep_rel = abs(float(d_card.sum(dtype=np.float64))
                    - rows[0].result.delivered_bits) \
        / rows[0].result.delivered_bits
    log(f"  card {agg_s:.6f} s ({agg_s / HORIZON64 * 1e6:.3f} us per slot "
        f"with upload and download); delivered {d_card.sum():.6e} b, per "
        f"slot rel diff to the CPU {rel:.3e}, final VOQ max |diff| "
        f"{voq_diff:.3e} b; total vs the single-hop sweep's {sweep_rel:.3e}")
    if not np.allclose(d_card, d_cpu, rtol=AGG_RTOL, atol=0.0):
        raise AssertionError(f"simulate_aggregate: per-slot delivered "
                             f"differs from the CPU's by {rel:.3e}")
    if voq_diff > AGG_VOQ_ATOL:
        raise AssertionError(f"simulate_aggregate: final VOQ differs from "
                             f"the CPU's by {voq_diff:.3e} bits")
    trace = traced_sweep(f"n={N64} two-hop ({routes[1][0]})", cases[1:])
    return {"launches": launches, "wall_s": wall, "cpu_s": cpu_s,
            "timings": {k: v for k, v in timings.items() if k != "batches"},
            "batches": timings["batches"], "trace": trace,
            "rows": {r.label: {"util": r.result.utilization,
                               "avg_hops": r.result.avg_hops,
                               "completed": r.result.completed_frac,
                               "fct_p99": r.result.fct_percentile(99)}
                     for r in rows},
            "aggregate": {"wall_s": agg_s, "slot_rel_diff": rel,
                          "voq_max_diff": voq_diff,
                          "vs_sweep_rel": sweep_rel}}


def certify_cli(argv: list, device: str) -> tuple:
    """``python -m repro_torch.analysis.certify`` on ``argv`` with
    ``--device``, in this process: (exit code, the certificate it wrote,
    its report)."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "cert.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = certify.main(argv + ["--device", device, "--json",
                                      str(path)])
        return rc, json.loads(path.read_text()), buf.getvalue()


def certificate_diff(got: dict, want: dict, theta_rtol: float) -> str:
    """Where two certificates differ ("" if nowhere): everything exactly,
    theta within ``theta_rtol``."""
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    tg, tw = got["bounds"].pop("theta"), want["bounds"].pop("theta")
    if got != want:
        return "schedule, demand, bounds, checks or violations differ"
    if abs(tg - tw) > theta_rtol * abs(tw):
        return f"theta {tg!r} against {tw!r} (rtol {theta_rtol:g})"
    return ""


def expect_launches(path: str, got: int, want: int) -> None:
    log(f"  {path}: {got} sinkhorn launches (expected {want})")
    if got != want:
        raise AssertionError(f"{path} launched the sinkhorn kernel {got} "
                             f"times (expected {want})")


def term_slots(sched, perms: np.ndarray) -> np.ndarray:
    """How many of ``sched``'s slots each BvN term's matching holds."""
    return np.array([(sched.perms == p).all(axis=1).sum() for p in perms])


def throughput_phases(scheds: list, wls: list) -> dict:
    """The paper's throughput analysis on the port, each card path read
    between its own resets of the Sinkhorn count: (a) Fig. 7's analytic
    table (host) and (b) its flow-level cross-check (saturate schedules,
    one ``run_sweep`` on the card) against the CPU run; (c) Fig. 8 (host);
    (d) the main path's four n = 256 saturate schedules certified on the
    card, the CI's two golden invocations and the saturate golden through
    the CLI, each against the CPU's certificate; (e) BvN's Theorem 1 and
    the quantized strawman, card against CPU; (f) the interconnect
    pricing (host) and its flow-level drain on the card against the CPU
    run.  Returns seconds by sub-phase, launches by path and the rows."""
    log("== throughput analysis: Fig. 7 / 8, certificates, BvN, "
        "interconnect pricing")
    secs: dict = {}
    launches: dict = {}
    out: dict = {"seconds": secs, "launches": launches}
    t_phase = time.perf_counter()

    # (a) Fig. 7, analytic
    t0 = time.perf_counter()
    sinkhorn_ops.reset_launches()
    rows = throughput_bench.run(n=FIG7_N, d_hat=FIG7_D_HAT, ks=FIG7_KS)
    secs["fig7_analytic_s"] = time.perf_counter() - t0
    cols = [f"vermilion_k{k}" for k in FIG7_KS] + [
        "oblivious_multihop", "oblivious_singlehop"]
    for r in rows:
        log(f"  fig7 {r['demand']:12s} " + " ".join(
            f"{c} {r[c]:.6f}" for c in cols)
            + " " + " ".join(f"bound_k{k} {r[f'bound_k{k}']:.6f}"
                             for k in FIG7_KS))
        for k in FIG7_KS:
            if r[f"vermilion_k{k}"] < r[f"bound_k{k}"] - 1e-9:
                raise AssertionError(f"fig7 {r['demand']}: Vermilion at k "
                                     f"{k} below Theorem 3")
    out["fig7"] = [{c: r[c] for c in ["demand"] + cols} for r in rows]

    # (b) Fig. 7, flow level: saturate schedules through the kernel
    t0 = time.perf_counter()
    cases = throughput_bench.simulated_cases(
        FIG7_N, FIG7_D_HAT, FIG7_HORIZON, FIG7_DEMANDS, device=DEV)
    sim = run_sweep(cases, throughput_bench.BITS_PER_SLOT, device=DEV,
                    sanitize=True)
    secs["fig7_sim_s"] = time.perf_counter() - t0
    launches["throughput_fig7"] = sinkhorn_ops.launches
    expect_launches("throughput_fig7", launches["throughput_fig7"],
                    len(FIG7_DEMANDS))
    t0 = time.perf_counter()
    cases_cpu = throughput_bench.simulated_cases(
        FIG7_N, FIG7_D_HAT, FIG7_HORIZON, FIG7_DEMANDS, device="cpu")
    for a, b in zip(cases, cases_cpu):
        if not np.array_equal(a.sched.perms, b.sched.perms):
            raise AssertionError(f"{a.label}: the card's schedule differs "
                                 f"from the CPU's")
    sim_cpu = run_sweep(cases_cpu, throughput_bench.BITS_PER_SLOT,
                        device="cpu", sanitize=True)
    secs["fig7_sim_cpu_s"] = time.perf_counter() - t0
    analytic = {r["demand"]: r for r in rows}
    for r in sim:
        res = r.result
        demand, system = r.label.split("/")
        theta = (analytic[demand]["vermilion_k3"] if system == "vermilion"
                 else analytic[demand]["oblivious_multihop"]
                 if system == "rotorlb"
                 else analytic[demand]["oblivious_singlehop"])
        log(f"  fig7 sim {r.label:24s} util {res.utilization:.6f} "
            f"(analytic {theta:.6f}), completed {res.completed_frac:.6f}")
    compare_sweep(sim, sim_cpu)
    out["fig7_sim"] = [{"label": r.label, "util": r.result.utilization,
                        "done": r.result.completed_frac} for r in sim]

    # (c) Fig. 8: hose schedules, host only
    t0 = time.perf_counter()
    sinkhorn_ops.reset_launches()
    fig8 = {"vs_k": bound_convergence.vs_k(),
            "vs_n": bound_convergence.vs_n()}
    secs["fig8_s"] = time.perf_counter() - t0
    for key, rs in fig8.items():
        for r in rs:
            x = "k" if key == "vs_k" else "n"
            log(f"  fig8 {key} {x}={r[x]:2d}: min {r['min']:.6f} mean "
                f"{r['mean']:.6f} bound {r['bound']:.6f}")
            if r["min"] < r["bound"] - 1e-9:
                raise AssertionError(f"fig8 {key} {x}={r[x]}: below "
                                     f"Theorem 3")
    expect_launches("fig8 (hose)", sinkhorn_ops.launches, 0)
    out["fig8"] = fig8

    # (d) certificates: the main path's schedules and the CLI goldens
    t0 = time.perf_counter()
    sinkhorn_ops.reset_launches()
    certs = [certify.certify_schedule(wl.demand_matrix(), s, device=DEV)
             for s, wl in zip(scheds, wls)]
    cli = {name: certify_cli(argv, DEV)
           for name, argv in CERTIFY_GOLDENS.items()}
    secs["certify_s"] = time.perf_counter() - t0
    launches["certify"] = sinkhorn_ops.launches
    # 2 a certificate (scaled and rounded demands); the saturate golden:
    # its schedule 1, its certificate 2, batch parity 2 batched + 2 solo
    expect_launches("certify", launches["certify"], 2 * len(scheds) + 7)
    bound_q = quantized_theorem3_bound(K, D_HAT, N, RECFG)
    for load, res in zip(LOADS, certs):
        log(f"  certificate n={N} load {load}: theta {res.theta:.9f}, "
            f"quantized bound {res.quantized_bound:.9f}, asymptotic "
            f"{res.asymptotic_bound:.9f}; checks {res.checks}")
        if not (res.ok and all(v == "pass" for v in res.checks.values())
                and res.theta >= bound_q - 1e-9
                and res.quantized_bound == bound_q):
            raise AssertionError(f"certificate at load {load} fails: "
                                 f"{res.violations}")
    for name, (rc, cert, _) in cli.items():
        log(f"  certify CLI {name}: exit {rc}, theta "
            f"{cert['bounds']['theta']:.9f}, quantized bound "
            f"{cert['bounds']['quantized_theorem3']:.9f}, checks "
            f"{cert['checks']}")
        if rc != 0 or cert["violations"]:
            raise AssertionError(f"certify CLI {name} on the card: exit "
                                 f"{rc}, {cert['violations']}")
    t0 = time.perf_counter()
    for load, s, wl, res in zip(LOADS, scheds, wls, certs):
        cpu = certify.certify_schedule(wl.demand_matrix(), s, device="cpu")
        diff = certificate_diff(res.certificate, cpu.certificate, THETA_RTOL)
        log(f"  certificate load {load}: card vs CPU theta rel diff "
            f"{abs(res.theta - cpu.theta) / cpu.theta:.3e}")
        if diff:
            raise AssertionError(f"certificate at load {load}: {diff}")
    for name, argv in CERTIFY_GOLDENS.items():
        rc, cert, _ = certify_cli(argv, "cpu")
        rtol = THETA_RTOL if "saturate" in argv else 0.0
        diff = certificate_diff(cli[name][1], cert, rtol)
        if rc != 0 or diff:
            raise AssertionError(f"certify CLI {name}: card vs CPU: exit "
                                 f"{rc}, {diff}")
    secs["certify_cpu_s"] = time.perf_counter() - t0
    out["certificates"] = [res.certificate["bounds"] for res in certs]

    # (e) BvN: Theorem 1 and the quantized strawman, card against CPU
    t0 = time.perf_counter()
    sinkhorn_ops.reset_launches()
    bvn = {}
    for n in BVN_NS:
        m0 = traffic_mod.skewed(n, 0.5, seed=4) + 1e-6
        m = traffic_mod.saturate(m0, device=DEV)
        lams, perms = bvn_decompose(m, device=DEV)
        bvn[n] = (m0, m, lams, perms, bvn_schedule(m0, device=DEV),
                  vermilion_schedule(m0, k=K, normalize="saturate",
                                     device=DEV))
    secs["bvn_s"] = time.perf_counter() - t0
    launches["bvn"] = sinkhorn_ops.launches
    expect_launches("bvn", launches["bvn"], 4 * len(BVN_NS))
    t0 = time.perf_counter()
    out["bvn"] = []
    for n, (m0, m, lams, perms, b, v) in bvn.items():
        cap = np.zeros((n, n))
        for lam, p in zip(lams, perms):
            cap[np.arange(n), p] += lam
        theta1 = throughput_single_hop(cap, m)
        demand = m.copy()
        np.fill_diagonal(demand, 0.0)
        tb, tv = (schedule_throughput(x, demand) for x in (b, v))
        lc, pc = bvn_decompose(m, device="cpu")
        bc = bvn_schedule(m0, device="cpu")
        lam_diff = (float(np.abs(lams - lc).max())
                    if len(lams) == len(lc) else float("inf"))
        slots, slots_cpu = term_slots(b, perms), term_slots(bc, perms)
        log(f"  bvn n={n}: {len(lams)} terms (CPU {len(lc)}), lambdas "
            f"sum {lams.sum():.12f}, card vs CPU max diff {lam_diff:.3e}; "
            f"ideal BvN theta {theta1:.9f}; {3 * n} slots: BvN "
            f"single-hop theta {tb:.6f}, Vermilion k={K} {tv:.6f}; "
            f"quantized perms equal to the CPU's: "
            f"{bool(np.array_equal(b.perms, bc.perms))}")
        if theta1 < 1 - 1e-6:
            raise AssertionError(f"bvn n={n}: Theorem 1 fails ({theta1})")
        if not (len(lams) == len(lc) and np.array_equal(perms, pc)
                and lam_diff <= BVN_LAM_ATOL):
            raise AssertionError(f"bvn n={n}: the card's decomposition "
                                 f"differs from the CPU's")
        # the largest-remainder fill may break a tie of equal lambdas
        # the other way: at most one slot a term, none lost
        if not (b.T == bc.T == 3 * n and slots.sum() == slots_cpu.sum()
                == 3 * n and np.abs(slots - slots_cpu).max() <= 1):
            raise AssertionError(f"bvn n={n}: quantized slots {slots} "
                                 f"against the CPU's {slots_cpu}")
        out["bvn"].append({"n": n, "terms": len(lams), "theta_ideal": theta1,
                           "theta_bvn": tb, "theta_vermilion": tv})
    secs["bvn_cpu_s"] = time.perf_counter() - t0

    # (f) interconnect pricing (host) and its drain on the card
    t0 = time.perf_counter()
    ic = interconnect_bench.run()
    secs["interconnect_analytic_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sinkhorn_ops.reset_launches()
    dcases = interconnect_bench.drain_cases(DRAIN_HORIZON, device=DEV)
    drain = run_sweep(dcases, interconnect_bench.BITS_PER_SLOT, device=DEV)
    secs["drain_s"] = time.perf_counter() - t0
    launches["interconnect"] = sinkhorn_ops.launches
    expect_launches("interconnect", launches["interconnect"], len(dcases))
    t0 = time.perf_counter()
    dcases_cpu = interconnect_bench.drain_cases(DRAIN_HORIZON, device="cpu")
    for a, b in zip(dcases, dcases_cpu):
        if not np.array_equal(a.sched.perms, b.sched.perms):
            raise AssertionError(f"drain {a.label}: the card's schedule "
                                 f"differs from the CPU's")
    drain_cpu = run_sweep(dcases_cpu, interconnect_bench.BITS_PER_SLOT,
                          device="cpu")
    secs["drain_cpu_s"] = time.perf_counter() - t0
    compare_sweep(drain, drain_cpu)
    t_sim = {r["arch"]: r["t_sim"] for r in
             interconnect_bench.drain_times(drain)}
    for r in ic:
        log(f"  interconnect {r['arch']:26s} vermilion "
            f"{r['t_vermilion'] * 1e3:.6f} ms, oblivious "
            f"{r['t_oblivious'] * 1e3:.6f}, oblivious single-hop "
            f"{r['t_obl_singlehop'] * 1e3:.6f}, int8 "
            f"{r['t_vermilion_int8'] * 1e3:.6f}, speedup "
            f"{r['speedup']:.6f}x; drained on the card in "
            f"{t_sim[r['arch']] * 1e3:.6f} ms")
        if not np.isfinite(t_sim[r["arch"]]):
            raise AssertionError(f"drain {r['arch']}: flows left at "
                                 f"{DRAIN_HORIZON} slots")
    out["interconnect"] = [{**{k: r[k] for k in (
        "arch", "t_vermilion", "t_oblivious", "t_obl_singlehop",
        "t_vermilion_int8", "speedup")}, "t_sim": t_sim[r["arch"]]}
        for r in ic]
    secs["phase_s"] = time.perf_counter() - t_phase
    log("  seconds: " + json.dumps(secs))
    return out


# -- the faults phase: fault injection, repair, fullest and jitter ----------

def faulted_sweep_cases(sched, wl) -> list:
    """The sweep's deployment under four fault scenarios, each firing at
    ``FAULT_SLOT``: one plane down, two ToRs failed, two ToRs drained, a
    port death and a link flap."""
    ev = faults_mod.FaultEvent
    scenarios = {
        "plane_down1": (ev(FAULT_SLOT, "plane_down", plane=0),),
        "tor_fail2": tuple(ev(FAULT_SLOT, "tor_fail", node=x)
                           for x in (0, 1)),
        "tor_drain2": tuple(ev(FAULT_SLOT, "tor_drain", node=x)
                            for x in (2, 3)),
        "port_flap": (ev(FAULT_SLOT, "port_down", node=4, plane=1),
                      ev(FAULT_SLOT, "link_flap", node=5, plane=2,
                         duration=FAULT_FLAP)),
    }
    return [SweepCase(sched, wl, "single_hop", name, {"fault": name},
                      faults=faults_mod.FaultSchedule(evs))
            for name, evs in scenarios.items()]


def compare_faulted_sweep(rows: list, rows_cpu: list) -> None:
    """The card's faulted sweep rows against the CPU's: FCTs within the
    sweep's bar, delivered and lost bits rtol 1e-5 (the f32 VOQ), refused
    bits equal."""
    for a, b in zip(rows, rows_cpu):
        ra, rb = a.result, b.result
        n_diff, max_diff = fct_diff(ra.fct_slots, rb.fct_slots)
        rel = max(abs(getattr(ra, f) - getattr(rb, f))
                  / max(abs(getattr(rb, f)), 1e-300)
                  for f in ("delivered_bits", "fault_lost_bits"))
        log(f"  {a.label}: card vs CPU: bits rel diff {rel:.3e}, refused "
            f"equal {ra.fault_refused_bits == rb.fault_refused_bits}; "
            f"FCTs differ on {n_diff} of {len(ra.fct_slots)} flows, by at "
            f"most {max_diff} slots")
        if rel > SWEEP_FAULT_RTOL \
                or ra.fault_refused_bits != rb.fault_refused_bits:
            raise AssertionError(f"{a.label}: faulted sweep bits differ "
                                 f"from the CPU's by {rel:.3e}")
        if n_diff > FCT_MAX_DIFF_FRAC * len(ra.fct_slots) \
                or max_diff > FCT_MAX_DIFF_SLOTS:
            raise AssertionError(f"{a.label}: FCTs differ on {n_diff} flows "
                                 f"by up to {max_diff} slots")


def post_fault_util(row) -> float:
    """``run_faults``' recovery plateau: mean per-epoch utilization from
    two epochs after the fault on."""
    return float(row.epoch_utilization[row.meta["fault_epoch"] + 2:].mean())


def compare_engine(rows: list, rows_cpu: list) -> dict:
    """Adaptive rows on the card against the CPU's: trajectory digests,
    counters and excisions equal; FCTs within the sweep's bar; bits and
    epoch utilization within rtol 1e-9 on the degraded-service engine
    (f64) and ``UTIL_RTOL`` on the compiled path (f32).  Returns the
    worst differences."""
    worst = {"fct_flows": 0, "fct_slots": 0.0, "bits_rel": 0.0}
    for a, b in zip(rows, rows_cpu):
        if a.plan_digest != b.plan_digest:
            raise AssertionError(f"{a.label}: the card's trajectory differs "
                                 "from the CPU's")
        for f in ("recomputes", "stale_slots", "dark_slots",
                  "dark_plane_slots", "schedule_groups_max",
                  "excised_nodes", "excised_planes"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{a.label}: {f} {getattr(a, f)} on "
                                     f"the card, {getattr(b, f)} on the CPU")
        ra, rb = a.result, b.result
        pairs = [(ra.delivered_bits, rb.delivered_bits),
                 (ra.fault_lost_bits, rb.fault_lost_bits),
                 (ra.fault_refused_bits, rb.fault_refused_bits),
                 (a.collision_lost_bits, b.collision_lost_bits)]
        pairs += list(zip(a.epoch_utilization, b.epoch_utilization))
        rel = max(abs(x - y) / max(abs(y), 1e-300) for x, y in pairs)
        rtol = ENGINE_RTOL if a.meta.get("engine") else UTIL_RTOL
        n_diff, max_diff = fct_diff(ra.fct_slots, rb.fct_slots)
        worst["fct_flows"] = max(worst["fct_flows"], n_diff)
        worst["fct_slots"] = max(worst["fct_slots"], max_diff)
        worst["bits_rel"] = max(worst["bits_rel"], rel)
        if rel > rtol:
            raise AssertionError(f"{a.label}: bits differ from the CPU's by "
                                 f"{rel:.3e} (rtol {rtol})")
        if n_diff > FCT_MAX_DIFF_FRAC * len(ra.fct_slots) \
                or max_diff > FCT_MAX_DIFF_SLOTS:
            raise AssertionError(f"{a.label}: FCTs differ on {n_diff} flows "
                                 f"by up to {max_diff} slots")
    return worst


def engine_run(name: str, cases: list) -> dict:
    """One adaptive grid on the card (sanitized, Sinkhorn launches counted
    from 0 against the saturate calls that ran) and on the CPU, held to
    :func:`compare_engine`; each row's ``meta["engine"]`` says whether it
    took the degraded-service engine."""
    cases = [dataclasses.replace(
        c, meta=dict(c.meta, engine=sim_mod._degraded(c))) for c in cases]
    n_engine = sum(c.meta["engine"] for c in cases)
    log(f"== {name}: {len(cases)} cases ({n_engine} on the degraded-service "
        f"engine), n={cases[0].wl.n}, d_hat={cases[0].d_hat}, "
        f"{cases[0].wl.horizon} slots, epochs of {cases[0].epoch_slots}")
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
        raise AssertionError(f"{name} launched the sinkhorn kernel "
                             f"{launches} times for {calls[0]} saturate "
                             "calls")
    for key, val in timings.items():
        log(f"  phase {key}: {val:.6f}" if isinstance(val, float)
            else f"  {key}: {json.dumps(val)}")
    t0 = time.perf_counter()
    rows_cpu = run_adaptive(cases, BITS_PER_SLOT, device="cpu",
                            sanitize=True)
    cpu_s = time.perf_counter() - t0
    worst = compare_engine(rows, rows_cpu)
    log(f"  the same cases on the CPU {cpu_s:.6f} s; card vs CPU: "
        f"trajectories, counters and excisions equal; FCTs differ on at "
        f"most {worst['fct_flows']} flows of a case, by at most "
        f"{worst['fct_slots']} slots; bits rel diff at most "
        f"{worst['bits_rel']:.3e}")
    for r in rows:
        res = r.result
        if not np.isfinite(res.utilization) or not res.utilization > 0:
            raise AssertionError(f"{r.label}: no finite utilization")
        log(f"  {r.label}: util {res.utilization:.6f}, completed "
            f"{res.completed_frac:.6f}, lost {res.fault_lost_bits:.6e} b, "
            f"refused {res.fault_refused_bits:.6e} b, excised nodes "
            f"{r.excised_nodes} planes {r.excised_planes}, recomputes "
            f"{r.recomputes}, collision loss {r.collision_lost_bits:.6e} b")
    return {"rows": rows, "launches": launches, "saturate_calls": calls[0],
            "wall_s": wall, "cpu_s": cpu_s, "timings": timings,
            "engine_cases": n_engine, "worst": worst}


def engine_numbers(res: dict) -> dict:
    """The degraded-service engine's numbers from a run's
    ``timings["degraded"]``: µs a slot (all its phases over its slots) and
    of its device loop alone (host clock: the loop issues the slot's ops
    and waits on nothing), the share of its slots served from claims (the
    degraded path), epoch-boundary reads, replay seconds."""
    t = res["timings"].get("degraded", {})
    slots = max(t.get("slots", 0), 1)
    total = sum(v for k, v in t.items() if k.endswith("_s"))
    return {"slots": t.get("slots", 0), "us_per_slot": total / slots * 1e6,
            "device_loop_us_per_slot": t.get("device_loop_s", 0.0)
            / slots * 1e6,
            "degraded_share": t.get("degraded_slots", 0) / slots,
            "epoch_reads": t.get("epoch_reads", 0),
            "replay_s": t.get("replay_s", 0.0),
            "control_s": t.get("control_s", 0.0)}


def faults_phases(sched, wl) -> dict:
    """Fault injection on the card against the CPU: the sweep's deployment
    under four fault scenarios; ``run_faults``' grid and its headline;
    grid (b) under ``fullest`` and activation jitter.  Returns the
    numbers, the Sinkhorn launches of the phase included."""
    out: dict = {}
    sinkhorn_ops.reset_launches()
    launches = 0

    # -- the sweep's deployment, four scenarios in one batch ---------------
    cases = faulted_sweep_cases(sched, wl)
    log(f"== faulted sweep: n={N}, d_hat={D_HAT}, load {LOADS[-1]}, "
        f"{HORIZON} slots, faults at slot {FAULT_SLOT}, {len(cases)} cases")
    timings: dict = {}
    t0 = time.perf_counter()
    rows = run_sweep(cases, BITS_PER_SLOT, device=DEV, sanitize=True,
                     timings=timings)
    sweep_s = time.perf_counter() - t0
    launches += sinkhorn_ops.launches
    log(f"  run_sweep on the card {sweep_s:.6f} s")
    log_batches(timings)
    t0 = time.perf_counter()
    rows_cpu = run_sweep(cases, BITS_PER_SLOT, device="cpu", sanitize=True)
    log(f"  the same cases on the CPU {time.perf_counter() - t0:.6f} s")
    compare_faulted_sweep(rows, rows_cpu)
    by = {r.label: r.result for r in rows}
    for name, r in by.items():
        log(f"  {name}: util {r.utilization:.6f}, completed "
            f"{r.completed_frac:.6f}, lost {r.fault_lost_bits:.6e} b, "
            f"refused {r.fault_refused_bits:.6e} b")
    if by["tor_drain2"].fault_lost_bits != 0.0:
        raise AssertionError("a drain lost bits")
    if not by["tor_fail2"].fault_lost_bits > 0.0:
        raise AssertionError("a ToR failure lost no bits")
    out["sweep"] = {"wall_s": sweep_s, "timings": {
        k: v for k, v in timings.items() if k != "batches"},
        "util": {k: r.utilization for k, r in by.items()},
        "lost": {k: r.fault_lost_bits for k, r in by.items()},
        "refused": {k: r.fault_refused_bits for k, r in by.items()}}

    # -- run_faults as the repo builds it, and its headline ----------------
    sinkhorn_ops.reset_launches()
    res = engine_run(f"run_faults (trains {', '.join(RF_TRAINS)})",
                     adaptive_bench.faults_cases(
                         horizon=RF_HORIZON, fault_slot=RF_FAULT_SLOT,
                         trains=RF_TRAINS))
    launches += res["launches"]
    rf = {r.label: r for r in res.pop("rows")}
    rep, bli, obl = (post_fault_util(rf[f"stationary-plane_down1-{p}"])
                     for p in ("repair", "blind", "oblivious"))
    excised = rf["stationary-plane_down1-repair"].excised_planes
    log(f"  headline: one plane down on the stationary train: post-fault "
        f"util repair {rep:.6f} >= oblivious {obl:.6f} > blind {bli:.6f}; "
        f"repair excised {excised} plane(s)")
    if excised != 1 or not rep >= obl > bli:
        raise AssertionError(f"run_faults' headline fails on the card: "
                             f"excised {excised}, repair {rep}, oblivious "
                             f"{obl}, blind {bli}")
    for label, row in rf.items():
        if "-tor_drain" in label and row.result.fault_lost_bits != 0.0:
            raise AssertionError(f"{label}: a drain lost bits")
    out["run_faults"] = {**res, "engine": engine_numbers(res),
                         "headline": {"repair": rep, "oblivious": obl,
                                      "blind": bli, "excised": excised},
                         "post_fault_util": {k: post_fault_util(r)
                                             for k, r in rf.items()}}

    # -- grid (b) under the new arbiter, and activation jitter -------------
    wl_b = phase_shifting_workload(
        DISAGREE_N, ADAPTIVE_LOAD, FAULT_GRID_B_HORIZON, BITS_PER_SLOT,
        d_hat=DISAGREE_D_HAT, seed=SEED, phases=ADAPTIVE_PHASES,
        shift_period=FAULT_GRID_B_SHIFT)
    common = dict(wl=wl_b, epoch_slots=DISAGREE_EPOCH, policy="adaptive",
                  k=K, d_hat=DISAGREE_D_HAT, recfg_frac=RECFG, seed=SEED,
                  alpha=0.5, normalize="saturate")
    cases = [AdaptiveCase(gather_steps=st, collision="fullest",
                          label=f"steps{st}-fullest", **common)
             for st in DISAGREE_STEPS]
    cases += [AdaptiveCase(gather_steps=DISAGREE_STEPS[-1], collision="drop",
                           label=f"steps{DISAGREE_STEPS[-1]}-drop",
                           **common),
              AdaptiveCase(gather_steps=DISAGREE_N - 1, collision="receiver",
                           activation_jitter_slots=JITTER_SLOTS,
                           label=f"jitter{JITTER_SLOTS}-receiver", **common)]
    res_b = engine_run("grid (b) under fullest and jitter", cases)
    launches += res_b["launches"]
    rb = {r.label: r for r in res_b.pop("rows")}
    st = DISAGREE_STEPS[-1]
    full, drop = rb[f"steps{st}-fullest"], rb[f"steps{st}-drop"]
    log(f"  {st}-step gathers: fullest delivers "
        f"{full.result.delivered_bits:.6e} b, drop "
        f"{drop.result.delivered_bits:.6e} b")
    if not full.result.delivered_bits > drop.result.delivered_bits:
        raise AssertionError(f"fullest delivers no more than drop at {st} "
                             "steps")
    out["grid_b"] = {**res_b, "engine": engine_numbers(res_b),
                     "util": {k: r.result.utilization
                              for k, r in rb.items()}}
    out["launches"] = launches
    for name in ("run_faults", "grid_b"):
        e = out[name]["engine"]
        log(f"  engine on {name}: {e['slots']} slots, "
            f"{e['us_per_slot']:.3f} us a slot (device loop "
            f"{e['device_loop_us_per_slot']:.3f}), degraded share "
            f"{e['degraded_share']:.4f}, epoch reads {e['epoch_reads']}, "
            f"replay {e['replay_s']:.6f} s, control {e['control_s']:.6f} s")
    return out


# -- the evaluation drivers: Fig. 5/6, the adaptive suite, Fig. 10 ---------

# schedule_time.run's sizes here (host only; the harness run sweeps to n 512
# with Hopcroft-Karp)
EVAL_SCHED_NS = (16, 64, 128, 256)


def log_fig5(rows: list) -> None:
    """The Fig. 5/6 table, one line a (system, load)."""
    for r in rows:
        log(f"  fig5 {r['system']}@{r['load']}: p99 short {r['p99_short']} "
            f"long {r['p99_long']} p50 short {r['p50_short']} slots, util "
            f"{r['util']:.6f}, done {r['done']:.6f}, hops {r['hops']:.6f}")


def log_adaptive_rows(name: str, rows: list) -> None:
    for r in rows:
        res = r.result
        log(f"  {name} {r.label}: util {res.utilization:.6f}, completed "
            f"{res.completed_frac:.6f}, p99 short "
            f"{res.fct_percentile(99, short_cutoff=SHORT_FLOW_BITS)} slots, "
            f"recomputes {r.recomputes}, stale slots {r.stale_slots}, dark "
            f"slots {r.dark_slots}, groups max {r.schedule_groups_max}, "
            f"construction_s {r.construction_s:.6f}")


def evaluation_phases() -> dict:
    """The paper's evaluation drivers (``repro_torch.benchmarks``) on the
    card, each held against the port's CPU run of the same driver: (i)
    ``fct_bench.run`` at its defaults (Fig. 5/6: n = 16, d_hat = 4, 4000
    slots, 6 loads x 5 systems; one Sinkhorn launch a load); (ii)
    ``fct_bench.timing_table`` at n = 64 (3 launches), its card and CPU
    times; (iii) ``adaptive_bench.run`` at its defaults (8 cases, the
    partial gather included), ``run_epoch_tradeoff`` (12 cases) and
    ``run_charging`` (``free-euler`` gated; the clock-charged rows read);
    (iv) ``schedule_time.run`` at :data:`EVAL_SCHED_NS` (host only).
    Bars: the sweep's (``compare_sweep``) and the adaptive loop's
    (``compare_adaptive``).  Returns the numbers, the phase's Sinkhorn
    launches included."""
    out: dict = {"seconds": {}}
    secs = out["seconds"]
    t_phase = time.perf_counter()

    # -- (i) Fig. 5/6 at fct_bench's defaults ------------------------------
    log(f"== evaluation (i): fct_bench.run, n=16, d_hat=4, 4000 slots, loads "
        f"{fct_bench.LOADS}, 5 systems")
    sinkhorn_ops.reset_launches()
    rows: list = []
    t0 = time.perf_counter()
    fig5 = fct_bench.run(device=DEV, sweep_rows=rows)
    secs["fig5_card_s"] = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    expect_launches("fct_bench.run", launches, len(fct_bench.LOADS))
    if sorted({r["system"] for r in fig5}) != sorted(
            ["vermilion", "greedy", "rotorlb", "vlb", "obl-singlehop"]):
        raise AssertionError("the Fig. 5/6 grid lacks a system")
    n_two = sum(r.mode != "single_hop" for r in rows)
    check_sweep_rows(rows, twohop_fcts=sim_mod._twohop_route(
        n_two, 16, 4000) == "twohop_fct")
    rows_cpu: list = []
    t0 = time.perf_counter()
    fct_bench.run(device="cpu", sweep_rows=rows_cpu)
    secs["fig5_cpu_s"] = time.perf_counter() - t0
    compare_sweep(rows, rows_cpu)
    log(f"  card {secs['fig5_card_s']:.6f} s, CPU {secs['fig5_cpu_s']:.6f} s")
    log_fig5(fig5)
    out["fig5"] = fig5

    # -- (ii) the timing table at n = 64 -----------------------------------
    log("== evaluation (ii): fct_bench.timing_table, n=64, d_hat=4, 1500 "
        "slots, loads (0.05, 0.3, 0.6)")
    sinkhorn_ops.reset_launches()
    t0 = time.perf_counter()
    tt = fct_bench.timing_table(device=DEV)
    secs["timing_table_s"] = time.perf_counter() - t0
    expect_launches("fct_bench.timing_table", sinkhorn_ops.launches, 3)
    launches += sinkhorn_ops.launches
    n_two = sum(r.mode != "single_hop" for r in tt["rows"]["card"])
    check_sweep_rows(tt["rows"]["card"], twohop_fcts=sim_mod._twohop_route(
        n_two, 64, 1500) == "twohop_fct")
    compare_sweep(tt["rows"]["card"], tt["rows"]["cpu"])
    for g, (c, t) in tt["groups"].items():
        log(f"  timing {g}: CPU {c:.6f} s, card {t:.6f} s ({c / t:.3f}x)")
    out["timing_table"] = tt["groups"]

    # -- (iii) the adaptive suite: policies, tradeoff, charging ------------
    sinkhorn_ops.reset_launches()
    adaptive: dict = {}
    for name, fn in (("run", adaptive_bench.run),
                     ("tradeoff", adaptive_bench.run_epoch_tradeoff),
                     ("charging", adaptive_bench.run_charging)):
        log(f"== evaluation (iii): adaptive_bench.{fn.__name__}")
        t0 = time.perf_counter()
        rows = fn(device=DEV)
        secs[f"adaptive_{name}_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_cpu = fn(device="cpu")
        secs[f"adaptive_{name}_cpu_s"] = time.perf_counter() - t0
        log(f"  card {secs[f'adaptive_{name}_card_s']:.6f} s, CPU "
            f"{secs[f'adaptive_{name}_cpu_s']:.6f} s")
        log_adaptive_rows(name, rows)
        # the clock-charged rows follow each run's construction times
        gated = [i for i, r in enumerate(rows)
                 if name != "charging" or r.label == "free-euler"]
        parted = compare_adaptive([rows[i] for i in gated],
                                  [rows_cpu[i] for i in gated])
        if parted:
            raise AssertionError(f"adaptive_bench.{fn.__name__}: the card's "
                                 f"trajectories differ from the CPU's: "
                                 f"{parted}")
        if name == "charging":
            log_adaptive_rows("charging (CPU, read only)", rows_cpu[1:])
        adaptive[name] = {r.label: {
            "util": r.result.utilization, "recomputes": r.recomputes,
            "stale_slots": r.stale_slots, "dark_slots": r.dark_slots,
            "construction_s": r.construction_s} for r in rows}
        if name == "run":
            if "adaptive-gather4" not in adaptive[name]:
                raise AssertionError("adaptive_bench.run lacks its partial "
                                     "gather")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                adaptive_bench.print_summary(rows)
            for line in buf.getvalue().splitlines():
                if line.startswith("#"):
                    log(f"  {line}")
        if name == "tradeoff":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                adaptive_bench.print_tradeoff(rows)
            log(f"  {buf.getvalue().splitlines()[-1]}")
    out["adaptive"] = adaptive

    # -- (iv) Fig. 10: construction latency (host) -------------------------
    log(f"== evaluation (iv): schedule_time.run, n {EVAL_SCHED_NS} (host)")
    t0 = time.perf_counter()
    sched_rows = schedule_time.run(ns=EVAL_SCHED_NS, device=DEV)
    secs["schedule_time_s"] = time.perf_counter() - t0
    expect_launches("adaptive_bench and schedule_time",
                    sinkhorn_ops.launches, 0)
    for r in sched_rows:
        log(f"  fig10 n={r['n']}: euler end to end "
            f"{r['end_to_end_euler_us']:.1f} us, hk "
            f"{r.get('end_to_end_hk_us', float('nan')):.1f} us, speedup "
            f"{r.get('speedup', float('nan')):.3f}")
    out["fig10"] = sched_rows
    out["launches"] = launches
    secs["phase_s"] = time.perf_counter() - t_phase
    log("  seconds: " + json.dumps(secs))
    return out


# -- the port's analysis and its examples on the card -------------------------

EXAMPLES = Path(__file__).resolve().parent / "examples"


def load_example(name: str):
    """``examples/<name>.py`` as a module (``examples`` is no package)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args) -> tuple:
    """``fn(*args)`` with its standard output captured: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@contextlib.contextmanager
def calls_seen(module, name: str, key):
    """``module.name`` wrapped to add ``key(*args, **kwargs)`` of each of
    its calls to the set the block gets."""
    seen: set = set()
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        seen.add(key(*args, **kwargs))
        return fn(*args, **kwargs)
    with swapped(module, name, rec):
        yield seen


def flash_call(q, k, v, causal=True, window=0, with_lse=False) -> tuple:
    """A flash-attention call's shapes, type and mask."""
    return (tuple(q.shape), tuple(k.shape), v.shape[-1], q.dtype,
            bool(causal), int(window))


def decode_call(q, k, v, length, window=0) -> tuple:
    """A flash-decode call's shapes, type, lane lengths and window."""
    lens = torch.as_tensor(length, dtype=torch.int64).expand(
        q.shape[0]).tolist()
    return (tuple(q.shape), tuple(k.shape), q.dtype, tuple(lens),
            int(window))


def analysis_phases() -> dict:
    """The port's quickstart (``examples/torch_quickstart.py``) on the card
    and on the CPU, the same printed numbers (only the device's name
    differs), its lint clean and its certificate ok, its saturate schedule
    through the Sinkhorn kernel; the op-level analyzer's reports of the
    five slot kernels on the card equal to the CPU's and within the port's
    budget; ``examples/torch_serve_decode.py`` serving its five requests
    on the card through the flash and decode kernels, at full width and
    as ``--smoke`` (the reference's example)."""
    out: dict = {}
    t_phase = time.perf_counter()
    quickstart = load_example("torch_quickstart")
    log("== the port's quickstart (examples/torch_quickstart.py) on the "
        "card")
    sinkhorn_ops.reset_launches()
    t0 = time.perf_counter()
    res, text = captured(quickstart.main, [])
    card_s = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    for line in text.splitlines():
        log(f"  | {line}")
    t0 = time.perf_counter()
    res_cpu, text_cpu = captured(quickstart.main, ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    diff = [(a, b) for a, b in zip(text.replace("cuda", "cpu").splitlines(),
                                   text_cpu.splitlines()) if a != b]
    log(f"  card {card_s:.6f} s, CPU {cpu_s:.6f} s; lines that differ "
        f"beyond the device's name: {len(diff)}; lint exit "
        f"{res['lint_rc']}, certificate ok {res['certificate'].ok}, "
        f"sinkhorn launches {launches}")
    for a, b in diff:
        log(f"  card: {a}\n  CPU:  {b}")
    if diff or len(text.splitlines()) != len(text_cpu.splitlines()):
        raise AssertionError("the quickstart's numbers on the card differ "
                             "from the CPU's")
    if res["lint_rc"] != 0 or not res["certificate"].ok \
            or res_cpu["lint_rc"] != 0:
        raise AssertionError("the quickstart's lint or certificate failed")
    if launches < 1:
        raise AssertionError("the quickstart's saturate schedule launched "
                             "no sinkhorn kernel")
    out["quickstart"] = {"card_s": card_s, "cpu_s": cpu_s,
                         "launches": launches}

    log("== the op-level analyzer (repro_torch.analysis.ir), card vs CPU")
    t0 = time.perf_counter()
    reports = ir_mod.analyze_all(device=DEV)
    ir_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports_cpu = ir_mod.analyze_all(device="cpu")
    ir_cpu_s = time.perf_counter() - t0
    violations = ir_mod.check_budget(reports, ir_mod.load_budget())
    for r, rc in zip(reports, reports_cpu):
        log(f"  {r.kernel}: flops {r.flops}, dot {r.dot_flops}, moved "
            f"{r.bytes_moved} B, peak {r.peak_bytes} B, carry "
            f"{r.carry_bytes} B (~n^{r.carry_exponent}), leaks "
            f"{len(r.dtype_leaks)}, unknown ops {r.unknown_prims}; equal "
            f"to the CPU's: {r.to_dict() == rc.to_dict()}")
    log(f"  card {ir_card_s:.6f} s, CPU {ir_cpu_s:.6f} s; budget "
        f"violations {violations}")
    unequal = [r.kernel for r, rc in zip(reports, reports_cpu)
               if r.to_dict() != rc.to_dict()]
    if unequal or violations:
        raise AssertionError(f"IR reports differ from the CPU's on "
                             f"{unequal}, budget violations {violations}")
    out["ir"] = {"card_s": ir_card_s, "cpu_s": ir_cpu_s,
                 "reports": [r.to_dict() for r in reports]}

    serve_decode = load_example("torch_serve_decode")
    out["serve_decode"] = {}
    out["flash"], out["decode"] = [], []
    for argv in ([], ["--smoke"]):
        label = " ".join(["torch_serve_decode"] + argv)
        log(f"== the port's serving example ({label}) on the card")
        flash_ops.reset_launches()
        decode_ops.reset_launches()
        t0 = time.perf_counter()
        with calls_seen(flash_ops, "attention_kernel", flash_call) as fc, \
                calls_seen(decode_ops, "decode_kernel", decode_call) as dc:
            done, text = captured(serve_decode.main, argv)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = {"flash_attention": flash_ops.launches,
                  "decode_attention": decode_ops.launches}
        for line in text.splitlines():
            log(f"  | {line}")
        log(f"  {len(done)} requests in {serve_s:.6f} s; launches {counts}; "
            f"distinct calls: flash {len(fc)}, decode {len(dc)}")
        if sorted(r.rid for r in done) != list(range(5)) \
                or any(len(r.out_tokens) != 8 for r in done):
            raise AssertionError(f"{label} did not complete its five "
                                 "requests with 8 tokens each")
        if not all(counts.values()):
            raise AssertionError(f"{label} bypassed a kernel: {counts}")
        out["serve_decode"][label] = {"s": serve_s, "launches": counts}
        # each distinct call the example made, held against the plain
        # version at its shapes, type and lane lengths (on seeded inputs)
        tag = "smoke" if argv else "example"
        log(f"== {label}'s kernel calls vs the plain versions")
        for qs, ks, dv, dt, causal, window in sorted(fc, key=str):
            out["flash"].append(check_flash(
                f"{tag} prefill", qs[0], qs[1], ks[1], qs[2], ks[2], qs[3],
                dt, causal=causal, window=window, reps=3, dv=dv))
        for qs, ks, dt, lens, window in sorted(dc, key=str):
            out["decode"].append(check_decode(
                f"{tag} decode", list(lens), ks[1], qs[2], ks[2], qs[3], dt,
                window=window, reps=3))
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  analysis and examples phase wall {out['wall_s']:.1f} s")
    return out


# -- training: the flash-attention backward kernel and the trainer -----------
# the backward kernel against its plain version (attention_bwd_ref) on the
# same inputs, each of dQ, dK, dV within a share of its own largest
# magnitude: f32 1e-4 (the two sum in other orders over up to 5000 keys);
# bf16 1.25e-2, 1.6 bf16 ulps of the largest magnitude, set from the
# card's readings (at most 6.9e-3 at these shapes: both round their
# outputs to bf16, and the kernel also P and dS for its products), which
# puts every control at least 16x past it; the forward's log-sum-exp
# within 1e-5 of a plain logsumexp
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.25e-2}
# the bf16 kernel against the plain model of its own arithmetic
# (attention_bwd_tiles: the same roundings of P and dS, the same order of
# sums): beyond one bf16 rounding of each element (2^-8 of its magnitude,
# the kernel's rounding of its f32 sums into its bf16 outputs), within
# BWD_TOL[bf16] / 4 of each output's largest magnitude.  What is left is
# the order of sums inside a wgmma and the few P and dS that round to the
# other bf16 neighbour where the kernel's S or ex2 differ from the model's
# by an f32 ulp: one such dS of a row with a dominant key moves a dQ or dK
# element by ~1e-3 of the largest (readings up to 1.82e-3, at Whisper's
# encoder; the parent's mma.sync kernel read the same)
TILE_TOL = BWD_TOL[torch.bfloat16] / 4
LSE_TOL = 1e-5
# a broken backward must sit at least this many times past the gate
CONTROL_FACTOR = 10.0
# (label, B, Sq, Sk, H, KV, dqk, dv, causal, window, dtypes): Qwen's
# training shape, Mixtral's window, Whisper's encoder and cross-attention,
# a ragged cross shape, MiniCPM3's training shape (MLA's cacheless branch:
# q/k 96, v 64) and a ragged self-attention at its widths (tail tiles,
# Sq % 4 != 0); the controls run at every one (the GQA sum where H > KV)
BWD_SHAPES = (
    ("qwen-train", 8, 2048, 2048, 16, 16, 64, 64, True, 0,
     (torch.bfloat16, torch.float32)),
    ("mixtral-window", 1, 5000, 5000, 32, 8, 128, 128, True, 4096,
     (torch.bfloat16, torch.float32)),
    ("whisper-encoder", 8, 1500, 1500, 6, 6, 64, 64, False, 0,
     (torch.bfloat16,)),
    ("whisper-cross", 8, 448, 1500, 6, 6, 64, 64, False, 0,
     (torch.bfloat16,)),
    ("ragged-cross", 1, 130, 1473, 6, 6, 64, 64, False, 0,
     (torch.bfloat16, torch.float32)),
    ("minicpm3-train", 8, 2048, 2048, 40, 40, 96, 64, True, 0,
     (torch.bfloat16, torch.float32)),
    ("minicpm3-ragged", 1, 1001, 1001, 40, 40, 96, 64, True, 0,
     (torch.bfloat16, torch.float32)),
)

# training: Qwen1.5-0.5B at full width and depth, the f32 gradient check
# at B 2 x 1024 (kernels vs plain versions: loss rtol 1e-5, each gradient
# leaf within 1e-3 of its largest magnitude, attention's reduction order
# carried through 24 layers and the chunked loss), then the Trainer in
# bf16 at B 8 x 2048: warmup 2, 12 steps, a checkpoint every 4, a failure
# injected at step 6 and a resume whose losses hold to the uninterrupted
# run's at rtol 1e-4 (the kernels are deterministic)
TRAIN_ARCH = "qwen1.5-0.5b"
GRAD_CHECK = (2, 1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_FAIL = 8, 2048, 12, 6
GRAD_LOSS_RTOL, GRAD_LEAF_TOL, RESUME_RTOL = 1e-5, 1e-3, 1e-4
# Whisper-tiny trained whole: the gradient check at B 2 x 448 tokens, then
# 4 bf16 Trainer steps at 8 x 448, each with its 1500 seeded frames
WHISPER_TRAIN = (2, 8, 448, 4)
# InternVL2-76B at full width, cut to 4 of its 80 layers: 256 vision tokens
# before 768 text tokens, B 2; forward and loss_fn under no_grad, f32
# kernels vs plain versions within 1e-3 (as the served models' f32
# logits), bf16 gated as the served models are
VLM_ARCH, VLM_LAYERS, VLM_TEXT, VLM_BATCH = "internvl2-76b", 4, 768, 2
VLM_F32_TOL = 1e-3
# MiniCPM3-4B trained at full width through MLA's cacheless branch (the
# flash kernels' (96, 64) instances), its depth cut from 62 to 32 layers:
# 2,381,455,360 weights by param_count, whose f32 weights, gradients and
# AdamW moments take ~38 GB (whole, the model's state alone is ~68 GB and
# leaves no room on an 80 GB card).  The f32 gradient check at B 2 x 1024
# (Qwen's gates), then the bf16 Trainer at 8 x 2048, warmup 1, 4 steps, its
# checkpoint left out (a stub save: 28.6 GB of state; Qwen's phase drives
# the checkpoint path), then one traced step
MINICPM3_TRAIN_LAYERS = 32
MINICPM3_GRAD_CHECK = (2, 1024)
MINICPM3_TRAIN_BATCH, MINICPM3_TRAIN_SEQ, MINICPM3_TRAIN_STEPS = 8, 2048, 4
# xLSTM-350M trained whole (24 layers: 21 mLSTM through the forward and
# backward kernels, 3 sLSTM as a plain per-token loop): the f32 gradient
# check at B 2 x 1024 (Qwen's gates), then the bf16 Trainer at 8 x 2048,
# warmup 1, 4 steps, no checkpoint (Qwen's phase drives that path), a
# traced step and the sLSTM blocks' share of a step
XLSTM_GRAD_CHECK = (2, 1024)
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 8, 2048, 4
# Jamba-1.5-Large at full width (d_model 8192, d_inner 16384, N 16), cut to
# layers 0-1 of its 8-layer supercell: two Mamba layers, layer 0's dense FFN
# and layer 1's MoE FFN holding expert 0 of 16 (its router keeps 16 outputs
# and top-2, as the served cut's): 3,088,875,520 weights by param_count.
# With experts 0-1 held (3,692,855,296 weights) the bf16 Trainer's step at
# 2 x 2048 ran out of the card's memory in AdamW's update, so one expert
# is held.  The
# model is built a supercell at a time, so the cut is a supercell of two
# layers: the attention layer's period set to 2 at an offset no layer
# takes (attn_every 2, attn_offset 2), which leaves both layers Mamba.
# The cut keeps the card's memory for the training step (the served cut's
# 8 layers and 8 experts are 48 GiB of bf16 weights alone); it drops the
# supercell's attention layer, which Qwen's and MiniCPM3's phases train.
# The f32 gradient check at B 1 x 1024 (the first training of the MoE
# dispatch's index_add_ on the card), then the bf16 Trainer at 2 x 2048,
# warmup 1, 4 steps, no checkpoint, and a traced step
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_EXPERTS = 2, 1
JAMBA_GRAD_CHECK = (1, 1024)
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS = 2, 2048, 4
# the learning rate scaled from TrainConfig's 3e-4 by Qwen's width over
# Jamba's (1024 / 8192): AdamW's first step moves every weight by about
# the rate whatever its gradient, and at d 8192 the default's step moved
# each logit by ~2.5 (the loss rose 12.75 -> 19.63, then fell to 13.53 by
# step 4, above the first)
JAMBA_TRAIN_LR = 3e-4 * 1024 / 8192
# the mLSTM and scan backward kernels against their plain versions, each
# gradient within this share of its largest magnitude (f32: the two sum in
# other orders; a bf16 du beyond one bf16 rounding of each element)
RECURRENT_BWD_TOL = 1e-4
# (label, B, S, H, dh, q/k/v/out/dout off a 16-byte boundary): xLSTM-350M's
# training shape (32 of the kernel's 64-position chunks, past its window of
# 16), S at the kernel's chunk edges and the shortest it takes, ragged past
# the plain version's 256, past one window, the other head dims
MLSTM_BWD_SHAPES = (
    ("xlstm-train", 8, 2048, 4, 512, False),
    ("s2", 1, 2, 4, 512, False),
    ("s63", 2, 63, 4, 512, False),
    ("s64", 2, 64, 4, 512, False),
    ("s65", 2, 65, 4, 512, False),
    ("s256", 2, 256, 4, 128, False),
    ("s300", 2, 300, 4, 128, False),
    ("s1100", 1, 1100, 4, 64, False),
    ("dh32", 2, 300, 4, 32, False),
    ("misaligned", 1, 300, 4, 512, True),
)
# (label, B, S, D, N, u type): Jamba's training shape with u in bf16 and in
# f32, S = 1, a ragged S, S at a lane's 16 and a tile's 64 positions and
# one past each, N 8, B 2 at a narrow D, an odd D
SCAN_BWD_SHAPES = (
    ("jamba-train", 2, 2048, 16384, 16, torch.bfloat16),
    ("jamba-train-f32", 2, 2048, 16384, 16, torch.float32),
    ("s1", 1, 1, 16384, 16, torch.bfloat16),
    ("ragged", 1, 333, 16384, 16, torch.bfloat16),
    ("s16", 1, 16, 16384, 16, torch.bfloat16),
    ("s17", 1, 17, 16384, 16, torch.bfloat16),
    ("s64", 1, 64, 16384, 16, torch.bfloat16),
    ("s65", 1, 65, 16384, 16, torch.bfloat16),
    ("n8", 2, 300, 256, 8, torch.float32),
    ("narrow", 2, 130, 96, 16, torch.float32),
    ("odd-d", 2, 130, 101, 16, torch.bfloat16),
)
CKPT_ROOT = Path(__file__).resolve().parent / "chiprun_out" / "train_ckpt"


@dataclasses.dataclass(frozen=True)
class SizedTrainConfig(TrainConfig):
    """A TrainConfig that carries the run's batch shape, which the Trainer
    reads as the reference's does (``getattr(tc, "seq_len", 64)``)."""
    seq_len: int = 64
    global_batch: int = 8


def bwd_rel(got, want) -> list:
    """max |diff| / max |plain| of each of (dq, dk, dv)."""
    return [float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


def bwd_ratio(got, want, dtype) -> float:
    """How far (dq, dk, dv) sit from the plain version's, over the gate:
    the largest of :func:`bwd_rel` over ``BWD_TOL[dtype]``.  <= 1
    passes."""
    return max(bwd_rel(got, want)) / BWD_TOL[dtype]


def tile_excess(got, model) -> float:
    """How far the kernel's bf16 (dq, dk, dv) sit from the tile model's
    f32 ones beyond one bf16 rounding of each element, over each output's
    largest magnitude; the largest of the three."""
    out = 0.0
    for g, m in zip(got, model):
        m = m.float()
        over = ((g.float() - m).abs() - m.abs() * 2.0 ** -8).clamp_min(0)
        out = max(out, float(over.max()) / max(float(m.abs().max()), 1e-30))
    return out


def bwd_group_not_summed(q, k, v, o, lse, do, causal, window):
    """Control: the plain backward with each kv head's dK and dV from the
    first query head of its group alone (the GQA sum left out)."""
    first = torch.arange(0, q.shape[2], q.shape[2] // k.shape[2],
                         device=q.device)
    dq, _, _ = attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    _, dk, dv = attention_bwd_ref(q[:, :, first], k, v, o[:, :, first],
                                  lse[:, first], do[:, :, first], causal,
                                  window)
    return dq, dk, dv


def bwd_d_dropped(q, k, v, o, lse, do, causal, window):
    """Control: the plain backward without D = rowsum(dO o O)."""
    return attention_bwd_ref(q, k, v, torch.zeros_like(o), lse, do, causal,
                             window)


def by_rows(fn, q, k, v, o, lse, do, causal, window) -> tuple:
    """``fn``'s (dq, dk, dv) one batch row at a time, joined: the same
    values (no row reads another's), with the (B, H, Sq, Sk) score tensors
    of the plain versions and the tile model a row's size."""
    parts = [fn(q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1],
                lse[i:i + 1], do[i:i + 1], causal, window)
             for i in range(q.shape[0])]
    return tuple(torch.cat(ts) for ts in zip(*parts))


def check_flash_bwd(label: str, b: int, sq: int, sk: int, h: int, kv: int,
                    dh: int, dv: int, dtype: torch.dtype, causal: bool,
                    window: int, reps: int = 5) -> dict:
    """The backward kernel against its plain version on one input, after
    the forward kernel's log-sum-exp against a plain logsumexp; the two
    controls (the GQA sum left out where rep > 1, the D term dropped) must
    miss the gate by CONTROL_FACTOR; in bf16 the kernel also within
    ``TILE_TOL`` of ``attention_bwd_tiles`` (:func:`tile_excess`).  Logs
    the rate of the five products and the SFU floor of the exponentials
    beside the bound.  Times the kernel on the card alone
    (:func:`device_ms`) and with the host, the plain version, and
    ``scaled_dot_product_attention``'s backward under the same mask on the
    card alone.  q and k are ``dh`` wide, v, O and dO ``dv``.  The plain
    versions and the tile model run a batch row at a time
    (:func:`by_rows`)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + sq + sk + h)
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device=DEV).to(dtype)
    q, k, v = rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dv)
    do = rnd(b, sq, h, dv)
    o, lse = flash_ops.attention_kernel(q, k, v, causal, window,
                                        with_lse=True)
    _, lse_ref = attention_lse_ref(q, k, v, causal, window)
    seen = torch.isfinite(lse_ref)
    lse_err = (float((lse[seen] - lse_ref[seen]).abs().max())
               if bool(seen.any()) else 0.0)
    if not torch.equal(torch.isfinite(lse), seen) or lse_err > LSE_TOL:
        raise AssertionError(f"flash forward log-sum-exp disagrees with a "
                             f"plain logsumexp: {label} {_dname(dtype)} "
                             f"({lse_err:.3e})")
    args = (q, k, v, o, lse, do, causal, window)
    got = bwd_ops.attention_bwd_kernel(*args)
    again = bwd_ops.attention_bwd_kernel(*args)
    torch.cuda.synchronize()
    want = by_rows(attention_bwd_ref, *args)
    rel = bwd_rel(got, want)
    ratio = bwd_ratio(got, want, dtype)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    broken = {"d_dropped": bwd_d_dropped}
    if h != kv:
        broken["group_not_summed"] = bwd_group_not_summed
    controls = {name: bwd_ratio(by_rows(fn, *args), want, dtype)
                for name, fn in broken.items()}
    del want
    tile = None
    if dtype == torch.bfloat16:
        tile = tile_excess(got, by_rows(attention_bwd_tiles, *args))
    del got, again
    call = lambda: bwd_ops.attention_bwd_kernel(*args)  # noqa: E731
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = device_ms(lambda: attention_bwd_ref(*args), 2, warm=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if causal and sq == sk and not window:
        mask = dict(is_causal=True)
    elif not causal and not window:
        mask = {}
    else:
        mask = dict(attn_mask=_end_aligned_mask(sq, sk, causal, window, DEV))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, enable_gqa=h != kv, **mask)
    dot = do.transpose(1, 2)
    # its backward on the card alone: forward and backward in one graph,
    # less the forward alone
    library_ms = device_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), reps) - device_ms(sdpa, reps)
    backend = sdpa_backend(qt, kt, vt, mask.get("attn_mask"), 0.0,
                           bool(mask.get("is_causal")), enable_gqa=h != kv)
    del qt, kt, vt
    size = torch.finfo(dtype).bits // 8
    pairs = visible_pairs(sq, sk, causal, window)
    # S, dK, dQ by dh and dP, dV by dv: 2 (3 dh + 2 dv) FLOP a visible pair;
    # q, dq, k, dk dh wide, o, do, v, dv dv wide, lse
    flop = 2.0 * b * h * (3 * dh + 2 * dv) * pairs
    bound_ms, bound_by = attn_bound_ms(
        (2 * b * sq * h + 2 * b * sk * kv) * (dh + dv) * size + 4 * b * h * sq,
        flop, dtype)
    # two exponentials a visible pair: the dK/dV and the dQ passes each
    # recompute P
    sfu_ms = 2.0 * b * h * pairs / SFU_EX2_PER_S * 1e3
    tile_log = ("" if tile is None else
                f"; beyond one rounding of the tile model {tile:.2e} (gate "
                f"{TILE_TOL:g}) {'ok' if tile <= TILE_TOL else 'FAIL'}")
    log(f"  {label:16s} {_dname(dtype):8s} B={b} Sq={sq} Sk={sk} H={h} "
        f"KV={kv} dh={dh}{'' if dv == dh else f' dv={dv}'} "
        f"causal={int(causal)} window={window}: "
        f"max_abs_err={err:.3e}, of each output's largest (dq, dk, dv) "
        f"{', '.join(f'{x:.2e}' for x in rel)} ({ratio:.3f} of the gate "
        f"{BWD_TOL[dtype]:g}) "
        f"{'ok' if ratio <= 1 else 'FAIL'}{tile_log}; lse err "
        f"{lse_err:.2e}; deterministic={same}; controls (x the gate) "
        f"{json.dumps({k: round(x, 2) for k, x in controls.items()})}; "
        f"kernel {ms:.4f} ms (with the host {call_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms ({backend}), "
        f"bound {bound_ms:.6f} ms ({bound_by}); x bound "
        f"{ms / bound_ms:.1f}, x sdpa {ms / library_ms:.2f}; "
        f"{flop / ms / 1e9:.1f} TFLOP/s of the five products; the "
        f"exponentials' SFU floor {sfu_ms:.6f} ms")
    if ratio > 1:
        raise AssertionError(f"flash backward kernel disagrees with its "
                             f"plain version: {label} {_dname(dtype)}")
    if tile is not None and tile > TILE_TOL:
        raise AssertionError(f"flash backward kernel disagrees with the "
                             f"model of its arithmetic: {label} "
                             f"({tile:.2e})")
    if not same:
        raise AssertionError(f"flash backward kernel is not deterministic: "
                             f"{label} {_dname(dtype)}")
    for name, r in controls.items():
        if r < CONTROL_FACTOR:
            raise AssertionError(f"control {name} at {label} is within "
                                 f"{r:.2f}x the gate (needs "
                                 f"{CONTROL_FACTOR}x)")
    return {"label": label, "dtype": _dname(dtype),
            "shape": [b, sq, sk, h, kv, dh], "dv": dv, "causal": causal,
            "window": window, "max_abs_err": err, "rel": rel,
            "x_gate": ratio, "tile_excess": tile,
            "lse_err": lse_err, "controls": controls, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_backend": backend,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flop / ms / 1e9, "sfu_floor_ms": sfu_ms}


def flash_bwd_phases() -> tuple:
    """``check_flash_bwd`` at every shape of :data:`BWD_SHAPES`; both
    controls must have been caught in each type.  Returns (instances,
    Qwen's bf16 training shape, which the kernel line reports)."""
    log("== flash-attention backward kernel vs plain "
        "(attention_bwd_ref) on the card")
    out = []
    for label, b, sq, sk, h, kv, dh, dv, causal, window, dtypes in \
            BWD_SHAPES:
        for dt in dtypes:
            out.append(check_flash_bwd(label, b, sq, sk, h, kv, dh, dv, dt,
                                       causal, window))
            gc.collect()
            torch.cuda.empty_cache()
    for dt in (torch.bfloat16, torch.float32):
        caught = {name for inst in out if inst["dtype"] == _dname(dt)
                  for name in inst["controls"]}
        if caught != {"d_dropped", "group_not_summed"}:
            raise AssertionError(f"controls run in {_dname(dt)}: "
                                 f"{sorted(caught)}")
    return out, out[0]


def expect_calls(path: str, got: dict, want: dict) -> None:
    """The kernels' wrapper calls on a training path, against the count its
    layers give."""
    log(f"  {path}: kernel wrapper calls {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{path} called the kernels {got} times "
                             f"(expected {want})")


def calls_per_pass(cfg) -> dict:
    """The kernels' calls in one loss and gradient: each attention call's
    flash forward (``forward``) and backward (``backward``), each mLSTM and
    Mamba layer's forward and backward kernel, once each, and every
    decoder block's forward once more where ``remat`` recomputes it (the
    encoder runs outside the checkpointed blocks)."""
    kinds = cfg.layer_kinds()
    again = 2 if cfg.remat == "block" else 1
    dec = sum(k == "attn" for k in kinds)
    dec *= 2 if cfg.is_encdec else 1       # self- and cross-attention
    enc = cfg.n_enc_layers if cfg.is_encdec else 0
    n_mlstm, n_mamba = kinds.count("mlstm"), kinds.count("mamba")
    return {"forward": enc + dec * again, "backward": enc + dec,
            "mlstm": n_mlstm * again, "mlstm_bwd": n_mlstm,
            "mamba_scan": n_mamba * again, "mamba_scan_bwd": n_mamba}


# the wrappers a training path calls, by the names calls_per_pass gives
TRAIN_WRAPPERS = {"forward": flash_ops, "backward": bwd_ops,
                  "mlstm": mlstm_ops, "mlstm_bwd": mlstm_bwd_ops,
                  "mamba_scan": mamba_ops, "mamba_scan_bwd": scan_bwd_ops}
# and the kernel each runs, as the kernel line names it
TRAIN_KERNELS = {"forward": "flash_attention",
                 "backward": "flash_attention_bwd", "mlstm": "mlstm",
                 "mlstm_bwd": "mlstm_bwd", "mamba_scan": "mamba_scan",
                 "mamba_scan_bwd": "mamba_scan_bwd"}


def kernel_calls() -> dict:
    return {k: m.launches for k, m in TRAIN_WRAPPERS.items()}


def reset_kernels() -> None:
    for m in TRAIN_WRAPPERS.values():
        m.reset_launches()


def lm_batch(cfg, b: int, s: int, step: int = 0) -> dict:
    """``SyntheticLM``'s batch ``step`` at B x S (the family's frames or
    vision embeddings with it), numpy, as the Trainer draws them."""
    return SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=SEED,
        family=cfg.family, n_vision_tokens=cfg.n_vision_tokens,
        d_model=cfg.d_model, enc_seq=cfg.enc_seq)).batch_at(step)


def grad_check(label: str, cfg, batch: dict) -> dict:
    """One loss and gradient of seeded f32 weights through the kernels and
    through the plain versions (``plain=True``): the loss within
    GRAD_LOSS_RTOL and every gradient leaf within GRAD_LEAF_TOL of its
    largest magnitude; the kernels' calls gated."""
    p = init_params(torch.Generator(device=DEV).manual_seed(SEED), cfg, DEV)

    def value_and_grad(plain: bool) -> tuple:
        pt = tree_map(lambda t: t.detach().requires_grad_(), p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(pt, cfg, batch, DEV, plain=plain)
        gs = torch.autograd.grad(loss, leaves(pt), allow_unused=True)
        torch.cuda.synchronize()
        return loss.detach(), gs, time.perf_counter() - t0

    reset_kernels()
    loss, gs, secs = value_and_grad(False)
    calls = kernel_calls()
    loss_p, gs_p, secs_p = value_and_grad(True)
    loss_rel = float((loss - loss_p).abs() / loss_p.abs())
    worst, worst_key = 0.0, None
    for (key, _), g, gp in zip(flatten_with_keys(p), gs, gs_p):
        if gp is None:
            continue
        r = float((g - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if r >= worst:
            worst, worst_key = r, key
    n_params = sum(t.numel() for t in leaves(p))
    log(f"  {label}: {n_params} weights; loss {float(loss):.6f} (plain "
        f"{float(loss_p):.6f}, rel {loss_rel:.2e}); worst gradient leaf "
        f"{worst_key} at {worst:.2e} of its largest magnitude; loss and "
        f"gradient {secs:.3f} s through the kernels, {secs_p:.3f} s plain")
    expect_calls(label, calls, calls_per_pass(cfg))
    if loss_rel > GRAD_LOSS_RTOL or worst > GRAD_LEAF_TOL:
        raise AssertionError(f"{label}: kernels' loss / gradients differ "
                             f"from the plain path's (loss rel "
                             f"{loss_rel:.2e}, leaf {worst_key} {worst:.2e})")
    return {"weights": n_params, "loss": float(loss),
            "loss_rel": loss_rel, "worst_leaf": worst_key,
            "worst_leaf_rel": worst, "s": secs, "plain_s": secs_p,
            "calls": calls}


# the dry-run (repro_torch.launch.dryrun): the cells of the reference's own
# tests (tests/test_dryrun.py), and the estimator on a (1, 1) mesh for
# Qwen's train step and serving decode as this script runs them; the
# training estimate's peak against the card's traced step
DRYRUN_REF_CELLS = (("qwen1.5-0.5b", "train_4k", False),
                    ("whisper-tiny", "decode_32k", True))
DRYRUN_TIMEOUT = 600
PEAK_BAND = (0.9, 1.1)
DRYRUNS: dict = {}      # {label: (start, process, out, err)}, stopped at exit
# (B, S, D, N) the scan backward takes beyond SCAN_BWD_SHAPES, and (B, S, H,
# dh) the mLSTM beyond MLSTM_BWD_SHAPES: Jamba's and xLSTM's served prefills
SCAN_WORKSPACE_SHAPES = ((1, 980, 16384, 16),)
MLSTM_WORKSPACE_SHAPES = ((1, 128, 4, 512), (1, 980, 4, 512),
                          (1, 1024, 4, 512))


def dryrun_cmds() -> dict:
    """{label: argv} of the dry-run's cells."""
    base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    cmds = {f"{a} {sh} {'2x16x16' if mp else '16x16'}":
            base + ["--arch", a, "--shape", sh] + (["--multi-pod"] * mp)
            for a, sh, mp in DRYRUN_REF_CELLS}
    cmds["one-card train"] = base + [
        "--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh", "1x1",
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    cmds["one-card decode"] = base + [
        "--arch", ARCH, "--shape", "decode_32k", "--mesh", "1x1",
        "--batch", str(SERVING.lanes), "--seq", str(SERVING.max_len),
        "--served"]
    return cmds


def start_dryruns() -> dict:
    """The dry-run's cells, each in a subprocess that sees no card (a fake
    process group must not live in this process, which holds the card),
    all started together, their output in temporary files (a pipe left
    unread would stall them): {label: (start time, process, stdout,
    stderr)}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    out = {}
    for label, cmd in dryrun_cmds().items():
        so, se = (tempfile.TemporaryFile("w+") for _ in range(2))
        out[label] = (time.perf_counter(), subprocess.Popen(
            cmd, env=env, stdout=so, stderr=se, text=True), so, se)
    return out


def stop_dryruns(procs: dict) -> None:
    for _, p, so, se in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        so.close()
        se.close()


def wait_dryruns(procs: dict) -> dict:
    """Each process's own wall time from its start to its exit, polled
    every 50 ms, within ``DRYRUN_TIMEOUT``: {label: s}."""
    ended: dict = {}
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    while len(ended) < len(procs):
        for label, (start, p, _, _) in procs.items():
            if label not in ended and p.poll() is not None:
                ended[label] = time.perf_counter() - start
        if len(ended) < len(procs):
            if time.perf_counter() > deadline:
                raise AssertionError(f"dry-run cells past {DRYRUN_TIMEOUT} "
                                     f"s: {sorted(set(procs) - set(ended))}")
            time.sleep(0.05)
    return ended


def workspace_gates() -> dict:
    """The meta rules' Python copies of the kernels' workspace formulas
    (``workspace_floats`` of the mLSTM forward and backward and the scan
    backward) against the built libraries' ``*_workspace_floats`` at every
    shape the checks, the training path and the served prefills give those
    kernels: {kernel: shapes compared}; any difference raises (the
    dry-run's peak would drift from the card's)."""
    mlstm = [sh[1:5] for sh in MLSTM_BWD_SHAPES] + list(MLSTM_WORKSPACE_SHAPES)
    scan = [sh[1:5] for sh in SCAN_BWD_SHAPES] + list(SCAN_WORKSPACE_SHAPES)
    out = {}
    for name, ops, shapes in (("mlstm", mlstm_ops, mlstm),
                              ("mlstm_bwd", mlstm_bwd_ops, mlstm),
                              ("mamba_scan_bwd", scan_bwd_ops, scan)):
        lib = ops._entry()[1]
        for shape in shapes:
            want, got = lib(*shape), ops.workspace_floats(*shape)
            if want != got:
                raise AssertionError(f"{name}.workspace_floats{shape} = {got}"
                                     f", the library's {want}")
        out[name] = len(shapes)
    log(f"  workspace formulas equal to the libraries': {json.dumps(out)}")
    return out


def dryrun_phases(procs: dict, traced: dict, served: dict) -> dict:
    """Each dry-run cell's JSON line (a ``dryrun:`` line each), the
    reference tests' cells ``ok`` on their meshes, and the one-card
    estimates against the card: the train state's and the serving engine's
    bytes exactly, the traced step's peak within ``PEAK_BAND``."""
    log("== dry-run: the reference tests' cells on the production meshes, "
        "the estimator on a (1, 1) mesh against the card")
    t0 = time.perf_counter()
    workspace = workspace_gates()
    wall = wait_dryruns(procs)
    out: dict = {}
    for label, (_, p, so, se) in procs.items():
        so.seek(0)
        se.seek(0)
        lines = [ln for ln in so.read().splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"dry-run {label} failed (exit "
                                 f"{p.returncode}): {se.read()[-3000:]}")
        res = json.loads(lines[-1])
        log(f"dryrun: {json.dumps(res)}")
        out[label] = {"result": res, "wall_s": wall[label]}
    for a, sh, mp in DRYRUN_REF_CELLS:
        res = out[f"{a} {sh} {'2x16x16' if mp else '16x16'}"]["result"]
        mesh, n = ("2x16x16", 512) if mp else ("16x16", 256)
        c = res["collectives"]
        if not (res["ok"] and res["mesh"] == mesh and res["n_devices"] == n
                and res["flops_per_device"] > 0):
            raise AssertionError(f"dry-run {a} {sh}: {res}")
        if sh == "train_4k" and not (c["all-reduce"] > 0
                                     or c["reduce-scatter"] > 0):
            raise AssertionError(f"dry-run {a} {sh}: no reduction: {c}")
    train = out["one-card train"]["result"]["memory"]
    decode = out["one-card decode"]["result"]["memory"]
    held = sum(served["held_bytes"].values())
    ratio = train["peak_bytes"] / traced["peak_bytes"]
    gates = {
        "train_argument_bytes": [train["sharded_argument_bytes_exact"],
                                 traced["state_bytes"]],
        "decode_argument_bytes": [decode["sharded_argument_bytes_exact"],
                                  held],
        "train_peak_bytes": [train["peak_bytes"], traced["peak_bytes"],
                             ratio],
        "workspace_shapes": workspace}
    log(f"  one-card train: estimated arguments "
        f"{train['sharded_argument_bytes_exact']:.0f} B, the card's state "
        f"{traced['state_bytes']} B; estimated peak {train['peak_bytes']} B, "
        f"the card's traced step {traced['peak_bytes']} B: x {ratio:.4f} "
        f"(band {PEAK_BAND})")
    log(f"  one-card decode: estimated arguments "
        f"{decode['sharded_argument_bytes_exact']:.0f} B, the engine's "
        f"weights and caches {held} B ({served['held_bytes']})")
    if train["sharded_argument_bytes_exact"] != traced["state_bytes"]:
        raise AssertionError(f"the train estimate's arguments differ from "
                             f"the card's state: {gates}")
    if decode["sharded_argument_bytes_exact"] != held:
        raise AssertionError(f"the decode estimate's arguments differ from "
                             f"the engine's weights and caches: {gates}")
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(f"the train estimate's peak is x {ratio:.4f} "
                             f"of the card's (band {PEAK_BAND})")
    phase = time.perf_counter() - t0
    log(f"  dry-run phase {phase:.1f} s; each process's wall (s) "
        + json.dumps({k: round(v["wall_s"], 1) for k, v in out.items()}))
    return {"cells": out, "gates": gates, "phase_s": phase}


def traced_train_step(cfg, tc, warm: bool = True) -> dict:
    """One bf16 train step of fresh weights, warmed by one untraced step
    (``warm``), under the profiler: its wall time, device events, busy time
    by kind and idle share, the kernels' calls (gated), each kernel's CUDA
    launches a call and the step's peak memory."""
    p = init_params(torch.Generator(device=DEV).manual_seed(SEED), cfg, DEV)
    state = init_state(p, tc)
    step = make_train_step(cfg, tc, DEV)
    batch = lm_batch(cfg, tc.global_batch, tc.seq_len)
    if warm:
        state, m = step(state, batch)
        float(m["loss"])
    state_bytes = _nbytes(state)
    reset_kernels()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=list(TRAIN_TRACE_ACTIVITIES)) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = kernel_calls()
    peak = torch.cuda.max_memory_allocated()
    expect_calls(f"{cfg.name} traced step", calls, calls_per_pass(cfg))
    events, busy, by_kind = _device_time(prof)
    per_call = cuda_launches_per_call(
        prof, {TRAIN_KERNELS[k]: n for k, n in calls.items()})
    del state, p
    out = {"wall_s": wall, "device_events": events, "busy_s": busy,
           "idle_share": 1 - busy / wall, "busy_by_kind": by_kind,
           "calls": calls, "cuda_launches_per_call": per_call,
           "peak_mem_gib": peak / 2 ** 30, "peak_bytes": peak,
           "state_bytes": state_bytes}
    log(f"  traced step: {json.dumps(out)}")
    return out


class _NoSave:
    """What a stub ``save`` returns: nothing is in flight."""

    @staticmethod
    def join() -> None:
        return None


def trainer_runs(label: str, cfg, tc, fail_at: int | None,
                 save: bool = True) -> dict:
    """The Trainer from fresh weights to ``tc.total_steps``, checkpointing
    only at its end (``save=False``: not at all, ``ckpt.save`` a stub),
    with the kernels' counts set to 0 just before and read
    just after; its tokens/s are every token over the run's wall time
    (start-up, data and the checkpoint included), beside the median step's.
    Then, with ``fail_at``, a run checkpointing every ``tc.ckpt_every``
    steps that fails there, and one that resumes from its last checkpoint
    through step ``fail_at + 1``, whose losses must hold to the first
    run's.  The checkpoints are removed at the end."""
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    tc_a = dataclasses.replace(tc, ckpt_dir=str(CKPT_ROOT / "a"),
                               ckpt_every=tc.total_steps)
    torch.cuda.reset_peak_memory_stats()
    stub = (contextlib.nullcontext() if save else
            swapped(ckpt_mod, "save", lambda *a, **k: _NoSave()))
    reset_kernels()
    t0 = time.perf_counter()
    with stub:
        full = Trainer(cfg, tc_a).run()
    wall = time.perf_counter() - t0
    calls = kernel_calls()
    peak = torch.cuda.max_memory_allocated()
    steps = tc.total_steps
    per = calls_per_pass(cfg)
    expect_calls(label, calls, {k: n * steps for k, n in per.items()})
    losses = full["losses"]
    secs = full["step_seconds"]
    median_s = float(np.median(secs))
    tokens = tc.global_batch * tc.seq_len
    out = {"steps": steps, "batch": [tc.global_batch, tc.seq_len],
           "checkpoint": save,
           "losses": losses, "step_s": secs, "median_step_s": median_s,
           "tokens_per_s": tokens * steps / wall,
           "median_step_tokens_per_s": tokens / median_s, "wall_s": wall,
           "peak_mem_gib": peak / 2 ** 30, "calls": calls,
           "calls_per_step": per}
    log(f"  {label}: losses {[round(x, 4) for x in losses]}; run wall "
        f"{wall:.3f} s ({'one checkpoint' if save else 'no checkpoint'}) "
        f"for {tokens * steps} tokens, "
        f"{out['tokens_per_s']:.1f} tokens/s; steps: first {secs[0]:.4f} "
        f"s, median {median_s:.4f} s ({tokens / median_s:.1f} tokens/s); "
        f"peak {peak / 2 ** 30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    if (fail_at is not None or not save) and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the last loss {losses[-1]} is not "
                             f"below the first {losses[0]}")
    if fail_at is not None:
        tc_b = dataclasses.replace(tc, ckpt_dir=str(CKPT_ROOT / "b"))
        t0 = time.perf_counter()
        try:
            Trainer(cfg, tc_b, fail_at_step=fail_at).run()
        except InjectedFailure as e:
            log(f"  {label}: {e}")
        else:
            raise AssertionError(f"{label}: no failure at step {fail_at}")
        until = fail_at + 2
        resumed = Trainer(cfg, tc_b).run(steps=until)
        restart = time.perf_counter() - t0
        start = until - len(resumed["losses"])
        want = losses[start:until]
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                      want))
        out["resume"] = {"from_step": start, "to_step": until - 1,
                         "losses": resumed["losses"],
                         "max_rel_diff": rel, "wall_s": restart}
        log(f"  {label}: failed at step {fail_at}, resumed from step "
            f"{start} through {until - 1}: losses "
            f"{[round(x, 4) for x in resumed['losses']]}, "
            f"max rel diff {rel:.2e} from the uninterrupted run "
            f"(rtol {RESUME_RTOL}); fail and resume wall {restart:.1f} s")
        if start != (fail_at // tc.ckpt_every) * tc.ckpt_every or \
                rel > RESUME_RTOL:
            raise AssertionError(f"{label}: the resumed run differs "
                                 f"(from step {start}, rel {rel:.2e})")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    return out


def training_phases() -> dict:
    """Qwen1.5-0.5B, Whisper-tiny, MiniCPM3-4B (32 layers), xLSTM-350M and
    Jamba (2 layers, 1 expert) trained on the card and InternVL2-76B's
    vision-prefixed forward and loss (see the module docstring)."""
    out: dict = {}
    cfg = get_config(TRAIN_ARCH)
    log(f"== training {TRAIN_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers, d {cfg.d_model}, vocab {cfg.vocab})")
    b, s = GRAD_CHECK
    out["grad_check"] = grad_check(f"{TRAIN_ARCH} f32 {b} x {s}",
                                   cfg.replace(dtype="float32"),
                                   lm_batch(cfg, b, s))
    gc.collect()
    torch.cuda.empty_cache()
    tc = SizedTrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                          warmup_steps=2, total_steps=TRAIN_STEPS,
                          ckpt_every=4, seed=SEED)
    out["trainer"] = trainer_runs(f"{TRAIN_ARCH} bf16 Trainer", cfg, tc,
                                  TRAIN_FAIL)
    gc.collect()
    torch.cuda.empty_cache()
    out["traced_step"] = traced_train_step(cfg, tc)
    gc.collect()
    torch.cuda.empty_cache()

    wcfg = get_config(WHISPER_ARCH)
    gb, tb, ts, steps = WHISPER_TRAIN
    log(f"== training {WHISPER_ARCH} whole ({wcfg.n_enc_layers} + "
        f"{wcfg.n_layers} layers, d {wcfg.d_model}, {wcfg.enc_seq} frames)")
    out["whisper_grad_check"] = grad_check(
        f"{WHISPER_ARCH} f32 {gb} x {ts}", wcfg.replace(dtype="float32"),
        lm_batch(wcfg, gb, ts))
    wtc = SizedTrainConfig(seq_len=ts, global_batch=tb, warmup_steps=1,
                           total_steps=steps, ckpt_every=steps, seed=SEED)
    out["whisper_trainer"] = trainer_runs(f"{WHISPER_ARCH} bf16 Trainer",
                                          wcfg, wtc, None)
    gc.collect()
    torch.cuda.empty_cache()
    out["vlm"] = vlm_phase()
    gc.collect()
    torch.cuda.empty_cache()
    out.update(minicpm3_training())
    gc.collect()
    torch.cuda.empty_cache()
    out.update(xlstm_training())
    gc.collect()
    torch.cuda.empty_cache()
    out.update(jamba_training())
    return out


def minicpm3_training() -> dict:
    """MiniCPM3-4B at full width, MINICPM3_TRAIN_LAYERS layers: the f32
    gradient check, the bf16 Trainer without a checkpoint, a traced
    step."""
    out: dict = {}
    mcfg = get_config(MINICPM3_ARCH).replace(n_layers=MINICPM3_TRAIN_LAYERS)
    gb, gs = MINICPM3_GRAD_CHECK
    log(f"== training {MINICPM3_ARCH} at full width (d {mcfg.d_model}, "
        f"{mcfg.n_heads} heads, MLA q_lora {mcfg.q_lora_rank}, kv_lora "
        f"{mcfg.kv_lora_rank}, rope {mcfg.rope_head_dim}: attention at q/k "
        f"{mcfg.head_dim + mcfg.rope_head_dim}, v {mcfg.head_dim}), "
        f"{MINICPM3_TRAIN_LAYERS} of 62 layers, {mcfg.param_count()} "
        f"weights by param_count")
    out["minicpm3_grad_check"] = grad_check(
        f"{MINICPM3_ARCH} f32 {gb} x {gs}", mcfg.replace(dtype="float32"),
        lm_batch(mcfg, gb, gs))
    gc.collect()
    torch.cuda.empty_cache()
    mtc = SizedTrainConfig(seq_len=MINICPM3_TRAIN_SEQ,
                           global_batch=MINICPM3_TRAIN_BATCH, warmup_steps=1,
                           total_steps=MINICPM3_TRAIN_STEPS,
                           ckpt_every=MINICPM3_TRAIN_STEPS, seed=SEED)
    out["minicpm3_trainer"] = trainer_runs(f"{MINICPM3_ARCH} bf16 Trainer",
                                           mcfg, mtc, None, save=False)
    gc.collect()
    torch.cuda.empty_cache()
    out["minicpm3_traced_step"] = traced_train_step(mcfg, mtc)
    return out


def vlm_phase() -> dict:
    """InternVL2-76B at full width, VLM_LAYERS layers: ``forward`` and
    ``loss_fn`` with the vision prefix under no_grad, f32 through the
    kernels against the plain versions, then bf16 (``serve_params``) read
    and gated by MiniCPM3's nudge rule."""
    cfg = get_config(VLM_ARCH).replace(n_layers=VLM_LAYERS, dtype="float32")
    log(f"== {VLM_ARCH} at full width (d {cfg.d_model}, {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
        f"{VLM_LAYERS} of 80 layers: {cfg.n_vision_tokens} vision + "
        f"{VLM_TEXT} text tokens, B {VLM_BATCH}")
    t0 = time.perf_counter()
    p = init_params(torch.Generator(device=DEV).manual_seed(SEED), cfg, DEV)
    batch = lm_batch(cfg, VLM_BATCH, VLM_TEXT)
    out = {"weights": sum(t.numel() for t in leaves(p)),
           "init_s": time.perf_counter() - t0}
    tokens, vis = batch["tokens"], batch["vision_embeds"]

    def run(params, c, plain: bool) -> tuple:
        h, _ = forward(params, c, tokens, device=DEV, plain=plain,
                       vision_embeds=vis)
        loss, _ = loss_fn(params, c, batch, DEV, plain=plain)
        return h.float(), T.logits_fn(params, c, h[:, -1]).float(), loss

    with torch.no_grad():
        flash_ops.reset_launches()
        t0 = time.perf_counter()
        h, lg, loss = run(p, cfg, False)
        torch.cuda.synchronize()
        out["f32_s"] = time.perf_counter() - t0
        out["flash_calls"] = flash_ops.launches
        hp, lgp, loss_p = run(p, cfg, True)
        out["f32"] = {"hidden_rel": float((h - hp).abs().max()
                                          / hp.abs().max()),
                      "logits_rel": _rel(lg, lgp),
                      "loss": float(loss), "loss_plain": float(loss_p),
                      "loss_rel": float((loss - loss_p).abs()
                                        / loss_p.abs())}
        del h, hp
        c16 = cfg.replace(dtype="bfloat16")
        sp = serve_params(p, c16)
        del p
        gc.collect()
        _, lg16, loss16 = run(sp, c16, False)
        _, lg16p, loss16p = run(sp, c16, True)
        with swapped(L, "attention_ref", q_nudged(attention_ref)):
            _, lg16n, _ = run(sp, c16, True)
        rel, nudge = _rel(lg16, lg16p), _rel(lg16n, lg16p)
        out["bf16"] = {"logits_rel": rel, "plain_nudged_rel": nudge,
                       "gated": nudge <= LOGIT_TOL[torch.bfloat16],
                       "loss": float(loss16), "loss_plain": float(loss16p)}
        del sp
    log(f"  {VLM_ARCH}: {out['weights']} weights; {json.dumps(out)}")
    if out["flash_calls"] != 2 * VLM_LAYERS:
        raise AssertionError(f"{VLM_ARCH}: {out['flash_calls']} flash calls "
                             f"(expected {2 * VLM_LAYERS})")
    f32 = out["f32"]
    if max(f32["hidden_rel"], f32["logits_rel"], f32["loss_rel"]) > \
            VLM_F32_TOL:
        raise AssertionError(f"{VLM_ARCH}: f32 kernels differ from the "
                             f"plain path: {f32}")
    if out["bf16"]["gated"] and rel > LOGIT_TOL[torch.bfloat16]:
        raise AssertionError(f"{VLM_ARCH}: bf16 logits differ from the "
                             f"plain path by {rel:.3e}")
    if not np.isfinite([f32["loss"], out["bf16"]["loss"]]).all():
        raise AssertionError(f"{VLM_ARCH}: a loss is not finite")
    return out


def mlstm_bwd_bound_ms(b: int, s: int, h: int, dh: int) -> tuple:
    """(least ms for the mLSTM's gradient on this card, "bytes" |
    "operations", ms of the operations on the CUDA cores in f32): q, k, v,
    out, dout and the gates read once, dq, dk, dv and the gates' gradients
    written once, over HBM rate; against the recurrent form's gradient,
    ~4 dh^2 multiply-adds a position and head (the reverse state's update,
    its products with v and k, q's with the forward state) at f32
    accuracy, the faster of the CUDA cores' f32 peak and three TF32
    passes (hi*hi + hi*lo + lo*hi, as the kernel forms them) at the tensor
    cores' TF32 peak."""
    t_bytes = 4 * (8 * b * s * h * dh + 4 * b * s * h) / HBM_BPS
    flops = 2 * 4 * dh * dh * b * s * h
    t_f32 = flops / PEAK_FLOPS[torch.float32]
    t_ops = min(t_f32, 3 * flops / PEAK_TF32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, t_f32) * 1e3)


def scan_bwd_bound_ms(b: int, s: int, d: int, n: int, u_bytes: int) -> tuple:
    """(least ms for the scan's gradient on this card, "bytes" |
    "operations"): dt, a, B, C, u and dy read once and their gradients
    written once, over HBM rate; against one exponential (a_bar) a
    (position, channel, state) on the special-function units."""
    small = 4 * (b * s + d * n + 2 * b * s * n)
    t_bytes = (2 * small + 4 * b * s * d + 2 * u_bytes * b * s * d) / HBM_BPS
    t_ops = b * s * d * n / SFU_EX2_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def recurrent_rel(got, want) -> list:
    """Each gradient's max |diff| over its largest magnitude; a bf16
    gradient's beyond one bf16 rounding of each element (2^-8 of it)."""
    out = []
    for g, w in zip(got, want):
        w = w.float()
        diff = (g.float() - w).abs()
        if g.dtype == torch.bfloat16:
            diff = (diff - w.abs() * 2.0 ** -8).clamp_min(0)
        out.append(float(diff.max()) / max(float(w.abs().max()), 1e-30))
    return out


def check_recurrent_bwd(name: str, label: str, shape: list, kernel, plain,
                        args: tuple, controls: dict, bound: tuple,
                        reps: int = 3) -> dict:
    """A backward kernel (``kernel(*args)``) against its plain version
    (``plain(*args)``): every gradient within RECURRENT_BWD_TOL of its
    largest magnitude (:func:`recurrent_rel`), two calls bitwise, each
    control (``plain(*args, **kw)``) at least CONTROL_FACTOR past the gate.
    Times the kernel on the card alone (:func:`device_ms`) and with the
    host, and one call of the plain version (CUDA events: it is a loop of
    small launches).  No single PyTorch call computes either gradient: no
    library time."""
    got = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    rel = recurrent_rel(got, want)
    ratio = max(rel) / RECURRENT_BWD_TOL
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    del got, again
    ctl = {}
    for cname, kw in controls.items():
        broken = plain(*args, **kw)
        ctl[cname] = max(recurrent_rel(broken, want)) / RECURRENT_BWD_TOL
        del broken
    del want
    call = lambda: kernel(*args)  # noqa: E731
    ms = device_ms(call, reps)
    call_ms = time_ms(call, reps)
    plain_ms = time_ms(lambda: plain(*args), 1, warm=1)
    bound_ms, bound_by, *f32 = bound
    extra = (f"; on the CUDA cores in f32 {f32[0]:.6f} ms, x "
             f"{ms / f32[0]:.1f}" if f32 else "")
    log(f"  {label:16s} {shape}: max_abs_err={err:.3e}, of each gradient's "
        f"largest {', '.join(f'{x:.2e}' for x in rel)} ({ratio:.3f} of the "
        f"gate {RECURRENT_BWD_TOL:g}) {'ok' if ratio <= 1 else 'FAIL'}; "
        f"deterministic={same}; controls (x the gate) "
        f"{json.dumps({k: round(x, 1) for k, x in ctl.items()})}; kernel "
        f"{ms:.4f} ms (with the host {call_ms:.4f}), plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.6f} ms ({bound_by}), x bound "
        f"{ms / bound_ms:.1f}{extra}")
    if ratio > 1:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version: {label} {shape}")
    if not same:
        raise AssertionError(f"{name} kernel is not deterministic: {label}")
    for cname, r in ctl.items():
        if r < CONTROL_FACTOR:
            raise AssertionError(f"control {cname} at {label} is within "
                                 f"{r:.2f}x the gate (needs "
                                 f"{CONTROL_FACTOR}x)")
    return {"label": label, "shape": shape, "max_abs_err": err, "rel": rel,
            "x_gate": ratio, "controls": ctl, "deterministic": same,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            **({"bound_f32_ms": f32[0]} if f32 else {})}


def mlstm_bwd_phases() -> tuple:
    """The mLSTM backward kernel against ``mlstm_chunkwise_bwd_ref`` at
    every shape of :data:`MLSTM_BWD_SHAPES`, on the forward kernel's output
    and a seeded cotangent, with two controls: the floor ``e^{-m_t}`` held
    constant (no gradient through the stabiliser) and, past one 64-position
    chunk, dC and dn not carried from chunk to chunk.  Returns (instances,
    the training shape's)."""
    log("== mLSTM backward kernel vs plain (mlstm_chunkwise_bwd_ref) on the "
        "card, f32")
    out = []
    for label, b, s, h, dh, misaligned in MLSTM_BWD_SHAPES:
        t0 = time.perf_counter()
        ins, _ = mlstm_inputs(b, s, h, dh, "none")
        o, _ = mlstm_ops.mlstm_kernel(*ins)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 7 * s + dh)
        dout = torch.randn(b, s, h, dh, generator=gen, device=DEV)
        args = (*ins, o, dout)
        if misaligned:
            args = (*map(_off_boundary, args[:3]), *args[3:5],
                    *map(_off_boundary, args[5:]))
        controls = {"stabiliser_dropped": {"drop_stabiliser": True}}
        if s > 64:
            controls["carry_dropped"] = {"drop_carry": True, "chunk": 64}
        inst = check_recurrent_bwd(
            "mlstm_bwd", label, [b, s, h, dh], mlstm_bwd_ops.mlstm_bwd_kernel,
            mlstm_chunkwise_bwd_ref, args, controls,
            mlstm_bwd_bound_ms(b, s, h, dh))
        inst.update(dtype="float32", misaligned=misaligned,
                    s=time.perf_counter() - t0)
        out.append(inst)
        del ins, o, dout, args
        gc.collect()
        torch.cuda.empty_cache()
    caught = {c for inst in out for c in inst["controls"]}
    if caught != {"stabiliser_dropped", "carry_dropped"}:
        raise AssertionError(f"mLSTM backward controls run: {sorted(caught)}")
    return out, out[0]


def mamba_bwd_phases() -> tuple:
    """The selective-scan backward kernel, given the tile states the
    forward kernel keeps (as training calls it), against
    ``selective_scan_bwd_ref`` at every shape of :data:`SCAN_BWD_SHAPES`
    with a seeded cotangent, with two controls: past the first position,
    ddt without its ``a a_bar h`` term, and past one 64-position tile, dh
    not carried from tile to tile.  Returns (instances, the bf16 training
    shape's)."""
    log("== selective-scan backward kernel vs plain (selective_scan_bwd_ref) "
        "on the card")
    out = []
    for label, b, s, d, n, u_dtype in SCAN_BWD_SHAPES:
        t0 = time.perf_counter()
        dt, a, bmat, cmat, u, _ = mamba_inputs(b, s, d, n, u_dtype, "none")
        gen = torch.Generator(device=DEV).manual_seed(SEED + 7 * s + d)
        dy = torch.randn(b, s, d, generator=gen, device=DEV)
        # the tile states the forward kernel keeps under a gradient, as the
        # training path hands them to the backward kernel
        *_, hs = mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u,
                                                 keep_states=True)
        # at S = 1 the term is 0 (h_{-1} = 0), within one tile no carry
        controls = {"decay_term_dropped": {"drop_decay_term": True}} \
            if s > 1 else {}
        if s > 64:
            controls["carry_dropped"] = {"drop_carry": True, "chunk": 64}
        inst = check_recurrent_bwd(
            "mamba_scan_bwd", label, [b, s, d, n],
            functools.partial(scan_bwd_ops.selective_scan_bwd_kernel,
                              hs=hs), selective_scan_bwd_ref,
            (dt, a, bmat, cmat, u, dy), controls,
            scan_bwd_bound_ms(b, s, d, n, u.element_size()))
        inst.update(dtype="float32", u_dtype=_dname(u_dtype),
                    s=time.perf_counter() - t0)
        out.append(inst)
        del dt, a, bmat, cmat, u, dy, hs
        gc.collect()
        torch.cuda.empty_cache()
    caught = {c for inst in out for c in inst["controls"]}
    if caught != {"decay_term_dropped", "carry_dropped"}:
        raise AssertionError(f"scan backward controls run: {sorted(caught)}")
    return out, out[0]


def slstm_share(cfg, tc, traced_s: float, median_s: float) -> dict:
    """The sLSTM blocks' share of a bf16 train step: one block's forward
    without a gradient (remat's first pass) and its forward and backward
    (the recompute and the gradient), timed alone at the step's shape on
    seeded weights (the Trainer has just run that shape), times the
    model's sLSTM blocks, over the traced step's wall time and over the
    Trainer's median step.  The sLSTM is a plain per-token loop under
    autograd, as the reference's ``lax.scan`` is."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    dtype = getattr(torch, cfg.dtype)
    p = {k: v.requires_grad_() for k, v in
         X.init_slstm(gen, cfg, dtype).items()}
    x = torch.randn(tc.global_batch, tc.seq_len, cfg.d_model, generator=gen,
                    device=DEV).to(dtype).requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        X.slstm_block(p, x, cfg)
    y, _ = X.slstm_block(p, x, cfg)
    torch.autograd.grad(y.float().sum(), [x, *p.values()])
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    n = cfg.layer_kinds().count("slstm")
    out = {"blocks": n, "block_s": block_s, "blocks_s": n * block_s,
           "traced_step_s": traced_s, "median_step_s": median_s,
           "share_of_traced_step": n * block_s / traced_s,
           "share_of_median_step": n * block_s / median_s}
    log(f"  sLSTM blocks' share of a step: {json.dumps(out)}")
    return out


def xlstm_training() -> dict:
    """xLSTM-350M at full width and depth: the f32 gradient check, the bf16
    Trainer without a checkpoint, a traced step, the sLSTM's share."""
    out: dict = {}
    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    kinds = cfg.layer_kinds()
    log(f"== training {XLSTM_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers: {kinds.count('mlstm')} mLSTM, {kinds.count('slstm')} "
        f"sLSTM; d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.mamba_expand * cfg.d_model // cfg.n_heads}), "
        f"{cfg.param_count()} weights by param_count")
    gb, gs = XLSTM_GRAD_CHECK
    out["xlstm_grad_check"] = grad_check(
        f"{XLSTM_ARCH} f32 {gb} x {gs}", cfg.replace(dtype="float32"),
        lm_batch(cfg, gb, gs))
    gc.collect()
    torch.cuda.empty_cache()
    tc = SizedTrainConfig(seq_len=XLSTM_TRAIN_SEQ,
                          global_batch=XLSTM_TRAIN_BATCH, warmup_steps=1,
                          total_steps=XLSTM_TRAIN_STEPS,
                          ckpt_every=XLSTM_TRAIN_STEPS, seed=SEED)
    out["xlstm_trainer"] = trainer_runs(f"{XLSTM_ARCH} bf16 Trainer", cfg, tc,
                                        None, save=False)
    gc.collect()
    torch.cuda.empty_cache()
    # not warmed: the Trainer has just run this shape, and a step is ~19 s
    out["xlstm_traced_step"] = traced_train_step(cfg, tc, warm=False)
    gc.collect()
    torch.cuda.empty_cache()
    out["xlstm_slstm_share"] = slstm_share(
        cfg, tc, out["xlstm_traced_step"]["wall_s"],
        out["xlstm_trainer"]["median_step_s"])
    out["xlstm_wall_s"] = time.perf_counter() - t0
    log(f"  {XLSTM_ARCH} training phase wall {out['xlstm_wall_s']:.1f} s")
    return out


def jamba_training() -> dict:
    """Jamba at full width, JAMBA_TRAIN_LAYERS layers holding
    JAMBA_TRAIN_EXPERTS experts: the f32 gradient check (the MoE dispatch's
    gradient on the card included) before anything is timed, the bf16
    Trainer without a checkpoint, a traced step."""
    out: dict = {}
    t0 = time.perf_counter()
    cfg = get_config(JAMBA_ARCH).replace(
        n_layers=JAMBA_TRAIN_LAYERS, attn_every=JAMBA_TRAIN_LAYERS,
        attn_offset=JAMBA_TRAIN_LAYERS, experts_held=JAMBA_TRAIN_EXPERTS,
        expert_offset=0)
    log(f"== training {JAMBA_ARCH} at full width (d {cfg.d_model}, d_inner "
        f"{cfg.mamba_expand * cfg.d_model}, N {cfg.d_state}), layers "
        f"{cfg.layer_kinds()} of its supercell, {JAMBA_TRAIN_EXPERTS} of "
        f"its {cfg.n_experts} experts held (top-{cfg.top_k}), "
        f"{cfg.param_count()} weights by param_count")
    gb, gs = JAMBA_GRAD_CHECK
    out["jamba_grad_check"] = grad_check(
        f"{JAMBA_ARCH} f32 {gb} x {gs}", cfg.replace(dtype="float32"),
        lm_batch(cfg, gb, gs))
    gc.collect()
    torch.cuda.empty_cache()
    tc = SizedTrainConfig(seq_len=JAMBA_TRAIN_SEQ,
                          global_batch=JAMBA_TRAIN_BATCH, lr=JAMBA_TRAIN_LR,
                          warmup_steps=1,
                          total_steps=JAMBA_TRAIN_STEPS,
                          ckpt_every=JAMBA_TRAIN_STEPS, seed=SEED)
    out["jamba_trainer"] = trainer_runs(f"{JAMBA_ARCH} bf16 Trainer", cfg, tc,
                                        None, save=False)
    gc.collect()
    torch.cuda.empty_cache()
    out["jamba_traced_step"] = traced_train_step(cfg, tc)
    out["jamba_wall_s"] = time.perf_counter() - t0
    log(f"  {JAMBA_ARCH} training phase wall {out['jamba_wall_s']:.1f} s")
    return out


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

    # each top-level phase's wall time, read at the end
    walls: dict = {"build": time.perf_counter() - t_start}
    t_mark = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_mark[0]
        t_mark[0] = now

    # -- 2. each kernel against its plain version --------------------------
    sinkhorn, main_shape = sinkhorn_phases()
    mark("sinkhorn_checks")

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
    obl = oblivious_schedule(N, d_hat=D_HAT, recfg_frac=RECFG)
    # fct_bench.build_grid's order: each load's Vermilion row, then its
    # baselines on the oblivious schedule
    cases = []
    for s, wl, load in zip(scheds, wls, LOADS):
        cases.append(SweepCase(s, wl, "single_hop", f"vermilion@{load}",
                               {"load": load}))
        cases += [SweepCase(obl, wl, m, f"{m}@{load}", {"load": load})
                  for m in TWOHOP_MODES]
    single = [c for c in cases if c.mode == "single_hop"]
    twohop = [c for c in cases if c.mode != "single_hop"]
    timings: dict = {}
    t0 = time.perf_counter()
    rows = run_sweep(cases, BITS_PER_SLOT, device="cuda", sanitize=True,
                     timings=timings)
    phases["sweep_s"] = time.perf_counter() - t0
    launches = sinkhorn_ops.launches
    flows = sum(wl.num_flows for wl in wls)
    log(f"  {len(rows)} rows, flows {flows} a system, sinkhorn launches "
        f"{launches}")
    if launches != len(LOADS):
        raise AssertionError(f"main path launched the sinkhorn kernel "
                             f"{launches} times (expected {len(LOADS)})")
    # the reference's route at this size: twohop_dense, aggregate-only
    route = sim_mod._twohop_route(len(twohop), N, HORIZON)
    routes = [(bt["route"], bt["cases"]) for bt in timings["batches"]]
    if routes != [("singlehop", len(single)), (route, len(twohop))]:
        raise AssertionError(f"main path ran the batches {routes}")
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
    check_sweep_rows(rows, twohop_fcts=route == "twohop_fct")
    for key, val in {**phases, **timings}.items():
        if key != "batches":
            log(f"  phase {key}: {val:.6f}" if key != "slots"
                else f"  slots served {val}")
    log_batches(timings)
    per_slot_us = {bt["route"]: bt["device_loop_s"] / bt["slots"] * 1e6
                   for bt in timings["batches"]}

    # -- 3a. the two-hop batch through the sparse formulation --------------
    log(f"== the {len(twohop)} two-hop cases forced through twohop_sparse "
        f"on the card")
    sparse_t: dict = {}
    t0 = time.perf_counter()
    sparse = sim_mod._twohop_batch([(c.sched, c.wl) for c in twohop],
                                   BITS_PER_SLOT, [c.mode for c in twohop],
                                   torch.device(DEV), kernel="sparse",
                                   timings=sparse_t)
    phases["sparse_s"] = time.perf_counter() - t0
    per_slot_us["twohop_sparse"] = (sparse_t["device_loop_s"]
                                    / sparse_t["slots"] * 1e6)
    log(f"  sparse batch {phases['sparse_s']:.6f} s: layout "
        f"{sparse_t['layout_s']:.6f} s, device loop "
        f"{sparse_t['device_loop_s']:.6f} s "
        f"({per_slot_us['twohop_sparse']:.3f} us per slot)")
    dense = {r.label: r.result for r in rows if r.mode != "single_hop"}
    for c, r in zip(twohop, sparse):
        d = dense[c.label]
        rel = max(abs(getattr(r, f) - getattr(d, f)) / abs(getattr(d, f))
                  for f in ("delivered_bits", "utilization", "avg_hops"))
        log(f"  {c.label}: sparse vs dense aggregates rel diff {rel:.3e}")
        if rel > SPARSE_RTOL or np.isfinite(r.fct_slots).any():
            raise AssertionError(f"{c.label}: the sparse formulation "
                                 f"differs from the dense by {rel:.3e} "
                                 f"(rtol {SPARSE_RTOL})")

    # -- 4. the card's result against the port's CPU run -------------------
    log("== card vs CPU on the same schedules")
    t0 = time.perf_counter()
    cpu_t: dict = {}
    rows_cpu = run_sweep(cases, BITS_PER_SLOT, device="cpu", sanitize=True,
                         timings=cpu_t)
    log(f"  CPU sweep {time.perf_counter() - t0:.3f} s")
    log_batches(cpu_t)
    compare_sweep(rows, rows_cpu)
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

    # -- 5. traced reruns: where each data plane's time goes on the card ---
    traces = {"singlehop": traced_sweep("single-hop", single),
              route: traced_sweep(f"two-hop ({route})", twohop)}

    mark("sweep")

    # -- 5a. the n = 64 grid: per-flow two-hop FCTs, the aggregate plane ---
    n64 = sweep_n64_phases()
    gc.collect()
    mark("sweep_n64")

    # -- 5b. the adaptive loop: grids (a) and (b) on the card --------------
    adaptive = adaptive_phases()
    gc.collect()
    mark("adaptive")

    # -- 5c. the throughput analysis on the sweep's schedules ---------------
    throughput = throughput_phases(scheds, wls)
    gc.collect()
    mark("throughput")

    # -- 5d. fault injection, repair, fullest and jitter ---------------------
    t0 = time.perf_counter()
    faults = faults_phases(scheds[-1], wls[-1])
    faults["wall_s"] = time.perf_counter() - t0
    log(f"  faults phase wall {faults['wall_s']:.1f} s")
    gc.collect()
    mark("faults")

    # -- 5e. the evaluation drivers: Fig. 5/6, the adaptive suite, Fig. 10 --
    evaluation = evaluation_phases()
    gc.collect()
    mark("evaluation")

    # -- 5e2. the port's analysis, the quickstart and the serving example ---
    analysis = analysis_phases()
    gc.collect()
    mark("analysis_examples")

    # -- 5f. the attention, mLSTM, scan and MLA kernels; the serving paths ---
    flash, flash_main, decode, decode_main = attention_phases()
    flash += analysis.pop("flash")
    decode += analysis.pop("decode")
    mark("attention_checks")
    mlstm, mlstm_main = mlstm_phases()
    mamba, mamba_main = mamba_phases()
    mla_pre, mla_pre_main, mla_dec, mla_dec_main = mla_phases()
    mark("mlstm_scan_mla_checks")
    served = {}
    for arch in (ARCH, XLSTM_ARCH, JAMBA_ARCH, MIXTRAL_ARCH, MINICPM3_ARCH):
        served[arch] = serving_phases(arch)
        mark(f"serving {arch}")
    w_flash, w_decode = whisper_kernel_checks()
    flash += w_flash
    decode += w_decode
    whisper = whisper_phases()
    mark(f"serving {WHISPER_ARCH}")

    # -- 5g. training: the backward kernel, Qwen, Whisper, InternVL2 --------
    bwd, bwd_main = flash_bwd_phases()
    mark("flash_bwd_checks")
    mlstm_bwd, mlstm_bwd_main = mlstm_bwd_phases()
    mark("mlstm_bwd_checks")
    scan_bwd, scan_bwd_main = mamba_bwd_phases()
    mark("scan_bwd_checks")
    training = training_phases()
    mark("training")

    # -- 5h. the dry-run: reference cells, one-card estimates vs the card ---
    # (its subprocesses start here, when no host-timed phase is left)
    DRYRUNS.update(start_dryruns())
    dryrun = dryrun_phases(DRYRUNS, training["traced_step"], served[ARCH])
    mark("dryrun")
    # each kernel's launches on every serving path that runs it, each path
    # read between its own resets
    by_path: dict = {}
    for arch, res in {**served, WHISPER_ARCH: whisper}.items():
        for name, n in res["launches"].items():
            by_path.setdefault(name, {})[arch] = n
    for label, res in analysis["serve_decode"].items():
        for name, n in res["launches"].items():
            by_path[name][label] = n
    for arch, key in ((TRAIN_ARCH, "trainer"),
                      (WHISPER_ARCH, "whisper_trainer"),
                      (MINICPM3_ARCH, "minicpm3_trainer"),
                      (XLSTM_ARCH, "xlstm_trainer"),
                      (JAMBA_ARCH, "jamba_trainer")):
        for k, n in training[key]["calls"].items():
            if n:
                by_path.setdefault(TRAIN_KERNELS[k], {})[f"train {arch}"] = n

    # -- 6. results -----------------------------------------------------------
    log(f"total wall {time.perf_counter() - t_start:.1f} s; by phase (s) "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    log(f"sinkhorn instances: {json.dumps(sinkhorn)}")
    log(f"flash instances: {json.dumps(flash)}")
    log(f"decode instances: {json.dumps(decode)}")
    log(f"mlstm instances: {json.dumps(mlstm)}")
    log(f"mamba_scan instances: {json.dumps(mamba)}")
    log(f"mla_prefill instances: {json.dumps(mla_pre)}")
    log(f"mla_decode instances: {json.dumps(mla_dec)}")
    for arch, res in served.items():
        log(f"serving {arch}: {json.dumps(res)}")
    log(f"serving {WHISPER_ARCH}: {json.dumps(whisper)}")
    log(f"flash_bwd instances: {json.dumps(bwd)}")
    log(f"mlstm_bwd instances: {json.dumps(mlstm_bwd)}")
    log(f"mamba_scan_bwd instances: {json.dumps(scan_bwd)}")
    log(f"training: {json.dumps(training)}")
    log(f"dryrun_gates: {json.dumps(dryrun['gates'])}")
    log("adaptive: " + json.dumps(adaptive))
    log("sweep: " + json.dumps({"us_per_slot": per_slot_us, "traces": traces,
                                "phases": phases}))
    log("sweep_n64: " + json.dumps(n64))
    log("throughput: " + json.dumps(throughput))
    log("faults: " + json.dumps(faults))
    log("evaluation: " + json.dumps(evaluation))
    log("analysis_examples: " + json.dumps(analysis))
    sinkhorn_by_path = {"sweep": launches, "sweep_n64": n64["launches"],
                        "adaptive_a": adaptive["a"]["launches"],
                        "adaptive_b": adaptive["b"]["launches"],
                        **throughput["launches"],
                        "faults": faults["launches"],
                        "evaluation": evaluation["launches"],
                        "quickstart": analysis["launches"]}
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
    # sinkhorn's `launches` counts wrapper calls on the sweep's schedules,
    # the two adaptive grids, the throughput analysis's four card paths,
    # the faults phase, the evaluation drivers and the quickstart, each
    # read between its own resets
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
    for key in ("traced_step", "xlstm_traced_step", "jamba_traced_step"):
        for name, n in training[key]["cuda_launches_per_call"].items():
            per_call.setdefault(name, n)
    # the MLA kernels replace no Pallas kernel: the reference computes that
    # attention in jnp (its layers.py, mla_attention's kv_cache branch)
    for name, inst, replaces in (
            ("flash_attention", flash_main,
             "src/repro/kernels/flash_attention/flash_attention.py:59"),
            ("decode_attention", decode_main,
             "src/repro/kernels/decode_attention/decode_attention.py:58"),
            ("mlstm", mlstm_main, "src/repro/kernels/mlstm/mlstm.py:73"),
            ("mamba_scan", mamba_main,
             "src/repro/kernels/mamba_scan/mamba_scan.py:54"),
            ("mla_prefill", mla_pre_main, "src/repro/models/layers.py:228"),
            ("mla_decode", mla_dec_main, "src/repro/models/layers.py:228"),
            # the gradients JAX takes of the reference's jnp attention,
            # mLSTM and scan
            ("flash_attention_bwd", bwd_main,
             "src/repro/models/layers.py:56"),
            ("mlstm_bwd", mlstm_bwd_main, "src/repro/models/xlstm.py:62"),
            ("mamba_scan_bwd", scan_bwd_main,
             "src/repro/models/mamba.py:47")):
        source = "mla_attention" if name.startswith("mla_") else name
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
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
    try:
        rc = main()
    finally:
        stop_dryruns(DRYRUNS)
    sys.exit(rc)
