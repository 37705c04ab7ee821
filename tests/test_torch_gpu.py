"""repro_torch kernels on the card (marker ``gpu``): each CUDA kernel
against its plain PyTorch version.  Needs no jax, so it runs on a machine
with a card and PyTorch alone (``pytest -m gpu``); without a card every
marked test skips (the one unmarked test checks that the entry points
refuse to run without a card).  Whether a card is present is decided
inside each test.

Tolerances: Sinkhorn f32 rtol 1e-5 / atol 1e-6, as tests/test_kernels.py
holds the Pallas kernel (reduction order only), f64 rtol 1e-12 over 200
iterations, and its cluster path bit for bit against
``sinkhorn_kernel_order``, the CPU model of its order; attention f32 2e-5
and bf16 2e-2, as tests/test_kernels.py holds the Pallas attention
kernels (the MLA latent attention kernels likewise, against their plain
versions, and the bf16 ones within a bf16 rounding of the output, 2^-7
relative and 2^-9 absolute, of the plain models of their order); mLSTM f32 rtol 1e-4 / atol 1e-4 on the
outputs and the final states (the kernel's chunks are 64 positions, the
plain version's 256, so its sums and exponent arguments are grouped
differently); the selective scan rtol 1e-4 / atol 1e-4 on ``y`` and the
final state, as tests/test_kernels.py holds the Pallas kernel; the served
models' logits, kernels against plain versions, within 2e-2 of the
largest logit (bf16), 1e-3 for the narrow Jamba in f32 (its router is
discontinuous: bf16 roundings would flip expert choices).  The adaptive
loop on the card against its CPU run: the same compiled control
trajectory and counters exactly, FCTs differing on at most 0.1 % of flows
by at most 1 slot (CUDA ``index_add_``'s order of same-slot arrivals),
utilization rtol 1e-5; the fleet estimation ops' ticks equal to the CPU's.
The two-hop routes on the card against the CPU: aggregates (delivered
bits, utilization, avg_hops) rtol 1e-4, FCTs within the sweep's bar
(``twohop_fct``'s per-slot outputs bit for bit, its FCTs equal);
``simulate_aggregate`` per slot rtol 1e-5, final VOQ within 1e-3 bits.
The throughput analysis on the card against the CPU: a saturate
certificate's bounds, checks and violations exactly, theta rtol 1e-9; the
BvN decomposition's perms exactly, lambdas within 1e-9; the interconnect
drain within the sweep's bar.  Fault injection on the card against the
CPU: the faulted sweep's FCTs within the sweep's bar, delivered and lost
bits rtol 1e-5 (f32), refused bits equal; the degraded-service engine
(f64): trajectory digests, counters and excisions equal, bits rtol 1e-9.
The evaluation drivers (``repro_torch.benchmarks``) on the card against
their CPU runs at the same bars.  The flash-attention backward kernel
against its plain version (``attention_bwd_ref``), at q/k and v widths of
(64, 64), (128, 128) and MLA's (96, 64): f32 within 1e-4 of each
output's largest magnitude, bf16 within 1.25e-2 (1.6 bf16 ulps; the card's
readings reach 6.9e-3 in ``chip_smoke.py``), and within a quarter of
that of the plain model of its arithmetic (``attention_bwd_tiles``)
beyond one bf16 rounding of each element; the forward's log-sum-exp within 1e-5 of a
plain logsumexp, -inf on the same rows.  The mLSTM and selective-scan
backward kernels against their plain versions (``mlstm_chunkwise_bwd_ref``,
``selective_scan_bwd_ref``): each f32 gradient within 1e-4 of its largest
magnitude, a bf16 du beyond one bf16 rounding of each element likewise;
a narrow xLSTM's and Jamba's f32 loss and gradients through the kernels
against the plain path within 1e-4 of the largest gradient leaf (loss rtol
1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import estimation, faults, schedule, simulator
from repro_torch.core.traffic import saturate
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_bwd_tiles,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                selective_scan_ref)
from repro_torch.kernels.mamba_scan_bwd import ops as scan_bwd_ops
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm_bwd import ops as mlstm_bwd_ops
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.mla_attention.ref import (mla_decode_ref,
                                                   mla_decode_splits,
                                                   mla_prefill_ref,
                                                   mla_prefill_tiles)
from repro_torch.kernels.mlstm.ref import (mlstm_chunkwise_bwd_ref,
                                           mlstm_chunkwise_ref)
from repro_torch.kernels.sinkhorn import ops
from repro_torch.kernels.sinkhorn.ref import (sinkhorn_kernel_order,
                                              sinkhorn_ref)
from repro_torch.models import (decode_step, forward, init_params, loss_fn,
                                prefill, serve_params)
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import flatten_with_keys, leaves, tree_map

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MLSTM_TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype,iters,rtol,atol", [
    (64, "float32", 20, 1e-5, 1e-6),
    (250, "float32", 20, 1e-5, 1e-6),
    (512, "float32", 20, 1e-5, 1e-6),
    (1024, "float32", 20, 1e-5, 1e-6),      # two passes a round
    (1, "float32", 20, 1e-5, 1e-6),
    (256, "float64", 200, 1e-12, 0.0),
    (17, "float64", 200, 1e-12, 0.0),
    (250, "float64", 200, 1e-12, 0.0),
])
def test_sinkhorn_kernel_matches_plain(n, dtype, iters, rtol, atol):
    _card()
    dt = getattr(torch, dtype)
    m = torch.from_numpy(np.random.default_rng(n).random((n, n)) + 0.01).to(
        "cuda", dt)
    before = ops.launches
    got = ops.sinkhorn(m, iters=iters, device="cuda")
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.dtype == dt and got.device.type == "cuda"
    torch.testing.assert_close(got, sinkhorn_ref(m, iters=iters),
                               rtol=rtol, atol=atol)
    # fixed-order reductions: the same input gives the same bits
    assert torch.equal(got, ops.sinkhorn(m, iters=iters, device="cuda"))


SINKHORN_ITERS = {"float32": (20, 1e-12), "float64": (200, 0.0)}


def _sinkhorn_input(n, dtype):
    return torch.from_numpy(np.random.default_rng(n).random((n, n)) + 0.01).to(
        "cuda", getattr(torch, dtype))


def _same_bits(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype", [
    (1, "float64"), (6, "float64"), (8, "float64"), (10, "float64"),
    (12, "float64"), (17, "float64"), (250, "float64"), (256, "float64"),
    ("top", "float64"), (17, "float32"), (256, "float32"), (512, "float32"),
    ("top", "float32"),
])
def test_sinkhorn_kernel_equals_its_order_model(n, dtype):
    """The cluster path, bit for bit against the CPU model of its order."""
    _card()
    dt = getattr(torch, dtype)
    n = ops.max_cluster_n(dt) if n == "top" else n
    assert ops.variant(n, dt) == "cluster"
    iters, eps = SINKHORN_ITERS[dtype]
    m = _sinkhorn_input(n, dtype)
    got = ops.sinkhorn_kernel(m, iters, eps).cpu()
    assert torch.equal(got, sinkhorn_kernel_order(m.cpu(), iters, eps,
                                                  ops.cluster_size()))


@pytest.mark.gpu
def test_sinkhorn_kernel_cluster_size_and_reach():
    _card()
    c = ops.cluster_size()
    assert c in (8, 16)
    top = {d: ops.max_cluster_n(d) for d in (torch.float32, torch.float64)}
    assert top == ({torch.float32: 736, torch.float64: 512} if c == 16 else
                   {torch.float32: 384, torch.float64: 384})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sinkhorn_kernel_two_passes_past_the_cluster(dtype):
    _card()
    dt = getattr(torch, dtype)
    top = ops.max_cluster_n(dt)
    assert ops.plan(top, dt)[0] == "cluster"
    assert ops.plan(top + 1, dt) == ("two_pass", ops.cluster_size(), 0)
    iters, eps = SINKHORN_ITERS[dtype]
    rtol, atol = (1e-5, 1e-6) if dtype == "float32" else (1e-12, 0.0)
    m = _sinkhorn_input(top + 1, dtype)
    got = ops.sinkhorn_kernel(m, iters, eps)
    torch.testing.assert_close(got, sinkhorn_ref(m, iters, eps), rtol=rtol,
                               atol=atol)
    assert torch.equal(got, ops.sinkhorn_kernel(m, iters, eps))


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["cluster", "two_pass"])
@pytest.mark.parametrize("case", ["iters0", "iters1", "nan"])
def test_sinkhorn_kernel_edges(path, case):
    _card()
    n = 250 if path == "cluster" else ops.max_cluster_n(torch.float64) + 1
    m = _sinkhorn_input(n, "float64")
    iters, eps = {"iters0": (0, 0.5), "iters1": (1, 0.0),
                  "nan": (5, 0.0)}[case]
    if case == "nan":
        m[7, 9] = float("nan")
    assert ops.variant(n, torch.float64) == path
    got = ops.sinkhorn_kernel(m, iters, eps)
    want = sinkhorn_ref(m, iters, eps)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0,
                               equal_nan=True)
    if case != "iters1":
        assert _same_bits(got, want)


@pytest.mark.gpu
def test_sinkhorn_kernel_is_one_launch():
    """The main path's instance is one CUDA launch a call."""
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m = _sinkhorn_input(256, "float64")
    ops.sinkhorn_kernel(m, 200, 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.sinkhorn_kernel(m, 200, 0.0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not names:
        pytest.skip("the profiler recorded no device events")
    assert len(names) == 1 and "sinkhorn_cluster" in names[0]


@pytest.mark.gpu
def test_sinkhorn_kernel_casts_half_and_clamps():
    _card()
    m = torch.rand(128, 128, device="cuda").to(torch.bfloat16)
    got = ops.sinkhorn(m, device="cuda")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, sinkhorn_ref(m), rtol=1e-5, atol=1e-6)
    z = torch.zeros(8, 8, device="cuda")
    assert torch.equal(ops.sinkhorn(z, iters=0, eps=0.25, device="cuda"),
                       torch.full_like(z, 0.25))


@pytest.mark.gpu
def test_sinkhorn_kernel_rejects_bad_input():
    _card()
    with pytest.raises(ValueError, match="square"):
        ops.sinkhorn_kernel(torch.ones(4, 5, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sinkhorn_kernel(torch.ones(8, 8, device="cuda").t()[:4, :4])
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.sinkhorn_kernel(torch.ones(4, 4, device="cuda",
                                       dtype=torch.float16))


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", [
    (1, 300, 300, 16, 16, 64, True, 0),       # the served model's prefill
    (2, 1000, 1000, 4, 2, 64, True, 0),       # ragged
    (1, 512, 512, 24, 8, 128, True, 0),       # Llama-3.2-3B's GQA
    (1, 256, 256, 8, 1, 64, True, 0),         # MQA
    (1, 384, 384, 4, 2, 64, True, 100),       # sliding window
    (1, 128, 512, 8, 8, 128, True, 0),        # Sq < Sk, end-aligned
    (2, 130, 130, 4, 4, 128, False, 0),       # non-causal
    (1, 256, 128, 2, 2, 64, True, 0),         # rows with no visible key
    # the bf16 kernel's tile edges: 64-row query tiles, 128-key tiles at dh 64
    (1, 63, 63, 8, 8, 64, True, 0),
    (1, 64, 64, 8, 8, 64, True, 0),
    (1, 65, 65, 8, 8, 64, True, 0),
    (1, 127, 127, 8, 8, 64, True, 0),
    (1, 128, 128, 8, 8, 64, True, 0),
    (1, 129, 129, 8, 8, 64, True, 0),
    (1, 255, 255, 8, 8, 64, True, 0),
    # 64-key tiles at dh 128, a full grid (B 2 x 64 heads)
    (2, 65, 65, 64, 8, 128, True, 0),
    (2, 129, 129, 64, 8, 128, True, 0),
    (2, 255, 255, 64, 8, 128, True, 0),
    (1, 100, 612, 8, 8, 128, True, 0),        # ragged Sq < Sk
    (1, 77, 301, 6, 3, 64, True, 0),
    (1, 1000, 1000, 16, 16, 64, True, 256),   # window edges inside tiles
    (1, 1000, 1000, 64, 8, 128, True, 256),
    (1, 300, 300, 24, 8, 128, True, 0),       # rep 3
    (1, 300, 300, 64, 8, 64, True, 0),        # rep 8
    (1, 300, 300, 32, 1, 128, True, 0),       # rep 32
    (1, 5000, 5000, 32, 8, 128, True, 4096),  # Mixtral's windowed prefill
    # Whisper-tiny (H 6, dh 64, 1500 encoder rows): the encoder's
    # non-causal self-attention, the cross-attention prefill (Sq != Sk),
    # one query, and key counts around the last 64-key tile's tail (1472
    # fills 23 tiles, 1473 one key past, 1500 leaves 28 keys in the last)
    (8, 1500, 1500, 6, 6, 64, False, 0),
    (8, 4, 1500, 6, 6, 64, False, 0),
    (2, 1, 1500, 6, 6, 64, False, 0),
    (1, 130, 1500, 6, 6, 64, False, 0),
    (1, 130, 1472, 6, 6, 64, False, 0),
    (1, 130, 1473, 6, 6, 64, False, 0),
])
def test_flash_kernel_matches_plain(dtype, b, sq, sk, h, kv, dh, causal,
                                    window):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
    q = _randn(gen, b, sq, h, dh, dtype=dt)
    k = _randn(gen, b, sk, kv, dh, dtype=dt)
    v = _randn(gen, b, sk, kv, dh, dtype=dt)
    before = flash_ops.launches
    got = flash_ops.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # no atomics: the same input gives the same bits
    assert torch.equal(got, flash_ops.attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,dh", [
    (2048, 16, 16, 64),         # the served model's decode
    (1024, 24, 8, 128),         # Llama-3.2-3B's GQA
    (1024, 8, 1, 64),           # MQA
    (1024, 4, 2, 64),           # rep 2
    (2048, 64, 8, 128),         # Jamba's (rep 8)
    (1024, 32, 1, 128),         # rep 32
])
def test_decode_kernel_matches_plain(dtype, s, h, kv, dh):
    _card()
    dt = getattr(torch, dtype)
    # every length class of the device split: none, one key, a share
    # boundary (visible keys a multiple of the splits times 64 rows, a
    # multiple of either type's tile, then one more), S - 1, S, past S
    sms = decode_ops.sm_count(torch.device("cuda"))
    unit = decode_ops.split_plan(11, kv, s, sms) * 64   # bf16's tile
    edge = unit * max(1, s // (2 * unit))
    lens = [0, 1, 255, 256, 257, s // 2 + 3, s - 1, s, s + 40, edge - 1,
            edge]
    b = len(lens)
    gen = torch.Generator(device="cuda").manual_seed(s + h)
    q = _randn(gen, b, 1, h, dh, dtype=dt)
    k = _randn(gen, b, s, kv, dh, dtype=dt)
    v = _randn(gen, b, s, kv, dh, dtype=dt)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = decode_ops.launches
    got = decode_ops.decode_attn(q, k, v, length)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    want = decode_attention_ref(q, k, v, length)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # fixed-order combine: the same input gives the same bits
    assert torch.equal(got, decode_ops.decode_attn(q, k, v, length))
    # a scalar length broadcasts
    torch.testing.assert_close(
        decode_ops.decode_attn(q, k, v, 300).float(),
        decode_attention_ref(q, k, v, 300).float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_cross_attention_shape(dtype):
    """Whisper-tiny's cross decode: 8 lanes, each one query over all 1500
    rows of its own encoder output (length 1499 everywhere), H 6, K/V a
    fresh contiguous projection and not a cache."""
    _card()
    dt = getattr(torch, dtype)
    b, s, h, dh, d = 8, 1500, 6, 64, 384
    gen = torch.Generator(device="cuda").manual_seed(1500)
    q = _randn(gen, b, 1, h, dh, dtype=dt)
    enc = _randn(gen, b, s, d, dtype=dt)
    wk = _randn(gen, d, h * dh, dtype=dt) * 0.05
    wv = _randn(gen, d, h * dh, dtype=dt) * 0.05
    k = (enc @ wk).reshape(b, s, h, dh)
    v = (enc @ wv).reshape(b, s, h, dh)
    before = decode_ops.launches
    got = decode_ops.decode_attn(q, k, v, s - 1)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    want = decode_attention_ref(q, k, v, s - 1)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, decode_ops.decode_attn(q, k, v, s - 1))
    # the same as the flash kernel's one-query answer over every key
    torch.testing.assert_close(
        got.float(), flash_ops.attention(q, k, v, causal=False).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,dh", [
    (8, 8, 64), (16, 4, 64), (64, 8, 64),         # rep 1, 4, 8 at dh 64
    (8, 8, 128), (32, 8, 128), (64, 8, 128),      # ... at dh 128 (Mixtral's)
])
@pytest.mark.parametrize("window,s", [
    (1, 1024), (63, 1024), (64, 1024), (65, 1024),
    (4096, 8192),                                 # Mixtral's window and cache
    (1030, 1024),                                 # a window wider than S
])
def test_decode_kernel_window_matches_plain(dtype, h, kv, dh, window, s):
    """The windowed decode kernel against its plain version, lanes seeing
    [lo, hi) with lo = length - window + 1: none, one key, the window's
    edges, lo on and off the 64-row tile edge and on a split edge of the
    unwindowed plan, a share boundary of the windowed plan, S - 1 to past
    S, and idle lanes whose window reaches one key into the cache or lies
    past it (0).  Two calls give the same bits; the unwindowed kernel
    misses the windowed plain version, beyond the tolerance, on every lane
    whose window hides at least as many keys as it shows."""
    _card()
    dt, w = getattr(torch, dtype), window
    sms = decode_ops.sm_count(torch.device("cuda"))
    unit = decode_ops.split_plan(17, kv, s, sms) * 64
    wunit = decode_ops.split_plan(17, kv, s, sms, w) * 64
    lens = [-1, 0, 1, w - 2, w - 1, w, w + 1, 192 + w - 1, 192 + w + 16,
            unit + w - 1, wunit - 1, wunit, s // 2 + 3, s - 1, s, s + 40,
            s + w - 2, s + w + 5]
    b = len(lens)
    gen = torch.Generator(device="cuda").manual_seed(s + h + w)
    q = _randn(gen, b, 1, h, dh, dtype=dt)
    k = _randn(gen, b, s, kv, dh, dtype=dt)
    v = _randn(gen, b, s, kv, dh, dtype=dt)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = decode_ops.launches
    got = decode_ops.decode_attn(q, k, v, length, w)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    want = decode_attention_ref(q, k, v, length, w)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, decode_ops.decode_attn(q, k, v, length, w))
    hi = [min(x, s - 1) + 1 if x >= 0 else 0 for x in lens]
    lo = [min(max(0, x - w + 1), e) if x >= 0 else 0
          for x, e in zip(lens, hi)]
    assert not got[[i for i in range(b) if lo[i] == hi[i]]].any()
    cut = [i for i in range(b) if hi[i] - lo[i] <= lo[i] < hi[i]]
    assert cut
    nowin = decode_ops.decode_attn(q, k, v, length).float()
    assert not any(torch.allclose(nowin[i], want[i].float(), rtol=tol,
                                  atol=tol) for i in cut)


@pytest.mark.gpu
def test_attention_kernels_reject_bad_input():
    _card()
    x = torch.zeros(1, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_ops.attention_kernel(x, x, x)
    with pytest.raises(ValueError, match="head dims"):
        decode_ops.decode_kernel(x[:, :1], x, x, 3)
    h16 = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_ops.attention_kernel(h16, h16, h16)
    q = torch.zeros(1, 1, 64, 64, device="cuda")
    kv1 = torch.zeros(1, 8, 1, 64, device="cuda")
    with pytest.raises(ValueError, match="query heads per kv head"):
        decode_ops.decode_kernel(q, kv1, kv1, 3)
    kv64 = torch.zeros(1, 8, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="window"):
        decode_ops.decode_kernel(q, kv64, kv64, 3, window=-1)
    strided = torch.zeros(1, 8, 64, 2, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="packed"):
        flash_ops.attention_kernel(strided, strided, strided)


@pytest.mark.gpu
def test_served_model_kernels_match_plain():
    """A narrow Qwen-shaped model (head dim 64) on the card: prefill and
    decode steps through the kernels against the same calls through the
    plain versions, fed the same tokens; then the engine, whose run must
    launch both kernels."""
    _card()
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=0, d_ff=512)
    assert cfg.head_dim == 64
    p = serve_params(init_params(torch.Generator(device="cuda").manual_seed(0),
                                 cfg), cfg)
    prompt = torch.arange(1, 41, device="cuda")[None] % cfg.vocab
    lk, ck, ln = prefill(p, cfg, prompt, 128)
    lp, cp, _ = prefill(p, cfg, prompt, 128, plain=True)
    for step in range(6):
        scale = max(1.0, float(lp.float().abs().max()))
        assert float((lk.float() - lp.float()).abs().max()) <= 2e-2 * scale
        tok = torch.argmax(lk, dim=-1)[:, None]
        lk, ck = decode_step(p, cfg, tok, ck, ln + step)
        lp, cp = decode_step(p, cfg, tok, cp, ln + step, plain=True)
    f0, d0 = flash_ops.launches, decode_ops.launches
    reqs = [Request(rid=i, prompt=np.arange(1, 5 + 7 * i), max_new_tokens=5)
            for i in range(3)]
    done = ServeEngine(p, cfg, n_lanes=2, max_len=64).run(reqs)
    assert len(done) == 3 and all(len(r.out_tokens) == 5 for r in reqs)
    assert flash_ops.launches - f0 == 3 * cfg.n_layers
    assert decode_ops.launches > d0


def _mlstm_inputs(gen, b, s, h, dh, state):
    """q, k, v, logi, logf at the scale of xLSTM-350M's projections, and a
    state: None, the serving path's fresh one, or a nonzero one."""
    q, k, v = (_randn(gen, b, s, h, dh, dtype=torch.float32) * 0.58
               for _ in range(3))
    li = _randn(gen, b, s, h, dtype=torch.float32) * 0.58
    lf = torch.nn.functional.logsigmoid(
        _randn(gen, b, s, h, dtype=torch.float32) * 0.58)
    if state == "fresh":
        st = (torch.zeros(b, h, dh, dh, device="cuda"),
              torch.zeros(b, h, dh, device="cuda"),
              torch.full((b, h), -1e9, device="cuda"))
    elif state == "carried":
        st = (_randn(gen, b, h, dh, dh, dtype=torch.float32) * 0.1,
              _randn(gen, b, h, dh, dtype=torch.float32) * 0.1,
              _randn(gen, b, h, dtype=torch.float32))
    else:
        st = None
    return (q, k, v, li, lf), st


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,dh,state", [
    (1, 552, 4, 512, "fresh"),      # the served model's prefill, padded
    (1, 159, 4, 512, "fresh"),      # S <= 256
    (1, 300, 4, 512, "carried"),    # a nonzero state carried in
    (1, 512, 4, 512, "fresh"),      # S a multiple of 256
    (2, 256, 4, 64, "carried"),
    (2, 1000, 8, 32, "fresh"),      # ragged
    (2, 300, 2, 128, "none"),
    (1, 2, 4, 64, "carried"),       # the shortest sequence it takes
    (1, 980, 4, 512, "fresh"),      # the longest served prefill
    (1, 64, 4, 512, "carried"),     # one 64-position chunk of the kernel
    (1, 65, 4, 512, "fresh"),       # and one past it
    (1, 1025, 4, 512, "carried"),   # 17 chunks: two windows of 16 slots
    (1, 2100, 2, 128, "none"),      # three windows
    (1, 4097, 2, 64, "carried"),    # 65 chunks: past the gates' window of 64
    (1, 200_000, 1, 32, "fresh"),   # 3125 chunks
])
def test_mlstm_kernel_matches_plain(b, s, h, dh, state):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(s * 3 + dh)
    ins, st = _mlstm_inputs(gen, b, s, h, dh, state)
    before = mlstm_ops.launches
    out, fin = mlstm_ops.mlstm(*ins, st)
    torch.cuda.synchronize()
    assert mlstm_ops.launches == before + 1
    assert out.shape == (b, s, h, dh) and out.dtype == torch.float32
    want, wfin = mlstm_chunkwise_ref(*ins, st)
    torch.testing.assert_close(out, want, rtol=MLSTM_TOL, atol=MLSTM_TOL)
    for a, w in zip(fin, wfin):
        torch.testing.assert_close(a, w, rtol=MLSTM_TOL, atol=MLSTM_TOL)
    # fixed-order sums: the same input gives the same bits
    again, again_fin = mlstm_ops.mlstm(*ins, st)
    assert torch.equal(out, again)
    assert all(torch.equal(a, w) for a, w in zip(fin, again_fin))


@pytest.mark.gpu
def test_mlstm_kernel_rejects_bad_input():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    (q, k, v, li, lf), st = _mlstm_inputs(gen, 1, 8, 2, 64, "fresh")
    with pytest.raises(ValueError, match="S >= 2"):
        mlstm_ops.mlstm_kernel(q[:, :1], k[:, :1], v[:, :1], li[:, :1],
                               lf[:, :1], st)
    with pytest.raises(ValueError, match="head dims"):
        mlstm_ops.mlstm_kernel(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous(), li, lf)
    with pytest.raises(TypeError, match="float32"):
        mlstm_ops.mlstm_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16(), li,
                               lf)
    with pytest.raises(ValueError, match="contiguous"):
        mlstm_ops.mlstm_kernel(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, li, lf)
    with pytest.raises(ValueError, match="state C"):
        mlstm_ops.mlstm_kernel(q, k, v, li, lf, (st[0][..., :32], *st[1:]))
    with pytest.raises(ValueError, match="logi, logf"):
        mlstm_ops.mlstm_kernel(q, k, v, li[:, :4], lf)


@pytest.mark.gpu
def test_mlstm_kernel_copies_misaligned_input():
    """A q, k or v that does not start on a 16-byte boundary (the kernel's
    copies are 16 bytes) is copied first: the same bits as aligned ones."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    (q, k, v, li, lf), st = _mlstm_inputs(gen, 1, 130, 2, 64, "carried")
    want, wfin = mlstm_ops.mlstm_kernel(q, k, v, li, lf, st)
    shifted = [torch.empty(t.numel() + 1, device="cuda")[1:].view_as(t)
               for t in (q, k, v)]
    for s, t in zip(shifted, (q, k, v)):
        s.copy_(t)
    out, fin = mlstm_ops.mlstm_kernel(*shifted, li, lf, st)
    assert torch.equal(out, want)
    assert all(torch.equal(a, w) for a, w in zip(fin, wfin))


@pytest.mark.gpu
def test_served_xlstm_kernel_matches_plain():
    """A narrow xLSTM (head dim 128) on the card: prefill and decode steps
    with the kernel against the plain version, fed the same tokens; then
    the engine, whose prefills must each launch the kernel once per mLSTM
    layer."""
    _card()
    cfg = get_config("xlstm-350m", smoke=True).replace(d_model=256)
    n_mlstm = sum(k == "mlstm" for k in cfg.layer_kinds())
    p = serve_params(init_params(torch.Generator(device="cuda").manual_seed(0),
                                 cfg), cfg)
    prompt = torch.arange(1, 301, device="cuda")[None] % cfg.vocab
    before = mlstm_ops.launches
    lk, ck, ln = prefill(p, cfg, prompt, 512)
    assert mlstm_ops.launches - before == n_mlstm
    lp, cp, _ = prefill(p, cfg, prompt, 512, plain=True)
    for step in range(4):
        scale = max(1.0, float(lp.float().abs().max()))
        assert float((lk.float() - lp.float()).abs().max()) <= 2e-2 * scale
        tok = torch.argmax(lk, dim=-1)[:, None]
        lk, ck = decode_step(p, cfg, tok, ck, ln + step)
        lp, cp = decode_step(p, cfg, tok, cp, ln + step, plain=True)
    before = mlstm_ops.launches
    reqs = [Request(rid=i, prompt=np.arange(1, 5 + 7 * i), max_new_tokens=5)
            for i in range(3)]
    done = ServeEngine(p, cfg, n_lanes=2, max_len=64).run(reqs)
    assert len(done) == 3 and all(len(r.out_tokens) == 5 for r in reqs)
    assert mlstm_ops.launches - before == 3 * n_mlstm


def _scan_inputs(gen, b, s, d, n, u_dtype, state):
    """dt, a, B, C, u at the scale of Jamba's Mamba layers on random
    weights (dt = softplus(~0.5), a = -(1..N)), and a state: None or a
    nonzero one."""
    dt = torch.nn.functional.softplus(
        0.5 + 0.1 * _randn(gen, b, s, dtype=torch.float32))
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(d, n).contiguous()
    bmat, cmat = (_randn(gen, b, s, n, dtype=torch.float32)
                  for _ in range(2))
    u = _randn(gen, b, s, d, dtype=torch.float32).to(u_dtype)
    h0 = (_randn(gen, b, d, n, dtype=torch.float32)
          if state == "carried" else None)
    return dt, a, bmat, cmat, u, h0


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n,u_dtype,state", [
    (1, 980, 16384, 16, "bfloat16", "none"),   # the served prefill
    (1, 159, 16384, 16, "bfloat16", "carried"),
    (1, 1, 16384, 16, "float32", "carried"),
    (2, 333, 96, 16, "float32", "carried"),    # ragged tiles, narrow D
    (2, 64, 256, 8, "float32", "none"),
    (1, 980, 16384, 16, "float32", "carried"),  # the f32 path's prefill
    (1, 16, 16384, 16, "bfloat16", "carried"),  # a lane's 16 positions
    (1, 17, 16384, 16, "bfloat16", "carried"),
    (1, 64, 16384, 16, "bfloat16", "carried"),  # a tile of 64
    (1, 65, 16384, 16, "bfloat16", "none"),
    (2, 130, 101, 16, "bfloat16", "carried"),   # odd D: u widened to f32
])
def test_mamba_kernel_matches_plain(b, s, d, n, u_dtype, state):
    """y and the final state against the plain version, at the reference
    test's tolerance (tests/test_kernels.py: rtol 1e-4, atol 1e-4)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(s + d + n)
    dt, a, bmat, cmat, u, h0 = _scan_inputs(gen, b, s, d, n,
                                            getattr(torch, u_dtype), state)
    before = mamba_ops.launches
    y, h = mamba_ops.selective_scan(dt, a, bmat, cmat, u, h0)
    torch.cuda.synchronize()
    assert mamba_ops.launches == before + 1
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    want_y, want_h = selective_scan_ref(dt, a, bmat, cmat, u, h0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    again, again_h = mamba_ops.selective_scan(dt, a, bmat, cmat, u, h0)
    assert torch.equal(y, again) and torch.equal(h, again_h)


@pytest.mark.gpu
def test_mamba_kernel_rejects_bad_input():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, a, bmat, cmat, u, h0 = _scan_inputs(gen, 1, 8, 64, 16,
                                            torch.float32, "carried")
    with pytest.raises(ValueError, match="d_state"):
        mamba_ops.selective_scan_kernel(dt, a[:, :4].contiguous(),
                                        bmat[..., :4], cmat[..., :4], u)
    with pytest.raises(TypeError, match="u must be"):
        mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u.half())
    with pytest.raises(ValueError, match="u must have shape"):
        mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u[..., :32])
    with pytest.raises(ValueError, match="contiguous"):
        mamba_ops.selective_scan_kernel(
            dt, a, bmat, cmat, u.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.gpu
def test_served_jamba_kernels_match_plain():
    """A narrow Jamba (head dim 128, d_inner 512, half of its 4 experts
    held) on the card: prefill and decode steps through the kernels
    against the plain versions in f32, fed the same tokens; then the
    engine, whose prefills must each launch the scan once per Mamba layer
    and the flash kernel once per attention layer."""
    _card()
    cfg = get_config("jamba-1.5-large", smoke=True).replace(
        d_model=256, n_heads=2, n_kv_heads=1, head_dim=0, dtype="float32",
        experts_held=2, expert_offset=2)
    assert cfg.head_dim == 128
    kinds = cfg.layer_kinds()
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                    serve=True)
    prompt = torch.arange(1, 301, device="cuda")[None] % cfg.vocab
    before = mamba_ops.launches
    lk, ck, ln = prefill(p, cfg, prompt, 512)
    assert mamba_ops.launches - before == kinds.count("mamba")
    lp, cp, _ = prefill(p, cfg, prompt, 512, plain=True)
    for step in range(4):
        scale = max(1.0, float(lp.abs().max()))
        assert float((lk - lp).abs().max()) <= 1e-3 * scale
        tok = torch.argmax(lk, dim=-1)[:, None]
        lk, ck = decode_step(p, cfg, tok, ck, ln + step)
        lp, cp = decode_step(p, cfg, tok, cp, ln + step, plain=True)
    m0, f0 = mamba_ops.launches, flash_ops.launches
    reqs = [Request(rid=i, prompt=np.arange(1, 5 + 7 * i), max_new_tokens=5)
            for i in range(3)]
    done = ServeEngine(p, cfg, n_lanes=2, max_len=64).run(reqs)
    assert len(done) == 3 and all(len(r.out_tokens) == 5 for r in reqs)
    assert mamba_ops.launches - m0 == 3 * kinds.count("mamba")
    assert flash_ops.launches - f0 == 3 * kinds.count("attn")


@pytest.mark.gpu
def test_served_mixtral_kernels_match_plain():
    """A narrow Mixtral (head dim 128, window 32, half of its 4 experts
    held) on the card: a 40-token prefill and 20 decode steps past the
    window through the kernels against the plain versions in f32, fed the
    same tokens; then the engine on lanes of 64 whose idle lanes run past
    the cache, launching the decode kernel once per layer a step."""
    _card()
    cfg = get_config("mixtral-8x7b-ep2", smoke=True).replace(
        d_model=256, n_heads=2, n_kv_heads=1, head_dim=0, dtype="float32",
        experts_held=2, expert_offset=2)
    assert cfg.head_dim == 128 and cfg.sliding_window == 32
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                    serve=True)
    prompt = torch.arange(1, 41, device="cuda")[None] % cfg.vocab
    lk, ck, ln = prefill(p, cfg, prompt, 64)
    lp, cp, _ = prefill(p, cfg, prompt, 64, plain=True)
    for step in range(20):
        scale = max(1.0, float(lp.abs().max()))
        assert float((lk - lp).abs().max()) <= 1e-3 * scale
        tok = torch.argmax(lk, dim=-1)[:, None]
        lk, ck = decode_step(p, cfg, tok, ck, ln + step)
        lp, cp = decode_step(p, cfg, tok, cp, ln + step, plain=True)
    d0, f0 = decode_ops.launches, flash_ops.launches
    reqs = [Request(rid=i, prompt=np.arange(1, n + 1), max_new_tokens=new)
            for i, (n, new) in enumerate(((49, 3), (9, 50)))]
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=64)
    done = eng.run(reqs)
    assert len(done) == 2 and [len(r.out_tokens) for r in reqs] == [3, 50]
    assert flash_ops.launches - f0 == 2 * cfg.n_layers
    assert decode_ops.launches - d0 == eng.stats["decode_steps"] * cfg.n_layers
    assert eng._lengths[0] - cfg.sliding_window + 1 >= 64


@pytest.mark.gpu
def test_served_whisper_kernels_match_plain():
    """A narrow Whisper (head dim 64, 300 encoder rows) on the card in
    f32: prefill(frames=) and decode steps through the kernels against the
    plain versions and against the teacher-forced forward, fed the same
    tokens; a prefill launches the flash kernel once per encoder layer and
    twice per decoder layer (self and cross), a decode step the decode
    kernel twice per decoder layer."""
    _card()
    cfg = get_config("whisper-tiny", smoke=True).replace(
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=0, d_ff=512,
        enc_seq=300, dtype="float32")
    assert cfg.head_dim == 64
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen,
                         device="cuda")
    prompt = torch.arange(1, 11, device="cuda").reshape(2, 5) % cfg.vocab
    f0, d0 = flash_ops.launches, decode_ops.launches
    lk, ck, ln, xk = prefill(p, cfg, prompt, 64, frames=frames)
    assert flash_ops.launches - f0 == cfg.n_enc_layers + 2 * cfg.n_layers
    lp, cp, _, xp = prefill(p, cfg, prompt, 64, plain=True, frames=frames)
    torch.testing.assert_close(xk, xp, rtol=1e-4, atol=1e-4)
    fed, logits = [], [lk]
    for step in range(6):
        scale = max(1.0, float(lp.abs().max()))
        assert float((lk - lp).abs().max()) <= 1e-3 * scale
        tok = torch.argmax(lk, dim=-1)[:, None]
        fed.append(tok)
        before = decode_ops.launches
        lk, ck = decode_step(p, cfg, tok, ck, ln + step, cross_kv=xk)
        assert decode_ops.launches - before == 2 * cfg.n_layers
        lp, cp = decode_step(p, cfg, tok, cp, ln + step, plain=True,
                             cross_kv=xp)
        logits.append(lk)
    h, _ = forward(p, cfg, torch.cat([prompt] + fed, dim=1), frames=frames)
    full = T.logits_fn(p, cfg, h)[:, prompt.shape[1] - 1:]
    for j, lg in enumerate(logits):
        scale = max(1.0, float(lg.abs().max()))
        assert float((full[:, j] - lg).abs().max()) <= 1e-3 * scale


# ---------------------------------------------------------------------------
# The MLA latent attention kernels (MiniCPM3's widths: R 256, Dr 32)
# ---------------------------------------------------------------------------

MLA_SCALE = 96 ** -0.5


def _mla_inputs(gen, b, sq, sk, h, dt):
    return (_randn(gen, b, sq, h, 256, dtype=dt),
            _randn(gen, b, sq, h, 32, dtype=dt),
            _randn(gen, b, sk, 256, dtype=dt), _randn(gen, b, sk, 32, dtype=dt))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [40, 1, 64])
def test_mla_decode_kernel_matches_plain(dtype, h):
    """MiniCPM3's decode at S 8192: lanes that see nothing, one key, the
    f32 kernel's 32-key tile and the bf16 kernel's 64-key tile and one past
    each, a share boundary of the split plan and one past it, S - 1, and
    past the cache; two calls give the same bits; one call adds one to the
    decode counter and none to the prefill's."""
    _card()
    dt, s = getattr(torch, dtype), 8192
    sms = decode_ops.sm_count(torch.device("cuda"))
    unit = mla_ops.split_plan(20, h, s, sms) * mla_ops.TILE
    lens = [-1, 0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 100, unit - 1, unit,
            4095, 6000, s - 1, s, s + 100, 129]
    gen = torch.Generator(device="cuda").manual_seed(h)
    ql, qr, c, kr = _mla_inputs(gen, len(lens), 1, s, h, dt)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    p0, d0 = mla_ops.PREFILL.launches, mla_ops.DECODE.launches
    got = mla_ops.mla_decode(ql, qr, c, kr, length, MLA_SCALE)
    torch.cuda.synchronize()
    assert (mla_ops.PREFILL.launches, mla_ops.DECODE.launches) == (p0, d0 + 1)
    want = mla_decode_ref(ql, qr, c, kr, length, MLA_SCALE)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[0].any()
    assert torch.equal(got, mla_ops.mla_decode(ql, qr, c, kr, length,
                                               MLA_SCALE))
    # a scalar length broadcasts
    torch.testing.assert_close(
        mla_ops.mla_decode(ql, qr, c, kr, 300, MLA_SCALE).float(),
        mla_decode_ref(ql, qr, c, kr, 300, MLA_SCALE).float(), rtol=tol,
        atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h", [
    (1, 1000, 1000, 40),          # a served prefill's shape
    (1, 63, 63, 40), (1, 64, 64, 40), (1, 65, 65, 40), (1, 129, 129, 40),
    (1, 255, 255, 40),            # around the 64-row and 32-key tiles
    (1, 31, 31, 1), (1, 33, 33, 1), (1, 64, 64, 1), (1, 65, 65, 1),
    (1, 100, 612, 40), (1, 77, 301, 40),   # a prefill at an offset
    (2, 33, 1000, 40), (3, 1, 50, 64),
    (1, 16, 16, 40), (1, 32, 32, 40),      # 5 and 10 bf16 blocks exactly
    (1, 127, 127, 1), (1, 128, 128, 1), (1, 129, 129, 1),  # 128-row block
    (1, 65, 192, 40), (2, 64, 129, 40),    # Sk at a 64-key tile edge
])
def test_mla_prefill_kernel_matches_plain(dtype, b, sq, sk, h):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + h)
    ql, qr, c, kr = _mla_inputs(gen, b, sq, sk, h, dt)
    p0, d0 = mla_ops.PREFILL.launches, mla_ops.DECODE.launches
    got = mla_ops.mla_prefill(ql, qr, c, kr, MLA_SCALE)
    torch.cuda.synchronize()
    assert (mla_ops.PREFILL.launches, mla_ops.DECODE.launches) == (p0 + 1, d0)
    want = mla_prefill_ref(ql, qr, c, kr, MLA_SCALE)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, mla_ops.mla_prefill(ql, qr, c, kr, MLA_SCALE))


@pytest.mark.gpu
def test_mla_kernels_take_views_of_the_cache():
    """The model hands the kernels views of its (R, B, max_len, .) cache
    (one repetition, a prefix for prefill) and a q_lat whose heads are not
    packed: strides are honoured."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cache = _randn(gen, 3, 2, 700, 256, dtype=torch.bfloat16)
    kcache = _randn(gen, 3, 2, 700, 32, dtype=torch.bfloat16)
    c, kr = cache[1, :, :300], kcache[1, :, :300]
    ql = _randn(gen, 2, 40, 120, 256, dtype=torch.bfloat16).transpose(1, 2)
    qr = _randn(gen, 2, 120, 40, 32, dtype=torch.bfloat16)
    got = mla_ops.mla_prefill(ql, qr, c, kr, MLA_SCALE)
    want = mla_prefill_ref(ql, qr, c, kr, MLA_SCALE)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    length = torch.tensor([299, 650], dtype=torch.int32, device="cuda")
    got = mla_ops.mla_decode(ql[:, :1], qr[:, :1], cache[2], kcache[2],
                             length, MLA_SCALE)
    want = mla_decode_ref(ql[:, :1], qr[:, :1], cache[2], kcache[2], length,
                          MLA_SCALE)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _mla_views(gen, b, sq, sk, h, dt):
    """q_lat with its heads unpacked, c and k_rope views of the first sk
    keys of one repetition of a (3, B, sk + 88, .) cache."""
    cache = _randn(gen, 3, b, sk + 88, 256, dtype=dt)
    kcache = _randn(gen, 3, b, sk + 88, 32, dtype=dt)
    return (_randn(gen, b, h, sq, 256, dtype=dt).transpose(1, 2),
            _randn(gen, b, sq, h, 32, dtype=dt), cache[1, :, :sk],
            kcache[1, :, :sk])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(64, 64), (65, 129), (128, 128),
                                   (1, 700)])
def test_mla_kernels_take_strided_views_at_b2(dtype, sq, sk):
    """B 2 on strided views of a cache at the tiles' edges: prefill (Sq =
    1 decodes at two lengths instead); two calls bitwise equal."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    ql, qr, c, kr = _mla_views(gen, 2, sq, sk, 40, dt)
    tol = ATTN_TOL[dt]
    if sq > 1:
        got = mla_ops.mla_prefill(ql, qr, c, kr, MLA_SCALE)
        want = mla_prefill_ref(ql, qr, c, kr, MLA_SCALE)
        again = mla_ops.mla_prefill(ql, qr, c, kr, MLA_SCALE)
    else:
        length = torch.tensor([63, 650], dtype=torch.int32, device="cuda")
        got = mla_ops.mla_decode(ql, qr, c, kr, length, MLA_SCALE)
        want = mla_decode_ref(ql, qr, c, kr, length, MLA_SCALE)
        again = mla_ops.mla_decode(ql, qr, c, kr, length, MLA_SCALE)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h", [(1, 129, 129, 40), (1, 200, 200, 1),
                                       (2, 33, 300, 40)])
def test_mla_bf16_kernels_match_their_models(b, sq, sk, h):
    """The bf16 kernels against the plain models of their order
    (``mla_prefill_tiles``: 128-row blocks, 64-key tiles, P rounded to bf16
    before P V; ``mla_decode_splits`` at the wrapper's split plan): within
    one bf16 rounding of the output (2^-7 relative, 2^-9 absolute), far
    inside the plain version's bar, since both round P alike and differ
    only in the order of the f32 sums."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(sq * h)
    ql, qr, c, kr = _mla_inputs(gen, b, sq, sk, h, torch.bfloat16)
    got = mla_ops.mla_prefill(ql, qr, c, kr, MLA_SCALE)
    want = mla_prefill_tiles(ql, qr, c, kr, MLA_SCALE)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -9)
    lens = [-1, 0, 63, 64, 65, sk - 1]
    ql1, qr1, c1, kr1 = (t[:1, :1] if t.dim() == 4 else t[:1]
                         for t in (ql, qr, c, kr))
    ql1, qr1, c1, kr1 = (t.repeat(len(lens), *[1] * (t.dim() - 1))
                         for t in (ql1, qr1, c1, kr1))
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = mla_ops.mla_decode(ql1, qr1, c1, kr1, length, MLA_SCALE)
    nsplit = mla_ops.split_plan(len(lens), h, sk, decode_ops.sm_count(
        torch.device("cuda")))
    want = mla_decode_splits(ql1, qr1, c1, kr1, length, MLA_SCALE, nsplit)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -9)


@pytest.mark.gpu
def test_mla_kernels_reject_bad_input():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    ql, qr, c, kr = _mla_inputs(gen, 1, 4, 16, 8, torch.float32)
    p0, d0 = mla_ops.PREFILL.launches, mla_ops.DECODE.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        mla_ops.mla_prefill_kernel(ql.cpu(), qr.cpu(), c.cpu(), kr.cpu(),
                                   MLA_SCALE)
    with pytest.raises(ValueError, match="latent width"):
        mla_ops.mla_prefill_kernel(ql[..., :128], qr, c[..., :128], kr,
                                   MLA_SCALE)
    wide = torch.cat([qr, qr], -1)
    with pytest.raises(ValueError, match="rope width"):
        mla_ops.mla_prefill_kernel(ql, wide, c, torch.cat([kr, kr], -1),
                                   MLA_SCALE)
    with pytest.raises(TypeError, match="bfloat16"):
        mla_ops.mla_prefill_kernel(ql.half(), qr.half(), c.half(),
                                   kr.half(), MLA_SCALE)
    # c one element off its 16-byte boundary
    shifted = torch.empty(1, 16 * 256 + 1, device="cuda")[:, 1:].view(
        1, 16, 256)
    with pytest.raises(ValueError, match="16-byte"):
        mla_ops.mla_prefill_kernel(ql, qr, shifted, kr, MLA_SCALE)
    # a row stride that is no multiple of 16 bytes
    ragged = torch.empty(1, 16, 257, device="cuda")[..., :256]
    with pytest.raises(ValueError, match="16-byte"):
        mla_ops.mla_decode_kernel(ql[:, :1], qr[:, :1], ragged, kr, 3,
                                  MLA_SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        mla_ops.mla_prefill_kernel(ql, qr, c.transpose(1, 2).contiguous()
                                   .transpose(1, 2), kr, MLA_SCALE)
    with pytest.raises(ValueError, match="at least as many"):
        mla_ops.mla_prefill_kernel(ql, qr, c[:, :3], kr[:, :3], MLA_SCALE)
    with pytest.raises(ValueError, match="one query"):
        mla_ops.mla_decode_kernel(ql, qr, c, kr, 3, MLA_SCALE)
    with pytest.raises(ValueError, match="scale"):
        mla_ops.mla_prefill_kernel(ql, qr, c, kr, 0.0)
    # bf16 reads every operand through a TMA map: no zero stride, and
    # boxes of 8 (position, head) rows: H dividing 8 or a multiple of 8
    bq, bqr = ql.bfloat16().repeat(2, 1, 1, 1), qr.bfloat16().repeat(2, 1, 1,
                                                                     1)
    bc = c.bfloat16().repeat(2, 1, 1)
    shared = kr[:1].bfloat16().expand(2, 16, 32)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        mla_ops.mla_prefill_kernel(bq, bqr, bc, shared, MLA_SCALE)
    with pytest.raises(ValueError, match="divide 8"):
        mla_ops.mla_prefill_kernel(bq[:, :, :6], bqr[:, :, :6], bc,
                                   kr.bfloat16().repeat(2, 1, 1), MLA_SCALE)
    assert (mla_ops.PREFILL.launches, mla_ops.DECODE.launches) == (p0, d0)


@pytest.mark.gpu
def test_served_minicpm3_kernels_match_plain():
    """MiniCPM3's layers at their full widths (d_model 2560, 40 heads of
    64, ranks 768 / 256, rope 32) and 2 layers, in f32 on the card: a
    300-token prefill and 12 decode steps through the kernels against the
    plain versions, fed the same tokens; then the engine, launching the
    prefill kernel once per layer a request and the decode kernel once per
    layer a step."""
    _card()
    cfg = get_config("minicpm3-4b").replace(n_layers=2, vocab=4096,
                                            dtype="float32")
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                    serve=True)
    prompt = torch.arange(1, 301, device="cuda")[None] * 7 % cfg.vocab
    lk, ck, ln = prefill(p, cfg, prompt, 320)
    lp, cp, _ = prefill(p, cfg, prompt, 320, plain=True)
    for step in range(12):
        scale = max(1.0, float(lp.abs().max()))
        assert float((lk - lp).abs().max()) <= 1e-3 * scale
        tok = torch.argmax(lk, dim=-1)[:, None]
        lk, ck = decode_step(p, cfg, tok, ck, ln + step)
        lp, cp = decode_step(p, cfg, tok, cp, ln + step, plain=True)
    p0, d0 = mla_ops.PREFILL.launches, mla_ops.DECODE.launches
    reqs = [Request(rid=i, prompt=np.arange(1, n + 1), max_new_tokens=new)
            for i, (n, new) in enumerate(((49, 3), (9, 30), (20, 4)))]
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=64)
    done = eng.run(reqs)
    assert len(done) == 3 and [len(r.out_tokens) for r in reqs] == [3, 30, 4]
    assert mla_ops.PREFILL.launches - p0 == 3 * cfg.n_layers
    assert (mla_ops.DECODE.launches - d0
            == eng.stats["decode_steps"] * cfg.n_layers)


# ---------------------------------------------------------------------------
# The adaptive loop and the estimation ops on the card
# ---------------------------------------------------------------------------

BPS = 100e9 * 4.5e-6


def _disagreement_cases(steps):
    """benchmarks/adaptive_bench.py run_disagreement's sizes under
    ``drop``, saturated."""
    wl = simulator.phase_shifting_workload(16, 0.5, 6000, BPS, d_hat=4,
                                           seed=1, shift_period=2000)
    return [simulator.AdaptiveCase(
        wl=wl, epoch_slots=250, policy="adaptive", d_hat=4, recfg_frac=1 / 9,
        seed=1, alpha=0.5, gather_steps=s, collision="drop",
        normalize="saturate", label=f"steps{s}") for s in steps]


@pytest.mark.gpu
def test_adaptive_loop_on_card_matches_cpu(monkeypatch):
    """Gathers of 15 and 2 steps: every saturate is one kernel launch, the
    control trajectory is the CPU's, the data plane within the sweep's
    bar; a full gather never disagrees, a 2-step one loses capacity."""
    _card()
    cases = _disagreement_cases((15, 2))
    calls = [0]
    inner = schedule.saturate

    def counted(m, iters=200, device=None):
        calls[0] += not (np.asarray(m) <= 0).all()   # else no projection
        return inner(m, iters=iters, device=device)

    monkeypatch.setattr(schedule, "saturate", counted)
    ops.reset_launches()
    rows = simulator.run_adaptive(cases, BPS, device="cuda", sanitize=True)
    assert ops.launches == calls[0] > 0
    rows_cpu = simulator.run_adaptive(cases, BPS, device="cpu",
                                      sanitize=True)
    for a, b in zip(rows, rows_cpu):
        assert a.plan_digest == b.plan_digest, a.label
        for f in ("recomputes", "stale_slots", "dark_slots",
                  "schedule_groups_max"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("epoch_estimate_tv", "epoch_disagreement",
                  "epoch_collision_loss"):
            assert np.array_equal(getattr(a, f), getattr(b, f),
                                  equal_nan=True), f
        fa, fb = a.result.fct_slots, b.result.fct_slots
        differ = fa != fb
        assert differ.sum() <= 1e-3 * len(fa)
        assert not differ.any() or np.abs(fa - fb)[differ].max() <= 1.0
        assert np.isclose(a.result.utilization, b.result.utilization,
                          rtol=1e-5)
        assert np.allclose(a.epoch_utilization, b.epoch_utilization,
                           rtol=1e-5, atol=0.0)
    assert np.all(rows[0].epoch_disagreement == 0.0)
    assert rows[1].collision_lost_bits > 0 and rows[1].schedule_groups_max > 1


@pytest.mark.gpu
def test_sinkhorn_kernel_on_a_partial_view():
    """A partial gather's view has all-zero rows; saturate clamps them to
    1e-12 before the kernel, which must then equal its order's model bit
    for bit, through the wrapper and through saturate."""
    _card()
    n = 16
    rng = np.random.default_rng(3)
    period = rng.gamma(0.6, 1e8, size=(n, n))
    np.fill_diagonal(period, 0.0)
    views = estimation.estimate_all_views(
        period, estimation.TrafficEstimator.fleet(n, alpha=0.5), 3, BPS,
        steps=2)
    m = views.view(5)
    assert (m.sum(axis=1) == 0).sum() == n - 3
    clamped = torch.from_numpy(np.where(m <= 0, 1e-12, m))
    want = sinkhorn_kernel_order(clamped, 200, 0.0, ops.cluster_size())
    got = ops.sinkhorn_kernel(clamped.cuda(), 200, 0.0).cpu()
    assert torch.equal(got, want)
    assert np.array_equal(saturate(m, device="cuda"), want.numpy())


@pytest.mark.gpu
def test_fleet_update_quantize_on_card_matches_cpu():
    _card()
    n, k = 64, 3
    rng = np.random.default_rng(9)
    ewma = {d: np.zeros((n, n), np.float32) for d in ("cuda", "cpu")}
    for _ in range(4):
        period = rng.gamma(0.7, 250 * BPS, size=(n, n))
        period[0, 1] = 1e14
        out = {d: estimation.fleet_update_quantize(ewma[d], period, 0.3, k,
                                                   BPS, device=d)
               for d in ("cuda", "cpu")}
        (e_c, q_c), (e_h, q_h) = out["cuda"], out["cpu"]
        assert q_c.device.type == "cuda" and q_c.dtype == torch.uint16
        assert e_c.dtype == torch.float32
        assert torch.equal(q_c.cpu(), q_h) and q_h[0, 1] == 65535
        torch.testing.assert_close(e_c.cpu(), e_h, rtol=1e-6, atol=0.0)
        ewma = {"cuda": e_c, "cpu": e_h}
    deq = estimation.dequantize_device(q_c, k, BPS)
    assert deq.device.type == "cuda"
    assert torch.equal(deq.cpu(), estimation.dequantize_device(q_h, k, BPS))


def _twohop_batch(n, horizon=300):
    """A rotorlb and a vlb case of two horizons on one oblivious schedule."""
    s = schedule.oblivious_schedule(n, d_hat=2, recfg_frac=1 / 9)
    wls = [simulator.websearch_workload(n, 0.6, h, BPS, d_hat=2, seed=seed)
           for h, seed in ((horizon // 2, 2), (horizon, 3))]
    return [(s, wl) for wl in wls], ["rotorlb", "vlb"]


def _assert_card_matches_cpu(card, cpu):
    for a, b in zip(card, cpu):
        for f in ("delivered_bits", "utilization", "avg_hops"):
            assert np.isclose(getattr(a, f), getattr(b, f), rtol=1e-4), f
        fa, fb = a.fct_slots, b.fct_slots
        differ = fa != fb
        assert differ.sum() <= 1e-3 * len(fa)
        assert not differ.any() or np.abs(fa - fb)[differ].max() <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,kernel", [(8, None), (12, None), (16, "dense"),
                                      (12, "sparse")])
def test_twohop_routes_on_card_match_cpu(n, kernel):
    """Each two-hop route on the card against the same ops on the CPU,
    sanitized: aggregates rtol 1e-4, FCTs within the sweep's bar (the
    twohop_fct route's are finite, the others' all inf)."""
    _card()
    from repro_torch.analysis.sanitize import make_sanitizer

    cases, modes = _twohop_batch(n)
    rows = {d: simulator._twohop_batch(cases, BPS, modes, torch.device(d),
                                       kernel=kernel,
                                       san=make_sanitizer(True))
            for d in ("cuda", "cpu")}
    _assert_card_matches_cpu(rows["cuda"], rows["cpu"])
    fct = simulator._twohop_route(2, n, 300, kernel) == "twohop_fct"
    assert fct == (kernel is None)
    for r in rows["cuda"]:
        assert np.isfinite(r.fct_slots).any() == fct
        assert r.delivered_bits > 0 and r.avg_hops > 1.0


@pytest.mark.gpu
def test_twohop_sweep_on_card_matches_cpu():
    """run_sweep's mixed grid (single_hop + rotorlb + vlb) on the card."""
    _card()
    cases, modes = _twohop_batch(16, horizon=400)
    sweep = [simulator.SweepCase(s, wl, m, m) for (s, wl), m in
             zip(cases, modes)]
    sweep.append(simulator.SweepCase(cases[1][0], cases[1][1], "single_hop"))
    rows = {d: simulator.run_sweep(sweep, BPS, device=d, sanitize=True)
            for d in ("cuda", "cpu")}
    _assert_card_matches_cpu([r.result for r in rows["cuda"]],
                             [r.result for r in rows["cpu"]])


@pytest.mark.gpu
def test_simulate_aggregate_on_card_matches_cpu():
    _card()
    wl = simulator.websearch_workload(16, 0.5, 400, BPS, d_hat=4, seed=5)
    s = schedule.vermilion_schedule(wl.demand_matrix(), k=3, d_hat=4,
                                    recfg_frac=1 / 9)
    arr = wl.arrival_matrix()
    (d_c, voq_c), (d_h, voq_h) = (
        simulator.simulate_aggregate(s, arr, BPS, device=d)
        for d in ("cuda", "cpu"))
    np.testing.assert_allclose(d_c, d_h, rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(voq_c, voq_h, rtol=0.0, atol=1e-3)
    assert d_c.sum() > 0


def _fct_within_bar(fa, fb):
    differ = fa != fb
    assert differ.sum() <= 1e-3 * len(fa)
    assert not differ.any() or np.abs(fa - fb)[differ].max() <= 1.0


@pytest.mark.gpu
def test_faulted_sweep_on_card_matches_cpu():
    """A single-hop batch under a ToR failure, a drain, a plane outage
    and a flap (and one clean case): the masked plans, refusals and
    flushes on the card against the same ops on the CPU, sanitized."""
    _card()
    wl = simulator.phase_shifting_workload(12, 0.7, 900, BPS, d_hat=3,
                                           seed=3, phases=("uniform",))
    s = schedule.oblivious_schedule(12, d_hat=3, recfg_frac=1 / 9)
    fs = faults.FaultSchedule((
        faults.FaultEvent(200, "tor_fail", node=4),
        faults.FaultEvent(250, "tor_drain", node=7),
        faults.FaultEvent(100, "plane_down", plane=2),
        faults.FaultEvent(300, "link_flap", node=1, plane=1, duration=50)))
    cases = [simulator.SweepCase(s, wl, faults=fs, label="faulted"),
             simulator.SweepCase(s, wl, label="clean")]
    rows = {d: simulator.run_sweep(cases, BPS, device=d, sanitize=True)
            for d in ("cuda", "cpu")}
    for a, b in zip(rows["cuda"], rows["cpu"]):
        ra, rb = a.result, b.result
        _fct_within_bar(ra.fct_slots, rb.fct_slots)
        for f in ("delivered_bits", "fault_lost_bits"):
            assert np.isclose(getattr(ra, f), getattr(rb, f), rtol=1e-5), f
        assert ra.fault_refused_bits == rb.fault_refused_bits
    faulted = rows["cuda"][0].result
    assert faulted.fault_lost_bits > 0 and faulted.fault_refused_bits > 0


def _engine_rows_match(rows, rows_cpu):
    for a, b in zip(rows, rows_cpu):
        assert a.plan_digest == b.plan_digest, a.label
        for f in ("recomputes", "stale_slots", "dark_slots",
                  "schedule_groups_max", "excised_nodes", "excised_planes",
                  "dark_plane_slots"):
            assert getattr(a, f) == getattr(b, f), (a.label, f)
        _fct_within_bar(a.result.fct_slots, b.result.fct_slots)
        for f in ("delivered_bits", "fault_lost_bits", "fault_refused_bits"):
            assert np.isclose(getattr(a.result, f), getattr(b.result, f),
                              rtol=1e-9), (a.label, f)
        assert np.isclose(a.collision_lost_bits, b.collision_lost_bits,
                          rtol=1e-9)
        assert np.allclose(a.epoch_utilization, b.epoch_utilization,
                           rtol=1e-9, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["repair", "fullest"])
def test_degraded_engine_on_card_matches_cpu(kind):
    """The degraded-service engine (f64 VOQ) on the card against the CPU:
    a repair case under a plane outage (the dead plane excised, NACK
    counters read at each epoch boundary) and a partial-gather
    ``fullest`` case (winners by VOQ depth on the card each slot):
    trajectory digests, counters and excisions equal, bits rtol 1e-9,
    FCTs within the sweep's bar."""
    _card()
    if kind == "repair":
        wl = simulator.phase_shifting_workload(
            12, 0.95, 2400, BPS, d_hat=3, seed=1, phases=("uniform",),
            shift_period=2400)
        case = simulator.AdaptiveCase(
            wl, 150, "adaptive", d_hat=3, recfg_frac=1 / 9,
            reconfig_penalty_slots=30, repair=True, swap_tv_threshold=0.3,
            faults=faults.FaultSchedule(
                (faults.FaultEvent(900, "plane_down", plane=0),)))
    else:
        wl = simulator.phase_shifting_workload(
            12, 0.5, 1500, BPS, d_hat=2, seed=1,
            phases=("permutation", "uniform"), shift_period=500)
        case = simulator.AdaptiveCase(
            wl, 150, "adaptive", d_hat=2, recfg_frac=1 / 9, alpha=0.5,
            gather_steps=3, collision="fullest")
    timings: dict = {}
    rows = simulator.run_adaptive([case], BPS, device="cuda", sanitize=True,
                                  timings=timings)
    rows_cpu = simulator.run_adaptive([case], BPS, device="cpu",
                                      sanitize=True)
    _engine_rows_match(rows, rows_cpu)
    if kind == "repair":
        assert rows[0].excised_planes == 1
        assert timings["degraded"]["epoch_reads"] == 15
    else:
        assert rows[0].collision_lost_bits > 0
        assert timings["degraded"]["epoch_reads"] == 0


def test_twohop_sweep_needs_a_card_unless_cpu(monkeypatch):
    """No card: two-hop run_sweep and simulate_aggregate raise by default
    and never fall back to the CPU (runs without a card too)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cases, modes = _twohop_batch(6, horizon=60)
    sweep = [simulator.SweepCase(s, wl, m) for (s, wl), m in
             zip(cases, modes)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.run_sweep(sweep, BPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.simulate_aggregate(cases[0][0], np.zeros((4, 6, 6)), BPS)
    rows = simulator.run_sweep(sweep, BPS, device="cpu")
    assert all(r.result.avg_hops > 1.0 for r in rows)


@pytest.mark.gpu
def test_saturate_certificate_on_card_matches_cpu():
    """A saturate schedule built and certified on the card: every check
    passes, and the certificate is the CPU's (theta rtol 1e-9)."""
    _card()
    from repro_torch.analysis import certify

    m = certify.demand_case("skewed", 12, seed=3)
    kw = dict(k=3, d_hat=2, recfg_frac=1 / 9, normalize="saturate",
              spread=False)
    s = {d: schedule.vermilion_schedule(m, device=d, **kw)
         for d in ("cuda", "cpu")}
    assert np.array_equal(s["cuda"].perms, s["cpu"].perms)
    before = ops.launches
    res = certify.certify_schedule(m, s["cuda"], device="cuda")
    assert ops.launches == before + 2          # scaled and rounded demands
    cpu = certify.certify_schedule(m, s["cuda"], device="cpu")
    assert res.ok and all(v == "pass" for v in res.checks.values())
    assert res.theta >= res.quantized_bound - 1e-9
    got, want = dict(res.certificate), dict(cpu.certificate)
    tg, tw = got.pop("bounds"), want.pop("bounds")
    assert got == want
    assert tg["quantized_theorem3"] == tw["quantized_theorem3"]
    assert tg["asymptotic_theorem3"] == tw["asymptotic_theorem3"]
    assert tg["theta"] == pytest.approx(tw["theta"], rel=1e-9, abs=0.0)
    mats = [certify.demand_case("skewed", 10, seed=i) for i in range(3)]
    assert certify.batch_parity(mats, k=3, d_hat=2, normalize="saturate",
                                device="cuda") == []


@pytest.mark.gpu
@pytest.mark.parametrize("n", [6, 16])
def test_bvn_on_card_matches_cpu(n):
    """Theorem 1 with the projection on the card; perms and term count
    equal to the CPU's, lambdas within 1e-9."""
    _card()
    from repro_torch.core import traffic
    from repro_torch.core.throughput import throughput_single_hop

    m0 = traffic.skewed(n, 0.5, seed=4) + 1e-6
    m = traffic.saturate(m0, device="cuda")
    before = ops.launches
    lams, perms = schedule.bvn_decompose(m, device="cuda")
    assert ops.launches == before + 1
    lc, pc = schedule.bvn_decompose(m, device="cpu")
    assert len(lams) == len(lc) and np.array_equal(perms, pc)
    np.testing.assert_allclose(lams, lc, rtol=0, atol=1e-9)
    cap = np.zeros((n, n))
    for lam, p in zip(lams, perms):
        cap[np.arange(n), p] += lam
    assert throughput_single_hop(cap, m) >= 1 - 1e-6
    # the quantized strawman: equal lambdas (a skewed demand has ties)
    # may take the largest-remainder fill's last slot the other way
    b, bc = (schedule.bvn_schedule(m0, device=d) for d in ("cuda", "cpu"))
    slots, slots_cpu = ([(s.perms == p).all(axis=1).sum() for p in perms]
                        for s in (b, bc))
    assert b.T == bc.T == sum(slots) == sum(slots_cpu) == 3 * n
    assert np.abs(np.subtract(slots, slots_cpu)).max() <= 1


@pytest.mark.gpu
def test_interconnect_drain_on_card_matches_cpu():
    """The interconnect drain (every arch's step matrix on its saturate
    schedule, one single-hop batch) at a short horizon, card vs CPU."""
    _card()
    from repro_torch.benchmarks import interconnect_bench as ib

    cases = {d: ib.drain_cases(horizon=3000, device=d)
             for d in ("cuda", "cpu")}
    for a, b in zip(cases["cuda"], cases["cpu"]):
        assert np.array_equal(a.sched.perms, b.sched.perms), a.label
    rows = {d: simulator.run_sweep(cases[d], ib.BITS_PER_SLOT, device=d,
                                   sanitize=True) for d in ("cuda", "cpu")}
    _assert_card_matches_cpu([r.result for r in rows["cuda"]],
                             [r.result for r in rows["cpu"]])
    assert any(np.isfinite(r.result.fct_slots).all() for r in rows["cuda"])


def test_throughput_paths_need_a_card_unless_cpu(monkeypatch, tmp_path):
    """No card: the BvN strawman, a saturate certificate and the certify
    CLI raise by default and never fall back to the CPU (runs without a
    card too); hose certificates do no device work."""
    from repro_torch.analysis import certify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = certify.demand_case("skewed", 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule.bvn_decompose(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule.bvn_schedule(m)
    s = schedule.vermilion_schedule(m, k=3, d_hat=2, normalize="saturate",
                                    device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        certify.certify_schedule(m, s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        certify.main(["--case", "skewed", "--n", "8"])
    assert certify.certify_schedule(m, s, device="cpu").ok
    hose = schedule.vermilion_schedule(m, k=3, d_hat=2)
    assert certify.certify_schedule(m, hose).ok
    out = tmp_path / "cert.json"
    assert certify.main(["--case", "skewed", "--n", "8", "--device", "cpu",
                         "--json", str(out)]) == 0
    assert out.exists()


@pytest.mark.gpu
def test_fct_bench_on_card_matches_cpu():
    """The Fig. 5/6 driver at a small grid (all five systems): one Sinkhorn
    launch a load, rows within the sweep's bar of the CPU's."""
    _card()
    from repro_torch.benchmarks import fct_bench

    kw = dict(n=8, d_hat=2, horizon=400, loads=(0.3, 0.6))
    rows = {d: [] for d in ("cuda", "cpu")}
    ops.reset_launches()
    fct_bench.run(**kw, device="cuda", sweep_rows=rows["cuda"])
    assert ops.launches == 2
    table = fct_bench.run(**kw, device="cpu", sweep_rows=rows["cpu"])
    assert len(table) == 10 and {r["system"] for r in table} == {
        "vermilion", "greedy", "rotorlb", "vlb", "obl-singlehop"}
    _assert_card_matches_cpu([r.result for r in rows["cuda"]],
                             [r.result for r in rows["cpu"]])


@pytest.mark.gpu
def test_adaptive_bench_smoke_on_card_matches_cpu():
    """The adaptive driver's smoke grid on the card: its own assertions,
    then the CPU's trajectories, counters, FCT bar and utilization."""
    _card()
    from repro_torch.benchmarks import adaptive_bench

    rows = adaptive_bench.smoke(device="cuda")
    rows_cpu = adaptive_bench.smoke(device="cpu")
    for a, b in zip(rows, rows_cpu):
        assert a.plan_digest == b.plan_digest, a.label
        for f in ("recomputes", "schedule_groups_max", "dark_slots"):
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.epoch_disagreement, b.epoch_disagreement)
        fa, fb = a.result.fct_slots, b.result.fct_slots
        differ = fa != fb
        assert differ.sum() <= 1e-3 * len(fa)
        assert not differ.any() or np.abs(fa - fb)[differ].max() <= 1.0
        assert np.isclose(a.result.utilization, b.result.utilization,
                          rtol=1e-5)


@pytest.mark.gpu
def test_twohop_fct_on_card_is_bitwise_the_cpus(monkeypatch):
    """twohop_fct adds arrivals by rounds of distinct pairs and sums in a
    fixed order, so its per-slot delivered matrices on the card are the
    CPU's bit for bit and every FCT is equal (the Fig. 5/6 grid's two-hop
    batch at n 16, cut to 800 slots)."""
    _card()
    from repro_torch.benchmarks import fct_bench

    cases = [c for c in fct_bench.build_grid(16, 4, 800, loads=(0.3, 0.7),
                                             device="cpu")
             if c.mode != "single_hop"]
    assert simulator._twohop_route(len(cases), 16, 800) == "twohop_fct"
    inner, seen = simulator.twohop_fct, {}

    def keep(*args):
        inner(*args)
        seen[args[0].device.type] = args[-2].cpu().clone()

    monkeypatch.setattr(simulator, "twohop_fct", keep)
    rows = {d: simulator.run_sweep(cases, fct_bench.BITS_PER_SLOT, device=d)
            for d in ("cuda", "cpu")}
    assert torch.equal(seen["cuda"], seen["cpu"])
    for a, b in zip(rows["cuda"], rows["cpu"]):
        assert np.array_equal(a.result.fct_slots, b.result.fct_slots)
        assert a.result.delivered_bits == b.result.delivered_bits


# -- training: the flash-attention backward kernel ---------------------------
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.25e-2}
# bf16: the kernel against the plain model of its arithmetic
# (attention_bwd_tiles), beyond one bf16 rounding of each element, within
# this share of each output's largest magnitude (chip_smoke.TILE_TOL: a
# quarter of the plain gate)
TILE_TOL = BWD_TOL[torch.bfloat16] / 4


def _bwd_close(got, want, dtype):
    """Each output within ``BWD_TOL[dtype]`` of its own largest magnitude
    (f32 1e-4; bf16 as ``chip_smoke.py`` gates it)."""
    for g, w in zip(got, want):
        d = float((g.float() - w.float()).abs().max())
        assert d <= BWD_TOL[dtype] * float(w.float().abs().max())


def _tile_close(got, model):
    """Each bf16 output within one bf16 rounding of the tile model's f32
    one (2^-8 of its magnitude) plus ``TILE_TOL`` of its largest."""
    for g, m in zip(got, model):
        over = (g.float() - m).abs() - m.abs() * 2.0 ** -8
        assert float(over.max()) <= TILE_TOL * float(m.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", [
    (1, 63, 63, 4, 4, 64, True, 0),           # one partial tile
    (1, 64, 64, 4, 4, 64, True, 0),
    (1, 65, 65, 4, 2, 64, True, 0),           # a tile and one row
    (2, 129, 129, 8, 1, 128, True, 0),        # MQA, dh 128
    (1, 300, 300, 8, 2, 128, True, 100),      # window edges inside tiles
    (1, 130, 1473, 6, 6, 64, False, 0),       # ragged cross shape
    (1, 256, 128, 2, 2, 64, True, 0),         # rows that see no key
    (2, 200, 200, 6, 6, 64, False, 0),        # non-causal
    (1, 100, 612, 8, 8, 128, True, 0),        # Sq < Sk, end-aligned
    (1, 97, 161, 4, 2, 128, True, 0),         # off the steps, dh 128
    (2, 333, 200, 6, 3, 64, False, 0),        # off the 64-row, 64-key steps
    (2, 100, 30, 4, 2, 64, False, 0),         # Sk under one key tile
    (1, 70, 20, 2, 2, 128, True, 0),          # Sk under a tile, causal
    (1, 520, 520, 32, 8, 128, True, 0),       # rep 4, Mixtral's 32 / 8
    (1, 700, 700, 32, 8, 128, True, 300),     # and its window
])
def test_flash_bwd_kernel_matches_plain(dtype, b, sq, sk, h, kv, dh, causal,
                                        window):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sq * 5 + sk)
    q = _randn(gen, b, sq, h, dh, dtype=dt)
    k = _randn(gen, b, sk, kv, dh, dtype=dt)
    v = _randn(gen, b, sk, kv, dh, dtype=dt)
    do = _randn(gen, b, sq, h, dh, dtype=dt)
    o, lse = flash_ops.attention_kernel(q, k, v, causal, window,
                                        with_lse=True)
    _, lse_ref = attention_lse_ref(q, k, v, causal, window)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), seen)
    torch.testing.assert_close(lse[seen], lse_ref[seen], rtol=0, atol=1e-5)
    before = bwd_ops.launches
    got = bwd_ops.attention_bwd_kernel(q, k, v, o, lse, do, causal, window)
    again = bwd_ops.attention_bwd_kernel(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    assert bwd_ops.launches == before + 2
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    _bwd_close(got, want, dt)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if dt == torch.bfloat16:
        _tile_close(got, attention_bwd_tiles(q, k, v, o, lse, do, causal,
                                             window))


# MLA's cacheless branch (MiniCPM3's training): q and k 96 wide (64 + a
# 32-wide RoPE part), v 64; b, sq, sk, h, kv, causal, window
SPLIT_SHAPES = [
    (1, 63, 63, 4, 4, True, 0),               # one partial tile
    (1, 65, 65, 8, 8, True, 0),               # a tile and one row
    (2, 257, 257, 40, 40, True, 0),           # MiniCPM3's heads
    (1, 1001, 1001, 40, 40, True, 0),         # tail tiles, Sq % 4 != 0
    (1, 77, 301, 6, 3, True, 0),              # ragged Sq < Sk, GQA
    (1, 300, 300, 8, 8, True, 100),           # window edges inside tiles
    (2, 200, 200, 4, 4, False, 0),            # non-causal
    (1, 130, 1473, 6, 6, False, 0),           # cross shape, Sk ragged
    (1, 256, 128, 2, 2, True, 0),             # rows that see no key
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", SPLIT_SHAPES)
def test_flash_kernels_at_split_widths_match_plain(dtype, b, sq, sk, h, kv,
                                                   causal, window):
    """The forward and backward kernels' (96, 64) instances against their
    plain versions: the output (64 wide) and its log-sum-exp, dQ and dK (96
    wide) and dV (64); in bf16 also the backward against its tile model;
    each kernel one launch a call, two calls the same bits."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sq * 3 + sk)
    q = _randn(gen, b, sq, h, 96, dtype=dt)
    k = _randn(gen, b, sk, kv, 96, dtype=dt)
    v = _randn(gen, b, sk, kv, 64, dtype=dt)
    do = _randn(gen, b, sq, h, 64, dtype=dt)
    f0, b0 = flash_ops.launches, bwd_ops.launches
    o, lse = flash_ops.attention_kernel(q, k, v, causal, window,
                                        with_lse=True)
    torch.cuda.synchronize()
    assert o.shape == (b, sq, h, 64) and o.dtype == dt
    want, lse_ref = attention_lse_ref(q, k, v, causal, window)
    tol = ATTN_TOL[dt]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), seen)
    torch.testing.assert_close(lse[seen], lse_ref[seen], rtol=0, atol=1e-5)
    args = (q, k, v, o, lse, do, causal, window)
    got = bwd_ops.attention_bwd_kernel(*args)
    again = bwd_ops.attention_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert (flash_ops.launches - f0, bwd_ops.launches - b0) == (1, 2)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape)
                                             for t in (q, k, v)]
    _bwd_close(got, attention_bwd_ref(*args), dt)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if dt == torch.bfloat16:
        _tile_close(got, attention_bwd_tiles(*args))


@pytest.mark.gpu
def test_flash_kernels_take_only_their_width_pairs():
    """(dqk, dv) pairs outside (64, 64), (128, 128) and (96, 64) raise in
    both wrappers; v as a strided slice (heads not packed) raises in the
    forward, which takes k's and v's strides apart."""
    _card()
    z = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
    for dqk, dv in ((96, 96), (64, 96), (128, 64), (32, 32)):
        q, k, v = z(1, 8, 2, dqk), z(1, 8, 2, dqk), z(1, 8, 2, dv)
        with pytest.raises(ValueError, match="head dims"):
            flash_ops.attention_kernel(q, k, v)
        with pytest.raises(ValueError, match="head dims"):
            bwd_ops.attention_bwd_kernel(q, k, v, z(1, 8, 2, dv),
                                         z(1, 2, 8), z(1, 8, 2, dv))
    kv = z(1, 8, 2, 128)
    with pytest.raises(ValueError, match="packed"):
        flash_ops.attention_kernel(z(1, 8, 2, 96), z(1, 8, 2, 96),
                                   kv[..., 64:])
    # k and v on strides of their own: k's heads not packed raises; k a
    # view with a sequence stride of its own beside a contiguous v runs
    base = torch.randn(1, 70, 2, 192, device="cuda")
    q = torch.randn(1, 70, 2, 96, device="cuda")
    k, v = base[..., :96], torch.randn(1, 70, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="packed"):
        flash_ops.attention_kernel(q, k, v)
    k = torch.randn(1, 140, 2, 96, device="cuda")[:, ::2]   # sequence stride
    got = flash_ops.attention_kernel(q, k, v)
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.gpu
def test_minicpm3_loss_gradient_through_the_kernels_matches_plain():
    """One MiniCPM3 layer at full width (d_model 2560, 40 heads, MLA's
    cacheless branch: attention at q/k 96 and v 64) in f32 on the card:
    ``loss_fn`` and every gradient leaf through the flash kernels against
    the plain path (loss rtol 1e-5, each leaf within 1e-3 of its largest
    magnitude, ``chip_smoke``'s bars); the forward kernel once a layer plus
    once under remat, the backward kernel once a layer."""
    _card()
    cfg = get_config("minicpm3-4b").replace(n_layers=1, vocab=4096,
                                            dtype="float32")
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=300,
                                   global_batch=2, seed=1)).batch_at(0)

    def value_and_grads(plain):
        pt = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = loss_fn(pt, cfg, batch, plain=plain)
        return loss.detach(), dict(zip(
            (k for k, _ in flatten_with_keys(pt)),
            torch.autograd.grad(loss, leaves(pt))))

    f0, b0 = flash_ops.launches, bwd_ops.launches
    loss, got = value_and_grads(False)
    torch.cuda.synchronize()
    assert (flash_ops.launches - f0, bwd_ops.launches - b0) == (2, 1)
    loss_p, want = value_and_grads(True)
    assert float((loss - loss_p).abs()) <= 1e-5 * float(loss_p.abs())
    for key, g in got.items():
        w = want[key]
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max()), key


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q", "k", "v", "o", "do", "lse"])
def test_flash_bwd_kernel_copies_a_misaligned_input(which):
    """A bf16 input whose base is one element off a 16-byte boundary is
    copied by the wrapper: the gradient is the one of the aligned inputs,
    bit for bit."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, do = (_randn(gen, 1, 150, 4, 64, dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (_randn(gen, 1, 150, 2, 64, dtype=torch.bfloat16)
            for _ in range(2))
    o, lse = flash_ops.attention_kernel(q, k, v, True, 0, with_lse=True)
    args = dict(q=q, k=k, v=v, o=o, lse=lse, do=do)
    want = bwd_ops.attention_bwd_kernel(*args.values(), True, 0)
    t = args[which]
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")
    view = buf[1:1 + t.numel()].view(t.shape)   # one element in
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    args[which] = view
    got = bwd_ops.attention_bwd_kernel(*args.values(), True, 0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    _bwd_close(got, attention_bwd_ref(q, k, v, o, lse, do, True, 0),
               torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_gate_catches_broken_backwards(dtype):
    """The kernel passes ``_bwd_close`` at a GQA shape while two broken
    plain backwards (the D term dropped; each kv head's dK, dV from the
    first query head of its group alone) miss it by at least 10x."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, do = (_randn(gen, 2, 1024, 8, 64, dtype=dt) for _ in range(2))
    k, v = (_randn(gen, 2, 1024, 2, 64, dtype=dt) for _ in range(2))
    o, lse = flash_ops.attention_kernel(q, k, v, True, 0, with_lse=True)
    got = bwd_ops.attention_bwd_kernel(q, k, v, o, lse, do, True, 0)
    want = attention_bwd_ref(q, k, v, o, lse, do, True, 0)
    _bwd_close(got, want, dt)
    first = torch.arange(0, 8, 4, device="cuda")
    d_dropped = attention_bwd_ref(q, k, v, torch.zeros_like(o), lse, do,
                                  True, 0)
    _, dk, dv = attention_bwd_ref(q[:, :, first], k, v, o[:, :, first],
                                  lse[:, first], do[:, :, first], True, 0)
    for broken in (d_dropped, (want[0], dk, dv)):
        worst = max(float((g.float() - w.float()).abs().max())
                    / float(w.float().abs().max())
                    for g, w in zip(broken, want))
        assert worst >= 10 * BWD_TOL[dt]


@pytest.mark.gpu
def test_flash_attention_function_on_the_card():
    """Under grad ``attention`` runs the forward kernel once and the
    backward kernel once, and its gradient is the plain path's."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_randn(gen, 2, 150, 4, 64, dtype=torch.float32)
               .requires_grad_() for _ in range(3))
    do = _randn(gen, 2, 150, 4, 64, dtype=torch.float32)
    f0, b0 = flash_ops.launches, bwd_ops.launches
    out = flash_ops.attention(q, k, v, True, 0)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_ops.launches - f0, bwd_ops.launches - b0) == (1, 1)
    want = torch.autograd.grad(attention_ref(q, k, v, True, 0), (q, k, v),
                               do)
    _bwd_close(got, want, torch.float32)


@pytest.mark.gpu
def test_kernels_without_a_backward_refuse_grad_on_the_card():
    _card()
    dev = "cuda"
    x = torch.zeros(1, 4, 2, 32, device=dev, requires_grad=True)
    gates = torch.zeros(1, 4, 2, device=dev)
    # the mLSTM and the scan train, from the zero state only: a state in,
    # or a gradient of the final state, is refused
    st = (torch.zeros(1, 2, 32, 32, device=dev),
          torch.zeros(1, 2, 32, device=dev),
          torch.full((1, 2), -1e9, device=dev))
    with pytest.raises(NotImplementedError, match="state"):
        mlstm_ops.mlstm(x, x, x, gates, gates, st)
    out, (c, _, _) = mlstm_ops.mlstm(x, x, x, gates, gates)
    with pytest.raises(NotImplementedError, match="final state"):
        (out.sum() + c.sum()).backward()
    u = torch.zeros(1, 4, 8, device=dev, requires_grad=True)
    dt = torch.full((1, 4), 0.5, device=dev)
    a = -torch.ones(8, 8, device=dev)
    bm = torch.zeros(1, 4, 8, device=dev)
    h0 = torch.zeros(1, 8, 8, device=dev)
    with pytest.raises(NotImplementedError, match="h0"):
        mamba_ops.selective_scan(dt, a, bm, bm, u, h0)
    y, h_last = mamba_ops.selective_scan(dt, a, bm, bm, u)
    with pytest.raises(NotImplementedError, match="h_last"):
        (y.sum() + h_last.sum()).backward()
    ql = torch.zeros(1, 4, 40, 256, device=dev, requires_grad=True)
    qr = torch.zeros(1, 4, 40, 32, device=dev)
    c = torch.zeros(1, 4, 256, device=dev)
    kr = torch.zeros(1, 4, 32, device=dev)
    with pytest.raises(NotImplementedError, match="cacheless branch"):
        mla_ops.mla_prefill(ql, qr, c, kr, 0.1)
    with pytest.raises(NotImplementedError, match="cacheless branch"):
        mla_ops.mla_decode(ql[:, :1], qr[:, :1], c, kr, 3, 0.1)
    with pytest.raises(NotImplementedError, match="decode-attention"):
        decode_ops.decode_attn(x, x, x, 3)
    with torch.no_grad():
        mlstm_ops.mlstm(x, x, x, gates, gates, st)
        mamba_ops.selective_scan(dt, a, bm, bm, u, h0)


def _rel_each(got, want):
    """max |got - want| / max |want| of each gradient."""
    return [float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,dh", [
    (1, 2, 2, 32),        # the shortest sequence it takes
    (2, 65, 2, 64),       # one past the kernel's 64-position chunk
    (2, 300, 2, 128),     # ragged past the plain version's 256
    (1, 1100, 1, 64),     # past 16 chunks
    (2, 130, 4, 512),     # xLSTM-350M's head dim
    (2, 65, 2, 32),       # a tensor-core tile's ragged tail at dh 32
    (1, 1100, 2, 32),     # and past 16 chunks
])
def test_mlstm_bwd_kernel_matches_plain(b, s, h, dh):
    """dq, dk, dv, dlogi, dlogf against ``mlstm_chunkwise_bwd_ref``, each
    within 1e-4 of its largest magnitude, the same bits on repeat."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(s + dh)
    ins, _ = _mlstm_inputs(gen, b, s, h, dh, "none")
    out, _ = mlstm_ops.mlstm_kernel(*ins)
    dout = _randn(gen, b, s, h, dh, dtype=torch.float32)
    before = mlstm_bwd_ops.launches
    got = mlstm_bwd_ops.mlstm_bwd(*ins, out, dout)
    again = mlstm_bwd_ops.mlstm_bwd(*ins, out, dout)
    torch.cuda.synchronize()
    assert mlstm_bwd_ops.launches == before + 2
    want = mlstm_chunkwise_bwd_ref(*ins, out, dout)
    assert max(_rel_each(got, want)) <= MLSTM_TOL
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_mlstm_bwd_kernel_rejects_bad_input_and_copies_misaligned():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    (q, k, v, li, lf), _ = _mlstm_inputs(gen, 1, 130, 2, 64, "none")
    out, _ = mlstm_ops.mlstm_kernel(q, k, v, li, lf)
    dout = _randn(gen, 1, 130, 2, 64, dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        mlstm_bwd_ops.mlstm_bwd_kernel(q, k, v, li, lf, out, dout.double())
    with pytest.raises(ValueError, match="head dims"):
        mlstm_bwd_ops.mlstm_bwd_kernel(*(t[..., :48].contiguous() for t in (
            q, k, v)), li, lf, *(t[..., :48].contiguous() for t in (
                out, dout)))
    with pytest.raises(ValueError, match="S >= 2"):
        mlstm_bwd_ops.mlstm_bwd_kernel(*(t[:, :1].contiguous() for t in (
            q, k, v, li, lf, out, dout)))
    with pytest.raises(ValueError, match="contiguous"):
        mlstm_bwd_ops.mlstm_bwd_kernel(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v, li, lf,
            out, dout)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_bwd_ops.mlstm_bwd_kernel(q.cpu(), k, v, li, lf, out, dout)
    want = mlstm_bwd_ops.mlstm_bwd_kernel(q, k, v, li, lf, out, dout)
    shifted = []
    for t in (q, k, v, out, dout):
        s = torch.empty(t.numel() + 1, device="cuda")[1:].view_as(t)
        s.copy_(t)
        shifted.append(s)
    got = mlstm_bwd_ops.mlstm_bwd_kernel(*shifted[:3], li, lf, *shifted[3:])
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _scan_bwd_close(got, want, u_dtype):
    """Each f32 gradient within 1e-4 of its largest magnitude; a bf16 du
    beyond one bf16 rounding of each element (2^-8 of it) likewise."""
    rel = _rel_each(got[:4], want[:4])
    assert max(rel) <= 1e-4, rel
    du, wdu = got[4].float(), want[4].float()
    slack = wdu.abs() * 2.0 ** -8 if u_dtype == torch.bfloat16 else 0.0
    over = ((du - wdu).abs() - slack).clamp_min(0)
    assert float(over.max()) <= 1e-4 * float(wdu.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n,u_dtype", [
    (1, 1, 64, 16, "float32"),          # S = 1
    (2, 17, 40, 8, "float32"),          # one past a lane, N 8
    (2, 130, 200, 16, "bfloat16"),      # ragged tiles
    (1, 300, 67, 16, "float32"),        # an odd D
    (2, 65, 16384, 16, "bfloat16"),     # Jamba's width, one past a tile
    (2, 130, 33, 8, "bfloat16"),        # an odd D past a block, N 8
    (1, 71, 31, 8, "float32"),          # D under one block, N 8
])
def test_scan_bwd_kernel_matches_plain(b, s, d, n, u_dtype):
    """ddt, da, dB, dC, du, given the forward kernel's kept tile states,
    against ``selective_scan_bwd_ref``, the same bits on repeat; du in u's
    type."""
    _card()
    ud = getattr(torch, u_dtype)
    gen = torch.Generator(device="cuda").manual_seed(s + d + n)
    dt, a, bmat, cmat, u, _ = _scan_inputs(gen, b, s, d, n, ud, "none")
    dy = _randn(gen, b, s, d, dtype=torch.float32)
    *_, hs = mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u,
                                             keep_states=True)
    before = scan_bwd_ops.launches
    got = scan_bwd_ops.selective_scan_bwd(dt, a, bmat, cmat, u, dy, hs)
    again = scan_bwd_ops.selective_scan_bwd(dt, a, bmat, cmat, u, dy, hs)
    torch.cuda.synchronize()
    assert scan_bwd_ops.launches == before + 2
    assert got[4].dtype == ud
    _scan_bwd_close(got, selective_scan_bwd_ref(dt, a, bmat, cmat, u, dy), ud)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n,u_dtype", [
    (2, 130, 200, 16, "bfloat16"),      # ragged tiles
    (1, 193, 33, 8, "float32"),         # an odd D, N 8, one past 3 tiles
])
def test_scan_forward_keeps_the_tile_states(b, s, d, n, u_dtype):
    """``keep_states`` (the ``SelectiveScan`` Function's forward under a
    gradient) leaves y and h_last bit for bit as they were, and its states
    are the plain scan's final states over each tile's prefix (the zero
    state for the first), within the forward's tolerance."""
    _card()
    ud = getattr(torch, u_dtype)
    gen = torch.Generator(device="cuda").manual_seed(s + d + n + 1)
    dt, a, bmat, cmat, u, _ = _scan_inputs(gen, b, s, d, n, ud, "none")
    y, h_last = mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u)
    y2, h2, hs = mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u,
                                                 keep_states=True)
    assert torch.equal(y, y2) and torch.equal(h_last, h2)
    assert hs.shape == (b, -(-s // 64), d, n)
    assert not hs[:, 0].any()
    for i in range(1, hs.shape[1]):
        p = 64 * i
        _, want = selective_scan_ref(dt[:, :p].contiguous(), a, bmat[:, :p],
                                     cmat[:, :p], u[:, :p].contiguous())
        torch.testing.assert_close(hs[:, i], want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_scan_bwd_kernel_rejects_bad_input():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, a, bmat, cmat, u, _ = _scan_inputs(gen, 1, 8, 64, 16, torch.float32,
                                           "none")
    dy = torch.zeros_like(u)
    *_, hs = mamba_ops.selective_scan_kernel(dt, a, bmat, cmat, u,
                                             keep_states=True)
    with pytest.raises(ValueError, match="d_state"):
        scan_bwd_ops.selective_scan_bwd_kernel(
            dt, a[:, :4].contiguous(), bmat[..., :4], cmat[..., :4], u, dy,
            hs[..., :4].contiguous())
    with pytest.raises(TypeError, match="u must be"):
        scan_bwd_ops.selective_scan_bwd_kernel(dt, a, bmat, cmat, u.half(),
                                               dy, hs)
    with pytest.raises(ValueError, match="dy must have shape"):
        scan_bwd_ops.selective_scan_bwd_kernel(dt, a, bmat, cmat, u,
                                               dy[..., :32], hs)
    with pytest.raises(TypeError, match="dy must be float32|float32"):
        scan_bwd_ops.selective_scan_bwd_kernel(dt, a, bmat, cmat, u,
                                               dy.bfloat16(), hs)
    with pytest.raises(ValueError, match="contiguous"):
        scan_bwd_ops.selective_scan_bwd_kernel(
            dt, a, bmat, cmat,
            u.transpose(1, 2).contiguous().transpose(1, 2), dy, hs)
    with pytest.raises(ValueError, match="hs must have shape"):
        scan_bwd_ops.selective_scan_bwd_kernel(dt, a, bmat, cmat, u, dy,
                                               hs[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="tile states"):
        scan_bwd_ops.selective_scan_bwd(dt, a, bmat, cmat, u, dy, None)


def _loss_grads_on_the_card(cfg, counters):
    """``loss_fn`` and every gradient leaf of seeded f32 weights through
    the kernels and through the plain path on the card; the kernels'
    launches (``counters``: name -> module with ``launches``) in the
    kernels' pass."""
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=300,
                                   global_batch=2, seed=1)).batch_at(0)

    def value_and_grads(plain):
        pt = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = loss_fn(pt, cfg, batch, plain=plain)
        return loss.detach(), dict(zip(
            (k for k, _ in flatten_with_keys(pt)),
            torch.autograd.grad(loss, leaves(pt), allow_unused=True)))

    start = {k: m.launches for k, m in counters.items()}
    loss, got = value_and_grads(False)
    torch.cuda.synchronize()
    calls = {k: m.launches - start[k] for k, m in counters.items()}
    loss_p, want = value_and_grads(True)
    assert float((loss - loss_p).abs()) <= 1e-5 * float(loss_p.abs())
    largest = max(float(w.abs().max()) for w in want.values()
                  if w is not None)
    for key, g in got.items():
        w = want[key]
        if w is None:
            assert g is None, key
            continue
        assert float((g - w).abs().max()) <= 1e-4 * largest, key
    return calls


@pytest.mark.gpu
def test_xlstm_loss_gradient_through_the_kernels_matches_plain():
    """A narrow xLSTM (head dim 128) in f32: loss and gradients through the
    mLSTM's forward and backward kernels against the plain path; under
    remat each mLSTM layer's forward kernel runs twice and its backward
    kernel once."""
    _card()
    cfg = get_config("xlstm-350m", smoke=True).replace(d_model=256,
                                                       dtype="float32")
    n_mlstm = sum(k == "mlstm" for k in cfg.layer_kinds())
    calls = _loss_grads_on_the_card(
        cfg, {"fwd": mlstm_ops, "bwd": mlstm_bwd_ops})
    fwd = n_mlstm * (2 if cfg.remat == "block" else 1)
    assert calls == {"fwd": fwd, "bwd": n_mlstm}


@pytest.mark.gpu
def test_jamba_loss_gradient_through_the_kernels_matches_plain():
    """A narrow Jamba (head dim 128, 2 of its 4 experts held) in f32: loss
    and gradients through the scan's forward and backward kernels and the
    flash kernels against the plain path; under remat each Mamba layer's
    forward kernel runs twice and its backward kernel once."""
    _card()
    cfg = get_config("jamba-1.5-large", smoke=True).replace(
        d_model=256, n_heads=2, n_kv_heads=1, head_dim=0, dtype="float32",
        experts_held=2, expert_offset=0)
    kinds = cfg.layer_kinds()
    n_mamba = sum(k == "mamba" for k in kinds)
    calls = _loss_grads_on_the_card(
        cfg, {"fwd": mamba_ops, "bwd": scan_bwd_ops})
    fwd = n_mamba * (2 if cfg.remat == "block" else 1)
    assert calls == {"fwd": fwd, "bwd": n_mamba}


@pytest.mark.gpu
def test_whisper_one_token_loss_trains_on_the_card():
    """A narrow Whisper's loss over one token on the card in f32: the one
    cross-attention query needs a gradient, so it takes the flash kernel
    and its backward (never the decode kernel, which has none), and every
    gradient leaf is the plain path's within 1e-4 of the largest gradient;
    the cross projections and the encoder get one."""
    _card()
    cfg = get_config("whisper-tiny", smoke=True).replace(
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=0, d_ff=512,
        enc_seq=300, dtype="float32")
    p = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=1, global_batch=2, seed=1,
        family=cfg.family, d_model=cfg.d_model,
        enc_seq=cfg.enc_seq)).batch_at(0)

    def grads(plain):
        pt = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = loss_fn(pt, cfg, batch, plain=plain)
        return dict(zip((k for k, _ in flatten_with_keys(pt)),
                        torch.autograd.grad(loss, leaves(pt))))

    f0, b0, d0 = flash_ops.launches, bwd_ops.launches, decode_ops.launches
    got = grads(False)
    torch.cuda.synchronize()
    assert decode_ops.launches == d0
    assert bwd_ops.launches - b0 == cfg.n_enc_layers + 2 * cfg.n_layers
    assert flash_ops.launches - f0 > bwd_ops.launches - b0
    want = grads(True)
    largest = max(float(w.abs().max()) for w in want.values())
    for key, g in got.items():
        assert float((g - want[key]).abs().max()) <= 1e-4 * largest, key
    for key in ("cross/attn/wq", "cross/attn/wk", "cross/attn/wv",
                "encoder/attn/wq", "enc_pos"):
        assert float(got[key].abs().max()) > 0, key


# -- the port's analysis and examples on the card ---------------------------

def _example(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["agg", "singlehop", "twohop_dense",
                                    "twohop_fct", "twohop_sparse"])
def test_ir_report_on_the_card_equals_the_cpu(kernel):
    """The op-level analyzer counts the aten ops a slot kernel issues: the
    same ops run on the card as on the CPU, so every field of the report
    is equal, and within the checked-in budget."""
    _card()
    from repro_torch.analysis import ir
    got = ir.analyze_kernel(kernel, device="cuda")
    want = ir.analyze_kernel(kernel, device="cpu")
    assert got.to_dict() == want.to_dict()
    assert ir.check_budget([got], ir.load_budget()) == []


@pytest.mark.gpu
def test_serve_decode_example_on_the_card():
    """``examples/torch_serve_decode.py``: Qwen1.5-0.5B at full width on
    the card serves its five requests, 8 tokens each, through the flash
    and decode kernels."""
    _card()
    f0, d0 = flash_ops.launches, decode_ops.launches
    done = _example("torch_serve_decode").main([])
    torch.cuda.synchronize()
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out_tokens) == 8 for r in done)
    assert flash_ops.launches > f0 and decode_ops.launches > d0


@pytest.mark.gpu
def test_serve_decode_smoke_on_the_card():
    """``--smoke``, the reference's example (4 heads of 64), on the card:
    its five requests through the flash and decode kernels."""
    _card()
    f0, d0 = flash_ops.launches, decode_ops.launches
    done = _example("torch_serve_decode").main(["--smoke"])
    torch.cuda.synchronize()
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out_tokens) == 8 for r in done)
    assert flash_ops.launches > f0 and decode_ops.launches > d0
