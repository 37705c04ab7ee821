"""repro_torch kernels on the card (marker ``gpu``): each CUDA kernel
against its plain PyTorch version.  Needs no jax, so it runs on a machine
with a card and PyTorch alone (``pytest -m gpu``); without a card every
test skips.  Whether a card is present is decided inside each test.

Tolerances: Sinkhorn f32 rtol 1e-5 / atol 1e-6, as tests/test_kernels.py
holds the Pallas kernel (reduction order only), f64 rtol 1e-12 over 200
iterations, and its cluster path bit for bit against
``sinkhorn_kernel_order``, the CPU model of its order; attention f32 2e-5
and bf16 2e-2, as tests/test_kernels.py holds the Pallas attention
kernels; mLSTM f32 rtol 1e-4 / atol 1e-4 on the
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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import estimation, schedule, simulator
from repro_torch.core.traffic import saturate
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
from repro_torch.kernels.sinkhorn import ops
from repro_torch.kernels.sinkhorn.ref import (sinkhorn_kernel_order,
                                              sinkhorn_ref)
from repro_torch.models import decode_step, init_params, prefill, serve_params
from repro_torch.serve.engine import Request, ServeEngine

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
    (1, "float64"), (17, "float64"), (250, "float64"), (256, "float64"),
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
