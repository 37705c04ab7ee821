"""The port's attention kernels on the CPU (their plain versions, which is
what a CPU tensor takes) against the reference's Pallas kernels in
interpret mode and their oracles, on the same numpy inputs.

Shapes are those of tests/test_kernels.py cut to S <= 512, plus what the
serving path needs beyond them: ragged lengths, a fully masked row, one
length per lane and lengths at or past the cache's end.  Tolerances:
f32 2e-5 (reduction order only), bf16 2e-2, as tests/test_kernels.py
holds the Pallas kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.kernels.decode_attention.decode_attention import decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref as j_dref
from repro.kernels.flash_attention.flash_attention import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_aref
from repro.models.layers import chunked_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, *shapes, dtype="float32"):
    """Seeded normal arrays as (jax, torch) pairs of one rounded value."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                        JDT[dtype])
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            TDT[dtype])
        out.append((j, t))
    return out


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,h,kv,dh", [
    (2, 256, 256, 4, 2, 64),
    (1, 128, 512, 8, 8, 128),    # Sq < Sk: end-aligned
    (1, 512, 512, 8, 1, 64),     # MQA
    (2, 128, 128, 4, 4, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_oracle(b, sq, sk, h, kv, dh, dtype):
    (qj, q), (kj, k), (vj, v) = _inputs(
        sq + sk + h, (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
        dtype=dtype)
    got = flash_ops.attention(q, k, v, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (b, sq, h, dh)
    _close(got, flash_attention(qj, kj, vj, causal=True), TOL[dtype])
    _close(got, j_aref(qj, kj, vj, causal=True), TOL[dtype])


@pytest.mark.parametrize("window", [64, 128])
def test_flash_plain_sliding_window(window):
    (qj, q), (kj, k), (vj, v) = _inputs(1, (1, 256, 4, 64), (1, 256, 2, 64),
                                        (1, 256, 2, 64))
    got = flash_ops.attention(q, k, v, causal=True, window=window)
    _close(got, flash_attention(qj, kj, vj, causal=True, window=window), 2e-5)
    _close(got, j_aref(qj, kj, vj, causal=True, window=window), 2e-5)


def test_flash_plain_noncausal():
    (qj, q), (kj, k), (vj, v) = _inputs(2, (2, 128, 4, 64), (2, 128, 4, 64),
                                        (2, 128, 4, 64))
    got = flash_ops.attention(q, k, v, causal=False)
    _close(got, flash_attention(qj, kj, vj, causal=False), 2e-5)
    _close(got, j_aref(qj, kj, vj, causal=False), 2e-5)


@pytest.mark.parametrize("sq,sk,window", [(200, 200, 0), (77, 301, 0),
                                          (130, 130, 50)])
def test_flash_plain_ragged_lengths(sq, sk, window):
    """Any length (the Pallas kernel refuses lengths its blocks do not
    divide): against the oracle, and against the reference model's
    ``chunked_attention`` with the same end alignment."""
    (qj, q), (kj, k), (vj, v) = _inputs(3, (1, sq, 6, 64), (1, sk, 3, 64),
                                        (1, sk, 3, 64))
    got = flash_ops.attention(q, k, v, causal=True, window=window)
    _close(got, j_aref(qj, kj, vj, causal=True, window=window), 2e-5)
    _close(got, chunked_attention(qj, kj, vj, causal=True, window=window,
                                  block_q=64, q_offset=sk - sq), 2e-5)


def test_flash_plain_fully_masked_row_is_zero():
    """Sq > Sk causal: the first Sq - Sk rows see no key.  The port returns
    0 there, as the oracle and ``chunked_attention`` do (the Pallas kernel's
    -1e30 sentinel gives the mean of V instead: a state of the reference,
    ROADMAP queue 3)."""
    (qj, q), (kj, k), (vj, v) = _inputs(4, (1, 256, 2, 64), (1, 128, 2, 64),
                                        (1, 128, 2, 64))
    got = flash_ops.attention(q, k, v, causal=True)
    assert torch.equal(got[:, :128], torch.zeros_like(got[:, :128]))
    _close(got, j_aref(qj, kj, vj, causal=True), 2e-5)
    assert float(got[:, 128:].abs().max()) > 0


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sk,h,kv,dh,ln", [
    (2, 512, 8, 2, 64, 300),
    (1, 512, 4, 4, 128, 511),
    (2, 512, 8, 1, 64, 0),
    (1, 512, 16, 2, 128, 234),
])
def test_decode_plain_matches_pallas_and_oracle(b, sk, h, kv, dh, ln):
    (qj, q), (kj, k), (vj, v) = _inputs(ln + h, (b, 1, h, dh),
                                        (b, sk, kv, dh), (b, sk, kv, dh))
    got = decode_ops.decode_attn(q, k, v, ln)
    assert got.shape == (b, 1, h, dh)
    _close(got, decode_attention(qj, kj, vj, jnp.int32(ln)), 2e-5)
    _close(got, j_dref(qj, kj, vj, jnp.int32(ln)), 2e-5)


def test_decode_plain_bf16():
    (qj, q), (kj, k), (vj, v) = _inputs(5, (2, 1, 8, 64), (2, 512, 2, 64),
                                        (2, 512, 2, 64), dtype="bfloat16")
    got = decode_ops.decode_attn(q, k, v, 400)
    assert got.dtype == torch.bfloat16
    _close(got, decode_attention(qj, kj, vj, jnp.int32(400)), 2e-2)
    _close(got, j_dref(qj, kj, vj, jnp.int32(400)), 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_per_lane_lengths(dtype):
    """One length per lane, as the serving engine passes them, against the
    Pallas kernel vmapped over lanes (what the reference engine runs),
    with lengths 0, S - 1 and past S among them."""
    lens = np.array([0, 17, 255, 256, 300, 130], np.int32)
    b, s = len(lens), 256
    (qj, q), (kj, k), (vj, v) = _inputs(6, (b, 1, 4, 64), (b, s, 2, 64),
                                        (b, s, 2, 64), dtype=dtype)
    got = decode_ops.decode_attn(q, k, v, torch.from_numpy(lens))
    one = jax.vmap(lambda q1, k1, v1, l1: decode_attention(
        q1[None], k1[None], v1[None], l1)[0])
    _close(got, one(qj, kj, vj, jnp.asarray(lens, jnp.int32)), TOL[dtype])
    for i, ln in enumerate(lens):
        _close(got[i:i + 1], j_dref(qj[i:i + 1], kj[i:i + 1], vj[i:i + 1],
                                    jnp.int32(ln)), TOL[dtype])


@pytest.mark.parametrize("ln", [512, 700])
def test_decode_plain_length_past_cache_sees_everything(ln):
    (qj, q), (kj, k), (vj, v) = _inputs(7, (2, 1, 4, 64), (2, 512, 4, 64),
                                        (2, 512, 4, 64))
    got = decode_ops.decode_attn(q, k, v, ln)
    _close(got, decode_attention(qj, kj, vj, jnp.int32(ln)), 2e-5)
    _close(got, decode_ops.decode_attn(q, k, v, 511), 0.0)


@pytest.mark.parametrize("ln", [300, 40, 600])
def test_decode_plain_matches_chunked_attention(ln):
    """The reference model's own decode mask (``chunked_attention`` with
    ``q_offset = length``), which the serving path computes."""
    (qj, q), (kj, k), (vj, v) = _inputs(8, (2, 1, 4, 64), (2, 512, 2, 64),
                                        (2, 512, 2, 64))
    got = decode_ops.decode_attn(q, k, v, ln)
    _close(got, chunked_attention(qj, kj, vj, causal=True, q_offset=ln),
           2e-5)


# ---------------------------------------------------------------------------
def test_wrappers_take_the_plain_version_on_cpu():
    (_, q), (_, k), (_, v) = _inputs(9, (1, 64, 2, 64), (1, 64, 2, 64),
                                     (1, 64, 2, 64))
    f0, d0 = flash_ops.launches, decode_ops.launches
    assert torch.equal(flash_ops.attention(q, k, v, window=16),
                       attention_ref(q, k, v, window=16))
    lens = torch.tensor([40])
    assert torch.equal(decode_ops.decode_attn(q[:, :1], k, v, lens),
                       decode_attention_ref(q[:, :1], k, v, lens))
    assert (flash_ops.launches, decode_ops.launches) == (f0, d0)


def test_kernels_refuse_cpu_tensors():
    (_, q), (_, k), (_, v) = _inputs(10, (1, 8, 2, 64), (1, 8, 2, 64),
                                     (1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        decode_ops.decode_kernel(q[:, :1], k, v, 3)


def test_lengths_vector_shapes():
    assert decode_ops.lengths_vector(5, 3, "cpu").tolist() == [5, 5, 5]
    v = decode_ops.lengths_vector(torch.tensor([1, 2]), 2, "cpu")
    assert v.dtype == torch.int32 and v.tolist() == [1, 2]
    with pytest.raises(ValueError, match="shape"):
        decode_ops.lengths_vector(torch.tensor([1, 2]), 3, "cpu")


# ---------------------------------------------------------------------------
# The wrappers' pure-Python rules for the redesigned kernels, on CPU tensors.
def _offset_view(shape, dtype, offset):
    """A tensor of ``shape`` that starts ``offset`` elements into a larger
    contiguous buffer (storage_offset), so its address moves by
    ``offset * itemsize`` bytes."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=dtype)[offset:offset + n].view(shape)


def test_tma_strides_accept_served_layouts():
    q = torch.zeros(2, 130, 16, 64, dtype=torch.bfloat16)
    assert flash_ops.tma_strides("q", q) == (130 * 16 * 64, 16 * 64)
    cache = torch.zeros(2, 2048, 8, 128, dtype=torch.bfloat16)
    view = cache[:, :300]                   # prefill attends over ck[:, :n]
    assert flash_ops.tma_strides("k", view) == (2048 * 8 * 128, 8 * 128)
    # a batch of one has no batch stride to honour
    one = torch.zeros(4, 64, 2, 64, dtype=torch.bfloat16)[1:2]
    assert flash_ops.tma_strides("k", one) == (64 * 2 * 64, 2 * 64)


def test_tma_strides_refuse_misaligned_base():
    q = _offset_view((1, 64, 2, 64), torch.bfloat16, 1)    # 2 bytes off
    assert q.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_ops.tma_strides("q", q)
    ok = _offset_view((1, 64, 2, 64), torch.bfloat16, 8)   # 16 bytes off
    assert flash_ops.tma_strides("q", ok) == (64 * 2 * 64, 2 * 64)


def test_tma_strides_refuse_unaligned_strides():
    base = torch.zeros(2 * 50 * 132, dtype=torch.bfloat16)
    # sequence stride 132 elements = 264 bytes: not a multiple of 16
    k = base.as_strided((2, 50, 2, 64), (50 * 132, 132, 64, 1))
    with pytest.raises(ValueError, match="sequence stride"):
        flash_ops.tma_strides("k", k)
    # batch stride 50 * 128 + 4 elements: a sequence stride of 128 is fine,
    # the batch stride is not
    k = torch.zeros(2 * (50 * 128 + 4), dtype=torch.bfloat16).as_strided(
        (2, 50, 2, 64), (50 * 128 + 4, 128, 64, 1))
    with pytest.raises(ValueError, match="batch stride"):
        flash_ops.tma_strides("k", k)


def test_decode_check_aligned():
    cache = torch.zeros(8, 2048, 16, 64, dtype=torch.bfloat16)
    decode_ops.check_aligned("k", cache)
    decode_ops.check_aligned("k", cache[:, 256:])  # the decode control's view
    with pytest.raises(ValueError, match="16-byte"):
        decode_ops.check_aligned("k", _offset_view((2, 64, 2, 64),
                                                   torch.float32, 1))
    odd = torch.zeros(2 * 64 * 132, dtype=torch.float32).as_strided(
        (2, 64, 2, 64), (64 * 132, 132, 64, 1))    # 528-byte rows: fine
    decode_ops.check_aligned("k", odd)
    odd = torch.zeros(2 * 64 * 130, dtype=torch.float32).as_strided(
        (2, 64, 2, 64), (64 * 130, 130, 64, 1))    # 520-byte rows
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        decode_ops.check_aligned("k", odd)


def test_decode_check_q():
    q = torch.zeros(8, 1, 16, 64, dtype=torch.bfloat16)
    decode_ops.check_q(q)
    decode_ops.check_q(q[1:])                      # 2 KiB on: fine
    with pytest.raises(ValueError, match="4-byte boundary"):
        decode_ops.check_q(_offset_view((2, 1, 16, 64), torch.bfloat16, 1))
    # an odd batch stride puts every other row's q 2 bytes off
    odd = torch.zeros(2 * 1025, dtype=torch.bfloat16).as_strided(
        (2, 1, 16, 64), (1025, 1024, 64, 1))
    with pytest.raises(ValueError, match="even batch stride"):
        decode_ops.check_q(odd)
    # f32 q is read one element at a time: any offset will do
    decode_ops.check_q(_offset_view((2, 1, 16, 64), torch.float32, 1))


@pytest.mark.parametrize("b,kvh,s,want", [
    (8, 16, 2048, 3),       # Qwen's served decode: 384 blocks on 132 SMs
    (8, 8, 2048, 5),        # Jamba's and Llama's: 320
    (8, 1, 2048, 33),       # MQA: 264
    (1, 1, 64, 2),          # capped by the cache's 32-row tiles
    (1, 1, 1, 1),
    (64, 16, 2048, 1),      # B KV alone fills the card
])
def test_decode_split_plan(b, kvh, s, want):
    n = decode_ops.split_plan(b, kvh, s, sms=132)
    assert n == want
    assert b * kvh * n >= min(2 * 132, b * kvh * -(-s // decode_ops.TILE))


# ---------------------------------------------------------------------------
# The one rounding the bf16 flash kernel adds to the plain version's f32
# arithmetic: P rounded to bf16 before P V, the row sums l taken in f32.
def _flash_bf16_model(q, k, v, causal, window, bk):
    """The bf16 kernel's arithmetic in plain PyTorch: f32 scores of the bf16
    inputs, an online softmax over key tiles of ``bk`` in log2 units, P in
    bf16 before P V, O / l rounded to bf16 (0 for a row that sees no
    key)."""
    _, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(h // kvh, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // kvh, 2).transpose(1, 2)
    c = dh ** -0.5 * np.log2(np.e)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full(qf.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for k0 in range(0, sk, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        kpos = torch.arange(k0, min(k0 + bk, sk))[None, :]
        ok = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        mu = torch.where(mn == float("-inf"), 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s * c - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
        m = mn
    out = torch.where(l > 0, o / l.clamp_min(1e-30), 0.0)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("h,kv,dh,bk", [(16, 16, 64, 128),   # Qwen's heads
                                        (64, 8, 128, 64)])   # Jamba's
@pytest.mark.parametrize("s,window,sharp", [(130, 0, 1.0), (257, 0, 1.0),
                                            (257, 0, 4.0), (200, 100, 1.0)])
def test_flash_bf16_p_rounding_stays_within_tolerance(h, kv, dh, bk, s,
                                                      window, sharp):
    """The model against the f32 oracle on the same bf16 inputs, by
    chip_smoke.py's rule |diff| <= tol + tol |want| with tol =
    ATTN_TOL[bf16] = 2e-2; ``sharp`` scales q so that the softmax is
    peaked, where P's rounding weighs most."""
    (_, q), (_, k), (_, v) = _inputs(s + h + dh, (1, s, h, dh),
                                     (1, s, kv, dh), (1, s, kv, dh),
                                     dtype="bfloat16")
    q = (q.float() * sharp).to(torch.bfloat16)
    got = _flash_bf16_model(q, k, v, True, window, bk).float()
    want = attention_ref(q, k, v, causal=True, window=window).float()
    oracle = attention_ref(q.float(), k.float(), v.float(), causal=True,
                           window=window)
    tol = TOL["bfloat16"]
    for ref in (want, oracle):
        assert bool(((got - ref).abs() <= tol + tol * ref.abs()).all())
    # the rounding is there: the model is not the plain version
    assert float((got - want).abs().max()) > 0
