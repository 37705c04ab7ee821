"""The port's MLA (multi-head latent attention) and MiniCPM3 against the
reference's (``repro.models``, ``repro.serve``), on the CPU, in f32.

The smoke MiniCPM3 (2 layers, d_model 64, 4 heads of 16, q_lora_rank 32,
kv_lora_rank 16, rope_head_dim 8) on the same weights, carried across by
``repro_torch.convert.params_from``, with numpy-seeded inputs.  The
reference serves MLA only through its weight-absorbed branch (prefill and
decode both take the ``kv_cache`` path), which the port runs through
``kernels/mla_attention`` (the plain versions on the CPU).

Bars: the plain latent attention within 1e-5 of an f64 softmax oracle;
plain models of the kernels' arithmetic (the decode split: split-K partials
combined in split order; the bf16 prefill: 128-row blocks, 64-key tiles,
P rounded to the working type before P V) within 1e-5 of the plain version
in f32, and in bf16 within the card's bar (2e-2 absolute plus 2e-2
relative, as the kernels are held on the card: P in bf16 moves a row's
output by up to 2^-9 of its largest value, and both sides round the output
to bf16); an MLA layer and its caches within 2e-5 of the reference's;
prefill and decode logits within 1e-4 of the largest logit, greedy and
engine tokens equal.
"""
import ast
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import greedy_generate as j_greedy
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.mla_attention.ref import (
    mla_attention_ref,
    mla_decode_ref,
    mla_decode_splits as _kernel_split,
    mla_prefill_ref,
    mla_prefill_tiles as _kernel_tiles,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "minicpm3-4b"
TOL = 1e-4
LOG2E = 1.4426950408889634


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * scale)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) in f32."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, convert.params_from(_np(jp), cfg)


def _prompt(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(
        np.int32)


# -- the plain latent attention ------------------------------------------------
def _operands(b, sq, sk, h, r, dr, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in (
        (b, sq, h, r), (b, sq, h, dr), (b, sk, r), (b, sk, dr)))


def _oracle(ql, qr, c, kr, scale, q_pos):
    """The latent attention in f64: q_pos (B, Sq), keys at or before."""
    ql, qr, c, kr = (np.asarray(a, np.float64) for a in (ql, qr, c, kr))
    s = (np.einsum("bshr,bkr->bhsk", ql, c)
         + np.einsum("bshd,bkd->bhsk", qr, kr)) * scale
    seen = np.arange(c.shape[1])[None, None, :] <= q_pos[:, :, None]
    s = np.where(seen[:, None], s, -np.inf)
    mx = s.max(-1, keepdims=True)
    e = np.exp(s - np.where(np.isfinite(mx), mx, 0.0))
    tot = e.sum(-1, keepdims=True)
    p = np.divide(e, tot, out=np.zeros_like(e), where=tot > 0)
    return np.einsum("bhsk,bkr->bshr", p, c)


@pytest.mark.parametrize("sq,sk", [(1, 1), (5, 5), (7, 19), (16, 16),
                                   (3, 40)])
@pytest.mark.parametrize("r,dr", [(16, 8), (256, 32)])
def test_prefill_ref_matches_the_f64_oracle(sq, sk, r, dr):
    """End-aligned causal masking (row i at Sk - Sq + i), keys R + Dr wide,
    values R wide, and the scale an argument, not the key width's."""
    ql, qr, c, kr = _operands(2, sq, sk, 3, r, dr, 10 * sq + sk)
    scale = 0.35
    got = mla_prefill_ref(_t(ql), _t(qr), _t(c), _t(kr), scale)
    q_pos = np.broadcast_to(np.arange(sq) + sk - sq, (2, sq))
    _close(got, _oracle(ql, qr, c, kr, scale, q_pos), 1e-5)
    assert tuple(got.shape) == (2, sq, 3, r) and got.dtype == torch.float32
    # the key width's scale is another function (where a row sees two keys)
    other = mla_prefill_ref(_t(ql), _t(qr), _t(c), _t(kr), (r + dr) ** -0.5)
    assert torch.allclose(other, got, atol=1e-3) == (sk == 1)


@pytest.mark.parametrize("lens", [[-1, 0, 3], [11, 12, 40], [-5, 7, 100]])
def test_decode_ref_matches_the_f64_oracle(lens):
    """One query a lane at its own length: keys [0, min(len, S - 1)]; a
    lane at a length below 0 sees nothing and returns 0."""
    ql, qr, c, kr = _operands(3, 1, 12, 4, 16, 8, sum(lens) + 50)
    scale = 0.35
    got = mla_decode_ref(_t(ql), _t(qr), _t(c), _t(kr),
                         torch.tensor(lens, dtype=torch.int32), scale)
    want = _oracle(ql, qr, c, kr, scale, np.array(lens)[:, None])
    _close(got, want, 1e-5)
    for i, ln in enumerate(lens):
        if ln < 0:
            assert not got[i].any()
    # a scalar length is every lane's
    _close(mla_attention_ref(_t(ql), _t(qr), _t(c), _t(kr), scale, 5),
           _oracle(ql, qr, c, kr, scale, np.full((3, 1), 5)), 1e-5)


def test_prefill_ref_at_an_offset_is_the_reference_mask():
    """Queries at length + i over a cache prefix of length + Sq (what the
    model hands the prefill) see what the reference's q_pos = ln + i mask
    lets them see over the whole cache."""
    ql, qr, c, kr = _operands(1, 6, 30, 2, 16, 8, 3)
    ln = 9
    got = mla_prefill_ref(_t(ql), _t(qr), _t(c[:, :ln + 6]),
                          _t(kr[:, :ln + 6]), 0.25)
    whole = mla_attention_ref(_t(ql), _t(qr), _t(c), _t(kr), 0.25, ln)
    _close(got, whole.numpy(), 1e-6)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    ql, qr, c, kr = (_t(a) for a in _operands(2, 4, 9, 3, 256, 32, 8))
    assert torch.equal(mla_ops.mla_prefill(ql, qr, c, kr, 0.1),
                       mla_prefill_ref(ql, qr, c, kr, 0.1))
    ln = torch.tensor([3, 20], dtype=torch.int32)
    assert torch.equal(mla_ops.mla_decode(ql[:, :1], qr[:, :1], c, kr, ln, 0.1),
                       mla_decode_ref(ql[:, :1], qr[:, :1], c, kr, ln, 0.1))
    p0, d0 = mla_ops.PREFILL.launches, mla_ops.DECODE.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        mla_ops.mla_prefill_kernel(ql, qr, c, kr, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mla_ops.mla_decode_kernel(ql[:, :1], qr[:, :1], c, kr, ln, 0.1)
    assert (mla_ops.PREFILL.launches, mla_ops.DECODE.launches) == (p0, d0)


# -- the kernels' arithmetic, modelled on the CPU ---------------------------------
def _held(got, want, dtype):
    """f32: within 1e-5 of the largest output; bf16: the card's bar."""
    if dtype == torch.float32:
        _close(got, want.numpy(), 1e-5)
    else:
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= 2e-2 + 2e-2 * want.float().abs()).all()), \
            float(diff.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [1, 40])
@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129])
def test_prefill_tile_model_matches_plain(n, h, dtype):
    """Sq = Sk around the 64-key tile and the 128-row block, at H 1 (rows
    are positions) and MiniCPM3's H 40 (a block spans 3-4 positions)."""
    dt = getattr(torch, dtype)
    ql, qr, c, kr = (_t(a).to(dt) for a in _operands(1, n, n, h, 256, 32,
                                                     n + h))
    scale = 96 ** -0.5
    got = _kernel_tiles(ql, qr, c, kr, scale)
    assert got.dtype == dt and tuple(got.shape) == (1, n, h, 256)
    _held(got, mla_prefill_ref(ql, qr, c, kr, scale), dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h", [(1, 77, 301, 40), (2, 33, 150, 40),
                                       (1, 100, 612, 1)])
def test_prefill_tile_model_at_an_offset(b, sq, sk, h, dtype):
    """A prefill at an offset (Sq < Sk: row i at Sk - Sq + i), B 2, and
    keys past the last tile's end read as zeros."""
    dt = getattr(torch, dtype)
    ql, qr, c, kr = (_t(a).to(dt) for a in _operands(b, sq, sk, h, 256, 32,
                                                     sq * sk))
    scale = 96 ** -0.5
    _held(_kernel_tiles(ql, qr, c, kr, scale),
          mla_prefill_ref(ql, qr, c, kr, scale), dt)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7, 33])
def test_decode_split_model_matches_plain(nsplit):
    """Shares of whole tiles, empty shares (m = -inf, l = 0) and lanes that
    see nothing, one key, a tile and one past it, S - 1 and past S."""
    sk = 300
    lens = [-1, 0, 31, 32, 33, 150, sk - 1, sk + 5]
    ql, qr, c, kr = (_t(a) for a in _operands(len(lens), 1, sk, 4, 256, 32,
                                             nsplit))
    ql, qr = ql * 0.3, qr * 0.3
    ln = torch.tensor(lens, dtype=torch.int32)
    scale = 96 ** -0.5
    got = _kernel_split(ql, qr, c, kr, ln, scale, nsplit)
    _close(got, mla_decode_ref(ql, qr, c, kr, ln, scale).numpy(), 1e-5)


@pytest.mark.parametrize("tile,dtype", [(32, "float32"), (64, "bfloat16")])
@pytest.mark.parametrize("nsplit", [1, 26, 33])
def test_decode_split_model_per_type(tile, dtype, nsplit):
    """Each type's tile (f32 32 keys, bf16 64) at the served plan's splits
    (10 lanes: 26, 8 lanes: 33) and one, lanes at the tile and share edges; bf16
    with P rounded before P V, within the card's bar."""
    sk = 8 * 64 + 5
    lens = [-1, 0, 63, 64, 65, 16 * 64 - 1, sk - 1, sk + 3]
    dt = getattr(torch, dtype)
    ql, qr, c, kr = (_t(a).to(dt) for a in _operands(len(lens), 1, sk, 40,
                                                     256, 32, nsplit + tile))
    ln = torch.tensor(lens, dtype=torch.int32)
    scale = 96 ** -0.5
    got = _kernel_split(ql, qr, c, kr, ln, scale, nsplit, tile)
    assert got.dtype == dt and not got[0].any()
    _held(got, mla_decode_ref(ql, qr, c, kr, ln, scale), dt)


@pytest.mark.parametrize("batch,h,s,want", [
    (8, 40, 8192, 33),          # MiniCPM3's served decode: 2 x 132 SMs
    (1, 40, 8192, 128),         # one lane: capped by S's 128 tiles
    (10, 64, 8192, 26),
    (1, 128, 100, 2),           # two row blocks; S's 2 tiles cap it
    (64, 40, 8192, 4),
    (10, 40, 8192, 26),         # chip_smoke's served decode: 260 blocks
    (300, 40, 8192, 1),         # more lanes than block slots: one split
    (3, 40, 1, 1),              # a one-key cache
])
def test_split_plan(batch, h, s, want):
    assert mla_ops.split_plan(batch, h, s, 132) == want


def test_tma_strides_on_cpu_tensors():
    """Every bf16 operand reaches the kernel through a TMA map: views of the
    cache keep their strides, a dimension of size 1 takes a contiguous
    tensor's stride (TMA refuses 0), and a base or stride off 16 bytes, a
    last dimension that is not contiguous, or a zero stride raise.  A
    transposed q_lat (heads not packed) keeps its strides: q's map has a
    dimension for each of batch, position and head."""
    bf = torch.bfloat16
    cache = torch.zeros(3, 2, 700, 256, dtype=bf)
    assert mla_ops.tma_strides("c", cache[1, :, :300]) == [700 * 256, 256]
    assert mla_ops.tma_strides("c", torch.zeros(1, 5, 256, dtype=bf)) == [
        5 * 256, 256]
    assert mla_ops.tma_strides("k_rope", torch.zeros(2, 1, 32, dtype=bf)) \
        == [32, 32]
    assert mla_ops.strides("c", torch.zeros(1, 5, 256, dtype=bf)) == [0, 256]
    flat = torch.zeros(16 * 256 + 8, dtype=bf)
    with pytest.raises(ValueError, match="16-byte boundary"):
        mla_ops.tma_strides("c", flat[1:1 + 16 * 256].view(1, 16, 256))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        mla_ops.tma_strides("c", torch.zeros(1, 16, 260, dtype=bf)[..., :256])
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        mla_ops.tma_strides("k_rope", torch.zeros(1, 32, dtype=bf)
                            .expand(4, 16, 32))
    with pytest.raises(ValueError, match="contiguous"):
        mla_ops.tma_strides("c", torch.zeros(1, 256, 16, dtype=bf)
                            .transpose(1, 2))
    ql = torch.zeros(2, 40, 120, 256, dtype=bf).transpose(1, 2)
    assert mla_ops.strides("q_lat", ql) == [40 * 120 * 256, 256, 120 * 256]
    assert mla_ops.tma_strides("q_lat", ql) == [40 * 120 * 256, 256,
                                                120 * 256]
    one = torch.zeros(3, 1, 40, 32, dtype=bf)         # a decode's q_rope
    assert mla_ops.tma_strides("q_rope", one) == [40 * 32, 40 * 32, 32]
    with pytest.raises(ValueError, match="16-byte"):
        mla_ops.strides("q_lat", torch.zeros(1, 4, 40, 260, dtype=bf)
                        [..., :256])


# -- one MLA layer ----------------------------------------------------------------
def _layer(model, seed):
    jcfg, _, cfg, _ = model
    jp = _np(JL.init_mla(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jp, cfg, {k: _t(v) for k, v in jp.items()}


def _caches(cfg, b, max_len, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, max_len, cfg.kv_lora_rank),
                                dtype=np.float32),
            rng.standard_normal((b, max_len, cfg.rope_head_dim),
                                dtype=np.float32))


@pytest.mark.parametrize("ln,s", [(0, 9), (0, 1), (5, 7), (12, 20)])
def test_mla_layer_prefill_matches(model, ln, s):
    """A prompt of ``s`` tokens written at ``ln`` into a cache of random
    keys (0: a prefill; above 0: a multi-token write at an offset), against
    ``JL.mla_attention``: the output and both cache tensors."""
    jcfg, jp, cfg, p = _layer(model, 7 + ln + s)
    b, max_len = 2, 40
    cc, ckr = _caches(cfg, b, max_len, ln + s)
    x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(ln, ln + s), (b, s)).astype(np.int32)
    want, (jc, jk, _) = JL.mla_attention(
        jp, _j(x), jcfg, jnp.asarray(pos, jnp.int32),
        kv_cache=(_j(cc), _j(ckr), jnp.int32(ln)))
    got, (tc, tk, n) = L.mla_attention(p, _t(x), cfg, torch.from_numpy(pos),
                                       kv_cache=(_t(cc), _t(ckr), ln))
    assert n == ln + s
    _close(got, want, 2e-5)
    _close(tc, jc, 2e-5)
    _close(tk, jk, 2e-5)


def test_mla_layer_decode_per_lane_matches(model):
    """One decode step of four lanes at their own lengths (a (B,) tensor)
    against the reference one lane at a time (its engine vmaps a scalar
    length): a lane whose write clamps at max_len - 1 and one past the
    cache by more, which sees the whole cache."""
    jcfg, jp, cfg, p = _layer(model, 3)
    max_len = 24
    lens = [0, 9, max_len - 1, max_len + 6]
    b = len(lens)
    cc, ckr = _caches(cfg, b, max_len, 5)
    x = np.random.default_rng(6).standard_normal((b, 1, cfg.d_model),
                                                 dtype=np.float32)
    ln = torch.tensor(lens, dtype=torch.int32)
    got, (tc, tk, n) = L.mla_attention(p, _t(x), cfg, ln.reshape(b, 1),
                                       kv_cache=(_t(cc), _t(ckr), ln))
    assert torch.equal(n, ln + 1)
    for i, li in enumerate(lens):
        want, (jc, jk, _) = JL.mla_attention(
            jp, _j(x[i:i + 1]), jcfg, jnp.full((1, 1), li, jnp.int32),
            kv_cache=(_j(cc[i:i + 1]), _j(ckr[i:i + 1]), jnp.int32(li)))
        _close(got[i:i + 1], want, 2e-5)
        _close(tc[i:i + 1], jc, 2e-5)
        _close(tk[i:i + 1], jk, 2e-5)
    # the clamped writes land in the last slot
    assert not torch.equal(tc[2:, -1], _t(cc[2:, -1]))
    assert torch.equal(tc[2:, :-1], _t(cc[2:, :-1]))


@pytest.mark.parametrize("s,causal", [(9, True), (1, True), (20, True),
                                      (7, False)])
def test_mla_layer_without_a_cache_matches_with_gradients(model, s, causal):
    """MLA's cacheless branch (training's forward: K and V up-projected,
    attention at q/k width head_dim + rope_head_dim = 24 and v width 16)
    against ``JL.mla_attention(kv_cache=None)``: the output within 2e-5,
    and the gradients of x and of every MLA weight (``jax.vjp`` against
    autograd through the port's ``FlashAttention`` on the CPU) each within
    1e-4 of its largest magnitude (of the largest of any, where the
    reference's is 0).  No cache comes back."""
    jcfg, jp, cfg, p = _layer(model, 11 + s)
    b = 2
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    dout = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    keys = sorted(jp)
    want, vjp = jax.vjp(
        lambda params, xx: JL.mla_attention(params, xx, jcfg,
                                            jnp.asarray(pos, jnp.int32),
                                            causal=causal)[0],
        {k: _j(jp[k]) for k in keys}, _j(x))
    jg_p, jg_x = vjp(_j(dout))
    pt = {k: p[k].clone().requires_grad_() for k in keys}
    xt = _t(x).requires_grad_()
    got, cache = L.mla_attention(pt, xt, cfg, torch.from_numpy(pos),
                                 causal=causal)
    assert cache is None and got.shape == (b, s, cfg.d_model)
    _close(got.detach(), want, 2e-5)
    grads = torch.autograd.grad(got, [xt] + [pt[k] for k in keys],
                                _t(dout))
    want_g = [np.asarray(w) for w in [jg_x] + [jg_p[k] for k in keys]]
    largest = max(float(np.abs(w).max()) for w in want_g)
    for name, g, w in zip(["x"] + keys, grads, want_g):
        assert g.shape == w.shape, name
        # one token: its one key takes all the weight, so the query's
        # weights have gradient 0 in exact arithmetic; the port's rounding
        # noise there is held to the largest gradient of any leaf
        scale = float(np.abs(w).max()) or largest
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, name


# -- the model ------------------------------------------------------------------
def test_minicpm3_is_ported():
    """The smoke MiniCPM3 builds the reference's parameter tree (shapes,
    types) and cache layout: per layer the latent pair (R, B, max_len,
    kv_lora_rank) and (R, B, max_len, rope_head_dim) in the activation
    type."""
    cfg, jcfg = get_config(ARCH, smoke=True), j_get_config(ARCH, smoke=True)
    T.check_supported(get_config(ARCH))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0), jcfg)))
    p = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want
    assert T.cell_structure(cfg) == JT.cell_structure(jcfg) == [
        ("attn", "dense")]
    caches = T.init_cache(cfg, 3, 16, "cpu")
    jcaches = JT.init_cache(jcfg, 3, 16)
    assert [[(tuple(t.shape), str(t.dtype).replace("torch.", ""))
             for t in c] for c in caches] == [
        [(tuple(t.shape), str(t.dtype)) for t in c] for c in jcaches]
    assert [tuple(t.shape) for t in caches[0]] == [(2, 3, 16, 16),
                                                   (2, 3, 16, 8)]


def test_full_size_counts_from_the_reference_tree():
    """MiniCPM3-4B at every published width and its full depth: 62 layers,
    d_model 2560, 40 heads of 64, ranks 768 / 256, rope 32, d_ff 6400,
    vocab 73,448; 4,261,519,360 weights by ``param_count`` (norms not
    counted), 4,261,839,360 leaves in the reference's tree, counted from
    shapes."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim, cfg.d_ff,
            cfg.vocab, cfg.dtype) == (62, 2560, 40, 64, 768, 256, 32, 6400,
                                      73448, "bfloat16")
    assert cfg.param_count() == 4_261_519_360
    shapes = jax.eval_shape(lambda: j_init_params(
        jax.random.PRNGKey(0), j_get_config(ARCH)))
    total = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    norms = cfg.n_layers * 2 * cfg.d_model + cfg.d_model
    assert total == 4_261_839_360 == cfg.param_count() + norms
    # 62 x (256 + 32) x 2 bytes of latent cache a token in bf16
    assert cfg.n_layers * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2 == 35712


@pytest.mark.parametrize("s", [1, 5, 40, 300])
def test_prefill_and_decode_match(model, s):
    """Prompts of 1, 5, 40 and 300 tokens, B = 2, then 12 decode steps:
    logits at every step, both cache tensors and the greedy tokens equal to
    the reference's."""
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab, 2, s, s)
    max_len = s + 16
    jl, jc, jln, _ = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_len)
    tl, tc, ln = prefill(p, cfg, torch.from_numpy(prompt), max_len,
                         device="cpu")
    assert ln == int(jln) == s
    _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(12):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                               jln + i)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu")
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for got, want in zip(tc, jc):
        for a, b in zip(got, want):
            _close(a, b)
    want = j_greedy(jp, jcfg, jnp.asarray(prompt, jnp.int32), 13, max_len)
    got = greedy_generate(p, cfg, torch.from_numpy(prompt), 13, max_len,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_splices_the_latent_pair_into_its_lane(model):
    """Admission copies a one-lane prefill's latent pair into the lane's
    slice of both pool tensors and leaves the other lanes as they were."""
    _, _, cfg, p = model
    eng = ServeEngine(p, cfg, n_lanes=3, max_len=32, device="cpu")
    prompt = _prompt(cfg.vocab, 1, 11, 4)[0]
    eng.try_admit(Request(rid=0, prompt=prompt, max_new_tokens=3))
    assert eng.try_admit(Request(rid=1, prompt=prompt[:6], max_new_tokens=3))
    _, one, _ = prefill(eng.params, cfg, torch.from_numpy(prompt[None, :6]),
                        32, device="cpu")
    for pool, mine in zip(eng.caches[0], one[0]):
        assert torch.equal(pool[:, 1], mine[:, 0])
        assert not pool[:, 2].any()


def test_engine_matches_reference_engine(model):
    """Both engines on 2 lanes of 48: one lane serves three requests while
    the other serves a long one, then goes idle and its length runs past
    the cache.  The same tokens."""
    jcfg, jp, cfg, p = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (20, 5, 31, 9)]
    new = [9, 40, 12, 3]
    jreqs = [JRequest(rid=i, prompt=pr, max_new_tokens=n)
             for i, (pr, n) in enumerate(zip(prompts, new))]
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=n)
            for i, (pr, n) in enumerate(zip(prompts, new))]
    jdone = JServeEngine(jp, jcfg, n_lanes=2, max_len=48).run(jreqs)
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=48, device="cpu")
    idle = []
    step = eng.step

    def watched():
        idle.append(sum(r is None for r in eng.active))
        return step()

    eng.step = watched
    done = eng.run(reqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert all(r.done for r in done)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert max(idle) == 1                 # a lane went idle


def test_launcher_serves_minicpm3_on_the_cpu(capsys):
    launch_serve.main(["--arch", "minicpm3-4b", "--smoke", "--device",
                       "cpu", "--n-requests", "3", "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("req 0: ")
    assert all(len(ast.literal_eval(ln.split("-> ")[1])) == 4 for ln in lines)
