"""The port's Whisper (``whisper-tiny``: the encoder, cross-attention,
``prefill(frames=)``, ``decode_step(cross_kv=)``) and teacher-forced
``forward`` against the reference's on the same weights, carried across by
``repro_torch.convert.params_from``, on the CPU.

Bars, as tests/test_torch_model.py's: the encoder and the cross-attention
layer within 2e-5 in f32 (product and reduction order only); prefill /
decode logits, caches, the encoder output and ``forward``'s hidden states
within 1e-4 and greedy tokens equal under an f32 config, at the smoke
config and at full size; logits within 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    decode_step,
    forward,
    greedy_generate,
    init_params,
    prefill,
    serve_params,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-tiny"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _models(arch, seed=0, smoke=True, dtype="float32"):
    jcfg = j_get_config(arch, smoke=smoke).replace(dtype=dtype)
    cfg = get_config(arch, smoke=smoke).replace(dtype=dtype)
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, convert.params_from(_np(jp), cfg)


def _frames(cfg, b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(100 + seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    """(jax cfg, jax params, port cfg, port params) of the smoke Whisper in
    f32."""
    return _models(ARCH)


def test_encode_matches_reference(smoke):
    jcfg, jp, cfg, p = smoke
    fr = _frames(cfg, 2)
    want = JT.encode(jp, jcfg, jnp.asarray(fr, jnp.float32))
    got = T.encode(p, cfg, torch.from_numpy(fr))
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    assert got.dtype == torch.float32
    _close(got, want, 2e-5)
    # the plain switch takes the same plain versions on the CPU
    assert torch.equal(T.encode(p, cfg, torch.from_numpy(fr), plain=True),
                       got)


def test_encode_rejects_frames_of_another_shape(smoke):
    _, _, cfg, p = smoke
    fr = torch.zeros(1, cfg.enc_seq - 1, cfg.d_model)
    with pytest.raises(ValueError, match="frames must have shape"):
        T.encode(p, cfg, fr)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("s", [5, 1])
def test_cross_attention_matches_reference(s, qkv_bias):
    """The cross branch: q from x (with its bias, no RoPE), k and v from
    the encoder output (no bias), all keys visible; S > 1 through the
    flash path, S = 1 through the decode path."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32",
                                                  qkv_bias=qkv_bias)
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32",
                                               qkv_bias=qkv_bias)
    jp = JL.init_gqa(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(5)
    if qkv_bias:     # the reference draws zero biases: give them values
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape, np.float32),
                              jnp.float32) if k.startswith("b") else v)
              for k, v in jp.items()}
    p = {k: _t(v) for k, v in jp.items()}
    b = 3
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((b, cfg.enc_seq, cfg.d_model),
                              dtype=np.float32)
    pos = np.broadcast_to(np.arange(7, 7 + s, dtype=np.int32), (b, s))
    want, wcache = JL.gqa_attention(jp, jnp.asarray(x, jnp.float32), jcfg,
                                    jnp.asarray(pos, jnp.int32),
                                    cross_kv=jnp.asarray(enc, jnp.float32))
    got, cache = L.gqa_attention(p, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos.copy()),
                                 cross_kv=torch.from_numpy(enc))
    assert wcache is None and cache is None
    _close(got, want, 2e-5)
    # lane b attends to its own encoder row only
    one, _ = L.gqa_attention(p, torch.from_numpy(x[1:2]), cfg,
                             torch.from_numpy(pos[1:2].copy()),
                             cross_kv=torch.from_numpy(enc[1:2]))
    _close(one, got[1:2].numpy(), 1e-6)


def test_cross_attention_ignores_the_window():
    """A sliding window (set on the config) hides no encoder key, as in the
    reference's cross branch."""
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    p = L.init_gqa(torch.Generator().manual_seed(0), cfg, torch.float32)
    rng = np.random.default_rng(6)
    enc = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq, cfg.d_model),
                                               dtype=np.float32))
    for s in (1, 4):
        x = torch.from_numpy(rng.standard_normal((2, s, cfg.d_model),
                                                 dtype=np.float32))
        pos = torch.zeros((2, s), dtype=torch.int32)
        want, _ = L.gqa_attention(p, x, cfg, pos, cross_kv=enc)
        got, _ = L.gqa_attention(p, x, cfg.replace(sliding_window=4), pos,
                                 cross_kv=enc)
        assert torch.equal(got, want)


def test_prefill_and_decode_match_reference(smoke):
    jcfg, jp, cfg, p = smoke
    fr = _frames(cfg, 2, seed=1)
    prompt = _tokens(cfg.vocab, 2, 5, seed=1)
    jl, jc, jln, jx = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 24,
                                frames=jnp.asarray(fr, jnp.float32))
    tl, tc, ln, tx = prefill(p, cfg, torch.from_numpy(prompt), 24,
                             device="cpu", frames=torch.from_numpy(fr))
    assert ln == int(jln) == prompt.shape[1]
    assert tx.shape == (2, cfg.enc_seq, cfg.d_model)
    assert tx.dtype == torch.float32
    _close(tl, jl, 1e-4)
    _close(tx, jx, 1e-4)
    for (k, v), (jk, jv) in zip(tc, jc):
        _close(k, jk, 1e-4)
        _close(v, jv, 1e-4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert np.array_equal(torch.argmax(tl, -1).numpy(), tok[:, 0])
    for i in range(6):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                               jln + i, cross_kv=jx)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu", cross_kv=tx)
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(torch.argmax(tl, -1).numpy(), tok[:, 0])
    for (k, v), (jk, jv) in zip(tc, jc):
        _close(k, jk, 1e-4)
        _close(v, jv, 1e-4)


def test_per_lane_lengths_with_cross_kv(smoke):
    """A (B,) length vector decodes each lane, with its own encoder row,
    as a scalar length would one lane at a time."""
    _, _, cfg, p = smoke
    fr = torch.from_numpy(_frames(cfg, 2, seed=2))
    prompt = torch.from_numpy(_tokens(cfg.vocab, 2, 5, seed=2))
    _, caches, ln, cross = prefill(p, cfg, prompt, 16, device="cpu",
                                   frames=fr)
    lens = torch.tensor([ln, ln + 3], dtype=torch.int32)
    tok = torch.tensor([[3], [4]])
    both, _ = decode_step(p, cfg, tok, [(k.clone(), v.clone())
                                        for k, v in caches], lens,
                          device="cpu", cross_kv=cross)
    for i in range(2):
        one = [(k[:, i:i + 1].clone(), v[:, i:i + 1].clone())
               for k, v in caches]
        want, _ = decode_step(p, cfg, tok[i:i + 1], one, int(lens[i]),
                              device="cpu", cross_kv=cross[i:i + 1])
        _close(both[i:i + 1], want.numpy(), 1e-5)


def test_forward_matches_reference(smoke):
    jcfg, jp, cfg, p = smoke
    fr = _frames(cfg, 2, seed=3)
    tokens = _tokens(cfg.vocab, 2, 12, seed=3)
    jh, jaux = JT.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32),
                          frames=jnp.asarray(fr, jnp.float32))
    th, taux = forward(p, cfg, torch.from_numpy(tokens),
                       frames=torch.from_numpy(fr), device="cpu")
    assert th.shape == (2, 12, cfg.d_model)
    _close(th, jh, 1e-4)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_and_decode_match_own_forward(smoke):
    """The reference's test_whisper_decode on the port: the served prefill
    and decode logits against the teacher-forced forward's."""
    _, _, cfg, p = smoke
    b, s = 2, 12
    fr = torch.from_numpy(_frames(cfg, b, seed=4))
    tokens = torch.from_numpy(_tokens(cfg.vocab, b, s, seed=4))
    h, _ = forward(p, cfg, tokens, frames=fr, device="cpu")
    full = T.logits_fn(p, cfg, h)
    logits, caches, length, cross = prefill(p, cfg, tokens[:, :6], s + 2,
                                            device="cpu", frames=fr)
    _close(logits, full[:, 5].numpy(), 1e-4)
    for i in range(6, s):
        logits, caches = decode_step(p, cfg, tokens[:, i:i + 1], caches,
                                     length, device="cpu", cross_kv=cross)
        length = length + 1
        _close(logits, full[:, i].numpy(), 1e-4)


def test_bf16_logits_match():
    jcfg, jp, cfg, p = _models(ARCH, seed=7, dtype="bfloat16")
    assert cfg.dtype == "bfloat16"
    fr = _frames(cfg, 2, seed=5)
    prompt = _tokens(cfg.vocab, 2, 5, seed=5)
    jl, jc, jln, jx = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 24,
                                frames=jnp.asarray(fr, jnp.float32))
    tl, tc, ln, tx = prefill(p, cfg, torch.from_numpy(prompt), 24,
                             device="cpu", frames=torch.from_numpy(fr))
    assert tl.dtype == tx.dtype == torch.bfloat16
    _close(tl, jl, 2e-2)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(3):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                               jln + i, cross_kv=jx)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu", cross_kv=tx)
        _close(tl, jl, 2e-2)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_params_from_carries_the_encoder_tree(smoke):
    _, jp, cfg, p = smoke
    for name in ("encoder", "enc_pos", "enc_ln_f", "cross"):
        want = jax.tree.leaves(_np(jp[name]))
        got = jax.tree.leaves(p[name])
        assert len(got) == len(want)
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    want = jax.tree.map(lambda a: a.shape, _np(jp))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == want


def test_init_params_serve_casts_the_encoder_leaf_by_leaf():
    """``init_params(serve=True)`` gives what ``serve_params`` makes of the
    f32 tree: every weight (``enc_pos`` included) in bf16, every norm scale
    in f32."""
    cfg = get_config(ARCH, smoke=True)
    full = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = jax.tree.map(lambda t: t.dtype, serve_params(full, cfg))
    got = init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                      serve=True)
    assert jax.tree.map(lambda t: t.dtype, got) == want
    assert got["enc_pos"].dtype == got["cross"]["attn"]["wq"].dtype \
        == got["encoder"]["ffn"]["w_in"].dtype == torch.bfloat16
    assert got["enc_ln_f"]["scale"].dtype == torch.float32
    assert got["cross"]["ln"]["scale"].dtype == torch.float32
    assert torch.equal(got["enc_pos"], full["enc_pos"].to(torch.bfloat16))


# -- the full-size model ---------------------------------------------------
@pytest.fixture(scope="module")
def full_size():
    """whisper-tiny at its published widths and depth, in f32."""
    return _models(ARCH, seed=11, smoke=False)


def test_full_size_tree_and_weights(full_size):
    jcfg, jp, cfg, p = full_size
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
            cfg.enc_seq) == (4, 4, 384, 6, 6, 64, 1536, 51865, 1500)
    assert cfg.param_count() == jcfg.param_count() == 61_065_984
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    mine = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), mine)
    assert got == want


def test_full_size_prefill_and_decode_match_reference(full_size):
    jcfg, jp, cfg, p = full_size
    fr = _frames(cfg, 1, seed=6)
    prompt = _tokens(cfg.vocab, 1, 4, seed=6)
    jl, jc, jln, jx = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 16,
                                frames=jnp.asarray(fr, jnp.float32))
    tl, tc, ln, tx = prefill(p, cfg, torch.from_numpy(prompt), 16,
                             device="cpu", frames=torch.from_numpy(fr))
    _close(tl, jl, 1e-4)
    _close(tx, jx, 1e-4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(3):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                               jln + i, cross_kv=jx)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu", cross_kv=tx)
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(torch.argmax(tl, -1).numpy(), tok[:, 0])


# -- forward for the decoder-only families ---------------------------------
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.2-3b",
                                  "mixtral-8x7b", "llama4-maverick-400b-a17b",
                                  "xlstm-350m", "jamba-1.5-large-398b",
                                  "minicpm3-4b"])
def test_forward_matches_reference_decoder_only(arch):
    """Dense, MoE (the aux loss too), xLSTM, Jamba and MiniCPM3 (MLA's
    cacheless branch): the port's teacher-forced forward against the
    reference's hidden states."""
    jcfg, jp, cfg, p = _models(arch, seed=2)
    tokens = _tokens(cfg.vocab, 2, 24, seed=8)
    jh, jaux = JT.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    th, taux = forward(p, cfg, torch.from_numpy(tokens), device="cpu")
    assert th.shape == (2, 24, cfg.d_model)
    _close(th, jh, 1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    if cfg.n_experts:
        assert float(taux) > 0


# -- refusals --------------------------------------------------------------
def test_engine_launcher_and_greedy_refuse_encdec(smoke):
    _, _, cfg, p = smoke
    with pytest.raises(NotImplementedError, match="prefill.*frames"):
        ServeEngine(p, cfg, n_lanes=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    prompt = torch.from_numpy(_tokens(cfg.vocab, 1, 4))
    with pytest.raises(NotImplementedError, match="greedy_generate.*frames"):
        greedy_generate(p, cfg, prompt, 2, 8, device="cpu")


def test_frames_and_cross_kv_required_and_refused(smoke):
    _, _, cfg, p = smoke
    prompt = torch.from_numpy(_tokens(cfg.vocab, 1, 4))
    with pytest.raises(ValueError, match="encoder-decoder.*frames"):
        prefill(p, cfg, prompt, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder.*frames"):
        forward(p, cfg, prompt, device="cpu")
    _, caches, ln, _ = prefill(p, cfg, prompt, 8, device="cpu",
                               frames=_frames(cfg, 1))
    with pytest.raises(ValueError, match="cross_kv"):
        decode_step(p, cfg, prompt[:, :1], caches, ln, device="cpu")
    q = get_config("qwen1.5-0.5b", smoke=True)
    qp = init_params(torch.Generator().manual_seed(0), q, device="cpu")
    fr = torch.zeros(1, 8, q.d_model)
    with pytest.raises(ValueError, match="no encoder"):
        prefill(qp, q, prompt % q.vocab, 8, device="cpu", frames=fr)
    with pytest.raises(ValueError, match="no encoder"):
        forward(qp, q, prompt % q.vocab, frames=fr, device="cpu")
    _, qc, qln = prefill(qp, q, prompt % q.vocab, 8, device="cpu")
    with pytest.raises(ValueError, match="no encoder"):
        decode_step(qp, q, prompt[:, :1] % q.vocab, qc, qln, device="cpu",
                    cross_kv=fr)


def test_entry_points_need_a_card_unless_cpu(smoke, monkeypatch):
    _, _, cfg, p = smoke
    prompt = torch.from_numpy(_tokens(cfg.vocab, 1, 4))
    fr = torch.from_numpy(_frames(cfg, 1))
    _, caches, ln, cross = prefill(p, cfg, prompt, 8, device="cpu",
                                   frames=fr)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefill(p, cfg, prompt, 8, frames=fr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_step(p, cfg, prompt[:, :1], caches, ln, cross_kv=cross)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forward(p, cfg, prompt, frames=fr)
    decode_step(p, cfg, prompt[:, :1], caches, ln, device="cpu",
                cross_kv=cross)
