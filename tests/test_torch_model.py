"""The port's model stack (``repro_torch.models``) against the reference's
(``repro.models``) on the same weights, carried across by
``repro_torch.convert.params_from``, on the CPU.

Bars: layers within 2e-5 in f32 (product and reduction order only);
prefill / decode logits within 1e-4 and greedy tokens equal under an f32
config; logits within 2e-2 in bf16 (the two frameworks round bf16
products in different places, so bf16 tokens may differ at near-ties and
are not compared).
"""
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
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
    serve_params,
)
from repro_torch.models import layers as L

ARCHS = ["qwen1.5-0.5b", "llama3.2-3b", "yi-9b"]   # MHA with QKV bias; GQA


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, jax params, port cfg, port params) in f32."""
    arch = request.param
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, convert.params_from(_np(jp), cfg)


def _prompt(vocab, b=2, s=9, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(
        np.int32)


# -- layers ----------------------------------------------------------------
def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    _close(L.rms_norm(_t(x), _t(scale)), JL.rms_norm(jnp.asarray(x, jnp.float32), scale),
           2e-5)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (1e4, 5e5):
        _close(L.rope(_t(x), torch.from_numpy(pos), theta),
               JL.rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos, jnp.int32), theta), 2e-5)


def test_ffn_matches():
    p = _np(JL.init_ffn(jax.random.PRNGKey(1), 32, 64))
    x = np.random.default_rng(1).standard_normal((2, 5, 32), dtype=np.float32)
    _close(L.ffn({k: _t(v) for k, v in p.items()}, _t(x)),
           JL.ffn(p, jnp.asarray(x, jnp.float32)), 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_attention_prefill_and_decode_match(arch):
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jp = _np(JL.init_gqa(jax.random.PRNGKey(2), jcfg))
    if jcfg.qkv_bias:   # nonzero biases, so that they are exercised
        rng = np.random.default_rng(2)
        jp = {k: (rng.standard_normal(v.shape, dtype=np.float32) * 0.1
                  if k.startswith("b") else v) for k, v in jp.items()}
    p = {k: _t(v) for k, v in jp.items()}
    b, s, max_len = 2, 6, 16
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    x = np.random.default_rng(3).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    # no cache
    want, _ = JL.gqa_attention(jp, jnp.asarray(x, jnp.float32), jcfg, jnp.asarray(pos, jnp.int32))
    got, _ = L.gqa_attention(p, _t(x), cfg, torch.from_numpy(pos.copy()))
    _close(got, want, 2e-5)
    # prefill into a cache at length 0, then one decode token
    zeros = np.zeros((b, max_len, kvh, hd), np.float32)
    want, (jk, jv, jln) = JL.gqa_attention(
        jp, jnp.asarray(x, jnp.float32), jcfg, jnp.asarray(pos, jnp.int32),
        kv_cache=(jnp.asarray(zeros, jnp.float32), jnp.asarray(zeros, jnp.float32), jnp.int32(0)))
    ck, cv = _t(zeros), _t(zeros)
    got, (ck, cv, ln) = L.gqa_attention(p, _t(x), cfg,
                                        torch.from_numpy(pos.copy()),
                                        kv_cache=(ck, cv, 0))
    _close(got, want, 2e-5)
    _close(ck, jk, 2e-5)
    _close(cv, jv, 2e-5)
    assert ln == s == int(jln)
    x1 = np.random.default_rng(4).standard_normal((b, 1, cfg.d_model),
                                                  dtype=np.float32)
    p1 = np.full((b, 1), s, np.int32)
    want, (jk, _, _) = JL.gqa_attention(jp, jnp.asarray(x1, jnp.float32), jcfg,
                                        jnp.asarray(p1, jnp.int32),
                                        kv_cache=(jk, jv, jln))
    got, (ck, _, _) = L.gqa_attention(p, _t(x1), cfg, torch.from_numpy(p1),
                                      kv_cache=(ck, cv, ln))
    _close(got, want, 2e-5)
    _close(ck, jk, 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_sliding_window_prefill_matches_and_decode_raises(arch):
    """A windowed config: prefill into a cache (the flash path's window)
    equals the reference, and so do decode steps through the decode path's
    window, at lengths whose window hides the first keys (7, 8), reaches
    past the cache (max_len 16 and on: the reference's ``q_offset`` is not
    clamped) and lies wholly past it (18: nothing visible).  The name is
    the test's from before decode took a window."""
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32",
                                                  sliding_window=3)
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               sliding_window=3)
    jp = _np(JL.init_gqa(jax.random.PRNGKey(5), jcfg))
    p = {k: _t(v) for k, v in jp.items()}
    b, s, max_len = 2, 7, 16
    x = np.random.default_rng(6).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    zeros = np.zeros((b, max_len, cfg.n_kv_heads, cfg.head_dim), np.float32)
    want, _ = JL.gqa_attention(
        jp, jnp.asarray(x, jnp.float32), jcfg, jnp.asarray(pos, jnp.int32),
        kv_cache=(jnp.asarray(zeros, jnp.float32),
                  jnp.asarray(zeros, jnp.float32), jnp.int32(0)))
    ck, cv = _t(zeros), _t(zeros)
    got, (ck, cv, ln) = L.gqa_attention(p, _t(x), cfg,
                                        torch.from_numpy(pos.copy()),
                                        kv_cache=(ck, cv, 0))
    _close(got, want, 2e-5)
    jk = jnp.asarray(ck.numpy(), jnp.float32)
    jv = jnp.asarray(cv.numpy(), jnp.float32)
    for i, ln in enumerate((s, s + 1, max_len - 1, max_len, max_len + 2)):
        x1 = np.random.default_rng(7 + i).standard_normal(
            (b, 1, cfg.d_model), dtype=np.float32)
        p1 = np.full((b, 1), ln, np.int32)
        want, (jk, jv, _) = JL.gqa_attention(
            jp, jnp.asarray(x1, jnp.float32), jcfg, jnp.asarray(p1, jnp.int32),
            kv_cache=(jk, jv, jnp.int32(ln)))
        got, (ck, cv, _) = L.gqa_attention(p, _t(x1), cfg,
                                           torch.from_numpy(p1),
                                           kv_cache=(ck, cv, ln))
        _close(got, want, 2e-5)
        _close(ck, jk, 2e-5)


# -- the model -------------------------------------------------------------
def test_prefill_and_decode_logits_match(model):
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab)
    jl, jc, jln, _ = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 32)
    tl, tc, ln = prefill(p, cfg, torch.from_numpy(prompt), 32, device="cpu")
    assert ln == int(jln) == prompt.shape[1]
    _close(tl, jl, 1e-4)
    for (k, v), (jk, jv) in zip(tc, jc):
        _close(k, jk, 1e-4)
        _close(v, jv, 1e-4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(4):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc, jln + i)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu")
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_greedy_tokens_equal(model):
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab, b=2, s=7, seed=1)
    want = j_greedy(jp, jcfg, jnp.asarray(prompt, jnp.int32), 8, 24)
    got = greedy_generate(p, cfg, torch.from_numpy(prompt), 8, 24,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match(arch):
    jcfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    assert cfg.dtype == "bfloat16"
    jp = j_init_params(jax.random.PRNGKey(3), jcfg)
    p = convert.params_from(_np(jp), cfg)
    prompt = _prompt(cfg.vocab, seed=2)
    jl, jc, jln, _ = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 32)
    tl, tc, ln = prefill(p, cfg, torch.from_numpy(prompt), 32, device="cpu")
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, 2e-2)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(3):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc, jln + i)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu")
        _close(tl, jl, 2e-2)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_per_lane_lengths_equal_one_lane_at_a_time(model):
    """A (B,) length vector decodes each lane as a scalar length would."""
    _, _, cfg, p = model
    prompt = _prompt(cfg.vocab, b=2, s=5, seed=3)
    _, caches, ln = prefill(p, cfg, torch.from_numpy(prompt), 16,
                            device="cpu")
    lens = torch.tensor([ln, ln + 3], dtype=torch.int32)
    tok = torch.tensor([[3], [4]])
    both, _ = decode_step(p, cfg, tok, [(k.clone(), v.clone())
                                        for k, v in caches], lens,
                          device="cpu")
    for i in range(2):
        one = [(k[:, i:i + 1].clone(), v[:, i:i + 1].clone())
               for k, v in caches]
        want, _ = decode_step(p, cfg, tok[i:i + 1], one, int(lens[i]),
                              device="cpu")
        _close(both[i:i + 1], want.numpy(), 1e-5)


def test_serve_params_give_the_same_logits():
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sp = serve_params(p, cfg)
    assert sp["cells"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert sp["embed"].dtype == torch.bfloat16
    assert sp["cells"][0]["ln1"]["scale"].dtype == torch.float32
    prompt = torch.from_numpy(_prompt(cfg.vocab, seed=4))
    a, _, _ = prefill(p, cfg, prompt, 16, device="cpu")
    b, _, _ = prefill(sp, cfg, prompt, 16, device="cpu")
    assert torch.equal(a, b)
    # xLSTM: the blocks' "norm" vectors and the sLSTM's gate weights, which
    # its recurrence reads in f32, stay f32; prefill and a decode step give
    # the same logits
    cfg = get_config("xlstm-350m", smoke=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sp = serve_params(p, cfg)
    ml, sl = sp["cells"][0]["mlstm"], sp["cells"][1]["slstm"]
    assert ml["wq"].dtype == sl["up"].dtype == torch.bfloat16
    assert ml["norm"].dtype == sl["norm"].dtype == torch.float32
    assert sl["w_gates"].dtype == sl["r_gates"].dtype == torch.float32
    prompt = torch.from_numpy(_prompt(cfg.vocab, seed=5))
    outs = []
    for params in (p, sp):
        lg, caches, ln = prefill(params, cfg, prompt, 16, device="cpu")
        lg2, _ = decode_step(params, cfg, prompt[:, :1], caches, ln,
                             device="cpu")
        outs.append((lg, lg2))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_init_params_tree_and_distribution():
    for arch in ARCHS + ["whisper-tiny"]:
        jcfg = j_get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            j_init_params(jax.random.PRNGKey(0), jcfg))
        p = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).replace("torch.", "")),
                           p)
        assert got == want
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    w = init_params(torch.Generator().manual_seed(2), cfg,
                    device="cpu")["embed"]
    assert float(w.abs().max()) <= 2 * 0.02 / 0.87962566 + 1e-6
    assert abs(float(w.std()) - 0.02) < 1e-3
    again = init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    assert torch.equal(again["embed"], w)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.from_numpy(_prompt(cfg.vocab, b=1, s=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefill(p, cfg, prompt, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator(), cfg)
    _, caches, ln = prefill(p, cfg, prompt, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_step(p, cfg, prompt[:, :1], caches, ln)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(p, cfg, prompt, 2, 8)
    decode_step(p, cfg, prompt[:, :1], caches, ln, device="cpu")
