"""The port's Mixtral (``repro_torch.models`` and ``repro_torch.serve``)
against the reference's (``repro.models``, ``repro.serve``) on the smoke
mixtral config (2 layers, d_model 64, 4 / 2 heads of 16, MoE FFNs of 4
experts top-2 on every layer, sliding window 32), on the same weights
carried across by ``repro_torch.convert.params_from``, on the CPU, in f32.

The window acts wherever a decode step's length reaches 32: the prompts
here are 40-60 tokens long, the engine's lanes run past their cache and,
idle, past it by more than the window (nothing visible).

Bars: the windowed decode mask equal to the reference's; a layer within
2e-5; prefill and decode logits within 1e-4 of the largest logit, greedy
and engine tokens equal, every MoE layer's expert choices equal to the
reference's top-k on the same router logits.  The served one-card cut is
checked for its widths, its cut and its weight count.
"""
import ast

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
from repro_torch.configs import mixtral_8x7b as mixtral_cfg
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "mixtral-8x7b"
TOL = 1e-4


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


@pytest.fixture
def routes(monkeypatch):
    """Every call of the port's router: (its f32 logits, the experts it
    chose)."""
    seen = []
    real = MOE.route

    def rec(logits, cfg):
        out = real(logits, cfg)
        seen.append((logits, out[2]))
        return out

    monkeypatch.setattr(MOE, "route", rec)
    return seen


def _assert_reference_routing(seen, k):
    assert seen
    for logits, idx in seen:
        probs = jax.nn.softmax(_j(logits.numpy()), axis=-1)
        _, want = jax.lax.top_k(probs, k)
        if not np.array_equal(idx.numpy(), np.asarray(want)):
            top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
            gap = float((top[..., k - 1] - top[..., k]).min())
            pytest.fail(f"router flip: a top-{k} choice differs; the "
                        f"closest decision had a probability gap of "
                        f"{gap:.3e}")


# -- the windowed decode mask --------------------------------------------------
S, W = 48, 16


@pytest.mark.parametrize("length", [-1, 0, 5, W - 1, W, W + 1, 40, S - 1, S,
                                    S + 3, S + W - 2, S + W - 1, S + 100])
@pytest.mark.parametrize("window", [1, W, S, S + 5])
def test_decode_ref_window_matches_chunked_attention(length, window):
    """One lane at a time: the plain decode version with a window against
    the reference's ``chunked_attention(..., causal=True, window=W,
    q_offset=length)`` over the whole cache; lengths below, at and past the
    window, at and past S, and ``length - W + 1 >= S`` (nothing visible: 0
    from both)."""
    rng = np.random.default_rng(length + 3 * window + 100)
    h, kv, dh = 4, 2, 16
    q = rng.standard_normal((1, 1, h, dh), dtype=np.float32)
    k = rng.standard_normal((1, S, kv, dh), dtype=np.float32)
    v = rng.standard_normal((1, S, kv, dh), dtype=np.float32)
    want = JL.chunked_attention(_j(q), _j(k), _j(v), causal=True,
                                window=window, q_offset=jnp.int32(length))
    got = decode_attention_ref(_t(q), _t(k), _t(v), length, window)
    _close(got, want, 2e-6)
    if length - window + 1 >= S or length < 0:
        assert not got.any()


def test_decode_ref_window_per_lane_equals_one_lane_at_a_time():
    """A (B,) length vector with a window gives each lane what it gets
    alone, the reference engine's vmap over lanes (within 1e-6: the batched
    products sum in another order)."""
    rng = np.random.default_rng(11)
    lens = [-1, 3, W, 30, S - 1, S + 7, S + W + 4]
    b = len(lens)
    q = _t(rng.standard_normal((b, 1, 8, 16), dtype=np.float32))
    k = _t(rng.standard_normal((b, S, 2, 16), dtype=np.float32))
    v = _t(rng.standard_normal((b, S, 2, 16), dtype=np.float32))
    got = decode_attention_ref(q, k, v, torch.tensor(lens, dtype=torch.int32),
                               W)
    for i, ln in enumerate(lens):
        one = decode_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], ln, W)
        _close(got[i:i + 1], one.numpy(), 1e-6)
    # on the CPU the wrapper is the plain version
    assert torch.equal(decode_ops.decode_attn(q, k, v, torch.tensor(lens), W),
                       got)


@pytest.mark.parametrize("batch,kvh,s,window,want", [
    (8, 8, 8192, 4096, 5),        # Mixtral's served decode: 2 x 132 SMs
    (1, 8, 8192, 0, 33),          # no window: capped by S's 256 tiles
    (1, 8, 8192, 4096, 33),       # the window's 128 tiles do not cap it
    (1, 8, 8192, 64, 2),          # ... a 64-key window's 2 tiles do
    (1, 1, 100, 4096, 4),         # S shorter than the window caps it
    (1, 1, 8192, 1, 1),
])
def test_split_plan_caps_by_the_keys_a_lane_sees(batch, kvh, s, window,
                                                  want):
    assert decode_ops.split_plan(batch, kvh, s, 132, window) == want


# -- one attention layer -------------------------------------------------------
@pytest.mark.parametrize("ln", [36, 40, 63, 64, 70, 96])
def test_gqa_decode_step_with_window_matches(model, ln):
    """One windowed decode step of the attention block at cache fill ``ln``
    (window 32, max_len 64: 63 and on write the last slot, 96 sees
    nothing) on a cache filled with random keys, against
    ``JL.gqa_attention``."""
    jcfg, _, cfg, _ = model
    jp = _np(JL.init_gqa(jax.random.PRNGKey(5), jcfg))
    p = {k: _t(v) for k, v in jp.items()}
    b, max_len = 2, 64
    rng = np.random.default_rng(ln)
    ck = rng.standard_normal((b, max_len, cfg.n_kv_heads, cfg.head_dim),
                             dtype=np.float32)
    cv = rng.standard_normal(ck.shape, dtype=np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    pos = np.full((b, 1), ln, np.int32)
    want, (jk, jv, _) = JL.gqa_attention(
        jp, _j(x), jcfg, jnp.asarray(pos, jnp.int32),
        kv_cache=(_j(ck), _j(cv), jnp.int32(ln)))
    got, (tk, tv, n) = L.gqa_attention(p, _t(x), cfg, torch.from_numpy(pos),
                                       kv_cache=(_t(ck), _t(cv), ln))
    assert n == ln + 1
    _close(got, want, 2e-5)
    _close(tk, jk, 2e-5)
    _close(tv, jv, 2e-5)


# -- the model -------------------------------------------------------------------
def test_mixtral_is_ported():
    """The smoke Mixtral builds: the reference's parameter tree (shapes,
    types), cell structure (attention and MoE in every layer) and cache
    layout."""
    cfg, jcfg = get_config(ARCH, smoke=True), j_get_config(ARCH, smoke=True)
    T.check_supported(get_config(ARCH))
    T.check_supported(get_config("mixtral-8x7b-ep2"))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0), jcfg)))
    p = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want
    assert T.cell_structure(cfg) == JT.cell_structure(jcfg) == [
        ("attn", "moe")]
    caches = T.init_cache(cfg, 3, 16, "cpu")
    jcaches = JT.init_cache(jcfg, 3, 16)
    assert [tuple(tuple(t.shape) for t in c) for c in caches] == [
        tuple(tuple(t.shape) for t in c) for c in jcaches]


@pytest.mark.parametrize("s", [40, 51, 60])
def test_prefill_and_decode_past_the_window_match(model, routes, s):
    """Prompts of 40-60 tokens (window 32), then 12 decode steps, B = 2:
    logits at every step and the greedy tokens equal to the reference's."""
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab, 2, s, s)
    max_len = 80
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
    _assert_reference_routing(routes, cfg.top_k)
    want = j_greedy(jp, jcfg, jnp.asarray(prompt, jnp.int32), 13, max_len)
    got = greedy_generate(p, cfg, torch.from_numpy(prompt), 13, max_len,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_matches_reference_engine_past_the_window(model):
    """Both engines on 2 lanes of 80 (window 32): lanes decode past the
    window; one lane serves three requests and then idles while the other
    serves a long one, so the idle lane's length runs past the cache by
    more than the window (it sees nothing).  The same tokens."""
    jcfg, jp, cfg, p = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (45, 5, 33, 70)]
    new = [9, 70, 12, 2]
    jreqs = [JRequest(rid=i, prompt=pr, max_new_tokens=n)
             for i, (pr, n) in enumerate(zip(prompts, new))]
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=n)
            for i, (pr, n) in enumerate(zip(prompts, new))]
    jdone = JServeEngine(jp, jcfg, n_lanes=2, max_len=80).run(jreqs)
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=80, device="cpu")
    seen = []
    step = eng.step

    def watched():
        seen.append(eng._lengths.copy())
        return step()

    eng.step = watched
    done = eng.run(reqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert all(r.done for r in done)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    lens = np.array(seen)
    assert (lens >= cfg.sliding_window).any(axis=1).sum() > 10
    assert (lens - cfg.sliding_window + 1 >= 80).any()


# -- the served cut -------------------------------------------------------------
def test_served_cut_keeps_every_width():
    """The one-card cut: all 32 layers at the published widths, holding
    experts 0-3 of 8, the one cut named in REDUCED; its weights, norms
    included, 24,154,214,400 parameters (the reference's tree with the
    expert axes cut to 4)."""
    full, cfg = mixtral_cfg.FULL, get_config("mixtral-8x7b-ep2")
    assert cfg is mixtral_cfg.SERVED
    for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "n_experts", "top_k", "capacity_factor",
              "sliding_window", "rope_theta", "moe_every", "dtype"):
        assert getattr(cfg, k) == getattr(full, k)
    assert (cfg.n_layers, cfg.sliding_window) == (32, 4096)
    assert (cfg.n_held, cfg.expert_offset, cfg.n_experts) == (4, 0, 8)
    assert set(mixtral_cfg.REDUCED) == {"experts_held"}
    assert cfg.param_count() == 24_153_948_160       # norms not counted
    assert full.param_count() == 46_702_526_464
    shapes = jax.eval_shape(lambda: j_init_params(
        jax.random.PRNGKey(0), j_get_config(ARCH)))
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", None) for k in path]
        n = int(np.prod(leaf.shape))
        if "moe" in keys and "router" not in keys:
            n = n // cfg.n_experts * cfg.n_held
        total += n
    assert total == 24_154_214_400
    assert get_config("mixtral-8x7b-ep2", smoke=True) == get_config(
        ARCH, smoke=True)


def test_params_from_cuts_an_all_moe_share(model):
    """``convert.params_from`` carries every layer's experts across cut to
    the share (experts 1-2 of the smoke's 4), the router whole."""
    _, jp, cfg, _ = model
    c = cfg.replace(experts_held=2, expert_offset=1)
    p = convert.params_from(_np(jp), c)
    jm, m = jp["cells"][0]["moe"], p["cells"][0]["moe"]
    for k in ("w_gate", "w_in", "w_out"):
        assert tuple(m[k].shape[:2]) == (cfg.n_layers, 2)
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k])[:, 1:3])
    np.testing.assert_array_equal(m["router"].numpy(),
                                  np.asarray(jm["router"]))


def test_launcher_serves_mixtral_on_the_cpu(capsys):
    launch_serve.main(["--arch", "mixtral-8x7b-ep2", "--smoke", "--device",
                       "cpu", "--n-requests", "3", "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("req 0: ")
    assert all(len(ast.literal_eval(ln.split("-> ")[1])) == 4 for ln in lines)
