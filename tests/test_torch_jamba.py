"""The port's Jamba (``repro_torch.models`` and ``repro_torch.serve``)
against the reference's (``repro.models``, ``repro.serve``) on the smoke
jamba config (8 layers in 2 supercells of [mamba, mamba, attn, mamba];
MoE FFNs on the odd layers, 4 experts top-2; d_model 64, d_inner 128,
d_state 16), on the same weights carried across by
``repro_torch.convert.params_from``, on the CPU, in f32.

Bars: prefill and decode logits within 1e-4 of the largest logit, caches
within 1e-4, greedy and engine tokens equal; every MoE layer's expert
choices equal to the reference's top-k on the same router logits (on a
flip the test reports the probability gap that decided it).  Prompts of 1
(the recurrence branch), 5, 40 and 300 tokens (ragged against the
reference's 256-position scan chunk).  The served one-card cut is checked
for its widths, its cuts and its weight count.
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
from repro.models import prefill as j_prefill
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs import jamba_1_5_large as jamba_cfg
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
    serve_params,
)
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(a):
    return jnp.asarray(a, jnp.float32)


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


def _close_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert tuple(a.shape) == tuple(np.shape(b))
            _close(a, b)


def test_jamba_is_ported():
    """The smoke Jamba builds: the reference's parameter tree (shapes,
    types), cell structure and cache layout (Mamba states f32)."""
    cfg, jcfg = get_config(ARCH, smoke=True), j_get_config(ARCH, smoke=True)
    T.check_supported(get_config(ARCH))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0), jcfg)))
    p = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want
    assert T.cell_structure(cfg) == JT.cell_structure(jcfg) == [
        ("mamba", "dense"), ("mamba", "moe"), ("attn", "dense"),
        ("mamba", "moe")]
    _close_caches(T.init_cache(cfg, 3, 16, "cpu"), JT.init_cache(jcfg, 3, 16))


def test_served_cut_keeps_every_width():
    """The one-card cut: one whole supercell at the published widths,
    holding experts 0-7 of 16, each cut named in REDUCED."""
    full, cfg = jamba_cfg.FULL, get_config("jamba-1.5-large")
    assert cfg is jamba_cfg.SERVED and cfg.n_layers == 8
    for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "n_experts", "top_k", "d_state", "d_conv",
              "mamba_expand", "capacity_factor"):
        assert getattr(cfg, k) == getattr(full, k)
    assert (cfg.n_held, cfg.expert_offset, cfg.n_experts) == (8, 0, 16)
    assert set(jamba_cfg.REDUCED) == {"n_layers", "experts_held"}
    assert T.cell_structure(cfg) == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]
    assert cfg.param_count() == 25_793_183_744
    assert full.replace(n_layers=8).param_count() == 45_120_536_576


def test_served_weights_are_cast_leaf_by_leaf():
    """init_params(serve=True) gives serve_params of the f32 draws, bit for
    bit: a_log and the norms stay f32."""
    cfg = get_config(ARCH, smoke=True).replace(experts_held=2,
                                               expert_offset=1)
    want = serve_params(init_params(torch.Generator().manual_seed(4), cfg,
                                    "cpu"), cfg)
    got = init_params(torch.Generator().manual_seed(4), cfg, "cpu",
                      serve=True)
    flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat_w, flat_g))
    assert got["cells"][0]["mamba"]["a_log"].dtype == torch.float32
    assert got["cells"][1]["moe"]["w_in"].dtype == torch.bfloat16
    assert got["cells"][1]["moe"]["w_in"].shape[1] == 2


@pytest.fixture
def routes(monkeypatch):
    """Every call of the port's router, recorded: (its f32 logits, the
    experts it chose)."""
    seen = []
    real = MOE.route

    def rec(logits, cfg):
        out = real(logits, cfg)
        seen.append((logits, out[2]))
        return out

    monkeypatch.setattr(MOE, "route", rec)
    return seen


def _assert_reference_routing(seen, k):
    """The reference's softmax and top-k on the same logits choose the same
    experts."""
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


@pytest.mark.parametrize("s", [9, 300])
def test_prefill_and_decode_logits_and_states_match(model, routes, s):
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab, 2, s, s)
    jl, jc, jln, _ = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 512)
    tl, tc, ln = prefill(p, cfg, torch.from_numpy(prompt), 512, device="cpu")
    assert ln == int(jln) == s
    _close(tl, jl)
    _close_caches(tc, jc)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(3):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                               jln + i)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu")
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    _close_caches(tc, jc)
    _assert_reference_routing(routes, cfg.top_k)


def test_greedy_tokens_equal(model):
    """B = 2: the reference's greedy decode groups both rows' MoE tokens
    together, and so does the port's."""
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab, 2, 7, 1)
    want = j_greedy(jp, jcfg, jnp.asarray(prompt, jnp.int32), 8, 24)
    got = greedy_generate(p, cfg, torch.from_numpy(prompt), 8, 24,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_matches_reference_engine(model):
    """Prompts of 1, 5, 40 and 300 tokens through both engines on 2 lanes
    (each lane's MoE routed alone, as the reference's vmapped decode
    routes it): the same tokens."""
    jcfg, jp, cfg, p = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (1, 5, 40, 300)]
    new = [5, 3, 6, 4]
    jreqs = [JRequest(rid=i, prompt=pr, max_new_tokens=n)
             for i, (pr, n) in enumerate(zip(prompts, new))]
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=n)
            for i, (pr, n) in enumerate(zip(prompts, new))]
    jdone = JServeEngine(jp, jcfg, n_lanes=2, max_len=512).run(jreqs)
    done = ServeEngine(p, cfg, n_lanes=2, max_len=512, device="cpu").run(
        reqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert all(r.done for r in done)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == n for r, n in zip(reqs, new))


def test_launcher_serves_jamba_on_the_cpu(capsys):
    launch_serve.main(["--arch", "jamba-1.5-large", "--smoke", "--device",
                       "cpu", "--n-requests", "3", "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("req 0: ")
    assert all(len(ast.literal_eval(ln.split("-> ")[1])) == 4 for ln in lines)
