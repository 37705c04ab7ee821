"""The port's xLSTM (``repro_torch.models`` and ``repro_torch.serve``)
against the reference's (``repro.models``, ``repro.serve``) on the smoke
xlstm-350m config (8 layers: sLSTM at 1 and 5, mLSTM elsewhere; d_model 64,
4 heads of dim 32), on the same weights carried across by
``repro_torch.convert.params_from``, on the CPU.

Bars: prefill and decode logits within 1e-4 and greedy and engine tokens
equal under an f32 config, recurrent states within 1e-4; logits within
2e-2 in bf16 (the two frameworks round bf16 products in different places).
Prompts of 1 (the recurrence branch), 5, 40 and 300 tokens (the
chunkwise branch, padded to 512 by the reference).
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
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (
    decode_step,
    greedy_generate,
    init_params,
    prefill,
)
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "xlstm-350m"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) in f32."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, convert.params_from(_np(jp), cfg)


def _prompt(vocab, b=2, s=9, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(
        np.int32)


def _close_caches(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert tuple(a.shape) == tuple(np.shape(b))
            _close(a, b, tol)


def test_xlstm_is_ported():
    """xlstm-350m builds: the reference's parameter tree (shapes, types),
    its cache layout (recurrent states, f32, m at -1e9) and values."""
    cfg, jcfg = get_config(ARCH, smoke=True), j_get_config(ARCH, smoke=True)
    T.check_supported(get_config(ARCH))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        j_init_params(jax.random.PRNGKey(0), jcfg))
    p = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want
    assert [k for k, _ in T.cell_structure(cfg)] == \
        [k for k, _ in JT.cell_structure(jcfg)] == \
        ["mlstm", "slstm", "mlstm", "mlstm"]
    _close_caches(T.init_cache(cfg, 3, 16, "cpu"), JT.init_cache(jcfg, 3, 16),
                  0.0)


def test_prefill_and_decode_logits_and_states_match(model):
    jcfg, jp, cfg, p = model
    for s in (9, 300):
        prompt = _prompt(cfg.vocab, s=s, seed=s)
        jl, jc, jln, _ = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32),
                                   512)
        tl, tc, ln = prefill(p, cfg, torch.from_numpy(prompt), 512,
                             device="cpu")
        assert ln == int(jln) == s
        _close(tl, jl, 1e-4)
        _close_caches(tc, jc, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        for i in range(4):
            jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                                   jln + i)
            tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                                 device="cpu")
            _close(tl, jl, 1e-4)
            tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        _close_caches(tc, jc, 1e-4)


def test_greedy_tokens_equal(model):
    jcfg, jp, cfg, p = model
    prompt = _prompt(cfg.vocab, b=2, s=7, seed=1)
    want = j_greedy(jp, jcfg, jnp.asarray(prompt, jnp.int32), 8, 24)
    got = greedy_generate(p, cfg, torch.from_numpy(prompt), 8, 24,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_matches_reference_engine(model):
    """Prompts of 1, 5, 40 and 300 tokens through both engines on 2 lanes:
    the same tokens."""
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


def test_bf16_logits_match():
    jcfg = j_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    assert cfg.dtype == "bfloat16"
    jp = j_init_params(jax.random.PRNGKey(3), jcfg)
    p = convert.params_from(_np(jp), cfg)
    prompt = _prompt(cfg.vocab, s=40, seed=2)
    jl, jc, jln, _ = j_prefill(jp, jcfg, jnp.asarray(prompt, jnp.int32), 64)
    tl, tc, ln = prefill(p, cfg, torch.from_numpy(prompt), 64, device="cpu")
    assert tl.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for c in tc for t in c)
    _close(tl, jl, 2e-2)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for i in range(3):
        jl, jc = j_decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc,
                               jln + i)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, ln + i,
                             device="cpu")
        _close(tl, jl, 2e-2)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_launcher_serves_xlstm_on_the_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--n-requests", "3", "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("req 0: ")
    assert all(len(ast.literal_eval(ln.split("-> ")[1])) == 4 for ln in lines)
