"""InternVL2's vision prefix in the port (``repro_torch.models``) against
the reference (``repro.models``) on the same weights, on the CPU: the
``vis_proj`` parameter, ``embed_tokens`` / ``forward`` with
``vision_embeds``, and the text-only prefill and decode the reference's
VLM serves.

Bars: hidden states within 2e-5 in f32 (product and reduction order
only), logits within 1e-4, greedy tokens equal; bf16 hidden states within
2e-2 (the frameworks round bf16 products in different places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import greedy_generate as j_greedy
from repro.models import init_params as j_init_params
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import (forward, greedy_generate, init_params,
                                loss_fn)
from repro_torch.models import transformer as T

ARCH = "internvl2-76b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def vlm():
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, convert.params_from(_np(jp), cfg)


def _inputs(cfg, b=2, s=7, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    vis = rng.standard_normal((b, cfg.n_vision_tokens, cfg.d_model)).astype(
        np.float32)
    return tokens, vis


def test_init_params_draw_vis_proj():
    jcfg, cfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        j_init_params(jax.random.PRNGKey(0), jcfg))
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want
    assert got["vis_proj"] == ((cfg.d_model, cfg.d_model), "float32")


def test_convert_carries_vis_proj(vlm):
    _, jp, _, p = vlm
    np.testing.assert_array_equal(p["vis_proj"].numpy(),
                                  np.asarray(jp["vis_proj"]))


@pytest.mark.parametrize("with_vision", [True, False])
def test_forward_hidden_states_match(vlm, with_vision):
    jcfg, jp, cfg, p = vlm
    tokens, vis = _inputs(cfg)
    ve = vis if with_vision else None
    jh, jaux = JT.forward(jp, jcfg, jnp.asarray(tokens, dtype=jnp.int32),
                          vision_embeds=None if ve is None
                          else jnp.asarray(ve, dtype=jnp.float32))
    h, aux = forward(p, cfg, tokens, device="cpu", vision_embeds=ve)
    s = tokens.shape[1] + (cfg.n_vision_tokens if with_vision else 0)
    assert h.shape == (2, s, cfg.d_model)
    _close(h, jh, 2e-5)
    assert float(aux) == float(jaux) == 0.0
    _close(T.logits_fn(p, cfg, h), JT.logits_fn(jp, jcfg, jh), 1e-4)


def test_embed_tokens_puts_the_projection_first(vlm):
    jcfg, jp, cfg, p = vlm
    tokens, vis = _inputs(cfg, seed=1)
    x = T.embed_tokens(p, cfg, torch.from_numpy(tokens),
                       torch.from_numpy(vis))
    want = JT.embed_tokens(jp, jcfg, jnp.asarray(tokens, dtype=jnp.int32),
                           jnp.asarray(vis, dtype=jnp.float32))
    _close(x, want, 2e-5)
    nv = cfg.n_vision_tokens
    _close(x[:, :nv], vis @ np.asarray(jp["vis_proj"]), 2e-5)
    assert torch.equal(x[:, nv:], p["embed"][torch.from_numpy(tokens)])


def test_bf16_forward_matches():
    jcfg, cfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    p = convert.params_from(_np(jp), cfg)
    tokens, vis = _inputs(cfg, seed=2)
    jh, _ = JT.forward(jp, jcfg, jnp.asarray(tokens, dtype=jnp.int32),
                       vision_embeds=jnp.asarray(vis, dtype=jnp.float32))
    h, _ = forward(p, cfg, tokens, device="cpu", vision_embeds=vis)
    assert h.dtype == torch.bfloat16
    _close(h, jh, 2e-2)


def test_loss_pads_the_vision_labels(vlm):
    """Labels over the prefix are -100: the loss counts the text tokens
    only, so moving a vision embedding moves the loss only through the
    text positions that attend to it."""
    _, _, cfg, p = vlm
    tokens, vis = _inputs(cfg, seed=3)
    batch = {"tokens": tokens, "labels": tokens, "vision_embeds": vis}
    loss, m = loss_fn(p, cfg, batch, device="cpu")
    h, _ = forward(p, cfg, tokens, device="cpu", vision_embeds=vis)
    logits = T.logits_fn(p, cfg, h[:, cfg.n_vision_tokens:]).float()
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab), torch.from_numpy(tokens).long()
        .reshape(-1))
    torch.testing.assert_close(m["ce"], want, rtol=1e-5, atol=1e-6)
    assert float(loss) == pytest.approx(float(m["ce"]))


def test_serving_stays_text_only(vlm):
    """Prefill and decode take no vision prefix, as the reference's: greedy
    tokens equal the reference's on a text prompt."""
    jcfg, jp, cfg, p = vlm
    tokens, _ = _inputs(cfg, s=6, seed=4)
    want = j_greedy(jp, jcfg, jnp.asarray(tokens, dtype=jnp.int32), 5, 16)
    got = greedy_generate(p, cfg, torch.from_numpy(tokens), 5, 16,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vision_embeds_refused_by_other_families():
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens, _ = _inputs(cfg)
    vis = np.zeros((2, 3, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="not a VLM"):
        forward(p, cfg, tokens, device="cpu", vision_embeds=vis)
