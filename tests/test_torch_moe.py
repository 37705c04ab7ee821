"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU, on the same numpy weights and inputs.

Bars (f32): outputs and the aux loss within 1e-5 (the expert products'
order only), and the same routing: the router is discontinuous, so the
chosen experts and the kept assignments are compared first, and a flip
is reported with the gap between the two probabilities that decided it.
A share of the experts (``experts_held``, ``expert_offset``) adds what its
experts give; the shares of a layer sum to the whole reference layer.
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
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import greedy_generate, init_params
from repro_torch.models import moe as MOE

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def layer():
    """(jax cfg, port cfg, reference weights as numpy) of one smoke MoE
    layer (d 64, ff 128, 4 experts, top-2), f32."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    jp = _np(JMOE.init_moe(jax.random.PRNGKey(0), jcfg))
    # a router 20x the init scale, so that routing is decided, not flat
    jp["router"] = jp["router"] * 20
    return jcfg, cfg, jp


def _share(jp, lo, hi):
    return {"router": _t(jp["router"]),
            **{k: _t(jp[k][lo:hi]) for k in ("w_gate", "w_in", "w_out")}}


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d),
                                                       dtype=np.float32)


def _assert_same_routing(cfg, jcfg, jp, x, per_row=False):
    """The port's routing decisions equal the reference's: on a flip,
    report the gap between the probabilities that decided it."""
    b, s, d = x.shape
    g = b * MOE._num_groups(s) if per_row else MOE._num_groups(b * s)
    logits = _t(x).reshape(g, b * s // g, d) @ _t(jp["router"])
    probs, _, idx, _, keep, _ = MOE.route(logits, cfg)
    jprobs = jax.nn.softmax(_j(logits.numpy()), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, max(jcfg.top_k, 1))
    if not np.array_equal(idx.numpy(), np.asarray(jidx)):
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min())
        pytest.fail(f"router flip: the top-{cfg.top_k} choice differs; the "
                    f"closest decision had a probability gap of {gap:.3e}")
    return keep


@pytest.mark.parametrize("b,s,cf", [(1, 24, 1.25), (3, 16, 1.25),
                                    (2, 40, 0.5)])
def test_moe_ffn_matches_reference(layer, b, s, cf):
    """B = 1 and B > 1 (grouped over B x S, as the reference groups), and
    a capacity factor that drops assignments."""
    jcfg, cfg, jp = layer
    jcfg, cfg = (c.replace(capacity_factor=cf) for c in (jcfg, cfg))
    x = _x(b, s, cfg.d_model, b * s)
    keep = _assert_same_routing(cfg, jcfg, jp, x)
    if cf < 1:
        assert not keep.all()           # some assignments are dropped
    want, want_aux = JMOE.moe_ffn(jax.tree.map(_j, jp),
                                  _j(x), jcfg)
    got, aux = MOE.moe_ffn(_share(jp, 0, 4), _t(x), cfg)
    _close(got, want)
    _close(aux, want_aux)


def test_expert_shares_sum_to_the_whole_layer(layer):
    """Experts 0-1 and 2-3 of the smoke config's 4, each a share holding 2:
    their outputs sum to the whole reference layer's; each share's aux
    loss is the whole layer's (the router is whole)."""
    jcfg, cfg, jp = layer
    x = _x(2, 30, cfg.d_model, 5)
    want, want_aux = JMOE.moe_ffn(jax.tree.map(_j, jp),
                                  _j(x), jcfg)
    parts = []
    for off in (0, 2):
        c = cfg.replace(experts_held=2, expert_offset=off)
        out, aux = MOE.moe_ffn(_share(jp, off, off + 2), _t(x), c)
        _close(aux, want_aux)
        parts.append(out)
    _close(parts[0] + parts[1], want)
    assert float((parts[0] - parts[1]).abs().max()) > 1e-3


def test_per_lane_grouping_matches_the_vmapped_reference(layer):
    """``per_row`` groups each row alone, as the reference engine's vmapped
    one-lane decode does: capacity 1 per expert for one token, nothing
    dropped; grouped over the batch instead, the capacity couples the
    lanes and drops assignments.  Capacity factor 0.5 gives 8 tokens of
    the smoke layer's 4 experts capacity 2, as 8 lanes of Jamba's 16
    experts have capacity 1."""
    jcfg, cfg, jp = layer
    jcfg, cfg = (c.replace(capacity_factor=0.5) for c in (jcfg, cfg))
    x = _x(8, 1, cfg.d_model, 9)
    jparams = jax.tree.map(_j, jp)
    want = jax.vmap(lambda xi: JMOE.moe_ffn(jparams, xi[None], jcfg)[0][0])(
        _j(x))
    _assert_same_routing(cfg, jcfg, jp, x, per_row=True)
    got, _ = MOE.moe_ffn(_share(jp, 0, 4), _t(x), cfg, per_row=True)
    _close(got, want)
    batched, _ = MOE.moe_ffn(_share(jp, 0, 4), _t(x), cfg)
    joint, _ = JMOE.moe_ffn(jparams, _j(x), jcfg)
    _close(batched, joint)
    assert float((batched - got).abs().max()) > 1e-3


def test_init_moe_holds_the_share(layer):
    _, cfg, _ = layer
    c = cfg.replace(experts_held=3, expert_offset=1)
    p = MOE.init_moe(torch.Generator().manual_seed(0), c, torch.float32,
                     store=torch.bfloat16)
    assert tuple(p["router"].shape) == (c.d_model, 4)
    assert p["router"].dtype == torch.float32
    assert tuple(p["w_gate"].shape) == (3, c.d_model, c.d_ff)
    assert tuple(p["w_out"].shape) == (3, c.d_ff, c.d_model)
    assert p["w_in"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="experts"):
        cfg.replace(experts_held=3, expert_offset=2)


def test_params_from_slices_the_share():
    jcfg = j_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True).replace(experts_held=2,
                                               expert_offset=2)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                      jax.eval_shape(lambda: j_init_params(
                          jax.random.PRNGKey(0), jcfg)))
    p = convert.params_from(jp, cfg)
    for j, (jc, tc) in enumerate(zip(jp["cells"], p["cells"])):
        if "moe" in jc:
            assert np.array_equal(tc["moe"]["router"].numpy(),
                                  jc["moe"]["router"])
            for k in ("w_gate", "w_in", "w_out"):
                assert np.array_equal(tc["moe"][k].numpy(),
                                      jc["moe"][k][:, 2:4])
        if "ffn" in jc:
            assert np.array_equal(tc["ffn"]["w_gate"].numpy(),
                                  jc["ffn"]["w_gate"])


def test_llama4_moe_model_greedy_tokens_equal():
    """The MoE family's top-1 routing (Llama-4's smoke config, MoE on every
    layer) through the whole model: greedy tokens equal the reference's in
    f32."""
    arch = "llama4-maverick-400b-a17b"
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    p = convert.params_from(_np(jp), cfg)
    prompt = np.random.default_rng(1).integers(1, cfg.vocab, (2, 7)).astype(
        np.int32)
    want = j_greedy(jp, jcfg, jnp.asarray(prompt, jnp.int32), 6, 24)
    got = greedy_generate(p, cfg, torch.from_numpy(prompt), 6, 24,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert init_params(torch.Generator().manual_seed(0), cfg, "cpu")[
        "cells"][0]["moe"]["w_gate"].shape == (2, 4, 64, 128)
