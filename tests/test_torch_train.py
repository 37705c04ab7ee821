"""The port's training path (``repro_torch.train``, ``models.loss_fn``,
``transformer.chunked_softmax_xent``) against the reference's on the CPU,
on the same weights (carried across by ``repro_torch.convert``) and the
same batches (``SyntheticLM``, bit-equal in both packages).

Bars: AdamW, the cosine schedule, the clip and the global norm rtol 1e-6;
int8 compression's q bits equal and its scales and error rtol 1e-6;
``chunked_softmax_xent`` and ``loss_fn`` values rtol 1e-5 and every
gradient leaf within 1e-4 of its largest magnitude (f32 smoke configs:
product and reduction order only); three ``make_train_step`` steps'
parameters rtol 1e-5 norm-wise per leaf (see
``test_train_steps_match_reference``).  Then ``tests/test_train.py``'s trainer cases
mirrored on the port alone (its weights come from a torch generator).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.ckpt.checkpoint import _flatten as j_flatten
from repro.configs import get_config as j_get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import transformer as JT
from repro.train import AdamW as JAdamW
from repro.train import cosine_schedule as j_cosine
from repro.train import global_norm as j_global_norm
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro.train import compression as JC
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params, loss_fn
from repro_torch.models import transformer as T
from repro_torch.train import (AdamW, InjectedFailure, StragglerMonitor,
                               Trainer, compression, cosine_schedule,
                               global_norm, init_state, make_train_step)
from repro_torch.tree import flatten_with_keys, leaves, tree_map

LOSS_ARCHS = ["qwen1.5-0.5b", "llama3.2-3b", "mixtral-8x7b", "whisper-tiny",
              "internvl2-76b", "xlstm-350m", "jamba-1.5-large-398b",
              "minicpm3-4b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_np(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# -- optimizer, schedule, norm, compression ---------------------------------
SHAPES = {"w": (4, 3), "b": (5,), "s": (2, 3, 2)}


def test_cosine_schedule_matches_reference():
    fn, jfn = cosine_schedule(3e-4, 10, 100), j_cosine(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 130):
        np.testing.assert_allclose(float(fn(step)), float(jfn(step)),
                                   rtol=1e-6, atol=0)
    sched = cosine_schedule(1.0, warmup=10, total=100)
    assert float(sched(0)) == 0.0
    assert float(sched(10)) == pytest.approx(1.0, abs=0.01)
    assert float(sched(100)) == pytest.approx(0.0, abs=0.01)
    assert float(sched(55)) < float(sched(20))


def test_global_norm_matches_reference():
    t = _tree_np(np.random.default_rng(0), SHAPES)
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(v) for k, v in t.items()})),
        float(j_global_norm({k: jnp.asarray(v, dtype=jnp.float32)
                             for k, v in t.items()})),
        rtol=1e-6)


@pytest.mark.parametrize("clip,lr", [(1.0, None), (0.0, 0.05), (1e3, None)])
def test_adamw_matches_reference(clip, lr):
    """Three steps of AdamW (decay on matrices, the clip, the schedule)
    from the same parameters and gradients."""
    rng = np.random.default_rng(1)
    p0 = _tree_np(rng, SHAPES)
    grads = [_tree_np(rng, SHAPES) for _ in range(3)]
    sched = lr if lr is not None else cosine_schedule(1e-2, 1, 10)
    jsched = lr if lr is not None else j_cosine(1e-2, 1, 10)
    opt = AdamW(lr=sched, grad_clip=clip)
    jopt = JAdamW(lr=jsched, grad_clip=clip)
    p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jp = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in p0.items()}
    st, jst = opt.init(p), jopt.init(jp)
    for g in grads:
        p, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                           st, p)
        jp, jst = jopt.update({k: jnp.asarray(v, dtype=jnp.float32)
                               for k, v in g.items()}, jst, jp)
    assert int(st.step) == int(jst.step) == 3
    for got, want in ((p, jp), (st.mu, jst.mu), (st.nu, jst.nu)):
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-9)


def test_adamw_keeps_dtype_and_decays_every_matrix():
    """bf16 parameters stay bf16; a stacked (R, d) norm scale (ndim 2) is
    decayed as the reference decays it, a (d,) vector is not."""
    p = {"scale": torch.ones(2, 3), "vec": torch.ones(3),
         "w": torch.ones(3, 3, dtype=torch.bfloat16)}
    opt = AdamW(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    st = opt.init(p)
    assert all(m.dtype == torch.float32 for m in leaves(st.mu))
    zero = tree_map(torch.zeros_like, p)
    p, st = opt.update(zero, st, p)
    assert p["w"].dtype == torch.bfloat16
    assert float(p["scale"][0, 0]) == pytest.approx(1 - 0.1 * 0.5)
    assert float(p["vec"][0]) == 1.0


def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip():
    opt = AdamW(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, state = opt.update({"w": torch.full((4,), 100.0)}, state, params)
    assert float(global_norm(state.mu)) <= (1 - opt.b1) * 1.0 + 1e-5


def test_int8_compression_matches_reference():
    rng = np.random.default_rng(2)
    gs = [_tree_np(rng, SHAPES) for _ in range(3)]
    err = compression.init_error({k: torch.zeros(s) for k, s in
                                  SHAPES.items()})
    jerr = JC.init_error({k: jnp.zeros(s, jnp.float32)
                          for k, s in SHAPES.items()})
    for g in gs:
        (q, s), err = compression.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, err)
        (jq, js), jerr = JC.compress_grads(
            {k: jnp.asarray(v, dtype=jnp.float32) for k, v in g.items()},
            jerr)
        for k in SHAPES:
            assert q[k].dtype == torch.int8
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_allclose(float(s[k]), float(js[k]), rtol=1e-6)
            np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]),
                                       rtol=1e-6, atol=1e-9)
        deq = compression.decompress_grads((q, s))
        jdeq = JC.decompress_grads((jq, js))
        for k in SHAPES:
            np.testing.assert_allclose(deq[k].numpy(), np.asarray(jdeq[k]),
                                       rtol=1e-6)


def test_int8_roundtrip_error_feedback():
    rng = np.random.default_rng(0)
    g = {"a": torch.from_numpy(rng.standard_normal(64).astype(np.float32))}
    err = compression.init_error(g)
    qs, _ = compression.compress_grads(g, err)
    deq = compression.decompress_grads(qs)
    _, s = compression.quantize_int8(g["a"])
    assert float((deq["a"] - g["a"]).abs().max()) <= float(s) + 1e-6
    acc = torch.zeros_like(g["a"])
    err = compression.init_error(g)
    for _ in range(50):
        qs, err = compression.compress_grads(g, err)
        acc = acc + compression.decompress_grads(qs)["a"]
    np.testing.assert_allclose((acc / 50).numpy(), g["a"].numpy(), atol=2e-2)


# -- the loss -----------------------------------------------------------------
def _pair(arch, seed=0):
    """(jax cfg, jax params, port cfg, port params) of a smoke config in
    f32."""
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, convert.params_from(_np(jp), cfg)


def _batch(cfg, b=2, s=20, step=0, masked=True):
    batch = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=1,
        family=cfg.family, n_vision_tokens=cfg.n_vision_tokens,
        d_model=cfg.d_model, enc_seq=cfg.enc_seq)).batch_at(step)
    if masked:
        batch["labels"][0, :3] = -100
    return batch


def test_chunked_softmax_xent_matches_reference():
    """Masked labels, S not a multiple of the chunk, and its gradient in h
    and the unembedding."""
    jcfg, jp, cfg, p = _pair("qwen1.5-0.5b")
    rng = np.random.default_rng(3)
    b, s = 2, 37
    h = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    for chunk in (8, 512):
        jfn = lambda hh, w: JT.chunked_softmax_xent(  # noqa: E731
            {**jp, "unembed": w}, jcfg, hh,
            jnp.asarray(labels, dtype=jnp.int32),
            jnp.asarray(mask, dtype=jnp.float32), chunk=chunk)
        want, (jgh, jgw) = jax.value_and_grad(jfn, argnums=(0, 1))(
            jnp.asarray(h, dtype=jnp.float32), jp["unembed"])
        ht = torch.from_numpy(h).requires_grad_()
        wt = p["unembed"].clone().requires_grad_()
        got = T.chunked_softmax_xent({**p, "unembed": wt}, cfg, ht,
                                     torch.from_numpy(labels).long(),
                                     torch.from_numpy(mask), chunk=chunk)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        gh, gw = torch.autograd.grad(got, (ht, wt))
        for g, w in ((gh, jgh), (gw, jgw)):
            w = np.asarray(w)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_value_and_gradients_match_reference(arch):
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(repro loss_fn)``: dense (QKV bias; GQA), MoE (its
    aux loss), Whisper (frames), InternVL2 (the vision prefix), xLSTM and
    Jamba (their kernels' plain versions on the CPU), MiniCPM3 (MLA's
    cacheless branch: q/k 24 and v 16 wide through ``FlashAttention``)."""
    jcfg, jp, cfg, p = _pair(arch)
    _loss_and_grads_match(jcfg, jp, cfg, p, _batch(cfg))


def _loss_and_grads_match(jcfg, jp, cfg, p, batch, zero=()):
    """``loss_fn``'s value (rtol 1e-5) and every gradient leaf (within 1e-4
    of its largest magnitude) against the reference's on ``batch``.  The
    leaves named in ``zero`` have gradient 0 in exact arithmetic (the
    reference's is 0): the port's rounding noise there is held within 1e-4
    of the largest gradient of any leaf."""
    (jl, jm), jg = jax.value_and_grad(
        lambda pp: j_loss_fn(pp, jcfg, {k: jnp.asarray(v, dtype=v.dtype)
                                        for k, v in batch.items()}),
        has_aux=True)(jp)
    pt = tree_map(lambda t: t.requires_grad_(), p)
    loss, metrics = loss_fn(pt, cfg, batch, device="cpu")
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["aux"].item(), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    if cfg.n_experts:
        assert metrics["aux"].item() > 0
    flat = leaves(pt)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    got = {k: (torch.zeros_like(t) if g is None else g)
           for (k, t), g in zip(flatten_with_keys(pt), grads)}
    want = j_flatten(jg)
    assert sorted(got) == sorted(want)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for key, g in got.items():
        w = want[key]
        scale = max(float(np.abs(w).max()), 1e-30)
        if key in zero:
            assert not np.any(w), key
            scale = largest
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, key


def test_whisper_one_token_loss_takes_the_flash_path(monkeypatch):
    """A Whisper loss over one token: its cross-attention has one query,
    which under grad goes through ``flash_ops.attention`` (the path with a
    backward), never the decode wrapper; value and gradients match the
    reference's, and the cross projections and the encoder get one.  The
    self-attention's one key takes all the weight, so its ``wq`` and ``wk``
    have no gradient."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    jcfg, jp, cfg, p = _pair("whisper-tiny")
    batch = _batch(cfg, s=1, masked=False)
    calls = []
    attention = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention", lambda q, *a, **k: (
        calls.append(q.shape[1]), attention(q, *a, **k))[1])

    def refuse(*args, **kwargs):
        raise AssertionError("decode_attn called under grad")

    monkeypatch.setattr(decode_ops, "decode_attn", refuse)
    _loss_and_grads_match(jcfg, jp, cfg, p, batch,
                          zero=("cells/[0]/attn/wq", "cells/[0]/attn/wk"))
    # self- and cross-attention of each layer, again where remat recomputes
    assert calls.count(1) == 2 * cfg.n_layers * (1 + (cfg.remat == "block"))
    pt = tree_map(lambda t: t.detach().requires_grad_(), p)
    loss, _ = loss_fn(pt, cfg, batch, device="cpu")
    grads = dict(zip((k for k, _ in flatten_with_keys(pt)),
                     torch.autograd.grad(loss, leaves(pt))))
    for key in ("cross/attn/wq", "cross/attn/wk", "cross/attn/wv",
                "encoder/attn/wq", "enc_pos"):
        assert any(key in k and float(g.abs().max()) > 0
                   for k, g in grads.items()), key


def test_remat_does_not_change_the_gradients():
    _, _, cfg, p = _pair("mixtral-8x7b")
    batch = _batch(cfg)
    out = []
    for remat in ("block", "none"):
        pt = tree_map(lambda t: t.detach().clone().requires_grad_(), p)
        loss, _ = loss_fn(pt, cfg.replace(remat=remat), batch, device="cpu")
        out.append((loss, torch.autograd.grad(loss, leaves(pt))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# -- the train step -------------------------------------------------------
@pytest.mark.parametrize("variant", [
    {}, {"microbatches": 2}, {"grad_wire_dtype": "bfloat16"},
    {"grad_compression": True}])
def test_train_steps_match_reference(variant):
    """Three ``make_train_step`` steps from the same weights on the same
    batches: the loss (rtol 1e-5) and grad norm (rtol 1e-5) each step, and
    each parameter leaf after, norm-wise: ``|p - p_ref| <= 1e-5 |p_ref|``.
    Elementwise rtol cannot hold under Adam: an element whose gradient is
    as small as the two packages' rounding differences gets a normalised
    step of either sign.  ``bk`` is all such elements: adding it shifts
    every key's score by the same ``q . bk``, which the softmax ignores, so
    its gradient is 0 in exact arithmetic and rounding noise in both
    packages; from its 0 init it can only be held to Adam's bound, ``lr``
    a step."""
    jcfg, jp, cfg, p = _pair("qwen1.5-0.5b", seed=1)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, **variant)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstep = jax.jit(j_make_train_step(jcfg, jtc))
    step = make_train_step(cfg, tc, device="cpu")
    js, st = j_init_state(jp, jtc), init_state(p, tc)
    for i in range(3):
        batch = _batch(cfg, b=4, s=16, step=i, masked=False)
        js, jm = jstep(js, {k: jnp.asarray(v, dtype=v.dtype)
                            for k, v in batch.items()})
        st, m = step(st, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(st.opt.step) == 3
    want = j_flatten(js.params)
    for key, leaf in flatten_with_keys(st.params):
        got, w = leaf.numpy(), want[key]
        if key.endswith("attn/bk"):
            assert np.abs(got).max() <= 3 * kw["lr"] * (1 + 1e-6)
            assert np.abs(w).max() <= 3 * kw["lr"] * (1 + 1e-6)
            continue
        assert np.linalg.norm(got - w) <= 1e-5 * np.linalg.norm(w), key


def test_minicpm3_train_steps_match_reference():
    """Three ``make_train_step`` steps of the smoke MiniCPM3 (MLA's
    cacheless branch under grad) from the same weights on the same
    batches: the loss and grad norm each step (rtol 1e-5), and each
    parameter leaf after within 1e-5 of the reference's norm-wise (see
    :func:`test_train_steps_match_reference`)."""
    jcfg, jp, cfg, p = _pair("minicpm3-4b", seed=1)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstep = jax.jit(j_make_train_step(jcfg, jtc))
    step = make_train_step(cfg, tc, device="cpu")
    js, st = j_init_state(jp, jtc), init_state(p, tc)
    for i in range(3):
        batch = _batch(cfg, b=4, s=16, step=i, masked=False)
        js, jm = jstep(js, {k: jnp.asarray(v, dtype=v.dtype)
                            for k, v in batch.items()})
        st, m = step(st, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(st.opt.step) == 3
    want = j_flatten(js.params)
    for key, leaf in flatten_with_keys(st.params):
        w = want[key]
        assert np.linalg.norm(leaf.numpy() - w) <= 1e-5 * np.linalg.norm(w), \
            key


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_recurrent_train_steps_match_reference(arch):
    """Three ``make_train_step`` steps of the smoke xLSTM (mLSTM and sLSTM
    blocks) and the smoke Jamba (Mamba, attention and MoE layers) from the
    same weights on the same batches, the mLSTM's and the scan's gradients
    through their ``MLSTM`` / ``SelectiveScan`` Functions (the plain
    backward on the CPU): the loss and grad norm each step (rtol 1e-5), and
    each parameter leaf after within 1e-5 of the reference's norm-wise (see
    :func:`test_train_steps_match_reference`)."""
    jcfg, jp, cfg, p = _pair(arch, seed=1)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstep = jax.jit(j_make_train_step(jcfg, jtc))
    step = make_train_step(cfg, tc, device="cpu")
    js, st = j_init_state(jp, jtc), init_state(p, tc)
    for i in range(3):
        batch = _batch(cfg, b=2, s=16, step=i, masked=False)
        js, jm = jstep(js, {k: jnp.asarray(v, dtype=v.dtype)
                            for k, v in batch.items()})
        st, m = step(st, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(st.opt.step) == 3
    want = j_flatten(js.params)
    for key, leaf in flatten_with_keys(st.params):
        w = want[key]
        assert np.linalg.norm(leaf.numpy() - w) <= 1e-5 * np.linalg.norm(w), \
            key


# -- the trainer (tests/test_train.py's cases) -----------------------------
def test_straggler_monitor():
    mon = StragglerMonitor(n_hosts=4, threshold=1.5)
    for step in range(10):
        slow = mon.record(step, np.array([1.0, 1.0, 1.0, 3.0]))
    assert slow == [3]
    assert mon.flags


@pytest.fixture
def tiny_train(tmp_path):
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    tc = TrainConfig(total_steps=6, warmup_steps=2, ckpt_every=2,
                     ckpt_dir=str(tmp_path / "ck"), lr=1e-3, seed=0)
    return cfg, tc


def test_train_loop_loss_decreases(tiny_train):
    cfg, tc = tiny_train
    out = Trainer(cfg, tc, device="cpu").run(steps=6)
    assert len(out["losses"]) == 6 == len(out["step_seconds"])
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]


def test_checkpoint_restart_resumes_exactly(tiny_train, tmp_path):
    cfg, tc = tiny_train
    tc_a = dataclasses.replace(tc, ckpt_dir=str(tmp_path / "a"))
    full = Trainer(cfg, tc_a, device="cpu").run(steps=6)
    tc_b = dataclasses.replace(tc, ckpt_dir=str(tmp_path / "b"))
    with pytest.raises(InjectedFailure):
        Trainer(cfg, tc_b, fail_at_step=4, device="cpu").run(steps=6)
    resumed = Trainer(cfg, tc_b, device="cpu").run(steps=6)
    # the restart resumes from the step-3 checkpoint: steps 4 and 5
    assert len(resumed["losses"]) == 2
    np.testing.assert_allclose(resumed["losses"], full["losses"][4:6],
                               rtol=1e-4, atol=1e-5)


def test_elastic_restart_different_host_count():
    """The data pipeline is counter-based: 1-host and 2-host runs see the
    same global batch, each host its shard, determined by (step, host)."""
    from repro_torch.data.pipeline import DataConfig as PDC
    from repro_torch.data.pipeline import SyntheticLM as PSL
    kw = dict(vocab=64, seq_len=8, global_batch=4, seed=3)
    ds = PSL(PDC(**kw))
    h0 = ds.batch_at(5, host_id=0, n_hosts=2)
    h1 = ds.batch_at(5, host_id=1, n_hosts=2)
    assert h0["tokens"].shape[0] == 2
    np.testing.assert_array_equal(
        h1["tokens"], ds.batch_at(5, host_id=1, n_hosts=2)["tokens"])
    np.testing.assert_array_equal(
        h1["tokens"], SyntheticLM(DataConfig(**kw)).batch_at(5, 1, 2)["tokens"])


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "qwen1.5-0.5b", "--smoke",
                             "--steps", "4", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "ck"),
                             "--grad-compression"])
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[0] == "LATEST"


def test_launch_train_minicpm3_smoke_on_cpu(tmp_path, capsys):
    """``--arch minicpm3-4b`` trains: MLA through its cacheless branch."""
    out = launch_train.main(["--arch", "minicpm3-4b", "--smoke",
                             "--steps", "3", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_launch_train_recurrent_smoke_on_cpu(arch, tmp_path, capsys):
    """``--arch xlstm-350m`` and ``--arch jamba-1.5-large-398b`` train: the
    mLSTM's and the scan's gradients through their Functions."""
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "2",
                             "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "ck")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "final loss" in capsys.readouterr().out


def test_torch_train_lm_example_on_cpu(tmp_path, capsys):
    """``examples/torch_train_lm.py``, the port of ``examples/train_lm.py``:
    its ~100M qwen-family model, two Trainer steps on the CPU, and its
    checkpoint at the end."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--steps", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    printed = capsys.readouterr().out
    assert "params: " in printed and "last-1  mean loss" in printed
    assert (tmp_path / "ck" / "LATEST").exists()


def test_training_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    tc = TrainConfig(ckpt_dir=str(tmp_path / "ck"))
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _batch(cfg, masked=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loss_fn(p, cfg, batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, tc)(init_state(p, tc), batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])
    loss, _ = loss_fn(p, cfg, batch, device="cpu")
    assert np.isfinite(float(loss))
