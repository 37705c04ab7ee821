"""The port's data pipeline (``repro_torch.data.pipeline``) and checkpoints
(``repro_torch.ckpt.checkpoint``) against the reference's, on the CPU.

Bars: batches bit for bit equal to ``repro.data.pipeline``'s for the
dense, vlm and encdec families and any (step, host_id, n_hosts);
``tests/test_ckpt.py``'s six cases mirrored over torch trees; a
checkpoint written by either package restores in the other, leaf for leaf
and bit for bit (bf16 through its f32 copy, which is lossless).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as jck
from repro.configs import get_config as j_get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import init_params as j_init_params
from repro.train import init_state as j_init_state
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.train import init_state
from repro_torch.tree import flatten_with_keys


# -- the data pipeline -------------------------------------------------------
def cfg(**kw):
    base = dict(vocab=128, seq_len=16, global_batch=4, seed=7)
    base.update(kw)
    return DataConfig(**base)


@pytest.mark.parametrize("family,extra", [
    ("dense", {}),
    ("vlm", {"n_vision_tokens": 4, "d_model": 8}),
    ("encdec", {"enc_seq": 6, "d_model": 8}),
])
@pytest.mark.parametrize("step,host_id,n_hosts", [
    (0, 0, 1), (3, 0, 1), (5, 1, 2), (11, 3, 4),
])
def test_batches_equal_the_references_bit_for_bit(family, extra, step,
                                                  host_id, n_hosts):
    kw = dict(vocab=151, seq_len=13, global_batch=8, seed=3, family=family,
              **extra)
    got = SyntheticLM(DataConfig(**kw)).batch_at(step, host_id, n_hosts)
    want = JSyntheticLM(JDataConfig(**kw)).batch_at(step, host_id, n_hosts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_determinism_per_step():
    ds = SyntheticLM(cfg())
    a = ds.batch_at(3)
    b = ds.batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ds.batch_at(4)
    assert (a["tokens"] != c["tokens"]).any()


def test_host_sharding_shapes():
    ds = SyntheticLM(cfg())
    h0 = ds.batch_at(0, host_id=0, n_hosts=2)
    h1 = ds.batch_at(0, host_id=1, n_hosts=2)
    assert h0["tokens"].shape == (2, 16)
    assert (h0["tokens"] != h1["tokens"]).any()


def test_copy_structure_learnable():
    b = SyntheticLM(cfg(seq_len=20)).batch_at(0)
    full = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    half = full.shape[1] // 2
    np.testing.assert_array_equal(full[:, half:2 * half], full[:, :half])


def test_prefetcher_order_and_close():
    ds = SyntheticLM(cfg())
    pf = Prefetcher(ds, start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          ds.batch_at(step)["tokens"])
    finally:
        pf.close()


# -- checkpoints: tests/test_ckpt.py's cases over torch trees ---------------
def tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones((4,), dtype=torch.bfloat16),
                   "c": [torch.zeros((2, 2)), torch.full((1,), 7.0)]},
    }


def test_roundtrip(tmp_path):
    t = tree()
    ck.save(t, str(tmp_path), step=3)
    restored, step = ck.restore(t, str(tmp_path))
    assert step == 3
    assert torch.equal(restored["a"], t["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["c"][1], t["nested"]["c"][1])


def test_latest_pointer_and_keep(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(t, str(tmp_path), step=s, keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2
    _, step = ck.restore(t, str(tmp_path))
    assert step == 5


def test_async_save(tmp_path):
    t = tree()
    th = ck.save(t, str(tmp_path), step=7, blocking=False)
    th.join(timeout=30)
    assert ck.latest_step(str(tmp_path)) == 7


def test_async_save_copies_before_it_returns(tmp_path):
    """The optimizer updates parameters in place: a leaf changed right after
    ``save(blocking=False)`` returns must not reach the checkpoint."""
    t = tree()
    want = t["a"].clone()
    th = ck.save(t, str(tmp_path), step=1, blocking=False)
    t["a"].add_(100.0)
    th.join(timeout=30)
    restored, _ = ck.restore(tree(), str(tmp_path))
    assert torch.equal(restored["a"], want)


def test_shape_mismatch_raises(tmp_path):
    t = tree()
    ck.save(t, str(tmp_path), step=1)
    bad = dict(t)
    bad["a"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        ck.restore(bad, str(tmp_path))


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(tree(), str(tmp_path / "nope"))


def test_crash_during_write_preserves_previous(tmp_path):
    """A stray .tmp dir (simulated crash) must not shadow LATEST."""
    t = tree()
    ck.save(t, str(tmp_path), step=1)
    os.makedirs(tmp_path / "step_000000002.tmp0")
    assert ck.latest_step(str(tmp_path)) == 1
    _, step = ck.restore(t, str(tmp_path))
    assert step == 1


# -- a reference TrainState across the packages -----------------------------
@pytest.fixture(scope="module")
def states():
    """(reference TrainState, the port's TrainState of the same leaves),
    the model's parameters, AdamW moments and error-feedback state made
    nonzero so that every leaf carries data."""
    jcfg = j_get_config("qwen1.5-0.5b", smoke=True)
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    jtc = JTrainConfig(grad_compression=True)
    tc = TrainConfig(grad_compression=True)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    noise = lambda x: jnp.asarray(  # noqa: E731
        rng.standard_normal(x.shape).astype(np.float32), dtype=jnp.float32)
    js = j_init_state(jp, jtc)
    js = js._replace(opt=js.opt._replace(
        step=jnp.int32(5), mu=jax.tree.map(noise, js.opt.mu),
        nu=jax.tree.map(noise, js.opt.nu)),
        err=jax.tree.map(noise, js.err))
    ps = init_state(convert.params_from(jax.tree.map(np.asarray, jp), cfg),
                    tc)
    return js, ps


def test_port_keys_are_the_references(states):
    js, ps = states
    assert sorted(k for k, _ in flatten_with_keys(ps)) == sorted(
        jck._flatten(js))


def test_reference_checkpoint_restores_in_the_port(states, tmp_path):
    js, ps = states
    jck.save(js, str(tmp_path), step=4)
    got, step = ck.restore(ps, str(tmp_path))
    assert step == 4
    want = jck._flatten(js)
    for key, leaf in flatten_with_keys(got):
        assert isinstance(leaf, torch.Tensor)
        np.testing.assert_array_equal(leaf.numpy(), want[key])
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 5


def test_port_checkpoint_restores_in_the_reference(states, tmp_path):
    """The port's state (filled with the reference's values, so that every
    leaf carries data) saved by the port, restored by the reference."""
    js, ps = states
    jck.save(js, str(tmp_path / "ref"), step=0)
    filled, _ = ck.restore(ps, str(tmp_path / "ref"))
    ck.save(filled, str(tmp_path / "port"), step=9)
    got, step = jck.restore(js, str(tmp_path / "port"))
    assert step == 9
    want = {k: v.numpy() for k, v in flatten_with_keys(filled)}
    for key, leaf in jck._flatten(got).items():
        np.testing.assert_array_equal(leaf, want[key])


def test_bf16_leaves_cross_both_ways(tmp_path):
    jt = {"w": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
          "s": [jnp.int32(3)]}
    pt = {"w": torch.zeros(3, dtype=torch.bfloat16),
          "s": [torch.zeros((), dtype=torch.int32)]}
    jck.save(jt, str(tmp_path / "a"), step=1)
    got, _ = ck.restore(pt, str(tmp_path / "a"))
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].float().tolist() == [1.5, -2.25, 3.0]
    assert int(got["s"][0]) == 3
    ck.save(got, str(tmp_path / "b"), step=2)
    back, _ = jck.restore(jt, str(tmp_path / "b"))
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  [1.5, -2.25, 3.0])
