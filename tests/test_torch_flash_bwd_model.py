"""The plain model of the bf16 flash-attention backward kernel's arithmetic
(``attention_bwd_tiles``: P and dS rounded to bf16 before their products,
dK and dV summed over the group's heads and query steps in the kernel's
order, dQ over key steps) on the CPU, and the wrapper's alignment copy.

The model is held, on bf16 inputs made by numpy from a seed:
- to the plain backward ``attention_bwd_ref`` within ``BWD_TOL`` (1.25e-2
  of each output's largest magnitude, the card's gate of the kernel
  against the plain version), both rounded to bf16 as the kernel and the
  plain version round their outputs (readings 4.1e-3 to 7.5e-3 at these
  shapes);
- in f32 to JAX's gradient of ``repro.models.layers.chunked_attention``
  on the same values in f32 within ``JAX_TOL`` = 1e-2 of each output's
  largest magnitude: the model's bf16 roundings of P and dS (2^-9
  relative each, summed over up to 200 terms) and the forward output
  rounded to bf16 before D, against an f32 gradient (readings 1.8e-3 to
  4.3e-3).
The card holds the kernel to the model within ``chip_smoke.TILE_TOL``
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.ref import (BWD_KV_STEP, BWD_Q_STEP,
                                                     attention_bwd_ref,
                                                     attention_bwd_tiles,
                                                     attention_lse_ref)
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops

BWD_TOL = 1.25e-2
JAX_TOL = 1e-2

# b, sq, sk, h, kv, dh, causal, window: the kernel's step edges (64 keys,
# 64 query rows, 64-key dQ steps), GQA and MQA, a window, Sq < Sk
CASES = [
    (1, 63, 63, 2, 2, 64, True, 0),        # one partial step
    (2, 130, 130, 4, 2, 64, True, 0),      # two steps and two rows, GQA
    (1, 97, 97, 4, 1, 128, True, 0),       # MQA, dh 128
    (1, 150, 150, 4, 2, 128, True, 40),    # window edges inside steps
    (1, 40, 170, 2, 2, 64, False, 0),      # cross shape, Sk ragged
    (1, 70, 200, 4, 4, 64, True, 0),       # Sq < Sk, end-aligned
    (2, 33, 20, 2, 1, 64, True, 0),        # Sk under a step; rows see none
]


def _inputs(b, sq, sk, h, kv, dh, causal, window, seed=0):
    """bf16 q, k, v, dO from numpy; the forward's output (bf16, as the
    forward kernel writes it) and log-sum-exp."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
    q, k, v, do = mk(b, sq, h, dh), mk(b, sk, kv, dh), mk(b, sk, kv, dh), \
        mk(b, sq, h, dh)
    o, lse = attention_lse_ref(q, k, v, causal, window)
    return q, k, v, o, lse, do


def _rel(got, want):
    return [float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_tile_model_within_the_gate_of_the_plain_backward(
        b, sq, sk, h, kv, dh, causal, window):
    args = _inputs(b, sq, sk, h, kv, dh, causal, window)
    model = attention_bwd_tiles(*args, causal, window)
    want = attention_bwd_ref(*args, causal, window)
    for m, w in zip(model, want):
        assert m.dtype == torch.float32 and m.shape == w.shape
        assert bool(torch.isfinite(m).all())
    rounded = [m.to(torch.bfloat16) for m in model]
    assert max(_rel(rounded, want)) <= BWD_TOL


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_tile_model_matches_jax_gradient(b, sq, sk, h, kv, dh, causal,
                                         window):
    """Against JAX's gradient of the reference's attention; a row that
    sees no key has none in both."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.models.layers import chunked_attention

    args = _inputs(b, sq, sk, h, kv, dh, causal, window)
    q, k, v, _, _, do = args
    j = [jnp.asarray(t.float().numpy(), dtype=jnp.float32)
         for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, bb, c: chunked_attention(
        a, bb, c, causal=causal, window=window, q_offset=sk - sq),
        j[0], j[1], j[2])
    want = [torch.from_numpy(np.array(g, np.float32)) for g in vjp(j[3])]
    model = attention_bwd_tiles(*args, causal, window)
    assert max(_rel(model, want)) <= JAX_TOL


@pytest.mark.parametrize("dqk,dv", [(24, 16), (96, 64)])
@pytest.mark.parametrize("b,sq,sk,h,kv,causal", [
    (1, 130, 130, 4, 4, True), (2, 70, 70, 2, 1, True),
    (1, 40, 170, 2, 2, False)])
def test_tile_model_at_split_widths(dqk, dv, b, sq, sk, h, kv, causal):
    """q/k ``dqk`` and v ``dv`` wide (MLA's cacheless branch): dQ and dK
    ``dqk`` wide, dV ``dv``; the model within ``BWD_TOL`` of the plain
    backward (rounded to bf16) and within ``JAX_TOL`` of JAX's gradient of
    the reference's attention."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.models.layers import chunked_attention

    rng = np.random.default_rng(7)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
    q, k, v, do = mk(b, sq, h, dqk), mk(b, sk, kv, dqk), mk(b, sk, kv, dv), \
        mk(b, sq, h, dv)
    o, lse = attention_lse_ref(q, k, v, causal, 0)
    model = attention_bwd_tiles(q, k, v, o, lse, do, causal, 0)
    want = attention_bwd_ref(q, k, v, o, lse, do, causal, 0)
    for m, w, t in zip(model, want, (q, k, v)):
        assert m.shape == w.shape == t.shape
    assert max(_rel([m.to(torch.bfloat16) for m in model], want)) <= BWD_TOL
    j = [jnp.asarray(t.float().numpy(), dtype=jnp.float32)
         for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, bb, c: chunked_attention(
        a, bb, c, causal=causal, q_offset=sk - sq), j[0], j[1], j[2])
    jax_grads = [torch.from_numpy(np.array(g, np.float32)) for g in vjp(j[3])]
    assert max(_rel(model, jax_grads)) <= JAX_TOL


def test_tile_model_rounds_where_the_kernel_does():
    """Without its bf16 roundings the model is the plain backward in f32
    (up to the order of its sums); with them it moves by about a bf16
    rounding of P and dS, and its steps are the kernel's."""
    assert BWD_KV_STEP == BWD_Q_STEP == 64
    args = _inputs(1, 130, 130, 4, 2, 64, True, 0, seed=3)
    model = attention_bwd_tiles(*args, True, 0)
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
    exact = attention_bwd_ref(*f32, True, 0)
    moved = max(_rel(model, exact))
    assert 1e-4 < moved < 5e-3


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_tma_ready_copies_a_misaligned_base(offset):
    """``tma_ready`` keeps an aligned contiguous tensor as it is and
    copies one whose base is off a 16-byte boundary (a view 2 bytes into
    a buffer) into a fresh, aligned allocation with the same values."""
    buf = torch.randn(4096, generator=torch.Generator().manual_seed(0)
                      ).to(torch.bfloat16)
    t = buf[offset:offset + 2 * 9 * 64].view(2, 9, 64)
    got = bwd_ops.tma_ready(t)
    assert torch.equal(got, t) and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert (got.data_ptr() == t.data_ptr()) == (t.data_ptr() % 16 == 0)


def test_tma_ready_makes_a_strided_view_contiguous():
    x = torch.randn(2, 9, 4, 64).to(torch.bfloat16)
    t = x.transpose(1, 2)
    got = bwd_ops.tma_ready(t)
    assert got.is_contiguous() and torch.equal(got, t)
    assert got.data_ptr() % 16 == 0


def test_kernel_refuses_cpu_tensors_before_any_copy():
    args = _inputs(1, 8, 8, 2, 2, 64, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        bwd_ops.attention_bwd_kernel(*args, True, 0)
    # the CPU takes the plain version, whatever the alignment
    got = bwd_ops.attention_bwd(*args, True, 0)
    want = attention_bwd_ref(*args, True, 0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
