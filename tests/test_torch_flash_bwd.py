"""The flash-attention gradient of the port on the CPU: the autograd
Function ``FlashAttention`` (reached through ``attention`` when a gradient
is wanted) with its plain forward (``attention_lse_ref``) and backward
(``attention_bwd_ref``, the explicit formula the backward kernel
computes), against autograd through the plain ``attention_ref``.  The card
swaps in only the kernels (``tests/test_torch_gpu.py``).

Bars: f32 gradients within 1e-5 of the largest magnitude of each (the two
sum in different orders), f64 within 1e-12, and ``gradcheck`` in f64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import no_backward
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops

CASES = [
    # b, sq, sk, h, kv, dh, causal, window
    (2, 9, 9, 4, 4, 16, True, 0),        # causal
    (1, 12, 12, 4, 2, 8, True, 5),       # sliding window, GQA
    (2, 7, 7, 2, 2, 8, False, 0),        # non-causal
    (1, 10, 10, 6, 1, 8, True, 0),       # MQA
    (2, 5, 11, 4, 2, 8, True, 0),        # Sq < Sk, end-aligned
    (1, 6, 13, 3, 3, 8, False, 0),       # cross-attention shape
    (1, 9, 4, 2, 1, 8, True, 0),         # rows that see no key
]


def _inputs(b, sq, sk, h, kv, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s), dtype=dtype, requires_grad=True)
    return mk(b, sq, h, dh), mk(b, sk, kv, dh), mk(b, sk, kv, dh), \
        torch.tensor(rng.standard_normal((b, sq, h, dh)), dtype=dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_function_gradient_matches_autograd_through_plain(
        dtype, tol, b, sq, sk, h, kv, dh, causal, window):
    q, k, v, do = _inputs(b, sq, sk, h, kv, dh, dtype)
    out = flash_ops.attention(q, k, v, causal, window)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = attention_ref(q, k, v, causal, window)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= tol * scale


# CASES' masks at a few elements each: gradcheck perturbs every input
# element, so its cost grows with their count
GRADCHECK_CASES = [
    (1, 5, 5, 2, 2, 4, True, 0),
    (1, 6, 6, 4, 2, 4, True, 3),
    (1, 4, 4, 2, 2, 4, False, 0),
    (1, 5, 5, 3, 1, 4, True, 0),
    (1, 3, 6, 2, 1, 4, True, 0),
    (1, 3, 7, 2, 2, 4, False, 0),
    (1, 6, 3, 2, 1, 4, True, 0),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", GRADCHECK_CASES)
def test_gradcheck_f64(b, sq, sk, h, kv, dh, causal, window):
    q, k, v, _ = _inputs(b, sq, sk, h, kv, dh, torch.float64, seed=1)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_ops.attention(q, k, v, causal, window),
        (q, k, v))


# q/k wider than v, as in MLA's cacheless branch: the smoke MiniCPM3's
# (24, 16) and the full model's (96, 64); b, sq, sk, h, kv, causal, window
SPLIT_WIDTHS = [(24, 16), (96, 64)]
SPLIT_CASES = [
    (2, 9, 9, 4, 4, True, 0),            # MiniCPM3's: H = KV, causal
    (1, 12, 12, 4, 2, True, 5),          # sliding window, GQA
    (1, 6, 13, 3, 3, False, 0),          # cross-attention shape
    (1, 9, 4, 2, 1, True, 0),            # rows that see no key
]


def _split_inputs(b, sq, sk, h, kv, dqk, dv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s), dtype=dtype, requires_grad=True)
    return mk(b, sq, h, dqk), mk(b, sk, kv, dqk), mk(b, sk, kv, dv), \
        torch.tensor(rng.standard_normal((b, sq, h, dv)), dtype=dtype)


@pytest.mark.parametrize("dqk,dv", SPLIT_WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", SPLIT_CASES)
def test_split_widths_match_jax_vjp_of_chunked_attention(
        dqk, dv, b, sq, sk, h, kv, causal, window):
    """``attention`` under grad (the Function's plain forward and
    backward) at q/k width ``dqk`` and v width ``dv``: the output (dv
    wide), dQ and dK (dqk wide) and dV (dv wide) against ``jax.vjp`` of the
    reference's ``chunked_attention`` on the same f32 values, each within
    1e-5 of its largest magnitude (the f32 bar above: the two sum in
    different orders)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax import vjp

    from repro.models.layers import chunked_attention

    q, k, v, do = _split_inputs(b, sq, sk, h, kv, dqk, dv, torch.float32)
    out = flash_ops.attention(q, k, v, causal, window)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad(out, (q, k, v), do)
    j = [jnp.asarray(t.detach().numpy(), dtype=jnp.float32)
         for t in (q, k, v, do)]
    want_out, fn = vjp(lambda a, bb, c: chunked_attention(
        a, bb, c, causal=causal, window=window, q_offset=sk - sq),
        j[0], j[1], j[2])
    want = fn(j[3])
    assert out.shape == (b, sq, h, dv)
    for g, w, t in zip((out,) + got, (want_out,) + tuple(want),
                       (None, q, k, v)):
        w = np.asarray(w)
        assert g.shape == w.shape and (t is None or g.shape == t.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.detach().numpy() - w).max()) <= 1e-5 * scale


@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window", [
    (1, 5, 5, 2, 2, True, 0), (1, 4, 6, 2, 1, False, 0),
    (1, 6, 6, 2, 2, True, 3)])
def test_gradcheck_f64_split_widths(b, sq, sk, h, kv, causal, window):
    """``gradcheck`` of ``FlashAttention`` in f64 at the smoke MiniCPM3's
    widths, q/k 24 and v 16."""
    q, k, v, _ = _split_inputs(b, sq, sk, h, kv, 24, 16, torch.float64,
                               seed=1)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_ops.FlashAttention.apply(q, k, v, causal,
                                                       window),
        (q, k, v))


def test_fully_masked_rows_get_no_gradient():
    # Sq 9 over Sk 4, causal: rows 0-4 sit at positions -5..-1 and see no key
    q, k, v, do = _inputs(1, 9, 4, 2, 1, 8, torch.float32, seed=2)
    out = flash_ops.attention(q, k, v, True, 0)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    assert torch.equal(out[:, :5], torch.zeros_like(out[:, :5]))
    assert torch.equal(dq[:, :5], torch.zeros_like(dq[:, :5]))
    assert bool(dq[:, 5:].abs().sum() > 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    _, lse = attention_lse_ref(q, k, v, True, 0)
    assert bool(torch.isneginf(lse[:, :, :5]).all())
    assert bool(torch.isfinite(lse[:, :, 5:]).all())


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window", CASES)
def test_lse_is_the_rows_logsumexp(b, sq, sk, h, kv, dh, causal, window):
    q, k, v, _ = _inputs(b, sq, sk, h, kv, dh, torch.float64, seed=3)
    out, lse = attention_lse_ref(q, k, v, causal, window)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float64
    rep = h // kv
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(rep, 2)) * dh ** -0.5
    qp = torch.arange(sq)[:, None] + sk - sq
    kp = torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out, attention_ref(q, k, v, causal, window))


def test_bwd_ref_sums_each_group_and_needs_the_d_term():
    """The two faults the card's controls plant, seen on the CPU: each kv
    head's dK/dV is the sum over its group's query heads, and dropping
    D = rowsum(dO o O) changes dQ and dK."""
    q, k, v, do = (t.detach() for t in _inputs(1, 8, 8, 4, 2, 8,
                                                torch.float64, seed=4))
    out, lse = attention_lse_ref(q, k, v, True, 0)
    dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do, True, 0)
    per_head = [attention_bwd_ref(q[:, :, i:i + 1], k[:, :, i // 2:i // 2 + 1],
                                  v[:, :, i // 2:i // 2 + 1],
                                  out[:, :, i:i + 1], lse[:, i:i + 1],
                                  do[:, :, i:i + 1], True, 0)
                for i in range(4)]
    for g in range(2):
        torch.testing.assert_close(
            dk[:, :, g], per_head[2 * g][1][:, :, 0]
            + per_head[2 * g + 1][1][:, :, 0])
        torch.testing.assert_close(
            dv[:, :, g], per_head[2 * g][2][:, :, 0]
            + per_head[2 * g + 1][2][:, :, 0])
    no_d = attention_bwd_ref(q, k, v, torch.zeros_like(out), lse, do, True, 0)
    assert float((no_d[0] - dq).abs().max()) > 1e-3
    assert torch.equal(no_d[2], dv)


def test_no_gradient_no_function():
    """Without a gradient the call is the plain version (the serving path
    on the CPU), and under no_grad too."""
    q, k, v, _ = _inputs(1, 6, 6, 2, 2, 8, torch.float32, seed=5)
    with torch.no_grad():
        out = flash_ops.attention(q, k, v)
    assert out.grad_fn is None
    d = q.detach()
    assert flash_ops.attention(d, k.detach(), v.detach()).grad_fn is None
    torch.testing.assert_close(out, attention_ref(d, k.detach(), v.detach()),
                               rtol=0, atol=0)


def test_backward_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, do = _inputs(2, 7, 7, 4, 2, 16, torch.float32, seed=6)
    out, lse = attention_lse_ref(q, k, v, True, 0)
    before = bwd_ops.launches
    got = bwd_ops.attention_bwd(q, k, v, out, lse, do, True, 0)
    want = attention_bwd_ref(q, k, v, out, lse, do, True, 0)
    assert bwd_ops.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        bwd_ops.attention_bwd_kernel(q, k, v, out, lse, do)


def test_no_backward_refuses_only_under_grad():
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9b"):
        no_backward("mLSTM", "item 9b", t)
    with pytest.raises(NotImplementedError,
                       match="serves only.*training runs elsewhere"):
        no_backward("MLA prefill", None, t, instead="elsewhere")
    with torch.no_grad():
        no_backward("mLSTM", "item 9b", t)
    no_backward("mLSTM", "item 9b", t.detach(), None)
