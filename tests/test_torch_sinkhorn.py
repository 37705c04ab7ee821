"""repro_torch Sinkhorn: the plain PyTorch version against the JAX package's
oracle and its Pallas kernel (interpret mode), ``saturate`` against the
reference's f64 host projection, the device policy, and
``sinkhorn_kernel_order``, the plain model of the CUDA kernel's cluster
path (``-k kernel_order``).  The CUDA kernel against its plain version and
that model on the card is in tests/test_torch_gpu.py.

Tolerances: f32 rtol 1e-5 / atol 1e-6 and bf16 rtol 3e-3, as in
tests/test_kernels.py (the versions differ only in reduction order); f64
rtol 1e-12 over 200 iterations (reduction order only); ``saturate`` on
the CPU bit for bit (numpy's own loop).  The model against itself is
bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import traffic as ref_traffic
from repro.core.simulator import websearch_workload as ref_websearch
from repro.kernels.sinkhorn.ref import sinkhorn_ref as jax_sinkhorn_ref
from repro.kernels.sinkhorn.sinkhorn import sinkhorn_pallas
from repro_torch.core import traffic
from repro_torch.kernels.sinkhorn import ops
from repro_torch.kernels.sinkhorn.ref import (sinkhorn_kernel_order,
                                              sinkhorn_ref)

BPS = 100e9 * 4.5e-6
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-3)}


def _uniform(n, seed=0):
    return (np.random.default_rng(seed).random((n, n)) + 0.01).astype(
        np.float32)


@pytest.mark.parametrize("n", [17, 64, 128, 250, 256, 512])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_sinkhorn_ref_matches_jax(n, dtype, against):
    jdt, tdt, rtol = DTYPES[dtype]
    m = _uniform(n, seed=n)
    mj = jnp.asarray(m, dtype=jnp.float32).astype(jdt)
    want = (jax_sinkhorn_ref(mj) if against == "ref"
            else sinkhorn_pallas(mj, interpret=True))
    got = sinkhorn_ref(torch.from_numpy(m).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=rtol, atol=1e-6)


def test_sinkhorn_ref_f64_is_doubly_stochastic():
    m = torch.from_numpy(_uniform(64).astype(np.float64))
    got = sinkhorn_ref(m, iters=200)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=1e-12)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-9)


def test_ops_cpu_takes_the_plain_version():
    m = _uniform(32, seed=3)
    got = ops.sinkhorn(m, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, sinkhorn_ref(torch.from_numpy(m)))
    # iters=0 is the clamp alone
    z = np.zeros((4, 4), np.float32)
    assert torch.equal(ops.sinkhorn(z, iters=0, eps=0.5, device="cpu"),
                       torch.full((4, 4), 0.5))


def test_ops_cpu_does_not_count_launches():
    before = ops.launches
    ops.sinkhorn(_uniform(16), device="cpu")
    assert ops.launches == before


def test_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.sinkhorn_kernel(torch.ones(4, 4))


def _saturate_input(name):
    if name == "websearch":
        return ref_websearch(16, 0.3, 200, BPS, d_hat=4, seed=1).demand_matrix()
    if name == "random_hose":
        return ref_traffic.random_hose(32, seed=2)
    if name == "skewed":
        return ref_traffic.skewed(24, 0.7, seed=3)
    return np.zeros((8, 8))


@pytest.mark.parametrize("name", ["websearch", "random_hose", "skewed",
                                  "all_zero"])
def test_saturate_matches_reference(name):
    m = _saturate_input(name)
    got = traffic.saturate(m, device="cpu")
    want = ref_traffic.saturate(m)
    assert got.dtype == np.float64
    # the CPU projection is numpy's own loop: equal bit for bit
    assert np.array_equal(got, want)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    m = _uniform(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.sinkhorn(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        traffic.saturate(m)
    # the same calls run when the CPU is asked for by name
    traffic.saturate(m, device="cpu")


# -- sinkhorn_kernel_order: the CUDA kernel's cluster path, modelled -------

TOL = {"float32": (20, 1e-12, 1e-5, 1e-6), "float64": (200, 0.0, 1e-12, 0.0)}


def _m(n, dtype, seed=None):
    g = np.random.default_rng(n if seed is None else seed)
    return torch.from_numpy(g.random((n, n)) + 0.01).to(getattr(torch, dtype))


def _same(a, b):
    """Bitwise equal, a NaN matching a NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("n", [1, 17, 64, 250, 256])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_order_matches_plain(n, dtype):
    iters, eps, rtol, atol = TOL[dtype]
    m = _m(n, dtype)
    got = sinkhorn_kernel_order(m, iters, eps)
    assert got.dtype == m.dtype and got.shape == (n, n)
    torch.testing.assert_close(got, sinkhorn_ref(m, iters, eps), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n", [17, 64, 256])
def test_kernel_order_matches_jax_ref(n):
    m = _uniform(n, seed=n)
    want = jax_sinkhorn_ref(jnp.asarray(m, dtype=jnp.float32))
    got = sinkhorn_kernel_order(torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,d_hat", [(16, 4), (256, 8)])
def test_kernel_order_matches_reference_saturate(n, d_hat):
    """The main path's use: ``saturate``'s clamp to 1e-12, then the
    kernel's 200 rounds at eps = 0 (n = 256 is the main path's size)."""
    m = ref_websearch(n, 0.3, 200, BPS, d_hat=d_hat, seed=1).demand_matrix()
    m = np.where(m <= 0, 1e-12, m)
    got = sinkhorn_kernel_order(torch.from_numpy(m), 200, 0.0)
    np.testing.assert_allclose(got.numpy(), ref_traffic.saturate(m), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("n", [17, 250, 256, 512])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_order_same_bits_for_either_cluster(n, dtype):
    iters, eps = TOL[dtype][:2]
    m = _m(n, dtype)
    a = sinkhorn_kernel_order(m, iters, eps, cluster=8)
    b = sinkhorn_kernel_order(m, iters, eps, cluster=16)
    assert torch.equal(a, b)
    # and it is not the plain version's order: the check has teeth
    assert not torch.equal(a, sinkhorn_ref(m, iters, eps)) or n == 1


def test_kernel_order_repeats_bitwise():
    m = _m(250, "float64")
    assert torch.equal(sinkhorn_kernel_order(m, 200, 0.0),
                       sinkhorn_kernel_order(m, 200, 0.0))


@pytest.mark.parametrize("case", ["clamp", "iters0", "iters1", "nan",
                                  "zero_row"])
def test_kernel_order_keeps_the_edges(case):
    m = _m(40, "float64")
    iters, eps = 3, 0.0
    if case == "clamp":                 # entries below eps become eps
        m[:5] = 0.0
        m[7, 3] = -2.0
        eps = 0.25
    elif case == "iters0":              # the clamped copy alone
        m[2, 2] = -1.0
        iters, eps = 0, 0.5
    elif case == "iters1":
        iters = 1
    elif case == "nan":                 # NaN passes the clamp and spreads
        m[7, 9] = float("nan")
    else:                               # 0 / 0 at eps = 0, as the plain one
        m[4] = 0.0
    got = sinkhorn_kernel_order(m, iters, eps)
    want = sinkhorn_ref(m, iters, eps)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0,
                               equal_nan=True)
    if case in ("iters0", "nan", "zero_row"):
        assert _same(got, want)
