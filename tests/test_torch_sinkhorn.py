"""repro_torch Sinkhorn: the plain PyTorch version against the JAX package's
oracle and its Pallas kernel (interpret mode), ``saturate`` against the
reference's f64 host projection, and the device policy.  The CUDA kernel
against its plain version on the card is in tests/test_torch_gpu.py.

Tolerances: f32 rtol 1e-5 / atol 1e-6 and bf16 rtol 3e-3, as in
tests/test_kernels.py (the versions differ only in reduction order);
``saturate`` atol 1e-12 (both f64, 200 iterations).
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
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref

BPS = 100e9 * 4.5e-6
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-3)}


def _uniform(n, seed=0):
    return (np.random.default_rng(seed).random((n, n)) + 0.01).astype(
        np.float32)


@pytest.mark.parametrize("n", [64, 128, 256, 512])
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
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


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
