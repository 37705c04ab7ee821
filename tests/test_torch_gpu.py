"""repro_torch kernels on the card (marker ``gpu``): each CUDA kernel
against its plain PyTorch version.  Needs no jax, so it runs on a machine
with a card and PyTorch alone (``pytest -m gpu``); without a card every
test skips.  Whether a card is present is decided inside each test.

Tolerances: f32 rtol 1e-5 / atol 1e-6, as tests/test_kernels.py holds the
Pallas kernel (reduction order only); f64 rtol 1e-12 over 200 iterations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.sinkhorn import ops
from repro_torch.kernels.sinkhorn.ref import sinkhorn_ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype,iters,rtol,atol", [
    (64, "float32", 20, 1e-5, 1e-6),
    (250, "float32", 20, 1e-5, 1e-6),
    (512, "float32", 20, 1e-5, 1e-6),
    (256, "float64", 200, 1e-12, 0.0),
])
def test_sinkhorn_kernel_matches_plain(n, dtype, iters, rtol, atol):
    _card()
    dt = getattr(torch, dtype)
    m = torch.from_numpy(np.random.default_rng(n).random((n, n)) + 0.01).to(
        "cuda", dt)
    before = ops.launches
    got = ops.sinkhorn(m, iters=iters, device="cuda")
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.dtype == dt and got.device.type == "cuda"
    torch.testing.assert_close(got, sinkhorn_ref(m, iters=iters),
                               rtol=rtol, atol=atol)
    # fixed-order reductions: the same input gives the same bits
    assert torch.equal(got, ops.sinkhorn(m, iters=iters, device="cuda"))


@pytest.mark.gpu
def test_sinkhorn_kernel_casts_half_and_clamps():
    _card()
    m = torch.rand(128, 128, device="cuda").to(torch.bfloat16)
    got = ops.sinkhorn(m, device="cuda")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, sinkhorn_ref(m), rtol=1e-5, atol=1e-6)
    z = torch.zeros(8, 8, device="cuda")
    assert torch.equal(ops.sinkhorn(z, iters=0, eps=0.25, device="cuda"),
                       torch.full_like(z, 0.25))


@pytest.mark.gpu
def test_sinkhorn_kernel_rejects_bad_input():
    _card()
    with pytest.raises(ValueError, match="square"):
        ops.sinkhorn_kernel(torch.ones(4, 5, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sinkhorn_kernel(torch.ones(8, 8, device="cuda").t()[:4, :4])
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.sinkhorn_kernel(torch.ones(4, 4, device="cuda",
                                       dtype=torch.float16))
