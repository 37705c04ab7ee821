"""The selective scan's gradient in the port: the explicit plain backward
(``kernels/mamba_scan/ref.py``'s ``selective_scan_bwd_ref``) against
autograd through the plain forward and against ``jax.vjp`` of the
reference's scan (the discretisation as ``repro.models.mamba.mamba_block``
forms it, ``_chunked_selective_scan``, the ``bsdn,bsn->bsd`` contraction), a
plain model of the backward kernel's order of work
(``kernels/csrc/mamba_scan_bwd.cu``), and the routing through the
``SelectiveScan`` autograd Function.

Bars: against autograd 1e-10 of each gradient's largest magnitude in f64
and 1e-5 in f32; against the reference 1e-4 in f32; the kernel's model
1e-5 in f64 and 1e-4 in f32, the kernel's own bar on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.models import mamba as JM
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                selective_scan_ref)

SIZES = [5, 64, 300, 512]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its tests run many small ops,
    which several threads each would only contend for the cores that
    pytest-xdist's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ("ddt", "da", "dB", "dC", "du")


def _inputs(seed, b, s, d, n):
    """dt (B, S) > 0, a (D, N) < 0, B, C (B, S, N), u (B, S, D) and a
    cotangent dy (B, S, D), numpy f64, at scales that keep the decays
    exp(dt a) between ~0.04 and ~1 (tests/test_torch_mamba.py's)."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.2, (b, s))
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float64),
                         (d, n)).copy() * rng.uniform(0.5, 1.0, (d, 1))
    bmat, cmat = (rng.standard_normal((b, s, n)) for _ in range(2))
    u, dy = (rng.standard_normal((b, s, d)) for _ in range(2))
    return dt, a, bmat, cmat, u, dy


def _held(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, name


@pytest.mark.parametrize("s", [1] + SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_explicit_backward_matches_autograd(s, dtype, tol):
    """The explicit reverse recurrence against autograd through
    ``selective_scan_ref`` (its 256-position chunks), every gradient."""
    ins = [torch.tensor(x, dtype=dtype) for x in _inputs(s, 2, s, 12, 8)]
    xs = [t.clone().requires_grad_() for t in ins[:5]]
    y, _ = selective_scan_ref(*xs)
    want = torch.autograd.grad(y, xs, ins[5])
    got = selective_scan_bwd_ref(*ins)
    assert all(g.dtype == dtype for g in got)
    if s == 1:                   # h_{-1} = 0: no gradient reaches a
        assert not got[1].any() and not want[1].any()
        got, want = got[:1] + got[2:], want[:1] + want[2:]
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
        return
    _held(got, want, tol)


def _reference_y(dt, a, bmat, cmat, u):
    """The reference model's scan: ``mamba_block``'s discretisation,
    ``_chunked_selective_scan`` from the zero state, the contraction."""
    a_bar = jnp.exp(dt[..., None, None] * a[None, None])
    b_bar = dt[..., None, None] * bmat[:, :, None, :] * u[..., None]
    hs, _ = JM._chunked_selective_scan(
        a_bar, b_bar, jnp.zeros(a_bar.shape[:1] + a_bar.shape[2:],
                                jnp.float32), JM.CHUNK)
    return jnp.einsum("bsdn,bsn->bsd", hs, cmat)


@pytest.mark.parametrize("s", SIZES)
def test_explicit_backward_matches_the_reference_vjp(s):
    """Against ``jax.vjp`` of the reference's scan on the same f32 inputs
    (its padding of a ragged last chunk with a = 1, b = 0)."""
    ins = [x.astype(np.float32) for x in _inputs(s + 3, 2, s, 12, 16)]
    _, vjp = jax.vjp(_reference_y, *map(jnp.asarray, ins[:5]))
    want = vjp(jnp.asarray(ins[5], dtype=jnp.float32))
    got = selective_scan_bwd_ref(*(torch.from_numpy(x) for x in ins))
    _held(got, want, 1e-4)


def test_function_passes_gradcheck():
    """``torch.autograd.gradcheck`` of the ``SelectiveScan`` Function in f64
    (its plain backward against finite differences), at a few elements."""
    ins = _inputs(4, 1, 7, 3, 8)
    xs = [torch.tensor(x).requires_grad_() for x in ins[:5]]
    assert torch.autograd.gradcheck(
        lambda *a: ops.SelectiveScan.apply(*a)[0], xs)


def test_controls_move_the_gradients():
    """The broken variants chip_smoke.py's controls use (dh not carried
    from one 64-position tile to the next; ddt without ``a a_bar h``) move
    the gradients by far more than the f32 bar."""
    ins = [torch.tensor(x) for x in _inputs(8, 2, 300, 24, 16)]
    want = selective_scan_bwd_ref(*ins)
    for kw in ({"drop_carry": True, "chunk": 64}, {"drop_decay_term": True}):
        got = selective_scan_bwd_ref(*ins, **kw)
        worst = max(float((x - w).abs().max() / w.abs().max())
                    for x, w in zip(got, want))
        assert worst > 1e-2, kw


# -- a model of the backward kernel's order of work ---------------------------
LANES, PER_LANE, CH = 8, 8, 32    # lanes a channel, positions a lane, a block
WARP_CH = 4                       # channels a warp
LOG2E = 1.4426950408889634


def _channel_sum(x):
    """Sum over the last dim (channels) in the kernel's order: a warp's 4
    channels by its reduce-scatter ((c0 + c2) + (c1 + c3)), the block's 8
    warps in order, the blocks in order (the second launch)."""
    d = x.shape[-1]
    nblk = -(-d // CH)
    x = torch.nn.functional.pad(x, (0, nblk * CH - d))
    x = x.reshape(*x.shape[:-1], nblk, CH // WARP_CH, WARP_CH)
    x = (x[..., 0] + x[..., 2]) + (x[..., 1] + x[..., 3])
    out = torch.zeros(x.shape[:-2], dtype=x.dtype)
    for k in range(nblk):
        part = torch.zeros_like(out)
        for w in range(CH // WARP_CH):
            part = part + x[..., k, w]
        out = out + part
    return out


def _butterfly_sum(x):
    """Sum over the last dim (the states) as the second launch's butterfly:
    neighbours first, then pairs of pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _kernel_scan_bwd(dt, a, bmat, cmat, u, dy):
    """mamba_scan_bwd.cu's order of work in plain PyTorch, in the inputs'
    dtype: tiles of LANES x PER_LANE positions; a forward sweep keeps the
    state entering each tile (each lane's pairs composed, the lanes' pairs
    scanned, the earlier first); then the tiles in reverse: each lane's h
    again from the tile's entering state, its reverse steps E_t = a_bar_t
    (E_{t+1} + C_t dy_t) composed into one pair, the lanes' pairs scanned
    from the last lane, the carry from the tile after entering at the last
    lane, and each lane's positions walked backwards; dB's, dC's and ddt's
    a-term's sums over channels by :func:`_channel_sum`, ddt's B-term as
    sum_n B_t[n] dB_t[n] / dt_t by :func:`_butterfly_sum`, da by lane over
    the tiles in reverse, then the lanes and the batch rows in order."""
    b, s = dt.shape
    d, n = a.shape
    ts = LANES * PER_LANE
    nt = -(-s // ts)
    padn = nt * ts - s
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x, (0, 0) * (x.dim() - 2) + (0, padn))
    dtp, bp, cp, up, dyp = (pad(x) for x in (dt, bmat, cmat, u, dy))
    ak = torch.exp2(dtp[:, :, None, None] * (a * LOG2E))      # (B, S', D, N)
    dtb = dtp[..., None] * bp                                  # (B, S', N)
    bk = dtb[:, :, None, :] * up[..., None]
    lane = lambda x, t0: x[:, t0:t0 + ts].reshape(  # noqa: E731
        b, LANES, PER_LANE, *x.shape[2:])

    def lane_pairs(aa, bb):
        pa, pb = torch.ones_like(aa[:, :, 0]), torch.zeros_like(bb[:, :, 0])
        for x in range(PER_LANE):
            pb = aa[:, :, x] * pb + bb[:, :, x]
            pa = pa * aa[:, :, x]
        off = 1
        while off < LANES:                 # the earlier lane's pair first
            pb = torch.cat([pb[:, :off], pa[:, off:] * pb[:, :-off]
                            + pb[:, off:]], dim=1)
            pa = torch.cat([pa[:, :off], pa[:, off:] * pa[:, :-off]], dim=1)
            off *= 2
        return pa, pb

    h = torch.zeros((b, d, n), dtype=dt.dtype)
    enter = []
    for it in range(nt):
        enter.append(h)
        pa, pb = lane_pairs(lane(ak, it * ts), lane(bk, it * ts))
        h = (pa * h[:, None] + pb)[:, -1]
    du = torch.zeros_like(up)
    tb = torch.zeros((b, nt * ts, n, d), dtype=dt.dtype)
    tc = torch.zeros_like(tb)
    tt = torch.zeros_like(up)
    da_lanes = torch.zeros((b, LANES, d, n), dtype=dt.dtype)
    ec = torch.zeros((b, d, n), dtype=dt.dtype)
    lanes = torch.arange(LANES) * PER_LANE
    for it in reversed(range(nt)):
        t0 = it * ts
        A, Bk = lane(ak, t0), lane(bk, t0)
        pa, pb = lane_pairs(A, Bk)
        h0 = enter[it]
        hh = torch.cat([h0[:, None], (pa * h0[:, None] + pb)[:, :-1]], dim=1)
        hp = []
        for x in range(PER_LANE):
            hp.append(hh)
            hh = A[:, :, x] * hh + Bk[:, :, x]
        beta = lane(cp, t0)[:, :, :, None, :] * lane(dyp, t0)[..., None]
        qa, qb = torch.ones_like(hh), torch.zeros_like(hh)
        for x in reversed(range(PER_LANE)):
            qb = A[:, :, x] * (qb + beta[:, :, x])
            qa = qa * A[:, :, x]
        off = 1
        while off < LANES:                 # the later lane's pair first
            qb = torch.cat([qa[:, :-off] * qb[:, off:] + qb[:, :-off],
                            qb[:, -off:]], dim=1)
            qa = torch.cat([qa[:, :-off] * qa[:, off:], qa[:, -off:]], dim=1)
            off *= 2
        full = qa * ec[:, None] + qb
        e = torch.cat([full[:, 1:], ec[:, None]], dim=1)
        ec = full[:, 0]
        U, Dy, Dtb = (lane(x, t0) for x in (up, dyp, dtb))
        dtl = lane(dtp[..., None], t0)[..., 0]
        dan = torch.zeros_like(da_lanes)
        for x in reversed(range(PER_LANE)):
            dh = e + beta[:, :, x]
            e = A[:, :, x] * dh
            ht = hp[x + 1] if x + 1 < PER_LANE else hh
            dab = dh * hp[x] * A[:, :, x]
            pos = t0 + lanes + x
            du[:, pos] = (dh * Dtb[:, :, x, None, :]).sum(-1)
            tt[:, pos] = (dab * a).sum(-1)
            dan = dan + dab * dtl[:, :, x, None, None]
            tb[:, pos] = (dh * U[:, :, x, :, None]).transpose(-1, -2)
            tc[:, pos] = (ht * Dy[:, :, x, :, None]).transpose(-1, -2)
        da_lanes = da_lanes + dan
    da = torch.zeros((d, n), dtype=dt.dtype)
    for bi in range(b):
        row = torch.zeros((d, n), dtype=dt.dtype)
        for j in range(LANES):
            row = row + da_lanes[bi, j]
        da = da + row
    dbu = _channel_sum(tb)[:, :s]                 # sum_d dh u, (B, S, N)
    ddt = _channel_sum(tt)[:, :s] + _butterfly_sum(bmat * dbu)
    return (ddt, da, dbu * dt[..., None], _channel_sum(tc)[:, :s],
            du[:, :s])


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 300])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-5),
                                       (torch.float32, 1e-4)])
def test_kernel_order_matches_the_explicit_backward(s, n, dtype, tol):
    """The kernel's composition (8 positions a lane, 8 lanes a channel,
    64-position tiles, the reverse steps' pairs scanned from the last lane,
    the sums over 4-channel warps and 32-channel blocks in order, ddt's
    B-term from dB's sums) against ``selective_scan_bwd_ref``: 1e-5 in f64,
    1e-4 in f32; S at the lane and tile edges and one past each, D = 72
    (two blocks and part of one)."""
    ins = [torch.tensor(x) for x in _inputs(s * n, 2, s, 72, n)]
    want = selective_scan_bwd_ref(*ins)
    got = _kernel_scan_bwd(*(x.to(dtype) for x in ins))
    if s == 1:
        got, want = got[:1] + got[2:], want[:1] + want[2:]
        for g, w in zip(got, want):
            assert float((g.double() - w).abs().max()) <= tol * float(
                w.abs().max())
        return
    _held(got, want, tol)


# -- the routing ------------------------------------------------------------
def _leaves(dtype=torch.float32):
    return [torch.tensor(x, dtype=dtype).requires_grad_()
            for x in _inputs(6, 2, 20, 8, 8)[:5]]


def test_grad_mode_goes_through_the_function():
    y, h_last = ops.selective_scan(*_leaves())
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    y.sum().backward()
    with torch.no_grad():
        plain, _ = ops.selective_scan(*_leaves())
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, y.detach(), rtol=0, atol=0)


def test_gradients_come_back_in_each_inputs_type():
    """bf16 B, C slices of one projection and bf16 u, as the model's bf16
    training passes them: each gradient in its input's type and shape."""
    dt, a, bmat, cmat, u = (x.detach() for x in _leaves())
    proj = torch.cat([bmat, cmat], -1).bfloat16().requires_grad_()
    ub = u.bfloat16().requires_grad_()
    y, _ = ops.selective_scan(dt, a, proj[..., :8], proj[..., 8:], ub)
    gp, gu = torch.autograd.grad(y.sum(), (proj, ub))
    assert gp.dtype == torch.bfloat16 and gp.shape == proj.shape
    assert gu.dtype == torch.bfloat16 and gu.shape == ub.shape


def test_state_gradients_are_refused():
    xs = _leaves()
    h0 = torch.zeros(2, 8, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="h0"):
        ops.selective_scan(*xs, h0)
    with pytest.raises(NotImplementedError, match="h0"):
        ops.selective_scan(*xs, h0.detach())
    y, h_last = ops.selective_scan(*xs)
    with pytest.raises(NotImplementedError, match="h_last"):
        (y.sum() + h_last.sum()).backward()
    with torch.no_grad():
        ops.selective_scan(*xs, h0.detach())
