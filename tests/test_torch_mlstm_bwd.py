"""The chunkwise mLSTM's gradient in the port: the explicit plain backward
(``kernels/mlstm/ref.py``'s ``mlstm_chunkwise_bwd_ref``) against autograd
through the plain forward and against ``jax.vjp`` of the reference's
``mlstm_chunkwise``, a plain model of the backward kernel's passes
(``kernels/csrc/mlstm_bwd.cu``), and the routing through the ``MLSTM``
autograd Function.

Bars: against autograd 1e-10 of each gradient's largest magnitude in f64
and 1e-5 in f32 (the same arithmetic in another order); against the
reference 1e-4 in f32; the kernel's model 1e-5 in f64 and 1e-4 in f32
(in f32 with the kernel's three TF32 passes a product), the kernel's own
bar on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.models.xlstm import mlstm_chunkwise as j_mlstm_chunkwise
from repro_torch.kernels.mlstm import ops
from repro_torch.kernels.mlstm.ref import (M_INIT, mlstm_chunkwise_bwd_ref,
                                           mlstm_chunkwise_ref)

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


NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")


def _inputs(seed, b, s, h, dh):
    """q, k, v, logi, logf and a cotangent, numpy f64: logi spread so that
    both branches of ``max(|den|, e^{-m})`` win at some positions."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)) * 0.6 for _ in range(3))
    logi = rng.standard_normal((b, s, h)) * 1.5 - 1.0
    logf = -np.log1p(np.exp(-(rng.standard_normal((b, s, h)) + 2.0)))
    dout = rng.standard_normal((b, s, h, dh))
    return q, k, v, logi, logf, dout


def _held(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, name


def _autograd(ins, dtype):
    q, k, v, li, lf, dout = (torch.tensor(x, dtype=dtype) for x in ins)
    xs = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
    out, _ = mlstm_chunkwise_ref(*xs)
    return out.detach(), torch.autograd.grad(out, xs, dout), (q, k, v, li,
                                                              lf, dout)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_explicit_backward_matches_autograd(s, dtype, tol):
    """The explicit reverse recurrence against autograd through
    ``mlstm_chunkwise_ref`` (256-position chunks, the padding of S = 300):
    every gradient, both branches of the floor taken."""
    ins = _inputs(s, 2, s, 2, 16)
    out, want, (q, k, v, li, lf, dout) = _autograd(ins, dtype)
    got = mlstm_chunkwise_bwd_ref(q, k, v, li, lf, out, dout)
    assert all(g.dtype == dtype for g in got)
    _held(got, want, tol)


def test_both_branches_of_the_floor_are_taken():
    """The inputs of these tests put positions on both sides of
    ``max(|den|, e^{-m})``, and the broken variants that chip_smoke.py's
    controls use (the floor held constant; dC and dn not carried across
    chunks) move the gradients by far more than the f32 bar."""
    q, k, v, li, lf, dout = (torch.tensor(x) for x in _inputs(300, 2, 300,
                                                              2, 16))
    # the global form: den_t = sum_u S_tu e^{a_u - G_t}, floor e^{-F_t - G_t}
    f = torch.cumsum(lf, 1)
    a = li - f
    g = torch.cummax(a, 1).values
    p = torch.exp(a[:, None] - g[:, :, None]) * torch.tril(  # (B, t, u, H)
        torch.ones(300, 300, dtype=torch.bool))[None, :, :, None]
    den = (torch.einsum("bthd,buhd->btuh", q, k) / 4.0 * p).sum(2)
    floor_wins = den.abs() < torch.exp(-(f + g))
    assert 0.1 < float(floor_wins.double().mean()) < 0.9
    out, _ = mlstm_chunkwise_ref(q, k, v, li, lf)
    want = mlstm_chunkwise_bwd_ref(q, k, v, li, lf, out, dout)
    for kw in ({"drop_stabiliser": True}, {"drop_carry": True}):
        got = mlstm_chunkwise_bwd_ref(q, k, v, li, lf, out, dout, **kw)
        worst = max(float((x - w).abs().max() / w.abs().max())
                    for x, w in zip(got, want))
        assert worst > 1e-2, kw


@pytest.mark.parametrize("s", SIZES)
def test_explicit_backward_matches_the_reference_vjp(s):
    """Against ``jax.vjp`` of ``repro.models.xlstm.mlstm_chunkwise`` on the
    same f32 inputs (the reference's own padding and chunk)."""
    ins = [x.astype(np.float32) for x in _inputs(s + 7, 2, s, 2, 16)]
    q, k, v, li, lf, dout = ins
    jout, vjp = jax.vjp(lambda *a: j_mlstm_chunkwise(*a)[0],
                        *map(jnp.asarray, (q, k, v, li, lf)))
    want = vjp(jnp.asarray(dout, dtype=jnp.float32))
    got = mlstm_chunkwise_bwd_ref(*(torch.from_numpy(x) for x in (
        q, k, v, li, lf)), torch.from_numpy(np.asarray(jout)),
        torch.from_numpy(dout))
    _held(got, want, 1e-4)


def test_function_passes_gradcheck():
    """``torch.autograd.gradcheck`` of the ``MLSTM`` Function in f64 (its
    plain backward against finite differences), at a few elements."""
    ins = _inputs(3, 1, 9, 1, 4)
    xs = [torch.tensor(x).requires_grad_() for x in ins[:5]]
    assert torch.autograd.gradcheck(lambda *a: ops.MLSTM.apply(*a)[0], xs)


# -- a model of the backward kernel's passes (kernels/csrc/mlstm_bwd.cu) -------
Q, T = 64, 64     # chunk, state rows (and dk's column block) a walk block
GB_PER, GB_WIN = 8, 2048    # the gates' pass: positions a thread, a window


def _after_scan(a, b):
    """For pairs (a, b) of x_t = b_t + a_t x_{t+1}, one a thread of the
    gates' pass (last dim, 256 threads), the composition of the threads after
    each, in the kernel's order: a warp's 32 by shuffles (offsets 1 to 16),
    the warps' totals from the last warp back, the next thread's result (the
    later warps' for a warp's last lane)."""
    lead = a.shape[:-1]
    a, b = a.reshape(*lead, 8, 32), b.reshape(*lead, 8, 32)
    off = 1
    while off < 32:
        oa = torch.nn.functional.pad(a[..., off:], (0, off), value=1.0)
        ob = torch.nn.functional.pad(b[..., off:], (0, off), value=0.0)
        b = a * ob + b
        a = a * oa
        off *= 2
    ta = [None] * 8
    tb = [None] * 8
    ca, cb = torch.ones_like(a[..., 0, 0]), torch.zeros_like(b[..., 0, 0])
    for w in reversed(range(8)):
        ta[w], tb[w] = ca, cb
        cb = a[..., w, 0] * cb + b[..., w, 0]
        ca = a[..., w, 0] * ca
    ta, tb = torch.stack(ta, -1)[..., None], torch.stack(tb, -1)[..., None]
    ia, ib = a * ta, a * tb + b
    ea = torch.cat([ia[..., 1:], ta], -1).reshape(*lead, 256)
    eb = torch.cat([ib[..., 1:], tb], -1).reshape(*lead, 256)
    return ea, eb


def _tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero, in f32: the kernel's ``cvt.rna.tf32.f32``."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b):
    """``a @ b`` as the kernel's tensor cores take it: in f32 three TF32
    passes, lo hi + hi lo + hi hi (hi = a rounded to TF32, lo = the rest
    rounded likewise), summed in f32; in f64 the exact product (the passes'
    order alone)."""
    if a.dtype != torch.float32:
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _kernel_bwd(q, k, v, logi, logf, out, dout):
    """mlstm_bwd.cu's passes in plain PyTorch, in the dtype of the inputs
    (every dh^2 and 64 x 64 product through :func:`_mm`): A. each
    64-position chunk's gates (the stabiliser carried as a scalar); N. each
    chunk's share of n, sum_p e^{a_p - G_end} k_p; R. per chunk n entering
    it from the shares before it, q k^T and dout v^T, per position W's row
    sum, q . n, dout . out, Z, dden, dm and dS, and the A operands dS /
    sqrt(dh), its transpose and (W / Z)^T; W. the forward walk (C from the
    first chunk on, each chunk's dq from C entering it, its dS k and n) and
    the reverse walk (dC and dn from the last chunk back, each chunk's dk
    from dC leaving it, its dS^T q and dn; k . dk by blocks of T columns;
    dC leaving each chunk kept); V. dv from dC leaving the chunk and (W /
    Z)^T dout; D. the gates: k . dk summed over the blocks in order, G's
    gradient summed over each run of one running max into its first
    position and dlogf's reverse running sum, both as the kernel's scans
    (:func:`_after_scan`) over windows of GB_WIN positions from the last."""
    b, s, h, dh = q.shape
    dt = q.dtype
    nc = -(-s // Q)
    pad = nc * Q - s
    P = lambda x: torch.nn.functional.pad(  # noqa: E731
        x, (0, 0) * (x.dim() - 2) + (0, pad))
    q, k, v, out, dout = (P(x) for x in (q, k, v, out, dout))
    li, lf = P(logi), P(logf)
    scale = dh ** -0.5
    rows = lambda x, j: x[:, j * Q:(j + 1) * Q].transpose(1, 2)  # noqa
    chunked = lambda x: x.reshape(b, nc, Q, h).permute(0, 3, 1, 2)  # noqa
    valid = (torch.arange(nc * Q) < s).reshape(nc, Q)
    zero = torch.zeros((), dtype=dt)
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    # A. gates (B, H, chunk, Q)
    f = torch.cumsum(chunked(lf), dim=-1)
    src = chunked(li) - f
    run = torch.cummax(src, dim=-1).values
    m = torch.full((b, h), M_INIT, dtype=dt)
    m_prev, g_last, decay = [], [], []
    for j in range(nc):
        last = min(s, (j + 1) * Q) - 1 - j * Q
        gl = torch.maximum(m, run[..., j, last])
        m_prev.append(m)
        g_last.append(gl)
        decay.append(torch.exp(m - gl))
        m = f[..., j, last] + gl
    m_prev, g_last = torch.stack(m_prev, -1), torch.stack(g_last, -1)
    g = torch.maximum(m_prev[..., None], run)
    mt = f + g
    inter = torch.where(valid, torch.exp(m_prev[..., None] - g), zero)
    coeff = torch.where(valid, torch.exp(src - g_last[..., None]), zero)
    # N. each chunk's share of n; n entering each chunk
    ksum = [(coeff[..., j, :, None] * rows(k, j)).sum(-2) for j in range(nc)]
    n_in, n = [], torch.zeros((b, h, dh), dtype=dt)
    for j in range(nc):
        n_in.append(n)
        n = decay[j][..., None] * n + ksum[j]
    # R. per chunk
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    invz, dden, dm, rowv = (torch.zeros((b, h, nc, Q), dtype=dt)
                            for _ in range(4))
    amat = []
    for j in range(nc):
        qj, kj, vj = rows(q, j), rows(k, j), rows(v, j)
        dj, oj = rows(dout, j), rows(out, j)
        dmat = torch.where(mask & valid[j][:, None], torch.exp(
            src[..., j, None, :] - g[..., j, :, None]), zero)
        wm = _mm(qj, tr(kj)) * scale * dmat
        den = wm.sum(-1) + inter[..., j, :] * (
            (qj @ n_in[j][..., None])[..., 0] * scale)
        floor = torch.exp(-mt[..., j, :])
        z = torch.maximum(den.abs(), floor) + 1e-6
        doo = (dj * oj).sum(-1)
        dz = -doo / z
        share = torch.where(den.abs() == floor, 0.5, 1.0).to(dt)
        dd = torch.where(den.abs() >= floor, dz * share * torch.sign(den),
                         zero)
        ok = valid[j]
        dden[..., j, :] = torch.where(ok, dd, zero)
        dm[..., j, :] = torch.where(ok & (den.abs() <= floor),
                                    -dz * share * floor, zero)
        invz[..., j, :] = torch.where(ok, 1.0 / z, zero)
        rowv[..., j, :] = torch.where(ok, doo + dd * den, zero)
        ds = scale * (_mm(dj, tr(vj)) * invz[..., j, :, None]
                      + dden[..., j, :, None]) * dmat
        amat.append((ds, tr(ds), tr(wm * invz[..., j, :, None])))
    qz = scale * inter * invz            # dq's row scale, dC's weights
    qd = scale * inter * dden            # dq's n term, dn's weights
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    tc = min(T, dh)
    kdk = torch.zeros((b, h, nc, Q, dh // tc), dtype=dt)
    # W. forward: C entering each chunk
    c = torch.zeros((b, h, dh, dh), dtype=dt)
    for j in range(nc):
        qj, kj, vj, dj = rows(q, j), rows(k, j), rows(v, j), rows(dout, j)
        gq = (qz[..., j, :, None] * _mm(dj, tr(c)) + _mm(amat[j][0], kj)
              + qd[..., j, :, None] * n_in[j][..., None, :])
        dq[:, j * Q:(j + 1) * Q] = gq.transpose(1, 2)
        c = decay[j][..., None, None] * c + _mm(
            tr(coeff[..., j, :, None] * kj), vj)
    # W. reverse: dC and dn leaving each chunk
    dc = torch.zeros((b, h, dh, dh), dtype=dt)
    dn = torch.zeros((b, h, dh), dtype=dt)
    dcs = [None] * nc
    for j in reversed(range(nc)):
        qj, kj, vj, dj = rows(q, j), rows(k, j), rows(v, j), rows(dout, j)
        cf = coeff[..., j, :, None]
        gk = (cf * _mm(vj, tr(dc)) + _mm(amat[j][1], qj)
              + cf * dn[..., None, :])
        dk[:, j * Q:(j + 1) * Q] = gk.transpose(1, 2)
        kdk[..., j, :, :] = (gk * kj).reshape(b, h, Q, dh // tc, tc).sum(-1)
        dcs[j] = dc
        dc = decay[j][..., None, None] * dc + _mm(
            tr(qz[..., j, :, None] * qj), dj)
        dn = decay[j][..., None] * dn + (qd[..., j, :, None] * qj).sum(-2)
    # V. dv
    for j in range(nc):
        kj, dj = rows(k, j), rows(dout, j)
        gv = (coeff[..., j, :, None] * _mm(kj, dcs[j])
              + _mm(amat[j][2], dj))
        dv[:, j * Q:(j + 1) * Q] = gv.transpose(1, 2)
    # D. the gates: k . dk over the blocks in order; R and dlogf by scans
    da = kdk[..., 0]
    for x in range(1, dh // tc):
        da = da + kdk[..., x]
    flat = lambda x: x.reshape(b, h, nc * Q)[..., :s]  # noqa: E731
    da, dg, dmf = flat(da), flat(dm - rowv), flat(dm)
    srcf, gf, mtf = (x.reshape(b, h, nc * Q) for x in (src, g, mt))
    t_ = torch.arange(s)
    prev = torch.where(t_ % Q != 0, gf[..., (t_ - 1).clamp(min=0)],
                       torch.where(t_ > 0, mtf[..., (t_ - 1).clamp(min=0)],
                                   torch.full((), M_INIT, dtype=dt)))
    rec = srcf[..., :s] >= prev
    ra = torch.cat([(~rec[..., 1:]).to(dt), torch.zeros((b, h, 1), dtype=dt)],
                   -1)
    dli = torch.zeros((b, h, s), dtype=dt)
    dlf = torch.zeros((b, h, s), dtype=dt)
    cr = cf = torch.zeros((b, h), dtype=dt)
    for w1 in range(s, 0, -GB_WIN):
        w0 = max(0, w1 - GB_WIN)
        cut = lambda x, fill: torch.nn.functional.pad(  # noqa: E731
            x[..., w0:w1], (0, GB_WIN - (w1 - w0)), value=fill).reshape(
                b, h, GB_WIN // GB_PER, GB_PER)
        wdg, wra, wda, wrec = (cut(dg, 0.0), cut(ra, 1.0), cut(da, 0.0),
                               cut(rec.to(dt), 0.0) > 0)
        a, bb = torch.ones((b, h, GB_WIN // GB_PER), dtype=dt), 0 * wdg[..., 0]
        for x in reversed(range(GB_PER)):
            bb = wra[..., x] * bb + wdg[..., x]
            a = a * wra[..., x]
        ea, eb = _after_scan(a, bb)
        r = ea * cr[..., None] + eb
        dfc = torch.zeros_like(wdg)
        wdl = torch.zeros_like(wdg)
        for x in reversed(range(GB_PER)):
            r = wra[..., x] * r + wdg[..., x]
            wdl[..., x] = torch.where(wrec[..., x], wda[..., x] + r,
                                      wda[..., x])
            dfc[..., x] = cut(dmf, 0.0)[..., x] - wdl[..., x]
        cr = r[..., 0]
        f = torch.zeros_like(a)
        for x in reversed(range(GB_PER)):
            f = f + dfc[..., x]
        _, eb = _after_scan(torch.ones_like(f), f)
        y = eb + cf[..., None]
        wdf = torch.zeros_like(wdg)
        for x in reversed(range(GB_PER)):
            y = y + dfc[..., x]
            wdf[..., x] = y
        cf = y[..., 0]
        dli[..., w0:w1] = wdl.reshape(b, h, GB_WIN)[..., :w1 - w0]
        dlf[..., w0:w1] = wdf.reshape(b, h, GB_WIN)[..., :w1 - w0]
    return (dq[:, :s], dk[:, :s], dv[:, :s], dli.permute(0, 2, 1),
            dlf.permute(0, 2, 1))


def test_tf32_rounding_is_to_nearest_ties_away():
    """The model's TF32 rounding: 10 mantissa bits, a tie away from zero
    (as ``cvt.rna``), the rest exact in f32."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 3.0, -2.0 ** -130])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 * 2 ** -10, 3.0, -2.0 ** -130])
    assert torch.equal(_tf32(x), want)
    y = torch.randn(1000, dtype=torch.float32)
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2 ** -20


@pytest.mark.parametrize("s", [2, 63, 64, 65, 300, 1100])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-5),
                                       (torch.float32, 1e-4)])
def test_kernel_passes_match_the_explicit_backward(s, dtype, tol):
    """The kernel's decomposition (64-position chunks, n from each chunk's
    share, the forward walk's dq from the state entering each chunk, the
    reverse walk's dk from dC leaving it, dv from the kept dC, k . dk by
    64-column blocks, the gates' runs; in f32 every product as three TF32
    passes) against ``mlstm_chunkwise_bwd_ref`` (256-position chunks): 1e-5
    in f64, 1e-4 in f32; S at the chunk edge, past the 256 chunk and past
    16 chunks."""
    b, h, dh = 1, 2, 128 if s < 1000 else 64
    ins = _inputs(s + 1, b, s, h, dh)
    q, k, v, li, lf, dout = (torch.tensor(x) for x in ins)
    out, _ = mlstm_chunkwise_ref(q, k, v, li, lf)
    want = mlstm_chunkwise_bwd_ref(q, k, v, li, lf, out, dout)
    got = _kernel_bwd(*(x.to(dtype) for x in (q, k, v, li, lf, out, dout)))
    _held(got, want, tol)


@pytest.mark.parametrize("s", [65, 300])
@pytest.mark.parametrize("dh", [32, 128])
def test_kernel_split_matches_the_reference_vjp(s, dh):
    """The kernel's passes with its three TF32 passes, in f32, against
    ``jax.vjp`` of the reference's ``mlstm_chunkwise`` on the same inputs
    (the reference's forward output): each gradient within 1e-4 of its
    largest."""
    ins = [x.astype(np.float32) for x in _inputs(s + dh, 1, s, 2, dh)]
    q, k, v, li, lf, dout = ins
    jout, vjp = jax.vjp(lambda *a: j_mlstm_chunkwise(*a)[0],
                        *map(jnp.asarray, (q, k, v, li, lf)))
    want = vjp(jnp.asarray(dout, dtype=jnp.float32))
    got = _kernel_bwd(*(torch.from_numpy(x) for x in (q, k, v, li, lf)),
                      torch.from_numpy(np.asarray(jout)),
                      torch.from_numpy(dout))
    _held(got, want, 1e-4)


# -- the routing ------------------------------------------------------------
def _leaves(s=40, requires=True):
    q, k, v, li, lf, _ = (torch.tensor(x, dtype=torch.float32)
                          for x in _inputs(9, 1, s, 2, 8))
    return [t.requires_grad_(requires) for t in (q, k, v, li, lf)]


def test_grad_mode_goes_through_the_function():
    out, (c, n, m) = ops.mlstm(*_leaves())
    assert type(out.grad_fn).__name__ == "MLSTMBackward"
    out.sum().backward()
    with torch.no_grad():
        plain, _ = ops.mlstm(*_leaves())
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, out.detach(), rtol=0, atol=0)


def test_state_gradients_are_refused():
    xs = _leaves()
    st = (torch.zeros(1, 2, 8, 8, requires_grad=True), torch.zeros(1, 2, 8),
          torch.full((1, 2), -1e9))
    with pytest.raises(NotImplementedError, match="state"):
        ops.mlstm(*xs, st)
    with pytest.raises(NotImplementedError, match="state"):
        ops.mlstm(*xs, tuple(t.detach() for t in st))
    out, (c, n, m) = ops.mlstm(*xs)
    with pytest.raises(NotImplementedError, match="final state"):
        (out.sum() + c.sum()).backward()
    # a state under no_grad still serves
    with torch.no_grad():
        ops.mlstm(*xs, tuple(t.detach() for t in st))
