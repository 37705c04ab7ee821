"""The chunkwise mLSTM's gradient in the port: the explicit plain backward
(``kernels/mlstm/ref.py``'s ``mlstm_chunkwise_bwd_ref``) against autograd
through the plain forward and against ``jax.vjp`` of the reference's
``mlstm_chunkwise``, a plain model of the backward kernel's passes
(``kernels/csrc/mlstm_bwd.cu``), and the routing through the ``MLSTM``
autograd Function.

Bars: against autograd 1e-10 of each gradient's largest magnitude in f64
and 1e-5 in f32 (the same arithmetic in another order); against the
reference 1e-4 in f32; the kernel's model 1e-5 in f64 and 1e-4 in f32,
the kernel's own bar on the card.
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
    want = vjp(jnp.asarray(dout))
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
Q, SLOTS, T = 64, 16, 64     # chunk, chunks a window, columns a block


def _kernel_bwd(q, k, v, logi, logf, out, dout):
    """mlstm_bwd.cu's passes in plain PyTorch, in the dtype of the inputs:
    A. each 64-position chunk's gates (the stabiliser carried as a scalar);
    K. the forward states over every chunk, a checkpoint at each window of
    SLOTS chunks; per window from the last: B. the window's states again
    from its checkpoint, R. per position W's row sum, q . n, dout . out, Z,
    dden, dm and dS, V. the reverse states (dC, dn leaving each chunk) from
    the carry of the window after it, G. dq, dk, dv from the chunk's dS or
    W and the states, k . dk by blocks of T columns; D. the gates: k . dk
    summed over the blocks in order, G's gradient summed over each run of
    one running max into its first position, dlogf's reverse running sum
    one position at a time."""
    b, s, h, dh = q.shape
    dt = q.dtype
    nc = -(-s // Q)
    nw = -(-nc // SLOTS)
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

    def walk(c, n, js, x, rc, y, cc=None, nwt=None):
        """States before each chunk of ``js`` in order, and the last."""
        before = []
        for j in js:
            before.append((c, n))
            xc = rc[..., j, :, None] * rows(x, j)
            yc = rows(y, j) if cc is None else cc[..., j, :, None] * rows(y, j)
            c = decay[j][..., None, None] * c + xc.transpose(-1, -2) @ yc
            wgt = 1.0 if nwt is None else nwt[..., j, :, None]
            n = decay[j][..., None] * n + (xc * wgt).sum(-2)
        return before, (c, n)

    state = (torch.zeros((b, h, dh, dh), dtype=dt),
             torch.zeros((b, h, dh), dtype=dt))
    ck = [state]
    for w in range(nw):                      # K.
        _, state = walk(*state, range(w * SLOTS, min(nc, (w + 1) * SLOTS)),
                        k, coeff, v)
        ck.append(state)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    kdk = torch.zeros((b, h, nc, Q, dh // T), dtype=dt)
    invz, dden, dm, rowv = (torch.zeros((b, h, nc, Q), dtype=dt)
                            for _ in range(4))
    carry = (torch.zeros((b, h, dh, dh), dtype=dt),
             torch.zeros((b, h, dh), dtype=dt))
    for w in reversed(range(nw)):
        js = range(w * SLOTS, min(nc, (w + 1) * SLOTS))
        fwd, _ = walk(*ck[w], js, k, coeff, v)                     # B.
        wd = {}
        for j, (_, n_in) in zip(js, fwd):                          # S., R.
            qj, kj, vj = rows(q, j), rows(k, j), rows(v, j)
            dj, oj = rows(dout, j), rows(out, j)
            dmat = torch.where(mask & valid[j][:, None], torch.exp(
                src[..., j, None, :] - g[..., j, :, None]), zero)
            wm = (qj @ kj.transpose(-1, -2)) * scale * dmat
            den = wm.sum(-1) + inter[..., j, :] * (
                (qj @ n_in[..., None])[..., 0] * scale)
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
            ds = ((dj @ vj.transpose(-1, -2)) * invz[..., j, :, None]
                  + dden[..., j, :, None]) * dmat
            wd[j] = (wm, ds)
        rev, carry = walk(*carry, reversed(js), q, inter * scale, dout,
                          invz, dden)                               # V.
        rev = dict(zip(reversed(js), rev))
        for j, (c_in, n_in) in zip(js, fwd):                        # G.
            wm, ds = wd[j]
            dc, dn = rev[j]
            qj, kj, vj, dj = rows(q, j), rows(k, j), rows(v, j), rows(dout, j)
            it = inter[..., j, :, None]
            cf = coeff[..., j, :, None]
            gq = (scale * ds @ kj + (dj * (scale * it * invz[..., j, :, None]))
                  @ c_in.transpose(-1, -2)
                  + scale * it * dden[..., j, :, None] * n_in[..., None, :])
            gk = (scale * ds.transpose(-1, -2) @ qj
                  + (vj * cf) @ dc.transpose(-1, -2) + cf * dn[..., None, :])
            gv = ((wm * invz[..., j, :, None]).transpose(-1, -2) @ dj
                  + (kj * cf) @ dc)
            for dst, grad in ((dq, gq), (dk, gk), (dv, gv)):
                dst[:, j * Q:(j + 1) * Q] = grad.transpose(1, 2)
            kdk[..., j, :, :] = (gk * kj).reshape(b, h, Q, dh // T, T).sum(-1)
    # D. the gates, one (batch row, head) at a time
    da = kdk.sum(-1) if dh // T == 1 else sum(
        kdk[..., x] for x in range(dh // T))
    flat = lambda x: x.reshape(b, h, nc * Q)  # noqa: E731
    da, dg = flat(da).clone(), flat(dm - rowv)
    srcf, gf, mtf = flat(src), flat(g), flat(mt)
    dli = torch.zeros((b, h, s), dtype=dt)
    dlf = torch.zeros((b, h, s), dtype=dt)
    for bi in range(b):
        for hi in range(h):
            dl = da[bi, hi, :s].clone()
            acc, r = 0.0, -1
            for t in range(s):
                prev = (gf[bi, hi, t - 1] if t % Q else
                        (mtf[bi, hi, t - 1] if t else M_INIT))
                if srcf[bi, hi, t] >= prev:
                    if r >= 0:
                        dl[r] += acc
                    r, acc = t, 0.0
                acc = acc + dg[bi, hi, t]
            dl[r] += acc
            dli[bi, hi] = dl
            runsum = 0.0
            for t in reversed(range(s)):
                runsum = runsum + (flat(dm)[bi, hi, t] - dl[t])
                dlf[bi, hi, t] = runsum
    return (dq[:, :s], dk[:, :s], dv[:, :s], dli.permute(0, 2, 1),
            dlf.permute(0, 2, 1))


@pytest.mark.parametrize("s", [2, 63, 64, 65, 300, 1100])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-5),
                                       (torch.float32, 1e-4)])
def test_kernel_passes_match_the_explicit_backward(s, dtype, tol):
    """The kernel's decomposition (64-position chunks, windows of 16 chunks
    with the forward states again from each window's checkpoint, the
    reverse states carried across windows, dq/dk/dv from the chunk's own
    rows and states, k . dk by 64-column blocks, the gates' runs) against
    ``mlstm_chunkwise_bwd_ref`` (256-position chunks): 1e-5 in f64, 1e-4
    in f32; S at the chunk edge, past the 256 chunk and past one window."""
    b, h, dh = 1, 2, 128 if s < 1000 else 64
    ins = _inputs(s + 1, b, s, h, dh)
    q, k, v, li, lf, dout = (torch.tensor(x) for x in ins)
    out, _ = mlstm_chunkwise_ref(q, k, v, li, lf)
    want = mlstm_chunkwise_bwd_ref(q, k, v, li, lf, out, dout)
    got = _kernel_bwd(*(x.to(dtype) for x in (q, k, v, li, lf, out, dout)))
    _held(got, want, tol)


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
