"""The port's chunkwise mLSTM (``repro_torch.kernels.mlstm``) and xLSTM
blocks (``repro_torch.models.xlstm``) against the reference's, on the CPU,
on the same numpy inputs.

Bars:
- the plain version against the Pallas kernel in interpret mode, at
  tests/test_kernels.py's shapes: rtol 1e-3, atol 5e-4, the bar that test
  holds the kernel to (the Pallas kernel starts m at -1e30, clamps its floor
  and uses chunks of 32-128);
- the plain version against the reference model's ``mlstm_chunkwise``,
  states in and out: 2e-5 in f32 (the same chunks; reduction order only),
  with inputs at half unit scale, as the model's projections give them
  (at unit scale the denominators sit near their floor and amplify the
  order of sums); the final ``m`` exactly where the padding floors it;
- the blocks against the reference's blocks: 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.kernels.mlstm.mlstm import mlstm_chunkwise_pallas
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.kernels.mlstm import ops
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref, pads
from repro_torch.models import xlstm as X


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _close(got, want, rtol, atol=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=rtol if atol is None else atol)


def _inputs(seed, b, s, h, dh, scale=1.0, gate_shift=2.0):
    """q, k, v (B, S, H, dh), logi, logf (B, S, H) as numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh), dtype=np.float32) * scale
               for _ in range(3))
    li = rng.standard_normal((b, s, h), dtype=np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        _j(rng.standard_normal((b, s, h), dtype=np.float32) + gate_shift)))
    return q, k, v, li, lf


def _state(seed, b, h, dh, kind):
    """A state to carry in: None, the serving path's fresh state, or a
    nonzero one."""
    if kind == "none":
        return None
    if kind == "fresh":
        return (np.zeros((b, h, dh, dh), np.float32),
                np.zeros((b, h, dh), np.float32),
                np.full((b, h), -1e9, np.float32))
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, dh, dh), dtype=np.float32) * 0.1,
            rng.standard_normal((b, h, dh), dtype=np.float32) * 0.1,
            rng.standard_normal((b, h), dtype=np.float32))


def _both(ins, st):
    """The plain version and the reference's ``mlstm_chunkwise``."""
    got = mlstm_chunkwise_ref(*map(_t, ins),
                              None if st is None else tuple(map(_t, st)))
    want = JX.mlstm_chunkwise(*map(_j, ins),
                              state=None if st is None else tuple(map(_j, st)))
    return got, want


# -- the plain version -------------------------------------------------------
@pytest.mark.parametrize("b,s,h,dh,chunk", [
    (2, 256, 4, 64, 64),
    (1, 512, 2, 128, 128),
    (2, 128, 8, 32, 32),
])
def test_plain_matches_pallas_kernel(b, s, h, dh, chunk):
    ins = _inputs(0, b, s, h, dh)
    got, _ = mlstm_chunkwise_ref(*map(_t, ins))
    want = mlstm_chunkwise_pallas(*map(_j, ins), chunk=chunk, interpret=True)
    _close(got, want, 1e-3, 5e-4)


@pytest.mark.parametrize("state", ["none", "fresh", "carried"])
@pytest.mark.parametrize("s", [64, 256, 300, 512])
def test_plain_matches_mlstm_chunkwise_with_states(s, state):
    b, h, dh = 2, 4, 32
    ins = _inputs(s, b, s, h, dh, scale=0.5)
    st = _state(s + 1, b, h, dh, state)
    (out, fin), (jout, jfin) = _both(ins, st)
    assert out.shape == (b, s, h, dh) and out.dtype == torch.float32
    _close(out, jout, 2e-5)
    for a, w in zip(fin, jfin):
        _close(a, w, 2e-5)


@pytest.mark.parametrize("first,second", [(256, 256), (128, 64)])
def test_plain_hands_its_state_on(first, second):
    """A sequence fed in two calls, the first call's final state handed to
    the second, gives the outputs and final state of one call (no call
    pads: S = 512 runs two chunks of 256, S = 192 one chunk)."""
    ins = tuple(map(_t, _inputs(14, 1, first + second, 2, 64, scale=0.5)))
    st = tuple(map(_t, _state(15, 1, 2, 64, "carried")))
    out, fin = mlstm_chunkwise_ref(*ins, st)
    out1, mid = mlstm_chunkwise_ref(*(a[:, :first] for a in ins), st)
    out2, fin2 = mlstm_chunkwise_ref(*(a[:, first:] for a in ins), mid)
    _close(torch.cat([out1, out2], dim=1), out.numpy(), 2e-5)
    for a, w in zip(fin2, fin):
        _close(a, w.numpy(), 2e-5)


def test_padding_floors_the_final_m_exactly():
    """S = 300 pads to 512 in the reference: the outputs keep their values,
    the final m becomes max(m_S, 0) (here exactly 0, from m_S < 0) and C, n
    are rescaled by exp(m_S - m); a chunk that needs no padding (100)
    leaves m_S."""
    b, s, h, dh = 1, 300, 2, 32
    q, k, v, li, lf = _inputs(3, b, s, h, dh, scale=0.5)
    li = -1.0 - np.abs(li)                  # every input gate below 1
    ins = (q, k, v, li, lf)
    st = _state(4, b, h, dh, "fresh")
    assert pads(s) and not pads(256) and not pads(512) and not pads(100)
    (out, (c, n, m)), (jout, (jc, jn, jm)) = _both(ins, st)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert (m == 0).all()
    unpadded = mlstm_chunkwise_ref(*map(_t, ins), tuple(map(_t, st)),
                                   chunk=100)
    j_unpadded = JX.mlstm_chunkwise(*map(_j, ins), chunk=100,
                                    state=tuple(map(_j, st)))
    m_s = unpadded[1][2]
    assert (m_s < 0).all()
    _close(m_s, j_unpadded[1][2], 2e-5)
    _close(unpadded[0], out.numpy(), 2e-5)
    rescale = torch.exp(m_s - m)
    _close(unpadded[1][0] * rescale[..., None, None], c.numpy(), 2e-5)
    _close(unpadded[1][1] * rescale[..., None], n.numpy(), 2e-5)


def test_parallel_form_matches_chunkwise():
    """The quadratic form (the port's test oracle) against the plain
    chunkwise version and the reference's ``mlstm_parallel``."""
    ins = _inputs(5, 2, 200, 4, 32, scale=0.5)
    par = X.mlstm_parallel(*map(_t, ins))
    _close(par, JX.mlstm_parallel(*map(_j, ins)), 2e-5)
    _close(mlstm_chunkwise_ref(*map(_t, ins))[0], par.numpy(), 1e-4)


# -- the blocks ---------------------------------------------------------------
@pytest.fixture(scope="module")
def cfgs():
    jcfg = j_get_config("xlstm-350m", smoke=True).replace(dtype="float32")
    return jcfg, get_config("xlstm-350m", smoke=True).replace(dtype="float32")


@pytest.mark.parametrize("s", [40, 300])
def test_mlstm_block_prefill_and_decode_match(cfgs, s):
    jcfg, cfg = cfgs
    jp = _np(JX.init_mlstm(jax.random.PRNGKey(1), jcfg))
    p = {k: _t(v) for k, v in jp.items()}
    b = 2
    x = np.random.default_rng(6).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    # no state (the training form)
    want, _ = JX.mlstm_block(jp, _j(x), jcfg)
    got, none = X.mlstm_block(p, _t(x), cfg)
    assert none is None
    _close(got, want, 2e-5)
    # prefill from the fresh state, then one-token steps
    jst = JX.init_mlstm_state(jcfg, b)
    st = X.init_mlstm_state(cfg, b, "cpu")
    for a, w in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    want, jst = JX.mlstm_block(jp, _j(x), jcfg, state=jst)
    got, st = X.mlstm_block(p, _t(x), cfg, state=st)
    _close(got, want, 2e-5)
    for a, w in zip(st, jst):
        _close(a, w, 2e-5)
    for i in range(3):
        x1 = np.random.default_rng(7 + i).standard_normal(
            (b, 1, cfg.d_model), dtype=np.float32)
        want, jst = JX.mlstm_block(jp, _j(x1), jcfg, state=jst)
        got, st = X.mlstm_block(p, _t(x1), cfg, state=st)
        _close(got, want, 2e-5)
        for a, w in zip(st, jst):
            _close(a, w, 2e-5)


def test_slstm_block_prefill_and_decode_match(cfgs):
    jcfg, cfg = cfgs
    jp = _np(JX.init_slstm(jax.random.PRNGKey(2), jcfg))
    p = {k: _t(v) for k, v in jp.items()}
    b, s = 2, 33
    x = np.random.default_rng(8).standard_normal((b, s, cfg.d_model),
                                                 dtype=np.float32)
    want, _ = JX.slstm_block(jp, _j(x), jcfg)
    got, none = X.slstm_block(p, _t(x), cfg)
    assert none is None
    _close(got, want, 2e-5)
    jst = JX.init_slstm_state(jcfg, b)
    st = X.init_slstm_state(cfg, b, "cpu")
    for a, w in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    want, jst = JX.slstm_block(jp, _j(x), jcfg, state=jst)
    got, st = X.slstm_block(p, _t(x), cfg, state=st)
    _close(got, want, 2e-5)
    for i in range(3):
        x1 = np.random.default_rng(9 + i).standard_normal(
            (b, 1, cfg.d_model), dtype=np.float32)
        want, jst = JX.slstm_block(jp, _j(x1), jcfg, state=jst)
        got, st = X.slstm_block(p, _t(x1), cfg, state=st)
        _close(got, want, 2e-5)
        for a, w in zip(st, jst):
            _close(a, w, 2e-5)


def test_one_token_steps_match_the_chunkwise_block(cfgs):
    """The one-token recurrence, step by step from the fresh state, against
    the chunkwise block over the whole sequence (tests/test_kernels.py's
    ground-truth check, with its bar)."""
    _, cfg = cfgs
    jp = _np(JX.init_mlstm(jax.random.PRNGKey(3), j_get_config(
        "xlstm-350m", smoke=True)))
    p = {k: _t(v) for k, v in jp.items()}
    x = _t(np.random.default_rng(10).standard_normal(
        (1, 64, cfg.d_model), dtype=np.float32) * 0.5)
    full, _ = X.mlstm_block(p, x, cfg)
    st = X.init_mlstm_state(cfg, 1, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = X.mlstm_block(p, x[:, t:t + 1], cfg, state=st)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full.numpy(), 1e-3, 1e-4)


# -- the wrapper ----------------------------------------------------------
def test_wrapper_takes_the_plain_version_on_cpu():
    ins = tuple(map(_t, _inputs(11, 1, 70, 2, 64, scale=0.5)))
    st = tuple(map(_t, _state(12, 1, 2, 64, "carried")))
    before = ops.launches
    out, fin = ops.mlstm(*ins, st)
    want, wfin = mlstm_chunkwise_ref(*ins, st)
    assert torch.equal(out, want)
    assert all(torch.equal(a, w) for a, w in zip(fin, wfin))
    assert ops.launches == before


def test_kernel_refuses_cpu_tensors():
    ins = tuple(map(_t, _inputs(13, 1, 8, 2, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        ops.mlstm_kernel(*ins)
    with pytest.raises(ValueError, match="CUDA"):
        ops.mlstm_kernel(*ins, tuple(map(_t, _state(0, 1, 2, 64, "fresh"))))


def test_prefill_of_one_token_takes_the_recurrence(cfgs, monkeypatch):
    """A one-token prompt with a state is the recurrence branch, as in the
    reference (``state is not None and s == 1``): the chunkwise entry is
    not called."""
    _, cfg = cfgs
    p = X.init_mlstm(torch.Generator().manual_seed(0), cfg, torch.float32)
    calls = []
    monkeypatch.setattr(ops, "mlstm",
                        lambda *a, **k: calls.append(a) or
                        mlstm_chunkwise_ref(*a, **k))
    x = torch.randn(1, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    X.mlstm_block(p, x, cfg, state=X.init_mlstm_state(cfg, 1, "cpu"))
    assert not calls
    X.mlstm_block(p, torch.cat([x, x], 1), cfg,
                  state=X.init_mlstm_state(cfg, 1, "cpu"))
    assert len(calls) == 1


# -- a model of the CUDA kernel's passes (kernels/csrc/mlstm.cu) -------------
Q = 64          # the kernel's chunk
MLSTM_TOL = 1e-4   # the kernel against the plain version (chip_smoke.py)


def _lane_scan_sum(x: torch.Tensor) -> torch.Tensor:
    """The running sum of 64 values (last dim) in the order the gate pass's
    warp takes it: each lane's pair sum, a Kogge-Stone scan of the 32 pair
    sums (the earlier term first), then a lane's two positions from the
    scan before it."""
    f0, f1 = x[..., 0::2], x[..., 1::2]
    pair = f0 + f1
    for off in (1, 2, 4, 8, 16):
        pair = torch.cat([pair[..., :off], pair[..., :-off] + pair[..., off:]],
                         dim=-1)
    before = torch.cat([torch.zeros_like(pair[..., :1]), pair[..., :-1]],
                       dim=-1)
    first = before + f0
    return torch.stack([first, first + f1], dim=-1).flatten(-2)


def _kernel_passes(q, k, v, logi, logf, state, pad_floor):
    """mlstm.cu's passes in plain PyTorch, in the dtype of the inputs:
    A. the gates of each 64-position chunk (running sum and max, the
    stabiliser carried from chunk to chunk as one scalar); B. the state
    entering every chunk; S and C. each chunk's outputs from its own q, k,
    v and the state entering it alone."""
    b, s, h, dh = q.shape
    dt = q.dtype
    nc = -(-s // Q)
    pad = nc * Q - s
    q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
               for x in (q, k, v))
    li, lf = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (logi, logf))
    scale = dh ** -0.5
    if state is None:
        c = torch.zeros((b, h, dh, dh), dtype=dt)
        n = torch.zeros((b, h, dh), dtype=dt)
        m = torch.full((b, h), -1e30, dtype=dt)
    else:
        c, n, m = state
    # A. gates: (B, H, chunk, Q)
    chunked = lambda x: x.reshape(b, nc, Q, h).permute(0, 3, 1, 2)  # noqa
    f = _lane_scan_sum(chunked(lf))
    src = chunked(li) - f
    run = torch.cummax(src, dim=-1).values
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
    inter = torch.exp(m_prev[..., None] - g)
    coeff = torch.exp(src - g_last[..., None])
    valid = (torch.arange(nc * Q) < s).reshape(nc, Q)
    coeff = torch.where(valid, coeff, torch.zeros((), dtype=dt))
    # B. the state entering each chunk, then the final state
    rows = lambda x, j: x[:, j * Q:(j + 1) * Q].transpose(1, 2)  # noqa
    c_in, n_in = [], []
    for j in range(nc):
        c_in.append(c)
        n_in.append(n)
        kc = coeff[..., j, :, None] * rows(k, j)          # (B, H, Q, dh)
        c = decay[j][..., None, None] * c + kc.transpose(-1, -2) @ rows(v, j)
        n = decay[j][..., None] * n + kc.sum(-2)
    m_out = torch.clamp(m, min=0.0) if pad_floor else m
    rescale = torch.exp(m - m_out)
    final = (c * rescale[..., None, None], n * rescale[..., None], m_out)
    # S and C. the outputs of each chunk
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    outs = []
    for j in range(nc):
        qj, kj, vj = rows(q, j), rows(k, j), rows(v, j)
        w = (qj @ kj.transpose(-1, -2)) * scale * torch.exp(
            src[..., j, None, :] - g[..., j, :, None])
        w = torch.where(mask & valid[j][:, None], w, torch.zeros((), dtype=dt))
        qs = qj * scale
        den = torch.maximum(
            torch.abs(w.sum(-1) + inter[..., j, :] * (qs @ n_in[j][..., None])
                      [..., 0]),
            torch.exp(-mt[..., j, :])) + 1e-6
        o = (w @ vj + inter[..., j, :, None] * (qs @ c_in[j])) / den[..., None]
        outs.append(o.transpose(1, 2))
    return torch.cat(outs, dim=1)[:, :s], final


@pytest.mark.parametrize("state", ["none", "fresh", "carried"])
@pytest.mark.parametrize("s", [2, 63, 64, 65, 256, 257, 980, 1000])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-5),
                                       (torch.float32, MLSTM_TOL)])
def test_kernel_passes_match_the_plain_version(s, state, dtype, tol):
    """The kernel's decomposition (64-position chunks, gates by a lane
    scan, the state entering each chunk, each chunk's outputs from that
    state alone) against ``mlstm_chunkwise_ref`` (256-position chunks):
    1e-5 with the model in f64, ``MLSTM_TOL`` in f32, the kernel's own type;
    outputs and the final C, n, m, with the pad floor exactly where the
    reference pads (S > 256 that 256 does not divide)."""
    b, h, dh = 1, 2, 32
    ins = _inputs(s, b, s, h, dh, scale=0.5)
    st = _state(s + 3, b, h, dh, state)
    want, want_fin = mlstm_chunkwise_ref(
        *map(_t, ins), None if st is None else tuple(map(_t, st)))
    cast = lambda x: torch.from_numpy(np.array(x)).to(dtype)  # noqa: E731
    got, fin = _kernel_passes(*map(cast, ins),
                              None if st is None else tuple(map(cast, st)),
                              pads(s))
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    for a, w in zip(fin, want_fin):
        torch.testing.assert_close(a.float(), w, rtol=tol, atol=tol)


def test_lane_scan_sum_is_a_running_sum():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 64)).astype(np.float64))
    torch.testing.assert_close(_lane_scan_sum(x), torch.cumsum(x, -1),
                               rtol=1e-12, atol=1e-12)
