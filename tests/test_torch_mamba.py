"""The port's selective scan (``repro_torch.kernels.mamba_scan``) and Mamba
block (``repro_torch.models.mamba``) against the reference's, on the CPU,
on the same numpy inputs.

Bars:
- the plain scan against the Pallas kernel in interpret mode and its
  oracle ``mamba_scan_ref``, at tests/test_kernels.py's shapes, fed
  ``a_bar``, ``b_bar`` made in numpy from the same ``dt, a, B, u``:
  rtol 1e-4, atol 1e-4, the bar that test holds the kernel to;
- the plain scan with a carried state against the reference model's
  ``_chunked_selective_scan`` plus the ``bsdn,bsn->bsd`` contraction
  (associative scan within 256-position chunks, so products are grouped
  differently): 1e-4 on ``y`` and the final state;
- the Mamba block, prefill with and without a state and one decode step,
  against the reference's block: 1e-4 on outputs and states (f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.kernels.mamba_scan.mamba_scan import mamba_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_scan_ref
from repro.models import mamba as JM
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import (
    mamba_scan_ref,
    selective_scan_ref,
)
from repro_torch.models import mamba as MB
from repro_torch.models import model as M

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _scan_inputs(seed, b, s, d, n):
    """dt (B, S) > 0, a (D, N) < 0, bmat, cmat (B, S, N), u (B, S, D): numpy
    f32, at scales that keep the decays exp(dt a) between ~0.04 and ~1, so
    the state remembers tens of positions."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.2, (b, s)).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                         (d, n)).copy() * rng.uniform(0.5, 1.0, (d, 1)).astype(
                             np.float32)
    bmat, cmat = (rng.standard_normal((b, s, n), dtype=np.float32)
                  for _ in range(2))
    u = rng.standard_normal((b, s, d), dtype=np.float32)
    return dt, a, bmat, cmat, u


def _discretise(dt, a, bmat, u):
    """a_bar, b_bar (B, S, D, N) in numpy, in the reference's order."""
    dt4 = dt[:, :, None, None]
    return (np.exp(dt4 * a).astype(np.float32),
            (dt4 * bmat[:, :, None, :] * u[..., None]).astype(np.float32))


@pytest.mark.parametrize("b,s,d,n,blk_d,chunk", [
    (2, 256, 256, 16, 128, 128),
    (1, 512, 512, 8, 256, 64),
    (2, 128, 64, 16, 64, 128),
])
def test_plain_scan_matches_pallas_kernel_and_oracle(b, s, d, n, blk_d,
                                                     chunk):
    dt, a, bmat, cmat, u = _scan_inputs(s + d, b, s, d, n)
    a_bar, b_bar = _discretise(dt, a, bmat, u)
    pallas = mamba_scan(_j(a_bar), _j(b_bar), _j(cmat), blk_d=blk_d,
                        chunk=chunk, interpret=True)
    oracle = j_mamba_scan_ref(_j(a_bar), _j(b_bar), _j(cmat))
    y, h = selective_scan_ref(_t(dt), _t(a), _t(bmat), _t(cmat), _t(u))
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    _close(y, pallas)
    _close(y, oracle)
    _close(mamba_scan_ref(_t(a_bar), _t(b_bar), _t(cmat)), oracle)


def _model_scan(dt, a, bmat, cmat, u, h0):
    """The reference model's scan: ``_chunked_selective_scan`` of a_bar,
    b_bar formed as ``mamba_block`` forms them, then the contraction."""
    dtf = _j(dt)[..., None]
    a_bar = jnp.exp(dtf[..., None] * _j(a)[None, None])
    b_bar = dtf[..., None] * _j(bmat)[:, :, None, :] * _j(u)[..., None]
    hs, h_last = JM._chunked_selective_scan(a_bar, b_bar, _j(h0), JM.CHUNK)
    return jnp.einsum("bsdn,bsn->bsd", hs, _j(cmat)), h_last


@pytest.mark.parametrize("s", [1, 5, 256, 300])
def test_plain_scan_with_state_matches_the_model_scan(s):
    """A carried nonzero state in, the final state out; S = 300 is ragged
    against the reference's 256-position chunk (padded with a = 1, b = 0,
    which leaves the final state as it is)."""
    b, d, n = 2, 48, 16
    dt, a, bmat, cmat, u = _scan_inputs(s, b, s, d, n)
    h0 = np.random.default_rng(7).standard_normal((b, d, n), dtype=np.float32)
    want_y, want_h = _model_scan(dt, a, bmat, cmat, u, h0)
    y, h = selective_scan_ref(_t(dt), _t(a), _t(bmat), _t(cmat), _t(u),
                              _t(h0))
    _close(y, want_y)
    _close(h, want_h)


def test_plain_scan_hands_its_state_on():
    """Two calls, the second from the first's final state, equal one
    call over both halves."""
    b, s, d, n = 1, 90, 32, 16
    dt, a, bmat, cmat, u = (_t(x) for x in _scan_inputs(3, b, s, d, n))
    y, h = selective_scan_ref(dt, a, bmat, cmat, u)
    y1, h1 = selective_scan_ref(dt[:, :40], a, bmat[:, :40], cmat[:, :40],
                                u[:, :40])
    y2, h2 = selective_scan_ref(dt[:, 40:], a, bmat[:, 40:], cmat[:, 40:],
                                u[:, 40:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, h, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    return jcfg, get_config(ARCH, smoke=True).replace(dtype="float32")


def _params(jcfg, seed=0):
    jp = JM.init_mamba(jax.random.PRNGKey(seed), jcfg)
    # the reference's dt_bias and zero conv bias leave too little to see:
    # move them so that every parameter reaches the output
    rng = np.random.default_rng(seed)
    jp = _np(jp)
    jp["conv_b"] = rng.standard_normal(jp["conv_b"].shape).astype(
        np.float32) * 0.1
    jp["dt_bias"] = np.full((1,), -1.0, np.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def test_init_mamba_has_the_reference_tree(cfgs):
    jcfg, cfg = cfgs
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        JM.init_mamba(jax.random.PRNGKey(0), jcfg))
    p = MB.init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in p.items()}
    assert got == want
    jp = _np(JM.init_mamba(jax.random.PRNGKey(0), jcfg))
    for k in ("conv_b", "dt_bias", "d_skip"):
        _close(p[k], jp[k], 0.0)
    # XLA's f32 log is one ulp off the correctly rounded log(7)
    _close(p["a_log"], jp["a_log"], 1e-7)
    st = MB.init_mamba_state(cfg, 3, "cpu")
    jst = JM.init_mamba_state(jcfg, 3)
    assert [tuple(t.shape) for t in st] == [a.shape for a in jst]
    assert all(t.dtype == torch.float32 and not t.any() for t in st)


@pytest.mark.parametrize("s", [7, 300])
def test_mamba_block_prefill_and_decode_match(cfgs, s):
    """Prefill without a state, prefill from a nonzero state (the serving
    path), then three decode steps (S = 1 with a state): outputs and
    states against the reference's block."""
    jcfg, cfg = cfgs
    jp, p = _params(jcfg, seed=s)
    b, di, n = 2, cfg.mamba_expand * cfg.d_model, cfg.d_state
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    want, none = JM.mamba_block(jp, _j(x), jcfg)
    got, nothing = MB.mamba_block(p, _t(x), cfg)
    assert none is None and nothing is None
    _close(got, want)
    st = (rng.standard_normal((b, di, n), dtype=np.float32),
          rng.standard_normal((b, cfg.d_conv - 1, di), dtype=np.float32))
    want, jst = JM.mamba_block(jp, _j(x), jcfg, state=tuple(map(_j, st)))
    got, tst = MB.mamba_block(p, _t(x), cfg, state=tuple(map(_t, st)))
    _close(got, want)
    for g, w in zip(tst, jst):
        _close(g, w)
    for i in range(3):
        x1 = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
        want, jst = JM.mamba_block(jp, _j(x1), jcfg, state=jst)
        got, tst = MB.mamba_block(p, _t(x1), cfg, state=tst)
        _close(got, want)
        for g, w in zip(tst, jst):
            _close(g, w)


def test_serve_params_keep_a_log_in_f32(cfgs):
    _, cfg = cfgs
    p = {"mamba": MB.init_mamba(torch.Generator().manual_seed(0), cfg,
                                torch.float32)}
    served = M.serve_params(p, cfg.replace(dtype="bfloat16"))["mamba"]
    assert served["a_log"].dtype == torch.float32
    assert torch.equal(served["a_log"], p["mamba"]["a_log"])
    assert served["in_proj"].dtype == torch.bfloat16


def test_wrapper_takes_the_plain_version_on_cpu():
    dt, a, bmat, cmat, u = (_t(x) for x in _scan_inputs(1, 1, 20, 32, 16))
    before = ops.launches
    y, h = ops.selective_scan(dt, a, bmat, cmat, u)
    want_y, want_h = selective_scan_ref(dt, a, bmat, cmat, u)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ops.launches == before


def test_kernel_refuses_cpu_tensors():
    dt, a, bmat, cmat, u = (_t(x) for x in _scan_inputs(1, 1, 8, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan_kernel(dt, a, bmat, cmat, u)


def test_prefill_of_one_token_takes_the_recurrence(cfgs, monkeypatch):
    """A one-token prompt with a state is the reference's decode step: no
    scan call (so no kernel launch on the card)."""
    jcfg, cfg = cfgs
    _, p = _params(jcfg)
    calls = []
    real = ops.selective_scan
    monkeypatch.setattr(ops, "selective_scan",
                        lambda *a: calls.append(1) or real(*a))
    st = MB.init_mamba_state(cfg, 1, "cpu")
    MB.mamba_block(p, torch.ones(1, 1, cfg.d_model), cfg, state=st)
    assert calls == []
    MB.mamba_block(p, torch.ones(1, 2, cfg.d_model), cfg, state=st)
    assert calls == [1]


# -- a model of the CUDA kernel's decomposition (kernels/csrc/mamba_scan.cu) -
LANES, PER_LANE = 4, 16      # lanes a channel, consecutive positions a lane
LOG2E = 1.4426950408889634


def _kernel_scan(dt, a, bmat, cmat, u, h0=None):
    """mamba_scan.cu's order of work in plain PyTorch (f32): tiles of
    LANES x PER_LANE positions, h carried from tile to tile; in a tile each
    lane composes its positions' (a, b) = (2^(dt a log2 e), (dt B) u) into
    one pair, the lanes' pairs are scanned (Kogge-Stone, the earlier pair
    first), the carried h enters through the exclusive prefix, and each lane
    re-walks its positions, y += C h.  Padded positions are dt = 0."""
    b, s = dt.shape
    d, n = a.shape
    ts = LANES * PER_LANE
    h = torch.zeros((b, d, n)) if h0 is None else h0.clone()
    a2 = a * LOG2E
    ys = []
    for t0 in range(0, s, ts):
        ln = min(ts, s - t0)
        padt = lambda x: torch.nn.functional.pad(  # noqa: E731
            x[:, t0:t0 + ln].transpose(1, -1), (0, ts - ln)).transpose(1, -1)
        dtt = torch.nn.functional.pad(dt[:, t0:t0 + ln], (0, ts - ln))
        bt, ct, ut = padt(bmat), padt(cmat), padt(u)
        ak = torch.exp2(dtt[:, :, None, None] * a2)              # (B, T, D, N)
        bk = (dtt[..., None] * bt)[:, :, None, :] * ut[..., None]
        lane = lambda x: x.reshape(b, LANES, PER_LANE, *x.shape[2:])  # noqa
        ak, bk, ct = lane(ak), lane(bk), lane(ct)
        pa, pb = ak[:, :, 0], bk[:, :, 0]
        for x in range(1, PER_LANE):
            pb = ak[:, :, x] * pb + bk[:, :, x]
            pa = pa * ak[:, :, x]
        off = 1
        while off < LANES:
            pb = torch.cat([pb[:, :off], pa[:, off:] * pb[:, :-off]
                            + pb[:, off:]], dim=1)
            pa = torch.cat([pa[:, :off], pa[:, off:] * pa[:, :-off]], dim=1)
            off *= 2
        end = pa * h[:, None] + pb
        hh = torch.cat([h[:, None], end[:, :-1]], dim=1)        # (B, L, D, N)
        y = torch.zeros((b, LANES, PER_LANE, d))
        for x in range(PER_LANE):
            hh = ak[:, :, x] * hh + bk[:, :, x]
            y[:, :, x] = torch.einsum("bldn,bln->bld", hh, ct[:, :, x])
        h = hh[:, -1]
        ys.append(y.reshape(b, ts, d)[:, :ln])
    return torch.cat(ys, dim=1), h


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 980])
def test_kernel_decomposition_matches_the_plain_scan(s, carried):
    """The kernel's composition over a lane's positions, a tile's lanes and
    the tiles (S at a lane boundary, a 32-position boundary and a tile
    boundary, each one past it, and the served 980) against
    ``selective_scan_ref`` (one position at a time) at ``TOL``, the kernel's
    bar; y and the final state, with and without a carried state."""
    b, d, n = 2, 24, 16
    dt, a, bmat, cmat, u = (_t(x) for x in _scan_inputs(s + 11, b, s, d, n))
    h0 = (_t(np.random.default_rng(s).standard_normal((b, d, n),
                                                      dtype=np.float32))
          if carried else None)
    want_y, want_h = selective_scan_ref(dt, a, bmat, cmat, u, h0)
    y, h = _kernel_scan(dt, a, bmat, cmat, u, h0)
    _close(y, want_y.numpy())
    _close(h, want_h.numpy())
