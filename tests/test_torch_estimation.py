"""repro_torch's traffic estimation (paper Appendix A) against ``repro``'s:
the cases of tests/test_estimation.py run on the port's copies, the
port's ``estimate_all_views`` held to the reference's bit for bit, and
the f32 fleet ops ``fleet_update_quantize`` / ``dequantize_device`` (on
the CPU) held to the jitted ``fleet_update_quantize_jax`` /
``dequantize_jax``.

Bars: the host pipeline is f64 numpy in both packages, so its outputs are
equal exactly.  The fleet ops: quantized ticks equal, on the reference's
integer grid and on random seeded inputs; the f32 EWMA within rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import estimation as ref_est
from repro_torch.core.estimation import (
    TrafficEstimator,
    allgather_rows,
    dequantize,
    dequantize_device,
    estimate_all_views,
    estimate_global_matrix,
    fleet_update_quantize,
    quantize_row,
    ring_all_views,
    ring_leader_view,
    ring_view_mask,
)
from repro_torch.core.schedule import vermilion_schedule

BPS = 100e9 * 4.5e-6


# ---------------------------------------------------------------------------
# tests/test_estimation.py on the port's copies
# ---------------------------------------------------------------------------

def test_quantize_row_bounds():
    row = np.array([0.0, 1e12, 3.3e5])
    q = quantize_row(row, k=3, bits_per_slot=1e5)
    assert q.dtype == np.uint16
    assert q[0] == 0 and q[1] == 65535
    assert q[2] == int(np.floor(3.3e5 * (2 / 3) / 1e5))


def test_allgather_complete_after_period():
    n = 8
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 100, size=(n, n)).astype(np.uint16)
    views = allgather_rows(rows)
    for i in range(n):
        assert (views[i] == rows).all()


def test_allgather_partial_steps():
    n = 8
    rows = np.eye(n, dtype=np.uint16)
    views = allgather_rows(rows, steps=3)
    have = (views[0] == rows).all(axis=1) | (rows.sum(axis=1) == 0)
    assert have[0]
    assert not (views[0][(0 - 4) % n] == rows[(0 - 4) % n]).all()


@pytest.mark.parametrize("closed_form", ["leader", "all_views"])
def test_closed_forms_match_simulated_gather(closed_form):
    """The O(n^2) closed forms equal the simulated ring pipeline for every
    staleness and node, and the simulated gather equals the reference's."""
    n = 9
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 1000, size=(n, n)).astype(np.uint16)
    for steps in (0, 1, 3, n - 2, n - 1, None):
        sim = allgather_rows(rows, steps=steps)
        assert np.array_equal(sim, ref_est.allgather_rows(rows, steps=steps))
        if closed_form == "leader":
            for leader in (0, 2, n - 1):
                fast = ring_leader_view(rows, steps=steps, leader=leader)
                assert (fast == sim[leader]).all(), (steps, leader)
        else:
            views = ring_all_views(rows, steps=steps)
            for j in range(n):
                assert (views.view(j) == sim[j]).all(), (steps, j)
            assert (views.have == ring_view_mask(n, steps)).all()


def test_ewma_estimator():
    est = TrafficEstimator(n=4, alpha=0.5)
    assert est.update(np.array([4.0, 0, 0, 0]))[0] == 2.0
    assert est.update(np.array([4.0, 0, 0, 0]))[0] == 3.0


def test_estimate_global_matrix_returns_input_units():
    n, k, bps = 6, 3, 1e4
    rng = np.random.default_rng(2)
    period = rng.random((n, n)) * 1e6 + 1e5
    ests = [TrafficEstimator(n=n, alpha=1.0) for _ in range(n)]
    g = estimate_global_matrix(period, ests, k=k, bits_per_slot=bps)
    assert g.shape == (n, n) and (g >= 0).all()
    tick = bps * k / (k - 1)
    assert np.all(np.abs(g - period) <= tick + 1e-9)
    assert g.max() > 1e5


def test_quantize_dequantize_roundtrip():
    k, bps = 3, 1e4
    row = np.array([0.0, 12345.0, 9.99e5])
    back = dequantize(quantize_row(row, k, bps), k, bps)
    tick = bps * k / (k - 1)
    assert np.all(back <= row + 1e-9)
    assert np.all(row - back <= tick + 1e-9)


def test_quantizer_rejects_degenerate_k():
    row = np.array([1.0, 2.0, 3.0])
    for k in (1, 0, -2):
        with pytest.raises(ValueError, match="k must be >= 2"):
            quantize_row(row, k=k, bits_per_slot=1.0)
        with pytest.raises(ValueError, match="k must be >= 2"):
            dequantize(row.astype(np.uint16), k=k, bits_per_slot=1.0)
        with pytest.raises(ValueError, match="k must be >= 2"):
            fleet_update_quantize(np.zeros((3, 3)), np.ones((3, 3)), 0.3,
                                  k=k, bits_per_slot=1.0, device="cpu")
        with pytest.raises(ValueError, match="k must be >= 2"):
            dequantize_device(torch.zeros(3, dtype=torch.uint16), k=k,
                              bits_per_slot=1.0)
    with pytest.raises(ValueError, match="k must be >= 2"):
        estimate_global_matrix(
            np.ones((3, 3)), [TrafficEstimator(n=3) for _ in range(3)],
            k=1, bits_per_slot=1.0)
    q = quantize_row(row, k=2, bits_per_slot=1.0)
    assert (dequantize(q, k=2, bits_per_slot=1.0) == [0.0, 2.0, 2.0]).all()


def test_estimator_update_leaves_input_untouched():
    est = TrafficEstimator(n=4, alpha=0.5)
    period = np.array([4.0, 2.0, 0.0, 8.0])
    snapshot = period.copy()
    out = est.update(period)
    est.update(period)
    assert np.array_equal(period, snapshot) and out is not period


def test_fleet_estimator_matches_per_node_instances():
    n = 7
    rng = np.random.default_rng(11)
    fleet = TrafficEstimator.fleet(n, alpha=0.3)
    singles = [TrafficEstimator(n=n, alpha=0.3) for _ in range(n)]
    for _ in range(4):
        period = rng.random((n, n)) * 1e5
        fleet.update(period)
        for i, est in enumerate(singles):
            est.update(period[i])
    assert np.array_equal(fleet.ewma, np.stack([e.ewma for e in singles]))


def test_ring_views_unique_grouping():
    n = 8
    rng = np.random.default_rng(5)
    rows = rng.integers(1, 100, size=(n, n)).astype(np.uint16)
    masks, owner = ring_all_views(rows).unique()
    assert masks.shape[0] == 1 and (owner == 0).all()
    masks, owner = ring_all_views(rows, steps=2).unique()
    assert masks.shape[0] == n and len(set(owner.tolist())) == n
    rows_z = np.zeros_like(rows)
    rows_z[0] = rows[0]
    masks, owner = ring_all_views(rows_z, steps=1).unique()
    assert masks.shape[0] == 2
    assert owner[0] == owner[1] != owner[2]
    assert len({int(owner[j]) for j in range(2, n)}) == 1


def test_ring_views_excise():
    rows = np.arange(16, dtype=np.float64).reshape(4, 4)
    views = ring_all_views(rows, steps=1)
    dead = np.array([False, True, False, False])
    cut = views.excise(dead, dead)
    ref = ref_est.ring_all_views(rows, steps=1).excise(dead, dead)
    assert np.array_equal(cut.rows, ref.rows)
    assert np.array_equal(cut.have, views.have)
    assert not cut.rows[1].any() and not cut.rows[:, 1].any()


def test_estimate_all_views_matches_per_leader_estimates():
    n, k, bps, steps = 8, 3, 1e4, 3
    rng = np.random.default_rng(6)
    fleet = TrafficEstimator.fleet(n, alpha=0.4)
    per_leader = {j: [TrafficEstimator(n=n, alpha=0.4) for _ in range(n)]
                  for j in range(n)}
    for _ in range(3):
        period = rng.random((n, n)) * 1e6
        views = estimate_all_views(period, fleet, k, bps, steps=steps)
        for j in range(n):
            ref = estimate_global_matrix(period, per_leader[j], k, bps,
                                         steps=steps, leader=j)
            assert np.array_equal(views.view(j), ref), j


def test_estimate_all_views_requires_fleet_estimator():
    with pytest.raises(ValueError, match="fleet"):
        estimate_all_views(np.ones((4, 4)), TrafficEstimator(n=4), 3, 1.0)


def test_negative_gather_steps_rejected():
    rows = np.ones((5, 5), dtype=np.uint16)
    for fn in (lambda: allgather_rows(rows, steps=-1),
               lambda: ring_view_mask(5, steps=-1),
               lambda: ring_all_views(rows, steps=-1),
               lambda: ring_leader_view(rows, steps=-1),
               lambda: estimate_all_views(
                   rows.astype(float), TrafficEstimator.fleet(5), 3, 1.0,
                   steps=-1)):
        with pytest.raises(ValueError, match="steps must be >= 0"):
            fn()
    assert (ring_view_mask(5, steps=0) == np.eye(5, dtype=bool)).all()


def test_quantizer_saturation_roundtrip():
    n, k, bps = 8, 3, 1e4
    tick = bps * k / (k - 1)
    period = np.full((n, n), 1e12)
    np.fill_diagonal(period, 0.0)
    period[0, 1] = 1e14
    ests = [TrafficEstimator(n=n, alpha=1.0) for _ in range(n)]
    g = estimate_global_matrix(period, ests, k, bps)
    off = ~np.eye(n, dtype=bool)
    assert g.max() == 65535 * tick
    assert (g[off] == 65535 * tick).all() and (g >= 0).all()
    assert vermilion_schedule(g, k=k, d_hat=2).T == k * n
    views = estimate_all_views(period, TrafficEstimator.fleet(n, alpha=1.0),
                               k, bps)
    assert np.array_equal(views.view(0), g)


def test_estimate_global_matrix_partial_gather():
    n, steps = 8, 3
    period = np.full((n, n), 5e5)
    np.fill_diagonal(period, 0.0)
    ests = [TrafficEstimator(n=n) for _ in range(n)]
    g = estimate_global_matrix(period, ests, k=3, bits_per_slot=1e4,
                               steps=steps)
    seen = {0} | {(-i) % n for i in range(1, steps + 1)}
    for i in range(n):
        assert (g[i].sum() > 0) == (i in seen)


# ---------------------------------------------------------------------------
# The port against the reference, on the same seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [None, 5, 2, 0])
def test_estimate_all_views_equals_reference(steps):
    """Four rounds of the fleet pipeline (EWMA state carried, a zero row,
    a saturating entry): rows and masks bit for bit, and the same unique
    groups."""
    n, k, bps = 11, 3, 1e4
    rng = np.random.default_rng(7)
    fleet = TrafficEstimator.fleet(n, alpha=0.3)
    fleet_ref = ref_est.TrafficEstimator.fleet(n, alpha=0.3)
    for r in range(4):
        period = rng.gamma(0.5, 1e6, size=(n, n))
        period[3] = 0.0
        period[1, 2] = 1e12 * r
        views = estimate_all_views(period, fleet, k, bps, steps=steps)
        ref = ref_est.estimate_all_views(period, fleet_ref, k, bps,
                                         steps=steps)
        assert views.rows.dtype == ref.rows.dtype
        assert np.array_equal(views.rows, ref.rows), r
        assert np.array_equal(views.have, ref.have)
        for a, b in zip(views.unique(), ref.unique()):
            assert np.array_equal(a, b)
        assert np.array_equal(fleet.ewma, fleet_ref.ewma)


def test_estimate_global_matrix_equals_reference():
    n = 6
    rng = np.random.default_rng(1)
    period = rng.random((n, n)) * 1e6
    g = estimate_global_matrix(period, [TrafficEstimator(n=n)
                                        for _ in range(n)],
                               k=3, bits_per_slot=1e4, steps=2, leader=4)
    g_ref = ref_est.estimate_global_matrix(
        period, [ref_est.TrafficEstimator(n=n) for _ in range(n)],
        k=3, bits_per_slot=1e4, steps=2, leader=4)
    assert np.array_equal(g, g_ref)


# ---------------------------------------------------------------------------
# The f32 fleet ops against the jitted reference ops
# ---------------------------------------------------------------------------

def _both_rounds(ewma, period, alpha, k, bps):
    e_t, q_t = fleet_update_quantize(ewma, period, alpha, k, bps,
                                     device="cpu")
    e_j, q_j = ref_est.fleet_update_quantize_jax(ewma, period, alpha=alpha,
                                                 k=k, bits_per_slot=bps)
    return e_t, q_t, np.asarray(e_j), np.asarray(q_j)


def test_fleet_update_quantize_integer_grid():
    """tests/test_jax_parity.py's grid: demand in whole quantizer units,
    so that the f32 normalization is exact; ticks equal to the jax op's
    and the f64 pipeline's."""
    n, k = 8, 3
    rng = np.random.default_rng(0)
    unit = BPS * k / (k - 1)
    period = (rng.integers(0, 50, size=(n, n)) * unit).astype(np.float64)
    fleet = TrafficEstimator.fleet(n, alpha=0.5)
    ref_ewma = fleet.update(period)
    ref_q = quantize_row(ref_ewma, k, BPS)
    e_t, q_t, e_j, q_j = _both_rounds(np.zeros((n, n)), period, 0.5, k, BPS)
    assert q_t.dtype == torch.uint16 and e_t.dtype == torch.float32
    assert e_t.device.type == "cpu"
    assert np.array_equal(q_t.numpy(), q_j)
    assert np.array_equal(q_t.numpy(), ref_q)
    assert np.allclose(e_t.numpy(), ref_ewma, rtol=1e-6)
    assert np.allclose(e_t.numpy(), e_j, rtol=1e-6)
    deq = dequantize_device(q_t, k, BPS)
    deq_j = np.asarray(ref_est.dequantize_jax(q_j, k, BPS))
    assert deq.dtype == torch.float32
    assert np.array_equal(deq.numpy(), deq_j)
    assert np.allclose(deq.numpy(), dequantize(ref_q, k, BPS), rtol=1e-6)


@pytest.mark.parametrize("seed,alpha,k", [(1, 0.3, 3), (2, 0.9, 2),
                                          (3, 0.1, 5)])
def test_fleet_update_quantize_random_rounds(seed, alpha, k):
    """Five rounds on seeded random counters, the EWMA carried in f32 by
    each side: ticks equal to the jax op's, EWMA within rtol 1e-6."""
    n = 16
    rng = np.random.default_rng(seed)
    e_t = np.zeros((n, n), np.float32)
    e_j = np.zeros((n, n), np.float32)
    for _ in range(5):
        period = rng.gamma(0.7, 250 * BPS, size=(n, n))
        e_t, q_t, _, _ = _both_rounds(e_t, period, alpha, k, BPS)
        _, _, e_j, q_j = _both_rounds(e_j, period, alpha, k, BPS)
        assert np.array_equal(q_t.numpy(), q_j)
        assert np.allclose(e_t.numpy(), e_j, rtol=1e-6)
        assert q_j.max() > 0
    deq_j = np.asarray(ref_est.dequantize_jax(q_j, k, BPS))
    assert np.array_equal(dequantize_device(q_t, k, BPS).numpy(), deq_j)


def test_fleet_update_quantize_saturates_without_wrapping():
    """Counters far past 65535 ticks clip at 65535, negative ones at 0,
    as the jax op's do; nothing wraps through the uint16 cast."""
    n, k = 4, 3
    period = np.full((n, n), 1e14)
    period[0, 0] = -5e9
    period[1, 2] = 70000 * BPS * k / (k - 1)
    _, q_t, _, q_j = _both_rounds(np.zeros((n, n)), period, 1.0, k, BPS)
    assert np.array_equal(q_t.numpy(), q_j)
    assert q_t[0, 0] == 0 and q_t[1, 2] == 65535 and q_t[3, 3] == 65535


def test_fleet_update_quantize_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_update_quantize(np.zeros((3, 3)), np.ones((3, 3)), 0.3, 3,
                              BPS)
