"""repro_torch's per-node disagreement under queue-aware arbitration
against ``repro``'s numpy engine: ``_resolve_slot_claims`` (the port's
runs in torch at a fixed size) against the reference's on random claims
under every arbiter, ``_fabric_plan``'s dynamic ``"fullest"`` plan and
its ``plane_map``, and tests/test_disagreement.py's partial-gather grid
under ``collision="fullest"`` (the degraded-service engine: FCT arrays,
counters, epoch arrays and bit totals equal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro.core.estimation import TrafficEstimator, estimate_all_views
from repro_torch import convert
from repro_torch.analysis.sanitize import Sanitizer
from repro_torch.core import simulator

BPS = 100e9 * 4.5e-6
RECFG = 1 / 9
COLLISIONS = ("drop", "lowest", "receiver", "fullest")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("collision", COLLISIONS)
def test_resolve_slot_claims_equals_reference(collision):
    """Random (R, n) claims on random planes, validity and VOQ depths with
    ties (small integer depths): winners and lost counts equal."""
    rng = np.random.default_rng(COLLISIONS.index(collision))
    for _ in range(150):
        n, R = int(rng.integers(2, 14)), int(rng.integers(1, 9))
        d_hat = int(rng.integers(1, 5))
        claims = rng.integers(0, n, size=(R, n))
        valid = rng.random((R, n)) < 0.8
        planes = rng.integers(0, d_hat, size=R)
        rot = rng.integers(0, 3 * n, size=R)
        voq = rng.integers(0, 4, size=n * n).astype(np.float64)
        win, lost = ref_sim._resolve_slot_claims(claims, valid, planes, rot,
                                                 collision, voq, n)
        for n_planes in (d_hat, None):
            got, got_lost = simulator._resolve_slot_claims(
                _t(claims), _t(valid), _t(planes), _t(rot), collision,
                _t(voq), n, n_planes=n_planes)
            assert np.array_equal(got.numpy(), win)
            assert int(got_lost) == lost


def test_fullest_arbiter_grants_deepest_voq():
    """tests/test_faults.py's unit case on the port."""
    n = 4
    claims = _t([[2, 2, 3, 3]])
    valid = torch.ones((1, n), dtype=torch.bool)
    planes, rot = _t([0]), _t([0])
    voq = torch.zeros(n * n, dtype=torch.float64)
    voq[0 * n + 2], voq[1 * n + 2], voq[2 * n + 3] = 5.0, 9.0, 4.0
    win, lost = simulator._resolve_slot_claims(claims, valid, planes, rot,
                                               "fullest", voq, n)
    assert win[0].tolist() == [False, True, True, False]
    assert int(lost) == 1
    win_d, lost_d = simulator._resolve_slot_claims(claims, valid, planes,
                                                   rot, "drop", voq, n)
    assert not win_d.any() and int(lost_d) == 3
    with pytest.raises(ValueError, match="collision"):
        simulator._resolve_slot_claims(claims, valid, planes, rot,
                                       "coinflip", voq, n)


def _partial_views(n=9, steps=1, seed=8):
    rng = np.random.default_rng(seed)
    period = rng.gamma(0.6, 1e7, size=(n, n))
    np.fill_diagonal(period, 0.0)
    fleet = TrafficEstimator.fleet(n, alpha=0.5)
    return estimate_all_views(period, fleet, 3, BPS, steps=steps)


def test_fullest_fabric_plan_equals_reference():
    """Under disagreement ``fullest`` is dynamic (no plans, no static
    winners, zero precomputed loss) with the claim structure of the
    reference; ``plane_map`` defaults to the identity and carries a
    repaired plan's surviving planes."""
    ref, owner = ref_schedule.per_node_schedules(
        _partial_views(), k=3, d_hat=3, recfg_frac=RECFG, seed=2)
    scheds = [convert.schedule_from(s) for s in ref]
    got = simulator._fabric_plan(scheds, owner, BPS, "fullest")
    want = ref_sim._fabric_plan(ref, owner, BPS, "fullest")
    assert got.plans is None and got.win is None
    assert (got.n_slots, got.disagreement, got.groups, got.w) == \
        (want.n_slots, want.disagreement, want.groups, want.w)
    for f in ("lost", "contested", "eff", "nonself", "plane_map"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    Sanitizer().check_fabric_plan(got, 9, 3, BPS * (1 - RECFG))
    pm = np.array([0, 2])
    for coll in COLLISIONS:
        a = simulator._fabric_plan(scheds[:1], np.zeros(9, dtype=np.int64),
                                   BPS, coll, plane_map=pm)
        b = ref_sim._fabric_plan(ref[:1], np.zeros(9, dtype=np.int64), BPS,
                                 coll, plane_map=pm)
        assert np.array_equal(a.plane_map, b.plane_map)
        for (p0, c0), (p1, c1) in zip(a.plans, b.plans):
            assert np.array_equal(p0, p1) and np.array_equal(c0, c1)
    with pytest.raises(ValueError, match="collision"):
        simulator._fabric_plan(scheds, owner, BPS, "coinflip")


def _partial_cases(collisions, n=12, horizon=1500, seed=1):
    """tests/test_disagreement.py's ``_partial_rows`` grid."""
    wl = ref_sim.phase_shifting_workload(n, 0.5, horizon, BPS, d_hat=2,
                                         seed=seed,
                                         phases=("permutation", "uniform"),
                                         shift_period=500)
    common = dict(wl=wl, epoch_slots=150, policy="adaptive", d_hat=2,
                  recfg_frac=RECFG, alpha=0.5, gather_steps=3)
    return [ref_sim.AdaptiveCase(collision=c, label=c, **common)
            for c in collisions]


def test_partial_gather_fullest_matches_reference():
    cases = _partial_cases(["fullest"])
    want = ref_sim.run_adaptive(cases, BPS, backend="numpy",
                                sanitize=True)[0]
    got = simulator.run_adaptive(
        [convert.adaptive_case_from(cases[0])], BPS, device="cpu",
        sanitize=True)[0]
    assert np.array_equal(want.result.fct_slots, got.result.fct_slots)
    for f in ("recomputes", "stale_slots", "dark_slots",
              "schedule_groups_max", "collision_lost_bits",
              "dark_plane_slots"):
        assert getattr(want, f) == getattr(got, f), f
    for f in ("epoch_utilization", "epoch_estimate_tv", "epoch_disagreement",
              "epoch_collision_loss"):
        assert np.array_equal(getattr(want, f), getattr(got, f),
                              equal_nan=True), f
    assert want.result.delivered_bits == got.result.delivered_bits
    assert got.schedule_groups_max == 12
    # per-epoch collision loss sums back to the scalar total
    ep_cap = 150 * 12 * 2 * BPS
    assert got.collision_lost_bits == pytest.approx(
        float(got.epoch_collision_loss.sum()) * ep_cap, rel=1e-9)


def test_fullest_recovers_what_drop_loses():
    """One control plane, two data planes: drop (compiled path) loses
    every contested claim, fullest (the engine) keeps one a port."""
    pwl = convert.workload_from(_partial_cases(["drop"])[0].wl)
    drop, fullest = simulator.run_adaptive(
        [convert.adaptive_case_from(c, pwl)
         for c in _partial_cases(["drop", "fullest"])], BPS, device="cpu")
    assert drop.recomputes == fullest.recomputes > 0
    assert np.allclose(drop.epoch_disagreement, fullest.epoch_disagreement)
    assert drop.collision_lost_bits > fullest.collision_lost_bits > 0
    assert fullest.result.utilization > drop.result.utilization
