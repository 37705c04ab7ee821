"""repro_torch schedule construction against the JAX package: websearch
workloads, Algorithm 1 ``perms`` under both normalizations, the padded
per-slot circuit export, the baselines, and the device policy of the
``"saturate"`` path.  Everything is exact: the same seeded inputs must
give the same integers (the ``"saturate"`` projection differs from the
reference's by ~1e-15, far inside the rounding's slack)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro.core import traffic as ref_traffic
from repro_torch import convert
from repro_torch.core import schedule, simulator

BPS = 100e9 * 4.5e-6
RECFG = 1 / 9


@pytest.mark.parametrize("n,load,horizon,d_hat,seed,pattern", [
    (8, 0.4, 300, 2, 5, "rack_permutation"),
    (16, 0.6, 400, 4, 1, "rack_permutation"),
    (12, 0.3, 200, 1, 3, "uniform"),
])
def test_websearch_workload_matches_reference(n, load, horizon, d_hat, seed,
                                              pattern):
    got = simulator.websearch_workload(n, load, horizon, BPS, d_hat=d_hat,
                                       seed=seed, pattern=pattern)
    want = ref_sim.websearch_workload(n, load, horizon, BPS, d_hat=d_hat,
                                      seed=seed, pattern=pattern)
    for f in ("src", "dst", "size", "arrival"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.n, got.horizon) == (want.n, want.horizon)
    assert np.array_equal(got.demand_matrix(), want.demand_matrix())


def _demand(kind, n, seed):
    if kind == "websearch":
        return ref_sim.websearch_workload(
            n, 0.5, 300, BPS, d_hat=2, seed=seed).demand_matrix()
    if kind == "skewed":
        return ref_traffic.skewed(n, 0.6, seed=seed)
    return ref_traffic.random_hose(n, seed=seed)


@pytest.mark.parametrize("normalize", ["hose", "saturate"])
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("kind", ["websearch", "skewed", "random_hose"])
def test_vermilion_perms_match_reference(normalize, n, kind):
    for seed in (0, 1):
        m = _demand(kind, n, seed)
        got = schedule.vermilion_schedule(
            m, k=3, d_hat=2, recfg_frac=RECFG, seed=seed,
            normalize=normalize, device="cpu")
        want = ref_schedule.vermilion_schedule(
            m, k=3, d_hat=2, recfg_frac=RECFG, seed=seed,
            normalize=normalize)
        assert np.array_equal(got.perms, want.perms), (kind, n, seed)
        assert got.meta == want.meta and got.name == want.name


def test_vermilion_hk_and_batch_match_reference():
    mats = [_demand("websearch", 16, s) for s in range(3)]
    got = schedule.vermilion_schedules(mats, k=3, d_hat=4,
                                       normalize="saturate", device="cpu")
    want = ref_schedule.vermilion_schedules(mats, k=3, d_hat=4,
                                            normalize="saturate")
    for a, b in zip(got, want):
        assert np.array_equal(a.perms, b.perms)
    a = schedule.vermilion_schedule(mats[0], method="hk", device="cpu",
                                    normalize="saturate")
    b = ref_schedule.vermilion_schedule(mats[0], method="hk",
                                        normalize="saturate")
    assert np.array_equal(a.perms, b.perms)


@pytest.mark.parametrize("d_hat,pair_base,j_pad", [
    (1, 0, None), (2, 0, 64), (4, 3 * 16 * 16, 64)])
def test_slot_circuits_padded_matches_reference(d_hat, pair_base, j_pad):
    m = _demand("websearch", 16, 2)
    got = schedule.vermilion_schedule(m, k=3, d_hat=d_hat, recfg_frac=RECFG,
                                      normalize="saturate", device="cpu")
    want = ref_schedule.vermilion_schedule(m, k=3, d_hat=d_hat,
                                           recfg_frac=RECFG,
                                           normalize="saturate")
    gp, gc = got.slot_circuits_padded(BPS, pair_base=pair_base, j_pad=j_pad)
    wp, wc = want.slot_circuits_padded(BPS, pair_base=pair_base,
                                       j_pad=j_pad)
    assert gp.dtype == wp.dtype and np.array_equal(gp, wp)
    assert gc.dtype == wc.dtype and np.array_equal(gc, wc)
    assert np.array_equal(got.capacity_per_slot(BPS),
                          want.capacity_per_slot(BPS))
    assert np.array_equal(got.emulated_capacity(), want.emulated_capacity())


def test_baselines_match_reference():
    m = _demand("skewed", 12, 4)
    a = schedule.oblivious_schedule(12, d_hat=3, recfg_frac=RECFG)
    b = ref_schedule.oblivious_schedule(12, d_hat=3, recfg_frac=RECFG)
    assert np.array_equal(a.perms, b.perms) and a.name == b.name
    a = schedule.greedy_matching_schedule(m, n_matchings=36, d_hat=3)
    b = ref_schedule.greedy_matching_schedule(m, n_matchings=36, d_hat=3)
    assert np.array_equal(a.perms, b.perms)


def test_convert_carries_schedule_and_workload():
    wl = ref_sim.websearch_workload(8, 0.4, 100, BPS, d_hat=2, seed=5)
    s = ref_schedule.vermilion_schedule(wl.demand_matrix(), d_hat=2,
                                        recfg_frac=RECFG)
    ps, pw = convert.schedule_from(s), convert.workload_from(wl)
    assert isinstance(ps, schedule.Schedule)
    assert isinstance(pw, simulator.Workload)
    assert np.array_equal(ps.perms, s.perms) and ps.meta == s.meta
    assert (ps.d_hat, ps.recfg_frac, ps.name) == (s.d_hat, s.recfg_frac,
                                                  s.name)
    for f in ("src", "dst", "size", "arrival", "n", "horizon"):
        assert np.array_equal(getattr(pw, f), getattr(wl, f)), f


def test_saturate_schedule_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _demand("websearch", 8, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule.vermilion_schedule(m, normalize="saturate")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule.vermilion_schedules([m], normalize="saturate")
    # "hose" does no device work
    schedule.vermilion_schedule(m, normalize="hose")
