"""repro_torch's adaptive control loop against ``repro``'s
``run_adaptive(backend="jax")`` on the same cases (carried across by
``repro_torch.convert.adaptive_case_from``): the adaptive parity cases of
tests/test_jax_parity.py, two ``normalize="saturate"`` cases, the
compiled control trajectories, the routing of the degraded-service
features, the device policy, and the
per-node schedule helpers.

Bars: those of tests/test_jax_parity.py's ``_assert_adaptive_parity`` —
FCT multisets equal, control counters and epoch arrays equal,
utilization within rtol 1e-6.  On the CPU the port's data plane
reproduces the JAX scan bit for bit and its control plane is the same f64
host code, so the compiled trajectories are also equal exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import estimation as ref_est
from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro.core.faults import FaultEvent, FaultSchedule
from repro_torch import convert
from repro_torch.analysis.sanitize import SanitizeError, Sanitizer
from repro_torch.core import estimation, schedule, simulator

BPS = 100e9 * 4.5e-6
RECFG = 1 / 9


def _wl(seed, n=12, horizon=900, load=0.7):
    return ref_sim.phase_shifting_workload(n, load, horizon, BPS, d_hat=3,
                                           seed=seed)


def _port_cases(cases_ref):
    """The port's copies of ``cases_ref``, one workload copy for each
    distinct reference workload (the loop's caches key on the object)."""
    wls: dict = {}
    return [convert.adaptive_case_from(
        c, wls.setdefault(id(c.wl), convert.workload_from(c.wl)))
        for c in cases_ref]


def _both(cases_ref, **kw):
    rows_ref = ref_sim.run_adaptive(cases_ref, BPS, backend="jax")
    rows = simulator.run_adaptive(_port_cases(cases_ref), BPS, device="cpu",
                                  **kw)
    return rows_ref, rows


def _fct_multisets_equal(a, b):
    fa = np.sort(a[np.isfinite(a)])
    fb = np.sort(b[np.isfinite(b)])
    return fa.shape == fb.shape and np.array_equal(fa, fb)


def _assert_adaptive_parity(a, b):
    assert a.label == b.label and a.policy == b.policy
    assert _fct_multisets_equal(a.result.fct_slots, b.result.fct_slots), \
        a.label
    assert a.recomputes == b.recomputes
    assert a.stale_slots == b.stale_slots
    assert a.dark_slots == b.dark_slots
    assert a.schedule_groups_max == b.schedule_groups_max
    for f in ("epoch_estimate_tv", "epoch_disagreement",
              "epoch_collision_loss"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)), equal_nan=True), f
    assert a.collision_lost_bits == b.collision_lost_bits
    assert a.dark_plane_slots == b.dark_plane_slots
    assert a.result.offered_bits == b.result.offered_bits
    assert np.isclose(a.result.utilization, b.result.utilization,
                      rtol=1e-6)
    assert np.allclose(a.epoch_utilization, b.epoch_utilization, rtol=1e-6)


def _assert_all(rows_ref, rows):
    assert [r.label for r in rows] == [r.label for r in rows_ref]
    for a, b in zip(rows_ref, rows):
        _assert_adaptive_parity(a, b)


# ---------------------------------------------------------------------------
# tests/test_jax_parity.py's adaptive cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gather_steps", [None, 6, 2])
@pytest.mark.parametrize("collision", ["drop", "lowest", "receiver"])
def test_adaptive_matches_reference(gather_steps, collision):
    case = ref_sim.AdaptiveCase(wl=_wl(11), d_hat=3, epoch_slots=150,
                                gather_steps=gather_steps,
                                collision=collision,
                                label=f"{gather_steps}-{collision}")
    _assert_all(*_both([case]))


@pytest.mark.parametrize("policy", ["oracle", "stale", "oblivious"])
def test_adaptive_policies(policy):
    case = ref_sim.AdaptiveCase(wl=_wl(21), d_hat=3, epoch_slots=150,
                                policy=policy, label=policy)
    _assert_all(*_both([case]))


def test_adaptive_charged_case():
    """Construction charging, the activation dark window and the churn
    hysteresis replay exactly."""
    case = ref_sim.AdaptiveCase(wl=_wl(31), d_hat=3, epoch_slots=150,
                                construction_slots=37,
                                reconfig_penalty_slots=20,
                                swap_tv_threshold=0.2, label="charged")
    rows_ref, rows = _both([case])
    _assert_all(rows_ref, rows)
    assert rows[0].dark_slots > 0 and rows[0].stale_slots > 0


def test_adaptive_batched_grid():
    cases = [
        ref_sim.AdaptiveCase(wl=_wl(41), d_hat=3, epoch_slots=150,
                             label="a"),
        ref_sim.AdaptiveCase(wl=_wl(42), d_hat=3, epoch_slots=150,
                             gather_steps=4, collision="lowest", label="b"),
        ref_sim.AdaptiveCase(wl=_wl(43), d_hat=3, epoch_slots=150,
                             policy="oracle", label="c"),
    ]
    _assert_all(*_both(cases))


@pytest.mark.parametrize("gather_steps", [None, 3])
def test_adaptive_saturate(gather_steps):
    """normalize="saturate": every recompute projects through the
    Sinkhorn plain version; a partial gather hands it views with zero
    rows (clamped to 1e-12).  Oracle and stale share a workload."""
    wl = _wl(71)
    common = dict(wl=wl, d_hat=3, epoch_slots=150, recfg_frac=RECFG,
                  normalize="saturate", seed=1)
    cases = [ref_sim.AdaptiveCase(gather_steps=gather_steps, alpha=0.5,
                                  collision="receiver", label="adaptive",
                                  **common)]
    if gather_steps is None:
        cases += [ref_sim.AdaptiveCase(policy=p, label=p, **common)
                  for p in ("oracle", "stale")]
    rows_ref, rows = _both(cases, sanitize=True)
    _assert_all(rows_ref, rows)
    if gather_steps is not None:
        assert rows[0].schedule_groups_max > 1
        assert rows[0].collision_lost_bits > 0


def test_compiled_trajectory_equals_reference():
    """The port's ``_compile_adaptive_plan`` emits the reference's plan
    ids, circuit registry and per-slot accounting, under a partial gather
    and a charged case; the digest on the row is that trajectory's."""
    wl = _wl(81)
    pwl = convert.workload_from(wl)
    for kw in (dict(gather_steps=3, collision="lowest"),
               dict(construction_slots=20, reconfig_penalty_slots=10,
                    normalize="saturate")):
        case = ref_sim.AdaptiveCase(wl=wl, d_hat=3, epoch_slots=150,
                                    label="t", **kw)
        ref = ref_sim._compile_adaptive_plan(case, BPS, sched_cache={})
        pcase = convert.adaptive_case_from(case, pwl)
        got = simulator._compile_adaptive_plan(pcase, BPS, sched_cache={},
                                               device="cpu")
        assert np.array_equal(got["plan_ids"], ref["plan_ids"])
        assert len(got["registry"]) == len(ref["registry"])
        for (p0, c0), (p1, c1) in zip(got["registry"], ref["registry"]):
            assert np.array_equal(p0, p1) and np.array_equal(c0, c1)
        for key in ("dis_slot", "coll_slot", "est_tv"):
            assert np.array_equal(got[key], ref[key], equal_nan=True), key
        for key in ("recomputes", "stale_slots", "dark_slots",
                    "dark_plane_slots", "groups_max", "n_epochs"):
            assert got[key] == ref[key], key
        row = simulator.run_adaptive([pcase], BPS, device="cpu")[0]
        assert row.plan_digest == simulator._plan_digest(got)


# ---------------------------------------------------------------------------
# The batch: dedup, sanitizer, timings
# ---------------------------------------------------------------------------

def test_identical_compiled_plans_are_served_once(monkeypatch):
    """A complete gather never invokes collision resolution, so its three
    collision modes compile to one plan and are served once (not under
    the sanitizer, whose ledgers stay one per case)."""
    wl = convert.workload_from(_wl(91, horizon=450))
    cases = [simulator.AdaptiveCase(wl=wl, d_hat=3, epoch_slots=150,
                                    collision=c, label=c)
             for c in ("drop", "lowest", "receiver")]
    served = []
    serve = simulator._serve

    def spy(wls, *args, **kw):
        served.append(len(wls))
        return serve(wls, *args, **kw)

    monkeypatch.setattr(simulator, "_serve", spy)
    rows = simulator.run_adaptive(cases, BPS, device="cpu")
    checked = simulator.run_adaptive(cases, BPS, device="cpu",
                                     sanitize=True)
    assert served == [1, 3]
    assert len({r.plan_digest for r in rows}) == 1
    for a, b in zip(rows, checked):
        assert np.array_equal(a.result.fct_slots, b.result.fct_slots,
                              equal_nan=True)
        assert a.result.utilization == b.result.utilization


def test_sanitized_run_is_identical_and_timed():
    case = convert.adaptive_case_from(ref_sim.AdaptiveCase(
        wl=_wl(95, horizon=450), d_hat=3, epoch_slots=150, gather_steps=2,
        label="s"))
    plain = simulator.run_adaptive([case], BPS, device="cpu",
                                   sanitize=False)[0]
    timings: dict = {}
    checked = simulator.run_adaptive([case], BPS, device="cpu",
                                     sanitize=True, timings=timings)[0]
    assert np.array_equal(plain.result.fct_slots, checked.result.fct_slots,
                          equal_nan=True)
    assert plain.plan_digest == checked.plan_digest
    assert timings["slots"] == 450
    for key in ("control_s", "layout_s", "upload_s", "device_loop_s",
                "download_s", "replay_s", "sanitize_s"):
        assert timings[key] >= 0.0, key


def test_sanitizer_checks_views_and_plans():
    san = Sanitizer()
    views = estimation.ring_all_views(np.ones((4, 4)), steps=1)
    san.check_views(views)
    with pytest.raises(SanitizeError, match="own row"):
        san.check_views(estimation.RingViews(
            rows=views.rows, have=np.zeros((4, 4), dtype=bool)))
    s = schedule.oblivious_schedule(4, d_hat=1)
    fp = simulator._fabric_plan([s], np.zeros(4, dtype=np.int64), BPS,
                                "drop")
    san.check_fabric_plan(fp, 4, 1, BPS)
    pid, cap = fp.plans[0]
    with pytest.raises(SanitizeError, match="over-committed"):
        san.check_plan_pairs(np.r_[pid, 1], np.r_[cap, BPS], 4, 1, BPS)
    assert san.counts["views"] == 2 and san.counts["fabric_plan"] == 1


# ---------------------------------------------------------------------------
# Rejections and the device policy
# ---------------------------------------------------------------------------

def test_unsupported_features_raise_before_any_case(monkeypatch):
    """The features the compiled path cannot express (faults, repair,
    ``fullest``, activation jitter) no longer raise: each such case runs
    on the degraded-service engine, every other case of the grid on the
    compiled batch path (tests/test_torch_faults.py holds the engine to
    the reference's numpy engine)."""
    wl = _wl(51, horizon=300)
    pwl = convert.workload_from(wl)
    fs = FaultSchedule((FaultEvent(10, "plane_down", plane=0),))
    ok = ref_sim.AdaptiveCase(wl=wl, d_hat=3, epoch_slots=150, label="ok")
    features = [dict(faults=fs, label="faults"),
                dict(repair=True, label="repair"),
                dict(collision="fullest", label="fullest"),
                dict(activation_jitter_slots=3, label="jitter")]
    degraded, compiled = [], []
    engine, batch = simulator._run_degraded_case, simulator._run_adaptive_batch

    def spy_engine(case, *a, **k):
        degraded.append(case.label)
        return engine(case, *a, **k)

    def spy_batch(cases, *a, **k):
        compiled.extend(c.label for c in cases)
        return batch(cases, *a, **k)

    monkeypatch.setattr(simulator, "_run_degraded_case", spy_engine)
    monkeypatch.setattr(simulator, "_run_adaptive_batch", spy_batch)
    for kw in features:
        bad = ref_sim.AdaptiveCase(wl=wl, d_hat=3, epoch_slots=150, **kw)
        cases = [convert.adaptive_case_from(c, pwl) for c in (ok, bad)]
        rows = simulator.run_adaptive(cases, BPS, device="cpu")
        assert [r.label for r in rows] == ["ok", kw["label"]]
        assert rows[1].result.utilization > 0.0
    assert degraded == [kw["label"] for kw in features]
    assert compiled == ["ok"] * len(features)


def test_case_validation_matches_reference():
    wl = convert.workload_from(_wl(52, horizon=300))
    for kw in (dict(policy="greedy"), dict(epoch_slots=0),
               dict(collision="random"), dict(gather_steps=12),
               dict(construction_slots=-1), dict(repair=True,
                                                 policy="oracle")):
        args = dict(wl=wl, epoch_slots=150)
        args.update(kw)
        with pytest.raises(ValueError):
            simulator.AdaptiveCase(**args)


def test_run_adaptive_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = simulator.phase_shifting_workload(8, 0.5, 300, BPS, d_hat=2,
                                           seed=3)
    case = simulator.AdaptiveCase(wl=wl, d_hat=2, epoch_slots=150)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.run_adaptive([case], BPS)
    assert simulator.run_adaptive([case], BPS, device="cpu")[0].recomputes


def test_phase_shifting_workload_equals_reference():
    for kw in (dict(), dict(phases=("ring", "skew-0.7"), shift_period=70)):
        a = ref_sim.phase_shifting_workload(10, 0.6, 400, BPS, d_hat=2,
                                            seed=4, **kw)
        b = simulator.phase_shifting_workload(10, 0.6, 400, BPS, d_hat=2,
                                              seed=4, **kw)
        for f in ("src", "dst", "size", "arrival"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.n, a.horizon) == (b.n, b.horizon)


def test_quantizer_unit_equals_reference():
    for args in ((150, 3, 3, BPS), (50000, 2, 8, BPS), (1, 5, 1, 1.0)):
        assert simulator._quantizer_unit(*args) == \
            ref_sim._quantizer_unit(*args)


# ---------------------------------------------------------------------------
# The per-node control plane's helpers
# ---------------------------------------------------------------------------

def _views(n=10, steps=2, seed=3):
    rng = np.random.default_rng(seed)
    period = rng.gamma(0.6, 1e7, size=(n, n))
    np.fill_diagonal(period, 0.0)
    period[4] = 0.0
    fleet = estimation.TrafficEstimator.fleet(n, alpha=0.5)
    fleet_ref = ref_est.TrafficEstimator.fleet(n, alpha=0.5)
    return (estimation.estimate_all_views(period, fleet, 3, BPS, steps=steps),
            ref_est.estimate_all_views(period, fleet_ref, 3, BPS,
                                       steps=steps))


@pytest.mark.parametrize("normalize", ["hose", "saturate"])
def test_per_node_schedules_equal_reference(normalize):
    views, views_ref = _views()
    scheds, owner = schedule.per_node_schedules(
        views, k=3, d_hat=2, recfg_frac=RECFG, seed=5, normalize=normalize,
        device="cpu")
    ref, owner_ref = ref_schedule.per_node_schedules(
        views_ref, k=3, d_hat=2, recfg_frac=RECFG, seed=5,
        normalize=normalize)
    assert len(scheds) == len(ref) > 1
    assert np.array_equal(owner, owner_ref)
    for a, b in zip(scheds, ref):
        assert np.array_equal(a.perms, b.perms)
        assert (a.d_hat, a.recfg_frac, a.meta) == (b.d_hat, b.recfg_frac,
                                                   b.meta)
    ported = [convert.schedule_from(s) for s in ref]
    eff = schedule.effective_perms(scheds, owner)
    assert np.array_equal(eff, ref_schedule.effective_perms(ref, owner_ref))
    assert schedule.schedule_disagreement(scheds, owner) == \
        ref_schedule.schedule_disagreement(ref, owner_ref) > 0
    old = schedule.effective_perms(ported[:1], np.zeros_like(owner))
    for d_hat in (1, 2, 4):
        assert np.array_equal(
            schedule.planes_changed(old, eff, d_hat),
            ref_schedule.planes_changed(old, eff, d_hat))
    assert not schedule.planes_changed(eff, eff.copy(), 2).any()
    assert schedule.planes_changed(eff[:-1], eff, 3).all()
    with pytest.raises(ValueError, match="owner"):
        schedule.effective_perms(scheds, owner[:-1])


@pytest.mark.parametrize("collision", ["drop", "lowest", "receiver"])
def test_fabric_plan_equals_reference(collision):
    views, views_ref = _views(n=9, steps=1, seed=8)
    ref, owner = ref_schedule.per_node_schedules(views_ref, k=3, d_hat=3,
                                                 recfg_frac=RECFG, seed=2)
    scheds = [convert.schedule_from(s) for s in ref]
    got = simulator._fabric_plan(scheds, owner, BPS, collision)
    want = ref_sim._fabric_plan(ref, owner, BPS, collision)
    assert (got.n_slots, got.disagreement, got.groups, got.w) == \
        (want.n_slots, want.disagreement, want.groups, want.w)
    for f in ("lost", "contested", "eff", "nonself", "win"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for (p0, c0), (p1, c1) in zip(got.plans, want.plans):
        assert np.array_equal(p0, p1) and np.array_equal(c0, c1)
    assert np.array_equal(got.plane_map, want.plane_map)
    Sanitizer().check_fabric_plan(got, 9, 3, BPS * (1 - RECFG))
    with pytest.raises(ValueError, match="collision"):
        simulator._fabric_plan(scheds, owner, BPS, "coinflip")
