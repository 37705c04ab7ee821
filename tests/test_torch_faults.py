"""repro_torch fault injection, the repair loop and activation jitter
against ``repro``'s numpy engine (``run_sweep(backend="numpy")``,
``simulate`` and ``run_adaptive(backend="numpy")``: the reference's jax
backend rejects all of these), on the same objects carried across by
``repro_torch.convert``, at the sizes of tests/test_faults.py.

Bars.  The sweep and ``simulate`` (the port's f32 VOQ): FCT arrays equal,
``delivered_bits`` and ``fault_lost_bits`` within rtol 1e-5 (the jax
parity bar), ``fault_refused_bits`` equal.  The adaptive loop's
degraded-service engine (f64 VOQ, as the numpy engine): FCT arrays,
counters, excisions, epoch arrays and every bit total equal.  Cases of a
grid that need none of the features take the compiled f32 path, the port
of the jax backend, and are held against ``backend="jax"`` at the
sweep's bar.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import faults as ref_faults
from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro.core.faults import FaultEvent, FaultSchedule
from repro_torch import convert
from repro_torch.core import faults, simulator

BPS = 100e9 * 4.5e-6
RECFG = 1 / 9


def _uniform(n=12, load=0.6, horizon=1200, d_hat=2, seed=3):
    return ref_sim.phase_shifting_workload(
        n, load, horizon, BPS, d_hat=d_hat, seed=seed, phases=("uniform",))


# ---------------------------------------------------------------------------
# Events, validation, the timeline and the claim mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ev", [
    (0, "gamma_ray"),                                    # unknown kind
    (-1, "plane_down", -1, 0),                           # negative slot
    (0, "plane_down", -1, 2),                            # plane out of range
    (0, "tor_fail", 8),                                  # node out of range
    (0, "tor_fail"),                                     # node required
    (0, "plane_down", 3, 0),                             # node forbidden
    (0, "tor_fail", 1, 0),                               # plane forbidden
    (0, "link_flap", 1, 0),                              # duration required
    (0, "tor_drain", 1, -1, 5),                          # duration forbidden
])
def test_malformed_fault_events_raise(ev):
    with pytest.raises(ValueError):
        faults.FaultSchedule((faults.FaultEvent(*ev),)).validate(8, 2)
    with pytest.raises(ValueError):
        FaultSchedule((FaultEvent(*ev),)).validate(8, 2)


def _mixed_events():
    return ((10, "plane_down", -1, 1), (20, "plane_up", -1, 1),
            (30, "port_down", 3, 0), (40, "link_flap", 2, 1, 7),
            (50, "tor_drain", 4), (60, "tor_fail", 5), (61, "tor_fail", 5))


def test_timeline_replays_the_reference():
    """Every slot's state (planes, dead ports, flaps, liveness,
    injection, version, clean), newly failed nodes and link mask equal
    the reference timeline's."""
    evs = _mixed_events()
    tl = faults.FaultSchedule(
        tuple(faults.FaultEvent(*e) for e in evs)).compile(8, 2)
    rtl = FaultSchedule(tuple(FaultEvent(*e) for e in evs)).compile(8, 2)
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS
    for slot in range(80):
        assert np.array_equal(tl.advance(slot), rtl.advance(slot))
        for f in ("plane_ok", "port_dead", "flap_dark", "node_alive",
                  "inject_ok", "version", "clean"):
            assert np.array_equal(getattr(tl, f), getattr(rtl, f)), f
        assert np.array_equal(tl.link_ok(), rtl.link_ok())
    assert not faults.FaultSchedule() and faults.FaultSchedule(
        (faults.FaultEvent(1, "plane_down", plane=0),))


def test_claims_fault_mask_equals_reference():
    rng = np.random.default_rng(5)
    for _ in range(50):
        n, P = int(rng.integers(2, 10)), int(rng.integers(1, 5))
        link_ok = rng.random((n, P + 2)) < 0.7
        claims = rng.integers(0, n, size=(P, n))
        pm = rng.permutation(P + 2)[:P]
        for plane_map in (None, pm):
            assert np.array_equal(
                faults.claims_fault_mask(claims, link_ok, plane_map),
                ref_faults.claims_fault_mask(claims, link_ok, plane_map))


# ---------------------------------------------------------------------------
# The sweep and simulate
# ---------------------------------------------------------------------------

SWEEP_FAULTS = {
    "plane": ((100, "plane_down", -1, 0), (400, "plane_up", -1, 0)),
    "port_down": ((150, "port_down", 3, 1),),
    "link_flap": ((120, "link_flap", 2, 0, 90),),
    "tor_drain": ((300, "tor_drain", 0),),
    "tor_fail": ((300, "tor_fail", 0), (500, "tor_fail", 5)),
    "mixed": ((100, "plane_down", -1, 2), (200, "tor_fail", 4),
              (250, "tor_drain", 7), (300, "link_flap", 1, 1, 50),
              (350, "port_down", 9, 0)),
}


def _assert_sim_equal(a, b, label=""):
    assert np.array_equal(a.fct_slots, b.fct_slots), label
    assert np.isclose(a.delivered_bits, b.delivered_bits, rtol=1e-5), label
    assert np.isclose(a.fault_lost_bits, b.fault_lost_bits, rtol=1e-5), label
    assert a.fault_refused_bits == b.fault_refused_bits, label
    assert a.offered_bits == b.offered_bits, label


@pytest.mark.parametrize("kind", list(SWEEP_FAULTS))
def test_sweep_faults_match_reference(kind):
    """One fault kind, an oblivious and a Vermilion schedule in one batch
    beside an unfaulted case (whose plan and FCTs stay the fault-free
    ones)."""
    wl = _uniform(n=12, load=0.7, horizon=900, d_hat=3)
    scheds = [ref_schedule.oblivious_schedule(12, d_hat=3, recfg_frac=RECFG),
              ref_schedule.vermilion_schedule(wl.demand_matrix(), k=3,
                                              d_hat=3, recfg_frac=RECFG)]
    fs = FaultSchedule(tuple(FaultEvent(*e) for e in SWEEP_FAULTS[kind]))
    cases = [ref_sim.SweepCase(s, wl, faults=fs, label=f"{kind}{i}")
             for i, s in enumerate(scheds)]
    cases.append(ref_sim.SweepCase(scheds[0], wl, label="clean"))
    want = ref_sim.run_sweep(cases, BPS, backend="numpy", sanitize=True)
    pwl = convert.workload_from(wl)
    got = simulator.run_sweep([convert.sweep_case_from(c, wl=pwl)
                               for c in cases], BPS, device="cpu",
                              sanitize=True)
    for a, b in zip(want, got):
        assert a.label == b.label
        _assert_sim_equal(a.result, b.result, a.label)
    clean = simulator.run_sweep(
        [simulator.SweepCase(convert.schedule_from(scheds[0]), pwl)], BPS,
        device="cpu")[0].result
    assert np.array_equal(clean.fct_slots, got[-1].result.fct_slots)
    assert clean.delivered_bits == got[-1].result.delivered_bits
    r = got[0].result
    if kind in ("tor_fail", "mixed"):
        assert r.fault_lost_bits > 0.0 and r.fault_refused_bits > 0.0
    else:
        assert r.fault_lost_bits == 0.0
    if kind == "tor_drain":
        assert r.fault_refused_bits > 0.0


def test_empty_fault_schedule_is_bit_identical_to_none():
    wl = convert.workload_from(_uniform(n=8, horizon=600))
    sched = simulator.oblivious_schedule(8, d_hat=2, recfg_frac=RECFG)
    ref = simulator.simulate(sched, wl, BPS, sanitize=True, device="cpu")
    for fs in (faults.FaultSchedule(), None):
        r = simulator.simulate(sched, wl, BPS, sanitize=True, faults=fs,
                               device="cpu")
        assert np.array_equal(r.fct_slots, ref.fct_slots)
        assert r.delivered_bits == ref.delivered_bits
        assert r.fault_lost_bits == 0.0 and r.fault_refused_bits == 0.0
    row = simulator.run_sweep(
        [simulator.SweepCase(sched, wl, faults=faults.FaultSchedule())],
        BPS, device="cpu")[0].result
    assert np.array_equal(row.fct_slots, ref.fct_slots)
    assert row.delivered_bits == ref.delivered_bits


@pytest.mark.parametrize("kind", ["plane", "tor_fail", "mixed"])
def test_simulate_faults_match_reference(kind):
    wl = _uniform(n=8, horizon=600, load=0.8)
    sched = ref_schedule.oblivious_schedule(8, d_hat=2, recfg_frac=RECFG)
    evs = {"plane": ((100, "plane_down", -1, 0),),
           "tor_fail": ((300, "tor_fail", 0),),
           "mixed": ((50, "link_flap", 3, 1, 40), (200, "tor_drain", 2),
                     (260, "tor_fail", 6), (300, "port_down", 1, 0))}[kind]
    fs = FaultSchedule(tuple(FaultEvent(*e) for e in evs))
    want = ref_sim.simulate(sched, wl, BPS, sanitize=True, faults=fs)
    got = simulator.simulate(convert.schedule_from(sched),
                             convert.workload_from(wl), BPS, sanitize=True,
                             faults=convert.fault_schedule_from(fs),
                             device="cpu")
    _assert_sim_equal(want, got, kind)


@pytest.mark.parametrize("mode", ["single_hop", "rotorlb", "vlb"])
def test_simulate_modes_match_reference(mode):
    """simulate's routing: single-hop through the sweep's engine (against
    the reference's ``simulate``), two-hop through the relay plane on the
    route ``run_sweep`` takes (per-flow FCTs at this size; against the
    reference's ``run_sweep(backend="jax")``, whose relay formulation the
    port's is)."""
    wl = _uniform(n=8, horizon=300, load=0.5)
    sched = ref_schedule.oblivious_schedule(8, d_hat=2, recfg_frac=RECFG)
    if mode == "single_hop":
        want = ref_sim.simulate(sched, wl, BPS, mode=mode)
    else:
        want = ref_sim.run_sweep([ref_sim.SweepCase(sched, wl, mode)], BPS,
                                 backend="jax")[0].result
    got = simulator.simulate(convert.schedule_from(sched),
                             convert.workload_from(wl), BPS, mode=mode,
                             device="cpu")
    assert np.array_equal(want.fct_slots, got.fct_slots)
    for f in ("delivered_bits", "utilization", "avg_hops"):
        assert np.isclose(getattr(want, f), getattr(got, f), rtol=1e-5), f


def test_faults_on_two_hop_and_bad_faults_raise():
    wl = convert.workload_from(_uniform(n=8, horizon=100))
    sched = simulator.oblivious_schedule(8, d_hat=2, recfg_frac=RECFG)
    fs = faults.FaultSchedule((faults.FaultEvent(10, "plane_down",
                                                 plane=0),))
    for mode in ("rotorlb", "vlb"):
        with pytest.raises(ValueError, match="single_hop"):
            simulator.SweepCase(sched, wl, mode=mode, faults=fs)
        with pytest.raises(ValueError, match="single_hop"):
            simulator.simulate(sched, wl, BPS, mode=mode, faults=fs,
                               device="cpu")
    with pytest.raises(ValueError, match="FaultSchedule"):
        simulator.SweepCase(sched, wl, faults=["plane_down"])
    with pytest.raises(ValueError, match="FaultSchedule"):
        simulator.simulate(sched, wl, BPS, faults=[object()], device="cpu")
    with pytest.raises(ValueError):
        simulator.SweepCase(sched, wl, faults=faults.FaultSchedule(
            (faults.FaultEvent(0, "tor_fail", node=99),)))
    with pytest.raises(ValueError):
        simulator.simulate(sched, wl, BPS, mode="multi_hop", device="cpu")


# ---------------------------------------------------------------------------
# The adaptive loop: the degraded-service engine
# ---------------------------------------------------------------------------

COUNTERS = ("recomputes", "stale_slots", "dark_slots", "dark_plane_slots",
            "schedule_groups_max", "excised_nodes", "excised_planes")
EPOCHS = ("epoch_utilization", "epoch_estimate_tv", "epoch_disagreement",
          "epoch_collision_loss")


def _port_cases(cases_ref):
    wls: dict = {}
    return [convert.adaptive_case_from(
        c, wls.setdefault(id(c.wl), convert.workload_from(c.wl)))
        for c in cases_ref]


def _both(cases_ref):
    """The port's rows against the reference's: a case with faults,
    repair, ``fullest`` or jitter against the numpy engine, exactly; any
    other case of the grid (the compiled f32 path, the port of the jax
    backend) against ``backend="jax"``: FCT arrays equal, bits within
    rtol 1e-5."""
    rows = simulator.run_adaptive(_port_cases(cases_ref), BPS, device="cpu",
                                  sanitize=True)
    degraded = [simulator._degraded(convert.adaptive_case_from(c))
                for c in cases_ref]
    rows_np = iter(ref_sim.run_adaptive(
        [c for c, d in zip(cases_ref, degraded) if d], BPS,
        backend="numpy", sanitize=True))
    rows_jax = iter(ref_sim.run_adaptive(
        [c for c, d in zip(cases_ref, degraded) if not d], BPS,
        backend="jax"))
    for d, b in zip(degraded, rows):
        a = next(rows_np) if d else next(rows_jax)
        assert a.label == b.label and a.policy == b.policy
        r0, r1 = a.result, b.result
        assert np.array_equal(r0.fct_slots, r1.fct_slots), a.label
        for f in COUNTERS:
            assert getattr(a, f) == getattr(b, f), (a.label, f)
        assert r0.offered_bits == r1.offered_bits
        if d:
            for f in EPOCHS:
                assert np.array_equal(getattr(a, f), getattr(b, f),
                                      equal_nan=True), (a.label, f)
            for f in ("delivered_bits", "fault_lost_bits",
                      "fault_refused_bits", "utilization"):
                assert getattr(r0, f) == getattr(r1, f), (a.label, f)
            assert a.collision_lost_bits == b.collision_lost_bits
            assert (b.fault_lost_bits, b.fault_refused_bits) == (
                r1.fault_lost_bits, r1.fault_refused_bits)
        else:
            assert np.isclose(r0.delivered_bits, r1.delivered_bits,
                              rtol=1e-5), a.label
            assert np.allclose(a.epoch_utilization, b.epoch_utilization,
                               rtol=1e-5)
    return rows


def _fault_cases(fs, horizon=2400, n=12):
    """tests/test_faults.py's repair / blind pair."""
    wl = ref_sim.phase_shifting_workload(
        n, 0.95, horizon, BPS, d_hat=3, seed=1, phases=("uniform",),
        shift_period=horizon)
    base = dict(d_hat=3, recfg_frac=RECFG, gather_steps=n - 1,
                reconfig_penalty_slots=30, faults=fs)
    return [
        ref_sim.AdaptiveCase(wl, 150, "adaptive", repair=True,
                             swap_tv_threshold=0.3, label="repair", **base),
        ref_sim.AdaptiveCase(wl, 150, "adaptive", label="blind", **base),
    ]


def test_plane_down_repair_matches_reference():
    fs = FaultSchedule((FaultEvent(900, "plane_down", plane=0),))
    rows = _both(_fault_cases(fs))
    rep, bli = rows
    assert rep.excised_planes == 1 and bli.excised_planes == 0
    assert rep.result.fault_lost_bits == 0.0
    post = [float(np.mean(r.epoch_utilization[8:])) for r in rows]
    assert post[0] > post[1]


def test_tor_fail_repair_matches_reference():
    fs = FaultSchedule((FaultEvent(900, "tor_fail", node=3),))
    rows = _both(_fault_cases(fs))
    assert rows[0].excised_nodes >= 1
    for row in rows:
        assert row.result.fault_lost_bits > 0.0
        assert row.result.fault_refused_bits > 0.0


def test_fullest_collision_mode_matches_reference():
    """test_fullest_collision_mode_runs_closed_loop's pair: fullest on the
    engine, drop on the compiled path."""
    wl = ref_sim.phase_shifting_workload(
        12, 0.5, 1200, BPS, d_hat=2, seed=1,
        phases=("permutation", "uniform"), shift_period=400)
    rows = _both([
        ref_sim.AdaptiveCase(wl, 150, "adaptive", d_hat=2, recfg_frac=RECFG,
                             gather_steps=2, collision=c, label=c)
        for c in ("drop", "fullest")])
    drop, fullest = rows
    assert fullest.result.delivered_bits > drop.result.delivered_bits
    assert fullest.collision_lost_bits > 0.0


def test_full_swap_darkens_every_plane_matches_reference():
    """test_full_swap_darkens_every_plane's case, under ``fullest`` so that
    it takes the engine (a complete gather never contends)."""
    wl = _uniform(horizon=1200)
    rows = _both([ref_sim.AdaptiveCase(
        wl, 150, "adaptive", d_hat=2, recfg_frac=RECFG,
        reconfig_penalty_slots=15, collision=c, label=c)
        for c in ("drop", "fullest")])
    for row in rows:
        assert row.dark_slots > 0
        assert row.dark_plane_slots == row.dark_slots * 2


def test_swap_hysteresis_matches_reference():
    """The hysteresis pair of tests/test_faults.py (compiled path), and
    the same pair with repair on (the engine)."""
    wl = _uniform(load=0.8, horizon=2400)
    base = dict(d_hat=2, recfg_frac=RECFG, reconfig_penalty_slots=15)
    rows = _both([
        ref_sim.AdaptiveCase(wl, 150, "adaptive", label="churn", **base),
        ref_sim.AdaptiveCase(wl, 150, "adaptive", swap_tv_threshold=0.9,
                             label="hyst", **base),
        ref_sim.AdaptiveCase(wl, 150, "adaptive", swap_tv_threshold=0.9,
                             repair=True, label="hyst-repair", **base)])
    churn, hyst, _ = rows
    assert churn.recomputes > hyst.recomputes
    assert hyst.dark_plane_slots < churn.dark_plane_slots


@pytest.mark.parametrize("collision", ["receiver", "fullest"])
def test_activation_jitter_matches_reference(collision):
    wl = _uniform(load=0.7, horizon=1200)
    rows = _both([ref_sim.AdaptiveCase(
        wl, 150, "adaptive", d_hat=2, recfg_frac=RECFG,
        activation_jitter_slots=40, collision=collision,
        gather_steps=None if collision == "receiver" else 3, label="jit")])
    assert 0.0 < rows[0].result.utilization


def test_saturate_with_faults_matches_reference():
    """normalize="saturate" (the Sinkhorn projection on every rebuild)
    under a port death, a flap and a drain; and an oracle case under a
    ToR failure and a plane outage with dark windows."""
    wl = ref_sim.phase_shifting_workload(
        12, 0.8, 1200, BPS, d_hat=3, seed=2,
        phases=("uniform", "permutation"), shift_period=600)
    fs = FaultSchedule((FaultEvent(400, "port_down", node=2, plane=1),
                        FaultEvent(500, "link_flap", node=5, plane=0,
                                   duration=100),
                        FaultEvent(700, "tor_drain", node=7)))
    fs2 = FaultSchedule((FaultEvent(300, "tor_fail", node=1),
                         FaultEvent(350, "plane_down", plane=2),
                         FaultEvent(800, "plane_up", plane=2)))
    rows = _both([
        ref_sim.AdaptiveCase(wl, 150, "adaptive", d_hat=3, recfg_frac=RECFG,
                             normalize="saturate", faults=fs, label="sat"),
        ref_sim.AdaptiveCase(wl, 150, "oracle", d_hat=3, recfg_frac=RECFG,
                             faults=fs2, reconfig_penalty_slots=10,
                             label="oracle")])
    assert rows[0].result.fault_refused_bits > 0.0
    assert rows[1].result.fault_lost_bits > 0.0


def test_empty_fault_schedule_keeps_the_compiled_path(monkeypatch):
    """An empty schedule (and activation_jitter_slots=0) is no feature:
    the case keeps the compiled path, bit-identical to None."""
    wl = convert.workload_from(_uniform(horizon=900))
    base = dict(d_hat=2, recfg_frac=RECFG, reconfig_penalty_slots=10)
    ref = simulator.run_adaptive([simulator.AdaptiveCase(
        wl, 150, "adaptive", **base)], BPS, device="cpu", sanitize=True)[0]

    def never(*a, **k):
        raise AssertionError("an empty schedule took the degraded engine")

    monkeypatch.setattr(simulator, "_run_degraded_case", never)
    row = simulator.run_adaptive([simulator.AdaptiveCase(
        wl, 150, "adaptive", faults=faults.FaultSchedule(),
        activation_jitter_slots=0, **base)], BPS, device="cpu",
        sanitize=True)[0]
    assert np.array_equal(row.result.fct_slots, ref.result.fct_slots)
    assert row.result.delivered_bits == ref.result.delivered_bits
    assert row.plan_digest == ref.plan_digest
    assert row.result.fault_lost_bits == 0.0


# digests of the compiled trajectories of tests/test_torch_adaptive.py's
# cases, recorded on the tree before the degraded engine existed: the
# compiled path must serve them unchanged
COMPILED_DIGESTS = {
    ("adaptive", 6, "lowest"): "814b89500062c84d097c670866f637d43faf5354",
    ("adaptive", 2, "receiver"): "c883d8976575eb90ddc9c4a3970849ec2c60ea4a",
    ("adaptive", 2, "drop"): "1e6188eeb65ab1518263ff2f0f967baa92869d8f",
    ("oracle", None, "drop"): "71ae2c0dd2e00917b1148309c135afd0ab2b301e",
    ("charged", None, "drop"): "efbbd6100062e580f91ec3983d9b2cb444967805",
}


@pytest.mark.parametrize("key", list(COMPILED_DIGESTS))
def test_compiled_plan_digests_unchanged(key):
    policy, steps, collision = key
    seed = {"adaptive": 11, "oracle": 21, "charged": 31}[policy]
    wl = ref_sim.phase_shifting_workload(12, 0.7, 900, BPS, d_hat=3,
                                         seed=seed)
    kw = (dict(construction_slots=37, reconfig_penalty_slots=20,
               swap_tv_threshold=0.2) if policy == "charged"
          else dict(policy=policy))
    case = ref_sim.AdaptiveCase(wl=wl, d_hat=3, epoch_slots=150,
                                gather_steps=steps, collision=collision,
                                **kw)
    row = simulator.run_adaptive(_port_cases([case]), BPS, device="cpu")[0]
    assert row.plan_digest == COMPILED_DIGESTS[key]


def test_adaptive_case_validation_matches_reference():
    wl = _uniform(horizon=600)
    pwl = convert.workload_from(wl)
    for kw in (dict(gather_steps=wl.n), dict(activation_jitter_slots=-1),
               dict(repair=True, policy="oblivious"),
               dict(repair_after_epochs=0), dict(swap_tv_threshold=-0.1),
               dict(faults="plane_down"),
               dict(faults=faults.FaultSchedule(
                   (faults.FaultEvent(0, "tor_fail", node=99),)))):
        with pytest.raises(ValueError):
            simulator.AdaptiveCase(pwl, 150, kw.pop("policy", "adaptive"),
                                   d_hat=2, recfg_frac=RECFG, **kw)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_convert_carries_faults_and_repair_across():
    fs = FaultSchedule(tuple(FaultEvent(*e) for e in _mixed_events()))
    got = convert.fault_schedule_from(fs)
    assert isinstance(got, faults.FaultSchedule)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in fs.events]
    assert convert.fault_schedule_from(None) is None
    assert not convert.fault_schedule_from(FaultSchedule())
    wl = _uniform(n=8, horizon=300)
    case = ref_sim.AdaptiveCase(wl, 100, "adaptive", d_hat=2, faults=fs,
                                repair=True, repair_after_epochs=3,
                                activation_jitter_slots=5,
                                collision="fullest", label="x")
    pc = convert.adaptive_case_from(case)
    assert pc.repair_after_epochs == 3 and pc.repair
    assert [dataclasses.astuple(e) for e in pc.faults.events] == \
        [dataclasses.astuple(e) for e in fs.events]
    for f in dataclasses.fields(case):
        if f.name not in ("wl", "faults", "oracle_demand", "meta"):
            assert getattr(pc, f.name) == getattr(case, f.name), f.name
    sched = ref_schedule.oblivious_schedule(8, d_hat=2, recfg_frac=RECFG)
    sc = ref_sim.SweepCase(sched, wl, label="s", meta={"a": 1}, faults=fs)
    ps = convert.sweep_case_from(sc)
    assert (ps.mode, ps.label, ps.meta) == ("single_hop", "s", {"a": 1})
    assert np.array_equal(ps.sched.perms, sched.perms)
    assert np.array_equal(ps.wl.size, wl.size)
    assert [dataclasses.astuple(e) for e in ps.faults.events] == \
        [dataclasses.astuple(e) for e in fs.events]
    pwl = convert.workload_from(wl)
    assert convert.sweep_case_from(sc, wl=pwl).wl is pwl
