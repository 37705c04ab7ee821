"""The port's evaluation drivers (``repro_torch.benchmarks``: ``fct_bench``,
``adaptive_bench``, ``schedule_time``, ``run``) against the reference's
(``benchmarks/*.py``, imported from the repo root) on the CPU, at smoke
sizes.

Bars: Fig. 5/6 rows equal to ``run(backend="jax")``'s: completion and
the FCT percentiles exactly, utilization and hops (ratios of delivered
bits) within rtol 1e-5, tests/test_jax_parity.py's bar for bits; adaptive
rows equal to the
reference's numpy engine (its default backend): sorted FCTs, control
counters, excisions and epoch arrays equal, utilization and bits within
rtol 1e-5.  ``run_charging``'s ``"measured"`` cases charge each recompute
its wall clock, so their trajectories follow the host's clock and differ
run to run: they are compared with an integer charge swapped in on both
sides, and the measured rows are only checked to be well formed.  The
CSV line names and JSON keys equal the reference's, with the engine
column renamed: the reference's ``numpy`` / ``jax`` backends are the
port's ``cpu`` / device, ``jax_adaptive`` is ``device_speedup``.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks import adaptive_bench as ref_ab  # noqa: E402
from benchmarks import fct_bench as ref_fct  # noqa: E402
from benchmarks import run as ref_run  # noqa: E402
from benchmarks import schedule_time as ref_st  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro_torch.benchmarks import adaptive_bench as ab  # noqa: E402
from repro_torch.benchmarks import fct_bench as fct  # noqa: E402
from repro_torch.benchmarks import run as port_run  # noqa: E402
from repro_torch.benchmarks import schedule_time as st  # noqa: E402

FCT_GRID = dict(n=8, d_hat=2, horizon=400, loads=(0.3, 0.6))
ADAPTIVE = dict(n=8, d_hat=2, load=0.5, horizon=900, shift_period=300,
                epoch_slots=150, seed=1)


def _stdout(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _names(text, device_map=None):
    """Each CSV line's name, the engine field renamed by ``device_map``."""
    names = []
    for line in text.splitlines():
        if line.startswith("#") or "[" not in line.split(",")[0]:
            continue
        name = line.split("],")[0] + "]"
        for old, new in (device_map or {}).items():
            name = name.replace(f",{old}]", f",{new}]")
        names.append(name)
    return names


def _derived_keys(text):
    return [[kv.split("=")[0] for kv in line.split(",")[-1].split(";") if kv]
            for line in text.splitlines()
            if not line.startswith("#") and "[" in line.split(",")[0]]


def _same_wl(a, b):
    for f in ("src", "dst", "size", "arrival"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.n, a.horizon) == (b.n, b.horizon)


# -- fct_bench ---------------------------------------------------------------

def test_fct_build_grid_equals_reference():
    got = fct.build_grid(**FCT_GRID, device="cpu")
    want = ref_fct.build_grid(**FCT_GRID)
    assert [(c.label, c.mode, c.meta) for c in got] == \
        [(c.label, c.mode, c.meta) for c in want]
    assert {c.label for c in got} == {"vermilion", "greedy", "rotorlb",
                                      "vlb", "obl-singlehop"}
    for a, b in zip(got, want):
        assert np.array_equal(a.sched.perms, b.sched.perms), a.label
        assert (a.sched.d_hat, a.sched.recfg_frac) == \
            (b.sched.d_hat, b.sched.recfg_frac)
        _same_wl(a.wl, b.wl)


def test_fct_run_equals_reference():
    got = fct.run(**FCT_GRID, device="cpu")
    want = ref_fct.run(**FCT_GRID, backend="jax")
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert (a["system"], a["load"], a["device"]) == \
            (b["system"], b["load"], "cpu")
        for k in ("done", "p50_short", "p99_short", "p99_long"):
            assert np.array_equal(a[k], b[k], equal_nan=True), \
                (a["system"], a["load"], k)
        for k in ("util", "hops"):
            assert np.isclose(a[k], b[k], rtol=1e-5, atol=0.0), \
                (a["system"], a["load"], k)
        assert set(a) - {"device"} == set(b) - {"backend"}


def test_fct_main_lines_equal_reference():
    argv = ["--n", "8", "--horizon", "300", "--no-timing"]
    _, got = _stdout(fct.main, argv + ["--device", "cpu"])
    _, want = _stdout(ref_fct.main, argv)
    assert _names(got) == _names(want, {"numpy": "cpu"})
    assert len(_names(got)) == 30
    assert _derived_keys(got) == _derived_keys(want)


def test_fct_timing_table_layout_and_rows():
    """The reference's layout with the columns renamed; the CPU's rows
    and the device's (here the CPU too) equal the Fig. 5/6 run's."""
    kw = dict(n=8, d_hat=2, horizon=200, loads=(0.3,))
    res, got = _stdout(fct.timing_table, **kw, device="cpu")
    _, want = _stdout(ref_fct.timing_table, **kw)
    assert _names(got) == _names(want)
    heads = [line for line in got.splitlines() if line.startswith("# group")]
    assert heads == ["# group,cpu_s,card_s,speedup"]
    assert [line for line in want.splitlines()
            if line.startswith("# group")] == \
        ["# group,old_engine_s,new_engine_s,speedup"]
    assert set(res["groups"]) == {"single_hop", "two_hop", "all"}
    srs: list = []
    fct.run(**kw, device="cpu", sweep_rows=srs)
    for role in ("cpu", "card"):
        assert [r.label for r in res["rows"][role]] == [r.label for r in srs]
        for a, b in zip(res["rows"][role], srs):
            assert np.array_equal(a.result.fct_slots, b.result.fct_slots)
            assert a.result.delivered_bits == b.result.delivered_bits


def test_fct_twohop_table_equals_reference():
    kw = dict(ns=(8, 12), horizon=100, repeats=1)
    got, out = _stdout(fct.twohop_table, **kw, device="cpu")
    want, ref_out = _stdout(ref_fct.twohop_table, **kw)
    assert _names(out) == _names(ref_out, {"numpy": "cpu", "jax": "cpu"})
    key_map = {"backend": "device", "speedup_vs_numpy": "speedup_vs_cpu"}
    for a, b in zip(got, want):
        assert list(a) == [key_map.get(k, k) for k in b]
        assert (a["n"], a["mode"]) == (b["n"], b["mode"])
        assert np.isclose(a["util"], b["util"], rtol=1e-5, atol=0.0)
        assert np.isclose(a["avg_hops"], b["avg_hops"], rtol=1e-5)


# -- adaptive_bench ----------------------------------------------------------

def _fct_sorted_equal(a, b):
    fa, fb = np.sort(a[np.isfinite(a)]), np.sort(b[np.isfinite(b)])
    return fa.shape == fb.shape and np.array_equal(fa, fb)


def _assert_adaptive_rows_equal(got, want):
    assert [r.label for r in got] == [r.label for r in want]
    for a, b in zip(got, want):
        assert a.policy == b.policy and a.meta == b.meta, a.label
        assert _fct_sorted_equal(a.result.fct_slots, b.result.fct_slots), \
            a.label
        for f in ("recomputes", "stale_slots", "dark_slots",
                  "schedule_groups_max", "excised_nodes", "excised_planes"):
            assert getattr(a, f) == getattr(b, f), (a.label, f)
        for f in ("epoch_estimate_tv", "epoch_disagreement",
                  "epoch_collision_loss"):
            assert np.array_equal(getattr(a, f), getattr(b, f),
                                  equal_nan=True), (a.label, f)
        assert a.result.offered_bits == b.result.offered_bits
        for x, y in ((a.result.utilization, b.result.utilization),
                     (a.result.delivered_bits, b.result.delivered_bits),
                     (a.result.fault_lost_bits, b.result.fault_lost_bits),
                     (a.result.fault_refused_bits,
                      b.result.fault_refused_bits),
                     (a.collision_lost_bits, b.collision_lost_bits),
                     (a.dark_plane_slots, b.dark_plane_slots)):
            assert np.isclose(x, y, rtol=1e-5, atol=0.0), a.label
        assert np.allclose(a.epoch_utilization, b.epoch_utilization,
                           rtol=1e-5, atol=0.0), a.label


def _same_case(a, b):
    skip = {"wl", "oracle_demand", "faults"}
    for f in a.__dataclass_fields__:
        if f not in skip:
            assert getattr(a, f) == getattr(b, f), (a.label, f)
    _same_wl(a.wl, b.wl)
    assert (a.oracle_demand is None) == (b.oracle_demand is None)
    if a.oracle_demand is not None:
        assert np.array_equal(a.oracle_demand, b.oracle_demand)
    fa = [] if a.faults is None else a.faults.events
    fb = [] if b.faults is None else b.faults.events
    assert [tuple(vars(e).values()) for e in fa] == \
        [tuple(vars(e).values()) for e in fb], a.label


def test_adaptive_build_cases_equal_reference():
    args = (16, 4, 0.5, 3000, 1000, 150, 1)
    got, want = ab.build_cases(*args), ref_ab.build_cases(*args)
    assert [c.label for c in got][-1] == "adaptive-gather4"
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        _same_case(a, b)


def test_adaptive_run_equals_reference():
    _assert_adaptive_rows_equal(ab.run(**ADAPTIVE, device="cpu"),
                                ref_ab.run(**ADAPTIVE))


def test_adaptive_epoch_tradeoff_equals_reference():
    kw = dict(n=8, d_hat=2, horizon=1200, shift_period=400,
              epoch_grid=(100, 300), penalties=(0, 25))
    got = ab.run_epoch_tradeoff(**kw, device="cpu")
    _assert_adaptive_rows_equal(got, ref_ab.run_epoch_tradeoff(**kw))
    assert any(r.dark_slots > 0 for r in got)


def test_adaptive_disagreement_with_fullest_equals_reference():
    kw = dict(n=8, d_hat=2, load=0.5, horizon=600, shift_period=300,
              epoch_slots=150, steps_grid=(7, 2),
              collisions=("drop", "fullest"))
    got = ab.run_disagreement(**kw, device="cpu")
    _assert_adaptive_rows_equal(got, ref_ab.run_disagreement(**kw))
    assert [r.label for r in got] == ["steps7-drop", "steps2-drop",
                                      "steps7-fullest", "steps2-fullest"]


def test_adaptive_smoke_equals_reference():
    got, out = _stdout(ab.smoke, device="cpu")
    want, ref_out = _stdout(ref_ab.smoke)
    _assert_adaptive_rows_equal(got, want)
    assert _names(out) == _names(ref_out)
    assert _derived_keys(out) == _derived_keys(ref_out)


def _reference_engines(monkeypatch):
    """The reference's ``run_adaptive`` in ``benchmarks/adaptive_bench.py``
    on the engine each case's port mirrors: cases with faults, repair,
    ``fullest`` or jitter on its numpy engine (the port's degraded-service
    engine), every other case on its jax backend (the port's compiled
    path; at load 0.95 the numpy engine's f64 VOQ moves a few FCTs)."""
    def run_adaptive(cases, bps, backend="numpy", sanitize=None):
        rows = [None] * len(cases)
        split = {"numpy": [], "jax": []}
        for i, c in enumerate(cases):
            degraded = (c.faults or c.repair or c.collision == "fullest"
                        or c.activation_jitter_slots)
            split["numpy" if degraded else "jax"].append(i)
        for engine, idx in split.items():
            if idx:
                got = ref_sim.run_adaptive([cases[i] for i in idx], bps,
                                           backend=engine, sanitize=sanitize)
                for i, r in zip(idx, got):
                    rows[i] = r
        return rows
    monkeypatch.setattr(ref_ab, "run_adaptive", run_adaptive)


def test_adaptive_smoke_faults_equals_reference(monkeypatch):
    """``run_faults --smoke`` through each ``main``: the same rows and
    lines."""
    _reference_engines(monkeypatch)
    rows, out = {}, {}
    for side, mod, extra in (("port", ab, ["--device", "cpu"]),
                             ("ref", ref_ab, [])):
        inner = mod.smoke_faults

        def smoke_faults(*a, _inner=inner, _side=side, **kw):
            rows[_side] = _inner(*a, **kw)
            return rows[_side]
        monkeypatch.setattr(mod, "smoke_faults", smoke_faults)
        _, out[side] = _stdout(mod.main, ["run_faults", "--smoke"] + extra)
    _assert_adaptive_rows_equal(rows["port"], rows["ref"])
    assert _names(out["port"]) == _names(out["ref"])
    assert len(rows["port"]) == 12


def test_faults_cases_equal_reference(monkeypatch):
    """``faults_cases`` builds the cases the reference's ``run_faults``
    hands its engine, both trains."""
    seen = []
    monkeypatch.setattr(ref_ab, "run_adaptive",
                        lambda cases, bps, **kw: seen.extend(cases) or [])
    ref_ab.run_faults()
    got = ab.faults_cases()
    assert len(got) == len(seen) == 42
    for a, b in zip(got, seen):
        _same_case(a, b)


def _integer_charges(monkeypatch, module, slots):
    """``module``'s ``AdaptiveCase`` with every ``"measured"`` charge
    replaced by ``slots``."""
    inner = module.AdaptiveCase

    def case(**kw):
        if kw.get("construction_slots") == "measured":
            kw["construction_slots"] = slots
        return inner(**kw)
    monkeypatch.setattr(module, "AdaptiveCase", case)


@pytest.mark.parametrize("slots", [0, 120, 700])
def test_run_charging_with_integer_charges_equals_reference(monkeypatch,
                                                            slots):
    kw = dict(n=8, d_hat=2, load=0.5, horizon=3000, shift_period=1000,
              epoch_slots=500, seed=1)
    _integer_charges(monkeypatch, ab, slots)
    _integer_charges(monkeypatch, ref_ab, slots)
    got = ab.run_charging(**kw, device="cpu")
    _assert_adaptive_rows_equal(got, ref_ab.run_charging(**kw))
    assert [r.label for r in got] == ["free-euler", "charged-euler",
                                      "charged-hk"]
    assert all((r.stale_slots > 0) == (slots > 0 and r.label != "free-euler")
               for r in got)


def test_run_charging_measured_rows_are_well_formed():
    """The clock-charged rows are read, not compared: their trajectories
    follow this host's construction times."""
    rows = ab.run_charging(n=8, d_hat=2, horizon=3000, shift_period=1000,
                           epoch_slots=500, device="cpu")
    assert [r.label for r in rows] == ["free-euler", "charged-euler",
                                       "charged-hk"]
    assert rows[0].stale_slots == 0
    for r in rows:
        assert 0.0 < r.result.utilization <= 1.0
        assert r.recomputes > 0 and r.construction_s > 0.0
        assert r.stale_slots >= 0 and np.isfinite(r.epoch_utilization).all()
    _, out = _stdout(ab.print_charged, rows)
    assert _names(out) == [f"adaptive_charged[{r.label}]" for r in rows]


def test_device_speedup_on_the_cpu():
    sp = ab.run_device_speedup(n=8, d_hat=2, horizon=600, shift_period=300,
                               epoch_slots=150, reps=1, device="cpu")
    assert sp["cases"] == 12 and sp["max_util_abs_diff"] == 0.0
    assert [r["label"] for r in sp["rows"]] == [
        f"steps{s}-{c}" for c in ("drop", "lowest", "receiver")
        for s in (7, 4, 2, 2)]
    _, out = _stdout(ab._print_device_speedup, sp)
    ref_sp = {"numpy_s": sp["cpu_s"], "jax_cold_s": sp["card_cold_s"],
              "jax_warm_s": sp["card_warm_s"],
              **{k: sp[k] for k in ("speedup", "max_util_abs_diff", "cases",
                                    "reps")},
              "rows": [{"util_jax": r["util_card"], **r}
                       for r in sp["rows"]]}
    _, ref_out = _stdout(ref_ab._print_jax_speedup, ref_sp)
    assert _names(out) == [name.replace("adaptive_jax[", "adaptive_device[")
                           for name in _names(ref_out)]


def _small_suite(monkeypatch, module, speedup_name):
    """``module``'s full-suite sections at smoke sizes."""
    small = dict(n=8, d_hat=2, horizon=600, shift_period=300,
                 epoch_slots=150)
    charging, tradeoff, disagree, faults = (module.run_charging,
                                            module.run_epoch_tradeoff,
                                            module.run_disagreement,
                                            module.run_faults)
    monkeypatch.setattr(module, "run_charging", lambda **kw: charging(
        n=8, d_hat=2, horizon=1500, shift_period=500, epoch_slots=500,
        **kw))
    monkeypatch.setattr(module, "run_epoch_tradeoff", lambda **kw: tradeoff(
        n=8, d_hat=2, horizon=600, shift_period=300, epoch_grid=(150, 300),
        penalties=(0, 25), **kw))
    monkeypatch.setattr(module, "run_disagreement", lambda **kw: disagree(
        steps_grid=(7, 2), **small, **kw))
    monkeypatch.setattr(module, "run_faults", lambda **kw: faults(
        n=8, d_hat=2, horizon=900, epoch_slots=150, fault_slot=300,
        severities=(1,), trains=("stationary",), **kw))
    print_faults = module._print_faults
    monkeypatch.setattr(module, "_print_faults",
                        lambda rows, check=True: print_faults(rows, False))
    if module is ref_ab:
        def no_jax():
            raise ImportError
        monkeypatch.setattr(module, speedup_name, no_jax)
    else:
        inner = module.run_device_speedup
        monkeypatch.setattr(module, speedup_name, lambda **kw: inner(
            reps=1, **small, **kw))


def test_adaptive_main_lines_equal_reference(monkeypatch):
    """The full suite's sections at smoke sizes: the same rows and lines,
    the reference's skipped jax comparison aside (``run_charging`` at an
    integer charge)."""
    _reference_engines(monkeypatch)
    _integer_charges(monkeypatch, ab, 120)
    _integer_charges(monkeypatch, ref_ab, 120)
    _small_suite(monkeypatch, ab, "run_device_speedup")
    _small_suite(monkeypatch, ref_ab, "run_jax_speedup")
    argv = ["--n", "8", "--d-hat", "2", "--horizon", "900",
            "--shift-period", "300", "--epoch-slots", "150"]
    got, out = _stdout(ab.main, argv + ["--device", "cpu"])
    want, ref_out = _stdout(ref_ab.main, argv)
    names = [n for n in _names(out) if not n.startswith("adaptive_device[")]
    assert names == _names(ref_out)
    assert [line.split(":")[0] for line in out.splitlines()
            if line.startswith("# ") and "adaptive:" not in line] == \
        [line.split(":")[0] for line in ref_out.splitlines()
         if line.startswith("# ") and "jax adaptive" not in line]
    for a, b in zip(got[:5], want[:5]):
        _assert_adaptive_rows_equal(a, b)
    assert want[5] is None and got[5]["cases"] == 12


def test_adaptive_smoke_main_lines_equal_reference():
    _, out = _stdout(ab.main, ["--smoke", "--device", "cpu"])
    _, ref_out = _stdout(ref_ab.main, ["--smoke"])
    assert _names(out) == _names(ref_out) and _names(out)


# -- schedule_time -----------------------------------------------------------

def test_schedule_time_rows_equal_reference():
    kw = dict(ns=(16, 32), hk_max_n=16, repeats=1)
    got, want = st.run(**kw, device="cpu"), ref_st.run(**kw)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["n"] for r in got] == [16, 32]
    assert "speedup" in got[0] and "speedup" not in got[1]
    assert got[0]["speedup"] > 0


def test_schedule_time_main_lines_equal_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(st, "DEFAULT_NS", (16, 24))
    monkeypatch.setattr(ref_st, "DEFAULT_NS", (16, 24))
    argv = ["--hk-max-n", "16", "--repeats", "1"]
    got, out = _stdout(st.main, argv + ["--device", "cpu", "--json",
                                        str(tmp_path / "rows.json")])
    _, ref_out = _stdout(ref_st.main, argv)
    assert _names(out) == _names(ref_out) == [
        "schedule_time_fig10[n=16]", "schedule_time_fig10[n=24]"]
    assert _derived_keys(out) == _derived_keys(ref_out)
    assert json.loads((tmp_path / "rows.json").read_text()) == got


# -- run.py and the device policy --------------------------------------------

def _stub_harness(monkeypatch, module, drivers):
    """The harness's sections at smoke sizes, through each driver's own
    functions."""
    ab_mod, fct_mod, st_mod = drivers
    if module is ref_run:
        rows = ref_ab.run(**ADAPTIVE)
        speed = None
        twohop = ref_fct.twohop_table(ns=(8,), horizon=100, repeats=1)
        sched = ref_st.run(ns=(16,), hk_max_n=16, repeats=1)
    else:
        rows = ab.run(**ADAPTIVE, device="cpu")
        speed = ab.run_device_speedup(n=8, d_hat=2, horizon=600,
                                      shift_period=300, epoch_slots=150,
                                      reps=1, device="cpu")
        twohop = fct.twohop_table(ns=(8,), horizon=100, repeats=1,
                                  device="cpu")
        sched = st.run(ns=(16,), hk_max_n=16, repeats=1, device="cpu")
    monkeypatch.setattr(ab_mod, "main", lambda *a: (
        rows, rows, rows, rows, rows, speed))
    monkeypatch.setattr(fct_mod, "main", lambda *a: None)
    monkeypatch.setattr(fct_mod, "twohop_table", lambda *a, **kw: twohop)
    monkeypatch.setattr(st_mod, "main", lambda *a: sched)


def test_run_json_keys_equal_reference(monkeypatch, tmp_path):
    from benchmarks import analytic as ref_analytic
    from benchmarks import (bound_convergence as ref_bc,
                            interconnect_bench as ref_ic,
                            throughput_bench as ref_tb)
    from repro_torch.benchmarks import (bound_convergence, interconnect_bench,
                                        throughput_bench)

    for mod in (ref_bc, ref_ic, ref_tb, bound_convergence,
                interconnect_bench, throughput_bench):
        monkeypatch.setattr(mod, "main", lambda *a: None)
    monkeypatch.setattr(ref_analytic, "cell_cost", None)
    monkeypatch.setattr("repro.configs.REGISTRY", {})
    monkeypatch.setattr(ref_run, "RESULTS", tmp_path / "ref")
    _stub_harness(monkeypatch, ref_run, (ref_ab, ref_fct, ref_st))
    _stub_harness(monkeypatch, port_run, (ab, fct, st))
    _, ref_out = _stdout(ref_run.main)
    got, out = _stdout(port_run.main, ["--device", "cpu", "--out",
                                       str(tmp_path / "port")])
    assert [line.split(":")[0] for line in out.splitlines()
            if line.startswith("# section ")] == [
        f"# section {s}" for s in ("throughput_fig7", "bound_fig8",
                                   "fct_fig5", "adaptive", "twohop",
                                   "schedule_time_fig10", "interconnect")]
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir()) \
        == ["BENCH_adaptive.json", "BENCH_schedule.json",
            "BENCH_twohop.json"]
    load = {side: {n: json.loads((tmp_path / side / n).read_text())
                   for n in names} for side in ("ref", "port")}
    a, b = load["port"]["BENCH_adaptive.json"], \
        load["ref"]["BENCH_adaptive.json"]
    assert list(a) == [("device_speedup" if k == "jax_adaptive" else k)
                       for k in b]
    for k in ("sweep", "charged", "epoch_tradeoff", "disagreement",
              "faults"):
        assert [list(r) for r in a[k]] == [list(r) for r in b[k]], k
        assert [r["label"] for r in a[k]] == [r["label"] for r in b[k]]
    assert [list(r) for r in load["port"]["BENCH_schedule.json"]] == \
        [list(r) for r in load["ref"]["BENCH_schedule.json"]]
    key_map = {"backend": "device", "speedup_vs_numpy": "speedup_vs_cpu"}
    assert [list(r) for r in load["port"]["BENCH_twohop.json"]] == \
        [[key_map.get(k, k) for k in r]
         for r in load["ref"]["BENCH_twohop.json"]]
    assert got["BENCH_adaptive.json"]["device_speedup"]["cases"] == 12


@pytest.mark.parametrize("module,argv", [
    (fct, []), (ab, []), (ab, ["--smoke"]), (ab, ["run_faults"]),
    (st, []), (port_run, [])])
def test_main_without_device_needs_a_card(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
