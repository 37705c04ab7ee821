"""repro_torch's two-hop and aggregate data planes against ``repro``'s jax
backend on the same objects (carried across by ``repro_torch.convert``):
``run_sweep`` on every two-hop case of tests/test_jax_parity.py, the batch
function against ``_twohop_batch_jax`` on tests/test_simulator.py's
cases, each step's per-slot outputs against the reference's jitted scans,
``simulate_aggregate`` against ``simulate_aggregate_jax``, and the route
(``twohop_fct`` / dense / sparse) against the reference's choice.

Bars: FCT arrays equal exactly; delivered bits, utilization and
``avg_hops`` within rtol 1e-5; per-slot step outputs and the aggregate
plane within rtol 1e-6 (f32 in both, reductions in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro_torch import convert
from repro_torch.core import simulator

BPS = 100e9 * 4.5e-6
RECFG = 1 / 9


def _port_cases(cases_ref):
    return [simulator.SweepCase(convert.schedule_from(c.sched),
                                convert.workload_from(c.wl), c.mode,
                                c.label, dict(c.meta))
            for c in cases_ref]


def _assert_results_equal(a, b, exact_fct=True):
    if exact_fct:
        assert np.array_equal(a.fct_slots, b.fct_slots, equal_nan=True)
    for f in ("delivered_bits", "utilization", "avg_hops"):
        assert np.isclose(getattr(a, f), getattr(b, f), rtol=1e-5), f
    assert a.offered_bits == b.offered_bits


def _both(cases_ref, **kw):
    rows_ref = ref_sim.run_sweep(cases_ref, BPS, backend="jax")
    rows = simulator.run_sweep(_port_cases(cases_ref), BPS, device="cpu",
                               **kw)
    assert [r.label for r in rows] == [r.label for r in rows_ref]
    for a, b in zip(rows_ref, rows):
        assert a.mode == b.mode
        _assert_results_equal(a.result, b.result)
    return rows_ref, rows


def _obl(n, d_hat):
    return ref_schedule.oblivious_schedule(n, d_hat=d_hat, recfg_frac=RECFG)


# ---------------------------------------------------------------------------
# run_sweep on test_jax_parity's two-hop cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["rotorlb", "vlb"])
def test_sweep_fct_multiset_parity(mode):
    wl = ref_sim.websearch_workload(8, 0.4, 300, BPS, d_hat=2, seed=5)
    _, rows = _both([ref_sim.SweepCase(_obl(8, 2), wl, mode, mode)])
    r = rows[0].result
    assert np.isfinite(r.fct_slots).any() and r.avg_hops > 1.0


@pytest.mark.parametrize("mode", ["rotorlb", "vlb"])
def test_sweep_fct_parity_overload(mode):
    """Sustained backlog: deep relay queues exercise the level slack of
    the pro-rata replay."""
    wl = ref_sim.websearch_workload(6, 2.5, 400, BPS, d_hat=1, seed=0)
    _both([ref_sim.SweepCase(_obl(6, 1), wl, mode, mode)])


def test_sweep_fct_parity_mixed_horizons():
    s = _obl(8, 2)
    wl_a = ref_sim.websearch_workload(8, 0.5, 120, BPS, d_hat=2, seed=2)
    wl_b = ref_sim.websearch_workload(8, 0.5, 300, BPS, d_hat=2, seed=3)
    _both([ref_sim.SweepCase(s, wl_a, "rotorlb", "short"),
           ref_sim.SweepCase(s, wl_b, "vlb", "long")])


def test_mixed_mode_grid():
    """test_simulator's mixed-mode grid: single_hop + rotorlb + vlb in one
    sweep, two batches, results in input order."""
    wl = ref_sim.websearch_workload(8, 0.4, 250, BPS, d_hat=2, seed=5)
    sv = ref_schedule.vermilion_schedule(wl.demand_matrix(), k=3, d_hat=2,
                                         recfg_frac=RECFG)
    so = _obl(8, 2)
    timings = {}
    _, rows = _both([ref_sim.SweepCase(sv, wl, "single_hop", "v"),
                     ref_sim.SweepCase(so, wl, "rotorlb", "r"),
                     ref_sim.SweepCase(so, wl, "vlb", "l")],
                    timings=timings)
    assert rows[2].result.avg_hops >= rows[1].result.avg_hops >= 1.0
    assert rows[0].result.avg_hops == 1.0
    assert [(b["route"], b["cases"]) for b in timings["batches"]] == [
        ("singlehop", 1), ("twohop_fct", 2)]
    assert timings["slots"] == 500


def test_sanitized_twohop_run_is_identical():
    wl = ref_sim.websearch_workload(8, 0.6, 200, BPS, d_hat=2, seed=4)
    cases = [ref_sim.SweepCase(_obl(8, 2), wl, m, m)
             for m in ("rotorlb", "vlb")]
    _, plain = _both(cases, sanitize=False)
    timings = {}
    _, checked = _both(cases, sanitize=True, timings=timings)
    for a, b in zip(plain, checked):
        _assert_results_equal(a.result, b.result)
    for key in ("layout_s", "upload_s", "device_loop_s", "download_s",
                "replay_s", "sanitize_s"):
        assert timings[key] >= 0.0, key
    assert timings["slots"] == 200


# ---------------------------------------------------------------------------
# The batch function against _twohop_batch_jax (test_simulator's cases)
# ---------------------------------------------------------------------------

def _batch_both(cases_ref, modes, kernel):
    ref = ref_sim._twohop_batch_jax(cases_ref, BPS, modes, kernel=kernel)
    port = simulator._twohop_batch(
        [(convert.schedule_from(s), convert.workload_from(wl))
         for s, wl in cases_ref], BPS, modes, torch.device("cpu"),
        kernel=kernel)
    for a, b in zip(ref, port):
        _assert_results_equal(a, b)
    return port


@pytest.mark.parametrize("mode", ["rotorlb", "vlb"])
@pytest.mark.parametrize("kernel", ["dense", "sparse"])
def test_twohop_batch_parity(mode, kernel):
    wl = ref_sim.websearch_workload(10, 0.45, 300, BPS, d_hat=2, seed=1)
    r = _batch_both([(_obl(10, 2), wl)], [mode], kernel)[0]
    assert np.isinf(r.fct_slots).all() and r.delivered_bits > 0


def test_twohop_batch_overloaded():
    wl = ref_sim.websearch_workload(6, 2.5, 400, BPS, d_hat=1, seed=0)
    s = _obl(6, 1)
    for kernel in (None, "dense", "sparse"):
        _batch_both([(s, wl), (s, wl)], ["rotorlb", "vlb"], kernel)


def test_twohop_batch_rejects_single_hop():
    wl = simulator.websearch_workload(6, 0.3, 50, BPS, d_hat=1, seed=0)
    s = simulator.oblivious_schedule(6, d_hat=1)
    with pytest.raises(ValueError, match="not a two-hop mode"):
        simulator._twohop_batch([(s, wl)], BPS, ["single_hop"],
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="kernel"):
        simulator._twohop_batch([(s, wl)], BPS, ["vlb"],
                                torch.device("cpu"), kernel="einsum")


# ---------------------------------------------------------------------------
# Each step's per-slot outputs against the reference's jitted scans
# ---------------------------------------------------------------------------

def _mixed_batch():
    s = _obl(8, 2)
    wl_a = ref_sim.websearch_workload(8, 0.7, 150, BPS, d_hat=2, seed=2)
    wl_b = ref_sim.websearch_workload(8, 0.7, 200, BPS, d_hat=2, seed=3)
    return [(s, wl_a), (s, wl_b)], ["rotorlb", "vlb"]


def _ref_step_outputs(route, cases, modes):
    """The reference kernel's per-slot outputs on its own padded inputs,
    cut to the batch's horizon."""
    fns = ref_sim.jax_kernels()
    caps_list, caps_flat, cap_idx, apos, asz, live, H = \
        ref_sim._jax_batch_inputs(cases, BPS)
    direct = np.array([0.0 if m == "vlb" else 1.0 for m in modes],
                      dtype=np.float32).reshape(-1, 1, 1)
    if route == "sparse":
        plans = ref_sim._SupportPlans(caps_list, cases[0][1].n,
                                      list(range(len(cases))), len(cases))
        keys, plan_list = {}, []
        plan_idx = np.zeros(apos.shape[0], dtype=np.int32)
        for slot in range(H):
            pi = keys.setdefault(plans.key(slot), len(plan_list))
            if pi == len(plan_list):
                plan_list.append(plans.plan(slot))
            plan_idx[slot] = pi
        J = max(p["J"] for p in plan_list)
        lut = [np.zeros((len(plan_list), J), dtype=np.int32)
               for _ in range(3)] + [
            np.zeros((len(plan_list), J), dtype=bool)]
        for i, p in enumerate(plan_list):
            for arr, key in zip(lut, ("row", "v", "b")):
                arr[i, :p["J"]] = p[key]
            lut[3][i, :p["J"]] = True
        out, _ = fns["twohop_sparse"](caps_flat, cap_idx, apos, asz, live,
                                      plan_idx, *lut, direct)
    else:
        out, _ = fns[f"twohop_{route}"](caps_flat, cap_idx, apos, asz, live,
                                        direct)
    return [np.asarray(o)[:H] for o in out]


@pytest.mark.parametrize("route", ["fct", "dense", "sparse"])
def test_step_outputs_match_jax_scan(route, monkeypatch):
    cases, modes = _mixed_batch()
    want = _ref_step_outputs(route, cases, modes)
    name = f"twohop_{route}"
    inner = getattr(simulator, name)
    got = []

    def keep(*args):
        inner(*args)
        got.extend(a.numpy().copy() for a in args[-2:])

    monkeypatch.setattr(simulator, name, keep)
    simulator._twohop_batch(
        [(convert.schedule_from(s), convert.workload_from(wl))
         for s, wl in cases], BPS, modes, torch.device("cpu"),
        kernel=None if route == "fct" else route)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0.0)
    assert want[0].sum() > 0 and want[1].sum() > 0


@pytest.mark.parametrize("seed", range(4))
def test_arrival_rounds_add_like_the_cpu(seed):
    """twohop_fct's arrivals by rounds: each round holds distinct pairs of
    one slot, and adding round by round gives the bits of the in-order
    adds (what an index_add_ of the slot gives on the CPU)."""
    rng = np.random.default_rng(seed)
    H, A, P = 12, 300, 9
    slot = np.sort(rng.integers(0, H, A))
    apid = rng.integers(0, P, A)
    size = rng.uniform(1.0, 1e7, A).astype(np.float32)
    bucket = np.searchsorted(slot, np.arange(H + 1))
    perm, bounds, slot_rounds = simulator._arrival_rounds(apid, bucket)
    assert np.array_equal(np.sort(perm), np.arange(A))
    want, got = torch.zeros(P), torch.zeros(P)
    for h in range(H):
        want.index_add_(0, torch.from_numpy(apid[bucket[h]:bucket[h + 1]]),
                        torch.from_numpy(size[bucket[h]:bucket[h + 1]]))
        for r in range(slot_rounds[h], slot_rounds[h + 1]):
            seg = perm[bounds[r]:bounds[r + 1]]
            assert len(np.unique(apid[seg])) == len(seg)
            assert (slot[seg] == h).all()
            got.index_add_(0, torch.from_numpy(apid[seg]),
                           torch.from_numpy(size[seg]))
        assert torch.equal(got, want), h
    assert slot_rounds[-1] == len(bounds) - 1 > H


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8, 12, 16, 33])
def test_tree_sum_is_a_sum(k):
    x = torch.rand(2, k, 5, dtype=torch.float64)
    got = simulator._tree_sum(x, 1)
    assert got.shape == (2, 5)
    torch.testing.assert_close(got, x.sum(dim=1), rtol=1e-14, atol=0.0)


# ---------------------------------------------------------------------------
# simulate_aggregate against simulate_aggregate_jax
# ---------------------------------------------------------------------------

def test_simulate_aggregate_parity():
    """test_simulator.py::test_jax_parity's case (25G links)."""
    bps = 25e9 * 4.5e-6
    wl = ref_sim.websearch_workload(6, 0.3, 300, bps, d_hat=2, seed=2)
    s = ref_schedule.vermilion_schedule(wl.demand_matrix(), k=3, d_hat=2,
                                        recfg_frac=RECFG)
    arr = wl.arrival_matrix()
    d_ref, voq_ref = ref_sim.simulate_aggregate_jax(s, arr, bps)
    d, voq = simulator.simulate_aggregate(convert.schedule_from(s), arr, bps,
                                          device="cpu")
    assert d.shape == (300,) and d.dtype == np.float32
    assert voq.shape == (6, 6)
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(voq, voq_ref, rtol=1e-6, atol=1e-3)
    assert d.sum() > 0


def test_simulate_aggregate_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = simulator.oblivious_schedule(4, d_hat=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.simulate_aggregate(s, np.zeros((3, 4, 4)), BPS)


# ---------------------------------------------------------------------------
# The route against the reference's, around n = 64, n = 256 and 2^27 bytes
# ---------------------------------------------------------------------------

class _Routed(Exception):
    pass


def _stub(name):
    def run(*args, **kw):
        raise _Routed(name)
    return run


@pytest.mark.parametrize("B,n,H", [
    (1, 64, 300), (1, 65, 300),
    (2, 64, 4096), (2, 64, 4097),        # H_pad * B * n^2 * 4 = 2^27, past it
    (3, 64, 2688), (3, 64, 2689),
    (1, 64, 8192), (1, 64, 8193),
    (4, 16, 100), (1, 256, 50), (1, 257, 50),
])
def test_route_matches_reference(B, n, H, monkeypatch):
    wl = ref_sim.Workload(src=np.array([0, 1]), dst=np.array([1, 0]),
                          size=np.array([1e5, 2e5]),
                          arrival=np.array([0, H - 1]), n=n, horizon=H)
    s = ref_schedule.oblivious_schedule(n, d_hat=4, recfg_frac=RECFG)
    cases = [(s, wl)] * B
    modes = ["rotorlb"] * B
    stubs = {k: _stub(k) for k in ("twohop_fct", "twohop_dense",
                                   "twohop_sparse")}
    monkeypatch.setattr(ref_sim, "_jax_fns", lambda: stubs)
    monkeypatch.setattr(ref_sim, "_record_call", lambda *a: None)
    with pytest.raises(_Routed) as ref_route:
        ref_sim._twohop_batch_jax(cases, BPS, modes)
    for k in stubs:
        monkeypatch.setattr(simulator, k, _stub(k))
    port = [(convert.schedule_from(s), convert.workload_from(wl))] * B
    with pytest.raises(_Routed) as route:
        simulator._twohop_batch(port, BPS, modes, torch.device("cpu"))
    assert str(route.value) == str(ref_route.value)
    assert simulator._twohop_route(B, n, H) == str(ref_route.value)
