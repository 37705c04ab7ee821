"""repro_torch single-hop sweep against ``repro``'s ``run_sweep(backend="jax")``
on the same objects (carried across by ``repro_torch.convert``): the
single-hop parity cases of tests/test_jax_parity.py, the data plane step
against the JAX ``singlehop`` scan, the sanitizer, the device policy, and
the import boundary of the port (the two-hop cases are in
tests/test_torch_twohop.py).

Bars: FCT arrays equal exactly; delivered bits within rtol 1e-5 (the
reference's own parity bar).  On the CPU the data plane reproduces the
JAX scan bit for bit, so the tests also pin the per-slot outputs exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_sim
from repro_torch import convert
from repro_torch.core import faults, simulator
from repro_torch.core.schedule import vermilion_schedule

BPS = 100e9 * 4.5e-6
RECFG = 1 / 9
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _both(cases_ref, **kw):
    """Run reference cases through repro (jax) and the port (cpu)."""
    rows_ref = ref_sim.run_sweep(cases_ref, BPS, backend="jax")
    cases = [simulator.SweepCase(convert.schedule_from(c.sched),
                                 convert.workload_from(c.wl), c.mode,
                                 c.label, dict(c.meta))
             for c in cases_ref]
    rows = simulator.run_sweep(cases, BPS, device="cpu", **kw)
    return rows_ref, rows


def _assert_rows_equal(rows_ref, rows):
    assert len(rows_ref) == len(rows)
    for a, b in zip(rows_ref, rows):
        assert a.label == b.label and a.mode == b.mode
        assert np.array_equal(a.result.fct_slots, b.result.fct_slots,
                              equal_nan=True), a.label
        assert np.isclose(a.result.delivered_bits, b.result.delivered_bits,
                          rtol=1e-5), a.label
        assert a.result.offered_bits == b.result.offered_bits
        assert np.isclose(a.result.utilization, b.result.utilization,
                          rtol=1e-5)


def _vermilion_case(normalize="hose", n=8, load=0.4, horizon=300, d_hat=2,
                    seed=5):
    wl = ref_sim.websearch_workload(n, load, horizon, BPS, d_hat=d_hat,
                                    seed=seed)
    s = ref_schedule.vermilion_schedule(wl.demand_matrix(), k=3,
                                        d_hat=d_hat, recfg_frac=RECFG,
                                        normalize=normalize)
    return ref_sim.SweepCase(s, wl, "single_hop", f"vermilion-{normalize}")


def test_sweep_fct_parity_vermilion():
    """test_jax_parity's n=8 Vermilion single-hop case."""
    _assert_rows_equal(*_both([_vermilion_case()]))


def test_sweep_fct_parity_overload():
    """Sustained backlog: deep queues exercise drain reconciliation."""
    wl = ref_sim.websearch_workload(6, 2.5, 400, BPS, d_hat=1, seed=0)
    s = ref_schedule.oblivious_schedule(6, d_hat=1, recfg_frac=RECFG)
    _assert_rows_equal(*_both([ref_sim.SweepCase(s, wl, "single_hop", "o")]))


def test_sweep_fct_parity_mixed_horizons():
    """Two horizons in one batch: no service leaks past the shorter case's
    end."""
    s = ref_schedule.oblivious_schedule(8, d_hat=2, recfg_frac=RECFG)
    wl_a = ref_sim.websearch_workload(8, 0.5, 120, BPS, d_hat=2, seed=2)
    wl_b = ref_sim.websearch_workload(8, 0.5, 300, BPS, d_hat=2, seed=3)
    _assert_rows_equal(*_both([
        ref_sim.SweepCase(s, wl_a, "single_hop", "short"),
        ref_sim.SweepCase(s, wl_b, "single_hop", "long")]))


def test_sweep_fct_parity_saturate_batch():
    """The main path at small size: a batch of loads, Vermilion schedules
    built with normalize="saturate"."""
    cases = [_vermilion_case("saturate", n=16, load=load, horizon=400,
                             d_hat=4, seed=1) for load in (0.15, 0.6)]
    _assert_rows_equal(*_both(cases))


def test_sweep_percentiles_available():
    wl = ref_sim.websearch_workload(8, 0.4, 300, BPS, d_hat=2, seed=7)
    s = ref_schedule.vermilion_schedule(wl.demand_matrix(), k=3, d_hat=2,
                                        recfg_frac=RECFG)
    _, rows = _both([ref_sim.SweepCase(s, wl, "single_hop", "v")])
    r = rows[0].result
    assert np.isfinite(r.fct_percentile(50))
    assert np.isfinite(r.fct_percentile(99))
    assert 0.0 < r.completed_frac <= 1.0


def test_data_plane_matches_jax_scan():
    """The port's ``singlehop`` loop against the JAX ``singlehop`` scan on
    the same plan and arrivals: tx, drained and the final VOQ carry."""
    case = _vermilion_case(n=8, load=0.9, horizon=200, d_hat=2)
    sched, wl = case.sched, case.wl
    n, H = wl.n, wl.horizon
    H_pad = ref_sim._pad_to(H, ref_sim._PAD_H)
    ppid, pcap = sched.slot_circuits_padded(BPS, j_pad=ref_sim._PAD_J)
    ps = np.arange(H_pad) % ppid.shape[0]
    p_pid, p_cap = ppid[ps], pcap[ps]
    p_cap[H:] = 0.0
    hz = np.array([H])
    *_, order, bucket, apid_j, asz_j = ref_sim._singlehop_jax_flows(
        [wl], n, hz, H, H_pad)
    voq_j, (tx_j, dr_j) = ref_sim._jax_fns()["singlehop"](
        np.zeros(n * n, np.float32), apid_j, asz_j, p_pid, p_cap)

    *_, bucket_t, apid, asz = simulator._batch_flows(
        [convert.workload_from(wl)], n, hz, H)
    assert np.array_equal(bucket_t, bucket)
    voq = torch.zeros(n * n, dtype=torch.float32)
    tx = torch.empty((H, p_pid.shape[1]), dtype=torch.float32)
    dr = torch.empty((H, p_pid.shape[1]), dtype=torch.bool)
    simulator.singlehop(voq, torch.from_numpy(apid), torch.from_numpy(asz),
                        bucket_t, torch.from_numpy(p_pid[:H].astype(np.int64)),
                        torch.from_numpy(p_cap[:H]), tx, dr)
    assert np.array_equal(tx.numpy(), np.asarray(tx_j)[:H])
    assert np.array_equal(dr.numpy(), np.asarray(dr_j)[:H])
    assert np.array_equal(voq.numpy(), np.asarray(voq_j))
    assert tx.numpy().sum() > 0 and dr.numpy().any()


def test_sanitized_run_is_identical():
    case = _vermilion_case("saturate", n=8, load=0.7, horizon=200)
    _, plain = _both([case], sanitize=False)
    timings = {}
    _, checked = _both([case], sanitize=True, timings=timings)
    _assert_rows_equal(plain, checked)
    assert timings["slots"] == 200 and timings["sanitize_s"] >= 0.0
    for key in ("layout_s", "upload_s", "device_loop_s", "download_s",
                "replay_s"):
        assert timings[key] >= 0.0, key


def test_sanitizer_catches_a_broken_schedule():
    from repro_torch.analysis.sanitize import SanitizeError

    case = _vermilion_case(n=8, horizon=50)
    bad = convert.schedule_from(case.sched)
    bad.perms[0, :2] = 0            # not a permutation any more
    wl = convert.workload_from(case.wl)
    with pytest.raises(SanitizeError, match="not permutations"):
        simulator.run_sweep([simulator.SweepCase(bad, wl)], BPS,
                            device="cpu", sanitize=True)


def test_faults_and_unknown_modes_raise():
    """Fault injection runs (tests/test_torch_faults.py); what the
    reference rejects at construction the port rejects too: faults that
    are not a FaultSchedule, faults on a two-hop case, an unknown mode."""
    case = _vermilion_case(n=8, horizon=50)
    s, wl = convert.schedule_from(case.sched), convert.workload_from(case.wl)
    with pytest.raises(ValueError, match="FaultSchedule"):
        simulator.SweepCase(s, wl, faults=[object()])
    fs = faults.FaultSchedule((faults.FaultEvent(10, "plane_down",
                                                 plane=0),))
    with pytest.raises(ValueError, match="single_hop"):
        simulator.SweepCase(s, wl, "rotorlb", faults=fs)
    with pytest.raises(ValueError):
        simulator.SweepCase(s, wl, "multi_hop")


def test_run_sweep_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = simulator.websearch_workload(8, 0.4, 50, BPS, d_hat=2, seed=5)
    s = vermilion_schedule(wl.demand_matrix(), d_hat=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.run_sweep([simulator.SweepCase(s, wl)], BPS)
    simulator.run_sweep([simulator.SweepCase(s, wl)], BPS, device="cpu")


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of repro_torch loads no jax and no repro."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 79, mods\n"
        "assert {'repro_torch.core.throughput', 'repro_torch.core.collectives',"
        " 'repro_torch.analysis.certify', 'repro_torch.core.faults',"
        " 'repro_torch.benchmarks.fct_bench',"
        " 'repro_torch.benchmarks.adaptive_bench',"
        " 'repro_torch.benchmarks.schedule_time',"
        " 'repro_torch.benchmarks.run',"
        " 'repro_torch.data.pipeline', 'repro_torch.ckpt.checkpoint',"
        " 'repro_torch.train.optimizer', 'repro_torch.train.compression',"
        " 'repro_torch.train.train_step', 'repro_torch.train.trainer',"
        " 'repro_torch.launch.train', 'repro_torch.tree',"
        " 'repro_torch.kernels.flash_attention_bwd.ops',"
        " 'repro_torch.analysis.lint', 'repro_torch.analysis.ir'}"
        " <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
