"""repro_torch.analysis.ir: the op-level reports of the five slot kernels
on their engine paths, the checked-in budget and the gate's exit codes,
and each kernel's carry against the reference's ``repro.analysis.ir`` at
the same dims."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.ir import (
    DEFAULT_BUDGET,
    _REF_DIMS,
    analyze_all,
    analyze_kernel,
    check_budget,
    load_budget,
    main as ir_main,
)
from repro_torch.core import simulator

KERNELS = ("agg", "singlehop", "twohop_dense", "twohop_fct", "twohop_sparse")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its kernels run many small ops,
    which several threads each would only contend for the cores that
    pytest-xdist's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reports():
    return {r.kernel: r for r in analyze_all(device="cpu")}


@pytest.fixture(scope="module")
def reference(reports):
    """The reference's reports at each port report's dims (``agg`` at the
    one case its engine path serves)."""
    pytest.importorskip("jax")
    from repro.analysis.ir import analyze_kernel as ref_analyze_kernel
    return {k: ref_analyze_kernel(k, **r.dims) for k, r in reports.items()}


def test_reports_all_slot_kernels_within_the_checked_in_budget(reports):
    assert set(reports) == set(simulator.slot_kernels()) == set(KERNELS)
    assert set(simulator.KERNEL_CARRIES) == set(KERNELS)
    for r in reports.values():
        assert r.flops > 0 and r.bytes_moved > 0 and r.peak_bytes > 0
        assert r.carry_bytes > 0 and r.carry_shapes
        # dtype-clean, and every op the kernels issue is in the flop model
        assert r.dtype_leaks == [] and r.unknown_prims == [], r.kernel
    assert check_budget(list(reports.values()),
                        load_budget(DEFAULT_BUDGET)) == []


@pytest.mark.parametrize("kernel", KERNELS)
def test_carry_matches_the_reference(kernel, reports, reference):
    """The slot carries the engine allocates at B 2, n 8 (``agg`` at B 1,
    as ``simulate_aggregate`` serves one case), and the exponent from n 16,
    equal the reference's scan carries at the same dims: (B, n, n) f32
    state, ~n^2; twohop_fct's (B, n, n, n) attribution tensor beside its
    VOQ, ~n^2.92."""
    got, want = reports[kernel], reference[kernel]
    assert got.dims == {"B": 1 if kernel == "agg" else 2, "n": 8}
    assert got.carry_bytes == want.carry_bytes
    assert got.carry_exponent == want.carry_exponent


def test_dot_flops(reports, reference):
    """``twohop_dense``'s relay product contracts (B, n, n) by (B, n, n)
    each of the 128 slots: 2 B n^3 H, as the reference's einsum.  The
    port's ``twohop_fct`` forms its relay spray as a broadcast outer
    product (a fixed order, so the card's bits equal the CPU's), no matrix
    product, where the reference's is an einsum: 0 dot flops against the
    reference's 262,144."""
    b, n = _REF_DIMS["B"], _REF_DIMS["n"]
    assert reports["twohop_dense"].dot_flops == 2 * b * n ** 3 * \
        simulator._PAD_H == reference["twohop_dense"].dot_flops == 262144
    assert reports["twohop_fct"].dot_flops == 0
    assert reference["twohop_fct"].dot_flops == 262144


def test_budget_gate_exit_codes(tmp_path):
    bp = tmp_path / "budget.json"
    one = ["--device", "cpu", "--kernel", "agg", "--budget", str(bp)]
    assert ir_main(one + ["--write-budget"]) == 0
    out = tmp_path / "report.json"
    assert ir_main(one + ["--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["violations"] == [] and len(rep["reports"]) == 1
    # a regressed kernel (budget below measurement) trips the gate
    b = load_budget(str(bp))
    b["kernels"]["agg"]["flops"] = 1
    bp.write_text(json.dumps(b))
    assert ir_main(one) == 1
    # so does a kernel the budget has never seen
    del b["kernels"]["agg"]
    bp.write_text(json.dumps(b))
    assert ir_main(one) == 1
    # a missing budget file has an exit of its own
    assert ir_main(["--device", "cpu", "--kernel", "agg", "--budget",
                    str(tmp_path / "nope.json")]) == 2


def test_reports_repeat_and_the_driver_refuses_unknown(reports):
    """A second run gives the same report field for field (the counts are
    the ops that run, not timings); an unknown kernel, and agg at more
    cases than its engine path serves, are refused."""
    again = analyze_kernel("twohop_sparse", device="cpu")
    assert again.to_dict() == reports["twohop_sparse"].to_dict()
    with pytest.raises(ValueError, match="unknown kernel"):
        simulator.drive_slot_kernel("multi_hop", None, device="cpu")
    with pytest.raises(ValueError, match="one case"):
        simulator.drive_slot_kernel("agg", None, B=2, device="cpu")


def test_the_gate_reads_the_engines_carry(monkeypatch, reports):
    """The carry is what the engine allocates, not a copy of its layout:
    widen the engine's data type and agg's VOQ doubles, which the budget's
    carry and dtype checks both catch."""
    monkeypatch.setattr(simulator, "DATA_DTYPE", torch.float64)
    wide = analyze_kernel("agg", device="cpu")
    assert wide.carry_bytes == 2 * reports["agg"].carry_bytes
    assert wide.carry_shapes == ["(1, 8, 8):float64"]
    found = check_budget([wide], load_budget(DEFAULT_BUDGET))
    assert any("IR1[carry_bytes]" in v for v in found), found
    assert any("IR3[dtype]" in v for v in found), found


def test_analyzer_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ir_main(["--kernel", "agg"])


def test_a_pass_through_hook_changes_nothing(monkeypatch):
    """The engine's results are the same whether its slot kernels run
    directly or through a hook that calls them on the arguments by name,
    as the analyzer's does."""
    sched = simulator.oblivious_schedule(8, d_hat=2)
    bits = simulator._DRIVE_BITS
    cases = [simulator.SweepCase(
        sched, simulator.websearch_workload(8, 0.6, 128, bits, d_hat=2,
                                            seed=s, pattern="uniform"),
        mode=m) for s, m in enumerate(("single_hop", "rotorlb", "vlb"))]
    arrivals = cases[0].wl.arrival_matrix()

    def run():
        rows = simulator.run_sweep(cases, bits, device="cpu")
        return ([(r.result.fct_slots, r.result.delivered_bits)
                 for r in rows],
                simulator.simulate_aggregate(sched, arrivals, bits,
                                             device="cpu"))

    direct = run()
    seen = []

    def hook(name, fn, kw):
        seen.append(name)
        return fn(**kw)

    monkeypatch.setattr(simulator, "_slot_hook", hook)
    hooked = run()
    assert sorted(seen) == ["agg", "singlehop", "twohop_fct"]
    for (fa, da), (fb, db) in zip(direct[0], hooked[0]):
        assert da == db
        torch.testing.assert_close(torch.from_numpy(fa),
                                   torch.from_numpy(fb), rtol=0, atol=0)
    for a, b in zip(direct[1], hooked[1]):
        assert (a == b).all()
