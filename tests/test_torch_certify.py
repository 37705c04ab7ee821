"""repro_torch.analysis.certify against the JAX package's
``repro.analysis.certify`` (numpy only there), everything on the CPU
(``device="cpu"``): the golden demand cases equal, the golden and saturate
certificates equal to the reference's (exactly under ``"hose"``; under
``"saturate"`` theta within rtol 1e-9, since the plain Sinkhorn meets
numpy's ``saturate`` at ~1e-15 and theta is min cap / demand of the
projected demand, everything else exactly), the corruptions tripping the
same failed checks on schedules carried across with
``repro_torch.convert.schedule_from``, the quantized bound, the rounding
hooks, ``batch_parity`` and the CLI's JSON for the two CI invocations."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.analysis import certify as ref_certify
from repro.core import schedule as ref_schedule
from repro_torch import convert
from repro_torch.analysis import certify
from repro_torch.core import schedule
from repro_torch.core.throughput import (
    quantized_theorem3_bound,
    theorem3_bound,
)

CI_INVOCATIONS = [
    ["--case", "skewed", "--n", "16", "--k", "3", "--d-hat", "2",
     "--batch-check"],
    ["--case", "websearch", "--n", "12", "--k", "3", "--d-hat", "4",
     "--recfg-frac", "0.1111"],
]


def _same_certificate(got: dict, want: dict, theta_rtol: float = 0.0):
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    tg, tw = got["bounds"].pop("theta"), want["bounds"].pop("theta")
    assert got == want
    if theta_rtol == 0.0:
        assert tg == tw
    else:
        assert tg == pytest.approx(tw, rel=theta_rtol, abs=0.0)


@pytest.mark.parametrize("case", sorted(certify.DEMAND_CASES))
@pytest.mark.parametrize("n,seed", [(8, 0), (12, 3), (16, 1)])
def test_demand_cases_equal_reference(case, n, seed):
    got = certify.demand_case(case, n, seed=seed)
    want = ref_certify.demand_case(case, n, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown demand case"):
        certify.demand_case("bogus", n)


@pytest.mark.parametrize("case,n,k,d_hat", [
    ("skewed", 16, 3, 2),
    ("websearch", 12, 3, 4),
    ("uniform", 8, 2, 1),
])
def test_certificate_holds_on_golden_cases(case, n, k, d_hat):
    m = certify.demand_case(case, n)
    sched = schedule.vermilion_schedule(m, k=k, d_hat=d_hat, device="cpu")
    res = certify.certify_schedule(m, sched, device="cpu")
    assert res.ok, res.violations
    assert all(v == "pass" for v in res.checks.values())
    assert res.theta >= res.quantized_bound - 1e-9
    assert res.quantized_bound == pytest.approx(theorem3_bound(k))
    want = ref_certify.certify_schedule(
        m, ref_schedule.vermilion_schedule(m, k=k, d_hat=d_hat))
    _same_certificate(res.certificate, want.certificate)
    assert res.theta == want.theta
    assert (res.quantized_bound, res.asymptotic_bound) == \
        (want.quantized_bound, want.asymptotic_bound)


def test_certificate_with_recfg_and_saturate():
    m = certify.demand_case("skewed", 12, seed=3)
    sched = schedule.vermilion_schedule(m, k=3, d_hat=2, recfg_frac=1 / 9,
                                        normalize="saturate", spread=False,
                                        device="cpu")
    res = certify.certify_schedule(m, sched, device="cpu")
    assert res.ok, res.violations
    assert res.quantized_bound == pytest.approx(theorem3_bound(3, 1 / 9))
    ref_sched = ref_schedule.vermilion_schedule(
        m, k=3, d_hat=2, recfg_frac=1 / 9, normalize="saturate",
        spread=False)
    assert np.array_equal(sched.perms, ref_sched.perms)
    want = ref_certify.certify_schedule(m, ref_sched)
    _same_certificate(res.certificate, want.certificate, theta_rtol=1e-9)


def _corruptions(s):
    short = type(s)(perms=s.perms[:-2], d_hat=2, name=s.name,
                    meta=dict(s.meta))
    p = s.perms.copy()
    p[0] = np.arange(s.n)
    ident = type(s)(perms=p, d_hat=2, name=s.name, meta=dict(s.meta))
    p2 = s.perms.copy()
    p2[1, 0] = p2[1, 1]
    dup = type(s)(perms=p2, d_hat=2, name=s.name, meta=dict(s.meta))
    p3 = s.perms.copy()
    p3[:, [2, 5]] = p3[:, [5, 2]]     # two columns swapped: demand moved
    swap = type(s)(perms=p3, d_hat=2, name=s.name, meta=dict(s.meta))
    return {"short": short, "identity": ident, "duplicate": dup,
            "swap": swap}


@pytest.mark.parametrize("which,expect", [
    ("short", {"C2_period"}), ("identity", {"C4_emulation"}),
    ("duplicate", {"C1_perms", "C5_matchings"}), ("swap", set())])
def test_certificate_trips_on_corruptions(which, expect):
    """The reference's corrupted schedules, carried across, fail the same
    checks with the same violations under both checkers."""
    m = certify.demand_case("skewed", 16)
    want_bad = _corruptions(ref_schedule.vermilion_schedule(m, k=3,
                                                            d_hat=2))[which]
    got_bad = convert.schedule_from(want_bad)
    got = certify.certify_schedule(m, got_bad, device="cpu")
    want = ref_certify.certify_schedule(m, want_bad)
    failed = {c for c, v in got.checks.items() if v == "fail"}
    assert failed == {c for c, v in want.checks.items() if v == "fail"}
    assert expect <= failed
    assert got.violations == want.violations
    assert got.ok == want.ok
    _same_certificate(got.certificate, want.certificate)


def test_quantized_bound_forms():
    assert quantized_theorem3_bound(3, 2, 16) == pytest.approx(
        theorem3_bound(3))
    assert quantized_theorem3_bound(3, 4, 12) == pytest.approx(2.0 / 3.0)
    assert quantized_theorem3_bound(3, 5, 7) < theorem3_bound(3)
    assert quantized_theorem3_bound(3, 5, 7) == pytest.approx(
        2 * 7 / (5 * 5.0))


def test_certify_rejects_bad_arguments():
    m = certify.demand_case("skewed", 8)
    s = schedule.vermilion_schedule(m, k=3, d_hat=2, device="cpu")
    with pytest.raises(ValueError, match="demand shape"):
        certify.certify_schedule(np.ones((4, 4)), s, device="cpu")
    bare = type(s)(perms=s.perms, d_hat=2)
    with pytest.raises(ValueError, match="k >= 2"):
        certify.certify_schedule(m, bare, device="cpu")


@pytest.mark.parametrize("normalize", ["hose", "saturate"])
def test_rounding_hooks_match_construction(normalize):
    m = certify.demand_case("skewed", 12)
    scaled = schedule.vermilion_scaled_demands([m], k=3, normalize=normalize,
                                               device="cpu")[0]
    r = schedule.vermilion_rounded([m], k=3, normalize=normalize,
                                   device="cpu")[0]
    assert np.abs(r - scaled).max() < 1.0
    assert r.sum(axis=0).max() <= 2 * 12 and r.sum(axis=1).max() <= 2 * 12
    assert np.diagonal(r).sum() == 0
    assert np.array_equal(r, ref_schedule.vermilion_rounded(
        [m], k=3, normalize=normalize)[0])
    sched = schedule.vermilion_schedule(m, k=3, d_hat=2, normalize=normalize,
                                        device="cpu")
    counts = sched.edge_counts()
    off = ~np.eye(12, dtype=bool)
    assert (counts[off] >= (r + 1)[off]).all()


@pytest.mark.parametrize("normalize", ["hose", "saturate"])
def test_batch_parity_pins_batched_construction(normalize):
    mats = [certify.demand_case("skewed", 10, seed=s) for s in range(3)]
    assert certify.batch_parity(mats, k=3, d_hat=2, normalize=normalize,
                                device="cpu") == []
    assert ref_certify.batch_parity(mats, k=3, d_hat=2,
                                    normalize=normalize) == []


@pytest.mark.parametrize("argv", CI_INVOCATIONS,
                         ids=["skewed-batch", "websearch-recfg"])
def test_certify_main_json_equals_reference(argv, tmp_path, capsys):
    got_p, want_p = tmp_path / "port.json", tmp_path / "ref.json"
    assert certify.main(argv + ["--device", "cpu", "--json",
                                str(got_p)]) == 0
    got_out = capsys.readouterr().out
    assert ref_certify.main(argv + ["--json", str(want_p)]) == 0
    want_out = capsys.readouterr().out
    assert got_p.read_text() == want_p.read_text()
    assert got_out == want_out
    cert = json.loads(got_p.read_text())
    assert cert["violations"] == []
    assert cert["bounds"]["theta"] >= \
        cert["bounds"]["quantized_theorem3"] - 1e-9


def test_certify_main_saturate_and_npy(tmp_path, capsys):
    """The saturate golden through the CLI (theta rtol 1e-9 against the
    reference's), and a demand given as .npy."""
    argv = ["--case", "skewed", "--n", "12", "--seed", "3", "--k", "3",
            "--d-hat", "2", "--recfg-frac", repr(1 / 9), "--normalize",
            "saturate", "--no-spread", "--batch-check"]
    assert certify.main(argv + ["--device", "cpu", "--json",
                                str(tmp_path / "a.json")]) == 0
    assert ref_certify.main(argv + ["--json", str(tmp_path / "b.json")]) == 0
    _same_certificate(json.loads((tmp_path / "a.json").read_text()),
                      json.loads((tmp_path / "b.json").read_text()),
                      theta_rtol=1e-9)
    np.save(tmp_path / "m.npy", certify.demand_case("websearch", 8, seed=2))
    npy = ["--demand", str(tmp_path / "m.npy"), "--k", "3", "--d-hat", "2"]
    assert certify.main(npy + ["--device", "cpu", "--json",
                               str(tmp_path / "c.json")]) == 0
    assert ref_certify.main(npy + ["--json", str(tmp_path / "d.json")]) == 0
    assert (tmp_path / "c.json").read_text() == \
        (tmp_path / "d.json").read_text()
    capsys.readouterr()


def test_certify_main_reports_a_violation(tmp_path, monkeypatch, capsys):
    """A schedule that breaks the guarantee exits 1, printing its
    violations, as the reference's CLI does."""
    real = certify.vermilion_schedule

    def truncated(*a, **kw):
        s = real(*a, **kw)
        return type(s)(perms=s.perms[:-2], d_hat=s.d_hat,
                       recfg_frac=s.recfg_frac, name=s.name,
                       meta=dict(s.meta))

    monkeypatch.setattr(certify, "vermilion_schedule", truncated)
    assert certify.main(["--case", "skewed", "--n", "8", "--device",
                         "cpu"]) == 1
    out = capsys.readouterr().out
    assert "C2_period: fail" in out and "certificate violation" in out
