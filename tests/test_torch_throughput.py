"""repro_torch throughput theory and the BvN strawman against the JAX
package: the closed forms, the bounds and the HiGHS LP equal exactly on
equal inputs (the port builds the LP as the reference does); the
properties of tests/test_throughput.py (Theorems 1-3, the 1/2 oblivious
bound, Fig. 7/8 trends) on the port; the Fig. 7 rows and one seed of each
Fig. 8 row equal to the reference's; ``bvn_decompose`` / ``bvn_schedule``
with the projection on the CPU (``device="cpu"``): perms and lambdas
equal, ties of the quantization included (the CPU projection is numpy's
own ``saturate`` loop)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import schedule as ref_schedule
from repro.core import throughput as ref_tp
from repro.core import traffic as ref_traffic
from repro_torch.benchmarks import bound_convergence, throughput_bench
from repro_torch.core import schedule, throughput as tp, traffic as T

N, D_HAT = 16, 4
RECFG = 0.5 / 4.5


def _caps(n, seed, density=0.6):
    rng = np.random.default_rng(seed)
    cap = rng.uniform(0.1, 2.0, size=(n, n)) * (rng.random((n, n)) < density)
    m = rng.uniform(0.0, 1.0, size=(n, n)) * (rng.random((n, n)) < 0.5)
    np.fill_diagonal(cap, 0.0)
    np.fill_diagonal(m, 0.0)
    return cap, m


@pytest.mark.parametrize("n,seed", [(2, 0), (5, 1), (8, 2), (12, 3)])
def test_closed_form_and_lp_equal_reference(n, seed):
    cap, m = _caps(n, seed)
    assert tp.throughput_single_hop(cap, m) == \
        ref_tp.throughput_single_hop(cap, m)
    assert tp.throughput_multi_hop(cap, m) == \
        ref_tp.throughput_multi_hop(cap, m)
    zero = np.zeros((n, n))
    for a, b in ((cap, zero), (zero, m)):
        assert tp.throughput_single_hop(a, b) == \
            ref_tp.throughput_single_hop(a, b)
        assert tp.throughput_multi_hop(a, b) == \
            ref_tp.throughput_multi_hop(a, b)


@pytest.mark.parametrize("kind", ["skewed", "random_hose", "ring"])
@pytest.mark.parametrize("multi_hop", [False, True])
def test_schedule_throughputs_equal_reference(kind, multi_hop):
    n = 8
    m = {"skewed": lambda: T.skewed(n, 0.6, seed=3),
         "random_hose": lambda: T.random_hose(n, seed=2),
         "ring": lambda: T.ring(n)}[kind]()
    s = schedule.vermilion_schedule(m, k=3, d_hat=2, recfg_frac=RECFG,
                                    device="cpu")
    rs = ref_schedule.vermilion_schedule(m, k=3, d_hat=2, recfg_frac=RECFG)
    demand = T.hose_normalize(m, d_hat=2.0)
    assert tp.schedule_throughput(s, demand, multi_hop=multi_hop) == \
        ref_tp.schedule_throughput(rs, demand, multi_hop=multi_hop)
    for k in (2, 3, 6):
        assert tp.vermilion_throughput(m, k=k, d_hat=2, recfg_frac=RECFG,
                                       seed=1) == \
            ref_tp.vermilion_throughput(m, k=k, d_hat=2, recfg_frac=RECFG,
                                        seed=1)
    assert tp.oblivious_throughput(m, d_hat=2, recfg_frac=RECFG,
                                   multi_hop=multi_hop) == \
        ref_tp.oblivious_throughput(m, d_hat=2, recfg_frac=RECFG,
                                    multi_hop=multi_hop)


@pytest.mark.parametrize("k,d_hat,n,recfg", [
    (2, 1, 8, 0.0), (3, 2, 16, 0.0), (3, 4, 12, RECFG), (3, 5, 7, 0.0),
    (6, 8, 256, 1 / 9), (3, 8, 256, 1 / 9)])
def test_bounds_equal_reference(k, d_hat, n, recfg):
    assert tp.theorem3_bound(k, recfg) == ref_tp.theorem3_bound(k, recfg)
    assert tp.quantized_theorem3_bound(k, d_hat, n, recfg) == \
        ref_tp.quantized_theorem3_bound(k, d_hat, n, recfg)


# -- the properties of tests/test_throughput.py, on the port ---------------

def test_single_hop_closed_form():
    cap = np.array([[0, 2.0], [1.0, 0]])
    m = np.array([[0, 1.0], [4.0, 0]])
    assert tp.throughput_single_hop(cap, m) == pytest.approx(0.25)


def test_multi_hop_two_paths():
    cap = np.zeros((3, 3))
    cap[0, 1] = cap[1, 2] = 1.0
    m = np.zeros((3, 3))
    m[0, 2] = 1.0
    assert tp.throughput_multi_hop(cap, m) == pytest.approx(1.0, abs=1e-6)


def test_multi_hop_geq_single_hop():
    m = T.skewed(8, 0.6, seed=3)
    s = schedule.vermilion_schedule(m, k=3, d_hat=2, device="cpu")
    cap = s.emulated_capacity()
    demand = T.hose_normalize(m, d_hat=2.0)
    assert (tp.throughput_multi_hop(cap, demand)
            >= tp.throughput_single_hop(cap, demand) - 1e-9)


@pytest.mark.parametrize("k", [2, 3, 6])
def test_theorem3_lower_bound(k):
    bound = tp.theorem3_bound(k)
    for seed in range(5):
        m = T.random_hose(N, seed=seed)
        th = tp.vermilion_throughput(m, k=k, d_hat=D_HAT, seed=seed)
        assert th >= bound - 1e-9, (k, seed, th)


def test_theorem3_with_reconfiguration():
    bound = tp.theorem3_bound(3, recfg_frac=1 / 9)
    m = T.random_hose(N, seed=7)
    th = tp.vermilion_throughput(m, k=3, d_hat=D_HAT, recfg_frac=1 / 9,
                                 seed=7)
    assert th >= bound - 1e-9


def test_oblivious_bounds_on_ring_and_uniform():
    assert tp.oblivious_throughput(T.ring(N), d_hat=D_HAT, multi_hop=True) \
        == pytest.approx(0.5, abs=0.02)
    assert tp.oblivious_throughput(T.ring(N), d_hat=D_HAT,
                                   multi_hop=False) < 0.1
    assert tp.oblivious_throughput(T.uniform(N), d_hat=D_HAT,
                                   multi_hop=True) > 0.9


def test_vermilion_beats_oblivious_on_skew_and_k_monotone():
    m = T.skewed(N, 0.9, seed=1)
    assert tp.vermilion_throughput(m, k=3, d_hat=D_HAT) > \
        tp.oblivious_throughput(m, d_hat=D_HAT, multi_hop=True)
    ths = [tp.vermilion_throughput(T.ring(12), k=k, d_hat=4)
           for k in (2, 3, 6)]
    assert ths[0] < ths[1] < ths[2]
    assert tp.vermilion_throughput(T.ring(8), k=8, d_hat=4) >= 7 / 8 - 1e-9


# -- Fig. 7 and Fig. 8 -----------------------------------------------------

def test_fig7_rows_equal_reference():
    from benchmarks import throughput_bench as ref_bench

    got = throughput_bench.run(n=16, d_hat=4, ks=(3, 6))
    want = ref_bench.run(n=16, d_hat=4, ks=(3, 6))
    assert [r["demand"] for r in got] == [r["demand"] for r in want]
    for a, b in zip(got, want):
        a, b = dict(a), dict(b)
        a.pop("us"), b.pop("us")
        assert a == b, a["demand"]
        for k in (3, 6):
            assert a[f"vermilion_k{k}"] >= a[f"bound_k{k}"] - 1e-9
    for name, m in throughput_bench.demand_suite(16).items():
        assert np.array_equal(m, ref_bench.demand_suite(16)[name]), name


@pytest.mark.parametrize("k,n", [(2, 16), (3, 16), (4, 16), (6, 16),
                                 (8, 16), (3, 8), (3, 24), (3, 32),
                                 (3, 48)])
def test_fig8_rows_one_seed_equal_reference(k, n):
    m = T.random_hose(n, seed=0)
    assert np.array_equal(m, ref_traffic.random_hose(n, seed=0))
    got = tp.vermilion_throughput(m, k=k, d_hat=4,
                                  recfg_frac=bound_convergence.RECFG, seed=0)
    want = ref_tp.vermilion_throughput(m, k=k, d_hat=4, recfg_frac=RECFG,
                                       seed=0)
    assert got == want
    assert got >= tp.theorem3_bound(k, RECFG) - 1e-9


def test_fig7_demand_workload_equals_reference():
    from benchmarks import throughput_bench as ref_bench

    m = throughput_bench.demand_suite(16)["skew-0.5"]
    got = throughput_bench.demand_workload(m, 4, 200)
    want = ref_bench._demand_workload(m, 4, 200)
    for f in ("src", "dst", "size", "arrival"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.n, got.horizon) == (want.n, want.horizon)


# -- BvN: Theorem 1 and the quantized strawman -----------------------------

def _bvn_inputs():
    """test_schedule.py's and test_throughput.py's inputs, three
    random_hose seeds, and the n = 16 Theorem-1 input of chip_smoke.py's
    BvN check (its 48-slot quantization meets a tie)."""
    return {
        "skewed-0.4-s1": T.skewed(6, 0.4, seed=1) + 1e-6,
        "skewed16-0.5-s4": T.skewed(16, 0.5, seed=4) + 1e-6,
        "skewed-0.5-s4": T.skewed(6, 0.5, seed=4) + 1e-6,
        "skewed-0.7-s2": T.skewed(6, 0.7, seed=2),
        **{f"random_hose-s{s}": T.random_hose(12, seed=s) for s in (0, 1, 2)},
    }


@pytest.mark.parametrize("name", list(_bvn_inputs()))
@pytest.mark.parametrize("presaturate", [False, True])
def test_bvn_decompose_matches_reference(name, presaturate):
    m = _bvn_inputs()[name]
    got_in = T.saturate(m, device="cpu") if presaturate else m
    want_in = ref_traffic.saturate(m) if presaturate else m
    lams, perms = schedule.bvn_decompose(got_in, device="cpu")
    rl, rp = ref_schedule.bvn_decompose(want_in)
    assert perms.dtype == rp.dtype and np.array_equal(perms, rp), name
    assert np.array_equal(lams, rl), name


@pytest.mark.parametrize("name", list(_bvn_inputs()))
@pytest.mark.parametrize("mult", [2, 3])
def test_bvn_schedule_matches_reference(name, mult):
    """Equal perms, ties included: skewed demands have equal lambdas in
    exact arithmetic, which the largest-remainder fill breaks by their
    last bits, and the CPU projection is numpy's own (bit-equal)."""
    m = _bvn_inputs()[name]
    n = m.shape[0]
    got = schedule.bvn_schedule(m, n_slots=mult * n, d_hat=2,
                                recfg_frac=RECFG, device="cpu")
    want = ref_schedule.bvn_schedule(m, n_slots=mult * n, d_hat=2,
                                     recfg_frac=RECFG)
    assert got.T == want.T == mult * n
    assert got.name == want.name == "bvn-quantized"
    assert (got.d_hat, got.recfg_frac) == (want.d_hat, want.recfg_frac)
    assert np.array_equal(got.perms, want.perms)
    rl, rp = ref_schedule.bvn_decompose(m)
    # given the same decomposition the quantization is the reference's
    q = schedule.quantize_bvn(rl, rp, mult * n, d_hat=2, recfg_frac=RECFG)
    rq = ref_schedule.quantize_bvn(rl, rp, mult * n, d_hat=2,
                                   recfg_frac=RECFG)
    assert np.array_equal(q.perms, rq.perms)


@pytest.mark.parametrize("n", [6, 16])
def test_bvn_ideal_full_throughput(n):
    """Theorem 1: zero-reconfig BvN serves saturated matrices fully."""
    m = T.saturate(T.skewed(n, 0.5, seed=4) + 1e-6, device="cpu")
    lams, perms = schedule.bvn_decompose(m, device="cpu")
    cap = np.zeros((n, n))
    for lam, p in zip(lams, perms):
        cap[np.arange(n), p] += lam
    assert tp.throughput_single_hop(cap, m) >= 1 - 1e-6
    rec = np.zeros((n, n))
    for lam, p in zip(lams, perms):
        rec[np.arange(n), p] += lam
    assert np.allclose(rec, m, atol=1e-6)


@pytest.mark.parametrize("seed", range(10))
def test_bvn_decompose_random_hose_terminates(seed):
    """Near-doubly-stochastic residuals end the decomposition gracefully,
    with nearly all of the saturated mass decomposed."""
    n = 12
    m = T.random_hose(n, seed=seed)
    lams, perms = schedule.bvn_decompose(m, device="cpu")
    assert len(lams) > 0 and 0.99 < lams.sum() <= 1.0 + 1e-9
    rec = np.zeros((n, n))
    for lam, p in zip(lams, perms):
        rec[np.arange(n), p] += lam
    assert np.abs(T.saturate(m, device="cpu") - rec).max() < 0.01


def test_fig7_and_fig8_mains_print_the_reference_rows(capsys):
    """The two scripts' CSV: the port's ``main`` on the CPU prints the
    reference script's derived columns."""
    from benchmarks import bound_convergence as ref_fig8
    from benchmarks import throughput_bench as ref_bench

    def derived(text):
        return [ln.rsplit(",", 1)[1] for ln in text.splitlines()
                if ln.startswith(("throughput_", "bound_"))]

    throughput_bench.main(["8", "--device", "cpu"])
    got = derived(capsys.readouterr().out)
    ref_bench.main(8)
    want = derived(capsys.readouterr().out)
    assert len(got) == 8 + 9 and got[:8] == want[:8]
    # the flow-level rows: utilization and completion to 3 digits, the
    # port's sweep against the reference's numpy engine
    assert got[8:] == want[8:]
    bound_convergence.main()
    got = derived(capsys.readouterr().out)
    ref_fig8.main()
    assert got == derived(capsys.readouterr().out) and len(got) == 10
