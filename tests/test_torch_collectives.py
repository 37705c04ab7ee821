"""repro_torch interconnect pricing against the JAX package: the five
traffic builders exactly, ``InterconnectModel`` (effective bandwidth and
step time under all three systems) exactly on equal inputs, and for every
architecture of the reference's registry the port's ``param_count`` and
``interconnect_bench.step_matrix`` equal to the reference's, with the
analytic rows of ``interconnect_bench.run`` equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.core import collectives as ref_col
from repro_torch.benchmarks import interconnect_bench
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import collectives as col

SYSTEMS = ("vermilion", "oblivious", "oblivious-singlehop")


@pytest.mark.parametrize("n", [1, 2, 5, 8, 12])
def test_builders_equal_reference(n):
    for name in ("ring_allreduce_traffic", "all_to_all_traffic",
                 "pipeline_traffic"):
        got = getattr(col, name)(n, 3.5e6)
        want = getattr(ref_col, name)(n, 3.5e6)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for groups in (g for g in (1, 2, 4) if n % g == 0):
        assert np.array_equal(col.hierarchical_traffic(n, groups, 2e6, 5e5),
                              ref_col.hierarchical_traffic(n, groups, 2e6,
                                                           5e5))
    for kw in ({}, {"moe_alltoall_bytes": 1e6}, {"pp_bytes": 2e5},
               {"moe_alltoall_bytes": 1e6, "pp_bytes": 2e5,
                "compression": 0.25}):
        assert np.array_equal(col.training_step_traffic(n, 4e7, **kw),
                              ref_col.training_step_traffic(n, 4e7, **kw))


def _matrices():
    rng = np.random.default_rng(5)
    return {"step": col.training_step_traffic(8, 4e7,
                                              moe_alltoall_bytes=1e6),
            "ring": col.ring_allreduce_traffic(8, 1e7),
            "hier": col.hierarchical_traffic(8, 2, 3e6, 1e6),
            "random": rng.uniform(0, 1e6, size=(6, 6)) * (1 - np.eye(6)),
            "zero": np.zeros((4, 4))}


@pytest.mark.parametrize("name", list(_matrices()))
@pytest.mark.parametrize("ic", [(400.0, 8, 1 / 9, 3), (100.0, 2, 0.0, 2),
                                (200.0, 4, 0.2, 6)])
def test_interconnect_model_equals_reference(name, ic):
    m = _matrices()[name]
    got, want = col.InterconnectModel(*ic), ref_col.InterconnectModel(*ic)
    for system in SYSTEMS:
        assert got.effective_bandwidth(m, system) == \
            want.effective_bandwidth(m, system), system
        assert got.step_time(m, system) == want.step_time(m, system), system
    with pytest.raises(ValueError):
        got.effective_bandwidth(m + 1.0, "bogus")


@pytest.mark.parametrize("arch", sorted(REF_REGISTRY))
def test_param_count_and_step_matrix_equal_reference(arch):
    from benchmarks import interconnect_bench as ref_bench

    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    for c in (1.0, 0.25):
        got = interconnect_bench.step_matrix(cfg, compression=c)
        want = ref_bench.step_matrix(ref_cfg, compression=c)
        assert np.array_equal(got, want)


def test_port_registry_holds_the_reference_archs():
    assert set(REF_REGISTRY) <= set(REGISTRY)
    # the extra entries are the one-card served cuts of Jamba and Mixtral
    assert set(REGISTRY) - set(REF_REGISTRY) == {"jamba-1.5-large",
                                                 "mixtral-8x7b-ep2"}


def test_interconnect_rows_equal_reference():
    from benchmarks import interconnect_bench as ref_bench

    want = {r["arch"]: r for r in ref_bench.run()}
    got = {r["arch"]: r for r in interconnect_bench.run()}
    assert sorted(got) == sorted(REGISTRY)
    for arch, b in want.items():
        a = dict(got[arch])
        b = dict(b)
        a.pop("us"), b.pop("us")
        assert a == b, arch
        assert a["t_vermilion"] <= a["t_oblivious"]


def test_drain_workload_equals_reference():
    from benchmarks import interconnect_bench as ref_bench

    m = interconnect_bench.step_matrix(get_config("mixtral-8x7b"))
    got = interconnect_bench.drain_workload(m, 500)
    want = ref_bench._drain_workload(m, 500)
    for f in ("src", "dst", "size", "arrival"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.n, got.horizon) == (want.n, want.horizon)


def test_interconnect_main_prints_the_reference_rows(capsys):
    """The script's CSV: the port's ``main`` on the CPU (its drain through
    ``run_sweep(device="cpu")``) prints the reference's analytic columns;
    the drain lands within one slot of the reference's numpy engine."""
    from benchmarks import interconnect_bench as ref_bench

    def fields(text):
        return {ln.split(",")[0]: dict(kv.split("=") for kv in
                                       ln.split(",")[2].split(";"))
                for ln in text.splitlines()
                if ln.startswith("interconnect[")}

    interconnect_bench.main(["--device", "cpu"])
    got = fields(capsys.readouterr().out)
    ref_bench.main()
    want = fields(capsys.readouterr().out)
    assert len(got) == len(REGISTRY) and set(want) <= set(got)
    for arch, w in want.items():
        g = got[arch]
        for key in ("verm", "obl", "verm_int8", "speedup"):
            assert g[key] == w[key], (arch, key)
        gs, ws = (float(x["verm_simulated"].rstrip("ms"))
                  for x in (g, w))
        assert abs(gs - ws) <= interconnect_bench.SLOT_S * 1e3 + 0.01, arch
