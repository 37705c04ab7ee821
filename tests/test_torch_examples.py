"""The port's examples on the CPU: ``examples/torch_quickstart.py``
against the reference's ``examples/quickstart.py`` (every number of
sections 1-8 and section 9's certificate equal at the printed precision),
and ``examples/torch_serve_decode.py --smoke`` (five requests, 8 tokens
each, each equal to what a one-lane engine gives it alone)."""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file: its kernels run many small ops,
    which several threads each would only contend for the cores that
    pytest-xdist's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _sections(text: str) -> dict:
    """Section number -> the numbers printed on each of its lines."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"=== (\d+)\.", line)
        if m:
            cur = out.setdefault(int(m.group(1)), [])
        elif cur is not None and line.startswith("  "):
            cur.append(NUM.findall(line))
    return out


@pytest.fixture(scope="module")
def quickstarts():
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))     # the reference's benchmarks package
    try:
        ref = _load(ROOT / "examples" / "quickstart.py", "ref_quickstart")
        _, ref_text = _run(ref.main)
    finally:
        sys.path.remove(str(ROOT))
    port = _load(ROOT / "examples" / "torch_quickstart.py", "torch_quickstart")
    res, text = _run(port.main, ["--device", "cpu"])
    return _sections(ref_text), _sections(text), res


@pytest.mark.parametrize("section", [1, 2, 4, 5, 7, 8])
def test_quickstart_numbers_equal_the_reference(section, quickstarts):
    ref, port, _ = quickstarts
    assert len(ref[section]) >= 1
    assert port[section] == ref[section]


def test_quickstart_section3_equals_the_reference_device_engine(quickstarts):
    """Section 3: utilization and hops equal the reference's printed lines
    (its numpy rows and its ``backend="jax"`` rotorlb row).  The p99 of
    short flows is held to the reference's ``run_sweep(...,
    backend="jax")`` on the same cases, the engine the port's
    ``run_sweep(device=)`` ports: the reference quickstart prints its
    numpy engine's, whose FCTs differ from its own jax backend's here
    (vermilion 4.68 against 3 slots, rotorlb 11 against 9)."""
    from repro.core.schedule import oblivious_schedule, vermilion_schedule
    from repro.core.simulator import SweepCase, run_sweep, websearch_workload
    ref, port, _ = quickstarts
    (_, _, v_util), (_, _, r_util, r_hops) = ref[3][0], ref[3][1]
    assert ref[3][2] == [r_util, r_hops, "1e-3"]       # the jax row
    (_, v_p99, pv_util), (_, r_p99, pr_util, pr_hops) = port[3][0], port[3][1]
    assert (pv_util, pr_util, pr_hops) == (v_util, r_util, r_hops)
    bits = 100e9 * 4.5e-6
    wl = websearch_workload(16, 0.4, 2000, bits, d_hat=4, seed=0)
    sv = vermilion_schedule(wl.demand_matrix(), k=3, d_hat=4,
                            recfg_frac=1 / 9, normalize="saturate")
    so = oblivious_schedule(16, d_hat=4, recfg_frac=1 / 9)
    rv, ro = (row.result for row in run_sweep(
        [SweepCase(sv, wl, "single_hop", "vermilion"),
         SweepCase(so, wl, "rotorlb", "rotorlb")], bits, backend="jax"))
    assert v_p99 == f"{rv.fct_percentile(99, short_cutoff=8e5):.0f}"
    assert r_p99 == f"{ro.fct_percentile(99, short_cutoff=8e5):.0f}"


def test_quickstart_analysis_sections(quickstarts):
    """Section 6: the sanitized sweep's utilization equal and the port's
    lint of its core clean; section 9: the certificate equal, and the
    op-level reports' carry exponents the reference's jaxpr ones."""
    ref, port, res = quickstarts
    assert port[6][0] == ref[6][0]
    assert res["lint_rc"] == 0 and port[6][-1] == ref[6][-1] == ["0"]
    assert port[9][0] == ref[9][0] and res["certificate"].ok
    for i in (1, 2):           # twohop_dense, twohop_fct
        assert port[9][i][-2:] == ref[9][i][-2:]   # exponent, dtype leaks


def test_serve_decode_smoke_isolates_lanes():
    """``--smoke`` on the CPU: the reference's exact example (2 lanes of
    64, five requests, 8 new tokens each), each request's tokens those a
    one-lane engine gives it alone."""
    mod = _load(ROOT / "examples" / "torch_serve_decode.py",
                "torch_serve_decode")
    done, text = _run(mod.main, ["--smoke", "--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out_tokens) == 8 for r in done)
    assert len(text.splitlines()) == 5
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                         serve=True)
    for r in done:
        alone = ServeEngine(params, cfg, n_lanes=1, max_len=64,
                            device="cpu").run(
            [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                     max_new_tokens=8)])
        assert alone[0].out_tokens == r.out_tokens, r.rid


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []), ("torch_serve_decode", ["--smoke"])])
def test_examples_need_a_card_unless_cpu(name, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _load(ROOT / "examples" / f"{name}.py", name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
