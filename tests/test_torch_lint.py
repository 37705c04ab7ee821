"""repro_torch.analysis.lint: rules R1-R4 in torch terms, the baseline
freeze and its exit codes, and the checked-in tree against the port's
baseline (the cases of tests/test_analysis.py, restated for the port's
allocators, compile calls and import guards)."""
import json
import os
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis.lint import (
    DEFAULT_BASELINE,
    apply_baseline,
    lint_file,
    load_baseline,
    main as lint_main,
    update_baseline,
    write_baseline,
)

ROOT = Path(__file__).resolve().parents[1]
HOT = "src/repro_torch/core/simulator.py"        # hot-path module (R1)
COLD = "src/repro_torch/benchmarks/fct_bench.py"  # not hot: R1 silent
TESTF = "tests/test_something.py"                 # a test module (R3)
TORCH_TESTF = "tests/test_torch_something.py"     # a port test module
GPU_TESTF = "tests/test_torch_gpu.py"             # the card's tests
F32 = "dtype=torch.float32"


def rules(path, source):
    return sorted({v.rule for v in lint_file(path, source=source)})


# ---------------------------------------------------------------------------
# R1: dense (n, n)-per-slot allocations on hot-path modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    "a = np.zeros((n_slots, n, n))",
    "v = np.zeros(B * n * n)",
    f"a = torch.zeros(B, n, n, {F32})",
    f"a = torch.zeros((B, n, n), {F32})",
    f"a = torch.empty([H, B, n, n], {F32})",
    f"v = torch.zeros(B * n * n, {F32})",
    f"a = torch.full((B, n, n), 0.0, {F32})",
    "a = x.new_zeros(B, n, n)",
    "a = x.new_empty((B, wl.n, wl.n))",
    "a = x.new_full((B, n, n), 1.0)",
    'm = torch.einsum("buv,bud->bvd", a, b)',
    'm = jnp.einsum("buv,bud->bvd", a, b)',
    f"a = torch.zeros((1, B, n, n), {F32})",     # a unit axis beside 3
])
def test_r1_dense_alloc_flagged_on_hot_path_only(line):
    src = f"import numpy as np\nimport torch\n{line}\n"
    assert "R1" in rules(HOT, src)
    assert "R1" not in rules(COLD, src)


@pytest.mark.parametrize("line", [
    f"a = torch.zeros(B, n, n, {F32})  # lint: allow-dense",
    f"# lint: allow-dense\na = torch.zeros(B, n, n, {F32})",
    f"a = torch.zeros(n, n, {F32})",             # 2-D: fine
    f"b = torch.zeros(4, 8, 8, {F32})",          # no fabric dims
    f"c = torch.zeros(n, {F32})",
    f"d = torch.full((n, n), 1.0, {F32})",
    f"e = torch.zeros(*shape, {F32})",
    "f = x.new_zeros(B * n)",
    'g = torch.einsum("bud,bd->bu", a, b)',
    "h = np.zeros((1, n, n))",                   # a unit axis: one (n, n)
    f"i = torch.zeros(1, n, n, {F32})",
    "j = np.zeros(1 * n * n)",
])
def test_r1_escape_hatch_and_small_allocs_pass(line):
    src = f"import numpy as np\nimport torch\n{line}\n"
    assert "R1" not in rules(HOT, src)


# ---------------------------------------------------------------------------
# R2: compile hygiene, host reads in a slot kernel's loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,flagged", [
    ("for k in ks:\n    fn = torch.compile(make(k))\n", True),
    ("while more():\n    fn = torch.jit.script(make())\n", True),
    ("fn = torch.compile(lambda x: x + 1)\n", True),
    ("fn = torch.jit.trace(lambda x: x, (y,))\n", True),
    ("fn = torch.compile(step)\n", False),
    ("for k in ks:\n    fn = torch.compile(f)  # lint: allow-jit\n", False),
])
def test_r2_compile_in_loop_or_on_lambda(src, flagged):
    assert ("R2" in rules(COLD, "import torch\n" + src)) is flagged


@pytest.mark.parametrize("read", ["item", "tolist", "cpu", "numpy"])
def test_r2_host_read_in_a_slot_loop_flagged(read):
    body = ("def twohop_dense(voq, caps, cap_idx):\n"
            "    n = int(voq.shape[1])\n"
            "    for h in range(cap_idx.shape[0]):\n"
            f"        x = voq.sum().{read}()\n")
    assert "R2" in rules(HOT, body)
    # outside a hot-path module, outside a slot kernel, outside its loop,
    # in a nested function, or with the hatch: silent
    assert "R2" not in rules(COLD, body)
    assert "R2" not in rules(HOT, body.replace("twohop_dense", "helper"))
    assert "R2" not in rules(HOT, "def agg(voq):\n"
                                  f"    x = voq.sum().{read}()\n")
    assert "R2" not in rules(HOT, "def agg(voq, hs):\n"
                                  "    def f():\n"
                                  "        for h in hs:\n"
                                  f"            x = voq.{read}()\n")
    assert "R2" not in rules(HOT, body.rstrip("\n")
                             + "  # lint: allow-jit\n")


# ---------------------------------------------------------------------------
# R3: jax and torch imports in tests need pytest.importorskip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,src,flagged", [
    (TESTF, "import jax\n", True),
    (HOT, "import jax\n", False),                 # src modules are exempt
    (TESTF, 'import pytest\npytest.importorskip("jax")\n'
            'import jax\nimport jax.numpy as jnp\n', False),
    (TESTF, 'import pytest\ndef test_x():\n'
            '    pytest.importorskip("jax")\n    import jax\n', False),
    (TESTF, 'import pytest\ndef test_x():\n    import jax\n'
            '    pytest.importorskip("jax")\n', True),
    (TORCH_TESTF, "import torch\n", True),
    (TORCH_TESTF, "from torch import nn\n", True),
    (TORCH_TESTF, 'import pytest\ntorch = pytest.importorskip("torch")\n'
                  'import torch.nn.functional as F\n', False),
    (TESTF, "import torch\n", False),             # not a port test
    (TORCH_TESTF, "import torch  # lint: allow-guard\n", False),
    (GPU_TESTF, 'import pytest\npytest.importorskip("torch")\n'
                'pytest.importorskip("jax")\nimport jax\n', True),
    (GPU_TESTF, 'import pytest\npytest.importorskip("torch")\n'
                'import torch\n', False),
])
def test_r3_import_guards(path, src, flagged):
    assert ("R3" in rules(path, src)) is flagged


# ---------------------------------------------------------------------------
# R4: dtype discipline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line,flagged", [
    ("a = jnp.zeros((2, 2))", True),
    ("a = jnp.zeros((2, 2), jnp.float32)", False),
    ("a = jnp.asarray(x)", True),
    ("a = jnp.asarray(x, dtype=x.dtype)", False),
    ("y = x.astype(np.uint16) + 1", True),
    ("a = torch.tensor([1.0])", True),
    ("a = torch.tensor([1.0], dtype=torch.float32)", False),
    ("a = torch.as_tensor(x, device=dev)", True),
    ("a = torch.as_tensor(x, torch.float32)", False),
    ("a = torch.zeros(3)", True),
    ("a = torch.full((2,), 1.0)", True),
    ("a = torch.empty(3, dtype=torch.int64)", False),
    ("a = torch.ones(3)  # lint: allow-dtype", False),
])
def test_r4_dtype(line, flagged):
    src = f"import numpy as np\nimport torch\n{line}\n"
    assert ("R4" in rules(COLD, src)) is flagged


# ---------------------------------------------------------------------------
# Baseline freeze and exit codes
# ---------------------------------------------------------------------------

def _mk_violations():
    return lint_file(COLD, source="import torch\n"
                                  "a = torch.zeros((2, 2))\n"
                                  "b = torch.ones((3,))\n")


def test_baseline_roundtrip_and_budget(tmp_path):
    vs = _mk_violations()
    assert len(vs) == 2
    bl_path = str(tmp_path / "baseline.json")
    write_baseline(vs, bl_path)
    bl = load_baseline(bl_path)

    fresh, suppressed = apply_baseline(vs, bl)
    assert fresh == [] and suppressed == 2

    # a *new* violation (not in the baseline) stays visible
    vs2 = vs + lint_file(COLD, source="import torch\n"
                                      "c = torch.full((4,), 0.0)\n")
    fresh, suppressed = apply_baseline(vs2, bl)
    assert suppressed == 2 and len(fresh) == 1 and "full" in fresh[0].snippet

    # a budget of count=1 absorbs exactly one duplicate
    fresh, suppressed = apply_baseline(vs[:1] * 3, bl)
    assert suppressed == 1 and len(fresh) == 2


def test_lint_main_exit_codes(tmp_path):
    clean = tmp_path / "ok.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "bad.py"
    dirty.write_text("import torch\na = torch.zeros((2, 2))\n")

    assert lint_main([str(clean), "--no-baseline"]) == 0
    assert lint_main([str(dirty), "--no-baseline"]) == 1

    # a baseline that freezes core/ violations is itself an error (exit 2)
    bad_bl = tmp_path / "bl.json"
    bad_bl.write_text(json.dumps({"version": 1, "entries": [
        {"file": "src/repro_torch/core/simulator.py", "rule": "R1",
         "snippet": "x", "count": 1}]}))
    assert lint_main([str(clean), "--baseline", str(bad_bl)]) == 2


def test_update_baseline_prunes_and_shrinks(tmp_path):
    tracked = tmp_path / "tracked.py"
    tracked.write_text("import torch\n"
                       "a = torch.zeros((2, 2))\n"
                       "b = torch.ones((3,))\n")
    bl_path = tmp_path / "baseline.json"
    assert lint_main([str(tracked), "--baseline", str(bl_path),
                      "--write-baseline"]) == 0

    bl = load_baseline(str(bl_path))
    assert len(bl["entries"]) == 2
    # a stale entry (file deleted since the freeze) and one for a file
    # outside the scan, which must survive untouched
    bl["entries"].append({"file": str(tmp_path / "gone.py"), "rule": "R4",
                          "snippet": "x = torch.zeros((1,))", "count": 1})
    outside = {"file": str(tmp_path / "sub" / "kept.py"), "rule": "R4",
               "snippet": "y = torch.ones((1,))", "count": 2}
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "kept.py").write_text("pass\n")
    bl["entries"].append(dict(outside))
    bl_path.write_text(json.dumps(bl))

    # fix one of the two real violations
    tracked.write_text("import torch\n"
                       "a = torch.zeros((2, 2))\n"
                       "b = torch.ones((3,), dtype=torch.float32)\n")
    assert lint_main([str(tracked), "--baseline", str(bl_path),
                      "--update-baseline"]) == 0

    nb = load_baseline(str(bl_path))
    files = [e["file"] for e in nb["entries"]]
    assert not any(f.endswith("gone.py") for f in files)     # pruned
    assert [e for e in nb["entries"]
            if e["file"] == outside["file"]] == [outside]    # kept verbatim
    snippets = [e["snippet"] for e in nb["entries"]
                if e["file"].endswith("tracked.py")]
    assert len(snippets) == 1 and "zeros" in snippets[0]     # shrunk

    # updating a nonexistent baseline is an error, never a silent create
    assert lint_main([str(tracked), "--baseline",
                      str(tmp_path / "none.json"), "--update-baseline"]) == 1


def test_update_baseline_never_adds():
    vs = _mk_violations()
    nb, pruned, shrunk = update_baseline(
        {"version": 1, "entries": []}, vs, {v.path for v in vs})
    assert nb["entries"] == [] and pruned == 0 and shrunk == 0


# ---------------------------------------------------------------------------
# The checked-in tree
# ---------------------------------------------------------------------------

def test_checked_in_tree_lints_clean(monkeypatch, capsys):
    """``python -m repro_torch.analysis.lint`` from the repository root:
    the port's files against its baseline, and the port's core with no
    baseline at all."""
    monkeypatch.chdir(ROOT)
    assert lint_main([]) == 0, capsys.readouterr().out
    assert lint_main(["src/repro_torch/core", "--no-baseline"]) == 0, \
        capsys.readouterr().out


def test_checked_in_baseline_has_no_core_entries():
    bl = load_baseline(DEFAULT_BASELINE)
    core = [e for e in bl["entries"]
            if e["file"].startswith("src/repro_torch/core")]
    assert core == [], core
    assert all(os.path.exists(ROOT / e["file"]) for e in bl["entries"])


def test_reference_lint_finds_no_implicit_dtype_in_port_tests():
    """The reference's own lint over the port's test files: no R4 finding
    (the jnp calls there state their dtypes)."""
    from repro.analysis.lint import lint_paths
    found = [str(v) for v in lint_paths(
        sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py")))
        if v.rule == "R4"]
    assert found == [], found
