"""The port's AST lint: its hot-path invariants, checked mechanically.

The counterpart of :mod:`repro.analysis.lint`, with the same CLI, report
format, escape hatches and baseline fingerprint, over the port's files:
``src/repro_torch``, ``tests/test_torch_*.py``, ``examples/torch_*.py``
and ``chip_smoke.py`` (the reference's files stay with the reference's
lint).  Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint
    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch/core --no-baseline
    PYTHONPATH=src python -m repro_torch.analysis.lint --write-baseline

Rules
=====
* **R1 dense-alloc** (hot-path modules only, see ``HOT_PATH_MODULES``):
  a dense ``(..., n, n)`` allocation, an ``np`` / ``jnp`` / ``torch``
  ``zeros`` / ``ones`` / ``empty`` / ``full`` call or a tensor's
  ``new_zeros`` / ``new_ones`` / ``new_empty`` / ``new_full`` whose size
  has >= 3 dims of which >= 2 trace to fabric-size symbols (``n``,
  ``n_slots``, ``T``; a literal ``1`` is a unit axis and no dim), given as a tuple or list or, for torch, as
  separate arguments (``torch.zeros(B, n, n)``); a flat product
  allocation with >= 3 factors of which >= 2 are fabric-sized
  (``torch.zeros(B * n * n)``); or an ``einsum`` whose output subscript
  has >= 3 indices.  Escape hatch for deliberately dense code (the VOQ,
  the relay carries): ``# lint: allow-dense`` on the allocation line or
  the line above.
* **R2 compile hygiene**: ``torch.compile`` / ``torch.jit.script`` /
  ``torch.jit.trace`` called inside a loop or on a fresh ``lambda`` (a
  per-call closure recompiles every call), and, in a hot-path module,
  ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` inside the slot
  loop of one of the five slot kernels (``SLOT_KERNELS``): a read back to
  the host each slot stalls the card once a slot, the counterpart of
  branching on a traced value.  The reference's check for scans outside a
  jitted function has no counterpart: the port's slot loops are Python
  loops by design until a persistent slot kernel replaces them.  Escape
  hatch: ``# lint: allow-jit``.
* **R3 import guards** (test files only): a file under ``tests/`` that
  imports ``jax`` guards it with ``pytest.importorskip("jax")`` before the
  import (module level, or earlier in the same function); a
  ``tests/test_torch_*.py`` file guards ``torch`` the same way; and
  ``tests/test_torch_gpu.py`` imports no ``jax`` at all (the machine with
  the card has none).  Escape hatch: ``# lint: allow-guard``.
* **R4 dtype**: ``jnp.array`` / ``asarray`` / ``zeros`` / ``ones`` /
  ``full`` / ``empty`` without an explicit dtype (the port's tests call
  jnp), ``torch.tensor`` / ``as_tensor`` / ``zeros`` / ``ones`` /
  ``empty`` / ``full`` without ``dtype=``, and arithmetic directly on a
  ``.astype(np.uint16)`` expression (the quantizer's 16-bit counters wrap
  silently).  Escape hatch: ``# lint: allow-dtype``.

Baseline
========
``baseline.json`` (next to this module) freezes pre-existing violations
outside ``core/``: a violation matching an unconsumed baseline entry
(same file, rule, and source snippet) is suppressed; anything beyond the
frozen counts fails.  ``src/repro_torch/core/`` carries zero baseline
entries.  ``--write-baseline`` regenerates the file from the current
tree; ``--update-baseline`` is the shrink-only variant (prunes entries
whose file is gone, shrinks entries that stopped firing, never adds).
"""
from __future__ import annotations

import argparse
import ast
import glob
import json
import os
import re
import sys
from dataclasses import dataclass

__all__ = [
    "Violation",
    "lint_file",
    "lint_paths",
    "load_baseline",
    "apply_baseline",
    "update_baseline",
    "write_baseline",
    "main",
    "DEFAULT_BASELINE",
    "DEFAULT_PATHS",
    "HOT_PATH_MODULES",
    "SLOT_KERNELS",
]

# Fabric-size symbols: identifiers (bare or attribute tails like ``self.n``,
# ``wl.n``, ``sched.n_slots``) whose product spans the whole fabric.
FABRIC_NAMES = frozenset({"n", "n_slots", "T"})

# Modules under the ROADMAP's "no dense (n, n) intermediates" rule.  R1
# runs only here: the control and analysis modules (traffic, throughput,
# rounding, ...) legitimately hold O(n^2) matrices.
HOT_PATH_MODULES = (
    "repro_torch/core/simulator.py",
    "repro_torch/core/schedule.py",
    "repro_torch/core/estimation.py",
    "repro_torch/core/matching.py",
    "repro_torch/core/faults.py",
)

# The slot kernels of repro_torch.core.simulator: a Python loop over the
# slots each, whose body must not read the card back.
SLOT_KERNELS = frozenset({"singlehop", "agg", "twohop_dense", "twohop_fct",
                          "twohop_sparse"})

# The port's files (globs, from the repository root).
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                 "examples/torch_*.py", "chip_smoke.py")

_ALLOC_FNS = frozenset({"zeros", "ones", "empty", "full"})
_NEW_FNS = frozenset({"new_zeros", "new_ones", "new_empty", "new_full"})
_ARRAY_MODULES = frozenset({"np", "jnp", "numpy", "torch"})
_JNP_DTYPE_FNS = {  # fn -> positional index of the dtype argument
    "zeros": 1, "ones": 1, "empty": 1, "array": 1, "asarray": 1, "full": 2,
}
# torch's dtype is keyword-only, except ``as_tensor(data, dtype)``
_TORCH_DTYPE_FNS = {"tensor": None, "as_tensor": 1, "zeros": None,
                    "ones": None, "empty": None, "full": None}
_COMPILE_FNS = frozenset({"torch.compile", "torch.jit.script",
                          "torch.jit.trace"})
_HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow-([a-z-]+)")


@dataclass(frozen=True)
class Violation:
    path: str          # repo-relative posix path
    line: int
    rule: str          # "R1".."R4"
    tag: str           # escape-hatch tag ("dense", "jit", "guard", "dtype")
    msg: str
    snippet: str       # stripped source line (baseline fingerprint)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}[{self.tag}] "
                f"{self.msg}\n    {self.snippet}")


def _norm(path: str) -> str:
    rel = os.path.relpath(path)
    return rel.replace(os.sep, "/")


def _is_hot_path(path: str) -> bool:
    return any(path.endswith(m) for m in HOT_PATH_MODULES)


def _is_test_file(path: str) -> bool:
    parts = path.split("/")
    return "tests" in parts[:-1] and parts[-1].endswith(".py")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('torch.jit.script')."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _is_fabric(node: ast.AST) -> bool:
    """True if the expression references a fabric-size symbol."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in FABRIC_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in FABRIC_NAMES:
            return True
    return False


def _is_one(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == 1 \
        and not isinstance(node.value, bool)


def _mult_factors(node: ast.AST) -> list[ast.AST]:
    """Flatten a multiplication chain ``B * n * n`` into its factors."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        return _mult_factors(node.left) + _mult_factors(node.right)
    return [node]


class _Linter(ast.NodeVisitor):
    """Single-file rule visitor.  A first pass collects the module's
    importorskip guards; the visit pass reports."""

    def __init__(self, path: str, tree: ast.Module, lines: list[str]):
        self.path = path
        self.lines = lines
        self.hot = _is_hot_path(path)
        self.test = _is_test_file(path)
        self.torch_test = self.test and os.path.basename(path).startswith(
            "test_torch_")
        self.gpu_test = self.test and path.endswith("tests/test_torch_gpu.py")
        self.out: list[Violation] = []
        self.fn_stack: list[ast.AST] = []   # enclosing FunctionDefs
        self.loop_depth = 0
        self.slot_loop_depth = 0            # loops inside a slot kernel
        self.module_guards: dict[str, int] = {}
        for node in ast.walk(tree):
            mod = self._guard_of(node)
            if mod is not None and mod not in self.module_guards:
                self.module_guards[mod] = node.lineno

    @staticmethod
    def _guard_of(node: ast.AST) -> str | None:
        """The module a ``pytest.importorskip("...")`` call guards."""
        if isinstance(node, ast.Call) \
                and _dotted(node.func) == "pytest.importorskip" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value
        return None

    # -- reporting ----------------------------------------------------------

    def _allowed(self, line: int, tag: str) -> bool:
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _ALLOW_RE.search(self.lines[ln - 1])
                if m and m.group(1) == tag:
                    return True
        return False

    def _report(self, node: ast.AST, rule: str, tag: str, msg: str) -> None:
        line = getattr(node, "lineno", 1)
        if self._allowed(line, tag):
            return
        snippet = (self.lines[line - 1].strip()
                   if 1 <= line <= len(self.lines) else "")
        self.out.append(Violation(self.path, line, rule, tag, msg, snippet))

    # -- traversal state ----------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.fn_stack.append(node)
        outer = self.slot_loop_depth
        self.slot_loop_depth = 0     # a nested function starts afresh
        self.generic_visit(node)
        self.slot_loop_depth = outer
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _in_slot_kernel(self) -> bool:
        return (self.hot and len(self.fn_stack) == 1
                and getattr(self.fn_stack[0], "name", "") in SLOT_KERNELS)

    def _visit_loop(self, node: ast.AST) -> None:
        slot = self._in_slot_kernel()
        self.loop_depth += 1
        self.slot_loop_depth += slot
        self.generic_visit(node)
        self.slot_loop_depth -= slot
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    # -- rules --------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        self._r1_dense_alloc(node, name)
        self._r2_compile(node, name)
        self._r4_dtype(node, name)
        self.generic_visit(node)

    def _r1_dims(self, node: ast.Call, mod: str, fn: str) -> list | None:
        """The size arguments of an allocation call, as a list of dims
        (a tuple or list) or a one-element list (a flat size)."""
        if not node.args:
            return None
        first = node.args[0]
        if isinstance(first, (ast.Tuple, ast.List)):
            return list(first.elts)
        # torch (and a tensor's new_*) also take the size as separate
        # arguments; full / new_full's second argument is the fill value
        if (mod == "torch" and fn != "full") \
                or fn in ("new_zeros", "new_ones", "new_empty"):
            dims = [a for a in node.args if not isinstance(a, ast.Starred)]
            return dims or None
        return [first]

    def _r1_dense_alloc(self, node: ast.Call, name: str) -> None:
        if not self.hot:
            return
        parts = name.split(".")
        fn = parts[-1]
        if len(parts) == 2 and parts[0] in _ARRAY_MODULES \
                and fn == "einsum":
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                spec = node.args[0].value
                out = spec.split("->")[-1] if "->" in spec else ""
                if len(out.strip()) >= 3:
                    self._report(
                        node, "R1", "dense",
                        f"einsum producing a dense >=3-D output "
                        f"({spec!r}) on a hot-path module")
            return
        if fn in _NEW_FNS and isinstance(node.func, ast.Attribute):
            mod = ""
        elif len(parts) == 2 and parts[0] in _ARRAY_MODULES \
                and fn in _ALLOC_FNS:
            mod = parts[0]
        else:
            return
        dims = self._r1_dims(node, mod, fn)
        if dims is None:
            return
        shaped = len(dims) > 1 or isinstance(node.args[0],
                                             (ast.Tuple, ast.List))
        # a literal 1 is a unit axis, not a dimension: (1, n, n) is one
        # (n, n) matrix
        dims = [d for d in dims if not _is_one(d)]
        if shaped:
            fabric = sum(_is_fabric(d) for d in dims)
            if len(dims) >= 3 and fabric >= 2:
                self._report(
                    node, "R1", "dense",
                    f"dense {len(dims)}-D allocation with {fabric} "
                    "fabric-sized dims (keep hot-path structures sparse)")
            return
        factors = [f for f in _mult_factors(dims[0]) if not _is_one(f)]
        fabric = sum(_is_fabric(f) for f in factors)
        if len(factors) >= 3 and fabric >= 2:
            self._report(
                node, "R1", "dense",
                f"flat allocation of a {len(factors)}-factor product "
                f"with {fabric} fabric-sized factors")

    def _r2_compile(self, node: ast.Call, name: str) -> None:
        if name in _COMPILE_FNS:
            if self.loop_depth > 0:
                self._report(
                    node, "R2", "jit",
                    f"{name} inside a loop (compile once at module scope "
                    "or behind a cache)")
            if node.args and isinstance(node.args[0], ast.Lambda):
                self._report(
                    node, "R2", "jit",
                    f"{name} on a fresh lambda (a per-call closure "
                    "recompiles every call)")
        if self.slot_loop_depth > 0 and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_READS:
            self._report(
                node, "R2", "jit",
                f".{node.func.attr}() inside a slot kernel's slot loop "
                "(a read back to the host stalls the card once a slot)")

    def _r4_dtype(self, node: ast.Call, name: str) -> None:
        parts = name.split(".")
        if len(parts) != 2:
            return
        if parts[0] == "jnp" and parts[1] in _JNP_DTYPE_FNS:
            pos = _JNP_DTYPE_FNS[parts[1]]
            if not (len(node.args) > pos
                    or any(k.arg == "dtype" for k in node.keywords)):
                self._report(
                    node, "R4", "dtype",
                    f"jnp.{parts[1]} without an explicit dtype (float64 "
                    "vs float32 promotion is engine-dependent)")
        elif parts[0] == "torch" and parts[1] in _TORCH_DTYPE_FNS:
            pos = _TORCH_DTYPE_FNS[parts[1]]
            if not ((pos is not None and len(node.args) > pos)
                    or any(k.arg == "dtype" for k in node.keywords)):
                self._report(
                    node, "R4", "dtype",
                    f"torch.{parts[1]} without dtype= (the default type "
                    "is inferred or global, not stated)")

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult)):
            for side in (node.left, node.right):
                if self._is_uint16_cast(side):
                    self._report(
                        node, "R4", "dtype",
                        "arithmetic directly on a uint16 cast (the 16-bit "
                        "quantizer counters wrap silently — widen first)")
                    break
        self.generic_visit(node)

    @staticmethod
    def _is_uint16_cast(node: ast.AST) -> bool:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "astype" and node.args:
            a = node.args[0]
            return (_dotted(a).endswith("uint16")
                    or (isinstance(a, ast.Constant) and a.value == "uint16"))
        return False

    # -- R3: import guards in tests -----------------------------------------

    def _guarded(self, mod: str, lineno: int) -> bool:
        line = self.module_guards.get(mod)
        if line is not None and line < lineno:
            return True
        # local import: an importorskip earlier in the enclosing function
        for fn in self.fn_stack:
            for sub in ast.walk(fn):
                if self._guard_of(sub) == mod and sub.lineno < lineno:
                    return True
        return False

    def _r3_import(self, node: ast.Import | ast.ImportFrom) -> None:
        if not self.test:
            return
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            names = [node.module or ""] if not node.level else []
        roots = {m.split(".")[0] for m in names}
        if "jax" in roots:
            if self.gpu_test:
                self._report(
                    node, "R3", "guard",
                    "jax import in the card's test file (the machine with "
                    "the card has no jax)")
            elif not self._guarded("jax", node.lineno):
                self._report(
                    node, "R3", "guard",
                    'jax import without a preceding pytest.importorskip('
                    '"jax") (the nojax CI job depends on this guard)')
        if "torch" in roots and self.torch_test \
                and not self._guarded("torch", node.lineno):
            self._report(
                node, "R3", "guard",
                'torch import without a preceding pytest.importorskip('
                '"torch") (the port\'s tests skip without torch)')

    def visit_Import(self, node: ast.Import) -> None:
        self._r3_import(node)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self._r3_import(node)
        self.generic_visit(node)


def lint_file(path: str, source: str | None = None) -> list[Violation]:
    """Lint one file; returns its violations (no baseline applied)."""
    norm = _norm(path)
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation(norm, e.lineno or 1, "R0", "syntax",
                          f"syntax error: {e.msg}", "")]
    linter = _Linter(norm, tree, source.splitlines())
    linter.visit(tree)
    return sorted(linter.out, key=lambda v: (v.path, v.line))


def _expand(paths: list[str]) -> list[str]:
    """Paths with their globs expanded (a glob matching nothing drops)."""
    out: list[str] = []
    for p in paths:
        if glob.has_magic(p):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    return out


def _iter_py(paths: list[str]):
    for p in _expand(paths):
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: list[str]) -> list[Violation]:
    out: list[Violation] = []
    for p in _iter_py(paths):
        out.extend(lint_file(p))
    return out


# ---------------------------------------------------------------------------
# Baseline: freeze pre-existing violations outside core/
# ---------------------------------------------------------------------------

def _fingerprint(v: Violation) -> tuple[str, str, str]:
    return (v.path, v.rule, v.snippet)


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def apply_baseline(
    violations: list[Violation], baseline: dict
) -> tuple[list[Violation], int]:
    """Suppress violations matching unconsumed baseline entries.

    Returns ``(new_violations, suppressed_count)``.  Each baseline entry
    ``{file, rule, snippet, count}`` absorbs up to ``count`` matching
    violations; anything beyond is new and fails.
    """
    budget: dict[tuple[str, str, str], int] = {}
    for e in baseline.get("entries", []):
        key = (e["file"], e["rule"], e["snippet"])
        budget[key] = budget.get(key, 0) + int(e.get("count", 1))
    fresh, suppressed = [], 0
    for v in violations:
        key = _fingerprint(v)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            suppressed += 1
        else:
            fresh.append(v)
    return fresh, suppressed


def update_baseline(
    baseline: dict, violations: list[Violation], scanned: set[str]
) -> tuple[dict, int, int]:
    """Shrink-only refresh of an existing baseline.

    Entries whose file no longer exists are pruned outright; entries whose
    file was scanned this run shrink to the number of still-matching
    violations (an entry that stopped firing disappears); entries whose
    file exists but was *not* in the scanned set are kept untouched.  New
    violations are never added.  Returns ``(new_baseline, pruned,
    shrunk)``.
    """
    current: dict[tuple[str, str, str], int] = {}
    for v in violations:
        current[_fingerprint(v)] = current.get(_fingerprint(v), 0) + 1
    entries, pruned, shrunk = [], 0, 0
    for e in baseline.get("entries", []):
        if not os.path.exists(e["file"]):
            pruned += 1
            continue
        if e["file"] not in scanned:
            entries.append(dict(e))
            continue
        key = (e["file"], e["rule"], e["snippet"])
        old = int(e.get("count", 1))
        have = min(old, current.get(key, 0))
        current[key] = current.get(key, 0) - have
        if have < old:
            shrunk += 1
        if have > 0:
            entries.append({"file": e["file"], "rule": e["rule"],
                            "snippet": e["snippet"], "count": have})
    return {"version": baseline.get("version", 1),
            "entries": entries}, pruned, shrunk


def write_baseline(violations: list[Violation], path: str) -> dict:
    counts: dict[tuple[str, str, str], int] = {}
    for v in violations:
        counts[_fingerprint(v)] = counts.get(_fingerprint(v), 0) + 1
    entries = [
        {"file": f, "rule": r, "snippet": s, "count": c}
        for (f, r, s), c in sorted(counts.items())
    ]
    data = {"version": 1, "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return data


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's static lint (rules R1-R4).")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files, directories or globs to lint (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report everything, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from the current tree")
    ap.add_argument("--update-baseline", action="store_true",
                    help="shrink-only baseline refresh: prune entries whose "
                         "file is gone, shrink entries that stopped firing; "
                         "never adds entries")
    ap.add_argument("--forbid-baseline-under",
                    default="src/repro_torch/core",
                    help="error if the baseline itself holds entries under "
                         "this prefix (core stays burned down to zero); "
                         "pass '' to disable")
    args = ap.parse_args(argv)
    paths = args.paths or list(DEFAULT_PATHS)

    violations = lint_paths(paths)

    if args.write_baseline:
        data = write_baseline(violations, args.baseline)
        print(f"wrote {len(data['entries'])} baseline entries "
              f"({len(violations)} violations) to {args.baseline}")
        return 0

    if args.update_baseline:
        if not os.path.exists(args.baseline):
            print(f"no baseline at {args.baseline} — nothing to update "
                  "(use --write-baseline to create one)")
            return 1
        scanned = {_norm(p) for p in _iter_py(paths)}
        data, pruned, shrunk = update_baseline(
            load_baseline(args.baseline), violations, scanned)
        with open(args.baseline, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        print(f"updated {args.baseline}: {len(data['entries'])} entries "
              f"({pruned} pruned as stale files, {shrunk} shrunk)")
        return 0

    suppressed = 0
    if not args.no_baseline and os.path.exists(args.baseline):
        baseline = load_baseline(args.baseline)
        if args.forbid_baseline_under:
            bad = [e for e in baseline.get("entries", [])
                   if e["file"].startswith(args.forbid_baseline_under)]
            if bad:
                print(f"baseline holds {len(bad)} frozen entries under "
                      f"{args.forbid_baseline_under!r} — core must stay at "
                      "zero; fix or annotate them instead:")
                for e in bad:
                    print(f"  {e['file']}: {e['rule']} {e['snippet']}")
                return 2
        violations, suppressed = apply_baseline(violations, baseline)

    for v in violations:
        print(v)
    tail = f" ({suppressed} baseline-suppressed)" if suppressed else ""
    if violations:
        print(f"\n{len(violations)} new violation(s){tail}")
        return 1
    print(f"clean{tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
