"""Op-level analysis of the port's slot kernels: the counterpart of
:mod:`repro.analysis.ir`.

The source lint (:mod:`repro_torch.analysis.lint`) sees source; what a
slot kernel allocates, moves and carries from slot to slot only shows when
it runs.  This module drives the engine path of each of the five slot
kernels of :mod:`repro_torch.core.simulator` (:func:`slot_kernels`) once
on a small seeded batch (:func:`drive_slot_kernel`), and runs the kernel
on the arguments the engine built for it under a ``TorchDispatchMode``
that sees every aten op the kernel issues.  It reports per kernel:

* **flops / dot_flops**: elementwise ops count their output's elements,
  reductions their input's, scatters their updates', ``mm`` / ``bmm`` /
  ``addmm`` / ``baddbmm`` 2·M·N·K (``dot_flops`` is that subtotal);
* **bytes_moved**: the bytes of every op's tensor operands and results
  (a view op's count none: it moves nothing);
* **peak_bytes**: the peak of the live bytes of the storages allocated
  under the mode (a storage lives while a tensor the mode saw still
  refers to it; the kernel's own inputs are not counted);
* **carry scaling**: the bytes of the arguments the kernel carries from
  slot to slot (``KERNEL_CARRIES``), as the engine allocated them, at the
  reference fabric size and at doubled ``n``, and the fitted exponent
  ``log2(carry(2n) / carry(n))``: ~2 for the per-(at, dst) state, ~3 for ``twohop_fct``'s deliberate
  per-(at, src, dst) attribution tensor;
* **dtype leaks**: float64 results and uint16 arithmetic.

Ops the flop model does not know are listed (``unknown_prims``), never
dropped.

**Why a dispatch mode, not ``torch.export``.**  The kernels are Python
loops over 128 slots whose bounds are data on the host (arrival bounds,
rounds, plan rows); an exported graph would unroll them with the data
baked in.  The dispatch mode sees exactly the ops that run, and the same
ops run on the CPU and on the card, so the report does not depend on the
device.

Budgets live in ``ir_budget.json`` next to this module, frozen from the
port's own run at the reference dims, with the reference's slack (the
reference's budget is the JAX kernels' and does not apply here).
``--write-budget`` regenerates it.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.ir [--device cpu]
    PYTHONPATH=src python -m repro_torch.analysis.ir --device cpu --write-budget
    PYTHONPATH=src python -m repro_torch.analysis.ir --json out.json

Violations print as ``kernel: RULE[tag] msg`` and exit 1; a missing
budget file exits 2.  Without ``--device cpu`` it runs on the card, and
raises without one.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.simulator import KERNEL_CARRIES, drive_slot_kernel, slot_kernels
from ..device import resolve_device

__all__ = [
    "KernelReport",
    "analyze_kernel",
    "analyze_all",
    "check_budget",
    "write_budget",
    "load_budget",
    "main",
    "DEFAULT_BUDGET",
]

DEFAULT_BUDGET = os.path.join(os.path.dirname(__file__), "ir_budget.json")

# The reference's bucket (B = 2 cases, n = 8 nodes, 128 slots; agg at the
# one case its engine path serves) and the doubled-n probe of the carry
# exponent.
_REF_DIMS = {"B": 2, "n": 8}
_REF_N2 = 16

# -- flop model (aten op names, in-place and out= variants alike) ----------
# One flop per output element:
_EW = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "pow", "neg", "abs",
    "sign", "floor", "ceil", "round", "trunc", "exp", "log", "log1p",
    "expm1", "sqrt", "rsqrt", "reciprocal", "tanh", "sigmoid", "maximum",
    "minimum", "clamp", "clamp_min", "clamp_max", "where", "masked_fill",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "lt", "le",
    "gt", "ge", "eq", "ne", "isfinite", "isnan", "nan_to_num",
})
# One flop per input element:
_REDUCE = frozenset({
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "any", "all", "cumsum", "cumprod", "cummax", "cummin", "sort",
    "logsumexp",
})
# Data movement and allocation: bytes, no flops.
_MOVE = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "select", "slice",
    "narrow", "index", "index_select", "gather", "take", "copy", "_to_copy",
    "clone", "contiguous", "cat", "stack", "diagonal", "transpose", "t",
    "permute", "unsqueeze", "squeeze", "expand", "alias", "detach",
    "lift_fresh", "as_strided", "split", "split_with_sizes", "unbind",
    "eye", "zero", "fill", "zeros", "ones", "empty", "full", "empty_like",
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_empty", "new_full", "new_empty_strided", "empty_strided",
    "scalar_tensor", "arange", "flip", "repeat", "view_as",
})
# One flop per update element (the last tensor operand):
_SCATTER = frozenset({
    "index_add", "index_put", "scatter", "scatter_add", "scatter_reduce",
    "index_copy", "index_fill", "masked_scatter",
})
# 2·M·N·K: the output's elements times twice the contracted width of the
# operand at this position.
_DOT = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1}
_UINT16_ARITH = frozenset({"add", "sub", "mul", "pow"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclass
class _Cost:
    flops: int = 0
    dot_flops: int = 0
    bytes_moved: int = 0
    peak_bytes: int = 0
    leaks: list[str] = field(default_factory=list)
    unknown: set[str] = field(default_factory=set)


class _Counter(TorchDispatchMode):
    """Counts every aten op issued under it into a :class:`_Cost` and
    tracks the live bytes of the storages its ops allocate."""

    def __init__(self, external: list):
        super().__init__()
        self.cost = _Cost()
        # storages that existed before (the kernel's inputs, wrapped
        # scalars), held so that their addresses cannot be reused
        self._external = {_storage_key(t): t.untyped_storage()
                          for t in external}
        self._live: dict[int, list] = {}    # key -> [bytes, tensors]
        self._live_bytes = 0

    def _drop(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._external:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self._live_bytes += entry[0]
            self.cost.peak_bytes = max(self.cost.peak_bytes,
                                       self._live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:
            key = _storage_key(t)
            if key not in self._live and key not in self._external:
                self._external[key] = t.untyped_storage()
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, ins, outs)
        for t in outs:
            self._track(t)
        return out

    def _count(self, func, ins: list, outs: list) -> None:
        c = self.cost
        name = func.overloadpacket.__name__.rstrip("_")
        if not func.is_view:     # a view moves nothing
            c.bytes_moved += sum(_nbytes(t) for t in ins + outs)
        out_n = sum(t.numel() for t in outs)
        if name in _EW:
            c.flops += out_n
        elif name in _REDUCE:
            c.flops += max((t.numel() for t in ins), default=0)
        elif name in _SCATTER:
            c.flops += ins[-1].numel() if ins else 0
        elif name in _DOT:
            f = 2 * out_n * ins[_DOT[name]].shape[-1]
            c.flops += f
            c.dot_flops += f
        elif name not in _MOVE:
            c.unknown.add(name)
        for t in outs:
            if t.dtype == torch.float64:
                c.leaks.append(f"float64:{name}")
            if name in _UINT16_ARITH and t.dtype == torch.uint16:
                c.leaks.append(f"uint16-arith:{name}")


@dataclass
class KernelReport:
    kernel: str
    dims: dict
    flops: int
    dot_flops: int
    bytes_moved: int
    peak_bytes: int
    carry_bytes: int
    carry_shapes: list[str]
    carry_exponent: float
    dtype_leaks: list[str]
    unknown_prims: list[str]

    def to_dict(self) -> dict:
        return {
            "kernel": self.kernel, "dims": dict(self.dims),
            "flops": self.flops, "dot_flops": self.dot_flops,
            "bytes_moved": self.bytes_moved, "peak_bytes": self.peak_bytes,
            "carry_bytes": self.carry_bytes,
            "carry_shapes": list(self.carry_shapes),
            "carry_exponent": self.carry_exponent,
            "dtype_leaks": list(self.dtype_leaks),
            "unknown_prims": sorted(self.unknown_prims),
        }


def _run_cost(kernel: str, dims: dict, device, fn=None) -> tuple:
    """One counted run of the kernel on the engine's own arguments
    (:func:`drive_slot_kernel`; ``fn``, if given, in place of the
    kernel): (cost, carry bytes, carry shapes)."""
    seen: list = []

    def hook(name, kernel_fn, kw):
        carries = [kw[k] for k in KERNEL_CARRIES[name]]
        counter = _Counter(_tensors(kw))
        with torch.no_grad(), counter:
            out = (fn or kernel_fn)(**kw)
        seen.append((counter.cost, sum(_nbytes(t) for t in carries),
                     [f"{tuple(t.shape)}:"
                      f"{str(t.dtype).removeprefix('torch.')}"
                      for t in carries]))
        return out

    drive_slot_kernel(kernel, hook, device=device, **dims)
    if len(seen) != 1:
        raise RuntimeError(f"{kernel}'s engine path launched it "
                           f"{len(seen)} times (expected once)")
    return seen[0]


def _dims(kernel: str) -> dict:
    """The reference bucket, at the one case that ``agg``'s engine path
    (``simulate_aggregate``) serves."""
    return dict(_REF_DIMS, B=1) if kernel == "agg" else dict(_REF_DIMS)


def analyze_kernel(kernel: str, fn=None, device=None,
                   **dims) -> KernelReport:
    """Run one slot kernel on its engine path at the reference bucket
    (override by ``dims``, the keywords ``B`` and ``n`` of
    :func:`drive_slot_kernel`) on ``device`` (``None``: the card), and fit
    its carry exponent against a run at doubled ``n``.  ``fn``, if given,
    runs in place of the kernel on the engine's arguments."""
    dev = resolve_device(device)
    use = _dims(kernel)
    use.update(dims)
    cost, carry, shapes = _run_cost(kernel, use, dev, fn)
    _, carry2, _ = _run_cost(kernel, dict(use, n=2 * use["n"]), dev, fn)
    exponent = math.log2(carry2 / carry) if carry > 0 and carry2 > 0 else 0.0
    return KernelReport(
        kernel=kernel, dims=use,
        flops=cost.flops, dot_flops=cost.dot_flops,
        bytes_moved=cost.bytes_moved, peak_bytes=cost.peak_bytes,
        carry_bytes=carry, carry_shapes=shapes,
        carry_exponent=round(exponent, 4),
        dtype_leaks=cost.leaks, unknown_prims=sorted(cost.unknown))


def analyze_all(kernels: list[str] | None = None,
                device=None) -> list[KernelReport]:
    names = kernels if kernels is not None else sorted(slot_kernels())
    return [analyze_kernel(k, device=device) for k in names]


# -- budget gate ------------------------------------------------------------

def load_budget(path: str = DEFAULT_BUDGET) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_budget(reports: list[KernelReport],
                 path: str = DEFAULT_BUDGET, slack: float = 0.01) -> dict:
    """Freeze the current measurements: the carry-exponent ceiling gets
    +0.15 over the fitted value, everything else the shared relative
    ``slack``."""
    data = {
        "version": 1,
        "reference": {**_REF_DIMS, "n2": _REF_N2},
        "slack": slack,
        "kernels": {
            r.kernel: {
                "flops": r.flops,
                "dot_flops": r.dot_flops,
                "bytes_moved": r.bytes_moved,
                "peak_bytes": r.peak_bytes,
                "carry_bytes": r.carry_bytes,
                "carry_exponent_max": round(r.carry_exponent + 0.15, 2),
                "dtype_leaks": len(r.dtype_leaks),
            } for r in reports
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return data


def check_budget(reports: list[KernelReport], budget: dict) -> list[str]:
    """Lint-style violation lines; empty means every kernel is within
    budget.  IR1 = footprint or op-count regression, IR2 = carry scaling,
    IR3 = dtype leaks, IR0 = a kernel the budget has never seen."""
    slack = float(budget.get("slack", 0.0))
    out: list[str] = []
    for r in reports:
        b = budget.get("kernels", {}).get(r.kernel)
        if b is None:
            out.append(f"{r.kernel}: IR0[budget] kernel has no entry in "
                       "ir_budget.json (run --write-budget to freeze it)")
            continue
        for metric in ("flops", "bytes_moved", "peak_bytes", "carry_bytes"):
            got, ref = getattr(r, metric), int(b[metric])
            if got > ref * (1.0 + slack):
                out.append(
                    f"{r.kernel}: IR1[{metric}] {got} exceeds budget "
                    f"{ref} (+{slack:.0%} slack): kernel footprint "
                    "regressed; fix it or refreeze with --write-budget")
        if r.carry_exponent > float(b["carry_exponent_max"]):
            out.append(
                f"{r.kernel}: IR2[carry] slot-carry n-exponent "
                f"{r.carry_exponent:.2f} exceeds the budget ceiling "
                f"{b['carry_exponent_max']}: the carry grew a fabric "
                "dimension (the op-level dense-alloc rule)")
        if len(r.dtype_leaks) > int(b["dtype_leaks"]):
            out.append(
                f"{r.kernel}: IR3[dtype] {len(r.dtype_leaks)} dtype leaks "
                f"(budget {b['dtype_leaks']}): "
                + ", ".join(sorted(set(r.dtype_leaks))))
    return out


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{b}B"
        b /= 1024
    return f"{b}B"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.ir",
        description="Op-level analysis of the port's slot kernels.")
    ap.add_argument("--kernel", action="append", default=None,
                    help="restrict to this kernel (repeatable)")
    ap.add_argument("--budget", default=DEFAULT_BUDGET,
                    help="budget file (default: the checked-in one)")
    ap.add_argument("--write-budget", action="store_true",
                    help="refreeze the budget from current measurements")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the full report (+violations) as JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    reports = analyze_all(args.kernel, device=args.device)
    for r in reports:
        print(f"{r.kernel}: flops={r.flops} dot={r.dot_flops} "
              f"moved={_fmt_bytes(r.bytes_moved)} "
              f"peak={_fmt_bytes(r.peak_bytes)} "
              f"carry={_fmt_bytes(r.carry_bytes)} "
              f"(~n^{r.carry_exponent:.2f}) "
              f"leaks={len(r.dtype_leaks)}")
        for s in r.carry_shapes:
            print(f"    carry {s}")
        if r.unknown_prims:
            print(f"    unmodeled ops: {', '.join(r.unknown_prims)}")

    if args.write_budget:
        data = write_budget(reports, args.budget)
        print(f"wrote budgets for {len(data['kernels'])} kernels "
              f"to {args.budget}")
        return 0

    if not os.path.exists(args.budget):
        print(f"\nno budget at {args.budget}: run --write-budget first")
        return 2
    violations = check_budget(reports, load_budget(args.budget))

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"reports": [r.to_dict() for r in reports],
                       "violations": violations}, f, indent=1)
            f.write("\n")

    for v in violations:
        print(v)
    if violations:
        print(f"\n{len(violations)} IR budget violation(s)")
        return 1
    print(f"\nall {len(reports)} kernels within ir_budget.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
