"""What the port's kernel A/B scripts share: building several sources of a
kernel at once with the port's ``nvcc`` flags, reading each build's
``ptxas`` report, text variants of a source, and a profiler split of a
call's device time by kernel.  Needs ``nvcc`` (and, for
:func:`kernel_split`, the card); imported by ``torch_flash_bwd_ab.py`` and
``torch_recurrent_bwd_ab.py``.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def log(msg: str = "") -> None:
    print(msg, flush=True)


def _kernel_name(mangled: str) -> str:
    """``name<template ints and bools[, bf16]>`` of an Itanium-mangled
    kernel name (a namespace's prefixes dropped); an unmangled name as it
    is."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    # a kernel returns void: its template arguments end at "Ev"
    tmpl = mangled[i:mangled.find("Ev", i) + 1] \
        if mangled.startswith("I", i) else ""
    args = [v if k == "i" else ("false", "true")[int(v)]
            for k, v in re.findall(r"L([ib])(\d+)E", tmpl)]
    if "bfloat16" in tmpl:
        args.append("bf16")
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_lines(report: str) -> list:
    """One line a kernel (its name, registers, spills, shared memory), and
    every error and warning."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        if "error" in line.lower() or "warning" in line.lower():
            out.append(line.strip())
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
        elif name and "spill" in line:
            spill = line.strip().split(",", 1)[1].strip() if "," in line \
                else line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build(sources: dict, out: Path, includes=lambda name: []) -> tuple:
    """Every source (name -> text) written to ``out`` and built at once,
    against ``includes(name)`` and then the port's ``csrc``; returns the
    loaded libraries by name (a failed build is left out) and each build's
    :func:`ptxas_lines`."""
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        inc = [x for d in includes(name) for x in ("-I", str(d))]
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *inc,
             "-I", str(_build.CSRC), "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, reports = {}, {}
    for name, p in procs.items():
        report, _ = p.communicate()
        log(f"== nvcc {name}: rc {p.returncode}")
        keep = ptxas_lines(report)
        if p.returncode != 0:
            keep = report.splitlines()[-40:]
        for line in keep:
            log(f"  {line}")
        reports[name] = keep
        if p.returncode == 0:
            libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    log(f"build wall {time.perf_counter() - t0:.1f} s")
    return libs, reports


def substituted(text: str, subs: list, name: str) -> str | None:
    """``text`` with each (anchor, replacement) of ``subs`` applied to every
    occurrence; None, and a line saying so, if an anchor is missing."""
    for a, b in subs:
        if a not in text:
            log(f"variant {name}: anchor not in the source, skipped: "
                f"{a[:60]!r}")
            return None
        text = text.replace(a, b)
    return text


def kernel_split(call, args, pattern: str) -> dict:
    """Device ms a launch of each kernel whose name matches ``pattern``
    (and of the memsets) and its launches a call, from a profiler trace of
    three calls (the mean over the launches the trace holds: it may drop a
    call's events, so a count below a whole number is such a loss); empty
    if the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    call(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call(*args)
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        m = re.search(pattern + r"\w*", e.key)
        if us and e.count and (m or "emset" in e.key):
            key = m.group(0) if m else "memset"
            ms, n = out.get(key, (0.0, 0))
            out[key] = ((ms * n + us / 1e3) / (n + e.count), n + e.count)
    return {k: (round(ms, 4), round(n / 3, 2)) for k, (ms, n) in out.items()}
