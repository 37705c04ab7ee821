#!/usr/bin/env python3
"""The port's Sinkhorn kernel against its parent and against timing
variants of itself, on one NVIDIA card.

    python3 benchmarks/torch_sinkhorn_ab.py --old OLD.cu

``OLD.cu`` is an earlier ``src/repro_torch/kernels/csrc/sinkhorn.cu``
(``git show <commit>:src/repro_torch/kernels/csrc/sinkhorn.cu > OLD.cu``,
written where the run can read it).  The script builds it, this tree's
kernel and text variants of this tree's kernel with ``nvcc`` (the port's
flags) under ``--build`` (default ``build/ab``, git-ignored), in parallel,
and prints each build's ``ptxas`` report.  Then it:

1. holds this tree's kernel (through ``repro_torch.kernels.sinkhorn.ops``)
   to its plain version within ``chip_smoke.TOL`` and, on the cluster
   path, to ``sinkhorn_kernel_order`` bit for bit, at n from 1 to past the
   cluster's reach, f32 at 20 and f64 at 200 iterations, with the main
   path's input (the websearch demand at n = 256, load 0.3) among them;
   the variants that keep the arithmetic are held to the model too;
2. times the old and the new kernel in turns (old, new, new, old) by
   ``chip_smoke.device_ms`` (CUDA-graph replay) and ``chip_smoke.time_ms``
   (events over eager calls) at f64 n = 256 and 512 with 200 iterations
   and f32 n = 256, 512 and 1024 with 20, and each variant at n = 256;
3. reads the per-phase cycle counts of one f64 n = 256, 200-iteration call
   (``prof``: clock64 in thread 0 of every block, summed over the rounds).

Variants (all but ``prof`` and the ones marked timing only give the
kernel's bits):

- ``nodiv`` (timing only): each quotient one multiply by the reciprocal;
- ``noexch`` (timing only): no stores to other blocks and no waits, every
  total 1 (the rounds' two trips through the cluster left out);
- ``ieee``: IEEE ``x / s`` for every quotient;
- ``two_barriers``: a cluster barrier before (c) and before (d), so each
  mbarrier wait finds its data there;
- ``pull``: every block reads every group's partial of its columns from the
  block that holds the group (32 KiB a block a round at n = 256, f64) after
  one cluster barrier a round, double-buffered, instead of the
  reduce-scatter and all-gather.

Writes the timings to ``--json`` (default ``chiprun_out/ab_sinkhorn.json``).
Needs the card; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sinkhorn import ops  # noqa: E402
from repro_torch.kernels.sinkhorn.ref import (  # noqa: E402
    sinkhorn_kernel_order,
    sinkhorn_ref,
)

F32, F64 = torch.float32, torch.float64
KERNEL = "template <typename T, int GPB>\n__global__ void __launch_bounds__"

NODIV = [("  T q = mul_rn(x, y);\n  T r = fma_rn(-q, s, x);\n  q = fma_rn(r, y, q);\n"
          "  r = fma_rn(-q, s, x);\n  return fma_rn(r, y, q);", "  return mul_rn(x, y);")]
IEEE = [("  if (fast) {\n#pragma unroll\n    for (int r = 0; r < ROWS; ++r) {\n"
         "      const T q = quotient(",
         "  if (false) {\n#pragma unroll\n    for (int r = 0; r < ROWS; ++r) {\n"
         "      const T q = quotient(")]
NOOP = (KERNEL, "template <typename... A>\n__device__ __forceinline__ void noop(A...) {}\n\n"
        + KERNEL)
NOEXCH = [NOOP,
          ("hopper::mbar_expect_tx(bar_gather", "noop(bar_gather"),
          ("if (holds) hopper::mbar_expect_tx(bar_totals", "if (holds) noop(bar_totals"),
          ("hopper::mbar_wait(bar_gather, parity);", "noop();"),
          ("hopper::mbar_wait(bar_totals, parity);", "noop();"),
          ("          hopper::st_async(gather_at", "          noop(gather_at"),
          ("        hopper::st_async(hopper::cluster_addr(totals + rank * cpb + k, h),",
           "        noop(hopper::cluster_addr(totals + rank * cpb + k, h),"),
          ("  // every block's mbarriers are ready before any block stores to them\n",
           "  for (int j = c; j < nt; j += nt) totals[j] = T(1);\n"
           "  for (int j = c; j < blocks * GPB * cpb; j += nt) gather[j] = T(1);\n"
           "  __syncthreads();\n")]
TWO_BARRIERS = [("    // (c) the owned columns' totals", "    cluster.sync();\n    // (c) the owned columns' totals"),
                ("    // (d) each column divided by its total\n",
                 "    cluster.sync();\n    // (d) each column divided by its total\n")]
PROF = [
    (KERNEL, "__device__ long long g_prof[16][8];\n"
     "#define PROF(k) { long long n_ = clock64(); acc_[k] += n_ - t_; t_ = n_; }\n\n" + KERNEL),
    ("  for (int it = 0; it < iters; ++it) {\n    const uint32_t parity",
     "  long long t_ = clock64(), acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  for (int it = 0; it < iters; ++it) {\n    const uint32_t parity"),
    ("      __syncthreads();\n      bool fast = true;\n",
     "      PROF(0)\n      __syncthreads();\n      bool fast = true;\n"),
    ("      fast = __syncthreads_and(fast);\n", "      fast = __syncthreads_and(fast);\n      PROF(1)\n"),
    ("      divide<ROWS>(v, rows, rowtot, rowrcp, 1, fast);\n",
     "      divide<ROWS>(v, rows, rowtot, rowrcp, 1, fast);\n      PROF(2)\n"),
    ("    // (c) the owned columns' totals", "    PROF(3)\n    // (c) the owned columns' totals"),
    ("        hopper::mbar_wait(bar_gather, parity);\n",
     "        hopper::mbar_wait(bar_gather, parity);\n        PROF(4)\n"),
    ("    // (d) each column divided by its total\n", "    PROF(5)\n    // (d) each column divided by its total\n"),
    ("      hopper::mbar_wait(bar_totals, parity);\n",
     "      hopper::mbar_wait(bar_totals, parity);\n      PROF(6)\n"),
    ("        divide<ROWS>(v, rows, &tot, &y, 0, exact_range(tot));\n      }\n    }\n",
     "        divide<ROWS>(v, rows, &tot, &y, 0, exact_range(tot));\n      }\n    }\n    PROF(7)\n"),
    ("  if (col_ok) {\n#pragma unroll\n    for (int r = 0; r < ROWS; ++r)\n      if (row0 + r < n) out",
     "  if (c == 0)\n    for (int k_ = 0; k_ < 8; ++k_) g_prof[rank][k_] = acc_[k_];\n"
     "  if (col_ok) {\n#pragma unroll\n    for (int r = 0; r < ROWS; ++r)\n      if (row0 + r < n) out"),
    ("const char* cuda_error_string(int code) {",
     "int sinkhorn_prof(long long* out) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));\n}\n\n"
     "const char* cuda_error_string(int code) {"),
]
PHASES = ["row butterfly", "row totals", "row quotients", "partials sent",
          "partials waited", "totals sent", "totals waited", "column quotients"]

# the one-barrier design: partial[2][GPB][nt] in each block, every block
# reads every group's partial of each column after one cluster barrier
PULL_ROUND = '''    T* part = reinterpret_cast<T*>(bars + 2) + (it & 1) * GPB * nt;
    if (holds) {
      // (a)
#pragma unroll
      for (int k = 0; k < GPB; ++k) {
        const T s = warp_row_sums(v + k * GROUP, lane);
        if ((lane & 1) == 0) red[(k * GROUP + (lane >> 1)) * warps + warp] = s;
      }
      __syncthreads();
      bool fast = true;
      for (int r = c; r < ROWS; r += nt) {
        const T s = sum_in_order(red + r * warps, warps, 1);
        rowtot[r] = s;
        rowrcp[r] = rcp_rn(s);
        if (row0 + r < n) fast = fast && exact_range(s);
      }
      fast = __syncthreads_and(fast);
      divide<ROWS>(v, rows, rowtot, rowrcp, 1, fast);
#pragma unroll
      for (int k = 0; k < GPB; ++k) {
        T s = v[k * GROUP];
#pragma unroll
        for (int i = 1; i < GROUP; ++i) s += v[k * GROUP + i];
        part[k * nt + c] = s;
      }
    }
    cluster.sync();
    if (rows > 0) {
      T tot = *cluster.map_shared_rank(part + c, 0);
#pragma unroll 8
      for (int g = 1; g < groups; ++g)
        tot += *cluster.map_shared_rank(part + (g % GPB) * nt + c, g / GPB);
      const T y = rcp_rn(tot);
      divide<ROWS>(v, rows, &tot, &y, 0, exact_range(tot));
    }
  }
'''


def pull(text: str) -> str:
    """The round of ``text``'s kernel replaced by the one-barrier pull."""
    a = text.index("    const uint32_t parity = it & 1;\n")
    b = text.index("  if (col_ok) {\n#pragma unroll\n    for (int r = 0; r < ROWS; ++r)\n"
                   "      if (row0 + r < n) out")
    # red and the row totals sit past partial[2][GPB][nt]
    t = text[:a] + PULL_ROUND + "\n" + text[b:]
    return t.replace("  T* red = mine + cpb;",
                     "  T* red = reinterpret_cast<T*>(bars + 2) + 2 * GPB * nt;")


VARIANTS = {"nodiv": NODIV, "noexch": NOEXCH, "ieee": IEEE,
            "two_barriers": TWO_BARRIERS, "prof": PROF}
SAME_BITS = ("ieee", "two_barriers", "pull")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvcc(src: Path, out: Path) -> subprocess.Popen:
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(old: Path, out: Path) -> dict:
    """Every source built at once; returns the loaded libraries by name."""
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    text = (_build.CSRC / "sinkhorn.cu").read_text()
    sources = {"old": old.read_text(), "new": text, "pull": pull(text)}
    for name, subs in VARIANTS.items():
        t = text
        for a, b in subs:
            if a not in t:
                raise SystemExit(f"variant {name}: anchor not in the source: "
                                 f"{a[:60]!r}")
            t = t.replace(a, b)
        sources[name] = t
    procs = {}
    for name, t in sources.items():
        (out / f"{name}.cu").write_text(t)
        procs[name] = nvcc(out / f"{name}.cu", out / f"{name}.so")
    libs = {}
    for name, p in procs.items():
        report, _ = p.communicate()
        log(f"== nvcc {name}: rc {p.returncode}")
        for line in report.splitlines():
            if "error" in line.lower() or "Used" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                log(f"  {line.strip()}")
        if p.returncode == 0:
            libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    log(f"build wall {time.perf_counter() - t0:.1f} s")
    return libs


def caller(lib, dtype):
    name, c_eps = (("sinkhorn_f64", ctypes.c_double) if dtype == F64
                   else ("sinkhorn_f32", ctypes.c_float))
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, c_eps, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(m, iters, eps):
        out = torch.empty_like(m)
        err = fn(m.data_ptr(), out.data_ptr(), m.shape[0], iters, eps,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def rand(n: int, dtype, seed: int | None = None) -> torch.Tensor:
    g = np.random.default_rng(n if seed is None else seed)
    return torch.from_numpy(g.random((n, n)) + 0.01).to("cuda", dtype)


def main_input(n: int = 256) -> torch.Tensor:
    return torch.from_numpy(cs.saturate_input(n, 0.3)).to("cuda")


def check(call, m, iters, eps, cluster, label) -> bool:
    """Within TOL of the plain version, NaN where it has NaN, two calls the
    same, and on the cluster path the model's bits."""
    got = call(m, iters, eps)
    again = call(m, iters, eps)
    torch.cuda.synchronize()
    want = sinkhorn_ref(m, iters, eps)
    rtol, atol = cs.TOL[m.dtype]
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    ok = bool((err <= atol + rtol * want[fin].abs()).all()) and \
        torch.equal(torch.isnan(got), torch.isnan(want))
    same = cs._same_bits(got, again)
    var = ops.variant(m.shape[0], m.dtype)
    bits = (cs._same_bits(got.cpu(), sinkhorn_kernel_order(
        m.cpu(), iters, eps, cluster)) if var == "cluster" else None)
    log(f"  {label:22s} {cs._dname(m.dtype):8s} n={m.shape[0]:4d} "
        f"iters={iters:3d} {var:8s} max_abs_err="
        f"{float(err.max()) if err.numel() else 0.0:.3e} "
        f"{'ok' if ok else 'FAIL'}; bits of the model {bits}; "
        f"repeatable {same}")
    return ok and same and bits is not False


def checks(libs) -> bool:
    log("== this tree's kernel (through ops) against the plain version and "
        "the model of its order")
    c = ops.cluster_size()
    top = {d: ops.max_cluster_n(d) for d in (F32, F64)}
    log(f"  cluster size {c}; the cluster path takes n <= {top[F32]} (f32), "
        f"<= {top[F64]} (f64)")
    k = ops.sinkhorn_kernel
    ok = check(k, main_input(), 200, 0.0, c, "main path's input")
    for n in (1, 17, 64, 250, 256, 512, top[F32], top[F32] + 1, 1024):
        ok &= check(k, rand(n, F32), 20, 1e-12, c, "random")
    for n in (1, 17, 250, 256, top[F64], top[F64] + 1):
        ok &= check(k, rand(n, F64), 200, 0.0, c, "random")
    for it in (0, 1):
        for n in (250, top[F64] + 1):
            ok &= check(k, rand(n, F64), it, 0.0, c, f"iters {it}")
    nan = rand(64, F64)
    nan[7, 9] = float("nan")
    ok &= check(k, nan, 5, 0.0, c, "a NaN entry")
    for name in SAME_BITS:
        if name not in libs:
            continue
        for m, it, eps in ((main_input(), 200, 0.0), (rand(250, F64, 6), 200,
                                                      0.0),
                           (rand(256, F32, 7), 20, 1e-12)):
            ok &= check(caller(libs[name], m.dtype), m, it, eps, c, name)
    log(f"checks {'passed' if ok else 'FAILED'}")
    return ok


def timings(libs) -> dict:
    """Device ms / ms with the host: old and new in turns at every size,
    then each variant at n = 256."""
    res = {}
    cases = [(F64, 256, 200, 0.0, 20), (F32, 256, 20, 1e-12, 50),
             (F32, 512, 20, 1e-12, 50), (F32, 1024, 20, 1e-12, 20),
             (F64, 512, 200, 0.0, 10)]
    for dtype, n, it, eps, reps in cases:
        m = main_input(n) if dtype == F64 else rand(n, dtype)
        key = f"{cs._dname(dtype)} n={n} iters={it}"
        row: dict = {}
        names = ["old", "new", "new", "old"]
        if n == 256:
            names += [v for v in libs if v not in ("old", "new", "prof")]
        for name in names:
            call = caller(libs[name], dtype)
            f = lambda: call(m, it, eps)  # noqa: E731
            row.setdefault(name, []).append(
                {"device_ms": cs.device_ms(f, reps),
                 "ms_with_host": cs.time_ms(f, reps)})
        res[key] = row
        log(f"  {key}: " + "; ".join(
            f"{k} " + ", ".join(f"{t['device_ms']:.4f} / "
                                f"{t['ms_with_host']:.4f}" for t in v)
            for k, v in row.items()))
    return res


def profile_rounds(lib) -> list:
    """Cycles a round by phase, thread 0 of each block."""
    call = caller(lib, F64)
    m = main_input()
    for _ in range(3):
        call(m, 200, 0.0)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 128)()
    lib.sinkhorn_prof.argtypes = [ctypes.c_void_p]
    if lib.sinkhorn_prof(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the phase counters failed")
    cyc = np.array(buf[:]).reshape(16, 8) / 200.0
    log("== cycles a round by phase, f64 n = 256, 200 iterations (thread 0 "
        "of blocks 0, 8, 15; the mean of all 16)")
    for b in (0, 8, 15):
        log(f"  block {b:2d}: " + ", ".join(
            f"{p} {v:.0f}" for p, v in zip(PHASES, cyc[b]))
            + f"; total {cyc[b].sum():.0f}")
    log("  mean    : " + ", ".join(
        f"{p} {v:.0f}" for p, v in zip(PHASES, cyc.mean(0)))
        + f"; total {cyc.mean(0).sum():.0f}")
    return cyc.mean(0).tolist()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="an earlier csrc/sinkhorn.cu to time against")
    ap.add_argument("--build", type=Path, default=ROOT / "build" / "ab")
    ap.add_argument("--json", type=Path,
                    default=ROOT / "chiprun_out" / "ab_sinkhorn.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sinkhorn_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs = build(args.old, args.build)
    if not {"old", "new"} <= set(libs):
        return 1
    ok = checks(libs)
    log("== device ms / ms with the host (old, new, new, old; variants)")
    res = {"card": card, "timings": timings(libs)}
    if "prof" in libs:
        res["cycles_by_phase"] = dict(zip(PHASES, profile_rounds(libs["prof"])))
    log(f"card: {cs.nvidia_smi()}")
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
