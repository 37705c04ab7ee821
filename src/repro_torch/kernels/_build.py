"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source compiles, on first use, into its own shared
library with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``).
Libraries go into ``kernels/build/`` beside this module (git-ignored; the
``REPRO_TORCH_BUILD_DIR`` environment variable overrides it), named by the
hash of the source, the headers beside it (``csrc/*.cuh``, which a source
may include) and the flags, so an edited source or header rebuilds and an
unchanged one is found in the cache.  :func:`build_all` starts one ``nvcc``
per source at once, so the build takes as long as the slowest source.

Nothing here runs at import time: every module imports on a machine with
no ``nvcc``, and a kernel compiles only when it is first needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "BuildInfo", "build_dir", "build_all",
           "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Loaded libraries by source name: a build cache, filled on first use.
_LIBS: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuildInfo:
    name: str
    path: Path
    built: bool            # False: found in the cache
    seconds: float
    ptxas: str             # nvcc's -Xptxas -v report ("" when cached)


def build_dir() -> Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(d) if d else Path(__file__).resolve().parent / "build"


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _target(src: Path) -> Path:
    """The library's path in the cache: named by the hash of the source,
    of every header in its directory (name and bytes) and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> list[BuildInfo]:
    """Build every named source (default: all of ``csrc/*.cu``) that is not
    in the cache, one ``nvcc`` process per source, all started together.
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    srcs = (sorted(CSRC.glob("*.cu")) if names is None
            else [CSRC / f"{n}.cu" for n in names])
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    infos: dict[str, BuildInfo] = {}
    procs = []
    for src in srcs:
        tgt = _target(src)
        if tgt.exists():
            infos[src.stem] = BuildInfo(src.stem, tgt, False, 0.0, "")
            continue
        tmp = tgt.with_name(f"{tgt.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tgt, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tgt, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, tgt)            # atomic: concurrent builds agree
        infos[src.stem] = BuildInfo(src.stem, tgt, True,
                                    time.perf_counter() - t0, log.strip())
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [infos[s.stem] for s in srcs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        (info,) = build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(info.path))
    return lib
