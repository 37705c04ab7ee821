"""The port's kernel build cache (``repro_torch.kernels._build``), without
``nvcc``: a library's cache key covers its source, the headers beside it
and the flags, so an edited header rebuilds and nothing else does.  And the
package data: an installed port ships every source and every header a
source includes."""
import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc`` with one source that includes one header, and a
    temporary build directory."""
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "h.cuh"\n__global__ void k() {}\n')
    (d / "h.cuh").write_text("// helpers, first version\n")
    monkeypatch.setattr(_build, "CSRC", d)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return d


def test_key_stays_put_when_nothing_changes(csrc, tmp_path):
    first = _build._target(csrc / "k.cu")
    assert first == _build._target(csrc / "k.cu")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("k-") and first.suffix == ".so"


def test_key_follows_an_included_header(csrc):
    before = _build._target(csrc / "k.cu")
    (csrc / "h.cuh").write_text("// helpers, second version\n")
    edited = _build._target(csrc / "k.cu")
    assert edited != before
    (csrc / "h.cuh").write_text("// helpers, first version\n")
    assert _build._target(csrc / "k.cu") == before


def test_key_follows_the_source_and_a_new_header(csrc):
    before = _build._target(csrc / "k.cu")
    (csrc / "g.cuh").write_text("// another header\n")
    assert _build._target(csrc / "k.cu") != before
    (csrc / "g.cuh").unlink()
    assert _build._target(csrc / "k.cu") == before
    (csrc / "k.cu").write_text('#include "h.cuh"\n__global__ void k2() {}\n')
    assert _build._target(csrc / "k.cu") != before


def test_build_all_finds_the_cache_and_rebuilds_after_a_header_edit(
        csrc, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc was called")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    cached = _build._target(csrc / "k.cu")
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"")                 # a library already built
    (info,) = _build.build_all(["k"])
    assert (info.name, info.path, info.built) == ("k", cached, False)
    (csrc / "h.cuh").write_text("// helpers, second version\n")
    with pytest.raises(RuntimeError, match="nvcc was called"):
        _build.build_all(["k"])


ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"


def _shipped(pyproject: Path) -> list:
    """The package-data globs of ``repro_torch`` in ``pyproject``."""
    with open(pyproject, "rb") as f:
        cfg = tomllib.load(f)
    return cfg["tool"]["setuptools"]["package-data"]["repro_torch"]


def _included(csrc: Path) -> set:
    """Every file a ``csrc`` source or header includes with quotes, as a
    path relative to the package."""
    names = set()
    for src in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(),
                               flags=re.M):
            names.add((src.parent / name).resolve().relative_to(PACKAGE))
    return names


def test_package_data_ships_every_included_header():
    csrc = PACKAGE / "kernels" / "csrc"
    globs = _shipped(ROOT / "pyproject.toml")
    included = _included(csrc)
    assert Path("kernels/csrc/hopper.cuh") in included
    for rel in included:
        assert (PACKAGE / rel).exists(), rel
        assert any(fnmatch.fnmatch(rel.as_posix(), g) for g in globs), (
            f"{rel} is included by a kernel source but no package-data glob "
            f"of repro_torch ({globs}) ships it")
    for src in csrc.glob("*.cu"):
        rel = src.relative_to(PACKAGE).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def test_package_data_check_fails_without_the_header_glob(tmp_path):
    """The check above refuses a pyproject that ships the sources alone."""
    text = (ROOT / "pyproject.toml").read_text()
    old = tmp_path / "pyproject.toml"
    old.write_text(re.sub(r'repro_torch = \[[^\]]*\]',
                          'repro_torch = ["kernels/csrc/*.cu"]', text))
    globs = _shipped(old)
    missing = [rel for rel in _included(PACKAGE / "kernels" / "csrc")
               if not any(fnmatch.fnmatch(rel.as_posix(), g) for g in globs)]
    assert Path("kernels/csrc/hopper.cuh") in missing
