"""repro_torch.parallel.sharding and the dry-run's argument bytes against
the reference's ``repro.parallel.sharding`` and ``repro.launch.dryrun``.

The reference's values come from its own functions, in one subprocess
that sets its 512-device XLA flag (as tests/test_pipeline.py does): for
each of the ten architectures, on both production meshes and on the
``"64x4"`` re-split, the PartitionSpec of every parameter and train-state
leaf (its path and shape too), the batch and cache specs of every cell, and
for the 66 (cell x production mesh) runs the per-device argument bytes of
``shard_bytes``.  The port's come from meta trees (``launch.input_specs``)
through its own rules; specs are compared leaf by leaf and bytes exactly.
"""
import functools
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, SRC)

ARCHS = ("yi-9b", "minicpm3-4b", "llama3.2-3b", "qwen1.5-0.5b",
         "internvl2-76b", "llama4-maverick-400b-a17b", "mixtral-8x7b",
         "whisper-tiny", "jamba-1.5-large-398b", "xlstm-350m")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "64x4": {"data": 64, "model": 4}}

_REFERENCE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from repro.configs import REGISTRY, SHAPES, shape_cells
from repro.configs.base import TrainConfig
from repro.launch.dryrun import shard_bytes
from repro.launch.input_specs import cache_structs, param_structs
from repro.parallel.sharding import (_path_str, batch_specs, cache_specs,
                                     params_shardings, to_shardings)
from repro.train.train_step import init_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "64x4": ((64, 4), ("data", "model"))}


def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def tree_specs(tree, mesh):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    shs = jax.tree.leaves(params_shardings(tree, mesh),
                          is_leaf=lambda x: hasattr(x, "spec"))
    return [[_path_str(p), list(leaf.shape), enc(s.spec)]
            for (p, leaf), s in zip(flat, shs)]


out = {}
for arch, cfg in REGISTRY.items():
    p = param_structs(cfg)
    st = jax.eval_shape(lambda p: init_state(p, TrainConfig()), p)
    out[arch] = {}
    for name, (shape, axes) in MESHES.items():
        mesh = jax.make_mesh(shape, axes)
        m = out[arch][name] = {"params": tree_specs(p, mesh),
                               "state": tree_specs(st, mesh), "batch": {},
                               "cache": {}, "bytes": {}}
        for sname in shape_cells(arch):
            sh = SHAPES[sname]
            b, s = sh.global_batch, sh.seq_len
            m["batch"][sname] = {k: enc(v) for k, v in batch_specs(
                cfg, mesh, sh.kind, b, s).items()}
            if sh.kind == "decode":
                m["cache"][sname] = [[enc(x) for x in t]
                                     for t in cache_specs(cfg, mesh, b, s)]
            if name == "64x4":
                continue
            if sh.kind == "train":
                n = shard_bytes(st, params_shardings(st, mesh))
            else:
                n = shard_bytes(p, params_shardings(p, mesh))
            if sh.kind == "decode":
                n += shard_bytes(cache_structs(cfg, b, s), to_shardings(
                    cache_specs(cfg, mesh, b, s), mesh))
            m["bytes"][sname] = n
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def _enc(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@functools.cache
def _trees(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.input_specs import param_structs
    from repro_torch.train.train_step import init_state

    cfg = get_config(arch)
    p = param_structs(cfg)
    return cfg, p, init_state(p, TrainConfig())


def _tree_specs(tree, mesh) -> list:
    from repro_torch.parallel.sharding import (flatten_paths,
                                               params_shardings, spec_leaves)

    specs = spec_leaves(params_shardings(tree, mesh))
    return [[path, list(leaf.shape), _enc(s)]
            for (path, leaf), s in zip(flatten_paths(tree), specs)]


CELLS = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_param_and_state_specs(reference, arch, mesh):
    """Every parameter and train-state leaf (path, shape, spec) as the
    reference's, the mu/nu pod rule included."""
    _, p, st = _trees(arch)
    ref = reference[arch][mesh]
    assert _tree_specs(p, MESHES[mesh]) == ref["params"]
    assert _tree_specs(st, MESHES[mesh]) == ref["state"]


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_batch_and_cache_specs(reference, arch, mesh):
    from repro_torch.configs import SHAPES, shape_cells
    from repro_torch.parallel.sharding import batch_specs, cache_specs

    cfg = _trees(arch)[0]
    ref = reference[arch][mesh]
    axes = MESHES[mesh]
    for sname in shape_cells(arch):
        sh = SHAPES[sname]
        b, s = sh.global_batch, sh.seq_len
        got = {k: _enc(v) for k, v in batch_specs(cfg, axes, sh.kind, b,
                                                  s).items()}
        assert got == ref["batch"][sname], sname
        if sh.kind == "decode":
            got = [[_enc(x) for x in t] for t in cache_specs(cfg, axes, b, s)]
            assert got == ref["cache"][sname], sname


RUNS = [(a, s, m) for a in ARCHS
        for s in (["train_4k", "prefill_32k", "decode_32k"]
                  + (["long_500k"] if a in ("jamba-1.5-large-398b",
                                            "xlstm-350m", "mixtral-8x7b")
                     else []))
        for m in ("16x16", "2x16x16")]


def test_the_grid_has_66_runs():
    from repro_torch.configs import shape_cells
    from repro_torch.launch.dryrun import GRID_ARCHS

    assert set(GRID_ARCHS) == set(ARCHS)
    assert len(RUNS) == 66
    assert RUNS == [(a, s, m) for a in ARCHS for s in shape_cells(a)
                    for m in ("16x16", "2x16x16")]


@pytest.mark.parametrize("arch,shape,mesh", RUNS)
def test_argument_bytes(reference, arch, shape, mesh):
    """Per-device argument bytes of each run exactly the reference's
    ``shard_bytes``: the train state for train, the params for prefill,
    params and caches for decode."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import shard_bytes
    from repro_torch.launch.input_specs import cache_structs
    from repro_torch.parallel.sharding import cache_specs, params_shardings

    cfg, p, st = _trees(arch)
    axes = MESHES[mesh]
    sh = SHAPES[shape]
    tree = st if sh.kind == "train" else p
    got = shard_bytes(tree, params_shardings(tree, axes), axes)
    if sh.kind == "decode":
        b, s = sh.global_batch, sh.seq_len
        got += shard_bytes(cache_structs(cfg, b, s),
                           cache_specs(cfg, axes, b, s), axes)
    assert got == reference[arch][mesh]["bytes"][shape]
