"""Sharded npz checkpointing with manifest, atomic rename, keep-N, async.

Counterpart of ``repro.ckpt.checkpoint`` over trees of tensors (nested
dicts, lists, tuples, NamedTuples; ``None`` holds nothing), with the
reference's on-disk layout and leaf keys (:mod:`repro_torch.tree`), so a
checkpoint written by either package restores in the other::

    <dir>/step_000123/
        manifest.json        # leaf keys, shapes, dtypes
        shard_00000.npz      # this host's leaves (flattened paths)
    <dir>/LATEST             # atomic pointer file

Writes go to ``step_X.tmpN`` then ``os.replace``: a crash mid-write never
corrupts the latest checkpoint (a restart reads LATEST).  bf16 leaves are
stored as f32 (npz has no bf16) and cast back on restore (lossless).
:func:`save` copies every leaf to host memory before it returns, also with
``blocking=False``: the trainer's optimizer updates the parameters in
place, and a copy made later by the writer thread could tear.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import flatten_with_keys, unflatten

__all__ = ["latest_step", "restore", "save"]


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of it (bf16 as f32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(tree: Any, directory: str, step: int, host_id: int = 0,
         keep: int = 3, blocking: bool = True) -> threading.Thread | None:
    """Write one checkpoint.  With ``blocking=False`` returns the writer
    thread (async checkpointing: training continues); the device-to-host
    copy is done before this returns either way."""
    flat = {k: _host(v) for k, v in flatten_with_keys(tree)}

    def _write():
        final = os.path.join(directory, f"step_{step:09d}")
        tmp = final + f".tmp{host_id}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(directory, "LATEST.tmp"),
                   os.path.join(directory, "LATEST"))
        _gc(directory, keep)

    os.makedirs(directory, exist_ok=True)
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and ".tmp" not in d
    )
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> int | None:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def restore(template: Any, directory: str, step: int | None = None,
            host_id: int = 0) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (shapes must match; each
    tensor leaf comes back in the template leaf's dtype and on its
    device).  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, f"shard_{host_id:05d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    assert sorted(flat.keys()) == manifest["keys"], "manifest mismatch"

    out = []
    for key, leaf in flatten_with_keys(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"template {shape}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(arr.astype(np.asarray(leaf).dtype))
    return unflatten(template, out), step
