"""Parameter / activation sharding rules for the production mesh, as the
reference's PartitionSpecs and as DTensor placements.

Counterpart of ``repro.parallel.sharding``, rule for rule.  Mesh axes:
optional ``pod`` (pure DP across pods, the axis Vermilion's optical
interconnect serves), ``data`` (FSDP: params and optimizer sharded,
weights all-gathered per layer), ``model`` (TP: heads / FFN hidden / vocab
/ experts).

A spec is a :class:`Spec`, a tuple with one entry per tensor dim: ``None``
(not sharded), a mesh-axis name, or a tuple of names (sharded over each, in
mesh order) - the reference's ``PartitionSpec``.  :func:`placements` turns
one into DTensor placements, one per mesh dim.  ``mesh`` is a
``DeviceMesh`` or a ``{axis name: size}`` dict in mesh order (the rules
read only names and sizes, so they need no process group).

Rules are matched on the flattened parameter path, the reference's
``_path_str`` (``cells/0/attn/wq``; a NamedTuple field as ``.mu``);
anything unmatched falls back to a divisibility heuristic (largest dim ->
model, next -> data).  Optimizer state (mu/nu mirrors params) reuses the
same specs: ZeRO for free.
"""
from __future__ import annotations

import math
import re

import numpy as np

from ..tree import SEP, flatten_with_keys, unflatten

__all__ = ["Spec", "mesh_axes", "param_spec", "params_shardings",
           "dp_axes", "batch_specs", "cache_specs", "placements",
           "to_shardings", "shard_count", "flatten_paths", "spec_leaves"]


class Spec(tuple):
    """One tensor's sharding: per dim ``None``, an axis name or a tuple of
    axis names (the reference's ``PartitionSpec``, which also writes a
    one-name tuple as the name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _path_str(key: str) -> str:
    """A :func:`repro_torch.tree.flatten_with_keys` key as the reference's
    ``_path_str`` spells it: list items by their bare index."""
    return SEP.join(re.sub(r"^\[(\d+)\]$", r"\1", p) for p in key.split(SEP))


def flatten_paths(tree) -> list[tuple[str, object]]:
    """[(the reference's path string, leaf)] in JAX's leaf order."""
    return [(_path_str(k), leaf) for k, leaf in flatten_with_keys(tree)]


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def param_spec(path: str, shape: tuple, mesh) -> Spec:
    """Spec for one parameter leaf (path includes stacked prefix)."""
    axes = mesh_axes(mesh)
    dsz, msz = axes.get("data", 1), axes.get("model", 1)
    nd = len(shape)

    stacked = bool(re.search(r"(cells/\d+|encoder|cross)", path))
    off = 1 if stacked and nd >= 2 else 0   # leading layer-stack dim: None

    def spec(*tail):
        return Spec(*([None] * off + list(tail)))

    name = path.split("/")[-1]
    d = tuple(shape[off:])

    # --- embeddings -------------------------------------------------------
    if name == "embed":
        return Spec("model" if _div(shape[0], msz) else None,
                    "data" if _div(shape[1], dsz) else None)
    if name == "unembed":
        return Spec("data" if _div(shape[0], dsz) else None,
                    "model" if _div(shape[1], msz) else None)
    if name in ("enc_pos",):
        return Spec(None, None)
    if name == "vis_proj":
        return Spec("data" if _div(shape[0], dsz) else None,
                    "model" if _div(shape[1], msz) else None)

    # --- MoE expert stacks (..., E, d, ff) / (..., E, ff, d) ----------------
    if name in ("w_gate", "w_in", "w_out") and nd - off == 3:
        e, a, b = d
        if _div(e, msz):   # expert parallel over model axis
            return spec("model", "data" if _div(a, dsz) else None, None)
        # few experts: TP the ff dim instead
        if name == "w_out":
            return spec(None, "model" if _div(a, msz) else None,
                        "data" if _div(b, dsz) else None)
        return spec(None, "data" if _div(a, dsz) else None,
                    "model" if _div(b, msz) else None)

    # --- projections: input-major (d -> wide) -----------------------------
    if name in ("wq", "wk", "wv", "w_uq", "w_ukv", "w_dq", "w_dkv", "up",
                "in_proj", "w_gates", "r_gates", "w_gate", "w_in", "router",
                "x_proj", "w_kr", "w_i", "w_f", "w_o"):
        if nd - off == 2:
            a, b = d
            return spec("data" if _div(a, dsz) else None,
                        "model" if _div(b, msz) else None)

    # --- output projections (wide -> d) -----------------------------------
    if name in ("wo", "w_out", "out_proj", "down"):
        if nd - off == 2:
            a, b = d
            return spec("model" if _div(a, msz) else None,
                        "data" if _div(b, dsz) else None)

    # --- small / vector params: replicate ---------------------------------
    if nd - off <= 1 or min(d) < 64:
        return spec(*([None] * (nd - off)))

    # --- fallback heuristic ------------------------------------------------
    order = np.argsort(d)[::-1]
    tail: list = [None] * (nd - off)
    used = []
    for i in order:
        if "model" not in used and _div(d[i], msz):
            tail[i] = "model"
            used.append("model")
        elif "data" not in used and _div(d[i], dsz):
            tail[i] = "data"
            used.append("data")
    return spec(*tail)


def params_shardings(params, mesh):
    """Spec tree mirroring ``params`` (a tree of tensors, meta tensors
    too): a train state's leaves as well, with the reference's paths.

    Optimizer moments (mu/nu) additionally shard their layer-stack dim over
    the ``pod`` axis when present (ZeRO-1 across pods): params must stay
    pod-replicated for DP compute, but the moments are only touched at the
    update, so pod-sharding them halves per-device optimizer memory per pod.
    """
    psz = mesh_axes(mesh).get("pod", 1)
    out = []
    for pstr, leaf in flatten_paths(params):
        shape = tuple(leaf.shape)
        spec = param_spec(pstr, shape, mesh)
        if (psz > 1 and re.search(r"(^|/)\.?(mu|nu)(/|$)", pstr)
                and len(shape) >= 1 and spec and spec[0] is None
                and shape[0] % psz == 0):
            spec = Spec(*(("pod",) + tuple(spec)[1:]))
        out.append(spec)
    return unflatten(params, out)


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------

def dp_axes(mesh) -> tuple:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _dp_total(mesh) -> int:
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in dp_axes(mesh))


def batch_specs(cfg, mesh, kind: str, batch: int, seq: int) -> dict:
    """Specs for the input batch dict."""
    dp = dp_axes(mesh)
    dp_total = _dp_total(mesh)
    bspec = dp if batch % max(dp_total, 1) == 0 and batch >= dp_total else None
    specs = {"tokens": Spec(bspec, None)}
    if kind == "train":
        specs["labels"] = Spec(bspec, None)
    if cfg.family == "vlm":
        specs["vision_embeds"] = Spec(bspec, None, None)
    if cfg.is_encdec:
        specs["frames"] = Spec(bspec, None, None)
    return specs


def cache_specs(cfg, mesh, batch: int, seq: int) -> list:
    """Specs for the decode cache tree (mirrors models.init_cache).

    KV caches shard: batch over dp if divisible, sequence over the leftover
    axes ('model', plus 'data' when batch cannot use it): flash-decode
    split-K.  Recurrent states shard their channel dim over 'model'.
    (The port's decode gathers such a cache whole to the ranks that read
    it, ``parallel.spmd.attention``: its kernels write no log-sum-exp to
    combine shards by.)
    """
    from ..models.transformer import cell_structure

    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    dp_total = _dp_total(mesh)
    use_b = batch % max(dp_total, 1) == 0 and batch >= dp_total
    bspec = dp if use_b else None
    seq_axes = ("model",) if use_b else tuple(
        a for a in ("data", "model") if a in axes)
    di = cfg.mamba_expand * cfg.d_model
    msz = axes.get("model", 1)
    mspec = "model" if di % msz == 0 else None

    specs = []
    for kind, _ in cell_structure(cfg):
        if kind == "attn":
            if cfg.attention == "mla":
                specs.append((
                    Spec(None, bspec, seq_axes, None),
                    Spec(None, bspec, seq_axes, None),
                ))
            else:
                specs.append((
                    Spec(None, bspec, seq_axes, None, None),
                    Spec(None, bspec, seq_axes, None, None),
                ))
        elif kind == "mamba":
            specs.append((Spec(None, bspec, mspec, None),
                          Spec(None, bspec, None, mspec)))
        elif kind == "mlstm":
            specs.append((Spec(None, bspec, None, None, None),
                          Spec(None, bspec, None, None),
                          Spec(None, bspec, None)))
        elif kind == "slstm":
            specs.append((Spec(None, bspec, mspec), Spec(None, bspec, mspec),
                          Spec(None, bspec, mspec), Spec(None, bspec, mspec)))
    return specs


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names (a tuple of names shards that
    dim over each of them, in mesh order), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def shard_count(spec: Spec, mesh) -> int:
    """Shards a tensor of ``spec`` is cut into (its bytes a device hold are
    its bytes over this)."""
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for e in spec for a in _axes_of(e))


def _map_specs(fn, tree):
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_specs(fn, v) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return tree


def spec_leaves(tree) -> list:
    """The specs of a spec tree in JAX's leaf order (that of
    :func:`repro_torch.tree.leaves` over the tree it mirrors)."""
    if tree is None:
        return []
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


def to_shardings(tree_of_specs, mesh):
    """The placements of every spec in a tree, in its structure."""
    return _map_specs(lambda s: placements(s, mesh), tree_of_specs)
