"""Multi-pod dry-run: trace one step of every (arch x shape) cell on the
production meshes and report, per device, its operations, the bytes of
every collective and the peak of live bytes.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for XLA:CPU with 512 fake devices; the port traces it with
DTensor on a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``), nothing allocated on
any device: the parameters, train state, batch and caches are ``meta``
tensors (``launch.input_specs``) distributed as DTensors by the
reference's PartitionSpec rules (``parallel.sharding``), and one step
(train, prefill or decode) runs under a dispatch mode that sees every
rank-0 local op beneath DTensor (:class:`Trace`).  The mode counts:

* operations: the matmuls' (``torch.utils.flop_counter``'s formulas, on
  the local shards, not the global op) and each hand kernel's, which its
  meta rule hands over (``kernels.count_flops``, PERF.md's bound formulas);
  elementwise work is not counted (XLA's ``flops`` counts it);
* collectives: the result bytes of each one, per device, by the
  reference's five kinds (``dryrun.py``'s ``collective_bytes``);
  ``shard_dim_alltoall`` is an all-to-all however DTensor runs it (on a
  CPU mesh as an all-gather and a chunk);
* live bytes: every storage an op makes, from its birth to its death,
  over the arguments' bytes; the peak is the most at once.

Usage::

    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --grid [--out results/dryrun_torch]
    python -m repro_torch.launch.dryrun --table [--out results/dryrun_torch]

It needs no card.  The grid runs each cell in a subprocess under a
timeout; a cell failure never poisons the rest.  Nothing here touches the
environment or a process group at import: a cell starts its fake group
itself.  The settings that change the program are the reference's:
``DRYRUN_PARAM_DTYPE`` (e.g. bf16 params), ``DRYRUN_MESH`` (``"64x4"``: a
``(data, model)`` re-split), ``DRYRUN_GRAD_WIRE``,
``DRYRUN_GRAD_COMPRESS`` and ``DRYRUN_SWA_CACHE``.  ``DRYRUN_HLO_PATH``
has no counterpart (an eager trace has no HLO to dump) and is ignored,
and so has ``normalize_cost_analysis`` (no compiled program to analyse):
the trace's own counts stand in for ``cost_analysis`` and
``memory_analysis``, and an op count for ``hlo_ops``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import weakref

import torch

__all__ = ["COLLECTIVES", "GRID_ARCHS", "Trace", "tracing", "collective_bytes",
           "shard_bytes", "start_fake_group", "distribute", "build_cell",
           "local_tensors", "trace_step", "run_cell", "run_grid",
           "grid_table", "main"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the c10d functional ops DTensor issues, by the reference's kinds
_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all",
          "broadcast": "collective-permute",
          "broadcast_": "collective-permute"}


def collective_bytes(trace: "Trace") -> dict:
    """Per-kind result bytes of every collective a rank issued in
    ``trace``, with their counts under ``counts`` (the reference's
    layout)."""
    out = dict(trace.coll)
    out["counts"] = dict(trace.coll_counts)
    return out


def shard_bytes(struct_tree, spec_tree, mesh) -> float:
    """Exact per-device bytes of a tree of tensors (meta ones too) laid out
    by a tree of specs."""
    from ..parallel.sharding import shard_count, spec_leaves
    from ..tree import leaves

    total = 0.0
    for t, spec in zip(leaves(struct_tree), spec_leaves(spec_tree)):
        total += t.numel() * t.element_size() / max(shard_count(spec, mesh),
                                                    1)
    return float(total)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace(torch.utils._python_dispatch.TorchDispatchMode):
    """The local ops of one rank beneath DTensor: operations, bytes read
    and written, collectives and live storages.  Ops on DTensors are
    handed back to DTensor (``NotImplemented``), whose local ops then come
    here; the ops its sharding propagation runs are not counted.
    ``base`` is the arguments' local tensors, alive throughout."""

    def __init__(self, base=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self._live: dict = {}
        for t in base:
            st = t.untyped_storage()
            self._live.setdefault(st._cdata, st.nbytes())
        self.argument_bytes = sum(self._live.values())
        self.live = self.argument_bytes
        self.peak = self.live
        self._quiet = 0     # inside shard_dim_alltoall: its inner collectives
        self._muted = 0     # inside sharding propagation: nothing counts

    def add_flops(self, n: float) -> None:
        """A kernel meta rule's operations (``kernels.count_flops``)."""
        self.flops += n

    def _free(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _collective(self, kind: str, out) -> None:
        self.coll[kind] += _nbytes(out)
        self.coll_counts[kind] += 1

    @contextlib.contextmanager
    def as_all_to_all(self):
        """Count DTensor's ``shard_dim_alltoall`` as one all-to-all of its
        result, whatever collectives carry it (on a CPU mesh: an
        all-gather and a chunk)."""
        from torch.distributed.tensor import placement_types as pt

        orig = pt.shard_dim_alltoall

        def wrapped(*a, **k):
            self._quiet += 1
            try:
                out = orig(*a, **k)
            finally:
                self._quiet -= 1
            self._collective("all-to-all", out)
            return out

        pt.shard_dim_alltoall = wrapped
        try:
            yield
        finally:
            pt.shard_dim_alltoall = orig

    @contextlib.contextmanager
    def muted_propagation(self):
        """Leave out the ops DTensor's sharding propagation runs on
        global-shape tensors to learn its outputs' shapes."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                       None)
        if orig is None:
            raise RuntimeError("this torch's DTensor has no "
                               "_propagate_tensor_meta_non_cached: the trace "
                               "could not tell its shape runs from the step")
        trace = self

        def muted(self, *a, **k):
            trace._muted += 1
            try:
                return orig(self, *a, **k)
            finally:
                trace._muted -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._muted:
            return out
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.ops += 1
        name = func._schema.name.split("::")[-1]
        kind = _KINDS.get(name)
        if kind is not None:
            if not self._quiet:
                self._collective(kind, outs[0])
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out


@contextlib.contextmanager
def tracing(base=()):
    """A :class:`Trace` open over its block, DTensor's plain tensors taken
    as replicated, the kernels' meta rules reporting to it."""
    from torch.distributed.tensor.experimental import implicit_replication

    tr = Trace(base)
    with implicit_replication(), tr.as_all_to_all(), \
            tr.muted_propagation(), tr:
        yield tr


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (a
    group of another size already open is an error)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is open; this cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def distribute(tree, specs, mesh):
    """``tree``'s leaves as DTensors laid out by ``specs`` (a spec tree
    mirroring it): a meta leaf as its local shard built directly, a leaf
    with data cut by :func:`torch.distributed.tensor.distribute_tensor`
    (every rank holds the same whole tensor)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from ..parallel.sharding import placements, spec_leaves
    from ..tree import leaves, unflatten

    out = []
    for t, spec in zip(leaves(tree), spec_leaves(specs)):
        pl = placements(spec, mesh)
        if t.is_meta:
            local, _ = compute_local_shape_and_global_offset(t.shape, mesh,
                                                             pl)
            out.append(DTensor.from_local(
                t.new_empty(local), mesh, pl, run_check=False,
                shape=t.shape, stride=t.stride()))
        else:
            out.append(distribute_tensor(t, mesh, pl, src_data_rank=None))
    return unflatten(tree, out)


def _mesh_for(multi_pod: bool, mesh_shape=None):
    from .mesh import make_mesh, production_axes

    split = mesh_shape or os.environ.get("DRYRUN_MESH")
    if split:
        d, m = (int(x) for x in split.split("x"))
        axes = {"data": d, "model": m}
    else:
        axes = production_axes(multi_pod)
    start_fake_group(math.prod(axes.values()))
    return make_mesh(axes)


def build_cell(arch: str, shape_name: str, multi_pod: bool, *,
               mesh=None, cfg=None, batch: int | None = None,
               seq: int | None = None, tc=None, served: bool = False):
    """(step, args, sharded argument bytes, mesh) for one cell; ``step(*args)``
    runs it.  ``mesh`` defaults to the production mesh (or
    ``DRYRUN_MESH``) over a fake group started here; ``cfg``, ``batch``,
    ``seq`` and ``tc`` override the arch's config, the shape's global
    batch and sequence and the train config; ``served`` lays a decode's
    parameters out as ``models.serve_params`` casts them."""
    from ..configs import SHAPES, get_config
    from ..configs.base import TrainConfig
    from ..models import decode_step, prefill
    from ..models.model import serve_params
    from ..parallel.sharding import (batch_specs, cache_specs, dp_axes,
                                     params_shardings, Spec)
    from ..train.train_step import init_state, make_train_step
    from .input_specs import cache_structs, input_specs, param_structs, sds

    cfg = cfg or get_config(arch)
    if os.environ.get("DRYRUN_PARAM_DTYPE"):
        cfg = cfg.replace(param_dtype=os.environ["DRYRUN_PARAM_DTYPE"])
    sh = SHAPES[shape_name]
    b = batch or sh.global_batch
    s = seq or sh.seq_len
    mesh = mesh if mesh is not None else _mesh_for(multi_pod)

    inputs = input_specs(arch, shape_name, cfg, batch=b, seq=s)
    b_specs = {k: v for k, v in batch_specs(cfg, mesh, sh.kind, b,
                                            s).items() if k in inputs}
    dev = "meta"
    if sh.kind == "train":
        tc = tc or TrainConfig(
            grad_wire_dtype=os.environ.get("DRYRUN_GRAD_WIRE", "float32"),
            grad_compression=bool(os.environ.get("DRYRUN_GRAD_COMPRESS")))
        state = init_state(param_structs(cfg), tc)
        st_specs = params_shardings(state, mesh)
        step = make_train_step(cfg, tc, dev)
        args = (distribute(state, st_specs, mesh),
                distribute(inputs, b_specs, mesh))
        arg_bytes = shard_bytes(state, st_specs, mesh)
    elif sh.kind == "prefill":
        params = param_structs(cfg)
        p_specs = params_shardings(params, mesh)
        c_specs = cache_specs(cfg, mesh, b, s)
        c_struct = cache_structs(cfg, b, s)     # global shapes: not traced

        def step(params, batch):
            # the caches the prefill fills are its outputs: each rank's
            # shards are made in the step
            caches = distribute(c_struct, c_specs, mesh)
            out = prefill(params, cfg, batch["tokens"], max_len=s,
                          device=dev, frames=batch.get("frames"),
                          caches=caches)
            return out[0], out[1]

        args = (distribute(params, p_specs, mesh),
                distribute(inputs, b_specs, mesh))
        arg_bytes = shard_bytes(params, p_specs, mesh)
    else:
        params = param_structs(cfg)
        if served:
            params = serve_params(params, cfg)
        p_specs = params_shardings(params, mesh)
        cache_len = s
        if cfg.sliding_window and os.environ.get("DRYRUN_SWA_CACHE"):
            cache_len = min(cache_len, cfg.sliding_window)
        caches = cache_structs(cfg, b, cache_len)
        c_specs = cache_specs(cfg, mesh, b, cache_len)
        cross = None
        if cfg.is_encdec:
            cross = distribute(sds((b, cfg.enc_seq, cfg.d_model),
                                   torch.float32),
                               Spec(dp_axes(mesh), None, None), mesh)
        # one token against a full cache: every key visible
        length = cache_len - 1

        def step(params, caches, tokens, cross_kv):
            return decode_step(params, cfg, tokens, caches, length,
                               device=dev, cross_kv=cross_kv)

        args = (distribute(params, p_specs, mesh),
                distribute(caches, c_specs, mesh),
                distribute(inputs, b_specs, mesh)["tokens"], cross)
        arg_bytes = (shard_bytes(params, p_specs, mesh)
                     + shard_bytes(caches, c_specs, mesh))
    return step, args, arg_bytes, mesh


def local_tensors(tree) -> list:
    """Each tensor of ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree, is_leaf=lambda x: isinstance(
                x, torch.Tensor)) if isinstance(t, torch.Tensor)]


def trace_step(step, args) -> tuple:
    """Run ``step(*args)`` under a :class:`Trace`: (trace, its output)."""
    base = local_tensors(args)
    with tracing(base) as tr:
        out = step(*args)
    return tr, out


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             mesh_shape: str | None = None, quiet: bool = False,
             **build) -> dict:
    """Trace one cell and print its JSON line (the reference's keys).
    ``mesh_shape`` (``"DxM"``) replaces the production mesh; ``build``
    goes to :func:`build_cell`."""
    t0 = time.time()
    if mesh_shape:
        build["mesh"] = _mesh_for(multi_pod, mesh_shape)
    step, args, arg_bytes, mesh = build_cell(arch, shape_name, multi_pod,
                                             **build)
    t_build = time.time() - t0
    tr, out = trace_step(step, args)
    t_trace = time.time() - t0 - t_build
    seen = {t.untyped_storage()._cdata for t in local_tensors(args)}
    out_bytes = 0
    for t in local_tensors(out):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            out_bytes += st.nbytes()
    mem = {"argument_bytes": tr.argument_bytes,
           "output_bytes": out_bytes,
           "temp_bytes": tr.peak - tr.argument_bytes,
           "peak_bytes": tr.peak,
           "sharded_argument_bytes_exact": arg_bytes}
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(mesh),
        "n_devices": mesh.size(),
        "ok": True,
        # lowering's counterpart: the sharded arguments built; compiling's:
        # the step traced
        "lower_s": round(t_build, 1),
        "compile_s": round(t_trace, 1),
        "flops_per_device": tr.flops,
        "bytes_per_device": tr.bytes,
        # an eager trace does not count transcendentals (XLA's cost
        # analysis does): no number rather than a wrong one
        "transcendentals": None,
        "memory": mem,
        "collectives": collective_bytes(tr),
        "ops": tr.ops,
        # DTensor's sharding propagation picks some layouts inside a block,
        # and torch versions pick differently: the numbers are this one's
        "torch": torch.__version__,
    }
    if not quiet:
        print(json.dumps(res), flush=True)
        print("memory:", mem, file=sys.stderr)
    return res


def run_grid(out_dir: str, timeout: int, only: str | None = None,
             meshes: tuple = (False, True)) -> None:
    """Every (arch x shape) cell of the reference's ten archs on both
    meshes, each in a subprocess under ``timeout`` seconds; a cell whose
    JSON is in ``out_dir`` already is skipped, a failed one leaves
    ``<tag>.json.err``."""
    from ..configs import REGISTRY, shape_cells

    os.makedirs(out_dir, exist_ok=True)
    cells = [(arch, shape, mp) for arch in REGISTRY if arch in GRID_ARCHS
             for shape in shape_cells(arch) for mp in meshes]
    for arch, shape, mp in cells:
        if only and only not in arch:
            continue
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            print("skip (done):", tag)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape]
        if mp:
            cmd.append("--multi-pod")
        print("run:", tag, flush=True)
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout)
            line = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            if p.returncode == 0 and line:
                with open(path, "w") as f:
                    f.write(line[-1])
                print("  ok", flush=True)
            else:
                with open(path + ".err", "w") as f:
                    f.write(p.stdout[-4000:] + "\n---\n" + p.stderr[-6000:])
                print("  FAIL (see .err)", flush=True)
        except subprocess.TimeoutExpired:
            with open(path + ".err", "w") as f:
                f.write("timeout")
            print("  TIMEOUT", flush=True)


def grid_table(out_dir: str) -> str:
    """The grid's results in ``out_dir`` as a markdown table, a row an
    arch, each column its shapes in order, each shape's 16 x 16 and 2 x 16
    x 16 runs as ``a / b``: ok or the error's last line, trace s,
    operations and peak GB a device, collective GB by kind."""
    from ..configs import shape_cells

    def run(tag: str):
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            return json.loads(open(path).read())
        err = path + ".err"
        lines = [ln for ln in open(err).read().splitlines() if ln.strip()] \
            if os.path.exists(err) else ["not run"]
        return (lines or ["failed"])[-1][-100:]

    def pair(rs, fn):
        return " / ".join(fn(r) if isinstance(r, dict) else "-" for r in rs)

    fields = [lambda r: "ok",
              lambda r: f"{r['compile_s']}",
              lambda r: f"{r['flops_per_device']:.3g}",
              lambda r: f"{r['memory']['peak_bytes'] / 1e9:.3g}"]
    fields += [lambda r, k=k: f"{r['collectives'][k] / 1e9:.3g}"
               for k in ("all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all")]
    rows = ["| Arch: shapes | ok | Trace s | Flops a device | Peak GB | "
            "All-reduce GB | All-gather GB | Reduce-scatter GB | "
            "All-to-all GB |", "|---|---|---|---|---|---|---|---|---|"]
    seen: set = set()
    for arch in GRID_ARCHS:
        shapes = shape_cells(arch)
        runs = [[run(f"{arch}__{sh}__{m}") for m in ("sp", "mp")]
                for sh in shapes]
        cols = ["; ".join(" / ".join(r if isinstance(r, str) else "ok"
                                     for r in rs) for rs in runs)]
        cols += ["; ".join(pair(rs, fn) for rs in runs) for fn in fields[1:]]
        rows.append(f"| {arch}: {', '.join(shapes)} | " + " | ".join(cols)
                    + " |")
        seen |= {r["torch"] for rs in runs for r in rs if isinstance(r, dict)}
    return "\n".join(rows + [f"\ntorch {', '.join(sorted(seen))}"])


# the reference's ten archs: the port's one-card cuts are not
# production-mesh configurations
GRID_ARCHS = ("yi-9b", "minicpm3-4b", "llama3.2-3b", "qwen1.5-0.5b",
              "internvl2-76b", "llama4-maverick-400b-a17b", "mixtral-8x7b",
              "whisper-tiny", "jamba-1.5-large-398b", "xlstm-350m")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--only")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--mesh", help="a (data, model) mesh 'DxM' in place of "
                    "the production mesh, e.g. 1x1 for one card")
    ap.add_argument("--batch", type=int, help="global batch (default: the "
                    "shape's)")
    ap.add_argument("--seq", type=int, help="sequence or cache length "
                    "(default: the shape's)")
    ap.add_argument("--served", action="store_true",
                    help="decode with the served parameters (serve_params)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (tests)")
    ap.add_argument("--table", action="store_true",
                    help="print the grid's results under --out as a table")
    args = ap.parse_args(argv)
    if args.table:
        print(grid_table(args.out))
        return
    if args.grid:
        run_grid(args.out, args.timeout, args.only)
        return
    build = {"batch": args.batch, "seq": args.seq, "served": args.served}
    if args.smoke:
        from ..configs import get_config
        build["cfg"] = get_config(args.arch, smoke=True)
    run_cell(args.arch, args.shape, args.multi_pod, mesh_shape=args.mesh,
             **build)


if __name__ == "__main__":
    main()
