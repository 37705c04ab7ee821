"""The port's dry-run (repro_torch.launch.dryrun) on the CPU.

* A smoke cell traced on a fake (2, 2) mesh prints the reference's keys,
  with operations and a reduction (the counterpart of
  tests/test_dryrun.py's single-pod train cell).
* Each hand kernel's meta rule gives its plain version's output shapes and
  dtypes at smoke sizes, adds its operations to an open trace, and raises
  where the kernel raises.
* A rehearsal: four ``gloo`` CPU processes run (2, 2)-sharded steps on real
  tensors (f32): the loss and gradients of smoke dense, MoE, xLSTM and
  Jamba configs, and a prefill then three decode steps of a smoke GQA and
  a smoke MLA config over caches sharded along their sequence.  The loss
  holds to the one-process loss within rtol 1e-5, every gradient leaf
  within 1e-4 of its largest magnitude, the served logits within 1e-5,
  and the collectives by kind count as the fake-group trace of the same
  steps on meta tensors.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, SRC)

REFERENCE_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "lower_s",
                  "compile_s", "flops_per_device", "bytes_per_device",
                  "transcendentals", "memory", "collectives"}

# each process: every job's sharded step on a (2, 2) mesh; rank 0 of the
# gloo run also the one-process step; the fake run also the smoke train
# cell's JSON line
_REHEARSAL = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import cache_structs, param_structs, sds
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import (decode_step, init_params, loss_fn, moe,
                                prefill)
from repro_torch.models.transformer import init_cache
from repro_torch.parallel.sharding import (batch_specs, cache_specs,
                                           params_shardings)
from repro_torch.tree import leaves, tree_map

# MoE tokens are grouped over the whole batch in one process and over each
# data-parallel rank's rows when sharded: the groups coincide where each
# rank's rows make whole groups (groups of 256 tokens: a row of Mixtral's
# 4 x 256, two rows of Jamba's 4 x 128).  Mixtral's one kv head is
# repeated over the heads' ranks, its 4 experts expert-parallel over model
# 2.  Jamba is cut to one Mamba + dense, two Mamba + MoE and one attention
# layer.  The MLA
# config takes the kernels' latent and rope widths (256, 32), which its
# meta rules hold the fake trace to.
JOBS = {
    "qwen1.5-0.5b": ("train", {}, 4, 256),
    "mixtral-8x7b": ("train", dict(d_model=128, n_heads=2, n_kv_heads=1), 4,
                     256),
    "xlstm-350m": ("train", {}, 4, 64),
    "jamba-1.5-large-398b": ("train", dict(n_layers=4), 4, 128),
    "qwen1.5-0.5b serve": ("serve", {}, 4, 16),
    "minicpm3-4b serve": ("serve", dict(kv_lora_rank=256, rope_head_dim=32),
                          4, 16),
}
MAX_LEN, STEPS = 24, 3        # the cache's 12 positions a model rank
moe.GROUP_TOKENS = 256


def train(cfg, params, batch, mesh, device):
    dp = dryrun.distribute(params, params_shardings(params, mesh), mesh)
    b, s = batch["tokens"].shape
    db = dryrun.distribute(batch, batch_specs(cfg, mesh, "train", b, s),
                           mesh)
    with dryrun.tracing(dryrun.local_tensors((dp, db))) as tr:
        p = tree_map(lambda t: t.detach().requires_grad_(), dp)
        loss, _ = loss_fn(p, cfg, db, device=device)
        gs = torch.autograd.grad(loss, leaves(p))
    return [loss], gs, tr.coll_counts


def serve(cfg, params, caches, tokens, mesh, device):
    # a prompt of S tokens into caches of MAX_LEN, then STEPS decode steps
    # at int lengths: the prefill's last logits and each step's
    b, s = tokens.shape
    s -= STEPS
    dp = dryrun.distribute(params, params_shardings(params, mesh), mesh)
    dc = dryrun.distribute(caches, cache_specs(cfg, mesh, b, MAX_LEN), mesh)
    spec = batch_specs(cfg, mesh, "decode", b, 1)["tokens"]
    toks = [dryrun.distribute(tokens[:, :s], spec, mesh)] + [
        dryrun.distribute(tokens[:, s + i:s + i + 1], spec, mesh)
        for i in range(STEPS)]
    with dryrun.tracing(dryrun.local_tensors((dp, dc, toks))) as tr:
        logits, dc, ln = prefill(dp, cfg, toks[0], MAX_LEN, device=device,
                                 caches=dc)[:3]
        outs = [logits]
        for t in toks[1:]:
            logits, dc = decode_step(dp, cfg, t, dc, ln, device=device)[:2]
            outs.append(logits)
            ln += 1
    return outs, [], tr.coll_counts


def one_process(kind, cfg, params, data):
    if kind == "train":
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        ref, _ = loss_fn(p, cfg, data, device="cpu")
        return [ref], torch.autograd.grad(ref, leaves(p))
    s = data.shape[1] - STEPS
    logits, caches, ln = prefill(params, cfg, data[:, :s], MAX_LEN,
                                 device="cpu")[:3]
    outs = [logits]
    for i in range(STEPS):
        logits, caches = decode_step(params, cfg, data[:, s + i:s + i + 1],
                                     caches, ln + i, device="cpu")[:2]
        outs.append(logits)
    return outs, []


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


mode, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if mode == "fake":
    dryrun.start_fake_group(4)
else:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
mesh = make_host_mesh(2, 2, device_type="cuda" if mode == "fake" else "cpu")
res = {}
for name, (kind, kw, b, s) in JOBS.items():
    cfg = get_config(name.split()[0], smoke=True).replace(dtype="float32",
                                                          **kw)
    if mode == "fake":
        params = param_structs(cfg)
        if kind == "train":
            batch = {k: sds((b, s), torch.int32) for k in ("tokens",
                                                           "labels")}
            counts = train(cfg, params, batch, mesh, "meta")[2]
        else:
            counts = serve(cfg, params, cache_structs(cfg, b, MAX_LEN),
                           sds((b, s), torch.int32), mesh, "meta")[2]
        res[name] = {"counts": counts}
        continue
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s + 1), dtype=np.int32))
    if kind == "train":
        data = {"tokens": tok[:, :-1].contiguous(),
                "labels": tok[:, 1:].contiguous()}
        outs, gs, counts = train(cfg, params, data, mesh, "cpu")
    else:
        data = tok[:, :-1].contiguous()
        outs, gs, counts = serve(cfg, params,
                                 init_cache(cfg, b, MAX_LEN, "cpu"), data,
                                 mesh, "cpu")
    outs = [o.full_tensor() for o in outs]
    full = [g.full_tensor() for g in gs]
    if rank == 0:
        want, want_g = one_process(kind, cfg, params, data)
        res[name] = {"out_rel": [rel(o, w) for o, w in zip(outs, want)],
                     "n_out": [len(outs), len(want)], "counts": counts,
                     "grad_rel": [rel(g, w) for g, w in zip(full, want_g)],
                     "n_grads": [len(full), len(want_g)]}
if mode == "fake":
    cell = dryrun.run_cell("qwen1.5-0.5b", "train_4k", False, mesh=mesh,
                           cfg=get_config("qwen1.5-0.5b", smoke=True),
                           batch=4, seq=64, quiet=True)
    res["cell"] = cell
else:
    dist.destroy_process_group()
if rank == 0:
    print(json.dumps(res))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def rehearsal():
    """(the gloo run's rank 0 results, the fake-group run's), the five
    processes started together."""
    # one intra-op thread a process: five run at once beside the suite's
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = str(_free_port())
    runs = [("gloo", r) for r in range(4)] + [("fake", 0)]
    procs = [subprocess.Popen([sys.executable, "-c", _REHEARSAL, mode,
                               str(rank), port], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for mode, rank in runs]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return json.loads(outs[0].splitlines()[-1]), json.loads(
        outs[4].splitlines()[-1])


def test_smoke_cell_prints_the_reference_keys(rehearsal):
    r = rehearsal[1]["cell"]
    assert set(r) == REFERENCE_KEYS | {"ops", "torch"}
    assert r["torch"] == torch.__version__
    assert r["ok"] and r["n_devices"] == 4 and r["mesh"] == "2x2"
    assert r["flops_per_device"] > 0 and r["ops"] > 0
    assert r["transcendentals"] is None
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "peak_bytes",
                                "sharded_argument_bytes_exact"}
    c = r["collectives"]
    assert set(c) == {"all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute", "counts"}
    assert c["all-reduce"] > 0 or c["reduce-scatter"] > 0
    m = r["memory"]
    assert m["peak_bytes"] >= m["argument_bytes"] \
        >= m["sharded_argument_bytes_exact"] > 0


TRAIN = ["qwen1.5-0.5b", "mixtral-8x7b", "xlstm-350m",
         "jamba-1.5-large-398b"]
SERVE = ["qwen1.5-0.5b serve", "minicpm3-4b serve"]


@pytest.mark.parametrize("arch", TRAIN)
def test_rehearsal_matches_one_process(rehearsal, arch):
    """The sharded loss within rtol 1e-5 and every gradient leaf within
    1e-4 of its largest magnitude."""
    got = rehearsal[0][arch]
    assert got["n_out"] == [1, 1]
    assert got["out_rel"][0] <= 1e-5, got["out_rel"]
    assert got["n_grads"][0] == got["n_grads"][1] > 0
    assert max(got["grad_rel"]) <= 1e-4, got["grad_rel"]


@pytest.mark.parametrize("job", SERVE)
def test_rehearsal_serves_as_one_process(rehearsal, job):
    """A prompt written into caches sharded along their sequence, then three
    decode steps reading them gathered: the prefill's last logits and each
    step's within 1e-5 of their largest magnitude."""
    got = rehearsal[0][job]
    assert got["n_out"] == [4, 4]
    assert max(got["out_rel"]) <= 1e-5, got["out_rel"]


@pytest.mark.parametrize("arch", TRAIN + SERVE)
def test_rehearsal_collectives_count_as_the_fake_trace(rehearsal, arch):
    real, fake = rehearsal[0][arch]["counts"], rehearsal[1][arch]["counts"]
    assert real == fake
    assert sum(real.values()) > 0


# ---------------------------------------------------------------------------
# the kernels' meta rules
# ---------------------------------------------------------------------------

def _meta(*ts):
    return tuple(t.to("meta") for t in ts)


def _flops(fn, *args, **kw):
    """(fn's outputs, the operations its meta rule handed an open
    trace)."""
    from repro_torch.launch.dryrun import Trace

    with Trace() as tr:
        out = fn(*args, **kw)
    return out, tr.flops


def _like(meta_out, plain_out):
    ms = meta_out if isinstance(meta_out, tuple) else (meta_out,)
    ps = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    assert len(ms) == len(ps)
    for m, p in zip(ms, ps):
        assert m.is_meta
        assert (tuple(m.shape), m.dtype) == (tuple(p.shape), p.dtype)


def _randn(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed + len(shape))
    return torch.randn(*shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_rules(dtype):
    from repro_torch.kernels import visible_pairs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    from repro_torch.kernels.flash_attention_bwd import ops as bwd

    b, sq, sk, h, kv, dqk, dv = 2, 33, 40, 4, 2, 96, 64
    q, k, v = (_randn(b, sq, h, dqk, dtype=dtype), _randn(b, sk, kv, dqk,
               dtype=dtype), _randn(b, sk, kv, dv, dtype=dtype))
    plain = attention_lse_ref(q, k, v, True, 16)
    before = ops.launches
    out, fl = _flops(ops.attention_kernel, *_meta(q, k, v), causal=True,
                     window=16, with_lse=True)
    _like(out, plain)
    assert fl == 2.0 * b * h * (dqk + dv) * visible_pairs(sq, sk, True, 16)
    do = _randn(b, sq, h, dv, dtype=dtype, seed=1)
    grads = attention_bwd_ref(q, k, v, plain[0], plain[1], do, True, 16)
    out, fl = _flops(bwd.attention_bwd_kernel,
                     *_meta(q, k, v, plain[0], plain[1], do), True, 16)
    _like(out, grads)
    assert fl == 2.0 * b * h * (3 * dqk + 2 * dv) * visible_pairs(
        sq, sk, True, 16)
    assert ops.launches == before
    with pytest.raises(ValueError, match="head dims"):
        ops.attention_kernel(*_meta(q[..., :32], k[..., :32], v[..., :32]))
    with pytest.raises(ValueError, match="head dims"):
        bwd.attention_bwd_kernel(*_meta(q[..., :32], k[..., :32],
                                        v[..., :32], do[..., :32],
                                        plain[1], do[..., :32]))


def test_visible_pairs_closed_form():
    import numpy as np

    from repro_torch.kernels import visible_pairs

    for sq, sk, causal, window in [(5, 5, True, 0), (3, 9, True, 4),
                                   (9, 9, False, 3), (7, 12, False, 0),
                                   (1, 1, True, 1), (4, 4, True, 8)]:
        qpos = np.arange(sq)[:, None] + (sk - sq)
        kpos = np.arange(sk)[None, :]
        ok = np.ones((sq, sk), bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        assert visible_pairs(sq, sk, causal, window) == int(ok.sum())


def test_decode_meta_rule():
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    b, s, h, kv, dh = 3, 70, 8, 2, 64
    q, k, v = _randn(b, 1, h, dh), _randn(b, s, kv, dh), _randn(b, s, kv, dh)
    plain = decode_attention_ref(q, k, v, 50, 16)
    before = ops.launches
    out, fl = _flops(ops.decode_kernel, *_meta(q, k, v), 50, 16)
    _like(out, plain)
    assert fl == 4.0 * h * dh * b * 16
    assert ops.launches == before
    with pytest.raises(ValueError, match="head dims"):
        ops.decode_kernel(*_meta(q[..., :32], k[..., :32], v[..., :32]), 5)
    with pytest.raises(ValueError, match="query heads"):
        ops.decode_kernel(*_meta(_randn(b, 1, 66, dh), k[:, :, :1],
                                 v[:, :, :1]), 5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_kernel(q, k, v, 5)


def test_mla_meta_rules():
    from repro_torch.kernels import visible_pairs
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.kernels.mla_attention.ref import (mla_decode_ref,
                                                       mla_prefill_ref)

    b, sq, sk, h, r, dr = 2, 5, 9, 8, 256, 32
    ql, qr = _randn(b, sq, h, r), _randn(b, sq, h, dr)
    c, kr = _randn(b, sk, r), _randn(b, sk, dr)
    before = (ops.PREFILL.launches, ops.DECODE.launches)
    out, fl = _flops(ops.mla_prefill_kernel, *_meta(ql, qr, c, kr), 0.1)
    _like(out, mla_prefill_ref(ql, qr, c, kr, 0.1))
    assert fl == 2.0 * b * h * (2 * r + dr) * visible_pairs(sq, sk, True, 0)
    out, fl = _flops(ops.mla_decode_kernel,
                     *_meta(ql[:, :1], qr[:, :1], c, kr), 6, 0.1)
    _like(out, mla_decode_ref(ql[:, :1], qr[:, :1], c, kr, 6, 0.1))
    assert fl == 2.0 * h * (2 * r + dr) * b * 7
    assert (ops.PREFILL.launches, ops.DECODE.launches) == before
    with pytest.raises(ValueError, match="latent width"):
        ops.mla_prefill_kernel(*_meta(ql[..., :128], qr, c[..., :128], kr),
                               0.1)
    with pytest.raises(ValueError, match="latent width"):
        ops.mla_decode_kernel(*_meta(ql[:, :1], qr[:, :1, :, :16], c,
                                     kr[..., :16]), 3, 0.1)


def test_mlstm_meta_rules():
    from repro_torch.kernels.mlstm import ops
    from repro_torch.kernels.mlstm.ref import (mlstm_chunkwise_bwd_ref,
                                               mlstm_chunkwise_ref)
    from repro_torch.kernels.mlstm_bwd import ops as bwd

    b, s, h, dh = 2, 70, 2, 32
    q, k, v = (_randn(b, s, h, dh, seed=i) for i in range(3))
    li, lf = _randn(b, s, h, seed=3), -_randn(b, s, h, seed=4).abs()
    plain = mlstm_chunkwise_ref(q, k, v, li, lf)
    before = (ops.launches, bwd.launches)
    out, fl = _flops(ops.mlstm_kernel, *_meta(q, k, v, li, lf))
    _like((out[0],) + tuple(out[1]), (plain[0],) + tuple(plain[1]))
    assert fl == 2.0 * b * s * h * (2 * dh * dh + 2 * dh)
    do = _randn(b, s, h, dh, seed=5)
    want = mlstm_chunkwise_bwd_ref(q, k, v, li, lf, plain[0], do)
    out, fl = _flops(bwd.mlstm_bwd_kernel, *_meta(q, k, v, li, lf, plain[0],
                                                  do))
    _like(tuple(out), tuple(want))
    assert fl == 2.0 * 4 * dh * dh * b * s * h
    assert (ops.launches, bwd.launches) == before
    assert ops.workspace_floats(b, s, h, dh) > 0
    assert bwd.workspace_floats(b, s, h, dh) > 0
    with pytest.raises(ValueError, match="head dims"):
        ops.mlstm_kernel(*_meta(q[..., :24], k[..., :24], v[..., :24], li,
                                lf))
    with pytest.raises(ValueError, match="head dims"):
        bwd.mlstm_bwd_kernel(*_meta(q[..., :24], k[..., :24], v[..., :24],
                                    li, lf, q[..., :24], q[..., :24]))


def test_scan_meta_rules():
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    from repro_torch.kernels.mamba_scan_bwd import ops as bwd

    b, s, d, n = 2, 70, 48, 16
    dt = _randn(b, s).abs() * 0.1
    a = -_randn(d, n, seed=1).abs()
    bm, cm, u = _randn(b, s, n, seed=2), _randn(b, s, n, seed=3), _randn(
        b, s, d, seed=4)
    plain = selective_scan_ref(dt, a, bm, cm, u)
    before = (ops.launches, bwd.launches)
    out, fl = _flops(ops.selective_scan_kernel, *_meta(dt, a, bm, cm, u),
                     keep_states=True)
    _like(out[:2], plain)
    assert tuple(out[2].shape) == (b, 2, d, n)
    assert fl == 7.0 * b * s * d * n + b * s * n
    dy = _randn(b, s, d, seed=5)
    want = selective_scan_bwd_ref(dt, a, bm, cm, u, dy)
    got, fl = _flops(bwd.selective_scan_bwd_kernel,
                     *_meta(dt, a, bm, cm, u, dy), out[2])
    _like(tuple(got), tuple(want))
    assert fl == 1.0 * b * s * d * n
    assert (ops.launches, bwd.launches) == before
    with pytest.raises(ValueError, match="d_state"):
        ops.selective_scan_kernel(*_meta(dt, a[:, :4], bm[..., :4],
                                         cm[..., :4], u))
