"""The model on DTensors: the calls that DTensor's sharding propagation
cannot carry, run on each rank's local shards.

The model code runs unchanged on DTensors (``launch.dryrun``): matmuls,
norms and elementwise ops propagate their placements and DTensor inserts
the collectives they need.  Each block starts from a fixed layout
(:func:`block_inputs`): its weights gathered over the data-parallel axes
(FSDP) and kept sharded over ``model`` (tensor parallel), its input's
batch over the data-parallel axes; left to itself, DTensor's cost model
(which counts bytes moved, not operations) picks layouts that multiply
whole weights on every rank.  Reshapes into and out of heads gather first
where DTensor's view rule refuses an uneven split (:func:`split_last`,
:func:`merge_last`).  What DTensor cannot carry goes through
:func:`torch.distributed.tensor.experimental.local_map`
(:func:`shard_call`), each input redistributed to the placements its call
takes (a collective that is counted, as GSPMD's inserted all-gathers are):

* the hand kernels: each kernel op (``flash_attention.ops.attention``,
  ``decode_attention.ops.decode_attn``, ``mla_attention.ops.mla_prefill``
  and ``mla_decode``, ``mlstm.ops.mlstm``, ``mamba_scan.ops.selective_scan``)
  hands a DTensor to :func:`attention`, :func:`latent_attention`,
  :func:`mlstm` or :func:`selective_scan`, which call it back on each
  rank's shards (the batch over the data-parallel axes where it divides,
  the heads or channels over ``model`` where they divide), so that on
  ``meta`` tensors their meta rules run; a cache sharded along its
  sequence is gathered whole first, as the kernel reads a lane's keys on
  one card;
* the cache writes (:func:`write_cache`): index and slice assignments have
  no DTensor rule; each rank writes the positions its shard holds;
* the MoE FFN (:func:`moe_ffn`): its routing (top-k, cumulative counts,
  scatter, index_add) has no DTensor rule; each rank routes its tokens and
  adds what its share of the experts (expert parallel) or of every
  expert's hidden width gives, summed over ``model``;
* the sLSTM's per-token loop (:func:`slstm_scan`): thousands of small
  steps whose recurrent product mixes every channel, run on each rank's
  batch shard with the channels whole;
* the mLSTM's log-sigmoid forget gate (:func:`pointwise`): its backward
  has no DTensor rule;
* the cross-entropy over a sharded vocabulary (:func:`vocab_logits`,
  :func:`logsumexp`, :func:`label_logits`): DTensor's own rules gather the
  logits, their gradient or fail;
* the embedding lookup (:func:`embed`): vocabulary-parallel, each rank's
  shard; DTensor's index rules refuse tokens sharded over two axes.

The functions the model calls directly (:func:`block_inputs`,
:func:`batch_layout`, :func:`split_last`, :func:`merge_last`,
:func:`embed`, :func:`pointwise`, :func:`slstm_scan` and the three
cross-entropy functions) take plain tensors too and then do what the
model did before, so that the model calls one function whatever its
inputs.  The kernels' plain versions (the model's ``plain=True``) are not
routed.  RoPE needs nothing: plain tensors beside DTensors are taken as
replicated (``implicit_replication``).
"""
from __future__ import annotations

import math
import sys

import torch

__all__ = ["is_dtensor", "dp_names", "placements", "shard_call", "shards",
           "pointwise", "fsdp_gather", "batch_layout", "block_inputs",
           "logsumexp", "embed", "vocab_logits", "label_logits",
           "split_last", "merge_last", "attention", "write_cache",
           "prompt_keys", "latent_attention", "mlstm", "selective_scan",
           "slstm_scan", "moe_ffn"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (free where DTensor was never imported:
    none can exist then)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_names(mesh, n: int) -> list:
    """The data-parallel mesh axes (``pod``, ``data``) a dim of size ``n``
    shards over: all of them where their product divides ``n``, else
    none (the rule of ``sharding.batch_specs``)."""
    sizes = _sizes(mesh)
    names = [a for a in ("pod", "data") if a in sizes]
    total = math.prod(sizes[a] for a in names)
    return names if n % total == 0 and n >= total else []


def _model(mesh, n: int) -> list:
    m = _sizes(mesh).get("model")
    return ["model"] if m and n % m == 0 else []


def placements(mesh, roles: dict) -> tuple:
    """Placements over ``mesh`` of a tensor whose dim ``d`` shards over the
    mesh axes ``roles[d]`` (in mesh order), replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, names in roles.items() if name in names]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_call(fn, mesh, ins: list, outs, *args, shares=()):
    """``fn(*locals, *args)`` on each rank's shards: ``ins`` (tensor,
    roles) pairs, each tensor redistributed to its roles' placements;
    ``outs`` the output's placements, or a tuple of them for several.
    An input held whole over a mesh axis that another input is cut along
    gets a partial sum for its gradient there: each rank's gradient is
    what its piece adds (a weight beside a batch shard).  ``shares``: more
    mesh axes over which each rank computes a share of the result (summed
    over them), with the same effect; elsewhere ranks that hold the same
    inputs compute the same thing, and one rank's gradient is the whole."""
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map

    if isinstance(outs[0], Placement):      # one output: local_map's list
        outs = list(outs)
    in_pl = tuple(None if t is None else placements(mesh, r)
                  for t, r in ins) + (None,) * len(args)
    shares = set(shares) | {name for pl in in_pl if pl is not None
                            for name, p in zip(mesh.mesh_dim_names, pl)
                            if p.is_shard()}
    grad_pl = tuple(
        None if pl is None else tuple(
            Partial() if p.is_replicate() and name in shares else p
            for name, p in zip(mesh.mesh_dim_names, pl)) for pl in in_pl)
    run = local_map(fn, out_placements=outs, in_placements=in_pl,
                    in_grad_placements=grad_pl, device_mesh=mesh,
                    redistribute_inputs=True)
    return run(*(t for t, _ in ins), *args)


def pointwise(fn, t):
    """``fn``, elementwise, on each rank's shard of ``t`` (a partial sum
    reduced first): for an op whose backward has no DTensor rule
    (``log_sigmoid_backward``).  A plain ``t``: ``fn(t)``."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=t.device_mesh, redistribute_inputs=True)(t)


def fsdp_gather(tree):
    """Each DTensor leaf of ``tree`` (dicts and lists) with its shards over
    the data-parallel axes gathered (FSDP's per-layer all-gather; its
    backward reduce-scatters the gradients), its ``model`` sharding kept."""
    if isinstance(tree, dict):
        return {k: fsdp_gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fsdp_gather(v) for v in tree)
    if not is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate

    names = tree.device_mesh.mesh_dim_names
    pl = [Replicate() if n in ("pod", "data") else p
          for n, p in zip(names, tree.placements)]
    return tree if list(tree.placements) == pl else tree.redistribute(
        placements=pl)


class _Layout(torch.autograd.Function):
    """The activations' layout both ways: forward ``x`` redistributed to
    ``pl`` (a partial sum reduced: Megatron's ``g``), backward the gradient
    reduced to ``pl`` where it comes as a partial sum (Megatron's ``f``).
    Left lazy, the partial gradient reaches the next row-parallel product,
    where DTensor's cost model, blind to operations, gathers the weight and
    multiplies its whole width on every rank rather than reduce it."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x) if tuple(x.placements) == pl else \
            x.redistribute(placements=pl)

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(placements=ctx.pl)
        return g, None


def batch_layout(x):
    """``x`` (B, ...) with its batch over the data-parallel axes where it
    divides and replicated elsewhere (a partial sum reduced, and its
    gradient too): the activations' layout between blocks, tensor
    parallelism inside them.  A plain tensor passes unchanged."""
    if not is_dtensor(x):
        return x
    pl = placements(x.device_mesh, {0: dp_names(x.device_mesh, x.shape[0])})
    return _Layout.apply(x, pl)


def block_inputs(x, *trees) -> tuple:
    """(``x`` in the activations' layout (:func:`batch_layout`), each of
    ``trees``' weights gathered over the data-parallel axes
    (:func:`fsdp_gather`)): a block's inputs.  Plain ones pass
    unchanged."""
    if not is_dtensor(x):
        return (x, *trees)
    return (batch_layout(x), *(fsdp_gather(t) for t in trees))


def _vocab_split(t) -> bool:
    """Whether ``t`` is a DTensor whose last dim (a vocabulary) is cut."""
    return is_dtensor(t) and shards(t, -1) > 1


def logsumexp(x):
    """``torch.logsumexp(x, -1)`` of a DTensor as max, exp and sum, each of
    which DTensor reduces over a sharded last dim with a small all-reduce
    (its own logsumexp rule gathers the operand).  Otherwise
    ``torch.logsumexp``."""
    if not _vocab_split(x):
        return torch.logsumexp(x, dim=-1)
    top = x.detach().amax(-1, keepdim=True)
    return (top + torch.log(torch.exp(x - top).sum(-1, keepdim=True)))[..., 0]


def _reshape(t, shape):
    """``t.reshape(shape)``; for a DTensor whose reshaped dims are sharded
    in a way DTensor's view rule refuses (40 heads over 16 ranks, split or
    merged; a partial sum, which its rule tries to shard; torch versions
    differ in what they refuse), those dims are gathered and the sum
    reduced first."""
    from torch.distributed.tensor import Replicate

    lead = 0
    while lead < min(t.ndim, len(shape)) and t.shape[lead] == shape[lead]:
        lead += 1
    heads = min(t.shape[lead], shape[lead]) if lead < len(shape) else 1
    sizes = _sizes(t.device_mesh)
    moved = [name for name, p in zip(t.device_mesh.mesh_dim_names,
                                     t.placements)
             if getattr(p, "dim", -1) >= lead]
    if not any(p.is_partial() for p in t.placements) \
            and heads % math.prod(sizes[n] for n in moved) == 0:
        try:
            return t.reshape(shape)
        except RuntimeError as e:
            if "shard" not in str(e):
                raise
    return t.redistribute(placements=[
        Replicate() if getattr(p, "dim", -1) >= lead or p.is_partial() else p
        for p in t.placements]).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _reshape(t, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape(g, ctx.shape), None


def _reshape_both_ways(t, shape):
    if not is_dtensor(t):
        return t.reshape(shape)
    return _Reshape.apply(t, tuple(shape))


def split_last(t, *sizes):
    """``t``'s last dim split into ``sizes`` (heads, head width): a plain
    reshape, except that a DTensor sharded there over ranks that do not
    divide the heads (40 over 16) is gathered first, forward and backward
    (DTensor's view rule refuses it)."""
    return _reshape_both_ways(t, (*t.shape[:-1], *sizes))


def merge_last(t):
    """``t``'s last two dims merged (heads x head width), gathered first
    where DTensor's view rule refuses, as in :func:`split_last`."""
    return _reshape_both_ways(t, (*t.shape[:-2], t.shape[-2] * t.shape[-1]))


def _offset(mesh, names: list, n_local: int) -> int:
    """First position of this rank's shard of a dim sharded over
    ``names`` (mesh order) in pieces of ``n_local``."""
    coord = mesh.get_coordinate()
    sizes = _sizes(mesh)
    idx = 0
    for name in names:
        idx = idx * sizes[name] + coord[mesh.mesh_dim_names.index(name)]
    return idx * n_local


def shards(t, dim: int) -> int:
    """Into how many pieces DTensor ``t``'s dim ``dim`` is cut."""
    sizes = _sizes(t.device_mesh)
    return math.prod(sizes[n] for n in _shard_names(t, dim % t.ndim))


def _shard_names(t, dim: int) -> list:
    """The mesh axes that shard DTensor ``t``'s dim ``dim``."""
    return [name for name, p in zip(t.device_mesh.mesh_dim_names,
                                    t.placements)
            if p.is_shard() and p.dim == dim]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _head_roles(mesh, h: int, kvh: int) -> tuple:
    """(mesh axes the heads shard over, how many times to repeat each kv
    head first): q and kv heads both over ``model`` where both divide; one
    kv head a rank (repeated) where the query heads divide and ``model`` is
    a multiple of the kv heads; else none."""
    m = _sizes(mesh).get("model", 1)
    if m == 1 or h % m:
        return [], 1
    if kvh % m == 0:
        return ["model"], 1
    if m % kvh == 0:
        return ["model"], m // kvh
    return [], 1


def _repeat_heads(t, rep: int):
    if rep == 1:
        return t
    b, s, kvh, dh = t.shape
    return t[:, :, :, None, :].expand(b, s, kvh, rep, dh).reshape(
        b, s, kvh * rep, dh)


def attention(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (flash attention, or decode attention over a
    query's keys or a cache) on each rank's (batch, heads) shard.  k and v
    are redistributed to that layout: a cache sharded along its sequence
    (``sharding.cache_specs``) comes whole to the ranks that read it, by
    an all-to-all over the mesh axes that take its heads and an
    all-gather over the rest, since a decode kernel reads a lane's keys on
    one card."""
    if isinstance(kw.get("length"), torch.Tensor):
        raise NotImplementedError("a sharded decode takes an int length")
    mesh = q.device_mesh
    heads, rep = _head_roles(mesh, q.shape[2], k.shape[2])
    k, v = _repeat_heads(k, rep), _repeat_heads(v, rep)
    roles = {0: dp_names(mesh, q.shape[0]), 2: heads}
    return shard_call(lambda q, k, v: fn(q, k, v, **kw), mesh,
                      [(q, roles), (k, roles), (v, roles)],
                      placements(mesh, roles))


def _cache_roles(cache) -> dict:
    return {0: _shard_names(cache, 0), 1: _shard_names(cache, 1)}


def write_cache(caches: tuple, news: tuple, ln) -> None:
    """Each ``new`` (B, S, ...) into its cache DTensor (B, max_len, ...),
    batch and sequence sharded as ``sharding.cache_specs`` lays it, at the
    int ``ln`` (one token clamped to ``max_len - 1``, as
    ``layers.write_cache`` clamps it); each rank writes the positions its
    shard holds."""
    if not isinstance(ln, int):
        raise NotImplementedError("a sharded cache takes an int length")
    n = caches[0].shape[1]
    s = news[0].shape[1]
    start = min(ln, n - 1) if s == 1 else ln
    if start + s > n:
        raise ValueError(f"{s} tokens at {ln} do not fit a cache of {n}")
    mesh = caches[0].device_mesh
    roles = _cache_roles(caches[0])

    whole = s == n      # a prompt that fills the cache shards as it does

    def write(*ts):
        half = len(ts) // 2
        for cache, new in zip(ts[:half], ts[half:]):
            if whole:
                cache.copy_(new.to(cache.dtype))
                continue
            off = _offset(mesh, roles[1], cache.shape[1])
            lo, hi = max(start, off), min(start + s, off + cache.shape[1])
            if lo < hi:
                cache[:, lo - off:hi - off] = new[:, lo - start:hi - start].to(
                    cache.dtype)
        return ts[0].new_zeros(())

    new_roles = {0: roles[0], 1: roles[1] if whole else []}
    shard_call(write, mesh, [(c, roles) for c in caches]
               + [(t, new_roles) for t in news], placements(mesh, {}))


def prompt_keys(news: tuple, ln) -> tuple:
    """The keys a prompt written at ``ln`` into a sharded cache attends
    over: its own fresh ``news``, which are the cache's prefix ``[0, S)``
    at ``ln`` 0, the only offset a sharded cache is filled from (gathering
    the prefix from the cache's shards would move it for nothing)."""
    if ln != 0:
        raise NotImplementedError("a sharded cache is filled from position 0")
    return news


def latent_attention(fn, q_lat, q_rope, c, k_rope, *args):
    """``fn(q_lat, q_rope, c, k_rope, *args)`` (MLA prefill or decode) on
    each rank's (batch, heads) shard; the latent keys are shared by the
    heads, so they shard over the batch only (a latent cache sharded along
    its sequence is gathered whole, as in :func:`attention`)."""
    if args and isinstance(args[0], torch.Tensor):
        raise NotImplementedError("a sharded decode takes an int length")
    mesh = q_lat.device_mesh
    bd = dp_names(mesh, q_lat.shape[0])
    qroles = {0: bd, 2: _model(mesh, q_lat.shape[2])}
    kroles = {0: bd}
    return shard_call(lambda *ts: fn(*ts, *args), mesh,
                      [(q_lat, qroles), (q_rope, qroles), (c, kroles),
                       (k_rope, kroles)], placements(mesh, qroles))


def embed(table, tokens):
    """``table[tokens]`` with the table's vocabulary sharded over
    ``model`` where it is: each rank looks up the tokens its shard holds
    (0 elsewhere), the rows summed over ``model`` (the vocabulary-parallel
    embedding; DTensor's index rules refuse tokens sharded over two mesh
    axes, and some torch versions fail on their backward).  A plain
    table: ``table[tokens]``."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    vd = _shard_names(table, 0)
    bd = dp_names(mesh, tokens.shape[0])

    def local(tab, tok):
        off = _offset(mesh, vd, tab.shape[0])
        idx = tok.long() - off
        ok = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows, 0.0)

    out = [Shard(0) if n in bd else Partial() if n in vd else Replicate()
           for n in mesh.mesh_dim_names]
    return shard_call(local, mesh, [(table, {0: vd}), (tokens, {0: bd})],
                      out, shares=tuple(bd) + tuple(vd))


def vocab_logits(h, w):
    """f32 logits ``h @ w`` (h (B, c, d), w (d, V) sharded over ``model``
    by vocabulary) on each rank's batch shard and vocabulary shard, their
    gradients partial sums (the vocabulary-parallel head: DTensor's own
    matmul rule re-lays the logits' gradient out as whole vocabulary rows,
    multiplying the head's whole width on every rank).  A head whose
    vocabulary is whole: ``(h @ w).float()``."""
    if not _vocab_split(w):
        return (h @ w.to(h.dtype)).float()
    mesh = h.device_mesh
    bd = dp_names(mesh, h.shape[0])
    return shard_call(lambda h, w: (h @ w.to(h.dtype)).float(), mesh,
                      [(h, {0: bd}), (w, {1: ["model"]})],
                      placements(mesh, {0: bd, 2: ["model"]}),
                      shares=mesh.mesh_dim_names)


def label_logits(logits, labels):
    """``logits`` (B, ..., V) at ``labels`` (B, ...): each rank's vocabulary
    shard gives the labels it holds and 0 elsewhere, summed over
    ``model`` (the vocabulary-parallel cross-entropy's gather; DTensor's
    own gather rule fails on a vocabulary-sharded operand).  Whole logits:
    ``torch.gather``."""
    if not _vocab_split(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    bd = dp_names(mesh, logits.shape[0])
    vd = _model(mesh, logits.shape[-1])

    def local(lg, lb):
        off = _offset(mesh, vd, lg.shape[-1])
        idx = lb - off
        ok = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(ok, got[..., 0], 0.0)

    out = [Shard(0) if n in bd else Partial() if n in vd else Replicate()
           for n in mesh.mesh_dim_names]
    return shard_call(local, mesh, [(logits, {0: bd, logits.ndim - 1: vd}),
                                    (labels, {0: bd})], out)


# ---------------------------------------------------------------------------
# recurrent blocks
# ---------------------------------------------------------------------------

def mlstm(fn, q, k, v, logi, logf, state=None):
    """``fn`` (the chunkwise mLSTM) on each rank's (batch, heads) shard:
    (out, (C, n, m))."""
    mesh = q.device_mesh
    bd = dp_names(mesh, q.shape[0])
    hd = _model(mesh, q.shape[2])
    r4, r3 = {0: bd, 2: hd}, {0: bd, 2: hd}
    rs = ({0: bd, 1: hd}, {0: bd, 1: hd}, {0: bd, 1: hd})
    ins = [(q, r4), (k, r4), (v, r4), (logi, r3), (logf, r3)]
    if state is not None:
        ins += list(zip(state, rs))

    def local(q, k, v, li, lf, *st):
        out, (c, n, m) = fn(q, k, v, li, lf, tuple(st) if st else None)
        return out, c, n, m

    out, c, n, m = shard_call(local, mesh, ins,
                              (placements(mesh, r4),)
                              + tuple(placements(mesh, r) for r in rs))
    return out, (c, n, m)


def selective_scan(fn, dt, a, bmat, cmat, u, h0=None):
    """``fn`` (the selective scan) on each rank's (batch, channels) shard:
    (y (B, S, D), h_last (B, D, N))."""
    mesh = u.device_mesh
    bd = dp_names(mesh, u.shape[0])
    cd = _model(mesh, u.shape[2])
    ins = [(dt, {0: bd}), (a, {0: cd}), (bmat, {0: bd}), (cmat, {0: bd}),
           (u, {0: bd, 2: cd})]
    hroles = {0: bd, 1: cd}
    if h0 is not None:
        ins.append((h0, hroles))
    return shard_call(lambda *ts: fn(*ts), mesh, ins,
                      (placements(mesh, {0: bd, 2: cd}),
                       placements(mesh, hroles)))


def slstm_scan(loop, gx, rg, state):
    """``loop(gx, rg, state) -> (hs, (c, h, n, m))``, the sLSTM's recurrence,
    on each rank's batch shard with every channel (its recurrent product
    mixes them all); ``state`` four (B, di) tensors or None.  Plain
    tensors: ``loop`` itself."""
    if not is_dtensor(gx):
        return loop(gx, rg, state)
    mesh = gx.device_mesh
    bd = dp_names(mesh, gx.shape[0])
    r2 = {0: bd}
    ins = [(gx, {0: bd}), (rg, {})]
    if state is not None:
        ins += [(t, r2) for t in state]

    def local(gx, rg, *st):
        hs, st1 = loop(gx, rg, tuple(st) if st else None)
        return (hs,) + tuple(st1)

    outs = shard_call(local, mesh, ins, (placements(mesh, {0: bd}),)
                      + (placements(mesh, r2),) * 4)
    return outs[0], tuple(outs[1:])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_ffn(fn, p: dict, x, cfg, per_row: bool = False):
    """``fn(p, x, cfg, per_row)`` (the MoE FFN) on each rank's tokens (the
    batch over the data-parallel axes) and its share of the experts: whole
    experts over ``model`` where ``model`` divides their count (expert
    parallel, the share ``cfg.expert_offset``/``experts_held`` names),
    else every expert's hidden width over ``model`` (w_gate, w_in by
    columns, w_out by rows).  Each rank's output is what its share adds,
    summed over ``model``; the aux loss, a mean over token groups, is each
    data-parallel rank's mean over its groups, averaged over those ranks
    (each ``model`` rank's copy a 1/model share, so that the router's
    gradient, a sum of the shares', counts it once)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    sizes = _sizes(mesh)
    m = sizes.get("model", 1)
    bd = dp_names(mesh, x.shape[0])
    held = p["w_gate"].shape[0]
    ep = m > 1 and held % m == 0
    ff_dim = {"w_gate": 2, "w_in": 2, "w_out": 1}
    wroles = {k: ({0: ["model"]} if ep else {ff_dim[k]: ["model"]})
              for k in ff_dim}
    copies = math.prod(sizes[a] for a in bd) * m
    names = ("router", "w_gate", "w_in", "w_out")

    def local(x, *ws):
        share = cfg
        if ep:
            coord = mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]
            share = cfg.replace(experts_held=held // m,
                                expert_offset=cfg.expert_offset
                                + coord * held // m)
        out, aux = fn(dict(zip(names, ws)), x, share, per_row)
        return out, aux / copies

    out_pl = tuple(Shard(0) if n in bd else Partial() if n == "model"
                   else Replicate() for n in mesh.mesh_dim_names)
    aux_pl = tuple(Partial() if n in bd or n == "model" else Replicate()
                   for n in mesh.mesh_dim_names)
    return shard_call(local, mesh, [(x, {0: bd}), (p["router"], {})]
                      + [(p[k], wroles[k]) for k in names[1:]],
                      (out_pl, aux_pl), shares=mesh.mesh_dim_names)
