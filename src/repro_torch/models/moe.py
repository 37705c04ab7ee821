"""Mixture-of-Experts FFN with grouped, capacity-bounded dispatch
(GShard/Switch), holding one device's share of the experts.

Counterpart of ``repro.models.moe`` with its semantics: tokens in groups
of ~``GROUP_TOKENS``; softmax over the router's ``n_experts`` outputs,
top-k, renormalised; capacity ``int(max(1, cf k T_g / E))`` per expert and
group with the published E; each (token, k) assignment's position by a
cumulative count in token-major order; assignments over capacity dropped;
the combine in the activation type; the Switch aux loss.

The experts are stacked ``(E_held, d, ff)`` as the reference stacks its
``(E, d, ff)``, so a share is a slice of the leading axis: this device
holds experts ``[cfg.expert_offset, cfg.expert_offset + cfg.n_held)`` and
adds only what they give to each token; the router stays whole, so every
share routes, counts positions and drops exactly as the whole layer does,
and the shares' outputs sum to the whole layer's.  Where the reference
multiplies one-hot dispatch and combine tensors, the port scatters each
kept assignment's token into its expert's slot, runs the held experts as
one batched product over their ``(groups x capacity)`` slots (every slot,
filled or not, so nothing waits on the host), and gathers the results
back: the same sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spmd
from .layers import dense_init

__all__ = ["GROUP_TOKENS", "init_moe", "moe_ffn", "route"]

GROUP_TOKENS = 2048


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype,
             store: torch.dtype | None = None) -> dict:
    """The router ``(d, E)`` and the held experts' ``w_gate``, ``w_in``
    ``(E_held, d, ff)`` and ``w_out`` ``(E_held, ff, d)``, drawn in
    ``dtype`` one expert at a time and kept in ``store`` (default
    ``dtype``), so a served copy never holds more than one f32 matrix of
    an expert beside it."""
    d, ff, held = cfg.d_model, cfg.d_ff, cfg.n_held

    def experts(shape):
        out = torch.empty((held,) + shape, dtype=store or dtype,
                          device=gen.device)
        for i in range(held):
            out[i] = dense_init(gen, shape, dtype)
        return out

    return {
        "router": dense_init(gen, (d, cfg.n_experts), dtype),
        "w_gate": experts((d, ff)),
        "w_in": experts((d, ff)),
        "w_out": experts((ff, d)),
    }


def _num_groups(t: int) -> int:
    g = max(1, t // GROUP_TOKENS)
    while t % g:
        g -= 1
    return g


def route(logits: torch.Tensor, cfg) -> tuple:
    """The router's decisions for one layer over all ``n_experts``, from
    f32 logits ``(G, Tg, E)``: (probs, renormalised gate values and expert
    ids ``(G, Tg, k)``, each assignment's position in its expert's
    capacity, whether it is kept, the capacity)."""
    _, tg, e = logits.shape
    top_k = max(cfg.top_k, 1)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(max(1, cfg.capacity_factor * top_k * tg / e))
    onehot = F.one_hot(gate_idx, e).reshape(logits.shape[0], tg * top_k, e)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = (pos * onehot).sum(-1).reshape(gate_idx.shape)
    return probs, gate_vals, gate_idx, pos, pos < cap, cap


def moe_ffn(p: dict, x: torch.Tensor, cfg,
            per_row: bool = False) -> tuple:
    """x: (B, S, d) -> (out, aux loss), ``out`` what the held experts add.
    Tokens are grouped over all B x S, as the reference groups them, or,
    with ``per_row``, within each row, as the reference's engine groups
    each lane of its ``vmap``-ped one-lane decode."""
    if spmd.is_dtensor(x):
        return spmd.moe_ffn(moe_ffn, p, x, cfg, per_row)
    b, s, d = x.shape
    e = cfg.n_experts
    g = b * _num_groups(s) if per_row else _num_groups(b * s)
    tg = b * s // g
    xt = x.reshape(g, tg, d)
    logits = (xt @ p["router"].to(x.dtype)).float()
    probs, gate_vals, gate_idx, pos, keep, cap = route(logits, cfg)
    top_k = gate_idx.shape[-1]

    # each kept assignment to a held expert goes to slot (expert, group,
    # position); the others to one spare row past the last slot
    held, off = cfg.n_held, cfg.expert_offset
    local = gate_idx - off
    mine = keep & (local >= 0) & (local < held)
    slots = held * g * cap
    group = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(mine, (local * g + group) * cap + pos,
                       slots).reshape(-1)
    tok = torch.arange(g * tg, device=x.device).repeat_interleave(top_k)
    xf = xt.reshape(g * tg, d)
    xin = x.new_zeros((slots + 1, d))
    xin[slot] = xf[tok]
    h = xin[:slots].reshape(held, g * cap, d)
    gate = F.silu(torch.bmm(h, p["w_gate"].to(x.dtype)))
    hid = torch.bmm(h, p["w_in"].to(x.dtype))
    eo = torch.bmm(gate * hid, p["w_out"].to(x.dtype)).reshape(slots, d)
    eo = torch.cat([eo, eo.new_zeros((1, d))])
    comb = torch.where(mine, gate_vals, 0.0).to(x.dtype).reshape(-1, 1)
    out = torch.zeros((g * tg, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, eo[slot].float() * comb.float())

    # load-balancing aux loss (Switch): E * mean_g sum_e f_e * p_e, the
    # token fractions counted in the activation type as the reference
    # sums its dispatch tensor
    kept = (F.one_hot(gate_idx, e) * keep[..., None]).sum((1, 2))  # (G, E)
    total = kept.sum(-1, keepdim=True)
    frac_tokens = (kept.to(x.dtype)
                   / total.to(x.dtype).clamp_min(1e-9)).float()
    aux = e * torch.mean(torch.sum(frac_tokens * probs.mean(1), dim=-1))
    return out.to(x.dtype).reshape(b, s, d), aux
