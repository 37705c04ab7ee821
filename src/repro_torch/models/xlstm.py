"""xLSTM blocks: mLSTM (matrix memory, chunkwise) and sLSTM (scalar
memory, recurrent).

Counterpart of ``repro.models.xlstm`` with the same parameter tree, gates
and states (arXiv:2405.04517).  A multi-token mLSTM call (prefill) runs the
chunkwise form through ``kernels.mlstm.ops.mlstm``, which launches the
hand-written CUDA kernel on the card and takes its plain version on the
CPU; ``plain=True`` calls the plain version on any device (a check-only
switch; serving never sets it).  Under a gradient (training, from the zero
state) the same call goes through the ``MLSTM`` autograd Function, whose
backward is the hand-written backward kernel on the card
(``kernels.mlstm_bwd``), so xLSTM trains on the card.  One token with a
state is the sequential recurrence, and the sLSTM is a per-token loop, both
plain PyTorch (the sLSTM under autograd), as the reference computes them
outside any Pallas kernel.  Every state is f32.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels.mlstm import ops as mlstm_ops
from ..kernels.mlstm.ref import mlstm_chunkwise_ref
from ..parallel import spmd
from .layers import dense_init, init_rms_norm, rms_norm

__all__ = ["init_mlstm", "mlstm_parallel", "mlstm_chunkwise", "mlstm_block",
           "init_mlstm_state", "init_slstm", "slstm_block",
           "init_slstm_state"]

M_STATE_INIT = -1e9     # the stabiliser of a fresh serving state


def _dims(cfg) -> tuple:
    di = cfg.mamba_expand * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    di, h, _ = _dims(cfg)
    return {
        "up": dense_init(gen, (d, 2 * di), dtype),
        "wq": dense_init(gen, (di, di), dtype),
        "wk": dense_init(gen, (di, di), dtype),
        "wv": dense_init(gen, (di, di), dtype),
        "w_i": dense_init(gen, (di, h), dtype),    # input gate (per head)
        "w_f": dense_init(gen, (di, h), dtype),    # forget gate
        "w_o": dense_init(gen, (di, di), dtype),   # output gate
        "norm": init_rms_norm(di, dtype, gen.device)["scale"],
        "down": dense_init(gen, (di, d), dtype),
    }


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logi: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """Stabilised parallel mLSTM (B, S, H, dh) with per-head log-space
    gates logi/logf (B, S, H): the quadratic form, a test oracle."""
    _, s, _, dh = q.shape
    f_cum = torch.cumsum(logf, dim=1)                      # (B, S, H)
    dmat = (f_cum[:, :, None] - f_cum[:, None, :]
            + logi[:, None, :, :])                         # (B, S, S, H)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = torch.amax(dmat, dim=2, keepdim=True)              # (B, S, 1, H)
    dstab = torch.exp(dmat - m)
    scores = torch.einsum("bthd,buhd->btuh", q, k) * (dh ** -0.5)
    w = scores * dstab
    norm = torch.maximum(torch.abs(w.sum(dim=2)), torch.exp(-m[:, :, 0]))
    out = torch.einsum("btuh,buhd->bthd", w, v)
    return out / (norm[..., None] + 1e-6)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logi: torch.Tensor, logf: torch.Tensor,
                    state: tuple | None = None,
                    plain: bool = False) -> tuple:
    """Chunkwise mLSTM (the reference's chunk, 256) with a state in and
    out: (out (B, S, H, dh) f32, (C, n, m)).  The kernel on a CUDA tensor,
    the plain version on a CPU tensor or under ``plain=True``."""
    fn = mlstm_chunkwise_ref if plain else mlstm_ops.mlstm
    return fn(q, k, v, logi, logf, state)


def mlstm_block(p: dict, x: torch.Tensor, cfg, state: tuple | None = None,
                plain: bool = False) -> tuple:
    """state = (C (B, H, dh, dh), n (B, H, dh), m (B, H)) for serving.
    Returns (out, new state or None)."""
    b, s, _ = x.shape
    di, h, dh = _dims(cfg)
    u, z = torch.chunk(x @ p["up"].to(x.dtype), 2, dim=-1)
    q = spmd.split_last(u @ p["wq"].to(x.dtype), h, dh)
    k = spmd.split_last(u @ p["wk"].to(x.dtype), h, dh)
    v = spmd.split_last(u @ p["wv"].to(x.dtype), h, dh)
    logi = (u @ p["w_i"].to(x.dtype)).float()                      # (B,S,H)
    logf = spmd.pointwise(F.logsigmoid, (u @ p["w_f"].to(x.dtype)).float())

    new_state = None
    if state is not None and s == 1:
        # one-step recurrence; the state holds the unscaled-k accumulation
        # and the 1/sqrt(dh) scale sits on q, as in the chunkwise form, so
        # prefill and decode compose
        c0, n0, m0 = state
        qf = q[:, 0].float() * (dh ** -0.5)
        kf = k[:, 0].float()
        vf = v[:, 0].float()
        m1 = torch.maximum(logf[:, 0] + m0.float(), logi[:, 0])
        f_s = torch.exp(logf[:, 0] + m0 - m1)
        i_s = torch.exp(logi[:, 0] - m1)
        c1 = (f_s[..., None, None] * c0.float()
              + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", kf, vf))
        n1 = f_s[..., None] * n0.float() + i_s[..., None] * kf
        num = torch.einsum("bhd,bhde->bhe", qf, c1)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n1)),
                            torch.exp(-m1))
        o = (num / (den[..., None] + 1e-6))[:, None]               # (B,1,H,dh)
        new_state = (c1.to(c0.dtype), n1.to(n0.dtype), m1)
    elif state is not None:
        # prefill: chunkwise with the carried state
        o, (c1, n1, m1) = mlstm_chunkwise(q.float(), k.float(), v.float(),
                                          logi, logf, state, plain)
        new_state = (c1.to(state[0].dtype), n1.to(state[1].dtype), m1)
    else:
        o, _ = mlstm_chunkwise(q.float(), k.float(), v.float(), logi, logf,
                               plain=plain)
    og = torch.sigmoid(u @ p["w_o"].to(x.dtype))
    y = rms_norm(spmd.merge_last(o).to(x.dtype), p["norm"], cfg.norm_eps)
    y = y * og * F.silu(z)
    return y @ p["down"].to(x.dtype), new_state


def init_mlstm_state(cfg, batch: int, device,
                     dtype: torch.dtype = torch.float32) -> tuple:
    _, h, dh = _dims(cfg)
    return (torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
            torch.zeros((batch, h, dh), dtype=dtype, device=device),
            torch.full((batch, h), M_STATE_INIT, dtype=torch.float32,
                       device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    di, _, _ = _dims(cfg)
    return {
        "up": dense_init(gen, (d, 2 * di), dtype),
        "w_gates": dense_init(gen, (di, 4 * di), dtype),   # i, f, z, o
        "r_gates": dense_init(gen, (di, 4 * di), dtype),   # recurrent
        "norm": init_rms_norm(di, dtype, gen.device)["scale"],
        "down": dense_init(gen, (di, d), dtype),
    }


def slstm_block(p: dict, x: torch.Tensor, cfg,
                state: tuple | None = None) -> tuple:
    """Scalar-memory LSTM with recurrent gate mixing, a loop over time.
    state = (c (B, di), h (B, di), n (B, di), m (B, di)).  The input half
    of every step's gates, ``u_t @ w_gates``, is one product for all steps
    ahead of the loop (the reference computes it inside its scan)."""
    u, z_out = torch.chunk(x @ p["up"].to(x.dtype), 2, dim=-1)
    gx = u.float() @ p["w_gates"].float()              # (B, S, 4 di)
    rg = p["r_gates"].float()
    st = None if state is None else tuple(t.float() for t in state)
    hs, (c, hprev, n, m) = spmd.slstm_scan(
        functools.partial(_slstm_loop, cfg=cfg), gx, rg, st)
    hs = hs.to(x.dtype)                                  # (B, S, di)
    y = rms_norm(hs, p["norm"], cfg.norm_eps) * F.silu(z_out)
    out = y @ p["down"].to(x.dtype)
    new_state = (c, hprev, n, m) if state is not None else None
    return out, new_state


def _slstm_loop(gx: torch.Tensor, rg: torch.Tensor, state, cfg) -> tuple:
    """The sLSTM's recurrence over the input gates ``gx`` (B, S, 4 di) with
    the recurrent gates ``rg`` (di, 4 di), f32, from ``state`` (c, h, n, m)
    or a fresh one: (the hidden states (B, S, di), the final state)."""
    b, s = gx.shape[:2]
    c, hprev, n, m = (init_slstm_state(cfg, b, gx.device) if state is None
                      else state)
    hs = []
    for t in range(s):
        g = gx[:, t] + hprev @ rg
        gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
        logf = F.logsigmoid(gf)
        m1 = torch.maximum(logf + m, gi)
        i_s = torch.exp(gi - m1)
        f_s = torch.exp(logf + m - m1)
        c = f_s * c + i_s * torch.tanh(gz)
        n = f_s * n + i_s
        hprev = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m1
        hs.append(hprev)
    return torch.stack(hs, dim=1), (c, hprev, n, m)


def init_slstm_state(cfg, batch: int, device,
                     dtype: torch.dtype = torch.float32) -> tuple:
    di, _, _ = _dims(cfg)
    z = torch.zeros((batch, di), dtype=dtype, device=device)
    return (z, z.clone(), z.clone(),
            torch.full((batch, di), M_STATE_INIT, dtype=torch.float32,
                       device=device))
