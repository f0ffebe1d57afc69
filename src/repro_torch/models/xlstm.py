"""xLSTM blocks (Beck et al. 2024) — the port of ``repro/models/xlstm.py``:
mLSTM (matrix memory; a stabilised parallel form for a whole sequence, an
O(d^2)-per-head recurrent step for decode) and sLSTM (scalar memory; its
gates read the previous hidden state, so a sequence runs step by step).
The stabiliser states ``m`` are kept exactly as the reference keeps them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import normal


def _log_sigmoid(g):
    return -F.softplus(-g)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, d_model: int, n_heads: int):
    hd = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)
    return {
        "wq": normal(gen, (d_model, n_heads, hd), s),
        "wk": normal(gen, (d_model, n_heads, hd), s),
        "wv": normal(gen, (d_model, n_heads, hd), s),
        "w_if": normal(gen, (d_model, n_heads, 2), s),
        "wo_gate": normal(gen, (d_model, d_model), s),
        "w_out": normal(gen, (d_model, d_model), s),
    }


def _heads(x, w):
    """x: [..., D], w: [D, H, k] -> [..., H, k] in f32."""
    dt = x.dtype
    y = torch.matmul(x, w.to(dt).flatten(1))
    return y.view(*x.shape[:-1], w.shape[1], w.shape[2]).float()


def mlstm_train(p, x):
    """Stabilised parallel mLSTM.  x: [B, S, D]."""
    B, S, D = x.shape
    dt = x.dtype
    q, k, v = (_heads(x, p[n]) for n in ("wq", "wk", "wv"))
    gates = _heads(x, p["w_if"])
    log_i = _log_sigmoid(gates[..., 0])
    log_f = _log_sigmoid(gates[..., 1])

    hd = q.shape[-1]
    Fc = torch.cumsum(log_f, dim=1)                     # [B,S,H]
    # D[t,s] = exp(F_t - F_s + log_i_s) for s <= t (log-space, stabilised)
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    logD = logD.masked_fill(~mask, -math.inf)            # [B,t,s,H]
    m = torch.amax(logD, dim=2, keepdim=True)           # stabiliser
    Dmat = torch.exp(logD - m)

    scores = torch.einsum("bthk,bshk->btsh", q, k) / math.sqrt(hd)
    w = scores * Dmat
    num = torch.einsum("btsh,bshk->bthk", w, v)
    den = torch.maximum(torch.abs(torch.sum(w, dim=2)),
                        torch.exp(-m[:, :, 0, :]))
    h = num / den[..., None]                            # [B,S,H,hd]

    o = torch.sigmoid(torch.matmul(x, p["wo_gate"].to(dt)).float())
    h = (h.reshape(B, S, D) * o).to(dt)
    return torch.matmul(h, p["w_out"].to(dt))


def mlstm_init_state(p, batch: int, dtype=torch.float32, device=None):
    D, H, hd = p["wq"].shape
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "m": torch.full((batch, H), -1e30, dtype=dtype, device=device),
    }


def mlstm_decode(p, x, state):
    """O(d^2) recurrent step.  x: [B, 1, D]; returns ``(out, new_state)``."""
    B, _, D = x.shape
    dt = x.dtype
    xt = x[:, 0]
    q, k, v = (_heads(xt, p[n]) for n in ("wq", "wk", "wv"))
    gates = _heads(xt, p["w_if"])
    log_i = _log_sigmoid(gates[..., 0])
    log_f = _log_sigmoid(gates[..., 1])

    hd = q.shape[-1]
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    C = state["C"] * f_s[..., None, None] + i_s[..., None, None] * (
        v[..., :, None] * k[..., None, :])              # [B,H,hd,hd]
    n = state["n"] * f_s[..., None] + i_s[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q) / math.sqrt(hd)
    den = torch.maximum(
        torch.abs(torch.einsum("bhk,bhk->bh", n, q)) / math.sqrt(hd),
        torch.exp(-m_new))
    h = num / den[..., None]

    o = torch.sigmoid(torch.matmul(xt, p["wo_gate"].to(dt)).float())
    h = (h.reshape(B, D) * o).to(dt)
    out = torch.matmul(h, p["w_out"].to(dt))[:, None, :]
    return out, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, d_model: int, n_heads: int):
    hd = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)
    return {
        # input weights for [z, i, f, o]
        "w_in": normal(gen, (d_model, n_heads, 4 * hd), s),
        # block-diagonal recurrent weights per head
        "r": normal(gen, (n_heads, hd, 4 * hd), 1.0 / math.sqrt(hd)),
        "w_out": normal(gen, (d_model, d_model), s),
    }


def slstm_init_state(p, batch: int, dtype=torch.float32, device=None):
    D, H, four_hd = p["w_in"].shape
    hd = four_hd // 4
    return {
        "h": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "c": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "n": torch.ones((batch, H, hd), dtype=dtype, device=device),
        "m": torch.zeros((batch, H), dtype=dtype, device=device),
    }


def _slstm_cell(p, state, u):
    """u: [B, H, 4*hd] pre-activation input for one step."""
    rec = torch.einsum("bhk,hkg->bhg", state["h"], p["r"])
    z, i, f, o = torch.chunk(u + rec, 4, dim=-1)
    log_f = _log_sigmoid(f)                              # sigmoid forget
    m_new = torch.maximum(log_f.mean(-1) + state["m"], i.mean(-1))
    i_s = torch.exp(i - m_new[..., None])
    f_s = torch.exp(log_f + (state["m"] - m_new)[..., None])
    c = f_s * state["c"] + i_s * torch.tanh(z)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_train(p, x):
    """Sequential recurrence over time.  x: [B, S, D]."""
    B, S, D = x.shape
    dt = x.dtype
    u = _heads(x, p["w_in"])                             # [B,S,H,4hd]
    state = slstm_init_state(p, B, device=x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, state, u[:, t])
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(dt)
    return torch.matmul(h, p["w_out"].to(dt))


def slstm_decode(p, x, state):
    """One step.  x: [B, 1, D]; returns ``(out, new_state)``."""
    dt = x.dtype
    new = _slstm_cell(p, state, _heads(x[:, 0], p["w_in"]))
    B, D = x.shape[0], x.shape[2]
    h = new["h"].reshape(B, D).to(dt)
    return torch.matmul(h, p["w_out"].to(dt))[:, None, :], new
