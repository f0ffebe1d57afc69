"""xLSTM blocks (Beck et al. 2024) — the port of ``repro/models/xlstm.py``:
mLSTM (matrix memory; a stabilised parallel form for a whole sequence, an
O(d^2)-per-head recurrent step for decode) and sLSTM (scalar memory; its
gates read the previous hidden state, so a sequence runs step by step).
The stabiliser states ``m`` are kept exactly as the reference keeps them.

On a mesh (``ax``, a ``ModelAxis``) each rank runs its share:

* mLSTM: ``wq``/``wk``/``wv`` split on heads give each rank its heads
  (the replicated ``w_if`` read on them, its gradient partial), whose
  outputs are its block of ``D``, where ``wo_gate``'s columns and
  ``w_out``'s rows lie.  Where the heads do not divide the axis ``wq`` is
  split on head_dim instead: its block of ``q`` is gathered and the cell
  runs whole on every rank, ``wo_gate`` and ``w_out`` still split on
  ``D``.
* sLSTM: ``w_in`` and ``r`` are split on their ``4 hd`` gate columns, so
  a rank holds a part of every head's z, i, f and o.  Each rank computes
  its columns of every step's gate pre-activations (input plus
  recurrence from the whole hidden state) and the pre-activations are
  gathered, one ``[B, H, 4 hd]`` activation a step; the cell then runs
  whole on every rank and ``w_out`` is row-parallel.  No leaf moves.

In decode each rank keeps its blocks of the recurrent states and gathers
them whole for a step (activations, a few KB a row); no leaf moves.
"""

from __future__ import annotations

import math
from typing import Optional

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


def mlstm_train(p, x, ax=None, places=None, sp: bool = False):
    """Stabilised parallel mLSTM.  x: [B, S, D].  With ``ax`` (and the
    leaves' ``places``) ``x`` is the block's norm output and each rank
    runs its share (see the module docstring)."""
    if ax is not None:
        return _mlstm_on_axis(p, x, ax, places, sp)
    dt = x.dtype
    q, k, v = (_heads(x, p[n]) for n in ("wq", "wk", "wv"))
    h = _mlstm_cell(q, k, v, _heads(x, p["w_if"]))
    o = torch.sigmoid(torch.matmul(x, p["wo_gate"].to(dt)).float())
    h = (h * o).to(dt)
    return torch.matmul(h, p["w_out"].to(dt))


def _mlstm_cell(q, k, v, gates):
    """The parallel form over heads ``[B, S, h, hd]`` -> ``[B, S, h * hd]``
    (f32)."""
    B, S = q.shape[:2]
    log_i = _log_sigmoid(gates[..., 0])
    log_f = _log_sigmoid(gates[..., 1])

    hd = q.shape[-1]
    Fc = torch.cumsum(log_f, dim=1)                     # [B,S,H]
    # D[t,s] = exp(F_t - F_s + log_i_s) for s <= t (log-space, stabilised)
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    logD = logD.masked_fill(~mask, -math.inf)            # [B,t,s,H]
    m = torch.amax(logD, dim=2, keepdim=True)           # stabiliser
    Dmat = torch.exp(logD - m)

    scores = torch.einsum("bthk,bshk->btsh", q, k) / math.sqrt(hd)
    w = scores * Dmat
    num = torch.einsum("btsh,bshk->bthk", w, v)
    den = torch.maximum(torch.abs(torch.sum(w, dim=2)),
                        torch.exp(-m[:, :, 0, :]))
    h = num / den[..., None]                            # [B,S,H,hd]
    return h.reshape(B, S, -1)


def _mlstm_split(p, ax, places) -> Optional[int]:
    """``wq``'s split dim (1: heads, 2: head_dim, None: whole), checked
    against the other leaves."""
    qd = ax.dim(places["wq"])
    kd = ax.dim(places["wk"])
    od = (ax.dim(places["wo_gate"]), ax.dim(places["w_out"]))
    if (qd is None) != (od == (None, None)) or od not in ((None, None),
                                                          (1, 0)) or \
            (kd is not None and (kd, qd) != (1, 1)):
        raise ValueError(f"mlstm leaves wq/wk/wo_gate/w_out placed "
                         f"{places['wq']}/{places['wk']}/"
                         f"{places['wo_gate']}/{places['w_out']} on {ax}")
    return qd


def _mlstm_on_heads(ax, places, qd) -> bool:
    """Whether each rank runs the cell on its own heads (``wq`` and
    ``wk`` split on heads)."""
    return qd == 1 and ax.dim(places["wk"]) == 1


def mlstm_partial_leaves(p, ax, places) -> frozenset:
    """The replicated leaves whose gradient is partial on this rank:
    ``w_if``, read on this rank's heads."""
    qd = _mlstm_split(p, ax, places)
    return frozenset({"w_if"} if _mlstm_on_heads(ax, places, qd) else ())


def _mlstm_on_axis(p, x, ax, places, sp):
    dt = x.dtype
    hp, hr = ax.enter(x, sp)
    qd = _mlstm_split(p, ax, places)
    if qd is None:
        return ax.leave_whole(mlstm_train(p, hr), sp)
    if _mlstm_on_heads(ax, places, qd):             # this rank's heads
        h0, nh = ax.block(p["wq"].shape[1] * ax.size)
        q, k, v = (_heads(hp, p[n]) for n in ("wq", "wk", "wv"))
        h = _mlstm_cell(q, k, v, _heads(hp, p["w_if"][:, h0:h0 + nh]))
    else:                              # the cell whole on every rank
        q = ax.gather(_heads(hp, p["wq"]), qd + 1)
        k, v = (_heads(hr, p[n]) for n in ("wk", "wv"))
        h = ax.scatter(_mlstm_cell(q, k, v, _heads(hr, p["w_if"])), -1)
    o = torch.sigmoid(torch.matmul(hp, p["wo_gate"].to(dt)).float())
    return ax.leave(torch.matmul((h * o).to(dt), p["w_out"].to(dt)), sp)


def mlstm_init_state(p, batch: int, dtype=torch.float32, device=None):
    D, H, hd = p["wq"].shape
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "m": torch.full((batch, H), -1e30, dtype=dtype, device=device),
    }


def mlstm_decode(p, x, state, ax=None, places=None, state_places=None):
    """O(d^2) recurrent step.  x: [B, 1, D]; returns ``(out, new_state)``.
    With ``ax`` the state is this rank's block (``state_places``): the
    step runs on every head from the gathered state, queries, keys and
    values (``wq`` on head_dim: the queries' blocks), and each rank keeps
    its blocks of the new state and its block of ``D`` for ``wo_gate``
    and ``w_out``."""
    if ax is not None:
        qd = _mlstm_split(p, ax, places)
        whole = _whole_state(state, ax, state_places)
        xt = x[:, 0]
        heads = {n: _heads(xt, p[n]) for n in ("wq", "wk", "wv", "w_if")}
        for n in ("wq", "wk", "wv"):
            d = ax.dim(places[n])
            if d is not None:
                heads[n] = ax.gather(heads[n], d)
        h, new = _mlstm_step(heads["wq"], heads["wk"], heads["wv"],
                             heads["w_if"], whole)
        dt = x.dtype
        if qd is None:
            o = torch.sigmoid(torch.matmul(xt, p["wo_gate"].to(dt)).float())
            out = torch.matmul((h * o).to(dt), p["w_out"].to(dt))
        else:
            o = torch.sigmoid(torch.matmul(xt, p["wo_gate"].to(dt)).float())
            out = ax.reduce(torch.matmul((ax.scatter(h, -1) * o).to(dt),
                                         p["w_out"].to(dt)))
        return out[:, None, :], _own_blocks(new, ax, state_places)
    dt = x.dtype
    xt = x[:, 0]
    q, k, v = (_heads(xt, p[n]) for n in ("wq", "wk", "wv"))
    h, new = _mlstm_step(q, k, v, _heads(xt, p["w_if"]), state)
    o = torch.sigmoid(torch.matmul(xt, p["wo_gate"].to(dt)).float())
    h = (h * o).to(dt)
    out = torch.matmul(h, p["w_out"].to(dt))[:, None, :]
    return out, new


def _mlstm_step(q, k, v, gates, state):
    """One step over heads ``[B, H, hd]``: ``(h [B, H * hd] f32, new
    state)``."""
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
    return h.reshape(h.shape[0], -1), {"C": C, "n": n, "m": m_new}


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
    return _slstm_zeros(batch, H, four_hd // 4, dtype, device)


def _slstm_zeros(batch: int, H: int, hd: int, dtype, device):
    return {
        "h": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "c": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "n": torch.ones((batch, H, hd), dtype=dtype, device=device),
        "m": torch.zeros((batch, H), dtype=dtype, device=device),
    }


def _slstm_cell(p, state, u):
    """u: [B, H, 4*hd] pre-activation input for one step."""
    rec = torch.einsum("bhk,hkg->bhg", state["h"], p["r"])
    return _slstm_update(state, u + rec)


def _slstm_update(state, pre):
    """The cell from its gate pre-activations ``[B, H, 4*hd]``."""
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    log_f = _log_sigmoid(f)                              # sigmoid forget
    m_new = torch.maximum(log_f.mean(-1) + state["m"], i.mean(-1))
    i_s = torch.exp(i - m_new[..., None])
    f_s = torch.exp(log_f + (state["m"] - m_new)[..., None])
    c = f_s * state["c"] + i_s * torch.tanh(z)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_split(p, ax, places) -> bool:
    dims = (ax.dim(places["w_in"]), ax.dim(places["r"]),
            ax.dim(places["w_out"]))
    if dims not in ((None, None, None), (2, 2, 0)):
        raise ValueError(f"slstm leaves w_in/r/w_out placed "
                         f"{places['w_in']}/{places['r']}/"
                         f"{places['w_out']} on {ax}")
    return dims[0] is not None


def slstm_train(p, x, ax=None, places=None, sp: bool = False):
    """Sequential recurrence over time.  x: [B, S, D].  With ``ax`` (and
    the leaves' ``places``) ``x`` is the block's norm output and each rank
    computes its gate columns (see the module docstring)."""
    if ax is not None:
        hp, hr = ax.enter(x, sp)
        if not _slstm_split(p, ax, places):
            return ax.leave_whole(slstm_train(p, hr), sp)
        B, S, D = hp.shape
        u = _heads(hp, p["w_in"])                        # [B,S,H,4hd/m]
        state = _slstm_zeros(B, u.shape[2], D // u.shape[2], torch.float32,
                             x.device)
        hs = []
        for t in range(S):
            rec = torch.einsum("bhk,hkg->bhg", ax.copy(state["h"]), p["r"])
            state = _slstm_update(state, ax.gather(u[:, t] + rec, -1))
            hs.append(state["h"])
        h = ax.scatter(torch.stack(hs, dim=1).reshape(B, S, D), -1)
        return ax.leave(torch.matmul(h.to(x.dtype), p["w_out"].to(x.dtype)),
                        sp)
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


def slstm_decode(p, x, state, ax=None, places=None, state_places=None):
    """One step.  x: [B, 1, D]; returns ``(out, new_state)``.  With ``ax``
    the state is this rank's block (``state_places``)."""
    if ax is not None:
        return _slstm_decode_on_axis(p, x, state, ax, places, state_places)
    dt = x.dtype
    new = _slstm_cell(p, state, _heads(x[:, 0], p["w_in"]))
    B, D = x.shape[0], x.shape[2]
    h = new["h"].reshape(B, D).to(dt)
    return torch.matmul(h, p["w_out"].to(dt))[:, None, :], new


def _whole_state(state, ax, state_places):
    """Each state leaf whole: its blocks gathered (a recurrent state is an
    activation, a few KB a row)."""
    return {k: v if ax.dim(state_places[k]) is None
            else ax.gather(v, ax.dim(state_places[k]))
            for k, v in state.items()}


def _own_blocks(state, ax, state_places):
    return {k: v if ax.dim(state_places[k]) is None
            else ax.scatter(v, ax.dim(state_places[k]))
            for k, v in state.items()}


def _slstm_decode_on_axis(p, x, state, ax, places, state_places):
    """The step on this rank's blocks: its gate columns of the
    pre-activations from the whole hidden state, gathered; the cell on
    every head; the new state kept as this rank's blocks; ``w_out``
    row-parallel."""
    dt = x.dtype
    B, D = x.shape[0], x.shape[2]
    whole = _whole_state(state, ax, state_places)
    if _slstm_split(p, ax, places):
        rec = torch.einsum("bhk,hkg->bhg", whole["h"], p["r"])
        pre = ax.gather(_heads(x[:, 0], p["w_in"]) + rec, -1)
        new = _slstm_update(whole, pre)
        h = ax.scatter(new["h"].reshape(B, D), -1).to(dt)
        out = ax.reduce(torch.matmul(h, p["w_out"].to(dt)))
    else:
        new = _slstm_cell(p, whole, _heads(x[:, 0], p["w_in"]))
        out = torch.matmul(new["h"].reshape(B, D).to(dt), p["w_out"].to(dt))
    return out[:, None, :], _own_blocks(new, ax, state_places)
