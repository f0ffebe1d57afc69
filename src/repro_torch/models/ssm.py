"""Mamba2 (State Space Duality) block — the port of ``repro/models/ssm.py``:
the chunked parallel form for a whole sequence, the O(1)-state recurrent
step for decode.

Per head h with state size N and head dim P,

    h_t = exp(a_t) * h_{t-1} + dt_t * B_t x_t^T      (a_t < 0)
    y_t = C_t . h_t + D * x_t

The sequence form computes y in chunks: a quadratic attention-like term
inside each chunk plus a recurrence on the chunk-final states.  The
reference runs that recurrence as an associative scan; here it is a loop
over the chunks (the same products, summed in chunk order).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import normal, ones, zeros


def init_mamba2(gen, d_model: int, d_state: int = 64, expand: int = 2,
                head_dim: int = 64, conv_width: int = 4):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    s = 1.0 / math.sqrt(d_model)
    p = {
        "w_z": normal(gen, (d_model, d_inner), s),
        "w_x": normal(gen, (d_model, d_inner), s),
        "w_B": normal(gen, (d_model, d_state), s),
        "w_C": normal(gen, (d_model, d_state), s),
        "w_dt": normal(gen, (d_model, n_heads), s),
        "conv_w": normal(gen, (conv_width, d_inner), 0.2),
    }
    device = "meta" if gen is None else gen.device
    p["a_log"] = torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=device))  # per-head decay
    p["dt_bias"] = zeros(gen, (n_heads,))
    p["d_skip"] = ones(gen, (n_heads,))
    p["w_out"] = normal(gen, (d_inner, d_model), 1.0 / math.sqrt(d_inner))
    p["norm_scale"] = zeros(gen, (d_inner,))
    return p


def _split_proj(p, x):
    """Returns z, xc, B, C, dt — [B,S,d_inner] x2, [B,S,N] x2, [B,S,H]."""
    dt_c = x.dtype
    return tuple(torch.matmul(x, p[name].to(dt_c))
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _causal_conv(p, xc, conv_state=None):
    """Depthwise causal conv along S.  With ``conv_state`` ([B, W-1, d])
    performs the one-step streaming update and returns the new state."""
    W = p["conv_w"].shape[0]
    w = p["conv_w"].to(xc.dtype)
    if conv_state is None:
        pad = F.pad(xc, (0, 0, W - 1, 0))
        out = sum(pad[:, i: i + xc.shape[1], :] * w[i] for i in range(W))
        return F.silu(out), None
    # an f32 state promotes the window (and the product) to f32, as in
    # the reference
    window = torch.cat([conv_state, xc.to(conv_state.dtype)], dim=1)
    out = torch.einsum("bwd,wd->bd", window, w.to(window.dtype))[:, None, :]
    return F.silu(out), window[:, 1:, :]


def _segsum(a):
    """Stable log-space segment sums: out[..., t, s] = sum_{s<r<=t} a_r."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def _gated_norm_out(p, y, z, dt_model):
    """Mamba2's z-gated RMS norm, then the output projection."""
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6)
         * (1.0 + p["norm_scale"])).to(dt_model)
    return torch.matmul(y, p["w_out"].to(dt_model))


def mamba2_train(p, x, chunk: int = 256):
    """x: [B, S, D] -> [B, S, D].  The chunk adapts to divide S."""
    Bsz, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = math.gcd(S, chunk)
    dt_model = x.dtype
    z, xc, Bm, Cm, dt = _split_proj(p, x)
    xc, _ = _causal_conv(p, xc)

    H = p["a_log"].shape[0]
    P = xc.shape[-1] // H
    N = Bm.shape[-1]
    nC = S // chunk

    dt = F.softplus(dt.float() + p["dt_bias"])                   # [B,S,H]
    a = -torch.exp(p["a_log"].float()) * dt                      # [B,S,H]
    xh = xc.float().reshape(Bsz, nC, chunk, H, P)
    Bc = Bm.float().reshape(Bsz, nC, chunk, N)
    Cc = Cm.float().reshape(Bsz, nC, chunk, N)
    ac = a.reshape(Bsz, nC, chunk, H).permute(0, 1, 3, 2)        # [B,c,H,L]
    dtc = dt.reshape(Bsz, nC, chunk, H)

    # 1) intra-chunk (quadratic in chunk)
    L = torch.exp(_segsum(ac))                                   # [B,c,H,L,L]
    y_diag = torch.einsum("bcln,bcsn,bchls,bcsh,bcshp->bclhp",
                          Cc, Bc, L, dtc, xh)

    # 2) chunk-final states
    a_cum = torch.cumsum(ac, dim=-1)                             # [B,c,H,L]
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bcsn,bchs,bcsh,bcshp->bchpn",
                          Bc, decay_to_end, dtc, xh)             # [B,c,H,P,N]

    # 3) cross-chunk recurrence: the state entering chunk c
    chunk_decay = torch.exp(a_cum[..., -1])                      # [B,c,H]
    entering = [torch.zeros_like(states[:, 0])]
    for c in range(nC - 1):
        entering.append(entering[-1] * chunk_decay[:, c, :, None, None]
                        + states[:, c])
    states_in = torch.stack(entering, dim=1)

    # 4) inter-chunk contribution
    state_decay = torch.exp(a_cum)                               # [B,c,H,L]
    y_off = torch.einsum("bcln,bchl,bchpn->bclhp", Cc, state_decay,
                         states_in)

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    y = y + p["d_skip"][None, None, :, None] * xh.reshape(Bsz, S, H, P)
    y = y.reshape(Bsz, S, H * P).to(dt_model)
    return _gated_norm_out(p, y, z, dt_model)


def mamba2_init_state(p, batch: int, dtype=torch.float32, device=None):
    d_inner = p["w_out"].shape[0]
    H = p["a_log"].shape[0]
    P = d_inner // H
    N = p["w_B"].shape[1]
    W = p["conv_w"].shape[0]
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        "conv": torch.zeros((batch, W - 1, d_inner), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p, x, state):
    """One-step recurrence.  x: [B, 1, D]; returns ``(out, new_state)``."""
    dt_model = x.dtype
    z, xc, Bm, Cm, dt = _split_proj(p, x)
    xc, conv_state = _causal_conv(p, xc, state["conv"])

    H = p["a_log"].shape[0]
    P = xc.shape[-1] // H
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])                  # [B,H]
    a = torch.exp(-torch.exp(p["a_log"]) * dt)                        # [B,H]
    xh = xc[:, 0].float().reshape(-1, H, P)
    Bv = Bm[:, 0].float()                                             # [B,N]
    Cv = Cm[:, 0].float()

    h = state["ssm"] * a[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bv)
    y = torch.einsum("bhpn,bn->bhp", h, Cv) + p["d_skip"][None, :, None] * xh
    y = y.reshape(x.shape[0], 1, H * P).to(dt_model)
    return _gated_norm_out(p, y, z, dt_model), {"ssm": h, "conv": conv_state}
