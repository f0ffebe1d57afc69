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

On a mesh (``ax``, a ``ModelAxis``) ``w_z``, ``w_x`` and ``conv_w`` are
this rank's blocks of ``d_inner`` (whole heads) and ``w_out`` its rows:
each rank runs its heads.  ``w_B``, ``w_C`` and ``w_dt`` are replicated
(the reference's rule), read whole for ``B``/``C`` and on this rank's
heads for ``dt``; the per-head leaves and the gate norm's scale are read
on this rank's heads (their gradients are partial).  The gate norm's
mean over the whole ``d_inner`` takes one sum over the model axis.  In
decode the recurrent state is updated where its block lies.
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


def _gated_norm_out(p, y, z, dt_model, ax=None):
    """Mamba2's z-gated RMS norm, then the output projection.  With ``ax``
    ``y``/``z`` are this rank's block of ``d_inner``: the mean of squares
    is summed over the model axis."""
    y = y * F.silu(z)
    if ax is None:
        var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    else:
        var = ax.psum(torch.sum(torch.square(y.float()), dim=-1,
                                keepdim=True)) / (y.shape[-1] * ax.size)
    y = (y.float() * torch.rsqrt(var + 1e-6)
         * (1.0 + p["norm_scale"])).to(dt_model)
    return torch.matmul(y, p["w_out"].to(dt_model))


def _heads_of(p, ax, places):
    """``(h0, nh)``: this rank's heads, whose ``d_inner`` columns are its
    block of ``w_x`` (a block that cuts a head raises)."""
    H = p["a_log"].shape[0]
    d_local = p["w_x"].shape[1]
    P = d_local * ax.size // H
    if d_local % P or ax.dim(places["conv_w"]) != 1 or \
            ax.dim(places["w_out"]) != 0:
        raise ValueError(f"mamba2 leaves w_x/conv_w/w_out placed "
                         f"{places['w_x']}/{places['conv_w']}/"
                         f"{places['w_out']} on {ax}: a d_inner block of "
                         f"{d_local} does not hold whole heads of {P}")
    return ax.block(H)


def partial_leaves(p, ax, places) -> frozenset:
    """The replicated leaves whose gradient is partial on this rank: where
    ``d_inner`` splits, every leaf :func:`_local_view` reads whole or on
    this rank's heads."""
    if ax.dim(places["w_x"]) is None:
        return frozenset()
    _heads_of(p, ax, places)
    return frozenset({"w_B", "w_C", "w_dt", "a_log", "dt_bias", "d_skip",
                      "norm_scale"})


def _local_view(p, ax, places):
    """The leaves as this rank's heads read them: its blocks, the
    replicated projections whole (``dt``'s on its heads) and the
    per-head leaves on its heads (see :func:`partial_leaves`)."""
    h0, nh = _heads_of(p, ax, places)
    d0, nd = ax.block(p["norm_scale"].shape[0])
    q = dict(p)
    q["w_dt"] = p["w_dt"][:, h0:h0 + nh]
    for n in ("a_log", "dt_bias", "d_skip"):
        q[n] = p[n][h0:h0 + nh]
    q["norm_scale"] = p["norm_scale"][d0:d0 + nd]
    return q


def mamba2_train(p, x, chunk: int = 256, ax=None, places=None,
                 sp: bool = False):
    """x: [B, S, D] -> [B, S, D].  The chunk adapts to divide S.  With
    ``ax`` (and the leaves' ``places``) ``x`` is the block's norm output
    and each rank runs its heads (see the module docstring)."""
    if ax is not None:
        if ax.dim(places["w_x"]) is None:
            return ax.leave_whole(mamba2_train(p, ax.enter(x, sp)[1],
                                               chunk), sp)
        hp, _ = ax.enter(x, sp)
        return ax.leave(_ssd(_local_view(p, ax, places), hp, chunk, ax), sp)
    return _ssd(p, x, chunk)


def _ssd(p, x, chunk: int, ax=None):
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
    return _gated_norm_out(p, y, z, dt_model, ax)


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


def mamba2_decode(p, x, state, ax=None, places=None, state_places=None):
    """One-step recurrence.  x: [B, 1, D]; returns ``(out, new_state)``.
    With ``ax`` the state is this rank's block (``state_places``): see
    :func:`_decode_on_axis`."""
    if ax is not None:
        return _decode_on_axis(p, x, state, ax, places, state_places)
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


def _decode_on_axis(p, x, state, ax, places, state_places):
    """:func:`mamba2_decode` on this rank's blocks.  The convolution runs
    on its ``d_inner`` block (its state block lies alike); the SSM state
    block ``[B, H, P, N]`` is updated where it lies, from the gathered
    ``x`` of every head (a few KB a token) and the replicated ``B``,
    ``C`` and ``dt``; its output is summed over the state's split dim and
    each rank keeps its heads for the gate norm and its rows of
    ``w_out``."""
    dt_model = x.dtype
    whole = ax.dim(places["w_x"]) is None
    h0, nh = (0, p["a_log"].shape[0]) if whole else \
        _heads_of(p, ax, places)
    H = p["a_log"].shape[0]
    if ax.dim(state_places["conv"]) != (None if whole else 2):
        raise ValueError(f"a mamba2 conv state placed "
                         f"{state_places['conv']} on {ax} does not lie as "
                         f"w_x ({places['w_x']})")
    z, xc = (torch.matmul(x, p[n].to(dt_model)) for n in ("w_z", "w_x"))
    Bm, Cm, dtv = (torch.matmul(x, p[n].to(dt_model))
                   for n in ("w_B", "w_C", "w_dt"))
    xc, conv_state = _causal_conv(p, xc, state["conv"])
    xh = xc[:, 0].float()
    if not whole:
        xh = ax.gather(xh, -1)
    P = xh.shape[-1] // H
    xh = xh.reshape(-1, H, P)                                   # [B,H,P]
    dtv = F.softplus(dtv[:, 0].float() + p["dt_bias"])          # [B,H]
    a = torch.exp(-torch.exp(p["a_log"]) * dtv)
    Bv, Cv = Bm[:, 0].float(), Cm[:, 0].float()                 # [B,N]

    sd = ax.dim(state_places["ssm"])
    sl = [slice(None)] * 4
    if sd is not None:
        b0, nb = ax.block(state["ssm"].shape[sd] * ax.size)
        sl[sd] = slice(b0, b0 + nb)
    hs, ps, ns = sl[1], sl[2], sl[3]
    h = state["ssm"] * a[:, hs, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv[:, hs], xh[:, hs, ps], Bv[:, ns])
    y = torch.einsum("bhpn,bn->bhp", h, Cv[:, ns])       # the block's part
    if sd == 3:                                          # summed over N
        y = ax.reduce(y) if whole else ax.reduce_scatter(y, 1)
    elif sd == 2 or (sd == 1 and (b0, nb) != (h0, nh)):
        y = ax.gather(y, sd)
    if y.shape[1] != nh:
        y = y[:, h0:h0 + nh]
    y = y + p["d_skip"][None, h0:h0 + nh, None] * xh[:, h0:h0 + nh]
    y = y.reshape(x.shape[0], 1, nh * P).to(dt_model)
    if whole:
        return _gated_norm_out(p, y, z, dt_model), \
            {"ssm": h, "conv": conv_state}
    d0, nd = ax.block(p["norm_scale"].shape[0])
    q = dict(p, norm_scale=p["norm_scale"][d0:d0 + nd])
    return ax.reduce(_gated_norm_out(q, y, z, dt_model, ax)), \
        {"ssm": h, "conv": conv_state}
