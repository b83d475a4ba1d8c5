"""Mamba-2 (SSD, state-space duality) mixer (port of
``repro.models.mamba2``; arXiv:2405.21060).

Prefill runs the chunked SSD algorithm: the sequence is cut into chunks of
``Q``; inside a chunk the dual quadratic (attention-like) form computes the
local terms, and a short loop over the chunks carries the ``[H, N, P]``
state with each chunk's decay.  Decode is the one-step recurrence ``h = dA
h + dt B x`` on an O(1) state.  The reference leaves these to plain JAX
(no Pallas), so they are plain PyTorch here.

The reference's four-operand intra-chunk einsum is contracted explicitly,
``scores * L * dt`` to ``[B, C, Q, Q, H]`` first and then against ``x``:
a left-to-right pairwise contraction would build a ``[B, C, Q, Q, H, P]``
intermediate (3.2 GB per batch row and chunk at mamba2-780m's widths).
Parameters and the recurrent ``state`` cache keep the reference's dtypes:
``a_log``, ``dt_bias``, ``d_skip`` and the state are float32 in any model
dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def mamba_param_shapes(cfg, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one mixer's parameters, the
    reference's tree: the input projections ``w_xz`` (x and the gate z),
    ``w_bc`` (B and C) and ``w_dt``, the causal conv over ``[x, B, C]``,
    the float32 ``a_log``, ``dt_bias`` and ``d_skip``, the gated norm and
    the output projection."""
    s = cfg.ssm
    d, d_in = cfg.d_model, s.expand * cfg.d_model
    nh, c = d_in // s.head_dim, d_in + 2 * s.d_state
    f32 = torch.float32
    return {"w_xz": ((d, 2 * d_in), dtype), "w_bc": ((d, 2 * s.d_state), dtype),
            "w_dt": ((d, nh), dtype), "conv_w": ((s.conv_width, c), dtype),
            "conv_b": ((c,), dtype), "a_log": ((nh,), f32),
            "dt_bias": ((nh,), f32), "d_skip": ((nh,), f32),
            "gate_norm": ((d_in,), dtype), "w_out": ((d_in, d), dtype)}


def mamba_init_(p, generator: torch.Generator) -> None:
    """Fill one mixer's parameters in place as the reference initialises
    them: projections truncated normal over ``1/sqrt(d_in)``, the conv
    taps over 0.1, ``a_log = log(linspace(1, 16, H))``, ``d_skip`` ones,
    the biases and the gated norm zeros.  The random draws are not the
    reference's ``jax.random`` numbers."""
    for name, t in p.items():
        if name in ("w_xz", "w_bc", "w_dt", "w_out"):
            t.copy_(cm.trunc_normal(generator, t.shape, t.device,
                                    1.0 / math.sqrt(t.shape[0])))
        elif name == "conv_w":
            t.copy_(cm.trunc_normal(generator, t.shape, t.device, 0.1))
        elif name == "a_log":
            t.copy_(torch.log(torch.linspace(1.0, 16.0, t.shape[0])))
        elif name == "d_skip":
            t.fill_(1.0)
        else:                                  # conv_b, dt_bias, gate_norm
            t.zero_()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` without ``F.softplus``'s switch to the identity
    above its threshold (``jax.nn.softplus`` has none)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p, xin: torch.Tensor, cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    x, z = torch.split(xin @ p["w_xz"], [d_in, d_in], dim=-1)
    bmat, cmat = torch.split(xin @ p["w_bc"], [s.d_state, s.d_state], dim=-1)
    dt = xin @ p["w_dt"]
    return x, z, bmat, cmat, dt, d_in, nh


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """Depthwise causal conv1d of width ``K``, then SiLU: ``x [B, S, C]``,
    ``w [K, C]``.  With ``state [B, K-1, C]`` (decode) the conv streams on
    from it; returns ``(out, new_state)``, the state the last ``K-1``
    inputs (None when ``K == 1``)."""
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None \
        else state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_state


def mamba_apply(p, xin: torch.Tensor, cfg, cache=None):
    """One Mamba-2 mixer on ``xin [B, S, d]``.  Prefill (``cache`` None):
    the chunked SSD over the sequence, returns ``(out, None)``.  Decode
    (``S == 1``): ``cache = {"conv": [B, K-1, C], "state": [B, H, P, N]}``,
    returns ``(out, {"conv", "state"})``, the new state in float32."""
    s = cfg.ssm
    b, seq, _ = xin.shape
    x, z, bmat, cmat, dt, d_in, nh = _project(p, xin, cfg)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        None if cache is None else cache["conv"])
    x, bmat, cmat = torch.split(conv_out, [d_in, s.d_state, s.d_state],
                                dim=-1)
    xh = x.reshape(b, seq, nh, s.head_dim)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B, S, H]
    da = torch.exp(dt * -torch.exp(p["a_log"]))                  # decay

    if cache is None:
        y = _ssd_chunked(xh, dt, da, bmat, cmat, s.chunk)
        new_cache = None
    else:
        xd = xh[:, 0] * dt[:, 0, :, None]                        # [B, H, P]
        hb = torch.einsum("bhp,bn->bhpn", xd.float(), bmat[:, 0].float())
        h = cache["state"] * da[:, 0, :, None, None] + hb
        y = torch.einsum("bhpn,bn->bhp", h, cmat[:, 0].float())
        y = y[:, None].to(xin.dtype)
        new_cache = {"conv": new_conv, "state": h}
    y = y.reshape(b, seq, nh, s.head_dim) \
        + (p["d_skip"][:, None] * xh.float()).to(y.dtype)
    y = cm.rms_norm(y.reshape(b, seq, d_in) * F.silu(z), p["gate_norm"])
    return y @ p["w_out"], new_cache


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, da: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, q: int):
    """Chunked SSD scan: ``xh [B, S, H, P]``, ``dt/da [B, S, H]`` (float32),
    ``bmat/cmat [B, S, N]`` → ``y [B, S, H, P]`` in ``xh``'s dtype, float32
    inside.  A length off the chunk multiple pads with ``dt = 0`` and ``da
    = 1`` (the pad adds nothing to any state) and slices the pad away."""
    b, seq, h, p_dim = xh.shape
    n = bmat.shape[-1]
    q = min(q, seq)
    orig_seq = seq
    if seq % q:
        pad = q - seq % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad), value=1.0)
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        seq += pad
    c = seq // q
    xc = xh.reshape(b, c, q, h, p_dim).float()
    dtc = dt.reshape(b, c, q, h)
    dac = da.reshape(b, c, q, h)
    bc = bmat.reshape(b, c, q, n).float()
    cc = cmat.reshape(b, c, q, n).float()

    cum = torch.cumsum(torch.log(torch.clamp(dac, min=1e-30)), dim=2)
    total = cum[:, :, -1]                                        # [B, C, H]

    # intra-chunk (the dual quadratic form): L[i, j] = exp(cum_i - cum_j)
    # for i >= j, masked BEFORE the exp (the i < j exponents are positive
    # and overflow)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # [B,C,Q,Q,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    l_mat = torch.exp(torch.where(mask[None, None, :, :, None], li,
                                  torch.tensor(-1e30, device=xh.device)))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)             # [B,C,Q,Q]
    weights = scores[..., None] * l_mat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", weights, xc)
    del li, l_mat, weights

    # chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j (x) x_j
    wx = (torch.exp(total[:, :, None] - cum) * dtc)[..., None] * xc
    states = torch.einsum("bcjn,bcjhp->bchnp", bc, wx)           # [B,C,H,N,P]

    # the inter-chunk recurrence over the chunk axis
    carry = torch.zeros((b, h, n, p_dim), dtype=torch.float32,
                        device=xh.device)
    prevs = []
    for ci in range(c):
        prevs.append(carry)
        carry = carry * torch.exp(total[:, ci])[:, :, None, None] \
            + states[:, ci]
    s_prevs = torch.stack(prevs, dim=1)                          # [B,C,H,N,P]

    # the inter-chunk term: decay from the chunk's start, contracted with C
    y_inter = torch.einsum("bcin,bchnp->bcihp", cc, s_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, seq, h, p_dim)[:, :orig_seq]
    return y.to(xh.dtype)


def final_state(p, xin: torch.Tensor, cfg) -> dict:
    """The decode cache after prefilling ``xin [B, S, d]`` (the mixer's
    normed input): the last ``K-1`` conv inputs (zero-padded on the left
    when ``S < K-1``) and the whole-sequence SSM state ``sum_j exp(cum_S -
    cum_j) dt_j x_j (x) B_j``, one contraction as the reference's
    ``_recover_rec_state`` does (not the chunk recurrence)."""
    s = cfg.ssm
    b, seqlen, _ = xin.shape
    x, _, bmat, cmat, dt, d_in, nh = _project(p, xin, cfg)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    k1 = s.conv_width - 1
    conv_state = torch.cat(
        [conv_in.new_zeros((b, max(k1 - seqlen, 0), conv_in.shape[-1])),
         conv_in[:, seqlen - min(k1, seqlen):]], dim=1)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    x, bmat, _ = torch.split(conv_out, [d_in, s.d_state, s.d_state], dim=-1)
    xh = x.reshape(b, seqlen, nh, s.head_dim).float()
    dtf = softplus(dt.float() + p["dt_bias"])
    da = torch.exp(dtf * -torch.exp(p["a_log"]))
    cum = torch.cumsum(torch.log(torch.clamp(da, min=1e-30)), dim=1)
    wx = (torch.exp(cum[:, -1:] - cum) * dtf)[..., None] * xh   # [B,S,H,P]
    state = torch.einsum("bjhp,bjn->bhpn", wx, bmat.float())
    return {"conv": conv_state, "state": state}


def mamba_sequential_ref(p, xin: torch.Tensor, cfg) -> torch.Tensor:
    """The step-by-step recurrence the chunked SSD computes (tests only)."""
    s = cfg.ssm
    b, seq, _ = xin.shape
    x, z, bmat, cmat, dt, d_in, nh = _project(p, xin, cfg)
    conv_out, _ = _causal_conv(torch.cat([x, bmat, cmat], dim=-1),
                               p["conv_w"], p["conv_b"])
    x, bmat, cmat = torch.split(conv_out, [d_in, s.d_state, s.d_state],
                                dim=-1)
    xh = x.reshape(b, seq, nh, s.head_dim).float()
    dt = softplus(dt.float() + p["dt_bias"])
    da = torch.exp(dt * -torch.exp(p["a_log"]))
    h = torch.zeros((b, nh, s.head_dim, s.d_state), dtype=torch.float32,
                    device=xin.device)
    ys = []
    for t in range(seq):
        hb = torch.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t, :, None],
                          bmat[:, t].float())
        h = h * da[:, t, :, None, None] + hb
        ys.append(torch.einsum("bhpn,bn->bhp", h, cmat[:, t].float()))
    y = torch.stack(ys, dim=1) + p["d_skip"][:, None] * xh
    y = y.reshape(b, seq, d_in).to(xin.dtype)
    return cm.rms_norm(y * F.silu(z), p["gate_norm"]) @ p["w_out"]
