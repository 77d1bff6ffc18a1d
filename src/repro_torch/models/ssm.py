"""RWKV6 ("Finch") time-mix and channel-mix blocks and the Mamba selective
SSM of Jamba (the port of ``repro.models.ssm``).

RWKV6's data-dependent per-channel decay ``w_t = exp(-exp(w0 + tanh(x̃_t A)
B))``, the per-head bonus ``u`` and the token-shift interpolation follow the
reference.  In the prefill (:func:`rwkv_forward`) everything but the WKV
recurrence is pointwise in time given the shifted input, so r, k, v, g and
the decay are computed for all T at once; one call of the WKV6 kernel (B.7
on the card, its plain version on the CPU) gives y and the final WKV state;
then come the gate and ``w_o``.  Decode (:func:`rwkv_decode`) is one step
of the same recurrence in plain PyTorch.  Training differentiates the
plain WKV6 version on the CPU; on the card a forward that autograd records
goes through ``WKV6`` (B.7 forward, then B.7's backward kernel).

Mamba (:func:`mamba_forward`) is the reference's: the input projection, a
depthwise causal conv whose state carries the last ``d_conv − 1`` inputs,
and the selective scan in float32 with ``dt = softplus(dt_low·dt_proj +
dt_bias)`` and ``a = −exp(a_log)``, a Python loop over time in plain
PyTorch (the reference scans it in plain JAX, outside any Pallas kernel).
Decode is the forward at S = 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import params as pr
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import sigmoid, silu
from repro_torch.utils.tree import subtree

_RWKV_LORA = 64


def rwkv_decl(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    ff = cfg.d_ff
    return {
        "time": {
            # token-shift interpolation weights per stream
            "mu_r": pr.constant((d,), ("embed",), 0.5),
            "mu_k": pr.constant((d,), ("embed",), 0.5),
            "mu_v": pr.constant((d,), ("embed",), 0.5),
            "mu_w": pr.constant((d,), ("embed",), 0.5),
            "mu_g": pr.constant((d,), ("embed",), 0.5),
            "w_r": pr.normal((d, d), ("embed", "hidden"), fan_in=d),
            "w_k": pr.normal((d, d), ("embed", "hidden"), fan_in=d),
            "w_v": pr.normal((d, d), ("embed", "hidden"), fan_in=d),
            "w_g": pr.normal((d, d), ("embed", "hidden"), fan_in=d),
            "w_o": pr.normal((d, d), ("hidden", "embed"), fan_in=d),
            # data-dependent decay: w0 + tanh(x A) B   (low-rank modulation)
            "decay_base": pr.constant((d,), ("embed",), -6.0),
            "decay_a": pr.normal((d, _RWKV_LORA), ("embed", None), fan_in=d),
            "decay_b": pr.normal((_RWKV_LORA, d), (None, "embed"), fan_in=_RWKV_LORA),
            "bonus": pr.zeros((h, hd), (None, None)),
        },
        "chan": {
            "mu_k": pr.constant((d,), ("embed",), 0.5),
            "mu_r": pr.constant((d,), ("embed",), 0.5),
            "w_k": pr.normal((d, ff), ("embed", "mlp"), fan_in=d),
            "w_v": pr.normal((ff, d), ("mlp", "embed"), fan_in=ff),
            "w_r": pr.normal((d, d), ("embed", "hidden"), fan_in=d),
        },
    }


def rwkv_init_state(cfg: ArchConfig, batch: int, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = cfg.compute_dtype
    return {
        "x_time": torch.zeros((batch, d), dtype=dt, device=device),  # prev token (time-mix)
        "x_chan": torch.zeros((batch, d), dtype=dt, device=device),  # prev token (chan-mix)
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
    }


def _time_inputs(p, x, x_prev, cfg: ArchConfig):
    """r, k, v, g and the decay w of the time-mix, pointwise in time.
    x, x_prev: (..., d).  Returns r, k, v in the compute dtype, g (silu
    applied) and w (float32, in (0, 1))."""
    dt = cfg.compute_dtype

    def shift(mu):
        return x_prev + (x - x_prev) * mu.to(x.dtype)

    r = shift(p["mu_r"]) @ p["w_r"].to(dt)
    k = shift(p["mu_k"]) @ p["w_k"].to(dt)
    v = shift(p["mu_v"]) @ p["w_v"].to(dt)
    g = silu(shift(p["mu_g"]) @ p["w_g"].to(dt))
    # data-dependent decay (the RWKV6 novelty)
    wx = shift(p["mu_w"]).float()
    wmod = torch.tanh(wx @ p["decay_a"].float()) @ p["decay_b"].float()
    w = torch.exp(-torch.exp(p["decay_base"].float() + wmod))
    return r, k, v, g, w


def _rwkv_time_step(p, x_t, x_prev, s, cfg: ArchConfig):
    """One token of RWKV6 time-mix. x_t, x_prev: (B, d); s: (B, H, hd, hd)."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = cfg.compute_dtype
    f32 = torch.float32
    r, k, v, g, w = _time_inputs(p, x_t, x_prev, cfg)
    rh = r.reshape(-1, h, hd).to(f32)
    kh = k.reshape(-1, h, hd).to(f32)
    vh = v.reshape(-1, h, hd).to(f32)
    wh = w.reshape(-1, h, hd)
    u = p["bonus"].to(f32)

    kv = kh[..., :, None] * vh[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rh, s + u[None, :, :, None] * kv)
    s_new = wh[..., None] * s + kv
    out = (out.reshape(-1, d) * g.to(f32)).to(dt)
    return out @ p["w_o"].to(dt), s_new


def _rwkv_chan_step(p, x_t, x_prev, cfg: ArchConfig):
    dt = cfg.compute_dtype

    def shift(mu):
        return x_prev + (x_t - x_prev) * mu.to(x_t.dtype)

    k = shift(p["mu_k"]) @ p["w_k"].to(dt)
    v = torch.square(F.relu(k)) @ p["w_v"].to(dt)
    r = sigmoid(shift(p["mu_r"]) @ p["w_r"].to(dt))
    return r * v


def rwkv_forward(p, x, cfg: ArchConfig, state=None):
    """Full-sequence RWKV6 block (time-mix + channel-mix with residuals).

    p: the block's leaves (``"time/w_r"``, ``"chan/w_k"``, ...); x: (B, S, D).
    Returns (y, final_state).  The WKV recurrence is one kernel call.
    """
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    s0 = None if state is None else state["wkv"].contiguous()
    if state is None:
        state = rwkv_init_state(cfg, b, x.device)
    pt, pc = subtree(p, "time"), subtree(p, "chan")

    # --- time mix
    x_prev = torch.cat([state["x_time"][:, None], x[:, :-1]], dim=1)
    r, k, v, g, w = _time_inputs(pt, x, x_prev, cfg)

    def heads(z):  # (B, S, D) -> a (B, H, S, hd) view
        return z.float().reshape(b, s, h, hd).permute(0, 2, 1, 3)

    y, wkv = wkv_ops.wkv6(heads(r), heads(k), heads(v), heads(w),
                          pt["bonus"].float().contiguous(), s0)
    out = (y.permute(0, 2, 1, 3).reshape(b, s, d) * g.float()).to(cfg.compute_dtype)
    t_out = out @ pt["w_o"].to(cfg.compute_dtype)
    x = x + t_out

    # --- channel mix (pointwise given shifted input)
    xc_prev = torch.cat([state["x_chan"][:, None], x[:, :-1]], dim=1)
    y = x + _rwkv_chan_step(pc, x, xc_prev, cfg)
    new_state = {
        "x_time": x[:, -1] - t_out[:, -1],  # pre-timemix input
        "x_chan": x[:, -1],
        "wkv": wkv,
    }
    return y, new_state


def rwkv_decode(p, x, cfg: ArchConfig, state):
    """Single-token step. x: (B, 1, D).  Returns (y (B, 1, D), new state)."""
    xt = x[:, 0]
    out, s_new = _rwkv_time_step(subtree(p, "time"), xt, state["x_time"], state["wkv"], cfg)
    x1 = xt + out
    c = _rwkv_chan_step(subtree(p, "chan"), x1, state["x_chan"], cfg)
    y = x1 + c
    return y[:, None], {"x_time": xt, "x_chan": x1, "wkv": s_new}


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — the recurrent half of Jamba
# ---------------------------------------------------------------------------

def mamba_decl(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dtr = cfg.mamba_dt_rank or max(1, (d + 15) // 16)
    return {
        "in_proj": pr.normal((d, 2 * di), ("embed", "hidden"), fan_in=d),
        "conv_w": pr.normal((di, dc), ("hidden", None), fan_in=dc),
        "conv_b": pr.zeros((di,), ("hidden",)),
        "x_proj": pr.normal((di, dtr + 2 * ds), ("hidden", None), fan_in=di),
        "dt_proj": pr.normal((dtr, di), (None, "hidden"), fan_in=dtr),
        "dt_bias": pr.zeros((di,), ("hidden",)),
        "a_log": pr.constant((di, ds), ("hidden", "state"), 0.0),
        "d_skip": pr.ones((di,), ("hidden",)),
        "out_proj": pr.normal((di, d), ("hidden", "embed"), fan_in=di),
    }


def mamba_init_state(cfg: ArchConfig, batch: int, device) -> dict:
    """The zero state: the last ``d_conv − 1`` conv inputs (B, d_conv − 1,
    d_inner) and the SSM state (B, d_inner, d_state) in float32."""
    di = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=cfg.compute_dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state), dtype=torch.float32, device=device),
    }


def _mamba_ssm_scan(p, u, cfg: ArchConfig, h0):
    """Selective scan in float32, a Python loop over time.  u: (B, S, di)
    post-conv activations.  Returns (y (B, S, di) float32, h_T)."""
    ds = cfg.mamba_d_state
    dtr = p["dt_proj"].shape[0]
    u32 = u.float()
    proj = u32 @ p["x_proj"].float()
    dt_low, bmat, cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"].float() + p["dt_bias"].float())  # (B, S, di)
    a = -torch.exp(p["a_log"].float())                                     # (di, ds)
    h, ys = h0, []
    for t in range(u.shape[1]):
        dt_t = dt[:, t, :, None]                                           # (B, di, 1)
        da = torch.exp(dt_t * a)                                           # (B, di, ds)
        dbu = dt_t * bmat[:, t, None, :] * u32[:, t, :, None]
        h = da * h + dbu
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1) + u32 * p["d_skip"].float()
    return y, h


def _causal_conv(p, x, cfg: ArchConfig, conv_state=None):
    """Depthwise causal conv1d. x: (B, S, di).  Returns (out, the last
    ``d_conv − 1`` inputs)."""
    dc = cfg.mamba_d_conv
    if conv_state is None:
        pad = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                                        # (B, S+dc-1, di)
    w = p["conv_w"].to(x.dtype)                                            # (di, dc)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[:, i] for i in range(dc)) + p["conv_b"].to(x.dtype)
    return out, xp[:, -(dc - 1):]


def mamba_forward(p, x, cfg: ArchConfig, state=None):
    """x: (B, S, D) -> (y (B, S, D), state).  ``state`` None starts from
    zeros."""
    if state is None:
        state = mamba_init_state(cfg, x.shape[0], x.device)
    dt_ = cfg.compute_dtype
    di = cfg.mamba_expand * cfg.d_model
    xz = x.to(dt_) @ p["in_proj"].to(dt_)
    u, z = torch.split(xz, [di, di], dim=-1)
    u, conv_state = _causal_conv(p, u, cfg, state["conv"])
    u = silu(u)
    y, ssm_state = _mamba_ssm_scan(p, u, cfg, state["ssm"])
    y = y.to(dt_) * silu(z)
    out = y @ p["out_proj"].to(dt_)
    return out.to(x.dtype), {"conv": conv_state, "ssm": ssm_state}


def mamba_decode(p, x, cfg: ArchConfig, state):
    """Single token: the forward at S = 1 (the conv state carries the
    history)."""
    return mamba_forward(p, x, cfg, state)


def recurrent_init_state(cfg: ArchConfig, blk: str, batch: int, device) -> dict:
    """The zero state of a recurrent (``mamba`` or ``rwkv``) layer."""
    if blk == "mamba":
        return mamba_init_state(cfg, batch, device)
    if blk == "rwkv":
        return rwkv_init_state(cfg, batch, device)
    raise ValueError(blk)
