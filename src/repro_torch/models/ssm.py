"""RWKV6 ("Finch") time-mix and channel-mix blocks (the RWKV half of the
port of ``repro.models.ssm``).

RWKV6's data-dependent per-channel decay ``w_t = exp(-exp(w0 + tanh(x̃_t A)
B))``, the per-head bonus ``u`` and the token-shift interpolation follow the
reference.  In the prefill (:func:`rwkv_forward`) everything but the WKV
recurrence is pointwise in time given the shifted input, so r, k, v, g and
the decay are computed for all T at once; one call of the WKV6 kernel (B.7
on the card, its plain version on the CPU) gives y and the final WKV state;
then come the gate and ``w_o``.  Decode (:func:`rwkv_decode`) is one step
of the same recurrence in plain PyTorch.  Training differentiates the
plain WKV6 version on the CPU; on the card a forward that autograd records
goes through ``WKV6`` (B.7 forward, then B.7's backward kernel).  Mamba
waits for its slice (ROADMAP A.11).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import params as pr
from repro_torch.models.config import ArchConfig
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
    g = F.silu(shift(p["mu_g"]) @ p["w_g"].to(dt))
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
    r = torch.sigmoid(shift(p["mu_r"]) @ p["w_r"].to(dt))
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
