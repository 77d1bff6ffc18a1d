"""Plain PyTorch version of the WKV6 kernel: a loop over time.

The recurrence of the reference's oracle
``repro/kernels/rwkv6_scan/ref.py::wkv6_ref`` in float32,

    y_t = r_tᵀ (S + u ⊙ k_t v_tᵀ),    S ← diag(w_t) S + k_t v_tᵀ,

from ``s0`` (zero when None), returning the final S beside y, as
``repro/models/ssm.py::rwkv_forward`` does.  The CPU path of the port and
the tests use it; on the card it serves only as the kernel's yardstick.
"""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) or None.

    Returns (y (B, H, T, hd) in r's dtype, final S (B, H, hd, hd) float32).
    """
    b, h, t, hd = r.shape
    f32 = torch.float32
    s = (torch.zeros((b, h, hd, hd), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    uk = u.to(f32)[None, :, :, None]
    ys = []
    for i in range(t):
        rt, kt, vt, wt = (x[:, :, i].to(f32) for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]                      # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + uk * kv))
        s = wt[..., :, None] * s + kv
    y = torch.stack(ys, dim=2) if ys else torch.zeros_like(r, dtype=f32)
    return y.to(r.dtype), s


def wkv6_bwd_ref(r, k, v, w, u, dy, s0=None, ds=None):
    """The backward of :func:`wkv6_ref` as an explicit reverse loop (the
    plain version of B.7's backward kernel; no autograd).

    r, k, v, w, dy: (B, H, T, hd); u: (H, hd); s0, ds (the cotangent of the
    final state): (B, H, hd, hd) or None (zero).  With S_t the state before
    step t and G the adjoint of the state after it (G = ds after the last
    step), per step t from the last:

        dr_t = (S_t + u ⊙ k_t v_tᵀ) dy_t
        dk_t = G v_t + u ⊙ r_t (dy_t · v_t)
        dv_t = Gᵀ k_t + (Σ_i r_t[i] u[i] k_t[i]) dy_t
        dw_t[i] = Σ_j G[i, j] S_t[i, j]
        du += Σ_b r_t ⊙ k_t (dy_t · v_t)
        G ← diag(w_t) G + r_t dy_tᵀ

    and ds0 = G at the end.  Returns (dr, dk, dv, dw in r's shape, du (H,
    hd), ds0 (B, H, hd, hd), or None when s0 is None), float32.
    """
    b, h, t, hd = r.shape
    f32 = torch.float32
    r, k, v, w, dy = (x.to(f32) for x in (r, k, v, w, dy))
    uf = u.to(f32)
    s = (torch.zeros((b, h, hd, hd), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    states = []  # S_t, the state before step t
    for i in range(t):
        states.append(s)
        s = w[:, :, i, :, None] * s + k[:, :, i, :, None] * v[:, :, i, None, :]
    g = (torch.zeros((b, h, hd, hd), dtype=f32, device=r.device) if ds is None
         else ds.to(f32).clone())
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros((h, hd), dtype=f32, device=r.device)
    for i in reversed(range(t)):
        rt, kt, vt, wt, dyt = (x[:, :, i] for x in (r, k, v, w, dy))
        vdy = (vt * dyt).sum(-1, keepdim=True)                           # (B, H, 1)
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        dr[:, :, i] = torch.einsum("bhij,bhj->bhi", states[i], dyt) + uf * kt * vdy
        dk[:, :, i] = torch.einsum("bhij,bhj->bhi", g, vt) + uf * rt * vdy
        dv[:, :, i] = torch.einsum("bhij,bhi->bhj", g, kt) + bonus * dyt
        dw[:, :, i] = (g * states[i]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, None if s0 is None else g
