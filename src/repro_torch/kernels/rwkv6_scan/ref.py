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
