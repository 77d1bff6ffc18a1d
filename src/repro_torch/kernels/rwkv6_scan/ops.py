"""The WKV6 function the rest of the port calls.

``wkv6`` takes the plain PyTorch version only for tensors on the CPU, and
counts those calls in ``.plain_calls``; autograd differentiates it there.
For CUDA tensors it launches the hand-written kernel (B.7) or raises —
there is no fallback.  B.7 has no backward yet, so on the card a call that
autograd would record raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import kernel as _k
from repro_torch.kernels.rwkv6_scan import ref as _r


def wkv6(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) or None.

    Returns (y (B, H, T, hd), final state (B, H, hd, hd) float32).
    """
    if _build.route("wkv6", r):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
            raise NotImplementedError(
                "wkv6: B.7 has no backward yet, so RWKV trains on the CPU only; the "
                "B.7 backward comes with the RWKV training slice (ROADMAP)")
        return _k.wkv6_scan(r, k, v, w, u, s0)
    wkv6.plain_calls += 1
    return _r.wkv6_ref(r, k, v, w, u, s0)


# how often the plain version served a call (CPU tensors only)
wkv6.plain_calls = 0
