"""The WKV6 function the rest of the port calls.

``wkv6`` takes the plain PyTorch version only for tensors on the CPU, and
counts those calls in ``.plain_calls``; for CUDA tensors it launches the
hand-written kernel (B.7) or raises — there is no fallback.
"""

from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import kernel as _k
from repro_torch.kernels.rwkv6_scan import ref as _r


def wkv6(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) or None.

    Returns (y (B, H, T, hd), final state (B, H, hd, hd) float32).
    """
    if _build.route("wkv6", r):
        return _k.wkv6_scan(r, k, v, w, u, s0)
    wkv6.plain_calls += 1
    return _r.wkv6_ref(r, k, v, w, u, s0)


# how often the plain version served a call (CPU tensors only)
wkv6.plain_calls = 0
