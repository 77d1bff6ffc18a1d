"""The flash-attention function the rest of the port calls.

``flash_attention`` takes the plain PyTorch version only for tensors on the
CPU, and counts those calls in ``.plain_calls``; for CUDA tensors it
launches the hand-written kernel (B.6) or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _r


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KVH, T, hd) -> (B, H, S, hd)."""
    if _build.route("flash_attention", q):
        return _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    flash_attention.plain_calls += 1
    return _r.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)


# how often the plain version served a call (CPU tensors only)
flash_attention.plain_calls = 0
