"""The quant_gossip functions the rest of the port calls.

``quantize_blockwise`` takes the plain PyTorch version only for tensors on
the CPU; for CUDA tensors it launches the hand-written kernel or raises —
there is no fallback.  ``dequantize_blockwise`` is plain PyTorch on every
device, as in the reference (``repro.kernels.quant_gossip.ops``), where it
was never a kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant_gossip import kernel as _k
from repro_torch.kernels.quant_gossip import ref as _r


def quantize_blockwise(x: torch.Tensor, u: torch.Tensor, *, qmax: float = 127.0,
                       block_d: int = 65536):
    """(K, D) f32 -> (q int8 (K, D), per-block scales f32 (K, n_blk))."""
    if x.device.type == "cuda":
        return _k.quantize_blockwise(x, u, qmax=qmax, block_d=block_d)
    if x.device.type == "cpu":
        quantize_blockwise.plain_calls += 1
        return _r.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
    raise ValueError(f"quantize_blockwise: unsupported device {x.device}")


# how often the plain version served a call (CPU tensors only)
quantize_blockwise.plain_calls = 0


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return _r.dequantize_blockwise_ref(q, scales)
