"""Plain PyTorch versions of the quant_gossip kernels.

Bit-exact against the CUDA kernel (and against the reference's
``quantize_blockwise_ref``) given the same uniforms ``u``: every step is one
correctly rounded float32 operation, ``scale = absmax / qmax`` (1 where the
block is all zero) and ``q = clip(floor(x / scale + u), ±qmax)``.

``qmax`` is divided as a tensor on ``x``'s device: PyTorch's CUDA division by
a Python number multiplies by its reciprocal, which is not correctly rounded
and would move ``scale`` by an ulp.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant_gossip.kernel import _pick_block


def _blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    k, d = x.shape
    return x.reshape(k, n_blk, d // n_blk)


def quantize_blockwise_ref(x, u, *, qmax: float = 127.0, block_d: int = 65536):
    """x, u: (K, D) -> (q int8 (K, D), scales f32 (K, D/block))."""
    k, d = x.shape
    n_blk = d // _pick_block(d, block_d)
    xb = _blocked(x.float(), n_blk)
    qmax_t = torch.full((), float(qmax), dtype=torch.float32, device=x.device)
    absmax = xb.abs().amax(dim=2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax_t, torch.ones_like(absmax))
    y = torch.floor(xb / scale + _blocked(u.float(), n_blk))
    q = torch.clamp(y, -float(qmax), float(qmax)).to(torch.int8)
    return q.reshape(k, d), scale.reshape(k, n_blk)


def dequantize_blockwise_ref(q, scales):
    """(K, D) int8 + (K, n_blk) scales -> (K, D) float32."""
    k, d = q.shape
    n_blk = scales.shape[1]
    return (_blocked(q.float(), n_blk) * scales[:, :, None]).reshape(k, d)
