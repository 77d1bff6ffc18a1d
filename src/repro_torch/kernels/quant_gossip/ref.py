"""Plain PyTorch versions of the quant_gossip kernels.

Bit-exact against the CUDA kernels given the same inputs: every step is one
correctly rounded float32 operation.

* quantize: ``scale = absmax / qmax`` (1 where the block is all zero) and
  ``q = clip(floor(x / scale + u), ±qmax)``, bit-exact against the
  reference's ``quantize_blockwise_ref`` too.  ``qmax`` is a float or a
  0-d float32 tensor (a schedule's rate), divided as a tensor on ``x``'s
  device either way: PyTorch's CUDA division by a Python number multiplies
  by its reciprocal, which is not correctly rounded and would move
  ``scale`` by an ulp.
* masked quantize: a masked row gives q = 0 and scale·m = 0, as the
  reference's oracle does.
* the grouped forms (every leaf of one matching in one call, as the card
  runs them) are loops over the one-leaf versions; the grouped accumulate
  writes into each ``acc`` in place, as the kernel does.
* dequantize-accumulate: ``acc + (a·scale)·q`` with ``a = w`` (or
  ``m·w``), the multiplication order of the reference's Pallas kernels
  (``kernel.py:46, 70``).  The reference's jnp oracle computes
  ``acc + w·(q·scale)``, which can differ by an ulp.  A row with a = 0
  returns ``acc`` bitwise, as the CUDA kernel does without reading q.
  ``src`` gathers the row each node receives from (the one-card
  ``ppermute``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant_gossip.kernel import _pick_block


def _blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    k, d = x.shape
    return x.reshape(k, n_blk, d // n_blk)


def quantize_blockwise_ref(x, u, *, qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """x, u: (K, D) -> (q int8 (K, D), scales f32 (K, D/block))."""
    k, d = x.shape
    n_blk = d // _pick_block(d, block_d)
    xb = _blocked(x.float(), n_blk)
    qmax_t = qmax.to(device=x.device, dtype=torch.float32) if isinstance(qmax, torch.Tensor) \
        else torch.full((), float(qmax), dtype=torch.float32, device=x.device)
    absmax = xb.abs().amax(dim=2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax_t, torch.ones_like(absmax))
    y = torch.floor(xb / scale + _blocked(u.float(), n_blk))
    q = torch.clamp(y, -qmax_t, qmax_t).to(torch.int8)
    return q.reshape(k, d), scale.reshape(k, n_blk)


def dequantize_blockwise_ref(q, scales):
    """(K, D) int8 + (K, n_blk) scales -> (K, D) float32."""
    k, d = q.shape
    n_blk = scales.shape[1]
    return (_blocked(q.float(), n_blk) * scales[:, :, None]).reshape(k, d)


def masked_quantize_blockwise_ref(x, u, mask, *, qmax: float | torch.Tensor = 127.0,
                                  block_d: int = 65536):
    """Masked-sender version: rows with mask 0 emit zero payload and zero
    scales."""
    q, scales = quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
    m = mask.reshape(-1, 1).float()
    q = torch.where(m > 0, q, torch.zeros_like(q))
    return q, scales * m


def _gather(q, scales, src):
    if src is None:
        return q, scales
    return q[src], scales[src]


def dequant_accumulate_ref(acc, q, scales, w, *, src=None):
    """acc + (w·scale)·q on the rows ``src`` selects; rows with w = 0 give
    acc bitwise."""
    q, scales = _gather(q, scales, src)
    a = w.reshape(-1, 1).float()
    k, d = acc.shape
    n_blk = scales.shape[1]
    out = _blocked(acc, n_blk) + (a * scales)[:, :, None] * _blocked(q.float(), n_blk)
    return torch.where(a != 0, out.reshape(k, d), acc)


def masked_dequant_accumulate_ref(acc, q, scales, w, mask, *, src=None):
    """acc + ((m·w)·scale)·q; masked rows give acc bitwise."""
    a = mask.reshape(-1).float() * w.reshape(-1).float()
    return dequant_accumulate_ref(acc, q, scales, a, src=src)


def quantize_blockwise_grouped_ref(xs, us,
                                   *, qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """[(q_l, scales_l)] of :func:`quantize_blockwise_ref` per leaf."""
    return [quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d) for x, u in zip(xs, us)]


def masked_quantize_blockwise_grouped_ref(xs, us, mask, *, qmax: float | torch.Tensor = 127.0,
                                          block_d: int = 65536):
    """[(q_l, scales_l)] of :func:`masked_quantize_blockwise_ref` per leaf."""
    return [masked_quantize_blockwise_ref(x, u, mask, qmax=qmax, block_d=block_d)
            for x, u in zip(xs, us)]


def masked_dequant_accumulate_grouped_ref_(accs, payloads, w, mask, *, src=None):
    """Each ``acc_l`` overwritten in place with
    :func:`masked_dequant_accumulate_ref` of it; returns ``accs``."""
    for acc, (q, scales) in zip(accs, payloads):
        acc.copy_(masked_dequant_accumulate_ref(acc, q, scales, w, mask, src=src))
    return accs


def dequant_accumulate_grouped_ref_(accs, payloads, w, *, src=None):
    """Each ``acc_l`` overwritten in place with
    :func:`dequant_accumulate_ref` of it; returns ``accs``."""
    for acc, (q, scales) in zip(accs, payloads):
        acc.copy_(dequant_accumulate_ref(acc, q, scales, w, src=src))
    return accs
