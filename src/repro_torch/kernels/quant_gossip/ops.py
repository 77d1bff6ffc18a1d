"""The quant_gossip functions the rest of the port calls.

Each kernel's dispatcher takes the plain PyTorch version only for tensors on
the CPU, and counts those calls in ``.plain_calls``; for CUDA tensors it
launches the hand-written kernel or raises — there is no fallback.
``dequantize_blockwise`` is plain PyTorch on every device, as in the
reference (``repro.kernels.quant_gossip.ops``), where it was never a kernel.

The grouped dispatchers take every leaf of one matching or round at once:
the memoryless masked gossip round calls B.4's and B.5's once per matching,
the static error-feedback round B.2's once per round and B.3's once per
matching, the compressed dense round B.2's once per round.

``quant_gossip_round`` and ``masked_quant_gossip_round`` compose one
compressed matching exchange of one leaf — quantize → the node-axis gather
that stands in for the reference's ``ppermute`` → dequantize-accumulate —
with the gather folded into the accumulate kernel (``src``).  The stochastic-rounding
uniforms ``u`` come in as a tensor where the reference takes a PRNG key.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_gossip import kernel as _k
from repro_torch.kernels.quant_gossip import ref as _r


def quantize_blockwise(x: torch.Tensor, u: torch.Tensor, *, qmax: float | torch.Tensor = 127.0,
                       block_d: int = 65536):
    """(K, D) f32 -> (q int8 (K, D), per-block scales f32 (K, n_blk))."""
    if _build.route("quantize_blockwise", x):
        return _k.quantize_blockwise(x, u, qmax=qmax, block_d=block_d)
    quantize_blockwise.plain_calls += 1
    return _r.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)


def quantize_blockwise_grouped(xs, us, *, qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """:func:`quantize_blockwise` over every leaf of a group (lists of (K,
    D_l) ``xs`` and ``us`` of one K): one launch on the card."""
    if _build.route("quantize_blockwise_grouped", xs[0]):
        return _k.quantize_blockwise_grouped(xs, us, qmax=qmax, block_d=block_d)
    quantize_blockwise_grouped.plain_calls += 1
    return _r.quantize_blockwise_grouped_ref(xs, us, qmax=qmax, block_d=block_d)


def masked_quantize_blockwise(x: torch.Tensor, u: torch.Tensor, mask: torch.Tensor, *,
                              qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """Masked-sender quantize: rows with mask 0 put nothing on the wire
    (q = 0, scale = 0).  Serves the memoryless dynamic gossip wire (θ per
    matching) and the error-feedback dynamic wire (the innovation, once per
    round, under the any-live-link sender mask)."""
    if _build.route("masked_quantize_blockwise", x):
        return _k.masked_quantize_blockwise(x, u, mask, qmax=qmax, block_d=block_d)
    masked_quantize_blockwise.plain_calls += 1
    return _r.masked_quantize_blockwise_ref(x, u, mask, qmax=qmax, block_d=block_d)


def masked_quantize_blockwise_grouped(xs, us, mask: torch.Tensor,
                                      *, qmax: float | torch.Tensor = 127.0,
                                      block_d: int = 65536):
    """:func:`masked_quantize_blockwise` over every leaf of a group (lists of
    (K, D_l) ``xs`` and ``us``, one (K,) mask): one launch on the card."""
    if _build.route("masked_quantize_blockwise_grouped", mask):
        return _k.masked_quantize_blockwise_grouped(xs, us, mask, qmax=qmax, block_d=block_d)
    masked_quantize_blockwise_grouped.plain_calls += 1
    return _r.masked_quantize_blockwise_grouped_ref(xs, us, mask, qmax=qmax, block_d=block_d)


def dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                       w: torch.Tensor, *, src: torch.Tensor | None = None) -> torch.Tensor:
    """acc + w·dequant(q[src], scales[src]), one fused pass over the payload."""
    if _build.route("dequant_accumulate", acc):
        return _k.dequant_accumulate(acc, q, scales, w, src=src)
    dequant_accumulate.plain_calls += 1
    return _r.dequant_accumulate_ref(acc, q, scales, w, src=src)


def dequant_accumulate_grouped_(accs, payloads, w: torch.Tensor, *,
                                src: torch.Tensor | None = None):
    """:func:`dequant_accumulate` over every leaf of a group, into each
    ``acc_l`` in place (one launch on the card); returns ``accs``."""
    if _build.route("dequant_accumulate_grouped_", w):
        return _k.dequant_accumulate_grouped_(accs, payloads, w, src=src)
    dequant_accumulate_grouped_.plain_calls += 1
    return _r.dequant_accumulate_grouped_ref_(accs, payloads, w, src=src)


def masked_dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                              w: torch.Tensor, mask: torch.Tensor, *,
                              src: torch.Tensor | None = None) -> torch.Tensor:
    """acc + mask·w·dequant(q[src], scales[src]); a masked link contributes
    exactly ``acc`` (bitwise)."""
    if _build.route("masked_dequant_accumulate", acc):
        return _k.masked_dequant_accumulate(acc, q, scales, w, mask, src=src)
    masked_dequant_accumulate.plain_calls += 1
    return _r.masked_dequant_accumulate_ref(acc, q, scales, w, mask, src=src)


def masked_dequant_accumulate_grouped_(accs, payloads, w: torch.Tensor, mask: torch.Tensor,
                                       *, src: torch.Tensor | None = None):
    """:func:`masked_dequant_accumulate` over every leaf of a group, into
    each ``acc_l`` in place (one launch on the card); returns ``accs``."""
    if _build.route("masked_dequant_accumulate_grouped_", mask):
        return _k.masked_dequant_accumulate_grouped_(accs, payloads, w, mask, src=src)
    masked_dequant_accumulate_grouped_.plain_calls += 1
    return _r.masked_dequant_accumulate_grouped_ref_(accs, payloads, w, mask, src=src)


# how often each plain version served a call (CPU tensors only)
quantize_blockwise.plain_calls = 0
quantize_blockwise_grouped.plain_calls = 0
masked_quantize_blockwise.plain_calls = 0
masked_quantize_blockwise_grouped.plain_calls = 0
dequant_accumulate.plain_calls = 0
dequant_accumulate_grouped_.plain_calls = 0
masked_dequant_accumulate.plain_calls = 0
masked_dequant_accumulate_grouped_.plain_calls = 0


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return _r.dequantize_blockwise_ref(q, scales)


def quant_gossip_round(x, acc, weight, src, u, *, qmax: float | torch.Tensor = 127.0,
                       block_d: int = 65536):
    """One compressed matching exchange on one card.

    Args:
      x: (K, D) blocks every node transmits.
      acc: (K, D) accumulator the received messages are combined into.
      weight: (K,) receive weights W_{i, src(i)} (0 where node i idles).
      src: (K,) int64, the row node i receives from (the matching).
      u: (K, D) stochastic-rounding uniforms.

    Returns acc + weight · dequant(quantize(x)[src]).
    """
    q, scales = quantize_blockwise(x, u, qmax=qmax, block_d=block_d)
    return dequant_accumulate(acc, q, scales, weight, src=src)


def masked_quant_gossip_round(x, acc, weight, mask, src, u, *, qmax: float | torch.Tensor = 127.0,
                              block_d: int = 65536):
    """:func:`quant_gossip_round` with the round's link mask (K,) at both
    ends: masked senders emit a zero payload and masked receivers combine
    exactly 0.  The link i–src(i) is one link, so mask[src(i)] == mask[i]."""
    q, scales = masked_quantize_blockwise(x, u, mask, qmax=qmax, block_d=block_d)
    return masked_dequant_accumulate(acc, q, scales, weight, mask, src=src)
