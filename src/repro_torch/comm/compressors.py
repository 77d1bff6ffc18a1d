"""Wire compressors for the consensus step.

The port of ``repro.comm.compressors`` for the codecs this slice runs.  Every
compressor maps a node-stacked block ``x`` of shape ``(K, D)`` float32 (one
flattened parameter leaf) to a *payload* that is what would cross the
interconnect, plus the inverse map.  Per-node granularity matters: each node
quantizes against its own dynamic range.

Noise contract: the reference draws its stochastic-rounding uniforms from
JAX keys inside ``compress``; here the wire draws them (or a test injects
the reference's) and ``compress`` takes them as ``u``.  JAX and torch
generators give different numbers from one seed, so this is what makes the
two frameworks comparable on identical noise.

* ``NoCompressor``        — identity (float32 wire), the paper baseline.
* ``IntQuantizer``        — int8 stochastic rounding ``floor(x/scale + u)``,
  one float32 scale per node (what ``--compress int8`` builds).
* ``KernelInt8Quantizer`` — the same code with a scale per (node, block),
  served by the hand-written CUDA quant_gossip kernels on the card
  (``repro_torch.kernels.quant_gossip``): quantize, the fused
  dequantize-accumulate of the gossip transport over every leaf at once,
  and their sender-masked forms.

bf16, int4 (nibble packing), topk and randk raise ``NotImplementedError``
in :func:`make_compressor` until their slice ports them.
"""

from __future__ import annotations

import dataclasses

import torch

_SCALE_BYTES = 4  # one float32 scale per node (per block for the kernel)

_LATER = {
    "bf16": "the codecs slice (bf16/int4/topk/randk)",
    "int4": "the codecs slice (bf16/int4/topk/randk)",
    "topk": "the codecs slice (bf16/int4/topk/randk)",
    "randk": "the codecs slice (bf16/int4/topk/randk)",
}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """End-to-end compression knobs (same field names as the reference).

    Attributes:
      kind: "none" | "bf16" | "int8" | "int4" | "topk" | "randk"; this slice
        builds "none" and "int8".
      error_feedback: CHOCO error feedback (gossip the compressed innovation
        against public copies) — False is the memoryless ablation.
      seed: seed of the stochastic-rounding noise.
      use_kernel: serve int8 with the blockwise CUDA quantizer (per-block
        scales) instead of the per-node-scale plain PyTorch path.
      block_d: quantizer block length along the flattened parameter dim.

    The reference's ``ratio`` and ``gamma`` (the sparsifiers' kept fraction
    and consensus step), ``schedule`` and ``interpret`` fields are absent:
    the quantizers this slice runs use γ = 1, sparsifiers and rate schedules
    wait for their slice, and there is no interpret mode here.
    """

    kind: str = "none"
    error_feedback: bool = True
    seed: int = 0
    use_kernel: bool = False
    block_d: int = 65536

    def __post_init__(self):
        if self.kind not in ("none", "bf16", "int8", "int4", "topk", "randk"):
            raise ValueError(f"unknown compression kind {self.kind!r}")
        if self.use_kernel and self.kind != "int8":
            raise ValueError("the quant_gossip kernel serves kind='int8'")

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


class NoCompressor:
    name = "none"

    def compress(self, x, u):
        return x

    def decompress(self, payload, d):
        return payload

    def payload_bytes(self, d):
        return 4 * d

    def payload_bits(self, d):
        return 8 * self.payload_bytes(d)


class IntQuantizer:
    """Stochastically rounded uniform int8 quantizer, per-node float32 scale."""

    def __init__(self, bits: int = 8):
        if bits != 8:
            raise NotImplementedError(f"int{bits} waits for {_LATER['int4']}")
        self.bits = bits
        self.qmax = (1 << (bits - 1)) - 1  # 127
        self.name = f"int{bits}"

    def compress(self, x, u):
        qmax = torch.full((), float(self.qmax), dtype=torch.float32, device=x.device)
        absmax = x.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
        q = torch.clamp(torch.floor(x / scale + u), -float(self.qmax), float(self.qmax))
        return q.to(torch.int8), scale

    def decompress(self, payload, d):
        q, scale = payload
        return q.float() * scale

    def payload_bytes(self, d):
        return d + _SCALE_BYTES

    def payload_bits(self, d):
        return 8 * self.payload_bytes(d)


class KernelInt8Quantizer(IntQuantizer):
    """int8 quantizer served by the blockwise CUDA quant_gossip kernels.

    Same wire format as :class:`IntQuantizer` except the scale is per
    (node, block).  On CUDA tensors every call below launches its kernel;
    the plain PyTorch versions serve only CPU tensors.  ``src`` (K,) int64
    is the row each node receives from on the gossip transport.
    """

    def __init__(self, block_d: int = 65536):
        super().__init__(bits=8)
        self.name = "int8-kernel"
        self.block_d = block_d

    def compress(self, x, u):
        from repro_torch.kernels.quant_gossip.ops import quantize_blockwise

        return quantize_blockwise(x, u, qmax=float(self.qmax), block_d=self.block_d)

    def compress_grouped(self, xs, us):
        """:meth:`compress` of every leaf at once (one B.2 launch on the
        card): [(q, scales)] per leaf, bit-identical to the one-leaf calls."""
        from repro_torch.kernels.quant_gossip.ops import quantize_blockwise_grouped

        return quantize_blockwise_grouped(xs, us, qmax=float(self.qmax), block_d=self.block_d)

    def decompress(self, payload, d):
        from repro_torch.kernels.quant_gossip.ops import dequantize_blockwise

        q, scale = payload
        return dequantize_blockwise(q, scale)

    def accumulate(self, acc, payload, weight, src=None):
        """acc + weight·dequantize(payload[src]), fused: one pass over q
        (the B.3 kernel on the card)."""
        from repro_torch.kernels.quant_gossip.ops import dequant_accumulate

        q, scale = payload
        return dequant_accumulate(acc, q, scale, weight, src=src)

    def accumulate_grouped_(self, accs, payloads, weight, src=None):
        """acc + weight·dequantize(payload[src]) for every leaf at once, into
        each acc in place (one B.3 launch on the card).  Returns ``accs``."""
        from repro_torch.kernels.quant_gossip.ops import dequant_accumulate_grouped_

        return dequant_accumulate_grouped_(accs, payloads, weight, src=src)

    def compress_masked_grouped(self, xs, us, mask):
        """Sender-masked quantize of every leaf at once (one B.4 launch on
        the card): masked rows emit a zero payload and zero scales, so a
        fully cut-off node's EF innovation stays unsent and its θ̂ frozen.
        An all-ones mask is bit-identical to :meth:`compress` per leaf."""
        from repro_torch.kernels.quant_gossip.ops import masked_quantize_blockwise_grouped

        return masked_quantize_blockwise_grouped(xs, us, mask, qmax=float(self.qmax),
                                                 block_d=self.block_d)

    def accumulate_masked_grouped_(self, accs, payloads, weight, mask, src=None):
        """acc + mask·weight·dequantize(payload[src]) for every leaf at once,
        into each acc in place (one B.5 launch on the card); masked links
        leave acc bitwise.  Returns ``accs``."""
        from repro_torch.kernels.quant_gossip.ops import masked_dequant_accumulate_grouped_

        return masked_dequant_accumulate_grouped_(accs, payloads, weight, mask, src=src)

    def _n_blocks(self, d):
        from repro_torch.kernels.quant_gossip.kernel import num_blocks

        return num_blocks(d, self.block_d)

    def payload_bytes(self, d):
        return d + _SCALE_BYTES * self._n_blocks(d)


def make_compressor(cfg: CompressionConfig):
    if cfg.kind == "none":
        return NoCompressor()
    if cfg.kind == "int8":
        return KernelInt8Quantizer(cfg.block_d) if cfg.use_kernel else IntQuantizer(8)
    raise NotImplementedError(
        f"compression kind {cfg.kind!r} is not ported yet; it waits for "
        f"{_LATER[cfg.kind]}")
