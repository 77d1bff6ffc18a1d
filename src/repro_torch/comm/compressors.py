"""Wire compressors for the consensus step.

The port of ``repro.comm.compressors``.  Every compressor maps a
node-stacked block ``x`` of shape ``(K, D)`` float32 (one flattened
parameter leaf) to a *payload* that is what would cross the interconnect,
plus the inverse map.  Per-node granularity matters: each node quantizes
against its own dynamic range.

Noise contract: the reference draws its stochastic-rounding uniforms (and
randk's scores) from JAX keys inside ``compress``; here the wire draws them
(or a test injects the reference's) and ``compress`` takes them as ``u``, a
(K, D) float32 tensor.  JAX and torch generators give different numbers
from one seed, so this is what makes the two frameworks comparable on
identical noise.  randk ranks ``u`` where the reference ranks
``_uniform_rows(keys, d)``: the same numbers under the injected noise.

Rate: ``compress(x, u, rate=...)`` takes an optional 0-d float32 tensor
from a :class:`~repro_torch.comm.schedule.CompressionSchedule`.  For the
quantizers it is the ceiling qmax (127 = int8, 7 = int4); the buffer stays
int8 and only ``ceil(log2(2·qmax+1))`` bits per entry carry information,
which ``payload_bits`` reports as a 0-d tensor.  For the sparsifiers it is
the kept fraction: the buffer is sized for ``ratio`` and entries past the
rate's count are zeroed (never sent).

* ``NoCompressor``        — identity (float32 wire), the paper baseline.
* ``BF16Compressor``      — round-to-nearest bfloat16 cast, 2 bytes/param.
* ``IntQuantizer``        — int8/int4 stochastic rounding
  ``floor(x/scale + u)``, one float32 scale per node; static int4 packs two
  nibbles per byte.
* ``KernelInt8Quantizer`` — the int8 code with a scale per (node, block),
  served by the hand-written CUDA quant_gossip kernels on the card
  (``repro_torch.kernels.quant_gossip``): quantize (qmax a float or the
  schedule's tensor), the fused dequantize-accumulate of the gossip
  transport over every leaf at once, and their sender-masked forms.
* ``TopKCompressor``      — magnitude top-k per node (biased; pair with EF).
* ``RandKCompressor``     — uniform random-k per node.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm.schedule import ScheduleConfig

_SCALE_BYTES = 4  # one float32 scale per node (per block for the kernel)


def quant_bits(qmax) -> torch.Tensor:
    """Wire bits per entry of a symmetric integer code with ceiling qmax:
    ceil(log2(2·qmax + 1)) in float32, on qmax's device."""
    q = qmax if isinstance(qmax, torch.Tensor) else torch.tensor(qmax)
    return torch.ceil(torch.log2(2.0 * q.float() + 1.0))


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """End-to-end compression knobs (the reference's field names).

    Attributes:
      kind: "none" | "bf16" | "int8" | "int4" | "topk" | "randk".
      ratio: kept fraction for topk/randk (with a schedule, the maximum).
      error_feedback: CHOCO error feedback (gossip the compressed innovation
        against public copies) — False is the memoryless ablation.
      seed: seed of the stochastic-rounding noise.
      use_kernel: serve int8 with the blockwise CUDA quantizer (per-block
        scales) instead of the per-node-scale plain PyTorch path.
      block_d: quantizer block length along the flattened parameter dim.
      gamma: consensus step size of θ += γ(Σ_j W_ij θ̂_j − θ̂_i); None picks
        1 for the quantizers and min(1, 2·ratio) for topk/randk.
      schedule: optional :class:`ScheduleConfig` moving the codec rate.

    The reference's ``interpret`` (Pallas interpret mode) has no meaning
    here and is absent.
    """

    kind: str = "none"
    ratio: float = 0.01
    error_feedback: bool = True
    seed: int = 0
    use_kernel: bool = False
    block_d: int = 65536
    gamma: float | None = None
    schedule: ScheduleConfig | None = None

    def __post_init__(self):
        if self.kind not in ("none", "bf16", "int8", "int4", "topk", "randk"):
            raise ValueError(f"unknown compression kind {self.kind!r}")
        if self.kind in ("topk", "randk") and not 0.0 < self.ratio <= 1.0:
            raise ValueError("ratio must be in (0, 1]")
        if self.use_kernel and self.kind != "int8":
            raise ValueError("the quant_gossip kernel serves kind='int8'")
        if self.schedule is not None:
            if self.kind not in ("int8", "int4", "topk", "randk"):
                raise ValueError(
                    f"kind {self.kind!r} has no adjustable rate to schedule")
            if self.schedule.kind == "adaptive" and not self.error_feedback:
                raise ValueError(
                    "adaptive schedules are driven by the error-feedback "
                    "innovation norm; set error_feedback=True")

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    @property
    def resolved_gamma(self) -> float:
        if self.gamma is not None:
            return self.gamma
        if self.kind in ("topk", "randk"):
            return min(1.0, 2.0 * self.ratio)
        return 1.0


class NoCompressor:
    name = "none"

    def compress(self, x, u, rate=None):
        return x

    def decompress(self, payload, d):
        return payload

    def payload_bytes(self, d):
        return 4 * d

    def payload_bits(self, d, rate=None):
        return 8 * self.payload_bytes(d)


class BF16Compressor:
    name = "bf16"

    def compress(self, x, u, rate=None):
        return x.to(torch.bfloat16)

    def decompress(self, payload, d):
        return payload.float()

    def payload_bytes(self, d):
        return 2 * d

    def payload_bits(self, d, rate=None):
        return 8 * self.payload_bytes(d)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, D) int8 nibbles in [-8, 7] -> (K, ceil(D/2)) packed int8: the
    even column in the low nibble, the odd one in the high nibble.  Computed
    in int32 and wrapped to int8 by its low byte, which is what the
    reference's int8 shifts give."""
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    lo = q[:, 0::2].int() & 0x0F
    hi = (q[:, 1::2].int() & 0x0F) << 4
    return ((lo | hi) ^ 0x80).sub(0x80).to(torch.int8)


def _unpack_int4(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`_pack_int4`: each nibble sign-extended."""
    p = packed.int()
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4  # arithmetic: the high nibble of a signed byte, sign-extended
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
    return out[:, :d].to(torch.int8)


class IntQuantizer:
    """Stochastically rounded uniform quantizer with a per-node float32 scale.

    With a schedule (``dynamic``) the buffer stays (K, D) int8 and
    ``payload_bits`` accounts the effective bit width; static int4
    nibble-packs for a genuinely halved buffer.
    """

    def __init__(self, bits: int, dynamic: bool = False):
        if bits not in (4, 8):
            raise ValueError("bits must be 4 or 8")
        self.bits = bits
        self.qmax = (1 << (bits - 1)) - 1  # 127 / 7
        self.dynamic = dynamic
        self.name = f"int{bits}"

    def _pack(self) -> bool:
        return self.bits == 4 and not self.dynamic

    def compress(self, x, u, rate=None):
        qmax = torch.full((), float(self.qmax), dtype=torch.float32, device=x.device) \
            if rate is None else rate
        absmax = x.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
        q = torch.clamp(torch.floor(x / scale + u), -qmax, qmax).to(torch.int8)
        if self._pack():
            q = _pack_int4(q)
        return q, scale

    def decompress(self, payload, d):
        q, scale = payload
        if self._pack():
            q = _unpack_int4(q, d)
        return q.float() * scale

    def payload_bytes(self, d):
        # packed nibbles for static int4, full bytes otherwise, + f32 scale
        return (d if not self._pack() else (d + 1) // 2) + _SCALE_BYTES

    def payload_bits(self, d, rate=None):
        if rate is None:
            return 8 * self.payload_bytes(d)
        return quant_bits(rate) * d + 8 * _SCALE_BYTES


class KernelInt8Quantizer(IntQuantizer):
    """int8 quantizer served by the blockwise CUDA quant_gossip kernels.

    Same wire format as :class:`IntQuantizer` except the scale is per
    (node, block).  On CUDA tensors every call below launches its kernel;
    the plain PyTorch versions serve only CPU tensors.  ``src`` (K,) int64
    is the row each node receives from on the gossip transport.  A
    schedule's rate (a 0-d float32 tensor) goes to the quantizer as its
    qmax and is read on the card, never on the host.
    """

    def __init__(self, block_d: int = 65536, dynamic: bool = False):
        super().__init__(bits=8, dynamic=dynamic)
        self.name = "int8-kernel"
        self.block_d = block_d

    def _qmax(self, rate):
        return float(self.qmax) if rate is None else rate

    def compress(self, x, u, rate=None):
        from repro_torch.kernels.quant_gossip.ops import quantize_blockwise

        return quantize_blockwise(x, u, qmax=self._qmax(rate), block_d=self.block_d)

    def compress_grouped(self, xs, us, rate=None):
        """:meth:`compress` of every leaf at once (one B.2 launch on the
        card): [(q, scales)] per leaf, bit-identical to the one-leaf calls."""
        from repro_torch.kernels.quant_gossip.ops import quantize_blockwise_grouped

        return quantize_blockwise_grouped(xs, us, qmax=self._qmax(rate), block_d=self.block_d)

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

    def compress_masked_grouped(self, xs, us, mask, rate=None):
        """Sender-masked quantize of every leaf at once (one B.4 launch on
        the card): masked rows emit a zero payload and zero scales, so a
        fully cut-off node's EF innovation stays unsent and its θ̂ frozen.
        An all-ones mask is bit-identical to :meth:`compress` per leaf."""
        from repro_torch.kernels.quant_gossip.ops import masked_quantize_blockwise_grouped

        return masked_quantize_blockwise_grouped(xs, us, mask, qmax=self._qmax(rate),
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

    def payload_bits(self, d, rate=None):
        if rate is None:
            return 8 * self.payload_bytes(d)
        return quant_bits(rate) * d + 8 * _SCALE_BYTES * self._n_blocks(d)


def _num_kept(d: int, ratio: float) -> int:
    return max(1, min(d, int(round(ratio * d))))


class TopKCompressor:
    """Keep the ``ratio`` fraction of largest-magnitude entries per node.

    ``ratio`` sizes the payload buffer; a rate ≤ ratio zeroes the tail of
    the magnitude-sorted buffer so only ``round(rate·d)`` entries are live
    (``payload_bits`` counts exactly those).  Tied magnitudes may be ordered
    differently from the reference's ``lax.top_k``.
    """

    def __init__(self, ratio: float):
        self.ratio = ratio
        self.name = "topk"

    def _dynamic_kept(self, d, rate):
        return torch.clamp(torch.round(rate * d), 1, _num_kept(d, self.ratio))

    def _mask_tail(self, vals, d, rate):
        # the buffer is magnitude-sorted, so zeroing its tail keeps the
        # largest entries (randk: an arbitrary-but-fixed subset, also fine)
        live = torch.arange(vals.shape[1], dtype=torch.float32,
                            device=vals.device)[None, :] < self._dynamic_kept(d, rate)
        return torch.where(live, vals, torch.zeros_like(vals))

    def _take(self, x, scores, rate):
        idx = torch.topk(scores, _num_kept(x.shape[1], self.ratio), dim=1).indices
        vals = torch.gather(x, 1, idx)
        if rate is not None:
            vals = self._mask_tail(vals, x.shape[1], rate)
        return vals, idx.int()

    def compress(self, x, u, rate=None):
        return self._take(x, x.abs(), rate)

    def decompress(self, payload, d):
        vals, idx = payload
        out = torch.zeros((vals.shape[0], d), dtype=torch.float32, device=vals.device)
        return out.scatter(1, idx.long(), vals)

    def payload_bytes(self, d):
        return _num_kept(d, self.ratio) * 8  # f32 value + int32 index

    def payload_bits(self, d, rate=None):
        if rate is None:
            return 8 * self.payload_bytes(d)
        return self._dynamic_kept(d, rate) * 64.0


class RandKCompressor(TopKCompressor):
    """Keep a uniformly random ``ratio`` fraction per node (fresh each round):
    the entries with the largest uniforms ``u``.

    Unscaled (E[ĉ] = ratio·x): pair with error feedback, which re-injects
    what was dropped.
    """

    def __init__(self, ratio: float):
        super().__init__(ratio)
        self.name = "randk"

    def compress(self, x, u, rate=None):
        return self._take(x, u, rate)


def make_compressor(cfg: CompressionConfig):
    dynamic = cfg.schedule is not None
    if cfg.kind == "none":
        return NoCompressor()
    if cfg.kind == "bf16":
        return BF16Compressor()
    if cfg.kind in ("int8", "int4"):
        if cfg.use_kernel:
            return KernelInt8Quantizer(cfg.block_d, dynamic=dynamic)
        # scheduled quantizers share the int8 container (packing is
        # shape-static); the schedule drives the effective bit width
        return IntQuantizer(8 if dynamic else int(cfg.kind[3:]), dynamic=dynamic)
    if cfg.kind == "topk":
        return TopKCompressor(cfg.ratio)
    if cfg.kind == "randk":
        return RandKCompressor(cfg.ratio)
    raise ValueError(cfg.kind)
