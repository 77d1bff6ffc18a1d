"""Wire layer: what crosses each link, and the ``CommState`` fields it owns.

The port of ``repro.comm.wire``: one of the three composable consensus
layers (see ``comm/composed.py``).  A wire declares — via ``init_fields`` —
exactly the ``CommState`` fields it needs, spliced over the trivial state,
so adding a wire never perturbs fields it does not own.

:class:`IdentityWire`    — full-precision parameters; trivial state.
:class:`CodecWire`       — memoryless codec: C(θ) crosses the wire every
                           round.  Owns ``key``; drives the codec-rate
                           schedule (``res_ref`` and ``rounds``).
:class:`ChocoWire`       — CHOCO error feedback: compressed *innovations*
                           against public copies θ̂.  Owns ``hat`` (and
                           ``hat_mix`` on incremental transports); with a
                           :class:`RebaseClock` also the ``ef_rounds`` /
                           ``ef_drift`` delta/re-base clock of the dynamic
                           gossip stack.
:class:`MaskedQuantWire` — the memoryless masked int8/int4 wire of the
                           dynamic gossip transport (masked quantize →
                           gather → masked dequantize-accumulate per
                           matching, the CUDA kernels B.4/B.5 on the card).

Stochastic-rounding noise: the uniforms of round r and leaf i (and, on the
masked wire, matching m) come from a ``torch.Generator`` seeded with a hash
of (``CommState.key``, r, i[, m]), drawn on the parameters' device — a pure
function of the round, like the reference's ``fold_in`` chain, though not
the same numbers.  ``uniforms`` (a callable ``(round, leaf_idx, shape) ->
array``, or ``(round, leaf_idx, matching_idx, shape)`` on the masked wire)
replaces that draw; the parity tests inject the reference's own uniforms
through it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.comm.compressors import (
    CompressionConfig,
    KernelInt8Quantizer,
    make_compressor,
)
from repro_torch.comm.protocol import CommState, scalar
from repro_torch.comm.schedule import CompressionSchedule

UniformsFn = Callable[..., object]


def _f32_zeros_like(tree):
    return {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for n, x in tree.items()}


def _send_mask(masks):
    """Per-node "any live outgoing link this round" vector: ∨ over the
    per-matching link masks.  A node with every incident link down emits a
    zero payload and its θ̂ stays frozen (nobody could apply the delta)."""
    send = masks[0]
    for m in masks[1:]:
        send = torch.maximum(send, m)
    return send


def _leaf_payload_bytes(compressor, params, k: int) -> int:
    """Per-round payload bytes one node injects (sum over leaves); the
    per-node leaf size is ``x.numel() // k`` with ``k`` the mixer's node
    count."""
    return sum(compressor.payload_bytes(x.numel() // k) for x in params.values())


def _noise_seed(*parts: int) -> int:
    digest = hashlib.blake2b(":".join(str(p) for p in parts).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1  # manual_seed takes < 2**63


def _uniforms(hook, key: int, index: tuple, x: torch.Tensor) -> torch.Tensor:
    """U[0, 1) noise shaped like ``x`` on ``x``'s device: ``hook(*index,
    shape)`` when a hook is set, else a generator seeded from (key,
    *index)."""
    if hook is not None:
        u = hook(*index, tuple(x.shape))
        if not isinstance(u, torch.Tensor):
            u = torch.from_numpy(np.array(u, dtype=np.float32))
        return u.to(device=x.device, dtype=torch.float32)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(_noise_seed(key, *index))
    return torch.rand(x.shape, generator=gen, dtype=torch.float32, device=x.device)


def wire_bits(senders, per_node_bits, device) -> torch.Tensor:
    """senders × per-node bits as a 0-d float32 tensor; ``senders`` is a host
    int (static stacks) or a 0-d tensor (time-varying stacks), and
    ``per_node_bits`` a host number or a 0-d tensor (a scheduled rate)."""
    if isinstance(senders, torch.Tensor) or isinstance(per_node_bits, torch.Tensor):
        return senders * per_node_bits
    return scalar(senders * per_node_bits, device)


@dataclasses.dataclass(frozen=True)
class RebaseClock:
    """The delta/re-base cadence of the dynamic EF gossip stack.

    every:     B — re-base the incremental ``hat_mix`` cache from
               full-precision public copies every B-th executed consensus
               round (``ef_rounds % B == B − 1``).  0 = never (static
               fault-free schedules only), 1 = every round.
    threshold: > 0 replaces the fixed clock with the drift proxy
               ‖s − W_r θ̂‖_F measured each round (adaptive re-base; the
               measurement lands in ``CommState.ef_drift``).
    """

    every: int = 8
    threshold: float = 0.0

    @property
    def adaptive(self) -> bool:
        return self.threshold > 0


class Wire:
    """Payload-semantics layer base: trivial state, no codec.

    ``init_fields(params, incremental=...)`` returns the ``CommState``
    fields this wire owns; ``incremental`` is True on transports that keep
    the receiver-side running mix cache (gossip), where EF wires also own
    ``hat_mix``.
    """

    compression: CompressionConfig | None = None
    ef = False
    traced_wire = False

    def init_fields(self, params, incremental: bool = False) -> dict:
        return {}


class IdentityWire(Wire):
    """Full-precision payloads — the uncompressed mixers' wire."""


class CodecWire(Wire):
    """Memoryless codec wire: C(θ) crosses every round (the ablation that
    stalls at the quantization noise floor)."""

    ef = False

    def __init__(self, compression: CompressionConfig,
                 uniforms: UniformsFn | None = None):
        self.compression = compression
        self.compressor = make_compressor(compression)
        self.gamma = compression.resolved_gamma
        self.schedule = (
            CompressionSchedule(compression.schedule, compression.kind, compression.ratio)
            if compression.schedule is not None else None)
        self._uniforms = uniforms

    @property
    def traced_wire(self) -> bool:
        """A scheduled wire's ``wire_bits`` is the round's measured wire."""
        return self.schedule is not None

    def init_fields(self, params, incremental: bool = False) -> dict:
        return {"key": int(self.compression.seed)}

    # -- schedule / accounting -------------------------------------------------

    def rate(self, state: CommState):
        """The codec rate of the round about to run: a 0-d float32 tensor on
        the parameters' device, or None without a schedule."""
        if self.schedule is None:
            return None
        return self.schedule.rate(state.rounds, state.res_norm, state.res_ref)

    def gamma_for(self, rate):
        """The round's consensus step: the config-resolved γ (a host float),
        or min(γ, 2·rate) under a sparsifier schedule with ``damp_gamma``."""
        if self.schedule is None:
            return self.gamma
        return self.schedule.gamma_for(self.gamma, rate)

    def next_sched_state(self, state: CommState, res_norm):
        """(res_norm', res_ref', rounds') after a round observing res_norm."""
        res_ref = (self.schedule.update_ref(state.rounds, res_norm, state.res_ref)
                   if self.schedule is not None else state.res_ref)
        return res_norm, res_ref, state.rounds + 1

    def round_wire_bits(self, params, rate, senders, k: int, device) -> torch.Tensor:
        """Wire bits one round injects: senders × the per-node payload, a sum
        over the leaves in their order (a 0-d tensor under a rate, summed in
        float32 as the reference does)."""
        per_node = 0.0
        for x in params.values():
            per_node = per_node + self.compressor.payload_bits(x.numel() // k, rate)
        return wire_bits(senders, per_node, device)

    def uniforms(self, key: int, rounds: int, leaf_idx: int, x: torch.Tensor):
        """U[0, 1) noise shaped like ``x`` for leaf ``leaf_idx`` of round
        ``rounds``, on ``x``'s device."""
        return _uniforms(self._uniforms, key, (rounds, leaf_idx), x)

    def compress_block(self, x, u, rate=None, send_mask=None):
        """Encode one (K, d) block, optionally sender-masked.

        ``send_mask`` (K,) in {0, 1} is the dynamic lowering's per-round
        "this node has at least one live link" vector: masked rows emit a
        zero payload and their θ̂ stays frozen.  A codec without a masked
        kernel masks the input block, which encodes to an all-zero payload
        (the kernel quantizer takes every leaf at once:
        :meth:`encode_leaves`).  An all-ones mask is bit-identical to the
        unmasked encode.
        """
        if send_mask is None:
            return self.compressor.compress(x, u, rate)
        return self.compressor.compress(x * send_mask[:, None], u, rate)

    def encode_leaf(self, x, hat, u, rate=None, send_mask=None):
        """Compress one flattened (K, d) leaf with uniforms ``u`` at the
        round's ``rate`` (None: the codec's static rate).

        Returns (payload, public', hat') where ``public'`` is this node's new
        publicly reconstructible value (θ̂' in EF mode, C(θ) memoryless) and
        ``hat'`` the state to carry (θ̂' or ()).
        """
        payload = self.compress_block(x - hat if self.ef else x, u, rate, send_mask)
        return self._decoded(x, hat, payload)

    def encode_leaves(self, xs, hats, us, rate=None, send_mask=None):
        """:meth:`encode_leaf` of every leaf: [(payload, public', hat')].

        With a codec that quantizes a group at once (the kernel quantizer:
        one B.2 launch per round on the card, one B.4 launch under a send
        mask) every leaf is encoded by one call; the payloads are the
        one-leaf calls' bit for bit.
        """
        grouped = getattr(self.compressor, "compress_grouped" if send_mask is None
                          else "compress_masked_grouped", None)
        if grouped is None:
            return [self.encode_leaf(x, h, u, rate, send_mask) for x, h, u in zip(xs, hats, us)]
        blocks = [x - h for x, h in zip(xs, hats)] if self.ef else xs
        payloads = grouped(blocks, us, rate=rate) if send_mask is None \
            else grouped(blocks, us, send_mask, rate=rate)
        return [self._decoded(x, h, p) for x, h, p in zip(xs, hats, payloads)]

    def _decoded(self, x, hat, payload):
        """(payload, public', hat') of one leaf from its payload."""
        public = self.compressor.decompress(payload, x.shape[1])
        if self.ef:
            new_hat = hat + public
            return payload, new_hat, new_hat
        return payload, public, ()


class ChocoWire(CodecWire):
    """CHOCO error-feedback wire: compressed innovations against θ̂.

    Owns ``hat`` (the public copies — the EF residual is θ − θ̂), plus
    ``hat_mix`` on incremental transports (the receiver-side running mix
    s_i = Σ_j W_ij θ̂_j of the gossip lowering).  With a
    :class:`RebaseClock` it also owns the ``ef_rounds`` consensus clock (a
    host int) and, in adaptive mode, ``ef_drift``.
    """

    ef = True

    def __init__(self, compression: CompressionConfig,
                 uniforms: UniformsFn | None = None,
                 clock: RebaseClock | None = None):
        if not compression.error_feedback:
            raise ValueError("ChocoWire is the error-feedback wire — build "
                             "CodecWire for the memoryless ablation")
        super().__init__(compression, uniforms)
        self.clock = clock

    # one device holds every node, so no field has a partitioning to declare
    # (the reference's spec_fields serves its pjit layout)
    def init_fields(self, params, incremental: bool = False) -> dict:  # repro: noqa[RPR007]
        fields = {"hat": _f32_zeros_like(params), "key": int(self.compression.seed)}
        if incremental:
            fields["hat_mix"] = _f32_zeros_like(params)
        if self.clock is not None:
            fields["ef_rounds"] = 0
            if self.clock.adaptive:
                fields["ef_drift"] = scalar(0.0, next(iter(params.values())).device)
        return fields


class MaskedQuantWire(Wire):
    """Memoryless masked int8/int4 quantization for the dynamic gossip
    transport: each matching runs masked quantize → gather → masked
    dequantize-accumulate, with a fresh C(θ) every round (int4 rides the
    int8 container at qmax = 7).  Owns only ``key``.

    On CUDA tensors the two steps always launch the kernels B.4 and B.5:
    the reference's ``use_kernel=False`` picks the Pallas kernels' own
    oracle, which in the port is the kernels' plain version and does not
    serve the card.  The payload is the same either way.
    """

    ef = False

    def __init__(self, quantized: CompressionConfig,
                 uniforms: UniformsFn | None = None):
        if quantized.kind not in ("int8", "int4"):
            raise ValueError(
                "the masked quant_gossip wire serves kind='int8' or "
                "'int4' (the traced-qmax rate in the int8 container)")
        if quantized.schedule is not None:
            raise ValueError("rate schedules are not supported on the masked wire")
        self.quantized = quantized
        self.compression = quantized
        self._qmax = 127 if quantized.kind == "int8" else 7
        self.compressor = KernelInt8Quantizer(quantized.block_d)
        self._uniforms = uniforms

    def init_fields(self, params, incremental: bool = False) -> dict:
        return {"key": int(self.quantized.seed)}

    def uniforms(self, key: int, rounds: int, leaf_idx: int, matching: int,
                 x: torch.Tensor):
        """U[0, 1) noise shaped like ``x`` for (round, leaf, matching)."""
        return _uniforms(self._uniforms, key, (rounds, leaf_idx, matching), x)

    def leaf_bits(self, d: int) -> float:
        """Effective wire bits per node for one leaf: ceil(log2(2qmax+1))
        per entry — 8 for int8, 4 for the int4 rate riding the int8
        container — plus the per-(node, block) float32 scales."""
        bits = math.ceil(math.log2(2 * self._qmax + 1))
        return float(bits * d + 32 * self.compressor._n_blocks(d))


def make_codec_wire(compression: CompressionConfig,
                    uniforms: UniformsFn | None = None,
                    clock: RebaseClock | None = None) -> CodecWire:
    """``error_feedback=True`` → :class:`ChocoWire` (+ optional clock),
    False → :class:`CodecWire`."""
    if compression.error_feedback:
        return ChocoWire(compression, uniforms, clock=clock)
    if clock is not None:
        raise ValueError("the delta/re-base clock belongs to the "
                         "error-feedback wire")
    return CodecWire(compression, uniforms)
