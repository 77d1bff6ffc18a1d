"""Wire layer: what crosses each link, and the ``CommState`` fields it owns.

The port of ``repro.comm.wire`` for the static stacks: one of the three
composable consensus layers (see ``comm/composed.py``).  A wire declares —
via ``init_fields`` — exactly the ``CommState`` fields it needs, spliced over
the trivial state, so adding a wire never perturbs fields it does not own.

:class:`IdentityWire` — full-precision parameters; trivial state.
:class:`CodecWire`    — memoryless codec: C(θ) crosses the wire every round.
                        Owns ``key``.
:class:`ChocoWire`    — CHOCO error feedback: compressed *innovations*
                        against public copies θ̂.  Owns ``hat`` too.

The re-base clock and the masked gossip wire of the reference belong to the
gossip and dynamics slices.

Stochastic-rounding noise: the uniforms of round r and leaf i come from a
``torch.Generator`` seeded with a hash of (``CommState.key``, r, i), drawn on
the parameters' device — a pure function of the round, like the reference's
``fold_in`` chain, though not the same numbers.  ``uniforms`` (a callable
``(round, leaf_idx, shape) -> array``) replaces that draw; the parity tests
inject the reference's own uniforms through it.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np
import torch

from repro_torch.comm.compressors import CompressionConfig, make_compressor

UniformsFn = Callable[[int, int, tuple], object]


def _f32_zeros_like(tree):
    return {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for n, x in tree.items()}


def _leaf_payload_bytes(compressor, params, k: int) -> int:
    """Per-round payload bytes one node injects (sum over leaves); the
    per-node leaf size is ``x.numel() // k`` with ``k`` the mixer's node
    count."""
    return sum(compressor.payload_bytes(x.numel() // k) for x in params.values())


def _noise_seed(key: int, rounds: int, leaf_idx: int) -> int:
    digest = hashlib.blake2b(f"{key}:{rounds}:{leaf_idx}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1  # manual_seed takes < 2**63


class Wire:
    """Payload-semantics layer base: trivial state, no codec."""

    compression: CompressionConfig | None = None
    ef = False

    def init_fields(self, params) -> dict:
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
        self._uniforms = uniforms

    def init_fields(self, params) -> dict:
        return {"key": int(self.compression.seed)}

    def round_wire_bits(self, params, senders: int, k: int) -> int:
        """Wire bits one round injects: senders × per-node payload."""
        return senders * sum(self.compressor.payload_bits(x.numel() // k)
                             for x in params.values())

    def uniforms(self, key: int, rounds: int, leaf_idx: int, x: torch.Tensor):
        """U[0, 1) noise shaped like ``x`` for leaf ``leaf_idx`` of round
        ``rounds``, on ``x``'s device."""
        if self._uniforms is not None:
            u = self._uniforms(rounds, leaf_idx, tuple(x.shape))
            if not isinstance(u, torch.Tensor):
                u = torch.from_numpy(np.array(u, dtype=np.float32))
            return u.to(device=x.device, dtype=torch.float32)
        gen = torch.Generator(device=x.device)
        gen.manual_seed(_noise_seed(key, rounds, leaf_idx))
        return torch.rand(x.shape, generator=gen, dtype=torch.float32,
                          device=x.device)

    def encode_leaf(self, x, hat, u):
        """Compress one flattened (K, d) leaf with uniforms ``u``.

        Returns (payload, public', hat') where ``public'`` is this node's new
        publicly reconstructible value (θ̂' in EF mode, C(θ) memoryless) and
        ``hat'`` the state to carry (θ̂' or ()).
        """
        if self.ef:
            payload = self.compressor.compress(x - hat, u)
            new_hat = hat + self.compressor.decompress(payload, x.shape[1])
            return payload, new_hat, new_hat
        payload = self.compressor.compress(x, u)
        return payload, self.compressor.decompress(payload, x.shape[1]), ()


class ChocoWire(CodecWire):
    """CHOCO error-feedback wire: compressed innovations against θ̂.

    Owns ``hat`` (the public copies — the EF residual is θ − θ̂).
    """

    ef = True

    def __init__(self, compression: CompressionConfig,
                 uniforms: UniformsFn | None = None):
        if not compression.error_feedback:
            raise ValueError("ChocoWire is the error-feedback wire — build "
                             "CodecWire for the memoryless ablation")
        super().__init__(compression, uniforms)

    # one device holds every node, so ``hat`` has no partitioning to declare
    # (the reference's spec_fields serves its pjit layout)
    def init_fields(self, params) -> dict:  # repro: noqa[RPR007]
        return {"hat": _f32_zeros_like(params), "key": int(self.compression.seed)}


def make_codec_wire(compression: CompressionConfig,
                    uniforms: UniformsFn | None = None) -> CodecWire:
    """``error_feedback=True`` → :class:`ChocoWire`, False → :class:`CodecWire`."""
    if compression.error_feedback:
        return ChocoWire(compression, uniforms)
    return CodecWire(compression, uniforms)
