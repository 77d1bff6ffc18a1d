"""Consensus (mixing) operators over node-stacked parameter dicts.

The port of ``repro.core.consensus`` for one card.  Every factory returns a
:class:`repro_torch.comm.protocol.Mixer` with one calling convention::

    comm  = mixer.init_state(params)               # CommState
    theta, comm = mixer(theta, comm, round=step)   # one consensus round

* ``make_dense_mixer``    — θ ← W θ as a matrix product over the node axis
  (or, with a ``CompressionConfig``, its compressed error-feedback twin).
* ``make_gossip_mixer``   — one node-axis gather per matching of the
  edge-coloured graph (the reference's ``ppermute`` lowering on one card),
  or its compressed twin.
* ``make_identity_mixer`` — no communication (pure local SGD ablation).

The hierarchical, hub and repeated mixers wait for their slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm import (
    CompressedDenseMixer,
    CompressedGossipMixer,
    CompressionConfig,
)
from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.protocol import Mixer
from repro_torch.comm.topology import StaticTopology
from repro_torch.comm.transport import DenseTransport, GossipTransport
from repro_torch.comm.wire import IdentityWire, UniformsFn
from repro_torch.device import resolve_device
from repro_torch.graphs.mixing import MixingDecomposition


class DenseMixer(ComposedMixer):
    """θ_i ← Σ_j W_ij θ_j along the leading node axis, in ``compute_dtype``
    (W cast to it once)."""

    def __init__(self, w: np.ndarray, compute_dtype=torch.float32, *, device="cuda"):
        super().__init__(StaticTopology(w, device), DenseTransport(compute_dtype),
                         IdentityWire())


def make_dense_mixer(w: np.ndarray, compression: CompressionConfig | None = None, *,
                     compute_dtype=torch.float32, device="cuda",
                     uniforms: UniformsFn | None = None) -> Mixer:
    """Dense mixing on ``device`` (or its compressed counterpart, which
    mixes in float32 whatever ``compute_dtype`` says, as the reference's).

    ``uniforms`` is the compressed wire's noise hook (tests only; see
    :mod:`repro_torch.comm.wire`).
    """
    dev = resolve_device(device)
    if compression is not None and compression.enabled:
        return CompressedDenseMixer(w, compression, device=dev, uniforms=uniforms)
    return DenseMixer(w, compute_dtype, device=dev)


class GossipMixer(ComposedMixer):
    """Sparse gossip mixing: one node-axis gather per graph matching."""

    def __init__(self, decomp: MixingDecomposition, *, device="cuda"):
        super().__init__(None, GossipTransport(decomp, device), IdentityWire())


def make_gossip_mixer(decomp: MixingDecomposition,
                      compression: CompressionConfig | None = None, *,
                      device="cuda", uniforms: UniformsFn | None = None) -> Mixer:
    """Gossip mixing on ``device`` (or its compressed counterpart).  The
    reference's ``mesh``, ``node_axis`` and ``param_specs`` are dropped: one
    card holds every node."""
    if compression is not None and compression.enabled:
        return CompressedGossipMixer(decomp, compression, device=device,
                                     uniforms=uniforms)
    return GossipMixer(decomp, device=device)


class IdentityMixer(ComposedMixer):
    """No communication — for ablations (pure local SGD)."""

    def __init__(self):
        super().__init__(None, None, IdentityWire())


def make_identity_mixer() -> Mixer:
    return IdentityMixer()
