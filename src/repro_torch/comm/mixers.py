"""Compressed consensus with error feedback (layer-stack shim).

The port of ``repro.comm.mixers`` for the dense lowering.  With
``error_feedback=True`` (the default) nodes gossip compressed *innovations*
(CHOCO-style): every node keeps a public copy θ̂_i its neighbours can
reconstruct, transmits only the compressed innovation, and applies the
consensus correction against the public copies:

    q_i = C(θ_i − θ̂_i),   θ̂_i ← θ̂_i + q_i,
    θ_i ← θ_i + γ·(Σ_j W_ij θ̂_j − θ̂_i).

* :class:`CompressedDenseMixer` = Static topology × Dense transport × codec
  wire: a matrix product over the public copies; the payload is
  *accounted*, the arithmetic is the one a real wire would give.
* :class:`CompressedGossipMixer` = frozen decomposition × Gossip transport
  × codec wire: each matching gathers the compressed payload and the
  receiver dequantize-accumulates it into its running mix cache
  s_i = Σ_j W_ij θ̂_j (the fused B.3 kernel on the card with
  ``use_kernel=True``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.compressors import CompressionConfig
from repro_torch.comm.topology import StaticTopology
from repro_torch.comm.transport import DenseTransport, GossipTransport
from repro_torch.comm.wire import UniformsFn, make_codec_wire
from repro_torch.graphs.mixing import MixingDecomposition


class CompressedDenseMixer(ComposedMixer):
    """Compressed consensus via a matrix product over the public copies.

    ``uniforms`` replaces the wire's own stochastic-rounding noise (a test
    hook: see :mod:`repro_torch.comm.wire`).
    """

    def __init__(self, w: np.ndarray, compression: CompressionConfig, *,
                 device="cuda", uniforms: UniformsFn | None = None):
        super().__init__(StaticTopology(w, device), DenseTransport(),
                         make_codec_wire(compression, uniforms))


class CompressedGossipMixer(ComposedMixer):
    """Compressed consensus lowered to one payload gather per matching.

    The reference's ``mesh``, ``node_axis`` and ``param_specs`` mean
    nothing on one card and are dropped; its ``replica_axis`` (the
    hierarchical psum-then-gossip stack) raises until that slice.
    """

    def __init__(self, decomp: MixingDecomposition, compression: CompressionConfig,
                 replica_axis: str | None = None, *, device="cuda",
                 uniforms: UniformsFn | None = None):
        if replica_axis is not None:
            raise NotImplementedError(
                "replica_axis (the hierarchical psum-then-gossip stack) is not "
                "ported yet; it waits for the hierarchical slice")
        super().__init__(None, GossipTransport(decomp, device),
                         make_codec_wire(compression, uniforms))
