"""Consensus mixers over time-varying graphs (layer-stack shims).

The port of ``repro.dynamics.mixers`` for one card.  Every mixer follows
the uniform protocol (``mixer(theta, CommState, round=...)``) and takes the
round's W from its schedule as a device tensor.  All share
:class:`repro_torch.comm.topology.ScheduledTopology` as the topology layer:

* :class:`DynamicDenseMixer`   = Scheduled × Dense × Identity — W_r product;
  runs any schedule including moving-support ones.
* :class:`DynamicGossipMixer`  = Scheduled × Gossip × Identity (or the
  memoryless masked int8/int4 wire with an ``error_feedback=False``
  ``quantized`` config); with an EF config it constructs a
  :class:`DynamicCompressedGossipMixer` instead.
* :class:`DynamicCompressedDenseMixer` = Scheduled × Dense × codec wire —
  EF composes with a moving W exactly on this lowering because the dense
  round re-mixes the full public-copy matrix every round.
* :class:`DynamicCompressedGossipMixer` = Scheduled × Gossip ×
  (ChocoWire + RebaseClock): the incremental ``hat_mix`` cache
  (s_i = Σ_j W_ij θ̂_j) advances by θ̂-delta gossip weighted with the current
  W_r and is re-based from full-precision public copies every
  ``ef_rebase_every`` rounds.

Wire accounting: the dynamic mixers count active directed links × the
per-node payload each round (``wire_bits``, a device tensor).

The reference's ``mesh``, ``node_axis`` and ``param_specs`` mean nothing on
one card and are dropped.  Faults (``faults=``) and the hierarchical
``replica_axis`` raise ``NotImplementedError`` until their slices.
``uniforms`` is the codec wires' noise hook (tests only; see
:mod:`repro_torch.comm.wire`).
"""

from __future__ import annotations

import torch

from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.compressors import CompressionConfig
from repro_torch.comm.mixers import CompressedDenseMixer, CompressedGossipMixer
from repro_torch.comm.topology import ScheduledTopology
from repro_torch.comm.transport import DenseTransport, GossipTransport
from repro_torch.comm.wire import (
    ChocoWire,
    IdentityWire,
    MaskedQuantWire,
    RebaseClock,
    UniformsFn,
    make_codec_wire,
)
from repro_torch.dynamics.schedule import StaticSchedule, TopologySchedule

__all__ = [
    "DynamicDenseMixer", "DynamicGossipMixer",
    "DynamicCompressedDenseMixer", "DynamicCompressedGossipMixer",
]


class DynamicDenseMixer(ComposedMixer):
    """θ ← W_r·θ with the schedule's W_r (matrix-product lowering).  Equal to
    :class:`repro_torch.core.consensus.DenseMixer` under a
    :class:`~repro_torch.dynamics.schedule.StaticSchedule`."""

    def __init__(self, schedule: TopologySchedule, faults=None,
                 compute_dtype=torch.float32):
        super().__init__(ScheduledTopology(schedule, faults),
                         DenseTransport(compute_dtype), IdentityWire())


class DynamicGossipMixer(ComposedMixer):
    """Gossip over the static union-support matchings with per-round weights.

    The edge colouring is frozen at build time from the schedule's base
    support; each round the (K,) self-weights and per-matching edge
    weights/masks are gathered out of W_r, so dropped links carry weight 0.

    With ``quantized`` (a ``CompressionConfig``), the wire depends on
    ``quantized.error_feedback``:

    * ``error_feedback=True`` (the config default) — constructing this
      class returns a :class:`DynamicCompressedGossipMixer`.
    * ``error_feedback=False`` — the memoryless masked wire
      (:class:`repro_torch.comm.wire.MaskedQuantWire`, int8/int4 only): each
      matching runs masked quantize → gather → masked dequantize-accumulate
      (the CUDA kernels B.4/B.5 on the card) with a fresh C(θ) every round.
      ``ef_rebase_every`` is ignored.
    """

    def __new__(cls, schedule: TopologySchedule = None, faults=None,
                quantized: CompressionConfig | None = None,
                ef_rebase_every: int = 8, ef_rebase_threshold: float = 0.0, *,
                uniforms: UniformsFn | None = None):
        if (cls is DynamicGossipMixer and quantized is not None
                and quantized.enabled and quantized.error_feedback):
            # EF wire: the sibling class owns the hat/hat_mix state and the
            # re-base clock.  Returning a non-subclass instance skips this
            # class's __init__ (Python data model).
            return DynamicCompressedGossipMixer(
                schedule, quantized, faults=faults, ef_rebase_every=ef_rebase_every,
                ef_rebase_threshold=ef_rebase_threshold, uniforms=uniforms)
        return super().__new__(cls)

    def __init__(self, schedule: TopologySchedule, faults=None,
                 quantized: CompressionConfig | None = None,
                 ef_rebase_every: int = 8, ef_rebase_threshold: float = 0.0, *,
                 uniforms: UniformsFn | None = None):
        if ef_rebase_threshold > 0:
            raise ValueError(
                "ef_rebase_threshold drives the adaptive hat_mix re-base, "
                "which only exists on the error-feedback wire — pass an "
                "error_feedback=True CompressionConfig")
        topo = ScheduledTopology(schedule, faults)
        transport = GossipTransport(schedule.decomposition(), schedule.device)
        wire = (MaskedQuantWire(quantized, uniforms)
                if quantized is not None and quantized.enabled else IdentityWire())
        super().__init__(topo, transport, wire)


class DynamicCompressedDenseMixer(CompressedDenseMixer):
    """Error-feedback compressed consensus over a dynamic topology: the codec
    wire of :class:`~repro_torch.comm.mixers.CompressedDenseMixer` over the
    schedule's per-round matrix.  A node with no live links this round
    mixes with W row e_i: its θ is untouched and its accumulated innovation
    ships on its next live round."""

    def __init__(self, schedule: TopologySchedule, compression: CompressionConfig,
                 faults=None, *, uniforms: UniformsFn | None = None):
        ComposedMixer.__init__(self, ScheduledTopology(schedule, faults),
                               DenseTransport(), make_codec_wire(compression, uniforms))


class DynamicCompressedGossipMixer(CompressedGossipMixer):
    """Error-feedback compressed gossip over a time-varying topology.

    The static :class:`~repro_torch.comm.mixers.CompressedGossipMixer` keeps
    the incremental cache s_i = Σ_j W_ij θ̂_j current by adding each round's
    received innovations — valid only under a static W.  This stack makes
    EF sound on per-round weights with a two-mode round selected by the
    clock ``CommState.ef_rounds``:

    * **delta rounds** (all but every B-th): the static mixer's EF leaf path
      with this round's gathered weights/masks — masked senders emit
      nothing and freeze their θ̂, and the cache advances by the
      current-W-weighted increments.
    * **re-base rounds** (``ef_rounds % B == B − 1``): the codec still runs
      (θ̂ advances), but the matchings exchange the full-precision public
      copies, and the cache is rebuilt exactly under the current weights.

    ``ef_rebase_every`` (B): 0 never re-bases (only valid for a static
    schedule), 1 re-bases every round.  ``ef_rebase_threshold`` > 0
    replaces the fixed clock with the drift proxy ‖s − W_r θ̂‖_F, measured
    each round (read on the host: one sync per round) and kept in
    ``CommState.ef_drift``.
    """

    def __init__(self, schedule: TopologySchedule, compression: CompressionConfig,
                 faults=None, ef_rebase_every: int = 8,
                 ef_rebase_threshold: float = 0.0,
                 replica_axis: str | None = None, *,
                 uniforms: UniformsFn | None = None):
        if compression is None or not compression.enabled:
            raise ValueError("DynamicCompressedGossipMixer needs an enabled "
                             "CompressionConfig")
        if not compression.error_feedback:
            raise ValueError(
                "error_feedback=False is the memoryless ablation — build "
                "DynamicGossipMixer(quantized=...) for that wire")
        if replica_axis is not None:
            raise NotImplementedError(
                "replica_axis (the hierarchical psum-then-gossip stack) is not "
                "ported yet; it waits for the hierarchical slice")
        transport = GossipTransport(schedule.decomposition(), schedule.device)
        topo = ScheduledTopology(schedule, faults)
        if ef_rebase_every < 0:
            raise ValueError("ef_rebase_every must be >= 0")
        if ef_rebase_threshold < 0:
            raise ValueError("ef_rebase_threshold must be >= 0")
        adaptive = ef_rebase_threshold > 0
        time_varying = not isinstance(schedule, StaticSchedule)
        if ef_rebase_every == 0 and time_varying and not adaptive:
            raise ValueError(
                "ef_rebase_every=0 (never re-base) keeps the incremental "
                "hat_mix cache forever, which is only valid for a static "
                "fault-free W; this schedule/fault config varies per round "
                "— pass ef_rebase_every >= 1 or an ef_rebase_threshold")
        clock = RebaseClock(every=int(ef_rebase_every),
                            threshold=float(ef_rebase_threshold))
        ComposedMixer.__init__(self, topo, transport,
                               ChocoWire(compression, uniforms, clock=clock))
