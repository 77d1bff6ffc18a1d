"""Consensus communication of the port: Topology × Transport × Wire layers
behind one :class:`~repro_torch.comm.protocol.Mixer` protocol."""

from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.compressors import (
    CompressionConfig,
    IntQuantizer,
    KernelInt8Quantizer,
    NoCompressor,
    make_compressor,
)
from repro_torch.comm.mixers import CompressedDenseMixer, CompressedGossipMixer
from repro_torch.comm.protocol import (
    CommMetrics,
    CommState,
    Mixer,
    trivial_comm_state,
)
from repro_torch.comm.topology import ScheduledTopology, StaticTopology, Topology
from repro_torch.comm.transport import DenseTransport, GossipTransport, Transport
from repro_torch.comm.wire import (
    ChocoWire,
    CodecWire,
    IdentityWire,
    MaskedQuantWire,
    RebaseClock,
    Wire,
    make_codec_wire,
)

__all__ = [
    "ComposedMixer", "CompressionConfig", "IntQuantizer", "KernelInt8Quantizer",
    "NoCompressor", "make_compressor", "CompressedDenseMixer",
    "CompressedGossipMixer", "CommMetrics", "CommState", "Mixer",
    "trivial_comm_state", "ScheduledTopology", "StaticTopology", "Topology",
    "DenseTransport", "GossipTransport", "Transport", "ChocoWire", "CodecWire",
    "IdentityWire", "MaskedQuantWire", "RebaseClock", "Wire", "make_codec_wire",
]
