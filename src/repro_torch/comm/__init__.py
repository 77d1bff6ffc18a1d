"""Consensus communication of the port: Topology × Transport × Wire layers
behind one :class:`~repro_torch.comm.protocol.Mixer` protocol."""

from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.compressors import (
    BF16Compressor,
    CompressionConfig,
    IntQuantizer,
    KernelInt8Quantizer,
    NoCompressor,
    RandKCompressor,
    TopKCompressor,
    make_compressor,
    quant_bits,
)
from repro_torch.comm.mixers import CompressedDenseMixer, CompressedGossipMixer
from repro_torch.comm.protocol import (
    CommMetrics,
    CommState,
    Mixer,
    trivial_comm_state,
)
from repro_torch.comm.schedule import CompressionSchedule, ScheduleConfig
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
    "ComposedMixer", "CompressionConfig", "NoCompressor", "BF16Compressor",
    "IntQuantizer", "KernelInt8Quantizer", "TopKCompressor", "RandKCompressor",
    "make_compressor", "quant_bits", "ScheduleConfig", "CompressionSchedule",
    "CompressedDenseMixer",
    "CompressedGossipMixer", "CommMetrics", "CommState", "Mixer",
    "trivial_comm_state", "ScheduledTopology", "StaticTopology", "Topology",
    "DenseTransport", "GossipTransport", "Transport", "ChocoWire", "CodecWire",
    "IdentityWire", "MaskedQuantWire", "RebaseClock", "Wire", "make_codec_wire",
]
