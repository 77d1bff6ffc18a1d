"""Time-varying consensus of the port: topology schedules, the dynamic dense
and gossip mixers, and :class:`DynamicsConfig` (``repro.dynamics``).  Faults,
local updates with gradient tracking and the hub wait for their slices."""

from repro_torch.dynamics.config import (
    TOPOLOGY_KINDS,
    DynamicsConfig,
    build_dynamic_mixer,
)
from repro_torch.dynamics.mixers import (
    DynamicCompressedDenseMixer,
    DynamicCompressedGossipMixer,
    DynamicDenseMixer,
    DynamicGossipMixer,
)
from repro_torch.dynamics.schedule import (
    DropoutSchedule,
    GeometricRedrawSchedule,
    RoundRobinSchedule,
    StaticSchedule,
    TopologySchedule,
    make_schedule,
)

__all__ = [
    "TOPOLOGY_KINDS", "DynamicsConfig", "build_dynamic_mixer",
    "DynamicCompressedDenseMixer", "DynamicCompressedGossipMixer",
    "DynamicDenseMixer", "DynamicGossipMixer", "DropoutSchedule",
    "GeometricRedrawSchedule", "RoundRobinSchedule", "StaticSchedule",
    "TopologySchedule", "make_schedule",
]
