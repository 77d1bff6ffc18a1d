"""Time-varying consensus of the port (``repro.dynamics``): topology
schedules, faults (link drops, stragglers, correlated outages), the dynamic
dense and gossip mixers, local updates with gradient tracking
(:class:`LocalUpdateMixer`), and :class:`DynamicsConfig`, whose
``topology="hub"`` builds the federated hub (FedAvg, SCAFFOLD).

Conventions, as in the reference: ``CommState.rounds`` is the dynamics
clock — it ticks per consensus round on a plain mixer and per optimizer
step under :class:`LocalUpdateMixer` (so with period H the rounds H − 1,
2H − 1, ... are consensus rounds, and topology coins, fault windows and
rate schedules advance on the step clock); the EF gossip wire keeps its own
clock of executed rounds in ``CommState.ef_rounds``.  Topology and fault
coins are pure functions of the round; wire accounting counts active
directed links × the per-node payload, so a round whose links are all
masked reports 0 bytes, and gradient tracking doubles a consensus round's
bytes.
"""

from repro_torch.dynamics.config import (
    TOPOLOGY_KINDS,
    DynamicsConfig,
    build_dynamic_mixer,
)
from repro_torch.dynamics.faults import FaultConfig, fault_keep_matrix, replay_fault_masks
from repro_torch.dynamics.local import LocalUpdateMixer
from repro_torch.dynamics.mixers import (
    DynamicCompressedDenseMixer,
    DynamicCompressedGossipMixer,
    DynamicDenseMixer,
    DynamicGossipMixer,
    gather_round_vectors,
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
    "DynamicsConfig", "TOPOLOGY_KINDS", "build_dynamic_mixer",
    "FaultConfig", "fault_keep_matrix", "replay_fault_masks",
    "LocalUpdateMixer",
    "DynamicDenseMixer", "DynamicGossipMixer", "DynamicCompressedDenseMixer",
    "DynamicCompressedGossipMixer", "gather_round_vectors",
    "TopologySchedule", "StaticSchedule", "RoundRobinSchedule",
    "DropoutSchedule", "GeometricRedrawSchedule", "make_schedule",
]
