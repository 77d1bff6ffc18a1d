"""Declarative dynamics setup: one config object from CLI to mixer.

The port of ``repro.dynamics.config``.  :class:`DynamicsConfig` is the
dynamics twin of ``CompressionConfig``: everything the trainer needs to
build a time-varying consensus operator — which
:class:`~repro_torch.dynamics.schedule.TopologySchedule`, which faults, the
local-update period H and whether gradient tracking is on.
:func:`build_dynamic_mixer` assembles the dense-lowering mixer stack
(schedule → faults → [compression] → [local updates]), or the federated hub
(``topology="hub"``); the gossip lowering is built explicitly with
:class:`~repro_torch.dynamics.mixers.DynamicGossipMixer`, as in the
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.comm.compressors import CompressionConfig
from repro_torch.comm.protocol import Mixer
from repro_torch.dynamics.faults import FaultConfig
from repro_torch.dynamics.local import LocalUpdateMixer
from repro_torch.dynamics.mixers import DynamicCompressedDenseMixer, DynamicDenseMixer
from repro_torch.dynamics.schedule import make_schedule

TOPOLOGY_KINDS = ("static", "round_robin", "dropout", "geometric", "hub")


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Dynamic-graph training knobs, threaded from CLI to the mixer stack.

    Attributes:
      topology: "static" | "round_robin" | "dropout" | "geometric" — the
        per-round topology process (``repro_torch.dynamics.schedule``) — or
        "hub": the federated hub-and-spoke lowering (every consensus round
        is the exact server average, W = 11ᵀ/K; with ``local_updates`` H > 1
        this is FedAvg, and adding ``gradient_tracking`` yields SCAFFOLD's
        control variate).  "hub" has no fault model, so it refuses
        ``faults``.
      drop_p: link dropout probability for topology="dropout".
      radius: connection radius for topology="geometric" re-draws.
      local_updates: H — optimizer steps per consensus round (H > 1 = local
        SGD between mixes).
      gradient_tracking: carry the drift correction of
        :class:`~repro_torch.dynamics.local.LocalUpdateMixer` (needs an
        uncompressed wire; 2× consensus bytes).
      faults: optional :class:`~repro_torch.dynamics.faults.FaultConfig`
        (stragglers, correlated outages, extra link dropout) composed on
        top of the schedule.
      ef_rebase_every: B — re-base period of the error-feedback compressed
        gossip lowering; 0 = never (static fault-free topologies only).  The
        dense EF lowering ignores it.
      ef_rebase_threshold: adaptive re-base: when > 0, the EF gossip
        lowering re-bases the round its cache drift exceeds this threshold
        instead of on the B clock.
      seed: schedule seed (the fault process has its own in ``FaultConfig``).
    """

    topology: str = "static"
    drop_p: float = 0.0
    radius: float = 0.5
    local_updates: int = 1
    gradient_tracking: bool = False
    faults: FaultConfig | None = None
    ef_rebase_every: int = 8
    ef_rebase_threshold: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.topology not in TOPOLOGY_KINDS:
            raise ValueError(
                f"unknown topology {self.topology!r}; options: "
                f"{TOPOLOGY_KINDS}")
        if self.local_updates < 1:
            raise ValueError("local_updates (H) must be >= 1")
        if self.ef_rebase_every < 0:
            raise ValueError("ef_rebase_every (B) must be >= 0")
        if self.ef_rebase_threshold < 0:
            raise ValueError("ef_rebase_threshold must be >= 0")
        if self.topology == "dropout" and not 0.0 <= self.drop_p < 1.0:
            raise ValueError("drop_p must be in [0, 1)")
        if (self.topology == "hub" and self.faults is not None
                and self.faults.enabled):
            raise ValueError(
                "topology='hub' (federated server averaging) has no "
                "fault/schedule model yet — the star topology is static "
                "(ROADMAP: federated faults); drop faults or pick a "
                "decentralized topology")
        if self.drop_p > 0 and self.topology != "dropout":
            # a sweep over --drop-p without --topology dropout must fail
            # loudly, not silently train p identical static baselines
            raise ValueError(
                f"drop_p={self.drop_p} has no effect with topology="
                f"{self.topology!r}; pass topology='dropout' (or use "
                "FaultConfig.link_drop_p to compose dropout with another "
                "schedule)")

    @property
    def enabled(self) -> bool:
        """False when the config describes a static synchronous run."""
        return (self.topology != "static"
                or self.local_updates > 1
                or self.gradient_tracking
                or (self.faults is not None and self.faults.enabled))


def build_dynamic_mixer(cfg: DynamicsConfig, w: np.ndarray,
                        compression: CompressionConfig | None = None, *,
                        device="cuda") -> Mixer:
    """Assemble the dense-lowering mixer stack for a dynamics config on
    ``device``.  ``w`` is the base doubly-stochastic matrix;
    topology="geometric" keeps only its K, and so does topology="hub" (the
    star W = 11ᵀ/K replaces the graph)."""
    k = int(np.asarray(w).shape[0])
    if cfg.topology == "hub":
        from repro_torch.core.consensus import make_hub_mixer

        mixer = make_hub_mixer(k, compression, device=device)
        if cfg.local_updates > 1 or cfg.gradient_tracking:
            # FedAvg; with gradient_tracking the tracker correction under
            # W = 11ᵀ/K is exactly SCAFFOLD's control variate
            mixer = LocalUpdateMixer(mixer, cfg.local_updates,
                                     gradient_tracking=cfg.gradient_tracking)
        return mixer
    schedule = make_schedule(
        cfg.topology, w=w, k=k, drop_p=cfg.drop_p, radius=cfg.radius,
        seed=cfg.seed, device=device)
    if compression is not None and compression.enabled:
        mixer: Mixer = DynamicCompressedDenseMixer(schedule, compression, faults=cfg.faults)
    else:
        mixer = DynamicDenseMixer(schedule, faults=cfg.faults)
    if cfg.local_updates > 1 or cfg.gradient_tracking:
        mixer = LocalUpdateMixer(mixer, cfg.local_updates,
                                 gradient_tracking=cfg.gradient_tracking)
    return mixer
