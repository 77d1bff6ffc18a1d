"""Declarative dynamics setup: one config object from CLI to mixer.

The port of ``repro.dynamics.config``.  :class:`DynamicsConfig` is the
dynamics twin of ``CompressionConfig``: which
:class:`~repro_torch.dynamics.schedule.TopologySchedule` the trainer runs.
:func:`build_dynamic_mixer` assembles the dense-lowering mixer stack
(schedule → [compression]); the gossip lowering is built explicitly with
:class:`~repro_torch.dynamics.mixers.DynamicGossipMixer`, as in the
reference.

Options of later slices are accepted by the config and raise
``NotImplementedError`` naming that slice: ``local_updates > 1`` and
``gradient_tracking`` (local SGD), ``faults``, and ``topology="hub"``
(federated).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.comm.compressors import CompressionConfig
from repro_torch.comm.protocol import Mixer
from repro_torch.dynamics.mixers import DynamicCompressedDenseMixer, DynamicDenseMixer
from repro_torch.dynamics.schedule import make_schedule

TOPOLOGY_KINDS = ("static", "round_robin", "dropout", "geometric", "hub")


def _faults_enabled(faults) -> bool:
    return faults is not None and getattr(faults, "enabled", True)


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Dynamic-graph training knobs, threaded from CLI to the mixer stack.

    Attributes:
      topology: "static" | "round_robin" | "dropout" | "geometric" — the
        per-round topology process (``repro_torch.dynamics.schedule``) — or
        "hub", the federated lowering (not ported yet).
      drop_p: link dropout probability for topology="dropout".
      radius: connection radius for topology="geometric" re-draws.
      local_updates: H — optimizer steps per consensus round (not ported
        beyond 1 yet).
      gradient_tracking: local-update drift correction (not ported yet).
      faults: the reference's ``FaultConfig`` (not ported yet; must be None).
      ef_rebase_every: B — re-base period of the error-feedback compressed
        gossip lowering; 0 = never (static topologies only).  The dense EF
        lowering ignores it.
      ef_rebase_threshold: adaptive re-base: when > 0, the EF gossip
        lowering re-bases the round its cache drift exceeds this threshold
        instead of on the B clock.
      seed: schedule seed.
    """

    topology: str = "static"
    drop_p: float = 0.0
    radius: float = 0.5
    local_updates: int = 1
    gradient_tracking: bool = False
    faults: Any = None
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
        if self.topology == "hub" and _faults_enabled(self.faults):
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
        if self.topology == "hub":
            raise NotImplementedError(
                "topology='hub' is not ported yet; it waits for the federated "
                "slice (hub/FedAvg/SCAFFOLD)")
        if self.local_updates > 1 or self.gradient_tracking:
            raise NotImplementedError(
                "local_updates > 1 and gradient_tracking are not ported yet; "
                "they wait for the local-updates slice (LocalUpdateMixer)")
        if _faults_enabled(self.faults):
            raise NotImplementedError(
                "faults are not ported yet; they wait for the faults slice")

    @property
    def enabled(self) -> bool:
        """False when the config describes a static synchronous run."""
        return (self.topology != "static"
                or self.local_updates > 1
                or self.gradient_tracking
                or _faults_enabled(self.faults))


def build_dynamic_mixer(cfg: DynamicsConfig, w: np.ndarray,
                        compression: CompressionConfig | None = None, *,
                        device="cuda") -> Mixer:
    """Assemble the dense-lowering mixer stack for a dynamics config on
    ``device``.  ``w`` is the base doubly-stochastic matrix;
    topology="geometric" keeps only its K."""
    schedule = make_schedule(
        cfg.topology, w=w, k=int(np.asarray(w).shape[0]),
        drop_p=cfg.drop_p, radius=cfg.radius, seed=cfg.seed, device=device)
    if compression is not None and compression.enabled:
        return DynamicCompressedDenseMixer(schedule, compression)
    return DynamicDenseMixer(schedule)
