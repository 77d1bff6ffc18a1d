"""Topology layer: the per-round mixing matrix ``W(round)``.

The port of ``repro.comm.topology``: one of the three composable consensus
layers (see ``comm/composed.py``).

:class:`StaticTopology`    — a fixed doubly-stochastic W (ring, ER, ...).
:class:`ScheduledTopology` — a :class:`~repro_torch.dynamics.schedule
                             .TopologySchedule` composed with an optional
                             :class:`~repro_torch.dynamics.faults.FaultConfig`
                             replay (link drops, stragglers and outages
                             renormalised back to doubly stochastic): the
                             round's W is a device tensor computed from the
                             round index.
:class:`StarTopology`      — hub-and-spoke: ``W = 11ᵀ/K``, the exact server
                             average of federated optimisation.

Every round's fault masks come from :func:`round_fault_masks`, the one place
the topology and the train step's ``straggler_skips_compute`` draw them.
``round_w`` takes the round as a 0-d int64 tensor on the device (a host int
is filled into one), which the schedule and the fault coins read there, so
a captured step computes the W_r of the round it replays.  Per-round
quantities (W_r, the gathered weights and masks, the active-link counts)
stay on the parameters' device: nothing here reads a device value back to
the host, but for two eager-only stacks that hand the round to host code:
a schedule class the port does not define, and a replaced
:func:`round_fault_masks` seam (the tests inject the reference's masks
through it), which get the round as a host int.  The trainer captures
neither (:func:`repro_torch.core.drdsgd.capture_declined`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.protocol import round_tensor
from repro_torch.device import resolve_device
from repro_torch.graphs.mixing import renormalize_masked_weights


def active_links(w: torch.Tensor) -> torch.Tensor:
    """Count (0-d float32 on w's device) of directed links with nonzero
    weight this round."""
    k = w.shape[0]
    off = 1.0 - torch.eye(k, dtype=torch.float32, device=w.device)
    return ((w > 0).float() * off).sum()


def gather_round_vectors(w: torch.Tensor, perm_idx: torch.Tensor):
    """(self_w, [match_w], [mask]) gathered from a round matrix W_r.

    ``perm_idx`` (M, K) int64 on W's device is the static edge colouring of
    the union support, one involution per matching.  The per-matching edge
    weights and {0, 1} link masks are gathered out of W_r, so a dropped link
    carries weight 0 and mask 0 while the matchings never change.
    """
    k = w.shape[0]
    arange = torch.arange(k, device=w.device)
    pw = torch.where(perm_idx != arange, w[arange, perm_idx], 0.0)
    masks = (pw > 0).float()
    return torch.diagonal(w), list(pw.unbind(0)), list(masks.unbind(0))


def active_sends(masks) -> torch.Tensor:
    """Count (0-d float32) of active directed matching links."""
    sends = masks[0].sum()
    for m in masks[1:]:
        sends = sends + m.sum()
    return sends


def round_fault_masks(faults, round, k: int, device):
    """The round's (keep (K, K), up (K,)) fault masks on ``device``:
    :func:`repro_torch.dynamics.faults.fault_keep_matrix` at ``round`` (a
    0-d int64 tensor on ``device``, or a host int).  Tests replace this
    function to inject the reference's replayed masks; a replacement is
    handed the round as a host int."""
    from repro_torch.dynamics.faults import fault_keep_matrix

    return fault_keep_matrix(faults, round, k, device)


_ROUND_FAULT_MASKS = round_fault_masks  # the seam as defined here


def seam_replaced() -> bool:
    """Whether :func:`round_fault_masks` was replaced (a host callable that
    a captured step could not replay)."""
    return round_fault_masks is not _ROUND_FAULT_MASKS


def fault_masks(faults, round, k: int, device):
    """:func:`round_fault_masks` through the seam as it stands: the round
    tensor to the port's own, the round as a host int to a replacement."""
    if seam_replaced():  # a host callable: the round as a host int (eager stacks only)
        round = int(round)  # repro: noqa[RPR002]
    return round_fault_masks(faults, round, k, device)


class Topology:
    """Per-round mixing-weight provider.

    ``time_varying`` is a class-level contract: a :class:`ScheduledTopology`
    over a static schedule is still time-varying (its W is computed per
    round), as in the reference.
    """

    time_varying: bool = False
    k: int

    def round_w(self, round) -> torch.Tensor:
        """The (K, K) doubly-stochastic W of round ``round`` (a 0-d int64
        tensor on the device, or a host int)."""
        raise NotImplementedError

    def base_weights(self) -> np.ndarray:
        """Host-side base support: the union of every round's nonzeros.
        Raises ``ValueError`` when the support is not statically known
        (geometric re-draws)."""
        raise NotImplementedError


class StaticTopology(Topology):
    """A fixed graph: ``round_w`` is constant (float32 on ``device``, which
    defaults to CUDA and raises without it)."""

    time_varying = False

    def __init__(self, w, device="cuda"):
        self._w_np = np.asarray(w, np.float64)
        if self._w_np.ndim != 2 or self._w_np.shape[0] != self._w_np.shape[1]:
            raise ValueError(f"W must be square, got {self._w_np.shape}")
        self.k = int(self._w_np.shape[0])
        self.w = torch.as_tensor(self._w_np, dtype=torch.float32).to(resolve_device(device))

    def round_w(self, round) -> torch.Tensor:
        return self.w

    def base_weights(self) -> np.ndarray:
        return self._w_np


class ScheduledTopology(Topology):
    """``TopologySchedule`` composed with optional fault replay.

    The faults are a pure function of the round index
    (:func:`round_fault_masks`), so a run replays the same keep-mask
    sequence; the masked W is renormalised back to doubly stochastic on the
    device.  ``faults`` is kept only when enabled (None otherwise).
    ``foreign`` names a schedule class the port does not define (None for
    the port's own), which is handed the round as a host int.
    """

    time_varying = True

    def __init__(self, schedule, faults=None):
        from repro_torch.dynamics.schedule import PORT_SCHEDULES

        self.schedule = schedule
        self.faults = faults if (faults is not None and faults.enabled) else None
        self.k = schedule.k
        self.foreign = (None if type(schedule) in PORT_SCHEDULES
                        else f"a schedule class the port does not define "
                             f"({type(schedule).__name__})")

    def round_w(self, round) -> torch.Tensor:
        r = round_tensor(round, self.schedule.device)
        # a foreign schedule is handed a host int (its stacks run eagerly)
        w = self.schedule.round_weights(int(r) if self.foreign else r)  # repro: noqa[RPR002]
        if self.faults is not None:
            keep, _ = fault_masks(self.faults, r, self.k, w.device)
            w = renormalize_masked_weights(w, keep)
        return w

    def base_weights(self) -> np.ndarray:
        return self.schedule.base_weights()


class StarTopology(Topology):
    """Hub-and-spoke: every consensus round is the exact global average.

    ``W = 11ᵀ/K`` (float32 on ``device``) — the server-averaging step of
    federated optimisation, lowered as a topology so the federated stack
    reuses the dense and star transports.  One round reaches consensus
    exactly (ρ = 0).
    """

    time_varying = False

    def __init__(self, k: int, device="cuda"):
        if k < 1:
            raise ValueError(f"hub topology needs k >= 1, got {k}")
        self.k = int(k)
        self._w_np = np.full((self.k, self.k), 1.0 / self.k, np.float64)
        self.w = torch.as_tensor(self._w_np, dtype=torch.float32).to(resolve_device(device))

    def round_w(self, round) -> torch.Tensor:
        return self.w

    def base_weights(self) -> np.ndarray:
        return self._w_np
