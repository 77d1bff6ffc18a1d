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
* ``make_hub_mixer``      — the federated lowering: every consensus round
  is the exact server average (W = 11ᵀ/K, the ρ = 0 endpoint).  Under
  ``LocalUpdateMixer`` this is FedAvg; with ``gradient_tracking=True`` the
  tracker correction is SCAFFOLD's control variate.
* ``repeat_mixer``        — several consensus rounds per optimizer step.

The hierarchical mixer waits for its slice (it is multi-device).
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
from repro_torch.comm.protocol import (
    CommState,
    Mixer,
    RoundClock,
    params_device,
    scalar,
)
from repro_torch.comm.topology import StarTopology, StaticTopology
from repro_torch.comm.transport import DenseTransport, GossipTransport, StarTransport
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


class HubMixer(ComposedMixer):
    """Hub-and-spoke (federated) consensus: the exact global average.

    Star topology × star transport: each round every node uploads its block
    and downloads the mean, so one round reaches consensus exactly (ρ = 0).
    ``LocalUpdateMixer(HubMixer(k), H)`` is FedAvg with H local steps;
    adding ``gradient_tracking=True`` yields the SCAFFOLD control variate
    (the tracker update (Δ̄ − Δ_i)/H under W = 11ᵀ/K is exactly c_i).
    """

    def __init__(self, k: int, *, device="cuda"):
        super().__init__(StarTopology(k, device), StarTransport(k), IdentityWire())


def make_hub_mixer(k: int, compression: CompressionConfig | None = None, *,
                   device="cuda", uniforms: UniformsFn | None = None) -> Mixer:
    """Federated server averaging on ``device`` (or its compressed twin).

    The compressed hub rides the dense transport with the star W: the codec
    round re-mixes the full public-copy matrix, which with W = 11ᵀ/K is
    "the server averages the reconstructed client innovations" (with
    ``use_kernel`` int8, one grouped B.2 launch per round on the card).
    """
    if compression is not None and compression.enabled:
        return CompressedDenseMixer(np.full((k, k), 1.0 / k), compression,
                                    device=device, uniforms=uniforms)
    return HubMixer(k, device=device)


def scheduled(mixer) -> bool:
    """Whether ``mixer`` (wrappers peeled) has a codec wire with a rate
    schedule, whose host part moves from round to round."""
    while mixer is not None:
        if getattr(getattr(mixer, "wire", None), "schedule", None) is not None:
            return True
        mixer = getattr(mixer, "inner", None)
    return False


class RepeatMixer(Mixer):
    """θ ← θ·W^rounds: several consensus rounds per optimizer step.

    Theorem 1's consensus term contracts like ρ^rounds, so m rounds on a
    sparse graph can stand in for a denser graph at m× the wire.
    ``wire_bits`` sums the inner rounds' bits.  Inner round j runs at the
    clock's round + j·(the inner rounds' advance), computed on the device,
    with its own branch from :meth:`plan`.  Under a rate schedule the later
    inner rounds fill their clocks from the host ints (those stacks run
    eagerly: ``repro_torch.core.drdsgd.capture_declined``).
    """

    def __init__(self, mixer: Mixer, rounds: int):
        if rounds < 1:
            raise ValueError("rounds must be >= 1")
        self.inner = mixer
        self.rounds = rounds
        self._scheduled = scheduled(mixer)

    @property
    def compression(self):
        return self.inner.compression

    @property
    def traced_wire(self) -> bool:
        return self.inner.traced_wire

    def init_state(self, params) -> CommState:
        return self.inner.init_state(params)

    def host_part(self, rounds: int) -> float:
        return self.inner.host_part(rounds)

    def plan(self, state: CommState):
        """The inner rounds' branches, in order, and the host ints after
        them."""
        branches = []
        for _ in range(self.rounds):
            branch, state = self.inner.plan(state)
            branches.append(branch)
        return tuple(branches), state

    def __call__(self, theta, state: CommState, *, round=None, clock=None, branch=None,
                 inplace: bool = False):
        if branch is None:
            branch = self.plan(state)[0]
        rounds0 = state.rounds
        total_bits = scalar(0.0, params_device(theta))
        for j in range(self.rounds):
            if clock is not None and j > 0:
                # inner round j at the clock's round + (the rounds run so
                # far); a scheduled wire's later rounds fill their clocks
                # from the host ints (those stacks run eagerly)
                clock = None if self._scheduled else RoundClock(
                    clock.round + (state.rounds - rounds0), clock.part)
                rounds0 = state.rounds
            theta, state = self.inner(theta, state, round=round, clock=clock,
                                      branch=branch[j], inplace=inplace)
            total_bits = total_bits + state.wire_bits
        # wire_bits is per-step accounting: sum the inner rounds
        return theta, state._replace(wire_bits=total_bits)

    def bytes_per_round(self, params) -> int:
        return self.rounds * self.inner.bytes_per_round(params)


def repeat_mixer(mixer: Mixer, rounds: int) -> Mixer:
    return RepeatMixer(mixer, rounds)
