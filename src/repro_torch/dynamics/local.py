"""Local-update rounds with optional gradient tracking, as a Mixer wrapper.

The port of ``repro.dynamics.local``.  :class:`LocalUpdateMixer` runs H
optimizer steps per consensus round (local SGD), with an optional
gradient-tracking correction c_i (Ghiasvand et al., 2025; K-GT) that steers
each node's local descent toward the network-averaged direction.  It wraps
any mixer and works in parameter space (it sees the post-update θ, never
gradients):

  every round:        θ̃_i = θ_i + c_i                (correction, GT only)
  local round:        nothing else happens (0 wire)
  consensus round:    θ⁺ = inner_mix(θ̃)              (the wrapped consensus)
                      Δ_i = θ̃_i − anchor_i           (window progress)
                      c_i += ((W Δ)_i − Δ_i) / H      (tracker exchange)
                      anchor_i = θ⁺_i

State lives in ``CommState.track = (correction, anchor)``, float32 dicts
shaped like the params whose leaves own their storage: the train step
scales gradients in place and the int8 wires accumulate in place, so an
anchor that aliased θ would move with it.  The wrapper owns the round
clock: ``CommState.rounds`` counts optimizer steps (the inner mixer's
increment is overwritten), so a wrapped topology, fault process or rate
schedule advances on the step clock; the EF gossip stack keeps its own
clock of executed rounds in ``ef_rounds``.  Consensus runs on the rounds
``H − 1, 2H − 1, ...``: a branch the host chooses from the host int
``rounds`` (:meth:`LocalUpdateMixer.plan`, passed back as ``branch``; the
trainer captures one graph per branch) where the reference uses
``lax.cond``.  The inner round and the tracker exchange read the round
from the step's clock.

Wire: local rounds report 0 bits; gradient tracking doubles a consensus
round's bits (the tracker Δ is exchanged full-precision beside θ), which is
why it needs an uncompressed inner mixer with a pure ``mix_tree``.
"""

from __future__ import annotations

import torch

from repro_torch.comm.protocol import CommState, Mixer, params_device, scalar
from repro_torch.obs.profiler import scope


def _f32_copy(tree) -> dict:
    """Float32 copies of every leaf, each in a storage of its own."""
    return {n: x.to(torch.float32, copy=True) for n, x in tree.items()}


class LocalUpdateMixer(Mixer):
    """Run H optimizer steps per consensus round, with optional tracking.

    Args:
      inner: any :class:`Mixer` (compressed or not) — performs the
        consensus on rounds ``H-1, 2H-1, ...``.
      period: H ≥ 1; H = 1 degenerates to the inner mixer (plus tracking
        when enabled).
      gradient_tracking: carry the drift correction in ``CommState.track``.
        Requires an uncompressed inner mixer with a pure ``mix_tree`` (the
        dense, gossip and dynamic mixers); the tracker exchange doubles the
        consensus round's wire.
    """

    traced_wire = True  # 0 bits on local rounds

    def __init__(self, inner: Mixer, period: int, gradient_tracking: bool = False):
        if period < 1:
            raise ValueError("period (H) must be >= 1")
        self.inner = inner
        self.period = int(period)
        self.gt = bool(gradient_tracking)
        if self.gt:
            if inner.compression is not None:
                raise ValueError(
                    "gradient tracking needs an uncompressed inner mixer "
                    "(the tracker exchange is full-precision; compose EF "
                    "compression with plain local updates instead)")
            supported = (type(inner).mix_tree is not Mixer.mix_tree
                         or type(inner)._mix is not Mixer._mix)
            if not supported:
                raise ValueError(
                    f"{type(inner).__name__} has no pure mix_tree; gradient "
                    "tracking cannot exchange the tracker through it")

    @property
    def compression(self):
        return self.inner.compression

    # -- state ----------------------------------------------------------------

    def init_state(self, params) -> CommState:
        state = self.inner.init_state(params)
        if self.gt:
            corr = {n: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                    for n, x in params.items()}
            state = state._replace(track=(corr, _f32_copy(params)))
        return state

    def bytes_per_round(self, params) -> int:
        b = self.inner.bytes_per_round(params)
        return 2 * b if self.gt else b

    def host_part(self, rounds: int) -> float:
        return self.inner.host_part(rounds)

    def plan(self, state: CommState):
        """(consensus, the inner round's branch) — (False, None) on a local
        round — and the host ints after the round: ``rounds`` one on, the
        inner round's other clocks (``ef_rounds``) on a consensus round."""
        if state.rounds % self.period != self.period - 1:  # repro: noqa[RPR001] (host ints)
            return (False, None), state._replace(rounds=state.rounds + 1)
        inner, after = self.inner.plan(state)
        return (True, inner), after._replace(rounds=state.rounds + 1)

    # -- the wrapper ----------------------------------------------------------

    def __call__(self, theta, state: CommState, *, round=None, clock=None, branch=None,
                 inplace: bool = False):
        """One round: local, or the inner consensus round, as ``branch``
        (:meth:`plan`'s; None: chosen here from ``state.rounds``) says,
        reading the round from ``clock`` (None: the inner mixer fills it)."""
        if branch is None:
            branch = self.plan(state)[0]
        consensus, inner_branch = branch
        track = state.track
        if self.gt:
            corr, anchor = track
            theta = {n: (x.float() + corr[n]).to(x.dtype) for n, x in theta.items()}
        if not consensus:  # repro: noqa[RPR001] (a host bool: the branch the host chose)
            return theta, state._replace(
                rounds=state.rounds + 1, track=track,
                wire_bits=scalar(0.0, params_device(theta)))
        mixed, st2 = self.inner(theta, state, round=round, clock=clock,
                                branch=inner_branch, inplace=inplace and not self.gt)
        if self.gt:
            delta = {n: x.float() - anchor[n] for n, x in theta.items()}
            with scope("obs:consensus/tracker_exchange"):
                wdelta = self.inner.mix_tree(delta, state, clock)
            corr2 = {n: corr[n] + (wdelta[n] - delta[n]) / self.period for n in corr}
            st2 = st2._replace(track=(corr2, _f32_copy(mixed)), wire_bits=2.0 * st2.wire_bits)
        else:
            st2 = st2._replace(track=track)
        # the wrapper owns the clock: rounds counts optimizer steps
        return mixed, st2._replace(rounds=state.rounds + 1)
