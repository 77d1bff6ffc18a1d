"""Consensus protocol: ONE calling convention for every mixer.

The port of ``repro.comm.protocol``.  Every consensus operator is a
:class:`Mixer` with the uniform stateful signature

    theta', comm' = mixer(theta, comm, round=step)

where ``theta`` is a dict of node-stacked tensors and ``comm`` the
:class:`CommState` allocated by ``mixer.init_state(params)``.  Uncompressed
mixers carry a trivial state and stamp their static full-precision
``wire_bits`` into it every round, so the train step reads one shape of state
whatever the wire codec.

Host-side fields are Python numbers (``key``: the wire's seed, ``rounds``,
``ef_rounds``);
per-round measurements are 0-d float32 tensors on the parameters' device, so
a training loop never waits on the device to read them.  A round reads the
host ints only through :meth:`Mixer.plan` (which branch it takes, and the
host ints after it); its tensors read the round from a :class:`RoundClock`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class CommMetrics(NamedTuple):
    """Per-round communication accounting, uniform across all mixers.

    wire_bits: f32 — wire bits injected by the last consensus round.
    res_norm:  f32 — error-feedback innovation norm ‖θ − θ̂‖ offered to the
               codec on the last round (0 for uncompressed mixers).
    rounds:    consensus rounds completed.
    """

    wire_bits: Any
    res_norm: Any
    rounds: int


class CommState(NamedTuple):
    """Per-node consensus state threaded through the train loop.

    hat:      public copies θ̂ (float32 dict shaped like the params); the
              error-feedback residual is θ − θ̂.  () for uncompressed mixers
              and for the memoryless (error_feedback=False) wire.
    hat_mix:  the gossip transport's running mix cache s_i = Σ_j W_ij θ̂_j
              (EF wires on the gossip transport); () elsewhere.
    key:      seed of the wire's stochastic rounding; the uniforms of round r
              and leaf i are a pure function of (key, r, i).
    res_norm: f32 — innovation norm ‖θ − θ̂‖_F (over all nodes and leaves)
              offered to the codec on the last round; 0 before the first
              round, in memoryless mode, and for uncompressed mixers.
    res_ref:  f32 — reference norm latched by an adaptive rate schedule
              after its warmup (0 until then, and on other wires).
    rounds:   consensus rounds completed (the schedules' clock).
    wire_bits: f32 — wire bits injected by the last round.
    track:    state carried across rounds by wrapper mixers: the
              gradient-tracking (correction, anchor) of
              :class:`repro_torch.dynamics.LocalUpdateMixer`, two float32
              dicts shaped like the params, each leaf in a storage of its
              own.  () for every plain mixer; inner mixers treat it as
              opaque and wrappers re-attach it after delegating.
    ef_rounds: host int — executed rounds of the clocked EF gossip stack
              (its delta/re-base clock); () on other stacks.
    ef_drift: f32 — the adaptive re-base's cache drift ‖s − W_r θ̂‖_F
              measured on the last round; () unless adaptive.
    """

    hat: Any
    hat_mix: Any
    key: int
    res_norm: torch.Tensor
    res_ref: torch.Tensor
    rounds: int
    wire_bits: torch.Tensor
    track: Any = ()
    ef_rounds: Any = ()
    ef_drift: Any = ()

    @property
    def metrics(self) -> CommMetrics:
        """The accounting view surfaced per step by ``build_train_step``."""
        return CommMetrics(wire_bits=self.wire_bits, res_norm=self.res_norm,
                           rounds=self.rounds)


class RoundClock(NamedTuple):
    """The round a mixer is about to run, as the device reads it.

    round: 0-d int64 — ``CommState.rounds`` (the wire's noise is drawn at it).
    part:  0-d float32 — the wire's rate-schedule host part of that round
           (``CompressionSchedule.host_part``; 0 without a schedule).

    A mixer reads only these two fields, so the trainer hands it its step's
    ``StepScalars`` (``core/drdsgd.py``), whose last two fields they are:
    fills in the eager step, values packed per step beside the batch in the
    captured step, so a replay reads its own round's.
    """

    round: torch.Tensor
    part: torch.Tensor


def scalar(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device`` (a fill, not a host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def trivial_comm_state(seed: int = 0, device="cpu") -> CommState:
    """The uncompressed mixers' state: accounting fields only."""
    zero = scalar(0.0, device)
    return CommState(hat=(), hat_mix=(), key=int(seed), res_norm=zero,
                     res_ref=zero, rounds=0, wire_bits=zero)


def round_tensor(round, device) -> torch.Tensor:
    """The round as a device reads it: a 0-d int64 tensor on ``device`` (a
    tensor as it is, a host int filled into one)."""
    if isinstance(round, torch.Tensor):
        return round
    return torch.full((), int(round), dtype=torch.int64, device=device)


def params_device(params: dict) -> torch.device:
    return next(iter(params.values())).device


class Mixer:
    """Base class of the uniform consensus protocol.

    Subclasses either implement :meth:`_mix` (pure ``theta -> theta`` body;
    the base ``__call__`` handles the state bookkeeping) or override
    :meth:`__call__` outright (the compressed mixers).

    Class attributes:
      compression: the ``CompressionConfig`` the mixer was built with, or
        None for full-precision mixers.
      traced_wire: the train step reports ``wire_bits / 8`` as the step's
        ``comm_bytes`` when True, ``bytes_per_round`` otherwise.
    """

    compression = None
    # True where ``CommState.wire_bits`` is the round's measured wire and the
    # static ``bytes_per_round`` only an estimate (time-varying stacks)
    traced_wire = False

    def init_state(self, params) -> CommState:
        return trivial_comm_state(device=params_device(params))

    def bytes_per_round(self, params) -> int:
        """Static estimate of wire bytes one consensus round injects."""
        raise NotImplementedError

    def _mix(self, theta):
        raise NotImplementedError

    def mix_tree(self, tree, state: CommState, clock: RoundClock | None = None):
        """Pure consensus applied to an arbitrary dict (no state advance, no
        codec) — the gradient-tracking tracker exchange of
        :class:`repro_torch.dynamics.LocalUpdateMixer`, at ``clock``'s round.
        Compressed mixers do not implement this (their wire is entangled
        with their state)."""
        return self._mix(tree)

    def plan(self, state: CommState):
        """The branch the round about to run takes and the state's host ints
        after it, from ``state``'s host ints alone (no tensor is read): the
        host's half of a round whose form depends on its clock, as the
        reference's ``lax.cond`` is.  The base round has one form (None)
        and advances ``rounds`` by one; wrappers and the clocked EF stack
        override it, and their ``__call__`` takes the branch back as
        ``branch``."""
        return None, state._replace(rounds=state.rounds + 1)

    def host_part(self, rounds: int) -> float:
        """The wire's rate-schedule host part of round ``rounds`` (0.0: no
        scheduled codec wire)."""
        return 0.0

    def round_state(self, theta, state: CommState) -> CommState:
        """The state after one full-precision round over ``theta``'s shapes
        (the base ``__call__``'s bookkeeping; the fused train step advances
        the state with it when it mixes through the B.1 kernel)."""
        return state._replace(
            rounds=state.rounds + 1,
            wire_bits=scalar(8.0 * self.bytes_per_round(theta),
                             state.res_norm.device),
        )

    def __call__(self, theta, state: CommState, *, round=None, clock: RoundClock | None = None,
                 branch=None, inplace: bool = False):
        """One consensus round: ``theta', comm' = mixer(theta, comm, round=i)``.
        Every mixer takes the round's ``clock``, :meth:`plan`'s ``branch``
        and ``inplace``; the base round has one form and reads none of them."""
        return self._mix(theta), self.round_state(theta, state)
