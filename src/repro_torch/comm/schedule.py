"""Compression schedules: anneal the wire codec as consensus contracts.

The port of ``repro.comm.schedule``.  A schedule moves the codec rate every
round — the quantization ceiling qmax for int8/int4 (127 → 7), the kept
fraction for topk/randk — driven by the round counter (``linear``) or by the
error-feedback innovation norm ``CommState.res_norm`` against the reference
norm ``res_ref`` latched after a warmup (``adaptive``).

The rate is a 0-d float32 tensor on the parameters' device, as the
reference's is a traced scalar: the quantizers hand it to the kernels as it
is (``repro_torch.kernels.quant_gossip`` reads qmax on the card), so a
scheduled round never copies the rate to the host nor waits for the card.
``rounds`` is a host int, as the port's ``CommState`` keeps it.  What the
rate takes from it is one float32 per round, the schedule's *host part*
(:meth:`CompressionSchedule.host_part`: the constant rate, the linear
ramp's rate in the reference's float32 arithmetic on numpy, or the
adaptive rule's warm-up flag), which the round reads as a 0-d float32
tensor (``part``): a fill in the eager step, a value packed per step where
the trainer replays its step from a CUDA graph.  So the rate and
``update_ref`` run on the device without a host branch on the round, and a
captured round reads its own round's rate.  The rate is clipped to
``[lo, hi]``; for the quantizers that range is checked to lie inside
``[1, 127]`` at construction, which is what keeps a tensor qmax inside the
int8 container without a check per launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.protocol import scalar

_QMAX8 = 127.0
_QMAX4 = 7.0
_TINY = 1e-20


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """How the codec rate moves during training (the reference's fields).

    Attributes:
      kind: "constant" | "linear" | "adaptive".
      rate_hi: full-fidelity rate; None resolves from the codec kind: 127
        for int8, 7 for int4, ``CompressionConfig.ratio`` for topk/randk.
      rate_lo: most aggressive rate; None resolves to 7 for the quantizers
        and ratio/8 for the sparsifiers.
      anneal_rounds: rounds to go hi → lo for kind="linear".
      threshold: adaptive only — the decay fraction ``res_norm / res_ref``
        at (or above) which the codec runs at ``rate_hi``.
      warmup_rounds: adaptive only — rounds run at ``rate_hi`` before the
        reference norm is latched.
      damp_gamma: sparsifiers only — γ_r = min(γ, 2·rate).
    """

    kind: str = "adaptive"
    rate_hi: float | None = None
    rate_lo: float | None = None
    anneal_rounds: int = 300
    threshold: float = 0.5
    warmup_rounds: int = 10
    damp_gamma: bool = False

    def __post_init__(self):
        if self.kind not in ("constant", "linear", "adaptive"):
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError("threshold must be in (0, 1]")
        if self.anneal_rounds < 1:
            raise ValueError("anneal_rounds must be >= 1")


class CompressionSchedule:
    """Maps schedule state (host ``rounds``; 0-d float32 ``res_norm`` and
    ``res_ref`` on the device) to the round's rate, a 0-d float32 tensor on
    the same device."""

    def __init__(self, cfg: ScheduleConfig, compression_kind: str, ratio: float):
        self.sparsifier = compression_kind in ("topk", "randk")
        if compression_kind in ("int8", "int4"):
            hi = _QMAX8 if compression_kind == "int8" else _QMAX4
            lo = _QMAX4
        elif self.sparsifier:
            hi = ratio
            lo = ratio / 8.0
        else:
            raise ValueError(
                f"compression kind {compression_kind!r} has no adjustable "
                "rate; schedules support int8/int4/topk/randk")
        self.cfg = cfg
        self.hi = float(cfg.rate_hi) if cfg.rate_hi is not None else hi
        self.lo = float(cfg.rate_lo) if cfg.rate_lo is not None else lo
        if not self.lo <= self.hi:
            raise ValueError(f"rate_lo {self.lo} > rate_hi {self.hi}")
        if compression_kind in ("int8", "int4"):
            # the wire container is int8: qmax beyond 127 would wrap in the
            # int8 cast, below 1 has no code points
            if not (1.0 <= self.lo and self.hi <= _QMAX8):
                raise ValueError(
                    f"quantizer rates must lie in [1, {_QMAX8:.0f}] "
                    f"(got lo={self.lo}, hi={self.hi})")
        elif not (0.0 < self.lo and self.hi <= 1.0):
            raise ValueError(
                f"sparsifier rates must lie in (0, 1] "
                f"(got lo={self.lo}, hi={self.hi})")
        # the reference's float32 constants
        self._hi32, self._lo32 = np.float32(self.hi), np.float32(self.lo)
        self._dropped = (np.float32(1.0) - self._hi32) * np.float32(cfg.threshold)

    def host_part(self, rounds: int) -> float:
        """The round's host part: the rate of a constant or linear schedule
        (the ramp t = clip(rounds / anneal_rounds, 0, 1) in float32, as the
        reference computes it), and for an adaptive one 1.0 while
        ``rounds`` is inside the warmup, else 0.0.  A float32 value."""
        cfg = self.cfg
        if cfg.kind == "constant":
            return float(self._hi32)
        if cfg.kind == "linear":
            t = np.clip(np.float32(rounds) / np.float32(cfg.anneal_rounds),
                        np.float32(0.0), np.float32(1.0))
            return float(self._hi32 + (self._lo32 - self._hi32) * t)
        return 1.0 if rounds < cfg.warmup_rounds else 0.0

    def _part(self, rounds, part, device) -> torch.Tensor:
        return scalar(self.host_part(rounds), device) if part is None else part

    def rate(self, rounds: int, res_norm: torch.Tensor, res_ref: torch.Tensor,
             part: torch.Tensor | None = None) -> torch.Tensor:
        """The rate for the round about to run.

        Args:
          rounds: compressed rounds completed so far (host int); read only
            where ``part`` is None.
          res_norm: innovation norm ‖θ − θ̂‖ offered on the previous round.
          res_ref: reference norm latched after warmup (0 until then).
          part: the round's :meth:`host_part` as a 0-d float32 tensor on
            the device (None: a fill of it from ``rounds``).
        """
        cfg, dev = self.cfg, res_norm.device
        part = self._part(rounds, part, dev)
        if cfg.kind != "adaptive":
            return part
        hi = scalar(float(self._hi32), dev)
        # adaptive: the constant-resolution rule of the reference
        frac = res_norm / torch.clamp_min(res_ref, _TINY)
        if self.sparsifier:
            # kept fraction 1 − (1 − hi)·threshold/frac: the dropped mass
            # held at its threshold-level budget
            r = 1.0 - scalar(float(self._dropped), dev) / torch.clamp_min(frac, _TINY)
        else:
            # qmax ∝ innovation norm: one bit fewer per halving
            r = hi * frac / scalar(cfg.threshold, dev)
        r = torch.clamp(r, float(self._lo32), float(self._hi32))
        # the warmup (part 1) runs at hi, as does a round before the latch
        return torch.where((part == 0) & (res_ref > 0), r, hi)

    def gamma_for(self, gamma: float, rate):
        """The round's consensus step: ``gamma`` (a host float, so the
        unscheduled arithmetic is unchanged) unless ``damp_gamma`` is set on
        a sparsifier schedule, then min(γ, 2·rate) as a 0-d tensor."""
        if not (self.cfg.damp_gamma and self.sparsifier) or rate is None:
            return gamma
        return torch.minimum(scalar(gamma, rate.device), 2.0 * rate)

    def update_ref(self, rounds: int, res_norm: torch.Tensor,
                   res_ref: torch.Tensor, part: torch.Tensor | None = None) -> torch.Tensor:
        """The reference norm after a round observing ``res_norm``: the
        first post-warmup observation is latched; constant and linear
        schedules keep the field as it is.  ``part`` as in :meth:`rate`."""
        if self.cfg.kind != "adaptive":
            return res_ref
        part = self._part(rounds, part, res_norm.device)
        return torch.where((part == 0) & (res_ref == 0), res_norm, res_ref)
