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
``rounds`` is a host int, as the port's ``CommState`` keeps it, so the
warmup and the linear ramp are host arithmetic (float32 on numpy, the
reference's float32 operations) and only the adaptive rule runs on the
device.  The rate is clipped to ``[lo, hi]``; for the quantizers that range
is checked to lie inside ``[1, 127]`` at construction, which is what keeps
a tensor qmax inside the int8 container without a check per launch.
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

    def rate(self, rounds: int, res_norm: torch.Tensor, res_ref: torch.Tensor) -> torch.Tensor:
        """The rate for the round about to run.

        Args:
          rounds: compressed rounds completed so far (host int).
          res_norm: innovation norm ‖θ − θ̂‖ offered on the previous round.
          res_ref: reference norm latched after warmup (0 until then).
        """
        cfg, dev = self.cfg, res_norm.device
        if cfg.kind == "constant":
            return scalar(float(self._hi32), dev)
        if cfg.kind == "linear":
            t = np.clip(np.float32(rounds) / np.float32(cfg.anneal_rounds),
                        np.float32(0.0), np.float32(1.0))
            return scalar(float(self._hi32 + (self._lo32 - self._hi32) * t), dev)
        if rounds < cfg.warmup_rounds:
            return scalar(float(self._hi32), dev)
        # adaptive: the constant-resolution rule of the reference
        frac = res_norm / torch.clamp_min(res_ref, _TINY)
        if self.sparsifier:
            # kept fraction 1 − (1 − hi)·threshold/frac: the dropped mass
            # held at its threshold-level budget
            r = 1.0 - scalar(float(self._dropped), dev) / torch.clamp_min(frac, _TINY)
        else:
            # qmax ∝ innovation norm: one bit fewer per halving
            r = scalar(float(self._hi32), dev) * frac / scalar(cfg.threshold, dev)
        r = torch.clamp(r, float(self._lo32), float(self._hi32))
        return torch.where(res_ref > 0, r, scalar(float(self._hi32), dev))

    def gamma_for(self, gamma: float, rate):
        """The round's consensus step: ``gamma`` (a host float, so the
        unscheduled arithmetic is unchanged) unless ``damp_gamma`` is set on
        a sparsifier schedule, then min(γ, 2·rate) as a 0-d tensor."""
        if not (self.cfg.damp_gamma and self.sparsifier) or rate is None:
            return gamma
        return torch.minimum(scalar(gamma, rate.device), 2.0 * rate)

    def update_ref(self, rounds: int, res_norm: torch.Tensor,
                   res_ref: torch.Tensor) -> torch.Tensor:
        """The reference norm after a round observing ``res_norm``: the
        first post-warmup observation is latched; constant and linear
        schedules keep the field as it is."""
        if self.cfg.kind != "adaptive" or rounds < self.cfg.warmup_rounds:
            return res_ref
        return torch.where(res_ref == 0, res_norm, res_ref)
