"""KL-regularized distributionally-robust objective (paper §4, Eq. 6-9).

The port of ``repro.core.robust``.  The min-max problem
min_Θ max_{λ∈Δ} Σ λ_i f_i(Θ) − μ·KL(λ ‖ 1/K) collapses, after exact inner
maximization, to min_Θ (1/K) Σ_i exp(f_i(Θ)/μ) (Eq. 8).  DR-DSGD realizes
this with a per-node multiplicative factor on the local stochastic gradient:
scale_i = h_i/μ = exp(ℓ̄_i/μ)/μ (Alg. 2, line 3).  Assumption 4 (bounded
loss) is enforced with a configurable clip before the exponent.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Configuration of the KL-DRO reweighting.

    Attributes:
      mu: regularization strength μ. μ→∞ recovers ERM/DSGD; smaller μ is more
        robust/fair. The paper's experiments use μ ∈ [2, 9].
      loss_clip: upper clip M on the scalar loss before exponentiation
        (Assumption 4 / App. A.1). None disables.
      enabled: False degrades the trainer to vanilla DSGD (the paper's
        baseline), keeping everything else identical.
    """

    mu: float = 6.0
    loss_clip: float | None = 10.0
    enabled: bool = True

    def __post_init__(self):
        if self.mu <= 0:
            raise ValueError(f"mu must be > 0, got {self.mu}")


def _clipped(losses: torch.Tensor, cfg: RobustConfig) -> torch.Tensor:
    ell = losses.float()
    return ell if cfg.loss_clip is None else torch.clamp(ell, max=cfg.loss_clip)


def robust_scale(loss: torch.Tensor, cfg: RobustConfig) -> torch.Tensor:
    """Gradient scale h(θ;μ)/μ = exp(ℓ̄/μ)/μ, elementwise (e.g. (K,) losses).

    With ``enabled=False`` returns ones (DSGD).
    """
    if not cfg.enabled:
        return torch.ones_like(loss, dtype=torch.float32)
    return torch.exp(_clipped(loss, cfg) / cfg.mu) / cfg.mu


def robust_objective(node_losses: torch.Tensor, cfg: RobustConfig) -> torch.Tensor:
    """μ·log((1/K) Σ exp(f_i/μ)): the soft-max of node losses (Eq. 7).

    In loss units; → mean(losses) as μ→∞.  The logsumexp is centred on
    mean(ℓ) so large μ does not lose the signal to fp32 cancellation.
    """
    ell = _clipped(node_losses, cfg)
    if not cfg.enabled:
        return ell.mean()
    mean = ell.mean()
    return mean + cfg.mu * (
        torch.logsumexp((ell - mean) / cfg.mu, dim=-1) - math.log(ell.shape[-1]))


def mixture_weights(node_losses: torch.Tensor, cfg: RobustConfig) -> torch.Tensor:
    """The implied adversarial mixture λ*_i ∝ exp(f_i/μ) (Eq. 4-6 dual)."""
    ell = _clipped(node_losses, cfg)
    if not cfg.enabled:
        return torch.full_like(ell, 1.0 / ell.shape[-1])
    return torch.softmax(ell / cfg.mu, dim=-1)
