"""Learning-rate schedules (pure functions step -> lr); the port of the
constant schedules of ``repro.optim.schedules``.  The cosine schedules wait
for the LM slice."""

from __future__ import annotations


def constant_schedule(lr: float):
    return lambda step: float(lr)


def paper_schedule(k: int, t_total: int):
    """Paper §6.1: η = sqrt(K/T) (constant, set from the horizon)."""
    return constant_schedule((k / max(t_total, 1)) ** 0.5)
