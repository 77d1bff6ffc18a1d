"""Learning-rate schedules (pure functions step -> lr; the port of
``repro.optim.schedules``).  ``step`` is the train state's host int; the
cosine schedules compute in float32, as the reference's traced step does,
and return that float32 value as a Python float."""

from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: float(lr)


def paper_schedule(k: int, t_total: int):
    """Paper §6.1: η = sqrt(K/T) (constant, set from the horizon)."""
    return constant_schedule((k / max(t_total, 1)) ** 0.5)


def _cosine32(base_lr: float, total_steps: int, final_frac: float, step) -> torch.Tensor:
    frac = torch.clamp(torch.as_tensor(step, dtype=torch.float32) / max(total_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * (final_frac + (1.0 - final_frac) * cos)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        return float(_cosine32(base_lr, total_steps, final_frac, step))

    return sched


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    horizon = max(total_steps - warmup_steps, 1)

    def sched(step):
        if step < warmup_steps:
            warm = torch.tensor(step + 1, dtype=torch.float32) * base_lr
            return float(warm / max(warmup_steps, 1))
        return float(_cosine32(base_lr, horizon, final_frac, step - warmup_steps))

    return sched
