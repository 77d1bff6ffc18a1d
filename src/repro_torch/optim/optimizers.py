"""Optimizers and global-norm clipping over dicts of node-stacked tensors
(the port of ``repro.optim.optimizers``).

An :class:`Optimizer` is an (init, update) pair mirroring the reference:
``update(grads, opt_state, params, step) -> (params', state')``, with
``step`` the train state's host int.  Updates are out of place, so a state
handed to ``update`` stays valid.  :func:`sgd` records its schedule on the
optimizer (``sgd_lr``), which is how the train step recognises plain SGD and
fuses it with dense mixing (``core/drdsgd.py``); :func:`momentum`,
:func:`adam` and :func:`chain_clip` leave ``sgd_lr`` unset, so their steps
run unfused (the optimizer, then the mixer), as in the reference.  Adam's
bias corrections are computed in float32 on the host, as the reference
computes them (``t = float32(step) + 1``, ``b ** t``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Schedule = Callable[[int], float]  # step -> lr


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: float(lr)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    sgd_lr: Schedule | None = None  # plain SGD's step size per step; None otherwise


def sgd(lr) -> Optimizer:
    """Plain SGD — the optimizer of DSGD/DR-DSGD (Alg. 1/2, line 3)."""
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        eta = sched(step)
        return {n: p - eta * grads[n].to(p.dtype) for n, p in params.items()}, state

    return Optimizer(init, update, sgd_lr=sched)


class MomentumState(NamedTuple):
    velocity: Any


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum (``nesterov``: the look-ahead update)."""
    sched = _as_schedule(lr)

    def init(params):
        return MomentumState({n: torch.zeros_like(p) for n, p in params.items()})

    def update(grads, state, params, step):
        eta = sched(step)
        vel = {n: beta * v + grads[n].to(v.dtype) for n, v in state.velocity.items()}
        upd = ({n: beta * v + grads[n].to(v.dtype) for n, v in vel.items()} if nesterov
               else vel)
        return {n: p - eta * upd[n] for n, p in params.items()}, MomentumState(vel)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any


def _bias_corrections(b1: float, b2: float, step: int) -> tuple[float, float]:
    """1 - b1**t and 1 - b2**t at t = step + 1, in float32 (exact as floats)."""
    t = torch.tensor(step, dtype=torch.float32) + 1.0
    f32 = torch.float32
    return (float(1.0 - torch.pow(torch.tensor(b1, dtype=f32), t)),
            float(1.0 - torch.pow(torch.tensor(b2, dtype=f32), t)))


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction; ``weight_decay`` adds ``wd * p`` to the
    update (decoupled, AdamW-style)."""
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(mu={n: torch.zeros_like(p) for n, p in params.items()},
                         nu={n: torch.zeros_like(p) for n, p in params.items()})

    def update(grads, state, params, step):
        eta = sched(step)
        bc1, bc2 = _bias_corrections(b1, b2, step)
        mu = {n: b1 * m + (1 - b1) * grads[n].to(m.dtype) for n, m in state.mu.items()}
        nu = {n: b2 * v + (1 - b2) * grads[n].to(v.dtype).square()
              for n, v in state.nu.items()}

        def step_fn(n, p):
            upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p
            return p - eta * upd

        return {n: step_fn(n, p) for n, p in params.items()}, AdamState(mu, nu)

    return Optimizer(init, update)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float, *,
                        nodes: bool = False, inplace: bool = False):
    """Global-norm gradient clipping (stabilizes exp-scaled gradients).

    With ``nodes=True`` every leaf carries a leading node axis and each node
    is clipped by its own global norm (the reference's per-node clip under
    vmap); the returned norm is then (K,).  ``inplace=True`` scales the
    given tensors themselves (the same products), which saves a copy of
    every leaf when the caller owns them.
    """
    if nodes:
        sq = sum(g.float().reshape(g.shape[0], -1).square().sum(1)
                 for g in grads.values())
    else:
        sq = sum(g.float().square().sum() for g in grads.values())
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)

    def apply(g):
        s = (scale.reshape((-1,) + (1,) * (g.ndim - 1)) if nodes else scale).to(g.dtype)
        return g.mul_(s) if inplace else g * s

    return {n: apply(g) for n, g in grads.items()}, gnorm


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm clipping of the gradients it is
    handed (one norm over every leaf, node axis included, as the
    reference's wrapper sees the stacked tree)."""

    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params, step)

    return Optimizer(opt.init, update)
