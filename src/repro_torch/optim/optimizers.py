"""SGD and global-norm clipping over dicts of node-stacked tensors.

The port of the part of ``repro.optim.optimizers`` the paper's algorithm
uses.  An :class:`Optimizer` is an (init, update) pair mirroring the
reference: ``update(grads, opt_state, params, step) -> (params', state')``.
Updates are out of place, so a state handed to ``update`` stays valid.
:func:`sgd` records its schedule on the optimizer (``sgd_lr``), which is how
the train step recognises plain SGD and fuses it with dense mixing
(``core/drdsgd.py``).  Momentum and Adam wait for a later slice (ROADMAP
A.4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

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
