"""Optimizers and global-norm clipping over dicts of node-stacked tensors
(the port of ``repro.optim.optimizers``).

An :class:`Optimizer` is an (init, update) pair mirroring the reference:
``update(grads, opt_state, params, step) -> (params', state')``, with
``step`` the train state's host int.  Updates are out of place, so a state
handed to ``update`` stays valid.

Each optimizer here also splits its update in two, so that a step can run
it without reading the step on the host (the trainer's captured step):
``scalars(step)``, one host function giving the step's scalars in float32
(η, and for Adam its bias corrections ``bc1``, ``bc2``: ``t =
float32(step) + 1``, ``1 − b ** t``, as the reference computes them on its
traced step), and ``apply(grads, opt_state, params, scalars, inplace)``,
the update reading them as 0-d float32 tensors on the parameters' device.
``update`` is ``apply`` of the step's scalars as fills, so both give the
same bits; ``inplace=True`` writes the new parameters and state into the
given tensors (the same operations: the captured step's slot).  A scalar
meets a leaf of another dtype in float32 and is rounded once to the leaf's
dtype, as a Python number would.  An ``Optimizer(init, update)`` built by
hand has neither, and its step runs eagerly.

:func:`sgd` records its schedule on the optimizer (``sgd_lr``), which is
how the train step recognises plain SGD and fuses it with dense mixing
(``core/drdsgd.py``); :func:`momentum`, :func:`adam` and :func:`chain_clip`
leave ``sgd_lr`` unset, so their steps run unfused (the optimizer, then the
mixer), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
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
    # step -> the step's float32 scalars (η first); None: update only
    scalars: Callable[[int], tuple] | None = None
    # (grads, state, params, scalars as 0-d tensors, inplace) -> (params', state')
    apply: Callable[..., tuple[Any, Any]] | None = None


def _f32(*values) -> tuple:
    return tuple(float(np.float32(v)) for v in values)


def _split(scalars, apply) -> Callable:
    """``update(grads, state, params, step)``: ``apply`` of the step's
    ``scalars`` as fills on the parameters' device."""

    def update(grads, state, params, step):
        dev = next(iter(params.values())).device
        ts = tuple(torch.full((), v, dtype=torch.float32, device=dev) for v in scalars(step))
        return apply(grads, state, params, ts, False)

    return update


def _times(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """s·x for a 0-d float32 ``s``, in x's dtype (a non-float32 x multiplied
    in float32 and rounded once, as a Python scalar is)."""
    return s * x if x.dtype == torch.float32 else (s * x.float()).to(x.dtype)


def _over(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x / s for a 0-d float32 ``s``, in x's dtype (see :func:`_times`)."""
    return x / s if x.dtype == torch.float32 else (x.float() / s).to(x.dtype)


def _into(x: torch.Tensor, inplace: bool) -> torch.Tensor:
    """Where an update of ``x`` is written: ``x`` itself where ``inplace``,
    else a new tensor like it (the same operations either way)."""
    return x if inplace else torch.empty_like(x)


def _decayed(x: torch.Tensor, beta: float, add: torch.Tensor, inplace: bool) -> torch.Tensor:
    """beta·x + add, into ``x`` itself where ``inplace``."""
    return torch.mul(x, beta, out=_into(x, inplace)).add_(add)


def _descend(p: torch.Tensor, step: torch.Tensor, inplace: bool) -> torch.Tensor:
    """p − step, into p itself where ``inplace``."""
    return torch.sub(p, step, out=_into(p, inplace))


def sgd(lr) -> Optimizer:
    """Plain SGD — the optimizer of DSGD/DR-DSGD (Alg. 1/2, line 3)."""
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def scalars(step):
        return _f32(sched(step))

    def apply(grads, state, params, sc, inplace):
        (eta,) = sc
        return {n: _descend(p, _times(eta, grads[n].to(p.dtype)), inplace)
                for n, p in params.items()}, state

    return Optimizer(init, _split(scalars, apply), sgd_lr=sched, scalars=scalars, apply=apply)


class MomentumState(NamedTuple):
    velocity: Any


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum (``nesterov``: the look-ahead update)."""
    sched = _as_schedule(lr)

    def init(params):
        return MomentumState({n: torch.zeros_like(p) for n, p in params.items()})

    def scalars(step):
        return _f32(sched(step))

    def apply(grads, state, params, sc, inplace):
        (eta,) = sc
        state = MomentumState(*state)  # a restored state is a plain tuple
        vel = {n: _decayed(v, beta, grads[n].to(v.dtype), inplace)
               for n, v in state.velocity.items()}
        new = {}
        for n, p in params.items():
            upd = beta * vel[n] + grads[n].to(vel[n].dtype) if nesterov else vel[n]
            new[n] = _descend(p, _times(eta, upd), inplace)
            del upd
        return new, MomentumState(vel)

    return Optimizer(init, _split(scalars, apply), scalars=scalars, apply=apply)


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

    def scalars(step):
        return _f32(sched(step), *_bias_corrections(b1, b2, step))

    def apply(grads, state, params, sc, inplace):
        eta, bc1, bc2 = sc
        state = AdamState(*state)  # a restored state is a plain tuple
        mu = {n: _decayed(m, b1, (1 - b1) * grads[n].to(m.dtype), inplace)
              for n, m in state.mu.items()}
        nu = {n: _decayed(v, b2, (1 - b2) * grads[n].to(v.dtype).square(), inplace)
              for n, v in state.nu.items()}

        def step_fn(n, p):
            upd = _over(_over(mu[n], bc1), torch.sqrt(_over(nu[n], bc2)) + eps)
            if weight_decay:
                upd = upd + weight_decay * p
            return _descend(p, _times(eta, upd), inplace)

        return {n: step_fn(n, p) for n, p in params.items()}, AdamState(mu, nu)

    return Optimizer(init, _split(scalars, apply), scalars=scalars, apply=apply)


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

    if opt.apply is None:
        return Optimizer(opt.init, update)

    def apply(grads, state, params, sc, inplace):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.apply(grads, state, params, sc, inplace)

    return Optimizer(opt.init, update, scalars=opt.scalars, apply=apply)
