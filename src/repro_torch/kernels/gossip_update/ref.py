"""Plain PyTorch versions of the fused gossip update (paper Eq. 9 / Eq. 20).

``gossip_update_ref`` is the reference's per-node form in the order of its
Pallas kernel (``repro/kernels/gossip_update/kernel.py``): float32
``(θ − (η·s)·g)``, the self weight, then one weighted neighbour at a time.
``gossip_update_stacked_ref`` is every node of a node-stacked leaf in the
order of the port's unfused train step — the robust scale ``g·s``, SGD's
``θ − η·(g·s)``, then the dense mixer's ``W @ u`` in float32 — so a step
that calls it computes the same bits as one that calls the optimizer and the
mixer; ``gossip_update_stacked_grouped_ref`` is it over every leaf of a
group, in order.  The stacked forms take η as a float or a 0-d float32
tensor (the kernel's pointer), multiplied in float32 and rounded once to
θ's dtype as SGD's float step size is, and write into ``out`` where
given.  The CPU path of the port and the tests use them; on the
card they serve only as the kernel's yardstick.
"""

from __future__ import annotations

import torch


def gossip_update_ref(theta, grad, neighbors, weights, scale, *, eta: float):
    """theta, grad: (D,); neighbors: (N, D); weights: (N+1,); scale: ().

    Returns ``W_ii·(θ − η·s·g) + Σ_n W_in·nbr_n`` in θ's dtype."""
    f32 = torch.float32
    acc = weights[0] * (theta.to(f32) - (eta * scale.to(f32)) * grad.to(f32))
    for n in range(neighbors.shape[0]):
        acc = acc + weights[n + 1] * neighbors[n].to(f32)
    return acc.to(theta.dtype)


def gossip_update_stacked_ref(theta, grad, w, scale, *, eta, out=None):
    """theta, grad: (K, ...); w: (K, K); scale: (K,); eta a float or a 0-d
    float32 tensor.

    Returns ``W @ (θ − η·(s⊙g))`` over the leading node axis, in θ's dtype
    (into ``out`` where given)."""
    k = theta.shape[0]
    s = scale.reshape((-1,) + (1,) * (grad.ndim - 1)).to(grad.dtype)
    gs = (grad * s).to(theta.dtype)
    if isinstance(eta, torch.Tensor):
        step = (eta.float() * gs.float()).to(theta.dtype)
    else:
        step = eta * gs
    u = theta - step
    new = (w @ u.reshape(k, -1).float()).reshape(theta.shape).to(theta.dtype)
    return new if out is None else out.copy_(new)


def gossip_update_stacked_grouped_ref(thetas, grads, w, scale, *, eta, out=None):
    """[:func:`gossip_update_stacked_ref` of each leaf], in order."""
    outs = [None] * len(thetas) if out is None else out
    return [gossip_update_stacked_ref(theta, grad, w, scale, eta=eta, out=o)
            for theta, grad, o in zip(thetas, grads, outs)]
