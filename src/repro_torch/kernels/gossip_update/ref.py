"""Plain PyTorch versions of the fused gossip update (paper Eq. 9 / Eq. 20).

``gossip_update_ref`` is the reference's per-node form in the order of its
Pallas kernel (``repro/kernels/gossip_update/kernel.py``): float32
``(θ − (η·s)·g)``, the self weight, then one weighted neighbour at a time.
``gossip_update_stacked_ref`` is every node of a node-stacked leaf in the
order of the port's unfused train step — the robust scale ``g·s``, SGD's
``θ − η·(g·s)``, then the dense mixer's ``W @ u`` in float32 — so a step
that calls it computes the same bits as one that calls the optimizer and the
mixer; ``gossip_update_stacked_grouped_ref`` is it over every leaf of a
group, in order.  The CPU path of the port and the tests use them; on the
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


def gossip_update_stacked_ref(theta, grad, w, scale, *, eta: float):
    """theta, grad: (K, ...); w: (K, K); scale: (K,).

    Returns ``W @ (θ − η·(s⊙g))`` over the leading node axis, in θ's dtype."""
    k = theta.shape[0]
    s = scale.reshape((-1,) + (1,) * (grad.ndim - 1)).to(grad.dtype)
    u = theta - eta * (grad * s).to(theta.dtype)
    return (w @ u.reshape(k, -1).float()).reshape(theta.shape).to(theta.dtype)


def gossip_update_stacked_grouped_ref(thetas, grads, w, scale, *, eta: float):
    """[:func:`gossip_update_stacked_ref` of each leaf], in order."""
    return [gossip_update_stacked_ref(theta, grad, w, scale, eta=eta)
            for theta, grad in zip(thetas, grads)]
