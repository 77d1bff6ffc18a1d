"""The gossip-update functions the rest of the port calls (the port of
``repro/kernels/gossip_update/ops.py``).

Each dispatcher takes the plain PyTorch version only for tensors on the
CPU, and counts those calls in ``.plain_calls``; for CUDA tensors it
launches the hand-written kernel (B.1) or raises — there is no fallback.
η is a runtime argument: SGD's schedule gives it per step.  The stacked
forms take it as a float or a 0-d float32 tensor on the parameters'
device (the kernel reads it through a pointer: the train step's captured
graph replays the η written before each replay), and the grouped one
writes into ``out`` leaves where given.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gossip_update import kernel as _k
from repro_torch.kernels.gossip_update import ref as _r


def gossip_update_flat(theta, grad, neighbors, weights, scale, *, eta: float):
    """One node: theta, grad (D,); neighbors (N, D); weights (N+1,) with the
    self weight first; scale ().  Returns the mixed update (D,)."""
    if _build.route("gossip_update", theta):
        return _k.gossip_update(theta, grad, neighbors, weights, scale, eta=eta)
    gossip_update_flat.plain_calls += 1
    return _r.gossip_update_ref(theta, grad, neighbors, weights, scale, eta=eta)


def gossip_update_tree(theta_tree, grad_tree, neighbor_trees, weights, scale, *,
                       eta: float):
    """:func:`gossip_update_flat` over every leaf of a (nested) dict.

    ``neighbor_trees`` is a list of dicts shaped like ``theta_tree``, one
    per neighbour; ``weights`` is (N+1,) with the self weight first.
    Returns a dict of the same structure.  On the card every leaf goes to
    one launch of the per-node kernel (:func:`kernel.gossip_update_leaves`,
    the neighbours' leaves read in place); on the CPU the plain version
    runs leaf by leaf."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    paths = []

    def collect(th, path):
        if isinstance(th, dict):
            for key in th:
                collect(th[key], path + (key,))
        else:
            paths.append(path)

    collect(theta_tree, ())
    thetas = [_at(theta_tree, p) for p in paths]
    grads = [_at(grad_tree, p) for p in paths]
    nbrs = [[_at(t, p) for t in neighbor_trees] for p in paths]
    if thetas and _build.route("gossip_update", thetas[0]):
        flat = _k.gossip_update_leaves(thetas, grads, nbrs, weights,
                                       scale.to(thetas[0].device), eta=eta)
    else:
        flat = [gossip_update_flat(th.reshape(-1), g.reshape(-1),
                                   torch.stack([x.reshape(-1) for x in nb]) if nb
                                   else th.new_zeros((0, th.numel())), weights,
                                   scale.to(th.device), eta=eta)
                for th, g, nb in zip(thetas, grads, nbrs)]
    outs = iter(flat)

    def rebuild(th):
        if isinstance(th, dict):
            return {key: rebuild(th[key]) for key in th}
        return next(outs).view(th.shape)

    return rebuild(theta_tree)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def gossip_update_stacked(theta, grad, w, scale, *, eta):
    """Every node of a node-stacked leaf: theta, grad (K, ...); w (K, K);
    scale (K,); eta a float or a 0-d float32 tensor.  Returns ``W @ (θ −
    η·(s⊙g))`` (K, ...)."""
    if _build.route("gossip_update_stacked", theta):
        return _k.gossip_update_stacked(theta, grad, w, scale, eta=eta)
    gossip_update_stacked.plain_calls += 1
    return _r.gossip_update_stacked_ref(theta, grad, w, scale, eta=eta)


def gossip_update_stacked_grouped(thetas, grads, w, scale, *, eta, out=None):
    """:func:`gossip_update_stacked` over every leaf of a group (lists of
    (K, ...) ``thetas`` and ``grads`` of one dtype): one launch on the card.
    Returns one tensor per leaf: new ones, or the leaves of ``out``,
    written."""
    if _build.route("gossip_update_stacked_grouped", w):
        return _k.gossip_update_stacked_grouped(thetas, grads, w, scale, eta=eta, out=out)
    gossip_update_stacked_grouped.plain_calls += 1
    return _r.gossip_update_stacked_grouped_ref(thetas, grads, w, scale, eta=eta, out=out)


# how often the plain version served a call (CPU tensors only)
gossip_update_flat.plain_calls = 0
gossip_update_stacked.plain_calls = 0
gossip_update_stacked_grouped.plain_calls = 0
