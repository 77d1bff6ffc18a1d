"""Helpers over parameter dicts (``{"fc0/b": tensor, ...}``).

The port keeps the reference's leaves as a flat dict keyed ``"<module>/<leaf>"``
in sorted key order, which is the order ``jax.tree.flatten`` gives the
reference's nested dicts.  That order indexes the wire's noise and the byte
sums, so every function iterates :func:`leaf_names`.
"""

from __future__ import annotations

import torch


def leaf_names(tree: dict) -> list[str]:
    """Leaf keys in the reference's flatten order (sorted)."""
    return sorted(tree)


def tree_bytes(tree: dict) -> int:
    return sum(x.numel() * x.element_size() for x in tree.values())


def tree_node_disagreement(tree: dict) -> torch.Tensor:
    """||θ(I − J)||_F² / K — mean squared distance of nodes to consensus.

    This is the discrepancy quantity bounded by Lemma 3 of the paper.
    """
    sq, n = 0.0, 0
    for name in leaf_names(tree):
        x = tree[name].float()
        sq = sq + (x - x.mean(0, keepdim=True)).square().sum()
        n += x[0].numel()
    k = next(iter(tree.values())).shape[0]
    return sq / (k * max(n, 1))
