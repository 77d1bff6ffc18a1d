"""Helpers over parameter dicts (``{"fc0/b": tensor, ...}``).

The port keeps the reference's leaves as a flat dict keyed ``"<module>/<leaf>"``
in sorted key order, which is the order ``jax.tree.flatten`` gives the
reference's nested dicts.  That order indexes the wire's noise and the byte
sums, so every function iterates :func:`leaf_names`.
"""

from __future__ import annotations

from typing import Mapping

import torch


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """A nested dict -> a flat dict keyed ``"a/b"`` (leaves as they are)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, name + "/"))
        else:
            out[name] = value
    return out


def unflatten(flat: Mapping) -> dict:
    """The inverse of :func:`flatten`: ``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def subtree(tree: Mapping, prefix: str) -> dict:
    """The leaves under ``prefix`` (``"groups/l0/mix"``), keyed by the rest
    of their name."""
    cut = len(prefix) + 1
    return {name[cut:]: v for name, v in tree.items() if name.startswith(prefix + "/")}


def leaf_names(tree: dict) -> list[str]:
    """Leaf keys in the reference's flatten order (sorted)."""
    return sorted(tree)


def tree_size(tree: dict) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree.values())


def tree_bytes(tree: dict) -> int:
    return sum(x.numel() * x.element_size() for x in tree.values())


def tree_global_norm(tree: dict) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²), each leaf squared and summed in float32."""
    total = sum(tree[n].float().square().sum() for n in leaf_names(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def tree_stack_nodes(trees: list) -> dict:
    """Stack a list of identical parameter dicts along a new leading node axis."""
    return {n: torch.stack([t[n] for t in trees]) for n in trees[0]}


def tree_unstack_nodes(tree: dict, k: int) -> list:
    """Inverse of :func:`tree_stack_nodes`."""
    return [{n: x[i] for n, x in tree.items()} for i in range(k)]


def tree_node_mean(tree: dict) -> dict:
    """Average over the leading node axis of every leaf."""
    return {n: x.mean(0) for n, x in tree.items()}


def tree_cast(tree: dict, dtype: torch.dtype) -> dict:
    """Floating leaves cast to ``dtype``; other leaves as they are."""
    return {n: x.to(dtype) if x.is_floating_point() else x for n, x in tree.items()}


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
