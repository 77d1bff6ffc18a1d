"""Communication-graph topologies for decentralized learning.

The port's own copy of ``repro.graphs.topology`` (numpy only, the same
graphs from the same seed): ``repro_torch`` imports nothing of ``repro``.

The paper (§6.1, §6.5) evaluates Erdős–Rényi graphs of varying connectivity
``p`` plus geometric, ring and grid graphs; torus, hypercube, star and
complete graphs are provided too, as the reference does.

A :class:`Graph` is a plain frozen dataclass over an adjacency matrix.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected communication graph over ``num_nodes`` devices."""

    name: str
    adjacency: np.ndarray  # (K, K) symmetric 0/1, zero diagonal

    def __post_init__(self):
        adj = np.asarray(self.adjacency)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adjacency must be square, got {adj.shape}")
        if not np.array_equal(adj, adj.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(adj) != 0):
            raise ValueError("adjacency must have zero diagonal")
        object.__setattr__(self, "adjacency", adj.astype(np.int64))

    @property
    def num_nodes(self) -> int:
        return int(self.adjacency.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def num_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    def edges(self) -> list[tuple[int, int]]:
        i, j = np.nonzero(np.triu(self.adjacency, k=1))
        return list(zip(i.tolist(), j.tolist()))

    def neighbors(self, i: int) -> list[int]:
        return np.nonzero(self.adjacency[i])[0].tolist()

    def is_connected(self) -> bool:
        k = self.num_nodes
        if k == 0:
            return False
        seen = np.zeros(k, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in self.neighbors(u):
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        return bool(seen.all())


def _from_edges(name: str, k: int, edges: Sequence[tuple[int, int]]) -> Graph:
    adj = np.zeros((k, k), dtype=np.int64)
    for i, j in edges:
        if i == j:
            continue
        adj[i, j] = adj[j, i] = 1
    return Graph(name=name, adjacency=adj)


def ring_graph(k: int) -> Graph:
    """Ring: node i ↔ (i±1) mod K. Paper Fig. 6(b)."""
    if k < 2:
        raise ValueError("ring needs K >= 2")
    if k == 2:
        return _from_edges("ring", k, [(0, 1)])
    return _from_edges("ring", k, [(i, (i + 1) % k) for i in range(k)])


def complete_graph(k: int) -> Graph:
    return _from_edges(
        "complete", k, [(i, j) for i in range(k) for j in range(i + 1, k)]
    )


def star_graph(k: int) -> Graph:
    """Star (PS-like) topology — kept for baselines/contrast."""
    return _from_edges("star", k, [(0, i) for i in range(1, k)])


def grid_graph(k: int, rows: int | None = None) -> Graph:
    """2D grid (non-wrapping). Paper Fig. 6(c)."""
    if rows is None:
        rows = int(math.isqrt(k))
        while k % rows:
            rows -= 1
    cols = k // rows
    if rows * cols != k:
        raise ValueError(f"cannot factor K={k} into grid {rows}x{cols}")
    edges = []
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            if c + 1 < cols:
                edges.append((u, u + 1))
            if r + 1 < rows:
                edges.append((u, u + cols))
    return _from_edges("grid", k, edges)


def torus_graph(k: int, rows: int | None = None) -> Graph:
    """2D torus — the physical ICI topology of a TPU pod slice."""
    if rows is None:
        rows = int(math.isqrt(k))
        while k % rows:
            rows -= 1
    cols = k // rows
    edges = []
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            edges.append((u, r * cols + (c + 1) % cols))
            edges.append((u, ((r + 1) % rows) * cols + c))
    return _from_edges("torus", k, edges)


def hypercube_graph(k: int) -> Graph:
    """Hypercube over K=2^m nodes: log-K degree, excellent spectral gap."""
    m = k.bit_length() - 1
    if 2**m != k:
        raise ValueError(f"hypercube needs K=2^m, got {k}")
    edges = [(i, i ^ (1 << b)) for i in range(k) for b in range(m) if i < i ^ (1 << b)]
    return _from_edges("hypercube", k, edges)


def erdos_renyi_graph(k: int, p: float, seed: int = 0, ensure_connected: bool = True) -> Graph:
    """Erdős–Rényi G(K, p), re-sampled (then ring-augmented) until connected.

    The paper's default topology (§6.1) with connectivity ratio p.
    """
    rng = np.random.default_rng(seed)
    for _ in range(200):
        mask = rng.random((k, k)) < p
        adj = np.triu(mask, 1)
        adj = (adj | adj.T).astype(np.int64)
        g = Graph("erdos_renyi", adj)
        if not ensure_connected or g.is_connected():
            return g
    # Fall back: overlay a ring so the graph is guaranteed connected.
    ring = ring_graph(k).adjacency
    return Graph("erdos_renyi", np.clip(adj + ring, 0, 1))


def geometric_graph(k: int, radius: float = 0.5, seed: int = 0) -> Graph:
    """Random geometric graph on the unit square. Paper Fig. 6(a)."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        pts = rng.random((k, 2))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        adj = (d2 < radius**2).astype(np.int64)
        np.fill_diagonal(adj, 0)
        g = Graph("geometric", adj)
        if g.is_connected():
            return g
        radius = min(1.5, radius * 1.1)  # grow radius until connected
    raise RuntimeError("could not build a connected geometric graph")


_BUILDERS = {
    "ring": lambda k, **kw: ring_graph(k),
    "complete": lambda k, **kw: complete_graph(k),
    "star": lambda k, **kw: star_graph(k),
    "grid": lambda k, **kw: grid_graph(k, kw.get("rows")),
    "torus": lambda k, **kw: torus_graph(k, kw.get("rows")),
    "hypercube": lambda k, **kw: hypercube_graph(k),
    "erdos_renyi": lambda k, **kw: erdos_renyi_graph(
        k, kw.get("p", 0.3), kw.get("seed", 0)
    ),
    "geometric": lambda k, **kw: geometric_graph(
        k, kw.get("radius", 0.5), kw.get("seed", 0)
    ),
}


def build_graph(kind: str, k: int, **kwargs) -> Graph:
    """Build a graph by name; the CLI entry point for ``--graph``."""
    if kind not in _BUILDERS:
        raise ValueError(f"unknown graph kind {kind!r}; options: {sorted(_BUILDERS)}")
    return _BUILDERS[kind](k, **kwargs)
