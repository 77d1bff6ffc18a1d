"""Mixing (gossip) matrices: the numpy half of ``repro.graphs.mixing``.

The paper (§6.1) uses Metropolis weights:

    W_ij = 1 / (1 + max(d_i, d_j))          if (i,j) ∈ E
    W_ii = 1 − Σ_{j∈N_i} W_ij
    W_ij = 0                                 otherwise

which yields a symmetric doubly-stochastic matrix with spectral norm
ρ = ||W − J|| < 1 on any connected graph (Assumption 5).  Every function here
returns the same float64 arrays as the reference.  The matching decomposition
(``permutation_decomposition``) belongs to the gossip transport and is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.topology import Graph


def metropolis_weights(graph: Graph) -> np.ndarray:
    """Paper §6.1 Metropolis-Hastings mixing matrix (float64)."""
    k = graph.num_nodes
    deg = graph.degrees
    w = np.zeros((k, k), dtype=np.float64)
    for i, j in graph.edges():
        w[i, j] = w[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    for i in range(k):
        w[i, i] = 1.0 - w[i].sum()
    return w


def max_degree_weights(graph: Graph) -> np.ndarray:
    """W = I − L/(Δ+1): the max-degree gossip matrix."""
    adj = graph.adjacency.astype(np.float64)
    deg = graph.degrees.astype(np.float64)
    alpha = 1.0 / (graph.max_degree + 1.0)
    w = alpha * adj
    np.fill_diagonal(w, 1.0 - alpha * deg)
    return w


def lazy_metropolis_weights(graph: Graph, laziness: float = 0.5) -> np.ndarray:
    """(1−β)·I + β·W — guarantees eigenvalues in (0, 1], useful for analysis."""
    if not 0.0 < laziness <= 1.0:
        raise ValueError("laziness must be in (0, 1]")
    w = metropolis_weights(graph)
    return (1.0 - laziness) * np.eye(graph.num_nodes) + laziness * w


def is_doubly_stochastic(w: np.ndarray, atol: float = 1e-9) -> bool:
    w = np.asarray(w)
    ones = np.ones(w.shape[0])
    return (
        bool(np.allclose(w, w.T, atol=atol))
        and bool(np.allclose(w @ ones, ones, atol=atol))
        and bool((w >= -atol).all())
    )


def spectral_norm(w: np.ndarray) -> float:
    """ρ = ||WᵀW − J||₂ (Assumption 5). Convergence requires ρ < 1."""
    k = w.shape[0]
    j = np.full((k, k), 1.0 / k)
    return float(np.linalg.norm(w.T @ w - j, ord=2))


def spectral_gap(w: np.ndarray) -> float:
    """1 − ρ: larger gap ⇒ faster consensus (third term of Theorem 1)."""
    return 1.0 - spectral_norm(w)
