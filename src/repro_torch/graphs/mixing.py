"""Mixing (gossip) matrices: the numpy half of ``repro.graphs.mixing``.

The paper (§6.1) uses Metropolis weights:

    W_ij = 1 / (1 + max(d_i, d_j))          if (i,j) ∈ E
    W_ii = 1 − Σ_{j∈N_i} W_ij
    W_ij = 0                                 otherwise

which yields a symmetric doubly-stochastic matrix with spectral norm
ρ = ||W − J|| < 1 on any connected graph (Assumption 5).  Every numpy
function here returns the same float64 arrays as the reference.

``permutation_decomposition`` rewrites a sparse W as
``W = w_self ⊙ I + Σ_c P_c ⊙ W`` where each ``P_c`` is a partial permutation
(a matching, from edge colouring).  On one card every node lives in one
tensor, so the gossip transport turns each matching into one gather along
the node axis (``src = perm``), where the reference runs one ``ppermute``.

The torch functions (``metropolis_weights_traced``,
``renormalize_masked_weights``, ``symmetric_uniform``) build a round's W on
the caller's device for the time-varying schedules (``repro_torch.dynamics``),
from coins the caller draws (``repro_torch.dynamics.coins``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a (K, K) float32 matrix in one fixed order on every
    device: the columns zero-padded to a power of two and summed by a
    pairwise tree, each level one elementwise add (a reduction kernel's
    order differs between the CPU and the card), so that a round's W is
    the same bits wherever it is computed."""
    width = 1 << max(x.shape[1] - 1, 0).bit_length()
    if width != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def metropolis_weights_traced(adj: torch.Tensor) -> torch.Tensor:
    """Float32 twin of :func:`metropolis_weights` on ``adj``'s device, for
    graphs that change every round.  ``adj`` is a (K, K) symmetric 0/1
    adjacency; zero-degree (isolated) nodes get W_ii = 1."""
    k = adj.shape[0]
    eye = torch.eye(k, dtype=torch.float32, device=adj.device)
    a = adj.float() * (1.0 - eye)
    deg = a.sum(dim=1)
    w = a / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    return w + torch.diag(1.0 - _row_sums(w))


def renormalize_masked_weights(w: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Mask links out of a doubly-stochastic W, returning mass to the diagonal.

    ``w`` is (K, K) doubly stochastic and ``keep`` a symmetric (K, K) 0/1
    link mask (diagonal ignored):

        W'_ij = W_ij · keep_ij                     (i ≠ j)
        W'_ii = W_ii + Σ_j W_ij · (1 − keep_ij)

    W' stays symmetric with exact row sums.  With ``keep ≡ 1`` the result is
    bit-identical to ``w``.  The returned mass is summed in one fixed order
    (:func:`_row_sums`), the same bits on the CPU and the card.
    """
    k = w.shape[0]
    eye = torch.eye(k, dtype=torch.float32, device=w.device)
    off = w * (1.0 - eye)
    kept = off * keep.float()
    returned = _row_sums(off - kept)
    return kept + torch.diag(torch.diagonal(w) + returned)


def symmetric_uniform(u: torch.Tensor) -> torch.Tensor:
    """Symmetric (K, K) U[0,1) matrix with a zero diagonal from a (K, K)
    draw ``u``: one coin per unordered pair, from ``u``'s upper triangle.
    The dense and gossip lowerings read their link coins from this one
    matrix, so they agree on which links dropped."""
    upper = torch.triu(u, 1)
    return upper + upper.T


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


@dataclasses.dataclass(frozen=True)
class MixingDecomposition:
    """W as self-weights + permutation (matching) classes.

    Attributes:
      self_weights: (K,) diagonal of W.
      matchings: list of matchings; each is a (K,) int array ``perm`` where
        ``perm[i] = j`` if i exchanges with j in this round and ``perm[i] = i``
        if i idles.  Matchings are involutions (perm[perm[i]] == i), so
        ``perm`` is also the row node i receives from.
      matching_weights: list of (K,) arrays; entry i is W[i, perm[i]]
        (0 where idle).
    """

    self_weights: np.ndarray
    matchings: list[np.ndarray]
    matching_weights: list[np.ndarray]

    @property
    def num_rounds(self) -> int:
        return len(self.matchings)

    def ppermute_pairs(self) -> list[list[tuple[int, int]]]:
        """Per-matching (src, dst) pairs: node i receives from j = perm[i],
        pair (j, i); idle nodes (fixed points) are omitted.  The count of
        pairs is the matching's directed sends (wire accounting)."""
        k = self.self_weights.shape[0]
        return [
            [(int(p[i]), i) for i in range(k) if int(p[i]) != i]
            for p in self.matchings
        ]

    def reconstruct(self) -> np.ndarray:
        """Rebuild the dense W (for testing exactness)."""
        k = self.self_weights.shape[0]
        w = np.diag(self.self_weights).astype(np.float64)
        for perm, pw in zip(self.matchings, self.matching_weights):
            for i in range(k):
                j = int(perm[i])
                if j != i:
                    w[i, j] += pw[i]
        return w


def _misra_gries_coloring(k: int, edges: list[tuple[int, int]]
                          ) -> tuple[dict[tuple[int, int], int], int]:
    """Misra & Gries (1992) proper edge coloring with at most Δ+1 colors."""
    deg = np.zeros(k, dtype=np.int64)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    n_colors = int(deg.max()) + 1 if len(edges) else 1
    # color_at[u][c] = neighbor matched to u with color c (or -1)
    color_at = np.full((k, n_colors), -1, dtype=np.int64)
    edge_color: dict[tuple[int, int], int] = {}

    def free_colors(u):
        return [c for c in range(n_colors) if color_at[u, c] == -1]

    def set_color(u, v, c):
        color_at[u, c] = v
        color_at[v, c] = u
        edge_color[(min(u, v), max(u, v))] = c

    def unset_color(u, v, c):
        color_at[u, c] = -1
        color_at[v, c] = -1
        edge_color.pop((min(u, v), max(u, v)), None)

    for (x, y) in edges:
        # build maximal fan of x starting at y
        fan = [y]
        fan_set = {y}
        while True:
            extended = False
            last = fan[-1]
            free_last = set(free_colors(last))
            for c in free_last:
                z = color_at[x, c]
                if z != -1 and z not in fan_set:
                    fan.append(z)
                    fan_set.add(z)
                    extended = True
                    break
            if not extended:
                break
        c = free_colors(x)[0]
        d = free_colors(fan[-1])[0]
        if c != d:
            # invert the cd_x path from x
            u, col = x, d
            path = []
            while True:
                v = color_at[u, col]
                if v == -1:
                    break
                path.append((u, v, col))
                u, col = v, (c if col == d else d)
            for (u, v, col) in path:
                unset_color(u, v, col)
            for (u, v, col) in path:
                set_color(u, v, c if col == d else d)
        # rotate the fan up to the first vertex where d is free
        w_idx = len(fan) - 1
        for idx, f in enumerate(fan):
            if color_at[f, d] == -1:
                w_idx = idx
                break
        for idx in range(w_idx):
            nxt = fan[idx + 1]
            col = edge_color[(min(x, nxt), max(x, nxt))]
            unset_color(x, nxt, col)
            set_color(x, fan[idx], col)
        set_color(x, fan[w_idx], d)

    used = sorted({c for c in edge_color.values()})
    remap = {c: i for i, c in enumerate(used)}
    return {e: remap[c] for e, c in edge_color.items()}, len(used)


def _greedy_coloring(k: int, edges: list[tuple[int, int]]
                     ) -> tuple[dict[tuple[int, int], int], int]:
    """Greedy edge coloring (≤ 2Δ−1 worst case, often optimal on regular
    graphs — e.g. exactly 2 colors on even rings where Misra-Gries may use
    Δ+1 = 3)."""
    deg = np.zeros(k, dtype=np.int64)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    order = sorted(edges, key=lambda e: -(deg[e[0]] + deg[e[1]]))
    used: list[set[int]] = [set() for _ in range(k)]
    edge_color: dict[tuple[int, int], int] = {}
    n_colors = 0
    for i, j in order:
        c = 0
        while c in used[i] or c in used[j]:
            c += 1
        edge_color[(i, j)] = c
        used[i].add(c)
        used[j].add(c)
        n_colors = max(n_colors, c + 1)
    return edge_color, n_colors


def permutation_decomposition(w: np.ndarray, atol: float = 1e-12) -> MixingDecomposition:
    """Edge coloring of supp(W) into matchings: the better of greedy and
    Misra-Gries, so at most Δ+1 classes and optimal on the common regular
    topologies.  Each matching is one node-axis gather of the gossip
    transport."""
    w = np.asarray(w, dtype=np.float64)
    k = w.shape[0]
    if not np.allclose(w, w.T, atol=1e-9):
        raise ValueError("mixing matrix must be symmetric")
    edges = [
        (i, j)
        for i in range(k)
        for j in range(i + 1, k)
        if abs(w[i, j]) > atol
    ]
    ec_g, n_g = _greedy_coloring(k, edges)
    ec_mg, n_mg = _misra_gries_coloring(k, edges)
    edge_color, n_colors = (ec_g, n_g) if n_g <= n_mg else (ec_mg, n_mg)
    matchings, matching_weights = [], []
    for c in range(n_colors):
        perm = np.arange(k)
        pw = np.zeros(k, dtype=np.float64)
        for (i, j), col in edge_color.items():
            if col == c:
                perm[i], perm[j] = j, i
                pw[i] = w[i, j]
                pw[j] = w[j, i]
        matchings.append(perm)
        matching_weights.append(pw)
    return MixingDecomposition(
        self_weights=np.diag(w).copy(),
        matchings=matchings,
        matching_weights=matching_weights,
    )
