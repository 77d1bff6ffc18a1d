from repro_torch.graphs.topology import (
    Graph,
    ring_graph,
    complete_graph,
    star_graph,
    grid_graph,
    torus_graph,
    hypercube_graph,
    erdos_renyi_graph,
    geometric_graph,
    build_graph,
)
from repro_torch.graphs.mixing import (
    metropolis_weights,
    max_degree_weights,
    lazy_metropolis_weights,
    spectral_norm,
    spectral_gap,
    is_doubly_stochastic,
)

__all__ = [
    "Graph",
    "ring_graph",
    "complete_graph",
    "star_graph",
    "grid_graph",
    "torus_graph",
    "hypercube_graph",
    "erdos_renyi_graph",
    "geometric_graph",
    "build_graph",
    "metropolis_weights",
    "max_degree_weights",
    "lazy_metropolis_weights",
    "spectral_norm",
    "spectral_gap",
    "is_doubly_stochastic",
]
