"""repro_torch.graphs against repro.graphs: identical float64 W per builder and seed."""

import numpy as np
import pytest

from repro import graphs as ref
from repro_torch import graphs as port

CASES = [
    ("ring", 2, {}), ("ring", 10, {}), ("complete", 6, {}), ("star", 7, {}),
    ("grid", 12, {}), ("grid", 12, {"rows": 2}), ("torus", 16, {}),
    ("hypercube", 8, {}),
    ("erdos_renyi", 10, {"p": 0.3, "seed": 0}),
    ("erdos_renyi", 10, {"p": 0.5, "seed": 3}),
    ("erdos_renyi", 20, {"p": 0.05, "seed": 1}),  # ring fallback path
    ("geometric", 10, {"radius": 0.5, "seed": 0}),
    ("geometric", 12, {"radius": 0.2, "seed": 7}),  # radius growth path
]


@pytest.mark.parametrize("kind,k,kw", CASES)
def test_graphs_and_weights_match_reference(kind, k, kw):
    g_ref = ref.build_graph(kind, k, **kw)
    g = port.build_graph(kind, k, **kw)
    assert g.name == g_ref.name
    np.testing.assert_array_equal(g.adjacency, g_ref.adjacency)
    for fn in ("metropolis_weights", "max_degree_weights", "lazy_metropolis_weights"):
        w_ref = getattr(ref, fn)(g_ref)
        w = getattr(port, fn)(g)
        assert w.dtype == np.float64
        np.testing.assert_array_equal(w, w_ref)
        assert port.is_doubly_stochastic(w) == ref.is_doubly_stochastic(w_ref)
        assert port.spectral_norm(w) == ref.spectral_norm(w_ref)
        assert port.spectral_gap(w) == ref.spectral_gap(w_ref)


def test_build_graph_rejects_unknown_kind():
    with pytest.raises(ValueError):
        port.build_graph("moebius", 4)
