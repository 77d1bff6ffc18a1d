"""The port's matching decomposition and on-device mixing weights against the
reference's ``repro.graphs.mixing``.

``permutation_decomposition`` is numpy on both sides and must give the same
matchings and the same float64 weights for every graph builder, seed and K.
``metropolis_weights_traced`` and ``renormalize_masked_weights`` are float32
on the caller's device in the port and jnp in the reference: held at rtol
1e-6 on the same inputs, and bitwise at keep ≡ 1 (the renormalization
returns exactly W).  The port's ``symmetric_uniform`` folds a (K, K) draw
(the dynamics' Philox coins) into one coin per unordered pair, so it is
held on its properties, not on bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import build_graph as ref_build_graph
from repro.graphs import mixing as ref_mixing
from repro_torch.graphs import build_graph, metropolis_weights
from repro_torch.graphs import mixing

BUILDERS = ["ring", "grid", "torus", "erdos_renyi", "geometric", "complete", "star",
            "hypercube"]


def _graph_kw(kind, seed):
    if kind == "erdos_renyi":
        return {"p": 0.4, "seed": seed}
    if kind == "geometric":
        return {"radius": 0.5, "seed": seed}
    return {}


# every builder at K ∈ {6, 10, 16} (the hypercube needs K = 2^m: 4, 8, 16)
CASES = [(kind, k) for kind in BUILDERS
         for k in ((4, 8, 16) if kind == "hypercube" else (6, 10, 16))]


@pytest.mark.parametrize("kind,k", CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutation_decomposition_matches_reference(kind, k, seed):
    kw = _graph_kw(kind, seed)
    w = metropolis_weights(build_graph(kind, k, **kw))
    np.testing.assert_array_equal(w, ref_mixing.metropolis_weights(ref_build_graph(kind, k, **kw)))
    got = mixing.permutation_decomposition(w)
    want = ref_mixing.permutation_decomposition(w)
    assert got.num_rounds == want.num_rounds
    np.testing.assert_array_equal(got.self_weights, want.self_weights)
    for a, b in zip(got.matchings, want.matchings):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[a], np.arange(k))  # an involution
    for a, b in zip(got.matching_weights, want.matching_weights):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    assert got.ppermute_pairs() == want.ppermute_pairs()
    np.testing.assert_array_equal(got.reconstruct(), want.reconstruct())
    np.testing.assert_allclose(got.reconstruct(), w, rtol=0, atol=1e-15)


def test_permutation_decomposition_rejects_asymmetric_w():
    w = np.array([[0.5, 0.5, 0.0], [0.2, 0.6, 0.2], [0.0, 0.5, 0.5]])
    with pytest.raises(ValueError, match="symmetric"):
        mixing.permutation_decomposition(w)


def _adjacency(k, seed):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((k, k)) < 0.4, 1)
    adj = (upper | upper.T).astype(np.float32)
    adj[0, :] = adj[:, 0] = 0.0  # an isolated node: W_00 = 1
    return adj


@pytest.mark.parametrize("k,seed", [(6, 0), (10, 1), (16, 2)])
def test_metropolis_weights_traced_matches_reference(k, seed):
    adj = _adjacency(k, seed)
    got = mixing.metropolis_weights_traced(torch.from_numpy(adj)).numpy()
    want = np.asarray(ref_mixing.metropolis_weights_traced(jnp.asarray(adj)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0, 0] == 1.0
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("k,seed", [(6, 0), (10, 1), (16, 2)])
def test_renormalize_masked_weights_matches_reference(k, seed):
    w = metropolis_weights(build_graph("erdos_renyi", k, p=0.5, seed=seed)).astype(np.float32)
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((k, k)) >= 0.3, 1).astype(np.float32)
    keep = upper + upper.T
    got = mixing.renormalize_masked_weights(torch.from_numpy(w), torch.from_numpy(keep)).numpy()
    want = np.asarray(ref_mixing.renormalize_masked_weights(jnp.asarray(w), jnp.asarray(keep)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, got.T, atol=1e-7)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    ones = np.ones((k, k), np.float32)
    same = mixing.renormalize_masked_weights(torch.from_numpy(w), torch.from_numpy(ones))
    np.testing.assert_array_equal(same.numpy(), w)  # keep ≡ 1 is bitwise W
    np.testing.assert_array_equal(np.asarray(ref_mixing.renormalize_masked_weights(
        jnp.asarray(w), jnp.asarray(ones))), w)


def test_symmetric_uniform_properties():
    draw = torch.rand((12, 12), generator=torch.Generator().manual_seed(3))
    u = mixing.symmetric_uniform(draw)
    assert u.dtype == torch.float32 and u.shape == (12, 12)
    assert torch.equal(u, u.T)
    assert torch.all(torch.diagonal(u) == 0)
    off = u[~torch.eye(12, dtype=torch.bool)]
    assert bool(((off >= 0) & (off < 1)).all())
    # one coin per unordered pair, from the draw's upper triangle alone
    assert torch.equal(torch.triu(u, 1), torch.triu(draw, 1))
    assert torch.equal(u, mixing.symmetric_uniform(draw + torch.tril(torch.ones(12, 12))))
    other = torch.rand((12, 12), generator=torch.Generator().manual_seed(4))
    assert not torch.equal(u, mixing.symmetric_uniform(other))
