"""The port's dense consensus stacks against the reference's mixers.

Uncompressed: ``make_dense_mixer`` on both sides, one round and the state's
accounting.  Compressed: the CHOCO error-feedback dense round (and the
memoryless one) on identical θ and θ̂, with the reference's own
stochastic-rounding uniforms injected into the port's wire through its
``uniforms`` hook.  The uniforms are recomputed from the reference's
``CommState.key`` exactly as ``repro/comm/composed.py:491-508`` derives
them.  Given the same uniforms the int8 payload is the same, and θ, θ̂
agree to float32 rounding of the W product (rtol 1e-6, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CompressionConfig as RefCompressionConfig
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.core.consensus import make_dense_mixer as ref_make_dense_mixer
from repro.graphs import build_graph, metropolis_weights
from repro_torch import convert
from repro_torch.comm import CompressionConfig
from repro_torch.core.consensus import make_dense_mixer

K = 6
W = metropolis_weights(build_graph("erdos_renyi", K, p=0.5, seed=1))
SHAPES = {"fc0": {"w": (20, 8), "b": (8,)}, "fc1": {"w": (8, 3), "b": (3,)},
          "conv0": {"w": (3, 3, 2, 4), "b": (4,)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {m: {n: (scale * rng.standard_normal((K,) + s)).astype(np.float32)
                for n, s in leaves.items()} for m, leaves in SHAPES.items()}


def _port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def _assert_tree_close(port_tree, ref_tree, **tol):
    want = convert._flatten(jax.tree.map(np.asarray, ref_tree))
    assert list(port_tree) == sorted(want)
    for n, t in port_tree.items():
        np.testing.assert_allclose(t.numpy(), want[n], err_msg=n, **tol)


class ReferenceUniforms:
    """The reference dense round's uniforms, recomputed from its CommState.key:
    round r splits the carried key, folds the node id, then the leaf index."""

    def __init__(self):
        self.by_round = {}

    def record(self, rounds, ref_state, theta_ref):
        _, sub = jax.random.split(ref_state.comm.key if hasattr(ref_state, "comm")
                                  else ref_state.key)
        node_ks = per_node_keys(sub, jnp.arange(K))
        leaves = jax.tree.leaves(theta_ref)
        self.by_round[rounds] = [
            np.asarray(_uniform_rows(fold_leaf(node_ks, i), x.size // K))
            for i, x in enumerate(leaves)]

    def __call__(self, rounds, leaf_idx, shape):
        u = self.by_round[rounds][leaf_idx]
        assert u.shape == shape
        return u


def test_uncompressed_dense_round_matches_reference():
    theta = _tree(0)
    ref_m = ref_make_dense_mixer(W)
    port_m = make_dense_mixer(W, device="cpu")
    ref_out, ref_cs = ref_m(jax.tree.map(jnp.asarray, theta), ref_m.init_state(theta))
    out, cs = port_m(_port(theta), port_m.init_state(_port(theta)))
    _assert_tree_close(out, ref_out, rtol=1e-6, atol=1e-6)
    assert port_m.bytes_per_round(_port(theta)) == ref_m.bytes_per_round(theta)
    assert float(cs.wire_bits) == float(ref_cs.wire_bits)
    assert cs.rounds == int(ref_cs.rounds) == 1
    assert float(cs.res_norm) == float(ref_cs.res_norm) == 0.0


@pytest.mark.parametrize("use_kernel,error_feedback",
                         [(True, True), (True, False), (False, True)],
                         ids=["int8-kernel-ef", "int8-kernel-memoryless", "int8-pernode-ef"])
def test_compressed_dense_rounds_match_reference(use_kernel, error_feedback):
    ref_cfg = RefCompressionConfig(kind="int8", use_kernel=use_kernel,
                                   error_feedback=error_feedback, seed=3)
    cfg = CompressionConfig(kind="int8", use_kernel=use_kernel,
                            error_feedback=error_feedback, seed=3)
    uniforms = ReferenceUniforms()
    ref_m = ref_make_dense_mixer(W, compression=ref_cfg)
    port_m = make_dense_mixer(W, compression=cfg, device="cpu", uniforms=uniforms)
    theta = _tree(0)
    ref_state = ref_m.init_state(theta)
    port_state = port_m.init_state(_port(theta))
    if error_feedback:
        # identical non-trivial public copies θ̂ on both sides
        hat = _tree(1, scale=0.5)
        ref_state = ref_state._replace(hat=jax.tree.map(jnp.asarray, hat))
        port_state = port_state._replace(hat=_port(hat))
    ref_theta, port_theta = jax.tree.map(jnp.asarray, theta), _port(theta)
    for r in range(3):
        uniforms.record(r, ref_state, ref_theta)
        ref_theta, ref_state = ref_m(ref_theta, ref_state)
        port_theta, port_state = port_m(port_theta, port_state)
        _assert_tree_close(port_theta, ref_theta, rtol=1e-6, atol=1e-6)
        if error_feedback:
            _assert_tree_close(port_state.hat, ref_state.hat, rtol=1e-6, atol=1e-6)
        else:
            assert port_state.hat == () and ref_state.hat == ()
        np.testing.assert_allclose(float(port_state.res_norm), float(ref_state.res_norm),
                                   rtol=1e-6)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits)
        assert port_state.rounds == int(ref_state.rounds) == r + 1
        # the same payload crossed the wire: the byte accounting is exact
        assert port_m.bytes_per_round(port_theta) == ref_m.bytes_per_round(theta)
        # theta and theta-hat carry over into the next round unchanged, so
        # the next round starts from (nearly) identical inputs on both sides
        port_theta = _port(jax.tree.map(np.asarray, ref_theta))
        if error_feedback:
            port_state = port_state._replace(
                hat=_port(jax.tree.map(np.asarray, ref_state.hat)))


@pytest.mark.parametrize("block_d", [65536, 64, 16])
def test_kernel_wire_bytes_per_round_match_reference(block_d):
    theta = _tree(0)
    ref_m = ref_make_dense_mixer(W, compression=RefCompressionConfig(
        kind="int8", use_kernel=True, block_d=block_d))
    port_m = make_dense_mixer(W, compression=CompressionConfig(
        kind="int8", use_kernel=True, block_d=block_d), device="cpu")
    assert port_m.bytes_per_round(_port(theta)) == ref_m.bytes_per_round(theta)


def test_default_noise_is_a_pure_function_of_the_round():
    cfg = CompressionConfig(kind="int8", use_kernel=True, seed=5)
    m1 = make_dense_mixer(W, compression=cfg, device="cpu")
    m2 = make_dense_mixer(W, compression=cfg, device="cpu")
    theta = _port(_tree(0))
    s1 = m1.init_state(theta)
    out1, s1b = m1(theta, s1)
    out1_again, _ = m1(theta, s1)  # same state in, same result out
    out2, _ = m2(theta, m2.init_state(theta))
    for n in theta:
        assert torch.equal(out1[n], out1_again[n]) and torch.equal(out1[n], out2[n])
    out_next, _ = m1(out1, s1b)
    assert any(not torch.equal(out_next[n], out1[n]) for n in theta)


@pytest.mark.parametrize("kind", ["bf16", "int4", "topk", "randk"])
def test_unported_codecs_raise(kind):
    with pytest.raises(NotImplementedError, match="codecs slice"):
        make_dense_mixer(W, compression=CompressionConfig(kind=kind), device="cpu")
