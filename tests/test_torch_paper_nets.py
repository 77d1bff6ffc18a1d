"""repro_torch.models.paper_nets against repro.models.paper_nets.

Weights come from the reference's own init and are carried across with
repro_torch.convert, so logits and per-node gradients must agree at
float32 rounding (rtol 1e-5, atol 1e-6).  The CNN case is the one that
catches a wrong flatten order before fc0 (the reference flattens the last
pooled map in (H, W, C) order) or a wrong HWIO -> OIHW weight transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import paper_nets as ref
from repro_torch import convert
from repro_torch.models import paper_nets as port

K = 3
B = 4


def _node_params(init, key):
    keys = jax.random.split(jax.random.PRNGKey(key), K)
    return jax.vmap(init)(keys)  # node-stacked reference pytree


def _case(name):
    # inputs in the synthetic images' range: the datasets clip to [-1, 1]
    rng = np.random.default_rng(0)
    if name == "mlp":
        params = _node_params(ref.mlp_init, 1)
        x = rng.uniform(-1.0, 1.0, (K, B, 28, 28)).astype(np.float32)
        return params, x, ref.mlp_apply, port.mlp_apply
    params = _node_params(ref.cnn_init, 2)
    # non-zero biases so the bias layout is exercised too
    params = {name: {**leaf, "b": leaf["b"] + 0.01 * jnp.linspace(
        -1.0, 1.0, leaf["b"].size, dtype=jnp.float32).reshape(leaf["b"].shape)}
        for name, leaf in params.items()}
    x = rng.uniform(-1.0, 1.0, (K, B, 3, 32, 32)).astype(np.float32)
    return params, x, ref.cnn_apply, port.cnn_apply


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_logits_match_reference(name):
    params, x, ref_apply, port_apply = _case(name)
    want = np.asarray(jax.vmap(ref_apply)(params, jnp.asarray(x)))
    got = port_apply(convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                               device="cpu"),
                     torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_per_node_grads_match_reference(name):
    params, x, ref_apply, port_apply = _case(name)
    y = np.random.default_rng(1).integers(0, 10, size=(K, B)).astype(np.int32)
    ref_loss = ref.make_classifier_loss(ref_apply)
    want_l, want_g = jax.vmap(jax.value_and_grad(ref_loss))(
        params, (jnp.asarray(x), jnp.asarray(y)))
    p = convert.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    leaves = {n: t.requires_grad_(True) for n, t in p.items()}
    losses = port.make_classifier_loss(port_apply)(leaves, (torch.from_numpy(x),
                                                            torch.from_numpy(y)))
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-6)
    flat_want = convert._flatten(jax.tree.map(np.asarray, want_g))
    assert sorted(flat_want) == list(leaves)
    for name_, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), flat_want[name_], rtol=1e-5, atol=1e-6,
                                   err_msg=name_)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_port_init_has_reference_layout(name):
    ref_init, port_init = ((ref.mlp_init, port.mlp_init) if name == "mlp"
                           else (ref.cnn_init, port.cnn_init))
    want = convert._flatten(jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(0))))
    got = port_init(torch.Generator().manual_seed(0))
    assert list(got) == sorted(want)  # the reference's flatten order
    for n, t in got.items():
        assert tuple(t.shape) == want[n].shape and t.dtype == torch.float32, n
        limit = float(np.abs(want[n]).max()) if n.endswith("/w") else 0.0
        # same Glorot-uniform bound: the port's draws stay inside the
        # reference's support (the reference's max nearly touches it)
        assert float(t.abs().max()) <= limit * 1.01 + 1e-12, n


def test_params_npz_round_trip(tmp_path):
    params = port.cnn_init(torch.Generator().manual_seed(3))
    path = tmp_path / "params.npz"
    np.savez(path, **convert.params_to_numpy(params))
    with np.load(path) as npz:
        back = convert.params_from_numpy(dict(npz), device="cpu")
    assert list(back) == list(params)
    for n in params:
        assert torch.equal(back[n], params[n])
