"""The node axis through the dense LMs' forward, on the CPU.

``make_lm_loss`` of a dense LM (every layer attn or swa with a dense FFN,
a token frontend) runs the K nodes' losses in one forward over
node-stacked leaves and (K, B, S+1) tokens.  Held here:

- against the reference's vmapped loss (``jax.vmap(jax.value_and_grad(
  model.loss))``, as ``repro/core/drdsgd.py`` vmaps its per-node loss) on
  qwen2's and gemma2's smoke configs cut to 2 layers at K = 3, with every
  node's leaves drawn apart: the losses at rtol 1e-5 and every gradient
  leaf within ``GRAD_REL`` of its own largest |value| (the tolerance
  ``tests/test_torch_lm_train.py`` holds the port's per-node loss to:
  the two frameworks sum the float32 products of the backward in other
  orders);
- against the port's per-node loop (``node_loop_loss``, which MoE, Mamba,
  RWKV and the stub frontends still take) on the same inputs: losses and
  gradients within ``LOOP_ULPS`` float32 ulps of each tensor's largest
  |value| (the batched products may sum in another order than the
  per-node ones);
- the predicate: the four dense families take the node axis, the others
  loop and carry the reason the trainer does not capture their step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import TransformerLM as RefLM
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import TransformerLM, make_lm_loss
from repro_torch.models.transformer import node_axis_declined, node_loop_loss

GRAD_REL = 2e-5   # a gradient leaf against its largest |value| (module doc)
LOSS_RTOL = 1e-5
LOOP_ULPS = 2     # batched against the loop, in float32 ulps of the largest |value|
K, B, S, LAYERS = 3, 2, 24, 2
EPS32 = float(np.finfo(np.float32).eps)


def _cut(cfg):
    """The smoke config cut to LAYERS layers (its pattern kept)."""
    return dataclasses.replace(cfg, n_layers=LAYERS)


def _node_params(ref_params, seed: int) -> dict:
    """K node copies of the reference's init, each nudged apart (numpy)."""
    rng = np.random.default_rng(seed)
    flat = jax.tree.map(np.asarray, ref_params)
    return jax.tree.map(lambda x: np.stack([
        x + (0.01 * rng.standard_normal(x.shape)).astype(x.dtype) for _ in range(K)]), flat)


def _batched(model, params: dict, toks: np.ndarray, loss_fn):
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    losses = loss_fn(leaves, (torch.from_numpy(toks),))
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    return losses.detach(), dict(zip(leaves, grads))


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float32 ulps of max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()) * EPS32, 1e-30)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma2_27b"])
def test_batched_loss_matches_reference_vmap(arch):
    ref = RefLM(_cut(ref_get_arch(arch, smoke=True)))
    node_params = _node_params(ref.init(jax.random.PRNGKey(0)), seed=1)
    toks = np.random.default_rng(3).integers(0, ref.cfg.vocab, (K, B, S + 1)).astype(np.int32)

    def per_node(p, t):
        return jax.value_and_grad(ref.loss)(p, {"tokens": t})

    want, want_g = jax.jit(jax.vmap(per_node))(node_params, toks)
    want_g = convert.params_from_numpy(jax.tree.map(np.asarray, want_g), device="cpu")

    model = TransformerLM(_cut(get_arch(arch, smoke=True)))
    params = convert.params_from_numpy(node_params, device="cpu")
    got, grads = _batched(model, params, toks, make_lm_loss(model))
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(want_g)
    for name, g in grads.items():
        assert g.shape == params[name].shape
        want_leaf = want_g[name]
        err = float((g - want_leaf).abs().max()) / max(float(want_leaf.abs().max()), 1e-30)
        assert err <= GRAD_REL, (arch, name, err)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma2_27b", "h2o_danube_1_8b"])
def test_batched_loss_matches_node_loop(arch):
    model = TransformerLM(_cut(get_arch(arch, smoke=True)))
    gen = torch.Generator().manual_seed(0)
    base = model.init(gen)
    params = {n: (x.unsqueeze(0) + 0.01 * torch.randn((K,) + x.shape, generator=gen))
              .contiguous() for n, x in base.items()}
    toks = np.random.default_rng(5).integers(0, model.cfg.vocab, (K, B, S + 1))
    got, grads = _batched(model, params, toks, make_lm_loss(model))
    want, want_g = _batched(model, params, toks, node_loop_loss(model))
    assert _ulps(got, want) <= LOOP_ULPS
    for name in params:
        err = _ulps(grads[name], want_g[name])
        assert err <= LOOP_ULPS, (arch, name, err)


def test_batched_loss_keeps_nodes_apart():
    """Node i's loss depends on node i's leaves and tokens only: changing
    node 1's tokens moves node 1's loss and leaves the others' bits."""
    model = TransformerLM(_cut(get_arch("qwen2_0_5b", smoke=True)))
    base = model.init(torch.Generator().manual_seed(2))
    params = {n: x.unsqueeze(0).expand((K,) + x.shape).contiguous() for n, x in base.items()}
    rng = np.random.default_rng(7)
    toks = rng.integers(0, model.cfg.vocab, (K, B, S + 1))
    other = toks.copy()
    other[1] = rng.integers(0, model.cfg.vocab, (B, S + 1))
    loss_fn = make_lm_loss(model)
    with torch.no_grad():
        a = loss_fn(params, (torch.from_numpy(toks),))
        b = loss_fn(params, (torch.from_numpy(other),))
    assert torch.equal(a[[0, 2]], b[[0, 2]])
    assert not torch.equal(a[1], b[1])


@pytest.mark.parametrize("arch,batched", [
    ("qwen2_0_5b", True), ("h2o_danube_1_8b", True), ("gemma2_27b", True),
    ("llama3_405b", True), ("deepseek_moe_16b", False), ("grok_1_314b", False),
    ("rwkv6_7b", False), ("jamba_1_5_large_398b", False), ("musicgen_medium", False),
    ("pixtral_12b", False)])
def test_node_axis_predicate(arch, batched):
    cfg = get_arch(arch, smoke=True)
    reason = node_axis_declined(cfg)
    assert (reason is None) == batched
    loss_fn = make_lm_loss(TransformerLM(cfg))
    declined = getattr(loss_fn, "capture_declined", None)
    assert (declined is None) == batched
    if not batched:
        assert reason in declined


def test_embed_and_norm_take_the_node_axis():
    """The building blocks: a (K, V, D) table gathers node i's rows from
    node i's table, and a (K, D) norm scale scales node i's rows."""
    from repro_torch.models.layers import embed, linear, rmsnorm

    gen = torch.Generator().manual_seed(4)
    table = torch.randn((K, 11, 6), generator=gen)
    toks = torch.randint(0, 11, (K, B, 5), generator=gen)
    out = embed({"table": table}, toks)
    for i in range(K):
        assert torch.equal(out[i], table[i][toks[i]])
    scale = torch.randn((K, 6), generator=gen)
    x = torch.randn((K, B, 5, 6), generator=gen)
    y = rmsnorm({"scale": scale}, x)
    for i in range(K):
        assert torch.equal(y[i], rmsnorm({"scale": scale[i]}, x[i]))
    w = torch.randn((K, 6, 4), generator=gen)
    z = linear(x, w)
    for i in range(K):
        assert _ulps(z[i], x[i] @ w[i]) <= LOOP_ULPS
