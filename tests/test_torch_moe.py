"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU.

The reference's parameters (``init_tree`` of its ``moe_decl``) are carried
across with ``convert.params_from_numpy`` and the same numpy-made tokens go
through both.

* Routing: ``expert_ids``, ``keep`` and each choice's rank within its
  expert are equal to the reference's routing (its own ops, copied from
  ``repro/models/moe.py:67-89`` below, since the reference exposes none),
  and the gates within 1e-6.  The repo's near-tie rule (ROADMAP C) would
  allow an expert choice to differ only where the top-k margin of the
  router's probabilities is below their measured error; every case checks
  that no such tie exists in its data, so every choice is held exactly.
* The output, the aux loss, and the gradients of both with respect to the
  input and every parameter (``jax.vjp`` against autograd, a random
  cotangent on the output and 1 on aux) within 1e-5 of the largest |value|.
* Capacity: at ``capacity_factor`` 0.25 choices are dropped (``keep`` has
  False entries) and the output still matches; the model loss changes
  against a large capacity, as ``tests/test_models.py`` checks the
  reference's.
* ``num_active_params`` equals the reference's for grok-1, deepseek-moe and
  jamba at full size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import TransformerLM as RefLM
from repro.models import moe as ref_moe
from repro.models import params as ref_pr
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import TransformerLM
from repro_torch.models import moe

TOL = 1e-5
B, S = 2, 24


def _fine(cfg):
    """deepseek's fine-grained shape at smoke width: 16 experts, top-6."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=6,
                                                            d_expert=32))


def _drops(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))


CASES = {
    "grok-smoke": ("grok_1_314b", lambda c: c),
    "deepseek-smoke": ("deepseek_moe_16b", lambda c: c),
    "jamba-smoke": ("jamba_1_5_large_398b", lambda c: c),
    "deepseek-top6": ("deepseek_moe_16b", _fine),
    "deepseek-cf0.25": ("deepseek_moe_16b", _drops),
    "grok-cf0.25": ("grok_1_314b", _drops),
}


def _cfgs(case):
    arch, edit = CASES[case]
    return edit(ref_get_arch(arch, smoke=True)), edit(get_arch(arch, smoke=True))


def _ref_route(p, xt, cfg):
    """The reference's routing (repro/models/moe.py:67-89), op for op."""
    m = cfg.moe
    t = xt.shape[0]
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, m.top_k)
    gate_vals = gate_vals / jnp.maximum(jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    cap = ref_moe._capacity(t, m)
    onehot = jax.nn.one_hot(expert_ids, m.num_experts, dtype=jnp.int32)
    flat = onehot.reshape(t * m.top_k, m.num_experts)
    ranks = jnp.cumsum(flat, axis=0) - flat
    rank = jnp.sum(ranks * flat, axis=-1).reshape(t, m.top_k)
    keep = rank < cap
    return dict(probs=probs, expert_ids=expert_ids, rank=rank, keep=keep, cap=cap,
                gate_vals=gate_vals * keep.astype(gate_vals.dtype))


def _setup(case, seed=0):
    ref_cfg, cfg = _cfgs(case)
    ref_p = ref_pr.init_tree(jax.random.PRNGKey(seed), ref_moe.moe_decl(ref_cfg))
    ref_p = jax.tree.map(np.asarray, ref_p)
    p = convert.params_from_numpy(ref_p, device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, ref_p, p, x


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_equal_reference(case):
    ref_cfg, cfg, ref_p, p, x = _setup(case)
    xt = x.reshape(B * S, -1)
    want = _ref_route(ref_p, jnp.asarray(xt), ref_cfg)
    got = moe.moe_route(p, torch.from_numpy(xt), cfg)
    assert got["cap"] == want["cap"] == ref_moe._capacity(B * S, ref_cfg.moe)
    # the near-tie rule: no choice at the top-k boundary within the router's error
    probs = np.asarray(want["probs"])
    ours = torch.softmax(torch.from_numpy(xt) @ p["router"], -1).numpy()
    err = float(np.abs(probs - ours).max())
    k = cfg.moe.top_k
    srt = -np.sort(-probs, axis=-1)
    margins = srt[:, :k] - srt[:, 1:k + 1]  # each choice against the next one down
    assert margins.min() > 2 * err, (margins.min(), err)
    np.testing.assert_array_equal(got["expert_ids"].numpy(), np.asarray(want["expert_ids"]))
    np.testing.assert_array_equal(got["rank"].numpy(), np.asarray(want["rank"]))
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    np.testing.assert_allclose(got["gate_vals"].numpy(), np.asarray(want["gate_vals"]),
                               rtol=1e-6, atol=1e-7)
    if case.endswith("cf0.25"):
        assert not got["keep"].all()  # choices past capacity were dropped
    else:
        assert got["keep"].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_aux_and_gradients_match_reference(case):
    ref_cfg, cfg, ref_p, p, x = _setup(case)
    dout = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref_f(params, xx):
        return ref_moe.moe_ffn(params, xx, ref_cfg)

    (r_out, r_aux), vjp = jax.vjp(ref_f, jax.tree.map(jnp.asarray, ref_p), jnp.asarray(x))
    r_dp, r_dx = vjp((jnp.asarray(dout), jnp.float32(1.0)))
    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_ffn(leaves, xx, cfg)
    torch.autograd.backward([out, aux], [torch.from_numpy(dout), torch.tensor(1.0)])
    _close(out.detach(), r_out, "out")
    np.testing.assert_allclose(float(aux.detach()), float(r_aux), rtol=TOL)
    assert float(aux) > 0
    _close(xx.grad, r_dx, "dx")
    want = convert._flatten(jax.tree.map(np.asarray, r_dp))
    assert sorted(want) == sorted(leaves)
    for n, t in leaves.items():
        _close(t.grad, want[n], f"d{n}")


def test_capacity_drops_change_the_loss():
    """As tests/test_models.py holds the reference: a tiny capacity factor
    changes the model's loss; at both capacities the port's loss is the
    reference's."""
    ref_cfg, cfg = _cfgs("grok-smoke")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    losses = []
    ref_params = RefLM(ref_cfg).init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")
    for cf in (8.0, 0.25):
        rc = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, capacity_factor=cf))
        pc = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        want = float(RefLM(rc).loss(ref_params, {"tokens": jnp.asarray(toks, jnp.int32)}))
        with torch.no_grad():
            got = float(TransformerLM(pc).loss(params, {"tokens": torch.from_numpy(toks)}))
        np.testing.assert_allclose(got, want, rtol=TOL)
        losses.append(got)
    assert abs(losses[0] - losses[1]) > 1e-6


@pytest.mark.parametrize("arch", ["grok_1_314b", "deepseek_moe_16b", "jamba_1_5_large_398b"])
def test_num_active_params_equal_reference(arch):
    model, ref = TransformerLM(get_arch(arch)), RefLM(ref_get_arch(arch))
    assert model.num_active_params() == ref.num_active_params() < model.num_params()
    assert model.num_params() == ref.num_params()
