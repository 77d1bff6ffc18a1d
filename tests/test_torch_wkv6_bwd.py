"""The plain version of B.7's backward against autograd and the reference.

``repro_torch/kernels/rwkv6_scan/ref.py::wkv6_bwd_ref`` is the backward of
the WKV6 recurrence as an explicit reverse loop: what the backward kernel
(``csrc/wkv6_bwd.cu``) is held against on the card (tests/test_torch_kernel.py,
``chip_smoke.py``'s ``train-rwkv`` phase).  Here, on the CPU, with inputs
made by numpy from a seed, every gradient is held within ``REL`` = 1e-4 of
its own largest |value| against:

* ``jax.vjp`` of the reference's oracle ``repro.kernels.rwkv6_scan.ref.
  wkv6_ref`` (dr, dk, dv, dw, du; that oracle starts from zero and drops
  the final state);
* ``torch.autograd`` of the port's ``wkv6_ref`` with a given s0 and a
  cotangent on the final state (ds0 besides);
* ``jax.vjp`` of the reference's ``repro.models.ssm.rwkv_forward`` on a
  smoke block with a given state, cotangents on y and on every leaf of the
  new state: the port's ``rwkv_forward`` differentiated with its WKV6 call
  routed through a Function whose backward is ``wkv6_bwd_ref``.

Cases: hd 16 and 64; decay drawn in (0, 1), near 1 (the init's
exp(-exp(-6))) and w = 1e-6 (the state forgotten at every step); T = 1 and
T that is not a multiple of the kernel's checkpoint stride (32 at hd 16, 8
at hd 64).  Measured on the CPU, the largest relative difference is ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels.rwkv6_scan.ref import wkv6_ref as ref_wkv6
from repro.models import TransformerLM as RefLM
from repro.models.ssm import rwkv_forward as ref_rwkv_forward
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.models.ssm import rwkv_forward

REL = 1e-4
CHUNK = {16: 32, 64: 8}   # the backward kernel's checkpoint stride per head dim
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(seed, b, h, t, hd, decay):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((b, h, t, hd)).astype(np.float32) for _ in range(4))
    if decay == "random":
        w = rng.uniform(0.0, 1.0, (b, h, t, hd)).astype(np.float32)
    elif decay == "near 1":  # the model's init: exp(-exp(-6)) ~ 0.9975
        w = np.full((b, h, t, hd), np.exp(-np.exp(-6.0)), np.float32)
    else:  # the state is forgotten at every step
        w = np.full((b, h, t, hd), 1e-6, np.float32)
    u = (0.5 * rng.standard_normal((h, hd))).astype(np.float32)
    s0, ds = (rng.standard_normal((b, h, hd, hd)).astype(np.float32) for _ in range(2))
    return r, k, v, w, u, dy, s0, ds


CASES = [(hd, t, decay) for hd in (16, 64) for t in (1, CHUNK[hd] * 2 + 3)
         for decay in ("random", "near 1", "1e-6")]


@pytest.mark.parametrize("hd,t,decay", CASES)
def test_bwd_ref_matches_jax_vjp_of_reference(hd, t, decay):
    r, k, v, w, u, dy, _, _ = _inputs(hd + t, 2, 2, t, hd, decay)
    _, vjp = jax.vjp(ref_wkv6, *(jnp.asarray(x) for x in (r, k, v, w, u)))
    want = vjp(jnp.asarray(dy))
    got = wkv6_bwd_ref(*(torch.from_numpy(x) for x in (r, k, v, w, u, dy)))
    assert got[5] is None
    for name, g, wnt in zip(NAMES, got[:5], want):
        assert g.shape == wnt.shape, name
        assert _rel(g.numpy(), wnt) <= REL, (name, _rel(g.numpy(), wnt))


@pytest.mark.parametrize("hd,t,decay", CASES)
def test_bwd_ref_matches_autograd_with_state(hd, t, decay):
    """With a given s0 and a cotangent on the final state."""
    xs = [torch.from_numpy(x) for x in _inputs(hd * t, 2, 3, t, hd, decay)]
    r, k, v, w, u, dy, s0, ds = xs
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = wkv6_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    got = wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
    for name, g, wnt in zip(NAMES, got, want):
        assert _rel(g, wnt) <= REL, (name, _rel(g, wnt))
    # no cotangent on the final state: the same as a zero one
    zero = wkv6_bwd_ref(r, k, v, w, u, dy, s0, torch.zeros_like(ds))
    for g, z in zip(wkv6_bwd_ref(r, k, v, w, u, dy, s0), zero):
        assert torch.equal(g, z)


class _PlainWKV6(torch.autograd.Function):
    """``ops.WKV6`` with the plain versions in place of the kernels."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return wkv6_ref(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        return wkv6_bwd_ref(r, k, v, w, u, torch.zeros_like(r) if dy is None else dy, s0, ds)


@pytest.mark.parametrize("seq,decay_base", [(1, -6.0), (19, -6.0), (19, 2.6), (37, None)])
def test_rwkv_forward_grads_match_reference(monkeypatch, seq, decay_base):
    """The smoke block (hd 16) from a given state: decay near 1 (the init's
    decay_base -6), near 1e-6 (decay_base 2.6: exp(-exp(2.6)) ~ 1.4e-6)
    and drawn per channel in (-3, 1).  Every parameter, x and every leaf
    of the state."""
    calls = []
    monkeypatch.setattr(ops, "wkv6", lambda *xs: calls.append(1) or _PlainWKV6.apply(*xs))
    cfg_ref = ref_get_arch("rwkv6_7b", smoke=True)
    cfg = get_arch("rwkv6_7b", smoke=True)
    params = jax.tree.map(np.asarray, RefLM(cfg_ref).init(jax.random.PRNGKey(0)))
    block = jax.tree.map(lambda a: np.array(a[0]), params["groups"]["l0"]["mix"])
    rng = np.random.default_rng(seq)
    h, hd, d = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, cfg.d_model
    block["time"]["bonus"] = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    block["time"]["decay_base"] = (np.full(d, decay_base, np.float32) if decay_base is not None
                                   else rng.uniform(-3.0, 1.0, d).astype(np.float32))
    b = 2
    x = rng.standard_normal((b, seq, d)).astype(np.float32)
    state = {"x_time": rng.standard_normal((b, d)).astype(np.float32),
             "x_chan": rng.standard_normal((b, d)).astype(np.float32),
             "wkv": rng.standard_normal((b, h, hd, hd)).astype(np.float32)}
    cot_y = rng.standard_normal((b, seq, d)).astype(np.float32)
    cot_s = {name: rng.standard_normal(a.shape).astype(np.float32) for name, a in state.items()}

    def ref_fn(p, x, st):
        return ref_rwkv_forward(p, x, cfg_ref, st)

    _, vjp = jax.vjp(ref_fn, jax.tree.map(jnp.asarray, block), jnp.asarray(x),
                     jax.tree.map(jnp.asarray, state))
    want_p, want_x, want_s = vjp((jnp.asarray(cot_y), jax.tree.map(jnp.asarray, cot_s)))
    want_p = convert._flatten(jax.tree.map(np.asarray, want_p))

    p = {n: t.requires_grad_() for n, t in convert.params_from_numpy(block, device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_()
    st = {n: torch.from_numpy(a).requires_grad_() for n, a in state.items()}
    y, new = rwkv_forward(p, xt, cfg, st)
    total = (y * torch.from_numpy(cot_y)).sum() + sum(
        (new[n] * torch.from_numpy(cot_s[n])).sum() for n in cot_s)
    assert len(calls) == 1
    names = list(p)
    grads = torch.autograd.grad(total, [p[n] for n in names] + [xt] + [st[n] for n in st])
    for name, g in zip(names, grads):
        assert _rel(g, want_p[name]) <= REL, (name, _rel(g, want_p[name]))
    assert _rel(grads[len(names)], want_x) <= REL
    for name, g in zip(st, grads[len(names) + 1:]):
        assert _rel(g, want_s[name]) <= REL, (name, _rel(g, want_s[name]))
