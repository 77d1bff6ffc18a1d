"""The port's Mamba block (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU.

The reference's parameters (``init_tree`` of ``mamba_decl``, then
``a_log`` set to Mamba's ``log(1..d_state)`` and ``dt_bias``, ``conv_b``
and ``d_skip`` drawn, so every term of the scan is exercised) are carried
across and the same numpy-made inputs go through both:

* the forward from the zero state and from a given state: the output, the
  conv state (the last ``d_conv − 1`` inputs) and the SSM state;
* a prefill of 12 tokens, then 4 decode steps (``mamba_decode``, the
  forward at S = 1) from the prefill's state;
* gradients through the scan with respect to the input, the initial states
  and every parameter, autograd against ``jax.vjp`` with random
  cotangents on the output and both final states;
* the state's shapes and dtypes (``mamba_init_state``).

Everything at rtol 1e-5 and atol 1e-5 of the largest |value|: the scan
sums the same float32 terms in the same order on both sides, and the
projections' matmuls differ only in summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import params as ref_pr
from repro.models import ssm as ref_ssm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import ssm

TOL = 1e-5
B = 2


def _variant(cfg, kind):
    if kind == "jamba-smoke":
        return cfg
    # d_state 16, a short conv, an explicit dt rank
    return dataclasses.replace(cfg, mamba_d_state=16, mamba_d_conv=3, mamba_dt_rank=5)


KINDS = ("jamba-smoke", "state16-conv3")


def _setup(kind, seed=0):
    ref_cfg = _variant(ref_get_arch("jamba_1_5_large_398b", smoke=True), kind)
    cfg = _variant(get_arch("jamba_1_5_large_398b", smoke=True), kind)
    p = jax.tree.map(np.asarray, ref_pr.init_tree(jax.random.PRNGKey(seed),
                                                  ref_ssm.mamba_decl(ref_cfg)))
    rng = np.random.default_rng(seed + 10)
    di, ds = p["a_log"].shape
    p["a_log"] = (np.log(np.arange(1, ds + 1, dtype=np.float32))[None]
                  + 0.1 * rng.standard_normal((di, ds))).astype(np.float32)
    for name, scale in (("dt_bias", 0.5), ("conv_b", 0.1), ("d_skip", 0.3)):
        p[name] = (p[name] + scale * rng.standard_normal(p[name].shape)).astype(np.float32)
    return ref_cfg, cfg, p, convert.params_from_numpy(p, device="cpu"), rng


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _state(cfg, rng):
    di = cfg.mamba_expand * cfg.d_model
    return {"conv": rng.standard_normal((B, cfg.mamba_d_conv - 1, di)).astype(np.float32),
            "ssm": rng.standard_normal((B, di, cfg.mamba_d_state)).astype(np.float32)}


@pytest.mark.parametrize("given", [False, True], ids=["zero-state", "given-state"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_reference(kind, given):
    ref_cfg, cfg, rp, p, rng = _setup(kind)
    x = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng) if given else None
    r_out, r_st = ref_ssm.mamba_forward(
        rp, jnp.asarray(x), ref_cfg,
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    with torch.no_grad():
        out, new = ssm.mamba_forward(
            p, torch.from_numpy(x), cfg,
            None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
    _close(out, r_out, "out")
    for name in ("conv", "ssm"):
        _close(new[name], r_st[name], name)
    # the conv state is the last d_conv - 1 inputs of the conv: x's projection
    di = cfg.mamba_expand * cfg.d_model
    _close(new["conv"], (x @ rp["in_proj"])[:, -(cfg.mamba_d_conv - 1):, :di], "conv inputs")


@pytest.mark.parametrize("kind", KINDS)
def test_decode_after_prefill_matches_reference(kind):
    ref_cfg, cfg, rp, p, rng = _setup(kind, seed=1)
    x = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    r_out, r_st = ref_ssm.mamba_forward(rp, jnp.asarray(x[:, :12]), ref_cfg)
    with torch.no_grad():
        out, st = ssm.mamba_forward(p, torch.from_numpy(x[:, :12]), cfg)
        _close(out, r_out, "prefill out")
        for t in range(12, 16):
            r_out, r_st = ref_ssm.mamba_decode(rp, jnp.asarray(x[:, t:t + 1]), ref_cfg, r_st)
            out, st = ssm.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), cfg, st)
            _close(out, r_out, f"decode {t} out")
            for name in ("conv", "ssm"):
                _close(st[name], r_st[name], f"decode {t} {name}")
        # decode continues the prefill exactly as a longer forward does
        whole, whole_st = ssm.mamba_forward(p, torch.from_numpy(x), cfg)
        _close(out[:, 0], whole[:, -1].numpy(), "decode vs whole forward")
        _close(st["ssm"], whole_st["ssm"].numpy(), "decode state vs whole forward")


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_through_the_scan_match_vjp(kind):
    ref_cfg, cfg, rp, p, rng = _setup(kind, seed=2)
    x = rng.standard_normal((B, 10, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng)
    d_out = rng.standard_normal(x.shape).astype(np.float32)
    d_st = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in st.items()}

    def ref_f(params, xx, state):
        return ref_ssm.mamba_forward(params, xx, ref_cfg, state)

    (r_out, r_new), vjp = jax.vjp(ref_f, jax.tree.map(jnp.asarray, rp), jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in st.items()})
    r_dp, r_dx, r_dst = vjp((jnp.asarray(d_out), {k: jnp.asarray(v) for k, v in d_st.items()}))

    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    state = {k: torch.from_numpy(v).requires_grad_(True) for k, v in st.items()}
    out, new = ssm.mamba_forward(leaves, xx, cfg, state)
    torch.autograd.backward([out, new["conv"], new["ssm"]],
                            [torch.from_numpy(d_out)] + [torch.from_numpy(d_st[k])
                                                         for k in ("conv", "ssm")])
    _close(out, r_out, "out")
    _close(xx.grad, r_dx, "dx")
    for k in ("conv", "ssm"):
        _close(state[k].grad, r_dst[k], f"d state {k}")
    want = convert._flatten(jax.tree.map(np.asarray, r_dp))
    assert sorted(want) == sorted(leaves)
    for n, t in leaves.items():
        _close(t.grad, want[n], f"d{n}")


def test_init_state_matches_reference():
    ref_cfg = ref_get_arch("jamba_1_5_large_398b", smoke=True)
    cfg = get_arch("jamba_1_5_large_398b", smoke=True)
    want = ref_ssm.mamba_init_state(ref_cfg, 3)
    got = ssm.mamba_init_state(cfg, 3, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(want[k].dtype).name
        assert not got[k].any()
    assert sorted(ssm.mamba_decl(cfg)) == sorted(ref_ssm.mamba_decl(ref_cfg))
    for k, d in ssm.mamba_decl(cfg).items():
        r = ref_ssm.mamba_decl(ref_cfg)[k]
        assert (d.shape, d.init, d.scale) == (r.shape, r.init, r.scale), k
