"""The port's WKV6 plain version against the reference's.

The plain version (``repro_torch/kernels/rwkv6_scan/ref.py``) is what the
port runs on the CPU and what the CUDA kernel (B.7) is held against on the
card (tests/test_torch_kernel.py).  Here y is held against the reference's
oracle ``wkv6_ref`` and its Pallas ``wkv6_scan`` in interpret mode on the
cases of tests/test_kernel_rwkv6.py, at rtol = atol = 2e-5 (those tests'
tolerance); the final state, which the Pallas kernel drops, against the
``wkv`` state the reference's ``rwkv_forward`` returns on a smoke block
with a random ``bonus`` and decay (its init makes u = 0 and w ≈ 0.9975,
which would hide the u term and the decay), at rtol = atol = 1e-5.  The
inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.kernels.rwkv6_scan.kernel import wkv6_scan
from repro.kernels.rwkv6_scan.ref import wkv6_ref as ref_wkv6
from repro.models import TransformerLM as RefLM
from repro.models.ssm import rwkv_forward as ref_rwkv_forward
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels.rwkv6_scan import kernel as wk
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
from repro_torch.models.ssm import rwkv_forward
from repro_torch.utils.tree import subtree

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, b, h, t, hd):
    """The reference test's distributions: r, k, v ~ 0.5 N(0, 1), w in
    (0.45, 0.95), u ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, h, t, hd)).astype(np.float32)
               for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((b, h, t, hd)))) + 0.45).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
    return r, k, v, w, u


def _port(*xs, s0=None):
    y, s = wkv6_ref(*(torch.from_numpy(x) for x in xs),
                    None if s0 is None else torch.from_numpy(s0))
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("b,h,t,hd,bt", [(2, 2, 32, 16, 8), (1, 4, 64, 32, 64),
                                         (2, 1, 16, 8, 4), (1, 2, 64, 16, 16)])
def test_matches_reference(b, h, t, hd, bt):
    xs = _case(b * 100 + t, b, h, t, hd)
    got, _ = _port(*xs)
    j = tuple(jnp.asarray(x) for x in xs)
    np.testing.assert_allclose(got, np.asarray(ref_wkv6(*j)), **TOL)
    np.testing.assert_allclose(got, np.asarray(wkv6_scan(*j, block_t=bt, interpret=True)),
                               **TOL)


def test_state_carries_across_a_split():
    """Starting the second half from the first half's final state gives the
    whole run's outputs and final state."""
    r, k, v, w, u = _case(7, 2, 3, 40, 16)
    y, s = _port(r, k, v, w, u)
    y1, s1 = _port(*(x[:, :, :17] for x in (r, k, v, w)), u)
    y2, s2 = _port(*(x[:, :, 17:] for x in (r, k, v, w)), u, s0=s1)
    np.testing.assert_allclose(np.concatenate([y1, y2], axis=2), y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s2, s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seq", [12, 33])
def test_final_state_matches_reference_rwkv_forward(seq):
    cfg_ref = ref_get_arch("rwkv6_7b", smoke=True)
    cfg = get_arch("rwkv6_7b", smoke=True)
    params = jax.tree.map(np.asarray, RefLM(cfg_ref).init(jax.random.PRNGKey(0)))
    block = jax.tree.map(lambda a: a[0], params["groups"]["l0"]["mix"])
    rng = np.random.default_rng(seq)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    block["time"]["bonus"] = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    block["time"]["decay_base"] = rng.uniform(-3.0, 1.0, cfg.d_model).astype(np.float32)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    y_ref, st_ref = ref_rwkv_forward(block, jnp.asarray(x), cfg_ref)
    p = convert.params_from_numpy(block, device="cpu")
    y, st = rwkv_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    for name in ("wkv", "x_time", "x_chan"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(st_ref[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert subtree(p, "time")["bonus"].abs().max() > 0


# -- the CUDA kernel's arithmetic order (csrc/wkv6.cu) --------------------------

def _f32(x):
    """Round float64 values to float32 and keep them in float64, where the
    product of two float32 values is exact."""
    return x.to(torch.float32).to(torch.float64)


def _fma(a, b, c):
    """fma(a, b, c) of float32 values: a·b + c rounded once (to float64,
    then float32; the double rounding can move an ulp on rare ties)."""
    return _f32(a * b + c)


def _tree(x):
    """The lanes' shuffle tree over the last axis: the halves added pairwise,
    the highest lane bit first, as __shfl_xor_sync with offsets n/2 .. 1."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = _f32(x[..., :half] + x[..., half:])
    return x[..., 0]


def keysplit_wkv6(r, k, v, w, u, s0=None):
    """B.7's arithmetic as csrc/wkv6.cu orders it, in float32: per step the
    bonus sum_i (r_i u_i) k_i as FMAs over each of P lanes' rows (rows
    4 (p + P q) + e), joined by the shuffle tree; per row group g of NG
    (rows 4 (g + NG q) + e, in that order) the partial y_j as a chain of
    fma(r_i, S_ij, acc) and the state as fma(w_i, S_ij, k_i v_j); the row
    groups joined by the shuffle tree; y_j = fma(v_j, bonus, sum).  numpy
    in, numpy out: (y (B, H, T, hd), final S (B, H, hd, hd))."""
    r, k, v, w, u = (torch.from_numpy(x).double() for x in (r, k, v, w, u))
    b, h, t, hd = r.shape
    rows, cols, chunk = {8: (4, 1, 16), 16: (4, 2, 32), 32: (4, 4, 32), 64: (8, 4, 32)}[hd]
    ng = hd // rows
    lanes = ng * hd // cols // chunk  # bonus lanes per step
    order = torch.tensor([[4 * (g + ng * q) + e for q in range(rows // 4) for e in range(4)]
                          for g in range(ng)])                       # (NG, R)
    bonus_rows = torch.tensor([[4 * (p + lanes * q) + e for q in range(hd // lanes // 4)
                                for e in range(4)] for p in range(lanes)])
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float64) if s0 is None
         else torch.from_numpy(s0).double())
    ys = []
    for i in range(t):
        rt, kt, vt, wt = (x[:, :, i] for x in (r, k, v, w))
        parts = torch.zeros((b, h, lanes), dtype=torch.float64)
        for m in range(bonus_rows.shape[1]):
            idx = bonus_rows[:, m]
            parts = _fma(_f32(rt[..., idx] * u[:, idx]), kt[..., idx], parts)
        bonus = _tree(parts)
        acc = torch.zeros((b, h, hd, ng), dtype=torch.float64)     # (.., column, group)
        for m in range(rows):
            idx = order[:, m]
            s_rows = s[:, :, idx, :]                                 # (B, H, NG, hd)
            acc = _fma(rt[..., idx][..., None, :], s_rows.transpose(2, 3), acc)
            kv = _f32(kt[..., idx][..., :, None] * vt[..., None, :])
            s[:, :, idx, :] = _fma(wt[..., idx][..., :, None], s_rows, kv)
        ys.append(_fma(vt, bonus[..., None], _tree(acc)))
    return (torch.stack(ys, dim=2).float().numpy(), s.float().numpy())


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("decay", ["random", "init", "1e-6"])
def test_keysplit_order_matches_reference(decay, hd):
    """The kernel's summation order (key-split partial sums joined by the
    lanes' tree, the bonus as one scalar per step) against the reference's
    oracle at TOL, for decays drawn in (0.45, 0.95), at the init value
    exp(-exp(-6)) ≈ 0.9975 (the state hardly decays) and at 1e-6 (it is
    forgotten every step); from zero and from a given state."""
    r, k, v, w, u = _case(11 + hd, 2, 2, 40, hd)
    if decay == "init":
        w = np.full_like(w, np.exp(-np.exp(-6.0)))
    elif decay == "1e-6":
        w = np.full_like(w, 1e-6)
    u = (5.0 * u).astype(np.float32)  # a bonus term of the state's size
    y, s = keysplit_wkv6(r, k, v, w, u)
    want = np.asarray(ref_wkv6(*(jnp.asarray(x) for x in (r, k, v, w, u))))
    np.testing.assert_allclose(y, want, **TOL)
    _, s_plain = _port(r, k, v, w, u)
    np.testing.assert_allclose(s, s_plain, **TOL)
    s0 = np.random.default_rng(hd).standard_normal(s.shape).astype(np.float32)
    y0, s1 = keysplit_wkv6(r, k, v, w, u, s0=s0)
    y0_plain, s1_plain = _port(r, k, v, w, u, s0=s0)
    np.testing.assert_allclose(y0, y0_plain, **TOL)
    np.testing.assert_allclose(s1, s1_plain, **TOL)


def test_dispatcher_runs_the_plain_version_on_cpu_only():
    xs = tuple(torch.from_numpy(x) for x in _case(3, 1, 2, 10, 16))
    before, launches = ops.wkv6.plain_calls, wk.wkv6_scan.launches
    y, s = ops.wkv6(*xs)
    assert ops.wkv6.plain_calls == before + 1 and wk.wkv6_scan.launches == launches
    assert y.shape == xs[0].shape and s.shape == (1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wk.wkv6_scan(*xs)


BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # tests/test_kernel_rwkv6.py::test_bf16


@pytest.mark.parametrize("b,h,t,hd", [(1, 2, 32, 16), (2, 1, 16, 8), (1, 4, 64, 32)])
def test_bf16_entry_point_and_kernel_arithmetic_match_reference(b, h, t, hd):
    """bfloat16 r, k, v, w, u: the port's entry point on the CPU (the plain
    version) and the card kernel's arithmetic (the inputs widened, its
    summation order, y rounded to bfloat16) against the reference's Pallas
    kernel in interpret mode on the same bfloat16 inputs, at the
    reference's 5e-2; y is bfloat16, the final state float32."""
    xs = [torch.from_numpy(x).bfloat16() for x in _case(b * 100 + t + 1, b, h, t, hd)]
    want = wkv6_scan(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs),
                     block_t=8, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    y, s = ops.wkv6(*xs)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), want, **BF16_TOL)
    y_k, s_k = keysplit_wkv6(*(x.float().numpy() for x in xs))
    np.testing.assert_allclose(torch.from_numpy(y_k).bfloat16().float().numpy(), want,
                               **BF16_TOL)
    np.testing.assert_allclose(s_k, s.numpy(), **TOL)
