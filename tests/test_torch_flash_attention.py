"""The port's flash-attention plain version against the reference's.

The plain version (``repro_torch/kernels/flash_attention/ref.py``) is what
the port runs on the CPU and what the CUDA kernel (B.6) is held against on
the card (tests/test_torch_kernel.py).  Here it is held against the
reference's jnp oracle ``attention_ref`` and its Pallas kernel
``flash_attention_fwd`` in interpret mode, on the shapes, windows, softcaps
and non-causal case of tests/test_kernel_flash_attention.py, at rtol = atol
= 2e-5 (the tolerance of those tests).  The inputs are made with numpy from
a seed and handed to both.  The Pallas kernel needs S and T to be tile
multiples; the port's kernel does not, so a non-tiling S is held against
``attention_ref`` alone.

The CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) take every
float32 matrix product as three TF32 tensor-core products.  That arithmetic
is emulated here in PyTorch (TF32 rounding by bit masking, as
``cvt.rna.tf32.f32`` rounds) and held against the reference's oracle and
``jax.vjp`` of it at the card's tests' shapes: the forward at 2e-5 and the
FlashAttention-2 backward within 1e-4 of each gradient's largest value, the
tolerances the kernels are held to on the card.  One TF32 product per
float32 product misses 2e-5 at qwen2-0.5b's shapes, which is why the
kernels take three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import MASKED, attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)

SHAPES = [  # b, h, kvh, s, t, hd, bq, bk (tests/test_kernel_flash_attention.py)
    (2, 4, 2, 64, 64, 16, 16, 16),
    (1, 4, 4, 128, 128, 32, 32, 64),
    (2, 8, 2, 64, 64, 16, 64, 16),
    (1, 2, 1, 32, 32, 8, 32, 32),
    (1, 6, 2, 96, 96, 16, 32, 32),
]


def _inputs(seed, b, h, kvh, s, t, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, hd), (b, kvh, t, hd), (b, kvh, t, hd)))


def _port(q, k, v, **kw):
    return attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()


def _both_refs(q, k, v, bq, bk, **kw):
    j = tuple(jnp.asarray(x) for x in (q, k, v))
    return (np.asarray(ref_attention(*j, **kw)),
            np.asarray(flash_attention_fwd(*j, block_q=bq, block_k=bk, interpret=True,
                                           **kw)))


@pytest.mark.parametrize("shape", SHAPES)
def test_causal_matches_reference(shape):
    b, h, kvh, s, t, hd, bq, bk = shape
    q, k, v = _inputs(sum(shape), b, h, kvh, s, t, hd)
    got = _port(q, k, v, causal=True)
    for want in _both_refs(q, k, v, bq, bk, causal=True):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_window_softcap_matches_reference(window, softcap):
    q, k, v = _inputs(1, 2, 4, 2, 64, 64, 16)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = _port(q, k, v, **kw)
    for want in _both_refs(q, k, v, 16, 16, **kw):
        np.testing.assert_allclose(got, want, **TOL)


def test_non_causal_matches_reference():
    q, k, v = _inputs(3, 1, 2, 1, 32, 32, 8)
    got = _port(q, k, v, causal=False)
    for want in _both_refs(q, k, v, 16, 16, causal=False):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s,window,softcap", [(50, None, None), (50, 7, 50.0),
                                              (130, 64, None)])
def test_non_tiling_length_matches_attention_ref(s, window, softcap):
    """S = T not a multiple of any tile: the Pallas kernel refuses it, the
    port's kernel masks the tail; the plain version is held to the oracle."""
    q, k, v = _inputs(s, 2, 4, 2, s, s, 16)
    kw = dict(causal=True, window=window, softcap=softcap)
    want = np.asarray(ref_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    np.testing.assert_allclose(_port(q, k, v, **kw), want, **TOL)


def test_strided_views_equal_contiguous():
    """The model hands over (B, S, H, hd) memory as (B, H, S, hd) views."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 2, 6, 3, 40, 40, 16))
    qv = q.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    kv_ = k.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    vv = v.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not qv.is_contiguous()
    torch.testing.assert_close(attention_ref(qv, kv_, vv, window=9),
                               attention_ref(q, k, v, window=9), rtol=0, atol=0)


def test_dispatcher_runs_the_plain_version_on_cpu_only():
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 2, 1, 16, 16, 16))
    before, launches = ops.flash_attention.plain_calls, fk.flash_attention_fwd.launches
    out = ops.flash_attention(q, k, v, window=4)
    assert ops.flash_attention.plain_calls == before + 1
    assert fk.flash_attention_fwd.launches == launches
    torch.testing.assert_close(out, attention_ref(q, k, v, window=4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_fwd(q, k, v)


# -- the kernels' 3xTF32 arithmetic, emulated -----------------------------------

# tests/test_torch_kernel.py's FLASH_CASES: b, h, kvh, s, t, hd, causal, window, softcap
KERNEL_CASES = [
    (2, 4, 2, 64, 64, 16, True, None, None),
    (2, 14, 2, 512, 512, 64, True, None, None),
    (1, 8, 2, 300, 300, 80, True, 64, None),
    (1, 8, 4, 200, 200, 128, True, 64, 50.0),
    (1, 4, 4, 130, 130, 128, True, None, 50.0),
    (2, 6, 3, 97, 97, 64, False, None, None),
    (1, 4, 1, 33, 77, 16, False, 8, 20.0),
    (2, 14, 2, 64, 64, 64, True, None, None),
    (1, 2, 2, 63, 63, 64, True, None, None),
    (1, 2, 2, 65, 65, 64, True, None, None),
    (1, 4, 4, 31, 33, 128, False, None, None),
    (1, 4, 2, 33, 31, 128, True, None, None),
    (2, 14, 2, 50, 50, 64, True, None, None),
    (1, 7, 1, 101, 101, 80, True, 32, None),
    (1, 7, 1, 65, 129, 64, False, None, None),
]
BWD_REL = 1e-4  # the backward's tolerance on the card, relative to each gradient's max
KEY_TILE = 32   # the forward's K/V tile (it sets only the order of the sums)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero, as cvt.rna.tf32.f32 rounds: add half of the dropped bits' unit to
    the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products, big.small + small.big + big.big, summed
    in float32 (the products of TF32 values are exact in float32)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_big @ b_small + a_small @ b_big + a_big @ b_big


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _mask(s, t, k0, k1, causal, window):
    qp = torch.arange(s)[:, None]
    kp = torch.arange(k0, k1)[None, :]
    ok = torch.ones((s, k1 - k0), dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    return ok


def _emulated_fwd(q, k, v, mm, causal, window, softcap):
    """flash_fwd.cu's arithmetic: scores and P V through ``mm``, an online
    softmax over key tiles, masked scores -1e30; returns (out, lse).  The
    kernel's exp is one ex2.approx (within ~1e-6 relative of exp at these
    scores); this takes torch.exp."""
    b, h, s, hd = q.shape
    t, g = k.shape[2], h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    m = torch.full((b, h, s, 1), MASKED)
    l, o = torch.zeros((b, h, s, 1)), torch.zeros((b, h, s, hd))
    for k0 in range(0, t, KEY_TILE):
        k1 = min(t, k0 + KEY_TILE)
        x = mm(q, k[:, :, k0:k1].transpose(-1, -2)) * (1.0 / hd ** 0.5)
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = torch.where(_mask(s, t, k0, k1, causal, window), x, torch.tensor(MASKED))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[:, :, k0:k1])
        m = m_new
    l = l.clamp_min(1e-30)
    return o / l, (m + torch.log(l))[..., 0]


def _emulated_bwd(q, k, v, o, lse, dout, mm, causal, window, softcap):
    """flash_bwd.cu's arithmetic: the FlashAttention-2 backward with each of
    its five products through ``mm``; dk and dv summed over each KV head's
    query heads in head order."""
    b, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g, scale = h // kvh, 1.0 / hd ** 0.5
    ke, ve = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    x = mm(q, ke.transpose(-1, -2)) * scale
    dcap = torch.ones_like(x)
    if softcap is not None:
        th = torch.tanh(x / softcap)
        x, dcap = softcap * th, 1 - th * th
    ok = _mask(s, t, 0, t, causal, window)
    p = torch.where(ok, torch.exp(x - lse[..., None]), torch.tensor(0.0))
    delta = (dout * o).sum(-1, keepdim=True)
    ds = p * (mm(dout, ve.transpose(-1, -2)) - delta) * dcap * scale
    dq = mm(ds, ke)
    dk = mm(ds.transpose(-1, -2), q).reshape(b, kvh, g, t, hd).sum(2)
    dv = mm(p.transpose(-1, -2), dout).reshape(b, kvh, g, t, hd).sum(2)
    return dq, dk, dv


def _oracle_vjp(q, k, v, dout, **kw):
    """The reference oracle's output and its vjp at dout (numpy in, numpy out)."""
    out, vjp = jax.vjp(lambda *x: ref_attention(*x, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_3xtf32_arithmetic_matches_reference(case):
    b, h, kvh, s, t, hd, causal, window, softcap = case
    q, k, v = _inputs(sum(case[:6]), b, h, kvh, s, t, hd)
    dout = np.random.default_rng(s + 7).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want_out, want_grads = _oracle_vjp(q, k, v, dout, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = _emulated_fwd(tq, tk, tv, _mm3, causal, window, softcap)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    grads = _emulated_bwd(tq, tk, tv, out, lse, tdo, _mm3, causal, window, softcap)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= BWD_REL, (name, rel)


@pytest.mark.parametrize("s", [64, 512])
def test_one_tf32_product_misses_the_tolerance(s):
    """qwen2-0.5b's attention (B 2, H 14 over 2, hd 64): one TF32 product per
    float32 product is off by far more than 2e-5; three are within it."""
    q, k, v = _inputs(s, 2, 14, 2, s, s, 64)
    want = np.asarray(ref_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    one, _ = _emulated_fwd(tq, tk, tv, _mm1, True, None, None)
    three, _ = _emulated_fwd(tq, tk, tv, _mm3, True, None, None)
    assert np.abs(one.numpy() - want).max() > 10 * TOL["atol"]
    np.testing.assert_allclose(three.numpy(), want, **TOL)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4, -(one + ulp / 2),
                      one + ulp, 3.0e-3], dtype=torch.float32)
    got = _tf32(x)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), one + ulp, 0.0])
    torch.testing.assert_close(got[:5], want[:5], rtol=0, atol=0)
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
