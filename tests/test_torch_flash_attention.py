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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

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
