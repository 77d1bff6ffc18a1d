"""The port's blockwise quantizer (plain PyTorch version) against the reference.

On the CPU the port's quantizer runs its plain version; it must give the
same int8 payload bit for bit and the same scales as the reference's jnp
oracle ``quantize_blockwise_ref`` and its Pallas kernel run in interpret
mode, from the same x and uniforms u.  The CUDA kernel is held against this
plain version on the card (tests/test_torch_kernel.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_gossip import kernel as ref_kernel
from repro.kernels.quant_gossip.ref import dequantize_blockwise_ref, quantize_blockwise_ref
from repro_torch.kernels.quant_gossip import kernel as port_kernel
from repro_torch.kernels.quant_gossip import ops, ref

# (K, D, block_d): tests/test_comm.py's kernel shapes, ragged tails that
# fall back to one block per row, and every leaf of the paper's MLP and CNN
# at K = 10 with the default block (all of them one block per row)
COMM_SHAPES = [(4, 256, 64), (3, 1000, 1000), (1, 128, 32), (8, 512, 512)]
RAGGED = [(3, 1000, 256), (2, 130, 64), (5, 7, 4)]
PAPER_D = [128, 100352, 64, 8192, 10, 640,                     # MLP leaves
           32, 864, 18432, 36864, 500, 512000, 250000, 5000]   # CNN leaves
PAPER = [(10, d, 65536) for d in PAPER_D]


def _inputs(k, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, d)) * rng.uniform(0.01, 3.0, (k, 1))).astype(np.float32)
    u = rng.random((k, d), dtype=np.float32)
    return x, u


def _check(x, u, qmax, block_d, interpret=True):
    q, s = ref.quantize_blockwise_ref(torch.from_numpy(x), torch.from_numpy(u),
                                      qmax=qmax, block_d=block_d)
    q, s = q.numpy(), s.numpy()
    q_ref, s_ref = quantize_blockwise_ref(jnp.asarray(x), jnp.asarray(u),
                                          qmax=jnp.float32(qmax), block_d=block_d)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, np.asarray(q_ref))
    np.testing.assert_array_equal(s, np.asarray(s_ref))
    if interpret:
        q_k, s_k = ref_kernel.quantize_blockwise(jnp.asarray(x), jnp.asarray(u), qmax=qmax,
                                                 block_d=block_d, interpret=True)
        np.testing.assert_array_equal(q, np.asarray(q_k))
        np.testing.assert_array_equal(s, np.asarray(s_k))
    deq = ref.dequantize_blockwise_ref(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(deq, np.asarray(dequantize_blockwise_ref(
        jnp.asarray(q), jnp.asarray(s))))


@pytest.mark.parametrize("k,d,block_d", COMM_SHAPES + RAGGED + PAPER)
@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_quantize_plain_matches_reference(k, d, block_d, qmax):
    x, u = _inputs(k, d, seed=k * 7919 + d)
    _check(x, u, qmax, block_d)


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_quantize_boundaries_match_reference(qmax):
    """Rows that hit the edge cases: an all-zero row (scale 1), x on exact
    multiples of the scale, u = 0 and u just below 1, a single spike."""
    k, d = 5, 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal((k, d)).astype(np.float32)
    x[0] = 0.0
    x[1] = (np.arange(d) % 17 - 8).astype(np.float32) * np.float32(0.37)
    x[2, :] = 0.0
    x[2, 5] = -2.5
    u = rng.random((k, d), dtype=np.float32)
    u[1, ::2] = 0.0
    u[3] = np.nextafter(np.float32(1.0), np.float32(0.0))
    u[4] = 0.5
    _check(x, u, qmax, block_d=64)


@pytest.mark.parametrize("d,block_d", [(10, 65536), (512000, 65536), (131072, 65536),
                                       (1000, 256), (256, 64), (7, 4), (128, 128)])
def test_block_layout_matches_reference(d, block_d):
    assert port_kernel._pick_block(d, block_d) == ref_kernel._pick_block(d, block_d)
    assert port_kernel.num_blocks(d, block_d) == ref_kernel.num_blocks(d, block_d)


def test_dispatcher_takes_plain_version_only_on_cpu():
    x, u = _inputs(2, 64, seed=0)
    before = ops.quantize_blockwise.plain_calls
    launches = port_kernel.quantize_blockwise.launches
    q, s = ops.quantize_blockwise(torch.from_numpy(x), torch.from_numpy(u))
    assert ops.quantize_blockwise.plain_calls == before + 1
    assert port_kernel.quantize_blockwise.launches == launches
    q_ref, s_ref = ref.quantize_blockwise_ref(torch.from_numpy(x), torch.from_numpy(u))
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; it never runs
    the plain version itself."""
    x, u = _inputs(2, 64, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.quantize_blockwise(torch.from_numpy(x), torch.from_numpy(u))


# -- B.3 dequant_accumulate, B.4 masked_quantize_blockwise, B.5
# masked_dequant_accumulate ---------------------------------------------------
#
# The plain versions compute acc + (a·scale)·q with every product and the sum
# rounded once, a = w (B.3) or m·w (B.5): the order of the reference's Pallas
# kernels (kernel.py:46, 70).  On the CPU, XLA contracts that multiply-add
# into one FMA, fma(a·scale, q, acc), when it runs the Pallas kernels in
# interpret mode, and the reference's jnp oracle computes acc + w·(q·scale):
# both differ from the port by about an ulp of the result (at most 4.8e-7
# here), so the accumulations are held to them at rtol 1e-6, atol 1e-6, and
# bitwise to the Pallas source order computed step by step in numpy.
# Payloads (q, scales) are exact against the oracle and the Pallas kernel
# called outside jit (under jit XLA may turn absmax/127 into a multiply by
# the reciprocal, which the reference's own tests allow at rtol 1e-6).

from repro.kernels.quant_gossip import ref as ref_oracle

# tests/test_comm.py:262 and tests/test_dynamics.py:913 shapes, then the
# paper MLP's leaf widths at K = 10 (all one block per row)
ACC_SHAPES = [(4, 256, 64), (2, 1000, 1000), (3, 1000, 1000)]
MLP = [(10, d, 65536) for d in PAPER_D[:6]]
MASKS = ["mixed", "ones", "zeros"]


def _mask(kind, k):
    if kind == "ones":
        return np.ones(k, np.float32)
    if kind == "zeros":
        return np.zeros(k, np.float32)
    return (np.arange(k) % 2).astype(np.float32)


def _acc_inputs(k, d, block_d, seed):
    x, u = _inputs(k, d, seed)
    rng = np.random.default_rng(seed + 1)
    acc = rng.standard_normal((k, d)).astype(np.float32)
    w = rng.uniform(0.05, 0.5, k).astype(np.float32)
    q, s = ref.quantize_blockwise_ref(torch.from_numpy(x), torch.from_numpy(u),
                                      block_d=block_d)
    return acc, q.numpy(), s.numpy(), w


def _numpy_pallas_order(acc, q, s, a):
    """acc + (a·scale)·q in float32, each step rounded (numpy never fuses)."""
    n_blk = s.shape[1]
    a_s = (a[:, None] * s).astype(np.float32)
    prod = (np.repeat(a_s, q.shape[1] // n_blk, axis=1) * q.astype(np.float32))
    return (acc + prod.astype(np.float32)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("k,d,block_d", ACC_SHAPES + MLP)
def test_dequant_accumulate_plain_matches_reference(k, d, block_d):
    acc, q, s, w = _acc_inputs(k, d, block_d, seed=d + k)
    out = ref.dequant_accumulate_ref(*_t(acc, q, s, w)).numpy()
    np.testing.assert_array_equal(out, _numpy_pallas_order(acc, q, s, w))
    want = ref_oracle.dequant_accumulate_ref(jnp.asarray(acc), jnp.asarray(q), jnp.asarray(s),
                                             jnp.asarray(w))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-6, atol=1e-6)
    if d <= 8192:  # the Pallas kernel in interpret mode (slow on wide rows)
        got = ref_kernel.dequant_accumulate(jnp.asarray(acc), jnp.asarray(q), jnp.asarray(s),
                                            jnp.asarray(w), interpret=True)
        np.testing.assert_allclose(out, np.asarray(got), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,d,block_d", ACC_SHAPES + MLP)
@pytest.mark.parametrize("mask", MASKS)
def test_masked_quantize_plain_matches_reference(k, d, block_d, mask):
    x, u = _inputs(k, d, seed=d * 3 + k)
    m = _mask(mask, k)
    q, s = ref.masked_quantize_blockwise_ref(*_t(x, u, m), block_d=block_d)
    q, s = q.numpy(), s.numpy()
    q_o, s_o = ref_oracle.masked_quantize_blockwise_ref(jnp.asarray(x), jnp.asarray(u),
                                                        jnp.asarray(m), block_d=block_d)
    np.testing.assert_array_equal(q, np.asarray(q_o))
    np.testing.assert_array_equal(s, np.asarray(s_o))
    if d <= 8192:
        q_k, s_k = ref_kernel.masked_quantize_blockwise(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(m), qmax=127.0, block_d=block_d,
            interpret=True)
        np.testing.assert_array_equal(q, np.asarray(q_k))
        np.testing.assert_array_equal(s, np.asarray(s_k))
    # masked senders put nothing on the wire; live rows are B.2's payload
    assert not q[m == 0].any() and not s[m == 0].any()
    q2, s2 = ref.quantize_blockwise_ref(*_t(x, u), block_d=block_d)
    np.testing.assert_array_equal(q[m > 0], q2.numpy()[m > 0])
    np.testing.assert_array_equal(s[m > 0], s2.numpy()[m > 0])


@pytest.mark.parametrize("k,d,block_d", ACC_SHAPES + MLP)
@pytest.mark.parametrize("mask", MASKS)
def test_masked_dequant_accumulate_plain_matches_reference(k, d, block_d, mask):
    acc, q, s, w = _acc_inputs(k, d, block_d, seed=d * 5 + k)
    m = _mask(mask, k)
    out = ref.masked_dequant_accumulate_ref(*_t(acc, q, s, w, m)).numpy()
    np.testing.assert_array_equal(out[m == 0], acc[m == 0])  # bitwise passthrough
    np.testing.assert_array_equal(out[m > 0],
                                  _numpy_pallas_order(acc, q, s, m * w)[m > 0])
    want = ref_oracle.masked_dequant_accumulate_ref(
        jnp.asarray(acc), jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), jnp.asarray(m))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-6, atol=1e-6)
    if d <= 8192:
        got = ref_kernel.masked_dequant_accumulate(
            jnp.asarray(acc), jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), jnp.asarray(m),
            interpret=True)
        np.testing.assert_allclose(out, np.asarray(got), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got)[m == 0], acc[m == 0])
    if mask == "ones":  # an all-ones mask is B.3 bit for bit
        np.testing.assert_array_equal(out, ref.dequant_accumulate_ref(*_t(acc, q, s, w)).numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_accumulate_src_is_an_explicit_gather(masked):
    """``src`` reads row src[i] of the payload: the one-card ppermute.  An
    idle node (src[i] = i, weight 0) keeps acc bitwise, as does a zero
    weight anywhere."""
    k, d, block_d = 8, 96, 32
    acc, q, s, w = _acc_inputs(k, d, block_d, seed=11)
    src = np.array([3, 2, 1, 0, 4, 6, 5, 7], np.int64)
    w[[4, 7]] = 0.0  # idle rows carry weight 0
    w[5] = 0.0       # and a dropped link
    m = np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32)
    args = _t(acc, q, s, w) + ([torch.from_numpy(m)] if masked else [])
    fn = ref.masked_dequant_accumulate_ref if masked else ref.dequant_accumulate_ref
    out = fn(*args, src=torch.from_numpy(src)).numpy()
    gathered = _t(acc, q[src], s[src], w) + ([torch.from_numpy(m)] if masked else [])
    np.testing.assert_array_equal(out, fn(*gathered).numpy())
    np.testing.assert_array_equal(out[[4, 5, 7]], acc[[4, 5, 7]])
    live = [0, 1, 2, 3, 6]
    assert not np.array_equal(out[live], acc[live])


def test_composed_rounds_equal_their_steps():
    k, d = 6, 48
    x, u = _inputs(k, d, seed=21)
    acc = np.random.default_rng(3).standard_normal((k, d)).astype(np.float32)
    w = np.linspace(0.1, 0.4, k).astype(np.float32)
    src = np.array([1, 0, 3, 2, 4, 5], np.int64)
    m = np.array([1, 1, 0, 0, 1, 1], np.float32)
    tx, tu, tacc, tw, tsrc, tm = _t(x, u, acc, w, src, m)
    q, s = ref.quantize_blockwise_ref(tx, tu, qmax=7.0, block_d=16)
    want = ref.dequant_accumulate_ref(tacc, q, s, tw, src=tsrc)
    got = ops.quant_gossip_round(tx, tacc, tw, tsrc, tu, qmax=7.0, block_d=16)
    assert torch.equal(got, want)
    q, s = ref.masked_quantize_blockwise_ref(tx, tu, tm, block_d=16)
    want = ref.masked_dequant_accumulate_ref(tacc, q, s, tw, tm, src=tsrc)
    got = ops.masked_quant_gossip_round(tx, tacc, tw, tm, tsrc, tu, block_d=16)
    assert torch.equal(got, want)
    assert torch.equal(got[2:4], tacc[2:4])


@pytest.mark.parametrize("name", ["dequant_accumulate", "masked_quantize_blockwise",
                                  "masked_dequant_accumulate"])
def test_new_dispatchers_take_plain_versions_only_on_cpu(name):
    k, d = 4, 64
    acc, q, s, w = _acc_inputs(k, d, 64, seed=2)
    x, u = _inputs(k, d, seed=3)
    m = _mask("mixed", k)
    args = {"dequant_accumulate": _t(acc, q, s, w),
            "masked_quantize_blockwise": _t(x, u, m),
            "masked_dequant_accumulate": _t(acc, q, s, w, m)}[name]
    dispatch, kern, plain = getattr(ops, name), getattr(port_kernel, name), getattr(ref, f"{name}_ref")
    before, launches = dispatch.plain_calls, kern.launches
    got = dispatch(*args)
    assert dispatch.plain_calls == before + 1 and kern.launches == launches
    want = plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    # the kernel wrapper launches on CUDA tensors or raises; never runs plain
    with pytest.raises(ValueError, match="CUDA"):
        kern(*args)
