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
