"""The CUDA blockwise quantizer against its plain PyTorch version, on the card.

Needs a CUDA device and ``nvcc``: every test here is marked ``cuda`` and
skips itself where torch finds no device.  On the card the kernel must give
the plain version's int8 payload elementwise and its scales exactly, at every
leaf shape of the paper's MLP and CNN with K = 10 (all of them one block per
row, including the ragged D = 10 and the D = 512,000 of the CNN's fc0/w),
at multi-block layouts, and at qmax 127 and 7.  Run it on a machine with a
card with ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernel.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.quant_gossip import kernel as qk
from repro_torch.kernels.quant_gossip import ops, ref

pytestmark = pytest.mark.cuda

PAPER_D = [128, 100352, 64, 8192, 10, 640,                     # MLP leaves
           32, 864, 18432, 36864, 500, 512000, 250000, 5000]   # CNN leaves
CASES = [(10, d, 65536) for d in PAPER_D] + [
    (10, 131072, 65536),  # two blocks per row
    (16, 4096, 128),      # the serving layout's block
    (3, 1000, 256),       # ragged: one block per row
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(k, d, seed, device):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, d)) * rng.uniform(0.01, 3.0, (k, 1))).astype(np.float32)
    if k > 2:
        x[1] = 0.0  # an all-zero row: scale 1
    u = rng.random((k, d), dtype=np.float32)
    u[0, ::3] = 0.0
    return torch.from_numpy(x).to(device), torch.from_numpy(u).to(device)


@pytest.mark.parametrize("k,d,block_d", CASES)
@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_kernel_equals_plain(cuda, k, d, block_d, qmax):
    x, u = _inputs(k, d, seed=d + k, device=cuda)
    q, s = qk.quantize_blockwise(x, u, qmax=qmax, block_d=block_d)
    q_p, s_p = ref.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.shape == (k, qk.num_blocks(d, block_d))
    assert torch.equal(q, q_p)
    assert torch.equal(s, s_p)
    # and the plain version on the card equals it on the CPU
    q_c, s_c = ref.quantize_blockwise_ref(x.cpu(), u.cpu(), qmax=qmax, block_d=block_d)
    assert torch.equal(q.cpu(), q_c) and torch.equal(s.cpu(), s_c)


def test_kernel_unaligned_rows_take_the_scalar_path(cuda):
    """A contiguous (K, D) view whose data does not start on 16 bytes."""
    k, d = 4, 1024
    x0, u0 = _inputs(k, d, seed=5, device=cuda)
    x = torch.empty(k * d + 1, device=cuda)[1:].view(k, d).copy_(x0)
    u = torch.empty(k * d + 1, device=cuda)[1:].view(k, d).copy_(u0)
    q, s = qk.quantize_blockwise(x, u, block_d=256)
    q_p, s_p = ref.quantize_blockwise_ref(x0, u0, block_d=256)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)


def test_dispatcher_launches_the_kernel_for_cuda_tensors(cuda):
    x, u = _inputs(10, 640, seed=1, device=cuda)
    launches, plain = qk.quantize_blockwise.launches, ops.quantize_blockwise.plain_calls
    ops.quantize_blockwise(x, u)
    ops.quantize_blockwise(x, u, qmax=7.0)
    assert qk.quantize_blockwise.launches == launches + 2
    assert ops.quantize_blockwise.plain_calls == plain


@pytest.mark.parametrize("bad", ["float64", "strided", "shape", "qmax"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    x, u = _inputs(4, 256, seed=2, device=cuda)
    kwargs = {}
    if bad == "float64":
        x = x.double()
    elif bad == "strided":
        x = x.t().contiguous().t()
    elif bad == "shape":
        u = u[:, :128]
    else:
        kwargs["qmax"] = 200.0
    launches = qk.quantize_blockwise.launches
    with pytest.raises((TypeError, ValueError)):
        qk.quantize_blockwise(x, u, **kwargs)
    assert qk.quantize_blockwise.launches == launches


def test_compressed_round_on_the_card_matches_the_cpu(cuda):
    """One CHOCO int8-kernel dense round, the same uniforms on both devices:
    the payload is bit-exact, so θ and θ̂ differ only by the W product's
    float32 summation order (atol 1e-6)."""
    from repro_torch.comm import CompressionConfig
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.graphs import build_graph, metropolis_weights

    k = 10
    w = metropolis_weights(build_graph("erdos_renyi", k, p=0.3, seed=0))
    rng = np.random.default_rng(0)
    theta = {n: rng.standard_normal((k,) + s).astype(np.float32)
             for n, s in (("fc0/b", (128,)), ("fc0/w", (784, 128)), ("fc1/w", (5,)))}

    def noise(rounds, leaf_idx, shape):
        return np.random.default_rng([rounds, leaf_idx]).random(shape, dtype=np.float32)

    cfg = CompressionConfig(kind="int8", use_kernel=True)
    out = {}
    for dev in ("cuda", "cpu"):
        m = make_dense_mixer(w, compression=cfg, device=dev, uniforms=noise)
        t = {n: torch.from_numpy(v).to(dev) for n, v in theta.items()}
        launches = qk.quantize_blockwise.launches
        t2, st = m(t, m.init_state(t))
        assert qk.quantize_blockwise.launches == launches + (3 if dev == "cuda" else 0)
        out[dev] = (t2, st)
    (t_g, s_g), (t_c, s_c) = out["cuda"], out["cpu"]
    for n in theta:
        torch.testing.assert_close(t_g[n].cpu(), t_c[n], rtol=0, atol=1e-6)
        assert torch.equal(s_g.hat[n].cpu(), s_c.hat[n])
