"""The CUDA quant_gossip kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and ``nvcc``: every test here is marked ``cuda`` and
skips itself where torch finds no device.  On the card each kernel must give
its plain version's result bit for bit — the quantizers' int8 payload and
scales (B.2 at qmax 127 and 7, B.4 with masks all ones, all zeros and mixed),
the accumulations (B.3, and B.5 at every mask pattern) with ``src`` None and
each matching of the fmnist graph — at every leaf shape of the paper's MLP
and CNN with K = 10 (all of them one block per row, including the ragged
D = 10 and the D = 512,000 of the CNN's fc0/w) and at multi-block layouts.
The wrappers reject what their kernels do not take, and the dispatchers
launch on CUDA tensors.

The serving kernels are held against their plain versions at rtol = atol =
2e-5 (the reference's own kernel tests' tolerance): flash attention (B.6)
at every head dim it is built for, with and without a window, softcap and
causal mask, at tile-multiple and ragged lengths, on the model's strided
layout; the WKV6 scan (B.7) at hd 16 and 64, ragged T (batches of four
steps and single steps after them), one step, w = 1e-6, from a zero and a
given state, on views staged by TMA and on rows off 16 bytes (plain
loads), y and the final state, at rtol 2e-5 and an atol of 2e-5 times
the largest |value| of the plain version's output: with N(0, 1) inputs and
the init's decay of 0.9975 over 256 steps the state grows to O(10) and y to
O(100), and y's 64-term dot products cancel, so the two summation orders
differ by up to 2e-6 of max |y| (2.2e-4 absolute, measured on an H100).
The LM's prefill on the card launches one B.6 per attn/swa layer and one
B.7 per rwkv layer and matches the CPU.

LM training: the per-node gossip update (B.1) equals its plain version bit
for bit (float32 and bfloat16, n = 0..5 neighbours); the node-stacked form
is held within 1e-6 of max |out| in float32 (its sum over the nodes is an
FMA chain where the plain version is a cuBLAS product) and 1e-2 in
bfloat16 (the output rounded to 8 bits after that sum), from K = 1 to 64.
B.6's backward (dq, dk, dv) is held against autograd of the plain version
within 1e-4 of each gradient's largest |value|, and the forward's row
log-sum-exp at 2e-5, at every flash case (qwen2-0.5b's training shape and
the edges of the kernels' tiles among them) and on rows that are not
16-byte aligned, and two backward calls give the same bits;
the node-stacked LM loss and its gradients on the card match the CPU
within the same 1e-4; the WKV6 scan refuses to be recorded for a gradient.

The masked int8 wire's grouped kernels (B.4 over every leaf of a matching
in thread-block clusters, B.5 in place) equal the one-leaf plain versions
bit for bit on the fmnist MLP's and the CNN's leaves, the layout cases as
groups and a group over the leaf cap (two launches), with every mask, src
and qmax, on rows off 16-byte boundaries too; the accumulate keeps acc's
storage; the wrappers refuse what the kernels do not take and are built
with the sizes the Python side states; a memoryless round through them
equals the leaf-by-leaf round.  B.3 grouped (B.5's kernel with no mask)
equals the one-leaf plain versions likewise, in place, and two static EF
rounds through it equal the rounds through the one-leaf B.3.  B.2 grouped
(B.4's kernel with no mask) equals the one-leaf plain version on the same
groups and on the serving layout's block 128, on rows off 16 bytes too.
B.1 stacked, grouped (every leaf of a step in one launch), equals the
one-leaf kernel bit for bit and the plain version within STACKED_REL (1e-2
in bfloat16), K in {1, 8, 10, 16, 33, 64}, leaves of 1, 10, 255, 257 and
100,352 columns, 20 leaves over the cap (two launches) and leaves that do
not start on the vector width.  At K = 65,
above the stacked B.1 kernel's
64 nodes, the SGD step on the card takes the unfused path (no B.1 launch),
equals the unfused step and stays within 1.5e-4 of the largest update of
the CPU's.

B.2 and B.4 grouped with qmax as a 0-d float32 tensor on the card (a
compression schedule's rate) equal the float form and the plain version bit
for bit at qmax 127, 7 and 42.5 on the MLP's and the CNN's leaves and the
serving layout, with and without a mask; such a call, and scheduled dense
int8-kernel rounds, run under CUDA's sync debug mode "error" (no
device-to-host copy, no synchronisation).

Run it on a machine with a card with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_kernel.py``.
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
        launches = qk.quantize_blockwise_grouped.launches
        t2, st = m(t, m.init_state(t))
        # one grouped B.2 launch per round over every leaf
        assert qk.quantize_blockwise_grouped.launches == launches + (dev == "cuda")
        out[dev] = (t2, st)
    (t_g, s_g), (t_c, s_c) = out["cuda"], out["cpu"]
    for n in theta:
        torch.testing.assert_close(t_g[n].cpu(), t_c[n], rtol=0, atol=1e-6)
        assert torch.equal(s_g.hat[n].cpu(), s_c.hat[n])


# -- B.3 dequant_accumulate, B.4 masked_quantize_blockwise, B.5
# masked_dequant_accumulate: bit-equal to their plain versions on the card ----

MASKS = ["ones", "zeros", "mixed"]
def _mask(kind, k, device):
    m = {"ones": np.ones(k), "zeros": np.zeros(k), "mixed": np.arange(k) % 2}[kind]
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _srcs(device):
    """None, then every matching of fmnist_default's graph (K = 10, ER(0.3),
    seed 0) as a src index tensor."""
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    w = metropolis_weights(build_graph("erdos_renyi", 10, p=0.3, seed=0))
    return [None] + [torch.from_numpy(p.astype(np.int64)).to(device)
                     for p in permutation_decomposition(w).matchings]


def _acc_inputs(k, d, block_d, seed, device):
    x, u = _inputs(k, d, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    acc = torch.randn((k, d), generator=gen, device=device)
    w = torch.rand((k,), generator=gen, device=device) * 0.5
    w[0] = 0.0  # a row that receives nothing
    q, s = ref.quantize_blockwise_ref(x, u, block_d=block_d)
    return acc, q, s, w


@pytest.mark.parametrize("k,d,block_d", CASES)
@pytest.mark.parametrize("mask", MASKS)
def test_masked_quantize_equals_plain(cuda, k, d, block_d, mask):
    x, u = _inputs(k, d, seed=d + 3 * k, device=cuda)
    m = _mask(mask, k, cuda)
    q, s = qk.masked_quantize_blockwise(x, u, m, block_d=block_d)
    q_p, s_p = ref.masked_quantize_blockwise_ref(x, u, m, block_d=block_d)
    torch.cuda.synchronize()
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert not q[m == 0].any() and not s[m == 0].any()


@pytest.mark.parametrize("k,d,block_d", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_dequant_accumulate_equals_plain(cuda, k, d, block_d, masked):
    """B.3 (and B.5 with every mask pattern) at every src: None and each
    matching of the fmnist graph (K = 10 only)."""
    acc, q, s, w = _acc_inputs(k, d, block_d, seed=d + k, device=cuda)
    srcs = _srcs(cuda) if k == 10 else [None]
    for src in srcs:
        for mask in (MASKS if masked else [None]):
            if mask is None:
                got = qk.dequant_accumulate(acc, q, s, w, src=src)
                want = ref.dequant_accumulate_ref(acc, q, s, w, src=src)
            else:
                m = _mask(mask, k, cuda)
                got = qk.masked_dequant_accumulate(acc, q, s, w, m, src=src)
                want = ref.masked_dequant_accumulate_ref(acc, q, s, w, m, src=src)
                assert torch.equal(got[m == 0], acc[m == 0])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (src, mask)
            assert torch.equal(got[0], acc[0])  # zero weight: acc bitwise


def test_new_dispatchers_launch_for_cuda_tensors(cuda):
    acc, q, s, w = _acc_inputs(10, 640, 65536, seed=1, device=cuda)
    x, u = _inputs(10, 640, seed=1, device=cuda)
    m = _mask("mixed", 10, cuda)
    names = ("dequant_accumulate", "masked_quantize_blockwise", "masked_dequant_accumulate")
    before = {n: (getattr(qk, n).launches, getattr(ops, n).plain_calls) for n in names}
    ops.dequant_accumulate(acc, q, s, w)
    ops.masked_quantize_blockwise(x, u, m)
    ops.masked_dequant_accumulate(acc, q, s, w, m)
    for n in names:
        assert getattr(qk, n).launches == before[n][0] + 1
        assert getattr(ops, n).plain_calls == before[n][1]


@pytest.mark.parametrize("bad", ["float64", "strided", "q-dtype", "scales-shape", "w-shape",
                                 "src-dtype", "cpu-q"])
def test_accumulate_wrappers_reject_what_the_kernel_does_not_take(cuda, bad):
    acc, q, s, w = _acc_inputs(4, 256, 64, seed=2, device=cuda)
    m = _mask("mixed", 4, cuda)
    src = None
    if bad == "float64":
        acc = acc.double()
    elif bad == "strided":
        acc = acc.t().contiguous().t()
    elif bad == "q-dtype":
        q = q.int()
    elif bad == "scales-shape":
        s = s[:, :2]
    elif bad == "w-shape":
        w = w[:3]
    elif bad == "src-dtype":
        src = torch.arange(4, device=cuda, dtype=torch.int32)
    else:
        q = q.cpu()
    for fn, args in ((qk.dequant_accumulate, (acc, q, s, w)),
                     (qk.masked_dequant_accumulate, (acc, q, s, w, m))):
        launches = fn.launches
        with pytest.raises((TypeError, ValueError)):
            fn(*args, src=src)
        assert fn.launches == launches


def test_gossip_rounds_on_the_card_match_the_cpu(cuda):
    """The static EF gossip round (B.2 + B.3) and the memoryless and EF
    dropout rounds (B.4 + B.5) on the card and on the CPU, with the same
    uniforms and W_r: payloads are exact, so θ, θ̂ and hat_mix agree to the
    float32 rounding of sums taken in another order (atol 1e-6)."""
    from repro_torch.comm import CompressedGossipMixer, CompressionConfig
    from repro_torch.dynamics import DropoutSchedule, DynamicGossipMixer
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    k = 10
    w = metropolis_weights(build_graph("erdos_renyi", k, p=0.3, seed=0))
    rng = np.random.default_rng(0)
    theta = {n: rng.standard_normal((k,) + sh).astype(np.float32)
             for n, sh in (("fc0/b", (128,)), ("fc0/w", (784, 128)), ("fc1/w", (5,)))}

    def noise(rounds, leaf_idx, *rest):
        shape = rest[-1]
        return np.random.default_rng([rounds, leaf_idx, *rest[:-1]]).random(
            shape, dtype=np.float32)

    ws = {r: DropoutSchedule(w, 0.2, seed=r, device="cpu").round_weights(r) for r in range(3)}

    class Replay(DropoutSchedule):
        def round_weights(self, rounds):
            return ws[rounds].to(self.device)

    ef = CompressionConfig(kind="int8", use_kernel=True)
    memoryless = CompressionConfig(kind="int8", use_kernel=True, error_feedback=False)
    stacks = {
        "static-ef": lambda dev: CompressedGossipMixer(permutation_decomposition(w), ef,
                                                       device=dev, uniforms=noise),
        "dropout-memoryless": lambda dev: DynamicGossipMixer(
            Replay(w, 0.2, device=dev), quantized=memoryless, uniforms=noise),
        "dropout-ef-b2": lambda dev: DynamicGossipMixer(
            Replay(w, 0.2, device=dev), quantized=ef, ef_rebase_every=2, uniforms=noise),
    }
    for name, build in stacks.items():
        out = {}
        for dev in ("cuda", "cpu"):
            m = build(dev)
            t = {n: torch.from_numpy(v).to(dev) for n, v in theta.items()}
            st = m.init_state(t)
            for _ in range(3):
                t, st = m(t, st)
            out[dev] = (t, st)
        (t_g, s_g), (t_c, s_c) = out["cuda"], out["cpu"]
        for n in theta:
            torch.testing.assert_close(t_g[n].cpu(), t_c[n], rtol=0, atol=1e-6, msg=name)
            if s_c.hat != ():
                torch.testing.assert_close(s_g.hat[n].cpu(), s_c.hat[n], rtol=0, atol=1e-6)
                torch.testing.assert_close(s_g.hat_mix[n].cpu(), s_c.hat_mix[n], rtol=0,
                                           atol=1e-6)
        assert float(s_g.wire_bits) == float(s_c.wire_bits)


# -- serving kernels: flash attention (B.6) and the WKV6 scan (B.7) ------------

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as wk  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402

SERVE_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_CASES = [  # b, h, kvh, s, t, hd, causal, window, softcap
    (2, 4, 2, 64, 64, 16, True, None, None),
    (2, 14, 2, 512, 512, 64, True, None, None),      # qwen2-0.5b prefill, B 2
    (1, 8, 2, 300, 300, 80, True, 64, None),         # h2o-danube's hd, ragged S
    (1, 8, 4, 200, 200, 128, True, 64, 50.0),        # gemma2's hd and softcap
    (1, 4, 4, 130, 130, 128, True, None, 50.0),      # G = 1
    (2, 6, 3, 97, 97, 64, False, None, None),        # non-causal, ragged
    (1, 4, 1, 33, 77, 16, False, 8, 20.0),           # S != T
    (2, 14, 2, 64, 64, 64, True, None, None),        # qwen2-0.5b training, B 2
    # the tiles' edges: 64 packed query rows and 32-key K/V tiles (forward,
    # dQ), 64-key tiles walking 32-row query tiles (dK/dV)
    (1, 2, 2, 63, 63, 64, True, None, None),
    (1, 2, 2, 65, 65, 64, True, None, None),
    (1, 4, 4, 31, 33, 128, False, None, None),
    (1, 4, 2, 33, 31, 128, True, None, None),
    (2, 14, 2, 50, 50, 64, True, None, None),        # G = 7, G S = 350 rows
    (1, 7, 1, 101, 101, 80, True, 32, None),         # G = 7, window
    (1, 7, 1, 65, 129, 64, False, None, None),       # G = 7, S != T
]


def _flash_inputs(b, h, kvh, s, t, hd, seed, device, strided):
    rng = np.random.default_rng(seed)
    if strided:  # the model's memory: (B, S, H, hd) viewed as (B, H, S, hd)
        q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
        k, v = (rng.standard_normal((b, t, kvh, hd)).astype(np.float32) for _ in range(2))
        return tuple(torch.from_numpy(x).to(device).permute(0, 2, 1, 3) for x in (q, k, v))
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
                 for shape in ((b, h, s, hd), (b, kvh, t, hd), (b, kvh, t, hd)))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("strided", [False, True])
def test_flash_attention_equals_plain(cuda, case, strided):
    b, h, kvh, s, t, hd, causal, window, softcap = case
    q, k, v = _flash_inputs(b, h, kvh, s, t, hd, sum(case[:6]), cuda, strided)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = fk.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.stride() == q.stride()
    torch.testing.assert_close(out, attention_ref(q, k, v, **kw), **SERVE_TOL)


def _wkv_inputs(b, h, t, hd, seed, device, decay="random"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32) for _ in range(3))
    if decay == "random":
        w = rng.uniform(0.0, 1.0, (b, t, h, hd)).astype(np.float32)
    elif decay == "1e-6":  # the state is forgotten at every step
        w = np.full((b, t, h, hd), 1e-6, np.float32)
    else:  # the model's init: exp(-exp(-6)) ~ 0.9975
        w = np.full((b, t, h, hd), np.exp(-np.exp(-6.0)), np.float32)
    u = (0.5 * rng.standard_normal((h, hd))).astype(np.float32)
    view = [torch.from_numpy(x).to(device).permute(0, 2, 1, 3) for x in (r, k, v, w)]
    return (*view, torch.from_numpy(u).to(device))


@pytest.mark.parametrize("b,h,t,hd", [(2, 8, 64, 16), (4, 64, 256, 64), (3, 5, 100, 64),
                                      (1, 2, 1, 16)])
@pytest.mark.parametrize("decay", ["random", "init"])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_equals_plain(cuda, b, h, t, hd, decay, with_state):
    r, k, v, w, u = _wkv_inputs(b, h, t, hd, b * h + t, cuda, decay)
    s0 = (torch.randn((b, h, hd, hd), device=cuda) if with_state else None)
    y, s = wk.wkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    y_p, s_p = wkv6_ref(r, k, v, w, u, s0)
    assert y.stride() == r.stride()
    for got, want in ((y, y_p), (s, s_p)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("b,h,t,hd", [(4, 64, 1, 64), (4, 256, 256, 16), (2, 8, 35, 64),
                                      (2, 8, 33, 16), (1, 3, 67, 64)])
@pytest.mark.parametrize("decay", ["random", "1e-6"])
def test_wkv6_new_cases_equal_plain(cuda, b, h, t, hd, decay):
    """The key-split kernel at one step with a given state, at hd 16 at the
    model's width, at T that leave single steps after the batches of four
    and a ragged chunk, and with w = 1e-6; the views staged by TMA."""
    r, k, v, w, u = _wkv_inputs(b, h, t, hd, 7 * b + t, cuda, decay)
    assert all(wk.rows_by_tma(x) for x in (r, k, v, w))
    s0 = torch.randn((b, h, hd, hd), device=cuda)
    for state in (None, s0):
        y, s = wk.wkv6_scan(r, k, v, w, u, state)
        torch.cuda.synchronize()
        y_p, s_p = wkv6_ref(r, k, v, w, u, state)
        for got, want in ((y, y_p), (s, s_p)):
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_takes_rows_off_16_byte_boundaries(cuda, hd):
    """Rows of H hd + 1 floats are not on 16 bytes: TMA does not take them
    and the kernel loads the chunks with plain loads, to the same answer."""
    b, h, t = 2, 8, 70
    gen = torch.Generator(device=cuda).manual_seed(hd)

    def view():
        flat = torch.randn((b, t, h * hd + 1), generator=gen, device=cuda)
        return flat[:, :, :h * hd].unflatten(2, (h, hd)).permute(0, 2, 1, 3)

    r, k, v, w = view(), view(), view(), view()
    w.uniform_(0.0, 1.0, generator=gen)
    u = 0.5 * torch.randn((h, hd), generator=gen, device=cuda)
    s0 = torch.randn((b, h, hd, hd), generator=gen, device=cuda)
    assert not any(wk.rows_by_tma(x) for x in (r, k, v, w))
    y, s = wk.wkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    y_p, s_p = wkv6_ref(r, k, v, w, u, s0)
    for got, want in ((y, y_p), (s, s_p)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("bad", ["bf16", "hd", "grad"])
def test_serving_kernels_reject_what_they_do_not_take(cuda, bad):
    q, k, v = _flash_inputs(1, 2, 1, 16, 16, 16, 0, cuda, False)
    r, kk, vv, w, u = _wkv_inputs(1, 2, 8, 16, 0, cuda)
    if bad == "bf16":
        q, r = q.bfloat16(), r.bfloat16()
    elif bad == "hd":
        q, k, v = _flash_inputs(1, 2, 1, 16, 16, 32, 0, cuda, False)
        r, kk, vv, w, u = (x[..., :8] for x in (r, kk, vv, w, u))
    else:
        q, r = q.requires_grad_(), r.requires_grad_()
    with pytest.raises((TypeError, ValueError)):
        fk.flash_attention_fwd(q, k, v)
    with pytest.raises((TypeError, ValueError)):
        wk.wkv6_scan(r, kk, vv, w, u.contiguous())


def test_serving_dispatchers_launch_for_cuda_tensors(cuda):
    q, k, v = _flash_inputs(1, 2, 1, 16, 16, 16, 0, cuda, False)
    xs = _wkv_inputs(1, 2, 8, 16, 0, cuda)
    plain = (fops.flash_attention.plain_calls, wops.wkv6.plain_calls)
    launches = (fk.flash_attention_fwd.launches, wk.wkv6_scan.launches)
    fops.flash_attention(q, k, v)
    wops.wkv6(*xs)
    assert (fops.flash_attention.plain_calls, wops.wkv6.plain_calls) == plain
    assert (fk.flash_attention_fwd.launches, wk.wkv6_scan.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "h2o_danube_1_8b", "gemma2_27b", "rwkv6_7b"])
def test_lm_prefill_on_the_card_matches_the_cpu(cuda, arch):
    model = TransformerLM(get_arch(arch, smoke=True))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 40)))
    with torch.inference_mode():
        want, want_pf = model.prefill(params, {"tokens": tokens})
        before = (fk.flash_attention_fwd.launches, wk.wkv6_scan.launches)
        got, got_pf = model.prefill({n: t.to(cuda) for n, t in params.items()},
                                    {"tokens": tokens.to(cuda)})
        torch.cuda.synchronize()
    kinds = [blk for blk, _ in model.cfg._full_pattern()]
    assert fk.flash_attention_fwd.launches - before[0] == sum(b != "rwkv" for b in kinds)
    assert wk.wkv6_scan.launches - before[1] == kinds.count("rwkv")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name, layer in got_pf[1].items():
        for leaf, t in layer.items():
            torch.testing.assert_close(t.cpu(), want_pf[1][name][leaf], rtol=1e-4, atol=1e-4)


# -- LM training: the gossip update (B.1) and B.6's backward ------------------

from repro_torch.core.drdsgd import replicate_params  # noqa: E402
from repro_torch.kernels.flash_attention.ref import MASKED  # noqa: E402
from repro_torch.kernels.gossip_update import kernel as gk  # noqa: E402
from repro_torch.kernels.gossip_update import ops as gops  # noqa: E402
from repro_torch.kernels.gossip_update import ref as gref  # noqa: E402
from repro_torch.models import make_lm_loss  # noqa: E402

BWD_REL = 1e-4     # B.6's backward against autograd of the plain version, relative to max
STACKED_REL = 1e-6  # B.1 stacked: an FMA chain against cuBLAS, relative to max |out|


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 3, 5])
@pytest.mark.parametrize("d", [7, 64, 128, 1000, 131072])
def test_gossip_update_equals_plain(cuda, d, n, dtype):
    rng = np.random.default_rng(d + n)
    theta, grad = (torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(cuda, dtype)
                   for _ in range(2))
    nbrs = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda, dtype)
    w = torch.softmax(torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)), 0).to(cuda)
    s = torch.tensor(1.7, device=cuda)
    before = gk.gossip_update.launches
    out = gops.gossip_update_flat(theta, grad, nbrs, w, s, eta=0.05)
    want = gref.gossip_update_ref(theta, grad, nbrs, w, s, eta=0.05)
    torch.cuda.synchronize()
    assert gk.gossip_update.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, want)  # the plain version's order, each op rounded once


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shape", [(8, (896,)), (8, (151936, 8)), (10, (784, 128)),
                                     (10, (10,)), (64, (4099,)), (1, (33,))])
def test_gossip_update_stacked_equals_plain(cuda, k, shape, dtype):
    from repro_torch.graphs import metropolis_weights, ring_graph

    rng = np.random.default_rng(k + sum(shape))
    theta, grad = (torch.from_numpy(rng.standard_normal((k, *shape)).astype(np.float32))
                   .to(cuda, dtype) for _ in range(2))
    w = torch.from_numpy(metropolis_weights(ring_graph(k)).astype(np.float32)
                         if k > 2 else np.full((k, k), 1.0 / k, np.float32)).to(cuda)
    s = torch.from_numpy(rng.uniform(0.1, 3.0, k).astype(np.float32)).to(cuda)
    before = gk.gossip_update_stacked.launches
    out = gops.gossip_update_stacked(theta, grad, w, s, eta=0.01)
    want = gref.gossip_update_stacked_ref(theta, grad, w, s, eta=0.01)
    torch.cuda.synchronize()
    assert gk.gossip_update_stacked.launches == before + 1
    assert out.shape == theta.shape and out.dtype == dtype
    # float32: the sum over j in another order than cuBLAS; bfloat16: and
    # the output rounded to 8 bits after it
    assert _rel(out, want) <= (STACKED_REL if dtype == torch.float32 else 1e-2)


def test_gossip_update_stacked_rejects_what_it_does_not_take(cuda):
    x = torch.ones((65, 4), device=cuda)
    with pytest.raises(ValueError, match="nodes"):
        gk.gossip_update_stacked(x, x, torch.eye(65, device=cuda), torch.ones(65, device=cuda),
                                 eta=0.1)
    y = torch.ones((4, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gossip_update_stacked(y, y.t().contiguous().t(), torch.eye(4, device=cuda),
                                 torch.ones(4, device=cuda), eta=0.1)
    with pytest.raises(TypeError):
        gk.gossip_update_stacked(y.double(), y.double(), torch.eye(4, device=cuda),
                                 torch.ones(4, device=cuda), eta=0.1)


def _plain_lse(q, k, v, causal, window, softcap):
    """The row log-sum-exp of the plain version's masked scores."""
    _, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kk) / hd ** 0.5
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    return torch.where(ok, scores, torch.full_like(scores, MASKED)).logsumexp(-1)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("strided", [False, True])
def test_flash_attention_bwd_equals_plain(cuda, case, strided):
    b, h, kvh, s, t, hd, causal, window, softcap = case
    q, k, v = _flash_inputs(b, h, kvh, s, t, hd, sum(case[:6]) + 1, cuda, strided)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(s), device=cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before = fk.flash_attention_bwd.launches
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fk.flash_attention_bwd.launches == before + 1
    assert dq.stride() == q.stride() and dk.shape == k.shape and dv.shape == v.shape
    torch.testing.assert_close(lse, _plain_lse(q, k, v, **kw), rtol=2e-5, atol=2e-5)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _rel(got, ref) <= BWD_REL, (name, _rel(got, ref))


def _misaligned(x):
    """x's values in memory one float past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, device=x.device)[1:]
    return flat.view(x.shape).copy_(x)


@pytest.mark.parametrize("case", [(1, 4, 2, 70, 70, 64, True, None, None),
                                  (1, 2, 1, 40, 40, 80, True, 16, 30.0)])
def test_flash_attention_takes_rows_off_16_byte_boundaries(cuda, case):
    """Rows that 16-byte copies cannot stage go through 4-byte ones."""
    b, h, kvh, s, t, hd, causal, window, softcap = case
    q, k, v = (_misaligned(x) for x in _flash_inputs(b, h, kvh, s, t, hd, 3, cuda, False))
    dout = _misaligned(torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(1),
                                   device=cuda))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    grads = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_ref(q, k, v, **kw), **SERVE_TOL)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, dout)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert _rel(got, ref) <= BWD_REL, (name, _rel(got, ref))


@pytest.mark.parametrize("case", [(2, 14, 2, 64, 64, 64, True, None, None),
                                  (2, 14, 2, 512, 512, 64, True, None, None),
                                  (1, 8, 4, 200, 200, 128, True, 64, 50.0)])
def test_flash_attention_bwd_repeats_bit_for_bit(cuda, case):
    """No float atomics: two backward calls give the same bits."""
    b, h, kvh, s, t, hd, causal, window, softcap = case
    q, k, v = _flash_inputs(b, h, kvh, s, t, hd, 11, cuda, True)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    first = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
def test_flash_attention_rows_go_by_tma_where_aligned(cuda, hd):
    """The model's strided views take TMA copies; rows off 16 bytes cp.async."""
    q, k, v = _flash_inputs(2, 14, 2, 64, 64, hd, 0, cuda, True)
    assert all(fk.rows_by_tma(x) for x in (q, k, v))
    assert not fk.rows_by_tma(_misaligned(k))


def test_flash_attention_function_launches_both_kernels(cuda):
    q, k, v = (x.requires_grad_() for x in _flash_inputs(1, 4, 2, 64, 64, 16, 5, cuda, True))
    launches = (fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches)
    out = fops.flash_attention(q, k, v, window=16)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, window=16).square().sum(), leaves)
    for got, ref in zip(grads, want):
        assert _rel(got, ref) <= BWD_REL


def test_rwkv_training_raises_on_the_card(cuda):
    r, k, v, w, u = _wkv_inputs(1, 2, 8, 16, 0, cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        wops.wkv6(r.requires_grad_(), k, v, w, u)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "h2o_danube_1_8b", "gemma2_27b"])
def test_lm_loss_and_grads_on_the_card_match_the_cpu(cuda, arch):
    """The node-stacked loss (K = 2) and every gradient leaf, card vs CPU."""
    model = TransformerLM(get_arch(arch, smoke=True))
    params = replicate_params(model.init(torch.Generator().manual_seed(0)), 2)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 2, 41)))
    loss_fn = make_lm_loss(model)
    out = {}
    for dev in ("cpu", cuda):
        leaves = {n: t.to(dev).requires_grad_() for n, t in params.items()}
        losses = loss_fn(leaves, (tokens.to(dev),))
        out[str(dev)] = losses, torch.autograd.grad(losses.sum(), list(leaves.values()))
    (l_c, g_c), (l_g, g_g) = out["cpu"], out["cuda"]
    torch.testing.assert_close(l_g.detach().cpu(), l_c.detach(), rtol=1e-5, atol=1e-5)
    for name, a, b in zip(params, g_g, g_c):
        assert _rel(a.cpu(), b) <= BWD_REL, (name, _rel(a.cpu(), b))


# -- the grouped masked wire: B.4 and B.5 over every leaf of a matching, one
# launch each (up to qk.MAX_GROUP_LEAVES leaves), bit-equal to the one-leaf
# plain versions; the fused step above 64 nodes ------------------------------

MLP_D = [128, 100352, 64, 8192, 10, 640]
CNN_D = [32, 864, 64, 18432, 64, 36864, 500, 512000, 500, 250000, 10, 5000]
GROUPS = {  # name -> (K, widths, block_d)
    "mlp": (10, MLP_D, 65536),
    "cnn": (10, CNN_D, 65536),
    "2 blocks": (10, [131072, 100352, 10], 65536),
    "block 128": (16, [4096, 1000, 128, 7], 128),
    "ragged": (3, [1000, 256, 3], 256),
    "over the cap": (10, MLP_D + CNN_D + [4096, 7], 65536),
}


def _group(k, dims, seed, device):
    xs, us = zip(*(_inputs(k, d, seed + i, device) for i, d in enumerate(dims)))
    return list(xs), list(us)


def test_grouped_kernels_are_built_as_stated(cuda):
    cfg = qk.config()
    assert cfg["cluster_size"] == qk.CLUSTER_SIZE
    assert cfg["max_group_leaves"] == qk.MAX_GROUP_LEAVES
    assert cfg["min_share"] == qk.MIN_SHARE
    assert cfg["acc_chunk"] == qk.ACC_CHUNK


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_grouped_quantize_equals_plain(cuda, group, mask):
    k, dims, block_d = GROUPS[group]
    xs, us = _group(k, dims, seed=7 * k, device=cuda)
    m = _mask(mask, k, cuda)
    launches = len(qk.leaf_tables([1] * len(dims)))
    for qmax in (127.0, 7.0):
        before = qk.masked_quantize_blockwise_grouped.launches
        got = qk.masked_quantize_blockwise_grouped(xs, us, m, qmax=qmax, block_d=block_d)
        want = ref.masked_quantize_blockwise_grouped_ref(xs, us, m, qmax=qmax, block_d=block_d)
        torch.cuda.synchronize()
        assert qk.masked_quantize_blockwise_grouped.launches == before + launches
        for i, ((q, s), (q_p, s_p)) in enumerate(zip(got, want)):
            assert torch.equal(q, q_p) and torch.equal(s, s_p), (i, qmax)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_grouped_accumulate_equals_plain_in_place(cuda, group, mask):
    k, dims, block_d = GROUPS[group]
    xs, us = _group(k, dims, seed=11 * k, device=cuda)
    payloads = [ref.quantize_blockwise_ref(x, u, block_d=block_d) for x, u in zip(xs, us)]
    gen = torch.Generator(device=cuda).manual_seed(k)
    w = torch.rand((k,), generator=gen, device=cuda) * 0.5
    w[0] = 0.0  # a row that receives nothing
    accs0 = [torch.randn((k, d), generator=gen, device=cuda) for d in dims]
    m = _mask(mask, k, cuda)
    srcs = _srcs(cuda) if k == 10 else [None, torch.tensor(
        [i ^ 1 if (i ^ 1) < k else i for i in range(k)], device=cuda)]
    for src in srcs:
        accs = [a.clone() for a in accs0]
        ptrs = [a.data_ptr() for a in accs]
        before = qk.masked_dequant_accumulate_grouped_.launches
        out = qk.masked_dequant_accumulate_grouped_(accs, payloads, w, m, src=src)
        want = ref.masked_dequant_accumulate_grouped_ref_([a.clone() for a in accs0], payloads,
                                                          w, m, src=src)
        torch.cuda.synchronize()
        assert qk.masked_dequant_accumulate_grouped_.launches == \
            before + len(qk.leaf_tables([1] * len(dims)))
        assert out is accs and [a.data_ptr() for a in out] == ptrs
        for a, b in zip(out, want):
            assert torch.equal(a, b), (group, mask, src)


@pytest.mark.parametrize("group", list(GROUPS))
def test_grouped_b3_accumulate_equals_plain_in_place(cuda, group):
    """B.3 over every leaf of a group (B.5's kernel with no mask), in place,
    bit for bit against the one-leaf plain versions, every src; the one-leaf
    B.3 (a one-leaf group on a copy) likewise."""
    k, dims, block_d = GROUPS[group]
    xs, us = _group(k, dims, seed=13 * k, device=cuda)
    payloads = [ref.quantize_blockwise_ref(x, u, block_d=block_d) for x, u in zip(xs, us)]
    gen = torch.Generator(device=cuda).manual_seed(k + 3)
    w = torch.rand((k,), generator=gen, device=cuda) * 0.5
    w[0] = 0.0  # a row that receives nothing
    accs0 = [torch.randn((k, d), generator=gen, device=cuda) for d in dims]
    srcs = _srcs(cuda) if k == 10 else [None, torch.tensor(
        [i ^ 1 if (i ^ 1) < k else i for i in range(k)], device=cuda)]
    for src in srcs:
        accs = [a.clone() for a in accs0]
        ptrs = [a.data_ptr() for a in accs]
        before = qk.dequant_accumulate_grouped_.launches
        out = qk.dequant_accumulate_grouped_(accs, payloads, w, src=src)
        one = [qk.dequant_accumulate(a, q, sc, w, src=src) for a, (q, sc) in zip(accs0, payloads)]
        want = [ref.dequant_accumulate_ref(a, q, sc, w, src=src)
                for a, (q, sc) in zip(accs0, payloads)]
        torch.cuda.synchronize()
        assert qk.dequant_accumulate_grouped_.launches == \
            before + len(qk.leaf_tables([1] * len(dims)))
        assert out is accs and [a.data_ptr() for a in out] == ptrs
        for a, o, b in zip(out, one, want):
            assert torch.equal(a, b) and torch.equal(o, b), (group, src)


def test_grouped_b3_static_round_on_the_card_equals_the_per_leaf_round(cuda):
    """Two rounds of the static int8 EF gossip wire through the grouped B.3
    (one launch per matching) and with the quantizer's grouped call hidden
    (the one-leaf B.3 per leaf and matching): θ, θ̂ and the mix cache bit
    for bit."""
    from repro_torch.comm import CompressedGossipMixer, CompressionConfig
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    decomp = permutation_decomposition(
        metropolis_weights(build_graph("erdos_renyi", 10, p=0.3, seed=0)))
    cfg = CompressionConfig(kind="int8", use_kernel=True)
    grouped = CompressedGossipMixer(decomp, cfg, device=cuda)
    per_leaf = CompressedGossipMixer(decomp, cfg, device=cuda)

    class PerLeaf:  # the kernel quantizer without its grouped accumulate
        def __init__(self, quantizer):
            self.quantizer = quantizer

        def __getattr__(self, name):
            if name == "accumulate_grouped_":
                raise AttributeError(name)
            return getattr(self.quantizer, name)

    per_leaf.compressor = PerLeaf(per_leaf.compressor)
    xs, _ = _group(10, MLP_D, seed=6, device=cuda)
    theta = dict(zip(["fc0/b", "fc0/w", "fc1/b", "fc1/w", "fc2/b", "fc2/w"], xs))
    (ta, sa), (tb, sb) = (theta, grouped.init_state(theta)), (theta, per_leaf.init_state(theta))
    n_match = len(decomp.matchings)
    for _ in range(2):
        g0, o0 = qk.dequant_accumulate_grouped_.launches, qk.dequant_accumulate.launches
        ta, sa = grouped(ta, sa)
        assert qk.dequant_accumulate_grouped_.launches == g0 + n_match
        tb, sb = per_leaf(tb, sb)
        assert qk.dequant_accumulate.launches == o0 + n_match * len(theta)
        torch.cuda.synchronize()
        for n in theta:
            assert torch.equal(ta[n], tb[n]) and torch.equal(sa.hat[n], sb.hat[n])
            assert torch.equal(sa.hat_mix[n], sb.hat_mix[n])


def test_grouped_kernels_take_rows_off_16_byte_boundaries(cuda):
    """Leaves whose data do not start on 16 bytes take the scalar paths."""
    k, dims = 4, [1024, 640]
    xs0, us0 = _group(k, dims, seed=5, device=cuda)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    xs, us = [shifted(x) for x in xs0], [shifted(u) for u in us0]
    m = _mask("mixed", k, cuda)
    got = qk.masked_quantize_blockwise_grouped(xs, us, m, block_d=256)
    want = ref.masked_quantize_blockwise_grouped_ref(xs0, us0, m, block_d=256)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(got, want))
    w = torch.full((k,), 0.25, device=cuda)
    accs = [shifted(torch.randn((k, d), device=cuda)) for d in dims]
    want = ref.masked_dequant_accumulate_grouped_ref_([a.clone() for a in accs], got, w, m)
    qk.masked_dequant_accumulate_grouped_(accs, got, w, m)
    assert all(torch.equal(a, b) for a, b in zip(accs, want))


@pytest.mark.parametrize("bad", ["float64", "strided", "k", "cpu-mask", "u-count", "empty"])
def test_grouped_wrappers_reject_what_the_kernels_do_not_take(cuda, bad):
    xs, us = _group(4, [256, 64], seed=2, device=cuda)
    m = _mask("mixed", 4, cuda)
    if bad == "float64":
        xs[1] = xs[1].double()
    elif bad == "strided":
        xs[0] = xs[0].t().contiguous().t()
    elif bad == "k":
        xs[1], us[1] = xs[1][:3], us[1][:3]
    elif bad == "cpu-mask":
        m = m.cpu()
    elif bad == "u-count":
        us = us[:1]
    else:
        xs, us = [], []
    launches = qk.masked_quantize_blockwise_grouped.launches
    with pytest.raises((TypeError, ValueError)):
        qk.masked_quantize_blockwise_grouped(xs, us, m, block_d=64)
    assert qk.masked_quantize_blockwise_grouped.launches == launches
    if bad in ("float64", "strided", "k"):
        payloads = [ref.quantize_blockwise_ref(x.float().contiguous(), u, block_d=64)
                    for x, u in zip(xs, us)]
        w = torch.ones(4, device=cuda)
        launches = qk.masked_dequant_accumulate_grouped_.launches
        with pytest.raises((TypeError, ValueError)):
            qk.masked_dequant_accumulate_grouped_(xs, payloads, w, m)
        assert qk.masked_dequant_accumulate_grouped_.launches == launches


def test_grouped_dispatchers_launch_for_cuda_tensors(cuda):
    xs, us = _group(10, MLP_D, seed=3, device=cuda)
    m = _mask("mixed", 10, cuda)
    w = torch.full((10,), 0.5, device=cuda)
    names = ("masked_quantize_blockwise_grouped", "masked_dequant_accumulate_grouped_")
    before = {n: (getattr(qk, n).launches, getattr(ops, n).plain_calls) for n in names}
    payloads = ops.masked_quantize_blockwise_grouped(xs, us, m)
    ops.masked_dequant_accumulate_grouped_([x.clone() for x in xs], payloads, w, m)
    for n in names:
        assert getattr(qk, n).launches == before[n][0] + 1
        assert getattr(ops, n).plain_calls == before[n][1]


def test_grouped_memoryless_round_on_the_card_equals_the_one_leaf_round(cuda):
    """The dropout-0.2 memoryless round through the grouped kernels (one B.4
    and one B.5 launch per matching) equals the same round leaf by leaf
    through ``masked_quant_gossip_round`` (one-leaf kernels), bit for bit."""
    from repro_torch.comm import CompressionConfig
    from repro_torch.comm.topology import gather_round_vectors
    from repro_torch.dynamics import DropoutSchedule, DynamicGossipMixer
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.utils.tree import leaf_names

    w = metropolis_weights(build_graph("erdos_renyi", 10, p=0.3, seed=0))
    mixer = DynamicGossipMixer(DropoutSchedule(w, 0.2, seed=0, device=cuda),
                               quantized=CompressionConfig(kind="int8", use_kernel=True,
                                                           error_feedback=False))
    xs, _ = _group(10, MLP_D, seed=4, device=cuda)
    theta = dict(zip(["fc0/b", "fc0/w", "fc1/b", "fc1/w", "fc2/b", "fc2/w"], xs))
    state = mixer.init_state(theta)
    self_w, match_ws, masks = gather_round_vectors(mixer.topo.round_w(0),
                                                   mixer.transport.perm_idx)
    before = (qk.masked_quantize_blockwise_grouped.launches,
              qk.masked_dequant_accumulate_grouped_.launches)
    got = mixer._quantized_gossip(theta, state, self_w, match_ws, masks)
    n_match = len(mixer.transport.srcs)
    assert (qk.masked_quantize_blockwise_grouped.launches,
            qk.masked_dequant_accumulate_grouped_.launches) == \
        (before[0] + n_match, before[1] + n_match)
    wire = mixer.wire
    for i, name in enumerate(leaf_names(theta)):
        acc = theta[name] * self_w[:, None]
        for j, (pw, mk, src) in enumerate(zip(match_ws, masks, mixer.transport.srcs)):
            u = wire.uniforms(state.key, state.rounds, i, j, theta[name])
            acc = ops.masked_quant_gossip_round(theta[name], acc, pw, mk, src, u)
        assert torch.equal(got[name], acc), name


def test_fused_step_at_65_nodes_equals_the_unfused_step(cuda):
    """K = 65 is above the stacked B.1 kernel's 64 nodes: the SGD step on
    the card takes the unfused path (no B.1 launch) and equals the unfused
    step; both stay within 1.5e-4 of the largest update of the CPU's."""
    from repro_torch.core import DecentralizedTrainer, RobustConfig
    from repro_torch.data import make_fmnist_like, pathological_noniid_partition
    from repro_torch.models import paper_nets as nets
    from repro_torch.optim import Optimizer, sgd

    k = 65
    fed = pathological_noniid_partition(make_fmnist_like(n_train=6500, n_test=200), k, seed=0)
    batch = fed.sample_batch(np.random.default_rng(0), 55)
    params = nets.mlp_init(torch.Generator().manual_seed(0))
    opt = sgd((10 / 300) ** 0.5)
    out = {}
    for tag, dev, o in (("fused", cuda, opt), ("unfused", cuda, Optimizer(opt.init, opt.update)),
                        ("cpu", "cpu", opt)):
        trainer = DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                       num_nodes=k, graph="erdos_renyi",
                                       graph_kwargs={"p": 0.3, "seed": 0},
                                       robust=RobustConfig(mu=6.0), optimizer=o, device=dev)
        state = trainer.init(params)
        before = (gk.gossip_update_stacked.launches, gk.gossip_update_stacked_grouped.launches)
        state, _ = trainer.step(state, batch)
        assert (gk.gossip_update_stacked.launches,
                gk.gossip_update_stacked_grouped.launches) == before
        out[tag] = {n: v.cpu() for n, v in state.params.items()}
    start = {n: v.unsqueeze(0).expand(out["cpu"][n].shape) for n, v in params.items()}
    largest = max(float((out["cpu"][n] - start[n]).abs().max()) for n in params)
    for n in params:
        assert torch.equal(out["fused"][n], out["unfused"][n]), n
        assert float((out["fused"][n] - out["cpu"][n]).abs().max()) <= 1.5e-4 * largest, n


# -- B.2 grouped: B.4's kernel with no mask, one launch over every leaf ---------

B2_GROUPS = {**GROUPS, "kv block 128": (32, [128 * 64, 128, 384], 128)}


@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("group", list(B2_GROUPS))
def test_grouped_b2_equals_one_leaf_plain(cuda, group, qmax):
    k, dims, block_d = B2_GROUPS[group]
    xs, us = _group(k, dims, seed=11 * k, device=cuda)
    launches = len(qk.leaf_tables([1] * len(dims)))
    before = qk.quantize_blockwise_grouped.launches
    got = qk.quantize_blockwise_grouped(xs, us, qmax=qmax, block_d=block_d)
    torch.cuda.synchronize()
    assert qk.quantize_blockwise_grouped.launches == before + launches
    for i, (x, u, (q, s)) in enumerate(zip(xs, us, got)):
        q_p, s_p = ref.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
        assert torch.equal(q, q_p) and torch.equal(s, s_p), i


def test_grouped_b2_takes_rows_off_16_byte_boundaries(cuda):
    k, dims = 4, [1024, 640, 10]
    xs0, us0 = _group(k, dims, seed=6, device=cuda)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)

    got = qk.quantize_blockwise_grouped([shifted(x) for x in xs0], [shifted(u) for u in us0],
                                        block_d=256)
    want = ref.quantize_blockwise_grouped_ref(xs0, us0, block_d=256)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(got, want))


def test_grouped_b2_dispatcher_launches_and_rejects(cuda):
    xs, us = _group(10, MLP_D, seed=4, device=cuda)
    before = (qk.quantize_blockwise_grouped.launches, ops.quantize_blockwise_grouped.plain_calls)
    ops.quantize_blockwise_grouped(xs, us)
    assert (qk.quantize_blockwise_grouped.launches,
            ops.quantize_blockwise_grouped.plain_calls) == (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="one K"):
        qk.quantize_blockwise_grouped([xs[0], xs[1][:3]], [us[0], us[1][:3]])
    with pytest.raises(TypeError):
        qk.quantize_blockwise_grouped([xs[0].double()], [us[0]])
    assert qk.quantize_blockwise_grouped.launches == before[0] + 1


# -- B.1 stacked, grouped: one launch over every leaf of a step ----------------

STACKED_DIMS = [1, 10, 255, 257, 100352]


def _stacked_group(k, dims, seed, dtype, device):
    from repro_torch.graphs import metropolis_weights, ring_graph

    rng = np.random.default_rng(seed)
    thetas, grads = ([torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
                      .to(device, dtype) for d in dims] for _ in range(2))
    w = torch.from_numpy(metropolis_weights(ring_graph(k)).astype(np.float32)
                         if k > 2 else np.full((k, k), 1.0 / k, np.float32)).to(device)
    s = torch.from_numpy(rng.uniform(0.1, 3.0, k).astype(np.float32)).to(device)
    return thetas, grads, w, s


def test_grouped_stacked_kernel_is_built_as_stated(cuda):
    assert gk.config() == dict(max_group_leaves=gk.MAX_GROUP_LEAVES, max_nodes=gk.MAX_NODES,
                               stacked_cols=gk.STACKED_COLS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 10, 16, 33, 64])
def test_grouped_stacked_equals_one_leaf_kernel_and_plain(cuda, k, dtype):
    """Every leaf in one launch: each output equals the one-leaf kernel's
    bit for bit (the same FMA chain per row) and the plain version within
    STACKED_REL (float32; 1e-2 in bfloat16)."""
    thetas, grads, w, s = _stacked_group(k, STACKED_DIMS, k, dtype, cuda)
    before = (gk.gossip_update_stacked_grouped.launches, gk.gossip_update_stacked.launches)
    got = gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.01)
    torch.cuda.synchronize()
    assert gk.gossip_update_stacked_grouped.launches == before[0] + 1
    for theta, grad, out in zip(thetas, grads, got):
        one = gk.gossip_update_stacked(theta, grad, w, s, eta=0.01)
        want = gref.gossip_update_stacked_ref(theta, grad, w, s, eta=0.01)
        assert out.shape == theta.shape and out.dtype == dtype
        assert torch.equal(out, one)
        assert _rel(out, want) <= (STACKED_REL if dtype == torch.float32 else 1e-2)
    assert gk.gossip_update_stacked.launches == before[1] + len(STACKED_DIMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_stacked_over_the_cap_and_off_alignment(cuda, dtype):
    """20 leaves (2 launches), some of them views that do not start on the
    vector width (the one-column path): each equals the one-leaf kernel on
    a contiguous copy, bit for bit."""
    k = 10
    dims = [100352, 128, 8192, 64, 640, 10] * 3 + [7, 4096]
    thetas, grads, w, s = _stacked_group(k, dims, 3, dtype, cuda)

    def shifted(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    thetas[1], grads[4] = shifted(thetas[1]), shifted(grads[4])
    before = gk.gossip_update_stacked_grouped.launches
    got = gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.2)
    assert gk.gossip_update_stacked_grouped.launches == before + 2
    for theta, grad, out in zip(thetas, grads, got):
        one = gk.gossip_update_stacked(theta.clone(), grad.clone(), w, s, eta=0.2)
        assert torch.equal(out, one)


def test_grouped_stacked_rejects_what_it_does_not_take(cuda):
    thetas, grads, w, s = _stacked_group(4, [8, 16], 1, torch.float32, cuda)
    before = gk.gossip_update_stacked_grouped.launches
    with pytest.raises(TypeError, match="one dtype"):
        gk.gossip_update_stacked_grouped([thetas[0], thetas[1].bfloat16()],
                                         [grads[0], grads[1].bfloat16()], w, s, eta=0.1)
    with pytest.raises(ValueError, match="one K"):
        gk.gossip_update_stacked_grouped([thetas[0], thetas[1][:3]], [grads[0], grads[1][:3]],
                                         w, s, eta=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gossip_update_stacked_grouped([thetas[0].t().contiguous().t()], [grads[0]], w, s,
                                         eta=0.1)
    assert gk.gossip_update_stacked_grouped.launches == before


def test_grouped_stacked_dispatcher_launches_for_cuda_tensors(cuda):
    thetas, grads, w, s = _stacked_group(10, [784 * 128, 128], 2, torch.float32, cuda)
    before = (gk.gossip_update_stacked_grouped.launches,
              gops.gossip_update_stacked_grouped.plain_calls)
    gops.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.1)
    assert (gk.gossip_update_stacked_grouped.launches,
            gops.gossip_update_stacked_grouped.plain_calls) == (before[0] + 1, before[1])


# -- B.2 and B.4 with qmax on the card (a compression schedule's rate) ---------

TENSOR_QMAX = [127.0, 7.0, 42.5]


@pytest.mark.parametrize("group", ["mlp", "cnn", "block 128"])
@pytest.mark.parametrize("mask", [None, "mixed"], ids=["b2", "b4-mixed"])
def test_tensor_qmax_equals_float_qmax(cuda, group, mask):
    """B.2 (no mask) and B.4 (a mixed mask) grouped, qmax as a 0-d float32
    tensor on the card at 127, 7 and the fractional 42.5: the payload and
    scales are the float form's and the plain version's bit for bit, in one
    launch per MAX_GROUP_LEAVES leaves."""
    k, dims, block_d = GROUPS[group]
    xs, us = _group(k, dims, seed=5 * k, device=cuda)
    m = None if mask is None else _mask(mask, k, cuda)
    fn = qk.quantize_blockwise_grouped if m is None else qk.masked_quantize_blockwise_grouped
    args = (xs, us) if m is None else (xs, us, m)
    plain = ref.quantize_blockwise_grouped_ref if m is None \
        else ref.masked_quantize_blockwise_grouped_ref
    launches = len(qk.leaf_tables([1] * len(dims)))
    for qmax in TENSOR_QMAX:
        q_t = torch.tensor(qmax, dtype=torch.float32, device=cuda)
        before = fn.launches
        got = fn(*args, qmax=q_t, block_d=block_d)
        torch.cuda.synchronize()
        assert fn.launches == before + launches
        want = fn(*args, qmax=qmax, block_d=block_d)
        plain_out = plain(*args, qmax=q_t, block_d=block_d)
        for i, ((q, s), (q_f, s_f), (q_p, s_p)) in enumerate(zip(got, want, plain_out)):
            assert torch.equal(q, q_f) and torch.equal(s, s_f), (group, qmax, i)
            assert torch.equal(q, q_p) and torch.equal(s, s_p), (group, qmax, i)


def test_tensor_qmax_is_never_read_on_the_host(cuda):
    """With CUDA's sync debug mode set to error, a grouped B.2 and B.4 call
    with a tensor qmax (and the one-leaf call) makes no device-to-host copy
    and no synchronisation; a tensor on another device or of another dtype
    is refused before any launch."""
    k, dims, block_d = GROUPS["mlp"]
    xs, us = _group(k, dims, seed=3, device=cuda)
    m = _mask("mixed", k, cuda)
    q_t = torch.tensor(7.0, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        qk.quantize_blockwise_grouped(xs, us, qmax=q_t, block_d=block_d)
        qk.masked_quantize_blockwise_grouped(xs, us, m, qmax=q_t, block_d=block_d)
        ops.quantize_blockwise(xs[0], us[0], qmax=q_t, block_d=block_d)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    launched = qk.quantize_blockwise_grouped.launches
    for bad in (torch.tensor(7.0), torch.tensor(7.0, dtype=torch.float64, device=cuda),
                torch.tensor([7.0], device=cuda)):
        with pytest.raises((ValueError, TypeError)):
            qk.quantize_blockwise_grouped(xs, us, qmax=bad, block_d=block_d)
    assert qk.quantize_blockwise_grouped.launches == launched


def test_scheduled_rounds_on_the_card_make_no_host_sync(cuda):
    """Dense int8-kernel rounds under the adaptive and the linear schedule
    (the rate, B.2 with the rate as qmax, the wire bits), past the warmup,
    run under sync debug mode "error": no device-to-host copy and no
    synchronisation.  The wire's own noise is drawn on the card (a test's
    numpy uniforms would be a host-to-device copy)."""
    from repro_torch.comm import CompressionConfig, ScheduleConfig
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.graphs import build_graph, metropolis_weights

    w = metropolis_weights(build_graph("ring", 10))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for kind in ("adaptive", "linear"):
        cfg = CompressionConfig(kind="int8", use_kernel=True, schedule=ScheduleConfig(
            kind=kind, warmup_rounds=1, threshold=0.9, anneal_rounds=3))
        mixer = make_dense_mixer(w, compression=cfg, device=cuda)
        theta = {"a": torch.randn((10, 3136), generator=gen, device=cuda),
                 "b": torch.randn((10, 10), generator=gen, device=cuda)}
        state = mixer.init_state(theta)
        before = qk.quantize_blockwise_grouped.launches
        for r in range(5):
            torch.cuda.synchronize()
            if r >= 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                theta, state = mixer(theta, state)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert qk.quantize_blockwise_grouped.launches == before + 5
        assert all(bool(torch.isfinite(t).all()) for t in theta.values())
        if kind == "linear":  # annealed to qmax 7: 4 bits per entry
            assert float(state.wire_bits) == 10 * (4 * 3146 + 2 * 32)
