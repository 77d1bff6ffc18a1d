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
layout; the WKV6 scan (B.7) at hd 16 and 64, ragged T, from a zero and a
given state, y and the final state, at rtol 2e-5 and an atol of 2e-5 times
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
        launches = qk.quantize_blockwise.launches
        t2, st = m(t, m.init_state(t))
        assert qk.quantize_blockwise.launches == launches + (3 if dev == "cuda" else 0)
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
