"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the paper's DR-DSGD trainer (Algorithm 2)
over the dense lowering, and over the gossip lowering on a static and a
time-varying topology, decentralized LM training, and static-batch LM
serving (prefill, then greedy decode) — on the card through their user
entry points, and holds every CUDA kernel of those paths against its plain
PyTorch version:

  build    nvcc-compiles every kernel source under src/ (one nvcc per
           source, all six started together), and proves from cuobjdump's
           SASS that each of B.6's product kernels, at every head dim, runs
           TF32 tensor-core instructions (HMMA/HGMMA .TF32).
  kernel   the four quant_gossip kernels against their plain versions at
           every leaf shape of the paper's MLP and CNN with K = 10 and at
           three multi-block layouts: quantize_blockwise (B.2) at qmax 127
           and 7, masked_quantize_blockwise (B.4) with masks all ones, all
           zeros and mixed, dequant_accumulate (B.3) and
           masked_dequant_accumulate (B.5, every mask pattern) with src None
           and each matching of the fmnist graph.  Payloads and
           accumulations must be equal bit for bit.  Times a call of each
           (CUDA events), its kernels' device time (profiler), the plain
           version, and the memory bound.
  b1-kernel  the gossip update (B.1) against its plain version: the
           per-node form on the reference's test cases (d 7 .. 131072, 0-5
           neighbours, float32 and bfloat16) bit for bit, the node-stacked
           form at every fmnist leaf (K = 10) and every qwen2-0.5b leaf
           (K = 8) within STACKED_REL of max |out|; times one call per leaf.
  fmnist   TrainerSpec -> DecentralizedTrainer at the paper's configuration
           (K = 10, ER(p = 0.3) seed 0, Metropolis W, mu = 6, T = 300,
           lr = sqrt(K/T), B = 55, MLP 784-128-64-10): DR-DSGD with the
           uncompressed dense wire (SGD and the static W fused into B.1:
           300 x 6 launches), then with the int8 error-feedback wire served
           by the CUDA quantizer (300 x 6 launches); no plain version
           called.
  b1-nodes one fmnist dense step recomputed node by node through
           gossip_update_tree (B.1's per-node form, 10 x 6 launches) and
           held against the fused step.
  gossip   the same configuration over the gossip lowering (a pre-built
           mixer handed to TrainerSpec.build, as the reference's benchmarks
           do), 300 steps on each of four stacks: uncompressed static gossip
           (params within 1e-5 of the dense run's after 20 steps, 1e-3 after
           300: the two sum in another order), the static int8 EF
           wire (B.2 + B.3), and dropout p = 0.2 with the memoryless masked
           int8 wire (B.4 + B.5) and the EF wire re-based every 4 rounds
           (B.4 + B.5); every count of launches is checked.  Then the CNN
           (cifar_default, clipped at norm 2) on the static int8 EF gossip
           wire for 20 steps, so B.3 runs on 512,000-wide rows.
  profile  30 fmnist steps of four stacks under torch.profiler: the
           device's busy share and the kernels that take its time.
  cifar    the CNN (K = 10, p = 0.5, gradients clipped at norm 2 as in the
           repo's CIFAR benchmark), dense int8-kernel wire, 50 steps; losses
           finite, launches must be 50 x 12 leaves.
  parity   20 uncompressed dense fmnist steps on the card vs the port on the
           CPU, and 20 steps of the dense int8-kernel wire and of the three
           compressed gossip stacks vs the CPU's plain versions with the
           same uniforms and W_r, at the printed tolerances.
  bwd-kernel  B.6's backward against autograd of the plain version at
           qwen2-0.5b's training shapes (B 2, H 14/2, hd 64, S = T = 64 and
           512) and at the serving shapes below, dq, dk and dv within
           BWD_REL of their largest |value|; times as below, with SDPA's
           backward as the yardstick (never on the path): its backend
           pinned (sdpa_yardstick), timed as a call and as device time.
  train-lm qwen2-0.5b at full width and depth through the training CLI
           (train_lm's defaults: K = 8 ring, batch 2, seq 64, lr 0.01, clip
           1), 20 steps: B.6 forward and backward 24 x 8 per step, B.1 once
           per leaf, no plain call; every metric finite, the first batch's
           loss lower after the run, ms per step, tokens per second, peak
           memory, one profiled step (with B.6's device time in it).  Then
           seq 512 at K = 4, 5 steps (multi-tile B.6 backward).
  train-parity  qwen2-0.5b cut to 2 layers at full width, K = 4, 3 steps:
           the same weights and tokens on the card and on the CPU, losses
           and every leaf within TRAIN_PARITY_REL, updates within
           UPDATE_REL; one fused step (B.1) against the unfused step from
           the same state on the card.
  serve-kernel  flash attention (B.6) at qwen2-0.5b's prefill and training
           shapes, at hd 80 and 128 with windows 4096 and 64 and gemma2's
           softcap 50, at G = 1 and at a ragged S = 300; the WKV6 scan (B.7)
           at rwkv6-7b's shapes and at T = 100 with random u and decays, y
           and the final state; both against their plain versions at rtol
           2e-5 (B.7's atol scaled by max |y|, see SERVE_TOL).  Times each
           call (CUDA events), its device time (profiler), the plain
           version, the bound (B.6: its products on the tensor cores as
           3xTF32, and on the CUDA cores beside it), and for B.6
           scaled_dot_product_attention with its backend pinned, timed as a
           call and as device time (never on the path).
  serve    qwen2-0.5b at full width and depth (24 layers, ~494 M
           parameters), then rwkv6-7b at full width and depth (32 layers,
           ~7.5 B parameters), seeded weights on the card, batch 4: the
           main path timed_generate (prefill, then greedy decode; 24 B.6 /
           32 B.7 launches per prefill, no plain call), held against the
           decode-only path (use_prefill=False: every prompt token through
           decode_step, no kernel).  qwen2: last-position logits and every
           cache leaf within SERVE_REL of their largest value, and generated
           tokens equal up to the first step whose top-2 logit gap is inside
           that tolerance.  rwkv6 (random weights amplify float32 rounding
           with depth, see phase_serve): every layer's prefill output and
           final state against its decode steps on the same input, within
           SERVE_REL; the end-to-end gaps are printed.  A profiler pass over
           one qwen2 prefill and 16 decode steps.
  serve-parity  both models cut to 2 layers at full width: the same seeded
           weights on the card (kernels) and on the CPU (plain versions);
           prefill logits, caches and 8 greedy tokens at SERVE_PARITY_REL.

TF32 is off for matmul and cuDNN throughout, so float32 means float32.
Weights come from the port's own seeded init, written to and read back
from a .npz.  Any failed phase raises (non-zero exit, no result line).
The build starts at most one nvcc per source; the script starts no other
process but nvidia-smi.  The last stdout line is the device record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it is the card's name and power limit from nvidia-smi, and the
line before that the kernels record.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense
K = 10
CIFAR_STEPS = 50
CIFAR_GOSSIP_STEPS = 20
CIFAR_GRAD_CLIP = 2.0      # the repo's CIFAR benchmark setting (see phase_cifar)
SERVE_BATCH = 4
SERVE_PARITY_GEN = 8
DROP_P = 0.2               # fig9's dropout rate
REBASE_EVERY = 4           # the EF gossip wire's re-base period B
PROFILE_STEPS = 30
PARITY_STEPS = 20
PARITY_PARAM_ATOL = 1e-5   # uncompressed: cuBLAS vs CPU summation order only
PARITY_METRIC_RTOL = 1e-4
PARITY_INT8_STEPS = 4.0    # int8: a floor that an ulp of theta - theta_hat flips
                           # moves theta-hat by one quantization step
GOSSIP_DENSE_ATOL = 1e-5   # static gossip vs the dense W product: 20 steps,
GOSSIP_DENSE_DRIFT = 1e-3  # and 300 steps, where float32 order drift reaches
                           # ~1.7e-4 on an H100
SERVE_REL = 1e-3          # prefill vs decode-only on the card, relative to max |x|
SERVE_PARITY_REL = 1e-4   # card vs CPU, 2 layers, relative to max |x|
SERVE_TOL = 2e-5          # B.6 / B.7 vs plain: rtol, and atol (B.7: times max |y|)
SRC = "src/repro_torch/kernels/"
TPU = "src/repro/kernels/"
# kernel -> (source, the TPU kernel's pallas_call, the CUDA kernels' names)
KERNELS = {
    "quantize_blockwise": (SRC + "quant_gossip/csrc/quantize.cu",
                           TPU + "quant_gossip/kernel.py:98", ("absmax_kernel", "quantize_kernel")),
    "dequant_accumulate": (SRC + "quant_gossip/csrc/accumulate.cu",
                           TPU + "quant_gossip/kernel.py:125", ("dequant_acc_kernel",)),
    "masked_quantize_blockwise": (SRC + "quant_gossip/csrc/quantize.cu",
                                  TPU + "quant_gossip/kernel.py:154",
                                  ("absmax_kernel", "quantize_kernel")),
    "masked_dequant_accumulate": (SRC + "quant_gossip/csrc/accumulate.cu",
                                  TPU + "quant_gossip/kernel.py:187", ("dequant_acc_kernel",)),
    "flash_attention_fwd": (SRC + "flash_attention/csrc/flash_fwd.cu",
                            TPU + "flash_attention/kernel.py:100", ("flash_fwd_mma_kernel",)),
    "wkv6_scan": (SRC + "rwkv6_scan/csrc/wkv6.cu", TPU + "rwkv6_scan/kernel.py:65",
                  ("wkv6_kernel",)),
    "gossip_update": (SRC + "gossip_update/csrc/gossip_update.cu",
                      TPU + "gossip_update/kernel.py:54", ("gossip_update_kernel",)),
    "gossip_update_stacked": (SRC + "gossip_update/csrc/gossip_update.cu",
                              TPU + "gossip_update/kernel.py:54",
                              ("gossip_update_stacked_kernel",)),
    # the backward of B.6: the reference differentiates its XLA attention
    "flash_attention_bwd": (SRC + "flash_attention/csrc/flash_bwd.cu",
                            TPU + "flash_attention/kernel.py:100",
                            ("bwd_mma_kernel", "bwd_reduce_kernel")),
}
QUANT = tuple(KERNELS)[:4]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one ``fn()`` over ``iters`` back-to-back calls, between
    two CUDA events: where launching costs the host more than the device
    takes to run, this is the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler after one warm-up
    call.  Returns (wall seconds, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def device_events(averages, *names: str) -> list:
    """The device-side entries (kernels, copies, fills) of the profiler's
    key averages whose name holds one of ``names`` (all when none given)."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type == DeviceType.CUDA
            and (not names or any(n in e.key for n in names))]


def device_us_per_call(averages, names) -> float:
    """Device time (us) of one call that launches each kernel of ``names``
    once: per name, its total over the launches the profiler recorded."""
    total = 0.0
    for name in names:
        events = device_events(averages, name)
        launches = sum(e.count for e in events)
        if not launches:
            raise AssertionError(f"the profiler recorded no launch of {name}")
        total += sum(e.self_device_time_total for e in events) / launches
    return total


def launch_us(prof, name: str) -> list[float]:
    """The device time (us) of each launch of the kernels whose name holds
    ``name`` in a profile, in launch order."""
    from torch.autograd import DeviceType

    return [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.name]


def device_ms(fn, iters: int, names, tries: int = 3) -> float:
    """Device time (ms) of one ``fn()`` that launches each kernel of
    ``names`` once, under the profiler.  The profiler now and then records
    no launch of a kernel at all (seen on the H100); the window is then
    profiled again, up to ``tries`` times."""
    for attempt in range(tries):
        _, prof = profiled(fn, iters)
        try:
            return device_us_per_call(prof.key_averages(), names) / 1e3
        except AssertionError:
            if attempt == tries - 1:
                raise
            log(f"[profile] no launch of {names} recorded; profiling again")
    raise AssertionError("unreachable")


def kernel_bound(name: str, k: int, d: int, n_blk: int) -> tuple[float, str]:
    """Least time for one call, every row live.  Quantizers: x and u read,
    q and the scales written once, about 7 float operations per element
    (abs, max, div, add, floor, clip).  Accumulations: acc and q read, out
    written, the weights, src and the scales read once; 3 float
    operations per element (two multiplies, an add).  A mask adds 4 bytes
    per row."""
    if "quantize" in name:
        n_bytes, ops = 9 * k * d + 4 * k * n_blk, 7 * k * d
    else:  # + the (K,) float32 weights and int64 src
        n_bytes, ops = 9 * k * d + 4 * k * n_blk + 12 * k, 3 * k * d
    if name.startswith("masked"):
        n_bytes += 4 * k
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def leaf_dims(params: dict) -> list[tuple[str, int]]:
    return [(n, params[n].numel()) for n in sorted(params)]


def _counters() -> dict:
    """kernel -> (its wrapper, which counts launches; its dispatcher, which
    counts plain calls)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ops as qops
    from repro_torch.kernels.rwkv6_scan import kernel as wk
    from repro_torch.kernels.rwkv6_scan import ops as wops

    from repro_torch.kernels.gossip_update import kernel as gk
    from repro_torch.kernels.gossip_update import ops as gops

    out = {name: (getattr(qk, name), getattr(qops, name)) for name in QUANT}
    out["flash_attention_fwd"] = (fk.flash_attention_fwd, fops.flash_attention)
    out["wkv6_scan"] = (wk.wkv6_scan, wops.wkv6)
    out["gossip_update"] = (gk.gossip_update, gops.gossip_update_flat)
    out["gossip_update_stacked"] = (gk.gossip_update_stacked, gops.gossip_update_stacked)
    # B.6's dispatcher counts the plain version's calls of both directions
    out["flash_attention_bwd"] = (fk.flash_attention_bwd, fops.flash_attention)
    return out


def kernel_counts() -> dict:
    """Launches of each kernel and calls of each plain version since the
    last :func:`reset_counts`."""
    return {name: (k.launches, o.plain_calls) for name, (k, o) in _counters().items()}


def reset_counts() -> None:
    for k, o in _counters().values():
        k.launches = 0
        o.plain_calls = 0


def check_counts(tag: str, counts: dict, want: dict) -> None:
    """Every kernel launched exactly ``want[name]`` times (0 when absent),
    and no plain version called."""
    for name, (launches, plain) in counts.items():
        if launches != want.get(name, 0) or plain != 0:
            raise AssertionError(f"[{tag}] {name}: {launches} launches and {plain} plain "
                                 f"calls, want {want.get(name, 0)} launches and none")


def cuobjdump() -> str:
    """cuobjdump from PATH, else beside nvcc in the CUDA toolkit, else from
    Triton's bundled binaries (``triton/backends/nvidia/bin``)."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    dirs = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin",
            Path("/usr/local/cuda/bin")]
    if shutil.which("nvcc"):
        dirs.append(Path(shutil.which("nvcc")).resolve().parent)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        dirs.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin")
    for d in dirs:
        if (d / "cuobjdump").is_file():
            return str(d / "cuobjdump")
    raise RuntimeError(f"cuobjdump not found on PATH nor in {[str(d) for d in dirs]}: "
                       f"the tensor-core check of B.6 cannot run")


# B.6's kernels that do matrix products: each must run them on the tensor
# cores (bwd_reduce_kernel, the sum of the backward's partials, does none)
TENSOR_CORE_KERNELS = {"flash_attention/csrc/flash_fwd.cu": ("flash_fwd_mma_kernel",),
                       "flash_attention/csrc/flash_bwd.cu": ("bwd_mma_kernel",)}
TF32_MMA = re.compile(r"\bHG?MMA\.[\w.]*TF32")


def tf32_mma_counts(lib: Path) -> dict[str, int]:
    """{kernel function (mangled): its TF32 tensor-core instructions (HMMA or
    HGMMA with a TF32 operand type)} in the SASS that cuobjdump prints."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and TF32_MMA.search(line):
            counts[fn] += 1
    return counts


def phase_build() -> dict:
    """Builds every source, logs ptxas's registers and spills, and proves
    from the SASS that each of B.6's product kernels, at every head dim it
    is built for, runs TF32 tensor-core instructions; raises if one has
    none.  Returns {kernel function: TF32 instructions}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {', '.join(lib.name for lib, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for source, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {source}: {line.strip()}")
    found = {}
    for source, names in TENSOR_CORE_KERNELS.items():
        counts = tf32_mma_counts(built[source][0])
        for name in names:
            fns = {fn: n for fn, n in counts.items() if name in fn}
            log(f"[build] {source}: TF32 tensor-core instructions of {name}: {fns}")
            if len(fns) != len(HEAD_DIMS) or not all(fns.values()):
                raise AssertionError(f"[build] {name} must be built for each of {HEAD_DIMS} "
                                     f"with TF32 HMMA/HGMMA in every instance: {fns}")
            found.update(fns)
    return found


def _matchings(p: float, seed: int):
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    return permutation_decomposition(
        metropolis_weights(build_graph("erdos_renyi", K, p=p, seed=seed)))


def _involution(k: int, device):
    """A matching over k rows for the layouts whose K is not the graph's."""
    import torch

    perm = [i ^ 1 if (i ^ 1) < k else i for i in range(k)]
    return torch.tensor(perm, dtype=torch.int64, device=device)


def phase_kernel(mlp_leaves, cnn_leaves) -> dict:
    """Every kernel against its plain version on the card; times one call
    per shape.  Returns {kernel: {max_abs_err, rows, per_step}}."""
    import torch

    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ref as qref

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [("mlp", n, K, d, 65536) for n, d in mlp_leaves]
    cases += [("cnn", n, K, d, 65536) for n, d in cnn_leaves]
    # multi-block layouts: several scale blocks per row (the path the
    # paper's leaves never take with the default block)
    cases += [("layout", "2 blocks", K, 131072, 65536), ("layout", "block 128", 16, 4096, 128),
              ("layout", "ragged", 3, 1000, 256)]
    fmnist_srcs = [torch.from_numpy(p).cuda() for p in _matchings(0.3, 0).matchings]
    out = {name: dict(max_abs_err=0.0, rows=[]) for name in QUANT}

    def diff(a, b):
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0

    def expect_equal(name, what, got, want):
        err = max(diff(g, w) for g, w in zip(got, want))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[kernel] {name} {what}: kernel != plain (max abs err {err})")

    for group, leaf, k, d, block_d in cases:
        x = torch.randn((k, d), generator=gen, device="cuda")
        x *= torch.rand((k, 1), generator=gen, device="cuda") * 3.0
        if k > 2:
            x[1] = 0.0  # an all-zero row: scale 1
        u = torch.rand((k, d), generator=gen, device="cuda")
        u[0, ::3] = 0.0
        acc = torch.randn((k, d), generator=gen, device="cuda")
        w = torch.rand((k,), generator=gen, device="cuda") * 0.5
        masks = {"ones": torch.ones(k, device="cuda"), "zeros": torch.zeros(k, device="cuda"),
                 "mixed": (torch.arange(k, device="cuda") % 2).float()}
        srcs = [None] + (fmnist_srcs if k == K else [_involution(k, "cuda")])
        what = f"{group} {leaf} ({k}, {d})"
        for qmax in (127.0, 7.0):
            expect_equal("quantize_blockwise", f"{what} qmax {qmax}",
                         qk.quantize_blockwise(x, u, qmax=qmax, block_d=block_d),
                         qref.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d))
        for mname, m in masks.items():
            expect_equal("masked_quantize_blockwise", f"{what} mask {mname}",
                         qk.masked_quantize_blockwise(x, u, m, block_d=block_d),
                         qref.masked_quantize_blockwise_ref(x, u, m, block_d=block_d))
        q, s = qref.quantize_blockwise_ref(x, u, block_d=block_d)
        for i, src in enumerate(srcs):
            expect_equal("dequant_accumulate", f"{what} src {i}",
                         [qk.dequant_accumulate(acc, q, s, w, src=src)],
                         [qref.dequant_accumulate_ref(acc, q, s, w, src=src)])
            for mname, m in masks.items():
                expect_equal("masked_dequant_accumulate", f"{what} src {i} mask {mname}",
                             [qk.masked_dequant_accumulate(acc, q, s, w, m, src=src)],
                             [qref.masked_dequant_accumulate_ref(acc, q, s, w, m, src=src)])
        torch.cuda.synchronize()
        # time one call of each at this shape, every row live
        ones, src = masks["ones"], srcs[1]
        calls = {
            "quantize_blockwise": (
                lambda: qk.quantize_blockwise(x, u, block_d=block_d),
                lambda: qref.quantize_blockwise_ref(x, u, block_d=block_d)),
            "masked_quantize_blockwise": (
                lambda: qk.masked_quantize_blockwise(x, u, ones, block_d=block_d),
                lambda: qref.masked_quantize_blockwise_ref(x, u, ones, block_d=block_d)),
            "dequant_accumulate": (
                lambda: qk.dequant_accumulate(acc, q, s, w, src=src),
                lambda: qref.dequant_accumulate_ref(acc, q, s, w, src=src)),
            "masked_dequant_accumulate": (
                lambda: qk.masked_dequant_accumulate(acc, q, s, w, ones, src=src),
                lambda: qref.masked_dequant_accumulate_ref(acc, q, s, w, ones, src=src)),
        }
        n_blk = qk.num_blocks(d, block_d)
        for name, (call, plain) in calls.items():
            ms = cuda_ms(call)
            plain_ms = cuda_ms(plain)
            dev_ms = device_ms(call, 50, KERNELS[name][2])
            bound, by = kernel_bound(name, k, d, n_blk)
            out[name]["rows"].append(dict(group=group, leaf=leaf, k=k, d=d, blocks=n_blk, ms=ms,
                                          device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                                          bound_by=by))
            log(f"[kernel] {name:25s} {group:6s} {leaf:9s} K={k:2d} D={d:7d} "
                f"blocks={n_blk:3d} device {1e3 * dev_ms:7.2f} us  call {1e3 * ms:7.2f} us  "
                f"plain {1e3 * plain_ms:7.2f} us  bound {1e3 * bound:7.3f} us ({by})")
    for name, rec in out.items():
        rec["per_step"] = {g: {key: sum(r[key] for r in rec["rows"] if r["group"] == g)
                               for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
                           for g in ("mlp", "cnn")}
        for g, v in rec["per_step"].items():
            log(f"[kernel] {name}: one call per {g} leaf: device {1e3 * v['device_ms']:.2f} us, "
                f"call {1e3 * v['ms']:.2f} us, plain {1e3 * v['plain_ms']:.2f} us, "
                f"bound {1e3 * v['bound_ms']:.3f} us; equal to plain everywhere "
                f"(max abs err {rec['max_abs_err']})")
    return out


def _sample(fed, steps, bsz, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    draws = [fed.sample_batch(rng, bsz) for _ in range(steps)]
    return tuple(np.stack(parts) for parts in zip(*draws))


def _params_via_npz(init, seed: int, tag: str, device: str):
    import numpy as np
    import torch

    from repro_torch import convert

    path = ROOT / "build" / "chip_smoke" / f"params_{tag}_seed{seed}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **convert.params_to_numpy(init(torch.Generator().manual_seed(seed))))
    with np.load(path) as npz:
        return convert.params_from_numpy(dict(npz), device=device)


def _finite(ms: dict) -> None:
    import torch

    for key, v in ms.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"metric {key} is not finite")


def _train(spec, loss_fn, apply_fn, params, batches, steps, warmup_batches, mixer=None):
    """Warm up on a throwaway state, set every launch count to 0, then drive
    ``steps`` steps through ``trainer.run``.  Returns the trainer, final
    state, metrics, ms/step and the counts of that run."""
    import torch

    trainer = spec.build(loss_fn, apply_fn, mixer=mixer)
    trainer.run(trainer.init(params), warmup_batches)
    state = trainer.init(params)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, ms = trainer.run(state, batches, steps=steps)
    torch.cuda.synchronize()
    ms_per_step = 1e3 * (time.perf_counter() - t0) / steps
    counts = kernel_counts()
    _finite(ms)
    return trainer, state, ms, ms_per_step, counts


def _loss_on(trainer, state, batch) -> float:
    import torch

    with torch.no_grad():
        x, y = (torch.from_numpy(b).to(trainer.device) for b in batch)
        return float(trainer.loss_fn(state.params, (x, y)).mean())


def _fmnist():
    """fmnist_default's data, batches and seeded weights on the card."""
    from repro_torch.configs import fmnist_default
    from repro_torch.data import make_fmnist_like, pathological_noniid_partition
    from repro_torch.models import mlp_init

    exp = fmnist_default()
    fed = pathological_noniid_partition(make_fmnist_like(), K, seed=exp.seed)
    batches = _sample(fed, exp.steps, exp.batch_size, exp.seed)
    return exp, fed, batches, _params_via_npz(mlp_init, exp.seed, "mlp", "cuda")


def _fmnist_run(tag, stack, spec, exp, fed, batches, params, mixer=None) -> tuple:
    """300 fmnist steps through TrainerSpec.build; logs and checks the
    record (falling loss, finite metrics).  Returns (record, final state)."""
    from repro_torch.models import make_classifier_loss, mlp_apply

    x_nodes, y_nodes = fed.per_node_test_sets(n_per_node=200, seed=exp.seed)
    warm = tuple(b[:5] for b in batches)
    first = tuple(b[0] for b in batches)
    trainer, state, ms, ms_step, counts = _train(
        spec, make_classifier_loss(mlp_apply), mlp_apply, params, batches, exp.steps, warm,
        mixer=mixer)
    loss0 = float(ms["loss_mean"][0])
    loss_end = _loss_on(trainer, state, first)
    stats = trainer.eval_local_distributions(state, x_nodes, y_nodes)
    rec = dict(stack=stack, steps=exp.steps, batch=exp.batch_size, lr=exp.lr,
               loss_step0=loss0, loss_step300=loss_end,
               acc_worst_dist=stats["acc_worst_dist"], acc_node_std=stats["acc_node_std"],
               acc_avg=stats["acc_avg"], disagreement=float(ms["disagreement"][-1]),
               ms_per_step=ms_step,
               launches={n: c[0] for n, c in counts.items() if c[0]},
               plain_calls=sum(c[1] for c in counts.values()))
    if trainer.mixer.traced_wire:  # the measured wire of a time-varying topology
        rec["wire_bytes_per_round_mean"] = float(ms["wire_bits"].double().mean()) / 8.0
    else:
        rec["comm_bytes_per_round"] = float(ms["comm_bytes"][-1])
    log(f"[{tag}] " + json.dumps(rec))
    if not loss_end < loss0:
        raise AssertionError(f"[{tag}] {stack}: loss did not fall ({loss0} -> {loss_end})")
    if not all(math.isfinite(v) for v in (stats["acc_worst_dist"], stats["acc_node_std"])):
        raise AssertionError(f"[{tag}] {stack}: eval metrics not finite")
    return rec, state, counts


def _spec(spec_cls, exp, compress, **kw):
    return spec_cls(num_nodes=K, graph="erdos_renyi",
                    graph_kwargs={"p": exp.p, "seed": exp.seed}, mu=exp.mu, lr=exp.lr,
                    compress=compress, device="cuda", **kw)


def phase_fmnist(spec_cls, cfg_cls) -> tuple[dict, dict]:
    exp, fed, batches, params = _fmnist()
    out, dense_params = {}, None
    for wire, compress in (("none", "none"),
                           ("int8-kernel", cfg_cls(kind="int8", use_kernel=True))):
        rec, state, counts = _fmnist_run("fmnist", wire, _spec(spec_cls, exp, compress),
                                         exp, fed, batches, params)
        # the uncompressed dense step is SGD + the static W: fused into B.1
        check_counts(f"fmnist {wire}", counts, {"quantize_blockwise": exp.steps * 6}
                     if wire == "int8-kernel" else {"gossip_update_stacked": exp.steps * 6})
        out[wire] = rec
        if wire == "none":
            dense_params = state.params
    return out, dense_params


def _gossip_mixer(stack: str, decomp, w, seed: int, cfg_cls, device="cuda", **hooks):
    """The gossip stack ``stack`` on ``device`` (a user's pre-built mixer);
    ``hooks`` are the tests' noise/topology injections (parity only)."""
    from repro_torch.comm import CompressedGossipMixer
    from repro_torch.core.consensus import make_gossip_mixer
    from repro_torch.dynamics import DropoutSchedule, DynamicGossipMixer

    uniforms = hooks.get("uniforms")
    sched = hooks.get("schedule") or DropoutSchedule(w, DROP_P, seed=seed, device=device)
    if stack == "gossip-none":
        return make_gossip_mixer(decomp, device=device)
    if stack == "gossip-int8-kernel-ef":
        return CompressedGossipMixer(decomp, cfg_cls(kind="int8", use_kernel=True),
                                     device=device, uniforms=uniforms)
    if stack == "dropout0.2-int8-kernel-memoryless":
        return DynamicGossipMixer(sched, quantized=cfg_cls(kind="int8", use_kernel=True,
                                                           error_feedback=False),
                                  uniforms=uniforms)
    if stack == "dropout0.2-int8-kernel-ef-B4":
        return DynamicGossipMixer(sched, quantized=cfg_cls(kind="int8", use_kernel=True),
                                  ef_rebase_every=REBASE_EVERY, uniforms=uniforms)
    raise ValueError(stack)


GOSSIP_STACKS = ("gossip-none", "gossip-int8-kernel-ef", "dropout0.2-int8-kernel-memoryless",
                 "dropout0.2-int8-kernel-ef-B4")


def _gossip_launches(stack: str, steps: int, leaves: int, matchings: int) -> dict:
    if stack == "gossip-int8-kernel-ef":
        return {"quantize_blockwise": steps * leaves,
                "dequant_accumulate": steps * leaves * matchings}
    if stack == "dropout0.2-int8-kernel-memoryless":
        return {"masked_quantize_blockwise": steps * leaves * matchings,
                "masked_dequant_accumulate": steps * leaves * matchings}
    if stack == "dropout0.2-int8-kernel-ef-B4":
        delta_rounds = sum(1 for r in range(steps) if r % REBASE_EVERY != REBASE_EVERY - 1)
        return {"masked_quantize_blockwise": steps * leaves,
                "masked_dequant_accumulate": delta_rounds * leaves * matchings}
    return {}


def phase_gossip(spec_cls, cfg_cls, dense_params) -> dict:
    from repro_torch.graphs import build_graph, metropolis_weights

    exp, fed, batches, params = _fmnist()
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
    decomp = _matchings(exp.p, exp.seed)
    log(f"[gossip] fmnist graph: {decomp.num_rounds} matchings, "
        f"{sum(len(p) for p in decomp.ppermute_pairs())} directed sends per round")
    out = {}
    for stack in GOSSIP_STACKS:
        mixer = _gossip_mixer(stack, decomp, w, exp.seed, cfg_cls)
        rec, state, counts = _fmnist_run("gossip", stack,
                                         _spec(spec_cls, exp, mixer.compression or "none"),
                                         exp, fed, batches, params, mixer=mixer)
        check_counts(f"gossip {stack}", counts,
                     _gossip_launches(stack, exp.steps, len(params), decomp.num_rounds))
        if stack == "gossip-none":
            rec.update(_gossip_vs_dense(spec_cls, exp, batches, params, state, dense_params,
                                        mixer))
        out[stack] = dict(rec, counts=counts)
    out["cifar"] = _gossip_cifar(spec_cls, cfg_cls)
    return out


def _gossip_vs_dense(spec_cls, exp, batches, params, gossip_state, dense_params,
                     mixer) -> dict:
    """Uncompressed static gossip against the dense W product: the two sum
    the neighbours in another order, so their params part by float32
    rounding that the training amplifies.  Held within GOSSIP_DENSE_ATOL
    after PARITY_STEPS steps, and within GOSSIP_DENSE_DRIFT after the whole
    run (a wrong weight or neighbour moves params by O(0.1))."""
    from repro_torch.models import make_classifier_loss, mlp_apply

    short = tuple(b[:PARITY_STEPS] for b in batches)
    ends = []
    for m in (None, mixer):
        trainer = _spec(spec_cls, exp, "none").build(make_classifier_loss(mlp_apply),
                                                     mlp_apply, mixer=m)
        ends.append(trainer.run(trainer.init(params), short)[0].params)
    d_short = max(float((ends[0][n] - ends[1][n]).abs().max()) for n in params)
    d_run = max(float((gossip_state.params[n] - dense_params[n]).abs().max())
                for n in params)
    log(f"[gossip] gossip-none vs the dense run: max abs param diff {d_short} after "
        f"{PARITY_STEPS} steps (atol {GOSSIP_DENSE_ATOL}), {d_run} after {exp.steps} "
        f"steps (atol {GOSSIP_DENSE_DRIFT})")
    if not (d_short <= GOSSIP_DENSE_ATOL and d_run <= GOSSIP_DENSE_DRIFT):
        raise AssertionError("[gossip] static gossip left the dense trajectory")
    return {f"max_abs_param_diff_vs_dense_{PARITY_STEPS}_steps": d_short,
            f"max_abs_param_diff_vs_dense_{exp.steps}_steps": d_run}


def _gossip_cifar(spec_cls, cfg_cls) -> dict:
    """The CNN on the static int8 EF gossip wire: B.3 on 512,000-wide rows."""
    from repro_torch.configs import cifar_default
    from repro_torch.data import make_cifar_like, pathological_noniid_partition
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import cnn_apply, cnn_init, make_classifier_loss

    exp = cifar_default()
    fed = pathological_noniid_partition(make_cifar_like(), K, seed=exp.seed)
    batches = _sample(fed, CIFAR_GOSSIP_STEPS, exp.batch_size, exp.seed)
    params = _params_via_npz(cnn_init, exp.seed, "cnn", "cuda")
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
    decomp = _matchings(exp.p, exp.seed)
    mixer = _gossip_mixer("gossip-int8-kernel-ef", decomp, w, exp.seed, cfg_cls)
    spec = spec_cls(num_nodes=K, graph="erdos_renyi", graph_kwargs={"p": exp.p, "seed": exp.seed},
                    mu=exp.mu, lr=exp.lr, grad_clip=CIFAR_GRAD_CLIP, compress=mixer.compression,
                    device="cuda")
    _, _, ms, ms_step, counts = _train(spec, make_classifier_loss(cnn_apply), cnn_apply, params,
                                       batches, CIFAR_GOSSIP_STEPS,
                                       tuple(b[:2] for b in batches), mixer=mixer)
    check_counts("gossip cifar", counts, _gossip_launches(
        "gossip-int8-kernel-ef", CIFAR_GOSSIP_STEPS, len(params), decomp.num_rounds))
    rec = dict(stack="gossip-int8-kernel-ef", model="cnn", steps=CIFAR_GOSSIP_STEPS,
               matchings=decomp.num_rounds, grad_clip=CIFAR_GRAD_CLIP,
               loss_step0=float(ms["loss_mean"][0]), loss_last=float(ms["loss_mean"][-1]),
               loss_worst_max=float(ms["loss_worst"].max()),
               comm_bytes_per_round=float(ms["comm_bytes"][-1]), ms_per_step=ms_step,
               launches={n: c[0] for n, c in counts.items() if c[0]})
    log("[gossip] " + json.dumps(rec))
    return rec


def phase_profile(spec_cls, cfg_cls) -> dict:
    """Where an fmnist step's time goes: PROFILE_STEPS steps of each stack
    under torch.profiler, the batches already on the card.  Reports the
    step's wall time (profiler on), the device's busy share and the kernels
    that take the most device time."""
    import torch

    from repro_torch.configs import fmnist_default
    from repro_torch.data import make_fmnist_like, pathological_noniid_partition
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import make_classifier_loss, mlp_apply, mlp_init

    exp = fmnist_default()
    fed = pathological_noniid_partition(make_fmnist_like(), K, seed=exp.seed)
    batches = tuple(torch.from_numpy(b).cuda()
                    for b in _sample(fed, PROFILE_STEPS, exp.batch_size, exp.seed))
    params = _params_via_npz(mlp_init, exp.seed, "mlp", "cuda")
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
    decomp = _matchings(exp.p, exp.seed)
    stacks = [("dense-none", "none", None),
              ("dense-int8-kernel", cfg_cls(kind="int8", use_kernel=True), None)]
    for stack in ("gossip-int8-kernel-ef", "dropout0.2-int8-kernel-memoryless"):
        mixer = _gossip_mixer(stack, decomp, w, exp.seed, cfg_cls)
        stacks.append((stack, mixer.compression, mixer))
    out = {}
    for stack, compress, mixer in stacks:
        trainer = _spec(spec_cls, exp, compress).build(make_classifier_loss(mlp_apply),
                                                       mlp_apply, mixer=mixer)
        state = [trainer.init(params)]

        def steps():
            state[0], _ = trainer.run(state[0], batches)

        wall, prof = profiled(steps, 1)
        dev = device_events(prof.key_averages())
        busy_us = sum(e.self_device_time_total for e in dev)
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        rec = dict(stack=stack, steps=PROFILE_STEPS,
                   ms_per_step_profiled=1e3 * wall / PROFILE_STEPS,
                   device_busy_ms_per_step=busy_us / 1e3 / PROFILE_STEPS,
                   device_busy_share=busy_us / 1e6 / wall,
                   device_ops_per_step=sum(e.count for e in dev) / PROFILE_STEPS,
                   top=[(e.key[:48], round(e.self_device_time_total / PROFILE_STEPS, 2),
                         e.count // PROFILE_STEPS) for e in top])
        log("[profile] " + json.dumps(rec))
        out[stack] = rec
    return out


def phase_cifar(spec_cls, cfg_cls) -> dict:
    from repro_torch.configs import cifar_default
    from repro_torch.data import make_cifar_like, pathological_noniid_partition
    from repro_torch.models import cnn_apply, cnn_init, make_classifier_loss

    exp = cifar_default()
    fed = pathological_noniid_partition(make_cifar_like(), K, seed=exp.seed)
    batches = _sample(fed, CIFAR_STEPS, exp.batch_size, exp.seed)
    warm = tuple(b[:3] for b in batches)
    params = _params_via_npz(cnn_init, exp.seed, "cnn", "cuda")
    # The CNN at the paper's lr = sqrt(K/T) is on the edge of stability on
    # the synthetic CIFAR stand-in (worst-node losses of 30-90 in the first
    # steps, up to 3.6x amplified by the robust scale): unclipped, the JAX
    # reference and the port both overflow on some noise seeds of the int8
    # wire (tests/cifar_stability.py).  The repo's own CIFAR benchmark clips
    # every node's gradient at global norm 2 (benchmarks/common.py,
    # run_decentralized), and so does this phase.
    spec = spec_cls(num_nodes=K, graph="erdos_renyi",
                    graph_kwargs={"p": exp.p, "seed": exp.seed}, mu=exp.mu, lr=exp.lr,
                    grad_clip=CIFAR_GRAD_CLIP,
                    compress=cfg_cls(kind="int8", use_kernel=True), device="cuda")
    trainer, state, ms, ms_step, counts = _train(
        spec, make_classifier_loss(cnn_apply), cnn_apply, params, batches, CIFAR_STEPS, warm)
    check_counts("cifar", counts, {"quantize_blockwise": CIFAR_STEPS * 12})
    rec = dict(wire="int8-kernel", steps=CIFAR_STEPS, batch=exp.batch_size,
               grad_clip=CIFAR_GRAD_CLIP, loss_step0=float(ms["loss_mean"][0]),
               loss_last=float(ms["loss_mean"][-1]),
               loss_worst_max=float(ms["loss_worst"].max()),
               comm_bytes=float(ms["comm_bytes"][-1]), ms_per_step=ms_step,
               launches=counts["quantize_blockwise"][0])
    log("[cifar] " + json.dumps(rec))
    return rec


def _step_loop(trainer, state, batches):
    """Drive ``trainer.step`` over the stacked batches.  Returns the final
    state, the metrics stacked on the host, and the largest quantization
    step the wire took: max |theta - theta_hat| / 127 before a round (max
    |theta| / 127 on a memoryless wire, which quantizes theta itself)."""
    import torch

    ms, q_step = [], 0.0
    for t in range(batches[0].shape[0]):
        ref = state.comm.hat if state.comm.hat != () else None
        q_step = max(q_step, max(
            float((state.params[n] - (ref[n] if ref is not None else 0.0)).abs().max())
            for n in state.params) / 127.0)
        state, m = trainer.step(state, tuple(b[t] for b in batches))
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms]).cpu() for k in ms[0]}, q_step


def _replay_schedule(w, ws: dict, device):
    """Dropout's decomposition with a fixed W_r per round, the same on both
    devices (parity only)."""
    from repro_torch.dynamics import DropoutSchedule

    class Replay(DropoutSchedule):
        def round_weights(self, rounds):
            return ws[rounds].to(self.device)

    return Replay(w, DROP_P, device=device)


def phase_parity(spec_cls, cfg_cls) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import fmnist_default
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.data import make_fmnist_like, pathological_noniid_partition
    from repro_torch.dynamics import DropoutSchedule
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import make_classifier_loss, mlp_apply, mlp_init

    exp = fmnist_default()
    fed = pathological_noniid_partition(make_fmnist_like(), K, seed=exp.seed)
    batches = _sample(fed, PARITY_STEPS, exp.batch_size, exp.seed)
    gkw = {"p": exp.p, "seed": exp.seed}
    w = metropolis_weights(build_graph("erdos_renyi", K, **gkw))
    decomp = _matchings(exp.p, exp.seed)
    loss_fn = make_classifier_loss(mlp_apply)
    sched = DropoutSchedule(w, DROP_P, seed=exp.seed, device="cpu")
    ws = {r: sched.round_weights(r) for r in range(PARITY_STEPS)}

    def noise(rounds, leaf_idx, *rest):  # identical uniforms for both devices
        return np.random.default_rng([rounds, leaf_idx, *rest[:-1]]).random(
            rest[-1], dtype=np.float32)

    def mixer_for(wire, device):
        if wire == "none":
            return None
        if wire == "dense-int8-kernel":
            return make_dense_mixer(w, compression=cfg_cls(kind="int8", use_kernel=True),
                                    device=device, uniforms=noise)
        return _gossip_mixer(wire, decomp, w, exp.seed, cfg_cls, device=device,
                             uniforms=noise, schedule=_replay_schedule(w, ws, device))

    out = {}
    for wire in ("none", "dense-int8-kernel") + GOSSIP_STACKS[1:]:
        runs = {}
        for device in ("cuda", "cpu"):
            mixer = mixer_for(wire, device)
            spec = spec_cls(num_nodes=K, graph="erdos_renyi", graph_kwargs=gkw, mu=exp.mu,
                            lr=exp.lr, compress=mixer.compression if mixer else "none",
                            device=device)
            trainer = spec.build(loss_fn, mlp_apply, mixer=mixer)
            params = _params_via_npz(mlp_init, exp.seed, "mlp", device)
            runs[device] = _step_loop(trainer, trainer.init(params), batches)
        (s_gpu, m_gpu, _), (s_cpu, m_cpu, q_step) = runs["cuda"], runs["cpu"]
        d_param = max(float((s_gpu.params[n].cpu() - s_cpu.params[n]).abs().max())
                      for n in s_cpu.params)
        d_metric = max(float(((m_gpu[k] - m_cpu[k]).abs() / m_cpu[k].abs().clamp_min(1e-30)
                              ).max()) for k in m_cpu if bool((m_cpu[k] != 0).any()))
        if wire == "none":
            atol, rtol = PARITY_PARAM_ATOL, PARITY_METRIC_RTOL
        else:
            atol, rtol = PARITY_INT8_STEPS * q_step, 1e-3
        rec = dict(wire=wire, steps=PARITY_STEPS, max_abs_param_diff=d_param,
                   max_quantization_step=q_step if wire != "none" else None,
                   max_rel_metric_diff=d_metric, param_atol=atol, metric_rtol=rtol,
                   tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
                   tf32_cudnn=torch.backends.cudnn.allow_tf32)
        log("[parity] " + json.dumps(rec))
        if not (d_param <= atol and d_metric <= rtol):
            raise AssertionError(f"[parity] {wire}: GPU vs CPU outside tolerance")
        out[wire] = rec
    return out


# -- serving: B.6 / B.7 and the LM path ---------------------------------------

def _pairs(s: int, t: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head), positions from 0."""
    n = 0
    for qi in range(s):
        lo = 0 if window is None else max(0, qi - window + 1)
        hi = min(t, qi + 1) if causal else t
        n += max(0, hi - lo)
    return n


def _attention_bound(n_bytes: int, ops: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, the CUDA cores' bound ms) of an attention
    kernel whose float32 products run as three TF32 tensor-core products:
    the larger of the bytes at the HBM rate and 3 x ops at the TF32 rate;
    beside it the larger of the bytes and ops at the float32 FMA rate."""
    t_bytes, t_tc = n_bytes / HBM_BYTES_PER_S, 3 * ops / TF32_OPS_PER_S
    return (1e3 * max(t_bytes, t_tc), "bytes" if t_bytes >= t_tc else "operations",
            1e3 * max(t_bytes, ops / FP32_OPS_PER_S))


def flash_bound(b, h, kvh, s, t, hd, causal, window) -> tuple[float, str, float]:
    """Least time of one B.6 call: q, k, v read and out written once at the
    HBM rate, against 4 hd float operations per unmasked pair (two for q.k,
    two for p.v), each taken as three TF32 products at the tensor cores'
    TF32 peak.  Returns (bound ms, "bytes" or "operations", the bound with
    the operations at the float32 FMA peak instead)."""
    n_bytes = 4 * (2 * b * h * s * hd + 2 * b * kvh * t * hd)
    return _attention_bound(n_bytes, 4 * b * h * hd * _pairs(s, t, causal, window))


def wkv6_bound(b, h, t, hd) -> tuple[float, str]:
    """Least time of one B.7 call: r, k, v, w read, y and the final state
    written once, u read once, against 4 hd^2 float operations per (b, h, t)
    at the float32 FMA peak."""
    n_bytes = 4 * (5 * b * h * t * hd + b * h * hd * hd + h * hd)
    ops = 4 * b * h * t * hd * hd
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def need_tma(tag: str, **views) -> bool:
    """True, or raise: B.6's kernels copy each of these (B, heads, rows, hd)
    views by TMA, not by the slower cp.async they fall back to when the
    driver refuses a tensor map or a row is not 16-byte aligned."""
    from repro_torch.kernels.flash_attention import kernel as fk

    off = {n: (tuple(x.shape), x.stride(), x.data_ptr() % 16) for n, x in views.items()
           if not fk.rows_by_tma(x)}
    if off:
        raise AssertionError(f"{tag}: copied by cp.async, not TMA (shape, strides, address "
                             f"mod 16): {off}")
    return True


def tma_audit(fn) -> dict:
    """Run ``fn`` with each call of B.6 from ``ops`` (the model's entry)
    checked first by :func:`need_tma` on the views it copies by TMA: the
    forward's k and v, the backward's q, k, v, out and dout.  Returns the
    calls checked, {"fwd": n, "bwd": n}."""
    import types

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo

    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, **kw):
        calls["fwd"] += need_tma("B.6 forward in the step", k=k, v=v)
        return fk.flash_attention_fwd(q, k, v, **kw)

    def bwd(q, k, v, out, lse, dout, **kw):
        dout_rows = dout if dout.stride(-1) == 1 else dout.contiguous()  # as the wrapper
        calls["bwd"] += need_tma("B.6 backward in the step", q=q, k=k, v=v, out=out,
                                 dout=dout_rows)
        return fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

    fo._k = types.SimpleNamespace(flash_attention_fwd=fwd, flash_attention_bwd=bwd)
    try:
        fn()
    finally:
        fo._k = fk
    return calls


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| over a pair of tensors."""
    scale = float(want.abs().max())
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-30)


def phase_serve_kernels() -> dict:
    """B.6 and B.7 against their plain versions at the serving shapes, on
    the model's memory layout (strided (B, S, H, hd) views)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rwkv6_scan import kernel as wk
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    flash_cases = [  # tag, b, h, kvh, s, hd, window, softcap
        ("qwen2-0.5b prefill", 4, 14, 2, 512, 64, None, None),
        ("qwen2-0.5b train S 64", 2, 14, 2, 64, 64, None, None),
        ("hd 80, window 4096", 2, 32, 8, 512, 80, 4096, None),
        ("hd 128, window 64, softcap 50", 2, 32, 16, 512, 128, 64, 50.0),
        ("G = 1", 2, 8, 8, 512, 64, None, None),
        ("ragged S = 300", 4, 14, 2, 300, 64, None, None),
    ]
    out = {"flash_attention_fwd": dict(max_abs_err=0.0, rows=[]),
           "wkv6_scan": dict(max_abs_err=0.0, rows=[])}
    for tag, b, h, kvh, s, hd, window, softcap in flash_cases:
        q = randn(b, s, h, hd).permute(0, 2, 1, 3)
        k, v = (randn(b, s, kvh, hd).permute(0, 2, 1, 3) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=softcap)
        got, want = fk.flash_attention_fwd(q, k, v, **kw), attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        out["flash_attention_fwd"]["max_abs_err"] = max(out["flash_attention_fwd"]["max_abs_err"],
                                                        err)
        if not torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL):
            raise AssertionError(f"[serve-kernel] B.6 {tag}: kernel != plain (max abs err {err})")
        ms = cuda_ms(lambda: fk.flash_attention_fwd(q, k, v, **kw), iters=50)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=10, warmup=2)
        dev_ms = device_ms(lambda: fk.flash_attention_fwd(q, k, v, **kw), 20,
                           KERNELS["flash_attention_fwd"][2])
        bound, by, fp32_bound = flash_bound(b, h, kvh, s, s, hd, True, window)
        row = dict(case=tag, b=b, h=h, kvh=kvh, s=s, hd=hd, window=window, softcap=softcap,
                   max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, fp32_bound_ms=fp32_bound, library_ms=None,
                   tma=need_tma(f"[serve-kernel] B.6 {tag}", k=k, v=v))
        if window is None and softcap is None:  # the yardstick: one PyTorch call, contiguous
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            backend, label, kf, vf, gqa = sdpa_yardstick(qc, kc, vc)

            def sdpa():
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(qc, kf, vf, is_causal=True,
                                                          enable_gqa=gqa)

            if not torch.allclose(sdpa(), want, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"[serve-kernel] SDPA disagrees with the plain version ({tag})")
            row.update(library_ms=cuda_ms(sdpa, iters=50),
                       library_device_ms=window_device_ms(sdpa, 20), library_backend=label)
        out["flash_attention_fwd"]["rows"].append(row)
        log("[serve-kernel] " + json.dumps(row))

    for tag, b, h, t, hd, decay in (("rwkv6-7b prefill", 4, 64, 256, 64, "random"),
                                    ("rwkv6-7b prefill, init decay", 4, 64, 256, 64, "init"),
                                    ("ragged T = 100", 4, 64, 100, 64, "random")):
        r, k, v = (randn(b, t, h, hd).permute(0, 2, 1, 3) for _ in range(3))
        if decay == "random":
            w = torch.rand((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
        else:  # exp(-exp(decay_base = -6)): the state hardly decays
            w = torch.full((b, t, h, hd), math.exp(-math.exp(-6.0)), device="cuda"
                           ).permute(0, 2, 1, 3)
        u = 0.5 * randn(h, hd)
        (y, st), (y_p, st_p) = wk.wkv6_scan(r, k, v, w, u), wkv6_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        errs = {}
        for what, got, want in (("y", y, y_p), ("state", st, st_p)):
            scale = float(want.abs().max())
            errs[what] = float((got - want).abs().max())
            errs[what + "_max_abs"] = scale
            if not torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL * scale):
                raise AssertionError(f"[serve-kernel] B.7 {tag} {what}: kernel != plain "
                                     f"(max abs err {errs[what]}, max |{what}| {scale})")
        out["wkv6_scan"]["max_abs_err"] = max(out["wkv6_scan"]["max_abs_err"], errs["y"],
                                              errs["state"])
        ms = cuda_ms(lambda: wk.wkv6_scan(r, k, v, w, u), iters=50)
        plain_ms = cuda_ms(lambda: wkv6_ref(r, k, v, w, u), iters=5, warmup=1)
        dev_ms = device_ms(lambda: wk.wkv6_scan(r, k, v, w, u), 20, KERNELS["wkv6_scan"][2])
        bound, by = wkv6_bound(b, h, t, hd)
        row = dict(case=tag, b=b, h=h, t=t, hd=hd, **errs, ms=ms, device_ms=dev_ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
        out["wkv6_scan"]["rows"].append(row)
        log("[serve-kernel] " + json.dumps(row))
    return out


def _clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _leaves(cache) -> dict:
    from repro_torch.utils.tree import flatten

    return flatten({"groups": cache["groups"],
                    "head": {str(i): c for i, c in enumerate(cache["head"])}})


def _generate(model, params, prompt, gen_len: int, use_prefill: bool):
    """Greedy generation by hand, keeping what the comparisons need: the
    prompt's last logits, the cache right after the prompt, the tokens and
    each step's top-2 logit gap.  ``use_prefill=False`` is the decode-only
    path (every prompt token through decode_step, no kernel)."""
    import torch

    from repro_torch.serve import merge_prefill_cache

    b, s0 = prompt.shape
    if use_prefill:
        logits, pf = model.prefill(params, {"tokens": prompt})
        cache = merge_prefill_cache(model, pf, b, s0 + gen_len, s0)
    else:
        cache = model.init_cache(b, s0 + gen_len, prompt.device)
        for t in range(s0):
            logits, cache = model.decode_step(params, prompt[:, t:t + 1], t, cache)
    first, first_cache = logits.clone(), _clone(cache)
    toks, gaps = [], []
    for t in range(gen_len):
        top = logits.topk(2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        toks.append(logits.argmax(dim=-1))
        logits, cache = model.decode_step(params, toks[-1][:, None], s0 + t, cache)
    return first, first_cache, torch.stack(toks, 1), torch.stack(gaps, 1)


def _same_tokens(tag, got, want, gaps, tol) -> int:
    """Tokens must agree row by row up to the first step where the
    reference's top-2 gap is within ``tol`` (a near tie that rounding may
    break either way; later steps then see other inputs).  Returns the
    count of identical tokens before that point."""
    same = 0
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            if int(got[row, t]) == int(want[row, t]):
                same += 1
                continue
            if float(gaps[row, t]) > tol:
                raise AssertionError(f"[{tag}] row {row} step {t}: token {int(got[row, t])} vs "
                                     f"{int(want[row, t])} with a top-2 gap of "
                                     f"{float(gaps[row, t])} > {tol}")
            break
    return same


def _compare(tag, logits, cache, ref_logits, ref_cache, rel) -> dict:
    d_logits = _rel_err(logits, ref_logits)
    got, want = _leaves(cache), _leaves(ref_cache)
    if sorted(got) != sorted(want):
        raise AssertionError(f"[{tag}] cache leaves differ: {sorted(got)} vs {sorted(want)}")
    d_cache = {name: _rel_err(got[name].to(want[name].device), want[name]) for name in want}
    worst = max(d_cache.values())
    if not (d_logits <= rel and worst <= rel):
        raise AssertionError(f"[{tag}] logits {d_logits}, cache {worst} (relative to max |x|) "
                             f"> {rel}")
    return dict(logits_rel_err=d_logits, cache_rel_err_max=worst,
                cache_worst_leaf=max(d_cache, key=d_cache.get))


def _serve_model(arch: str, n_layers: int | None = None):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import TransformerLM

    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return TransformerLM(cfg)


def _serve_profile(model, params, prompt, decode_steps: int) -> dict:
    """One prefill and ``decode_steps`` decode steps under torch.profiler."""
    from repro_torch.serve import merge_prefill_cache

    b, s0 = prompt.shape
    out = {}
    state = {}

    def prefill():
        state["logits"], state["pf"] = model.prefill(params, {"tokens": prompt})

    def decode():
        cache = merge_prefill_cache(model, state["pf"], b, s0 + decode_steps, s0)
        logits = state["logits"]
        for t in range(decode_steps):
            logits, cache = model.decode_step(params, logits.argmax(-1)[:, None], s0 + t, cache)

    for phase, fn in (("prefill", prefill), (f"decode x{decode_steps}", decode)):
        wall, prof = profiled(fn, 1)
        dev = device_events(prof.key_averages())
        busy_us = sum(e.self_device_time_total for e in dev)
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        out[phase] = dict(wall_ms=1e3 * wall, device_busy_ms=busy_us / 1e3,
                          device_busy_share=busy_us / 1e6 / wall,
                          device_ops=sum(e.count for e in dev),
                          top=[(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count)
                               for e in top])
        log(f"[serve] profile {phase}: " + json.dumps(out[phase]))
    return out


def _layerwise(model, params, prompt) -> dict:
    """Each rwkv layer's prefill form (one B.7 launch) against its decode
    form (every prompt token through the layer's decode step from a fresh
    state), both fed the same input: the prefill path's own hidden states,
    so rounding differences do not compound from layer to layer.  Returns
    the largest output and state differences, relative to their largest
    value."""
    import torch

    from repro_torch.models.ssm import rwkv_init_state

    b, s = prompt.shape
    x = model._input_embed(params, {"tokens": prompt})
    worst = {"layer_out_rel_err": 0.0, "layer_state_rel_err": 0.0}
    for blk, ffn, p, _ in model._layers(params):
        if blk != "rwkv":
            raise ValueError(f"layer by layer is for rwkv blocks, got {blk!r}")
        y, state = model._apply_layer_fwd(p, x, blk, ffn, True)
        cache = rwkv_init_state(model.cfg, b, x.device)
        ys = []
        for t in range(s):
            y_t, cache = model._apply_layer_decode(p, x[:, t:t + 1], blk, ffn, t, cache)
            ys.append(y_t)
        worst["layer_out_rel_err"] = max(worst["layer_out_rel_err"],
                                         _rel_err(y, torch.cat(ys, dim=1)))
        for name, v in state.items():
            worst["layer_state_rel_err"] = max(worst["layer_state_rel_err"],
                                               _rel_err(v, cache[name]))
        x = y
    return worst


def phase_serve(arch: str, prompt_len: int, gen_len: int, kernel: str, profile: bool,
                end_to_end: bool) -> dict:
    """One model at full width and depth on the card: the main path
    (timed_generate) with its launches counted, held against the
    decode-only path: end to end (logits, caches, tokens) when
    ``end_to_end``, else layer by layer (``_layerwise``) with the end-to-end
    gaps recorded.  A randomly initialised rwkv6-7b amplifies float32
    rounding from layer to layer (the reference's own prefill and decode
    paths part by 2.6e-6 at 2 layers and 5.8e-3 at 32, at d = 256 on the
    CPU: tests/rwkv_depth_sweep.py), so its two paths' logits part by O(1) at 32 layers whatever the
    kernel does; each layer is still held at SERVE_REL."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import timed_generate

    t_start = time.perf_counter()
    model = _serve_model(arch)
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt_len))).cuda()
    per_prefill = sum(blk != "rwkv" for blk, _ in cfg._full_pattern()) \
        if kernel == "flash_attention_fwd" else sum(blk == "rwkv" for blk, _ in cfg._full_pattern())
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               params=model.num_params(), batch=SERVE_BATCH, prompt_len=prompt_len,
               gen_len=gen_len, init_s=time.perf_counter() - t_start)
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        tokens, stats = timed_generate(model, params, prompt, gen_len)
        counts = kernel_counts()
        check_counts(f"serve {arch}", counts, {kernel: 2 * per_prefill})  # 2 prefill calls
        rec.update(launches=counts[kernel][0], launches_per_prefill=per_prefill,
                   prefill_tok_s=stats["prefill"]["tok_s"],
                   prefill_steady_s=stats["prefill"]["steady_s"],
                   prefill_first_call_extra_s=stats["prefill"]["compile_s"],
                   decode_ms_per_token=1e3 * stats["decode"]["steady_s"] / max(1, gen_len - 1),
                   decode_tok_s=stats["decode"]["tok_s"])
        reset_counts()
        logits, cache, toks, _ = _generate(model, params, prompt, gen_len, use_prefill=True)
        check_counts(f"serve {arch} one prefill", kernel_counts(), {kernel: per_prefill})
        if not torch.equal(toks, tokens):
            raise AssertionError(f"[serve] {arch}: timed_generate and a second greedy run differ")
        t0 = time.perf_counter()
        ref_logits, ref_cache, ref_toks, gaps = _generate(model, params, prompt, gen_len,
                                                          use_prefill=False)
        rec["decode_only_s"] = time.perf_counter() - t0
        tol = SERVE_REL * float(ref_logits.abs().max())
        if end_to_end:
            rec.update(_compare(f"serve {arch}", logits, cache, ref_logits, ref_cache,
                                SERVE_REL))
            rec["tokens_identical"] = _same_tokens(f"serve {arch}", tokens, ref_toks, gaps, tol)
        else:
            rec["end_to_end_logits_rel_err"] = _rel_err(logits, ref_logits)
            rec["end_to_end_tokens_identical"] = int((tokens == ref_toks).sum())
            t0 = time.perf_counter()
            rec.update(_layerwise(model, params, prompt))
            rec["layerwise_s"] = time.perf_counter() - t0
            if max(rec["layer_out_rel_err"], rec["layer_state_rel_err"]) > SERVE_REL:
                raise AssertionError(f"[serve] {arch}: a layer's prefill and decode forms "
                                     f"differ by more than {SERVE_REL}: {rec}")
        rec["tokens_total"] = tokens.numel()
        if not all(bool(torch.isfinite(x).all()) for x in (logits, ref_logits)):
            raise AssertionError(f"[serve] {arch}: logits not finite")
        if profile:
            rec["profile"] = _serve_profile(model, params, prompt, 16)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["phase_s"] = time.perf_counter() - t_start
    log("[serve] " + json.dumps({k: v for k, v in rec.items() if k != "profile"}))
    del params, cache, ref_cache
    torch.cuda.empty_cache()
    return rec


def phase_serve_parity(arch: str, prompt_len: int) -> dict:
    """The model cut to 2 layers at full width: the same seeded weights on
    the card (kernels) and on the CPU (plain versions)."""
    import numpy as np
    import torch

    model = _serve_model(arch, n_layers=2)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (SERVE_BATCH, prompt_len)))
    runs = {}
    with torch.inference_mode():
        for device in ("cuda", "cpu"):
            reset_counts()
            p = params if device == "cpu" else {n: t.cuda() for n, t in params.items()}
            runs[device] = _generate(model, p, prompt.to(device), SERVE_PARITY_GEN, True)
            counts = kernel_counts()
            launched = sum(c[0] for c in counts.values())
            plain = sum(c[1] for c in counts.values())
            if (device == "cuda") != (launched > 0) or (device == "cpu") != (plain > 0):
                raise AssertionError(f"[serve-parity] {arch} on {device}: {counts}")
    (lg, cg, tg, _), (lc, cc, tc, gaps) = runs["cuda"], runs["cpu"]
    rec = dict(arch=model.cfg.name, n_layers=2, batch=SERVE_BATCH, prompt_len=prompt_len,
               **_compare(f"serve-parity {arch}", lg.cpu(), cg, lc, cc, SERVE_PARITY_REL))
    tol = SERVE_PARITY_REL * float(lc.abs().max())
    rec["tokens_identical"] = _same_tokens(f"serve-parity {arch}", tg.cpu(), tc, gaps, tol)
    rec["tokens_total"] = tc.numel()
    log("[serve-parity] " + json.dumps(rec))
    return rec


# -- LM training: B.1 and B.6's backward, and the qwen2-0.5b trainer -------------

LM_ARCH = "qwen2_0_5b"
LM_NODES, LM_STEPS, LM_SEQ = 8, 20, 64       # train_lm's defaults; 20 steps
LM_LONG = (512, 4, 5)                       # seq, nodes, steps: multi-tile B.6 tiles
LM_PARITY = (2, 4, 3)                       # layers, nodes, steps: card vs CPU
BWD_REL = 1e-4            # B.6 backward vs autograd of the plain version, relative to max
STACKED_REL = 1e-6        # B.1 stacked (an FMA chain) vs the plain cuBLAS product
TRAIN_PARITY_REL = 1e-5   # 2-layer qwen2 on the card vs the CPU, relative to max |x|
UPDATE_REL = 1e-3         # the same runs' parameter updates, relative to the largest
                          # update of any leaf (a leaf whose own gradient nearly cancels,
                          # as the key bias's does, differs more relative to itself)


def gossip_bound(k: int, d: int, n: int | None, elt: int = 4) -> tuple[float, str]:
    """Least time of one B.1 call.  Per-node (n neighbours): theta, grad and
    the neighbours read and out written once, 2 n + 4 float operations per
    element.  Stacked (n None, K nodes): theta and grad read and out written
    once, W and the scales read once, 3 K D + 2 K^2 D operations."""
    if n is None:
        n_bytes, ops = 3 * k * d * elt + 4 * (k * k + k), 3 * k * d + 2 * k * k * d
    else:
        n_bytes, ops = (n + 3) * d * elt + 4 * (n + 2), (2 * n + 4) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bwd_bound(b, h, kvh, s, t, hd, causal, window) -> tuple[float, str, float]:
    """Least time of one B.6 backward call: q, o, dO, k, v and lse read and
    dq, dk, dv written once at the HBM rate, against 10 hd float operations
    per unmasked pair (the scores recomputed, then dO.v, dV, dQ and dK: five
    products of 2 hd each, FlashAttention-2's count), each taken as three
    TF32 products at the tensor cores' TF32 peak.  Returns (bound ms, "bytes"
    or "operations", the bound at the float32 FMA peak instead)."""
    n_bytes = 4 * (4 * b * h * s * hd + 4 * b * kvh * t * hd + b * h * s)
    return _attention_bound(n_bytes, 10 * b * h * hd * _pairs(s, t, causal, window))


def window_device_ms(fn, iters: int, windows: int = 3) -> float:
    """Device time (ms) of one ``fn()`` from every device entry the profiler
    records over ``iters`` calls (kernels, copies, fills), whatever its
    name: each entry's mean time per launch times its launches per call (its
    count over ``iters``, rounded), so a launch the profiler drops does not
    shorten the sum.  The median over ``windows`` windows."""
    per_call = []
    for _ in range(windows):
        _, prof = profiled(fn, iters)
        per_call.append(sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                            for e in device_events(prof.key_averages()) if e.count) / 1e3)
    return sorted(per_call)[windows // 2]


def sdpa_yardstick(q, k, v):
    """The fastest SDPA backend that takes these float32 inputs:
    EFFICIENT_ATTENTION, else MATH, each with K/V as they are (enable_gqa)
    or, where it refuses GQA, expanded over the query heads by
    repeat_interleave here, outside any timed window.  Returns (backend,
    its label, k and v as fed, enable_gqa)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[1] // k.shape[1]
    expanded = tuple(x.repeat_interleave(g, dim=1) for x in (k, v))
    feeds = [((k, v), True, ""), (expanded, False, ", K/V expanded")] if g > 1 \
        else [((k, v), False, "")]
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        for (kk, vv), gqa, how in feeds:
            try:
                with sdpa_kernel([backend]):
                    F.scaled_dot_product_attention(q, kk, vv, is_causal=True, enable_gqa=gqa)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            return backend, backend.name + how, kk, vv, gqa
    raise AssertionError("no SDPA backend takes float32 at this shape")


def _time_call(name, call, plain, iters, plain_iters, names=None) -> dict:
    return dict(ms=cuda_ms(call, iters=iters, warmup=2),
                plain_ms=cuda_ms(plain, iters=plain_iters, warmup=1),
                device_ms=device_ms(call, max(2, iters // 4), names or KERNELS[name][2]))


def phase_gossip_update_kernels(mlp_leaves) -> dict:
    """B.1 against its plain version: the per-node form on the reference's
    test cases (bit for bit), the stacked form at every fmnist leaf (K = 10)
    and every qwen2-0.5b leaf (K = 8), relative to max |out|.  Times one
    call per fmnist leaf (per-node: node 0's neighbours) and per qwen2 leaf
    (stacked)."""
    import numpy as np
    import torch

    from repro_torch.graphs import build_graph, metropolis_weights, ring_graph
    from repro_torch.kernels.gossip_update import kernel as gk
    from repro_torch.kernels.gossip_update import ref as gref

    gen = torch.Generator(device="cuda").manual_seed(77)
    out = {"gossip_update": dict(max_abs_err=0.0, rows=[]),
           "gossip_update_stacked": dict(max_abs_err=0.0, max_rel_err=0.0, rows=[])}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # per node: d in the reference's cases, n = 0..5, float32 and bfloat16
    for dtype in (torch.float32, torch.bfloat16):
        for d in (7, 64, 128, 1000, 131072):
            for n in range(6):
                theta, grad, nbrs = randn(d, dtype=dtype), randn(d, dtype=dtype), \
                    randn(n, d, dtype=dtype)
                w = torch.softmax(randn(n + 1), 0)
                s = torch.tensor(1.7, device="cuda")
                got = gk.gossip_update(theta, grad, nbrs, w, s, eta=0.05)
                want = gref.gossip_update_ref(theta, grad, nbrs, w, s, eta=0.05)
                err = float((got.float() - want.float()).abs().max())
                out["gossip_update"]["max_abs_err"] = max(out["gossip_update"]["max_abs_err"],
                                                          err)
                if not torch.equal(got, want):
                    raise AssertionError(f"[b1-kernel] gossip_update d={d} n={n} {dtype}: "
                                         f"kernel != plain (max abs err {err})")
    # per node at the fmnist leaves, node 0 of the paper's graph
    w_fm = metropolis_weights(build_graph("erdos_renyi", K, p=0.3, seed=0))
    nbr_ids = [j for j in range(K) if j != 0 and w_fm[0, j] > 0]
    w0 = torch.tensor([w_fm[0, 0]] + [w_fm[0, j] for j in nbr_ids], dtype=torch.float32,
                      device="cuda")
    for leaf, d in mlp_leaves:
        theta, grad, nbrs = randn(d), randn(d), randn(len(nbr_ids), d)
        s = torch.tensor(1.3, device="cuda")
        t = _time_call("gossip_update", lambda: gk.gossip_update(theta, grad, nbrs, w0, s, eta=0.1),
                       lambda: gref.gossip_update_ref(theta, grad, nbrs, w0, s, eta=0.1), 200, 50)
        bound, by = gossip_bound(1, d, len(nbr_ids))
        row = dict(group="mlp", leaf=leaf, d=d, n=len(nbr_ids), **t, bound_ms=bound, bound_by=by)
        out["gossip_update"]["rows"].append(row)
        log("[b1-kernel] per-node " + json.dumps(row))

    # stacked: every fmnist leaf (K = 10, the paper's W) and every qwen2 leaf (K = 8 ring)
    lm_shapes = {n: tuple(t.shape) for n, t in _serve_model(LM_ARCH).param_shapes().items()}
    cases = [("mlp", leaf, K, (d,), w_fm) for leaf, d in mlp_leaves]
    w_ring = metropolis_weights(ring_graph(LM_NODES))
    cases += [("qwen2", leaf, LM_NODES, shape, w_ring) for leaf, shape in sorted(lm_shapes.items())]
    for group, leaf, k, shape, w_np in cases:
        theta, grad = randn(k, *shape), randn(k, *shape)
        w = torch.from_numpy(np.asarray(w_np, np.float32)).cuda()
        s = torch.rand((k,), generator=gen, device="cuda") + 0.5
        got = gk.gossip_update_stacked(theta, grad, w, s, eta=0.01)
        want = gref.gossip_update_stacked_ref(theta, grad, w, s, eta=0.01)
        err, rel = float((got - want).abs().max()), _rel_err(got, want)
        rec = out["gossip_update_stacked"]
        rec["max_abs_err"], rec["max_rel_err"] = max(rec["max_abs_err"], err), \
            max(rec["max_rel_err"], rel)
        if rel > STACKED_REL:
            raise AssertionError(f"[b1-kernel] stacked {group} {leaf}: {rel} of max |out| "
                                 f"> {STACKED_REL}")
        del got, want
        big = theta.numel() > 1 << 26
        t = _time_call("gossip_update_stacked",
                       lambda: gk.gossip_update_stacked(theta, grad, w, s, eta=0.01),
                       lambda: gref.gossip_update_stacked_ref(theta, grad, w, s, eta=0.01),
                       10 if big else 100, 3 if big else 20)
        bound, by = gossip_bound(k, theta.numel() // k, None)
        row = dict(group=group, leaf=leaf, k=k, d=theta.numel() // k, max_rel_err=rel, **t,
                   bound_ms=bound, bound_by=by)
        rec["rows"].append(row)
        log("[b1-kernel] stacked " + json.dumps(row))
        del theta, grad
        torch.cuda.empty_cache()
    for name, rec in out.items():
        rec["per_step"] = {g: {key: sum(r[key] for r in rec["rows"] if r["group"] == g)
                               for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
                           for g in {r["group"] for r in rec["rows"]}}
        log(f"[b1-kernel] {name}: one call per leaf: " + json.dumps(rec["per_step"]))
    return out


def phase_flash_bwd_kernels() -> dict:
    """B.6's backward against autograd of the plain version at the forward's
    serving shapes and qwen2-0.5b's training shapes (S = T = 64 and 512),
    dq, dk and dv relative to their largest |value|; times the call, its
    kernels, the plain backward and SDPA's backward (never on the path)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(99)
    scrub = torch.empty(64 << 20, device="cuda")  # 256 MB written between cold calls: 5x L2
    cases = [  # tag, b, h, kvh, s, hd, window, softcap
        ("qwen2-0.5b train S 64", 2, 14, 2, 64, 64, None, None),
        ("qwen2-0.5b train S 512", 2, 14, 2, 512, 64, None, None),
        ("qwen2-0.5b prefill", 4, 14, 2, 512, 64, None, None),
        ("hd 80, window 4096", 2, 32, 8, 512, 80, 4096, None),
        ("hd 128, window 64, softcap 50", 2, 32, 16, 512, 128, 64, 50.0),
        ("G = 1", 2, 8, 8, 512, 64, None, None),
        ("ragged S = 300", 4, 14, 2, 300, 64, None, None),
    ]
    out = dict(max_abs_err=0.0, rows=[])
    for tag, b, h, kvh, s, hd, window, softcap in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
        k, v = (torch.randn((b, s, kvh, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
                for _ in range(2))
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        kw = dict(causal=True, window=window, softcap=softcap)
        o, lse = fk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        got = fk.flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ref_out = attention_ref(*leaves, **kw)
        want = torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)
        errs = {n: _rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        out["max_abs_err"] = max(out["max_abs_err"], abs_err)
        if max(errs.values()) > BWD_REL:
            raise AssertionError(f"[bwd-kernel] {tag}: {errs} (relative to max) > {BWD_REL}")

        def call():
            fk.flash_attention_bwd(q, k, v, o, lse, dout, **kw)

        def plain():
            torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)

        names = tuple(n for n in KERNELS["flash_attention_bwd"][2]
                      if h > kvh or n != "bwd_reduce_kernel")  # G = 1: no partials to sum
        def cold_call():  # inputs and code out of L2, as inside a training step
            scrub.zero_()
            call()

        t = _time_call("flash_attention_bwd", call, plain, 30, 5, names)
        bound, by, fp32_bound = flash_bwd_bound(b, h, kvh, s, s, hd, True, window)
        row = dict(case=tag, b=b, h=h, kvh=kvh, s=s, hd=hd, window=window, softcap=softcap,
                   rel_err=errs, max_abs_err=abs_err, **t,
                   cold_device_ms=device_ms(cold_call, 10, names), bound_ms=bound,
                   bound_by=by, fp32_bound_ms=fp32_bound, library_ms=None,
                   tma=need_tma(f"[bwd-kernel] {tag}", q=q, k=k, v=v, out=o, dout=dout))
        if window is None and softcap is None:  # the yardstick: SDPA's backward, contiguous
            qc, kc, vc = (x.detach().contiguous() for x in (q, k, v))
            backend, label, kf, vf, gqa = sdpa_yardstick(qc, kc, vc)
            leaves_s = [x.detach().clone().requires_grad_() for x in (qc, kf, vf)]
            with sdpa_kernel([backend]):
                sdpa = F.scaled_dot_product_attention(*leaves_s, is_causal=True, enable_gqa=gqa)

            def sdpa_bwd():
                return torch.autograd.grad(sdpa, leaves_s, dout, retain_graph=True)

            dqs, dks, dvs = sdpa_bwd()
            if not gqa and h > kvh:  # the expanded K/V's gradients, summed per KV head
                dks, dvs = (x.view(b, kvh, h // kvh, s, hd).sum(2) for x in (dks, dvs))
            if max(_rel_err(g, w) for g, w in zip((dqs, dks, dvs), want)) > 1e-3:
                raise AssertionError(f"[bwd-kernel] SDPA's backward disagrees ({tag})")
            row.update(library_ms=cuda_ms(sdpa_bwd, iters=30, warmup=2),
                       library_device_ms=window_device_ms(sdpa_bwd, 10), library_backend=label)
        out["rows"].append(row)
        log("[bwd-kernel] " + json.dumps(row))
    return out


# B.6's keys in the kernels line: besides the contract's, SDPA's device time
# and backend (its bound on the CUDA cores stays in the logged rows)
FLASH_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "library_device_ms", "library_backend")


def _lm_counts(nodes: int, steps: int, layers: int, leaves: int) -> dict:
    """Launches of one LM training run: B.6 forward and backward on every
    attention layer of every node, B.1 once per leaf, every step."""
    per = steps * nodes * layers
    return {"flash_attention_fwd": per, "flash_attention_bwd": per,
            "gossip_update_stacked": steps * leaves}


def _node_losses(trainer, state, batch) -> list:
    import torch

    with torch.no_grad():
        return trainer.loss_fn(state.params, (batch.to(trainer.device),)).tolist()


def phase_train_lm(seq: int, nodes: int, steps: int, profile: bool) -> dict:
    """qwen2-0.5b at full width and depth through the training CLI
    (``python -m repro_torch.launch.train --arch qwen2_0_5b``, train_lm's
    defaults otherwise), every launch counted; the first batch's loss before
    and after the run; the steady ms per step; optionally one profiled step."""
    import numpy as np
    import torch

    from repro_torch.data import make_node_token_streams
    from repro_torch.launch import train

    argv = ["--arch", LM_ARCH, "--steps", str(steps), "--seq-len", str(seq), "--nodes",
            str(nodes), "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer, state, history = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    model = _serve_model(LM_ARCH)
    cfg = model.cfg
    check_counts(f"train-lm S {seq} K {nodes}", counts,
                 _lm_counts(nodes, steps, cfg.n_layers, len(state.params)))
    peak = torch.cuda.max_memory_allocated() / 1e9
    first = torch.from_numpy(np.stack([s.next_batch(2, seq) for s in
                                       make_node_token_streams(nodes, cfg.vocab, seed=0)]))
    loss_end = _node_losses(trainer, state, first)
    walls = [r["wall_s"] for r in history]
    steady = np.diff(walls)[1:]  # from the second step on
    ms_step = 1e3 * float(np.median(steady))
    tokens = nodes * 2 * seq
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, params=model.num_params(),
               nodes=nodes, batch=2,
               seq_len=seq, steps=steps, wall_s=wall, ms_per_step=ms_step,
               ms_per_step_min=1e3 * float(steady.min()), tokens_per_step=tokens,
               tokens_per_s=tokens / (ms_step / 1e3), peak_memory_gb=peak,
               loss_first_step=history[0]["loss_mean"], loss_last_step=history[-1]["loss_mean"],
               first_batch_loss_before=history[0]["loss_mean"],
               first_batch_loss_after=float(np.mean(loss_end)),
               ln_vocab=math.log(cfg.vocab),
               launches={n: c[0] for n, c in counts.items() if c[0]})
    for r in history:
        for key in ("loss_mean", "loss_worst", "robust_objective", "comm_bytes", "disagreement"):
            if not math.isfinite(r[key]):
                raise AssertionError(f"[train-lm] step {r['step']}: {key} = {r[key]}")
    if not rec["first_batch_loss_after"] < rec["first_batch_loss_before"]:
        raise AssertionError(f"[train-lm] the loss did not fall: {rec}")
    if abs(rec["loss_first_step"] - rec["ln_vocab"]) > 1.5:
        raise AssertionError(f"[train-lm] a random model's loss should be near ln V: {rec}")
    batch = (first.cuda(),)
    box = [state]
    del state

    def one_step():
        box[0], _ = trainer.step(box[0], batch)

    # one more step, each B.6 call's views checked: the model's own layouts
    per_step = nodes * cfg.n_layers
    rec["tma_audit"] = tma_audit(one_step)
    if rec["tma_audit"] != {"fwd": per_step, "bwd": per_step}:
        raise AssertionError(f"[train-lm] the TMA audit saw {rec['tma_audit']} B.6 calls, "
                             f"not {per_step} of each")
    if profile:
        p_wall, prof = profiled(one_step, 1)
        avg = prof.key_averages()
        dev = device_events(avg)
        busy_us = sum(e.self_device_time_total for e in dev)
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
        b6 = {name: sum(e.self_device_time_total for e in device_events(avg, *KERNELS[name][2]))
              / 1e3 for name in ("flash_attention_fwd", "flash_attention_bwd")}
        # the backward's launches in the step, against the bwd-kernel phase's
        # warm and cold calls at the same shape
        mma = sorted(launch_us(prof, "bwd_mma_kernel"))
        rec["profile"] = dict(wall_ms=1e3 * p_wall, device_busy_ms=busy_us / 1e3,
                              device_busy_share=busy_us / 1e6 / p_wall,
                              b6_fwd_device_ms=b6["flash_attention_fwd"],
                              b6_bwd_device_ms=b6["flash_attention_bwd"],
                              bwd_mma_us=dict(launches=len(mma), min=mma[0],
                                              median=mma[len(mma) // 2], max=mma[-1]),
                              bwd_reduce_us_mean=float(np.mean(
                                  launch_us(prof, "bwd_reduce_kernel"))),
                              device_ops=sum(e.count for e in dev),
                              top=[(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count)
                                   for e in top])
        log("[train-lm] profile of one step: " + json.dumps(rec["profile"]))
    del box
    log("[train-lm] " + json.dumps({k: v for k, v in rec.items() if k != "profile"}))
    del trainer
    torch.cuda.empty_cache()
    return rec


def phase_train_parity(spec_cls) -> dict:
    """qwen2-0.5b cut to 2 layers at full width, K = 4, 3 steps of
    train_lm's stack: the same seeded weights and tokens on the card
    (kernels) and on the CPU (plain versions): per-step losses and every
    final leaf relative to its largest |value|, and the updates relative to
    the largest |update|.  Then, on the card, one fused step against the
    unfused step (the optimizer and the mixer called directly) from the same
    state."""
    import numpy as np
    import torch

    from repro_torch.data import make_node_token_streams
    from repro_torch.models import make_lm_loss
    from repro_torch.optim import Optimizer, sgd

    layers, nodes, steps = LM_PARITY
    model = _serve_model(LM_ARCH, layers)
    params = model.init(torch.Generator().manual_seed(0))
    streams = make_node_token_streams(nodes, model.cfg.vocab, seed=0)
    batches = (np.stack([np.stack([s.next_batch(2, LM_SEQ) for s in streams])
                         for _ in range(steps)]),)

    def trainer_on(device, optimizer=None):
        spec = spec_cls(num_nodes=nodes, graph="ring", lr=0.01, grad_clip=1.0, device=device)
        return spec.build(make_lm_loss(model), optimizer=optimizer)

    runs = {}
    for device in ("cuda", "cpu"):
        trainer = trainer_on(device)
        reset_counts()
        t0 = time.perf_counter()
        state, ms = trainer.run(trainer.init(params), batches)
        runs[device] = ({n: t.cpu() for n, t in state.params.items()}, ms["loss_mean"].cpu(),
                        time.perf_counter() - t0)
        counts = kernel_counts()
        if device == "cuda":
            check_counts("train-parity", counts,
                         _lm_counts(nodes, steps, layers, len(state.params)))
        elif sum(c[0] for c in counts.values()) or not sum(c[1] for c in counts.values()):
            raise AssertionError(f"[train-parity] the CPU run launched a kernel: {counts}")
        del state
    (p_g, l_g, s_g), (p_c, l_c, s_c) = runs["cuda"], runs["cpu"]
    init = {n: t.unsqueeze(0) for n, t in params.items()}
    leaf_rel = max(_rel_err(p_g[n], p_c[n]) for n in p_c)
    upd_g, upd_c = ({n: p[n] - init[n] for n in p_c} for p in (p_g, p_c))
    largest = max(float(u.abs().max()) for u in upd_c.values())
    update_rel = max(float((upd_g[n] - upd_c[n]).abs().max()) for n in p_c) / largest
    own = {n: _rel_err(upd_g[n], upd_c[n]) for n in p_c}
    worst = max(own, key=own.get)
    loss_rel = float(((l_g - l_c).abs() / l_c.abs()).max())
    rec = dict(arch=model.cfg.name, n_layers=layers, nodes=nodes, steps=steps,
               loss_rel_err=loss_rel, leaf_rel_err=leaf_rel, update_rel_err=update_rel,
               worst_leaf_update_rel_err=(worst, own[worst]), card_s=s_g, cpu_s=s_c)
    if not (loss_rel <= TRAIN_PARITY_REL and leaf_rel <= TRAIN_PARITY_REL
            and update_rel <= UPDATE_REL):
        raise AssertionError(f"[train-parity] card vs CPU outside tolerance: {rec}")

    # fused (B.1) against unfused from the same state, on the card
    opt = sgd(0.01)
    fused, unfused = trainer_on("cuda", opt), trainer_on("cuda", Optimizer(opt.init, opt.update))
    batch = tuple(torch.from_numpy(b[0]) for b in batches)
    outs = []
    for trainer in (fused, unfused):
        reset_counts()
        state, m = trainer.step(trainer.init(params), batch)
        outs.append((state.params, m, kernel_counts()))
    (pf, mf, cf), (pu, mu, cu) = outs
    if cf["gossip_update_stacked"][0] != len(pf) or cu["gossip_update_stacked"][0] != 0:
        raise AssertionError(f"[train-parity] fused {cf} / unfused {cu} launches of B.1")
    rec["fused_vs_unfused_rel_err"] = max(_rel_err(pf[n], pu[n]) for n in pf)
    rec["fused_vs_unfused_bitwise_leaves"] = sum(bool(torch.equal(pf[n], pu[n])) for n in pf)
    rec["fused_vs_unfused_metric_rel_err"] = max(
        float((mf[k] - mu[k]).abs() / mu[k].abs().clamp_min(1e-30)) for k in mf)
    rec["leaves"] = len(pf)
    log("[train-parity] " + json.dumps(rec))
    if rec["fused_vs_unfused_rel_err"] > STACKED_REL:
        raise AssertionError(f"[train-parity] fused vs unfused: {rec}")
    del outs, pf, pu, fused, unfused
    torch.cuda.empty_cache()
    return rec


def phase_gossip_update_nodes(spec_cls) -> dict:
    """The per-node form's path: one fmnist dense DR-DSGD step recomputed
    node by node through ``gossip_update_tree`` (node i combines its own
    update with its neighbours' updated parameters, Alg. 2 lines 3-4) and
    held against the fused step's output, row by row."""
    import torch

    from repro_torch.core.robust import robust_scale
    from repro_torch.kernels.gossip_update.ops import gossip_update_tree
    from repro_torch.models import make_classifier_loss, mlp_apply

    exp, fed, batches, params = _fmnist()
    trainer = _spec(spec_cls, exp, "none").build(make_classifier_loss(mlp_apply), mlp_apply)
    state = trainer.init(params)
    batch = tuple(torch.from_numpy(b[0]).cuda() for b in batches)
    names = sorted(state.params)
    leaves = [state.params[n].detach().requires_grad_(True) for n in names]
    losses = trainer.loss_fn(dict(zip(names, leaves)), batch)
    grads = dict(zip(names, torch.autograd.grad(losses.sum(), leaves)))
    scale = robust_scale(losses.detach(), trainer.robust)
    w = trainer.mixer.w
    eta = exp.lr
    updated = {n: state.params[n] - eta * (grads[n] * scale.reshape((-1,) + (1,) * (
        grads[n].ndim - 1))) for n in names}  # what each node sends (Alg. 2 line 3)
    reset_counts()
    rows = []
    for i in range(K):
        nbrs = [j for j in range(K) if j != i and float(w[i, j]) > 0]
        weights = torch.stack([w[i, i]] + [w[i, j] for j in nbrs])
        rows.append(gossip_update_tree({n: state.params[n][i] for n in names},
                                       {n: grads[n][i] for n in names},
                                       [{n: updated[n][j] for n in names} for j in nbrs],
                                       weights, scale[i], eta=eta))
    torch.cuda.synchronize()
    counts = kernel_counts()
    check_counts("b1-nodes", counts, {"gossip_update": K * len(names)})
    fused, _ = trainer.step(state, batch)
    err = max(_rel_err(torch.stack([r[n] for r in rows]), fused.params[n]) for n in names)
    rec = dict(nodes=K, leaves=len(names), launches=counts["gossip_update"][0],
               rel_err_vs_fused_step=err)
    log("[b1-nodes] " + json.dumps(rec))
    if err > STACKED_REL:
        raise AssertionError(f"[b1-nodes] per-node B.1 vs the fused step: {err}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.comm import CompressionConfig
    from repro_torch.core import TrainerSpec
    from repro_torch.models import cnn_init, mlp_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)}; {smi}; "
        f"TF32 off for matmul and cuDNN")
    t_start = time.perf_counter()
    phase_build()
    g = torch.Generator().manual_seed(0)
    mlp = leaf_dims(mlp_init(g))
    cnn = leaf_dims(cnn_init(g))
    kern = phase_kernel(mlp, cnn)
    b1 = phase_gossip_update_kernels(mlp)
    fm, dense_params = phase_fmnist(TrainerSpec, CompressionConfig)
    b1_nodes = phase_gossip_update_nodes(TrainerSpec)
    gossip = phase_gossip(TrainerSpec, CompressionConfig, dense_params)
    phase_profile(TrainerSpec, CompressionConfig)
    phase_cifar(TrainerSpec, CompressionConfig)
    phase_parity(TrainerSpec, CompressionConfig)
    log(f"[done] paper training phases in {time.perf_counter() - t_start:.1f} s")
    bwd = phase_flash_bwd_kernels()
    lm = phase_train_lm(LM_SEQ, LM_NODES, LM_STEPS, profile=True)
    phase_train_lm(*LM_LONG, profile=False)
    phase_train_parity(TrainerSpec)
    log(f"[done] training phases in {time.perf_counter() - t_start:.1f} s")
    serve_kern = phase_serve_kernels()
    qwen = phase_serve("qwen2_0_5b", 512, 64, "flash_attention_fwd", profile=True,
                       end_to_end=True)
    rwkv = phase_serve("rwkv6_7b", 256, 32, "wkv6_scan", profile=False, end_to_end=False)
    phase_serve_parity("qwen2_0_5b", 64)
    phase_serve_parity("rwkv6_7b", 32)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    # launches on each kernel's main path: B.2 the dense int8 fmnist run,
    # B.3 the static EF gossip run, B.4/B.5 the memoryless dropout run
    path = {"quantize_blockwise": fm["int8-kernel"]["launches"],
            "dequant_accumulate": gossip["gossip-int8-kernel-ef"]["launches"],
            "masked_quantize_blockwise": gossip["dropout0.2-int8-kernel-memoryless"]["launches"],
            "masked_dequant_accumulate":
                gossip["dropout0.2-int8-kernel-memoryless"]["launches"]}
    # B.1 per node: its own path (b1-nodes); stacked and B.6's backward:
    # the qwen2-0.5b training run
    path["gossip_update"] = {"gossip_update": b1_nodes["launches"]}
    for name in ("gossip_update_stacked", "flash_attention_bwd"):
        path[name] = {name: lm["launches"][name]}
    lines = []
    for name, (source, replaces, _) in KERNELS.items():
        if name.startswith("gossip_update"):
            # one call per leaf: the fmnist MLP's (per node), qwen2-0.5b's (stacked)
            rows = [r for r in b1[name]["rows"]
                    if r["group"] == ("mlp" if name == "gossip_update" else "qwen2")]
            step = b1[name]["per_step"][rows[0]["group"]]
            timing = dict(ms=step["ms"], device_ms=step["device_ms"], plain_ms=step["plain_ms"],
                          bound_ms=step["bound_ms"],
                          bound_by="bytes" if {r["bound_by"] for r in rows} == {"bytes"}
                          else "operations", library_ms=None)
            err, launches = b1[name]["max_abs_err"], path[name][name]
        elif name == "flash_attention_bwd":  # one call at qwen2-0.5b's training shape
            row = bwd["rows"][0]
            timing = {key: row.get(key) for key in FLASH_KEYS}
            err, launches = bwd["max_abs_err"], path[name][name]
        elif name in QUANT:
            step = kern[name]["per_step"]["mlp"]
            bound_by = {r["bound_by"] for r in kern[name]["rows"] if r["group"] == "mlp"}
            # one call per leaf of the fmnist MLP at the main path's shapes
            timing = dict(ms=step["ms"], device_ms=step["device_ms"], plain_ms=step["plain_ms"],
                          bound_ms=step["bound_ms"],
                          bound_by="bytes" if bound_by == {"bytes"} else "operations",
                          library_ms=None)
            err, launches = kern[name]["max_abs_err"], path[name][name]
        else:  # one call at the main path's shapes: qwen2-0.5b / rwkv6-7b prefill
            row = serve_kern[name]["rows"][0]
            timing = {key: row.get(key) for key in (
                FLASH_KEYS if name == "flash_attention_fwd" else FLASH_KEYS[:6])}
            err = serve_kern[name]["max_abs_err"]
            launches = (qwen if name == "flash_attention_fwd" else rwkv)["launches"]
        # ms is the wrapper's call time back to back (host launch cost
        # included), device_ms the kernels' own time under the profiler
        lines.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": launches, "max_abs_err": err, **timing})
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
