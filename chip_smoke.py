"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the paper's DR-DSGD trainer (Algorithm 2)
over the dense lowering, and over the gossip lowering on a static and a
time-varying topology — on the card through their user entry points, and
holds every CUDA kernel of those paths against its plain PyTorch version:

  build    nvcc-compiles the kernels of the paths from src/ (one nvcc per
           source, started together).
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
  fmnist   TrainerSpec -> DecentralizedTrainer at the paper's configuration
           (K = 10, ER(p = 0.3) seed 0, Metropolis W, mu = 6, T = 300,
           lr = sqrt(K/T), B = 55, MLP 784-128-64-10): DR-DSGD with the
           uncompressed dense wire, then with the int8 error-feedback wire
           served by the CUDA quantizer; kernel launches must be 300 x 6
           leaves and no plain version called.
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

TF32 is off for matmul and cuDNN throughout, so float32 means float32.
Weights come from the port's own seeded init, written to and read back
from a .npz.  Any failed phase raises (non-zero exit, no result line).
The last stdout line is the device record
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}; the
line before it is the card's name and power limit from nvidia-smi, and the
line before that the kernels record.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
K = 10
CIFAR_STEPS = 50
CIFAR_GOSSIP_STEPS = 20
CIFAR_GRAD_CLIP = 2.0      # the repo's CIFAR benchmark setting (see phase_cifar)
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
SRC = "src/repro_torch/kernels/quant_gossip/csrc/"
TPU = "src/repro/kernels/quant_gossip/kernel.py:"
# kernel -> (source, the TPU kernel's pallas_call, the CUDA kernels' names)
KERNELS = {
    "quantize_blockwise": (SRC + "quantize.cu", TPU + "98",
                           ("absmax_kernel", "quantize_kernel")),
    "dequant_accumulate": (SRC + "accumulate.cu", TPU + "125", ("dequant_acc_kernel",)),
    "masked_quantize_blockwise": (SRC + "quantize.cu", TPU + "154",
                                  ("absmax_kernel", "quantize_kernel")),
    "masked_dequant_accumulate": (SRC + "accumulate.cu", TPU + "187",
                                  ("dequant_acc_kernel",)),
}


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
    call.  Returns (wall seconds, the profiler's key averages)."""
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
    return wall, prof.key_averages()


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


def kernel_counts() -> dict:
    """Launches of each kernel and calls of each plain version since the
    last :func:`reset_counts`."""
    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ops as qops

    return {name: (getattr(qk, name).launches, getattr(qops, name).plain_calls)
            for name in KERNELS}


def reset_counts() -> None:
    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ops as qops

    for name in KERNELS:
        getattr(qk, name).launches = 0
        getattr(qops, name).plain_calls = 0


def check_counts(tag: str, counts: dict, want: dict) -> None:
    """Every kernel launched exactly ``want[name]`` times (0 when absent),
    and no plain version called."""
    for name, (launches, plain) in counts.items():
        if launches != want.get(name, 0) or plain != 0:
            raise AssertionError(f"[{tag}] {name}: {launches} launches and {plain} plain "
                                 f"calls, want {want.get(name, 0)} launches and none")


def phase_build() -> None:
    from repro_torch.kernels.quant_gossip import kernel as qk

    t0 = time.perf_counter()
    built = qk.build()
    log(f"[build] {', '.join(lib.name for lib, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for source, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {source}: {line.strip()}")


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
    out = {name: dict(max_abs_err=0.0, rows=[]) for name in KERNELS}

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
            _, avg = profiled(call, 50)
            dev_ms = device_us_per_call(avg, KERNELS[name][2]) / 1e3
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
        check_counts(f"fmnist {wire}", counts, {"quantize_blockwise": exp.steps * 6}
                     if wire == "int8-kernel" else {})
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

        wall, avg = profiled(steps, 1)
        dev = device_events(avg)
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
    fm, dense_params = phase_fmnist(TrainerSpec, CompressionConfig)
    gossip = phase_gossip(TrainerSpec, CompressionConfig, dense_params)
    phase_profile(TrainerSpec, CompressionConfig)
    phase_cifar(TrainerSpec, CompressionConfig)
    phase_parity(TrainerSpec, CompressionConfig)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    # launches on each kernel's main path: B.2 the dense int8 fmnist run,
    # B.3 the static EF gossip run, B.4/B.5 the memoryless dropout run
    path = {"quantize_blockwise": fm["int8-kernel"]["launches"],
            "dequant_accumulate": gossip["gossip-int8-kernel-ef"]["launches"],
            "masked_quantize_blockwise": gossip["dropout0.2-int8-kernel-memoryless"]["launches"],
            "masked_dequant_accumulate":
                gossip["dropout0.2-int8-kernel-memoryless"]["launches"]}
    lines = []
    for name, (source, replaces, _) in KERNELS.items():
        step = kern[name]["per_step"]["mlp"]
        bound_by = {r["bound_by"] for r in kern[name]["rows"] if r["group"] == "mlp"}
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path[name][name],
            "max_abs_err": kern[name]["max_abs_err"],
            # one call per leaf of the fmnist MLP at the main path's shapes:
            # ms is the wrapper's call time back to back (host launch cost
            # included), device_ms the kernels' own time under the profiler
            "ms": step["ms"], "device_ms": step["device_ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
