"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the paper's DR-DSGD trainer (Algorithm 2)
over the dense lowering, and over the gossip lowering on a static and a
time-varying topology, decentralized LM training, and static-batch LM
serving (prefill, then greedy decode) — on the card through their user
entry points, and holds every CUDA kernel of those paths against its plain
PyTorch version:

  build    nvcc-compiles every kernel source under src/ (one nvcc per
           source, all five started together), and proves from cuobjdump's
           SASS that each of B.6's product kernels, at every head dim, runs
           TF32 tensor-core instructions (HMMA/HGMMA .TF32).
  kernel   the four quant_gossip kernels against their plain versions at
           every leaf shape of the paper's MLP and CNN with K = 10 and at
           three multi-block layouts: quantize_blockwise (B.2) at qmax 127
           and 7, masked_quantize_blockwise (B.4) with masks all ones, all
           zeros and mixed, dequant_accumulate (B.3) and
           masked_dequant_accumulate (B.5, every mask pattern) with src None
           and each matching of the fmnist graph (B.2, B.3, B.4 and B.5
           per leaf are one-leaf groups of the grouped kernels).  Payloads
           and accumulations must be equal bit for bit.  Times a call of each
           (CUDA events), its kernels' device time (profiler), the plain
           version, and the memory bound.  Then the grouped B.2, B.3, B.4
           and B.5 (one launch over every leaf of a round or matching, B.4
           as thread-block clusters, B.2 as B.4's kernel and B.3 as B.5's
           with no mask) against the one-leaf plain versions bit for bit:
           the MLP's 6 leaves, the CNN's 12, the three layouts as groups
           and a group of 20 leaves (over the cap: 2 launches), every
           mask, src and qmax; and a grouped call timed
           against the one-leaf calls of every leaf of the MLP and of the
           CNN, in turns, with the cluster size and the leaf cap as built.
  b1-kernel  the gossip update (B.1) against its plain version: the
           per-node form on the reference's test cases (d 7 .. 131072, 0-5
           neighbours, float32 and bfloat16) bit for bit, the node-stacked
           form at every fmnist leaf (K = 10) and every qwen2-0.5b leaf
           (K = 8) within STACKED_REL of max |out|; times one call per leaf.
           Then the grouped stacked form (one launch over every leaf) at
           both leaf sets: equal to the one-leaf kernel bit for bit, timed
           against the one-leaf calls of every leaf, in turns.
  fmnist   TrainerSpec -> DecentralizedTrainer at the paper's configuration
           (K = 10, ER(p = 0.3) seed 0, Metropolis W, mu = 6, T = 300,
           lr = sqrt(K/T), B = 55, MLP 784-128-64-10): DR-DSGD with the
           uncompressed dense wire (SGD and the static W fused into B.1,
           one grouped launch per step over every leaf: 300 launches), then
           with the int8 error-feedback wire served by the CUDA quantizer
           (one grouped B.2 launch per round: 300); no plain version
           called; both must print the per-leaf launches' loss_step300,
           acc_worst_dist and acc_avg to the bit (PER_LEAF_DENSE).
  b1-nodes one fmnist dense step recomputed node by node through
           gossip_update_tree (B.1's per-node form, 10 x 6 launches) and
           held against the fused step; and (b1-leaves) its stacked update
           leaf by leaf through gossip_update_stacked (6 launches), equal
           bit for bit to one grouped call.
  gossip   the same configuration over the gossip lowering (a pre-built
           mixer handed to TrainerSpec.build, as the reference's benchmarks
           do), 300 steps on each of four stacks: uncompressed static gossip
           (params within 1e-5 of the dense run's after 20 steps, 1e-3 after
           300: the two sum in another order), the static int8 EF
           wire (grouped B.2 once per round: 300 launches, and grouped B.3
           once per matching: 300 x 5; it must print
           the per-leaf B.3 wire's loss_step300, acc_worst_dist and acc_avg
           to the bit, PER_LEAF_TRAJECTORIES), and dropout p = 0.2 with the
           memoryless masked
           int8 wire (grouped B.4 + B.5: 300 x 5 launches each) and the EF
           wire re-based every 4 rounds (grouped B.4 once per round, B.5
           once per matching of a delta round); every count of launches is
           checked, and both dropout stacks must print the one-leaf
           wire's loss_step300, acc_worst_dist and acc_avg to the bit
           (ONE_LEAF_TRAJECTORIES).  Then the CNN
           (cifar_default, clipped at norm 2) on the static int8 EF gossip
           wire for 20 steps with cuDNN held deterministic, so B.3 runs on
           512,000-wide rows; its losses must be the per-leaf B.3 wire's to
           the bit (PER_LEAF_CIFAR).
  b45-leaves  one memoryless dropout round on the fmnist MLP through the
           mixer (grouped B.4/B.5, 5 launches each) and leaf by leaf through
           masked_quant_gossip_round (the one-leaf calls, 6 x 5 launches
           each): equal bit for bit.
  b3-leaves  two static int8 EF rounds on the fmnist MLP through the mixer
           (grouped B.3, 5 launches each) and with the quantizer's grouped
           call hidden (the one-leaf B.3, 6 x 5 launches each): θ, θ̂ and
           the mix cache equal bit for bit.
  b2-leaves  two dense int8 EF rounds on the fmnist MLP through the mixer
           (grouped B.2, one launch each) and with the wire's grouped call
           hidden (the one-leaf B.2, 6 launches each): θ and θ̂ equal bit
           for bit.
  profile  30 fmnist steps of four stacks under torch.profiler: the
           device's busy share and the kernels that take its time.
  cifar    the CNN (K = 10, p = 0.5, gradients clipped at norm 2 as in the
           repo's CIFAR benchmark), dense int8-kernel wire, 50 steps; losses
           finite, launches must be 50 (one grouped B.2 over the 12 leaves
           per round).
  parity   20 uncompressed dense fmnist steps on the card vs the port on the
           CPU, and 20 steps of the dense int8-kernel wire and of the three
           compressed gossip stacks vs the CPU's plain versions with the
           same uniforms and W_r, at the printed tolerances.
  codecs   fig7's fmnist task (K = 8 ring, Metropolis W, DR-DSGD mu = 3, B =
           55, lr 0.18, 400 steps, clipped at 2 as the figure's runner
           clips, lr_compensate off): dense none (fused B.1), bf16, int8,
           int4, topk 2 % (EF, default gamma) and int8 on the kernel (B.2
           once per round), gossip topk and randk 2 % over the ring's
           matchings; the CNN (B = 40, lr 0.05) with int4 and topk 2 %, cut
           to CIFAR_STEPS steps.  Each prints worst-distribution accuracy,
           total comm bytes and the median ms per step; each must lower its
           first batch's loss, keep every metric finite, bill each round the
           port's own accounting and launch what its wire launches.
  schedules  fig8: B.2 grouped with qmax a 0-d tensor on the card equal to
           the float form and the plain version bit for bit (qmax 127, 7,
           42.5; the MLP's and the CNN's leaves) and timed beside it; the
           linear rate on the card equal to hi + (lo - hi)·min(r/300, 1);
           14 rounds of each scheduled kernel stack (dense and gossip EF,
           adaptive and linear) against the CPU with the same uniforms; one
           scheduled round synchronising no more than an unscheduled one
           (CUDA's sync debug mode); then 600 fmnist steps of int8_fixed,
           int4_fixed, int8_adaptive (threshold 1, warmup 10) and
           int8_linear (anneal 300) on the per-node quantizer, and of
           int8_adaptive and int8_linear on the kernel quantizer over the
           dense and the gossip EF lowering (B.2 with the rate as qmax once
           per round: every launch counted as a tensor-qmax launch), each
           printing its rate at rounds 0, 10 and the last, its wire bits and
           worst-distribution accuracy.
  bwd-kernel  B.6's backward against autograd of the plain version at
           qwen2-0.5b's training shapes (B 2, H 14/2, hd 64, S = T = 64 and
           512) and at the serving shapes below, dq, dk and dv within
           BWD_REL of their largest |value|; times as below, with SDPA's
           backward as the yardstick (never on the path): its backend
           pinned (sdpa_yardstick), timed as a call and as device time.
  train-lm qwen2-0.5b at full width and depth through the training CLI
           (train_lm's defaults: K = 8 ring, batch 2, seq 64, lr 0.01, clip
           1), 20 steps: B.6 forward and backward 24 x 8 per step, grouped
           B.1 once per step over the 14 leaves, no plain call; every
           metric finite, the first batch's loss lower after the run, ms
           per step, tokens per second, peak memory, one profiled step
           (with B.6's device time in it).  Then seq 512 at K = 4, 5 steps
           (multi-tile B.6 backward).
  train-parity  qwen2-0.5b cut to 2 layers at full width, K = 4, 3 steps:
           the same weights and tokens on the card and on the CPU, losses
           and every leaf within TRAIN_PARITY_REL, updates within
           UPDATE_REL; one fused step (B.1) against the unfused step from
           the same state on the card.
  serve-kernel  flash attention (B.6) at qwen2-0.5b's prefill and training
           shapes, at hd 80 and 128 with windows 4096 and 64 and gemma2's
           softcap 50, at G = 1 and at a ragged S = 300; the WKV6 scan (B.7)
           at rwkv6-7b's shapes (random and init decays), at T = 100, at T =
           1 from a given state, at hd 16, with w = 1e-6 and on rows off 16
           bytes (plain loads, not TMA; WKV6_CASES), y and the final state;
           both against their plain versions at rtol 2e-5 (B.7's atol scaled
           by max |y|, see SERVE_TOL).  Times each
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
    # B.2, B.3, B.4 and B.5: two kernels (B.2 is B.4's without a mask, B.3
    # B.5's), called per leaf (a one-leaf group) or over every leaf of a
    # round or matching (the grouped entry points, the path)
    "quantize_blockwise": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                           TPU + "quant_gossip/kernel.py:98",
                           ("masked_quantize_grouped_kernel",)),
    "dequant_accumulate": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                           TPU + "quant_gossip/kernel.py:125",
                           ("masked_dequant_acc_grouped_kernel",)),
    "masked_quantize_blockwise": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                                  TPU + "quant_gossip/kernel.py:154",
                                  ("masked_quantize_grouped_kernel",)),
    "masked_dequant_accumulate": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                                  TPU + "quant_gossip/kernel.py:187",
                                  ("masked_dequant_acc_grouped_kernel",)),
    "masked_quantize_blockwise_grouped": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                                          TPU + "quant_gossip/kernel.py:154",
                                          ("masked_quantize_grouped_kernel",)),
    "masked_dequant_accumulate_grouped_": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                                           TPU + "quant_gossip/kernel.py:187",
                                           ("masked_dequant_acc_grouped_kernel",)),
    "dequant_accumulate_grouped_": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                                    TPU + "quant_gossip/kernel.py:125",
                                    ("masked_dequant_acc_grouped_kernel",)),
    "quantize_blockwise_grouped": (SRC + "quant_gossip/csrc/masked_grouped.cu",
                                   TPU + "quant_gossip/kernel.py:98",
                                   ("masked_quantize_grouped_kernel",)),
    "flash_attention_fwd": (SRC + "flash_attention/csrc/flash_fwd.cu",
                            TPU + "flash_attention/kernel.py:100", ("flash_fwd_mma_kernel",)),
    "wkv6_scan": (SRC + "rwkv6_scan/csrc/wkv6.cu", TPU + "rwkv6_scan/kernel.py:65",
                  ("wkv6_keysplit_kernel",)),
    "gossip_update": (SRC + "gossip_update/csrc/gossip_update.cu",
                      TPU + "gossip_update/kernel.py:54", ("gossip_update_kernel",)),
    # B.1 stacked: one kernel, called per leaf (a one-leaf group) or over
    # every leaf of a step (the grouped entry point, the path)
    "gossip_update_stacked": (SRC + "gossip_update/csrc/gossip_update.cu",
                              TPU + "gossip_update/kernel.py:54",
                              ("gossip_update_stacked_grouped_kernel",)),
    "gossip_update_stacked_grouped": (SRC + "gossip_update/csrc/gossip_update.cu",
                                      TPU + "gossip_update/kernel.py:54",
                                      ("gossip_update_stacked_grouped_kernel",)),
    # the backward of B.6: the reference differentiates its XLA attention
    "flash_attention_bwd": (SRC + "flash_attention/csrc/flash_bwd.cu",
                            TPU + "flash_attention/kernel.py:100",
                            ("bwd_mma_kernel", "bwd_reduce_kernel")),
}
QUANT = tuple(KERNELS)[:8]   # the quant_gossip wrappers
GROUPED = QUANT[4:]
ONE_LEAF = {"masked_quantize_blockwise_grouped": "masked_quantize_blockwise",
            "masked_dequant_accumulate_grouped_": "masked_dequant_accumulate",
            "dequant_accumulate_grouped_": "dequant_accumulate",
            "quantize_blockwise_grouped": "quantize_blockwise"}
# (loss_step300, acc_worst_dist, acc_avg) that these stacks printed on an
# H100 in four runs of the one-leaf masked wire, to the bit: the grouped
# wire changes no bit
ONE_LEAF_TRAJECTORIES = {
    "dropout0.2-int8-kernel-memoryless": (0.40981656312942505, 0.5399999618530273,
                                          0.7120000123977661),
    "dropout0.2-int8-kernel-ef-B4": (0.43094539642333984, 0.39499998092651367,
                                     0.7059999704360962),
}
# the same three of the static int8 EF stack, which the per-leaf B.3 printed
# on an H100 in two runs of one call: grouped B.3 changes no bit
PER_LEAF_TRAJECTORIES = {
    "gossip-int8-kernel-ef": (0.4425765573978424, 0.5349999666213989, 0.7104999423027039),
}
# the same three of the fmnist dense runs, uncompressed (the fused step,
# B.1 once per leaf) and int8 EF (B.2 once per leaf), which the parent
# printed on an H100 in two runs of one call: grouped B.1 and B.2 change no
# bit
PER_LEAF_DENSE = {
    "none": (0.4424481987953186, 0.5299999713897705, 0.7099999189376831),
    "int8-kernel": (0.442539781332016, 0.5349999666213989, 0.7104999423027039),
}
# (loss_step0, loss_last, loss_worst_max) of the CIFAR static EF gossip run
# (20 steps) through the per-leaf B.3 with cuDNN held deterministic, the
# same in two runs of one call on an H100; without that cuDNN's convolution
# backward moves loss_last between runs (1.733568549156189, 1.73506760597229)
PER_LEAF_CIFAR = (2.761140823364258, 1.7332394123077393, 3.964625358581543)


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


def device_ms(fn, iters: int, names, tries: int = 6) -> float:
    """Device time (ms) of one ``fn()`` that launches each kernel of
    ``names`` once, under the profiler.  The profiler now and then records
    no launch of a kernel at all (seen on the H100, once three windows in
    a row); the window is then profiled again, up to ``tries`` times."""
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
    out["gossip_update_stacked_grouped"] = (gk.gossip_update_stacked_grouped,
                                            gops.gossip_update_stacked_grouped)
    # B.6's dispatcher counts the plain version's calls of both directions
    out["flash_attention_bwd"] = (fk.flash_attention_bwd, fops.flash_attention)
    return out


def kernel_counts() -> dict:
    """Launches of each kernel and calls of each plain version since the
    last :func:`reset_counts`."""
    return {name: (k.launches, o.plain_calls) for name, (k, o) in _counters().items()}


def reset_counts() -> None:
    from repro_torch.kernels.quant_gossip import kernel as qk

    for k, o in _counters().values():
        k.launches = 0
        o.plain_calls = 0
    qk.quantize_blockwise_grouped.tensor_qmax_launches = 0


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
    out = {name: dict(max_abs_err=0.0, rows=[]) for name in QUANT[:4]}

    def expect_equal(name, what, got, want):
        err = max(_max_diff(g, w) for g, w in zip(got, want))
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
    out.update(_grouped_kernels(mlp_leaves, cnn_leaves, fmnist_srcs, gen))
    return out


def _max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# the layout cases as groups: (K, widths, block_d), each mixing layouts
GROUP_LAYOUTS = {"2 blocks": (K, [131072, 100352, 10], 65536),
                 "block 128": (16, [4096, 1000, 128, 7], 128),
                 "ragged": (3, [1000, 256, 3], 256)}


def _grouped_kernels(mlp_leaves, cnn_leaves, fmnist_srcs, gen) -> dict:
    """B.2, B.3, B.4 and B.5 over every leaf of a group, one launch per
    MAX_GROUP_LEAVES leaves, against the one-leaf plain versions bit for
    bit: the fmnist MLP's 6 leaves, the CNN's 12, the three layout cases as
    groups and a group over the leaf cap (20 leaves, 2 launches); masks all
    ones, all zeros and mixed (B.4, B.5), qmax 127 and 7 (B.2, B.4), src
    None and each matching.  Then, at the MLP and the CNN, one grouped call against the
    one-leaf calls of every leaf, in turns (one-leaf, grouped, grouped,
    one-leaf): call time (CUDA events), device time (every device entry of a
    call under the profiler: the one-leaf B.4's scratch-free launch, B.3's
    and B.5's copy of acc), the plain version's call and the bound (the sum
    of the leaves')."""
    import torch

    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ref as qref

    cfg = qk.config()
    log(f"[kernel] grouped B.4/B.5 as built: {cfg}")
    if (cfg["cluster_size"], cfg["max_group_leaves"], cfg["min_share"], cfg["acc_chunk"]) != \
            (qk.CLUSTER_SIZE, qk.MAX_GROUP_LEAVES, qk.MIN_SHARE, qk.ACC_CHUNK):
        raise AssertionError(f"[kernel] masked_grouped.cu's sizes {cfg} are not the wrappers'")
    mlp_d, cnn_d = [d for _, d in mlp_leaves], [d for _, d in cnn_leaves]
    groups = {"mlp": (K, mlp_d, 65536), "cnn": (K, cnn_d, 65536), **GROUP_LAYOUTS,
              "over the cap": (K, mlp_d + cnn_d + [4096, 7], 65536)}
    out = {name: dict(max_abs_err=0.0, cases=0, cluster_size=cfg["cluster_size"],
                      max_group_leaves=cfg["max_group_leaves"], rows=[]) for name in GROUPED}
    inputs = {}

    def expect_equal(name, what, got, want, launches, before):
        fn = getattr(qk, name)
        if fn.launches - before != launches:
            raise AssertionError(f"[kernel] {name} {what}: {fn.launches - before} launches, "
                                 f"want {launches}")
        err = max(_max_diff(g, w) for g, w in zip(got, want))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        out[name]["cases"] += 1
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[kernel] {name} {what}: kernel != plain (max abs err {err})")

    for group, (k, dims, block_d) in groups.items():
        xs, us = [], []
        for d in dims:
            x = torch.randn((k, d), generator=gen, device="cuda")
            x *= torch.rand((k, 1), generator=gen, device="cuda") * 3.0
            if k > 2:
                x[1] = 0.0  # an all-zero row: scale 1
            u = torch.rand((k, d), generator=gen, device="cuda")
            u[0, ::3] = 0.0
            xs.append(x)
            us.append(u)
        masks = {"ones": torch.ones(k, device="cuda"), "zeros": torch.zeros(k, device="cuda"),
                 "mixed": (torch.arange(k, device="cuda") % 2).float()}
        srcs = [None] + (fmnist_srcs if k == K else [_involution(k, "cuda")])
        payloads = [qref.quantize_blockwise_ref(x, u, block_d=block_d) for x, u in zip(xs, us)]
        w = torch.rand((k,), generator=gen, device="cuda") * 0.5
        w[0] = 0.0  # a row that receives nothing
        accs0 = [torch.randn((k, d), generator=gen, device="cuda") for d in dims]
        n_launch = len(qk.leaf_tables([1] * len(dims)))
        what = f"{group} ({len(dims)} leaves, K = {k})"
        for mname, m in masks.items():
            for qmax in (127.0, 7.0):
                before = qk.masked_quantize_blockwise_grouped.launches
                got = qk.masked_quantize_blockwise_grouped(xs, us, m, qmax=qmax, block_d=block_d)
                want = [qref.masked_quantize_blockwise_ref(x, u, m, qmax=qmax, block_d=block_d)
                        for x, u in zip(xs, us)]
                expect_equal("masked_quantize_blockwise_grouped", f"{what} mask {mname} "
                             f"qmax {qmax}", [t for p in got for t in p],
                             [t for p in want for t in p], n_launch, before)
            for i, src in enumerate(srcs):
                accs = [a.clone() for a in accs0]
                before = qk.masked_dequant_accumulate_grouped_.launches
                got = qk.masked_dequant_accumulate_grouped_(accs, payloads, w, m, src=src)
                want = [qref.masked_dequant_accumulate_ref(a, q, s, w, m, src=src)
                        for a, (q, s) in zip(accs0, payloads)]
                if got is not accs:
                    raise AssertionError("[kernel] the grouped accumulate is not in place")
                expect_equal("masked_dequant_accumulate_grouped_",
                             f"{what} mask {mname} src {i}", got, want, n_launch, before)
        for qmax in (127.0, 7.0):  # B.2: no mask
            before = qk.quantize_blockwise_grouped.launches
            got = qk.quantize_blockwise_grouped(xs, us, qmax=qmax, block_d=block_d)
            want = [qref.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
                    for x, u in zip(xs, us)]
            expect_equal("quantize_blockwise_grouped", f"{what} qmax {qmax}",
                         [t for p in got for t in p], [t for p in want for t in p], n_launch,
                         before)
        for i, src in enumerate(srcs):  # B.3: no mask
            accs = [a.clone() for a in accs0]
            before = qk.dequant_accumulate_grouped_.launches
            got = qk.dequant_accumulate_grouped_(accs, payloads, w, src=src)
            want = [qref.dequant_accumulate_ref(a, q, s, w, src=src)
                    for a, (q, s) in zip(accs0, payloads)]
            if got is not accs:
                raise AssertionError("[kernel] the grouped B.3 is not in place")
            expect_equal("dequant_accumulate_grouped_", f"{what} src {i}", got, want, n_launch,
                         before)
        torch.cuda.synchronize()
        inputs[group] = (k, dims, block_d, xs, us, payloads, w, srcs[1])
    for name in GROUPED:
        log(f"[kernel] {name}: {out[name]['cases']} grouped cases equal to the one-leaf plain "
            f"versions (max abs err {out[name]['max_abs_err']}); cluster size "
            f"{cfg['cluster_size']}, {cfg['max_group_leaves']} leaves per launch")

    for group in ("mlp", "cnn"):
        k, dims, block_d, xs, us, payloads, _, src = inputs[group]
        ones = torch.ones(k, device="cuda")
        w = 0.25 + 0.5 * torch.rand((k,), generator=gen, device="cuda")  # every row live
        accs = [torch.randn((k, d), generator=gen, device="cuda") for d in dims]
        calls = {
            "masked_quantize_blockwise_grouped": (
                lambda: qk.masked_quantize_blockwise_grouped(xs, us, ones, block_d=block_d),
                lambda: [qk.masked_quantize_blockwise(x, u, ones, block_d=block_d)
                         for x, u in zip(xs, us)],
                lambda: qref.masked_quantize_blockwise_grouped_ref(xs, us, ones,
                                                                   block_d=block_d)),
            "masked_dequant_accumulate_grouped_": (
                lambda: qk.masked_dequant_accumulate_grouped_(accs, payloads, w, ones, src=src),
                lambda: [qk.masked_dequant_accumulate(a, q, s, w, ones, src=src)
                         for a, (q, s) in zip(accs, payloads)],
                lambda: qref.masked_dequant_accumulate_grouped_ref_(accs, payloads, w, ones,
                                                                    src=src)),
            "dequant_accumulate_grouped_": (
                lambda: qk.dequant_accumulate_grouped_(accs, payloads, w, src=src),
                lambda: [qk.dequant_accumulate(a, q, s, w, src=src)
                         for a, (q, s) in zip(accs, payloads)],
                lambda: qref.dequant_accumulate_grouped_ref_(accs, payloads, w, src=src)),
            "quantize_blockwise_grouped": (
                lambda: qk.quantize_blockwise_grouped(xs, us, block_d=block_d),
                lambda: [qk.quantize_blockwise(x, u, block_d=block_d) for x, u in zip(xs, us)],
                lambda: qref.quantize_blockwise_grouped_ref(xs, us, block_d=block_d)),
        }
        for name, (grouped, one_leaf, plain) in calls.items():
            bounds = [kernel_bound(ONE_LEAF[name], k, d, qk.num_blocks(d, block_d))
                      for d in dims]
            readings = {"one_leaf": [], "grouped": []}
            for side in ("one_leaf", "grouped", "grouped", "one_leaf"):
                fn = grouped if side == "grouped" else one_leaf
                readings[side].append((cuda_ms(fn), window_device_ms(fn, 50)))
            mean = {side: [sum(r[j] for r in rs) / len(rs) for j in (0, 1)]
                    for side, rs in readings.items()}
            row = dict(group=group, leaves=len(dims), k=k, ms=mean["grouped"][0],
                       device_ms=mean["grouped"][1], one_leaf_ms=mean["one_leaf"][0],
                       one_leaf_device_ms=mean["one_leaf"][1],
                       plain_ms=cuda_ms(plain, iters=50, warmup=2),
                       bound_ms=sum(b for b, _ in bounds),
                       bound_by="bytes" if {by for _, by in bounds} == {"bytes"}
                       else "operations", readings=readings)
            out[name]["rows"].append(row)
            log(f"[kernel] {name:34s} {group}: grouped device {1e3 * row['device_ms']:7.2f} us "
                f"call {1e3 * row['ms']:7.2f} us | {len(dims)} one-leaf calls device "
                f"{1e3 * row['one_leaf_device_ms']:7.2f} us call "
                f"{1e3 * row['one_leaf_ms']:7.2f} us | plain {1e3 * row['plain_ms']:8.2f} us "
                f"| bound {1e3 * row['bound_ms']:.3f} us ({row['bound_by']}); readings "
                f"(call, device ms) {readings}")
    for name in GROUPED:
        out[name]["per_step"] = {r["group"]: {key: r[key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")} for r in out[name]["rows"]}
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
        # the uncompressed dense step is SGD + the static W: fused into B.1,
        # one launch per step over every leaf; the int8 wire quantizes every
        # leaf of a round in one B.2 launch
        check_counts(f"fmnist {wire}", counts, {"quantize_blockwise_grouped": exp.steps}
                     if wire == "int8-kernel" else {"gossip_update_stacked_grouped": exp.steps})
        got = (rec["loss_step300"], rec["acc_worst_dist"], rec["acc_avg"])
        if got != PER_LEAF_DENSE[wire]:
            raise AssertionError(f"[fmnist] {wire}: (loss_step300, acc_worst_dist, acc_avg) = "
                                 f"{got}, the per-leaf launches printed {PER_LEAF_DENSE[wire]}")
        log(f"[fmnist] {wire}: loss_step300, acc_worst_dist and acc_avg are the per-leaf "
            f"launches' to the bit")
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
    """The static EF wire: one grouped B.2 per round (per 16 leaves), one
    grouped B.3 per matching; the masked wires: one grouped B.4 per
    matching (memoryless) or per round (EF), one grouped B.5 per matching of
    a round that sends payloads."""
    if stack == "gossip-int8-kernel-ef":
        return {"quantize_blockwise_grouped": steps * -(-leaves // 16),
                "dequant_accumulate_grouped_": steps * matchings}
    if stack == "dropout0.2-int8-kernel-memoryless":
        return {"masked_quantize_blockwise_grouped": steps * matchings,
                "masked_dequant_accumulate_grouped_": steps * matchings}
    if stack == "dropout0.2-int8-kernel-ef-B4":
        delta_rounds = sum(1 for r in range(steps) if r % REBASE_EVERY != REBASE_EVERY - 1)
        return {"masked_quantize_blockwise_grouped": steps,
                "masked_dequant_accumulate_grouped_": delta_rounds * matchings}
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
        pinned = {**ONE_LEAF_TRAJECTORIES, **PER_LEAF_TRAJECTORIES}
        if stack in pinned:
            got = (rec["loss_step300"], rec["acc_worst_dist"], rec["acc_avg"])
            wire = "one-leaf" if stack in ONE_LEAF_TRAJECTORIES else "per-leaf B.3"
            if got != pinned[stack]:
                raise AssertionError(f"[gossip] {stack}: (loss_step300, acc_worst_dist, "
                                     f"acc_avg) = {got}, the {wire} wire printed "
                                     f"{pinned[stack]}")
            log(f"[gossip] {stack}: loss_step300, acc_worst_dist and acc_avg are the "
                f"{wire} wire's to the bit")
        if stack == "gossip-none":
            rec.update(_gossip_vs_dense(spec_cls, exp, batches, params, state, dense_params,
                                        mixer))
        out[stack] = dict(rec, counts=counts)
    out["cifar"] = _gossip_cifar(spec_cls, cfg_cls)
    return out


def phase_b45_leaves(cfg_cls) -> dict:
    """One round of the memoryless dropout-0.2 wire on the fmnist MLP
    (K = 10, the seeded weights plus seeded noise per node) through the
    mixer (one grouped B.4 and one grouped B.5 launch per matching), and the
    same round leaf by leaf through ``masked_quant_gossip_round`` (the
    one-leaf B.4 and B.5, one launch each per leaf and matching): the same
    bits."""
    import torch

    from repro_torch.comm.topology import gather_round_vectors
    from repro_torch.core.drdsgd import replicate_params
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.kernels.quant_gossip.ops import masked_quant_gossip_round
    from repro_torch.utils.tree import leaf_names

    exp, _, _, params = _fmnist()
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
    decomp = _matchings(exp.p, exp.seed)
    mixer = _gossip_mixer("dropout0.2-int8-kernel-memoryless", decomp, w, exp.seed, cfg_cls)
    gen = torch.Generator(device="cuda").manual_seed(exp.seed)
    theta = {n: x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
             for n, x in replicate_params(params, K).items()}
    state = mixer.init_state(theta)
    m = decomp.num_rounds
    reset_counts()
    mixed, _ = mixer(theta, state)
    torch.cuda.synchronize()
    check_counts("b45-leaves grouped", kernel_counts(),
                 {"masked_quantize_blockwise_grouped": m,
                  "masked_dequant_accumulate_grouped_": m})
    self_w, match_ws, masks = gather_round_vectors(mixer.topo.round_w(state.rounds),
                                                   mixer.transport.perm_idx)
    reset_counts()
    equal = {}
    for i, name in enumerate(leaf_names(theta)):
        xf = theta[name].reshape(K, -1)
        acc = xf * self_w[:, None]
        for j, (pw, mk, src) in enumerate(zip(match_ws, masks, mixer.transport.srcs)):
            u = mixer.wire.uniforms(state.key, state.rounds, i, j, xf)
            acc = masked_quant_gossip_round(xf, acc, pw, mk, src, u,
                                            qmax=float(mixer.wire._qmax),
                                            block_d=mixer.wire.quantized.block_d)
        equal[name] = bool(torch.equal(acc.reshape(theta[name].shape), mixed[name]))
    counts = kernel_counts()
    check_counts("b45-leaves one-leaf", counts,
                 {"masked_quantize_blockwise": len(theta) * m,
                  "masked_dequant_accumulate": len(theta) * m})
    rec = dict(matchings=m, leaves=len(theta), equal=equal,
               launches={n: c[0] for n, c in counts.items() if c[0]})
    log("[b45-leaves] " + json.dumps(rec))
    if not all(equal.values()):
        raise AssertionError("[b45-leaves] the grouped round is not the leaf-by-leaf round")
    return rec


class _Without:
    """The kernel quantizer without one of its grouped calls: a round then
    goes leaf by leaf through the one-leaf kernel, as it did before that
    kernel was grouped (``accumulate_grouped_``: B.3; ``compress_grouped``:
    B.2)."""

    def __init__(self, quantizer, hidden: str):
        self._q, self._hidden = quantizer, hidden

    def __getattr__(self, name):
        if name == self._hidden:
            raise AttributeError(name)
        return getattr(self._q, name)


def phase_b3_leaves(cfg_cls) -> dict:
    """Two rounds of the static int8 EF wire on the fmnist MLP (K = 10, the
    seeded weights plus seeded noise per node) through the mixer (one
    grouped B.3 launch per matching), and the same rounds from the same
    states leaf by leaf (the one-leaf B.3, one launch per leaf and
    matching): θ, θ̂ and the mix cache equal bit for bit."""
    import torch

    from repro_torch.core.drdsgd import replicate_params
    from repro_torch.graphs import build_graph, metropolis_weights

    exp, _, _, params = _fmnist()
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
    decomp = _matchings(exp.p, exp.seed)
    grouped = _gossip_mixer("gossip-int8-kernel-ef", decomp, w, exp.seed, cfg_cls)
    per_leaf = _gossip_mixer("gossip-int8-kernel-ef", decomp, w, exp.seed, cfg_cls)
    per_leaf.compressor = _Without(per_leaf.compressor, "accumulate_grouped_")
    gen = torch.Generator(device="cuda").manual_seed(exp.seed)
    theta = {n: x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
             for n, x in replicate_params(params, K).items()}
    m, leaves = decomp.num_rounds, len(theta)
    runs, counts = {}, {}
    for tag, mixer in (("grouped", grouped), ("per-leaf", per_leaf)):
        t, state = theta, mixer.init_state(theta)
        reset_counts()
        for _ in range(2):
            t, state = mixer(t, state)
        torch.cuda.synchronize()
        counts[tag] = kernel_counts()
        runs[tag] = (t, state)
    check_counts("b3-leaves grouped", counts["grouped"],
                 {"quantize_blockwise_grouped": 2, "dequant_accumulate_grouped_": 2 * m})
    check_counts("b3-leaves per-leaf", counts["per-leaf"],
                 {"quantize_blockwise_grouped": 2, "dequant_accumulate": 2 * leaves * m})
    (ta, sa), (tb, sb) = runs["grouped"], runs["per-leaf"]
    equal = {n: bool(torch.equal(ta[n], tb[n]) and torch.equal(sa.hat[n], sb.hat[n])
                     and torch.equal(sa.hat_mix[n], sb.hat_mix[n])) for n in theta}
    rec = dict(rounds=2, matchings=m, leaves=leaves, equal=equal,
               launches={n: c[0] for n, c in counts["per-leaf"].items() if c[0]})
    log("[b3-leaves] " + json.dumps(rec))
    if not all(equal.values()):
        raise AssertionError("[b3-leaves] the grouped round is not the leaf-by-leaf round")
    return rec


def phase_b2_leaves(cfg_cls) -> dict:
    """Two rounds of the dense int8 EF wire on the fmnist MLP (K = 10, the
    seeded weights plus seeded noise per node) through the mixer (one
    grouped B.2 launch per round over every leaf), and the same rounds from
    the same states with the wire's grouped call hidden (the one-leaf B.2,
    one launch per leaf and round): θ and θ̂ equal bit for bit."""
    import torch

    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.core.drdsgd import replicate_params
    from repro_torch.graphs import build_graph, metropolis_weights

    exp, _, _, params = _fmnist()
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
    cfg = cfg_cls(kind="int8", use_kernel=True)
    grouped = make_dense_mixer(w, compression=cfg, device="cuda")
    per_leaf = make_dense_mixer(w, compression=cfg, device="cuda")
    per_leaf.wire.compressor = _Without(per_leaf.wire.compressor, "compress_grouped")
    gen = torch.Generator(device="cuda").manual_seed(exp.seed)
    theta = {n: x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
             for n, x in replicate_params(params, K).items()}
    leaves = len(theta)
    runs, counts = {}, {}
    for tag, mixer in (("grouped", grouped), ("per-leaf", per_leaf)):
        t, state = theta, mixer.init_state(theta)
        reset_counts()
        for _ in range(2):
            t, state = mixer(t, state)
        torch.cuda.synchronize()
        counts[tag] = kernel_counts()
        runs[tag] = (t, state)
    check_counts("b2-leaves grouped", counts["grouped"], {"quantize_blockwise_grouped": 2})
    check_counts("b2-leaves per-leaf", counts["per-leaf"], {"quantize_blockwise": 2 * leaves})
    (ta, sa), (tb, sb) = runs["grouped"], runs["per-leaf"]
    equal = {n: bool(torch.equal(ta[n], tb[n]) and torch.equal(sa.hat[n], sb.hat[n]))
             for n in theta}
    rec = dict(rounds=2, leaves=leaves, equal=equal,
               launches={n: c[0] for n, c in counts["per-leaf"].items() if c[0]})
    log("[b2-leaves] " + json.dumps(rec))
    if not all(equal.values()):
        raise AssertionError("[b2-leaves] the grouped round is not the leaf-by-leaf round")
    return rec


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
    """The CNN on the static int8 EF gossip wire: B.3 on 512,000-wide rows,
    with cuDNN held deterministic so that the run prints the per-leaf B.3's
    losses to the bit (PER_LEAF_CIFAR)."""
    import torch

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
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, _, ms, ms_step, counts = _train(spec, make_classifier_loss(cnn_apply), cnn_apply,
                                           params, batches, CIFAR_GOSSIP_STEPS,
                                           tuple(b[:2] for b in batches), mixer=mixer)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check_counts("gossip cifar", counts, _gossip_launches(
        "gossip-int8-kernel-ef", CIFAR_GOSSIP_STEPS, len(params), decomp.num_rounds))
    rec = dict(stack="gossip-int8-kernel-ef", model="cnn", steps=CIFAR_GOSSIP_STEPS,
               matchings=decomp.num_rounds, grad_clip=CIFAR_GRAD_CLIP,
               loss_step0=float(ms["loss_mean"][0]), loss_last=float(ms["loss_mean"][-1]),
               loss_worst_max=float(ms["loss_worst"].max()),
               comm_bytes_per_round=float(ms["comm_bytes"][-1]), ms_per_step=ms_step,
               launches={n: c[0] for n, c in counts.items() if c[0]})
    log("[gossip] " + json.dumps(rec))
    got = (rec["loss_step0"], rec["loss_last"], rec["loss_worst_max"])
    if got != PER_LEAF_CIFAR:
        raise AssertionError(f"[gossip] cifar: (loss_step0, loss_last, loss_worst_max) = {got}, "
                             f"the per-leaf B.3 wire printed {PER_LEAF_CIFAR}")
    log("[gossip] cifar: loss_step0, loss_last and loss_worst_max are the per-leaf B.3 "
        "wire's to the bit")
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
    check_counts("cifar", counts, {"quantize_blockwise_grouped": CIFAR_STEPS})
    rec = dict(wire="int8-kernel", steps=CIFAR_STEPS, batch=exp.batch_size,
               grad_clip=CIFAR_GRAD_CLIP, loss_step0=float(ms["loss_mean"][0]),
               loss_last=float(ms["loss_mean"][-1]),
               loss_worst_max=float(ms["loss_worst"].max()),
               comm_bytes=float(ms["comm_bytes"][-1]), ms_per_step=ms_step,
               launches=counts["quantize_blockwise_grouped"][0])
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


# -- the compressed-wire codecs and rate schedules (fig7, fig8) ---------------

FIG_K = 8                  # fig7/fig8: K = 8 ring, Metropolis W, DR-DSGD mu = 3
FIG_MU = 3.0
FIG_CLIP = 2.0             # run_decentralized's grad_clip, the figures' default
FIG7_STEPS = 400
FIG7_FMNIST = (55, 0.18)   # batch, lr (benchmarks/fig7_compression.py _TASK)
FIG7_CIFAR = (40, 0.05)
FIG7_RATIO = 0.02          # topk2pct
FIG8_STEPS = 600
FIG8_ANNEAL = FIG8_STEPS // 2
SCHED_PARITY_ROUNDS = 14   # past fig8's warmup of 10 rounds
SCHED_RATE_RTOL = 1e-4     # adaptive rate, card vs CPU (res_norm's summation order)
TENSOR_QMAX = (127.0, 7.0, 42.5)


def _fig_spec(spec_cls, compress, batch_lr, **kw):
    return spec_cls(num_nodes=FIG_K, graph="ring", mu=FIG_MU, lr=batch_lr[1],
                    grad_clip=FIG_CLIP, compress=compress, device="cuda", **kw)


def _fig_data(model: str, steps: int, batch: int, seed: int = 0):
    """fig7/fig8's task at K = 8: data, batches, per-node test sets and
    seeded weights on the card."""
    from repro_torch.data import (
        make_cifar_like,
        make_fmnist_like,
        pathological_noniid_partition,
    )
    from repro_torch.models import cnn_init, mlp_init

    make, init = (make_fmnist_like, mlp_init) if model == "mlp" else (make_cifar_like, cnn_init)
    fed = pathological_noniid_partition(make(), FIG_K, seed=seed)
    return (_sample(fed, steps, batch, seed), fed.per_node_test_sets(n_per_node=200, seed=seed),
            _params_via_npz(init, seed, model, "cuda"))


def _ring_decomp():
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    return permutation_decomposition(metropolis_weights(build_graph("ring", FIG_K)))


def _fig_run(tag, name, spec, model, data, steps, want_counts, mixer=None) -> dict:
    """``steps`` steps of ``trainer.step``, each timed to a synchronised
    end, after a 3-step warm-up on a throwaway state, with every launch
    count set to 0 just before.  Holds: loss falls on the first batch,
    every metric finite, each round's bytes equal to the port's own
    accounting (a scheduled wire's ``round_wire_bits`` at the round's rate,
    which the wire reports before the step; else ``bytes_per_round``), and
    the launches ``want_counts`` with no plain call.  Returns the record."""
    import statistics

    import torch

    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.models import cnn_apply, make_classifier_loss, mlp_apply

    apply_fn = mlp_apply if model == "mlp" else cnn_apply
    batches, (x_nodes, y_nodes), params = data
    trainer = spec.build(make_classifier_loss(apply_fn), apply_fn, mixer=mixer)
    trainer.run(trainer.init(params), tuple(b[:3] for b in batches))
    state = trainer.init(params)
    wire = trainer.mixer.wire
    sched = getattr(wire, "schedule", None)
    torch.cuda.synchronize()
    reset_counts()
    rates, times, metrics = [], [], []
    for t in range(steps):
        if sched is not None:
            rates.append(wire.rate(state.comm))  # the round's rate, on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, tuple(b[t] for b in batches))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    counts = kernel_counts()
    tensor_qmax = qk.quantize_blockwise_grouped.tensor_qmax_launches
    ms = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    _finite(ms)
    check_counts(f"{tag} {name}", counts, want_counts)
    # the port's own accounting of every round's wire
    if sched is not None:
        senders = trainer.mixer._sends() if trainer.mixer._is_gossip else FIG_K
        want_bits = torch.stack([wire.round_wire_bits(state.params, r, senders, FIG_K, "cuda")
                                 for r in rates])
        if not torch.equal(ms["wire_bits"], want_bits):
            raise AssertionError(f"[{tag}] {name}: wire_bits are not the round's accounting")
        if not torch.equal(ms["comm_bytes"], ms["wire_bits"] / 8.0):
            raise AssertionError(f"[{tag}] {name}: comm_bytes are not wire_bits / 8")
        if "int8-kernel" in name and tensor_qmax != steps:
            raise AssertionError(f"[{tag}] {name}: {tensor_qmax} B.2 launches read qmax on "
                                 f"the card, want {steps}")
    else:
        per_round = trainer.mixer.bytes_per_round(state.params)
        if not bool((ms["comm_bytes"] == per_round).all()):
            raise AssertionError(f"[{tag}] {name}: comm_bytes are not bytes_per_round "
                                 f"{per_round}")
    loss0 = float(ms["loss_mean"][0])
    loss_end = _loss_on(trainer, state, tuple(b[0] for b in batches))
    stats = trainer.eval_local_distributions(state, x_nodes, y_nodes)
    rec = dict(run=name, model=model, steps=steps, loss_step0=loss0, loss_end=loss_end,
               acc_worst_dist=stats["acc_worst_dist"], acc_avg=stats["acc_avg"],
               comm_bytes_total=float(ms["comm_bytes"].double().sum()),
               wire_bits_total=float(ms["wire_bits"].double().sum()),
               comm_bytes_round0=float(ms["comm_bytes"][0]),
               ms_per_step_median=1e3 * statistics.median(times),
               launches={n: c[0] for n, c in counts.items() if c[0]})
    if sched is not None:
        rec["rate"] = {r: float(rates[r]) for r in (0, 10, steps - 1)}
        rec["tensor_qmax_launches"] = tensor_qmax
    log(f"[{tag}] " + json.dumps(rec))
    if not loss_end < loss0:
        raise AssertionError(f"[{tag}] {name}: loss did not fall ({loss0} -> {loss_end})")
    if not all(math.isfinite(v) for v in (stats["acc_worst_dist"], stats["acc_avg"])):
        raise AssertionError(f"[{tag}] {name}: eval metrics not finite")
    return rec


def phase_codecs(spec_cls, cfg_cls) -> dict:
    """fig7: every codec on the fmnist task (K = 8 ring, DR-DSGD mu = 3, B =
    55, lr 0.18, 400 steps, clipped at 2, lr_compensate off) over the dense
    lowering — none (the fused B.1 step), bf16, int8, int4, topk 2 % (EF,
    default gamma), int8 on the kernel (B.2 once per round) — and topk and
    randk 2 % over the ring's gossip matchings; then the CNN (B = 40, lr
    0.05, clipped at 2) with int4 and topk 2 %, cut from 400 to CIFAR_STEPS
    steps as phase_cifar is.  Each run is held by :func:`_fig_run`."""
    from repro_torch.comm import CompressedGossipMixer

    out = {}
    data = _fig_data("mlp", FIG7_STEPS, FIG7_FMNIST[0])
    dense = {"none": "none", "bf16": cfg_cls(kind="bf16"), "int8": cfg_cls(kind="int8"),
             "int4": cfg_cls(kind="int4"),
             "topk2pct": cfg_cls(kind="topk", ratio=FIG7_RATIO),
             "int8-kernel": cfg_cls(kind="int8", use_kernel=True)}
    for name, cfg in dense.items():
        want = {"none": {"gossip_update_stacked_grouped": FIG7_STEPS},
                "int8-kernel": {"quantize_blockwise_grouped": FIG7_STEPS}}.get(name, {})
        out[f"dense-{name}"] = _fig_run("codecs", f"dense-{name}",
                                        _fig_spec(spec_cls, cfg, FIG7_FMNIST), "mlp", data,
                                        FIG7_STEPS, want)
    decomp = _ring_decomp()
    for kind in ("topk", "randk"):
        mixer = CompressedGossipMixer(decomp, cfg_cls(kind=kind, ratio=FIG7_RATIO))
        name = f"gossip-{kind}2pct"
        out[name] = _fig_run("codecs", name, _fig_spec(spec_cls, mixer.compression, FIG7_FMNIST),
                             "mlp", data, FIG7_STEPS, {}, mixer=mixer)
    cifar = _fig_data("cnn", CIFAR_STEPS, FIG7_CIFAR[0])
    for name, cfg in (("int4", cfg_cls(kind="int4")),
                      ("topk2pct", cfg_cls(kind="topk", ratio=FIG7_RATIO))):
        out[f"cifar-{name}"] = _fig_run("codecs", f"cifar-dense-{name}",
                                        _fig_spec(spec_cls, cfg, FIG7_CIFAR), "cnn", cifar,
                                        CIFAR_STEPS, {})
    return out


def _sched_cfg(cfg_cls, kind: str, **kw):
    from repro_torch.comm import ScheduleConfig

    schedule = {"adaptive": ScheduleConfig(kind="adaptive", threshold=1.0, warmup_rounds=10),
                "linear": ScheduleConfig(kind="linear", anneal_rounds=FIG8_ANNEAL)}[kind]
    return cfg_cls(kind="int8", schedule=schedule, **kw)


def _sched_mixer(stack: str, cfg, device, uniforms=None):
    """The scheduled kernel stacks: dense, or gossip EF over the ring."""
    from repro_torch.comm import CompressedGossipMixer
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    w = metropolis_weights(build_graph("ring", FIG_K))
    if stack == "dense":
        return make_dense_mixer(w, compression=cfg, device=device, uniforms=uniforms)
    return CompressedGossipMixer(permutation_decomposition(w), cfg, device=device,
                                 uniforms=uniforms)


def _tensor_qmax_kernel(mlp_leaves, cnn_leaves) -> dict:
    """B.2 grouped with qmax as a 0-d float32 tensor on the card against the
    float form and the plain version, bit for bit, at TENSOR_QMAX, on the
    fmnist MLP's leaves and the CNN's (K = 10, the kernel phase's inputs);
    then the MLP's call timed in both forms, in turns (float, tensor,
    tensor, float), beside the plain version with the tensor and the bound
    (the grouped B.2's, plus the 4-byte qmax)."""
    import torch

    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ref as qref

    gen = torch.Generator(device="cuda").manual_seed(99)
    rec = dict(cases=0, max_abs_err=0.0)
    inputs = {}
    for group, leaves in (("mlp", mlp_leaves), ("cnn", cnn_leaves)):
        dims = [d for _, d in leaves]
        xs = [torch.randn((K, d), generator=gen, device="cuda")
              * (0.01 + 3.0 * torch.rand((K, 1), generator=gen, device="cuda")) for d in dims]
        us = [torch.rand((K, d), generator=gen, device="cuda") for d in dims]
        inputs[group] = (dims, xs, us)
        for qmax in TENSOR_QMAX:
            q_t = torch.full((), qmax, dtype=torch.float32, device="cuda")
            got = qk.quantize_blockwise_grouped(xs, us, qmax=q_t)
            flt = qk.quantize_blockwise_grouped(xs, us, qmax=qmax)
            plain = qref.quantize_blockwise_grouped_ref(xs, us, qmax=q_t)
            for (q, s), (qf, sf), (qp, sp) in zip(got, flt, plain):
                err = max(_max_diff(q, qp), _max_diff(s, sp))
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if not (torch.equal(q, qf) and torch.equal(s, sf) and torch.equal(q, qp)
                        and torch.equal(s, sp)):
                    raise AssertionError(f"[schedules] B.2 with a tensor qmax {qmax} on the "
                                         f"{group} leaves != the float form / plain version")
                rec["cases"] += 1
    log(f"[schedules] B.2 grouped, tensor qmax {TENSOR_QMAX}: equal to the float form and "
        f"the plain version on the MLP's and the CNN's leaves ({rec['cases']} leaf cases)")
    dims, xs, us = inputs["mlp"]
    q_t = torch.full((), 127.0, dtype=torch.float32, device="cuda")
    forms = {"float": lambda: qk.quantize_blockwise_grouped(xs, us, qmax=127.0),
             "tensor": lambda: qk.quantize_blockwise_grouped(xs, us, qmax=q_t)}
    readings = {"float": [], "tensor": []}
    for side in ("float", "tensor", "tensor", "float"):
        readings[side].append((cuda_ms(forms[side]), window_device_ms(forms[side], 50)))
    mean = {side: [sum(r[j] for r in rs) / len(rs) for j in (0, 1)]
            for side, rs in readings.items()}
    bounds = [kernel_bound("quantize_blockwise", K, d, qk.num_blocks(d, 65536)) for d in dims]
    rec.update(ms=mean["tensor"][0], device_ms=mean["tensor"][1], float_ms=mean["float"][0],
               float_device_ms=mean["float"][1],
               plain_ms=cuda_ms(lambda: qref.quantize_blockwise_grouped_ref(xs, us, qmax=q_t),
                                iters=50, warmup=2),
               bound_ms=sum(b for b, _ in bounds) + 1e3 * 4 / HBM_BYTES_PER_S,
               bound_by="bytes" if {by for _, by in bounds} == {"bytes"} else "operations",
               readings=readings)
    log(f"[schedules] B.2 grouped on the MLP's leaves: tensor qmax device "
        f"{1e3 * rec['device_ms']:.2f} us call {1e3 * rec['ms']:.2f} us | float qmax device "
        f"{1e3 * rec['float_device_ms']:.2f} us call {1e3 * rec['float_ms']:.2f} us | plain "
        f"{1e3 * rec['plain_ms']:.2f} us | bound {1e3 * rec['bound_ms']:.3f} us; readings "
        f"(call, device ms) {readings}")
    return rec


def _linear_rates_on_card(cfg_cls) -> int:
    """The linear schedule's rate at round r, computed on the card, equals
    hi + (lo - hi)·min(r / 300, 1) in float32 bit for bit."""
    import numpy as np
    import torch

    from repro_torch.comm.schedule import CompressionSchedule

    cfg = _sched_cfg(cfg_cls, "linear")
    sched = CompressionSchedule(cfg.schedule, "int8", cfg.ratio)
    zero = torch.zeros((), device="cuda")
    checked = 0
    for r in (0, 1, 10, 100, 150, 299, 300, 450, FIG8_STEPS - 1):
        got = sched.rate(r, zero, zero)
        hi, lo = np.float32(127.0), np.float32(7.0)
        want = hi + (lo - hi) * np.minimum(np.float32(r) / np.float32(FIG8_ANNEAL),
                                           np.float32(1.0))
        if got.device.type != "cuda" or np.float32(got.cpu()).view(np.uint32) != \
                np.float32(want).view(np.uint32):
            raise AssertionError(f"[schedules] linear rate at round {r}: {float(got)} on "
                                 f"{got.device}, want {float(want)}")
        checked += 1
    log(f"[schedules] linear rate on the card = hi + (lo - hi) min(r/{FIG8_ANNEAL}, 1) at "
        f"{checked} rounds, bit for bit")
    return checked


def _sched_parity(cfg_cls) -> dict:
    """SCHED_PARITY_ROUNDS rounds of each scheduled kernel stack (dense and
    gossip EF, adaptive and linear) on the card and the port on the CPU,
    from the same θ (the seeded MLP, K = 8, each node moved by its own
    normal draw) with the same uniforms: rates (linear bitwise, adaptive
    within SCHED_RATE_RTOL), θ within PARITY_INT8_STEPS quantization steps
    (max |θ − θ̂| / rate over the rounds), and wire bits within one bit per
    entry (quant_bits of a rate at a power-of-two edge)."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.models import mlp_init

    base = convert.params_to_numpy(mlp_init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(5)
    theta_np = {n: (x[None] + 0.05 * rng.standard_normal((FIG_K,) + x.shape)).astype(np.float32)
                for n, x in base.items()}
    entries = sum(x[0].size for x in theta_np.values())

    def noise(rounds, leaf_idx, shape):
        return np.random.default_rng([rounds, leaf_idx]).random(shape, dtype=np.float32)

    out = {}
    for stack in ("dense", "gossip"):
        for kind in ("adaptive", "linear"):
            cfg = _sched_cfg(cfg_cls, kind, use_kernel=True)
            runs = {}
            for device in ("cuda", "cpu"):
                mixer = _sched_mixer(stack, cfg, device, uniforms=noise)
                theta = {n: torch.from_numpy(v).to(device) for n, v in theta_np.items()}
                state = mixer.init_state(theta)
                rates, bits, q_step = [], [], 0.0
                for _ in range(SCHED_PARITY_ROUNDS):
                    rate = mixer.wire.rate(state)
                    q_step = max(q_step, max(float((theta[n] - state.hat[n]).abs().max())
                                             for n in theta) / float(rate))
                    theta, state = mixer(theta, state)
                    rates.append(float(rate))
                    bits.append(float(state.wire_bits))
                runs[device] = (theta, rates, bits, q_step, mixer)
            (t_gpu, r_gpu, b_gpu, _, m_gpu), (t_cpu, r_cpu, b_cpu, q_step, _) = \
                runs["cuda"], runs["cpu"]
            d_theta = max(float((t_gpu[n].cpu() - t_cpu[n]).abs().max()) for n in t_cpu)
            d_rate = max(abs(a - b) / b for a, b in zip(r_gpu, r_cpu))
            senders = m_gpu._sends() if stack == "gossip" else FIG_K
            d_bits = max(abs(a - b) for a, b in zip(b_gpu, b_cpu))
            rate_tol = SCHED_RATE_RTOL if kind == "adaptive" else 0.0
            rec = dict(stack=f"{stack}-int8-kernel-{kind}", rounds=SCHED_PARITY_ROUNDS,
                       rates_card=r_gpu, max_rel_rate_diff=d_rate, rate_rtol=rate_tol,
                       max_abs_theta_diff=d_theta, theta_atol=PARITY_INT8_STEPS * q_step,
                       max_wire_bits_diff=d_bits, wire_bits_atol=senders * entries)
            log("[schedules] parity " + json.dumps(rec))
            if not (d_rate <= rate_tol and d_theta <= PARITY_INT8_STEPS * q_step
                    and d_bits <= senders * entries):
                raise AssertionError(f"[schedules] {rec['stack']}: card vs CPU outside "
                                     f"tolerance")
            if kind == "adaptive" and not min(r_gpu) < 127.0:
                raise AssertionError(f"[schedules] {rec['stack']}: the rate never annealed")
            out[rec["stack"]] = rec
    return out


def _round_syncs(mixer, theta, state) -> dict:
    """What one round does that waits on the card: the synchronising calls
    CUDA's sync debug mode reports, and under the profiler the runtime's
    synchronise calls and the device-to-host copies."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mixer(theta, state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mixer(theta, state)
    torch.cuda.synchronize()
    events = prof.events()
    return dict(
        # the mode's own one-time "prototype feature" notice is not a sync
        debug_mode=sum(1 for w in caught
                       if "called a synchronizing CUDA operation" in str(w.message)),
        runtime_syncs=sum(1 for e in events if e.device_type == DeviceType.CPU
                          and "Synchronize" in e.name),
        dtoh_copies=sum(1 for e in events if e.device_type == DeviceType.CUDA
                        and "DtoH" in e.name))


def _sync_counts(cfg_cls) -> dict:
    """One round of each kernel stack unscheduled and scheduled (adaptive,
    past its warmup, and linear), the wire's own noise drawn on the card:
    the scheduled round may make no more synchronisations than the
    unscheduled one."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for stack in ("dense", "gossip"):
        counts = {}
        for kind in ("none", "adaptive", "linear"):
            cfg = cfg_cls(kind="int8", use_kernel=True) if kind == "none" \
                else _sched_cfg(cfg_cls, kind, use_kernel=True)
            mixer = _sched_mixer(stack, cfg, "cuda")
            theta = {"fc0/w": torch.randn((FIG_K, 784, 128), generator=gen, device="cuda"),
                     "fc0/b": torch.randn((FIG_K, 128), generator=gen, device="cuda")}
            state = mixer.init_state(theta)
            for _ in range(12):  # past the adaptive warmup: res_ref latched
                theta, state = mixer(theta, state)
            counts[kind] = _round_syncs(mixer, theta, state)
        log(f"[schedules] synchronisations in one {stack} int8-kernel round: {counts}")
        if any(counts[kind][key] > counts["none"][key] for kind in ("adaptive", "linear")
               for key in counts["none"]):
            raise AssertionError(f"[schedules] a scheduled {stack} round synchronises more "
                                 f"than an unscheduled one: {counts}")
        out[stack] = counts
    return out


def phase_schedules(spec_cls, cfg_cls, mlp_leaves, cnn_leaves) -> dict:
    """fig8: int8_fixed, int4_fixed, int8_adaptive (threshold 1.0, warmup
    10) and int8_linear (anneal 300) on the per-node quantizer, 600 fmnist
    steps (K = 8 ring, mu = 3, B = 55, lr 0.18, clipped at 2); then
    int8_adaptive and int8_linear on the kernel quantizer, over the dense
    lowering (grouped B.2 once per round, qmax the rate on the card) and
    the static EF gossip lowering (grouped B.2 once per round, grouped B.3
    once per matching).  Before them: B.2 with a tensor qmax against the
    float form and the plain version (and timed), the linear rate on the
    card, the scheduled kernel stacks against the CPU, and their rounds'
    synchronisations."""
    out = {"b2_tensor_qmax": _tensor_qmax_kernel(mlp_leaves, cnn_leaves),
           "linear_rates_checked": _linear_rates_on_card(cfg_cls),
           "parity": _sched_parity(cfg_cls), "syncs": _sync_counts(cfg_cls)}
    data = _fig_data("mlp", FIG8_STEPS, FIG7_FMNIST[0])
    runs = {"int8_fixed": cfg_cls(kind="int8"), "int4_fixed": cfg_cls(kind="int4"),
            "int8_adaptive": _sched_cfg(cfg_cls, "adaptive"),
            "int8_linear": _sched_cfg(cfg_cls, "linear")}
    for name, cfg in runs.items():
        out[name] = _fig_run("schedules", name, _fig_spec(spec_cls, cfg, FIG7_FMNIST), "mlp",
                             data, FIG8_STEPS, {})
    matchings = _ring_decomp().num_rounds
    for stack in ("dense", "gossip"):
        for kind in ("adaptive", "linear"):
            cfg = _sched_cfg(cfg_cls, kind, use_kernel=True)
            mixer = _sched_mixer(stack, cfg, "cuda") if stack == "gossip" else None
            want = {"quantize_blockwise_grouped": FIG8_STEPS}
            if stack == "gossip":
                want["dequant_accumulate_grouped_"] = FIG8_STEPS * matchings
            name = f"{stack}-int8-kernel-{kind}"
            out[name] = _fig_run("schedules", name, _fig_spec(spec_cls, cfg, FIG7_FMNIST), "mlp",
                                 data, FIG8_STEPS, want, mixer=mixer)
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


def wkv6_bound(b, h, t, hd, given_state: bool = False) -> tuple[float, str]:
    """Least time of one B.7 call: r, k, v, w read, y and the final state
    written once, u (and a given state) read once, against the least
    arithmetic at the float32 peak: 5 float operations per (i, j, t), a
    multiply (k_i v_j) and two FMAs (y's sum and the decayed state), the
    bonus being one scalar per (b, h, t)."""
    n_bytes = 4 * (5 * b * h * t * hd + (1 + given_state) * b * h * hd * hd + h * hd)
    ops = 5 * b * h * t * hd * hd
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# B.7's serve-kernel cases: tag, B, H, T, hd, decay, a given state, layout
# ("model": the model's strided views, staged by TMA; "odd": rows off 16
# bytes, staged by plain loads)
WKV6_CASES = (
    ("rwkv6-7b prefill", 4, 64, 256, 64, "random", False, "model"),
    ("rwkv6-7b prefill, init decay", 4, 64, 256, 64, "init", False, "model"),
    ("ragged T = 100", 4, 64, 100, 64, "random", False, "model"),
    ("T = 1, given state", 4, 64, 1, 64, "random", True, "model"),
    ("hd 16", 4, 256, 256, 16, "random", False, "model"),
    ("w = 1e-6", 4, 64, 256, 64, "1e-6", False, "model"),
    ("rows off 16 bytes, given state", 2, 8, 70, 64, "random", True, "odd"),
)
# the device time of the kernel this design replaced (one thread per column
# of the state) on an H100 80GB HBM3 at 700.00 W, printed beside the cases
WKV6_PREVIOUS_US = {"rwkv6-7b prefill": "one thread per column: 155.13 us"}


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

    for tag, b, h, t, hd, decay, given, layout in WKV6_CASES:
        if layout == "model":  # the model's (B, T, H, hd) projections
            def view():
                return randn(b, t, h, hd).permute(0, 2, 1, 3)
        else:  # rows of H hd + 1 floats: only the first row is on 16 bytes
            def view():
                return randn(b, t, h * hd + 1)[:, :, :h * hd].unflatten(
                    2, (h, hd)).permute(0, 2, 1, 3)
        r, k, v, w = view(), view(), view(), view()
        if decay == "random":
            w.copy_(torch.rand(w.shape, generator=gen, device="cuda"))
        elif decay == "init":  # exp(-exp(decay_base = -6)): the state hardly decays
            w.fill_(math.exp(-math.exp(-6.0)))
        else:  # the state is forgotten at every step
            w.fill_(1e-6)
        u = 0.5 * randn(h, hd)
        s0 = randn(b, h, hd, hd) if given else None
        tma = all(wk.rows_by_tma(x) for x in (r, k, v, w))
        if tma != (layout == "model"):
            raise AssertionError(f"[serve-kernel] B.7 {tag}: staged by "
                                 f"{'TMA' if tma else 'plain loads'}")
        (y, st), (y_p, st_p) = wk.wkv6_scan(r, k, v, w, u, s0), wkv6_ref(r, k, v, w, u, s0)
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
        ms = cuda_ms(lambda: wk.wkv6_scan(r, k, v, w, u, s0), iters=50)
        plain_ms = cuda_ms(lambda: wkv6_ref(r, k, v, w, u, s0), iters=5, warmup=1)
        dev_ms = device_ms(lambda: wk.wkv6_scan(r, k, v, w, u, s0), 20,
                           KERNELS["wkv6_scan"][2])
        bound, by = wkv6_bound(b, h, t, hd, given)
        row = dict(case=tag, b=b, h=h, t=t, hd=hd, decay=decay, given_state=given,
                   tma=tma, **errs, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=None)
        out["wkv6_scan"]["rows"].append(row)
        log("[serve-kernel] " + json.dumps(row))
        log(f"[serve-kernel] B.7 {tag}: device {1e3 * dev_ms:.2f} us "
            f"[{WKV6_PREVIOUS_US.get(tag, 'not measured')}], call {1e3 * ms:.2f} us, plain "
            f"{1e3 * plain_ms:.2f} us, bound {1e3 * bound:.3f} us ({by})")
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
    out["gossip_update_stacked_grouped"] = _stacked_grouped(
        [("mlp", K, [(d,) for _, d in mlp_leaves], w_fm),
         ("qwen2", LM_NODES, [shape for _, shape in sorted(lm_shapes.items())], w_ring)], gen,
        {g: v["plain_ms"] for g, v in out["gossip_update_stacked"]["per_step"].items()})
    return out


def _stacked_grouped(groups, gen, plain_ms) -> dict:
    """B.1 stacked over every leaf of a step in one launch, at the fmnist
    MLP's leaves (K = 10) and qwen2-0.5b's (K = 8): each output equal to
    the one-leaf kernel's bit for bit and within STACKED_REL of the plain
    version; then the grouped call against the one-leaf calls of every
    leaf, in turns (one-leaf, grouped, grouped, one-leaf): call time (CUDA
    events) and device time (every device entry of a call, the profiler's
    median window), and the bound (the sum of the leaves').  The plain
    version (the one-leaf plain calls in turn) is ``plain_ms[group]``, the
    one-leaf rows' sum: at qwen2 its outputs and temporaries beside the
    inputs would not fit the card."""
    import numpy as np
    import torch

    from repro_torch.kernels.gossip_update import kernel as gk
    from repro_torch.kernels.gossip_update import ref as gref

    cfg = gk.config()
    if cfg != dict(max_group_leaves=gk.MAX_GROUP_LEAVES, max_nodes=gk.MAX_NODES,
                   stacked_cols=gk.STACKED_COLS):
        raise AssertionError(f"[b1-kernel] gossip_update.cu's sizes {cfg} are not the wrapper's")
    out = dict(max_abs_err=0.0, max_rel_err=0.0, rows=[], **cfg)
    for group, k, shapes, w_np in groups:
        thetas = [torch.randn((k, *shape), generator=gen, device="cuda") for shape in shapes]
        grads = [torch.randn((k, *shape), generator=gen, device="cuda") for shape in shapes]
        w = torch.from_numpy(np.asarray(w_np, np.float32)).cuda()
        s = torch.rand((k,), generator=gen, device="cuda") + 0.5
        before = gk.gossip_update_stacked_grouped.launches
        got = gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.01)
        launches = gk.gossip_update_stacked_grouped.launches - before
        if launches != len(gk.leaf_tables([t.numel() // k for t in thetas])):
            raise AssertionError(f"[b1-kernel] grouped stacked {group}: {launches} launches")
        for i in range(len(shapes)):
            one = gk.gossip_update_stacked(thetas[i], grads[i], w, s, eta=0.01)
            if not torch.equal(got[i], one):
                raise AssertionError(f"[b1-kernel] grouped stacked {group} leaf {i} != the "
                                     f"one-leaf kernel (max abs err {_max_diff(got[i], one)})")
            del one
            want = gref.gossip_update_stacked_ref(thetas[i], grads[i], w, s, eta=0.01)
            diff = (got[i] - want).abs_()  # float32: a qwen2 leaf in double would not fit
            err = float(diff.max())
            rel = err / max(float(want.abs().max()), 1e-30)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["max_rel_err"] = max(out["max_rel_err"], rel)
            if rel > STACKED_REL:
                raise AssertionError(f"[b1-kernel] grouped stacked {group} leaf {i}: {rel} of "
                                     f"max |out| > {STACKED_REL}")
            del want, diff
        del got
        torch.cuda.empty_cache()
        big = sum(t.numel() for t in thetas) > 1 << 26
        iters = 5 if big else 200

        def grouped():
            gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.01)

        def one_leaf():
            for theta, grad in zip(thetas, grads):
                gk.gossip_update_stacked(theta, grad, w, s, eta=0.01)

        readings = {"one_leaf": [], "grouped": []}
        for side in ("one_leaf", "grouped", "grouped", "one_leaf"):
            fn = grouped if side == "grouped" else one_leaf
            readings[side].append((cuda_ms(fn, iters=iters, warmup=2),
                                   window_device_ms(fn, 3 if big else 50)))
        mean = {side: [sum(r[j] for r in rs) / len(rs) for j in (0, 1)]
                for side, rs in readings.items()}
        bounds = [gossip_bound(k, t.numel() // k, None) for t in thetas]
        row = dict(group=group, leaves=len(shapes), k=k, launches=launches,
                   ms=mean["grouped"][0], device_ms=mean["grouped"][1],
                   one_leaf_ms=mean["one_leaf"][0], one_leaf_device_ms=mean["one_leaf"][1],
                   plain_ms=plain_ms[group], bound_ms=sum(b for b, _ in bounds),
                   bound_by="bytes" if {by for _, by in bounds} == {"bytes"} else "operations",
                   readings=readings)
        out["rows"].append(row)
        log(f"[b1-kernel] grouped stacked {group}: device {1e3 * row['device_ms']:.2f} us call "
            f"{1e3 * row['ms']:.2f} us ({launches} launch) | {len(shapes)} one-leaf calls "
            f"device {1e3 * row['one_leaf_device_ms']:.2f} us call "
            f"{1e3 * row['one_leaf_ms']:.2f} us | plain {1e3 * row['plain_ms']:.2f} us | bound "
            f"{1e3 * row['bound_ms']:.3f} us ({row['bound_by']}); readings (call, device ms) "
            f"{readings}")
        del thetas, grads
        torch.cuda.empty_cache()
    out["per_step"] = {r["group"]: {key: r[key] for key in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "one_leaf_ms",
        "one_leaf_device_ms")} for r in out["rows"]}
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
    attention layer of every node, B.1 once per 16 leaves, every step."""
    per = steps * nodes * layers
    return {"flash_attention_fwd": per, "flash_attention_bwd": per,
            "gossip_update_stacked_grouped": steps * -(-leaves // 16)}


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
    if cf["gossip_update_stacked_grouped"][0] != -(-len(pf) // 16) or \
            cu["gossip_update_stacked_grouped"][0] != 0:
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
    held against the fused step's output, row by row.  The one-leaf
    stacked form's path (b1-leaves): the same update leaf by leaf through
    ``gossip_update_stacked``, bit-equal to one grouped call over every
    leaf."""
    import torch

    from repro_torch.core.robust import robust_scale
    from repro_torch.kernels.gossip_update.ops import (
        gossip_update_stacked,
        gossip_update_stacked_grouped,
        gossip_update_tree,
    )
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
    # the stacked form of the same update: one grouped launch over every
    # leaf, then leaf by leaf through the one-leaf calls
    reset_counts()
    grouped = gossip_update_stacked_grouped([state.params[n] for n in names],
                                            [grads[n] for n in names], w, scale, eta=eta)
    one_leaf = [gossip_update_stacked(state.params[n], grads[n], w, scale, eta=eta)
                for n in names]
    torch.cuda.synchronize()
    stacked = kernel_counts()
    check_counts("b1-leaves", stacked, {"gossip_update_stacked_grouped": 1,
                                        "gossip_update_stacked": len(names)})
    leaves_equal = all(torch.equal(a, b) for a, b in zip(grouped, one_leaf))
    fused, _ = trainer.step(state, batch)
    err = max(_rel_err(torch.stack([r[n] for r in rows]), fused.params[n]) for n in names)
    err_stacked = max(_rel_err(g, fused.params[n]) for g, n in zip(grouped, names))
    rec = dict(nodes=K, leaves=len(names), launches=counts["gossip_update"][0],
               stacked_launches=stacked["gossip_update_stacked"][0],
               rel_err_vs_fused_step=err, one_leaf_equals_grouped=leaves_equal,
               grouped_rel_err_vs_fused_step=err_stacked)
    log("[b1-nodes] " + json.dumps(rec))
    if err > STACKED_REL or err_stacked > STACKED_REL:
        raise AssertionError(f"[b1-nodes] per-node or grouped B.1 vs the fused step: {rec}")
    if not leaves_equal:
        raise AssertionError("[b1-nodes] the one-leaf stacked calls are not the grouped call")
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
    b45 = phase_b45_leaves(CompressionConfig)
    b3 = phase_b3_leaves(CompressionConfig)
    b2 = phase_b2_leaves(CompressionConfig)
    phase_profile(TrainerSpec, CompressionConfig)
    phase_cifar(TrainerSpec, CompressionConfig)
    phase_parity(TrainerSpec, CompressionConfig)
    t_codecs = time.perf_counter()
    phase_codecs(TrainerSpec, CompressionConfig)
    sched = phase_schedules(TrainerSpec, CompressionConfig, mlp, cnn)
    log(f"[done] codecs and schedules in {time.perf_counter() - t_codecs:.1f} s")
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
    # launches on each kernel's main path: grouped B.2 the dense int8 fmnist
    # run (and the static EF gossip run), grouped B.3 the static EF gossip
    # run, grouped B.4/B.5 the memoryless dropout run, their one-leaf calls
    # the leaf-by-leaf rounds (b2-leaves, b3-leaves, b45-leaves)
    memoryless = gossip["dropout0.2-int8-kernel-memoryless"]["launches"]
    path = {"quantize_blockwise": b2["launches"],
            "dequant_accumulate": b3["launches"],
            "masked_quantize_blockwise": b45["launches"],
            "masked_dequant_accumulate": b45["launches"],
            "masked_quantize_blockwise_grouped": memoryless,
            "masked_dequant_accumulate_grouped_": memoryless,
            "dequant_accumulate_grouped_": gossip["gossip-int8-kernel-ef"]["launches"],
            "quantize_blockwise_grouped": fm["int8-kernel"]["launches"]}
    # B.1 per node: its own path (b1-nodes); stacked, grouped: the fmnist
    # dense run (and the qwen2-0.5b training run); one leaf at a time:
    # b1-leaves; B.6's backward: the qwen2-0.5b training run
    path["gossip_update"] = {"gossip_update": b1_nodes["launches"]}
    path["gossip_update_stacked"] = {"gossip_update_stacked": b1_nodes["stacked_launches"]}
    path["gossip_update_stacked_grouped"] = fm["none"]["launches"]
    path["flash_attention_bwd"] = {"flash_attention_bwd": lm["launches"]["flash_attention_bwd"]}
    scheduled = {name: sched[name]["tensor_qmax_launches"] for name in (
        "dense-int8-kernel-adaptive", "dense-int8-kernel-linear",
        "gossip-int8-kernel-adaptive", "gossip-int8-kernel-linear")}
    other_runs = {
        "quantize_blockwise_grouped": {
            "gossip-int8-kernel-ef": gossip["gossip-int8-kernel-ef"]["launches"][
                "quantize_blockwise_grouped"],
            **{f"schedules {n}": sched[n]["launches"]["quantize_blockwise_grouped"]
               for n in scheduled}},
        "gossip_update_stacked_grouped": {
            "train-lm": lm["launches"]["gossip_update_stacked_grouped"]}}
    lines = []
    for name, (source, replaces, _) in KERNELS.items():
        if name in ("gossip_update", "gossip_update_stacked"):
            # one call per leaf: the fmnist MLP's (per node), qwen2-0.5b's (stacked)
            rows = [r for r in b1[name]["rows"]
                    if r["group"] == ("mlp" if name == "gossip_update" else "qwen2")]
            step = b1[name]["per_step"][rows[0]["group"]]
            timing = dict(ms=step["ms"], device_ms=step["device_ms"], plain_ms=step["plain_ms"],
                          bound_ms=step["bound_ms"],
                          bound_by="bytes" if {r["bound_by"] for r in rows} == {"bytes"}
                          else "operations", library_ms=None)
            if name == "gossip_update_stacked":  # and at the fmnist MLP's leaves
                timing["mlp"] = b1[name]["per_step"]["mlp"]
            err, launches = b1[name]["max_abs_err"], path[name][name]
        elif name == "gossip_update_stacked_grouped":
            # one call over the fmnist MLP's leaves (the path), beside the six
            # one-leaf calls in the same turns; and over qwen2-0.5b's
            rec = b1[name]
            timing = dict(rec["per_step"]["mlp"], library_ms=None,
                          qwen2=rec["per_step"]["qwen2"],
                          max_group_leaves=rec["max_group_leaves"],
                          stacked_cols=rec["stacked_cols"])
            err, launches = rec["max_abs_err"], path[name][name]
        elif name == "flash_attention_bwd":  # one call at qwen2-0.5b's training shape
            row = bwd["rows"][0]
            timing = {key: row.get(key) for key in FLASH_KEYS}
            err, launches = bwd["max_abs_err"], path[name][name]
        elif name in QUANT:
            step = kern[name]["per_step"]["mlp"]
            bound_by = {r["bound_by"] for r in kern[name]["rows"] if r["group"] == "mlp"}
            # one call per leaf of the fmnist MLP at the main path's shapes
            # (grouped: one call over all of its leaves; and the CNN's)
            timing = dict(ms=step["ms"], device_ms=step["device_ms"], plain_ms=step["plain_ms"],
                          bound_ms=step["bound_ms"],
                          bound_by="bytes" if bound_by == {"bytes"} else "operations",
                          library_ms=None)
            if name in GROUPED:  # beside it, the MLP's six one-leaf calls in the same turns
                row = next(r for r in kern[name]["rows"] if r["group"] == "mlp")
                timing.update(one_leaf_ms=row["one_leaf_ms"],
                              one_leaf_device_ms=row["one_leaf_device_ms"],
                              cnn=kern[name]["per_step"]["cnn"],
                              cluster_size=kern[name]["cluster_size"],
                              max_group_leaves=kern[name]["max_group_leaves"])
            err, launches = kern[name]["max_abs_err"], path[name][name]
        else:  # one call at the main path's shapes: qwen2-0.5b / rwkv6-7b prefill
            row = serve_kern[name]["rows"][0]
            timing = {key: row.get(key) for key in (
                FLASH_KEYS if name == "flash_attention_fwd" else FLASH_KEYS[:6])}
            err = serve_kern[name]["max_abs_err"]
            launches = (qwen if name == "flash_attention_fwd" else rwkv)["launches"]
        if name in other_runs:  # the kernel's launches on the other runs that take it
            timing["launches_other_runs"] = other_runs[name]
        if name == "quantize_blockwise_grouped":
            # qmax a 0-d tensor on the card (a schedule's rate): its launches on
            # the scheduled kernel stacks, and its call on the MLP's leaves
            # timed beside the float form in the same turns
            b2t = sched["b2_tensor_qmax"]
            timing["tensor_qmax"] = dict(
                launches=sum(scheduled.values()), launches_by_run=scheduled,
                max_abs_err=b2t["max_abs_err"],
                **{key: b2t[key] for key in ("ms", "device_ms", "float_ms", "float_device_ms",
                                             "plain_ms", "bound_ms", "bound_by")})
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
