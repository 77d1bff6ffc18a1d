"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the paper's DR-DSGD trainer (Algorithm 2)
over the dense lowering, and over the gossip lowering on a static and a
time-varying topology, checkpointed and resumed, with momentum, nesterov
and Adam, decentralized LM training (attention, RWKV, MoE, the frame
stub), static-batch LM serving (prefill, then greedy decode; a prefix
frontend through decode), the continuous-batching engine over a paged
float32 or int8 KV pool (jamba's mamba rows beside it), a Mamba block at
jamba's width, the ten architectures' smoke configs, and the port's four
examples — on the card through their user entry points,
and holds every CUDA kernel of those paths against its plain PyTorch
version:

  build    nvcc-compiles every kernel source under src/ (one nvcc per
           source, all seven started together), and proves from cuobjdump's
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
           Then the wire's noise (csrc/philox.cu, Philox-4x32-10, the
           round read through a pointer) against its plain version bit for
           bit: the MLP's 6 leaves and the CNN's 12 at K = 10, qwen2-0.5b's
           14 at K = 2, ragged leaves (21, 1 and 45 elements), 20 leaves (2
           launches), a round and a key past 2**32 and a matching, and the
           dynamics' coins at fig9's shapes (five streams in one launch,
           the outage stream through a round divisor); one call per group
           timed against its bound (4 bytes per element).
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
           one grouped launch per step over every leaf: 300 launches, the
           step captured in CUDA graphs, jit=True's default), then
           with the int8 error-feedback wire served by the CUDA quantizer
           (one Philox and one grouped B.2 launch per round: 300 each, the
           step captured); no plain version called; both must print the
           pinned loss_step300, acc_worst_dist and acc_avg to the bit
           (PER_LEAF_DENSE: B.1 once per leaf, and the one-leaf int8 wire
           of tests/pin_noise.py).
  b1-nodes one fmnist dense step recomputed node by node through
           gossip_update_tree (B.1's per-node form, one launch per node
           over its 6 leaves: 10 launches) and held against the fused step,
           each node bit-equal to the plain version; one node's call timed
           against the 6 one-leaf calls in turns and against its bound; and
           (b1-leaves) its stacked update leaf by leaf through
           gossip_update_stacked (6 launches), equal bit for bit to one
           grouped call.
  gossip   the same configuration over the gossip lowering (a pre-built
           mixer handed to TrainerSpec.build, as the reference's benchmarks
           do), 300 steps on each of four stacks: uncompressed static gossip
           (params within 1e-5 of the dense run's after 20 steps, 1e-3 after
           300: the two sum in another order), the static int8 EF
           wire (the step captured; Philox and grouped B.2 once per round:
           300 launches each, and grouped B.3 once per matching: 300 x 5;
           it must print the per-leaf wire's loss_step300, acc_worst_dist
           and acc_avg to the bit, PER_LEAF_TRAJECTORIES), and dropout p =
           0.2 with the memoryless masked
           int8 wire (Philox, grouped B.4 + B.5: 300 x 5 launches each) and
           the EF wire re-based every 4 rounds (Philox and grouped B.4 once
           per round, B.5 once per matching of a delta round), each with the
           dropout coins (one Philox launch per round), both captured; every count
           of launches is checked, and both dropout stacks must print the
           pinned loss_step300, acc_worst_dist and acc_avg to the bit
           (ONE_LEAF_TRAJECTORIES).  Then the CNN
           (cifar_default, clipped at norm 2) on the static int8 EF gossip
           wire for 20 steps with cuDNN held deterministic, so B.3 runs on
           512,000-wide rows; its losses must be the per-leaf wire's to
           the bit (PER_LEAF_CIFAR).  The pins are what
           tests/pin_noise.py prints from the wire as it was before it was
           grouped: the eager step (jit=False), each round leaf by leaf
           through the one-leaf kernels, each leaf's noise drawn alone by
           the plain Philox.
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
           55, lr 0.18, 100 steps (the figure's 400, quartered), clipped at 2
           as the figure's runner clips, lr_compensate off): dense none (fused B.1), bf16, int8,
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
           linear rate on the card equal to hi + (lo - hi)·min(r/150, 1);
           14 rounds of each scheduled kernel stack (dense and gossip EF,
           adaptive and linear) against the CPU with the same uniforms; one
           scheduled round synchronising no more than an unscheduled one
           (CUDA's sync debug mode); then 150 fmnist steps (fig8's 600,
           quartered) of int8_fixed,
           int4_fixed, int8_adaptive (threshold 1, warmup 10) and
           int8_linear (anneal 75) on the per-node quantizer, and of
           int8_adaptive and int8_linear on the kernel quantizer over the
           dense and the gossip EF lowering (B.2 with the rate as qmax once
           per round: every launch counted as a tensor-qmax launch), each
           printing its rate at rounds 0, 10 and the last, its wire bits and
           worst-distribution accuracy.
  dynamics fig9's local-update rows and faults on fig7's task (K = 8 ring,
           DR-DSGD mu = 3, B = 55, lr 0.18, clipped at 2, 100 steps: the
           figure's 400, quartered), every row through the captured step
           (the coins drawn on the card: one Philox launch per draw of a
           round's W_r or fault masks, counted; the run's W_r and fault
           masks on the card bit-equal to the CPU's over its rounds): dense
           dropout 0.2 at H = 2 and 4 and at H = 4 with gradient tracking
           (its consensus rounds bill 2x the H = 4 run's, local rounds 0);
           dense stragglers 0.1 with outages 0.05 over windows of 10, with
           and without straggler_skips_compute; the memoryless int8 gossip
           wire under stragglers 0.1 (grouped B.4 and B.5 once per matching
           per round, held against their plain versions bit for bit on
           three rounds in which a straggler's row is masked in every
           matching); the EF int8 gossip wire re-based every 4 rounds under
           dropout 0.2 inside LocalUpdateMixer(H = 2) (grouped B.4 once per
           consensus round, grouped B.5 once per matching of a delta round
           on the EF clock, no launch on a local round, checked round by
           round).  Each row prints worst-distribution accuracy, total wire
           bytes, the median synchronised ms per step, the observed
           straggler, outage and link-keep rates against the configured
           ones (held within RATE_SIGMAS) and its launches.  Before them,
           12 rounds of each new mixer (faulted dense and memoryless gossip,
           dense gradient tracking, EF gossip under H = 2, the hub, the int8
           hub under H = 4, a repeated dense round) on the card against the
           CPU with the same fault masks, W_r and uniforms, within
           DYN_UPDATE_REL of the round's largest update, wire bits equal.
  hub      fig11 without its hierarchical row, captured: gossip over the static ring,
           the hub at H = 1 (disagreement at float noise at the end), FedAvg
           and SCAFFOLD at H = 4 (SCAFFOLD's consensus rounds bill 2x), and
           int8 FedAvg at H = 4 on the kernel quantizer (grouped B.2 over the
           star W once per consensus round: 25 launches).
  ckpt     fig7's fmnist task (K = 8 ring) through the fused B.1 step, the
           EF int8 gossip wire re-based every 4 under dropout 0.2 and the
           memoryless int8 gossip wire under stragglers 0.1: saved at step
           150 of 300 (save_train_state), restored (restore_train_state)
           and resumed; the restored state and the resumed run's every
           leaf and metric equal the uninterrupted run's bit for bit.  A
           qwen2-0.5b train state cut to 2 layers at K = 4 with a bfloat16
           leaf round-trips bit for bit; seconds to save and restore and
           the file's bytes printed.
  optim    fmnist_default's dense stack (K = 10, ER(0.3), DR-DSGD) for 50
           steps with chain_clip(momentum(cosine_schedule), 2), nesterov
           momentum and adam(linear_warmup_cosine, weight decay, eps 1e-6)
           through TrainerSpec.build(optimizer=...): the unfused step, no
           launch; the card against the CPU within OPTIM_UPDATE_REL of the
           largest update, the first batch's loss lower after the run.
  obs      A.13: the train CLI's ``--paper fmnist --log-dir D --profile
           --sanitize`` (300 steps, grouped B.1 300 times; the JSONL valid,
           300 train records, vectors every 8th, a perf record per segment;
           B.1's kernel and the obs: ranges in the Chrome trace); through
           the trainer API the same run with the sink off, on, on, off
           (metrics and final parameters bit-equal, each run's seconds),
           the int8 wire on the kernel quantizer with the sink and the
           sanitizer (grouped B.2 300 times, no check fired), then
           one injected violation per check (a W row off by 1e-2, a NaN in
           a node, a qmax of 128, a half link mask on the straggler gossip
           stack) firing that check first at its step; the memoryless int8
           gossip wire under stragglers 0.2 with the sink and the sanitizer
           (grouped B.4 and B.5 once per matching per round), its report's
           fault replay on the card naming exactly the straggler rounds
           the mixer applied; audit_host_syncs of one fmnist step (dense
           and int8) with the sink and sanitizer off and on, on never
           above off.  Each part's wall seconds.  The engine phase's
           float32 CLI run writes its JSONL under ``--log-dir``.
  bwd-kernel  B.6's backward against autograd of the plain version at
           qwen2-0.5b's training shapes (the node axis's B 16 = K 8 x B 2
           and B 2, H 14/2, hd 64, S = T = 64; B 2 at 512),
           deepseek-moe-16b's (B 2, H 16/16, S 64, hd 128) and
           musicgen-medium's (B 2, H 24/24, S 320, hd 64), and at the
           serving shapes below, dq, dk and dv within
           BWD_REL of their largest |value|; times as below, with SDPA's
           backward as the yardstick (never on the path): its backend
           pinned (sdpa_yardstick), timed as a call and as device time.
  compiled A.14's captured step against the eager one: the same weights
           and batches through jit=False and jit=True in turns (eager,
           captured, captured, eager) in one process, fmnist dense-none (300
           steps, the fused step), the unfused step on fmnist (100 steps
           each: the dense int8 EF wire through B.2, static gossip with it
           (B.2 and B.3), the dense int8 wire under fig8's adaptive
           schedule, Nesterov momentum and Adam over the dense W),
           qwen2-0.5b at full width and depth (K = 8, seq 64, 5 steps, the
           fused step) and with Nesterov momentum and the dense int8 EF
           wire (K = 4, ring, 5 steps): the final carry (parameters,
           optimizer state, CommState tensors), host fields and metrics
           bit-equal to the first eager turn's, one captured program per
           trainer (the watchdog), exact launches (one Philox and one B.2
           per round, B.3 per matching, B.2 reading qmax on the card under
           the schedule), the counters' launches of a profiled run equal
           to the profiler's, the captured qwen2 steps' peak memory no
           more than the eager steps' (within COMPILED_PEAK_MARGIN of a
           node-stacked copy); ms per step, device ops per step, busy
           share, peak memory per turn.  Then A.14 (c), one graph per
           branch the host chooses (the watchdog's programs: the distinct
           branches met): fig9/fig11's stacks on their task (K = 8 ring,
           100 steps a turn: dense dropout under H = 4 with gradient
           tracking, stragglers and outages skipping compute, the
           memoryless int8 gossip under stragglers, the EF int8 gossip
           re-based every 4 under H = 2 and with the adaptive trigger,
           geometric re-draws, int8 FedAvg at H = 4, the hub at H = 1,
           mix_every = 2, RepeatMixer(gossip int8 EF, 2)) and qwen2-0.5b
           at full width and depth over the EF int8 gossip under dropout
           0.2 re-based every 4 (K = COMPILED_LM_DYN_NODES, 8 steps: both
           graphs replay), held as above, the coins' Philox launches
           counted.
  train-lm qwen2-0.5b at full width and depth through the training CLI
           (train_lm's defaults: K = 8 ring, batch 2, seq 64, lr 0.01, clip
           1; the step captured), 20 steps: B.6 forward and backward 24 per
           step (the node axis: K x B = 16 rows in one launch per layer),
           grouped B.1 once per step over the 14 leaves, no plain call; every
           metric finite, the first batch's loss lower after the run, ms
           per step, tokens per second, peak memory, one profiled step
           (with B.6's device time in it); the TMA audit around the run (the
           warm-up step's and the capture's B.6 calls).  Then seq 512 at
           K = 4, 5 steps (multi-tile B.6 backward).
  train-parity  qwen2-0.5b cut to 2 layers at full width, K = 4, 3 steps:
           the same weights and tokens on the card and on the CPU, losses
           and every leaf within TRAIN_PARITY_REL, updates within
           UPDATE_REL; one fused step (B.1) against the unfused step from
           the same state on the card.
  train-rwkv  B.7 forward and its backward kernel at rwkv6-7b's training
           shape (B 2, H 64, T 64, hd 64), at hd 16, with w = 1e-6 and the
           init's decay from a given state with the final state's cotangent
           (WKV6_TRAIN_CASES): the forward against its plain version at
           SERVE_TOL, the backward against its plain version (an explicit
           reverse loop) and against autograd of the plain forward on the
           card, each gradient within WKV_BWD_REL of its largest |value|, two
           backward calls equal bit for bit; timed, the backward beside its
           first design's time at the same shape (PARENT_BWD_US).  Then
           ``train --arch
           rwkv6_7b --smoke`` (3 steps), rwkv6-7b at full width cut to 2
           layers at K = 4 (batch 2, seq 64, 10 steps: B.7 forward and
           backward 2 x 4 per step, grouped B.1 twice per step over the 23
           leaves, exact; the first batch's loss lower after the run; ms per
           step, peak memory, one profiled step's busy share) and cut to 1
           layer at K = 2 on the card against the CPU (5 steps, as
           train-parity: losses and every leaf within TRAIN_PARITY_REL;
           every entry's update within RWKV_UPDATE_REL of the largest
           update, or within UPDATE_ULPS ulps of its own value).
  serve-kernel  flash attention (B.6) at qwen2-0.5b's prefill and training
           shapes (B 2 and the folded B 16), at hd 80 and 128 with windows 4096 and 64 and gemma2's
           softcap 50, at G = 1, at a ragged S = 300, at the LM example's
           hd 32 (HD32_CASE; bwd-kernel too) and on A.11's paths
           (A11_FWD_CASES: deepseek-moe-16b's prefill and training shape at
           hd 128, musicgen-medium's S = 320); the WKV6 scan (B.7)
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
  engine   B.2 at the KV writes (k and v of a layer in one launch: 1 to 8
           rows of D = 128, an admission's 456 rows, gemma2's D = 2048)
           bit-equal to its plain version, B.6 (batch 1, S = 5 and 19, and
           gemma2's hd 128 with softcap) and B.7 (batch 1, T = 5 and 19) at
           the admission shapes at SERVE_TOL, timed.  Then the main path:
           ``serve --engine`` and ``--engine --int8-kv`` (qwen2-0.5b at full
           width and depth, 4 slots, 8-token pages, SMOKE_CLASSES at 2
           requests/s for 8 s, the wall clock), every launch counted
           (_engine_launches) and no plain call; decode ms per step, TTFT and
           per-token percentiles, peak memory.  On the steps clock: float32
           engine tokens equal each request's isolated greedy tokens up to a
           near tie, int8 diverging from float32 only where the top-2 margin
           is below twice the row's measured logit error; 2 layers card vs
           CPU at SERVE_PARITY_REL; rwkv6-7b and gemma2 (int8 too) at 2
           layers, launches counted, tokens against isolated greedy.
  train-moe  deepseek-moe-16b at its published width (d_model 2048, 16
           heads of 128, 64 routed experts of 1,408 top-6 + 2 shared, vocab
           102,400) cut to 2 layers (the dense first layer and one MoE
           layer, ~1.03 B parameters) at K = 4 on train_lm's stack (batch
           2, seq 64, 5 steps): B.6 forward and backward at hd 128 on both
           layers of every node and grouped B.1 twice per step, exact; the
           first batch's loss lower after the run, the aux term finite and
           positive; ms per step, peak memory, one profiled step.  One MoE
           layer (first_k_dense 0) at K = 2 on the card against the CPU
           (_card_vs_cpu).
  frontend musicgen-medium at its published width (d_model 1536, 24 heads
           of 64, vocab 2048) with the frame stub's 256 frames before 64
           text tokens: 2 layers at K = 4, 5 steps (B.6 forward and
           backward at S = 320), 1 layer at K = 2 against the CPU, and all
           48 layers served through the decode path (no kernel; tokens
           equal greedy_generate's).
  serve-moe  deepseek-moe-16b, 2 layers at full width: timed_generate
           (batch 4, prompt 256, 32 tokens; B.6 at hd 128 once per
           attention layer per prefill); card vs CPU at prompt 32: every
           MoE call's routing (expert choices, ranks, drops) equal up to a
           near tie, logits, caches and 8 greedy tokens at
           SERVE_PARITY_REL.
  mamba-layer  one Mamba block at jamba-1.5-large's width (d_model 8192,
           d_inner 16384, d_state 16, dt_rank 512; ~420 M parameters):
           prefill 4 x 256 tokens and 32 decode steps timed, decode against
           one forward, card vs CPU at B 2, S 32 (output, conv and SSM
           states).
  smoke-archs  grok-1, deepseek-moe, jamba, pixtral and musicgen at their
           smoke configs: the serving and training CLIs (launches exact),
           serving and 2 node-stacked train steps card vs CPU, and jamba
           through ``serve --engine --int8-kv`` (B.2 on its attention KV
           rows, B.6 on admissions, exact).
  examples the port's four examples through their main(argv) at their
           defaults with cut steps: examples/torch_quickstart.py (100
           steps) and torch_decentralized_fmnist.py (T = 100, both runs)
           through grouped B.1, torch_train_lm_drdsgd.py (5 steps at K = 8,
           batch 4, seq 128, head dim 32: B.6 forward and backward on every
           layer of every node; then --full-width, 2 steps, peak memory),
           torch_serve_decode.py (rwkv6 smoke: B.7 at the static batch's
           prefill and each admission); exact launches, wall time each.

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

import gc
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
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 on the tensor cores, dense
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
    # the backward of B.7: the reference differentiates its XLA scan
    "wkv6_bwd": (SRC + "rwkv6_scan/csrc/wkv6_bwd.cu", TPU + "rwkv6_scan/kernel.py:65",
                 ("wkv6_bwd_kernel", "wkv6_du_kernel")),
    # the wire's noise, the port's own kernel: no TPU kernel, the reference
    # draws jax.random (threefry) inside its jitted step
    "uniforms_grouped": (SRC + "quant_gossip/csrc/philox.cu",
                         "none on the TPU: jax.random inside the step, "
                         "src/repro/comm/composed.py:492",
                         ("philox_uniforms_kernel",)),
}
QUANT = tuple(KERNELS)[:8]   # the quant_gossip wrappers
GROUPED = QUANT[4:]
ONE_LEAF = {"masked_quantize_blockwise_grouped": "masked_quantize_blockwise",
            "masked_dequant_accumulate_grouped_": "masked_dequant_accumulate",
            "dequant_accumulate_grouped_": "dequant_accumulate",
            "quantize_blockwise_grouped": "quantize_blockwise"}
# (loss_step300, acc_worst_dist, acc_avg) that these stacks printed on an
# H100 in two runs of one call of tests/pin_noise.py through the one-leaf
# masked wire (B.4 and B.5 per leaf and matching, each leaf's noise drawn
# alone by the plain Philox, the dropout W_r from the plain Philox coins,
# the eager step): the grouped wire with the Philox kernel, captured,
# prints them to the bit
ONE_LEAF_TRAJECTORIES = {
    "dropout0.2-int8-kernel-memoryless": (0.5014004111289978, 0.4350000023841858,
                                          0.6884999871253967),
    "dropout0.2-int8-kernel-ef-B4": (0.4852026402950287, 0.5199999809265137,
                                     0.7020000219345093),
}
# the same three of the static int8 EF stack, through the per-leaf wire in
# the same runs (one-leaf B.2 and B.3, plain noise per leaf): grouped B.2
# and B.3, the Philox kernel and the captured step change no bit
PER_LEAF_TRAJECTORIES = {
    "gossip-int8-kernel-ef": (0.4425292909145355, 0.5299999713897705, 0.7099999189376831),
}
# the same three of the fmnist dense runs: uncompressed (the fused step,
# which an earlier tree printed through B.1 once per leaf, no noise) and
# int8 EF (the one-leaf B.2 with plain noise per leaf, tests/pin_noise.py's
# runs): grouped B.1 and B.2, the Philox kernel and the captured steps
# change no bit
PER_LEAF_DENSE = {
    "none": (0.4424481987953186, 0.5299999713897705, 0.7099999189376831),
    "int8-kernel": (0.4425012171268463, 0.5299999713897705, 0.7099999189376831),
}
# (loss_step0, loss_last, loss_worst_max) of the CIFAR static EF gossip run
# (20 steps) with cuDNN held deterministic, the per-leaf wire's (as for
# PER_LEAF_TRAJECTORIES) in two runs of tests/pin_noise.py on an H100;
# without that cuDNN's convolution backward moves loss_last between runs
PER_LEAF_CIFAR = (2.761140823364258, 1.7315807342529297, 3.964625358581543)


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


def profiled(fn, iters: int, lead: int = 0):
    """Run ``fn`` ``iters`` times under torch.profiler after one warm-up
    call; inside the window, ``lead`` one-float fills run first (see
    device_time).  Returns (wall seconds of the calls, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    buf = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            buf.fill_(0.0)
        torch.cuda.synchronize()
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


PROFILE_LEAD = 64  # launches that open a device_time window, 4x more on each retry


def device_time(fn, iters: int, names, tries: int = 4) -> dict:
    """Device time of one ``fn()`` that launches each kernel of ``names``
    once, under the profiler: ``{"device_ms": ms}``.  Late in a run the
    profiler loses the first launches of a window (seen on the H100: the
    first one after ~25 s of work, all seven of a short window after ~5
    minutes; a host sleep in the window does not help, launches before
    the calls do), so each window opens with PROFILE_LEAD one-float fills,
    four times as many on each retry, which take the loss.  A window that
    still recorded no launch of a kernel is logged with what it did
    record; after ``tries`` such windows the time comes from CUDA events
    (queued_device_ms), which also count the gaps between launches and
    anything else ``fn`` queues, and the result says so:
    ``"device_source": "cuda events"``."""
    for attempt in range(tries):
        _, prof = profiled(fn, iters, PROFILE_LEAD * 4 ** attempt)
        averages = prof.key_averages()
        try:
            return {"device_ms": device_us_per_call(averages, names) / 1e3}
        except AssertionError:
            seen = sorted(((e.count, e.key[:40]) for e in device_events(averages)),
                          reverse=True)
            log(f"[profile] no launch of {names} recorded in window {attempt + 1} "
                f"({PROFILE_LEAD * 4 ** attempt} fills first); it recorded {len(seen)} "
                f"device entries {seen[:4]}")
    ms = queued_device_ms(fn, iters)
    log(f"[profile] no launch of {names} in {tries} windows: {ms} ms per call from CUDA "
        f"events behind a sleep kernel (queued_device_ms)")
    return {"device_ms": ms, "device_source": "cuda events"}


def device_ms(fn, iters: int, names) -> float:
    """device_time's milliseconds alone (the variant scripts under tests/
    call this name in this tree and in older ones)."""
    return device_time(fn, iters, names)["device_ms"]


def timing_keys(row: dict, keys) -> dict:
    """``row``'s ``keys`` (None where absent), and its device_source where
    it has one."""
    out = {key: row.get(key) for key in keys}
    if "device_source" in row:
        out["device_source"] = row["device_source"]
    return out


def queued_device_ms(fn, iters: int) -> float:
    """Device time (ms) of one ``fn()`` from two CUDA events around
    ``iters`` calls queued behind a ~50 ms sleep kernel: the host enqueues
    every call before the device reaches them, so the events time the
    device running them back to back (the gaps between launches
    included).  For calls that do not wait for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's ~1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    # B.6's and B.7's dispatchers count the plain version's calls of both directions
    out["flash_attention_bwd"] = (fk.flash_attention_bwd, fops.flash_attention)
    out["wkv6_bwd"] = (wk.wkv6_bwd, wops.wkv6)
    out["uniforms_grouped"] = (qk.uniforms_grouped, qops.uniforms_grouped)
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
# cores (bwd_reduce_kernel, the sum of the backward's partials, does none),
# the float32 ones as TF32 products, the forward's bfloat16 instances
# (flash_fwd_bf16_kernel) as bfloat16 ones
TENSOR_CORE_KERNELS = {"flash_attention/csrc/flash_fwd.cu": ("flash_fwd_mma_kernel",
                                                             "flash_fwd_bf16_kernel"),
                       "flash_attention/csrc/flash_bwd.cu": ("bwd_mma_kernel",)}
TF32_MMA = re.compile(r"\bHG?MMA\.[\w.]*TF32")
BF16_MMA = re.compile(r"\bHG?MMA\.[\w.]*BF16")


def mma_counts(lib: Path, pattern=TF32_MMA) -> dict[str, int]:
    """{kernel function (mangled): its tensor-core instructions of
    ``pattern``'s operand type (HMMA or HGMMA; TF32 by default)} in the SASS
    that cuobjdump prints."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and pattern.search(line):
            counts[fn] += 1
    return counts


def phase_build() -> dict:
    """Builds every source, logs ptxas's registers and spills, and proves
    from the SASS that each of B.6's product kernels, at every head dim it
    is built for, runs TF32 tensor-core instructions (the bfloat16 forward:
    bfloat16 ones, and no TF32); raises if one has none.  Returns {kernel
    function: tensor-core instructions}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS, HEAD_DIMS

    # an instance per head dim: (count, dims, the products' type)
    instances = {"flash_fwd_mma_kernel": (len(HEAD_DIMS), HEAD_DIMS, TF32_MMA),
                 "flash_fwd_bf16_kernel": (len(HEAD_DIMS), HEAD_DIMS, BF16_MMA),
                 "bwd_mma_kernel": (len(BWD_HEAD_DIMS), BWD_HEAD_DIMS, TF32_MMA)}
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
        tf32 = mma_counts(built[source][0])
        for name in names:
            want, dims, pattern = instances[name]
            counts = tf32 if pattern is TF32_MMA else mma_counts(built[source][0], pattern)
            fns = {fn: n for fn, n in counts.items() if name in fn}
            kind = "TF32" if pattern is TF32_MMA else "bfloat16"
            log(f"[build] {source}: {kind} tensor-core instructions of {name}: {fns}")
            if len(fns) != want or not all(fns.values()):
                raise AssertionError(f"[build] {name} must be built {want} times (head dims "
                                     f"{dims}) with {kind} HMMA/HGMMA in every instance: {fns}")
            if pattern is not TF32_MMA and any(tf32[fn] for fn in fns):
                raise AssertionError(f"[build] {name} runs TF32 products: "
                                     f"{ {fn: tf32[fn] for fn in fns} }")
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
            plain_ms = cuda_ms(plain, iters=50, warmup=5)
            dev = device_time(call, 50, KERNELS[name][2])
            dev_ms = dev["device_ms"]
            bound, by = kernel_bound(name, k, d, n_blk)
            out[name]["rows"].append(dict(group=group, leaf=leaf, k=k, d=d, blocks=n_blk, ms=ms,
                                          **dev, plain_ms=plain_ms, bound_ms=bound,
                                          bound_by=by))
            log(f"[kernel] {name:25s} {group:6s} {leaf:9s} K={k:2d} D={d:7d} "
                f"blocks={n_blk:3d} device {1e3 * dev_ms:7.2f} us  call {1e3 * ms:7.2f} us  "
                f"plain {1e3 * plain_ms:7.2f} us  bound {1e3 * bound:7.3f} us ({by})")
    for name, rec in out.items():
        rec["per_step"] = {g: {key: sum(r[key] for r in rec["rows"] if r["group"] == g)
                               for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
                           for g in ("mlp", "cnn")}
        for g, v in rec["per_step"].items():  # a sum with a term from CUDA events says so
            if any("device_source" in r for r in rec["rows"] if r["group"] == g):
                v["device_source"] = "cuda events"
        for g, v in rec["per_step"].items():
            log(f"[kernel] {name}: one call per {g} leaf: device {1e3 * v['device_ms']:.2f} us, "
                f"call {1e3 * v['ms']:.2f} us, plain {1e3 * v['plain_ms']:.2f} us, "
                f"bound {1e3 * v['bound_ms']:.3f} us; equal to plain everywhere "
                f"(max abs err {rec['max_abs_err']})")
    out.update(_grouped_kernels(mlp_leaves, cnn_leaves, fmnist_srcs, gen))
    out.update(_philox_kernel(mlp_leaves, cnn_leaves))
    return out


def _philox_kernel(mlp_leaves, cnn_leaves) -> dict:
    """The wire's uniforms (csrc/philox.cu) against their plain version on
    the card, bit for bit: the MLP's 6 leaves and the CNN's 12 at K = 10,
    qwen2-0.5b's 14 leaves at K = COMPILED_LM_UNFUSED_NODES, the shapes
    the compiled phase's qwen2 int8 EF turn draws at (each leaf's plain
    draw alone: the draw is a pure function of its coordinates), leaves of
    21 and 1 elements (not multiples of 4), a split of 20 leaves over the
    16 of a launch (2 launches), a round past 2**32, a key past 2**32 and
    a matching; and the dynamics' coins at fig9's shapes (K = 8: the
    fault links, stragglers and outages, the last at its window through
    a round divisor of 10, a dropout schedule's links and a geometric
    re-draw's points, at their stream leaves, in one launch).  Times one
    call per group (device under the profiler, call back to back) beside
    its bound: 4 bytes written per element at HBM_BYTES_PER_S.  No PyTorch
    call draws this function (library null)."""
    import torch

    from repro_torch.dynamics import coins
    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ref as qref

    def like(k, shape):  # the shape and device, no storage
        return torch.empty((), device="cuda").expand((k, *shape))

    lm = _serve_model(LM_ARCH)
    coin_streams = (coins.LINKS, coins.STRAGGLERS, coins.OUTAGES, coins.DROPOUT, coins.GEOMETRIC)
    groups = {"mlp": [like(K, (d,)) for _, d in mlp_leaves],
              "cnn": [like(K, (d,)) for _, d in cnn_leaves],
              "qwen2": [like(COMPILED_LM_UNFUSED_NODES, tuple(t.shape))
                        for t in lm.param_shapes().values()],
              "ragged": [like(3, (7,)), like(1, (1,)), like(5, (9,))],
              "split": [like(2, (n,)) for n in range(1, 21)],
              "coins": [like(FIG_K, (FIG_K,)), like(1, (FIG_K,)), like(1, (FIG_K,)),
                        like(FIG_K, (FIG_K,)), like(FIG_K, (2,))]}
    coords = {"mlp": (0, 0, 0), "cnn": (5, 17, 0), "qwen2": (0, 3, 0),
              "ragged": (2 ** 40 + 99, 2 ** 32 + 5, 3), "split": (7, 123, 2),
              "coins": (coins.coin_key(0), 37, 0)}
    # the coins' leaves and round divisors (the outage stream at its window)
    extra = {"coins": dict(leaves=list(coin_streams),
                           divisors=[1, 1, FIG9_FAULTS["outage_len"], 1, 1])}
    rec = dict(max_abs_err=0.0, rows=[], max_group_leaves=qk.philox_config()["max_group_leaves"],
               threads=qk.philox_config()["threads"])
    if (rec["max_group_leaves"], rec["threads"]) != (qk.MAX_GROUP_LEAVES, qk.PHILOX_THREADS):
        raise AssertionError(f"[kernel] uniforms_grouped is built with {rec}, the wrapper "
                             f"states ({qk.MAX_GROUP_LEAVES}, {qk.PHILOX_THREADS})")
    for group, xs in groups.items():
        key, rnd, matching = coords[group]
        r = torch.full((), rnd, dtype=torch.int64, device="cuda")
        kw = extra.get(group, {})
        reset_counts()
        got = qk.uniforms_grouped(xs, key, r, matching=matching, **kw)
        launches = qk.uniforms_grouped.launches
        want_launches = -(-len(xs) // qk.MAX_GROUP_LEAVES)
        if launches != want_launches:
            raise AssertionError(f"[kernel] uniforms_grouped {group}: {launches} launches, "
                                 f"want {want_launches}")
        for i, (x, u) in enumerate(zip(xs, got)):
            one = {f: [v[i]] for f, v in kw.items()} if kw else dict(leaves=[i])
            want = qref.uniforms_grouped_ref([x], key, r, matching=matching, **one)[0]
            err = _max_diff(u, want)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if u.shape != x.shape or not torch.equal(u, want):
                raise AssertionError(f"[kernel] uniforms_grouped {group} leaf {i} "
                                     f"{tuple(x.shape)}: kernel != plain (max abs err {err})")
            del want
        del got
        torch.cuda.synchronize()
        if group not in ("mlp", "cnn", "qwen2", "coins"):
            continue
        call = lambda: qk.uniforms_grouped(xs, key, r, matching=matching, **kw)
        plain = lambda: qref.uniforms_grouped_ref(xs, key, r, matching=matching, **kw)
        big = group == "qwen2"
        ms = cuda_ms(call, iters=20 if big else 200, warmup=3 if big else 20)
        plain_ms = cuda_ms(plain, iters=2 if big else 20, warmup=1 if big else 3)
        dev = device_time(call, 10 if big else 50, KERNELS["uniforms_grouped"][2])
        n = sum(x.numel() for x in xs)
        bound = 1e3 * 4 * n / HBM_BYTES_PER_S
        row = dict(group=group, leaves=len(xs), k=xs[0].shape[0], elements=n, ms=ms, **dev,
                   plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None)
        rec["rows"].append(row)
        log(f"[kernel] uniforms_grouped {group:6s} {len(xs):2d} leaves K={xs[0].shape[0]:2d} "
            f"{n:11d} elements device {1e3 * dev['device_ms']:10.2f} us  call "
            f"{1e3 * ms:10.2f} us  plain {1e3 * plain_ms:12.2f} us  bound {1e3 * bound:9.3f} us")
        torch.cuda.empty_cache()
    rec["per_step"] = {r["group"]: r for r in rec["rows"]}
    log(f"[kernel] uniforms_grouped: equal to plain everywhere (max abs err "
        f"{rec['max_abs_err']})")
    return {"uniforms_grouped": rec}


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
        check_counts(f"fmnist {wire}", counts,
                     {"quantize_blockwise_grouped": exp.steps, "uniforms_grouped": exp.steps}
                     if wire == "int8-kernel" else {"gossip_update_stacked_grouped": exp.steps,
                                                    "uniforms_grouped": 0})
        got = (rec["loss_step300"], rec["acc_worst_dist"], rec["acc_avg"])
        if got != PER_LEAF_DENSE[wire]:
            raise AssertionError(f"[fmnist] {wire}: (loss_step300, acc_worst_dist, acc_avg) = "
                                 f"{got}, the pinned run printed {PER_LEAF_DENSE[wire]}")
        log(f"[fmnist] {wire}: loss_step300, acc_worst_dist and acc_avg are the pinned "
            f"run's to the bit")
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
    a round that sends payloads; the noise (one Philox launch per 16
    leaves) drawn where B.2 or B.4 quantizes, and the dropout schedule's
    coins (one Philox launch per round)."""
    groups = -(-leaves // 16)
    if stack == "gossip-int8-kernel-ef":
        return {"quantize_blockwise_grouped": steps * groups,
                "dequant_accumulate_grouped_": steps * matchings,
                "uniforms_grouped": steps * groups}
    if stack == "dropout0.2-int8-kernel-memoryless":
        return {"masked_quantize_blockwise_grouped": steps * matchings,
                "masked_dequant_accumulate_grouped_": steps * matchings,
                "uniforms_grouped": steps * matchings * groups + steps}
    if stack == "dropout0.2-int8-kernel-ef-B4":
        delta_rounds = sum(1 for r in range(steps) if r % REBASE_EVERY != REBASE_EVERY - 1)
        return {"masked_quantize_blockwise_grouped": steps,
                "masked_dequant_accumulate_grouped_": delta_rounds * matchings,
                "uniforms_grouped": steps * groups + steps}
    return {"uniforms_grouped": 0}


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
            wire = "one-leaf masked" if stack in ONE_LEAF_TRAJECTORIES else "per-leaf"
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
    # the wire's noise per matching, and the round's dropout coins (one draw)
    check_counts("b45-leaves grouped", kernel_counts(),
                 {"masked_quantize_blockwise_grouped": m,
                  "masked_dequant_accumulate_grouped_": m, "uniforms_grouped": m + 1})
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
                  "masked_dequant_accumulate": len(theta) * m,
                  "uniforms_grouped": len(theta) * m})  # each leaf's noise drawn alone
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
                 {"quantize_blockwise_grouped": 2, "dequant_accumulate_grouped_": 2 * m,
                  "uniforms_grouped": 2})
    check_counts("b3-leaves per-leaf", counts["per-leaf"],
                 {"quantize_blockwise_grouped": 2, "dequant_accumulate": 2 * leaves * m,
                  "uniforms_grouped": 2})
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
    check_counts("b2-leaves grouped", counts["grouped"],
                 {"quantize_blockwise_grouped": 2, "uniforms_grouped": 2})
    check_counts("b2-leaves per-leaf", counts["per-leaf"],
                 {"quantize_blockwise": 2 * leaves, "uniforms_grouped": 2})
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


def _gossip_cifar(spec_cls, cfg_cls, jit: bool = True, pinned: bool = True) -> dict:
    """The CNN on the static int8 EF gossip wire: B.3 on 512,000-wide rows,
    with cuDNN held deterministic so that the run prints the per-leaf
    wire's losses to the bit (PER_LEAF_CIFAR; ``pinned=False`` leaves them
    unchecked: ``tests/pin_noise.py`` prints them with ``jit=False``, through
    the per-leaf wire and through this one)."""
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
                    device="cuda", jit=jit)
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
    if not pinned:
        return rec
    if got != PER_LEAF_CIFAR:
        raise AssertionError(f"[gossip] cifar: (loss_step0, loss_last, loss_worst_max) = {got}, "
                             f"the per-leaf wire printed {PER_LEAF_CIFAR}")
    log("[gossip] cifar: loss_step0, loss_last and loss_worst_max are the per-leaf wire's "
        "to the bit")
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
    check_counts("cifar", counts, {"quantize_blockwise_grouped": CIFAR_STEPS,
                                   "uniforms_grouped": CIFAR_STEPS})
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
FIG7_STEPS = 100           # fig7's 400 steps, quartered to keep the smoke in its time
FIG7_FMNIST = (55, 0.18)   # batch, lr (benchmarks/fig7_compression.py _TASK)
FIG7_CIFAR = (40, 0.05)
FIG7_RATIO = 0.02          # topk2pct
FIG8_STEPS = 150           # fig8's 600 steps, quartered likewise
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
    55, lr 0.18, FIG7_STEPS steps, clipped at 2, lr_compensate off) over the
    dense lowering — none (the fused B.1 step), bf16, int8, int4, topk 2 % (EF,
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
    noise = {"uniforms_grouped": FIG7_STEPS}  # every codec's round draws (6 leaves)
    for name, cfg in dense.items():
        want = {"none": {"gossip_update_stacked_grouped": FIG7_STEPS},
                "int8-kernel": {"quantize_blockwise_grouped": FIG7_STEPS, **noise}
                }.get(name, noise)
        out[f"dense-{name}"] = _fig_run("codecs", f"dense-{name}",
                                        _fig_spec(spec_cls, cfg, FIG7_FMNIST), "mlp", data,
                                        FIG7_STEPS, want)
    decomp = _ring_decomp()
    for kind in ("topk", "randk"):
        mixer = CompressedGossipMixer(decomp, cfg_cls(kind=kind, ratio=FIG7_RATIO))
        name = f"gossip-{kind}2pct"
        out[name] = _fig_run("codecs", name, _fig_spec(spec_cls, mixer.compression, FIG7_FMNIST),
                             "mlp", data, FIG7_STEPS, noise, mixer=mixer)
    cifar = _fig_data("cnn", CIFAR_STEPS, FIG7_CIFAR[0])
    for name, cfg in (("int4", cfg_cls(kind="int4")),
                      ("topk2pct", cfg_cls(kind="topk", ratio=FIG7_RATIO))):
        out[f"cifar-{name}"] = _fig_run("codecs", f"cifar-dense-{name}",
                                        _fig_spec(spec_cls, cfg, FIG7_CIFAR), "cnn", cifar,
                                        CIFAR_STEPS, {"uniforms_grouped": CIFAR_STEPS})
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
    hi + (lo - hi)·min(r / FIG8_ANNEAL, 1) in float32 bit for bit."""
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


def _sync_counts(cfg_cls) -> dict:
    """One round of each kernel stack unscheduled and scheduled (adaptive,
    past its warmup, and linear), the wire's own noise drawn on the card:
    the scheduled round may make no more synchronisations than the
    unscheduled one."""
    import torch

    from repro_torch.analysis import audit_host_syncs

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
            counts[kind] = audit_host_syncs(mixer, theta, state)
        log(f"[schedules] synchronisations in one {stack} int8-kernel round: {counts}")
        if any(counts[kind][key] > counts["none"][key] for kind in ("adaptive", "linear")
               for key in counts["none"]):
            raise AssertionError(f"[schedules] a scheduled {stack} round synchronises more "
                                 f"than an unscheduled one: {counts}")
        out[stack] = counts
    return out


def phase_schedules(spec_cls, cfg_cls, mlp_leaves, cnn_leaves) -> dict:
    """fig8: int8_fixed, int4_fixed, int8_adaptive (threshold 1.0, warmup
    10) and int8_linear (anneal FIG8_ANNEAL) on the per-node quantizer,
    FIG8_STEPS fmnist steps (K = 8 ring, mu = 3, B = 55, lr 0.18, clipped at 2); then
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
                             data, FIG8_STEPS, {"uniforms_grouped": FIG8_STEPS})
    matchings = _ring_decomp().num_rounds
    for stack in ("dense", "gossip"):
        for kind in ("adaptive", "linear"):
            cfg = _sched_cfg(cfg_cls, kind, use_kernel=True)
            mixer = _sched_mixer(stack, cfg, "cuda") if stack == "gossip" else None
            want = {"quantize_blockwise_grouped": FIG8_STEPS, "uniforms_grouped": FIG8_STEPS}
            if stack == "gossip":
                want["dequant_accumulate_grouped_"] = FIG8_STEPS * matchings
            name = f"{stack}-int8-kernel-{kind}"
            out[name] = _fig_run("schedules", name, _fig_spec(spec_cls, cfg, FIG7_FMNIST), "mlp",
                                 data, FIG8_STEPS, want, mixer=mixer)
    return out


# -- faults, local updates and the federated hub (fig9, fig11) ----------------

FIG9_STEPS = 100            # fig9/fig11's 400 steps (benchmarks/fig9_dynamics.py,
                            # fig11_hub.py), quartered likewise
FIG9_DROP = 0.2             # fig9's dropout under the local-update rows
FIG9_FAULTS = dict(straggler_p=0.1, outage_p=0.05, outage_len=10)
EF_LOCAL = (4, 2)           # the EF gossip row: re-base period B, local-update period H
HUB_H = 4                   # fig11's FedAvg / SCAFFOLD period
DYN_PARITY_ROUNDS = 12
DYN_UPDATE_REL = 1.5e-4     # card vs CPU, relative to the largest update (ROADMAP §C)
RATE_SIGMAS = 5.0           # an observed fault rate against its configured one


def _dyn_run(tag, name, spec, data, steps, want_counts, mixer=None, period=1) -> dict:
    """``steps`` steps of ``trainer.step`` on fig9/fig11's task, each timed
    to a synchronised end, after a 3-step warm-up on a throwaway state,
    with every launch count set to 0 just before.  Holds: loss falls on the
    first batch, every metric finite, ``comm_bytes`` the round's measured
    wire (``wire_bits / 8``) on time-varying stacks and ``bytes_per_round``
    on static ones, 0 on the local steps of a period-H stack, and the
    launches ``want_counts`` with no plain call.  Returns the record, with
    the per-step wire bits and launches, the final state and the trainer's
    mixer beside it (not logged)."""
    import statistics

    import torch

    from repro_torch.models import make_classifier_loss, mlp_apply

    batches, (x_nodes, y_nodes), params = data
    trainer = spec.build(make_classifier_loss(mlp_apply), mlp_apply, mixer=mixer)
    if not trainer.captured:
        raise AssertionError(f"[{tag}] {name}: the step is not captured "
                             f"({trainer.capture_declined})")
    trainer.run(trainer.init(params), tuple(b[:3] for b in batches))
    state = trainer.init(params)
    torch.cuda.synchronize()
    reset_counts()
    times, metrics, step_launches = [], [], []
    for t in range(steps):
        before = {n: c[0] for n, c in kernel_counts().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, tuple(b[t] for b in batches))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
        step_launches.append({n: c[0] - before[n] for n, c in kernel_counts().items()
                              if c[0] != before[n]})
    counts = kernel_counts()
    ms = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    _finite(ms)
    check_counts(f"{tag} {name}", counts, want_counts)
    if trainer.mixer.traced_wire:
        if not torch.equal(ms["comm_bytes"], ms["wire_bits"] / 8.0):
            raise AssertionError(f"[{tag}] {name}: comm_bytes are not wire_bits / 8")
    elif not bool((ms["comm_bytes"] == trainer.mixer.bytes_per_round(state.params)).all()):
        raise AssertionError(f"[{tag}] {name}: comm_bytes are not bytes_per_round")
    local = [t for t in range(steps) if t % period != period - 1]
    if local and bool(ms["comm_bytes"][local].any()):
        raise AssertionError(f"[{tag}] {name}: a local step billed wire bytes")
    if local and any(step_launches[t] for t in local):
        raise AssertionError(f"[{tag}] {name}: a local step launched a kernel")
    loss0 = float(ms["loss_mean"][0])
    loss_end = _loss_on(trainer, state, tuple(b[0] for b in batches))
    stats = trainer.eval_local_distributions(state, x_nodes, y_nodes)
    rec = dict(run=name, step="captured", programs=trainer._run._cache_size(), steps=steps,
               period=period, loss_step0=loss0, loss_end=loss_end,
               acc_worst_dist=stats["acc_worst_dist"], acc_avg=stats["acc_avg"],
               comm_bytes_total=float(ms["comm_bytes"].double().sum()),
               disagreement_final=float(ms["disagreement"][-1]),
               ms_per_step_median=1e3 * statistics.median(times),
               launches={n: c[0] for n, c in counts.items() if c[0]})
    log(f"[{tag}] " + json.dumps(rec))
    if not loss_end < loss0:
        raise AssertionError(f"[{tag}] {name}: loss did not fall ({loss0} -> {loss_end})")
    if not all(math.isfinite(v) for v in (stats["acc_worst_dist"], stats["acc_avg"])):
        raise AssertionError(f"[{tag}] {name}: eval metrics not finite")
    return dict(rec, wire_bits=ms["wire_bits"].cpu(), step_launches=step_launches,
                final=state, mixer=trainer.mixer)


def _rate(tag, what, observed: float, configured: float, n: int) -> dict:
    """An observed fault rate beside its configured one, held within
    RATE_SIGMAS binomial standard deviations over ``n`` draws."""
    sigma = (configured * (1 - configured) / n) ** 0.5
    if abs(observed - configured) > RATE_SIGMAS * sigma:
        raise AssertionError(f"[{tag}] {what}: observed {observed}, configured {configured}, "
                             f"sigma {sigma} over {n} draws")
    return dict(observed=observed, configured=configured, sigma=sigma, draws=n)


def _observed_rates(tag, steps: int, drop_p: float = 0.0, faults=None) -> dict:
    """The card's own coins over the run's ``steps`` rounds, replayed from
    the configs: the link-keep share of the ring's links under dropout, and
    per stream the straggler share (per round) and the outage share (per
    window) — each stream is its own Philox leaf, so each is replayed
    alone."""
    import numpy as np

    from repro_torch.dynamics import DropoutSchedule, FaultConfig, replay_fault_masks
    from repro_torch.graphs import build_graph, metropolis_weights

    k, out = FIG_K, {}
    w = metropolis_weights(build_graph("ring", k))
    iu = np.triu_indices(k, 1)
    links = w[iu] > 0
    if drop_p > 0:
        sched = DropoutSchedule(w, drop_p, seed=0, device="cuda")
        kept = np.stack([sched.round_weights(r).cpu().numpy()[iu][links] > 0
                         for r in range(steps)])
        out["link_keep"] = _rate(tag, "link keep", float(kept.mean()), 1 - drop_p, kept.size)
    if faults is not None:
        rounds = np.arange(steps)
        if faults.straggler_p > 0:
            _, up = replay_fault_masks(FaultConfig(straggler_p=faults.straggler_p,
                                                   seed=faults.seed), rounds, k, "cuda")
            out["straggler"] = _rate(tag, "straggler", float(1 - up.mean()), faults.straggler_p,
                                     up.size)
        if faults.outage_p > 0:
            starts = np.arange(0, steps, faults.outage_len)
            _, up = replay_fault_masks(FaultConfig(outage_p=faults.outage_p,
                                                   outage_len=faults.outage_len,
                                                   seed=faults.seed), starts, k, "cuda")
            out["outage"] = _rate(tag, "outage", float(1 - up.mean()), faults.outage_p, up.size)
        keep, _ = replay_fault_masks(faults, rounds, k, "cuda")
        p_up = (1 - faults.straggler_p) * (1 - faults.outage_p)
        out["link_keep"] = dict(observed=float(keep[:, iu[0], iu[1]][:, links].mean()),
                                configured=p_up * p_up * (1 - faults.link_drop_p))
    return out


def _cpu_twin(sched):
    """The same schedule (its class, W, rate, radius and seed) on the CPU."""
    from repro_torch.dynamics import (
        DropoutSchedule,
        GeometricRedrawSchedule,
        RoundRobinSchedule,
        StaticSchedule,
    )

    if isinstance(sched, DropoutSchedule):
        return DropoutSchedule(sched.base_weights(), sched.p, seed=sched.seed, device="cpu")
    if isinstance(sched, GeometricRedrawSchedule):
        return GeometricRedrawSchedule(sched.k, sched.radius, seed=sched.seed, device="cpu")
    if isinstance(sched, RoundRobinSchedule):
        return RoundRobinSchedule(sched.base_weights(), device="cpu")
    if type(sched) is StaticSchedule:
        return StaticSchedule(sched.base_weights(), device="cpu")
    raise ValueError(f"no CPU twin for {type(sched).__name__}")


def _coins_card_vs_cpu(tag, mixer, rounds: int) -> dict:
    """The run's fault masks and W_r on the card over its ``rounds``
    rounds (the run's own topology, wrappers peeled; each round drawn at
    the round as a 0-d tensor on the card, as the captured step draws it)
    against ``replay_fault_masks`` and the same schedule's ``round_weights``
    (faults applied) on the CPU: bit-equal, the Philox coins being the
    same on both devices."""
    import torch

    from repro_torch.comm.topology import ScheduledTopology
    from repro_torch.dynamics import replay_fault_masks

    while getattr(mixer, "topo", None) is None:
        mixer = mixer.inner
    topo = mixer.topo
    cpu = ScheduledTopology(_cpu_twin(topo.schedule), topo.faults)
    differ = []
    for r in range(rounds):
        got = topo.round_w(torch.full((), r, dtype=torch.int64, device="cuda")).cpu()
        if not torch.equal(got, cpu.round_w(r)):
            differ.append(r)
    masks_equal = None
    if topo.faults is not None:
        card = replay_fault_masks(topo.faults, range(rounds), FIG_K, "cuda")
        host = replay_fault_masks(topo.faults, range(rounds), FIG_K, "cpu")
        masks_equal = all((a == b).all() for a, b in zip(card, host))
    rec = dict(rounds=rounds, w_rounds_differ=differ, fault_masks_equal=masks_equal)
    log(f"[{tag}] coins card vs CPU: " + json.dumps(rec))
    if differ or masks_equal is False:
        raise AssertionError(f"[{tag}] the card's coins are not the CPU's: {rec}")
    return rec


def _time_grouped(name, call, plain, dims, block_d: int) -> dict:
    """One grouped call on a new path's leaves (K = FIG_K): call time (CUDA
    events), the kernel's device time (profiler), the plain version's call
    and the bound, the sum of the leaves' (:func:`kernel_bound`)."""
    from repro_torch.kernels.quant_gossip import kernel as qk

    bounds = [kernel_bound(name, FIG_K, d, qk.num_blocks(d, block_d)) for d in dims]
    rec = dict(_time_call(name, call, plain, 200, 10), bound_ms=sum(b for b, _ in bounds),
               bound_by="bytes" if {b for _, b in bounds} == {"bytes"} else "operations",
               leaves=len(dims), nodes=FIG_K)
    log(f"[timing] {name} on a new path's leaves: " + json.dumps(rec))
    return rec


def _b45_on_straggler_rounds(tag, mixer, theta, rounds: int, cfg) -> dict:
    """The memoryless straggler wire's grouped B.4 and B.5 on the card
    against their plain versions on the same card tensors, bit for bit, on
    the first three rounds in which a straggler masks a whole row (its row
    is 0 in every matching's mask), with the round's own uniforms."""
    import torch

    from repro_torch.comm.topology import gather_round_vectors
    from repro_torch.dynamics import replay_fault_masks
    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ref as qref
    from repro_torch.utils.tree import leaf_names

    _, up = replay_fault_masks(cfg, range(rounds), FIG_K, theta[next(iter(theta))].device)
    picked = [r for r in range(rounds) if up[r].min() == 0][:3]
    if len(picked) < 3:
        raise AssertionError(f"[{tag}] fewer than 3 straggler rounds in {rounds}")
    names = leaf_names(theta)
    xfs = [theta[n].reshape(FIG_K, -1).float().contiguous() for n in names]
    wire, t = mixer.wire, mixer.transport
    err, down_rows = 0.0, 0
    for r in picked:
        self_w, pws, masks = gather_round_vectors(mixer.topo.round_w(r), t.perm_idx)
        for i in (up[r] == 0).nonzero()[0]:
            if any(float(mk[i]) != 0.0 for mk in masks):
                raise AssertionError(f"[{tag}] round {r}: straggler {i} is not masked")
            down_rows += 1
        accs = [xf * self_w[:, None] for xf in xfs]
        plain_accs = [a.clone() for a in accs]
        for m, (pw, mk, src) in enumerate(zip(pws, masks, t.srcs)):
            us = [wire.uniforms(int(wire.quantized.seed), r, i, m, xf)
                  for i, xf in enumerate(xfs)]
            got = qk.masked_quantize_blockwise_grouped(xfs, us, mk, qmax=127.0,
                                                       block_d=wire.quantized.block_d)
            want = qref.masked_quantize_blockwise_grouped_ref(xfs, us, mk, qmax=127.0,
                                                              block_d=wire.quantized.block_d)
            for (gq, gs), (wq, ws) in zip(got, want):
                if not (torch.equal(gq, wq) and torch.equal(gs, ws)):
                    raise AssertionError(f"[{tag}] round {r}: B.4 differs from its plain version")
            qk.masked_dequant_accumulate_grouped_(accs, got, pw, mk, src=src)
            qref.masked_dequant_accumulate_grouped_ref_(plain_accs, want, pw, mk, src=src)
            err = max(err, max(_max_diff(a, b) for a, b in zip(accs, plain_accs)))
        if err != 0.0:
            raise AssertionError(f"[{tag}] round {r}: B.5 differs from its plain version ({err})")
    # one matching of the last picked round, timed: the straggler-masked B.4
    # and B.5 over every leaf at the path's shapes
    block_d, dims = wire.quantized.block_d, [x.shape[1] for x in xfs]
    scratch = [a.clone() for a in accs]
    timing = {
        "masked_quantize_blockwise_grouped": _time_grouped(
            "masked_quantize_blockwise_grouped",
            lambda: qk.masked_quantize_blockwise_grouped(xfs, us, mk, qmax=127.0,
                                                         block_d=block_d),
            lambda: qref.masked_quantize_blockwise_grouped_ref(xfs, us, mk, qmax=127.0,
                                                               block_d=block_d),
            dims, block_d),
        "masked_dequant_accumulate_grouped_": _time_grouped(
            "masked_dequant_accumulate_grouped_",
            lambda: qk.masked_dequant_accumulate_grouped_(scratch, got, pw, mk, src=src),
            lambda: qref.masked_dequant_accumulate_grouped_ref_(scratch, want, pw, mk, src=src),
            dims, block_d)}
    rec = dict(rounds=picked, down_rows=down_rows, max_abs_err=err, timing=timing)
    log(f"[{tag}] B.4/B.5 on straggler rounds: " + json.dumps(rec))
    return rec


def _state_to(state, device):
    """A CommState (tensors, dicts of tensors, host ints) on ``device``."""
    import torch

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, dict):
            return {n: move(x) for n, x in v.items()}
        if isinstance(v, tuple):
            return tuple(move(x) for x in v)
        return v

    return state._replace(**{f: move(getattr(state, f)) for f in state._fields})


def _dyn_parity(cfg_cls) -> dict:
    """DYN_PARITY_ROUNDS rounds of each new mixer on the card and the port on
    the CPU from the same θ (the seeded MLP, K = 8, each node moved by its
    own normal draw, and kicked again between rounds), with the same fault
    masks, W_r and uniforms on both devices (the card's coins are its own):
    each round starts both from the card's θ and state, and the outputs
    agree within DYN_UPDATE_REL of the round's largest update (exactly on a
    local round), with equal wire bits."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.comm import topology as comm_topology
    from repro_torch.core import DenseMixer, HubMixer, make_hub_mixer, repeat_mixer
    from repro_torch.dynamics import (
        DropoutSchedule,
        DynamicDenseMixer,
        DynamicGossipMixer,
        FaultConfig,
        LocalUpdateMixer,
        StaticSchedule,
        fault_keep_matrix,
    )
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import mlp_init

    w = metropolis_weights(build_graph("ring", FIG_K))
    base = convert.params_to_numpy(mlp_init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(6)
    theta_np = {n: (x[None] + 0.05 * rng.standard_normal((FIG_K,) + x.shape)).astype(np.float32)
                for n, x in base.items()}
    kicks = [{n: (0.01 * rng.standard_normal(x.shape)).astype(np.float32)
              for n, x in theta_np.items()} for _ in range(DYN_PARITY_ROUNDS)]
    faults = FaultConfig(link_drop_p=0.1, straggler_p=0.2, outage_p=0.1, outage_len=4, seed=3)
    masks = [fault_keep_matrix(faults, r, FIG_K, "cpu") for r in range(DYN_PARITY_ROUNDS)]
    sched = DropoutSchedule(w, FIG9_DROP, seed=0, device="cpu")
    ws = {r: sched.round_weights(r) for r in range(DYN_PARITY_ROUNDS)}

    def noise(rounds, leaf_idx, *rest):  # identical uniforms for both devices
        return np.random.default_rng([rounds, leaf_idx, *rest[:-1]]).random(
            rest[-1], dtype=np.float32)

    def kernel_int8(**kw):
        return cfg_cls(kind="int8", use_kernel=True, **kw)

    def stacks(device):
        replay = _replay_schedule(w, ws, device)
        return {
            "dense-faults": DynamicDenseMixer(StaticSchedule(w, device=device), faults=faults),
            "gossip-int8-memoryless-faults": DynamicGossipMixer(
                StaticSchedule(w, device=device), faults=faults,
                quantized=kernel_int8(error_feedback=False), uniforms=noise),
            "dense-dropout-gt-H2": LocalUpdateMixer(DynamicDenseMixer(replay), 2,
                                                    gradient_tracking=True),
            "gossip-int8-ef-B4-H2": LocalUpdateMixer(DynamicGossipMixer(
                replay, quantized=kernel_int8(), ef_rebase_every=EF_LOCAL[0], uniforms=noise),
                EF_LOCAL[1]),
            "hub": HubMixer(FIG_K, device=device),
            "hub-int8-kernel-H4": LocalUpdateMixer(make_hub_mixer(
                FIG_K, kernel_int8(), device=device, uniforms=noise), HUB_H),
            "repeat-dense-2": repeat_mixer(DenseMixer(w, device=device), 2),
        }

    saved = comm_topology.round_fault_masks

    def injected(cfg, rounds, k, device):  # the same masks on both devices
        keep, up = masks[rounds]
        return keep.to(device), up.to(device)

    # the kernels each stack launches in its rounds on the card: the memoryless
    # wire B.4/B.5 per matching; the EF wire under H = 2 B.4 per consensus
    # round and B.5 per matching of a delta round (EF clock 0..5, B = 4); the
    # int8 hub under H = 4 one B.2 per consensus round
    m = 2  # the ring's matchings
    b, h = EF_LOCAL
    ef = DYN_PARITY_ROUNDS // h
    want_launches = {
        "gossip-int8-memoryless-faults": {"masked_quantize_blockwise_grouped": 12 * m,
                                          "masked_dequant_accumulate_grouped_": 12 * m},
        "gossip-int8-ef-B4-H2": {"masked_quantize_blockwise_grouped": ef,
                                 "masked_dequant_accumulate_grouped_":
                                     m * sum(1 for c in range(ef) if c % b != b - 1)},
        "hub-int8-kernel-H4": {"quantize_blockwise_grouped": DYN_PARITY_ROUNDS // HUB_H}}
    comm_topology.round_fault_masks = injected
    out = {}
    try:
        card, cpu = stacks("cuda"), stacks("cpu")
        for name in card:
            theta = {n: torch.from_numpy(v).to("cuda") for n, v in theta_np.items()}
            state = card[name].init_state(theta)
            worst, launches_before = 0.0, kernel_counts()
            for r in range(DYN_PARITY_ROUNDS):
                theta_cpu = {n: v.cpu() for n, v in theta.items()}
                state_cpu = _state_to(state, "cpu")
                got, state = card[name](theta, state)
                want, want_state = cpu[name](theta_cpu, state_cpu)
                update = max(float((want[n] - theta_cpu[n]).abs().max()) for n in want)
                diff = max(float((got[n].cpu() - want[n]).abs().max()) for n in want)
                if update == 0.0 and diff != 0.0 or diff > DYN_UPDATE_REL * update:
                    raise AssertionError(f"[dynamics] parity {name} round {r}: card vs CPU "
                                         f"differ by {diff} (largest update {update})")
                if float(state.wire_bits) != float(want_state.wire_bits):
                    raise AssertionError(f"[dynamics] parity {name} round {r}: wire bits "
                                         f"{float(state.wire_bits)} vs "
                                         f"{float(want_state.wire_bits)}")
                worst = max(worst, diff / update if update else 0.0)
                theta = {n: got[n] + torch.from_numpy(kicks[r][n]).to("cuda") for n in got}
            after = kernel_counts()
            launched = {n: after[n][0] - launches_before[n][0] for n in after
                        if after[n][0] != launches_before[n][0]}
            rec = dict(stack=name, rounds=DYN_PARITY_ROUNDS, max_update_rel_diff=worst,
                       update_rtol=DYN_UPDATE_REL, launches=launched)
            log("[dynamics] parity " + json.dumps(rec))
            if launched != want_launches.get(name, {}):
                raise AssertionError(f"[dynamics] parity {name}: launched {launched}, want "
                                     f"{want_launches.get(name, {})}")
            out[name] = rec
    finally:
        comm_topology.round_fault_masks = saved
    return out


def phase_dynamics(spec_cls, cfg_cls) -> dict:
    """fig9's local-update rows and faults on fig9's task (K = 8 ring,
    Metropolis W, DR-DSGD mu = 3, B = 55, lr 0.18, clipped at 2, FIG9_STEPS steps,
    lr_compensate off): dense dropout 0.2 at H = 2 and 4, and H = 4 with
    gradient tracking (its consensus rounds bill 2× the H = 4 run's, on the
    same W_r); dense stragglers 0.1 with outages 0.05 over windows of 10,
    with and without straggler_skips_compute; the memoryless int8 gossip
    wire under stragglers 0.1 (grouped B.4 and B.5 once per matching per
    round; held against their plain versions on rounds a straggler masks a
    whole row); the EF int8 gossip wire re-based every 4 under dropout 0.2
    inside LocalUpdateMixer(H = 2): grouped B.4 once per consensus round,
    grouped B.5 once per matching of a delta round on the EF clock, nothing
    on a local round.  Before them: each new mixer card vs CPU."""
    from repro_torch.dynamics import (
        DropoutSchedule,
        DynamicGossipMixer,
        FaultConfig,
        LocalUpdateMixer,
        StaticSchedule,
    )
    from repro_torch.graphs import build_graph, metropolis_weights

    out = {"parity": _dyn_parity(cfg_cls)}
    data = _fig_data("mlp", FIG9_STEPS, FIG7_FMNIST[0])
    w = metropolis_weights(build_graph("ring", FIG_K))
    matchings = _ring_decomp().num_rounds
    n = FIG9_STEPS
    # (fields, H, the coins' Philox draws per consensus round: the round's W_r,
    # again for the tracker exchange, and the up vector of straggler_skips_compute)
    dense = {
        f"dropout{FIG9_DROP:g}-H2": (dict(topology="dropout", drop_p=FIG9_DROP, local_updates=2),
                                     2, 1),
        f"dropout{FIG9_DROP:g}-H4": (dict(topology="dropout", drop_p=FIG9_DROP, local_updates=4),
                                     4, 1),
        f"dropout{FIG9_DROP:g}-H4-gt": (dict(topology="dropout", drop_p=FIG9_DROP,
                                             local_updates=4, gradient_tracking=True), 4, 2),
        "faults": (dict(FIG9_FAULTS), 1, 1),
        "faults-skips-compute": (dict(FIG9_FAULTS, straggler_skips_compute=True), 1, 2),
    }
    fault_cfg = FaultConfig(seed=0, **FIG9_FAULTS)
    for name, (kw, period, draws) in dense.items():
        rec = _dyn_run("dynamics", f"dense-{name}",
                       _fig_spec(spec_cls, "none", FIG7_FMNIST, **kw), data, n,
                       {"uniforms_grouped": n // period * draws}, period=period)
        rec["rates"] = _observed_rates(f"dynamics {name}", n, kw.get("drop_p", 0.0),
                                       fault_cfg if "straggler_p" in kw else None)
        log(f"[dynamics] dense-{name} fault rates: " + json.dumps(rec["rates"]))
        rec["coins_card_vs_cpu"] = _coins_card_vs_cpu(f"dynamics dense-{name}", rec["mixer"], n)
        out[f"dense-{name}"] = rec
    # gradient tracking bills 2x a consensus round: the GT and the plain H = 4
    # runs share the schedule's seed, so their consensus rounds share W_r
    gt, plain = out[f"dense-dropout{FIG9_DROP:g}-H4-gt"], out[f"dense-dropout{FIG9_DROP:g}-H4"]
    if not bool((gt["wire_bits"] == 2.0 * plain["wire_bits"]).all()):
        raise AssertionError("[dynamics] gradient tracking does not bill 2x the plain rounds")
    straggler = FaultConfig(straggler_p=FIG9_FAULTS["straggler_p"], seed=0)
    mixer = DynamicGossipMixer(StaticSchedule(w, device="cuda"), faults=straggler,
                               quantized=cfg_cls(kind="int8", use_kernel=True,
                                                 error_feedback=False))
    name = f"gossip-straggler{straggler.straggler_p:g}-int8-kernel-memoryless"
    rec = _dyn_run("dynamics", name, _fig_spec(spec_cls, mixer.compression, FIG7_FMNIST),
                   data, n, {"masked_quantize_blockwise_grouped": n * matchings,
                    "masked_dequant_accumulate_grouped_": n * matchings,
                    "uniforms_grouped": n * matchings + n}, mixer=mixer)
    rec["rates"] = _observed_rates(f"dynamics {name}", n, faults=straggler)
    rec["coins_card_vs_cpu"] = _coins_card_vs_cpu(f"dynamics {name}", mixer, n)
    rec["b45_straggler_rounds"] = _b45_on_straggler_rounds("dynamics", mixer,
                                                           rec["final"].params, n, straggler)
    out[name] = rec
    b, h = EF_LOCAL
    ef_rounds = n // h
    delta_rounds = sum(1 for r in range(ef_rounds) if r % b != b - 1)
    mixer = LocalUpdateMixer(DynamicGossipMixer(
        DropoutSchedule(w, FIG9_DROP, seed=0, device="cuda"),
        quantized=cfg_cls(kind="int8", use_kernel=True), ef_rebase_every=b), h)
    name = f"gossip-dropout{FIG9_DROP:g}-int8-kernel-ef-B{b}-H{h}"
    rec = _dyn_run("dynamics", name, _fig_spec(spec_cls, mixer.compression, FIG7_FMNIST),
                   data, n, {"masked_quantize_blockwise_grouped": ef_rounds,
                    "masked_dequant_accumulate_grouped_": delta_rounds * matchings,
                    "uniforms_grouped": 2 * ef_rounds},
                   mixer=mixer, period=h)
    # the EF clock: consensus round c (step c·H + H − 1) is a re-base when
    # c % B == B − 1 and launches the coins, the noise and B.4 alone; a delta
    # round adds B.5 per matching
    for c in range(ef_rounds):
        want = {"masked_quantize_blockwise_grouped": 1, "uniforms_grouped": 2}
        if c % b != b - 1:
            want["masked_dequant_accumulate_grouped_"] = matchings
        if rec["step_launches"][c * h + h - 1] != want:
            raise AssertionError(f"[dynamics] {name}: consensus round {c} launched "
                                 f"{rec['step_launches'][c * h + h - 1]}, want {want}")
    if rec["final"].comm.ef_rounds != ef_rounds or rec["final"].comm.rounds != n:
        raise AssertionError(f"[dynamics] {name}: clocks {rec['final'].comm.ef_rounds}, "
                             f"{rec['final'].comm.rounds}")
    rec["rates"] = _observed_rates(f"dynamics {name}", n, FIG9_DROP)
    rec["coins_card_vs_cpu"] = _coins_card_vs_cpu(f"dynamics {name}", mixer, n)
    out[name] = rec
    return out


def _hub_b2_timing(run) -> dict:
    """The int8 hub round's grouped B.2 (EF: the innovation against θ̂ of
    every leaf) at the path's shapes, block length and uniforms (those of
    the run's last consensus round), timed; bit-equal to its plain version
    first."""
    import torch

    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.kernels.quant_gossip import ref as qref
    from repro_torch.utils.tree import leaf_names

    state, wire = run["final"], run["mixer"].inner.wire
    names, block_d = leaf_names(state.params), wire.compression.block_d
    xs = [(state.params[n] - state.comm.hat[n]).reshape(FIG_K, -1).contiguous() for n in names]
    us = [wire.uniforms(state.comm.key, state.comm.rounds - 1, i, x) for i, x in enumerate(xs)]
    got = qk.quantize_blockwise_grouped(xs, us, qmax=127.0, block_d=block_d)
    want = qref.quantize_blockwise_grouped_ref(xs, us, qmax=127.0, block_d=block_d)
    if not all(torch.equal(g, w) for gp, wp in zip(got, want) for g, w in zip(gp, wp)):
        raise AssertionError("[hub] grouped B.2 differs from its plain version")
    return _time_grouped("quantize_blockwise_grouped",
                         lambda: qk.quantize_blockwise_grouped(xs, us, qmax=127.0,
                                                               block_d=block_d),
                         lambda: qref.quantize_blockwise_grouped_ref(xs, us, qmax=127.0,
                                                                     block_d=block_d),
                         [x.shape[1] for x in xs], block_d)


def phase_hub(spec_cls, cfg_cls) -> dict:
    """fig11 without its hierarchical row, on fig9's task: gossip over the
    static ring, the hub at H = 1 (exact server averaging: the run must end
    at float-noise disagreement, as the reference's fig11 asserts), FedAvg
    and SCAFFOLD at H = 4 (SCAFFOLD's consensus rounds bill 2× FedAvg's),
    and int8 FedAvg at H = 4 on the kernel quantizer (grouped B.2 over the
    star W once per consensus round: steps / H launches)."""
    from repro_torch.core.consensus import make_gossip_mixer

    data = _fig_data("mlp", FIG9_STEPS, FIG7_FMNIST[0])
    n, out = FIG9_STEPS, {}
    mixer = make_gossip_mixer(_ring_decomp(), device="cuda")
    out["gossip-ring"] = _dyn_run("hub", "gossip-ring",
                                  _fig_spec(spec_cls, "none", FIG7_FMNIST), data, n, {},
                                  mixer=mixer)
    rows = {"hub-H1": (dict(topology="hub"), "none", 1, {}),
            f"hub-H{HUB_H}-fedavg": (dict(topology="hub", local_updates=HUB_H), "none", HUB_H,
                                     {}),
            f"hub-H{HUB_H}-scaffold": (dict(topology="hub", local_updates=HUB_H,
                                            gradient_tracking=True), "none", HUB_H, {}),
            f"hub-H{HUB_H}-fedavg-int8-kernel": (
                dict(topology="hub", local_updates=HUB_H),
                cfg_cls(kind="int8", use_kernel=True), HUB_H,
                {"quantize_blockwise_grouped": n // HUB_H, "uniforms_grouped": n // HUB_H})}
    for name, (kw, compress, period, want) in rows.items():
        out[name] = _dyn_run("hub", name, _fig_spec(spec_cls, compress, FIG7_FMNIST, **kw),
                             data, n, want, period=period)
    out["b2_timing"] = _hub_b2_timing(out[f"hub-H{HUB_H}-fedavg-int8-kernel"])
    if not out["hub-H1"]["disagreement_final"] < 1e-6:
        raise AssertionError(f"[hub] hub H=1 must reach exact consensus every round: "
                             f"disagreement {out['hub-H1']['disagreement_final']}")
    fed, scaffold = out[f"hub-H{HUB_H}-fedavg"], out[f"hub-H{HUB_H}-scaffold"]
    if not bool((scaffold["wire_bits"] == 2.0 * fed["wire_bits"]).all()):
        raise AssertionError("[hub] SCAFFOLD does not bill 2x FedAvg's consensus rounds")
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


def _attention_bound(n_bytes: int, ops: int, tc_ops: int | None = None,
                     tc_rate: float = TF32_OPS_PER_S) -> tuple[float, str, float]:
    """(bound ms, what bounds it, the CUDA cores' bound ms) of an attention
    kernel whose products run on the tensor cores: the larger of the bytes
    at the HBM rate and ``tc_ops``, the tensor-core products' operations
    (by default 3 x ops: each float32 product as three TF32 products), at
    ``tc_rate`` (TF32's by default); beside it the larger of the bytes and
    ops at the float32 FMA rate."""
    tc_ops = 3 * ops if tc_ops is None else tc_ops
    t_bytes, t_tc = n_bytes / HBM_BYTES_PER_S, tc_ops / tc_rate
    return (1e3 * max(t_bytes, t_tc), "bytes" if t_bytes >= t_tc else "operations",
            1e3 * max(t_bytes, ops / FP32_OPS_PER_S))


def flash_bound(b, h, kvh, s, t, hd, causal, window,
                elem_bytes: int = 4) -> tuple[float, str, float]:
    """Least time of one B.6 call: q, k, v read and out written once at the
    HBM rate (``elem_bytes`` each: 2 for bfloat16), against 4 hd float
    operations per unmasked pair (two for q.k, two for p.v) as the
    tensor-core products the inputs' type needs: in float32 three TF32
    products for q.k and three for p.v (3xTF32) at the TF32 peak; in
    bfloat16 one bfloat16 product for q.k (exact in float32) and two for
    p.v (P's bfloat16 high and low halves times V) at the bfloat16 peak.
    Returns (bound ms, "bytes" or "operations", the bound with the
    operations at the float32 FMA peak instead)."""
    n_bytes = elem_bytes * (2 * b * h * s * hd + 2 * b * kvh * t * hd)
    macs = 2 * b * h * hd * _pairs(s, t, causal, window)
    if elem_bytes == 4:
        return _attention_bound(n_bytes, 2 * macs, (3 + 3) * macs)
    return _attention_bound(n_bytes, 2 * macs, (1 + 2) * macs, BF16_OPS_PER_S)


def wkv6_bound(b, h, t, hd, given_state: bool = False,
               elem_bytes: int = 4) -> tuple[float, str]:
    """Least time of one B.7 call: r, k, v, w read, y and the final state
    written once, u (and a given state) read once (r, k, v, w, y and u at
    ``elem_bytes`` each: 2 for bfloat16; the states float32), against the
    least arithmetic at the float32 peak: 5 float operations per (i, j, t),
    a multiply (k_i v_j) and two FMAs (y's sum and the decayed state), the
    bonus being one scalar per (b, h, t)."""
    n_bytes = (elem_bytes * (5 * b * h * t * hd + h * hd)
               + 4 * (1 + given_state) * b * h * hd * hd)
    ops = 5 * b * h * t * hd * hd
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# B.6 at the LM example's shape (examples/torch_train_lm_drdsgd.py's
# defaults: batch 4, seq 128, d_model 256 over 8 heads of 32, 2 KV heads)
HD32_CASE = "LM example: hd 32"
# qwen2-0.5b's training step with the node axis: K = 8 nodes x batch 2 in B.6's batch
FOLDED_CASE = "qwen2-0.5b train S 64, K = 8 folded"
# B.6 on A.11's paths (tag, b, h, kvh, s, hd, window, softcap): deepseek-moe-16b's
# static prefill (serve-moe) and training step (train-moe) at hd 128, and
# musicgen-medium's 256 frames + 64 text tokens (frontend); the backward
# at the two training shapes
A11_FWD_CASES = (
    ("deepseek-moe-16b prefill", 4, 16, 16, 256, 128, None, None),
    ("deepseek-moe-16b train S 64", 2, 16, 16, 64, 128, None, None),
    ("musicgen-medium train S 320", 2, 24, 24, 320, 64, None, None),
)

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


def tma_audit(fn, dtypes: list | None = None) -> dict:
    """Run ``fn`` with each call of B.6 from ``ops`` (the model's entry)
    checked first by :func:`need_tma` on the views it copies by TMA: the
    forward's k and v, the backward's q, k, v, out and dout; each forward's
    q dtype is appended to ``dtypes`` when given.  Returns the calls
    checked, {"fwd": n, "bwd": n}.  A replay of the trainer's captured step
    calls no wrapper: audit a run that captures (train-lm wraps the CLI's
    run: its eager warm-up step and its capture), or a ``jit=False``
    step."""
    import types

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fo

    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, **kw):
        calls["fwd"] += need_tma("B.6 forward in the step", k=k, v=v)
        if dtypes is not None:
            dtypes.append(q.dtype)
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

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    flash_cases = [  # tag, b, h, kvh, s, hd, window, softcap
        ("qwen2-0.5b prefill", 4, 14, 2, 512, 64, None, None),
        ("qwen2-0.5b train S 64", 2, 14, 2, 64, 64, None, None),
        (FOLDED_CASE, LM_NODES * LM_BATCH, 14, 2, LM_SEQ, 64, None, None),
        ("hd 80, window 4096", 2, 32, 8, 512, 80, 4096, None),
        ("hd 128, window 64, softcap 50", 2, 32, 16, 512, 128, 64, 50.0),
        ("G = 1", 2, 8, 8, 512, 64, None, None),
        ("ragged S = 300", 4, 14, 2, 300, 64, None, None),
        (HD32_CASE, 4, 8, 2, 128, 32, None, None),
        *A11_FWD_CASES,
    ]
    out = {"flash_attention_fwd": dict(max_abs_err=0.0, rows=[]),
           "wkv6_scan": dict(max_abs_err=0.0, rows=[])}
    for case in flash_cases:
        _add_row(out["flash_attention_fwd"], _flash_case("serve-kernel", randn, *case))
    for tag, b, h, t, hd, decay, given, layout in WKV6_CASES:
        row = _wkv6_case("serve-kernel", randn, gen, tag, b, h, t, hd, decay, given, layout)
        _add_row(out["wkv6_scan"], row)
    out["domain"] = _serve_domain(gen)
    return out


# The reference kernels' input domain (its tests' shapes): bfloat16 inputs,
# and head dim 8 (B.6) and 8 and 32 (B.7).  B.6: b, h, kvh, s, t, hd
# (tests/test_kernel_flash_attention.py:26-33 and its bf16 and window /
# softcap cases); B.7: b, h, t, hd (tests/test_kernel_rwkv6.py:25-30).
DOMAIN_FLASH_SHAPES = ((2, 4, 2, 64, 64, 16), (1, 4, 4, 128, 128, 32), (2, 8, 2, 64, 64, 16),
                       (1, 2, 1, 32, 32, 8), (1, 6, 2, 96, 96, 16), (1, 2, 2, 64, 64, 32))
DOMAIN_FLASH_MASKS = ((True, None, None), (True, 8, None), (True, 16, 20.0), (False, None, None))
DOMAIN_WKV6_SHAPES = ((2, 2, 32, 16), (1, 4, 64, 32), (2, 1, 16, 8), (1, 2, 64, 16),
                      (1, 2, 32, 16), (4, 64, 64, 8), (4, 64, 64, 32))
# the bfloat16 case timed per kernel: the main path's serving shapes
DOMAIN_FLASH_TIMED = ("qwen2-0.5b prefill, bf16", 4, 14, 2, 512, 64)
DOMAIN_WKV6_TIMED = ("rwkv6-7b prefill, bf16", 4, 64, 256, 64)


def bf16_ulps(got, want, atol: float = 0.0) -> float:
    """The largest |got - want| over (one bfloat16 ulp of the larger
    magnitude of the pair + ``atol``): at most 1 where the two differ by one
    rounding to bfloat16 of values that agreed within ``atol`` before it."""
    import torch

    g, w = got.float(), want.float()
    m = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m.clamp_min(1e-38))) - 7),
                      torch.zeros_like(m))
    return float(((g - w).abs() / (ulp + atol).clamp_min(1e-38)).max())


def _domain_check(tag: str, got, want, bf16: bool, scale_atol: bool) -> float:
    """Against the plain version's output: float32 at SERVE_TOL (atol times
    max |want| where ``scale_atol``, B.7's rule); bfloat16 within one
    bfloat16 ulp plus that float32 atol (the kernel and the plain version
    both round a float32 result once; where a result is near 0 their
    float32 sums, taken in other orders, differ by up to the atol).
    Returns the error (abs; for bfloat16 the bf16_ulps ratio, at most 1)."""
    import torch

    atol = SERVE_TOL * (float(want.abs().max()) if scale_atol else 1.0)
    if bf16:
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"[serve-domain] {tag}: output {got.dtype}, not bfloat16")
        ratio = bf16_ulps(got, want, atol)
        if ratio > 1.0:
            raise AssertionError(f"[serve-domain] {tag}: {ratio} of (one bf16 ulp + {atol}) "
                                 f"from plain")
        return ratio
    if not torch.allclose(got, want, rtol=SERVE_TOL, atol=atol):
        raise AssertionError(f"[serve-domain] {tag}: kernel != plain "
                             f"(max abs err {float((got - want).abs().max())})")
    return float((got - want).abs().max())


def _serve_domain(gen) -> dict:
    """B.6 and B.7 on the reference kernels' domain against their plain
    versions on the card: B.6 in bfloat16 at every reference shape (hd 8,
    16, 32) under each mask (causal, windows, a softcap, non-causal) and in
    float32 at hd 8; B.7 in float32 and bfloat16 at every reference shape
    (hd 8, 16, 32) and at rwkv6-7b's heads with hd 8 and 32, from zero and
    from a given state (the final state float32 at SERVE_TOL; in bfloat16
    also bit-equal to the float32 kernel on the widened inputs).  Then one
    bfloat16 case per kernel at the main path's serving shape timed, its
    chunks or K/V tiles by TMA: call, device, plain, bound (bytes at 2 per
    element) and, for B.6, SDPA in bfloat16; beside it, in the same call
    and in turns, the float32 kernel on the same values widened."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rwkv6_scan import kernel as wk
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    t0 = time.perf_counter()

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {"flash_attention_fwd": dict(cases=0, max_abs_err_f32=0.0, max_ratio_bf16=0.0),
           "wkv6_scan": dict(cases=0, max_abs_err_f32=0.0, max_ratio_bf16=0.0,
                             bitwise_vs_float32=0)}

    def note(name, err, bf16):
        rec = out[name]
        rec["cases"] += 1
        key = "max_ratio_bf16" if bf16 else "max_abs_err_f32"
        rec[key] = max(rec[key], err)

    for b, h, kvh, s, t, hd in DOMAIN_FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32) if hd == 8 else (torch.bfloat16,):
            q, k, v = randn(b, h, s, hd, dtype=dtype), *(randn(b, kvh, t, hd, dtype=dtype)
                                                         for _ in range(2))
            for causal, window, softcap in DOMAIN_FLASH_MASKS:
                kw = dict(causal=causal, window=window, softcap=softcap)
                got, want = fk.flash_attention_fwd(q, k, v, **kw), attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                tag = f"B.6 {dtype} {(b, h, kvh, s, t, hd)} {kw}"
                note("flash_attention_fwd",
                     _domain_check(tag, got, want, dtype == torch.bfloat16, False),
                     dtype == torch.bfloat16)
    for b, h, t, hd in DOMAIN_WKV6_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            r, k, v = (randn(b, t, h, hd, dtype=dtype).permute(0, 2, 1, 3) for _ in range(3))
            w = torch.rand((b, t, h, hd), generator=gen, device="cuda").to(dtype).permute(
                0, 2, 1, 3)
            u = (0.5 * randn(h, hd)).to(dtype)
            for s0 in (None, randn(b, h, hd, hd)):
                (y, st), (y_p, st_p) = wk.wkv6_scan(r, k, v, w, u, s0), wkv6_ref(r, k, v, w, u,
                                                                                 s0)
                torch.cuda.synchronize()
                tag = f"B.7 {dtype} {(b, h, t, hd)} state {s0 is not None}"
                bf16 = dtype == torch.bfloat16
                note("wkv6_scan", _domain_check(tag + " y", y, y_p, bf16, True), bf16)
                _domain_check(tag + " state", st, st_p, False, True)
                if bf16:  # float32 steps on the widened chunks: the float32 kernel's bits
                    y32, st32 = wk.wkv6_scan(*(x.float() for x in (r, k, v, w, u)), s0)
                    if not (torch.equal(st, st32) and torch.equal(y, y32.to(dtype))):
                        raise AssertionError(f"[serve-domain] {tag}: not bit-equal to the "
                                             f"float32 kernel on the widened inputs")
                    out["wkv6_scan"]["bitwise_vs_float32"] += 1
    # one bfloat16 case per kernel, timed, beside the float32 path on the
    # same values widened (rows 6 and 7), in turns: float32, bfloat16,
    # bfloat16, float32
    tag, b, h, kvh, s, hd = DOMAIN_FLASH_TIMED
    q = randn(b, s, h, hd, dtype=torch.bfloat16).permute(0, 2, 1, 3)
    k, v = (randn(b, s, kvh, hd, dtype=torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    need_tma(f"[serve-domain] B.6 {tag}", k=k, v=v)
    got, want = fk.flash_attention_fwd(q, k, v), attention_ref(q, k, v)
    err = _domain_check(tag, got, want, True, False)
    bound, by, _ = flash_bound(b, h, kvh, s, s, hd, True, None, elem_bytes=2)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    q32, k32, v32 = q.float(), k.float(), v.float()

    def sdpa():
        return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)

    sdpa_err = float((sdpa().float() - want.float()).abs().max())
    if sdpa_err > 2e-2:  # SDPA rounds P to bfloat16: the reference's bf16 tolerance
        raise AssertionError(f"[serve-domain] SDPA in bfloat16 disagrees with the plain "
                             f"version ({tag}): max abs err {sdpa_err}")
    turns = _in_turns(
        lambda: _time_call("flash_attention_fwd", lambda: fk.flash_attention_fwd(q32, k32, v32),
                           lambda: attention_ref(q32, k32, v32), 50, 10),
        lambda: _time_call("flash_attention_fwd", lambda: fk.flash_attention_fwd(q, k, v),
                           lambda: attention_ref(q, k, v), 50, 10, names=FLASH_BF16_NAMES))
    out["flash_attention_fwd"]["timed"] = dict(
        case=tag, bf16_ratio=err, library_max_abs_err=sdpa_err, **turns["b"],
        bound_ms=bound, bound_by=by, library_ms=cuda_ms(sdpa, iters=50),
        library_device_ms=window_device_ms(sdpa, 50) or None,
        library_backend="SDPA default dispatch, bfloat16, enable_gqa",
        float32_same_call=turns["a"], turns=turns["turns"])
    tag, b, h, t, hd = DOMAIN_WKV6_TIMED
    r, k, v = (randn(b, t, h, hd, dtype=torch.bfloat16).permute(0, 2, 1, 3) for _ in range(3))
    w = torch.rand((b, t, h, hd), generator=gen, device="cuda").to(torch.bfloat16).permute(
        0, 2, 1, 3)
    u = (0.5 * randn(h, hd)).to(torch.bfloat16)
    if not all(wk.rows_by_tma(x) for x in (r, k, v, w)):
        raise AssertionError(f"[serve-domain] B.7 {tag}: bfloat16 chunks not staged by TMA")
    (y, _), (y_p, _) = wk.wkv6_scan(r, k, v, w, u), wkv6_ref(r, k, v, w, u)
    err = _domain_check(tag, y, y_p, True, True)
    bound, by = wkv6_bound(b, h, t, hd, elem_bytes=2)
    f32 = [x.float() for x in (r, k, v, w, u)]
    turns = _in_turns(
        lambda: _time_call("wkv6_scan", lambda: wk.wkv6_scan(*f32), lambda: wkv6_ref(*f32), 50, 5),
        lambda: _time_call("wkv6_scan", lambda: wk.wkv6_scan(r, k, v, w, u),
                           lambda: wkv6_ref(r, k, v, w, u), 50, 5))
    out["wkv6_scan"]["timed"] = dict(case=tag, bf16_ratio=err, **turns["b"], bound_ms=bound,
                                     bound_by=by, library_ms=None,
                                     float32_same_call=turns["a"], turns=turns["turns"])
    for name in ("flash_attention_fwd", "wkv6_scan"):
        rec = out[name]["timed"]
        log(f"[serve-domain] {name} {rec['case']}: device bf16 {1e3 * rec['device_ms']:.2f} us, "
            f"float32 {1e3 * rec['float32_same_call']['device_ms']:.2f} us (the same call), "
            f"bound {1e3 * rec['bound_ms']:.2f} us; turns {rec['turns']}")
    out["wall_s"] = time.perf_counter() - t0
    log("[serve-domain] " + json.dumps(out))
    return out


# B.6's bfloat16 instances, by the profiler's kernel name
FLASH_BF16_NAMES = ("flash_fwd_bf16_kernel",)


def _in_turns(time_a, time_b) -> dict:
    """Two versions timed in turns a, b, b, a (each ``time_*`` returns a
    _time_call record): each version's mean of its two records, and every
    device reading in turn order."""
    recs = [time_a(), time_b(), time_b(), time_a()]

    def mean(pair):
        keys = [key for key in pair[0] if isinstance(pair[0][key], float)]
        return {**pair[0], **{key: (pair[0][key] + pair[1][key]) / 2 for key in keys}}

    return dict(a=mean([recs[0], recs[3]]), b=mean([recs[1], recs[2]]),
                turns=[("ab"[i in (1, 2)], r["device_ms"]) for i, r in enumerate(recs)])


def _add_row(rec: dict, row: dict) -> None:
    rec["max_abs_err"] = max(rec["max_abs_err"], row["max_abs_err"])
    rec["rows"].append(row)


def _flash_case(phase, randn, tag, b, h, kvh, s, hd, window, softcap,
                require_tma: bool = True) -> dict:
    """B.6 at one shape on the model's layout (strided (B, S, H, hd) views)
    against its plain version at SERVE_TOL; its call, device and plain
    times, its bound, and SDPA's times where SDPA computes the same
    function (no window, no softcap).  Fails where K/V would be copied by
    cp.async rather than TMA, unless ``require_tma`` is off (then the row
    records which)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q = randn(b, s, h, hd).permute(0, 2, 1, 3)
    k, v = (randn(b, s, kvh, hd).permute(0, 2, 1, 3) for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap)
    got, want = fk.flash_attention_fwd(q, k, v, **kw), attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL):
        raise AssertionError(f"[{phase}] B.6 {tag}: kernel != plain (max abs err {err})")
    ms = cuda_ms(lambda: fk.flash_attention_fwd(q, k, v, **kw), iters=50)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=10, warmup=2)
    dev = device_time(lambda: fk.flash_attention_fwd(q, k, v, **kw), 20,
                      KERNELS["flash_attention_fwd"][2])
    bound, by, fp32_bound = flash_bound(b, h, kvh, s, s, hd, True, window)
    row = dict(case=tag, b=b, h=h, kvh=kvh, s=s, hd=hd, window=window, softcap=softcap,
               max_abs_err=err, ms=ms, **dev, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, fp32_bound_ms=fp32_bound, library_ms=None,
               tma=need_tma(f"[{phase}] B.6 {tag}", k=k, v=v) if require_tma
               else fk.rows_by_tma(k) and fk.rows_by_tma(v))
    if window is None and softcap is None:  # the yardstick: one PyTorch call, contiguous
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        backend, label, kf, vf, gqa = sdpa_yardstick(qc, kc, vc)

        def sdpa():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qc, kf, vf, is_causal=True,
                                                      enable_gqa=gqa)

        if not torch.allclose(sdpa(), want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"[{phase}] SDPA disagrees with the plain version ({tag})")
        row.update(library_ms=cuda_ms(sdpa, iters=50),
                   # None: the profiler recorded no device time of SDPA
                   library_device_ms=window_device_ms(sdpa, 50) or None,
                   library_backend=label)
    log(f"[{phase}] " + json.dumps(row))
    return row


def _wkv6_case(phase, randn, gen, tag, b, h, t, hd, decay, given, layout) -> dict:
    """B.7 at one shape against its plain version (y and the final state)
    at SERVE_TOL (atol scaled by the largest value); call, device and
    plain times and the bound."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel as wk
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

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
        raise AssertionError(f"[{phase}] B.7 {tag}: staged by "
                             f"{'TMA' if tma else 'plain loads'}")
    (y, st), (y_p, st_p) = wk.wkv6_scan(r, k, v, w, u, s0), wkv6_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    errs = {}
    for what, got, want in (("y", y, y_p), ("state", st, st_p)):
        scale = float(want.abs().max())
        errs[what] = float((got - want).abs().max())
        errs[what + "_max_abs"] = scale
        if not torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL * scale):
            raise AssertionError(f"[{phase}] B.7 {tag} {what}: kernel != plain "
                                 f"(max abs err {errs[what]}, max |{what}| {scale})")
    ms = cuda_ms(lambda: wk.wkv6_scan(r, k, v, w, u, s0), iters=50)
    plain_ms = cuda_ms(lambda: wkv6_ref(r, k, v, w, u, s0), iters=5, warmup=1)
    dev = device_time(lambda: wk.wkv6_scan(r, k, v, w, u, s0), 20, KERNELS["wkv6_scan"][2])
    dev_ms = dev["device_ms"]
    bound, by = wkv6_bound(b, h, t, hd, given)
    row = dict(case=tag, b=b, h=h, t=t, hd=hd, decay=decay, given_state=given,
               tma=tma, **errs, max_abs_err=max(errs["y"], errs["state"]), ms=ms,
               **dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    log(f"[{phase}] " + json.dumps(row))
    log(f"[{phase}] B.7 {tag}: device {1e3 * dev_ms:.2f} us "
        f"[{WKV6_PREVIOUS_US.get(tag, 'not measured')}], call {1e3 * ms:.2f} us, plain "
        f"{1e3 * plain_ms:.2f} us, bound {1e3 * bound:.3f} us ({by})")
    return row


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


def _serve_model(arch: str, n_layers: int | None = None, smoke: bool = False, **fields):
    """``arch``'s model at its published width (``smoke``: its smoke
    config), cut to ``n_layers``, other config ``fields`` replaced."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import TransformerLM

    cfg = get_arch(arch, smoke=smoke)
    if n_layers is not None:
        fields["n_layers"] = n_layers
    return TransformerLM(dataclasses.replace(cfg, **fields) if fields else cfg)


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
    x, _ = model._input_embed(params, {"tokens": prompt})
    worst = {"layer_out_rel_err": 0.0, "layer_state_rel_err": 0.0}
    for blk, ffn, p, _ in model._layers(params):
        if blk != "rwkv":
            raise ValueError(f"layer by layer is for rwkv blocks, got {blk!r}")
        y, _, state = model._apply_layer_fwd(p, x, blk, ffn, 0.0, True)
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


# qwen2-0.5b at compute_dtype=bfloat16: served at full width and depth as the
# float32 serve phase runs it, and cut to 2 layers on the card vs the CPU
SERVE_BF16 = ("qwen2_0_5b", 512, 64)        # arch, prompt, new tokens
SERVE_BF16_PARITY = (2, 64)                 # layers, prompt (SERVE_PARITY_GEN new tokens)
# card vs CPU in bfloat16, in bfloat16 ulps of the largest |value| of each
# tensor compared (logits, every cache leaf).  Both sides are the port's
# model, rounding at the same places; they take float32 sums in other
# orders (cuBLAS and B.6 against the CPU's products), so a sum within
# float32 noise of a rounding boundary lands on the neighbouring bfloat16
# value and the next norm spreads that over its row: 1.2 ulps measured on
# an H100 at this cut, up to 1.35 against the reference at the smoke width
# (tests/test_torch_lm_bf16.py); a kernel fault moves whole rows by far more
SERVE_BF16_ULPS = 4.0


def bf16_ulps_of_max(got, want) -> float:
    """max |got - want| in bfloat16 ulps of max |want|."""
    largest = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(largest)) - 7) if largest > 0 else 2.0 ** -133
    return float((got.float() - want.float()).abs().max()) / ulp


def phase_serve_bf16(f32: dict) -> dict:
    """qwen2-0.5b served with ``compute_dtype=bfloat16`` at full width and
    depth (batch 4, prompt 512, 64 new tokens, as the float32 serve phase
    ``f32``): exactly one B.6 launch per attention layer per prefill, each
    on bfloat16 q, k, v with K/V staged by TMA; prefill tok/s and decode
    ms/token beside the float32 phase's.  Then cut to 2 layers, the same
    seeded weights on the card (kernels) and the CPU (plain versions):
    logits and cache within SERVE_BF16_ULPS, greedy tokens equal up to a
    row's first step whose top-2 gap is under twice the measured logit
    error (the near-tie rule of _routing_vs)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import timed_generate

    t_start = time.perf_counter()
    arch, prompt_len, gen_len = SERVE_BF16
    model = _serve_model(arch, compute_dtype=torch.bfloat16)
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt_len))).cuda()
    per_prefill = sum(blk != "rwkv" for blk, _ in cfg._full_pattern())
    rec = dict(arch=cfg.name, compute_dtype="bfloat16", n_layers=cfg.n_layers,
               d_model=cfg.d_model, batch=SERVE_BATCH, prompt_len=prompt_len, gen_len=gen_len)
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_counts()
        tokens, stats = timed_generate(model, params, prompt, gen_len)
        check_counts("serve-bf16", kernel_counts(), {"flash_attention_fwd": 2 * per_prefill})
        rec.update(prefill_tok_s=stats["prefill"]["tok_s"],
                   prefill_steady_s=stats["prefill"]["steady_s"],
                   decode_ms_per_token=1e3 * stats["decode"]["steady_s"] / max(1, gen_len - 1),
                   decode_tok_s=stats["decode"]["tok_s"],
                   float32=dict(prefill_tok_s=f32["prefill_tok_s"],
                                decode_ms_per_token=f32["decode_ms_per_token"]))
        reset_counts()
        dtypes: list = []
        out = {}

        def one_prefill():
            out["run"] = _generate(model, params, prompt, gen_len, use_prefill=True)

        audit = tma_audit(one_prefill, dtypes)
        check_counts("serve-bf16 one prefill", kernel_counts(),
                     {"flash_attention_fwd": per_prefill})
        if audit["fwd"] != per_prefill or set(dtypes) != {torch.bfloat16}:
            raise AssertionError(f"[serve-bf16] B.6 calls {audit}, q dtypes {set(dtypes)}: want "
                                 f"{per_prefill} bfloat16 calls per prefill")
        logits, _, toks, _ = out["run"]
        if not torch.equal(toks, tokens):
            raise AssertionError("[serve-bf16] timed_generate and a second greedy run differ")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("[serve-bf16] logits not finite")
        rec.update(launches=2 * per_prefill, launches_per_prefill=per_prefill,
                   bf16_launches_audited=len(dtypes), tokens_total=tokens.numel())
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, out
    torch.cuda.empty_cache()
    rec["parity"] = _serve_bf16_parity(arch)
    rec["phase_s"] = time.perf_counter() - t_start
    log("[serve-bf16] " + json.dumps(rec))
    log(f"[serve-bf16] prefill {rec['prefill_tok_s']:.1f} tok/s in bfloat16, "
        f"{f32['prefill_tok_s']:.1f} in float32; decode {rec['decode_ms_per_token']:.3f} "
        f"ms/token in bfloat16, {f32['decode_ms_per_token']:.3f} in float32")
    return rec


def _serve_bf16_parity(arch: str) -> dict:
    """``arch`` at compute_dtype=bfloat16 cut to SERVE_BF16_PARITY's layers,
    full width: the card against the CPU (see phase_serve_bf16)."""
    import numpy as np
    import torch

    layers, prompt_len = SERVE_BF16_PARITY
    model = _serve_model(arch, n_layers=layers, compute_dtype=torch.bfloat16)
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
            want = {"flash_attention_fwd": layers} if device == "cuda" else {}
            if device == "cuda":
                check_counts(f"serve-bf16 parity {arch}", counts, want)
            elif sum(c[1] for c in counts.values()) == 0 or sum(c[0] for c in counts.values()):
                raise AssertionError(f"[serve-bf16] {arch} on the CPU: {counts}")
    (lg, cg, tg, _), (lc, cc, tc, gaps) = runs["cuda"], runs["cpu"]
    errs = {"logits": bf16_ulps_of_max(lg.cpu(), lc)}
    got, want = _leaves(cg), _leaves(cc)
    for name in want:
        errs[name] = bf16_ulps_of_max(got[name].cpu(), want[name])
    worst = max(errs, key=errs.get)
    if errs[worst] > SERVE_BF16_ULPS:
        raise AssertionError(f"[serve-bf16] {arch} {layers} layers, card vs CPU: {worst} "
                             f"{errs[worst]} bf16 ulps of max |x| > {SERVE_BF16_ULPS}: {errs}")
    logit_err = float((lg.cpu() - lc).abs().max())
    rec = dict(n_layers=layers, prompt_len=prompt_len, ulps_of_max=errs, worst=worst,
               logits_max_abs_err=logit_err,
               tokens_identical=_same_tokens(f"serve-bf16 parity {arch}", tg.cpu(), tc, gaps,
                                             2 * logit_err),
               tokens_total=tc.numel())
    log("[serve-bf16] parity " + json.dumps(rec))
    return rec


# -- LM training: B.1 and B.6's backward, and the qwen2-0.5b trainer -------------

LM_ARCH = "qwen2_0_5b"
LM_NODES, LM_STEPS, LM_SEQ = 8, 20, 64       # train_lm's defaults; 20 steps
LM_BATCH = 2                                # train_lm's batch per node
LM_PAIR = ("flash_attention_fwd", "flash_attention_bwd")  # an attention layer's kernels
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
    shorten the sum.  The median over ``windows`` windows that recorded
    any device time (seen on the H100: windows of SDPA at batch 1 that
    recorded none), in at most four times as many tries; 0.0 where none did."""
    per_call = []
    for _ in range(4 * windows):  # a window the profiler recorded nothing of is taken again
        _, prof = profiled(fn, iters)
        ms = sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                 for e in device_events(prof.key_averages()) if e.count) / 1e3
        if ms > 0:
            per_call.append(ms)
        if len(per_call) == windows:
            return sorted(per_call)[windows // 2]
    log(f"[profile] device time recorded in {len(per_call)} of {4 * windows} windows")
    return sorted(per_call)[len(per_call) // 2] if per_call else 0.0


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
                **device_time(call, max(2, iters // 4), names or KERNELS[name][2]))


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
    eta = torch.full((), 0.01, device="cuda")  # η as the train step hands it over: by pointer
    w_ring = metropolis_weights(ring_graph(LM_NODES))
    cases += [("qwen2", leaf, LM_NODES, shape, w_ring) for leaf, shape in sorted(lm_shapes.items())]
    for group, leaf, k, shape, w_np in cases:
        theta, grad = randn(k, *shape), randn(k, *shape)
        w = torch.from_numpy(np.asarray(w_np, np.float32)).cuda()
        s = torch.rand((k,), generator=gen, device="cuda") + 0.5
        got = gk.gossip_update_stacked(theta, grad, w, s, eta=eta)
        want = gref.gossip_update_stacked_ref(theta, grad, w, s, eta=eta)
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
                       lambda: gk.gossip_update_stacked(theta, grad, w, s, eta=eta),
                       lambda: gref.gossip_update_stacked_ref(theta, grad, w, s, eta=eta),
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
                   stacked_cols=gk.STACKED_COLS, node_nbr_pool=gk.NODE_NBR_POOL):
        raise AssertionError(f"[b1-kernel] gossip_update.cu's sizes {cfg} are not the wrapper's")
    out = dict(max_abs_err=0.0, max_rel_err=0.0, rows=[], **cfg)
    eta = torch.full((), 0.01, device="cuda")  # η as the train step hands it over: by pointer
    for group, k, shapes, w_np in groups:
        thetas = [torch.randn((k, *shape), generator=gen, device="cuda") for shape in shapes]
        grads = [torch.randn((k, *shape), generator=gen, device="cuda") for shape in shapes]
        w = torch.from_numpy(np.asarray(w_np, np.float32)).cuda()
        s = torch.rand((k,), generator=gen, device="cuda") + 0.5
        before = gk.gossip_update_stacked_grouped.launches
        got = gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=eta)
        launches = gk.gossip_update_stacked_grouped.launches - before
        if launches != len(gk.leaf_tables([t.numel() // k for t in thetas])):
            raise AssertionError(f"[b1-kernel] grouped stacked {group}: {launches} launches")
        for i in range(len(shapes)):
            one = gk.gossip_update_stacked(thetas[i], grads[i], w, s, eta=eta)
            if not torch.equal(got[i], one):
                raise AssertionError(f"[b1-kernel] grouped stacked {group} leaf {i} != the "
                                     f"one-leaf kernel (max abs err {_max_diff(got[i], one)})")
            del one
            want = gref.gossip_update_stacked_ref(thetas[i], grads[i], w, s, eta=eta)
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
            gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=eta)

        def one_leaf():
            for theta, grad in zip(thetas, grads):
                gk.gossip_update_stacked(theta, grad, w, s, eta=eta)

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
    cases = [  # tag, b, h, kvh, s, hd, window, softcap; the first is the main path's
        (FOLDED_CASE, LM_NODES * LM_BATCH, 14, 2, LM_SEQ, 64, None, None),
        ("qwen2-0.5b train S 64", 2, 14, 2, 64, 64, None, None),
        ("qwen2-0.5b train S 512", 2, 14, 2, 512, 64, None, None),
        ("qwen2-0.5b prefill", 4, 14, 2, 512, 64, None, None),
        ("hd 80, window 4096", 2, 32, 8, 512, 80, 4096, None),
        ("hd 128, window 64, softcap 50", 2, 32, 16, 512, 128, 64, 50.0),
        ("G = 1", 2, 8, 8, 512, 64, None, None),
        ("ragged S = 300", 4, 14, 2, 300, 64, None, None),
        (HD32_CASE, 4, 8, 2, 128, 32, None, None),
        *A11_FWD_CASES[1:],
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
                   **{"cold_" + key: value
                      for key, value in device_time(cold_call, 10, names).items()},
                   bound_ms=bound,
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


def _lm_counts(nodes: int, steps: int, layers: int, leaves: int, pair=LM_PAIR,
               folded: bool = False) -> dict:
    """Launches of one LM training run: the layers' kernel forward and
    backward (``pair``: B.6 on attention layers, RWKV_PAIR on rwkv layers)
    on each of the ``layers`` that run it (_pair_layers) of every node, or
    once for all nodes where the forward takes the node axis (``folded``:
    _folded), B.1 once per 16 leaves, every step."""
    per = steps * layers * (1 if folded else nodes)
    return {pair[0]: per, pair[1]: per,
            "gossip_update_stacked_grouped": steps * -(-leaves // 16)}


def _folded(cfg, pair=LM_PAIR) -> bool:
    """Whether a training step of ``cfg`` launches B.6 once per layer for
    all its nodes (a dense LM: the node axis folds K into B.6's batch)
    rather than once per layer of every node."""
    from repro_torch.models.transformer import node_axis_declined

    return pair == LM_PAIR and node_axis_declined(cfg) is None


def _pair_layers(cfg, pair=LM_PAIR) -> int:
    """The layers that run ``pair``: attn/swa for B.6, rwkv for B.7 (mamba
    blocks and MoE FFNs run plain PyTorch)."""
    kinds = ("rwkv",) if pair == RWKV_PAIR else ("attn", "swa")
    return sum(blk in kinds for blk, _ in cfg._full_pattern())


def _node_losses(trainer, state, batch) -> list:
    """Each node's loss on ``batch``: its tokens, or (tokens, embeddings)."""
    import torch

    batch = (batch,) if isinstance(batch, torch.Tensor) else batch
    with torch.no_grad():
        return trainer.loss_fn(state.params, tuple(b.to(trainer.device) for b in batch)
                               ).tolist()


def _lm_embeddings(cfg, nodes: int, steps: int, seed: int = 0):
    """A stub frontend's embeddings as train_lm draws them (seed 0):
    (steps, nodes, LM_BATCH, P, D); None for a token frontend."""
    import numpy as np

    if cfg.frontend == "token":
        return None
    rng = np.random.default_rng(seed)
    return np.stack([rng.standard_normal((nodes, LM_BATCH, cfg.frontend_len, cfg.d_model)
                                         ).astype(np.float32) * 0.02 for _ in range(steps)])


def _lm_tokens(nodes: int, steps: int, vocab: int, seq: int = LM_SEQ):
    """train_lm's token streams (seed 0) at its batch: (steps, nodes,
    LM_BATCH, seq)."""
    import numpy as np

    from repro_torch.data import make_node_token_streams

    streams = make_node_token_streams(nodes, vocab, seed=0)
    return np.stack([np.stack([s.next_batch(LM_BATCH, seq) for s in streams])
                     for _ in range(steps)])


def _lm_step_profile(trainer, box, batch, pair) -> tuple[dict, object]:
    """One training step from ``box[0]`` (the state, replaced) under the
    profiler: wall and device-busy ms, the busy share, the layers' kernel
    pair's device ms, device ops and the eight costliest device kernels."""
    def one_step():
        box[0], _ = trainer.step(box[0], batch)

    p_wall, prof = profiled(one_step, 1)
    avg = prof.key_averages()
    dev = device_events(avg)
    busy_us = sum(e.self_device_time_total for e in dev)
    kern = [sum(e.self_device_time_total for e in device_events(avg, *KERNELS[name][2])) / 1e3
            for name in pair]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=1e3 * p_wall, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / 1e6 / p_wall, fwd_device_ms=kern[0],
                bwd_device_ms=kern[1], device_ops=sum(e.count for e in dev),
                top=[(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count)
                     for e in top]), prof


def _lm_run_record(tag: str, trainer, state, model, nodes: int, seq: int, history: list,
                   steady_s, counts: dict, pair, first, loss_before: float) -> dict:
    """The record and checks of one LM training run: exact launches
    (_lm_counts), every logged metric finite, the steady ms per step (median
    of ``steady_s``), peak memory, and the first batch's mean node loss lower
    after the run than ``loss_before``."""
    import numpy as np
    import torch

    cfg = model.cfg
    check_counts(tag, counts, _lm_counts(nodes, len(history), _pair_layers(cfg, pair),
                                         len(state.params), pair, _folded(cfg, pair)))
    for r in history:
        for key, x in r.items():
            if isinstance(x, float) and not math.isfinite(x):
                raise AssertionError(f"[{tag}] step {r['step']}: {key} = {x}")
    ms_step = 1e3 * float(np.median(steady_s))
    tokens = nodes * LM_BATCH * seq
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, params=model.num_params(),
               nodes=nodes, batch=LM_BATCH, seq_len=seq, steps=len(history),
               ms_per_step=ms_step, ms_per_step_min=1e3 * float(np.min(steady_s)),
               tokens_per_step=tokens, tokens_per_s=tokens / (ms_step / 1e3),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss_first_step=history[0]["loss_mean"], loss_last_step=history[-1]["loss_mean"],
               first_batch_loss_before=loss_before,
               first_batch_loss_after=float(np.mean(_node_losses(trainer, state, first))),
               ln_vocab=math.log(cfg.vocab),
               launches={n: c[0] for n, c in counts.items() if c[0]})
    if not rec["first_batch_loss_after"] < rec["first_batch_loss_before"]:
        raise AssertionError(f"[{tag}] the first batch's loss did not fall: {rec}")
    return rec


COMPILED_TURNS = ("eager", "captured", "captured", "eager")  # in one process, alternated
COMPILED_LM_STEPS = 5        # qwen2-0.5b steps of each turn, compared after the last
# the unfused step's turns on fmnist_default (A.14 (a) and (b)): steps per
# turn (more than one packing of captured.PACK_STEPS = 64), and the stacks
COMPILED_FM_STEPS = 100
COMPILED_FM_STACKS = ("dense-int8-kernel-ef", "gossip-int8-kernel-ef",
                      "dense-int8-kernel-adaptive", "nesterov", "adam")
# qwen2-0.5b with Nesterov momentum (beta 0.9) and the dense int8 EF wire
# through B.2: the largest of K = 8, 4, 2 at which the eager step fits the
# card (PERF.md §6: ~7.6 node-stacked float32 copies of 1.98 GB per node at
# its peak, 60 GB at K = 4, 120 GB at K = 8); the ring at K = 4
COMPILED_LM_UNFUSED_NODES = 4
# the captured qwen2 step's peak allocated memory may pass the eager step's by
# this share of one node-stacked copy (158 MB of 15.8 GB at K = 8): what the
# captured run keeps beside the step (the capture's stream and its library
# workspaces, the packed inputs, the metrics buffer; 67 MB measured)
COMPILED_PEAK_MARGIN = 0.01
COMPILED_PROFILED = {"gossip_update_stacked_grouped": "gossip_update_stacked_grouped_kernel",
                     "flash_attention_fwd": "flash_fwd_mma_kernel",
                     "flash_attention_bwd": "bwd_mma_kernel",
                     "uniforms_grouped": "philox_uniforms_kernel",
                     "quantize_blockwise_grouped": "masked_quantize_grouped_kernel",
                     "dequant_accumulate_grouped_": "masked_dequant_acc_grouped_kernel",
                     # B.2 is B.4's kernel and B.3 B.5's: a stack launches one of each pair
                     "masked_quantize_blockwise_grouped": "masked_quantize_grouped_kernel",
                     "masked_dequant_accumulate_grouped_": "masked_dequant_acc_grouped_kernel",
                     }  # counter -> its kernel's name
# A.14 (c): fig9/fig11's dynamics, hub, local-update and EF-gossip stacks on
# their task (K = 8 ring, Metropolis W, DR-DSGD mu = 3, the paper's MLP),
# COMPILED_DYN_STEPS steps a turn, one graph per branch the host chooses
COMPILED_DYN_STEPS = 100
COMPILED_DYN_STACKS = ("dense-dropout0.2-H4-gt", "dense-faults-skips-compute",
                       "gossip-straggler0.1-int8-kernel-memoryless",
                       "gossip-dropout0.2-int8-kernel-ef-B4-H2",
                       "gossip-dropout0.2-int8-kernel-ef-adaptive", "dense-geometric",
                       "hub-H4-fedavg-int8-kernel", "hub-H1", "dense-mix-every-2",
                       "repeat-gossip-int8-kernel-ef-2")
COMPILED_EF_THRESHOLD = 0.5   # the adaptive re-base's drift threshold (its drift passes it
                              # every few rounds on this task)
# qwen2-0.5b, SGD over DynamicGossipMixer(DropoutSchedule(W, 0.2), int8 EF kernel
# wire, ef_rebase_every = 4): the largest of K = 8, 4 and 2 at which the eager
# step fits the card (PERF.md §6: ~7.6 node-stacked float32 copies of 1.98 GB
# per node at its peak, ~60 GB at K = 4, ~120 GB at K = 8); the ring at K = 4;
# 8 steps a turn, so that both the delta and the re-base graphs replay
COMPILED_LM_DYN_NODES = 4
COMPILED_LM_DYN_STEPS = 8
COMPILED_PROFILE_TRIES = 3
COMPILED_PROFILED_STEPS = (20, 2)  # the profiled run's steps: fmnist, qwen2-0.5b
LEAD_FILL = "FillFunctor<short>"  # the lead fills' kernel, which no step launches


def _busy_us(prof, skip: str) -> float:
    """The device's busy time in a profile: the union of its device events'
    intervals (a name holding ``skip`` left out), so overlapping events
    count once."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and skip not in e.name)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _mode_profile(trainer, box, batches, names) -> dict:
    """One run of the stacked ``batches`` (n steps) from ``box[0]``
    (replaced) under the profiler, its window opened by PROFILE_LEAD int16
    fills (see device_time; left out of the readings): wall and device-busy
    ms per step, the busy share, device ops per step, and per kernel of
    ``names`` (counter names of COMPILED_PROFILED) its launches in the
    profile beside the launch counters'.  A window whose profile disagrees
    with the counters is retried with 4x the fills, at most
    COMPILED_PROFILE_TRIES times; then the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lead = torch.empty(1, dtype=torch.int16, device="cuda")
    seen = []
    for attempt in range(COMPILED_PROFILE_TRIES):
        before = kernel_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD * 4 ** attempt):
                lead.fill_(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # handed over without a name: the run frees its first state
            state, _ = trainer.run(box.pop(), batches)
            box.append(state)
            del state
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = kernel_counts()
        dev = [e for e in device_events(prof.key_averages()) if LEAD_FILL not in e.key]
        busy_us = _busy_us(prof, LEAD_FILL)
        launches = {n: (after[n][0] - before[n][0],
                        sum(e.count for e in dev if COMPILED_PROFILED[n] in e.key))
                    for n in names}
        seen.append(launches)
        if all(c == p for c, p in launches.values()):
            n = batches[0].shape[0]
            return dict(steps=n, wall_ms_per_step=1e3 * wall / n,
                        device_busy_ms_per_step=busy_us / 1e3 / n,
                        device_busy_share=busy_us / 1e6 / wall,
                        device_ops_per_step=sum(e.count for e in dev) / n,
                        launches_counter_vs_profiler=launches, windows=attempt + 1)
    raise AssertionError(f"[compiled] the profiler's launches never matched the counters "
                         f"(counter, profiler) per window: {seen}")


def _update_rule(params, ref: dict, start: dict) -> dict:
    """``params`` against ``ref`` (host copies) by the train-parity rule:
    every entry within RWKV_UPDATE_REL of the largest update of ``ref``
    from ``start`` (one node's initial leaves), or within UPDATE_ULPS
    float32 ulps of its own value."""
    import torch

    largest = max(float((ref[n] - start[n].unsqueeze(0)).abs().max()) for n in ref)
    outside, worst = 0, 0.0
    for n in ref:
        got = params[n].cpu()
        diff = (got - ref[n]).abs()
        ulp = torch.nextafter(ref[n].abs(), torch.tensor(math.inf)) - ref[n].abs()
        bad = (diff > RWKV_UPDATE_REL * largest) & (diff > UPDATE_ULPS * ulp)
        outside += int(bad.sum())
        worst = max(worst, float(diff.max()) / largest)
    return dict(largest_update=largest, worst_rel_to_largest_update=worst,
                entries_outside=outside, rtol=RWKV_UPDATE_REL, ulps=UPDATE_ULPS)


DIGEST_ROW = 1 << 24  # elements per digest row


def _digests(params: dict) -> dict:
    """Per leaf, a bitwise digest on the card: for each row of DIGEST_ROW
    elements, the sum of the elements' 32-bit patterns times fixed odd
    64-bit multipliers, wrapping mod 2**64 (a linear hash: two leaves whose
    bits differ anywhere give a different row sum but for one chance in
    2**64).  Bit-equality of node-stacked copies without a second copy on
    the card or a host round trip of each.  32-bit leaves (float32; an
    int64 leaf as its two words)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 - 1)
    mult = torch.randint(-2 ** 62, 2 ** 62, (DIGEST_ROW,), generator=gen, device="cuda",
                         dtype=torch.int64) | 1
    out = {}
    for name, x in params.items():
        bits = x.contiguous().reshape(-1).view(torch.int32)
        rows = [bits[i:i + DIGEST_ROW] for i in range(0, bits.numel(), DIGEST_ROW)]
        out[name] = tuple(int((r.long() * mult[:r.numel()]).sum()) for r in rows)
    return out


def _mode_turns(tag: str, build, init, batches, steps: int, names, copy_bytes: int,
                start: dict, profiled_steps: int, want_programs: int = 1) -> dict:
    """COMPILED_TURNS over one configuration: per turn ``build(jit)``'s
    trainer runs ``steps`` steps of ``batches`` from ``init(trainer)`` (the
    first alone: the eager step, or the warm-up and capture; the rest
    timed), its final parameters (their _digests; the first eager turn's
    leaves kept on the host, so that no turn holds a fourth node-stacked
    copy on the card), its optimizer state and CommState tensors (the
    _digests of every tensor of the carry, captured._tensors), host fields
    and metrics held against the first eager turn's bit for bit, or else
    the parameters by the train-parity rule (_update_rule, from
    ``start``), then, in the first turn of each mode, ``profiled_steps``
    more steps profiled (_mode_profile).  Each turn's record: ms per step
    over the timed steps, peak memory above the turn's start (and in node-stacked parameter
    copies of ``copy_bytes``) and peak reserved memory (between replays
    the graph pool's blocks are reserved, not allocated), the programs the
    watchdog saw, the launches of the run (and B.2's with qmax read on the
    card).  ``want_programs``: the graphs a captured turn may capture (one
    per branch it meets).  Returns {"turns": [...], "bitwise": per later turn,
    "leaves": the counts a bit-equal turn has}."""
    import torch

    from repro_torch.core.captured import _tensors
    from repro_torch.kernels.quant_gossip import kernel as qk
    from repro_torch.obs import RecompileWatchdog

    out, ref, ref_ms, profiled_modes = [], None, None, set()
    for turn in COMPILED_TURNS:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        trainer = build(turn == "captured")
        watch = RecompileWatchdog(label=f"compiled {tag}")
        if turn == "captured":
            watch.track("run", trainer._run, allowed=want_programs)
        reset_counts()
        first = tuple(b[:1] for b in batches)
        rest = tuple(b[1:steps] for b in batches)
        box = [trainer.run(init(trainer), first)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the states are handed over without a name: no step holds a fourth copy
        state, ms0 = box.pop()
        box.append(state)
        del state
        state, ms = trainer.run(box.pop(), rest)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.perf_counter() - t0) / (steps - 1)
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated() - base
        # the graph pool's blocks count as reserved, not allocated, between replays
        peak_reserved = torch.cuda.max_memory_reserved() - base_reserved
        ms = {k: torch.cat([ms0[k], ms[k]]).cpu() for k in ms}
        tensor_qmax = qk.quantize_blockwise_grouped.tensor_qmax_launches
        rule, differ, digests = None, None, _digests(_tensors(state))
        host = (state.step, state.comm.key, state.comm.rounds, state.comm.ef_rounds)
        if ref is None:
            ref = {n: t.cpu() for n, t in state.params.items()}
            ref_ms, ref_digests, ref_host, equal = ms, digests, host, None
        else:
            equal = dict(carry=sum(digests.get(p) == d for p, d in ref_digests.items()),
                         metrics=sum(bool(torch.equal(ms[k], ref_ms[k])) for k in ref_ms),
                         host=int(host == ref_host))
            differ = dict(carry=[p for p, d in ref_digests.items() if digests.get(p) != d],
                          metrics=[k for k in ref_ms if not torch.equal(ms[k], ref_ms[k])])
            if any(p.startswith("params/") for p in differ["carry"]):
                rule = _update_rule(state.params, ref, start)
        programs = watch.check() if turn == "captured" else None
        box = [state]
        del state
        profiled = None
        if turn not in profiled_modes:  # one profiled run per mode
            profiled_modes.add(turn)
            profiled = _mode_profile(trainer, box, tuple(b[steps:steps + profiled_steps]
                                                         for b in batches), names)
        rec = dict(mode=turn, step=("captured" if trainer.captured
                                    else f"eager ({trainer.capture_declined})"),
                   steps=steps, ms_per_step=ms_step, peak_memory_gb=peak / 1e9,
                   peak_node_stacked_copies=peak / copy_bytes, base_memory_gb=base / 1e9,
                   peak_reserved_gb=peak_reserved / 1e9,
                   programs=programs, bitwise_vs_first_eager=equal, differ=differ,
                   update_rule=rule, tensor_qmax_launches=tensor_qmax,
                   launches={n: c[0] for n, c in counts.items() if c[0]},
                   plain_calls=sum(c[1] for c in counts.values()), profile=profiled)
        log(f"[compiled] {tag} {turn}: " + json.dumps(rec))
        out.append(rec)
        del box, trainer, watch
    want_equal = dict(carry=len(ref_digests), metrics=len(ref_ms), host=1)
    bitwise = [r["bitwise_vs_first_eager"] == want_equal for r in out[1:]]
    return dict(turns=out, bitwise=bitwise, leaves=want_equal, metrics=ref_ms)


def _compiled_fm_stack(spec_cls, cfg_cls, stack: str, exp, jit: bool):
    """fmnist_default's trainer on ``stack`` (COMPILED_FM_STACKS), its names
    profiled and its launches per step: the dense int8 EF wire through B.2,
    static 5-matching gossip with it (B.2 and B.3), the dense int8 wire
    under fig8's adaptive schedule (B.2 reading qmax through its pointer),
    and Nesterov momentum and Adam (phase_optim's) on the uncompressed
    dense W (no kernel).  One Philox launch per round with a wire."""
    from repro_torch.models import make_classifier_loss, mlp_apply

    kernel_int8 = cfg_cls(kind="int8", use_kernel=True)
    mixer, optimizer, compress = None, None, "none"
    if stack == "dense-int8-kernel-ef":
        compress = kernel_int8
    elif stack == "dense-int8-kernel-adaptive":
        compress = _sched_cfg(cfg_cls, "adaptive", use_kernel=True)
    elif stack == "gossip-int8-kernel-ef":
        from repro_torch.graphs import build_graph, metropolis_weights

        w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
        mixer = _gossip_mixer(stack, _matchings(exp.p, exp.seed), w, exp.seed, cfg_cls)
        compress = mixer.compression
    else:
        optimizer = _optimizer("nesterov" if stack == "nesterov" else "adam-warmup-cosine-wd")
    trainer = _spec(spec_cls, exp, compress, jit=jit).build(
        make_classifier_loss(mlp_apply), mlp_apply, mixer=mixer, optimizer=optimizer)
    per_step = {"uniforms_grouped": 0 if compress == "none" else 1}
    if compress != "none":
        per_step["quantize_blockwise_grouped"] = 1
    if mixer is not None:
        per_step["dequant_accumulate_grouped_"] = _matchings(exp.p, exp.seed).num_rounds
    return trainer, [n for n, c in per_step.items() if c], per_step


def _compiled_checks(tag: str, run: dict, want: dict, gate_memory: bool,
                     tensor_qmax: int | None = None, programs: int = 1) -> dict:
    """One configuration's turns held: exact launches, no plain version,
    ``programs`` programs per captured turn (one per branch met), B.2's
    tensor-qmax launches where given,
    the captured peak within COMPILED_PEAK_MARGIN of the eager one where
    ``gate_memory``, and every later turn bit-equal to the first eager
    turn's.  Returns the configuration's record."""
    for r in run["turns"]:
        check_counts(f"compiled {tag} {r['mode']}", {n: (r["launches"].get(n, 0), 0)
                                                     for n in kernel_counts()}, want)
        if r["plain_calls"]:
            raise AssertionError(f"[compiled] {tag} {r['mode']}: a plain version ran")
        if r["mode"] == "captured" and r["programs"] != {"run": programs}:
            raise AssertionError(f"[compiled] {tag}: {r['programs']} programs captured")
        if tensor_qmax is not None and r["tensor_qmax_launches"] != tensor_qmax:
            raise AssertionError(f"[compiled] {tag} {r['mode']}: B.2 read qmax on the card "
                                 f"{r['tensor_qmax_launches']} times, want {tensor_qmax}")
    eager = max(r["peak_node_stacked_copies"] for r in run["turns"] if r["mode"] == "eager")
    captured = max(r["peak_node_stacked_copies"] for r in run["turns"]
                   if r["mode"] == "captured")
    rec = dict(turns=run["turns"], bitwise=run["bitwise"], leaves=run["leaves"],
               peak_copies_eager=eager, peak_copies_captured=captured)
    # at qwen2 the node-stacked copies are the step's memory (fmnist's are a
    # few MB beside its batches): the captured step updates its one slot in
    # place, so it holds no more than the eager step
    if gate_memory and captured > eager + COMPILED_PEAK_MARGIN:
        raise AssertionError(f"[compiled] {tag}: the captured step holds {captured:.3f} "
                             f"node-stacked copies at its peak, eager {eager:.3f}")
    return rec


def _compiled_dyn_stack(spec_cls, cfg_cls, stack: str, jit: bool, n: int):
    """fig9/fig11's ``stack`` (COMPILED_DYN_STACKS) on its task: the
    trainer, the counters its profile holds and its launches over ``n``
    steps: the coins (one Philox draw per round of a dropout, geometric or
    faulted topology; again for the tracker exchange and for
    straggler_skips_compute's up vector), the wire's noise (one Philox draw
    per round, per matching on the memoryless wire), B.4 per matching
    (memoryless) or per round (EF), B.5 per matching of a delta round (and
    of every adaptive round, which runs both accumulations), B.2 per round
    and B.3 per matching (static EF under RepeatMixer: two rounds a step),
    B.2 per consensus round (int8 FedAvg)."""
    from repro_torch.core.consensus import make_gossip_mixer, repeat_mixer
    from repro_torch.dynamics import (
        DropoutSchedule,
        DynamicGossipMixer,
        FaultConfig,
        LocalUpdateMixer,
        StaticSchedule,
    )
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import make_classifier_loss, mlp_apply

    w = metropolis_weights(build_graph("ring", FIG_K))
    m = _ring_decomp().num_rounds
    kernel_int8 = cfg_cls(kind="int8", use_kernel=True)
    mixer, compress, kw = None, "none", {}
    b, h = EF_LOCAL
    if stack == "dense-dropout0.2-H4-gt":
        kw = dict(topology="dropout", drop_p=FIG9_DROP, local_updates=4, gradient_tracking=True)
        want = {"uniforms_grouped": 2 * (n // 4)}
    elif stack == "dense-faults-skips-compute":
        kw = dict(FIG9_FAULTS, straggler_skips_compute=True)
        want = {"uniforms_grouped": 2 * n}
    elif stack == "gossip-straggler0.1-int8-kernel-memoryless":
        mixer = DynamicGossipMixer(
            StaticSchedule(w, device="cuda"),
            faults=FaultConfig(straggler_p=FIG9_FAULTS["straggler_p"], seed=0),
            quantized=cfg_cls(kind="int8", use_kernel=True, error_feedback=False))
        want = {"masked_quantize_blockwise_grouped": n * m,
                "masked_dequant_accumulate_grouped_": n * m, "uniforms_grouped": n * m + n}
    elif stack == "gossip-dropout0.2-int8-kernel-ef-B4-H2":
        mixer = LocalUpdateMixer(DynamicGossipMixer(
            DropoutSchedule(w, FIG9_DROP, seed=0, device="cuda"), quantized=kernel_int8,
            ef_rebase_every=b), h)
        rounds = n // h
        want = {"masked_quantize_blockwise_grouped": rounds,
                "masked_dequant_accumulate_grouped_":
                    m * sum(1 for c in range(rounds) if c % b != b - 1),
                "uniforms_grouped": 2 * rounds}
    elif stack == "gossip-dropout0.2-int8-kernel-ef-adaptive":
        mixer = DynamicGossipMixer(DropoutSchedule(w, FIG9_DROP, seed=0, device="cuda"),
                                   quantized=kernel_int8,
                                   ef_rebase_threshold=COMPILED_EF_THRESHOLD)
        want = {"masked_quantize_blockwise_grouped": n,
                "masked_dequant_accumulate_grouped_": n * m, "uniforms_grouped": 2 * n}
    elif stack == "dense-geometric":
        kw = dict(topology="geometric")
        want = {"uniforms_grouped": n}
    elif stack == "hub-H4-fedavg-int8-kernel":
        kw, compress = dict(topology="hub", local_updates=HUB_H), kernel_int8
        want = {"quantize_blockwise_grouped": n // HUB_H, "uniforms_grouped": n // HUB_H}
    elif stack == "hub-H1":
        kw, want = dict(topology="hub"), {}
    elif stack == "dense-mix-every-2":
        kw, want = dict(mix_every=2), {}
    elif stack == "repeat-gossip-int8-kernel-ef-2":
        mixer = repeat_mixer(make_gossip_mixer(_ring_decomp(), kernel_int8, device="cuda"), 2)
        want = {"uniforms_grouped": 2 * n, "quantize_blockwise_grouped": 2 * n,
                "dequant_accumulate_grouped_": 2 * n * m}
    else:
        raise ValueError(stack)
    if mixer is not None:
        compress = mixer.compression or "none"
    trainer = _fig_spec(spec_cls, compress, FIG7_FMNIST, jit=jit, **kw).build(
        make_classifier_loss(mlp_apply), mlp_apply, mixer=mixer)
    return trainer, [k for k in want if k in COMPILED_PROFILED], want


def _adaptive_rebases(trainer, params, batches, steps: int):
    """The re-base rounds of ``steps`` eager steps of the adaptive EF stack,
    counted from each round's ``ef_drift`` against COMPILED_EF_THRESHOLD
    (the select's own test), and the steps' ``wire_bits`` metric."""
    import torch

    state, rebases, bits = trainer.init(params), 0, []
    for t in range(steps):
        state, m = trainer.step(state, tuple(b[t] for b in batches))
        rebases += float(state.comm.ef_drift) > COMPILED_EF_THRESHOLD
        bits.append(m["wire_bits"])
    return rebases, torch.stack(bits).cpu()


def _branches_met(trainer, state, steps: int) -> int:
    """The distinct branches of ``steps`` steps from ``state`` (the host
    function's): the graphs a captured run of them captures."""
    met, step, comm = set(), state.step, state.comm
    for _ in range(steps):
        branch, comm = trainer._train_step.host_branch(step, comm)
        met.add(branch)
        step += 1
    return len(met)


def phase_compiled(spec_cls, cfg_cls) -> dict:
    """A.14's captured step on the card against the eager one, the same
    weights and batches through ``jit=False`` and ``jit=True`` in
    alternated turns (COMPILED_TURNS) in one process: fmnist dense-none
    (fmnist_default: K = 10, 300 steps: the fused B.1 step), the unfused
    step's stacks of COMPILED_FM_STACKS (100 steps each), qwen2-0.5b at
    full width and depth (train_lm's stack, K = 8, seq 64,
    COMPILED_LM_STEPS steps: the fused step), and qwen2-0.5b with Nesterov
    momentum and the dense int8 EF wire (COMPILED_LM_UNFUSED_NODES nodes).
    Held: every turn's final carry (parameters, optimizer state, CommState
    tensors), host fields and metrics bit-equal to the first eager turn's;
    one captured program per trainer (RecompileWatchdog); exact launches
    (one Philox launch per round with a wire, B.2 per round, B.3 per
    matching, B.6 once per layer each way per qwen2 step), and the
    counters' launches of a profiled run equal to the profiler's; the
    captured qwen2 turns' peak memory above the turn's start no more than
    the eager turns' (COMPILED_PEAK_MARGIN).  fmnist is held bit for bit;
    the fused qwen2 turns, where a turn is not bit-equal, to the
    train-parity rule, with the leaves and metrics that differ logged.
    Prints per turn ms per step, device ops per step, the busy share, peak
    memory and the launches."""
    import torch

    from repro_torch.models import make_classifier_loss, make_lm_loss, mlp_apply
    from repro_torch.optim import momentum

    t_phase = time.perf_counter()
    out = {}
    exp, fed, _, fm_params = _fmnist()
    fm_batches = tuple(torch.from_numpy(b).cuda() for b in _sample(
        fed, exp.steps + COMPILED_PROFILED_STEPS[0], exp.batch_size, exp.seed))
    fm_copy = 4 * K * sum(x.numel() for x in fm_params.values())
    fm_start = {n: t.cpu() for n, t in fm_params.items()}

    def fm_build(jit):
        return _spec(spec_cls, exp, "none", jit=jit).build(make_classifier_loss(mlp_apply),
                                                           mlp_apply)

    fm = _mode_turns("fmnist dense-none", fm_build, lambda tr: tr.init(fm_params),
                     fm_batches, exp.steps, ["gossip_update_stacked_grouped"], fm_copy,
                     fm_start, COMPILED_PROFILED_STEPS[0])
    out["fmnist dense-none"] = _compiled_checks(
        "fmnist dense-none", fm, {"gossip_update_stacked_grouped": exp.steps,
                                  "uniforms_grouped": 0}, gate_memory=False)
    for stack in COMPILED_FM_STACKS:
        tag = f"fmnist {stack}"
        _, names, per_step = _compiled_fm_stack(spec_cls, cfg_cls, stack, exp, False)
        run = _mode_turns(tag, lambda jit, st=stack: _compiled_fm_stack(
                              spec_cls, cfg_cls, st, exp, jit)[0],
                          lambda tr: tr.init(fm_params), fm_batches, COMPILED_FM_STEPS, names,
                          fm_copy, fm_start, COMPILED_PROFILED_STEPS[0])
        out[tag] = _compiled_checks(
            tag, run, {n: c * COMPILED_FM_STEPS for n, c in per_step.items()},
            gate_memory=False,
            tensor_qmax=COMPILED_FM_STEPS if stack.endswith("adaptive") else None)
    # A.14 (c): fig9/fig11's stacks, one graph per branch met
    t_dyn = time.perf_counter()
    dyn_batches, _, dyn_params = _fig_data("mlp", COMPILED_DYN_STEPS + COMPILED_PROFILED_STEPS[0],
                                           FIG7_FMNIST[0])
    dyn_batches = tuple(torch.from_numpy(b).cuda() for b in dyn_batches)
    dyn_copy = 4 * FIG_K * sum(x.numel() for x in dyn_params.values())
    dyn_start = {n: t.cpu() for n, t in dyn_params.items()}
    for stack in COMPILED_DYN_STACKS:
        tag = f"fig9 {stack}"
        probe, names, want = _compiled_dyn_stack(spec_cls, cfg_cls, stack, False,
                                                 COMPILED_DYN_STEPS)
        programs = _branches_met(probe, probe.init(dyn_params), COMPILED_DYN_STEPS)
        adaptive = stack.endswith("adaptive")
        if adaptive:  # the drift select's two sides, from an eager run of the turn's steps
            rebases, rebase_bits = _adaptive_rebases(probe, dyn_params, dyn_batches,
                                                     COMPILED_DYN_STEPS)
        del probe
        run = _mode_turns(tag, lambda jit, st=stack: _compiled_dyn_stack(
                              spec_cls, cfg_cls, st, jit, COMPILED_DYN_STEPS)[0],
                          lambda tr: tr.init(dyn_params), dyn_batches, COMPILED_DYN_STEPS,
                          names, dyn_copy, dyn_start, COMPILED_PROFILED_STEPS[0],
                          want_programs=programs)
        out[tag] = _compiled_checks(tag, run, want, gate_memory=False, programs=programs)
        out[tag]["programs"] = programs
        if adaptive:
            # some rounds re-base and some do not, and the turns billed the
            # same rounds at full precision (every later turn's metrics are
            # the first eager turn's bit for bit)
            if not 0 < rebases < COMPILED_DYN_STEPS or not torch.equal(
                    rebase_bits, run["metrics"]["wire_bits"]):
                raise AssertionError(f"[compiled] {tag}: {rebases} of {COMPILED_DYN_STEPS} "
                                     f"rounds re-based, or the turn's wire_bits differ")
            out[tag]["rebase_rounds"] = rebases
            log(f"[compiled] {tag}: {rebases} of {COMPILED_DYN_STEPS} rounds re-based")
    log(f"[compiled] fig9/fig11 stacks in {time.perf_counter() - t_dyn:.1f} s")
    model = _serve_model(LM_ARCH)
    cfg = model.cfg
    single = model.init(torch.Generator("cuda").manual_seed(0))
    lm_start = {n: t.cpu() for n, t in single.items()}
    lm_dyn = "qwen2-0.5b dropout0.2 int8-kernel-ef-B4"
    for tag, nodes, graph, optimizer, compress in (
            ("qwen2-0.5b", LM_NODES, "ring", None, "none"),
            ("qwen2-0.5b nesterov int8-kernel-ef", COMPILED_LM_UNFUSED_NODES,
             "ring" if COMPILED_LM_UNFUSED_NODES > 2 else "complete",
             lambda: momentum(0.01, beta=0.9, nesterov=True),
             cfg_cls(kind="int8", use_kernel=True)),
            (lm_dyn, COMPILED_LM_DYN_NODES, "ring" if COMPILED_LM_DYN_NODES > 2 else "complete",
             None, "dynamic")):
        steps = COMPILED_LM_DYN_STEPS if tag == lm_dyn else COMPILED_LM_STEPS
        toks = torch.from_numpy(_lm_tokens(nodes, steps + COMPILED_PROFILED_STEPS[1],
                                           cfg.vocab)).cuda()

        def lm_build(jit, nodes=nodes, graph=graph, optimizer=optimizer, compress=compress):
            mixer = None
            if compress == "dynamic":  # SGD over the EF gossip under dropout, re-based every 4
                from repro_torch.dynamics import DropoutSchedule, DynamicGossipMixer
                from repro_torch.graphs import build_graph, metropolis_weights

                w = metropolis_weights(build_graph(graph, nodes))
                mixer = DynamicGossipMixer(DropoutSchedule(w, FIG9_DROP, seed=0, device="cuda"),
                                           quantized=cfg_cls(kind="int8", use_kernel=True),
                                           ef_rebase_every=REBASE_EVERY)
                compress = mixer.compression
            return spec_cls(num_nodes=nodes, graph=graph, lr=0.01, grad_clip=1.0,
                            compress=compress, jit=jit).build(
                make_lm_loss(model), optimizer=optimizer() if optimizer else None, mixer=mixer)

        fused = compress == "none"
        want = _lm_counts(nodes, steps, cfg.n_layers, len(single), folded=_folded(cfg))
        groups = -(-len(single) // 16)
        programs = 1
        if fused:
            want["uniforms_grouped"] = 0
            names = list(LM_PAIR) + ["gossip_update_stacked_grouped"]
        elif tag == lm_dyn:
            # per round: the coins and the noise, B.4 once, B.5 per matching of a
            # delta round; two branches
            from repro_torch.graphs import build_graph, metropolis_weights
            from repro_torch.graphs.mixing import permutation_decomposition

            del want["gossip_update_stacked_grouped"]
            delta = sum(1 for r in range(steps) if r % REBASE_EVERY != REBASE_EVERY - 1)
            m = permutation_decomposition(metropolis_weights(build_graph(graph, nodes))).num_rounds
            want.update(uniforms_grouped=steps * (1 + groups),
                        masked_quantize_blockwise_grouped=steps * groups,
                        masked_dequant_accumulate_grouped_=m * delta * groups)
            names = list(LM_PAIR) + ["uniforms_grouped", "masked_quantize_blockwise_grouped",
                                     "masked_dequant_accumulate_grouped_"]
            programs = 2
        else:
            del want["gossip_update_stacked_grouped"]
            want.update(uniforms_grouped=steps * groups,
                        quantize_blockwise_grouped=steps * groups)
            names = list(LM_PAIR) + ["uniforms_grouped", "quantize_blockwise_grouped"]
        run = _mode_turns(tag, lm_build, lambda tr: tr.init(single), (toks,), steps,
                          names, 4 * nodes * model.num_params(), lm_start,
                          COMPILED_PROFILED_STEPS[1], want_programs=programs)
        out[tag] = _compiled_checks(tag, run, want, gate_memory=True, programs=programs)
        del run, toks
        gc.collect()
        torch.cuda.empty_cache()
    for tag, rec in out.items():
        if all(rec["bitwise"]):
            continue
        equal = [r["bitwise_vs_first_eager"] for r in rec["turns"]]
        if tag != "qwen2-0.5b":
            raise AssertionError(f"[compiled] {tag}: a turn is not bit-equal to the first "
                                 f"eager turn: {equal}; differ {[r['differ'] for r in rec['turns']]}")
        # the fused qwen2 turns only: held to the train-parity rule, the cause
        # named: the leaves and metrics whose bits differ from the first eager
        # turn's
        differ = [(r["mode"], r["differ"]) for r in rec["turns"][1:]]
        rules = [r["update_rule"] for r in rec["turns"] if r["update_rule"]]
        log(f"[compiled] {tag}: not bit-equal to the first eager turn, held to the "
            f"train-parity rule; the bits differ in (turn, leaves and metrics) {differ}; "
            f"rule {rules}")
        if any(r["entries_outside"] for r in rules) or any(
                p for _, d in differ for p in d["carry"] if not p.startswith("params/")):
            raise AssertionError(f"[compiled] {tag}: a turn is neither bit-equal to the "
                                 f"first eager turn {equal} nor within the train-parity "
                                 f"rule {rules}")
    del fm, single
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[compiled] phase in {out['phase_s']:.1f} s: " + json.dumps(
        {tag: dict(bitwise=rec["bitwise"], peak_copies=(rec["peak_copies_eager"],
                                                        rec["peak_copies_captured"]),
                   ms_per_step={r["mode"]: r["ms_per_step"] for r in rec["turns"][:2]})
         for tag, rec in out.items() if tag != "phase_s"}))
    return out


def phase_train_lm(seq: int, nodes: int, steps: int, profile: bool) -> dict:
    """qwen2-0.5b at full width and depth through the training CLI
    (``python -m repro_torch.launch.train --arch qwen2_0_5b``, train_lm's
    defaults otherwise: the captured step), every launch counted; the first
    batch's loss before and after the run; the steady ms per step;
    optionally one profiled step.  The run is under :func:`tma_audit`,
    which sees each B.6 call of the eager warm-up step and of the capture
    (a replay calls no wrapper)."""
    import numpy as np
    import torch

    from repro_torch.launch import train

    argv = ["--arch", LM_ARCH, "--steps", str(steps), "--seq-len", str(seq), "--nodes",
            str(nodes), "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    box = []
    audit = tma_audit(lambda: box.append(train.main(argv)))
    trainer, state, history = box.pop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    model = _serve_model(LM_ARCH)
    cfg = model.cfg
    first = torch.from_numpy(_lm_tokens(nodes, 1, cfg.vocab, seq)[0])
    # from the second step on; the CLI's first step logs the first batch's loss
    rec = _lm_run_record(f"train-lm S {seq} K {nodes}", trainer, state, model, nodes, seq,
                         history, np.diff([r["wall_s"] for r in history])[1:], counts,
                         LM_PAIR, first, history[0]["loss_mean"])
    rec["wall_s"] = wall
    rec["step"] = "captured" if trainer.captured else f"eager ({trainer.capture_declined})"
    if abs(rec["loss_first_step"] - rec["ln_vocab"]) > 1.5:
        raise AssertionError(f"[train-lm] a random model's loss should be near ln V: {rec}")
    if not trainer.captured or trainer._run._cache_size() != 1:
        raise AssertionError(f"[train-lm] the CLI's step is not one captured program: {rec}")
    batch = (first.cuda(),)
    box = [state]
    del state
    # each B.6 call's views checked (the model's own layouts): one step's
    # calls (the node axis: one per layer) in the warm-up and in the capture
    per_run = 2 * cfg.n_layers
    rec["tma_audit"] = audit
    if audit != {"fwd": per_run, "bwd": per_run}:
        raise AssertionError(f"[train-lm] the TMA audit saw {audit} B.6 calls, not {per_run} "
                             f"of each (the warm-up step and the capture)")
    if profile:
        rec["profile"], prof = _lm_step_profile(trainer, box, batch, LM_PAIR)
        # the backward's launches in the step, against the bwd-kernel phase's
        # warm and cold calls at the same shape
        mma = sorted(launch_us(prof, "bwd_mma_kernel"))
        rec["profile"].update(bwd_mma_us=dict(launches=len(mma), min=mma[0],
                                              median=mma[len(mma) // 2], max=mma[-1]),
                              bwd_reduce_us_mean=float(np.mean(
                                  launch_us(prof, "bwd_reduce_kernel"))))
        log("[train-lm] profile of one step: " + json.dumps(rec["profile"]))
    del box
    log("[train-lm] " + json.dumps({k: v for k, v in rec.items() if k != "profile"}))
    del trainer
    torch.cuda.empty_cache()
    return rec


def _card_vs_cpu(tag: str, spec_cls, arch: str, cut: tuple, pair, update_rel: float,
                 ulps: int = 0, smoke: bool = False, **fields) -> tuple[dict, object, dict, object]:
    """``arch`` at full width (``smoke``: its smoke config; other config
    ``fields`` replaced) cut to ``cut`` = (layers, nodes, steps; layers
    None keeps the config's) on
    train_lm's stack (ring, lr 0.01, clip 1, batch 2, seq 64): the same
    seeded weights and tokens on the card (the layers' kernel ``pair`` and
    grouped B.1, launches exact) and on the CPU (plain versions, no launch).
    Held: per-step losses and every final leaf within TRAIN_PARITY_REL of
    its largest |value|; every entry's update within ``update_rel`` of the
    largest |update| of any leaf or, where ``ulps`` is set, within ``ulps``
    float32 ulps of the entry's own value (the two runs round each step's
    theta + update apart; an update small beside its weight moves the
    weight by few ulps).  A stub frontend's steps carry train_lm's
    embeddings.  Returns the record, the model, the initial params and the
    tokens."""
    import torch

    from repro_torch.models import make_lm_loss

    layers, nodes, steps = cut
    model = _serve_model(arch, layers, smoke, **fields)
    layers = model.cfg.n_layers
    params = model.init(torch.Generator().manual_seed(0))
    toks = _lm_tokens(nodes, steps, model.cfg.vocab)
    emb = _lm_embeddings(model.cfg, nodes, steps)
    batches = (toks,) if emb is None else (toks, emb)
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = spec_cls(num_nodes=nodes, graph="ring", lr=0.01, grad_clip=1.0,
                           device=device).build(make_lm_loss(model))
        reset_counts()
        t0 = time.perf_counter()
        state, ms = trainer.run(trainer.init(params), batches)
        # both runs' parameters end up on the card (a copy of the card's
        # own), where the comparison below runs
        runs[device] = ({n: t.clone() if device == "cuda" else t
                         for n, t in state.params.items()}, ms["loss_mean"].cpu(),
                        time.perf_counter() - t0)
        counts = kernel_counts()
        if device == "cuda":
            check_counts(tag, counts, _lm_counts(nodes, steps, _pair_layers(model.cfg, pair),
                                                 len(state.params), pair,
                                                 _folded(model.cfg, pair)))
            launches = {n: c[0] for n, c in counts.items() if c[0]}
        elif sum(c[0] for c in counts.values()) or not sum(c[1] for c in counts.values()):
            raise AssertionError(f"[{tag}] the CPU run launched a kernel: {counts}")
        del state, trainer
    (p_g, l_g, s_g), (p_c, l_c, s_c) = runs["cuda"], runs["cpu"]
    # the comparison runs on the card: elementwise operations and maxima,
    # so the numbers are the host's, without the host's passes over the
    # node-stacked copies (several GB at full width)
    t_cmp = time.perf_counter()
    p_c = {n: t.to("cuda") for n, t in p_c.items()}
    start = {n: t.to("cuda") for n, t in params.items()}
    upd_g, upd_c = ({n: p[n] - start[n].unsqueeze(0) for n in p_c} for p in (p_g, p_c))
    largest = max(float(u.abs().max()) for u in upd_c.values())
    own = {n: _rel_err(upd_g[n], upd_c[n]) for n in p_c}
    worst = max(own, key=own.get)
    over, by_ulp, worst_ulps = 0, 0, 0.0
    for n in p_c:
        diff = (p_g[n] - p_c[n]).abs()
        beyond = diff > update_rel * largest
        if ulps and bool(beyond.any()):
            theta = p_c[n].abs()
            in_ulps = diff[beyond] / (torch.nextafter(
                theta, torch.tensor(math.inf, device=theta.device)) - theta)[beyond]
            worst_ulps = max(worst_ulps, float(in_ulps.max()))
            by_ulp += int((in_ulps <= ulps).sum())
            beyond[beyond.clone()] = in_ulps > ulps
        over += int(beyond.sum())
    rec = dict(arch=model.cfg.name, n_layers=layers, nodes=nodes, steps=steps,
               loss_rel_err=float(((l_g - l_c).abs() / l_c.abs()).max()),
               leaf_rel_err=max(_rel_err(p_g[n], p_c[n]) for n in p_c),
               update_rel_err=max(float((upd_g[n] - upd_c[n]).abs().max()) for n in p_c)
               / largest, largest_update=largest,
               worst_leaf_update_rel_err=(worst, own[worst]),
               update_rtol=update_rel, entries_within_ulps=by_ulp,
               worst_ulps_beyond_rtol=worst_ulps, entries_outside=over,
               losses_card=l_g.tolist(), losses_cpu=l_c.tolist(), card_s=s_g, cpu_s=s_c,
               launches=launches)
    del p_g, p_c, start, upd_g, upd_c
    rec["compare_s"] = time.perf_counter() - t_cmp
    log(f"[{tag}] card vs CPU: " + json.dumps(rec))
    if not (rec["loss_rel_err"] <= TRAIN_PARITY_REL and rec["leaf_rel_err"] <= TRAIN_PARITY_REL
            and over == 0):
        raise AssertionError(f"[{tag}] card vs CPU outside tolerance: {rec}")
    return rec, model, params, toks


def phase_train_parity(spec_cls) -> dict:
    """qwen2-0.5b cut to 2 layers at full width, K = 4, 3 steps of
    train_lm's stack, card vs CPU (_card_vs_cpu; updates within UPDATE_REL
    of the largest update).  Then, on the card, one fused step against the
    unfused step (the optimizer and the mixer called directly) from the same
    state."""
    import torch

    from repro_torch.models import make_lm_loss
    from repro_torch.optim import Optimizer, sgd

    rec, model, params, toks = _card_vs_cpu("train-parity", spec_cls, LM_ARCH, LM_PARITY,
                                            LM_PAIR, UPDATE_REL)
    nodes = LM_PARITY[1]

    def trainer_on(optimizer):
        spec = spec_cls(num_nodes=nodes, graph="ring", lr=0.01, grad_clip=1.0, device="cuda")
        return spec.build(make_lm_loss(model), optimizer=optimizer)

    # fused (B.1) against unfused from the same state, on the card
    opt = sgd(0.01)
    fused, unfused = trainer_on(opt), trainer_on(Optimizer(opt.init, opt.update))
    batch = (torch.from_numpy(toks[0]),)
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


RWKV_ARCH = "rwkv6_7b"
RWKV_TRAIN = (2, 4, 10)     # layers, nodes, steps: rwkv6-7b at full width on one card
RWKV_PARITY = (1, 2, 5)     # layers, nodes, steps: card vs CPU
RWKV_UPDATE_REL = 1.5e-4  # card vs CPU, relative to the largest update (ROADMAP §C) ...
UPDATE_ULPS = 2           # ... or within 2 float32 ulps of the entry's own value
WKV_BWD_REL = 1e-4        # B.7's backward vs the plain version and autograd, relative to max
RWKV_PAIR = ("wkv6_scan", "wkv6_bwd")  # an rwkv layer's kernels in training
# B.7 forward and backward: tag, B, H, T, hd, decay, a given state (and the
# final state's cotangent); the first is rwkv6-7b's training shape
WKV6_TRAIN_CASES = (
    ("rwkv6-7b train", 2, 64, 64, 64, "random", False),
    ("hd 16", 2, 256, 64, 16, "random", False),
    ("w = 1e-6, given state, T = 19", 2, 64, 19, 64, "1e-6", True),
    ("init decay, given state, hd 16, T = 37", 2, 8, 37, 16, "init", True),
)


# B.7 backward's device us per WKV6_TRAIN_CASES row in its first design
# (one CTA per (b, h)), timed by tests/wkv6_bwd_variants.py --root <that
# tree> at these shapes on an H100 80GB HBM3 at 700 W (chip_smoke.py's own
# run of that design read 113.87 and 62.77 for the first two)
PARENT_BWD_US = {"rwkv6-7b train": 109.80, "hd 16": 62.49,
                 "w = 1e-6, given state, T = 19": 35.71,
                 "init decay, given state, hd 16, T = 37": 31.85}


def wkv6_bwd_bound(b, h, t, hd, given_state: bool = False) -> tuple[float, str]:
    """Least time of one B.7 backward call: r, k, v, w and dy read, dr, dk,
    dv and dw written once, u read and du written once (and a given state,
    the final state's cotangent and ds0), against 14 float operations per
    (i, j, t): the state recomputed once (3), S dy (2), G's update (3), G v,
    G^T k and G (.) S (2 each); and 16 per (i, t) for the u terms, which
    the function needs per row only: v.dy (2), sum r u k (3), u k (v.dy) into
    dr, u r (v.dy) into dk and r k (v.dy) into du (3 each), (sum r u k) dy
    into dv (2); at the float32 peak."""
    n_bytes = 4 * (9 * b * h * t * hd + 2 * h * hd + 3 * given_state * b * h * hd * hd)
    ops = b * h * t * hd * (14 * hd + 16)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _wkv6_bwd_case(gen, tag, b, h, t, hd, decay, given) -> dict:
    """B.7's backward at one shape on the model's layout: two calls equal
    bit for bit, each gradient within WKV_BWD_REL of its largest |value|
    against the plain version (an explicit reverse loop) and against
    autograd of the forward's plain version, on the card; call, device and
    plain times and the bound."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel as wk
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref, wkv6_ref

    def view():  # the model's (B, T, H, hd) projections
        return torch.randn((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)

    r, k, v, w, dy = view(), view(), view(), view(), view()
    if decay == "random":
        w.uniform_(0.0, 1.0, generator=gen)
    elif decay == "init":
        w.fill_(math.exp(-math.exp(-6.0)))
    else:
        w.fill_(1e-6)
    u = 0.5 * torch.randn((h, hd), generator=gen, device="cuda")
    s0, ds = ((torch.randn((b, h, hd, hd), generator=gen, device="cuda") for _ in range(2))
              if given else (None, None))
    args = (r, k, v, w, u, dy, s0, ds)
    got, again = wk.wkv6_bwd(*args), wk.wkv6_bwd(*args)
    plain = wkv6_bwd_ref(*args)
    leaves = [x.detach().clone().requires_grad_() for x in (r, k, v, w, u)]
    state = s0.clone().requires_grad_() if given else None
    y, s = wkv6_ref(*leaves, state)
    loss = (y * dy).sum() + ((s * ds).sum() if given else 0.0)
    auto = torch.autograd.grad(loss, leaves + ([state] if given else []))
    torch.cuda.synchronize()
    names = ("dr", "dk", "dv", "dw", "du", "ds0")[:len(auto)]
    if not all(torch.equal(x, z) for x, z in zip(got[:len(auto)], again[:len(auto)])):
        raise AssertionError(f"[train-rwkv] B.7 backward {tag}: two calls differ")
    rel = {n: max(_rel_err(g, p), _rel_err(g, a))
           for n, g, p, a in zip(names, got, plain, auto)}
    abs_err = max(float((g - p).abs().max()) for g, p in zip(got, plain[:len(auto)]))
    if max(rel.values()) > WKV_BWD_REL:
        raise AssertionError(f"[train-rwkv] B.7 backward {tag}: {rel} (relative to max) > "
                             f"{WKV_BWD_REL}")

    def call():
        wk.wkv6_bwd(*args)

    bound, by = wkv6_bwd_bound(b, h, t, hd, given)
    row = dict(case=tag, b=b, h=h, t=t, hd=hd, decay=decay, given_state=given, rel_err=rel,
               max_abs_err=abs_err, bitwise_repeat=True, ms=cuda_ms(call, iters=50),
               **device_time(call, 20, KERNELS["wkv6_bwd"][2]),
               plain_ms=cuda_ms(lambda: wkv6_bwd_ref(*args), iters=3, warmup=1),
               bound_ms=bound, bound_by=by, library_ms=None,
               parent_device_us=PARENT_BWD_US[tag])
    parent = row["parent_device_us"]
    log(f"[train-rwkv] B.7 backward {tag}: device {1e3 * row['device_ms']:.2f} us "
        f"[{parent:.2f} before the redesign], bound {1e3 * bound:.3f} us ({by}): "
        + json.dumps(row))
    return row


def _full_width_train(tag: str, spec_cls, model, nodes: int, steps: int, pair,
                      seq: int = LM_SEQ, check=None) -> dict:
    """``model`` (full width, cut in depth) at K = ``nodes`` through
    TrainerSpec -> DecentralizedTrainer (train_lm's stack: ring, lr 0.01,
    clip 1, batch 2, ``seq`` tokens, and a stub frontend's embeddings),
    ``steps`` steps: _lm_run_record's checks, ``check(trainer, state,
    first batch)``'s record, and one profiled step's busy share."""
    import numpy as np
    import torch

    from repro_torch.models import make_lm_loss

    trainer = spec_cls(num_nodes=nodes, graph="ring", lr=0.01, grad_clip=1.0).build(
        make_lm_loss(model))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init(model.init(torch.Generator("cuda").manual_seed(0)))
    toks = _lm_tokens(nodes, steps, model.cfg.vocab, seq)
    emb = _lm_embeddings(model.cfg, nodes, steps)
    batches = [(toks[t],) if emb is None else (toks[t], emb[t]) for t in range(steps)]
    first = tuple(torch.from_numpy(b) for b in batches[0])
    loss_before = float(np.mean(_node_losses(trainer, state, first)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_counts()
    walls, history = [], []
    for t in range(steps):
        t1 = time.perf_counter()
        state, m = trainer.step(state, batches[t])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        history.append(dict(step=t, **{k: float(v) for k, v in m.items()}))
    rec = _lm_run_record(tag, trainer, state, model, nodes, seq, history, walls[1:],
                         kernel_counts(), pair, first, loss_before)
    rec.update(init_s=init_s, ms_per_step_first=1e3 * walls[0])
    if check is not None:
        rec.update(check(trainer, state, first))
    box = [state]
    del state
    rec["profile"], _ = _lm_step_profile(trainer, box, tuple(b.cuda() for b in first), pair)
    log(f"[{tag}] " + json.dumps(rec))
    del box, trainer
    torch.cuda.empty_cache()
    return rec


def _rwkv_full_width(spec_cls) -> dict:
    """rwkv6-7b at full width cut to RWKV_TRAIN's layers and nodes
    (_full_width_train)."""
    layers, nodes, steps = RWKV_TRAIN
    return _full_width_train("train-rwkv full width", spec_cls,
                             _serve_model(RWKV_ARCH, layers), nodes, steps, RWKV_PAIR)


def phase_train_rwkv(spec_cls) -> dict:
    """A.15 on the card.  B.7's forward and its backward kernel at
    rwkv6-7b's training shape and the other WKV6_TRAIN_CASES against their
    plain versions (the forward at SERVE_TOL, the backward at WKV_BWD_REL,
    also against autograd of the plain forward; two backward calls equal bit
    for bit), timed.  Then the training CLI at the smoke config (``train
    --arch rwkv6_7b --smoke``), rwkv6-7b at full width cut to 2 layers at
    K = 4 (_rwkv_full_width) and cut to 1 layer at K = 2 against the CPU
    (_card_vs_cpu); every launch counted, no plain call."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7007)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {"wkv6_scan": dict(max_abs_err=0.0, rows=[]), "wkv6_bwd": dict(max_abs_err=0.0, rows=[])}
    for tag, b, h, t, hd, decay, given in WKV6_TRAIN_CASES:
        _add_row(out["wkv6_scan"], _wkv6_case("train-rwkv", randn, gen, tag, b, h, t, hd,
                                               decay, given, "model"))
        _add_row(out["wkv6_bwd"], _wkv6_bwd_case(gen, tag, b, h, t, hd, decay, given))

    reset_counts()
    trainer, state, history = train.main(["--arch", RWKV_ARCH, "--smoke", "--steps", "3",
                                          "--log-every", "1"])
    torch.cuda.synchronize()
    smoke_layers = get_arch(RWKV_ARCH, smoke=True).n_layers
    counts = kernel_counts()
    check_counts("train-rwkv smoke CLI", counts,
                 _lm_counts(trainer.num_nodes, 3, smoke_layers, len(state.params), RWKV_PAIR))
    if not all(math.isfinite(r["loss_mean"]) for r in history):
        raise AssertionError(f"[train-rwkv] smoke CLI: {history}")
    out["smoke_cli"] = dict(nodes=trainer.num_nodes, losses=[r["loss_mean"] for r in history],
                            launches={n: c[0] for n, c in counts.items() if c[0]})
    log("[train-rwkv] train --arch rwkv6_7b --smoke: " + json.dumps(out["smoke_cli"]))
    del trainer, state
    out["full_width"] = _rwkv_full_width(spec_cls)
    out["parity"] = _card_vs_cpu("train-rwkv parity", spec_cls, RWKV_ARCH, RWKV_PARITY,
                                 RWKV_PAIR, RWKV_UPDATE_REL, UPDATE_ULPS)[0]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train-rwkv] phase in {out['phase_s']:.1f} s")
    return out


def _example(name: str):
    """examples/<name>.py as a module (its main() is not run on import)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> dict:
    """A.16 on the card: the port's four examples through their ``main(argv)``
    at their defaults with cut steps: the quickstart (100 steps) and the
    fmnist reproduction (T = 100, both runs) through grouped B.1 once per
    step; the LM example (5 steps: K = 8, batch 4, seq 128, head dim 32)
    through B.6 forward and backward on every attention layer of every
    node, then ``--full-width`` (qwen2-0.5b, 2 steps; peak memory); the
    serving example (rwkv6 smoke) through B.7 at its prefill and every
    admission.  Exact launches, no plain call, wall time each."""
    import torch

    from repro_torch.configs import get_arch

    out = {}

    def run(tag, fn, want):
        gc.collect()  # earlier phases' cyclic garbage would count in the peak
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
        reset_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        check_counts(f"examples {tag}", counts, want(result) if callable(want) else want)
        out[tag] = dict(wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                        base_memory_gb=base,
                        launches={n: c[0] for n, c in counts.items() if c[0]})
        log(f"[examples] {tag}: " + json.dumps(out[tag]))
        return result

    quick = _example("torch_quickstart")
    hist = run("torch_quickstart --steps 100", lambda: quick.main(["--steps", "100"]),
               {"gossip_update_stacked_grouped": 100})
    fm = _example("torch_decentralized_fmnist")
    fm.T, fm.EVAL_EVERY = 100, 50
    dr, ds = run("torch_decentralized_fmnist (T = 100)", lambda: fm.main([]),
                 {"gossip_update_stacked_grouped": 200})
    for h in hist + dr + ds:
        if not 0.0 <= h["acc_worst_dist"] <= h["acc_avg"] <= 1.0:
            raise AssertionError(f"[examples] fmnist accuracies: {h}")
    lm = _example("torch_train_lm_drdsgd")
    for argv, steps in ((["--steps", "5"], 5), (["--full-width", "--steps", "2"], 2)):
        model = lm.model_for("--full-width" in argv)
        cfg = model.cfg
        history = run("torch_train_lm_drdsgd " + " ".join(argv), lambda: lm.main(argv),
                      _lm_counts(8, steps, cfg.n_layers, len(model.param_shapes()),
                                 folded=_folded(cfg)))
        if not all(math.isfinite(h["loss_mean"]) for h in history):
            raise AssertionError(f"[examples] LM losses: {history}")
        out["torch_train_lm_drdsgd " + " ".join(argv)].update(
            head_dim=cfg.d_model // cfg.n_heads, losses=[h["loss_mean"] for h in history])
    serve = _example("torch_serve_decode")
    cfg = get_arch("rwkv6_7b", smoke=True)

    def serve_want(result):
        want = _engine_launches(cfg, result["report"], False)
        # and the static batch's prefill: B.7 once per layer
        want["wkv6_scan"] = want.get("wkv6_scan", 0) + cfg.n_layers
        return want

    result = run("torch_serve_decode", lambda: serve.main([]), serve_want)
    if result["report"]["completed"] != 5 or result["tokens"].shape != (4, 24):
        raise AssertionError(f"[examples] serve_decode: {result['report']['completed']} "
                             f"completed, tokens {result['tokens'].shape}")
    return out


def _node_call_timing(params, grads, updated, w, scale, eta, names) -> dict:
    """Node 0's per-node update over every leaf of the fmnist MLP: one
    ``gossip_update_tree`` call (one launch) against the same update leaf by
    leaf through the one-leaf ``kernel.gossip_update`` (its neighbours'
    rows stacked first, a launch per leaf), in turns
    (one-leaf, tree, tree, one-leaf): call time (CUDA events) and device
    time (every device entry of a call, the profiler's median window); the
    plain version's call time (the leaves through ``gossip_update_ref`` on
    the card); the bound, the leaves' bytes and operations summed."""
    import torch

    from repro_torch.kernels.gossip_update import kernel as gk
    from repro_torch.kernels.gossip_update.ops import gossip_update_tree
    from repro_torch.kernels.gossip_update.ref import gossip_update_ref

    nbrs = [j for j in range(K) if j != 0 and float(w[0, j]) > 0]
    weights = torch.stack([w[0, 0]] + [w[0, j] for j in nbrs])
    theta = {n: params[n][0] for n in names}
    grad = {n: grads[n][0] for n in names}
    nbr_trees = [{n: updated[n][j] for n in names} for j in nbrs]

    def tree():
        gossip_update_tree(theta, grad, nbr_trees, weights, scale[0], eta=eta)

    def one_leaf():
        for n in names:
            gk.gossip_update(theta[n].reshape(-1), grad[n].reshape(-1),
                             torch.stack([t[n].reshape(-1) for t in nbr_trees]), weights,
                             scale[0], eta=eta)

    def plain():
        for n in names:
            gossip_update_ref(theta[n].reshape(-1), grad[n].reshape(-1),
                              torch.stack([t[n].reshape(-1) for t in nbr_trees]), weights,
                              scale[0], eta=eta)

    readings = {"one_leaf": [], "tree": []}
    for side in ("one_leaf", "tree", "tree", "one_leaf"):
        fn = tree if side == "tree" else one_leaf
        readings[side].append((cuda_ms(fn, iters=200, warmup=5), window_device_ms(fn, 50)))
    mean = {side: [sum(r[j] for r in rs) / len(rs) for j in (0, 1)]
            for side, rs in readings.items()}
    bounds = [gossip_bound(1, theta[n].numel(), len(nbrs)) for n in names]
    return dict(leaves=len(names), n=len(nbrs), ms=mean["tree"][0], device_ms=mean["tree"][1],
                one_leaf_ms=mean["one_leaf"][0], one_leaf_device_ms=mean["one_leaf"][1],
                plain_ms=cuda_ms(plain, iters=50, warmup=2),
                bound_ms=sum(b for b, _ in bounds),
                bound_by="bytes" if {by for _, by in bounds} == {"bytes"} else "operations",
                readings=readings)


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
    from repro_torch.kernels.gossip_update.ref import gossip_update_ref
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
    check_counts("b1-nodes", counts, {"gossip_update": K})  # one launch per node
    for i, row in enumerate(rows):  # each node bit-equal to the plain version, leaf by leaf
        nbrs = [j for j in range(K) if j != i and float(w[i, j]) > 0]
        weights = torch.stack([w[i, i]] + [w[i, j] for j in nbrs])
        for n in names:
            want = gossip_update_ref(state.params[n][i].reshape(-1), grads[n][i].reshape(-1),
                                     torch.stack([updated[n][j].reshape(-1) for j in nbrs]),
                                     weights, scale[i], eta=eta)
            if not torch.equal(row[n].reshape(-1), want):
                raise AssertionError(f"[b1-nodes] node {i} leaf {n}: the per-node kernel is "
                                     f"not its plain version (max abs err "
                                     f"{_max_diff(row[n].reshape(-1), want)})")
    node = _node_call_timing(state.params, grads, updated, w, scale, eta, names)
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
               bitwise_vs_plain=True, node_call=node,
               stacked_launches=stacked["gossip_update_stacked"][0],
               rel_err_vs_fused_step=err, one_leaf_equals_grouped=leaves_equal,
               grouped_rel_err_vs_fused_step=err_stacked)
    log("[b1-nodes] " + json.dumps(rec))
    if err > STACKED_REL or err_stacked > STACKED_REL:
        raise AssertionError(f"[b1-nodes] per-node or grouped B.1 vs the fused step: {rec}")
    if not leaves_equal:
        raise AssertionError("[b1-nodes] the one-leaf stacked calls are not the grouped call")
    return rec


# -- checkpoints (A.10) and the serving engine (A.12) --------------------------

CKPT_SAVE, CKPT_STEPS = 50, 100    # save at step 50 of a 100-step run
CKPT_LM = (2, 4)                   # qwen2-0.5b layers, nodes of the round-tripped LM state
ENGINE_ARCH = "qwen2_0_5b"
ENGINE_ARGS = ("--batch", "4", "--page-size", "8", "--rate", "2.0", "--horizon", "8")
ENGINE_CUT = 2                     # layers of the card-vs-CPU and the rwkv6/gemma2 runs


def _state_leaves(tree, prefix: str = "") -> dict:
    """Every tensor and host value of a train state (or its metrics), keyed
    by its path."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_state_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {f"{prefix}#len": len(tree)}
        for i, v in enumerate(tree):
            out.update(_state_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _same_bits(tag: str, got, want) -> int:
    """Every leaf of ``got`` equal to ``want``'s bit for bit (dtypes and
    host values too); returns the tensors compared."""
    import torch

    a, b = _state_leaves(got), _state_leaves(want)
    if sorted(a) != sorted(b):
        raise AssertionError(f"[{tag}] leaves differ: {sorted(set(a) ^ set(b))}")
    n = 0
    for name, x in b.items():
        y = a[name]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and y.dtype == x.dtype and torch.equal(y, x)):
                raise AssertionError(f"[{tag}] {name} differs")
            n += 1
        elif type(x) is not type(y) or x != y:
            raise AssertionError(f"[{tag}] {name}: {y!r} != {x!r}")
    return n


def _kept(state):
    """A copy of ``state``'s tensors (host values as they are): a captured
    trainer donates the state it returned to its next run, which writes
    over it, so a state compared after that run is kept as a copy."""
    import torch

    if isinstance(state, torch.Tensor):
        return state.clone()
    if hasattr(state, "_fields"):
        return type(state)(*(_kept(v) for v in state))
    if isinstance(state, dict):
        return {k: _kept(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_kept(v) for v in state)
    return state


def _ckpt_dir(name: str) -> Path:
    path = ROOT / "build" / "chip_smoke" / "ckpt" / name
    shutil.rmtree(path, ignore_errors=True)
    return path


def phase_ckpt(spec_cls, cfg_cls) -> dict:
    """A.10 on the card: three fmnist stacks of fig7's task (K = 8 ring) run
    CKPT_STEPS steps, saved at step CKPT_SAVE with save_train_state, restored with
    restore_train_state and continued: the dense wire through the fused
    B.1 step, the EF int8 gossip wire re-based every 4 under dropout 0.2
    (hat, hat_mix, ef_rounds) and the memoryless int8 gossip wire under
    stragglers 0.1.  The restored state equals the saved one and the resumed
    run the uninterrupted one, every leaf and every metric bit for bit.
    Then a qwen2-0.5b train state cut to 2 layers at K = 4 (one step of
    train_lm's stack, its final norm in bfloat16) round-trips bit for bit.
    Prints the seconds to save and restore and the file's bytes."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import restore_train_state, save_train_state
    from repro_torch.dynamics import (
        DropoutSchedule,
        DynamicGossipMixer,
        FaultConfig,
        StaticSchedule,
    )
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import make_classifier_loss, make_lm_loss, mlp_apply

    t_phase = time.perf_counter()
    batches, _, params = _fig_data("mlp", CKPT_STEPS, FIG7_FMNIST[0])
    first = tuple(b[:CKPT_SAVE] for b in batches)
    rest = tuple(b[CKPT_SAVE:] for b in batches)
    w = metropolis_weights(build_graph("ring", FIG_K))
    stacks = {
        "dense-none-fused": (lambda: None, "gossip_update_stacked_grouped"),
        f"gossip-dropout{DROP_P:g}-int8-kernel-ef-B{REBASE_EVERY}": (
            lambda: DynamicGossipMixer(DropoutSchedule(w, DROP_P, seed=0, device="cuda"),
                                       quantized=cfg_cls(kind="int8", use_kernel=True),
                                       ef_rebase_every=REBASE_EVERY),
            "masked_quantize_blockwise_grouped"),
        f"gossip-straggler{FIG9_FAULTS['straggler_p']:g}-int8-kernel-memoryless": (
            lambda: DynamicGossipMixer(
                StaticSchedule(w, device="cuda"),
                faults=FaultConfig(straggler_p=FIG9_FAULTS["straggler_p"], seed=0),
                quantized=cfg_cls(kind="int8", use_kernel=True, error_feedback=False)),
            "masked_quantize_blockwise_grouped"),
    }
    out = {}
    for name, (make_mixer, kernel) in stacks.items():
        mixer = make_mixer()
        spec = _fig_spec(spec_cls, mixer.compression if mixer is not None else "none",
                         FIG7_FMNIST)
        trainer = spec.build(make_classifier_loss(mlp_apply), mlp_apply, mixer=mixer)
        state, _ = trainer.run(trainer.init(params), first)
        path = _ckpt_dir(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_train_state(str(path), CKPT_SAVE, state)
        t_save = time.perf_counter() - t0
        restored, step = restore_train_state(str(path), device="cuda")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0 - t_save
        tensors = _same_bits(f"ckpt {name} restored", restored, state)
        reset_counts()
        want, want_ms = trainer.run(state, rest)
        want = _kept(want)  # the captured trainer's next run writes over it
        got, got_ms = trainer.run(restored, rest)
        counts = kernel_counts()
        if counts[kernel][0] == 0 or any(c[1] for c in counts.values()):
            raise AssertionError(f"[ckpt] {name}: {counts}")
        _same_bits(f"ckpt {name} resumed", got, want)
        _same_bits(f"ckpt {name} metrics", got_ms, want_ms)
        _finite(got_ms)
        comm = got.comm
        out[name] = dict(saved_at=step, steps=CKPT_STEPS, tensors=tensors,
                         bytes=json.loads((path / f"step_{CKPT_SAVE:08d}" /
                                           "manifest.json").read_text())["bytes"],
                         save_s=t_save, restore_s=t_restore, rounds=comm.rounds,
                         ef_rounds=comm.ef_rounds if comm.ef_rounds != () else None,
                         loss_last=float(got_ms["loss_mean"][-1]),
                         launches_resumed={n: c[0] for n, c in counts.items() if c[0]},
                         bitwise=True)
        log("[ckpt] " + json.dumps({"stack": name, **out[name]}))

    layers, nodes = CKPT_LM
    model = _serve_model(LM_ARCH, layers)
    trainer = spec_cls(num_nodes=nodes, graph="ring", lr=0.01, grad_clip=1.0,
                       device="cuda").build(make_lm_loss(model))
    state = trainer.init(model.init(torch.Generator(device="cuda").manual_seed(0)))
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab, (nodes, 2, LM_SEQ + 1))
    state, _ = trainer.step(state, (tokens,))
    norm = "final_norm/scale"
    state = state._replace(params={**state.params, norm: state.params[norm].to(torch.bfloat16)})
    path = _ckpt_dir("qwen2-2layers")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(str(path), 1, state)
    t_save = time.perf_counter() - t0
    restored, _ = restore_train_state(str(path), device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0 - t_save
    if restored.params[norm].dtype != torch.bfloat16:
        raise AssertionError("[ckpt] the bfloat16 leaf came back as "
                             f"{restored.params[norm].dtype}")
    out["qwen2-2layers"] = dict(
        arch=model.cfg.name, n_layers=layers, nodes=nodes, params=model.num_params(),
        tensors=_same_bits("ckpt qwen2", restored, state), bf16_leaf=norm,
        bytes=json.loads((path / "step_00000001" / "manifest.json").read_text())["bytes"],
        save_s=t_save, restore_s=t_restore, bitwise=True)
    log("[ckpt] " + json.dumps(out["qwen2-2layers"]))
    del state, restored, trainer
    shutil.rmtree(ROOT / "build" / "chip_smoke" / "ckpt", ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[ckpt] phase in {out['phase_s']:.1f} s")
    return out


def _attn_layers(cfg) -> tuple[int, int]:
    """(attn/swa layers, attn/swa entries of the head layers and the group
    pattern): B.2 launches once per attention layer and decode step, and
    once per entry and admission (every group's rows in one call)."""
    layers = sum(blk in ("attn", "swa") for blk, _ in cfg._full_pattern())
    entries = sum(blk in ("attn", "swa") for blk, _ in cfg.head_layers() + cfg.group_pattern())
    return layers, entries


def _engine_launches(cfg, report, quantized: bool) -> dict:
    """The kernels one engine run launches: B.6 (B.7) once per attn (rwkv)
    layer per admission with s0 > 1; B.2 (int8 pools) once per attention
    layer per decode step and once per attention entry per such admission."""
    decode_calls = report["decode"]["steady_steps"] + (report["completed"] > 0)
    prefills = sum(c.s0 > 1 for c in report["completions"])
    layers, entries = _attn_layers(cfg)
    rwkv = sum(blk == "rwkv" for blk, _ in cfg._full_pattern())
    want = {"flash_attention_fwd": layers * prefills, "wkv6_scan": rwkv * prefills}
    if quantized:
        want["quantize_blockwise_grouped"] = layers * decode_calls + entries * prefills
    return {k: v for k, v in want.items() if v}


def _logged_engine(model, params, quantized: bool, trace, max_len: int):
    """A steps-clock engine run (4 slots, 8-token pages) with each decode
    step's logits kept per request.  Returns (report, {rid: [logits row of
    each of its decode steps]})."""
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, params, max_batch=4, max_len=max_len, page_size=8,
                         quantized=quantized)
    rows: dict = {}
    step, decode = engine._step, model.paged_decode_step
    captured = []

    def logged():
        rids = {int(slot): engine._slot_meta[slot]["req"].rid
                for slot in engine._active_np.nonzero()[0]}
        out = step()
        logits = captured.pop()
        for slot, rid in rids.items():
            rows.setdefault(rid, []).append(logits[slot])
        return out

    def capture(*args, **kw):
        logits, cache = decode(*args, **kw)
        captured.append(logits.clone())
        return logits, cache

    engine._step = logged
    object.__setattr__(model, "paged_decode_step", capture)
    try:
        report = engine.run(trace, clock="steps")
    finally:
        object.__delattr__(model, "paged_decode_step")
    return report, rows


def _tokens_of(report) -> dict:
    return {c.rid: [int(t) for t in c.tokens] for c in report["completions"]}


def _near_tie_divergence(tag, rows_a, rows_b, toks_a, toks_b, tol=None) -> dict:
    """Per request, the decode steps of run b against run a's: equal tokens
    up to a first divergence, which must fall where a's top-2 logit margin
    is below ``tol`` (default: twice the largest |b - a| of that row, as
    both logits of the pair may move by that much).  Returns the largest
    row error relative to max |a| before any divergence, the steps
    compared and the divergences (rid, step, margin, bound)."""
    worst, compared, diverged = 0.0, 0, []
    for rid, ra in rows_a.items():
        rb = rows_b[rid]
        for t, (a, b) in enumerate(zip(ra, rb)):
            b = b.to(a.device)
            err = float((b - a).abs().max())
            top = a.topk(2).values
            margin = float(top[0] - top[1])
            compared += 1
            if toks_a[rid][t] != toks_b[rid][t]:
                bound = 2 * err if tol is None else tol
                if not margin < bound:
                    raise AssertionError(f"[{tag}] rid {rid} step {t}: tokens "
                                         f"{toks_a[rid][t]} vs {toks_b[rid][t]} with a top-2 "
                                         f"margin of {margin} >= {bound}")
                diverged.append((rid, t, margin, bound))
                break
            worst = max(worst, err / float(a.abs().max()))
    return dict(rel_err=worst, steps_compared=compared, divergences=diverged)


def _engine_vs_greedy(tag, model, params, report, trace) -> int:
    """Each request's engine tokens against its isolated greedy generation
    (prefill of the whole prompt, then decode), equal up to a near tie
    (SERVE_REL of the prompt's largest logit).  Returns the tokens that
    agreed before any such tie."""
    import torch

    prompts = {r.rid: r.prompt for r in trace}
    device = next(iter(params.values())).device
    same = 0
    with torch.inference_mode():
        for c in report["completions"]:
            prompt = torch.from_numpy(prompts[c.rid][None].astype("int64")).to(device)
            first, _, toks, gaps = _generate(model, params, prompt, c.max_new, True)
            got = torch.from_numpy(c.tokens[None].astype("int64"))
            same += _same_tokens(tag, got, toks.cpu(), gaps.cpu(),
                                 SERVE_REL * float(first.abs().max()))
    return same


def _kv_write_case(tag, randn, n: int, d: int, timed: bool) -> dict:
    """B.2 at a KV write: a layer's k and v rows, (n, d) each, in one
    grouped launch with u = 0.5, qmax 127 and blocks of up to 128 (the
    pool's layout), through the path's wrapper (``quantize_kv_rows``), bit-equal to
    the plain version; timed as call, device and plain where ``timed``."""
    import torch

    from repro_torch.kernels.quant_gossip.kernel import _pick_block
    from repro_torch.kernels.quant_gossip.ref import quantize_blockwise_grouped_ref
    from repro_torch.models.attention import KV_SCALE_BLOCK, quantize_kv_rows

    rows = [randn(n, d) * (1.0 + 10.0 * torch.rand(n, 1, device="cuda")) for _ in range(2)]
    half = [torch.full((n, d), 0.5, device="cuda")] * 2

    def plain():
        return quantize_blockwise_grouped_ref(rows, half, qmax=127.0, block_d=KV_SCALE_BLOCK)

    got, want = quantize_kv_rows(rows), plain()
    torch.cuda.synchronize()
    for (q, s), (q_p, s_p) in zip(got, want):
        if not (torch.equal(q, q_p) and torch.equal(s, s_p)):
            raise AssertionError(f"[engine-kernel] B.2 {tag}: kernel != plain")
    n_blk = d // _pick_block(d, KV_SCALE_BLOCK)
    row = dict(case=tag, rows=n, d=d, leaves=2, blocks_per_row=n_blk, max_abs_err=0.0,
               library_ms=None)
    if timed:
        bound, by = kernel_bound("quantize_blockwise_grouped", 2 * n, d, n_blk)
        row.update(ms=cuda_ms(lambda: quantize_kv_rows(rows), iters=200),
                   **device_time(lambda: quantize_kv_rows(rows), 50,
                                 KERNELS["quantize_blockwise_grouped"][2]),
                   plain_ms=cuda_ms(plain, iters=50, warmup=5), bound_ms=bound, bound_by=by)
    log("[engine-kernel] " + json.dumps(row))
    return row


def _engine_kernels() -> dict:
    """The kernels at the engine's shapes: B.2 at the KV writes (decode: 1
    to 8 rows of qwen2-0.5b's D = 128 per leaf, the 16-CTA cluster packing
    at its smallest; admission: 24 layers of a 6- and a 20-token prompt's
    rows in one call; gemma2's D = 2048, 16 blocks per row; jamba smoke's D
    = 32, one 32-wide block per row), B.6 at the admission prefills (batch
    1, S = 5 and 19: one ragged tile; gemma2's hd 128 with softcap 50;
    jamba smoke's hd 16) and B.7 at rwkv6-7b's (batch 1, T = 5 and 19), each
    against its plain version; the decode and the longer admission timed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2112)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {"quantize_blockwise_grouped": dict(max_abs_err=0.0, rows=[]),
           "flash_attention_fwd": dict(max_abs_err=0.0, rows=[]),
           "wkv6_scan": dict(max_abs_err=0.0, rows=[])}
    kv = [(f"decode, batch {n}", n, 128, n == 4) for n in range(1, 9)]
    kv += [("admission, chat: 24 layers x 5 rows", 120, 128, False),
           ("admission, doc: 24 layers x 19 rows", 456, 128, True),
           ("gemma2 decode, batch 4, D 2048", 4, 2048, False),
           ("jamba smoke decode, batch 4, D 32", 4, 32, False),
           ("jamba smoke admission: 2 layers x 19 rows", 38, 32, False)]
    for tag, n, d, timed in kv:
        _add_row(out["quantize_blockwise_grouped"], _kv_write_case(tag, randn, n, d, timed))
    for case in (("admission, chat: S 5", 1, 14, 2, 5, 64, None, None),
                 ("admission, doc: S 19", 1, 14, 2, 19, 64, None, None),
                 ("gemma2 admission: S 19, hd 128, softcap 50", 1, 32, 16, 19, 128, None, 50.0),
                 ("jamba smoke admission: S 19, hd 16", 1, 8, 2, 19, 16, None, None)):
        _add_row(out["flash_attention_fwd"],
                 _flash_case("engine-kernel", randn, *case, require_tma=False))
    for t in (5, 19):
        _add_row(out["wkv6_scan"], _wkv6_case("engine-kernel", randn, gen,
                                               f"rwkv6-7b admission: T {t}", 1, 64, t, 64,
                                               "random", False, "model"))
    return out


def phase_engine() -> dict:
    """A.12 on the card.  The main path: the serving CLI's engine (``serve
    --engine``, the reference's example: qwen2-0.5b at full width and
    depth, 4 slots, 8-token pages, SMOKE_CLASSES at 2 requests per second
    for 8 s, the wall clock), float32 and then ``--int8-kv``, its launches
    counted exactly (_engine_launches) with no plain call; decode ms per
    step, TTFT and per-token percentiles and peak memory.  Then the same
    trace on the steps clock: float32 engine tokens equal each request's
    isolated greedy tokens up to a near tie, and int8 equal to float32 up to
    a first divergence that falls on a top-2 margin below twice the int8
    row's logit error.  qwen2-0.5b cut to 2 layers on the card against the
    CPU (float32 logits within SERVE_PARITY_REL of their largest value).
    rwkv6-7b (B.7 at admission) and gemma2 (swa and attn pools, softcap; int8
    too) cut to 2 layers through the engine, launches counted, tokens
    against isolated greedy."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import SMOKE_CLASSES, poisson_trace

    t_phase = time.perf_counter()
    out = {"kernels": _engine_kernels()}
    max_len = max(c.prompt_len + c.gen_max for c in SMOKE_CLASSES)

    def trace(vocab):
        return poisson_trace(SMOKE_CLASSES, rate=2.0, horizon=8.0, vocab=vocab, seed=0)

    cfg = get_arch(ENGINE_ARCH)
    log_dir = _obs_dir("engine")
    for label, flags in (("f32", ("--log-dir", str(log_dir))), ("int8", ("--int8-kv",))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        report = serve_cli.main(["--arch", ENGINE_ARCH, "--engine", *ENGINE_ARGS, *flags])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = kernel_counts()
        check_counts(f"engine {label}", counts,
                     _engine_launches(cfg, report, "--int8-kv" in flags))
        if "--log-dir" in flags:
            # A.13: the engine's sink wrote its records; the latency is theirs
            from repro_torch.obs import load_records, serve_latency_summary

            jsonl = log_dir / "telemetry.jsonl"
            kinds = _validated("engine", jsonl)["kinds"]
            if serve_latency_summary(load_records(str(jsonl))) != report["latency"]:
                raise AssertionError("[engine] the JSONL's latency summary is not the report's")
            out["telemetry"] = dict(kinds=kinds, latency_from_jsonl=True)
            log("[engine] --log-dir: " + json.dumps(out["telemetry"]))
        if not report["admitted"] or report["completed"] != report["admitted"]:
            raise AssertionError(f"[engine] {label}: {report['completed']} of "
                                 f"{report['admitted']} requests completed")
        dc, lat = report["decode"], report["latency"]
        rec = dict(arch=cfg.name, n_layers=cfg.n_layers, kv=label, clock="wall",
                   admitted=report["admitted"], completed=report["completed"],
                   steps=report["steps"], wall_s=report["wall_s"], run_s=run_s,
                   decode_ms_per_step=1e3 * dc["steady_s"] / max(1, dc["steady_steps"]),
                   decode_tok_s=dc["tok_s"], decode_first_call_s=dc["compile_s"],
                   prefill_tok_s=report["prefill"]["tok_s"],
                   prefill_first_calls_s=report["prefill"]["compile_s"],
                   **{k: lat.get(k) for k in ("ttft_p50_s", "ttft_p99_s", "per_token_p50_s",
                                              "per_token_p99_s", "queued_p50_s")},
                   per_class={c: d["requests"] for c, d in lat["per_class"].items()},
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={n: c[0] for n, c in counts.items() if c[0]})
        out[f"wall-{label}"] = rec
        log("[engine] " + json.dumps(rec))
        torch.cuda.empty_cache()

    model = _serve_model(ENGINE_ARCH)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    reqs = trace(model.cfg.vocab)
    runs = {q: _logged_engine(model, params, q, reqs, max_len) for q in (False, True)}
    (f32, rows32), (i8, rows8) = runs[False], runs[True]
    rec = dict(arch=model.cfg.name, clock="steps", requests=len(reqs), steps=f32["steps"],
               tokens=sum(c.n_tokens for c in f32["completions"]),
               tokens_equal_isolated_greedy=_engine_vs_greedy("engine", model, params, f32,
                                                              reqs),
               int8_vs_f32=_near_tie_divergence("engine int8", rows32, rows8,
                                                 _tokens_of(f32), _tokens_of(i8)))
    out["steps-qwen2"] = rec
    log("[engine] " + json.dumps(rec))
    del params, runs, rows32, rows8
    torch.cuda.empty_cache()

    model = _serve_model(ENGINE_ARCH, ENGINE_CUT)
    params = model.init(torch.Generator().manual_seed(0))
    reqs = trace(model.cfg.vocab)
    device_runs = {}
    for device in ("cuda", "cpu"):
        reset_counts()
        p = params if device == "cpu" else {n: t.cuda() for n, t in params.items()}
        device_runs[device] = _logged_engine(model, p, False, reqs, max_len)
        counts = kernel_counts()
        launched, plain = sum(c[0] for c in counts.values()), sum(c[1] for c in counts.values())
        if (device == "cuda") != (launched > 0) or (device == "cpu") != (plain > 0):
            raise AssertionError(f"[engine] card vs CPU on {device}: {counts}")
    (card, rows_card), (cpu, rows_cpu) = device_runs["cuda"], device_runs["cpu"]
    tol = SERVE_PARITY_REL * max(float(r.abs().max()) for rs in rows_cpu.values() for r in rs)
    parity = _near_tie_divergence("engine card vs CPU", rows_cpu, rows_card, _tokens_of(cpu),
                                  _tokens_of(card), tol=tol)
    if parity["rel_err"] > SERVE_PARITY_REL:
        raise AssertionError(f"[engine] card vs CPU logits {parity['rel_err']} > "
                             f"{SERVE_PARITY_REL} of their largest value")
    out["card-vs-cpu"] = dict(arch=model.cfg.name, n_layers=ENGINE_CUT, **parity)
    log("[engine] card vs CPU: " + json.dumps(out["card-vs-cpu"]))
    del device_runs

    for arch, kvs in (("rwkv6_7b", (False,)), ("gemma2_27b", (False, True))):
        model = _serve_model(arch, ENGINE_CUT)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        reqs = trace(model.cfg.vocab)
        runs = {}
        for q in kvs:
            reset_counts()
            runs[q] = _logged_engine(model, params, q, reqs, max_len)
            check_counts(f"engine {arch} {'int8' if q else 'f32'}", kernel_counts(),
                         _engine_launches(model.cfg, runs[q][0], q))
        report = runs[False][0]
        rec = dict(arch=model.cfg.name, n_layers=ENGINE_CUT, requests=len(reqs),
                   steps=report["steps"],
                   tokens_equal_isolated_greedy=_engine_vs_greedy(f"engine {arch}", model,
                                                                  params, report, reqs),
                   tokens=sum(c.n_tokens for c in report["completions"]),
                   launches=_engine_launches(model.cfg, report, False))
        if True in runs:
            rec["int8_vs_f32"] = _near_tie_divergence(
                f"engine {arch} int8", runs[False][1], runs[True][1], _tokens_of(report),
                _tokens_of(runs[True][0]))
            rec["int8_launches"] = _engine_launches(model.cfg, runs[True][0], True)
        out[f"cut-{arch}"] = rec
        log("[engine] " + json.dumps(rec))
        del params, runs
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[engine] phase in {out['phase_s']:.1f} s")
    return out


# -- A.4 and A.11: the other optimizers and the other model families ---------------

OPTIM_STEPS = 50
OPTIM_UPDATE_REL = 1.5e-4  # card vs CPU, relative to the largest update (DYN_UPDATE_REL)
# name -> the optimizer on fmnist_default's task (the default K = 10, ER(0.3))
OPTIM_CASES = ("clip-momentum-cosine", "nesterov", "adam-warmup-cosine-wd")


def _optimizer(name: str):
    """Adam's eps is 1e-6: at 1e-8 it maps an entry whose gradient is near
    eps, where float32 summation noise is a large part of it, to an update
    of O(lr) that any two summation orders part on (tests/test_torch_optim.py)."""
    from repro_torch import optim

    if name == "clip-momentum-cosine":
        return optim.chain_clip(optim.momentum(optim.cosine_schedule(0.02, OPTIM_STEPS)), 2.0)
    if name == "nesterov":
        return optim.momentum(0.02, beta=0.9, nesterov=True)
    return optim.adam(optim.linear_warmup_cosine(1e-3, 5, OPTIM_STEPS), eps=1e-6,
                      weight_decay=1e-4)


def phase_optim(spec_cls) -> dict:
    """A.4 on the card: fmnist_default's dense stack (K = 10, ER(0.3),
    DR-DSGD, the uncompressed dense wire) for OPTIM_STEPS steps with each of
    OPTIM_CASES through TrainerSpec.build(optimizer=...), on the card and on
    the CPU from the same weights and batches.  None sets ``sgd_lr``, so the
    step is unfused: no B.1 launch, no kernel at all.  Every entry's update
    within OPTIM_UPDATE_REL of the largest update, the losses at rtol 1e-4,
    the first batch's loss lower after the run."""
    import numpy as np
    import torch

    from repro_torch.models import make_classifier_loss, mlp_apply

    t_phase = time.perf_counter()
    exp, fed, batches, params = _fmnist()
    cpu_params = {n: t.cpu() for n, t in params.items()}
    batches = tuple(b[:OPTIM_STEPS] for b in batches)
    out = {}
    for name in OPTIM_CASES:
        runs = {}
        for device in ("cuda", "cpu"):
            spec = spec_cls(num_nodes=K, graph="erdos_renyi",
                            graph_kwargs={"p": exp.p, "seed": exp.seed}, mu=exp.mu, lr=exp.lr,
                            device=device)
            trainer = spec.build(make_classifier_loss(mlp_apply), mlp_apply,
                                 optimizer=_optimizer(name))
            reset_counts()
            t0 = time.perf_counter()
            state, ms = trainer.run(trainer.init(params if device == "cuda" else cpu_params),
                                    batches)
            first = tuple(b[0] for b in batches)
            loss_after = _loss_on(trainer, state, first)
            secs = time.perf_counter() - t0
            check_counts(f"optim {name} on {device}", kernel_counts(), {})
            runs[device] = ({n: t.cpu() for n, t in state.params.items()},
                            ms["loss_mean"].cpu(), secs, loss_after)
        (p_g, l_g, s_g, after_g), (p_c, l_c, s_c, after_c) = runs["cuda"], runs["cpu"]
        upd = {n: p_c[n] - cpu_params[n].unsqueeze(0) for n in p_c}
        largest = max(float(u.abs().max()) for u in upd.values())
        worst = max(float((p_g[n] - p_c[n]).abs().max()) for n in p_c) / largest
        rec = dict(optimizer=name, steps=OPTIM_STEPS, nodes=K, largest_update=largest,
                   update_rel_err=worst,
                   loss_rel_err=float(((l_g - l_c).abs() / l_c.abs()).max()),
                   loss_step0=float(l_c[0]), first_batch_loss_after=after_g,
                   first_batch_loss_after_cpu=after_c, card_s=s_g, cpu_s=s_c,
                   ms_per_step_card=1e3 * s_g / OPTIM_STEPS)
        log("[optim] " + json.dumps(rec))
        if not (worst <= OPTIM_UPDATE_REL and rec["loss_rel_err"] <= 1e-4
                and after_g < rec["loss_step0"] and all(np.isfinite(l_g.numpy()))):
            raise AssertionError(f"[optim] {name}: card vs CPU or loss: {rec}")
        out[name] = rec
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[optim] phase in {out['phase_s']:.1f} s")
    return out


MOE_ARCH = "deepseek_moe_16b"
MOE_CUT = 2                 # the dense first layer and one MoE layer, at full width
MOE_SERVE = (256, 32)       # prompt, new tokens at SERVE_BATCH
MOE_PARITY_PROMPT = 32
MOE_TRAIN = (MOE_CUT, 4, 5)  # layers, nodes, steps
MOE_PARITY = (1, 2, 2)      # one MoE layer (first_k_dense 0), nodes, steps: card vs CPU


def _moe_inputs(fn) -> list:
    """Run ``fn`` with every MoE FFN call recording its (params, input)."""
    from repro_torch.models import transformer

    seen, moe_ffn = [], transformer.moe_ffn

    def recording(p, x, cfg):
        seen.append((p, x.detach().clone()))
        return moe_ffn(p, x, cfg)

    transformer.moe_ffn = recording
    try:
        fn()
    finally:
        transformer.moe_ffn = moe_ffn
    return seen


def _routing_vs(tag, cfg, card_calls, cpu_calls) -> dict:
    """Each MoE call's routing on the card against the CPU's, on each
    device's own input, call by call in order: expert choices, ranks and
    drops equal, except where a token's top-k boundary margin of the CPU's
    router probabilities is below twice the measured largest |card - CPU|
    probability (the repo's near-tie rule, ROADMAP C).  A flip taints its
    batch row from that call on (its output, and so its later inputs, part),
    and a drop it moves taints the moved token's row; tainted rows are left
    out of later calls.  Returns the tokens compared, the near ties that
    flipped, the tainted rows and the probability error."""
    import torch

    from repro_torch.models.moe import moe_route

    if len(card_calls) != len(cpu_calls):
        raise AssertionError(f"[{tag}] {len(card_calls)} MoE calls on the card, "
                             f"{len(cpu_calls)} on the CPU")
    k = cfg.moe.top_k
    tokens = flips = 0
    err = 0.0
    tainted: set = set()
    for (pg, xg), (pc, xc) in zip(card_calls, cpu_calls):
        b = xc.shape[0]
        row = torch.arange(b).repeat_interleave(xc.numel() // (b * xc.shape[-1]))
        live = torch.tensor([int(r) not in tainted for r in row])
        xg, xc = xg.reshape(-1, xg.shape[-1]), xc.reshape(-1, xc.shape[-1])
        rg, rc = moe_route(pg, xg, cfg), moe_route(pc, xc, cfg)
        probs_c = torch.softmax(xc.float() @ pc["router"].float(), -1)
        probs_g = torch.softmax(xg.float() @ pg["router"].float(), -1).cpu()
        err = max(err, float((probs_g[live] - probs_c[live]).abs().max()))
        differ = (rg["expert_ids"].cpu() != rc["expert_ids"]).any(-1) & live
        srt = probs_c.sort(-1, descending=True).values
        margin = (srt[:, :k] - srt[:, 1:k + 1]).min(-1).values
        bad = differ & (margin >= 2 * err)
        if bool(bad.any()):
            raise AssertionError(f"[{tag}] {int(bad.sum())} tokens route apart with a top-k "
                                 f"margin above 2 x {err}")
        flips += int(differ.sum())
        keep_g, keep_c = rg["keep"].cpu(), rc["keep"]
        if not tainted and not bool(differ.any()):
            if not (torch.equal(rg["rank"].cpu(), rc["rank"]) and torch.equal(keep_g, keep_c)):
                raise AssertionError(f"[{tag}] equal choices, different ranks or drops")
        else:  # ranks follow every earlier token's choices; a moved drop moves its row
            moved = (keep_g != keep_c).any(-1) & live
            tainted.update(int(r) for r in row[differ | moved])
        tokens += int(live.sum())
    return dict(moe_calls=len(cpu_calls), tokens_routed=tokens, near_tie_flips=flips,
                tainted_rows=sorted(tainted), router_prob_err=err)


def _batch_rows(cache, rows) -> dict:
    """The cache's entries of batch ``rows`` (head leaves are (B, ...),
    group leaves (layers, B, ...))."""
    from repro_torch.utils.tree import flatten, unflatten

    return {"head": [unflatten({n: t[rows] for n, t in flatten(c).items()})
                     for c in cache["head"]],
            "groups": unflatten({n: t[:, rows] for n, t in flatten(cache["groups"]).items()})}


def phase_serve_moe() -> dict:
    """deepseek-moe-16b at its published width (d_model 2048, 16 heads of
    128, 64 routed experts of 1,408 top-6 plus 2 shared, vocab 102,400) cut
    to MOE_CUT layers: the static serving path (timed_generate, SERVE_BATCH
    x 256-token prompts, 32 new tokens): B.6 at hd 128 once per attention
    layer per prefill, no plain call; tokens equal a second greedy run.
    Then card vs CPU at prompt MOE_PARITY_PROMPT: every MoE call's routing
    (_routing_vs), and the prefill's logits and caches and 8 greedy tokens
    at SERVE_PARITY_REL on every batch row no near tie flipped a choice of
    (at least one)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import timed_generate

    t_phase = time.perf_counter()
    model = _serve_model(MOE_ARCH, MOE_CUT)
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    card = {n: t.cuda() for n, t in params.items()}
    prompt_len, gen_len = MOE_SERVE
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt_len))).cuda()
    per_prefill = _pair_layers(cfg)
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               params=model.num_params(), active_params=model.num_active_params(),
               batch=SERVE_BATCH, prompt_len=prompt_len, gen_len=gen_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_counts()
        tokens, stats = timed_generate(model, card, prompt, gen_len)
        counts = kernel_counts()
        check_counts("serve-moe", counts, {"flash_attention_fwd": 2 * per_prefill})
        rec.update(launches=counts["flash_attention_fwd"][0], launches_per_prefill=per_prefill,
                   prefill_tok_s=stats["prefill"]["tok_s"],
                   prefill_steady_s=stats["prefill"]["steady_s"],
                   decode_ms_per_token=1e3 * stats["decode"]["steady_s"] / max(1, gen_len - 1),
                   decode_tok_s=stats["decode"]["tok_s"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        _, _, again, _ = _generate(model, card, prompt, gen_len, use_prefill=True)
        if not torch.equal(again, tokens):
            raise AssertionError("[serve-moe] timed_generate and a second greedy run differ")
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (SERVE_BATCH, MOE_PARITY_PROMPT)))
        runs, calls = {}, {}
        for device, p in (("cuda", card), ("cpu", params)):
            reset_counts()
            calls[device] = _moe_inputs(lambda: runs.__setitem__(device, _generate(
                model, p, prompt.to(device), SERVE_PARITY_GEN, True)))
            counts = kernel_counts()
            launched = sum(c[0] for c in counts.values())
            if (device == "cuda") != (launched > 0) or \
                    (device == "cpu") != (sum(c[1] for c in counts.values()) > 0):
                raise AssertionError(f"[serve-moe] card vs CPU on {device}: {counts}")
    rec["routing"] = _routing_vs("serve-moe", cfg, calls["cuda"], calls["cpu"])
    (lg, cg, tg, _), (lc, cc, tc, gaps) = runs["cuda"], runs["cpu"]
    # a flipped choice moves its row's output: the other rows are held
    rows = [r for r in range(SERVE_BATCH) if r not in rec["routing"]["tainted_rows"]]
    if not rows:
        raise AssertionError(f"[serve-moe] near ties tainted every row: {rec['routing']}")
    rec.update(rows_compared=rows,
               **_compare("serve-moe card vs CPU", lg.cpu()[rows], _batch_rows(cg, rows),
                          lc[rows], _batch_rows(cc, rows), SERVE_PARITY_REL))
    rec["tokens_identical"] = _same_tokens("serve-moe card vs CPU", tg.cpu()[rows], tc[rows],
                                           gaps[rows],
                                           SERVE_PARITY_REL * float(lc[rows].abs().max()))
    rec["phase_s"] = time.perf_counter() - t_phase
    log("[serve-moe] " + json.dumps(rec))
    del card, params, runs, calls
    torch.cuda.empty_cache()
    return rec


def phase_train_moe(spec_cls) -> dict:
    """deepseek-moe-16b at full width cut to MOE_CUT layers through
    train_lm's stack at K = 4, 5 steps (_full_width_train): B.6 forward and
    backward on both attention layers of every node, the fused B.1 once
    per 16 leaves, exact; the loss falls; the aux term of node 0's loss on
    the first batch finite and positive.  Then one MoE layer (n_layers 1,
    first_k_dense 0) at K = 2 on the card against the CPU (_card_vs_cpu,
    updates within UPDATE_REL of the largest)."""
    import torch

    t_phase = time.perf_counter()
    layers, nodes, steps = MOE_TRAIN
    model = _serve_model(MOE_ARCH, layers)

    def aux_term(trainer, state, first):
        node0 = {n: t[0] for n, t in state.params.items()}
        with torch.no_grad():
            aux = float(model._forward(node0, {"tokens": first[0][0].cuda()}, False,
                                       drop_last_token=True)[1])
        if not (math.isfinite(aux) and aux > 0):
            raise AssertionError(f"[train-moe] aux term {aux}")
        return {"aux_node0_first_batch": aux}

    out = {"full_width": _full_width_train("train-moe", spec_cls, model, nodes, steps,
                                           LM_PAIR, check=aux_term)}
    out["parity"] = _card_vs_cpu("train-moe parity", spec_cls, MOE_ARCH, MOE_PARITY, LM_PAIR,
                                 UPDATE_REL, first_k_dense=0)[0]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train-moe] phase in {out['phase_s']:.1f} s")
    return out


MAMBA_ARCH = "jamba_1_5_large_398b"
MAMBA_SERVE = (4, 256, 32)   # batch, prefill tokens, decode steps
MAMBA_PARITY = (2, 32)       # batch, tokens: card vs CPU


def phase_mamba_layer() -> dict:
    """One Mamba block at jamba-1.5-large's published width (d_model 8192,
    d_inner 16384, d_state 16, d_conv 4, dt_rank 512; ~420 M parameters),
    seeded weights: prefill B 4 x S 256 then 32 decode steps from its
    state (mamba_forward, mamba_decode), timed; the decode steps' outputs
    and states against one forward over all 288 tokens at SERVE_REL; then
    card vs CPU at B 2, S 32: output, conv state and SSM state at
    SERVE_PARITY_REL of their largest value.  The scan is plain PyTorch
    (no kernel: check_counts holds every count at 0)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import params as pr
    from repro_torch.models.ssm import mamba_decl, mamba_decode, mamba_forward

    t_phase = time.perf_counter()
    cfg = get_arch(MAMBA_ARCH)
    decl = mamba_decl(cfg)
    params = pr.init_tree(torch.Generator().manual_seed(0), decl, "cpu")
    card = {n: t.cuda() for n, t in params.items()}
    b, s, steps = MAMBA_SERVE
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((b, s + steps, cfg.d_model), generator=gen, device="cuda")
    rec = dict(arch=cfg.name, d_model=cfg.d_model, d_inner=cfg.mamba_expand * cfg.d_model,
               d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
               dt_rank=params["dt_proj"].shape[0], params=pr.count_params(decl), batch=b,
               prefill_tokens=s, decode_steps=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        times = []
        for _ in range(3):
            t0 = _cuda_clock()
            y, state = mamba_forward(card, x[:, :s], cfg)
            times.append(_cuda_clock() - t0)
        decode_s, ys = [], []
        for t in range(s, s + steps):
            t0 = _cuda_clock()
            y_t, state = mamba_decode(card, x[:, t:t + 1], cfg, state)
            decode_s.append(_cuda_clock() - t0)
            ys.append(y_t)
        whole, whole_state = mamba_forward(card, x, cfg)
        check_counts("mamba-layer", kernel_counts(), {})
        rec.update(prefill_ms=1e3 * min(times), prefill_ms_first=1e3 * times[0],
                   prefill_tok_s=b * s / min(times),
                   decode_ms_per_step=1e3 * sorted(decode_s)[len(decode_s) // 2],
                   decode_vs_forward_rel_err=max(
                       _rel_err(torch.cat(ys, 1), whole[:, s:]),
                       *(_rel_err(state[k], whole_state[k]) for k in state)),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if rec["decode_vs_forward_rel_err"] > SERVE_REL:
            raise AssertionError(f"[mamba-layer] decode vs forward: {rec}")
        pb, ps = MAMBA_PARITY
        xp = torch.randn((pb, ps, cfg.d_model), generator=torch.Generator().manual_seed(9))
        reset_counts()
        yg, sg = mamba_forward(card, xp.cuda(), cfg)
        yc, sc = mamba_forward(params, xp, cfg)
        check_counts("mamba-layer parity", kernel_counts(), {})
        errs = {"out": _rel_err(yg.cpu(), yc),
                **{k: _rel_err(sg[k].cpu(), sc[k]) for k in ("conv", "ssm")}}
    rec["card_vs_cpu_rel_err"] = errs
    rec["phase_s"] = time.perf_counter() - t_phase
    log("[mamba-layer] " + json.dumps(rec))
    if max(errs.values()) > SERVE_PARITY_REL or not all(
            bool(torch.isfinite(v).all()) for v in (y, whole, yg)):
        raise AssertionError(f"[mamba-layer] card vs CPU: {errs}")
    del card, params, state, whole_state
    torch.cuda.empty_cache()
    return rec


def _cuda_clock() -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


FRONTEND_ARCH = "musicgen_medium"
FRONTEND_TEXT = 64            # text tokens beside the 256 prefix frames: B.6 at S = 320
FRONTEND_TRAIN = (2, 4, 5)    # layers, nodes, steps
FRONTEND_PARITY = (1, 2, 3)   # layers, nodes, steps: card vs CPU
FRONTEND_SERVE = (64, 16)     # prompt, new tokens at SERVE_BATCH, all 48 layers


def phase_frontend(spec_cls) -> dict:
    """musicgen-medium at its published width (d_model 1536, 24 heads of 64,
    vocab 2048) with the frame stub: 256 prefix frames and FRONTEND_TEXT
    text tokens per sequence, so B.6 runs at S = 320.  Cut to 2 layers at
    K = 4 through train_lm's stack (_full_width_train, 5 steps: B.6 forward
    and backward per layer per node, B.1 exact), 1 layer at K = 2 on the
    card against the CPU (_card_vs_cpu), and all 48 layers served through
    the decode path (a prefix frontend has no prompt-only prefill): no
    kernel, the tokens equal greedy_generate's, ms per token."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import timed_generate
    from repro_torch.serve import greedy_generate

    t_phase = time.perf_counter()
    layers, nodes, steps = FRONTEND_TRAIN
    out = {"train": _full_width_train("frontend train", spec_cls,
                                      _serve_model(FRONTEND_ARCH, layers), nodes, steps,
                                      LM_PAIR, seq=FRONTEND_TEXT)}
    out["parity"] = _card_vs_cpu("frontend parity", spec_cls, FRONTEND_ARCH, FRONTEND_PARITY,
                                 LM_PAIR, UPDATE_REL)[0]
    model = _serve_model(FRONTEND_ARCH)
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompt_len, gen_len = FRONTEND_SERVE
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, prompt_len))).cuda()
    torch.cuda.synchronize()
    reset_counts()
    tokens, stats = timed_generate(model, params, prompt, gen_len)
    again = greedy_generate(model, params, prompt, gen_len)
    check_counts("frontend serve", kernel_counts(), {})
    if not torch.equal(tokens, again):
        raise AssertionError("[frontend] timed_generate and greedy_generate differ")
    out["serve"] = dict(arch=cfg.name, n_layers=cfg.n_layers, params=model.num_params(),
                        batch=SERVE_BATCH, prompt_len=prompt_len, gen_len=gen_len,
                        prompt_through_decode_tok_s=stats["prefill"]["tok_s"],
                        decode_ms_per_token=1e3 * stats["decode"]["steady_s"]
                        / max(1, gen_len - 1),
                        decode_tok_s=stats["decode"]["tok_s"])
    log("[frontend] serve: " + json.dumps(out["serve"]))
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[frontend] phase in {out['phase_s']:.1f} s")
    return out


SMOKE_ARCHS = ("grok_1_314b", "deepseek_moe_16b", "jamba_1_5_large_398b", "pixtral_12b",
               "musicgen_medium")
SMOKE_TRAIN = (None, 2, 2)    # the smoke config's layers, nodes, steps: card vs CPU


def _smoke_serve_parity(arch: str) -> dict:
    """One smoke family served on the card and on the CPU from the same
    weights: token frontends through prefill then greedy decode (_generate),
    the prefix frontends' prefill with their embeddings (logits, caches)
    and their greedy tokens through the decode path; SERVE_PARITY_REL."""
    import numpy as np
    import torch

    model = _serve_model(arch, smoke=True)
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, 24)))
    emb = None if cfg.frontend == "token" else torch.from_numpy(
        (rng.standard_normal((SERVE_BATCH, cfg.frontend_len, cfg.d_model)) * 0.02
         ).astype(np.float32))
    runs = {}
    with torch.inference_mode():
        for device in ("cuda", "cpu"):
            reset_counts()
            p = params if device == "cpu" else {n: t.cuda() for n, t in params.items()}
            if emb is None:
                runs[device] = _generate(model, p, prompt.to(device), SERVE_PARITY_GEN, True)
            else:
                logits, pf = model.prefill(p, {"tokens": prompt.to(device),
                                               "embeddings": emb.to(device)})
                _, _, toks, gaps = _generate(model, p, prompt.to(device), SERVE_PARITY_GEN,
                                             False)
                runs[device] = (logits, {"head": pf[0], "groups": pf[1]}, toks, gaps)
            counts = kernel_counts()
            launched, plain = (sum(c[i] for c in counts.values()) for i in (0, 1))
            if (device == "cuda") != (launched > 0) or (device == "cpu") != (plain > 0):
                raise AssertionError(f"[smoke-archs] {arch} serve on {device}: {counts}")
    (lg, cg, tg, _), (lc, cc, tc, gaps) = runs["cuda"], runs["cpu"]
    rec = dict(arch=cfg.name, **_compare(f"smoke-archs {arch}", lg.cpu(), cg, lc, cc,
                                          SERVE_PARITY_REL))
    rec["tokens_identical"] = _same_tokens(f"smoke-archs {arch}", tg.cpu(), tc, gaps,
                                           SERVE_PARITY_REL * float(lc.abs().max()))
    return rec


def _jamba_engine_parity() -> dict:
    """jamba's smoke config through the engine on the steps clock (the
    engine phase's trace), float32 and int8, on the card and on the CPU
    from the same weights: the card's launches exact; the card's float32
    tokens equal each request's isolated greedy tokens (a Mamba row left
    from a slot's last request would part them); float32 card logits within
    SERVE_PARITY_REL of the CPU's, tokens equal up to a near tie; int8 card
    tokens equal the CPU's up to a near tie (twice the row's logit error:
    a KV row that rounds to another int8 code moves a logit by more than
    float noise), and the card's int8 equal its float32 up to one."""
    import torch

    from repro_torch.serve import SMOKE_CLASSES, poisson_trace

    model = _serve_model(MAMBA_ARCH, smoke=True)
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    card = {n: t.cuda() for n, t in params.items()}
    reqs = poisson_trace(SMOKE_CLASSES, rate=2.0, horizon=8.0, vocab=cfg.vocab, seed=0)
    max_len = max(c.prompt_len + c.gen_max for c in SMOKE_CLASSES)
    runs = {}
    for device, p in (("cuda", card), ("cpu", params)):
        for q in (False, True):
            reset_counts()
            runs[device, q] = _logged_engine(model, p, q, reqs, max_len)
            counts = kernel_counts()
            if device == "cuda":
                check_counts(f"smoke-archs jamba engine {'int8' if q else 'f32'} steps clock",
                             counts, _engine_launches(cfg, runs[device, q][0], q))
            elif sum(c[0] for c in counts.values()) or not sum(c[1] for c in counts.values()):
                raise AssertionError(f"[smoke-archs] jamba engine on the CPU: {counts}")
    (f32, rows32), (i8, rows8) = runs["cuda", False], runs["cuda", True]
    (f32_c, rows32_c), (i8_c, rows8_c) = runs["cpu", False], runs["cpu", True]
    tol = SERVE_PARITY_REL * max(float(r.abs().max()) for rs in rows32_c.values() for r in rs)
    rec = dict(requests=len(reqs), steps=f32["steps"],
               tokens=sum(c.n_tokens for c in f32["completions"]),
               tokens_equal_isolated_greedy=_engine_vs_greedy("smoke-archs jamba engine", model,
                                                              card, f32, reqs),
               f32_card_vs_cpu=_near_tie_divergence("smoke-archs jamba engine card vs CPU",
                                                    rows32_c, rows32, _tokens_of(f32_c),
                                                    _tokens_of(f32), tol=tol),
               int8_card_vs_cpu=_near_tie_divergence("smoke-archs jamba engine int8 card vs "
                                                     "CPU", rows8_c, rows8, _tokens_of(i8_c),
                                                     _tokens_of(i8)),
               int8_vs_f32=_near_tie_divergence("smoke-archs jamba engine int8", rows32, rows8,
                                                 _tokens_of(f32), _tokens_of(i8)))
    if rec["f32_card_vs_cpu"]["rel_err"] > SERVE_PARITY_REL:
        raise AssertionError(f"[smoke-archs] jamba engine card vs CPU logits "
                             f"{rec['f32_card_vs_cpu']['rel_err']} > {SERVE_PARITY_REL} of "
                             f"their largest value")
    return rec


def phase_smoke_archs(spec_cls) -> dict:
    """The five families A.11 adds, at their smoke configs, through the
    entry points: the serving CLI's static batch (B.6 twice per attention
    layer for a token frontend, no kernel for a prefix frontend) and the
    training CLI (K = 4, 2 steps, B.6 and B.1 exact); serving and 2
    node-stacked train steps card vs CPU (_smoke_serve_parity;
    _card_vs_cpu at UPDATE_REL or UPDATE_ULPS ulps of the entry: at smoke
    width the largest update is ~2e-4, and one ulp of a norm scale of 1.0,
    1.19e-7, is ~6e-4 of it, so two roundings of theta + update apart
    leave UPDATE_REL); and jamba through ``serve --engine
    --int8-kv`` (B.2 on its attention layers' KV rows, B.6 on admissions,
    exact), then through the engine on the card and the CPU
    (_jamba_engine_parity)."""
    import torch

    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    out = {}
    for arch in SMOKE_ARCHS:
        model = _serve_model(arch, smoke=True)
        cfg = model.cfg
        rec = dict(arch=cfg.name)
        reset_counts()
        serve_cli.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "16",
                        "--gen-len", "4"])
        torch.cuda.synchronize()
        check_counts(f"smoke-archs serve {arch}", kernel_counts(),
                     {"flash_attention_fwd": 2 * _pair_layers(cfg)}
                     if model.has_prompt_prefill else {})
        reset_counts()
        trainer, state, history = train.main(["--arch", arch, "--smoke", "--steps", "2",
                                              "--nodes", "4", "--log-every", "1"])
        torch.cuda.synchronize()
        check_counts(f"smoke-archs train {arch}", kernel_counts(),
                     _lm_counts(4, 2, _pair_layers(cfg), len(state.params),
                                folded=_folded(cfg)))
        if not all(math.isfinite(r["loss_mean"]) for r in history):
            raise AssertionError(f"[smoke-archs] train {arch}: {history}")
        rec["train_cli_losses"] = [r["loss_mean"] for r in history]
        del trainer, state
        rec["serve"] = _smoke_serve_parity(arch)
        rec["train"] = _card_vs_cpu(f"smoke-archs {arch}", spec_cls, arch, SMOKE_TRAIN,
                                    LM_PAIR, UPDATE_REL, UPDATE_ULPS, smoke=True)[0]
        out[arch] = rec
        log("[smoke-archs] " + json.dumps({k: v for k, v in rec.items() if k != "train"}))
    cfg = _serve_model(MAMBA_ARCH, smoke=True).cfg
    reset_counts()
    report = serve_cli.main(["--arch", MAMBA_ARCH, "--smoke", "--engine", "--int8-kv",
                             *ENGINE_ARGS])
    torch.cuda.synchronize()
    want = _engine_launches(cfg, report, True)
    check_counts("smoke-archs jamba engine", kernel_counts(), want)
    if not report["admitted"] or report["completed"] != report["admitted"]:
        raise AssertionError(f"[smoke-archs] jamba engine: {report['completed']} of "
                             f"{report['admitted']}")
    out["jamba-engine-int8"] = dict(arch=cfg.name, admitted=report["admitted"],
                                    steps=report["steps"], launches=want,
                                    steps_clock=_jamba_engine_parity())
    log("[smoke-archs] jamba engine: " + json.dumps(out["jamba-engine-int8"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[smoke-archs] phase in {out['phase_s']:.1f} s")
    return out


def _a11_train_runs(moe_train, frontend, smoke):
    """(phase, run, record) of A.11's training runs on the card."""
    yield "train-moe", "deepseek-moe-16b 2 layers K 4", moe_train["full_width"]
    yield "train-moe", "1 MoE layer K 2 vs CPU", moe_train["parity"]
    yield "frontend", "musicgen-medium 2 layers K 4", frontend["train"]
    yield "frontend", "1 layer K 2 vs CPU", frontend["parity"]
    for arch in SMOKE_ARCHS:
        yield "smoke-archs", f"{arch} K 2 vs CPU", smoke[arch]["train"]


# -- A.13: the tooling on the card ----------------------------------------------

OBS_STEPS = 100              # fmnist's 300 steps, cut: the CLI run and the int8 wire
OBS_GOSSIP_STEPS = 100       # the straggler-masked memoryless gossip run
OBS_INJECT = (8, 5)          # steps of an injected-violation run, the injected step
OBS_STRAGGLER_P = 0.2


def _obs_dir(name: str) -> Path:
    path = ROOT / "build" / "chip_smoke" / "obs" / name
    shutil.rmtree(path, ignore_errors=True)
    return path


def _validated(tag: str, path: Path) -> dict:
    """The port's validator over a JSONL stream; any error fails the phase."""
    from repro_torch.obs import validate_jsonl

    summary = validate_jsonl(str(path))
    if summary["errors"]:
        raise AssertionError(f"[obs] {tag}: {path} fails the schema: {summary['errors'][:5]}")
    return summary


# benchmarks/bench_trainer.py's sink-off / sink-on pair: fmnist_default's K
# = 10 ER(0.3) graph, mu 6, lr 0.1, clip 2, batch 32, 200 steps in segments
# of 50 through run_segments, in 6 alternated rounds (bench_trainer.py's
# 10 cut to keep the smoke within its time); the ceiling this run
# asserts on the median of the rounds' paired readings, above the
# reference's 3 % budget (one pass of a mode differs from the next by up
# to ~20 % on a shared host) and below the +16 % of the fault it guards
SINK_BENCH = dict(lr=0.1, grad_clip=2.0, batch=32, steps=200, seg=50, rounds=6)
SINK_OVERHEAD_CEILING_PCT = 10.0
# where the sink sits in a pass: off, no sink; on, the trainer's tap and
# run_segments' per-segment work (one synchronisation, one drain and one
# perf record per segment); tap, the tap only (drained at the pass's end);
# hooks, the per-segment work around a trainer without a sink
SINK_KINDS = ("off", "on", "tap", "hooks")


def sink_passes(spec_cls, exp, fed, params, kinds=("off", "on"),
                rounds: int | None = None) -> dict:
    """Time fmnist in SINK_BENCH's configuration with the telemetry sink
    placed as each of ``kinds`` (SINK_KINDS) says: every kind warmed up on
    one segment, then ``rounds`` (by default SINK_BENCH's) rounds of one
    pass per kind, the kinds' order rotated by one each round (with two kinds: off, on, then on, off),
    each pass from the same weights with the same batches and ending
    synchronised (the sink drained), garbage collected before it and the
    earlier phases' heap frozen out of the collector.  Raises unless every
    kind's final parameters are bit-equal to the first kind's.  Returns
    {"wall_s": {kind: [s per round]}, "order": [kinds per round],
    "sinks": {kind: its MetricsSink or None}}."""

    import numpy as np
    import torch

    from repro_torch.core import run_segments
    from repro_torch.models import make_classifier_loss, mlp_apply
    from repro_torch.obs import MetricsSink

    cfg = SINK_BENCH
    rounds = cfg["rounds"] if rounds is None else rounds

    def build(sink, tap: bool):
        # the eager step in every kind (jit=False): the tap keeps a step
        # eager, so the pair prices the sink, not the capture
        spec = spec_cls(num_nodes=exp.num_nodes, graph="erdos_renyi",
                        graph_kwargs={"p": exp.p, "seed": exp.seed}, mu=exp.mu, robust=True,
                        lr=cfg["lr"], grad_clip=cfg["grad_clip"], seed=exp.seed, device="cuda",
                        jit=False)
        return spec.build(make_classifier_loss(mlp_apply), mlp_apply,
                          obs=sink if tap else None)

    # (trainer, the sink to drain, the sink run_segments gets); on and tap
    # share one tapped trainer
    modes, tapped = {}, None
    for kind in kinds:
        if kind in ("on", "tap"):
            if tapped is None:
                sink = MetricsSink()
                tapped = (build(sink, True), sink)
            modes[kind] = (*tapped, tapped[1] if kind == "on" else None)
        else:
            sink = MetricsSink() if kind == "hooks" else None
            modes[kind] = (build(None, False), sink, sink)

    def one_pass(kind, steps):
        trainer, sink, seg_obs = modes[kind]
        rng = np.random.default_rng(exp.seed)
        state = trainer.init(params)
        gc.collect()  # no collection of the previous pass's garbage inside this one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_segments(trainer, state, lambda step: fed.sample_batch(rng, cfg["batch"]),
                             steps, cfg["seg"], obs=seg_obs)
        torch.cuda.synchronize()
        if sink is not None:
            sink.barrier()
        return time.perf_counter() - t0, state

    for kind in kinds:
        one_pass(kind, cfg["seg"])
    walls, order, final = {k: [] for k in kinds}, [], {}
    # a full collection in a pass scans only what the passes make
    gc.collect()
    gc.freeze()
    try:
        for rnd in range(rounds):
            turn = kinds[rnd % len(kinds):] + kinds[:rnd % len(kinds)]
            order.append(list(turn))
            for kind in turn:
                wall, final[kind] = one_pass(kind, cfg["steps"])
                walls[kind].append(wall)
    finally:
        gc.unfreeze()
    for kind in kinds[1:]:
        differ = [n for n in final[kinds[0]].params
                  if not torch.equal(final[kinds[0]].params[n], final[kind].params[n])]
        if differ:
            raise AssertionError(f"[obs] sink {kind}: the final parameters differ from "
                                 f"{kinds[0]}'s in {differ}")
    return dict(wall_s=walls, order=order, sinks={k: m[1] for k, m in modes.items()})


def _sink_overhead(spec_cls, exp, fed, params) -> dict:
    """The sink's cost per step in bench_trainer.py's configuration
    (:func:`sink_passes`, off and on over SINK_BENCH["rounds"] alternated
    rounds).  sink_overhead_pct is bench_trainer's statistic, 100 (1 - off
    / on) of each mode's best pass; sink_overhead_paired_pct the median
    over the rounds of each round's 100 (1 - off / on), which the run
    asserts is at most SINK_OVERHEAD_CEILING_PCT.  The final parameters
    bit-equal; one train record per step, vectors on every 8th."""
    import numpy as np

    cfg = SINK_BENCH
    run = sink_passes(spec_cls, exp, fed, params)
    walls = run["wall_s"]
    best = {name: min(w) for name, w in walls.items()}
    pct = 100.0 * (1.0 - best["off"] / best["on"])
    per_round = [100.0 * (1.0 - off / on) for off, on in zip(walls["off"], walls["on"])]
    paired = float(np.median(per_round))
    log(f"[obs] sink_overhead_pct {pct:.3f} (best of {cfg['rounds']}: off {best['off']:.4f} s, "
        f"on {best['on']:.4f} s for {cfg['steps']} steps); sink_overhead_paired_pct "
        f"{paired:.3f} (median of the rounds' readings, ceiling {SINK_OVERHEAD_CEILING_PCT} %; "
        f"the reference's budget 3 %); passes " + json.dumps(walls))
    sink = run["sinks"]["on"]
    recs = sink.records("train")
    want = cfg["seg"] + cfg["rounds"] * cfg["steps"]
    vec = sum(1 for r in recs if "loss_nodes" in r)
    if len(recs) != want or vec != sum(1 for r in recs if r["step"] % sink.vector_every == 0):
        raise AssertionError(f"[obs] sink on: {len(recs)} train records ({want} expected), "
                             f"{vec} with vectors")
    if paired > SINK_OVERHEAD_CEILING_PCT:
        raise AssertionError(f"[obs] the sink costs a median {paired:.2f} % of the step over "
                             f"{cfg['rounds']} rounds, above {SINK_OVERHEAD_CEILING_PCT} %: "
                             f"{per_round}")
    return dict(config=cfg, wall_s=walls, best_s=best,
                steps_per_s={n: cfg["steps"] / w for n, w in best.items()},
                sink_overhead_pct=pct, round_pct=per_round, sink_overhead_paired_pct=paired,
                ceiling_pct=SINK_OVERHEAD_CEILING_PCT, params_bitwise=True,
                train_records=len(recs), vector_records=vec)


def _obs_trainer(spec_cls, exp, compress, sanitize, obs=None, mixer=None):
    from repro_torch.models import make_classifier_loss, mlp_apply

    spec = spec_cls(num_nodes=exp.num_nodes, graph="erdos_renyi",
                    graph_kwargs={"p": exp.p, "seed": exp.seed}, lr=exp.lr, mu=exp.mu,
                    compress=compress, sanitize=sanitize, device="cuda")
    return spec.build(make_classifier_loss(mlp_apply), mlp_apply, mixer=mixer, obs=obs)


def _straggler_gossip(cfg_cls, exp):
    """The memoryless int8 gossip wire over fmnist_default's ER graph under
    stragglers: grouped B.4 and B.5 once per matching per round."""
    from repro_torch.dynamics import DynamicGossipMixer, FaultConfig, StaticSchedule
    from repro_torch.graphs import build_graph, metropolis_weights

    w = metropolis_weights(build_graph("erdos_renyi", exp.num_nodes, p=exp.p, seed=exp.seed))
    return DynamicGossipMixer(StaticSchedule(w, device="cuda"),
                              faults=FaultConfig(straggler_p=OBS_STRAGGLER_P, seed=exp.seed),
                              quantized=cfg_cls(kind="int8", use_kernel=True,
                                                error_feedback=False))


def _injected(tag, trainer, params, batches, check, inject) -> dict:
    """OBS_INJECT's run with ``inject(target mixer, state)`` between its two
    epochs: the sanitizer must fire ``check`` first at the injected step."""
    from repro_torch.analysis import SanitizeError

    steps, at = OBS_INJECT
    target = trainer.mixer
    while hasattr(target, "inner"):
        target = target.inner

    def on_epoch(e, st, ms):
        if e == 0:
            inject(target, st)

    try:
        trainer.run(trainer.init(params), tuple(b[:steps] for b in batches), epoch_steps=at,
                    on_epoch=on_epoch)
    except SanitizeError as err:
        first = min(step for step, _ in err.fired.values())
        if err.fired.get(check, (None,))[0] != at or first != at:
            raise AssertionError(f"[obs] {tag}: fired {err.fired}, want {check} at {at}")
        return {name: dict(step=step, value=value) for name, (step, value) in err.fired.items()}
    raise AssertionError(f"[obs] {tag}: the injected violation fired no check")


def phase_obs(spec_cls, cfg_cls) -> dict:
    """A.13 on the card, through the user entry points.

    1. ``train --paper fmnist --steps OBS_STEPS --log-dir D --profile
       --sanitize`` (fmnist_default, K = 10, its 300 steps cut; the fused
       step through grouped B.1): the JSONL passes the port's validator
       with one train record per step, vectors on every 8th and one perf
       record per segment; B.1 launched once per step (the launch
       counter); the Chrome trace holds B.1's kernel
       and the step's obs: ranges.  Then the same weights and batches
       through the trainer API with the sink off, on, on, off: the metrics
       and the final parameters bit-equal, and each run's seconds.
    2. The int8 wire on the kernel quantizer (Philox and grouped B.2 once
       per step) with the sink and the sanitizer, through the trainer API (the
       CLI's ``--compress int8`` is the reference's plain codec and never
       reaches B.2): no check fires; then runs of OBS_INJECT steps with one
       violation each injected at its step (a W row off by 1e-2, a NaN in
       one node's parameters, a qmax of 128; a mask entry of 0.5 on the
       gossip stack of 3) fire that check first, at that step.
    3. The memoryless int8 gossip wire under stragglers (0.2) with the sink
       and the sanitizer (the train CLI builds only the dense lowering, as
       the reference's does: the gossip stack is the trainer API's
       ``mixer=``), OBS_GOSSIP_STEPS steps: B.4 and B.5 once per matching
       per round; ``python -m repro_torch.obs report`` replays the run's
       faults on the card and names exactly the straggler rounds the mixer
       applied (read through ``comm/topology.py::round_fault_masks``).
    4. ``audit_host_syncs`` on one fmnist step (dense and int8), sink and
       sanitizer off and on: on may make no more synchronisations than off.
    Part 1 ends with bench_trainer.py's sink-off / sink-on pair in
    alternated rounds (:func:`_sink_overhead`): the median of the rounds'
    ``sink_overhead_pct`` at most SINK_OVERHEAD_CEILING_PCT, the parameters
    bit-equal.
    Part 5, the engine with a sink, runs in the engine phase."""
    import contextlib
    import io

    import torch

    from repro_torch.analysis.audit import fmnist_step_syncs
    from repro_torch.comm import topology as comm_topology
    from repro_torch.launch import train
    from repro_torch.obs import MetricsSink, find_perfetto_trace, load_records
    from repro_torch.obs import report as obs_report

    t_phase = time.perf_counter()
    out = {}
    exp, fed, batches, params = _fmnist()
    steps = OBS_STEPS
    batches = tuple(b[:steps] for b in batches)

    # 1. the dense wire through B.1: the CLI with the sink, the profiler and
    #    the sanitizer
    t0 = time.perf_counter()
    d1 = _obs_dir("fmnist-dense")
    reset_counts()
    train.main(["--paper", "fmnist", "--steps", str(steps), "--log-dir", str(d1), "--profile",
                "--sanitize"])
    torch.cuda.synchronize()
    counts = kernel_counts()
    check_counts("obs fmnist --log-dir --profile --sanitize", counts,
                 {"gossip_update_stacked_grouped": steps})
    summary = _validated("fmnist dense", d1 / "telemetry.jsonl")
    recs = load_records(str(d1))
    train_recs = [r for r in recs if r["kind"] == "train"]
    with_vec = [r["step"] for r in train_recs if "loss_nodes" in r]
    segments = -(-steps // 10)
    if (len(train_recs) != steps or with_vec != list(range(0, steps, 8))
            or summary["kinds"].get("perf") != segments or not summary["train_steps_contiguous"]):
        raise AssertionError(f"[obs] fmnist dense: {summary['kinds']}, vectors on {with_vec}")
    prof = find_perfetto_trace(str(d1))
    text = Path(prof).read_text()
    names = ["gossip_update_stacked_grouped_kernel", "obs:grad", "obs:dr_weighting",
             "obs:local_update", "obs:consensus", "obs:sanitize", "obs:tap", "obs:run",
             "obs:hook"]
    # a kernel's name is its C++ signature ("void name<float>(...)")
    missing = [n for n in names if (f'"{n}' if n.startswith("obs:") else n) not in text]
    if missing:
        raise AssertionError(f"[obs] the profile {prof} lacks {missing}")
    cli_s = time.perf_counter() - t0
    # the sink on and off through the trainer API, the same weights and
    # batches, in turns off, on, on, off: the metrics callers see and the
    # final parameters bit-equal; each run's wall seconds
    runs = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off"):
        trainer = _obs_trainer(spec_cls, exp, None, False,
                               obs=MetricsSink() if turn == "on" else None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fin, ms = trainer.run(trainer.init(params), batches)
        torch.cuda.synchronize()
        runs[turn].append((time.perf_counter() - t1, fin, ms))
        if turn == "on" and len(trainer.obs.records("train")) != steps:
            raise AssertionError("[obs] the sink did not get one train record per step")
    _, fin0, ms0 = runs["off"][0]
    for turn, got in runs.items():
        for _, fin, ms in got:
            differ = ([n for n in fin0.params if not torch.equal(fin.params[n], fin0.params[n])]
                      + [k for k in ms0 if k not in ms or not torch.equal(ms[k], ms0[k])]
                      + [k for k in ms if k not in ms0])
            if differ:
                raise AssertionError(f"[obs] sink {turn}: the run differs in {differ}")
    out["fmnist-dense"] = dict(
        steps=steps, kinds=summary["kinds"], vector_steps=len(with_vec),
        launches={n: c[0] for n, c in counts.items() if c[0]}, profile_mb=len(text) / 1e6,
        cli_s=cli_s, sink_on_off_bitwise=True,
        run_s_without_sink=[r[0] for r in runs["off"]],
        run_s_with_sink=[r[0] for r in runs["on"]], wall_s=time.perf_counter() - t0)
    del runs, fin0, ms0
    log("[obs] " + json.dumps(out["fmnist-dense"]))
    out["sink-overhead"] = _sink_overhead(spec_cls, exp, fed, params)

    # 2. the int8 wire on the kernel quantizer (grouped B.2) with the sink and
    #    the sanitizer, through the trainer API: the CLI's --compress int8 is
    #    the reference's codec (use_kernel=False, plain PyTorch, no kernel);
    #    then one violation each
    t0 = time.perf_counter()
    d2 = _obs_dir("fmnist-int8")
    with MetricsSink(str(d2)) as sink:
        trainer = _obs_trainer(spec_cls, exp, cfg_cls(kind="int8", use_kernel=True), True,
                               obs=sink)
        sink.log("meta", 0, paper="fmnist", nodes=exp.num_nodes, steps=steps,
                 compress="int8", sanitize=True, device=str(trainer.device))
        reset_counts()
        trainer.run(trainer.init(params), batches, epoch_steps=10, on_epoch=lambda *a: None)
        torch.cuda.synchronize()
        counts = kernel_counts()
    check_counts("obs fmnist int8 kernel wire, sanitized", counts,
                 {"quantize_blockwise_grouped": steps, "uniforms_grouped": steps})
    if _validated("fmnist int8", d2 / "telemetry.jsonl")["kinds"].get("train") != steps:
        raise AssertionError("[obs] fmnist int8: not one train record per step")
    rec = dict(steps=steps, fired={}, launches={n: c[0] for n, c in counts.items() if c[0]})

    def bad_w(target, st):
        target.w[0, 0] += 1e-2

    def nan(target, st):
        st.params["fc0/w"][1, 0, 0] = float("nan")

    def qmax128(target, st):
        target._rate = lambda comm: torch.full((), 128.0, device="cuda")

    def half_mask(target, st):
        inner = target._round_vectors

        def vectors(w):
            self_w, match_ws, masks = inner(w)
            return self_w, match_ws, [masks[0] * 0.5] + list(masks[1:])
        target._round_vectors = vectors

    for check, inject in (("doubly_stochastic", bad_w), ("finite", nan),
                          ("rate_in_container", qmax128)):
        trainer = _obs_trainer(spec_cls, exp, cfg_cls(kind="int8", use_kernel=True), True)
        rec["fired"][check] = _injected(f"int8 {check}", trainer, params, batches, check,
                                        inject)
    mixer = _straggler_gossip(cfg_cls, exp)
    trainer = _obs_trainer(spec_cls, exp, mixer.compression, True, mixer=mixer)
    rec["fired"]["masks_binary"] = _injected("gossip masks_binary", trainer, params, batches,
                                             "masks_binary", half_mask)
    rec["wall_s"] = time.perf_counter() - t0
    out["fmnist-int8-sanitize"] = rec
    log("[obs] " + json.dumps(rec))

    # 3. the straggler-masked memoryless gossip wire: B.4/B.5, fault replay
    t0 = time.perf_counter()
    d3 = _obs_dir("gossip-stragglers")
    mixer = _straggler_gossip(cfg_cls, exp)
    matchings = len(mixer.transport.srcs)
    applied = {}
    seam = comm_topology.round_fault_masks

    def spy(faults, rounds, k, device):
        keep, up = seam(faults, rounds, k, device)
        applied[rounds] = [int(n) for n in torch.nonzero(up < 0.5)[:, 0].tolist()]
        return keep, up

    n = OBS_GOSSIP_STEPS
    with MetricsSink(str(d3)) as sink:
        trainer = _obs_trainer(spec_cls, exp, mixer.compression, True, obs=sink, mixer=mixer)
        sink.log("meta", 0, paper="fmnist", nodes=exp.num_nodes, steps=n,
                 topology="static-gossip", straggler_p=OBS_STRAGGLER_P, seed=exp.seed,
                 compress="int8", sanitize=True, device=str(trainer.device))
        reset_counts()
        comm_topology.round_fault_masks = spy
        try:
            trainer.run(trainer.init(params), tuple(b[:n] for b in batches), epoch_steps=10,
                        on_epoch=lambda *a: None)
            torch.cuda.synchronize()
        finally:
            comm_topology.round_fault_masks = seam
        counts = kernel_counts()
    # the noise per matching; the coins per round, again for the sanitizer's W_r
    check_counts("obs gossip stragglers", counts,
                 {"masked_quantize_blockwise_grouped": n * matchings,
                  "masked_dequant_accumulate_grouped_": n * matchings,
                  "uniforms_grouped": n * matchings + 2 * n})
    _validated("gossip stragglers", d3 / "telemetry.jsonl")
    report_out = io.StringIO()
    with contextlib.redirect_stdout(report_out):
        rc = obs_report.main(["report", str(d3), "--json",
                              "--export-trace", str(d3 / "events.json")])
    summary = json.loads(report_out.getvalue().split("\ntrace")[0])
    if rc or "events_error" in summary:
        raise AssertionError(f"[obs] report: rc {rc}, {summary.get('events_error')}")
    replayed = {e["step"]: e["down_nodes"] for e in obs_report.summarize_run(
        load_records(str(d3)))["trace_records"] if e["event"] == "fault"}
    want = {r: nodes for r, nodes in sorted(applied.items()) if nodes and r < n}
    if replayed != want:
        raise AssertionError(f"[obs] replayed straggler rounds {replayed} != applied {want}")
    out["gossip-stragglers"] = dict(
        steps=n, matchings=matchings, straggler_rounds=len(want),
        down_node_rounds=sum(len(v) for v in want.values()), events=summary.get("events"),
        launches={k: c[0] for k, c in counts.items() if c[0]},
        wall_s=time.perf_counter() - t0)
    log("[obs] " + json.dumps(out["gossip-stragglers"]))

    # 4. host synchronisations of one step, the sink and the sanitizer off and on
    t0 = time.perf_counter()
    syncs = {c: fmnist_step_syncs(c) for c in ("none", "int8")}
    for c, counts in syncs.items():
        worse = [(s, k) for s, v in counts["on"].items() for k in v
                 if v[k] > counts["off"][s][k]]
        if worse:
            raise AssertionError(f"[obs] {c}: the sink and sanitizer add syncs: {counts}")
    out["audit"] = dict(syncs, wall_s=time.perf_counter() - t0)
    log("[obs] synchronisations of one fmnist step, sink and sanitizer off/on: "
        + json.dumps(out["audit"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[obs] phase in {out['phase_s']:.1f} s")
    return out


def timed(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds logged as ``[time] <name>``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[time] {name} {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import expandable_segments

    expandable_segments()  # before any CUDA allocation: the allocator's reserve at full width
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
    timed("build", phase_build)
    g = torch.Generator().manual_seed(0)
    mlp = leaf_dims(mlp_init(g))
    cnn = leaf_dims(cnn_init(g))
    kern = timed("kernel", phase_kernel, mlp, cnn)
    b1 = timed("gossip_update_kernels", phase_gossip_update_kernels, mlp)
    fm, dense_params = timed("fmnist", phase_fmnist, TrainerSpec, CompressionConfig)
    b1_nodes = timed("gossip_update_nodes", phase_gossip_update_nodes, TrainerSpec)
    gossip = timed("gossip", phase_gossip, TrainerSpec, CompressionConfig, dense_params)
    b45 = timed("b45_leaves", phase_b45_leaves, CompressionConfig)
    b3 = timed("b3_leaves", phase_b3_leaves, CompressionConfig)
    b2 = timed("b2_leaves", phase_b2_leaves, CompressionConfig)
    timed("profile", phase_profile, TrainerSpec, CompressionConfig)
    timed("cifar", phase_cifar, TrainerSpec, CompressionConfig)
    timed("parity", phase_parity, TrainerSpec, CompressionConfig)
    t_codecs = time.perf_counter()
    timed("codecs", phase_codecs, TrainerSpec, CompressionConfig)
    sched = timed("schedules", phase_schedules, TrainerSpec, CompressionConfig, mlp, cnn)
    log(f"[done] codecs and schedules in {time.perf_counter() - t_codecs:.1f} s")
    t_dyn = time.perf_counter()
    dyn = timed("dynamics", phase_dynamics, TrainerSpec, CompressionConfig)
    hub = timed("hub", phase_hub, TrainerSpec, CompressionConfig)
    log(f"[done] dynamics and hub in {time.perf_counter() - t_dyn:.1f} s")
    timed("ckpt", phase_ckpt, TrainerSpec, CompressionConfig)
    timed("optim", phase_optim, TrainerSpec)
    timed("obs", phase_obs, TrainerSpec, CompressionConfig)
    log(f"[done] paper training phases in {time.perf_counter() - t_start:.1f} s")
    bwd = timed("flash_bwd_kernels", phase_flash_bwd_kernels)
    compiled = timed("compiled", phase_compiled, TrainerSpec, CompressionConfig)
    lm = timed("train_lm", phase_train_lm, LM_SEQ, LM_NODES, LM_STEPS, profile=True)
    timed("train_lm S 512", phase_train_lm, *LM_LONG, profile=False)
    timed("train_parity", phase_train_parity, TrainerSpec)
    rwkv_train = timed("train_rwkv", phase_train_rwkv, TrainerSpec)
    moe_train = timed("train_moe", phase_train_moe, TrainerSpec)
    frontend = timed("frontend", phase_frontend, TrainerSpec)
    log(f"[done] training phases in {time.perf_counter() - t_start:.1f} s")
    serve_kern = timed("serve_kernels", phase_serve_kernels)
    qwen = timed("serve qwen2", phase_serve, "qwen2_0_5b", 512, 64, "flash_attention_fwd",
                 profile=True, end_to_end=True)
    rwkv = timed("serve rwkv6", phase_serve, "rwkv6_7b", 256, 32, "wkv6_scan", profile=False,
                 end_to_end=False)
    timed("serve_parity qwen2", phase_serve_parity, "qwen2_0_5b", 64)
    timed("serve_parity rwkv6", phase_serve_parity, "rwkv6_7b", 32)
    serve_bf16 = timed("serve_bf16", phase_serve_bf16, qwen)
    moe_serve = timed("serve_moe", phase_serve_moe)
    timed("mamba_layer", phase_mamba_layer)
    engine = timed("engine", phase_engine)
    smoke = timed("smoke_archs", phase_smoke_archs, TrainerSpec)
    t_examples = time.perf_counter()
    examples = timed("examples", phase_examples)
    log(f"[done] examples in {time.perf_counter() - t_examples:.1f} s")
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
    # the wire's noise: every round of a compressed wire; the fmnist int8
    # runs and the gossip stacks beside the compiled phase's
    other_runs = {"uniforms_grouped": {
        "fmnist int8-kernel": fm["int8-kernel"]["launches"]["uniforms_grouped"],
        **{f"gossip {n}": gossip[n]["launches"].get("uniforms_grouped", 0)
           for n in GOSSIP_STACKS}}}
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
    fedavg_int8 = f"hub-H{HUB_H}-fedavg-int8-kernel"
    straggler_run = next(rec for name, rec in dyn.items() if "memoryless" in name)
    new_path_timing = {**straggler_run["b45_straggler_rounds"]["timing"],
                       "quantize_blockwise_grouped": hub["b2_timing"]}
    # the faulted memoryless wire and the EF wire under local updates (dynamics)
    masked_runs = {name: rec["launches"] for name, rec in dyn.items()
                   if name.startswith("gossip-")}
    other_runs.update({
        "quantize_blockwise_grouped": {
            "gossip-int8-kernel-ef": gossip["gossip-int8-kernel-ef"]["launches"][
                "quantize_blockwise_grouped"],
            **{f"schedules {n}": sched[n]["launches"]["quantize_blockwise_grouped"]
               for n in scheduled},
            f"hub {fedavg_int8}": hub[fedavg_int8]["launches"]["quantize_blockwise_grouped"]},
        "gossip_update_stacked_grouped": {
            "train-lm": lm["launches"]["gossip_update_stacked_grouped"]},
        **{kernel: {f"dynamics {name}": launches[kernel] for name, launches in masked_runs.items()}
           for kernel in ("masked_quantize_blockwise_grouped",
                          "masked_dequant_accumulate_grouped_")}})
    # the captured step (compiled): its first captured turn's run on each
    # configuration, counted by the replays
    for tag, rec in compiled.items():
        if tag == "phase_s":
            continue
        turn = next(r for r in rec["turns"] if r["mode"] == "captured")
        for kernel, n in turn["launches"].items():
            other_runs.setdefault(kernel, {})[f"compiled {tag}, captured"] = n
    # qwen2-0.5b served in bfloat16 (B.6's bfloat16 instances)
    other_runs.setdefault("flash_attention_fwd", {}).update({
        "serve-bf16 qwen2-0.5b, bfloat16": serve_bf16["launches"],
        "serve-bf16 card vs CPU, 2 layers": SERVE_BF16_PARITY[0]})
    # A.11's paths: deepseek-moe-16b served and trained, musicgen-medium
    # trained at S = 320, the smoke families trained, jamba's int8 engine
    for kernel, runs in {
            "flash_attention_fwd": {
                "serve-moe deepseek-moe-16b 2 layers": moe_serve["launches"],
                **{f"{tag} {what}": rec["launches"]["flash_attention_fwd"]
                   for tag, what, rec in _a11_train_runs(moe_train, frontend, smoke)}},
            "flash_attention_bwd": {
                f"{tag} {what}": rec["launches"]["flash_attention_bwd"]
                for tag, what, rec in _a11_train_runs(moe_train, frontend, smoke)},
            "gossip_update_stacked_grouped": {
                f"{tag} {what}": rec["launches"]["gossip_update_stacked_grouped"]
                for tag, what, rec in _a11_train_runs(moe_train, frontend, smoke)}}.items():
        other_runs.setdefault(kernel, {}).update(runs)
    engine_launches = {
        "quantize_blockwise_grouped": {
            "serve --engine --int8-kv": engine["wall-int8"]["launches"][
                "quantize_blockwise_grouped"],
            "gemma2 2 layers, int8": engine["cut-gemma2_27b"]["int8_launches"][
                "quantize_blockwise_grouped"],
            "jamba smoke --engine --int8-kv": smoke["jamba-engine-int8"]["launches"][
                "quantize_blockwise_grouped"]},
        "flash_attention_fwd": {
            "serve --engine": engine["wall-f32"]["launches"]["flash_attention_fwd"],
            "serve --engine --int8-kv": engine["wall-int8"]["launches"]["flash_attention_fwd"],
            "gemma2 2 layers": engine["cut-gemma2_27b"]["launches"]["flash_attention_fwd"]},
        "wkv6_scan": {"rwkv6-7b 2 layers": engine["cut-rwkv6_7b"]["launches"]["wkv6_scan"]}}
    lines = []
    for name, (source, replaces, _) in KERNELS.items():
        if name == "gossip_update":
            # one per-node call over every leaf of the fmnist MLP (node 0),
            # beside the six one-leaf calls in the same turns
            node = b1_nodes["node_call"]
            timing = {key: node[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "one_leaf_ms",
                                                 "one_leaf_device_ms")}
            timing["library_ms"] = None
            err, launches = b1[name]["max_abs_err"], path[name][name]
        elif name == "gossip_update_stacked":
            # one call per leaf: qwen2-0.5b's
            rows = [r for r in b1[name]["rows"] if r["group"] == "qwen2"]
            step = b1[name]["per_step"][rows[0]["group"]]
            timing = dict(ms=step["ms"], device_ms=step["device_ms"], plain_ms=step["plain_ms"],
                          bound_ms=step["bound_ms"],
                          bound_by="bytes" if {r["bound_by"] for r in rows} == {"bytes"}
                          else "operations", library_ms=None)
            timing["mlp"] = b1[name]["per_step"]["mlp"]  # and at the fmnist MLP's leaves
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
        elif name == "flash_attention_bwd":  # one call at qwen2-0.5b's folded training shape
            row = bwd["rows"][0]
            timing = timing_keys(row, FLASH_KEYS)
            err, launches = bwd["max_abs_err"], path[name][name]
        elif name == "wkv6_bwd":  # one call at rwkv6-7b's training shape, and at hd 16
            rows = rwkv_train[name]["rows"]
            timing = timing_keys(rows[0], FLASH_KEYS[:6])
            timing["hd16"] = timing_keys(rows[1], FLASH_KEYS[:6])
            err = rwkv_train[name]["max_abs_err"]
            launches = rwkv_train["full_width"]["launches"][name]
        elif name == "uniforms_grouped":
            # one call over the fmnist MLP's leaves (the path: a round of the
            # dense int8 EF wire), and over the CNN's and qwen2-0.5b's
            rec = kern[name]
            timing = dict(timing_keys(rec["per_step"]["mlp"], FLASH_KEYS[:6]),
                          cnn=rec["per_step"]["cnn"], qwen2=rec["per_step"]["qwen2"],
                          max_group_leaves=rec["max_group_leaves"])
            err = rec["max_abs_err"]
            launches = next(r for r in compiled["fmnist dense-int8-kernel-ef"]["turns"]
                            if r["mode"] == "captured")["launches"][name]
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
            timing = timing_keys(row, FLASH_KEYS if name == "flash_attention_fwd"
                                 else FLASH_KEYS[:6])
            err = serve_kern[name]["max_abs_err"]
            launches = (qwen if name == "flash_attention_fwd" else rwkv)["launches"]
        if name in ("wkv6_scan", "wkv6_bwd"):  # the training runs (train-rwkv)
            timing.setdefault("launches_other_runs", {}).update(
                {"train-rwkv card vs CPU": rwkv_train["parity"]["launches"][name],
                 "train --arch rwkv6_7b --smoke": rwkv_train["smoke_cli"]["launches"][name]})
        if name == "wkv6_scan":  # one call at the training shape
            row = rwkv_train[name]["rows"][0]
            timing["train"] = dict(timing_keys(row, FLASH_KEYS[:6]),
                                   launches=rwkv_train["full_width"]["launches"][name])
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # head dim 32 at the LM example's shape, and its launches there
            rows = (serve_kern[name] if name == "flash_attention_fwd" else bwd)["rows"]
            row = next(r for r in rows if r["case"] == HD32_CASE)
            timing["hd32"] = dict(timing_keys(row, FLASH_KEYS),
                                  max_abs_err=row["max_abs_err"],
                                  launches=examples["torch_train_lm_drdsgd --steps 5"][
                                      "launches"][name])
            # A.11's shapes: deepseek-moe-16b at hd 128, musicgen-medium at S = 320
            timing["a11"] = {r["case"]: dict(timing_keys(r, FLASH_KEYS),
                                             max_abs_err=r["max_abs_err"])
                             for r in rows if r["case"] in {c[0] for c in A11_FWD_CASES}}
        if name in serve_kern["domain"]:
            # the reference kernels' domain: bfloat16, hd 8 (and 32 for B.7),
            # its cases held, and one bfloat16 case timed
            timing["new_domain"] = serve_kern["domain"][name]
        if name in other_runs:  # the kernel's launches on the other runs that take it
            timing["launches_other_runs"] = other_runs[name]
        if name in new_path_timing:  # one call at a new path's shapes (K = 8)
            timing["new_path"] = new_path_timing[name]
        if name in engine["kernels"]:
            # the engine's shapes: B.2 at the KV writes (k and v of a layer in
            # one launch), B.6 / B.7 at the admission prefills; launches of
            # the engine's runs (the CLI's int8 run for B.2)
            rows = engine["kernels"][name]["rows"]
            timing["engine"] = dict(
                max_abs_err=engine["kernels"][name]["max_abs_err"],
                rows=[r for r in rows if "ms" in r],
                cases_held=len(rows),
                launches=engine_launches[name])
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
        # included), device_ms the kernels' own time under the profiler (device_source
        # "cuda events" where the profiler recorded no launch: see device_time)
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
