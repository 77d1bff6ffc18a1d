"""The pins of ``chip_smoke.py``'s noise-drawing stacks, from a wire that
shares no round code with the one the smoke runs.

Each stack trains with the eager step (``jit=False``) through the rounds
as they were before the wire was grouped: leaf by leaf through the
one-leaf kernels (the copies of those rounds that
``tests/test_torch_quant_gossip_grouped.py`` keeps: ``_old_dense_round``,
one-leaf B.2; ``_old_static_gossip_round`` with the grouped encode hidden,
one-leaf B.2 and B.3; ``_old_quantized_gossip``, one-leaf B.4 and B.5 per
matching; ``_old_gossip_round`` and ``_old_rebase_round``, one-leaf B.4
and B.5), with each leaf's noise drawn alone by the plain Philox
(``ref.uniforms_grouped_ref`` on the card, through the wire's ``uniforms``
hook) and the dropout stacks' W_r from the plain Philox coins (the
schedule's draw, ``repro_torch.dynamics.coins.draw``, replaced by
``ref.uniforms_grouped_ref`` at the same key, streams and round).  The stacks: the dense int8 EF fmnist stack, the static int8 EF
gossip stack, the memoryless dropout and the EF-B4 masked gossip stacks,
each printing (loss_step300, acc_worst_dist, acc_avg); and the CIFAR
static EF gossip run (20 steps, cuDNN deterministic) printing (loss_step0,
loss_last, loss_worst_max).  Each one-leaf run twice, so that a difference
between runs shows, then the same stack once through the grouped wire
with the Philox kernel (the smoke's wire, eager here), for comparison.

    python tests/pin_noise.py [ROOT [STACK ...]]

ROOT is the checkout to measure (default: this one); STACKs (default: all
five) pick the runs (``cifar`` names the CIFAR run).  Prints ``PINNOISE``
lines, one per run, with the path and the launches.  Needs a CUDA device
and nvcc.
"""
import json
import sys
import types
from pathlib import Path

root = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parents[1])
sys.path[:0] = [root + "/src", root, root + "/tests"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import test_torch_quant_gossip_grouped as old  # noqa: E402
from repro_torch.comm import CompressionConfig  # noqa: E402
from repro_torch.core import TrainerSpec  # noqa: E402
from repro_torch.core.consensus import make_dense_mixer  # noqa: E402
from repro_torch.dynamics import coins  # noqa: E402
from repro_torch.graphs import build_graph, metropolis_weights  # noqa: E402
from repro_torch.kernels.quant_gossip import ref as qref  # noqa: E402

picked = set(sys.argv[2:])
kernel_coins = coins.draw


def plain_coins(seed, round, shapes, streams, divisors=None):
    """The coins drawn by the plain Philox (the schedule's draw)."""
    like = [torch.empty(shape, device=round.device) for shape in shapes]
    return qref.uniforms_grouped_ref(like, coins.coin_key(seed), round, leaves=list(streams),
                                     divisors=divisors)


def plain_noise(key: int):
    """The wire's ``uniforms`` hook: each leaf's noise drawn alone by the
    plain Philox at (key, round, leaf, matching) on the card."""

    def hook(rounds, leaf, *rest):
        *matching, shape = rest
        r = torch.full((), int(rounds), dtype=torch.int64, device="cuda")
        return qref.uniforms_grouped_ref([torch.empty(shape, device="cuda")], key, r,
                                         matching=matching[0] if matching else 0,
                                         leaves=[leaf])[0]

    return hook


def one_leaf(mixer, stack: str):
    """``mixer`` with its rounds replaced by the one-leaf rounds and its
    noise by :func:`plain_noise`."""
    mixer.wire._uniforms = plain_noise(int(mixer.wire.compression.seed))
    bind = lambda fn: types.MethodType(fn, mixer)  # noqa: E731
    if stack == "dense-int8-kernel":
        mixer._dense_round = bind(old._old_dense_round)
    elif stack == "gossip-int8-kernel-ef":
        mixer.wire.compressor = cs._Without(mixer.wire.compressor, "compress_grouped")
        mixer._gossip_round = bind(old._old_static_gossip_round)
    elif stack == "dropout0.2-int8-kernel-memoryless":
        mixer._quantized_gossip = bind(old._old_quantized_gossip)
    elif stack == "dropout0.2-int8-kernel-ef-B4":
        mixer._gossip_round = bind(old._old_gossip_round)
        mixer._rebase_round = bind(old._old_rebase_round)
    else:
        raise ValueError(stack)
    return mixer


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(cs.nvidia_smi(), flush=True)
cs.phase_build()
exp, fed, batches, params = cs._fmnist()
w = metropolis_weights(build_graph("erdos_renyi", cs.K, p=exp.p, seed=exp.seed))
decomp = cs._matchings(exp.p, exp.seed)
cfg = CompressionConfig(kind="int8", use_kernel=True)
stacks = ["dense-int8-kernel", "gossip-int8-kernel-ef", "dropout0.2-int8-kernel-memoryless",
          "dropout0.2-int8-kernel-ef-B4"]
for stack in stacks:
    if picked and stack not in picked:
        continue
    for path in ("one-leaf", "one-leaf", "grouped"):
        coins.draw = plain_coins if path == "one-leaf" else kernel_coins
        if stack == "dense-int8-kernel":
            mixer = make_dense_mixer(w, compression=cfg, device="cuda")
        else:
            mixer = cs._gossip_mixer(stack, decomp, w, exp.seed, CompressionConfig)
        if path == "one-leaf":
            mixer = one_leaf(mixer, stack)
        rec, _, _ = cs._fmnist_run("pin", stack,
                                   cs._spec(TrainerSpec, exp, mixer.compression, jit=False),
                                   exp, fed, batches, params, mixer=mixer)
        print("PINNOISE " + json.dumps({"stack": stack, "path": path, "pin": [
            rec["loss_step300"], rec["acc_worst_dist"], rec["acc_avg"]],
            "launches": rec["launches"]}), flush=True)

coins.draw = kernel_coins
# the CIFAR run builds its mixer through cs._gossip_mixer and checks the
# grouped wire's launches: the one-leaf runs swap the mixer and record them
grouped_mixer, check_counts, seen = cs._gossip_mixer, cs.check_counts, {}
for path in ("one-leaf", "one-leaf", "grouped") if not picked or "cifar" in picked else ():
    if path == "one-leaf":
        cs._gossip_mixer = lambda stack, *a, **kw: one_leaf(grouped_mixer(stack, *a, **kw), stack)
        cs.check_counts = lambda tag, counts, want: seen.update(
            {n: c[0] for n, c in counts.items() if c[0]})
    try:
        rec = cs._gossip_cifar(TrainerSpec, CompressionConfig, jit=False, pinned=False)
    finally:
        cs._gossip_mixer, cs.check_counts = grouped_mixer, check_counts
    print("PINNOISE " + json.dumps({"stack": "cifar gossip-int8-kernel-ef", "path": path, "pin": [
        rec["loss_step0"], rec["loss_last"], rec["loss_worst_max"]],
        "launches": seen if path == "one-leaf" else rec["launches"]}), flush=True)
    seen = {}
