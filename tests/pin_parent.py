"""Pins of a checkout on the card: the fmnist metrics of the dense stacks
(uncompressed: the fused B.1 step; int8 EF: B.2) and of the static int8 EF
gossip stack, and the CIFAR gossip run's losses (each twice, so that a
difference between runs shows), and B.7's error and times at rwkv6-7b's
prefill, one step from a given state, hd 16 and w = 1e-6.

    python tests/pin_parent.py ROOT

ROOT is the checkout to measure (its ``chip_smoke.py`` and package are
imported), e.g. the parent commit unpacked under build/ with
``git archive HEAD | tar -x -C build/parent``.  Prints ``PINDENSE``,
``PIN``, ``PINCIFAR`` and ``PINWKV`` lines.  Needs a CUDA device and nvcc.
``tests/pin_cifar.py`` repeats the CIFAR run with cuDNN deterministic.
"""
import json, math, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.comm import CompressionConfig
from repro_torch.core import TrainerSpec
from repro_torch.graphs import build_graph, metropolis_weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(cs.nvidia_smi(), flush=True)
cs.phase_build()
exp, fed, batches, params = cs._fmnist()
keys = ("loss_step300", "acc_worst_dist", "acc_avg", "ms_per_step", "launches")
for wire, compress in (("none", "none"),
                       ("int8-kernel", CompressionConfig(kind="int8", use_kernel=True))):
    for rep in range(2):
        rec, _, _ = cs._fmnist_run("pin", f"dense-{wire}", cs._spec(TrainerSpec, exp, compress),
                                   exp, fed, batches, params)
        print("PINDENSE " + json.dumps({"wire": wire, **{k: rec[k] for k in keys}}), flush=True)
w = metropolis_weights(build_graph("erdos_renyi", cs.K, p=exp.p, seed=exp.seed))
decomp = cs._matchings(exp.p, exp.seed)
stack = "gossip-int8-kernel-ef"
for rep in range(2):
    mixer = cs._gossip_mixer(stack, decomp, w, exp.seed, CompressionConfig)
    rec, state, counts = cs._fmnist_run("pin", stack, cs._spec(TrainerSpec, exp, mixer.compression),
                                        exp, fed, batches, params, mixer=mixer)
    print("PIN " + json.dumps({k: rec[k] for k in keys}), flush=True)
for rep in range(2):
    print("PINCIFAR " + json.dumps(cs._gossip_cifar(TrainerSpec, CompressionConfig)), flush=True)

from repro_torch.kernels.rwkv6_scan import kernel as wk
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
gen = torch.Generator(device="cuda").manual_seed(4321)
for tag, b, h, t, hd, decay, given in (("rwkv6-7b prefill", 4, 64, 256, 64, "random", False),
                                       ("T = 1, given state", 4, 64, 1, 64, "random", True),
                                       ("hd 16", 4, 256, 256, 16, "random", False),
                                       ("w = 1e-6", 4, 64, 256, 64, "tiny", False)):
    r, k, v = (torch.randn((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
               for _ in range(3))
    if decay == "random":
        ww = torch.rand((b, t, h, hd), generator=gen, device="cuda").permute(0, 2, 1, 3)
    else:
        ww = torch.full((b, t, h, hd), 1e-6, device="cuda").permute(0, 2, 1, 3)
    u = 0.5 * torch.randn((h, hd), generator=gen, device="cuda")
    s0 = torch.randn((b, h, hd, hd), generator=gen, device="cuda") if given else None
    y, st = wk.wkv6_scan(r, k, v, ww, u, s0)
    yp, sp = wkv6_ref(r, k, v, ww, u, s0)
    torch.cuda.synchronize()
    err = float((y - yp).abs().max()) / float(yp.abs().max())
    ms = cs.cuda_ms(lambda: wk.wkv6_scan(r, k, v, ww, u, s0), iters=50)
    dev = cs.device_ms(lambda: wk.wkv6_scan(r, k, v, ww, u, s0), 20, cs.KERNELS["wkv6_scan"][2])
    print("PINWKV " + json.dumps(dict(case=tag, rel_err=err, ms=ms, device_ms=dev,
                                       bound_ms=cs.wkv6_bound(b, h, t, hd)[0])), flush=True)
