"""The CIFAR static int8 EF gossip run of a checkout, twice, with cuDNN
held deterministic (without it, cuDNN's convolution backward moves the
losses between runs).

    python tests/pin_cifar.py ROOT

ROOT is the checkout to measure (its ``chip_smoke.py`` and package are
imported).  Prints one ``PINCIFAR`` line per run.  Needs a CUDA device.
"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.comm import CompressionConfig
from repro_torch.core import TrainerSpec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
for rep in range(2):
    rec = cs._gossip_cifar(TrainerSpec, CompressionConfig)
    print("PINCIFAR " + json.dumps({k: rec[k] for k in ("loss_step0", "loss_last", "loss_worst_max",
                                                        "ms_per_step", "launches")}), flush=True)
