"""Does the paper's CIFAR configuration stay finite without a gradient clip?

Runs DR-DSGD on the paper's CNN at ``cifar_default()`` (K = 10, ER(p = 0.5)
seed 0, Metropolis W, mu = 6, lr = sqrt(K/T), B = 55) for 50 steps, once per
noise seed of the consensus wire (``CompressionConfig.seed``).  The data,
the batches and the initial weights (the port's seeded ``cnn_init``) are the
same in every run and in both frameworks; only the stochastic-rounding noise
changes with the seed.  Prints one JSON line per run: the first step whose
mean loss is not finite (null if none), the largest worst-node loss, the
largest robust scale and the last mean loss.

  PYTHONPATH=src python tests/cifar_stability.py --framework ref
  PYTHONPATH=src python tests/cifar_stability.py --framework port --device cpu
  PYTHONPATH=src python tests/cifar_stability.py --framework port --device cuda

``--framework ref`` runs the JAX reference on the CPU (its quantizer through
the plain jnp version the Pallas kernel is tested against); ``port`` imports
no JAX.  The reference, the port's CPU generator and its CUDA generator draw
different uniforms from one seed, so the runs compare how often the
configuration diverges over noise seeds, not trajectories:
``tests/test_torch_cifar.py`` holds the CNN's trajectories against each other
on injected noise.  ``--wire none`` is the uncompressed control and
``--grad-clip 2`` the clip of the repo's CIFAR benchmark.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, value in flat.items():
        mod, leaf = name.split("/")
        out.setdefault(mod, {})[leaf] = value
    return out


def _trainer(framework: str, wire: str, seed: int, clip, device: str):
    from repro_torch.configs import cifar_default

    exp = cifar_default()
    kw = dict(num_nodes=exp.num_nodes, graph="erdos_renyi",
              graph_kwargs={"p": exp.p, "seed": exp.seed}, lr=exp.lr, grad_clip=clip)
    if framework == "ref":
        from repro.comm import CompressionConfig
        from repro.core import DecentralizedTrainer, RobustConfig
        from repro.models import paper_nets
    else:
        from repro_torch.comm import CompressionConfig
        from repro_torch.core import DecentralizedTrainer, RobustConfig
        from repro_torch.models import paper_nets
        kw["device"] = device
    cfg = CompressionConfig(kind="int8", use_kernel=True, seed=seed) if wire != "none" else None
    return DecentralizedTrainer(paper_nets.make_classifier_loss(paper_nets.cnn_apply),
                                paper_nets.cnn_apply, robust=RobustConfig(mu=exp.mu),
                                compression=cfg, **kw)


def run(framework: str, wire: str, seed: int, steps: int, clip, device: str) -> dict:
    import torch

    from repro_torch import convert
    from repro_torch.configs import cifar_default
    from repro_torch.data import make_cifar_like, pathological_noniid_partition
    from repro_torch.models import cnn_init

    exp = cifar_default()
    fed = pathological_noniid_partition(make_cifar_like(), exp.num_nodes, seed=exp.seed)
    rng = np.random.default_rng(exp.seed)
    batches = [fed.sample_batch(rng, exp.batch_size) for _ in range(steps)]
    weights = convert.params_to_numpy(cnn_init(torch.Generator().manual_seed(exp.seed)))
    trainer = _trainer(framework, wire, seed, clip, device)
    state = trainer.init(_nested(weights) if framework == "ref"
                         else convert.params_from_numpy(weights, device=device))
    nonfinite, worst, scale_max, last = None, 0.0, 0.0, float("nan")
    t0 = time.perf_counter()
    for step, batch in enumerate(batches):
        state, m = trainer.step(state, batch)
        last = float(m["loss_mean"])
        if not math.isfinite(last):
            nonfinite = step
            break
        worst = max(worst, float(m["loss_worst"]))
        scale_max = max(scale_max, float(m["scale_max"]))
    return dict(framework=framework, device=device if framework == "port" else "cpu",
                wire=wire, noise_seed=seed, grad_clip=clip, steps=steps,
                first_nonfinite_step=nonfinite, max_loss_worst=worst,
                max_scale=scale_max, last_loss_mean=last,
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--framework", choices=("ref", "port"), required=True)
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--wire", choices=("int8-kernel", "none"), default="int8-kernel")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--grad-clip", type=float, default=None)
    args = ap.parse_args(argv)
    if args.framework == "port":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    diverged = 0
    for seed in args.seeds:
        rec = run(args.framework, args.wire, seed, args.steps, args.grad_clip, args.device)
        diverged += rec["first_nonfinite_step"] is not None
        print(json.dumps(rec), flush=True)
    print(json.dumps(dict(framework=args.framework, wire=args.wire, grad_clip=args.grad_clip,
                          runs=len(args.seeds), diverged=diverged)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
