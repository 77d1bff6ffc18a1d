"""Decentralized (DR-)DSGD training driver — the paper's models on one GPU.

The port of the ``--paper`` path of ``repro.launch.train``: the paper's MLP
(FMNIST stand-in) or CNN (CIFAR10 stand-in) on K nodes with non-IID shards,
an Erdős–Rényi graph with Metropolis mixing, η = √(K/T) and B = √(KT), the
robust per-node scale (``--dsgd`` turns it off) and the consensus wire of
``--compress``.  Every ``--log-every`` steps it prints the paper's fairness
metrics on each node's local test distribution.  Weights come from the
port's own seeded init.  The LM path (``--arch``) is not ported yet.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist
  PYTHONPATH=src python -m repro_torch.launch.train --paper cifar --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist --steps 20 \
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import cifar_default, fmnist_default
from repro_torch.core import TrainerSpec, run_segments
from repro_torch.data import (
    make_cifar_like,
    make_fmnist_like,
    pathological_noniid_partition,
)
from repro_torch.models import (
    cnn_apply,
    cnn_init,
    make_classifier_loss,
    mlp_apply,
    mlp_init,
)


def train_paper(args):
    exp = fmnist_default() if args.paper == "fmnist" else cifar_default()
    steps = args.steps or exp.steps
    gen = torch.Generator().manual_seed(args.seed)
    if args.paper == "fmnist":
        ds, params, apply_fn = make_fmnist_like(), mlp_init(gen), mlp_apply
    else:
        ds, params, apply_fn = make_cifar_like(), cnn_init(gen), cnn_apply
    spec = TrainerSpec.from_args(
        args, num_nodes=exp.num_nodes, lr=exp.lr,
        graph="erdos_renyi", graph_kwargs={"p": exp.p, "seed": args.seed})
    k = spec.num_nodes
    fed = pathological_noniid_partition(ds, k, seed=args.seed)
    x_nodes, y_nodes = fed.per_node_test_sets(n_per_node=200, seed=args.seed)
    trainer = spec.build(make_classifier_loss(apply_fn), apply_fn)
    state = trainer.init(params)
    rng = np.random.default_rng(args.seed)
    bsz = args.batch_per_node or exp.batch_size
    print(json.dumps(dict(kind="meta", paper=args.paper, nodes=k, steps=steps,
                          batch=bsz, lr=spec.lr, mu=spec.mu, robust=spec.robust,
                          rho=round(trainer.rho, 4), compress=args.compress,
                          device=str(trainer.device))), flush=True)
    t0 = time.perf_counter()

    def on_segment(step, seg_state, ms):
        stats = trainer.eval_local_distributions(seg_state, x_nodes, y_nodes)
        print(json.dumps(dict(
            kind="eval", step=step, wall_s=round(time.perf_counter() - t0, 3),
            loss_mean=float(ms["loss_mean"][-1]),
            comm_bytes=float(ms["comm_bytes"][-1]),
            disagreement=float(ms["disagreement"][-1]),
            **{k: v for k, v in stats.items() if k != "acc_nodes"})), flush=True)

    return run_segments(trainer, state, lambda step: fed.sample_batch(rng, bsz),
                        steps, args.log_every, on_segment)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="assigned architecture id (not ported yet)")
    ap.add_argument("--paper", default=None, choices=["fmnist", "cifar"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-per-node", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    TrainerSpec.add_cli_args(ap)
    args = ap.parse_args(argv)
    if args.arch:
        raise NotImplementedError("--arch (the LM stack) is not ported yet; it "
                                  "waits for the LM slice")
    if not args.paper:
        raise SystemExit("provide --paper fmnist|cifar")
    train_paper(args)


if __name__ == "__main__":
    main()
