"""Decentralized (DR-)DSGD training driver — the paper's models and the LMs
on one GPU (the port of ``repro.launch.train``).

``--paper``: the paper's MLP (FMNIST stand-in) or CNN (CIFAR10 stand-in) on
K nodes with non-IID shards, an Erdős–Rényi graph with Metropolis mixing,
η = √(K/T) and B = √(KT), the robust per-node scale (``--dsgd`` turns it
off) and the consensus wire of ``--compress``.  Every ``--log-every`` steps
it prints the paper's fairness metrics on each node's local test
distribution.

``--arch``: an assigned LM (``--smoke`` for its reduced config) on K = 8
nodes over a ring with Metropolis mixing, lr 0.01, each node's gradient
clipped at global norm 1, batch 2 per node of ``--seq-len`` 64 tokens from
each node's own synthetic token stream; every ``--log-every`` steps a
``train`` line with the step's loss and consensus metrics.  The step is
plain SGD with dense mixing, so it runs through the fused gossip update
(B.1); the attention forward and backward run through B.6.  RWKV models
train on the CPU only (B.7 has no backward yet).

Weights come from the port's own seeded init.  ``--ckpt-dir`` (ROADMAP
A.10), ``--log-dir`` and ``--profile`` (A.13) raise as not ported.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist
  PYTHONPATH=src python -m repro_torch.launch.train --paper cifar --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist \
      --compress int8 --compress-schedule adaptive
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist \
      --compress topk --compress-ratio 0.02 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --smoke \
      --steps 3 --nodes 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import cifar_default, fmnist_default, get_arch
from repro_torch.core import TrainerSpec, run_segments
from repro_torch.data import (
    make_cifar_like,
    make_fmnist_like,
    make_node_token_streams,
    pathological_noniid_partition,
)
from repro_torch.models import (
    TransformerLM,
    cnn_apply,
    cnn_init,
    make_classifier_loss,
    make_lm_loss,
    mlp_apply,
    mlp_init,
)

# flag -> (its attribute, the slice that ports it)
_UNPORTED = {"--ckpt-dir": ("ckpt_dir", "the checkpoint slice (ROADMAP A.10)"),
             "--log-dir": ("log_dir", "the tooling slice (ROADMAP A.13)"),
             "--profile": ("profile", "the tooling slice (ROADMAP A.13)")}
_TRAIN_FIELDS = ("loss_mean", "loss_worst", "robust_objective", "comm_bytes", "disagreement")


def train_lm(args):
    """The LM stack; returns (trainer, final state, the train records)."""
    steps = args.steps or 50
    bsz = args.batch_per_node or 2
    cfg = get_arch(args.arch, smoke=args.smoke)
    model = TransformerLM(cfg)
    spec = TrainerSpec.from_args(args, num_nodes=8, lr=0.01, grad_clip=1.0, graph="ring")
    k = spec.num_nodes
    trainer = spec.build(make_lm_loss(model))
    print(json.dumps(dict(kind="meta", arch=cfg.name, params=model.num_params(), nodes=k,
                          rho=round(trainer.rho, 4), mu=spec.mu, robust=spec.robust,
                          compress=args.compress, topology=spec.topology, steps=steps,
                          batch=bsz, seq_len=args.seq_len, device=str(trainer.device))),
          flush=True)
    params = model.init(torch.Generator(trainer.device).manual_seed(args.seed))
    streams = make_node_token_streams(k, cfg.vocab, seed=args.seed)
    history = []

    def sample_batch(step):
        return (np.stack([s.next_batch(bsz, args.seq_len) for s in streams]),)

    def on_segment(step, seg_state, ms):
        rec = dict(kind="train", step=step, wall_s=round(time.perf_counter() - t0, 3),
                   **{key: float(ms[key][-1]) for key in _TRAIN_FIELDS})
        history.append(rec)
        print(json.dumps(rec), flush=True)

    # hand the initial state over without keeping it: at full width each
    # node-stacked copy of the parameters is K x 2 GB
    t0 = time.perf_counter()
    state = run_segments(trainer, trainer.init(params), sample_batch, steps, args.log_every,
                         on_segment)
    return trainer, state, history


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
    ap.add_argument("--arch", default=None, help="assigned architecture id")
    ap.add_argument("--paper", default=None, choices=["fmnist", "cifar"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-per-node", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None, help="not ported yet")
    ap.add_argument("--log-dir", default=None, help="not ported yet")
    ap.add_argument("--profile", action="store_true", help="not ported yet")
    TrainerSpec.add_cli_args(ap)
    args = ap.parse_args(argv)
    for flag, (dest, later) in _UNPORTED.items():
        if getattr(args, dest):
            raise NotImplementedError(f"{flag} is not ported yet; it waits for {later}")
    if args.paper:
        return train_paper(args)
    if args.arch:
        return train_lm(args)
    raise SystemExit("provide --arch <id> or --paper fmnist|cifar")


if __name__ == "__main__":
    main()
