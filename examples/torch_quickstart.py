"""Quickstart on the PyTorch port: distributionally robust decentralized
training in ~40 lines.

Ten devices on an Erdős–Rényi graph collaboratively train the paper's MLP
on pathologically non-IID Fashion-MNIST-like data, with the KL-DRO
exponential reweighting of DR-DSGD (Alg. 2). Compare against ``--dsgd``.

The port of ``examples/quickstart.py``: the same flags, defaults and
printed lines, plus ``--device`` (the card by default; ``cpu`` runs the
plain PyTorch versions).  ``trainer.run`` is an eager loop of train steps
(on the card each step's SGD update and dense mix is one launch of the
gossip-update kernel, B.1), chopped into ``--log-every`` epochs with the
evaluation hook between them.  The weights come from the port's own seeded
init unless ``train`` is handed initial parameters.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--dsgd] [--steps N] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import TrainerSpec
from repro_torch.data import make_fmnist_like, pathological_noniid_partition
from repro_torch.models import mlp_apply, mlp_init
from repro_torch.models.paper_nets import make_classifier_loss


def train(args, params=None) -> list[dict]:
    """The quickstart run; returns one record per epoch (the printed line's
    step, loss and accuracies).  ``params``: one node's initial MLP
    parameters (the port's flat dict), else the port's seeded init."""
    k, steps = 10, args.steps

    data = make_fmnist_like(n_train=4000, n_test=600)
    fed = pathological_noniid_partition(data, num_nodes=k, shards_per_node=2)

    trainer = TrainerSpec(
        num_nodes=k,
        graph="erdos_renyi",
        graph_kwargs={"p": 0.3},
        mu=3.0,
        robust=not args.dsgd,
        lr=0.18,
        grad_clip=2.0,
        device=args.device,
    ).build(make_classifier_loss(mlp_apply), mlp_apply)
    print(f"algo={'DSGD' if args.dsgd else 'DR-DSGD'}  K={k}  "
          f"graph rho={trainer.rho:.3f}")

    if params is None:
        params = mlp_init(torch.Generator().manual_seed(0))
    state = trainer.init(params)
    rng = np.random.default_rng(0)
    x_nodes, y_nodes = fed.per_node_test_sets(n_per_node=200)

    # stack the whole run along a leading time axis; run() steps through it
    # in log_every-sized epochs and calls back between them
    xb, yb = zip(*[fed.sample_batch(rng, 55) for _ in range(steps)])
    batches = (np.stack(xb), np.stack(yb))
    history = []

    def on_epoch(epoch, epoch_state, metrics):
        step = min((epoch + 1) * args.log_every, steps) - 1
        stats = trainer.eval_local_distributions(epoch_state, x_nodes, y_nodes)
        loss = float(metrics["loss_mean"][-1])
        history.append(dict(step=step, loss=loss, **stats))
        print(f"step {step:4d}  loss={loss:.3f}  "
              f"acc_avg={stats['acc_avg']:.3f}  "
              f"acc_worst={stats['acc_worst_dist']:.3f}  "
              f"node_std={stats['acc_node_std']:.3f}")

    trainer.run(state, batches, epoch_steps=args.log_every, on_epoch=on_epoch)
    return history


def main(argv=None, params=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dsgd", action="store_true", help="disable DR (baseline)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return train(ap.parse_args(argv), params)


if __name__ == "__main__":
    main()
