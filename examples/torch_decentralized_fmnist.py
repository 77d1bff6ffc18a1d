"""Paper reproduction scenario on the PyTorch port: Figs. 2 & 4 in one script.

Trains DR-DSGD and DSGD side by side on non-IID Fashion-MNIST-like data
(K=10 devices, Erdős–Rényi p=0.3, Metropolis mixing, eta=sqrt(K/T),
B≈sqrt(KT)) and prints the paper's three headline metrics — average accuracy,
worst-distribution accuracy, and the per-device accuracy STDEV — plus the
communication-efficiency ratio (rounds to a worst-accuracy target).

The port of ``examples/decentralized_fmnist.py``: the same constants,
printed lines and defaults, plus ``--device`` (the card by default; ``cpu``
runs the plain PyTorch versions).  Both runs go through
``repro_torch.core.run_segments``: batches are sampled and stacked on the
host one 50-step epoch at a time, ``trainer.run`` steps through them
eagerly (on the card one launch of the gossip-update kernel, B.1, per step)
and evaluation runs between the segments.  The weights come from the
port's own seeded init unless ``train`` is handed initial parameters.

Run:  PYTHONPATH=src python examples/torch_decentralized_fmnist.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import TrainerSpec, run_segments
from repro_torch.data import make_fmnist_like, pathological_noniid_partition
from repro_torch.models import mlp_apply, mlp_init
from repro_torch.models.paper_nets import make_classifier_loss

K, T = 10, 600
LR = (K / T) ** 0.5 * 2.3          # eta = sqrt(K/T), scaled for synthetic data
BATCH = int((K * T) ** 0.5)        # B = sqrt(KT)
EVAL_EVERY = 50


def train(robust: bool, mu: float = 3.0, seed: int = 0, params=None,
          device: str = "cuda") -> list[dict]:
    """One run; returns the evaluation after each segment.  ``params``: one
    node's initial MLP parameters (the port's flat dict), else the port's
    seeded init."""
    data = make_fmnist_like(n_train=4000, n_test=600, seed=0)
    fed = pathological_noniid_partition(data, K, shards_per_node=2, seed=seed)
    trainer = TrainerSpec(
        num_nodes=K, graph="erdos_renyi",
        graph_kwargs={"p": 0.3, "seed": seed},
        mu=mu, robust=robust, lr=LR, grad_clip=2.0, seed=seed, device=device,
    ).build(make_classifier_loss(mlp_apply), mlp_apply)
    if params is None:
        params = mlp_init(torch.Generator().manual_seed(seed))
    state = trainer.init(params)
    rng = np.random.default_rng(seed)
    x_nodes, y_nodes = fed.per_node_test_sets(n_per_node=200, seed=seed)
    history = []

    def on_segment(last_step, seg_state, _metrics):
        s = trainer.eval_local_distributions(seg_state, x_nodes, y_nodes)
        s["step"] = last_step
        history.append(s)

    run_segments(trainer, state, lambda step: fed.sample_batch(rng, BATCH),
                 T, EVAL_EVERY, on_segment)
    return history


def rounds_to(history, target):
    for h in history:
        if h["acc_worst_dist"] >= target:
            return h["step"]
    return None


def main(argv=None, params=None) -> tuple[list[dict], list[dict]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(f"K={K} T={T} eta={LR:.3f} B={BATCH}")
    dr = train(robust=True, params=params, device=args.device)
    ds = train(robust=False, params=params, device=args.device)
    f = dr[-1]
    g = ds[-1]
    print("\n              avg      worst    stdev")
    print(f"DR-DSGD     {f['acc_avg']:.3f}    {f['acc_worst_dist']:.3f}"
          f"    {f['acc_node_std']:.3f}")
    print(f"DSGD        {g['acc_avg']:.3f}    {g['acc_worst_dist']:.3f}"
          f"    {g['acc_node_std']:.3f}")
    target = g["acc_worst_dist"] * 0.95
    r_dr, r_ds = rounds_to(dr, target), rounds_to(ds, target)
    if r_dr and r_ds:
        print(f"\nrounds to worst-acc {target:.2f}: DR-DSGD={r_dr} "
              f"DSGD={r_ds} -> {r_ds / max(r_dr, 1):.1f}x fewer rounds")
    print("\nworst-distribution accuracy trajectory (step: DR vs DSGD):")
    for a, b in zip(dr, ds):
        print(f"  {a['step']:4d}: {a['acc_worst_dist']:.3f} vs "
              f"{b['acc_worst_dist']:.3f}")
    return dr, ds


if __name__ == "__main__":
    main()
