"""End-to-end driver on the PyTorch port: decentralized DR-DSGD training of a
transformer LM.

Eight nodes on a ring, each with its own token distribution (per-node Zipf
permutation => genuine distribution shift), train a qwen2-family decoder
with the robust exponential reweighting.  By default the smoke config is
widened to d_model 256 with 8 heads (head dim 32), 4 layers; ``--full-width``
is the 0.5B assigned config at K = 8, batch 4, seq 128 (one H100's memory;
see the README's port section for its measured peak).

The port of ``examples/train_lm_drdsgd.py``: the same flags, printed lines
and defaults, plus ``--device`` (the card by default; ``cpu`` runs the plain
PyTorch versions).  ``trainer.run`` steps eagerly through segments of 5
stacked steps, logging between them; on the card every attention layer of
every node runs the flash-attention kernel forward and backward (B.6) and
each step's SGD update and mix is one launch of the gossip-update kernel
(B.1).  The weights come from the port's own seeded init unless ``train``
is handed initial parameters.

Run:  PYTHONPATH=src python examples/torch_train_lm_drdsgd.py --steps 30 [--device cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import TrainerSpec
from repro_torch.data import make_node_token_streams
from repro_torch.device import expandable_segments
from repro_torch.models import TransformerLM, make_lm_loss


def model_for(full_width: bool) -> TransformerLM:
    cfg = get_arch("qwen2_0_5b", smoke=not full_width)
    if not full_width:
        # widen the smoke config into the ~10M range for a meaningful run
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=256, n_heads=8,
                                  n_kv_heads=2, d_ff=1024, vocab=2048)
    return TransformerLM(cfg)


def train(args, params=None) -> list[dict]:
    """The run; returns one record per logged segment (the printed line's
    metrics).  ``params``: one node's initial parameters (the port's flat
    dict), else the port's seeded init."""
    model = model_for(args.full_width)
    cfg = model.cfg

    trainer = TrainerSpec(
        num_nodes=args.nodes,
        graph="ring",
        mu=args.mu,
        lr=0.02,
        grad_clip=1.0,
        device=args.device,
    ).build(make_lm_loss(model))
    print(f"model={cfg.name} params={model.num_params():,} "
          f"nodes={args.nodes} ring rho={trainer.rho:.3f} mu={args.mu}")

    if params is None:
        params = model.init(torch.Generator(trainer.device).manual_seed(0))
    state = trainer.init(params)
    del params
    streams = make_node_token_streams(args.nodes, cfg.vocab, hetero=True)
    history = []

    t0 = time.time()
    # stack 5 steps of token batches per segment, log between segments
    for start in range(0, args.steps, 5):
        n = min(5, args.steps - start)
        toks = np.stack([
            np.stack([s.next_batch(args.batch_per_node, args.seq_len)
                      for s in streams])
            for _ in range(n)])
        state, ms = trainer.run(state, (toks,))
        step = start + n - 1
        rec = {key: float(ms[key][-1]) for key in (
            "loss_mean", "loss_worst", "robust_objective", "lambda_max", "disagreement")}
        history.append(dict(step=step, **rec))
        print(f"step {step:4d}  loss_mean={rec['loss_mean']:.4f}  "
              f"loss_worst={rec['loss_worst']:.4f}  "
              f"robust_obj={rec['robust_objective']:.4f}  "
              f"lambda_max={rec['lambda_max']:.3f}  "
              f"disagree={rec['disagreement']:.2e}")
    dt = time.time() - t0
    tokens = args.steps * args.nodes * args.batch_per_node * args.seq_len
    print(f"\n{tokens:,} tokens in {dt:.1f}s ({tokens / dt:,.0f} tok/s)")
    print("Worst-node loss should track mean loss closely: that is the "
          "DRO guarantee under per-node distribution shift.")
    return history


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--mu", type=float, default=6.0)
    ap.add_argument("--full-width", action="store_true",
                    help="use the full qwen2-0.5b config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, params=None) -> list[dict]:
    expandable_segments()  # the allocator's reserve at full width (repro_torch.device)
    return train(parse(argv), params)


if __name__ == "__main__":
    main()
