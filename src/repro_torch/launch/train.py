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
(B.1); the attention forward and backward run through B.6, the RWKV time
mix's WKV recurrence through B.7 and its backward kernel; the MoE dispatch
and the Mamba scan are plain PyTorch.  The stub frontends (pixtral,
musicgen) get fresh (K, B, P, D) embeddings each step, drawn as the
reference draws them (``0.02 * standard_normal`` from ``default_rng(seed)``).

Dynamic graphs (``repro_torch.dynamics``) on either path: ``--topology
dropout --drop-p 0.2`` trains over per-round link failures; ``--local-updates
H`` runs H local steps per consensus round and ``--gradient-tracking`` adds
the drift correction; ``--straggler-p``/``--outage-p``/``--outage-len``
inject node faults (``--straggler-skips-compute``: down nodes lose their
gradient too); ``--topology hub`` is the federated server average (FedAvg
with ``--local-updates``, SCAFFOLD with ``--gradient-tracking``);
``--mix-every N`` mixes every N-th step only.

Weights come from the port's own seeded init.  ``--ckpt-dir DIR`` saves
the full final state (parameters and ``CommState``) with
``repro_torch.checkpoint.save_train_state`` at ``DIR/step_<steps>``;
``restore_train_state(DIR, device=...)`` reads it back.

The first line says how the step runs: ``step: captured`` where the
trainer replays its step from CUDA graphs (``jit=True`` on a stack
``capture_declined`` keeps: any optimizer, any ``--topology`` (static,
round-robin, dropout, geometric, the hub) with or without faults, any
``--compress`` codec and ``--compress-schedule``, ``--local-updates``
with or without ``--gradient-tracking``, ``--mix-every``, one graph per
branch the host chooses; no telemetry tap, no sanitizer, a loss that
batches its nodes), else ``step: eager (<why>)``.

Telemetry (``repro_torch.obs``): every run streams through a
:class:`~repro_torch.obs.MetricsSink` — with ``--log-dir`` the train
step's tap delivers one ``train`` record per optimizer step (scalar
metrics; per-node losses, DR weights and histogram counts every
``--tap-vectors-every`` steps; the tap keeps the step eager), without it
the CLI logs each segment's last step's metrics as its ``train``
record (the step then runs captured where it can); the eval hook writes
the paper's fairness metrics as ``eval`` records, and ``run_segments``
rolls up wall-clock phase timings as ``perf`` records.  The console lines
are formatters over those same records; ``--log-dir`` also writes them as
schema-versioned JSONL (``python -m
repro_torch.obs.schema`` validates; ``python -m repro_torch.obs report
<log-dir>`` renders the fairness/comm summary and replays the run's fault
events on its device), and ``--profile`` wraps the run in
``torch.profiler`` and writes a Chrome trace under ``--log-dir`` (phases
carry ``obs:...`` ranges).  ``--sanitize`` stages the in-step invariant
checks (``repro_torch.analysis.sanitize``): a violation raises at the end
of its segment, naming the check and the step; the trajectory is the same
bits with the flag off.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist \
      --log-dir runs/fmnist --profile --sanitize
  PYTHONPATH=src python -m repro_torch.launch.train --paper cifar --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist \
      --compress int8 --compress-schedule adaptive
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist \
      --compress topk --compress-ratio 0.02 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist --nodes 8 \
      --graph ring --topology dropout --drop-p 0.2 --local-updates 4 \
      --gradient-tracking --straggler-p 0.1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --paper fmnist --nodes 8 \
      --topology hub --local-updates 4 --gradient-tracking
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_7b --smoke --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --smoke \
      --steps 3 --nodes 4 --device cpu --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_train_state
from repro_torch.configs import cifar_default, fmnist_default, get_arch
from repro_torch.core import TrainerSpec, add_obs_cli_args, run_segments
from repro_torch.device import expandable_segments
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
from repro_torch.obs import MetricsSink, format_eval, format_meta, format_train, profile


def _dynamics_meta(spec) -> dict:
    """The dynamics fields of the meta record (the reference's, so a run's
    fault events replay from its config)."""
    return dict(topology=spec.topology, local_updates=spec.local_updates,
                gradient_tracking=spec.gradient_tracking, mix_every=spec.mix_every,
                seed=spec.seed, drop_p=spec.drop_p, straggler_p=spec.straggler_p,
                outage_p=spec.outage_p, outage_len=spec.outage_len,
                straggler_skips_compute=spec.straggler_skips_compute,
                ef_rebase_every=spec.ef_rebase_every,
                ef_rebase_threshold=spec.ef_rebase_threshold)


def _tap(args, sink: MetricsSink):
    """The trainer's sink: the sink where its records go to ``--log-dir``,
    else None (no tap in the step; :func:`_train_record` logs the console's
    records)."""
    return sink if args.log_dir else None


def _step_line(trainer) -> str:
    """How the trainer's step runs: captured, or eager and why."""
    why = trainer.capture_declined
    return "step: captured" if why is None else f"step: eager ({why})"


def _train_record(trainer, sink: MetricsSink, step: int, ms: dict) -> dict:
    """The segment's last ``train`` record: the tap's where the trainer
    taps, else the segment's last step's metrics, logged here (one
    device-to-host copy)."""
    if trainer.obs is not None:
        return dict(sink.last("train"))
    vals = torch.stack([v[-1] for v in ms.values()]).tolist()
    return dict(sink.log("train", step, **dict(zip(ms, vals))))


def _run(args, trainer, params, sample_batch, steps: int, on_segment, sink: MetricsSink):
    """``run_segments`` from ``trainer.init(params)`` with the perf rollup,
    under ``--profile``.  The initial state is handed over without a name
    here, so run_segments frees it after the first step (at LM widths a
    node-stacked copy of the parameters is K x 2 GB)."""
    with profile(args.log_dir, enabled=args.profile) as prof:
        state = run_segments(trainer, trainer.init(params), sample_batch, steps,
                             args.log_every, on_segment, obs=sink)
        sink.barrier()
    if prof.trace_path:
        print(f"profiler trace: {prof.trace_path}", flush=True)
    return state


def train_lm(args, sink: MetricsSink):
    """The LM stack; returns (trainer, final state, the train records)."""
    steps = args.steps or 50
    bsz = args.batch_per_node or 2
    cfg = get_arch(args.arch, smoke=args.smoke)
    model = TransformerLM(cfg)
    spec = TrainerSpec.from_args(args, num_nodes=8, lr=0.01, grad_clip=1.0, graph="ring")
    k = spec.num_nodes
    trainer = spec.build(make_lm_loss(model), obs=_tap(args, sink))
    print(_step_line(trainer), flush=True)
    print(format_meta(sink.log(
        "meta", 0, arch=cfg.name, params=model.num_params(), nodes=k,
        rho=round(trainer.rho, 4), mu=spec.mu, robust=spec.robust, compress=args.compress,
        steps=steps, batch=bsz, seq_len=args.seq_len, sanitize=spec.sanitize,
        device=str(trainer.device), **_dynamics_meta(spec))), flush=True)
    params = model.init(torch.Generator(trainer.device).manual_seed(args.seed))
    streams = make_node_token_streams(k, cfg.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prefix = cfg.frontend_len if cfg.frontend != "token" else 0
    history = []

    def sample_batch(step):
        toks = np.stack([s.next_batch(bsz, args.seq_len) for s in streams])
        if not prefix:
            return (toks,)
        # the stub frontends' (K, B, P, D) embeddings, drawn as the reference draws them
        emb = rng.standard_normal((k, bsz, prefix, cfg.d_model)).astype(np.float32) * 0.02
        return toks, emb

    compressed = trainer.compression is not None

    def on_segment(step, seg_state, ms):
        # the console line and the history entry are the segment's last
        # train record (the step's tap's, with --log-dir)
        rec = _train_record(trainer, sink, step, ms)
        rec["wall_s"] = time.perf_counter() - t0
        history.append(rec)
        print(format_train(rec, compressed=compressed), flush=True)

    t0 = time.perf_counter()
    state = _run(args, trainer, params, sample_batch, steps, on_segment, sink)
    _save(args, steps, state)
    return trainer, state, history


def train_paper(args, sink: MetricsSink):
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
    trainer = spec.build(make_classifier_loss(apply_fn), apply_fn, obs=_tap(args, sink))
    print(_step_line(trainer), flush=True)
    rng = np.random.default_rng(args.seed)
    bsz = args.batch_per_node or exp.batch_size
    print(format_meta(sink.log(
        "meta", 0, paper=args.paper, nodes=k, steps=steps, batch=bsz, lr=spec.lr, mu=spec.mu,
        robust=spec.robust, rho=round(trainer.rho, 4), compress=args.compress,
        sanitize=spec.sanitize, device=str(trainer.device), **_dynamics_meta(spec))),
        flush=True)

    def on_segment(step, seg_state, ms):
        # the paper's fairness metrics (worst-distribution accuracy, per-device
        # STDEV) into the stream, with the DR-weight snapshot of the newest
        # train record that carries it (the vectors are decimated)
        stats = trainer.eval_local_distributions(seg_state, x_nodes, y_nodes)
        train_rec = sink.last_with("train", "dr_weights")
        rec = sink.log("eval", step, loss_mean=float(ms["loss_mean"][-1]),
                       comm_bytes=float(ms["comm_bytes"][-1]),
                       dr_weights=(train_rec or {}).get("dr_weights"), **stats)
        print(format_eval(rec), flush=True)

    state = _run(args, trainer, params, lambda step: fed.sample_batch(rng, bsz), steps,
                 on_segment, sink)
    _save(args, steps, state)
    return state


def _save(args, steps: int, state) -> None:
    """The full final state, CommState included, under ``--ckpt-dir``."""
    if args.ckpt_dir:
        save_train_state(args.ckpt_dir, steps, state)
        print(f"checkpoint saved to {args.ckpt_dir}", flush=True)


def main(argv=None):
    expandable_segments()  # before any CUDA allocation (repro_torch.device)
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the final train state (parameters and CommState) here")
    add_obs_cli_args(ap)
    TrainerSpec.add_cli_args(ap)
    args = ap.parse_args(argv)
    if not (args.paper or args.arch):
        raise SystemExit("provide --arch <id> or --paper fmnist|cifar")
    with MetricsSink(args.log_dir, vector_every=args.tap_vectors_every) as sink:
        out = train_paper(args, sink) if args.paper else train_lm(args, sink)
        if sink.path:
            print(f"telemetry: {sink.path}", flush=True)
    return out


if __name__ == "__main__":
    main()
