"""Time the train CLI of two checkouts in turns on one card, and break down
the per-step host cost of the telemetry sink in this checkout.

    python3 tests/train_cli_ab.py PARENT_ROOT [--turns A,B,B,A] [--workloads fmnist,qwen2]
    python3 tests/train_cli_ab.py --costs [--turns off,on,on,off] [--steps 20]

``PARENT_ROOT`` is another checkout of the repo (unpack one with
``git archive HEAD | tar -x -C build/parent``); ``.`` is this one.  For
each workload (``fmnist``: ``--paper fmnist``, 300 steps; ``qwen2``:
``--arch qwen2_0_5b --steps 20 --log-every 1``) every turn starts a fresh
process that imports the turn's ``repro_torch``, runs ``launch.train.main``
for 2 steps (kernel build and load, allocator warm-up) and then times one
full ``main(argv)`` to a synchronised end.  For qwen2 the line also gives
``ms_per_step`` as ``chip_smoke.py``'s train-lm phase computes it: the
median of the logged steps' wall-clock gaps from the third step on.
Prints the card's name and power limit, then one ``AB {...}`` JSON line
per run.  Compare two trees only within one call.

``--costs`` runs qwen2-0.5b at full width as the CLI's ``train_lm`` does
(K = 8 ring, lr 0.01, clip 1, batch 2 x 64 tokens, one step per segment)
in one process, through the trainer API with the sink off and on in
turns, and times each step's host phases: ``sample`` (the batch),
``issue`` (``trainer.run`` returning: the step's launches, with the tap's
ops and its queueing when on; of it, ``tap`` is the host time inside the
step's ``_tap_fields`` and the sink's ``tap_drain``), ``wait`` (the segment's one
synchronisation: run_segments' ``comm_bytes`` read when on, the first
``float`` of the parent's hook when off), ``hook`` (on: ``sink.last``'s
drain, one device-to-host copy, and the console line; off: the parent's
other ``float`` reads and its JSON line) and ``perf`` (on: the perf
record).  One ``COSTS {...}`` line per turn with each phase's median in
ms from the third step on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

WORKLOADS = {"fmnist": ["--paper", "fmnist"],
             "qwen2": ["--arch", "qwen2_0_5b", "--steps", "20", "--log-every", "1"]}
# the fields the parent's LM hook read with float(), one sync-free read each
PARENT_FIELDS = ("loss_mean", "loss_worst", "robust_objective", "comm_bytes", "disagreement")


def _no_tf32(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _one(tree: str, argv: list[str]) -> None:
    sys.path.insert(0, f"{tree}/src")
    import numpy as np
    import torch

    _no_tf32(torch)
    from repro_torch.launch import train

    train.main(argv + ["--steps", "2"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train.main(argv)
    torch.cuda.synchronize()
    rec = {"tree": tree, "argv": argv, "wall_s": time.perf_counter() - t0}
    if "--arch" in argv:
        history = out[2]
        rec["ms_per_step"] = 1e3 * float(np.median(np.diff([r["wall_s"] for r in history])[1:]))
    print("AB " + json.dumps(rec), flush=True)


def _costs(turns: list[str], steps: int) -> None:
    sys.path.insert(0, "src")
    import numpy as np
    import torch

    _no_tf32(torch)
    from repro_torch.configs import get_arch
    from repro_torch.core import TrainerSpec
    from repro_torch.core import drdsgd
    from repro_torch.data import make_node_token_streams
    from repro_torch.models import TransformerLM, make_lm_loss
    from repro_torch.obs import MetricsSink, format_train
    from repro_torch.obs.profiler import PhaseTimer

    cfg = get_arch("qwen2_0_5b")
    model = TransformerLM(cfg)
    spec = TrainerSpec(num_nodes=8, lr=0.01, grad_clip=1.0, graph="ring", device="cuda")
    loss_fn = make_lm_loss(model)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    for turn in turns:
        sink = MetricsSink() if turn == "on" else None
        trainer = spec.build(loss_fn, obs=sink)
        streams = make_node_token_streams(spec.num_nodes, cfg.vocab, seed=0)
        timer = PhaseTimer()
        box = [trainer.init(params)]
        times: dict[str, list[float]] = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            times.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out

        def tapped(fn):
            def wrapper(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    tap_ms[0] += 1e3 * (time.perf_counter() - t0)
            return wrapper

        tap_ms = [0.0]
        tap_fields = drdsgd._tap_fields
        if sink is not None:
            drdsgd._tap_fields = tapped(tap_fields)
            sink.tap_drain = tapped(sink.tap_drain)
        torch.cuda.synchronize()
        for step in range(steps):
            tap_ms[0] = 0.0
            t_step = time.perf_counter()
            batch = timed("sample", lambda: (np.stack(
                [s.next_batch(2, 64) for s in streams])[None],))
            state, ms = timed("issue", lambda: trainer.run(box.pop(), batch))
            if sink is not None:
                wire = timed("wait", lambda: float(ms["comm_bytes"].sum()))
                timed("hook", lambda: print(format_train(dict(sink.last("train")),
                                                         compressed=False), file=sys.stderr))
                timer.phases = {"run": 1e-3 * sum(times[k][-1] for k in ("issue", "wait"))}
                timed("perf", lambda: sink.log("perf", step, **timer.rollup(
                    steps=1, wire_bytes=wire)))
            else:
                timed("wait", lambda: float(ms[PARENT_FIELDS[0]][-1]))
                timed("hook", lambda: print(json.dumps(
                    {k: float(ms[k][-1]) for k in PARENT_FIELDS}), file=sys.stderr))
            box.append(state)
            del state, ms
            times.setdefault("step", []).append(1e3 * (time.perf_counter() - t_step))
            if sink is not None:
                times.setdefault("tap", []).append(tap_ms[0])
        drdsgd._tap_fields = tap_fields
        del box, trainer
        torch.cuda.empty_cache()
        print("COSTS " + json.dumps({"sink": turn, "steps": steps, "median_ms": {
            k: float(np.median(v[2:])) for k, v in times.items()}}), flush=True)


def _smi() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          end="", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        _one(sys.argv[2], sys.argv[3:])
        return 0
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--turns", default=None,
                    help="A = the parent, B = this checkout (default A,B,B,A); with "
                         "--costs, off and on (default off,on,on,off)")
    ap.add_argument("--workloads", default="fmnist,qwen2")
    ap.add_argument("--costs", action="store_true")
    ap.add_argument("--steps", type=int, default=20, help="steps per --costs turn")
    args = ap.parse_args()
    _smi()
    if args.costs:
        _costs((args.turns or "off,on,on,off").split(","), args.steps)
        return 0
    if not args.parent:
        ap.error("give PARENT_ROOT, or --costs")
    trees = {"A": args.parent, "B": "."}
    for name in args.workloads.split(","):
        for turn in (args.turns or "A,B,B,A").split(","):
            out = subprocess.run([sys.executable, __file__, "--one", trees[turn],
                                  *WORKLOADS[name]],
                                 capture_output=True, text=True, check=True).stdout
            print("".join(line for line in out.splitlines(True) if line.startswith("AB ")),
                  end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
