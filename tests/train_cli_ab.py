"""Time the train CLI of two checkouts in turns on one card, and break down
the per-step host cost of the telemetry sink in this checkout.

    python3 tests/train_cli_ab.py PARENT_ROOT [--turns A,B,B,A] [--workloads fmnist,qwen2]
    python3 tests/train_cli_ab.py --costs [--turns off,on,sham,on,off,sham,...] [--steps 4]

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
in one process, through the trainer API, with one trainer per kind of
turn all stepping ONE state: the kinds interleave on the same trajectory
every ``--steps`` steps, so the host's drift over the run (measured on
the card's host: the numpy batch sampling alone slowed up to 4x within
one process) falls on every kind alike.  It times each step's host phases: ``sample`` (the
batch), ``issue`` (``trainer.run`` returning: the step's launches, with
the tap's queueing when on; of it, ``tap`` is the host time inside the
step's ``_tap_fields`` and the sink's ``tap_drain``), ``wait`` (the
step's one synchronisation: the ``comm_bytes`` read as ``run_segments``
makes it with a sink, the first ``float`` of the parent's hook without),
``hook`` (with a sink: ``sink.last``'s drain, one device-to-host copy,
and the console line; without: the parent's other ``float`` reads and
its JSON line) and ``perf`` (the perf record).  The kinds: ``off`` (no
sink), ``on`` (the sink), ``sham`` (the sink built into the trainer and
the per-step host work of ``on``, with the step's tap taken out: the
control that separates the tap from the sink's presence) or ``hooks``
(the per-step host work of ``on`` around a trainer without a sink).
Two warm-up steps and one profiled step of each kind come first.  One
``COSTS {...}`` line per turn
with each phase's median in ms, every step's ``issue``, the GC
collections (``gc.callbacks``; ``gc_in_issue`` is the GC time inside
``issue``), the allocator's ``num_alloc_retries``, ``num_device_alloc``
and ``num_device_free`` over the turn, and the host and device op counts
of the kind's profiled step; then one ``COSTS_SUMMARY {...}`` line: per
kind the median ``issue`` over all its turns' steps, and each kind's
difference from ``off`` in ms and percent.
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


MEM_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams")


def _costs(turns: list[str], steps: int) -> None:
    sys.path.insert(0, "src")
    import gc

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
    gc_box = {"t0": 0.0, "ms": 0.0, "n": [0, 0, 0]}

    def on_gc(phase, info):
        if phase == "start":
            gc_box["t0"] = time.perf_counter()
        else:
            gc_box["ms"] += 1e3 * (time.perf_counter() - gc_box["t0"])
            gc_box["n"][info["generation"]] += 1

    gc.callbacks.append(on_gc)
    tap_fields = drdsgd._tap_fields
    now = {"kind": None, "tap_ms": 0.0}

    def tapped(fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                now["tap_ms"] += 1e3 * (time.perf_counter() - t0)
        return wrapper

    # the sham turns' step runs without its tap; every other kind's is timed
    timed_tap = tapped(tap_fields)
    drdsgd._tap_fields = lambda *a, **k: {} if now["kind"] == "sham" else timed_tap(*a, **k)
    # one trainer per kind, all stepping ONE state, so the kinds interleave
    # on the same trajectory: on: the sink; sham: the sink built in and the
    # per-step host work of on, the tap taken out; hooks: that host work
    # around a trainer without a sink
    kinds = {}
    for kind in dict.fromkeys(turns):
        sink = None if kind == "off" else MetricsSink()
        trainer = spec.build(loss_fn, obs=None if kind == "hooks" else sink)
        if sink is not None:
            sink.tap_drain = tapped(sink.tap_drain)
        kinds[kind] = (trainer, sink, PhaseTimer())
    streams = make_node_token_streams(spec.num_nodes, cfg.vocab, seed=0)
    box = [next(iter(kinds.values()))[0].init(params)]

    def one_step(kind, times):
        trainer, sink, timer = kinds[kind]
        now["kind"], now["tap_ms"] = kind, 0.0
        gc_box["ms"] = 0.0

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            times.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out

        t_step = time.perf_counter()
        batch = timed("sample", lambda: (np.stack(
            [s.next_batch(2, 64) for s in streams])[None],))
        state, ms = timed("issue", lambda: trainer.run(box.pop(), batch))
        times.setdefault("gc_in_issue", []).append(gc_box["ms"])
        if sink is not None:
            wire = timed("wait", lambda: float(ms["comm_bytes"].sum()))
            rec = sink.last("train")
            timed("hook", lambda: print(format_train(dict(rec), compressed=False)
                                        if rec else "-", file=sys.stderr))
            timer.phases = {"run": 1e-3 * (times["issue"][-1] + times["wait"][-1])}
            timed("perf", lambda: sink.log("perf", 0, **timer.rollup(steps=1, wire_bytes=wire)))
            times.setdefault("tap", []).append(now["tap_ms"])
        else:
            timed("wait", lambda: float(ms[PARENT_FIELDS[0]][-1]))
            timed("hook", lambda: print(json.dumps(
                {k: float(ms[k][-1]) for k in PARENT_FIELDS}), file=sys.stderr))
        box.append(state)
        del state, ms
        times.setdefault("step", []).append(1e3 * (time.perf_counter() - t_step))

    # warm-up: two steps of each kind, then one profiled step of each (its
    # host and device op counts), none of them in the medians
    profiled = {}
    for kind in kinds:
        for _ in range(2):
            one_step(kind, {})
    for kind in kinds:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            one_step(kind, {})
            torch.cuda.synchronize()
        evs = prof.events()
        kern = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
        profiled[kind] = {"cpu_ops": sum(1 for e in evs
                                         if e.device_type == torch.autograd.DeviceType.CPU),
                          "device_ops": len(kern),
                          "device_ms": 1e-3 * sum(e.device_time for e in kern)}
        del prof, evs, kern
    gc.collect()
    pooled: dict[str, list[float]] = {}
    for turn in turns:
        times: dict[str, list[float]] = {}
        gc_box["n"] = [0, 0, 0]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_stats()
        for _ in range(steps):
            one_step(turn, times)
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_stats()
        print("COSTS " + json.dumps({
            "sink": turn, "steps": steps,
            "median_ms": {k: float(np.median(v)) for k, v in times.items()},
            "issue_ms": [round(v, 2) for v in times["issue"]],
            "gc": {"collections": gc_box["n"]},
            "memory": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in MEM_KEYS},
            "profiled_step": profiled[turn]}), flush=True)
        pooled.setdefault(turn, []).extend(times["issue"])
    drdsgd._tap_fields = tap_fields
    gc.callbacks.remove(on_gc)
    medians = {kind: float(np.median(v)) for kind, v in pooled.items()}
    base = medians.get("off")
    print("COSTS_SUMMARY " + json.dumps({
        "issue_median_ms": medians, "steps": {k: len(v) for k, v in pooled.items()},
        "vs_off_ms": {k: m - base for k, m in medians.items()} if base else None,
        "vs_off_pct": {k: 100.0 * (m / base - 1.0) for k, m in medians.items()}
        if base else None}), flush=True)


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
                         "--costs, kinds among off, on, sham, hooks "
                         "(default off,on,on,off)")
    ap.add_argument("--workloads", default="fmnist,qwen2")
    ap.add_argument("--costs", action="store_true")
    ap.add_argument("--steps", type=int, default=4, help="steps per --costs turn")
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
