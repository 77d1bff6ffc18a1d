"""Where the telemetry sink's cost per step goes, on the card: the fmnist pair
of ``chip_smoke.py``'s obs phase (benchmarks/bench_trainer.py's
configuration: K = 10 ER(0.3), mu 6, lr 0.1, clip 2, batch 32, 200 steps in
segments of 50 through ``run_segments``) split into its two parts.

    python3 tests/sink_overhead_probe.py [--rounds 10]

Four kinds of pass (``chip_smoke.SINK_KINDS``), timed by
``chip_smoke.sink_passes`` in rounds that rotate which kind runs first:

* ``off``  — no sink;
* ``on``   — the sink in the trainer (the step's tap) and in run_segments
  (one synchronisation, one drain and one perf record per segment);
* ``tap``  — the sink in the trainer only (the tap; one drain at the end);
* ``hooks`` — the sink in run_segments only (the per-segment work, no tap).

Prints the card's name and power limit, one ``PROBE {...}`` line per
round and a ``PROBE_SUMMARY {...}`` line: each kind's best and median pass,
their difference from ``off`` in percent, and the median over the rounds
of each round's difference from ``off``.  The parameters of every kind
must be bit-equal.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sink_overhead_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import TrainerSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    cs.phase_build()
    exp, fed, _, params = cs._fmnist()
    kinds = cs.SINK_KINDS
    run = cs.sink_passes(TrainerSpec, exp, fed, params, kinds, args.rounds)
    walls = run["wall_s"]
    for rnd, order in enumerate(run["order"]):
        print("PROBE " + json.dumps({"round": rnd, "order": order,
                                     "wall_s": {k: walls[k][rnd] for k in kinds}}), flush=True)
    best = {k: min(v) for k, v in walls.items()}
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print("PROBE_SUMMARY " + json.dumps({
        "config": cs.SINK_BENCH, "rounds": args.rounds, "best_s": best, "median_s": med,
        "best_vs_off_pct": {k: 100.0 * (best[k] / best["off"] - 1.0) for k in kinds},
        "median_vs_off_pct": {k: 100.0 * (med[k] / med["off"] - 1.0) for k in kinds},
        "paired_vs_off_pct": {k: float(np.median([100.0 * (w / o - 1.0) for w, o in
                                                  zip(walls[k], walls["off"])]))
                              for k in kinds},
        "params_bitwise": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
