"""The captured step's memory on the card, in the allocator configuration
the process starts with: ``chip_smoke.py``'s compiled phase (fmnist
dense-none, K = 10, 300 steps, the unfused step's fmnist stacks, 100 steps
each, and qwen2-0.5b at full width and depth, K = 8, seq 64, 5 steps, and
with Nesterov momentum and the dense int8 EF wire; eager and captured
turns alternated, every check of the phase held).

    python3 tests/captured_memory_probe.py
    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:False python3 tests/captured_memory_probe.py

The first runs with PyTorch's expandable segments (``repro_torch.device.
expandable_segments``, as ``chip_smoke.py`` and the train CLI set them);
the second with the allocator a library caller gets by default.  Prints
the card's name and power limit, the allocator configuration, and one
``PROBE {...}`` line per turn: the configuration, the mode, ms per step,
peak allocated and reserved memory above the turn's start (GB) and the
peak in node-stacked parameter copies.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("captured_memory_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.device import expandable_segments

    expandable_segments()  # leaves a configuration the caller set
    import chip_smoke as cs
    from repro_torch.comm import CompressionConfig
    from repro_torch.core import TrainerSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    print(f"PYTORCH_CUDA_ALLOC_CONF={os.environ['PYTORCH_CUDA_ALLOC_CONF']}", flush=True)
    cs.phase_build()
    out = cs.phase_compiled(TrainerSpec, CompressionConfig)
    for tag, rec in out.items():
        if tag == "phase_s":
            continue
        for r in rec["turns"]:
            print("PROBE " + json.dumps(dict(
                config=tag, mode=r["mode"], ms_per_step=r["ms_per_step"],
                peak_allocated_gb=r["peak_memory_gb"], peak_reserved_gb=r["peak_reserved_gb"],
                peak_node_stacked_copies=r["peak_node_stacked_copies"],
                bitwise=r["bitwise_vs_first_eager"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
