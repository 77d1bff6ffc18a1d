"""An fmnist stack's step of two checkouts, in turns on one card.

    python tests/memoryless_ab.py PARENT_ROOT [CHANGE_ROOT] [--stack STACK[,STACK...]]

Runs the fmnist configuration on one of ``chip_smoke.py``'s gossip stacks
(default ``dropout0.2-int8-kernel-memoryless``, the dropout-0.2 memoryless
int8 wire; ``gossip-int8-kernel-ef`` is the static int8 EF wire) or dense
stacks (``dense-none``: the fused B.1 step; ``dense-int8-kernel``: the int8
EF wire) from the checkout at PARENT_ROOT and from CHANGE_ROOT (default:
this checkout), for each stack given in the order parent, change, change,
parent, each in a process of its own that
imports that checkout's ``chip_smoke.py`` and package: 300 steps timed on
the host clock, ended by a synchronise (``_fmnist_run``: ms per step, the
launches, the final metrics), then ``phase_profile``'s 30 profiled steps
(device ops and busy share per step).  Prints one JSON line per run and the
card's name and power limit.  Needs a CUDA device; each checkout builds its
own kernels under its build/.
"""

import json
import subprocess
import sys
from pathlib import Path

STACK = "dropout0.2-int8-kernel-memoryless"

CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke as cs
from repro_torch.comm import CompressionConfig
from repro_torch.core import TrainerSpec
from repro_torch.graphs import build_graph, metropolis_weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
exp, fed, batches, params = cs._fmnist()
w = metropolis_weights(build_graph("erdos_renyi", cs.K, p=exp.p, seed=exp.seed))
if sys.argv[2].startswith("dense-"):
    mixer = None
    compress = "none" if sys.argv[2] == "dense-none" else CompressionConfig(kind="int8",
                                                                             use_kernel=True)
else:
    mixer = cs._gossip_mixer(sys.argv[2], cs._matchings(exp.p, exp.seed), w, exp.seed,
                             CompressionConfig)
    compress = mixer.compression
rec, _, _ = cs._fmnist_run("ab", sys.argv[2], cs._spec(TrainerSpec, exp, compress),
                           exp, fed, batches, params, mixer=mixer)
prof = cs.phase_profile(TrainerSpec, CompressionConfig)[sys.argv[2]]
keys = ("ms_per_step", "launches", "loss_step300", "acc_worst_dist", "acc_avg")
out = {k: rec[k] for k in keys}
out.update({k: prof[k] for k in ("ms_per_step_profiled", "device_busy_ms_per_step",
                                 "device_busy_share", "device_ops_per_step")})
print("AB " + json.dumps(out), flush=True)
"""


def main(argv) -> int:
    stack = STACK
    if "--stack" in argv:
        i = argv.index("--stack")
        stack = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = str(Path(argv[0]).resolve())
    change = str(Path(argv[1]).resolve() if len(argv) > 1 else Path(__file__).resolve().parents[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    for one in stack.split(","):
        for tag, root in (("parent", parent), ("change", change), ("change", change),
                          ("parent", parent)):
            proc = subprocess.run([sys.executable, "-c", CHILD, root, one], capture_output=True,
                                  text=True, timeout=900, cwd=root)
            lines = [ln[3:] for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
            if proc.returncode or not lines:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                raise RuntimeError(f"the {tag} run ({root}) failed: rc {proc.returncode}")
            print(json.dumps({"stack": one, "run": tag, "root": root,
                              **json.loads(lines[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
