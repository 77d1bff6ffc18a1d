"""Does the port's fmnist EF-B4 dropout stack follow the reference for 300 steps?

The stack: DR-DSGD at ``fmnist_default()`` (K = 10, ER(p = 0.3) seed 0,
Metropolis W, mu = 6, lr = sqrt(K/T), B = 55, the paper's MLP) over the
gossip lowering with dropout p = 0.2 (``DropoutSchedule`` seed 0) and the
int8 error-feedback wire re-based every 4 rounds — the reference's
``--topology dropout --drop-p 0.2 --ef-rebase-every 4`` with int8 on the
gossip lowering, ``chip_smoke.py``'s ``dropout0.2-int8-kernel-ef-B4``.

The reference runs in a subprocess with 10 host devices (its quantizer is
the Pallas kernel in interpret mode).  It records, per round, the W_r its
schedule drew (the link mask is W_r's off-diagonal support) and the key the
wire's uniforms come from, the per-step metrics and the final parameters.
The port then replays the run on the CPU: the same initial weights (the
reference's ``mlp_init(PRNGKey(0))``), the same batches (``repro.data``
and the port's copy of it draw the same ones), W_r through a
``ScheduledTopology`` over a replayed schedule, and the reference's
uniforms, recomputed from each round's key.  It prints one JSON line: both
runs' ``acc_worst_dist``, ``acc_node_std`` and ``acc_avg`` on each node's
local test distribution, the final parameters' largest difference against
4 times the largest quantization step (the 20-step parity tolerance of
``chip_smoke.py``), and the largest relative difference of the per-step
metrics (against 1e-3).

  PYTHONPATH=src python tests/ef_b4_parity.py [--steps 300]

Takes ~10 minutes on 8 CPU cores.  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

K = 10
DROP_P, REBASE_EVERY = 0.2, 4
PARAM_STEPS = 4.0    # params within 4 quantization steps (chip_smoke.py's parity)
METRIC_RTOL = 1e-3

REFERENCE = r'''
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.comm import CompressionConfig
from repro.configs import fmnist_default
from repro.core import DecentralizedTrainer, RobustConfig
from repro.data import make_fmnist_like, pathological_noniid_partition
from repro.dynamics import DropoutSchedule, DynamicGossipMixer
from repro.graphs import build_graph, metropolis_weights
from repro.models import paper_nets

OUT, STEPS, K = sys.argv[1], int(sys.argv[2]), 10
exp = fmnist_default()
mesh = jax.make_mesh((K,), ("data",))
w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))
sched = DropoutSchedule(w, 0.2, seed=exp.seed)
fed = pathological_noniid_partition(make_fmnist_like(), K, seed=exp.seed)
rng = np.random.default_rng(exp.seed)
batches = [fed.sample_batch(rng, exp.batch_size) for _ in range(STEPS)]
params = jax.tree.map(np.asarray, paper_nets.mlp_init(jax.random.PRNGKey(0)))
node = jax.tree.map(lambda x: np.broadcast_to(x[None], (K,) + x.shape), params)
cfg = CompressionConfig(kind="int8", use_kernel=True, interpret=True)
mixer = DynamicGossipMixer(sched, mesh, "data", jax.tree.map(lambda _: P("data"), node),
                           quantized=cfg, ef_rebase_every=4)
trainer = DecentralizedTrainer(
    paper_nets.make_classifier_loss(paper_nets.mlp_apply), paper_nets.mlp_apply,
    num_nodes=K, graph="erdos_renyi", graph_kwargs={"p": exp.p, "seed": exp.seed},
    robust=RobustConfig(mu=exp.mu), lr=exp.lr, mixer=mixer, compression=cfg,
    metrics_disagreement=False)


def put(x):
    if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1 and x.shape[0] == K:
        return jax.device_put(x, NamedSharding(mesh, P("data")))
    return jax.device_put(x, NamedSharding(mesh, P()))


state = jax.tree.map(put, trainer.init(params))
round_w = jax.jit(mixer._round_topology_w)
out = {}
for name, leaf in zip(("fc0/b", "fc0/w", "fc1/b", "fc1/w", "fc2/b", "fc2/w"),
                      jax.tree.leaves(params)):
    out[f"params0|{name}"] = leaf
for step in range(STEPS):
    out[f"s{step}|key"] = np.asarray(jax.random.key_data(state.comm.key)
                                      if jnp.issubdtype(state.comm.key.dtype,
                                                        jax.dtypes.prng_key)
                                      else state.comm.key)
    out[f"s{step}|w"] = np.asarray(round_w(state.comm.rounds))
    state, m = trainer.step(state, jax.tree.map(put, batches[step]))
    for key, v in m.items():
        out[f"s{step}|m|{key}"] = np.asarray(v)
for name, leaf in zip(("fc0/b", "fc0/w", "fc1/b", "fc1/w", "fc2/b", "fc2/w"),
                      jax.tree.leaves(state.params)):
    out[f"final|{name}"] = np.asarray(leaf)
np.savez(OUT, **out)
print("OK")
'''


def run_reference(steps: int, path: Path) -> dict:
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={K}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path), str(steps)], env=env,
                         capture_output=True, text=True, timeout=3600)
    if out.returncode != 0:
        raise RuntimeError(f"reference run failed:\n{out.stdout}\n{out.stderr[-4000:]}")
    with np.load(path) as npz:
        return dict(npz)


def accuracies(apply_fn, params: dict, x_nodes, y_nodes) -> dict:
    """Each node's model on its own test distribution (the reference's
    ``eval_local_distributions``)."""
    accs = np.array([float(np.mean(np.argmax(apply_fn(params, i, x_nodes[i]), -1) == y_nodes[i]))
                     for i in range(K)])
    return {"acc_avg": float(accs.mean()), "acc_worst_dist": float(accs.min()),
            "acc_node_std": float(accs.std())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
    from repro.configs import fmnist_default
    from repro.data import make_fmnist_like, pathological_noniid_partition
    from repro.models import paper_nets as ref_nets
    from repro_torch.comm import CompressionConfig
    from repro_torch.core import DecentralizedTrainer, RobustConfig
    from repro_torch.dynamics import DynamicGossipMixer, TopologySchedule
    from repro_torch.graphs import build_graph, metropolis_weights
    from repro_torch.models import paper_nets as nets
    from repro_torch.utils.tree import unflatten

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        runs = run_reference(args.steps, Path(tmp) / "ref.npz")
    ref_s = time.time() - t0
    exp = fmnist_default()
    w = metropolis_weights(build_graph("erdos_renyi", K, p=exp.p, seed=exp.seed))

    class ReplaySchedule(TopologySchedule):
        """The reference run's W_r, round by round, on the CPU."""

        def __init__(self):
            self._w_np = np.asarray(w, np.float64)
            self.k = K
            self.device = torch.device("cpu")

        def round_weights(self, rounds):
            return torch.from_numpy(np.array(runs[f"s{rounds}|w"]))

        def base_weights(self):
            return self._w_np

    names = sorted(k.split("|")[1] for k in runs if k.startswith("params0|"))
    dims = tuple(int(np.prod(runs[f"params0|{n}"].shape)) for n in names)

    def _u(key, ds):
        _, sub = jax.random.split(key)
        node_ks = per_node_keys(sub, jnp.arange(K))
        return [_uniform_rows(fold_leaf(node_ks, i), d) for i, d in enumerate(ds)]

    ef_u = jax.jit(_u, static_argnums=1)
    cache: dict = {}

    def uniforms(rounds, leaf_idx, shape):
        if rounds not in cache:
            cache.clear()
            key = jnp.asarray(runs[f"s{rounds}|key"])
            cache[rounds] = [np.asarray(u) for u in ef_u(key, dims)]
        return cache[rounds][leaf_idx]

    cfg = CompressionConfig(kind="int8", use_kernel=True)
    mixer = DynamicGossipMixer(ReplaySchedule(), quantized=cfg, ef_rebase_every=REBASE_EVERY,
                               uniforms=uniforms)
    trainer = DecentralizedTrainer(
        nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply, num_nodes=K,
        graph="erdos_renyi", graph_kwargs={"p": exp.p, "seed": exp.seed},
        robust=RobustConfig(mu=exp.mu), lr=exp.lr, mixer=mixer, compression=cfg,
        device="cpu")
    state = trainer.init({n: torch.from_numpy(runs[f"params0|{n}"]) for n in names})
    fed = pathological_noniid_partition(make_fmnist_like(), K, seed=exp.seed)
    rng = np.random.default_rng(exp.seed)
    batches = [fed.sample_batch(rng, exp.batch_size) for _ in range(args.steps)]
    metric_rel, q_step, first_off = 0.0, 0.0, None
    for step in range(args.steps):
        q_step = max(q_step, max(float((state.params[n] - state.comm.hat[n]).abs().max())
                                 for n in names) / 127.0)
        state, m = trainer.step(state, batches[step])
        for key in (k.split("|")[2] for k in runs if k.startswith(f"s{step}|m|")):
            want = float(runs[f"s{step}|m|{key}"])
            rel = abs(float(m[key]) - want) / max(abs(want), 1e-30)
            metric_rel = max(metric_rel, rel)
            if first_off is None and rel > METRIC_RTOL:
                first_off = (step, key)
    port_s = time.time() - t0 - ref_s

    x_nodes, y_nodes = fed.per_node_test_sets(n_per_node=200, seed=exp.seed)
    final_ref = {n: runs[f"final|{n}"] for n in names}
    final_port = {n: state.params[n].numpy() for n in names}
    ref_acc = accuracies(lambda p, i, x: np.asarray(ref_nets.mlp_apply(
        jax.tree.map(lambda a: jnp.asarray(a[i]), unflatten(p)), jnp.asarray(x))),
        final_ref, x_nodes, y_nodes)
    port_stats = trainer.eval_local_distributions(state, x_nodes, y_nodes)
    port_acc = {k: port_stats[k] for k in ("acc_avg", "acc_worst_dist", "acc_node_std")}
    d_param = max(float(np.abs(final_port[n] - final_ref[n]).max()) for n in names)
    rec = {"steps": args.steps, "reference": ref_acc, "port": port_acc,
           "max_abs_param_diff": d_param, "max_quantization_step": q_step,
           "param_atol": PARAM_STEPS * q_step, "max_rel_metric_diff": metric_rel,
           "metric_rtol": METRIC_RTOL, "first_metric_past_rtol": first_off,
           "reference_s": round(ref_s, 1), "port_s": round(port_s, 1)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
