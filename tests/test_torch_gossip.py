"""The port's gossip lowering against live runs of the reference's.

The reference's gossip stacks need one device per node, so one module-scoped
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the
pattern of tests/test_comm.py:232-237) runs them on an 8-node ring and an
8-node Erdős–Rényi graph: uncompressed static and dynamic gossip, the
static EF ``CompressedGossipMixer`` (int8 kernel, Pallas in interpret
mode), the memoryless masked ``DynamicGossipMixer`` under dropout 0.2, and
the EF ``DynamicCompressedGossipMixer`` under dropout 0.2 with re-base
period B = 1, B = 4 and an adaptive threshold; then 10 DR-DSGD steps of a
narrow MLP on the EF B = 4 stack.  It writes every round's inputs and
outputs, its W_r and its stochastic-rounding uniforms (recomputed from the
round's key exactly as the reference derives them) to an npz, gathered to
numpy before any numpy math (jax 0.9 refuses a gather from an array sharded
over the mesh).

The port replays each round on the CPU with the reference's W_r (through
:class:`ReplaySchedule`, defined here) and uniforms (through the wires'
``uniforms`` hooks), starting every round from the reference's inputs as
tests/test_torch_comm.py does.  Tolerances: θ, θ̂ and ``hat_mix`` at rtol
1e-6, atol 1e-6 (the payload is exact, so only float32 rounding remains:
the reference's Pallas kernels run as a fused multiply-add on the CPU, the
port's as a multiply then an add, tests/test_torch_quant_gossip.py);
``wire_bits`` and ``bytes_per_round`` exact.  The trainer's trajectory runs
without re-syncing and is held leaf by leaf within its own quantization
steps, as tests/test_torch_trainer.py holds the dense int8 wire.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.consensus import make_dense_mixer as ref_make_dense_mixer
from repro.graphs import build_graph, metropolis_weights
from repro_torch import convert
from repro_torch.comm import CompressedGossipMixer, CompressionConfig
from repro_torch.core import DecentralizedTrainer, RobustConfig
from repro_torch.core.consensus import make_dense_mixer, make_gossip_mixer
from repro_torch.dynamics import DynamicGossipMixer, TopologySchedule
from repro_torch.graphs import permutation_decomposition
from repro_torch.models import paper_nets as nets

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
K = 8
GRAPHS = {"ring": ("ring", {}), "er": ("erdos_renyi", {"p": 0.4, "seed": 3})}
STACKS = ["static-none", "static-ef", "dyn-none", "dyn-memoryless", "dyn-ef-b1",
          "dyn-ef-b4", "dyn-ef-adaptive"]
CFG = dict(kind="int8", use_kernel=True, block_d=16, seed=3)
WIRE_STEPS = 8      # trainer: per-leaf atol, in quantization steps
EARLY_ROUNDS = 2    # rounds before a floor flip feeds back into other leaves
EARLY_SHARE = 0.01  # share of a leaf's entries allowed past 1 % of a step then

SCRIPT = r'''
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.comm import CompressionConfig
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.comm.mixers import CompressedGossipMixer
from repro.core import DecentralizedTrainer, RobustConfig
from repro.core.consensus import make_gossip_mixer
from repro.data import make_fmnist_like, pathological_noniid_partition
from repro.dynamics import DropoutSchedule, DynamicGossipMixer
from repro.graphs import build_graph, metropolis_weights, permutation_decomposition
from repro.models import paper_nets

OUT = sys.argv[1]
K, ROUNDS, BLOCK_D = 8, 4, 16
SHAPES = {"a": {"w": (8, 8)}, "c": {"w": (3, 3, 2, 5)}}
GRAPHS = {"ring": ("ring", {}), "er": ("erdos_renyi", {"p": 0.4, "seed": 3})}
mesh = jax.make_mesh((K,), ("data",))
out = {}


def put(tree):
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))),
                        tree)



def host(tree):
    return {f"{m}/{n}": np.asarray(v) for m, leaves in tree.items() for n, v in leaves.items()}


def save(prefix, tree):
    for name, v in host(tree).items():
        out[f"{prefix}|{name}"] = v


def ef_uniforms(key, leaves):
    """The dense and EF gossip rounds' noise: split the carried key, fold
    the node id, then the leaf index (repro/comm/composed.py:542-563)."""
    return [np.asarray(u) for u in _ef_u(key, tuple(x.size // K for x in leaves))]


def _ef_u_impl(key, ds):
    _, sub = jax.random.split(key)
    node_ks = per_node_keys(sub, jnp.arange(K))
    return [_uniform_rows(fold_leaf(node_ks, i), d) for i, d in enumerate(ds)]


def _masked_u_impl(key, ds, n_match):
    _, sub = jax.random.split(key)
    nodes = jnp.arange(K)
    out = []
    for i, d in enumerate(ds):
        node_ks = jax.vmap(lambda n: jax.random.fold_in(jax.random.fold_in(sub, i), n))(nodes)
        out.append(jnp.stack([jax.vmap(lambda kk: jax.random.uniform(
            jax.random.fold_in(kk, m), (1, d), jnp.float32)[0])(node_ks)
            for m in range(n_match)]))
    return out


_ef_u = jax.jit(_ef_u_impl, static_argnums=1)
_masked_u = jax.jit(_masked_u_impl, static_argnums=(1, 2))


def masked_uniforms(key, leaves, n_match):
    """The memoryless masked wire's noise: per (leaf, node, matching)
    (repro/comm/composed.py:458-474)."""
    return [np.asarray(u) for u in _masked_u(key, tuple(x.size // K for x in leaves), n_match)]


rng = np.random.default_rng(0)
theta0 = {m: {n: rng.standard_normal((K,) + s).astype(np.float32) for n, s in leaves.items()}
          for m, leaves in SHAPES.items()}
specs = jax.tree.map(lambda _: P("data"), theta0)
for gname, (kind, kw) in GRAPHS.items():
    w = metropolis_weights(build_graph(kind, K, **kw))
    decomp = permutation_decomposition(w)
    sched = DropoutSchedule(w, 0.2, seed=5)
    cfg = dict(kind="int8", use_kernel=True, interpret=True, block_d=BLOCK_D, seed=3)
    stacks = {
        "static-none": make_gossip_mixer(decomp, mesh, "data", specs),
        "static-ef": CompressedGossipMixer(decomp, mesh, "data", specs,
                                           CompressionConfig(**cfg)),
        "dyn-none": DynamicGossipMixer(sched, mesh, "data", specs),
        "dyn-memoryless": DynamicGossipMixer(
            sched, mesh, "data", specs,
            quantized=CompressionConfig(**cfg, error_feedback=False)),
        "dyn-ef-b1": DynamicGossipMixer(sched, mesh, "data", specs,
                                        quantized=CompressionConfig(**cfg), ef_rebase_every=1),
        "dyn-ef-b4": DynamicGossipMixer(sched, mesh, "data", specs,
                                        quantized=CompressionConfig(**cfg), ef_rebase_every=4),
        "dyn-ef-adaptive": DynamicGossipMixer(sched, mesh, "data", specs,
                                              quantized=CompressionConfig(**cfg),
                                              ef_rebase_threshold=0.3),
    }
    for sname, mixer in stacks.items():
        tag = f"{gname}/{sname}"
        call = jax.jit(lambda t, s, mixer=mixer: mixer(t, s))
        round_w = jax.jit(mixer._round_topology_w) if hasattr(mixer, "_round_topology_w") \
            else None
        theta = put(theta0)
        state = mixer.init_state(theta0)
        out[f"{tag}|bytes_per_round"] = np.int64(mixer.bytes_per_round(theta0))
        for r in range(ROUNDS):
            pre = f"{tag}|r{r}"
            leaves = jax.tree.leaves(theta)
            save(f"{pre}|in_theta", theta)
            if state.hat != ():
                save(f"{pre}|in_hat", state.hat)
            if state.hat_mix != ():
                save(f"{pre}|in_hat_mix", state.hat_mix)
            if round_w is not None:
                out[f"{pre}|w"] = np.asarray(round_w(state.rounds))
            if isinstance(state.ef_rounds, jax.Array):
                out[f"{pre}|in_ef_rounds"] = np.asarray(state.ef_rounds)
            if sname == "dyn-memoryless":
                for i, u in enumerate(masked_uniforms(state.key, leaves, len(mixer.perms))):
                    out[f"{pre}|u|{i}"] = u
            elif mixer.compression is not None:
                for i, u in enumerate(ef_uniforms(state.key, leaves)):
                    out[f"{pre}|u|{i}"] = u
            theta, state = call(theta, state)
            save(f"{pre}|out_theta", theta)
            if state.hat != ():
                save(f"{pre}|out_hat", state.hat)
            if state.hat_mix != ():
                save(f"{pre}|out_hat_mix", state.hat_mix)
            out[f"{pre}|wire_bits"] = np.asarray(state.wire_bits)
            out[f"{pre}|res_norm"] = np.asarray(state.res_norm)
            if isinstance(state.ef_drift, jax.Array):
                out[f"{pre}|ef_drift"] = np.asarray(state.ef_drift)

# -- a 10-step DR-DSGD run on the EF B = 4 dropout gossip stack, narrow MLP --
STEPS, B, LR = 10, 8, 0.1
w = metropolis_weights(build_graph("erdos_renyi", K, p=0.4, seed=3))
sched = DropoutSchedule(w, 0.2, seed=5)
fed = pathological_noniid_partition(make_fmnist_like(n_train=400, n_test=50), K, seed=0)
rng = np.random.default_rng(1)
params = {"fc0": {"w": (0.05 * rng.standard_normal((784, 12))).astype(np.float32),
                  "b": np.zeros(12, np.float32)},
          "fc1": {"w": (0.3 * rng.standard_normal((12, 10))).astype(np.float32),
                  "b": np.zeros(10, np.float32)}}
node_params = jax.tree.map(lambda x: np.broadcast_to(x[None], (K,) + x.shape), params)
cfg = CompressionConfig(kind="int8", use_kernel=True, interpret=True, seed=7)
mixer = DynamicGossipMixer(sched, mesh, "data", jax.tree.map(lambda _: P("data"), node_params),
                           quantized=cfg, ef_rebase_every=4)
trainer = DecentralizedTrainer(
    paper_nets.make_classifier_loss(paper_nets.mlp_apply), paper_nets.mlp_apply,
    num_nodes=K, graph="erdos_renyi", graph_kwargs={"p": 0.4, "seed": 3},
    robust=RobustConfig(mu=6.0), lr=LR, mixer=mixer, compression=cfg,
    metrics_disagreement=False)


def put_state(state):
    def _put(x):
        if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1 and x.shape[0] == K:
            return jax.device_put(x, NamedSharding(mesh, P("data")))
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree.map(_put, state)


state = put_state(trainer.init(params))
round_w = jax.jit(mixer._round_topology_w)
save("trainer|params0", params)
for step in range(STEPS):
    x, y = fed.sample_batch(rng, B)
    out[f"trainer|s{step}|x"], out[f"trainer|s{step}|y"] = x, y
    leaves = jax.tree.leaves(state.params)
    for i, u in enumerate(ef_uniforms(state.comm.key, leaves)):
        out[f"trainer|s{step}|u|{i}"] = u
    out[f"trainer|s{step}|w"] = np.asarray(round_w(state.comm.rounds))
    save(f"trainer|s{step}|in_hat", state.comm.hat)
    state, m = trainer.step(state, put((x, y)))
    save(f"trainer|s{step}|params", state.params)
    save(f"trainer|s{step}|hat", state.comm.hat)
    for key, v in m.items():
        out[f"trainer|s{step}|m|{key}"] = np.asarray(v)
np.savez(OUT, **out)
print("OK")
'''


class ReplaySchedule(TopologySchedule):
    """The reference run's W_r, round by round, on the CPU."""

    def __init__(self, w_base, ws):
        self._w_np = np.asarray(w_base, np.float64)
        self.k = self._w_np.shape[0]
        self.device = torch.device("cpu")
        self.ws = ws

    def round_weights(self, rounds):
        return torch.from_numpy(np.array(self.ws[rounds]))

    def base_weights(self):
        return self._w_np


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """Run the reference once (see the module docstring); {key: array}."""
    path = tmp_path_factory.mktemp("ref_gossip") / "runs.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    with np.load(path) as npz:
        return dict(npz)


def _tree(runs, prefix):
    names = sorted(k[len(prefix) + 1:] for k in runs if k.startswith(prefix + "|"))
    return {n: torch.from_numpy(np.array(runs[f"{prefix}|{n}"])) for n in names}


def _w(graph):
    kind, kw = GRAPHS[graph]
    return metropolis_weights(build_graph(kind, K, **kw))


def _port_mixer(runs, graph, stack):
    tag = f"{graph}/{stack}"
    w = _w(graph)

    def uniforms(rounds, leaf_idx, shape):
        return runs[f"{tag}|r{rounds}|u|{leaf_idx}"]

    def masked_uniforms(rounds, leaf_idx, matching, shape):
        return runs[f"{tag}|r{rounds}|u|{leaf_idx}"][matching]

    if stack.startswith("static"):
        decomp = permutation_decomposition(w)
        if stack == "static-none":
            return make_gossip_mixer(decomp, device="cpu")
        return CompressedGossipMixer(decomp, CompressionConfig(**CFG), device="cpu",
                                     uniforms=uniforms)
    ws = {r: runs[f"{tag}|r{r}|w"] for r in range(_rounds(runs, tag))}
    sched = ReplaySchedule(w, ws)
    if stack == "dyn-none":
        return DynamicGossipMixer(sched)
    if stack == "dyn-memoryless":
        return DynamicGossipMixer(sched, quantized=CompressionConfig(**CFG, error_feedback=False),
                                  uniforms=masked_uniforms)
    clock = {"dyn-ef-b1": dict(ef_rebase_every=1), "dyn-ef-b4": dict(ef_rebase_every=4),
             "dyn-ef-adaptive": dict(ef_rebase_threshold=0.3)}[stack]
    return DynamicGossipMixer(sched, quantized=CompressionConfig(**CFG), uniforms=uniforms,
                              **clock)


def _rounds(runs, tag):
    return len({k.split("|")[1] for k in runs if k.startswith(tag + "|r")})


def _close(got: dict, want: dict, what):
    assert list(got) == list(want), what
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_uncompressed_static_gossip_equals_dense(graph):
    """Gossip, the port's dense round and the reference's dense round on the
    same θ (no subprocess needed)."""
    w = _w(graph)
    rng = np.random.default_rng(1)
    theta = {"a": {"w": rng.standard_normal((K, 8, 8)).astype(np.float32)},
             "c": {"w": rng.standard_normal((K, 3, 3, 2, 5)).astype(np.float32)}}
    port_theta = convert.params_from_numpy(theta, device="cpu")
    g = make_gossip_mixer(permutation_decomposition(w), device="cpu")
    d = make_dense_mixer(w, device="cpu")
    g_out, g_state = g(port_theta, g.init_state(port_theta))
    d_out, _ = d(port_theta, d.init_state(port_theta))
    ref_out, _ = ref_make_dense_mixer(w)(
        {m: {n: jnp.asarray(v) for n, v in leaves.items()} for m, leaves in theta.items()},
        ref_make_dense_mixer(w).init_state(theta))
    want = convert._flatten({m: {n: np.asarray(v) for n, v in leaves.items()}
                             for m, leaves in ref_out.items()})
    for n in port_theta:
        np.testing.assert_allclose(g_out[n].numpy(), d_out[n].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g_out[n].numpy(), want[n], rtol=1e-6, atol=1e-6)
    sends = sum(len(p) for p in permutation_decomposition(w).ppermute_pairs())
    assert float(g_state.wire_bits) == 8.0 * sends * sum(
        x.numel() // K * 4 for x in port_theta.values())


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("stack", STACKS)
def test_gossip_stack_replays_reference_rounds(ref_runs, graph, stack):
    runs, tag = ref_runs, f"{graph}/{stack}"
    mixer = _port_mixer(runs, graph, stack)
    theta0 = _tree(runs, f"{tag}|r0|in_theta")
    assert mixer.bytes_per_round(theta0) == int(runs[f"{tag}|bytes_per_round"])
    for r in range(_rounds(runs, tag)):
        pre = f"{tag}|r{r}"
        theta = _tree(runs, f"{pre}|in_theta")
        state = mixer.init_state(theta)._replace(rounds=r)
        if f"{pre}|in_hat|a/w" in runs:
            state = state._replace(hat=_tree(runs, f"{pre}|in_hat"),
                                   hat_mix=_tree(runs, f"{pre}|in_hat_mix"))
        if f"{pre}|in_ef_rounds" in runs:
            state = state._replace(ef_rounds=int(runs[f"{pre}|in_ef_rounds"]))
        out, state = mixer(theta, state)
        _close(out, _tree(runs, f"{pre}|out_theta"), f"{pre} theta")
        if f"{pre}|out_hat|a/w" in runs:
            _close(state.hat, _tree(runs, f"{pre}|out_hat"), f"{pre} hat")
            _close(state.hat_mix, _tree(runs, f"{pre}|out_hat_mix"), f"{pre} hat_mix")
        else:
            assert state.hat == () and state.hat_mix == ()
        assert float(state.wire_bits) == float(runs[f"{pre}|wire_bits"]), pre
        np.testing.assert_allclose(float(state.res_norm), float(runs[f"{pre}|res_norm"]),
                                   rtol=1e-6, atol=1e-7, err_msg=pre)
        if f"{pre}|ef_drift" in runs:
            np.testing.assert_allclose(float(state.ef_drift), float(runs[f"{pre}|ef_drift"]),
                                       rtol=1e-5, atol=1e-6, err_msg=pre)
        assert state.rounds == r + 1


def test_trainer_on_the_ef_gossip_stack_tracks_reference(ref_runs):
    """10 DR-DSGD steps of a narrow MLP (784-12-10) on the EF dropout-0.2
    gossip stack with B = 4, fed the reference's W_r and uniforms; metrics
    at rtol 1e-3, params and θ̂ per leaf within WIRE_STEPS of its largest
    quantization step so far (≤ 1 % of entries past 1 % of a step in the
    first EARLY_ROUNDS rounds)."""
    runs = ref_runs
    steps = len({k.split("|")[1] for k in runs if k.startswith("trainer|s")})
    w = _w("er")
    cfg = CompressionConfig(kind="int8", use_kernel=True, seed=7)

    def uniforms(rounds, leaf_idx, shape):
        return runs[f"trainer|s{rounds}|u|{leaf_idx}"]

    mixer = DynamicGossipMixer(ReplaySchedule(w, {s: runs[f"trainer|s{s}|w"]
                                                  for s in range(steps)}),
                               quantized=cfg, ef_rebase_every=4, uniforms=uniforms)
    trainer = DecentralizedTrainer(
        nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply, num_nodes=K,
        graph="erdos_renyi", graph_kwargs={"p": 0.4, "seed": 3}, robust=RobustConfig(mu=6.0),
        lr=0.1, mixer=mixer, compression=cfg, device="cpu")
    state = trainer.init(_tree(runs, "trainer|params0"))
    q_step = {}
    for step in range(steps):
        pre = f"trainer|s{step}"
        state, m = trainer.step(state, (runs[f"{pre}|x"], runs[f"{pre}|y"]))
        ref_keys = {k.split("|")[3] for k in runs if k.startswith(f"{pre}|m|")}
        assert ref_keys <= set(m) and "wire_bits" in ref_keys
        for key in ref_keys:
            np.testing.assert_allclose(float(m[key]), float(runs[f"{pre}|m|{key}"]), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{key} at step {step}")
        hat_before, hat = _tree(runs, f"{pre}|in_hat"), _tree(runs, f"{pre}|hat")
        for n in hat:
            q_step[n] = max(q_step.get(n, 0.0),
                            float((hat[n] - hat_before[n]).abs().max()) / 126.0)
        for what, got, want in (("params", state.params, _tree(runs, f"{pre}|params")),
                                ("hat", state.comm.hat, hat)):
            assert list(got) == list(want)
            for n, t in got.items():
                diff = (t - want[n]).abs()
                where = f"{what} {n} at step {step} (quantization step {q_step[n]:.3g})"
                assert float(diff.max()) <= WIRE_STEPS * q_step[n], \
                    f"{where}: off by {float(diff.max()):.3g}"
                if step < EARLY_ROUNDS:
                    share = float((diff > 0.01 * q_step[n]).float().mean())
                    assert share <= EARLY_SHARE, f"{where}: {share:.2%} of entries off"
    assert state.comm.ef_rounds == steps
