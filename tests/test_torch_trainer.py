"""The port's DR-DSGD trainer (Algorithm 2) against the reference trainer.

A 20-step trajectory of the paper's fmnist setup at K = 10 on ER(p = 0.3)
with Metropolis W: the same initial weights (the reference's init, carried
across), the same batches (repro's and repro_torch's data copies from one
seed), stepped through the reference's jitted ``trainer.step`` loop and the
port's ``trainer.step``.  Parameters and every metric are compared each step.

Tolerances.  Uncompressed (DR-DSGD and DSGD): rtol 1e-5, atol 1e-6 — the
two frameworks round float32 sums in different orders and the exp-scaled
updates carry those last-bit differences through 20 steps (measured on the
CPU: at most 9e-8 on a parameter, 1e-6 relative on a metric).  int8 EF wire:
the port's wire is fed the reference's uniforms, but an ulp of difference in
θ − θ̂ can still move ``floor(x/scale + u)`` across an integer, so an entry
of θ̂ may differ by one quantization step (scale = absmax/127 of its row),
and that difference feeds back.  Bit equality is not the goal there.  Each
leaf is held to its own quantization step, the largest the reference's wire
took on that leaf so far (max |Δθ̂|/126: the row with the largest scale
sends some |q| ≥ 126).  Over the whole run params and θ̂ stay within
``WIRE_STEPS`` steps.  In the first ``EARLY_ROUNDS`` rounds, before a flip
has fed back through the gradients into other leaves, no more than
``EARLY_SHARE`` of a leaf's entries may be off by more than 1 % of a step,
so a wrong quantizer, noise or θ̂ update, which moves most entries, fails.
The scalar metrics are held at rtol 1e-3.  Measured on the CPU: at most 3.5
steps (MLP, 20 steps) and 1.0 step (CNN, 5 steps); in the first two rounds
at most 0.03 % (MLP) and 0.14 % (CNN) of a leaf's entries past 1 % of a
step.  The CNN runs at lr 0.05 and B = 8: at the paper's lr a flip grows
~10× per step on the CNN, and the check would only hold for two or three
steps.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CompressionConfig as RefCompressionConfig
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.core import DecentralizedTrainer as RefTrainer
from repro.core import RobustConfig as RefRobust
from repro.data import make_fmnist_like as ref_make_fmnist_like
from repro.data import pathological_noniid_partition as ref_partition
from repro.models import paper_nets as ref_nets
from repro_torch import convert
from repro_torch.comm import CompressionConfig
from repro_torch.core import DecentralizedTrainer, RobustConfig, TrainerSpec
from repro_torch.comm.mixers import CompressedDenseMixer
from repro_torch.core.consensus import DenseMixer, make_dense_mixer
from repro_torch.data import make_cifar_like, make_fmnist_like, pathological_noniid_partition
from repro_torch.graphs import build_graph, metropolis_weights
from repro_torch.models import paper_nets as nets

ROOT = Path(__file__).resolve().parents[1]
K, B, STEPS, SEED = 10, 55, 20, 0
LR = (K / 300) ** 0.5  # the paper's η = √(K/T) at T = 300
GRAPH_KW = {"p": 0.3, "seed": 0}
WIRE_STEPS = 8          # int8 wire: per-leaf atol, in quantization steps
EARLY_ROUNDS = 2        # rounds before a floor flip feeds back into other leaves
EARLY_SHARE = 0.01      # share of a leaf's entries allowed past 1 % of a step then
METRIC_KEYS = {"comm_bytes", "loss_mean", "loss_worst", "loss_std", "robust_objective",
               "scale_mean", "scale_max", "lambda_max", "wire_bits", "ef_residual_norm",
               "disagreement"}


@pytest.fixture(scope="module")
def setup():
    fed_ref = ref_partition(ref_make_fmnist_like(n_train=2000, n_test=200), K, seed=SEED)
    fed = pathological_noniid_partition(make_fmnist_like(n_train=2000, n_test=200), K,
                                        seed=SEED)
    rng_ref, rng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    batches_ref = [fed_ref.sample_batch(rng_ref, B) for _ in range(STEPS)]
    batches = [fed.sample_batch(rng, B) for _ in range(STEPS)]
    for (xa, ya), (xb, yb) in zip(batches_ref, batches):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    params = jax.tree.map(np.asarray, ref_nets.mlp_init(jax.random.PRNGKey(SEED)))
    return dict(batches=batches, params=params, fed=fed)


def _ref_trainer(robust, compression=None, grad_clip=None, model="mlp", graph_kw=GRAPH_KW,
                 lr=LR):
    apply_fn = getattr(ref_nets, f"{model}_apply")
    return RefTrainer(ref_nets.make_classifier_loss(apply_fn), apply_fn,
                      num_nodes=K, graph="erdos_renyi", graph_kwargs=graph_kw,
                      robust=RefRobust(mu=6.0, enabled=robust), lr=lr,
                      compression=compression, grad_clip=grad_clip)


def _port_trainer(robust, compression=None, mixer=None, grad_clip=None, model="mlp",
                  graph_kw=GRAPH_KW, lr=LR):
    apply_fn = getattr(nets, f"{model}_apply")
    return DecentralizedTrainer(nets.make_classifier_loss(apply_fn), apply_fn,
                                num_nodes=K, graph="erdos_renyi", graph_kwargs=graph_kw,
                                robust=RobustConfig(mu=6.0, enabled=robust), lr=lr,
                                grad_clip=grad_clip, compression=compression, mixer=mixer,
                                device="cpu")


def _flat_numpy(tree):
    return convert._flatten(jax.tree.map(np.asarray, tree))


def _assert_params_close(port_params, ref_params, **tol):
    want = convert._flatten(jax.tree.map(np.asarray, ref_params))
    assert list(port_params) == sorted(want)
    for n, t in port_params.items():
        np.testing.assert_allclose(t.numpy(), want[n], err_msg=n, **tol)


@pytest.mark.parametrize("robust,grad_clip", [(True, None), (False, None), (True, 0.5)],
                         ids=["dr-dsgd", "dsgd", "dr-dsgd-clip"])
def test_uncompressed_trajectory_matches_reference(setup, robust, grad_clip):
    """``grad_clip`` clips every node's gradient at its own global norm
    before the robust scale (0.5 is below the MLP's gradient norms here,
    so the clip acts on every step)."""
    ref_t = _ref_trainer(robust, grad_clip=grad_clip)
    port_t = _port_trainer(robust, grad_clip=grad_clip)
    ref_state = ref_t.init(setup["params"])
    state = port_t.init(convert.params_from_numpy(setup["params"], device="cpu"))
    for step, (x, y) in enumerate(setup["batches"]):
        ref_state, ref_m = ref_t.step(ref_state, (jnp.asarray(x), jnp.asarray(y)))
        state, m = port_t.step(state, (x, y))
        assert set(m) == set(ref_m) == METRIC_KEYS
        for key in METRIC_KEYS:
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} at step {step}")
        _assert_params_close(state.params, ref_state.params, rtol=1e-5, atol=1e-6)
    assert state.step == int(ref_state.step) == STEPS


def _int8_kernel_trajectory(params, batches, model="mlp", graph_kw=GRAPH_KW, lr=LR):
    """Step the reference and the port with the int8 kernel wire, the
    port's wire fed the reference's uniforms; hold every metric, and params
    and θ̂ leaf by leaf, to the module docstring's tolerance."""
    by_round = {}

    def uniforms(rounds, leaf_idx, shape):
        return by_round[rounds][leaf_idx]

    w = metropolis_weights(build_graph("erdos_renyi", K, **graph_kw))
    cfg = CompressionConfig(kind="int8", use_kernel=True)
    ref_t = _ref_trainer(True, RefCompressionConfig(kind="int8", use_kernel=True),
                         model=model, graph_kw=graph_kw, lr=lr)
    port_t = _port_trainer(True, cfg, model=model, graph_kw=graph_kw, lr=lr,
                           mixer=make_dense_mixer(w, compression=cfg, device="cpu",
                                                  uniforms=uniforms))
    ref_state = ref_t.init(params)
    state = port_t.init(convert.params_from_numpy(params, device="cpu"))
    q_step = {}
    for step, (x, y) in enumerate(batches):
        # the reference round's noise: split the carried key, fold node, leaf
        _, sub = jax.random.split(ref_state.comm.key)
        node_ks = per_node_keys(sub, jnp.arange(K))
        by_round[step] = [np.asarray(_uniform_rows(fold_leaf(node_ks, i), leaf[0].size))
                          for i, leaf in enumerate(jax.tree.leaves(ref_state.params))]
        hat_before = _flat_numpy(ref_state.comm.hat)
        ref_state, ref_m = ref_t.step(ref_state, (jnp.asarray(x), jnp.asarray(y)))
        state, m = port_t.step(state, (x, y))
        assert set(m) == set(ref_m) == METRIC_KEYS
        for key in METRIC_KEYS:
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{key} at step {step}")
        hat = _flat_numpy(ref_state.comm.hat)
        assert list(state.comm.hat) == list(state.params) == sorted(hat)
        for n in hat:
            q_step[n] = max(q_step.get(n, 0.0),
                            float(np.abs(hat[n] - hat_before[n]).max()) / 126.0)
        for what, got, want in (("params", state.params, _flat_numpy(ref_state.params)),
                                ("hat", state.comm.hat, hat)):
            for n, t in got.items():
                diff = np.abs(t.numpy() - want[n])
                where = f"{what} {n} at step {step} (quantization step {q_step[n]:.3g})"
                assert diff.max() <= WIRE_STEPS * q_step[n], \
                    f"{where}: off by {diff.max():.3g}"
                if step < EARLY_ROUNDS:
                    share = float((diff > 0.01 * q_step[n]).mean())
                    assert share <= EARLY_SHARE, f"{where}: {share:.2%} of entries off"


def test_int8_kernel_trajectory_matches_reference(setup):
    """The fmnist MLP on the int8 EF wire with the reference's uniforms
    injected; see the module docstring for the tolerance."""
    _int8_kernel_trajectory(setup["params"], setup["batches"])


def test_cnn_int8_kernel_trajectory_matches_reference():
    """The paper's CNN (12 leaves, fc0/w 512,000 wide: the kernel's ragged
    single-block fallback) on the int8 EF wire, K = 10 on ER(p = 0.5) as in
    the CIFAR configuration, 5 steps of B = 8 at lr 0.05."""
    fed = pathological_noniid_partition(make_cifar_like(n_train=1000, n_test=100), K,
                                        seed=SEED)
    rng = np.random.default_rng(SEED)
    batches = [fed.sample_batch(rng, 8) for _ in range(5)]
    params = jax.tree.map(np.asarray, ref_nets.cnn_init(jax.random.PRNGKey(SEED)))
    _int8_kernel_trajectory(params, batches, model="cnn", graph_kw={"p": 0.5, "seed": 0},
                            lr=0.05)


def test_run_equals_looped_step(setup):
    cfg = CompressionConfig(kind="int8", use_kernel=True)
    t = _port_trainer(True, cfg)
    p = convert.params_from_numpy(setup["params"], device="cpu")
    batches = setup["batches"][:6]
    s_loop = t.init(p)
    ms_loop = []
    for b in batches:
        s_loop, m = t.step(s_loop, b)
        ms_loop.append(m)
    stacked = tuple(np.stack(parts) for parts in zip(*batches))
    s_run, ms_run = t.run(t.init(p), stacked)
    assert s_run.step == s_loop.step == 6 and s_run.comm.rounds == s_loop.comm.rounds
    for n in p:
        assert torch.equal(s_run.params[n], s_loop.params[n])
        assert torch.equal(s_run.comm.hat[n], s_loop.comm.hat[n])
    assert set(ms_run) == METRIC_KEYS
    for key in METRIC_KEYS:
        assert ms_run[key].shape == (6,)
        assert torch.equal(ms_run[key], torch.stack([m[key] for m in ms_loop]))
    s_part, ms_part = t.run(t.init(p), stacked, steps=4)
    assert s_part.step == 4 and ms_part["loss_mean"].shape == (4,)


def test_eval_matches_reference(setup):
    ref_t, port_t = _ref_trainer(True), _port_trainer(True)
    rng = np.random.default_rng(4)
    # distinct node models so per-node accuracies differ
    node_params = jax.tree.map(
        lambda x: x[None] + 0.05 * rng.standard_normal((K,) + x.shape).astype(np.float32),
        setup["params"])
    ref_state = ref_t.init_stacked(jax.tree.map(jnp.asarray, node_params))
    state = port_t.init_stacked(convert.params_from_numpy(node_params, device="cpu"))
    fed = setup["fed"]
    x_nodes, y_nodes = fed.per_node_test_sets(n_per_node=40, seed=1)
    got = port_t.eval_local_distributions(state, x_nodes, y_nodes)
    want = ref_t.eval_local_distributions(ref_state, x_nodes, y_nodes)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    sets = fed.per_class_test_sets()
    got = port_t.eval_worst_distribution(state, sets)
    want = ref_t.eval_worst_distribution(ref_state, sets)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    np.testing.assert_allclose(
        port_t.eval_per_node(state, fed.x_test, fed.y_test).numpy(),
        np.asarray(ref_t.eval_per_node(ref_state, fed.x_test, fed.y_test)), rtol=1e-6)


def test_spec_builds_the_paper_trainer():
    spec = TrainerSpec(num_nodes=K, graph="erdos_renyi", graph_kwargs=GRAPH_KW, lr=LR,
                       compress=CompressionConfig(kind="int8", use_kernel=True),
                       device="cpu")
    t = spec.build(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply)
    assert t.compression.use_kernel and t.mixer.compression.kind == "int8"
    assert TrainerSpec(compress="int8", device="cpu").compression_config().kind == "int8"
    # every codec and schedule flag reaches the config the reference's spec builds
    from repro.core.spec import TrainerSpec as RefTrainerSpec

    for kw in (dict(compress="topk", compress_ratio=0.02),
               dict(compress="int8", compress_schedule="adaptive", schedule_threshold=0.7,
                    schedule_warmup=5),
               dict(compress="randk", compress_schedule="linear", schedule_rounds=40,
                    error_feedback=False, seed=4)):
        got = TrainerSpec(device="cpu", **kw).compression_config()
        want = RefTrainerSpec(**kw).compression_config()
        assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                           if k != "interpret"}


@pytest.mark.parametrize("argv", [["--topology", "hub"], ["--straggler-p", "0.1"],
                                  ["--gradient-tracking"],
                                  ["--arch", "qwen2_0_5b", "--ckpt-dir", "x"],
                                  ["--local-updates", "2"], ["--mix-every", "2"]])
def test_cli_unported_flags_raise(argv):
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(["--paper", "fmnist", "--device", "cpu", *argv])


def test_cli_builds_the_dense_dynamic_stack():
    """``--topology dropout --drop-p 0.2`` (and the EF re-base flags) reach a
    DynamicsConfig, and the trainer builds the dense dynamic stack; with
    ``--compress int8`` its compressed twin."""
    import argparse

    from repro_torch.dynamics import (
        DropoutSchedule,
        DynamicCompressedDenseMixer,
        DynamicDenseMixer,
    )

    ap = argparse.ArgumentParser()
    TrainerSpec.add_cli_args(ap)
    for extra, mixer_cls in (([], DynamicDenseMixer),
                             (["--compress", "int8"], DynamicCompressedDenseMixer)):
        args = ap.parse_args(["--topology", "dropout", "--drop-p", "0.2", "--device", "cpu",
                              "--ef-rebase-every", "4", *extra])
        spec = TrainerSpec.from_args(args, num_nodes=K, graph="erdos_renyi",
                                     graph_kwargs=GRAPH_KW)
        cfg = spec.dynamics_config()
        assert (cfg.topology, cfg.drop_p, cfg.ef_rebase_every) == ("dropout", 0.2, 4)
        t = spec.build(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply)
        assert type(t.mixer) is mixer_cls
        assert isinstance(t.mixer.topo.schedule, DropoutSchedule)
        assert t.mixer.topo.schedule.p == 0.2 and t.mixer.traced_wire
    static = TrainerSpec.from_args(ap.parse_args(["--device", "cpu"]), num_nodes=K)
    assert static.dynamics_config() is None
    with pytest.raises(ValueError, match="pre-built mixer and a DynamicsConfig"):
        TrainerSpec(num_nodes=K, graph="ring", topology="round_robin", device="cpu").build(
            nets.make_classifier_loss(nets.mlp_apply),
            mixer=make_dense_mixer(metropolis_weights(build_graph("ring", K)), device="cpu"))


def test_entry_points_raise_without_cuda():
    """Without device="cpu" the entry points ask for CUDA; on a machine
    without it they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), num_nodes=4,
                             graph="ring")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerSpec(num_nodes=4, graph="ring").build(
            nets.make_classifier_loss(nets.mlp_apply))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy({"fc0": {"w": np.zeros((2, 2), np.float32)}})
    w = metropolis_weights(build_graph("ring", 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dense_mixer(w)
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseMixer(w)
    with pytest.raises(RuntimeError, match="CUDA"):
        CompressedDenseMixer(w, CompressionConfig(kind="int8", use_kernel=True))
    from repro_torch.core.consensus import make_gossip_mixer
    from repro_torch.dynamics import DropoutSchedule, make_schedule
    from repro_torch.graphs import permutation_decomposition

    with pytest.raises(RuntimeError, match="CUDA"):
        make_gossip_mixer(permutation_decomposition(w))
    with pytest.raises(RuntimeError, match="CUDA"):
        DropoutSchedule(w, 0.2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_schedule("geometric", k=4)
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--paper", "fmnist", "--steps", "1"])


def test_port_imports_neither_jax_nor_repro():
    """Import every repro_torch module and chip_smoke.py (which runs nothing
    on import) in a fresh interpreter: neither jax nor repro may load.  The
    serving slice's modules must be among them."""
    serving = [f"repro_torch.{m}" for m in (
        "kernels._build", "kernels.flash_attention.kernel", "kernels.flash_attention.ops",
        "kernels.flash_attention.ref", "kernels.rwkv6_scan.kernel", "kernels.rwkv6_scan.ops",
        "kernels.rwkv6_scan.ref", "models.config", "models.params", "models.layers",
        "models.attention", "models.ssm", "models.transformer", "configs.base",
        "configs.qwen2_0_5b", "configs.rwkv6_7b", "serve.sampling", "serve.prefill",
        "launch.serve")]
    script = f"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
importlib.util.module_from_spec(spec)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
assert not bad, bad
missing = [m for m in {serving!r} if m not in sys.modules]
assert not missing, missing
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split("LOADED")[1]) >= 70


def test_paper_schedule_matches_reference():
    from repro.optim import schedules as ref_sched
    from repro_torch.optim import constant_schedule, paper_schedule

    for step in (0, 7, 299):
        assert paper_schedule(K, 300)(step) == pytest.approx(
            float(ref_sched.paper_schedule(K, 300)(step)), rel=1e-7)
        assert constant_schedule(0.05)(step) == pytest.approx(
            float(ref_sched.constant_schedule(0.05)(step)), rel=1e-7)
