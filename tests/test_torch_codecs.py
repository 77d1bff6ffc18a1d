"""The port's wire codecs (A.7) against the reference's.

Codecs: every ``Compressor`` — none, bf16, int8 and int4 per node (static
int4 nibble-packed, scheduled int4 in the int8 container), int8 with
``use_kernel=True`` (per-block scales; the reference's Pallas kernel in
interpret mode, the port's plain version of B.2), topk and randk — on the
same x and the reference's uniforms (randk's scores are those uniforms), at
the static rate and at a rate tensor: payloads bitwise, decoded blocks
bitwise, ``payload_bytes`` and ``payload_bits`` exactly.  ``_pack_int4`` and
``_unpack_int4`` over every nibble pair and every byte, bitwise.

Dense rounds: each codec on the CHOCO error-feedback wire and the
memoryless one, with the reference's uniforms injected through the port's
``uniforms`` hook, each round started from the reference's θ and θ̂: θ, θ̂
at rtol 1e-6, atol 1e-6 (float32 rounding of the W product),
``wire_bits`` exactly.  ``compute_dtype=bfloat16`` dense rounds, static and
over a time-varying W_r, at one bfloat16 rounding of the product (rtol
2**-8, the unit roundoff of bfloat16's 8-bit significand; measured on the
CPU: equal on the static W),
and the fused SGD step declining them.

Gossip rounds: the reference's gossip stacks need one device per node, so
one module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` runs the static
compressed gossip mixer on an 8-node ring for each codec (EF and
memoryless) and for the scheduled int8 kernel quantizer (adaptive and
linear) and writes every round's inputs, outputs, rate and uniforms to an
npz, as tests/test_torch_gossip.py does.  The port replays each round on
the CPU from the reference's inputs and schedule state: rate bitwise, θ,
θ̂ and ``hat_mix`` at rtol 1e-6, atol 1e-6, ``wire_bits`` exactly.

Inputs are standard normal draws from a numpy seed: no two magnitudes tie,
so topk keeps the same entries in the same order on both sides.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CompressionConfig as RefCompressionConfig
from repro.comm import ScheduleConfig as RefScheduleConfig
from repro.comm import make_compressor as ref_make_compressor
from repro.comm.compressors import (
    _pack_int4 as ref_pack_int4,
    _uniform_rows,
    _unpack_int4 as ref_unpack_int4,
    fold_leaf,
    per_node_keys,
)
from repro.core.consensus import make_dense_mixer as ref_make_dense_mixer
from repro.dynamics import mixers as ref_mixers
from repro.dynamics.schedule import DropoutSchedule as RefDropout
from repro.graphs import build_graph, metropolis_weights
from repro_torch import convert
from repro_torch.comm import (
    CompressedGossipMixer,
    CompressionConfig,
    ScheduleConfig,
    make_compressor,
)
from repro_torch.comm.compressors import _pack_int4, _unpack_int4
from repro_torch.comm.wire import MaskedQuantWire
from repro_torch.core.consensus import DenseMixer, make_dense_mixer
from repro_torch.core.drdsgd import _fused_w
from repro_torch.dynamics import DynamicDenseMixer, TopologySchedule
from repro_torch.graphs import permutation_decomposition
from repro_torch.optim import sgd

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
K = 6
W = metropolis_weights(build_graph("erdos_renyi", K, p=0.5, seed=1))
SHAPES = {"fc0": {"w": (20, 8), "b": (8,)}, "fc1": {"w": (8, 3), "b": (3,)},
          "conv0": {"w": (3, 3, 2, 5), "b": (5,)}}
# codec -> CompressionConfig kwargs (the reference adds interpret=True to
# the kernel quantizer's)
CODECS = {
    "none": dict(kind="none"),
    "bf16": dict(kind="bf16"),
    "int8": dict(kind="int8"),
    "int4": dict(kind="int4"),
    "int8-kernel": dict(kind="int8", use_kernel=True, block_d=16),
    "topk": dict(kind="topk", ratio=0.3),
    "randk": dict(kind="randk", ratio=0.3),
}


def _cfgs(spec, schedule=None, **kw):
    spec = dict(spec, **kw)
    ref_extra = dict(interpret=True) if spec.get("use_kernel") else {}
    return (RefCompressionConfig(**spec, **ref_extra,
                                 schedule=RefScheduleConfig(**schedule) if schedule else None),
            CompressionConfig(**spec, schedule=ScheduleConfig(**schedule) if schedule else None))


def _tensors(payload):
    return list(payload) if isinstance(payload, tuple) else [payload]


def _same(got, want, what):
    """Bitwise equality of a port payload (tensors) and a reference one."""
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=what)


# -- codecs -------------------------------------------------------------------

@pytest.mark.parametrize("codec,rate", [(c, r) for c in CODECS for r in (
    [None, "low", "high"] if CODECS[c]["kind"] in ("int8", "int4", "topk", "randk")
    else [None])])
@pytest.mark.parametrize("d", [1, 7, 64, 160])
def test_codec_matches_reference(codec, d, rate):
    """compress/decompress bitwise on the same x and uniforms; a rate (a
    scheduled codec: int8/int4 in the int8 container at qmax 5.5 or 127,
    topk/randk at half or all of ``ratio``) where the codec takes one."""
    sched = dict(kind="linear") if rate is not None else None
    ref_cfg, cfg = _cfgs(CODECS[codec], sched)
    ref_c, port_c = ref_make_compressor(ref_cfg), make_compressor(cfg)
    assert port_c.name == ref_c.name
    rng = np.random.default_rng(d)
    x = rng.standard_normal((K, d)).astype(np.float32)
    if CODECS[codec]["kind"] != "topk":
        x[1] = 0.0  # an all-zero row (for topk, a tie of every magnitude)
    keys = fold_leaf(per_node_keys(jax.random.PRNGKey(d), jnp.arange(K)), 2)
    u = np.array(_uniform_rows(keys, d))
    r = None
    if rate is not None:
        sparse = CODECS[codec]["kind"] in ("topk", "randk")
        r = (0.15 if rate == "low" else 0.3) if sparse else (5.5 if rate == "low" else 127.0)
    want = ref_c.compress(jnp.asarray(x), keys, None if r is None else jnp.float32(r))
    got = port_c.compress(torch.from_numpy(x), torch.from_numpy(u),
                          None if r is None else torch.tensor(r, dtype=torch.float32))
    _same(got, want, f"{codec} payload")
    _same(port_c.decompress(got, d), ref_c.decompress(want, d), f"{codec} decoded")
    assert port_c.payload_bytes(d) == ref_c.payload_bytes(d)
    want_bits = ref_c.payload_bits(d, None if r is None else jnp.float32(r))
    got_bits = port_c.payload_bits(d, None if r is None else torch.tensor(r))
    assert float(got_bits) == float(want_bits)


def test_pack_int4_every_nibble():
    """Every (even, odd) nibble pair in [-8, 7]² packs to the reference's
    byte, every byte unpacks to the reference's pair, and unpack(pack(q))
    is q; an odd width pads one zero nibble."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], axis=1).astype(np.int8).reshape(16, 32)
    packed = _pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_pack_int4(jnp.asarray(q))))
    assert torch.equal(_unpack_int4(packed, 32), torch.from_numpy(q))
    every_byte = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        _unpack_int4(torch.from_numpy(every_byte), 32).numpy(),
        np.asarray(ref_unpack_int4(jnp.asarray(every_byte), 32)))
    odd = q[:, :31]
    packed_odd = _pack_int4(torch.from_numpy(odd))
    np.testing.assert_array_equal(packed_odd.numpy(),
                                  np.asarray(ref_pack_int4(jnp.asarray(odd))))
    assert torch.equal(_unpack_int4(packed_odd, 31), torch.from_numpy(odd))


@pytest.mark.parametrize("spec", [
    dict(kind="int4", use_kernel=True), dict(kind="topk", ratio=0.0),
    dict(kind="randk", ratio=1.5), dict(kind="bf16", schedule="linear"),
    dict(kind="none", schedule="linear"), dict(kind="int8", error_feedback=False,
                                               schedule="adaptive")],
    ids=["int4-kernel", "topk-ratio0", "randk-ratio1.5", "bf16-schedule", "none-schedule",
         "adaptive-memoryless"])
def test_compression_config_checks_match_reference(spec):
    spec = dict(spec)
    sched = spec.pop("schedule", None)
    with pytest.raises(ValueError):
        RefCompressionConfig(**spec, schedule=RefScheduleConfig(kind=sched) if sched else None)
    with pytest.raises(ValueError):
        CompressionConfig(**spec, schedule=ScheduleConfig(kind=sched) if sched else None)


@pytest.mark.parametrize("spec", [dict(kind=k, ratio=r, gamma=g) for k in CODECS
                                  if "-" not in k for r in (0.01, 0.3, 0.9)
                                  for g in (None, 0.5)][::2])
def test_resolved_gamma_and_compressor_branch_match_reference(spec):
    for sched in (None, "linear"):
        if sched and spec["kind"] in ("none", "bf16"):
            continue
        ref_cfg, cfg = _cfgs(spec, dict(kind=sched) if sched else None)
        assert cfg.resolved_gamma == ref_cfg.resolved_gamma
        ref_c, port_c = ref_make_compressor(ref_cfg), make_compressor(cfg)
        assert (port_c.name, type(port_c).__name__) == (ref_c.name, type(ref_c).__name__)
        assert getattr(port_c, "bits", None) == getattr(ref_c, "bits", None)
        assert getattr(port_c, "dynamic", None) == getattr(ref_c, "dynamic", None)


def test_masked_wire_refuses_a_schedule():
    """As the reference's (repro/comm/wire.py:318-320)."""
    cfg = CompressionConfig(kind="int8", use_kernel=True, error_feedback=False,
                            schedule=ScheduleConfig(kind="linear"))
    with pytest.raises(ValueError, match="schedules"):
        MaskedQuantWire(cfg)


# -- dense rounds ---------------------------------------------------------------

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {m: {n: (scale * rng.standard_normal((K,) + s)).astype(np.float32)
                for n, s in leaves.items()} for m, leaves in SHAPES.items()}


def _port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def _assert_tree_close(port_tree, ref_tree, **tol):
    want = convert._flatten(jax.tree.map(np.asarray, ref_tree))
    assert list(port_tree) == sorted(want)
    for n, t in port_tree.items():
        np.testing.assert_allclose(t.float().numpy(), want[n], err_msg=n, **tol)


class ReferenceUniforms:
    """The reference dense round's uniforms (and randk's scores): round r
    splits the carried key, folds the node id, then the leaf index."""

    def __init__(self):
        self.by_round = {}

    def record(self, rounds, ref_state, theta_ref):
        _, sub = jax.random.split(ref_state.key)
        node_ks = per_node_keys(sub, jnp.arange(K))
        self.by_round[rounds] = [
            np.asarray(_uniform_rows(fold_leaf(node_ks, i), x.size // K))
            for i, x in enumerate(jax.tree.leaves(theta_ref))]

    def __call__(self, rounds, leaf_idx, shape):
        u = self.by_round[rounds][leaf_idx]
        assert u.shape == shape
        return u


@pytest.mark.parametrize("codec", [c for c in CODECS if c != "none"])
@pytest.mark.parametrize("error_feedback", [True, False], ids=["ef", "memoryless"])
def test_compressed_dense_rounds_match_reference(codec, error_feedback):
    ref_cfg, cfg = _cfgs(CODECS[codec], error_feedback=error_feedback, seed=3)
    uniforms = ReferenceUniforms()
    ref_m = ref_make_dense_mixer(W, compression=ref_cfg)
    port_m = make_dense_mixer(W, compression=cfg, device="cpu", uniforms=uniforms)
    assert not port_m.traced_wire
    theta = _tree(0)
    ref_state, port_state = ref_m.init_state(theta), port_m.init_state(_port(theta))
    if error_feedback:
        hat = _tree(1, scale=0.5)
        ref_state = ref_state._replace(hat=jax.tree.map(jnp.asarray, hat))
        port_state = port_state._replace(hat=_port(hat))
    ref_theta, port_theta = jax.tree.map(jnp.asarray, theta), _port(theta)
    for r in range(3):
        uniforms.record(r, ref_state, ref_theta)
        ref_theta, ref_state = ref_m(ref_theta, ref_state)
        port_theta, port_state = port_m(port_theta, port_state)
        _assert_tree_close(port_theta, ref_theta, rtol=1e-6, atol=1e-6)
        if error_feedback:
            _assert_tree_close(port_state.hat, ref_state.hat, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(port_state.res_norm), float(ref_state.res_norm),
                                   rtol=1e-6)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits)
        assert port_m.bytes_per_round(port_theta) == ref_m.bytes_per_round(theta)
        port_theta = _port(jax.tree.map(np.asarray, ref_theta))
        if error_feedback:
            port_state = port_state._replace(
                hat=_port(jax.tree.map(np.asarray, ref_state.hat)))


class _Replay(TopologySchedule):
    """The reference dropout schedule's W_r, round by round, on the CPU."""

    def __init__(self, w_base, ws):
        self._w_np = np.asarray(w_base, np.float64)
        self.k = self._w_np.shape[0]
        self.device = torch.device("cpu")
        self.ws = ws

    def round_weights(self, rounds):
        return torch.from_numpy(np.array(self.ws[rounds]))

    def base_weights(self):
        return self._w_np


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dropout"])
def test_bf16_dense_rounds_match_reference(dynamic):
    """``compute_dtype=bfloat16``: the static W cast once and the leaves
    rounded to bfloat16 before the product; a time-varying float32 W_r
    multiplies the rounded leaves in float32 (the reference's einsum
    promotion)."""
    theta = _tree(0)
    if dynamic:
        ref_sched = RefDropout(W, 0.3, seed=2)
        ref_m = ref_mixers.DynamicDenseMixer(ref_sched, compute_dtype=jnp.bfloat16)
        ws = {r: np.asarray(ref_sched.round_weights(jnp.int32(r))) for r in range(3)}
        port_m = DynamicDenseMixer(_Replay(W, ws), compute_dtype=torch.bfloat16)
    else:
        ref_m = ref_make_dense_mixer(W, compute_dtype=jnp.bfloat16)
        port_m = make_dense_mixer(W, compute_dtype=torch.bfloat16, device="cpu")
        assert port_m.w.dtype == torch.bfloat16
    ref_theta, port_theta = jax.tree.map(jnp.asarray, theta), _port(theta)
    ref_state, port_state = ref_m.init_state(theta), port_m.init_state(port_theta)
    for _ in range(3):
        ref_theta, ref_state = ref_m(ref_theta, ref_state)
        port_theta, port_state = port_m(port_theta, port_state)
        _assert_tree_close(port_theta, ref_theta, rtol=2.0 ** -8, atol=0)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits)
        port_theta = _port(jax.tree.map(np.asarray, ref_theta))


def test_fused_step_declines_bfloat16_dense_rounds():
    """B.1 computes in float32, so the fused SGD + dense step takes a
    float32 DenseMixer and declines a bfloat16 one (and a compressed one)."""
    assert _fused_w(sgd(0.1), DenseMixer(W, device="cpu")) is not None
    assert _fused_w(sgd(0.1), DenseMixer(W, torch.bfloat16, device="cpu")) is None
    cfg = CompressionConfig(kind="bf16")
    assert _fused_w(sgd(0.1), make_dense_mixer(W, cfg, device="cpu")) is None


# -- gossip rounds (the reference in a subprocess with 8 host devices) -------------

GK = 8
GOSSIP = {
    "bf16-ef": dict(kind="bf16"),
    "int8-ef": dict(kind="int8"),
    "int4-ef": dict(kind="int4"),
    "topk-ef": dict(kind="topk", ratio=0.3),
    "randk-ef": dict(kind="randk", ratio=0.3),
    "int8-kernel-ef": dict(kind="int8", use_kernel=True, block_d=16),
    "bf16-memoryless": dict(kind="bf16", error_feedback=False),
    "int8-memoryless": dict(kind="int8", error_feedback=False),
    "int8-kernel-memoryless": dict(kind="int8", use_kernel=True, block_d=16,
                                   error_feedback=False),
    "int4-memoryless": dict(kind="int4", error_feedback=False),
    "topk-memoryless": dict(kind="topk", ratio=0.3, error_feedback=False),
    "randk-memoryless": dict(kind="randk", ratio=0.3, error_feedback=False),
    "int8-kernel-adaptive": dict(kind="int8", use_kernel=True, block_d=16,
                                 schedule=dict(kind="adaptive", warmup_rounds=1,
                                               threshold=0.9)),
    "int8-kernel-linear": dict(kind="int8", use_kernel=True, block_d=16,
                               schedule=dict(kind="linear", anneal_rounds=2)),
    "int4-adaptive": dict(kind="int4", schedule=dict(kind="adaptive", warmup_rounds=1,
                                                     threshold=0.9)),
    "topk-linear-damped": dict(kind="topk", ratio=0.3,
                               schedule=dict(kind="linear", anneal_rounds=2,
                                             damp_gamma=True)),
}

SCRIPT = r'''
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.comm import CompressionConfig, ScheduleConfig
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.comm.mixers import CompressedGossipMixer
from repro.graphs import build_graph, metropolis_weights, permutation_decomposition

OUT, STACKS = sys.argv[1], json.loads(sys.argv[2])
K, ROUNDS = 8, 3
SHAPES = {"a": {"w": (8, 8)}, "b": {"w": (7,)}, "c": {"w": (3, 3, 2, 5)}}
mesh = jax.make_mesh((K,), ("data",))
out = {}


def put(tree):
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))),
                        tree)


def save(prefix, tree):
    for m, leaves in tree.items():
        for n, v in leaves.items():
            out[f"{prefix}|{m}/{n}"] = np.asarray(v)


def _u_impl(key, ds):
    _, sub = jax.random.split(key)
    node_ks = per_node_keys(sub, jnp.arange(K))
    return [_uniform_rows(fold_leaf(node_ks, i), d) for i, d in enumerate(ds)]


_u = jax.jit(_u_impl, static_argnums=1)
rng = np.random.default_rng(0)
theta0 = {m: {n: rng.standard_normal((K,) + s).astype(np.float32) for n, s in leaves.items()}
          for m, leaves in SHAPES.items()}
specs = jax.tree.map(lambda _: P("data"), theta0)
decomp = permutation_decomposition(metropolis_weights(build_graph("ring", K)))
for name, spec in STACKS.items():
    spec = dict(spec, seed=3)
    if spec.get("use_kernel"):
        spec["interpret"] = True
    sched = spec.pop("schedule", None)
    cfg = CompressionConfig(**spec, schedule=ScheduleConfig(**sched) if sched else None)
    mixer = CompressedGossipMixer(decomp, mesh, "data", specs, cfg)
    call = jax.jit(lambda t, s, mixer=mixer: mixer(t, s))
    theta, state = put(theta0), mixer.init_state(theta0)
    out[f"{name}|bytes_per_round"] = np.int64(mixer.bytes_per_round(theta0))
    for r in range(ROUNDS):
        pre = f"{name}|r{r}"
        save(f"{pre}|in_theta", theta)
        if state.hat != ():
            save(f"{pre}|in_hat", state.hat)
            save(f"{pre}|in_hat_mix", state.hat_mix)
        out[f"{pre}|in_res_norm"] = np.asarray(state.res_norm)
        out[f"{pre}|in_res_ref"] = np.asarray(state.res_ref)
        rate = mixer._rate(state)
        if rate is not None:
            out[f"{pre}|rate"] = np.asarray(rate)
        for i, u in enumerate(_u(state.key, tuple(x.size // K for x in jax.tree.leaves(theta)))):
            out[f"{pre}|u|{i}"] = np.asarray(u)
        theta, state = call(theta, state)
        save(f"{pre}|out_theta", theta)
        if state.hat != ():
            save(f"{pre}|out_hat", state.hat)
            save(f"{pre}|out_hat_mix", state.hat_mix)
        for field in ("wire_bits", "res_norm", "res_ref"):
            out[f"{pre}|{field}"] = np.asarray(getattr(state, field))
np.savez(OUT, **out)
print("OK")
'''


@pytest.fixture(scope="module")
def gossip_runs(tmp_path_factory):
    """Run the reference once (see the module docstring); {key: array}."""
    import json

    path = tmp_path_factory.mktemp("ref_codec_gossip") / "runs.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(path), json.dumps(GOSSIP)],
                         env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    with np.load(path) as npz:
        return dict(npz)


def _gtree(runs, prefix):
    names = sorted(k[len(prefix) + 1:] for k in runs if k.startswith(prefix + "|"))
    return {n: torch.from_numpy(np.array(runs[f"{prefix}|{n}"])) for n in names}


def _gclose(got: dict, want: dict, what):
    assert list(got) == list(want), what
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("name", list(GOSSIP))
def test_compressed_gossip_rounds_match_reference(gossip_runs, name):
    """Each round of the static compressed gossip stack on the 8-ring, from
    the reference's inputs: sparsifier and bf16 payloads go through the
    gather-and-decompress path, the kernel quantizer through B.2 and B.3's
    plain versions (a schedule's rate as a 0-d tensor)."""
    runs = gossip_runs
    spec = dict(GOSSIP[name], seed=3)
    sched = spec.pop("schedule", None)
    cfg = CompressionConfig(**spec, schedule=ScheduleConfig(**sched) if sched else None)

    def uniforms(rounds, leaf_idx, shape):
        u = runs[f"{name}|r{rounds}|u|{leaf_idx}"]
        assert u.shape == shape
        return u

    decomp = permutation_decomposition(metropolis_weights(build_graph("ring", GK)))
    mixer = CompressedGossipMixer(decomp, cfg, device="cpu", uniforms=uniforms)
    assert mixer.traced_wire == (sched is not None)
    for r in range(3):
        pre = f"{name}|r{r}"
        theta = _gtree(runs, f"{pre}|in_theta")
        state = mixer.init_state(theta)._replace(
            rounds=r, res_norm=torch.from_numpy(np.array(runs[f"{pre}|in_res_norm"])),
            res_ref=torch.from_numpy(np.array(runs[f"{pre}|in_res_ref"])))
        if cfg.error_feedback:
            state = state._replace(hat=_gtree(runs, f"{pre}|in_hat"),
                                   hat_mix=_gtree(runs, f"{pre}|in_hat_mix"))
        if sched is not None:
            rate = mixer.wire.rate(state)
            assert rate.numpy().view(np.uint32) == runs[f"{pre}|rate"].view(np.uint32), r
        out, state = mixer(theta, state)
        _gclose(out, _gtree(runs, f"{pre}|out_theta"), f"{pre} theta")
        if cfg.error_feedback:
            _gclose(state.hat, _gtree(runs, f"{pre}|out_hat"), f"{pre} hat")
            _gclose(state.hat_mix, _gtree(runs, f"{pre}|out_hat_mix"), f"{pre} hat_mix")
        np.testing.assert_allclose(float(state.res_norm), float(runs[f"{pre}|res_norm"]),
                                   rtol=1e-6)
        assert float(state.res_ref) == float(runs[f"{pre}|res_ref"])
        assert float(state.wire_bits) == float(runs[f"{pre}|wire_bits"]), r
        assert mixer.bytes_per_round(theta) == int(runs[f"{name}|bytes_per_round"])
