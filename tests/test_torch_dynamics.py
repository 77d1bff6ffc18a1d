"""The port's topology schedules and dynamic dense mixers against the
reference's ``repro.dynamics``.

Deterministic schedules (static, round-robin, dropout at p = 0) must give
the reference's W_r bit for bit.  The port draws dropout coins from its
Philox coins (``repro_torch.dynamics.coins``: a pure function of (seed,
stream, round), the same on the CPU and the card) where the reference
folds the round into a JAX key, so its sampler is held on its rates: over
2,000 rounds the kept-link fraction lies within 4σ of 1 − p, and every
W_r is symmetric and doubly stochastic (1e-6).  The mixers' arithmetic is held on the reference's own W_r and
uniforms, injected through :class:`ReplaySchedule` (defined here, not in
the package) and the wire's ``uniforms`` hook: θ and θ̂ agree per round at
rtol 1e-6, atol 1e-6 (float32 summation order of the W product), the
payload is exact, and ``wire_bits`` and ``bytes_per_round`` are equal.
These run on one JAX device; the gossip lowering's reference runs are in
tests/test_torch_gossip.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CompressionConfig as RefCompressionConfig
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.dynamics import DynamicsConfig as RefDynamicsConfig
from repro.dynamics import mixers as ref_mixers
from repro.dynamics import schedule as ref_schedule
from repro.graphs import build_graph, metropolis_weights
from repro_torch import convert
from repro_torch.comm import CompressionConfig
from repro_torch.dynamics import (
    DropoutSchedule,
    DynamicCompressedDenseMixer,
    DynamicCompressedGossipMixer,
    DynamicDenseMixer,
    DynamicGossipMixer,
    DynamicsConfig,
    GeometricRedrawSchedule,
    RoundRobinSchedule,
    StaticSchedule,
    TopologySchedule,
    build_dynamic_mixer,
    make_schedule,
)

K = 8
W = metropolis_weights(build_graph("erdos_renyi", K, p=0.4, seed=3))
SHAPES = {"a": {"w": (8, 8), "b": (6,)}, "c": {"w": (3, 3, 2, 5)}}


class ReplaySchedule(TopologySchedule):
    """The reference schedule's W_r, recorded per round, on the CPU."""

    def __init__(self, ref_sched, rounds):
        self._w_np = np.asarray(ref_sched.base_weights(), np.float64)
        self.k = ref_sched.k
        self.device = torch.device("cpu")
        self.ws = {r: np.array(jax.jit(ref_sched.round_weights)(jnp.int32(r)))
                   for r in range(rounds)}

    def round_weights(self, rounds):
        return torch.from_numpy(self.ws[rounds])

    def base_weights(self):
        return self._w_np


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {m: {n: (scale * rng.standard_normal((K,) + s)).astype(np.float32)
                for n, s in leaves.items()} for m, leaves in SHAPES.items()}


def _port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def _close(port_tree, ref_tree, **tol):
    want = convert._flatten(jax.tree.map(np.asarray, ref_tree))
    assert list(port_tree) == sorted(want)
    for n, t in port_tree.items():
        np.testing.assert_allclose(t.numpy(), want[n], err_msg=n, **tol)


def test_static_and_zero_dropout_schedules_are_the_base_w():
    w32 = torch.as_tensor(W, dtype=torch.float32)
    for sched in (StaticSchedule(W, device="cpu"), DropoutSchedule(W, 0.0, device="cpu"),
                  make_schedule("dropout", w=W, drop_p=0.0, device="cpu")):
        for r in (0, 1, 17):
            assert torch.equal(sched.round_weights(r), w32)
        np.testing.assert_array_equal(sched.base_weights(), W)
    ref = ref_schedule.DropoutSchedule(W, 0.0)
    np.testing.assert_array_equal(np.asarray(ref.round_weights(jnp.int32(3))), w32.numpy())


@pytest.mark.parametrize("graph", ["ring", "erdos_renyi", "grid"])
def test_round_robin_stack_matches_reference(graph):
    w = metropolis_weights(build_graph(graph, K, **({"p": 0.4, "seed": 3}
                                                    if graph == "erdos_renyi" else {})))
    ours, ref = RoundRobinSchedule(w, device="cpu"), ref_schedule.RoundRobinSchedule(w)
    assert ours.num_matchings == ref.num_matchings
    for r in range(2 * ours.num_matchings + 1):
        got = ours.round_weights(r).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.round_weights(jnp.int32(r))))
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    for a, b in zip(ours.decomposition().matchings, ref.decomposition().matchings):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_sampler_rates(p):
    """2,000 rounds of the port's own coins: the kept share of the base
    graph's links within 4σ of 1 − p, every W_r symmetric and doubly
    stochastic, supported on the base graph, and a pure function of the
    round."""
    sched = DropoutSchedule(W, p, seed=11, device="cpu")
    base = torch.as_tensor(W, dtype=torch.float32)
    off = ~torch.eye(K, dtype=torch.bool)
    links = int(((base > 0) & off).sum()) // 2
    rounds = 2000
    ws = torch.stack([sched.round_weights(r) for r in range(rounds)])  # (R, K, K)
    assert torch.allclose(ws, ws.transpose(1, 2), atol=1e-6)
    assert torch.allclose(ws.sum(2), torch.ones(rounds, K), atol=1e-6)
    assert bool((ws >= 0).all()) and bool((ws[:, (base == 0) & off] == 0).all())
    kept = int(((ws > 0) & off).sum()) // 2
    share, n = kept / (rounds * links), rounds * links
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 4 * sigma, (share, 1 - p, sigma)
    assert torch.equal(sched.round_weights(5), DropoutSchedule(W, p, seed=11, device="cpu")
                       .round_weights(5))
    assert not torch.equal(sched.round_weights(5), sched.round_weights(6))


def test_geometric_redraw_rounds_are_doubly_stochastic():
    sched = GeometricRedrawSchedule(K, radius=0.6, seed=2, device="cpu")
    with pytest.raises(ValueError, match="only the dense lowering"):
        sched.decomposition()
    for r in range(50):
        w = sched.round_weights(r)
        assert torch.allclose(w, w.T, atol=1e-6)
        assert torch.allclose(w.sum(1), torch.ones(K), atol=1e-6)


def test_dynamic_dense_mixer_matches_reference():
    rounds = 4
    ref_sched = ref_schedule.DropoutSchedule(W, 0.3, seed=4)
    ref_m = ref_mixers.DynamicDenseMixer(ref_sched)
    port_m = DynamicDenseMixer(ReplaySchedule(ref_sched, rounds))
    theta = _tree(0)
    ref_theta, ref_state = jax.tree.map(jnp.asarray, theta), ref_m.init_state(theta)
    port_state = port_m.init_state(_port(theta))
    step = jax.jit(lambda t, s: ref_m(t, s))
    assert port_m.bytes_per_round(_port(theta)) == ref_m.bytes_per_round(theta)
    for r in range(rounds):
        port_theta, port_state = port_m(_port(jax.tree.map(np.asarray, ref_theta)), port_state)
        ref_theta, ref_state = step(ref_theta, ref_state)
        _close(port_theta, ref_theta, rtol=1e-6, atol=1e-6)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits)
        assert port_state.rounds == int(ref_state.rounds) == r + 1


@pytest.mark.parametrize("error_feedback", [True, False], ids=["ef", "memoryless"])
def test_dynamic_compressed_dense_mixer_matches_reference(error_feedback):
    rounds = 4
    ref_sched = ref_schedule.DropoutSchedule(W, 0.3, seed=4)
    kw = dict(kind="int8", use_kernel=True, error_feedback=error_feedback, seed=3, block_d=16)
    ref_m = ref_mixers.DynamicCompressedDenseMixer(ref_sched, RefCompressionConfig(**kw))
    by_round = {}

    def uniforms(rounds, leaf_idx, shape):
        return by_round[rounds][leaf_idx]

    port_m = DynamicCompressedDenseMixer(ReplaySchedule(ref_sched, rounds),
                                         CompressionConfig(**kw), uniforms=uniforms)
    theta = _tree(0)
    ref_theta, ref_state = jax.tree.map(jnp.asarray, theta), ref_m.init_state(theta)
    if error_feedback:
        ref_state = ref_state._replace(hat=jax.tree.map(jnp.asarray, _tree(1, 0.5)))
    port_state = port_m.init_state(_port(theta))
    step = jax.jit(lambda t, s: ref_m(t, s))
    for r in range(rounds):
        _, sub = jax.random.split(ref_state.key)
        node_ks = per_node_keys(sub, jnp.arange(K))
        by_round[r] = [np.asarray(_uniform_rows(fold_leaf(node_ks, i), x.size // K))
                       for i, x in enumerate(jax.tree.leaves(ref_theta))]
        if error_feedback:  # start each round from the reference's θ̂
            port_state = port_state._replace(hat=_port(jax.tree.map(np.asarray, ref_state.hat)))
        port_theta, port_state = port_m(_port(jax.tree.map(np.asarray, ref_theta)), port_state)
        ref_theta, ref_state = step(ref_theta, ref_state)
        _close(port_theta, ref_theta, rtol=1e-6, atol=1e-6)
        if error_feedback:
            _close(port_state.hat, ref_state.hat, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(port_state.res_norm), float(ref_state.res_norm),
                                   rtol=1e-6)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits)
    assert port_m.bytes_per_round(_port(theta)) == ref_m.bytes_per_round(theta)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("kwargs", [
    dict(topology="wormhole"), dict(local_updates=0), dict(ef_rebase_every=-1),
    dict(ef_rebase_threshold=-1.0), dict(topology="dropout", drop_p=1.0),
    dict(drop_p=0.2)])
def test_dynamics_config_raises_the_reference_errors(kwargs):
    assert _error(lambda: DynamicsConfig(**kwargs)) == \
        _error(lambda: RefDynamicsConfig(**kwargs))


@pytest.mark.parametrize("kwargs,ported_in", [
    (dict(topology="hub"), "federated slice"),
    (dict(local_updates=2), "local-updates slice"),
    (dict(gradient_tracking=True), "local-updates slice"),
    (dict(faults=dict(straggler_p=0.1)), "faults slice")])
def test_unported_dynamics_options_raise(kwargs, ported_in):
    """The options that raised until their slice (``ported_in``) was ported
    now build as the reference's do (``enabled``, the stack's classes); what
    still raises is the reference's own refusal of a hub with faults.
    ``faults`` holds the FaultConfig's fields, built on both sides."""
    from repro.dynamics import FaultConfig as RefFaultConfig
    from repro.dynamics import build_dynamic_mixer as ref_build

    from repro_torch.dynamics import FaultConfig

    ref_kwargs = dict(kwargs)
    if "faults" in kwargs:
        kwargs = dict(faults=FaultConfig(**kwargs["faults"]))
        ref_kwargs = dict(faults=RefFaultConfig(**ref_kwargs["faults"]))
    cfg, ref_cfg = DynamicsConfig(**kwargs), RefDynamicsConfig(**ref_kwargs)
    assert cfg.enabled and ref_cfg.enabled, ported_in
    got = build_dynamic_mixer(cfg, W, device="cpu")
    want = ref_build(ref_cfg, W)
    assert type(got).__name__ == type(want).__name__, ported_in
    assert type(getattr(got, "inner", got)).__name__ == \
        type(getattr(want, "inner", want)).__name__
    if "faults" in kwargs:
        assert _error(lambda: DynamicsConfig(topology="hub", **kwargs)) == \
            _error(lambda: RefDynamicsConfig(topology="hub", **ref_kwargs))


def test_dynamics_config_builds_the_dense_stack():
    assert not DynamicsConfig().enabled
    cfg = DynamicsConfig(topology="dropout", drop_p=0.2, seed=1)
    assert cfg.enabled
    m = build_dynamic_mixer(cfg, W, device="cpu")
    assert type(m) is DynamicDenseMixer and m.topo.schedule.p == 0.2
    m = build_dynamic_mixer(cfg, W, CompressionConfig(kind="int8"), device="cpu")
    assert type(m) is DynamicCompressedDenseMixer
    m = build_dynamic_mixer(DynamicsConfig(topology="geometric"), W, device="cpu")
    assert isinstance(m.topo.schedule, GeometricRedrawSchedule)


def test_dynamic_gossip_mixer_checks_and_redirect():
    sched = DropoutSchedule(W, 0.2, device="cpu")
    ef = CompressionConfig(kind="int8", use_kernel=True)
    memoryless = CompressionConfig(kind="int8", use_kernel=True, error_feedback=False)
    assert type(DynamicGossipMixer(sched, quantized=ef)) is DynamicCompressedGossipMixer
    assert type(DynamicGossipMixer(sched, quantized=memoryless)) is DynamicGossipMixer
    assert DynamicGossipMixer(sched).compression is None
    # the reference's argument checks, raised before it touches a mesh
    ref_sched = ref_schedule.DropoutSchedule(W, 0.2)
    assert _error(lambda: DynamicGossipMixer(sched, quantized=memoryless,
                                             ef_rebase_threshold=0.5)) == \
        _error(lambda: ref_mixers.DynamicGossipMixer(
            ref_sched, None, "data", None, ef_rebase_threshold=0.5,
            quantized=RefCompressionConfig(kind="int8", error_feedback=False)))
    for kwargs in (dict(compression=CompressionConfig(kind="none")),
                   dict(compression=memoryless)):
        ref_kwargs = dict(compression=RefCompressionConfig(
            kind=kwargs["compression"].kind,
            error_feedback=kwargs["compression"].error_feedback))
        assert _error(lambda: DynamicCompressedGossipMixer(sched, **kwargs)) == \
            _error(lambda: ref_mixers.DynamicCompressedGossipMixer(
                ref_sched, None, "data", None, **ref_kwargs))
    with pytest.raises(ValueError, match="ef_rebase_every=0"):
        DynamicCompressedGossipMixer(sched, ef, ef_rebase_every=0)
    with pytest.raises(ValueError, match="ef_rebase_every must be >= 0"):
        DynamicCompressedGossipMixer(sched, ef, ef_rebase_every=-1)
    DynamicCompressedGossipMixer(StaticSchedule(W, device="cpu"), ef, ef_rebase_every=0)
    with pytest.raises(ValueError, match="only the dense lowering"):
        DynamicGossipMixer(GeometricRedrawSchedule(K, device="cpu"))
    with pytest.raises(ValueError, match="masked quant_gossip wire serves"):
        DynamicGossipMixer(sched, quantized=CompressionConfig(kind="bf16",
                                                              error_feedback=False))
    with pytest.raises(NotImplementedError, match="hierarchical slice"):
        DynamicCompressedGossipMixer(sched, ef, replica_axis="replica")
    # faults compose on the gossip lowering; they make a static schedule
    # time-varying, so the EF wire must re-base, as in the reference
    from repro_torch.dynamics import FaultConfig

    faults = FaultConfig(straggler_p=0.1)
    assert DynamicGossipMixer(sched, faults=faults).topo.faults is faults
    assert DynamicGossipMixer(sched, faults=FaultConfig()).topo.faults is None
    with pytest.raises(ValueError, match="ef_rebase_every=0"):
        DynamicCompressedGossipMixer(StaticSchedule(W, device="cpu"), ef, faults=faults,
                                     ef_rebase_every=0)


def test_mix_tree_matches_reference():
    """``mix_tree`` (consensus on any dict at this round's W, no state
    advance) on the dense and the gossip lowering, against the reference's
    dense dynamic mixer on its own W_r."""
    ref_sched = ref_schedule.DropoutSchedule(W, 0.3, seed=4)
    ref_m = ref_mixers.DynamicDenseMixer(ref_sched)
    replay = ReplaySchedule(ref_sched, 3)
    tree = _tree(2)
    for r in range(3):
        ref_state = ref_m.init_state(tree)._replace(rounds=jnp.int32(r))
        want = jax.jit(ref_m.mix_tree)(jax.tree.map(jnp.asarray, tree), ref_state)
        for port_m in (DynamicDenseMixer(replay), DynamicGossipMixer(replay)):
            state = port_m.init_state(_port(tree))._replace(rounds=r)
            _close(port_m.mix_tree(_port(tree), state), want, rtol=1e-6, atol=1e-6)
            assert port_m.init_state(_port(tree)).rounds == 0
    with pytest.raises(NotImplementedError):
        DynamicCompressedDenseMixer(replay, CompressionConfig(kind="int8")).mix_tree(
            _port(tree), None)
