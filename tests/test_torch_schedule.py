"""The port's compression schedules against the reference's.

``ScheduleConfig`` and ``CompressionSchedule`` validation, the rate of every
schedule kind for every codec kind over a fixed sequence of (rounds,
res_norm, res_ref), ``gamma_for`` (with and without ``damp_gamma``),
``update_ref`` and ``quant_bits``: bitwise, since the port reproduces the
reference's float32 arithmetic operation for operation.

Then scheduled dense consensus rounds (CHOCO error feedback, and the
memoryless wire under a linear schedule) on identical θ, θ̂ and schedule
state, with the reference's own uniforms injected through the port's
``uniforms`` hook — every codec that takes a rate: int8 per node, int8 with
``use_kernel=True`` (the reference's Pallas kernel in interpret mode, as
tests/test_schedule.py runs it; the port's plain version of B.2 with the
rate as a 0-d tensor), int4 in the int8 container, topk and randk.  The
round's rate is held bitwise, the payload is then the same, θ and θ̂ agree
to float32 rounding of the W product (rtol 1e-6, atol 1e-6), ``res_norm``
at rtol 1e-6, ``res_ref`` and ``rounds`` exactly, ``wire_bits`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CompressionConfig as RefCompressionConfig
from repro.comm import ScheduleConfig as RefScheduleConfig
from repro.comm import quant_bits as ref_quant_bits
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.comm.schedule import CompressionSchedule as RefSchedule
from repro.core.consensus import make_dense_mixer as ref_make_dense_mixer
from repro.graphs import build_graph, metropolis_weights
from repro_torch import convert
from repro_torch.comm import (
    CompressionConfig,
    CompressionSchedule,
    ScheduleConfig,
    quant_bits,
)
from repro_torch.comm.protocol import scalar
from repro_torch.core import RobustConfig, TrainStepConfig, build_train_step, init_state
from repro_torch.core.consensus import make_dense_mixer
from repro_torch.optim import sgd

K = 6
W = metropolis_weights(build_graph("erdos_renyi", K, p=0.5, seed=1))
SHAPES = {"fc0": {"w": (20, 8), "b": (8,)}, "fc1": {"w": (8, 3), "b": (3,)}}
CODECS = ("int8", "int4", "topk", "randk")
# (rounds, res_norm, res_ref): before and after the warmup, an unlatched
# reference, norms above, at and below the threshold's, and a vanishing one
SEQUENCE = [(0, 0.0, 0.0), (1, 3.0, 0.0), (2, 2.5, 0.0), (3, 2.5, 2.5), (4, 2.0, 2.5),
            (5, 1.0, 2.5), (7, 0.3, 2.5), (9, 1e-3, 2.5), (12, 5.0, 2.5), (40, 0.7, 1.3),
            (400, 1e-30, 1.3)]


def _pair(kind, codec, **kw):
    ratio = 0.05
    ref = RefSchedule(RefScheduleConfig(kind=kind, **kw), codec, ratio)
    port = CompressionSchedule(ScheduleConfig(kind=kind, **kw), codec, ratio)
    return ref, port


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("kwargs", [dict(kind="cosine"), dict(threshold=0.0),
                                    dict(threshold=1.5), dict(anneal_rounds=0)],
                         ids=["kind", "threshold0", "threshold1.5", "anneal0"])
def test_schedule_config_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        RefScheduleConfig(**kwargs)
    with pytest.raises(ValueError):
        ScheduleConfig(**kwargs)


@pytest.mark.parametrize("codec,kwargs", [
    ("int8", {}), ("int4", {}), ("topk", {}), ("int8", dict(rate_hi=200.0)),
    ("int8", dict(rate_lo=0.5)), ("int4", dict(rate_lo=9.0)), ("topk", dict(rate_hi=1.5)),
    ("bf16", {}), ("randk", dict(rate_lo=0.01, rate_hi=0.9))])
def test_schedule_ranges_match_reference(codec, kwargs):
    """The resolved [lo, hi] per codec, and the same refusals: quantizer
    rates outside [1, 127] (the int8 container), sparsifier rates outside
    (0, 1], lo > hi, a codec with no rate."""
    cfg = dict(kind="linear", **kwargs)
    try:
        ref = RefSchedule(RefScheduleConfig(**cfg), codec, 0.05)
    except ValueError:
        with pytest.raises(ValueError):
            CompressionSchedule(ScheduleConfig(**cfg), codec, 0.05)
        return
    port = CompressionSchedule(ScheduleConfig(**cfg), codec, 0.05)
    assert (port.hi, port.lo, port.sparsifier) == (ref.hi, ref.lo, ref.sparsifier)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind,kw", [("constant", {}), ("linear", dict(anneal_rounds=30)),
                                     ("adaptive", dict(warmup_rounds=3, threshold=0.8)),
                                     ("adaptive", dict(warmup_rounds=0, threshold=1.0))],
                         ids=["constant", "linear", "adaptive", "adaptive-nowarmup"])
def test_rates_match_reference(codec, kind, kw):
    """Bitwise over SEQUENCE; the port's rate is a 0-d float32 tensor on the
    norms' device."""
    ref, port = _pair(kind, codec, **kw)
    for rounds, norm, ref_norm in SEQUENCE:
        want = ref.rate(jnp.int32(rounds), jnp.float32(norm), jnp.float32(ref_norm))
        got = port.rate(rounds, scalar(norm, "cpu"), scalar(ref_norm, "cpu"))
        assert got.dtype == torch.float32 and got.shape == ()
        assert _bits(got.numpy()) == _bits(want), (rounds, norm, ref_norm, float(got),
                                                   float(want))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("damp", [False, True])
def test_gamma_for_matches_reference(codec, damp):
    """γ stays the host float unless a sparsifier schedule damps it; then
    min(γ, 2·rate), bitwise."""
    ref, port = _pair("linear", codec, anneal_rounds=10, damp_gamma=damp)
    assert port.gamma_for(0.1, None) == ref.gamma_for(0.1, None) == 0.1
    for rounds in (0, 3, 10):
        rate_p = port.rate(rounds, scalar(0.0, "cpu"), scalar(0.0, "cpu"))
        rate_r = ref.rate(jnp.int32(rounds), jnp.float32(0.0), jnp.float32(0.0))
        for gamma in (0.1, 1.0):
            want, got = ref.gamma_for(gamma, rate_r), port.gamma_for(gamma, rate_p)
            if isinstance(want, float):
                assert got == want
            else:
                assert _bits(got.numpy()) == _bits(want)


@pytest.mark.parametrize("kind", ["constant", "linear", "adaptive"])
def test_update_ref_matches_reference(kind):
    """The latch of the first post-warmup norm, carried through SEQUENCE."""
    ref, port = _pair(kind, "int8", warmup_rounds=3)
    ref_r, port_r = jnp.float32(0.0), scalar(0.0, "cpu")
    for rounds, norm, _ in SEQUENCE:
        ref_r = ref.update_ref(jnp.int32(rounds), jnp.float32(norm), ref_r)
        port_r = port.update_ref(rounds, scalar(norm, "cpu"), port_r)
        assert _bits(port_r.numpy()) == _bits(ref_r), rounds


def test_quant_bits_matches_reference():
    """ceil(log2(2·qmax + 1)) in float32, bitwise, at the int8 and int4
    ceilings, at powers of two and between them, from a float or a tensor."""
    for q in (1.0, 3.0, 7.0, 7.5, 15.0, 31.5, 63.5, 64.0, 100.25, 126.9, 127.0):
        want = _bits(ref_quant_bits(q))
        assert _bits(quant_bits(q).numpy()) == want, q
        assert _bits(quant_bits(torch.tensor(q)).numpy()) == want, q


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
        np.testing.assert_allclose(t.numpy(), want[n], err_msg=n, **tol)


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


SCHEDULED = {
    "int8-adaptive": dict(kind="int8", schedule=dict(kind="adaptive", warmup_rounds=2,
                                                     threshold=0.9)),
    "int8-linear": dict(kind="int8", schedule=dict(kind="linear", anneal_rounds=4)),
    "int8-constant": dict(kind="int8", schedule=dict(kind="constant")),
    "int8-kernel-adaptive": dict(kind="int8", use_kernel=True, block_d=16,
                                 schedule=dict(kind="adaptive", warmup_rounds=2,
                                               threshold=0.9)),
    "int8-kernel-linear": dict(kind="int8", use_kernel=True, block_d=16,
                               schedule=dict(kind="linear", anneal_rounds=4)),
    "int8-kernel-constant": dict(kind="int8", use_kernel=True, block_d=16,
                                 schedule=dict(kind="constant")),
    "int4-adaptive": dict(kind="int4", schedule=dict(kind="adaptive", warmup_rounds=2,
                                                     threshold=0.9, rate_hi=7.0,
                                                     rate_lo=2.0)),
    "topk-adaptive": dict(kind="topk", ratio=0.4, schedule=dict(kind="adaptive",
                                                                warmup_rounds=2)),
    "topk-linear-damped": dict(kind="topk", ratio=0.4,
                               schedule=dict(kind="linear", anneal_rounds=4, damp_gamma=True)),
    "randk-linear": dict(kind="randk", ratio=0.4, schedule=dict(kind="linear",
                                                                anneal_rounds=4)),
    "int8-kernel-linear-memoryless": dict(kind="int8", use_kernel=True, block_d=16,
                                          error_feedback=False,
                                          schedule=dict(kind="linear", anneal_rounds=4)),
    "int8-linear-memoryless": dict(kind="int8", error_feedback=False,
                                   schedule=dict(kind="linear", anneal_rounds=4)),
}


def _configs(spec):
    spec = dict(spec, seed=3)
    sched = spec.pop("schedule")
    ref_extra = dict(interpret=True) if spec.get("use_kernel") else {}
    return (RefCompressionConfig(**spec, **ref_extra, schedule=RefScheduleConfig(**sched)),
            CompressionConfig(**spec, schedule=ScheduleConfig(**sched)))


@pytest.mark.parametrize("name", list(SCHEDULED))
def test_scheduled_dense_rounds_match_reference(name):
    """Six rounds, each started from the reference's θ, θ̂ and schedule
    state (res_norm, res_ref, rounds), so the port computes the rate from
    the same inputs: rate bitwise, outputs at rtol 1e-6, wire_bits exact.
    Random normal inputs: no tied magnitudes for topk."""
    ref_cfg, cfg = _configs(SCHEDULED[name])
    uniforms = ReferenceUniforms()
    ref_m = ref_make_dense_mixer(W, compression=ref_cfg)
    port_m = make_dense_mixer(W, compression=cfg, device="cpu", uniforms=uniforms)
    assert port_m.traced_wire and ref_m.traced_wire
    theta = _tree(0)
    ref_theta, port_theta = jax.tree.map(jnp.asarray, theta), _port(theta)
    ref_state, port_state = ref_m.init_state(theta), port_m.init_state(_port(theta))
    ef = cfg.error_feedback
    for r in range(6):
        uniforms.record(r, ref_state, ref_theta)
        want_rate = ref_m._rate(ref_state)
        got_rate = port_m.wire.rate(port_state)
        assert _bits(got_rate.numpy()) == _bits(want_rate), (r, float(got_rate),
                                                              float(want_rate))
        ref_theta, ref_state = ref_m(ref_theta, ref_state)
        port_theta, port_state = port_m(port_theta, port_state)
        _assert_tree_close(port_theta, ref_theta, rtol=1e-6, atol=1e-6)
        if ef:
            _assert_tree_close(port_state.hat, ref_state.hat, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(port_state.res_norm), float(ref_state.res_norm),
                                   rtol=1e-6)
        assert port_state.rounds == int(ref_state.rounds) == r + 1
        assert float(port_state.wire_bits) == float(ref_state.wire_bits), r
        # the next round starts from the reference's state on both sides
        port_theta = _port(jax.tree.map(np.asarray, ref_theta))
        port_state = port_state._replace(
            res_norm=torch.from_numpy(np.array(ref_state.res_norm)),
            res_ref=torch.from_numpy(np.array(ref_state.res_ref)))
        if ef:
            port_state = port_state._replace(hat=_port(jax.tree.map(np.asarray,
                                                                     ref_state.hat)))
        assert np.asarray(port_state.res_ref) == np.asarray(ref_state.res_ref)
    if "adaptive" in name:
        assert float(ref_state.res_ref) > 0  # the latch happened inside the run


def test_scheduled_step_bills_the_measured_wire():
    """A scheduled mixer reports ``traced_wire``, so the train step's
    ``comm_bytes`` is the round's ``wire_bits / 8`` (the reference's
    repro/core/drdsgd.py:152-153, 230-232), and the linear rate's bits fall
    as it anneals."""
    cfg = CompressionConfig(kind="int8", use_kernel=True,
                            schedule=ScheduleConfig(kind="linear", anneal_rounds=3))
    mixer = make_dense_mixer(W, compression=cfg, device="cpu")
    params = {"w": torch.randn(K, 40, generator=torch.Generator().manual_seed(0))}

    def loss_fn(p, batch):
        return (p["w"] ** 2).mean(dim=1)

    step = build_train_step(loss_fn, sgd(0.1), mixer,
                            TrainStepConfig(robust=RobustConfig(mu=3.0), compression=cfg))
    state = init_state(params, sgd(0.1), mixer=mixer)
    bits = []
    for _ in range(5):
        state, m = step(state, None)
        assert float(m["comm_bytes"]) == float(m["wire_bits"]) / 8.0
        bits.append(float(m["wire_bits"]))
    # 40 entries per node at ceil(log2(2·qmax + 1)) bits + one f32 scale
    assert bits[0] == K * (8 * 40 + 32) and bits[-1] == K * (4 * 40 + 32)
    assert bits == sorted(bits, reverse=True)
