"""The port's federated hub (``HubMixer``, ``StarTopology``, ``StarTransport``,
``make_hub_mixer``), FedAvg and SCAFFOLD, and ``RepeatMixer``, against the
reference's ``repro.core.consensus``.

Held: the hub is exact one-round consensus (every node the same bits, the
node mean at rtol 1e-6) and equals the dense star matrix and the
reference's hub at rtol 1e-6; its state is trivial and its wire is K
uploads + K downloads; the compressed hub is the dense codec stack over the
star W and equals the reference's with the reference's own uniforms
(payload exact, θ and θ̂ at rtol 1e-6; one grouped B.2 per round, its plain
version here); FedAvg passes θ through on local rounds and averages exactly
on the H-th; FedAvg, SCAFFOLD and int8 FedAvg train through ``TrainerSpec``
(``--topology hub``) with the reference trainer's trajectory at rtol 1e-5
and its per-step bytes; ``RepeatMixer`` sums its inner rounds' bits.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CompressionConfig as RefCompressionConfig
from repro.comm.compressors import _uniform_rows, fold_leaf, per_node_keys
from repro.core import TrainerSpec as RefTrainerSpec
from repro.core.consensus import DenseMixer as RefDenseMixer
from repro.core.consensus import HubMixer as RefHubMixer
from repro.core.consensus import make_hub_mixer as ref_make_hub_mixer
from repro.core.consensus import repeat_mixer as ref_repeat_mixer
from repro.dynamics import LocalUpdateMixer as RefLocalUpdateMixer
from repro_torch import convert
from repro_torch.comm import (
    CommState,
    CompressedDenseMixer,
    CompressionConfig,
    StarTopology,
    StarTransport,
)
from repro_torch.core import DenseMixer, HubMixer, RepeatMixer, TrainerSpec, make_hub_mixer
from repro_torch.core import repeat_mixer
from repro_torch.dynamics import (
    DynamicsConfig,
    FaultConfig,
    LocalUpdateMixer,
    build_dynamic_mixer,
)
from repro_torch.kernels.quant_gossip import ops as qops

K = 8


def _theta(k=K, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(k, 6, 3)).astype(np.float32),
            "b": rng.normal(size=(k, 5)).astype(np.float32)}


def _port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def test_hub_is_exact_one_round_consensus():
    theta = _theta()
    mixer = HubMixer(K, device="cpu")
    out, comm = mixer(_port(theta), mixer.init_state(_port(theta)))
    for name, x in theta.items():
        got = out[name]
        # every node holds the identical global average after one round
        assert torch.equal(got, got[0].expand(got.shape))
        np.testing.assert_allclose(got[0].numpy(), x.mean(0), rtol=1e-6, atol=1e-7)
        assert got.is_contiguous() and got.dtype == torch.float32
    assert comm.rounds == 1
    # K uploads + K downloads of the per-node block
    assert mixer.bytes_per_round(_port(theta)) == 2 * sum(x.size * 4 for x in theta.values())
    assert float(comm.wire_bits) == 8.0 * mixer.bytes_per_round(_port(theta))


def test_hub_matches_dense_star_matrix_and_reference():
    theta = _theta()
    hub = HubMixer(K, device="cpu")
    dense = DenseMixer(np.full((K, K), 1.0 / K), device="cpu")
    th, sh = hub(_port(theta), hub.init_state(_port(theta)))
    td, _ = dense(_port(theta), dense.init_state(_port(theta)))
    ref = RefHubMixer(K)
    tr, sr = jax.jit(ref)(jax.tree.map(jnp.asarray, theta), ref.init_state(theta))
    for name in theta:
        np.testing.assert_allclose(th[name].numpy(), td[name].numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(th[name].numpy(), np.asarray(tr[name]), rtol=1e-6, atol=1e-7)
    assert float(sh.wire_bits) == float(sr.wire_bits)
    assert hub.bytes_per_round(_port(theta)) == ref.bytes_per_round(theta)
    # a bfloat16 leaf averages in float32 and comes back in bfloat16
    xb = torch.from_numpy(theta["b"]).to(torch.bfloat16)
    out = StarTransport(K).apply({"b": xb})["b"]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0], xb.float().mean(0).to(torch.bfloat16))


def test_hub_protocol_state_is_trivial():
    theta = _port(_theta())
    hub = HubMixer(K, device="cpu")
    st = hub.init_state(theta)
    assert isinstance(st, CommState)
    assert st.hat == () and st.hat_mix == () and st.track == ()
    assert hub.compression is None and hub.traced_wire is False
    topo = StarTopology(K, device="cpu")
    assert not topo.time_varying
    np.testing.assert_array_equal(topo.base_weights(), np.full((K, K), 1.0 / K))
    with pytest.raises(ValueError, match="k >= 1"):
        StarTopology(0, device="cpu")
    with pytest.raises(ValueError, match="k >= 1"):
        StarTransport(0)


def test_make_hub_mixer_compressed_rides_dense_star():
    """The int8 hub is the dense codec stack over W = 11ᵀ/K; with the
    reference's own uniforms it gives the reference's round (kernel
    quantizer: one grouped B.2 call per round, its plain version here)."""
    kw = dict(kind="int8", use_kernel=True, seed=3, block_d=16)
    by_round = {}

    def uniforms(rounds, leaf_idx, shape):
        return by_round[rounds][leaf_idx]

    m = make_hub_mixer(K, CompressionConfig(**kw), device="cpu", uniforms=uniforms)
    ref = ref_make_hub_mixer(K, RefCompressionConfig(**kw))
    assert isinstance(m, CompressedDenseMixer)
    np.testing.assert_allclose(m.w.numpy(), np.full((K, K), 1.0 / K), rtol=1e-7)
    theta = _theta()
    ref_theta, ref_state = jax.tree.map(jnp.asarray, theta), ref.init_state(theta)
    state = m.init_state(_port(theta))
    step = jax.jit(lambda t, s: ref(t, s))
    for r in range(3):
        _, sub = jax.random.split(ref_state.key)
        node_ks = per_node_keys(sub, jnp.arange(K))
        by_round[r] = [np.asarray(_uniform_rows(fold_leaf(node_ks, i), x.size // K))
                       for i, x in enumerate(jax.tree.leaves(ref_theta))]
        state = state._replace(hat=_port(jax.tree.map(np.asarray, ref_state.hat)))
        before = qops.quantize_blockwise_grouped.plain_calls
        out, state = m(_port(jax.tree.map(np.asarray, ref_theta)), state)
        assert qops.quantize_blockwise_grouped.plain_calls == before + 1
        ref_theta, ref_state = step(ref_theta, ref_state)
        for n in theta:
            np.testing.assert_allclose(out[n].numpy(), np.asarray(ref_theta[n]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(state.hat[n].numpy(), np.asarray(ref_state.hat[n]),
                                       rtol=1e-6, atol=1e-6)
        assert float(state.wire_bits) == float(ref_state.wire_bits)
    # the quantized server average still contracts hard toward consensus
    out, _ = make_hub_mixer(K, CompressionConfig(kind="int8", seed=3), device="cpu")(
        _port(theta), make_hub_mixer(K, CompressionConfig(kind="int8", seed=3),
                                     device="cpu").init_state(_port(theta)))
    spread0 = max(np.ptp(x, axis=0).max() for x in theta.values())
    spread1 = max(float((out[n].max(0).values - out[n].min(0).values).max()) for n in theta)
    assert spread1 < 0.1 * spread0
    assert isinstance(make_hub_mixer(K, device="cpu"), HubMixer)
    assert isinstance(make_hub_mixer(K, CompressionConfig(kind="none"), device="cpu"), HubMixer)


def test_dynamics_config_hub_validation():
    assert DynamicsConfig(topology="hub").enabled
    DynamicsConfig(topology="hub", faults=FaultConfig())  # disabled faults pass
    with pytest.raises(ValueError, match="hub"):
        DynamicsConfig(topology="hub", faults=FaultConfig(straggler_p=0.2))
    with pytest.raises(ValueError, match="codec wires on the hub"):
        from repro_torch.comm.composed import ComposedMixer
        from repro_torch.comm.wire import make_codec_wire

        ComposedMixer(StarTopology(K, device="cpu"), StarTransport(K),
                      make_codec_wire(CompressionConfig(kind="int8")))


def test_build_dynamic_mixer_hub_paths():
    w = np.full((K, K), 1.0 / K)
    m = build_dynamic_mixer(DynamicsConfig(topology="hub"), w, device="cpu")
    assert isinstance(m, HubMixer)
    fed = build_dynamic_mixer(DynamicsConfig(topology="hub", local_updates=4), w, device="cpu")
    assert isinstance(fed, LocalUpdateMixer) and fed.period == 4
    assert isinstance(fed.inner, HubMixer) and not fed.gt
    scaffold = build_dynamic_mixer(DynamicsConfig(topology="hub", local_updates=4,
                                                  gradient_tracking=True), w, device="cpu")
    assert scaffold.gt and isinstance(scaffold.inner, HubMixer)
    comp = build_dynamic_mixer(DynamicsConfig(topology="hub"), w,
                               compression=CompressionConfig(kind="int8"), device="cpu")
    assert isinstance(comp, CompressedDenseMixer)
    fed8 = build_dynamic_mixer(DynamicsConfig(topology="hub", local_updates=4), w,
                               compression=CompressionConfig(kind="int8"), device="cpu")
    assert isinstance(fed8, LocalUpdateMixer) and isinstance(fed8.inner, CompressedDenseMixer)


def test_fedavg_rounds_local_then_exact_average():
    theta = _port(_theta())
    fed = LocalUpdateMixer(HubMixer(K, device="cpu"), 3)
    st = fed.init_state(theta)
    t = theta
    for r in range(2):  # rounds 0, 1: local (no wire, θ untouched)
        t, st = fed(t, st)
        assert float(st.wire_bits) == 0.0
        for name in theta:
            assert torch.equal(t[name], theta[name])
    t, st = fed(t, st)  # round 2 = H − 1: the exact server average
    assert float(st.wire_bits) > 0.0
    ref = RefLocalUpdateMixer(RefHubMixer(K), 3)
    rt, rs = jax.tree.map(jnp.asarray, _theta()), ref.init_state(_theta())
    for _ in range(3):
        rt, rs = jax.jit(ref)(rt, rs)
    for name, x in _theta().items():
        np.testing.assert_allclose(t[name].numpy(), np.broadcast_to(x.mean(0), x.shape),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t[name].numpy(), np.asarray(rt[name]), rtol=1e-6, atol=1e-7)
    assert st.rounds == int(rs.rounds) == 3
    assert float(st.wire_bits) == float(rs.wire_bits)


@pytest.mark.parametrize("h,gt,compress", [(1, False, "none"), (4, False, "none"),
                                           (4, True, "none"), (2, True, "none"),
                                           (4, False, "int8")],
                         ids=["hub-H1", "fedavg-H4", "scaffold-H4", "scaffold-H2",
                              "fedavg-int8-H4"])
def test_federated_training_matches_reference(h, gt, compress):
    """--topology hub through TrainerSpec: hub H = 1, FedAvg, SCAFFOLD and
    int8 FedAvg (DR-DSGD μ = 3, heterogeneous targets), 8 steps against the
    reference trainer: params at rtol 1e-5 (int8: within 2 quantization
    steps of the state's range, the noise being the port's own), per-step
    bytes exactly, and a consensus round ends at float-noise disagreement."""
    k, steps = 4, 8
    batches = np.broadcast_to(np.arange(k, dtype=np.float32)[None, :, None],
                              (steps, k, 1)).copy()
    common = dict(num_nodes=k, graph="ring", robust=True, mu=3.0, lr=0.2, topology="hub",
                  local_updates=h, gradient_tracking=gt, compress=compress)
    tr = TrainerSpec(device="cpu", **common).build(
        lambda p, b: (p["x"] - b[0]).square().mean(-1))
    before = qops.quantize_blockwise_grouped.plain_calls
    out, ms = tr.run(tr.init({"x": torch.zeros(3)}), (batches,))
    ref_tr = RefTrainerSpec(metrics_disagreement=True, **common).build(
        lambda p, b: jnp.mean((p["x"] - b) ** 2))
    ref_out, ref_ms = ref_tr.run(ref_tr.init({"x": jnp.zeros(3)}), jnp.asarray(batches))
    x, ref_x = out.params["x"].numpy(), np.asarray(ref_out.params["x"])
    if compress == "none":
        np.testing.assert_allclose(x, ref_x, rtol=1e-5, atol=1e-6)
        # consensus rounds snap disagreement to float noise (exact server average)
        assert float(ms["disagreement"][-1]) < 1e-6
    else:
        step = 2 * np.abs(ref_x).max() / 127
        np.testing.assert_allclose(x, ref_x, rtol=0, atol=step)
    np.testing.assert_array_equal(ms["comm_bytes"].numpy(), np.asarray(ref_ms["comm_bytes"]))
    assert float(ms["comm_bytes"][h - 1]) > 0 and (ms["comm_bytes"][: h - 1] == 0).all()
    # the average model moved toward the global mean target 1.5
    assert abs(float(out.params["x"].mean()) - 1.5) < 1.0
    assert np.isfinite(ms["loss_mean"].numpy()).all()
    if compress == "int8":  # the kernel quantizer is not the default; the wire is per-node
        assert qops.quantize_blockwise_grouped.plain_calls == before


def test_int8_fedavg_on_the_kernel_quantizer_calls_b2_once_per_consensus_round():
    """int8 FedAvg with ``use_kernel``: one grouped B.2 call (its plain
    version here) per consensus round, none on local rounds."""
    k, steps, h = 4, 8, 4
    batches = np.broadcast_to(np.arange(k, dtype=np.float32)[None, :, None],
                              (steps, k, 1)).copy()
    spec = TrainerSpec(num_nodes=k, graph="ring", mu=3.0, lr=0.2, topology="hub",
                       local_updates=h, compress=CompressionConfig(kind="int8", use_kernel=True),
                       device="cpu")
    tr = spec.build(lambda p, b: (p["x"] - b[0]).square().mean(-1))
    state = tr.init({"x": torch.zeros(3)})
    calls = []
    for t in range(steps):
        before = qops.quantize_blockwise_grouped.plain_calls
        state, _ = tr.step(state, (batches[t],))
        calls.append(qops.quantize_blockwise_grouped.plain_calls - before)
    assert calls == [0, 0, 0, 1] * 2


def test_repeat_mixer_sums_wire_and_matches_reference():
    w = np.full((K, K), 1.0 / K) * 0.5 + np.eye(K) * 0.5
    theta = _theta()
    rep = repeat_mixer(DenseMixer(w, device="cpu"), 3)
    assert isinstance(rep, RepeatMixer)
    ref = ref_repeat_mixer(RefDenseMixer(w), 3)
    out, st = rep(_port(theta), rep.init_state(_port(theta)))
    ref_out, ref_st = jax.jit(ref)(jax.tree.map(jnp.asarray, theta), ref.init_state(theta))
    for n in theta:
        np.testing.assert_allclose(out[n].numpy(), np.asarray(ref_out[n]), rtol=1e-6,
                                   atol=1e-6)
    assert float(st.wire_bits) == float(ref_st.wire_bits) == \
        3 * 8.0 * DenseMixer(w, device="cpu").bytes_per_round(_port(theta))
    assert st.rounds == int(ref_st.rounds) == 3
    assert rep.bytes_per_round(_port(theta)) == ref.bytes_per_round(theta)
    assert rep.compression is None and not rep.traced_wire
    with pytest.raises(ValueError, match="rounds"):
        RepeatMixer(DenseMixer(w, device="cpu"), 0)


def test_hub_cli_threading():
    ap = argparse.ArgumentParser()
    TrainerSpec.add_cli_args(ap)
    args = ap.parse_args(["--topology", "hub", "--local-updates", "2", "--device", "cpu"])
    spec = TrainerSpec.from_args(args, num_nodes=K, graph="ring")
    cfg = spec.dynamics_config()
    assert cfg is not None and cfg.topology == "hub" and cfg.local_updates == 2
    tr = spec.build(lambda p, b: p["x"].square().sum(-1))
    assert isinstance(tr.mixer, LocalUpdateMixer) and isinstance(tr.mixer.inner, HubMixer)
    with pytest.raises(SystemExit):
        ap.parse_args(["--topology", "blimp"])
    # hub + stragglers must fail loudly at config build
    args = ap.parse_args(["--topology", "hub", "--straggler-p", "0.2"])
    with pytest.raises(ValueError, match="hub"):
        TrainerSpec.from_args(args).dynamics_config()
