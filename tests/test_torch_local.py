"""The port's local updates (``repro_torch.dynamics.LocalUpdateMixer``, with
gradient tracking), the consensus period ``mix_every`` and their conflict,
against the reference's ``repro.dynamics.local`` and ``repro.core.drdsgd``.

Every stack here is deterministic (a static schedule), so both packages run
the same arithmetic live: the wrapper's rounds at H ∈ {1, 2, 3}, with and
without tracking, give θ, the tracker (correction, anchor) at rtol 1e-6
(float32 order of the W product), and ``wire_bits`` and the round clock
exactly; H = 1 equals the inner mixer bit for bit; DR-DSGD trajectories
with gradient tracking (8 steps) and with ``mix_every`` agree with the
reference trainer's at rtol 1e-5 with the same per-step ``comm_bytes`` and
``wire_bits``.  The EF re-base clock under local updates is held on the
reference test's literal numbers (its gossip mesh needs 8 host devices):
``ef_rounds == [0,1,1,2,2,3,3,4]``, 16·8·(d+4) bits per delta round and
16·32·d per re-base, and the int8 kernel wire calls B.4/B.5 (their plain
versions here) only on consensus rounds.  The anchor and the correction
own their storage, so an in-place step cannot move them; the fused B.1 step
declines ``mix_every`` > 1 and wrapper mixers.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TrainerSpec as RefTrainerSpec
from repro.dynamics import DynamicDenseMixer as RefDynamicDenseMixer
from repro.dynamics import LocalUpdateMixer as RefLocalUpdateMixer
from repro.dynamics import StaticSchedule as RefStaticSchedule
from repro.graphs import build_graph, metropolis_weights
from repro_torch import convert
from repro_torch.comm import CompressionConfig
from repro_torch.core import DenseMixer, TrainerSpec, repeat_mixer
from repro_torch.core.consensus import make_dense_mixer
from repro_torch.core.drdsgd import _fused_w
from repro_torch.dynamics import (
    DropoutSchedule,
    DynamicCompressedGossipMixer,
    DynamicDenseMixer,
    LocalUpdateMixer,
    StaticSchedule,
)
from repro_torch.kernels.gossip_update import ops as gops
from repro_torch.kernels.quant_gossip import ops as qops
from repro_torch.optim import Optimizer, sgd

K = 6
W = metropolis_weights(build_graph("ring", K))


def _theta(k, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((k, 5, 3))).astype(np.float32),
            "b": (scale * rng.standard_normal((k, 7))).astype(np.float32)}


def _port(tree):
    return convert.params_from_numpy(tree, device="cpu")


def _close(port_tree, ref_tree, rtol=1e-6, atol=1e-6):
    for n in ("a", "b"):
        np.testing.assert_allclose(port_tree[n].numpy(), np.asarray(ref_tree[n]),
                                   rtol=rtol, atol=atol, err_msg=n)


@pytest.mark.parametrize("period", [1, 2, 3])
@pytest.mark.parametrize("gt", [False, True], ids=["plain", "tracking"])
def test_local_update_mixer_matches_reference(period, gt):
    """8 rounds, each fed the reference's previous output plus the same
    perturbation (a stand-in for the local step): θ, the tracker and the
    wire agree, local rounds bill 0 and tracking bills 2× a consensus
    round; the wrapper owns the step clock."""
    ref_m = RefLocalUpdateMixer(RefDynamicDenseMixer(RefStaticSchedule(W)), period,
                                gradient_tracking=gt)
    port_m = LocalUpdateMixer(DynamicDenseMixer(StaticSchedule(W, device="cpu")), period,
                              gradient_tracking=gt)
    theta = _theta(K, 0)
    ref_state = ref_m.init_state(jax.tree.map(jnp.asarray, theta))
    port_state = port_m.init_state(_port(theta))
    step = jax.jit(lambda t, s: ref_m(t, s))
    ref_theta = jax.tree.map(jnp.asarray, theta)
    plain_bits = 8.0 * DynamicDenseMixer(StaticSchedule(W, device="cpu")).bytes_per_round(
        _port(theta))
    assert port_m.bytes_per_round(_port(theta)) == ref_m.bytes_per_round(theta)
    for r in range(8):
        kick = jax.tree.map(lambda x: jnp.asarray(x * 0.1), _theta(K, 10 + r))
        feed = jax.tree.map(lambda a, b: a + b, ref_theta, kick)
        port_theta, port_state = port_m(_port(jax.tree.map(np.asarray, feed)), port_state)
        ref_theta, ref_state = step(feed, ref_state)
        _close(port_theta, ref_theta)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits), r
        assert port_state.rounds == int(ref_state.rounds) == r + 1
        consensus = r % period == period - 1
        assert float(port_state.wire_bits) == ((2.0 if gt else 1.0) * plain_bits
                                               if consensus else 0.0)
        if gt:
            for port_part, ref_part in zip(port_state.track, ref_state.track):
                _close(port_part, ref_part)
        else:
            assert port_state.track == ()


def test_local_update_period_one_matches_inner_bitexact():
    params = _port(_theta(K, 0))
    inner = DynamicDenseMixer(StaticSchedule(W, device="cpu"))
    wrapped = LocalUpdateMixer(DynamicDenseMixer(StaticSchedule(W, device="cpu")), 1)
    a, sa = inner(params, inner.init_state(params))
    b, sb = wrapped(params, wrapped.init_state(params))
    for n in params:
        assert torch.equal(a[n], b[n]), n
    assert torch.equal(sa.wire_bits, sb.wire_bits) and sa.rounds == sb.rounds == 1


def test_local_rounds_pass_theta_through():
    mixer = LocalUpdateMixer(DynamicDenseMixer(StaticSchedule(W, device="cpu")), 3)
    params = _port(_theta(K, 0))
    out, state = mixer(params, mixer.init_state(params))
    assert all(out[n] is params[n] for n in params)
    assert float(state.wire_bits) == 0.0 and state.rounds == 1


def _quadratic(k, steps, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, 6)).astype(np.float32)
    return c, np.broadcast_to(c[None], (steps, k, 6)).copy()


@pytest.mark.parametrize("h,robust", [(2, False), (4, False), (2, True)])
def test_gradient_tracking_trajectory_matches_reference(h, robust):
    """8 DR-DSGD (or DSGD) steps through TrainerSpec with local updates and
    tracking on a heterogeneous quadratic: params at rtol 1e-5, and the
    per-step comm bytes exactly (0 on local steps, 2× on consensus steps)."""
    k, steps = 8, 8
    _, batches = _quadratic(k, steps)
    common = dict(num_nodes=k, graph="ring", robust=robust, mu=3.0, lr=0.05,
                  local_updates=h, gradient_tracking=True)
    tr = TrainerSpec(device="cpu", **common).build(
        lambda p, b: (p["x"] - b[0]).square().sum(-1))
    out, ms = tr.run(tr.init({"x": torch.zeros(6)}), (batches,))
    ref_tr = RefTrainerSpec(metrics_disagreement=False, **common).build(
        lambda p, b: jnp.sum((p["x"] - b) ** 2))
    ref_out, ref_ms = ref_tr.run(ref_tr.init({"x": jnp.zeros(6)}), jnp.asarray(batches))
    np.testing.assert_allclose(out.params["x"].numpy(), np.asarray(ref_out.params["x"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ms["comm_bytes"].numpy(), np.asarray(ref_ms["comm_bytes"]))
    np.testing.assert_array_equal(ms["wire_bits"].numpy(), np.asarray(ref_ms["wire_bits"]))
    assert (ms["comm_bytes"][: h - 1] == 0).all() and ms["comm_bytes"][h - 1] > 0
    corr, anchor = out.comm.track
    ref_corr, ref_anchor = ref_out.comm.track
    np.testing.assert_allclose(corr["x"].numpy(), np.asarray(ref_corr["x"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(anchor["x"].numpy(), np.asarray(ref_anchor["x"]), rtol=1e-5,
                               atol=1e-6)


def test_gradient_tracking_reduces_local_update_drift():
    """Node i pulls toward c_i.  With H = 8 local steps, plain local SGD
    parks O(η·H) from the global optimum mean(c); tracking collapses that
    drift by a large factor (the reference's claim, on the port)."""
    k = 8
    c, batches = _quadratic(k, 400)
    dists = {}
    for gt in (False, True):
        spec = TrainerSpec(num_nodes=k, graph="ring", robust=False, lr=0.05, local_updates=8,
                           gradient_tracking=gt, device="cpu")
        tr = spec.build(lambda p, b: (p["x"] - b[0]).square().sum(-1))
        state, _ = tr.run(tr.init({"x": torch.zeros(6)}), (batches,))
        dists[gt] = float(np.linalg.norm(state.params["x"].numpy() - c.mean(0)[None],
                                         axis=1).max())
    assert dists[True] < 0.5 * dists[False], dists


def test_gradient_tracking_doubles_consensus_wire():
    params = _port(_theta(K, 0))
    plain = LocalUpdateMixer(DynamicDenseMixer(StaticSchedule(W, device="cpu")), 2)
    gt = LocalUpdateMixer(DynamicDenseMixer(StaticSchedule(W, device="cpu")), 2,
                          gradient_tracking=True)
    sp, sg = plain.init_state(params), gt.init_state(params)
    tp = tg = params
    for r in range(2):
        tp, sp = plain(tp, sp, round=r)
        tg, sg = gt(tg, sg, round=r)
    assert float(sg.wire_bits) == 2.0 * float(sp.wire_bits) > 0
    assert gt.bytes_per_round(params) == 2 * plain.bytes_per_round(params)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_gradient_tracking_rejects_compressed_and_impure_inners():
    from repro.comm import CompressionConfig as RefCompressionConfig
    from repro.comm.mixers import CompressedDenseMixer as RefCompressedDenseMixer
    from repro.core.consensus import DenseMixer as RefDenseMixer
    from repro.core.consensus import repeat_mixer as ref_repeat_mixer

    comp = make_dense_mixer(W, CompressionConfig(kind="int8"), device="cpu")
    ref_comp = RefCompressedDenseMixer(W, RefCompressionConfig(kind="int8"))
    assert _error(lambda: LocalUpdateMixer(comp, 2, gradient_tracking=True)) == \
        _error(lambda: RefLocalUpdateMixer(ref_comp, 2, gradient_tracking=True))
    assert "uncompressed" in _error(lambda: LocalUpdateMixer(comp, 2, True))[1]
    rep = repeat_mixer(DenseMixer(W, device="cpu"), 2)
    ref_rep = ref_repeat_mixer(RefDenseMixer(W), 2)
    assert _error(lambda: LocalUpdateMixer(rep, 2, gradient_tracking=True)) == \
        _error(lambda: RefLocalUpdateMixer(ref_rep, 2, gradient_tracking=True))
    assert _error(lambda: LocalUpdateMixer(rep, 0)) == _error(lambda: RefLocalUpdateMixer(
        ref_rep, 0))
    LocalUpdateMixer(comp, 2)  # compressed inner without tracking is fine


def test_mix_every_conflicts_with_local_update_period():
    def loss_fn(params, batch):
        return params["x"].square().sum(-1)

    with pytest.raises(ValueError, match="clock"):
        TrainerSpec(num_nodes=4, graph="ring", local_updates=2, mix_every=2,
                    device="cpu").build(loss_fn)
    TrainerSpec(num_nodes=4, graph="ring", local_updates=1, mix_every=2,
                device="cpu").build(loss_fn)


@pytest.mark.parametrize("topology", ["static", "dropout"])
def test_mix_every_matches_reference(topology):
    """mix_every = 3: off-steps skip the mixer, pass CommState through and
    bill 0; on a static dense W (the static estimate) and a time-varying one
    (the measured wire), against the reference trainer."""
    k, steps = 6, 7
    _, batches = _quadratic(k, steps, seed=1)
    common = dict(num_nodes=k, graph="ring", robust=True, mu=3.0, lr=0.05, mix_every=3,
                  topology=topology)
    tr = TrainerSpec(device="cpu", **common).build(
        lambda p, b: (p["x"] - b[0]).square().sum(-1))
    out, ms = tr.run(tr.init({"x": torch.zeros(6)}), (batches,))
    ref_tr = RefTrainerSpec(metrics_disagreement=False, **common).build(
        lambda p, b: jnp.sum((p["x"] - b) ** 2))
    ref_out, ref_ms = ref_tr.run(ref_tr.init({"x": jnp.zeros(6)}), jnp.asarray(batches))
    np.testing.assert_allclose(out.params["x"].numpy(), np.asarray(ref_out.params["x"]),
                               rtol=1e-5, atol=1e-6)
    for key in ("comm_bytes", "wire_bits"):
        np.testing.assert_array_equal(ms[key].numpy(), np.asarray(ref_ms[key]), err_msg=key)
    assert list((ms["comm_bytes"] > 0).numpy()) == [False, False, True] * 2 + [False]
    assert out.comm.rounds == int(ref_out.comm.rounds) == 2


def test_fused_step_declines_mix_every_and_wrappers():
    """B.1 mixes on every call: the fused SGD + dense step declines
    mix_every > 1 and wrapper mixers, so a static dense SGD stack with
    mix_every = 2 takes the unfused path (no B.1 call) and equals the
    unfused step bit for bit."""
    opt = sgd(0.05)
    dense = DenseMixer(W, device="cpu")
    assert _fused_w(opt, dense, 1) is not None
    assert _fused_w(opt, dense, 2) is None
    assert _fused_w(opt, LocalUpdateMixer(dense, 1), 1) is None
    assert _fused_w(opt, LocalUpdateMixer(dense, 2, gradient_tracking=True), 1) is None
    assert _fused_w(opt, repeat_mixer(dense, 2), 1) is None
    _, batches = _quadratic(K, 6, seed=2)
    runs = {}
    for tag, o in (("sgd", opt), ("unfused", Optimizer(opt.init, opt.update))):
        spec = TrainerSpec(num_nodes=K, graph="ring", mu=3.0, lr=0.05, mix_every=2,
                           device="cpu")
        tr = spec.build(lambda p, b: (p["x"] - b[0]).square().sum(-1), optimizer=o)
        before = gops.gossip_update_stacked_grouped.plain_calls
        runs[tag] = tr.run(tr.init({"x": torch.zeros(6)}), (batches,))
        assert gops.gossip_update_stacked_grouped.plain_calls == before
    assert torch.equal(runs["sgd"][0].params["x"], runs["unfused"][0].params["x"])
    for key in runs["sgd"][1]:
        assert torch.equal(runs["sgd"][1][key], runs["unfused"][1][key]), key
    # and mix_every = 1 still fuses
    tr = TrainerSpec(num_nodes=K, graph="ring", lr=0.05, device="cpu").build(
        lambda p, b: (p["x"] - b[0]).square().sum(-1), optimizer=opt)
    before = gops.gossip_update_stacked_grouped.plain_calls
    tr.run(tr.init({"x": torch.zeros(6)}), (batches,))
    assert gops.gossip_update_stacked_grouped.plain_calls == before + 6


@pytest.mark.parametrize("use_kernel", [False, True], ids=["int8", "int8-kernel"])
def test_ef_rebase_clock_composes_with_local_updates(use_kernel):
    """The re-base cadence follows ``ef_rounds`` (executed EF consensus
    rounds), not the step clock the wrapper owns: with H = 2 and B = 2,
    steps 0/2/4/6 are local (0 wire), steps 1/5 int8 delta rounds and 3/7
    f32 re-bases (the reference test's literal numbers).  On the kernel
    wire B.4 runs once per consensus round and B.5 once per matching of a
    delta round; local rounds call neither."""
    k, d = 8, 64
    w = metropolis_weights(build_graph("ring", k))
    theta = {"a": torch.from_numpy(np.random.default_rng(0).normal(size=(k, d))
                                   .astype(np.float32))}
    inner = DynamicCompressedGossipMixer(
        DropoutSchedule(w, 0.0, seed=2, device="cpu"),
        CompressionConfig(kind="int8", seed=1, use_kernel=use_kernel), ef_rebase_every=2)
    mixer = LocalUpdateMixer(inner, 2)
    state = mixer.init_state(theta)
    wires, efs, calls = [], [], []
    t = theta
    for r in range(8):
        before = (qops.masked_quantize_blockwise_grouped.plain_calls,
                  qops.masked_dequant_accumulate_grouped_.plain_calls)
        t, state = mixer(t, state, round=r)
        calls.append((qops.masked_quantize_blockwise_grouped.plain_calls - before[0],
                      qops.masked_dequant_accumulate_grouped_.plain_calls - before[1]))
        wires.append(float(state.wire_bits))
        efs.append(int(state.ef_rounds))
    assert efs == [0, 1, 1, 2, 2, 3, 3, 4], efs
    assert wires[0] == wires[2] == wires[4] == wires[6] == 0.0, wires
    per_delta = 16 * 8.0 * (d + 4)          # active links x int8 payload bits
    per_rebase = 16 * 32.0 * d              # active links x f32 bits
    assert wires[1] == wires[5] == per_delta, wires
    assert wires[3] == wires[7] == per_rebase, wires
    assert state.rounds == 8  # the wrapper owns the step clock
    if use_kernel:
        matchings = len(inner.transport.srcs)
        assert calls == [(0, 0), (1, matchings), (0, 0), (1, 0)] * 2, calls


def test_anchor_and_correction_own_their_storage():
    """The tracker must not alias θ: not at init, not after a consensus
    round, not after the trainer's in-place clip — and an in-place write to
    θ leaves it untouched."""
    params = _port(_theta(K, 0))
    mixer = LocalUpdateMixer(DynamicDenseMixer(StaticSchedule(W, device="cpu")), 2,
                             gradient_tracking=True)
    state = mixer.init_state(params)

    def storages(tree):
        return {x.untyped_storage().data_ptr() for x in tree.values()}

    corr, anchor = state.track
    assert not storages(anchor) & storages(params) and not storages(corr) & storages(params)
    t = params
    for r in range(2):
        t, state = mixer(t, state, round=r)
    corr, anchor = state.track
    assert not storages(anchor) & storages(t) and not storages(corr) & storages(t)
    saved = {n: x.clone() for n, x in anchor.items()}
    for x in t.values():
        x.mul_(3.0)
    assert all(torch.equal(anchor[n], saved[n]) for n in anchor)
    # through the trainer: clipped in place, two consensus rounds
    k, steps = 8, 4
    _, batches = _quadratic(k, steps)
    tr = TrainerSpec(num_nodes=k, graph="ring", lr=0.05, grad_clip=1.0, local_updates=2,
                     gradient_tracking=True, device="cpu").build(
        lambda p, b: (p["x"] - b[0]).square().sum(-1))
    out, _ = tr.run(tr.init({"x": torch.zeros(6)}), (batches,))
    corr, anchor = out.comm.track
    assert not storages(anchor) & storages(out.params)
    before = anchor["x"].clone()
    out.params["x"].add_(1.0)
    assert torch.equal(anchor["x"], before)


def test_local_update_flags_cli_threading():
    """--local-updates, --gradient-tracking and --mix-every reach the spec and
    the DynamicsConfig as the reference's spec builds them, and the trainer
    builds the wrapper."""
    from repro.core.spec import TrainerSpec as RefSpec

    ap = argparse.ArgumentParser()
    TrainerSpec.add_cli_args(ap)
    ref_ap = argparse.ArgumentParser()
    RefSpec.add_cli_args(ref_ap)
    for argv in (["--local-updates", "4", "--gradient-tracking"], ["--mix-every", "3"],
                 ["--local-updates", "2", "--topology", "dropout", "--drop-p", "0.2"]):
        spec = TrainerSpec.from_args(ap.parse_args(argv + ["--device", "cpu"]), num_nodes=8,
                                     graph="ring")
        ref_spec = RefSpec.from_args(ref_ap.parse_args(argv))
        assert (spec.local_updates, spec.gradient_tracking, spec.mix_every) == \
            (ref_spec.local_updates, ref_spec.gradient_tracking, ref_spec.mix_every)
        got, want = spec.dynamics_config(), ref_spec.dynamics_config()
        assert (got is None) == (want is None)
        tr = spec.build(lambda p, b: p["x"].square().sum(-1))
        if spec.local_updates > 1:
            assert (got.local_updates, got.gradient_tracking) == \
                (want.local_updates, want.gradient_tracking)
            assert isinstance(tr.mixer, LocalUpdateMixer)
            assert (tr.mixer.period, tr.mixer.gt) == (spec.local_updates, spec.gradient_tracking)


@pytest.mark.parametrize("argv", [
    ["--local-updates", "2", "--gradient-tracking", "--mix-every", "1", "--topology", "dropout",
     "--drop-p", "0.2"],
    ["--straggler-p", "0.2", "--outage-p", "0.1", "--outage-len", "2",
     "--straggler-skips-compute"],
    ["--topology", "hub", "--local-updates", "2"],
    ["--mix-every", "2"]], ids=["local-gt", "faults", "hub", "mix-every"])
def test_cli_runs_the_new_flags(argv):
    """The training CLI accepts and runs every flag of this slice on the CPU
    (none raises NotImplementedError)."""
    from repro_torch.launch import train

    state = train.main(["--paper", "fmnist", "--device", "cpu", "--steps", "4", "--nodes", "4",
                        "--graph", "ring", "--log-every", "2", *argv])
    assert all(bool(torch.isfinite(x).all()) for x in state.params.values())
