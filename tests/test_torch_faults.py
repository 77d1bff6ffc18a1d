"""The port's fault process (``repro_torch.dynamics.faults``) and the faulted
mixers and train step against the reference's ``repro.dynamics.faults``.

The port draws its coins from Philox streams on the device
(``repro_torch.dynamics.coins``: one leaf per stream, the round read from a
0-d tensor, the outage stream at its window) where the reference folds the
round into a JAX key, so the two never share bits.  The port's sampler is
held on its rates (straggler, outage and link keep within 3σ over 2,000
rounds) and on its structure (symmetric keep, a link kept only between two
up nodes, outage windows shared, a pure function of the round).
Everything that compares arithmetic injects the reference's own
``replay_fault_masks`` into the port through its one seam,
``repro_torch.comm.topology.round_fault_masks``: the faulted W_r equals the
reference's at 1e-7 and stays doubly stochastic, a faulted dense round's θ
agrees at rtol 1e-6 with exact ``wire_bits``, the memoryless int8 gossip
round (B.4/B.5's plain versions) masks a straggler's row in every matching
and equals the reference's masked quantize and dequantize-accumulate on the
reference's faulted W_r (payload exact, accumulation at rtol 1e-6), a round
in which every node straggles bills 0 bytes, and ``straggler_skips_compute``
freezes down nodes and keeps them from dominating the DR weights, with
trajectories equal to the reference trainer's at rtol 1e-6.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TrainerSpec as RefTrainerSpec
from repro.dynamics import DynamicDenseMixer as RefDynamicDenseMixer
from repro.dynamics import FaultConfig as RefFaultConfig
from repro.dynamics import StaticSchedule as RefStaticSchedule
from repro.dynamics import gather_round_vectors as ref_gather_round_vectors
from repro.dynamics import replay_fault_masks as ref_replay_fault_masks
from repro.graphs import build_graph, metropolis_weights
from repro.kernels.quant_gossip import ref as ref_kernels
from repro_torch import convert
from repro_torch.comm import CompressionConfig
from repro_torch.comm import topology as comm_topology
from repro_torch.comm.topology import ScheduledTopology, gather_round_vectors
from repro_torch.core import TrainerSpec
from repro_torch.dynamics import (
    DynamicDenseMixer,
    DynamicGossipMixer,
    FaultConfig,
    StaticSchedule,
    fault_keep_matrix,
    replay_fault_masks,
)
from repro_torch.graphs import is_doubly_stochastic
from repro_torch.utils.tree import leaf_names

K = 12
W = metropolis_weights(build_graph("erdos_renyi", K, p=0.4, seed=3))
FAULTS = dict(link_drop_p=0.3, straggler_p=0.2, outage_p=0.2, outage_len=4, seed=1)


def inject(monkeypatch, ref_cfg, k, rounds=64):
    """Serve the reference's replayed masks of ``ref_cfg`` to the port's
    topology and train step for rounds 0 .. ``rounds`` − 1."""
    keep, up = (np.array(a) for a in ref_replay_fault_masks(ref_cfg, np.arange(rounds), k))

    def masks(faults, r, kk, device):
        assert kk == k
        return (torch.from_numpy(keep[r]).to(device), torch.from_numpy(up[r]).to(device))

    monkeypatch.setattr(comm_topology, "round_fault_masks", masks)
    return keep, up


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


# -- the config ------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [dict(link_drop_p=-0.1), dict(straggler_p=1.0),
                                    dict(outage_p=1.5), dict(outage_len=0)])
def test_fault_config_raises_the_reference_errors(kwargs):
    assert _error(lambda: FaultConfig(**kwargs)) == _error(lambda: RefFaultConfig(**kwargs))


def test_fault_config_fields_and_enabled_match_reference():
    assert [f.name for f in dataclasses.fields(FaultConfig)] == \
        [f.name for f in dataclasses.fields(RefFaultConfig)]
    for kw in (dict(), dict(link_drop_p=0.1), dict(straggler_p=0.2), dict(outage_p=0.1),
               dict(straggler_skips_compute=True), dict(outage_len=3, seed=5)):
        assert FaultConfig(**kw).enabled == RefFaultConfig(**kw).enabled
        assert dataclasses.asdict(FaultConfig(**kw)) == dataclasses.asdict(RefFaultConfig(**kw))


# -- the port's own sampler ------------------------------------------------------

def test_fault_masks_are_a_pure_function_of_the_round():
    cfg = FaultConfig(**FAULTS)
    keep, up = fault_keep_matrix(cfg, 5, K, device="cpu")
    keep2, up2 = fault_keep_matrix(cfg, 5, K, device="cpu")
    assert torch.equal(keep, keep2) and torch.equal(up, up2)
    assert keep.dtype == up.dtype == torch.float32
    assert torch.equal(keep, keep.T)
    assert torch.equal(keep * up[:, None] * up[None, :], keep)  # links only between up nodes
    rk, ru = replay_fault_masks(cfg, [3, 5, 9], K, device="cpu")
    assert rk.shape == (3, K, K) and ru.shape == (3, K)
    np.testing.assert_array_equal(rk[1], keep.numpy())
    np.testing.assert_array_equal(ru[1], up.numpy())
    # every stream moves with the round
    assert not torch.equal(fault_keep_matrix(cfg, 6, K, device="cpu")[0], keep)
    # the straggler stream does not depend on whether links drop
    a = fault_keep_matrix(FaultConfig(straggler_p=0.3, seed=2), 7, K, device="cpu")[1]
    b = fault_keep_matrix(FaultConfig(straggler_p=0.3, link_drop_p=0.4, seed=2), 7, K,
                          device="cpu")[1]
    assert torch.equal(a, b)


def test_outage_windows_are_correlated():
    cfg = FaultConfig(outage_p=0.5, outage_len=5, seed=7)
    ups = [fault_keep_matrix(cfg, r, 10, device="cpu")[1] for r in range(15)]
    # rounds 0-4 share one outage draw, rounds 5-9 the next, 10-14 the next
    for w0 in (0, 5, 10):
        for r in range(w0 + 1, w0 + 5):
            assert torch.equal(ups[r], ups[w0])
    assert not (torch.equal(ups[0], ups[5]) and torch.equal(ups[5], ups[10]))


@pytest.mark.parametrize("kind,p", [("straggler", 0.1), ("outage", 0.05), ("link", 0.3)])
def test_fault_sampler_rates(kind, p):
    """2,000 rounds of the port's own coins: the up share (stragglers; per
    window for outages) and the kept share of links within 3σ of 1 − p."""
    k, rounds, out_len = 10, 2000, 10
    cfg = {"straggler": FaultConfig(straggler_p=p, seed=4),
           "outage": FaultConfig(outage_p=p, outage_len=out_len, seed=4),
           "link": FaultConfig(link_drop_p=p, seed=4)}[kind]
    if kind == "outage":  # one coin per window: read the first round of each
        draws = [fault_keep_matrix(cfg, r, k, device="cpu")[1] for r in range(0, rounds, out_len)]
        share, n = float(torch.stack(draws).mean()), len(draws) * k
    elif kind == "straggler":
        keep, up = replay_fault_masks(cfg, np.arange(rounds), k, device="cpu")
        share, n = float(up.mean()), up.size
    else:
        keep, up = replay_fault_masks(cfg, np.arange(rounds), k, device="cpu")
        iu = np.triu_indices(k, 1)
        share, n = float(keep[:, iu[0], iu[1]].mean()), rounds * len(iu[0])
        assert (up == 1).all()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 3 * sigma, (share, 1 - p, sigma)


# -- the faulted W and mixers, on the reference's masks ---------------------------

def test_faulted_w_doubly_stochastic_and_equals_reference(monkeypatch):
    ref_cfg = RefFaultConfig(**FAULTS)
    _, up = inject(monkeypatch, ref_cfg, K)
    ref_topo = RefDynamicDenseMixer(RefStaticSchedule(W), faults=ref_cfg).topo
    topo = ScheduledTopology(StaticSchedule(W, device="cpu"), FaultConfig(**FAULTS))
    step = jax.jit(ref_topo.round_w)
    downs = 0
    for r in range(24):
        got = topo.round_w(r).numpy()
        np.testing.assert_allclose(got, np.asarray(step(jnp.int32(r))), rtol=0, atol=1e-7)
        assert is_doubly_stochastic(got, atol=1e-5), r
        for i in np.nonzero(up[r] == 0)[0]:  # a down node's row degenerates to e_i
            assert got[i, i] == pytest.approx(1.0, abs=1e-6)
            downs += 1
    assert downs > 0
    assert ScheduledTopology(StaticSchedule(W, device="cpu"), FaultConfig()).faults is None


def _theta(k, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((k, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((k, 7)).astype(np.float32)}


def test_faulted_dense_rounds_match_reference(monkeypatch):
    ref_cfg = RefFaultConfig(**FAULTS)
    inject(monkeypatch, ref_cfg, K)
    ref_m = RefDynamicDenseMixer(RefStaticSchedule(W), faults=ref_cfg)
    port_m = DynamicDenseMixer(StaticSchedule(W, device="cpu"), faults=FaultConfig(**FAULTS))
    theta = _theta(K, 0)
    ref_theta, ref_state = jax.tree.map(jnp.asarray, theta), ref_m.init_state(theta)
    port_state = port_m.init_state(convert.params_from_numpy(theta, device="cpu"))
    step = jax.jit(lambda t, s: ref_m(t, s))
    assert port_m.bytes_per_round(convert.params_from_numpy(theta, device="cpu")) == \
        ref_m.bytes_per_round(theta)
    for r in range(6):
        port_theta, port_state = port_m(
            convert.params_from_numpy(jax.tree.map(np.asarray, ref_theta), device="cpu"),
            port_state)
        ref_theta, ref_state = step(ref_theta, ref_state)
        for n in ("a", "b"):
            np.testing.assert_allclose(port_theta[n].numpy(), np.asarray(ref_theta[n]),
                                       rtol=1e-6, atol=1e-6)
        assert float(port_state.wire_bits) == float(ref_state.wire_bits)
        assert port_state.rounds == r + 1


def test_faulted_memoryless_gossip_round_matches_reference_arithmetic(monkeypatch):
    """The memoryless int8 gossip round on the faulted W_r: the weights and
    masks gathered from it equal the reference's gather on its faulted W_r,
    a down node's row is masked in every matching (no send, no receive),
    the round equals the reference's masked quantize (B.4's oracle) and
    masked dequantize-accumulate (B.5's oracle) per matching, and the wire
    bills active sends only."""
    k, cfg_kw = 8, dict(straggler_p=0.3, link_drop_p=0.2, seed=2)
    ref_cfg = RefFaultConfig(**cfg_kw)
    w = metropolis_weights(build_graph("ring", k))
    _, up = inject(monkeypatch, ref_cfg, k)
    uniforms = {}

    def noise(rounds, leaf_idx, matching, shape):
        key = (rounds, leaf_idx, matching)
        if key not in uniforms:
            rng = np.random.default_rng([rounds, leaf_idx, matching])
            uniforms[key] = rng.random(shape, dtype=np.float32)
        return uniforms[key]

    mixer = DynamicGossipMixer(StaticSchedule(w, device="cpu"), faults=FaultConfig(**cfg_kw),
                               quantized=CompressionConfig(kind="int8", use_kernel=True,
                                                           error_feedback=False, block_d=16),
                               uniforms=noise)
    ref_topo = RefDynamicDenseMixer(RefStaticSchedule(w), faults=ref_cfg).topo
    perm_idx = mixer.transport.perm_idx.numpy()
    theta = {"a": _theta(k, 1)["a"].reshape(k, -1), "b": _theta(k, 1)["b"]}
    tensors = {n: torch.from_numpy(x) for n, x in theta.items()}
    state = mixer.init_state(tensors)
    down_seen = 0
    for r in range(6):
        out, state2 = mixer(tensors, state._replace(rounds=r))
        ref_w = ref_topo.round_w(jnp.int32(r))
        ref_self, ref_pws, ref_masks = ref_gather_round_vectors(ref_w, perm_idx)
        self_w, pws, masks = gather_round_vectors(mixer.topo.round_w(r), mixer.transport.perm_idx)
        np.testing.assert_allclose(self_w.numpy(), np.asarray(ref_self), rtol=0, atol=1e-7)
        for m in range(len(masks)):
            np.testing.assert_array_equal(masks[m].numpy(), np.asarray(ref_masks[m]))
            np.testing.assert_allclose(pws[m].numpy(), np.asarray(ref_pws[m]), rtol=0, atol=1e-7)
        for i in np.nonzero(up[r] == 0)[0]:
            down_seen += 1
            assert all(float(mk[i]) == 0.0 for mk in masks), (r, i)
        for li, n in enumerate(leaf_names(theta)):
            x = jnp.asarray(theta[n])
            acc = x * jnp.asarray(ref_self)[:, None]
            for m, (pw, mk) in enumerate(zip(ref_pws, ref_masks)):
                u = jnp.asarray(noise(r, li, m, x.shape))
                q, s = ref_kernels.masked_quantize_blockwise_ref(x, u, mk, qmax=127, block_d=16)
                src = perm_idx[m]
                acc = ref_kernels.masked_dequant_accumulate_ref(acc, q[src], s[src], pw, mk)
            np.testing.assert_allclose(out[n].numpy(), np.asarray(acc), rtol=1e-6, atol=1e-6)
        per_node = sum(mixer.wire.leaf_bits(x[0].size) for x in theta.values())
        sends = sum(float(np.asarray(mk).sum()) for mk in ref_masks)
        assert float(state2.wire_bits) == sends * per_node
    assert down_seen > 0


def test_full_straggler_round_reports_zero_comm_bytes(monkeypatch):
    """Masked-out links put nothing on the wire: rounds in which every node
    straggles report comm_bytes == wire_bits == 0 through the train step, on
    the reference's masks and on the port's own coins, dense and gossip."""
    k = 6

    def loss_fn(params, batch):
        return params["x"].square().sum(-1)

    def run(mixer=None):
        spec = TrainerSpec(num_nodes=k, graph="ring", robust=False, lr=0.01,
                           straggler_p=0.0 if mixer else 0.999, device="cpu")
        tr = spec.build(loss_fn, mixer=mixer)
        state = tr.init({"x": torch.ones(4)})
        _, ms = tr.run(state, (np.zeros((5, k, 1), np.float32),))
        return ms

    for ms in (run(),):  # the port's own coins
        assert torch.equal(ms["comm_bytes"], torch.zeros(5))
    keep, _ = inject(monkeypatch, RefFaultConfig(straggler_p=0.999), k)
    assert not keep[:5][:, ~np.eye(k, dtype=bool)].any()
    w = metropolis_weights(build_graph("ring", k))
    gossip = DynamicGossipMixer(StaticSchedule(w, device="cpu"),
                                faults=FaultConfig(straggler_p=0.999))
    for ms in (run(), run(gossip)):
        assert torch.equal(ms["comm_bytes"], torch.zeros(5))
        assert torch.equal(ms["wire_bits"], torch.zeros(5))
    ref_spec = RefTrainerSpec(num_nodes=k, graph="ring", robust=False, lr=0.01,
                              straggler_p=0.999, metrics_disagreement=False)
    ref_tr = ref_spec.build(lambda p, b: jnp.sum(p["x"] ** 2))
    _, ref_ms = ref_tr.run(ref_tr.init({"x": jnp.ones(4)}), jnp.zeros((5, k, 1)))
    np.testing.assert_array_equal(np.asarray(ref_ms["comm_bytes"]), np.zeros(5, np.float32))


# -- straggler_skips_compute -------------------------------------------------------

def _mixed_up_round(straggler_p, k, seed):
    """First round whose reference straggler draw has both up and down nodes."""
    _, up = ref_replay_fault_masks(RefFaultConfig(straggler_p=straggler_p, seed=seed),
                                   np.arange(64), k)
    for r in range(64):
        if 0 < up[r].sum() < k:
            return r, up[r]
    raise AssertionError("no mixed straggler round in 64 draws")


def _run_both(monkeypatch, k, flag, batch, x0, **kw):
    """One step of the port's and the reference's trainer on the
    reference's masks (seed 3, straggler_p 0.5).  Returns (port x, port
    metrics, reference x, reference metrics)."""
    inject(monkeypatch, RefFaultConfig(straggler_p=0.5, seed=3), k)
    common = dict(num_nodes=k, graph="ring", robust=True, lr=0.1, straggler_p=0.5,
                  straggler_skips_compute=flag, seed=3, **kw)

    def loss_fn(params, b):
        return (params["x"] - b[0]).square().mean(-1)

    tr = TrainerSpec(device="cpu", **common).build(loss_fn)
    out, ms = tr.run(tr.init({"x": torch.from_numpy(x0)}), (batch,))
    ref_tr = RefTrainerSpec(metrics_disagreement=False, **common).build(
        lambda p, b: jnp.mean((p["x"] - b) ** 2))
    ref_out, ref_ms = ref_tr.run(ref_tr.init({"x": jnp.asarray(x0)}), jnp.asarray(batch))
    return out.params["x"].numpy(), ms, np.asarray(ref_out.params["x"]), ref_ms


def test_straggler_skips_compute_freezes_down_nodes(monkeypatch):
    """With the flag a down node loses its gradient too: its robust scale is
    zeroed, so its params pass the round untouched (no local update, no
    send, no receive), while up nodes keep moving; the reference's trainer
    on the same masks gives the same params."""
    k = 8
    r0, up = _mixed_up_round(0.5, k, seed=3)
    assert r0 == 0, "pick a seed whose round-0 draw is mixed"
    x0 = np.ones(4, np.float32)
    batch = np.zeros((1, k, 1), np.float32)
    x1, _, ref_x1, _ = _run_both(monkeypatch, k, True, batch, x0)
    for i in range(k):
        if up[i] == 0:
            np.testing.assert_array_equal(x1[i], x0)
        else:
            assert not np.array_equal(x1[i], x0), i
    np.testing.assert_allclose(x1, ref_x1, rtol=1e-6, atol=1e-7)


def test_skipped_straggler_cannot_dominate_dr_weighting(monkeypatch):
    """A node that produced no work must not take the exponential DR weight
    its worst loss would earn: the masked scale zeroes it; without the flag
    the down node's huge scaled gradient blows up its own parameters.  Both
    runs equal the reference's on the same masks."""
    k = 8
    _, up = _mixed_up_round(0.5, k, seed=3)
    down = int(np.nonzero(up == 0)[0][0])
    batch = np.zeros((1, k, 1), np.float32)
    batch[0, down, 0] = 100.0  # the straggler holds the worst loss
    out = {flag: _run_both(monkeypatch, k, flag, batch, np.zeros(4, np.float32), mu=1.0)
           for flag in (False, True)}
    (x_off, ms_off, ref_off, ref_ms_off), (x_on, ms_on, ref_on, ref_ms_on) = \
        out[False], out[True]
    assert np.abs(x_off[down]).max() > 1.0
    np.testing.assert_array_equal(x_on[down], np.zeros(4))
    assert float(ms_on["scale_max"][0]) < float(ms_off["scale_max"][0])
    for i in np.nonzero(up == 1)[0]:
        np.testing.assert_array_equal(x_on[i], x_off[i])
    np.testing.assert_allclose(x_off, ref_off, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x_on, ref_on, rtol=1e-6, atol=1e-6)
    for ms, ref_ms in ((ms_off, ref_ms_off), (ms_on, ref_ms_on)):
        np.testing.assert_allclose(float(ms["scale_max"][0]), float(ref_ms["scale_max"][0]),
                                   rtol=1e-6)


def test_straggler_skips_compute_peels_wrappers(monkeypatch):
    """The compute mask is found under LocalUpdateMixer and RepeatMixer, and
    is replayed from the step clock before the round."""
    from repro_torch.core import repeat_mixer
    from repro_torch.core.drdsgd import _step_faults
    from repro_torch.dynamics import LocalUpdateMixer

    faults = FaultConfig(straggler_p=0.2, straggler_skips_compute=True)
    inner = DynamicDenseMixer(StaticSchedule(W, device="cpu"), faults=faults)
    for mixer in (inner, LocalUpdateMixer(inner, 2), repeat_mixer(inner, 2),
                  LocalUpdateMixer(repeat_mixer(inner, 2), 3)):
        assert _step_faults(mixer) is faults
    assert _step_faults(DynamicDenseMixer(StaticSchedule(W, device="cpu"),
                                          faults=FaultConfig(straggler_p=0.2))) is None
    assert _step_faults(DynamicDenseMixer(StaticSchedule(W, device="cpu"), faults=FaultConfig(
        link_drop_p=0.2, straggler_skips_compute=True))) is None


def test_fault_flags_cli_threading():
    """Every fault flag reaches the FaultConfig the reference's spec builds."""
    from repro.core.spec import TrainerSpec as RefSpec

    ap = argparse.ArgumentParser()
    TrainerSpec.add_cli_args(ap)
    ref_ap = argparse.ArgumentParser()
    RefSpec.add_cli_args(ref_ap)
    for argv in (["--straggler-p", "0.3", "--straggler-skips-compute"],
                 ["--straggler-p", "0.3"],
                 ["--outage-p", "0.05", "--outage-len", "7", "--seed", "4"],
                 ["--topology", "dropout", "--drop-p", "0.2", "--straggler-p", "0.1",
                  "--outage-p", "0.05"]):
        spec = TrainerSpec.from_args(ap.parse_args(argv + ["--device", "cpu"]),
                                     num_nodes=8, graph="ring")
        ref_spec = RefSpec.from_args(ref_ap.parse_args(argv))
        assert spec.straggler_skips_compute == ref_spec.straggler_skips_compute
        got, want = spec.dynamics_config(), ref_spec.dynamics_config()
        assert dataclasses.asdict(got.faults) == dataclasses.asdict(want.faults)
        assert (got.topology, got.drop_p) == (want.topology, want.drop_p)
        trainer = spec.build(lambda p, b: p["x"].square().sum(-1))
        assert trainer.mixer.topo.faults == got.faults
