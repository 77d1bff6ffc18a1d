"""The dynamics' coins (``repro_torch.dynamics.coins``): every fault and
topology draw of a round from the Philox draw of
``repro_torch.kernels.quant_gossip.ops.uniforms_grouped`` (its plain
version here; the kernel is held against it bit for bit on the card in
``tests/test_torch_kernel.py`` and ``chip_smoke.py``).

- The fault masks and every schedule's W_r are a pure function of (seed,
  stream, round): the same for the round as a host int and as a 0-d int64
  tensor, the same on a second call, and other for another seed or round;
  each stream is the Philox draw of its own leaf at its own round.
- The link keep is symmetric, and links run only between up nodes.
- The outage stream is constant within a window of ``outage_len`` rounds
  (the draw at ``round // outage_len``) and moves between windows.
- Over 2,000 rounds the straggler and link-keep shares, the outage share
  per window and a dropout schedule's kept-link share lie within 5σ of
  their configured rates.
- The coins' leaf indices lie at or above ``COIN_LEAF``, the wire's below
  it, so the two share no (key, leaf, round, element) counter, even where
  the fault seed and the wire's seed are equal: the draws differ.
- ``replay_fault_masks`` equals the masks a captured run drew, round by
  round, and a ``straggler_skips_compute`` run's down nodes keep their
  parameters exactly on those rounds.
"""

import numpy as np
import pytest
import torch

from repro_torch.comm import CompressionConfig
from repro_torch.comm.protocol import trivial_comm_state
from repro_torch.comm.wire import CodecWire
from repro_torch.core import TrainerSpec
from repro_torch.dynamics import (
    DropoutSchedule,
    FaultConfig,
    GeometricRedrawSchedule,
    RoundRobinSchedule,
    coins,
    fault_keep_matrix,
    replay_fault_masks,
)
from repro_torch.dynamics import faults as faults_mod
from repro_torch.graphs import build_graph, metropolis_weights
from repro_torch.graphs.mixing import symmetric_uniform
from repro_torch.kernels.quant_gossip import ref
from repro_torch.models import paper_nets as nets

K = 10
W = metropolis_weights(build_graph("erdos_renyi", K, p=0.4, seed=3))
FAULTS = dict(link_drop_p=0.3, straggler_p=0.2, outage_p=0.2, outage_len=4, seed=5)


def _r(round):
    return torch.tensor(round, dtype=torch.int64)


def _schedules(seed):
    return {"dropout": DropoutSchedule(W, 0.3, seed=seed, device="cpu"),
            "geometric": GeometricRedrawSchedule(K, radius=0.5, seed=seed, device="cpu"),
            "round_robin": RoundRobinSchedule(W, device="cpu")}


@pytest.mark.parametrize("round", [0, 7, 2 ** 32 + 3])
def test_coins_are_a_pure_function_of_seed_stream_and_round(round):
    cfg = FaultConfig(**FAULTS)
    keep, up = fault_keep_matrix(cfg, round, K, device="cpu")
    for again in (fault_keep_matrix(cfg, round, K, device="cpu"),
                  fault_keep_matrix(cfg, _r(round), K, device="cpu")):
        assert torch.equal(again[0], keep) and torch.equal(again[1], up)
    # each stream is its own leaf of one Philox draw at the coins' key
    key = coins.coin_key(cfg.seed)
    like = torch.empty(K, K)
    u_link = ref.uniforms_grouped_ref([like], key, _r(round), leaves=[coins.LINKS])[0]
    u_str = ref.uniforms_grouped_ref([like[0]], key, _r(round), leaves=[coins.STRAGGLERS])[0]
    u_out = ref.uniforms_grouped_ref([like[0]], key, _r(round // cfg.outage_len),
                                     leaves=[coins.OUTAGES])[0]
    want_up = ((u_str >= cfg.straggler_p) & (u_out >= cfg.outage_p)).float()
    want_keep = (symmetric_uniform(u_link) >= cfg.link_drop_p).float()
    assert torch.equal(up, want_up)
    assert torch.equal(keep, want_keep * want_up[:, None] * want_up[None, :])
    other = [fault_keep_matrix(FaultConfig(**dict(FAULTS, seed=6)), round, K, device="cpu"),
             fault_keep_matrix(cfg, round + 1, K, device="cpu")]
    assert all(not torch.equal(o[0], keep) for o in other)
    for name, sched in _schedules(2).items():
        w = sched.round_weights(round)
        assert torch.equal(sched.round_weights(_r(round)), w), name
        assert torch.equal(_schedules(2)[name].round_weights(round), w), name
        if name != "round_robin":
            assert not torch.equal(_schedules(3)[name].round_weights(round), w), name
            assert not torch.equal(sched.round_weights(round + 1), w), name


def test_link_keep_is_symmetric_and_between_up_nodes():
    cfg = FaultConfig(**FAULTS)
    downs = 0
    for round in range(40):
        keep, up = fault_keep_matrix(cfg, round, K, device="cpu")
        assert keep.dtype == up.dtype == torch.float32
        assert torch.equal(keep, keep.T)
        assert torch.equal(keep * up[:, None] * up[None, :], keep)
        assert bool(((keep == 0) | (keep == 1)).all()) and bool(((up == 0) | (up == 1)).all())
        down = up == 0
        downs += int(down.sum())
        assert not bool(keep[down].any()) and not bool(keep[:, down].any())
    assert downs > 0


def test_outage_stream_is_constant_within_a_window():
    cfg = FaultConfig(outage_p=0.5, outage_len=5, seed=7)
    ups = [fault_keep_matrix(cfg, r, K, device="cpu")[1] for r in range(20)]
    for w0 in range(0, 20, 5):
        for r in range(w0 + 1, w0 + 5):
            assert torch.equal(ups[r], ups[w0])
    assert len({tuple(u.tolist()) for u in ups[::5]}) > 1
    # the window's draw: the outage leaf at round // outage_len
    u = ref.uniforms_grouped_ref([torch.empty(K)], coins.coin_key(7), _r(3),
                                 leaves=[coins.OUTAGES])[0]
    assert torch.equal(ups[17], (u >= 0.5).float())


@pytest.mark.parametrize("kind,p", [("straggler", 0.1), ("outage", 0.05), ("link", 0.3),
                                    ("dropout", 0.2)])
def test_coin_rates_within_five_sigma(kind, p):
    rounds, out_len = 2000, 10
    iu = np.triu_indices(K, 1)
    links = W[iu] > 0
    if kind == "dropout":
        sched = DropoutSchedule(W, p, seed=4, device="cpu")
        kept = np.stack([sched.round_weights(r).numpy()[iu][links] > 0 for r in range(rounds)])
        share, n = float(kept.mean()), kept.size
    elif kind == "outage":  # one coin per window: the first round of each
        cfg = FaultConfig(outage_p=p, outage_len=out_len, seed=4)
        _, up = replay_fault_masks(cfg, np.arange(0, rounds * out_len, out_len), K, "cpu")
        share, n = float(up.mean()), up.size
    elif kind == "straggler":
        _, up = replay_fault_masks(FaultConfig(straggler_p=p, seed=4), np.arange(rounds), K,
                                   "cpu")
        share, n = float(up.mean()), up.size
    else:
        keep, up = replay_fault_masks(FaultConfig(link_drop_p=p, seed=4), np.arange(rounds), K,
                                      "cpu")
        share, n = float(keep[:, iu[0], iu[1]].mean()), rounds * len(iu[0])
        assert (up == 1).all()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 5 * sigma, (share, 1 - p, sigma)


def test_coin_streams_share_no_counter_with_the_wire():
    """At equal seeds the wire's noise (leaves 0 .. n − 1 at the wire's key)
    and the coins (leaves at and above COIN_LEAF at the coins' key) never
    share a counter, and their draws differ."""
    streams = (coins.LINKS, coins.STRAGGLERS, coins.OUTAGES, coins.DROPOUT, coins.GEOMETRIC)
    assert len(set(streams)) == len(streams) and min(streams) >= coins.COIN_LEAF
    assert max(streams) < 2 ** 32
    seed, round = 3, 5
    wire = CodecWire(CompressionConfig(kind="int8", use_kernel=True, seed=seed))
    xs = [torch.empty(K, K) for _ in range(6)]
    noise = wire.round_uniforms(trivial_comm_state(seed), _r(round), xs)
    drawn = coins.draw(seed, _r(round), [(K, K)] * len(streams), streams)
    for u in drawn:
        assert all(not torch.equal(u, v) for v in noise)
    # the same leaf index at the wire's key is not the coin either
    for s, u in zip(streams, drawn):
        same_leaf = ref.uniforms_grouped_ref([torch.empty(K, K)], seed, _r(round), leaves=[s])[0]
        assert not torch.equal(same_leaf, u)
    assert coins.coin_key(seed) != seed


def test_replay_fault_masks_equals_the_masks_the_run_drew(monkeypatch):
    """A captured run on the CPU (straggler_skips_compute, stragglers and
    outages): the masks its rounds drew, recorded where they are drawn,
    equal ``replay_fault_masks`` of its config over the run's rounds, and a
    down node's parameters do not move on its round."""
    seen = []
    drawn = faults_mod.fault_keep_matrix

    def record(cfg, round, k, device):
        keep, up = drawn(cfg, round, k, device)
        seen.append((int(round), keep.clone(), up.clone()))
        return keep, up

    monkeypatch.setattr(faults_mod, "fault_keep_matrix", record)
    k, steps = 8, 12
    rng = np.random.default_rng(0)
    x = rng.standard_normal((steps, k, 4, 20)).astype(np.float32)
    y = rng.integers(0, 5, size=(steps, k, 4)).astype(np.int32)
    params = nets.mlp_init(torch.Generator().manual_seed(0), input_dim=20, hidden=(12,),
                           num_classes=5)
    trainer = TrainerSpec(num_nodes=k, graph="ring", lr=0.1, device="cpu", straggler_p=0.2,
                          outage_p=0.1, outage_len=3, straggler_skips_compute=True,
                          seed=9).build(nets.make_classifier_loss(nets.mlp_apply))
    assert trainer.captured, trainer.capture_declined
    state = trainer.init(params)
    thetas = [{n: v.clone() for n, v in state.params.items()}]
    for t in range(steps):
        state, _ = trainer.step(state, (x[t], y[t]))
        thetas.append({n: v.clone() for n, v in state.params.items()})
    rounds = sorted({r for r, _, _ in seen})
    assert rounds == list(range(steps))
    keep, up = replay_fault_masks(trainer.mixer.topo.faults, rounds, k, device="cpu")
    for r, kp, u in seen:
        np.testing.assert_array_equal(kp.numpy(), keep[r])
        np.testing.assert_array_equal(u.numpy(), up[r])
    assert (up == 0).any() and (up == 1).any()
    for t in range(steps):
        for i in np.nonzero(up[t] == 0)[0]:
            assert all(torch.equal(thetas[t + 1][n][i], thetas[t][n][i]) for n in params), (t, i)
        moved = [i for i in np.nonzero(up[t] == 1)[0]
                 if not torch.equal(thetas[t + 1]["fc0/w"][i], thetas[t]["fc0/w"][i])]
        assert moved, t
