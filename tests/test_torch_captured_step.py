"""The trainer's captured step (``jit=True``) on the CPU, where it runs the
capturable form the card captures (the same slot, written in place, and
the step's scalars read from the packed input buffer) eagerly.

- 20 fmnist dense-none steps (the paper's MLP, K = 10, ER(0.3)) and 3
  qwen2 smoke steps (K = 4 ring, ``train_lm``'s lr and clip) with
  ``jit=True`` equal ``jit=False`` bit for bit: every parameter, every
  metric, ``step`` and ``comm.rounds``; also through ``step``, through
  epochs with a hook, past the metrics buffer's columns, and under a
  decaying SGD schedule over more steps than one packing of inputs.
  These comparisons run on one intra-op thread (``one_thread``).
- The unfused step, captured: on a small MLP (K = 6 ring) every codec
  wire (the dense int8 EF wire through the kernel quantizer, int4
  memoryless, topk and randk EF, bf16), static-gossip int8 EF, the int8
  wire under linear and adaptive schedules, Nesterov momentum, Adam under
  ``linear_warmup_cosine``, ``chain_clip`` and K = 65 give ``jit=True``
  equal to ``jit=False`` bit for bit (parameters, optimizer state, every
  ``CommState`` field, every metric) through epochs with a hook, past
  ``PACK_STEPS`` and through ``step``; so does the fmnist dense int8 EF
  stack over 20 steps; the capturable form makes no call that reads a
  device value on the host (a CUDA graph cannot replay one); a run saved
  mid-way from a captured trainer (momentum and the EF wire), restored and
  continued captured equals the uninterrupted eager run bit for bit.
- The dynamic stacks, captured with one graph per branch the host
  chooses (fig9/fig11's stacks on a small MLP, K = 8 ring): dense dropout
  0.2 under ``LocalUpdateMixer`` H = 4 with gradient tracking, dense
  stragglers and outages with ``straggler_skips_compute``, the memoryless
  int8 gossip wire under stragglers, the int8 EF gossip re-based every 4
  under dropout inside H = 2, the same EF gossip with the adaptive
  trigger, geometric re-draws, round-robin gossip, int8 FedAvg at H = 4,
  the hub at H = 1, SCAFFOLD at H = 4, ``mix_every`` = 2 and
  ``RepeatMixer(gossip int8 EF, 2)`` give ``jit=True`` equal to
  ``jit=False`` bit for bit (the whole carry, the host ints, every
  metric), with one program per distinct branch met; their capturable
  form reads nothing on the host; a run whose branches replay out of
  their capture order (local, delta, local, re-base, ...) and a
  checkpoint restored in the middle of a local-update period equal the
  eager runs bit for bit.
- The caller's state is left untouched on the CPU (copied in, the result
  copied out), so one initial state serves several runs.
- The capture predicate declines, each with its reason: a replaced fault
  seam (``round_fault_masks``), a schedule class the port does not
  define, a ``uniforms`` hook, an ``Optimizer(init, update)`` with no
  device form, a sink (``obs``) and ``sanitize``; ``jit=False`` says so;
  it keeps plain SGD, every codec, schedule and optimizer above and K >
  64; the CLI's first line says how the step runs (the dynamics and hub
  commands captured too).
- B.1's plain version with η a 0-d float32 tensor and ``out`` leaves
  against the reference's Pallas kernel in interpret mode, row by row, at
  the tolerance of ``tests/test_torch_gossip_update.py`` (rtol 1e-5, atol
  1e-5); the out leaves are written and returned, and equal the float-η
  call bit for bit; ``out`` the θ leaves themselves (in place) gives the
  same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.gossip_update.ops import gossip_update_flat as ref_flat
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.comm import CompressionConfig, ScheduleConfig
from repro_torch.comm import topology as comm_topology
from repro_torch.configs import get_arch
from repro_torch.core import DecentralizedTrainer, TrainerSpec
from repro_torch.core import captured as cap
from repro_torch.core.consensus import make_dense_mixer, make_gossip_mixer, repeat_mixer
from repro_torch.core.drdsgd import step_scalars
from repro_torch.data import make_fmnist_like, make_node_token_streams
from repro_torch.data import pathological_noniid_partition
from repro_torch.dynamics import (
    DropoutSchedule,
    DynamicDenseMixer,
    DynamicGossipMixer,
    DynamicsConfig,
    FaultConfig,
    LocalUpdateMixer,
    RoundRobinSchedule,
    StaticSchedule,
)
from repro_torch.graphs import metropolis_weights, ring_graph
from repro_torch.graphs.mixing import permutation_decomposition
from repro_torch.kernels.gossip_update import ops
from repro_torch.models import TransformerLM, make_lm_loss
from repro_torch.models import paper_nets as nets
from repro_torch.obs import MetricsSink
from repro_torch.optim import Optimizer, adam, chain_clip, linear_warmup_cosine, momentum, sgd

K, STEPS = 10, 20


@pytest.fixture
def one_thread():
    """One intra-op thread while two runs are compared bit for bit: with
    several, MKL may pick its threads by the machine's load, and a product
    then sums in another order from one run to the next, in either mode."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fmnist():
    fed = pathological_noniid_partition(make_fmnist_like(), K, seed=0)
    rng = np.random.default_rng(0)
    draws = [fed.sample_batch(rng, 16) for _ in range(STEPS)]
    batches = tuple(np.stack(parts) for parts in zip(*draws))
    return batches, nets.mlp_init(torch.Generator().manual_seed(0))


def _fmnist_trainer(jit: bool, **kw):
    return DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                num_nodes=K, graph_kwargs={"p": 0.3, "seed": 0}, lr=0.2,
                                device="cpu", jit=jit, **kw)


def _same(a, ma, b, mb) -> None:
    assert sorted(a.params) == sorted(b.params)
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert ma[k].shape == mb[k].shape and torch.equal(ma[k], mb[k]), k
    assert (a.step, a.comm.rounds, a.comm.key) == (b.step, b.comm.rounds, b.comm.key)
    for f in ("res_norm", "res_ref", "wire_bits"):
        assert torch.equal(getattr(a.comm, f), getattr(b.comm, f)), f


def test_fmnist_captured_equals_eager(fmnist, one_thread):
    batches, params = fmnist
    out = {}
    for jit in (False, True):
        trainer = _fmnist_trainer(jit)
        assert trainer.captured == jit
        state, ms = trainer.run(trainer.init(params), batches)
        out[jit] = (state, ms)
    _same(*out[False], *out[True])
    assert out[True][0].step == STEPS and out[True][0].comm.rounds == STEPS


def test_fmnist_step_epochs_and_metric_columns(fmnist, monkeypatch, one_thread):
    """``step`` after a run, a run in epochs with a hook, and a run longer
    than the metrics buffer (cut to 4 columns here) and than one packing of
    inputs (cut to 3 steps) equal the eager ones."""
    batches, params = fmnist
    monkeypatch.setattr(cap, "METRIC_COLS", 4)
    monkeypatch.setattr(cap, "PACK_STEPS", 3)
    first = tuple(b[0] for b in batches)
    out = {}
    for jit in (False, True):
        trainer = _fmnist_trainer(jit)
        seen = []
        state, ms = trainer.run(
            trainer.init(params), batches, steps=11, epoch_steps=5,
            on_epoch=lambda e, st, m: seen.append((e, st.step, len(m["loss_mean"]))))
        state, m1 = trainer.step(state, first)
        out[jit] = (state, ms, m1, seen)
    (a, ma, m1a, sa), (b, mb, m1b, sb) = out[False], out[True]
    _same(a, ma, b, mb)
    assert sa == sb == [(0, 5, 5), (1, 10, 5), (2, 11, 1)]
    assert all(v.ndim == 0 for v in m1b.values())
    assert all(torch.equal(m1a[k], m1b[k]) for k in m1a)


def test_fmnist_decaying_schedule_captured_equals_eager(fmnist, monkeypatch, one_thread):
    """A decaying SGD schedule over more steps than one packing of inputs
    (cut to 3 steps): each step's η, packed beside its batch, is the
    schedule's, bit for bit as the eager step's (an η taken at the warm-up
    or at the wrong offset would not give these bits)."""
    batches, params = fmnist
    monkeypatch.setattr(cap, "PACK_STEPS", 3)
    out = {}
    for jit in (False, True):
        trainer = _fmnist_trainer(jit, optimizer=sgd(lambda t: 0.4 / (1.0 + 0.3 * t)))
        assert trainer.captured == jit
        out[jit] = trainer.run(trainer.init(params), batches, steps=11)
    _same(*out[False], *out[True])
    flat = _fmnist_trainer(True, optimizer=sgd(0.4))
    state, _ = flat.run(flat.init(params), batches, steps=11)
    assert not all(torch.equal(state.params[n], out[True][0].params[n]) for n in params)


def test_caller_state_untouched_on_the_cpu(fmnist, one_thread):
    batches, params = fmnist
    trainer = _fmnist_trainer(True)
    s0 = trainer.init(params)
    kept = {n: t.clone() for n, t in s0.params.items()}
    s1, m1 = trainer.run(s0, batches, steps=6)
    s2, m2 = trainer.run(s0, batches, steps=6)
    for n in kept:
        assert torch.equal(s0.params[n], kept[n])
        assert s1.params[n] is not s2.params[n]
        assert torch.equal(s1.params[n], s2.params[n])
    assert s0.step == 0 and s0.comm.rounds == 0
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    s3, _ = trainer.run(s1, batches, steps=3)
    assert s3.step == 9 and all(torch.equal(s1.params[n], s2.params[n]) for n in kept)
    assert trainer._run._cache_size() == 1


def test_qwen2_smoke_captured_equals_eager(one_thread):
    k, steps = 4, 3
    model = TransformerLM(get_arch("qwen2_0_5b", smoke=True))
    params = model.init(torch.Generator().manual_seed(0))
    streams = make_node_token_streams(k, model.cfg.vocab, seed=0)
    toks = np.stack([np.stack([s.next_batch(2, 32) for s in streams]) for _ in range(steps)])
    out = {}
    for jit in (False, True):
        trainer = TrainerSpec(num_nodes=k, graph="ring", lr=0.01, grad_clip=1.0, device="cpu",
                              jit=jit).build(make_lm_loss(model))
        assert trainer.captured == jit
        out[jit] = trainer.run(trainer.init(params), (toks,))
    _same(*out[False], *out[True])
    assert out[True][0].step == steps and out[True][0].comm.rounds == steps


def _tiny_loss():
    return nets.make_classifier_loss(nets.mlp_apply)


SMALL_K, SMALL_STEPS = 6, 9
SMALL_MLP = dict(input_dim=20, hidden=(12,), num_classes=5)  # leaves of 12, 240, 5, 60
INT8_KERNEL = CompressionConfig(kind="int8", use_kernel=True)


def _small_w(k: int = SMALL_K):
    return metropolis_weights(ring_graph(k))


# the unfused stacks the trainer captures: DecentralizedTrainer fields
STACKS = {
    "dense-int8-kernel-ef": lambda: dict(compression=INT8_KERNEL),
    "dense-int4-memoryless": lambda: dict(
        compression=CompressionConfig(kind="int4", error_feedback=False)),
    "dense-topk-ef": lambda: dict(compression=CompressionConfig(kind="topk", ratio=0.1)),
    "dense-randk-ef": lambda: dict(compression=CompressionConfig(kind="randk", ratio=0.1)),
    "dense-bf16": lambda: dict(compression=CompressionConfig(kind="bf16")),
    "gossip-int8-kernel-ef": lambda: dict(
        compression=INT8_KERNEL,
        mixer=make_gossip_mixer(permutation_decomposition(_small_w()), INT8_KERNEL,
                                device="cpu")),
    "dense-int8-linear": lambda: dict(compression=CompressionConfig(
        kind="int8", schedule=ScheduleConfig(kind="linear", anneal_rounds=6))),
    "dense-int8-adaptive": lambda: dict(compression=CompressionConfig(
        kind="int8", schedule=ScheduleConfig(kind="adaptive", warmup_rounds=3))),
    "nesterov": lambda: dict(optimizer=momentum(0.05, nesterov=True)),
    "adam-warmup-cosine": lambda: dict(
        optimizer=adam(linear_warmup_cosine(1e-2, 3, SMALL_STEPS), eps=1e-6)),
    "chain-clip-momentum": lambda: dict(optimizer=chain_clip(momentum(0.05), 0.5)),
    "k65-sgd": lambda: dict(num_nodes=65),
}


def _small_data(k: int, steps: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((steps, k, 8, SMALL_MLP["input_dim"])).astype(np.float32)
    y = rng.integers(0, SMALL_MLP["num_classes"], size=(steps, k, 8)).astype(np.int32)
    return (x, y), nets.mlp_init(torch.Generator().manual_seed(seed), **SMALL_MLP)


def _small_trainer(stack: str, jit: bool, **kw):
    fields = dict(num_nodes=SMALL_K, graph="ring", lr=0.1, device="cpu", jit=jit)
    fields.update(STACKS[stack]())
    fields.update(kw)
    return DecentralizedTrainer(_tiny_loss(), **fields)


def _carry(state) -> dict:
    """Every tensor of the state's carry by path, and its host fields."""
    return cap._tensors(state), (state.step, state.comm.key, state.comm.rounds,
                                 state.comm.ef_rounds)


def _same_carry(a, ma, b, mb) -> None:
    (ta, ha), (tb, hb) = _carry(a), _carry(b)
    assert ha == hb
    assert sorted(ta) == sorted(tb)
    for p in ta:
        assert ta[p].dtype == tb[p].dtype and torch.equal(ta[p], tb[p]), p
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert ma[k].shape == mb[k].shape and torch.equal(ma[k], mb[k]), k


@pytest.mark.parametrize("stack", list(STACKS))
def test_unfused_stacks_captured_equal_eager(stack, monkeypatch, one_thread):
    """A run in epochs with a hook, past the input packing (cut to 3 steps)
    and the metrics buffer (cut to 4 columns), then ``step``: the captured
    step's parameters, optimizer state, CommState and metrics are the eager
    step's bit for bit."""
    monkeypatch.setattr(cap, "PACK_STEPS", 3)
    monkeypatch.setattr(cap, "METRIC_COLS", 4)
    k = STACKS[stack]().get("num_nodes", SMALL_K)
    batches, params = _small_data(k, SMALL_STEPS)
    first = tuple(b[0] for b in batches)
    out = {}
    for jit in (False, True):
        trainer = _small_trainer(stack, jit)
        assert trainer.captured == jit, trainer.capture_declined
        seen = []
        state, ms = trainer.run(
            trainer.init(params), batches, steps=8, epoch_steps=3,
            on_epoch=lambda e, st, m: seen.append((e, st.step, len(m["loss_mean"]))))
        state, m1 = trainer.step(state, first)
        out[jit] = (state, {**ms, **{f"step/{k}": v for k, v in m1.items()}}, seen)
    (a, ma, sa), (b, mb, sb) = out[False], out[True]
    _same_carry(a, ma, b, mb)
    assert sa == sb == [(0, 3, 3), (1, 6, 3), (2, 8, 2)]
    assert b.step == 9 and b.comm.rounds == 9


DYN_K = 8
EF_ADAPTIVE = 0.05  # a threshold this run's drift crosses both ways


def _dyn_w():
    return metropolis_weights(ring_graph(DYN_K))


# fig9/fig11's stacks, small: DecentralizedTrainer fields
DYN_STACKS = {
    "dense-dropout-H4-gt": lambda: dict(dynamics=DynamicsConfig(
        topology="dropout", drop_p=0.2, local_updates=4, gradient_tracking=True)),
    "dense-faults-skips-compute": lambda: dict(dynamics=DynamicsConfig(faults=FaultConfig(
        straggler_p=0.1, outage_p=0.05, outage_len=10, straggler_skips_compute=True))),
    "gossip-int8-memoryless-stragglers": lambda: dict(mixer=DynamicGossipMixer(
        StaticSchedule(_dyn_w(), device="cpu"), faults=FaultConfig(straggler_p=0.1),
        quantized=CompressionConfig(kind="int8", use_kernel=True, error_feedback=False))),
    "gossip-int8-ef-B4-dropout-H2": lambda: dict(mixer=LocalUpdateMixer(DynamicGossipMixer(
        DropoutSchedule(_dyn_w(), 0.2, device="cpu"), quantized=INT8_KERNEL,
        ef_rebase_every=4), 2)),
    "gossip-int8-ef-adaptive": lambda: dict(mixer=DynamicGossipMixer(
        DropoutSchedule(_dyn_w(), 0.2, device="cpu"), quantized=INT8_KERNEL,
        ef_rebase_threshold=EF_ADAPTIVE)),
    "dense-geometric": lambda: dict(dynamics=DynamicsConfig(topology="geometric")),
    "gossip-round-robin": lambda: dict(mixer=DynamicGossipMixer(
        RoundRobinSchedule(_dyn_w(), device="cpu"))),
    "hub-int8-fedavg-H4": lambda: dict(dynamics=DynamicsConfig(topology="hub", local_updates=4),
                                       compression=INT8_KERNEL),
    "hub-H1": lambda: dict(dynamics=DynamicsConfig(topology="hub")),
    "hub-scaffold-H4": lambda: dict(dynamics=DynamicsConfig(
        topology="hub", local_updates=4, gradient_tracking=True)),
    "mix-every-2": lambda: dict(mix_every=2),
    "repeat-gossip-int8-ef-2": lambda: dict(mixer=repeat_mixer(make_gossip_mixer(
        permutation_decomposition(_dyn_w()), INT8_KERNEL, device="cpu"), 2)),
}


def _dyn_trainer(stack: str, jit: bool):
    fields = dict(num_nodes=DYN_K, graph="ring", lr=0.1, device="cpu", jit=jit)
    fields.update(DYN_STACKS[stack]())
    if fields.get("mixer") is not None and fields["mixer"].compression is not None:
        fields.setdefault("compression", fields["mixer"].compression)
    return DecentralizedTrainer(_tiny_loss(), **fields)


def _branches(trainer, state, steps: int) -> list:
    """The branch of each of ``steps`` steps from ``state``, by the host
    function."""
    out, step, comm = [], state.step, state.comm
    for _ in range(steps):
        branch, comm = trainer._train_step.host_branch(step, comm)
        out.append(branch)
        step += 1
    return out


@pytest.mark.parametrize("stack", list(DYN_STACKS))
def test_dynamic_stacks_captured_equal_eager(stack, monkeypatch, one_thread):
    """A run in epochs with a hook, past the input packing (cut to 3 steps)
    and the metrics buffer (cut to 4 columns), then ``step``: the captured
    step's carry (parameters, optimizer state, every CommState tensor: θ̂,
    the mix cache, the tracker), host ints and metrics are the eager
    step's bit for bit, with one program per distinct branch met."""
    monkeypatch.setattr(cap, "PACK_STEPS", 3)
    monkeypatch.setattr(cap, "METRIC_COLS", 4)
    batches, params = _small_data(DYN_K, 10)
    first = tuple(b[0] for b in batches)
    out = {}
    for jit in (False, True):
        trainer = _dyn_trainer(stack, jit)
        assert trainer.captured == jit, trainer.capture_declined
        state = trainer.init(params)
        met = set(_branches(trainer, state, 10))
        state, ms = trainer.run(state, batches, steps=9, epoch_steps=4,
                                on_epoch=lambda e, st, m: None)
        state, m1 = trainer.step(state, first)
        out[jit] = (state, {**ms, **{f"step/{k}": v for k, v in m1.items()}})
        if jit:
            assert trainer._run._cache_size() == len(met), (met, trainer._run._cache_size())
    _same_carry(*out[False], *out[True])
    assert out[True][0].step == 10


@pytest.mark.parametrize("stack", list(DYN_STACKS))
def test_dynamic_capturable_form_reads_nothing_on_the_host(stack):
    """Each of the first steps' branches of the form the trainer captures,
    on the slot in place, its scalars packed as 0-d tensors: no op reads
    the device on the host."""
    batches, params = _small_data(DYN_K, 6)
    trainer = _dyn_trainer(stack, True)
    step = trainer._train_step
    state = trainer.init(params)
    for t in range(5):
        branch = step.host_branch(state.step, state.comm)[0]
        sc = step_scalars(step.host_scalars(state.step, state.comm.rounds), trainer.device)
        batch = trainer._batch(tuple(b[t] for b in batches))
        with _HostReads() as mode:
            state, _ = step.capturable(state, batch, sc, inplace=t > 0, branch=branch)
        assert mode.seen == [], (t, branch, mode.seen)


def test_adaptive_rebase_takes_both_sides(one_thread):
    """The adaptive re-base's device select is taken both ways in the
    parity run's 10 rounds: counted from each eager round's ``ef_drift``
    against the threshold, some rounds but not all re-base, and the
    captured run's per-step ``wire_bits`` are the eager steps' bit for bit
    (so it billed the same rounds at full precision)."""
    batches, params = _small_data(DYN_K, 10)
    eager = _dyn_trainer("gossip-int8-ef-adaptive", False)
    state, drifts, bits = eager.init(params), [], []
    for t in range(10):
        state, m = eager.step(state, tuple(b[t] for b in batches))
        drifts.append(float(state.comm.ef_drift))
        bits.append(m["wire_bits"])
    rebases = sum(d > EF_ADAPTIVE for d in drifts)
    assert 0 < rebases < 10, drifts
    captured = _dyn_trainer("gossip-int8-ef-adaptive", True)
    assert captured.captured
    _, ms = captured.run(captured.init(params), batches)
    assert torch.equal(ms["wire_bits"], torch.stack(bits))


def test_branches_replayed_out_of_capture_order_equal_eager(one_thread):
    """The int8 EF gossip under dropout, re-based every 2 executed rounds,
    inside H = 2: the graphs are captured local, delta, re-base, and
    replayed local, delta, local, re-base, local, delta, ... across two
    runs; the carry and metrics equal the eager runs' bit for bit."""
    def mixer():
        return LocalUpdateMixer(DynamicGossipMixer(
            DropoutSchedule(_dyn_w(), 0.2, device="cpu"), quantized=INT8_KERNEL,
            ef_rebase_every=2), 2)

    batches, params = _small_data(DYN_K, 12)
    out = {}
    for jit in (False, True):
        trainer = DecentralizedTrainer(_tiny_loss(), num_nodes=DYN_K, graph="ring", lr=0.1,
                                       device="cpu", jit=jit, mixer=mixer(),
                                       compression=INT8_KERNEL)
        state = trainer.init(params)
        branches = _branches(trainer, state, 12)
        assert branches[:5] == [(True, (False, None)), (True, (True, False)),
                                (True, (False, None)), (True, (True, True)),
                                (True, (False, None))]
        state, m0 = trainer.run(state, tuple(b[:3] for b in batches))
        if jit:
            assert trainer._run._cache_size() == 2
        state, m1 = trainer.run(state, tuple(b[3:] for b in batches))
        out[jit] = (state, {k: torch.cat([m0[k], m1[k]]) for k in m0})
        if jit:
            assert trainer._run._cache_size() == 3
    _same_carry(*out[False], *out[True])
    assert out[True][0].comm.ef_rounds == 6 and out[True][0].comm.rounds == 12


def test_checkpoint_mid_period_captured_equals_eager(tmp_path, one_thread):
    """Dense dropout under LocalUpdateMixer H = 4 with gradient tracking: 5
    captured steps (one into the second period), saved, restored and 6
    more captured steps (the restored run starts on a local branch, its
    consensus graph captured where it first appears) equal 11 eager steps
    bit for bit, the tracker included."""
    batches, params = _small_data(DYN_K, 11)
    eager = _dyn_trainer("dense-dropout-H4-gt", False)
    want = eager.run(eager.init(params), batches)
    first = _dyn_trainer("dense-dropout-H4-gt", True)
    state, m0 = first.run(first.init(params), tuple(b[:5] for b in batches))
    save_train_state(str(tmp_path), state.step, state)
    restored, step = restore_train_state(str(tmp_path), device="cpu")
    assert step == 5 and restored.comm.rounds == 5 and restored.comm.track != ()
    second = _dyn_trainer("dense-dropout-H4-gt", True)
    assert second.captured
    got, m1 = second.run(restored, tuple(b[5:] for b in batches))
    assert second._run._cache_size() == 2
    _same_carry(want[0], want[1], got, {k: torch.cat([m0[k], m1[k]]) for k in m0})


class _HostReads(TorchDispatchMode):
    """Records every op that reads a device value on the host or makes a
    tensor from host data: neither can be replayed from a CUDA graph."""

    HOST = ("_local_scalar_dense", "item", "nonzero", "equal", "is_nonzero", "lift_fresh",
            "masked_select", "unique")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.HOST or name.startswith("_unique"):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("stack", list(STACKS))
def test_capturable_form_reads_nothing_on_the_host(stack):
    """The form the trainer captures, on the slot in place, its scalars
    packed as 0-d tensors: no op reads the device on the host."""
    k = STACKS[stack]().get("num_nodes", SMALL_K)
    batches, params = _small_data(k, 2)
    trainer = _small_trainer(stack, True)
    state, _ = trainer._train_step(trainer.init(params), trainer._batch(tuple(b[0] for b in
                                                                         batches)))
    step = trainer._train_step
    sc = step_scalars(step.host_scalars(state.step, state.comm.rounds), trainer.device)
    batch = trainer._batch(tuple(b[1] for b in batches))
    with _HostReads() as mode:
        step.capturable(state, batch, sc, inplace=True)
    assert mode.seen == [], mode.seen


def test_fmnist_int8_ef_captured_equals_eager(fmnist, one_thread):
    """The paper's fmnist stack with the dense int8 EF wire through the
    kernel quantizer (its plain version here), 20 steps."""
    batches, params = fmnist
    out = {}
    for jit in (False, True):
        trainer = _fmnist_trainer(jit, compression=INT8_KERNEL)
        assert trainer.captured == jit
        out[jit] = trainer.run(trainer.init(params), batches)
    _same_carry(*out[False], *out[True])


def test_checkpoint_round_trip_captured_equals_eager(tmp_path, one_thread):
    """Momentum and the dense int8 EF wire: 5 captured steps, saved,
    restored and 5 more captured steps equal 10 eager steps bit for bit."""
    batches, params = _small_data(SMALL_K, 10)
    stack = dict(optimizer=momentum(0.05, nesterov=True), compression=INT8_KERNEL)
    eager = _small_trainer("dense-int8-kernel-ef", False, **stack)
    want = eager.run(eager.init(params), batches)
    first = _small_trainer("dense-int8-kernel-ef", True, **stack)
    half = tuple(b[:5] for b in batches)
    state, m0 = first.run(first.init(params), half)
    save_train_state(str(tmp_path), state.step, state)
    restored, step = restore_train_state(str(tmp_path), device="cpu")
    assert step == 5
    second = _small_trainer("dense-int8-kernel-ef", True, **stack)
    assert first.captured and second.captured
    got, m1 = second.run(restored, tuple(b[5:] for b in batches))
    _same_carry(want[0], want[1], got, {k: torch.cat([m0[k], m1[k]]) for k in m0})


class _ForeignSchedule(StaticSchedule):
    """A schedule class the port does not define: it is handed the round as
    a host int, so its stack runs eagerly."""


@pytest.mark.parametrize("case,words", [
    ("seam", "replaced fault seam"), ("schedule", "_ForeignSchedule"),
    ("hook", "uniforms hook"), ("optimizer", "no device form"), ("sink", "sink"),
    ("sanitize", "sanitize"), ("jit", "jit=False")])
def test_capture_predicate_declines_with_reason(case, words, monkeypatch):
    kw = dict(num_nodes=4, graph="ring", lr=0.1, device="cpu")
    w = metropolis_weights(ring_graph(4))
    if case == "seam":
        monkeypatch.setattr(comm_topology, "round_fault_masks",
                            lambda cfg, r, k, device: (torch.ones(k, k), torch.ones(k)))
        trainer = TrainerSpec(straggler_p=0.1, **kw).build(_tiny_loss())
    else:
        extra = {"schedule": lambda: dict(mixer=DynamicDenseMixer(
                     _ForeignSchedule(w, device="cpu"))),
                 "hook": lambda: dict(compression=INT8_KERNEL, mixer=make_dense_mixer(
                     w, INT8_KERNEL, device="cpu",
                     uniforms=lambda r, i, shape: np.full(shape, 0.5, np.float32))),
                 "optimizer": lambda: dict(optimizer=Optimizer(sgd(0.1).init, sgd(0.1).update)),
                 "sink": lambda: dict(obs=MetricsSink()), "sanitize": lambda: dict(sanitize=True),
                 "jit": lambda: dict(jit=False)}[case]()
        trainer = DecentralizedTrainer(_tiny_loss(), **kw, **extra)
    assert not trainer.captured
    assert words in trainer.capture_declined, trainer.capture_declined
    if case == "jit":
        assert not hasattr(trainer._run, "_cache_size")
    else:
        assert trainer._run._cache_size() == 0


def test_capture_predicate_keeps_the_fused_stack():
    trainer = DecentralizedTrainer(_tiny_loss(), num_nodes=4, graph="ring", lr=0.1, device="cpu")
    assert trainer.captured and trainer.capture_declined is None
    assert trainer._train_step.capturable.__name__ == "fused_step"
    for stack in STACKS:  # every codec, schedule and optimizer, and K > 64: the unfused step
        kept = _small_trainer(stack, True)
        assert kept.captured, (stack, kept.capture_declined)
        assert kept._train_step.capturable.__name__ == "unfused_step", stack
    lm = TransformerLM(get_arch("rwkv6_7b", smoke=True))
    looped = DecentralizedTrainer(make_lm_loss(lm), num_nodes=4, graph="ring", device="cpu")
    assert "per-node loop" in looped.capture_declined


@pytest.mark.parametrize("argv,line", [
    ([], "step: captured"),
    (["--compress", "int8"], "step: captured"),
    (["--topology", "dropout", "--drop-p", "0.2", "--local-updates", "4",
      "--gradient-tracking", "--straggler-p", "0.1"], "step: captured"),
    (["--topology", "hub", "--local-updates", "4"], "step: captured"),
    (["--log-dir", "LOG"], "step: eager (a telemetry sink (obs) taps the step)")])
def test_cli_says_how_the_step_runs(argv, line, tmp_path, capsys):
    from repro_torch.launch import train

    argv = [str(tmp_path) if a == "LOG" else a for a in argv]
    train.main(["--paper", "fmnist", "--device", "cpu", "--steps", "2", "--nodes", "4",
                "--log-every", "1", *argv])
    assert capsys.readouterr().out.splitlines()[0] == line


@pytest.mark.parametrize("d", [64, 1000])
def test_stacked_eta_tensor_and_out_match_reference_kernel(d):
    k, eta = 6, 0.05
    g = ring_graph(k)
    w = metropolis_weights(g)
    rng = np.random.default_rng(d + 1)
    thetas, grads = (rng.standard_normal((k, d)).astype(np.float32) for _ in range(2))
    scales = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    args = ([torch.from_numpy(thetas)], [torch.from_numpy(grads)],
            torch.from_numpy(w.astype(np.float32)), torch.from_numpy(scales))
    out = [torch.full((k, d), float("nan"))]
    eta_t = torch.tensor(eta, dtype=torch.float32)
    got = ops.gossip_update_stacked_grouped(*args, eta=eta_t, out=out)
    assert got[0] is out[0]
    assert torch.equal(got[0], ops.gossip_update_stacked_grouped(*args, eta=eta)[0])
    updated = thetas - np.float32(eta) * scales[:, None] * grads  # what each neighbour sends
    for i in range(k):
        nbr_ids = g.neighbors(i)
        weights = np.concatenate([[w[i, i]], w[i, nbr_ids]]).astype(np.float32)
        want = ref_flat(jnp.asarray(thetas[i]), jnp.asarray(grads[i]),
                        jnp.asarray(updated[nbr_ids]), jnp.asarray(weights),
                        jnp.float32(scales[i]), eta=eta, interpret=True)
        np.testing.assert_allclose(out[0][i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_stacked_out_in_place_equals_new_leaves():
    """``out`` the θ leaves themselves (the captured step's update in place):
    the same bits as new leaves, written into θ and returned."""
    rng = np.random.default_rng(5)
    k = 5
    thetas = [torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
              for d in (7, 300)]
    grads = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) for t in thetas]
    w = torch.from_numpy(metropolis_weights(ring_graph(k)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 2.0, size=k).astype(np.float32))
    eta = torch.tensor(0.05)
    want = ops.gossip_update_stacked_grouped(thetas, grads, w, s, eta=eta)
    got = ops.gossip_update_stacked_grouped(thetas, grads, w, s, eta=eta, out=thetas)
    assert all(g is t for g, t in zip(got, thetas))
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def test_stacked_eta_tensor_follows_the_schedule_in_bfloat16():
    """A bfloat16 leaf: η as a tensor gives the float η's bits (f32(η)
    times the bfloat16 g·s, rounded once to bfloat16)."""
    rng = np.random.default_rng(9)
    theta, grad = (torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(2))
    w, s = torch.eye(3), torch.tensor([0.7, 1.3, 2.1])
    for eta in (0.1, 0.0371, 3e-4):
        a = ops.gossip_update_stacked(theta, grad, w, s, eta=eta)
        b = ops.gossip_update_stacked(theta, grad, w, s, eta=torch.tensor(eta))
        assert torch.equal(a, b), eta
