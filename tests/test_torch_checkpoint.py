"""The port's checkpoints (``repro_torch.checkpoint``) against the reference's.

Port to port: a run saved with ``save_train_state``, restored with
``restore_train_state`` and continued equals the uninterrupted run bit for
bit — every parameter, every ``CommState`` field and every metric — on the
fused dense SGD step, the int8 error-feedback gossip stack over dropout
(``hat``, ``hat_mix``, ``ef_rounds``, saved mid re-base period), gradient
tracking under ``LocalUpdateMixer`` (``track``), a faulted run (its coins
are a pure function of ``rounds``) and a state with a bfloat16 leaf.

Reference to port: the reference writes with its ``save_train_state``; the
port restores every field equal but ``key`` (which follows the module's
stated rule), and the dense uncompressed stack continues within the
trainer's trajectory tolerance (rtol 1e-5, atol 1e-6,
tests/test_torch_trainer.py) of the reference's continuation.  The
reference's padding cases (pre-``track`` and pre-``ef_rounds`` files,
tests/test_checkpoint.py) restore in the port.  A file the port writes
restores in the reference.  The port's MessagePack codec is held byte for
byte against the ``msgpack`` package.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore_checkpoint
from repro.checkpoint import restore_train_state as ref_restore_train_state
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.checkpoint import save_train_state as ref_save_train_state
from repro.comm.protocol import CommState as RefCommState
from repro.comm.protocol import trivial_comm_state as ref_trivial_comm_state
from repro.core import TrainerSpec as RefTrainerSpec
from repro.core.drdsgd import DecentralizedState as RefState
from repro_torch.checkpoint import (
    _msgpack,
    io,
    latest_step,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from repro_torch.comm import CompressionConfig
from repro_torch.comm.protocol import CommState
from repro_torch.core import TrainerSpec
from repro_torch.core.drdsgd import DecentralizedState
from repro_torch.dynamics import DropoutSchedule, DynamicGossipMixer
from repro_torch.graphs import build_graph, metropolis_weights
from repro_torch.utils.tree import flatten

K = 6


def _loss(params, batch):
    x, y = batch
    w = params["w"].float()
    out = torch.bmm(x, w)
    if "b" in params:
        out = out + params["b"].float()[:, None, :]
    return ((out - y) ** 2).mean((1, 2))


def _ref_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, 8, 4)).astype(np.float32),
            rng.normal(size=(K, 8, 2)).astype(np.float32))


def _spec(**kw):
    return TrainerSpec(num_nodes=K, graph="ring", lr=0.05, device="cpu", **kw)


def _ef_gossip_mixer():
    w = metropolis_weights(build_graph("ring", K))
    return DynamicGossipMixer(DropoutSchedule(w, 0.3, seed=1, device="cpu"),
                              quantized=CompressionConfig(kind="int8", use_kernel=True,
                                                          seed=5),
                              ef_rebase_every=4)


def _leaves(tree, prefix="") -> dict:
    """Every tensor and host value of a state, keyed by its path."""
    if isinstance(tree, (DecentralizedState, CommState)):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {f"{prefix}#len": len(tree)}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for name, x in la.items():
        y = lb[name]
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, name
            assert torch.equal(x, y), name
        else:
            assert type(x) is type(y) and x == y, name


def _params(bf16: bool = False) -> dict:
    p = {"w": torch.zeros(4, 2)}
    if bf16:
        p["b"] = torch.full((2,), 0.25, dtype=torch.bfloat16)
    return p


# (trainer spec kwargs, mixer factory, initial params, steps before the save,
# a field the stack must have filled by then)
STACKS = {
    "fused-dense-sgd": (dict(), None, False, 3, None),
    "int8-ef-gossip-dropout": (dict(), _ef_gossip_mixer, False, 6, "hat_mix"),
    "gradient-tracking": (dict(topology="dropout", drop_p=0.3, local_updates=2,
                               gradient_tracking=True), None, False, 3, "track"),
    "faulted": (dict(straggler_p=0.3, outage_p=0.2, outage_len=3,
                     straggler_skips_compute=True), None, False, 4, None),
    "bf16-leaf": (dict(), None, True, 3, None),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_resume_is_bitwise(tmp_path, stack):
    kw, mixer, bf16, before, filled = STACKS[stack]
    trainer = _spec(**kw).build(_loss, mixer=mixer() if mixer else None)
    state = trainer.init(_params(bf16))
    for i in range(before):
        state, _ = trainer.step(state, _batch(i))
    if filled is not None:
        assert state.comm._asdict()[filled] != ()
    if stack == "int8-ef-gossip-dropout":
        assert state.comm.ef_rounds % 4 != 3  # saved mid re-base period
    save_train_state(str(tmp_path), before, state)
    restored, step = restore_train_state(str(tmp_path), device="cpu")
    assert step == before
    _assert_bitwise(restored, state)

    runs = []
    for s in (state, restored):
        ms = []
        for i in range(before, before + 4):
            s, m = trainer.step(s, _batch(i))
            ms.append(m)
        runs.append((s, ms))
    (s1, m1), (s2, m2) = runs
    _assert_bitwise(s2, s1)
    for a, b in zip(m1, m2):
        _assert_bitwise(b, a)


# -- the reference's files ------------------------------------------------------

def _ref_toy(**kw):
    return RefTrainerSpec(num_nodes=K, graph="ring", lr=0.05, metrics_disagreement=False,
                          **kw).build(_ref_loss)


def _ref_state_after(trainer, steps):
    state = trainer.init({"w": jnp.zeros((4, 2))})
    for i in range(steps):
        state, _ = trainer.step(state, tuple(jnp.asarray(b) for b in _batch(i)))
    return state


def _assert_equal_to_reference(port_tree, ref_tree, name=""):
    """A restored port field against the reference's: flat dicts against
    nested ones, tensors against arrays bit for bit."""
    if isinstance(port_tree, dict):
        flat = flatten(ref_tree)
        assert sorted(port_tree) == sorted(flat), name
        for k in flat:
            _assert_equal_to_reference(port_tree[k], flat[k], f"{name}/{k}")
    elif isinstance(port_tree, tuple):
        assert len(port_tree) == len(ref_tree), name
        for i, (a, b) in enumerate(zip(port_tree, ref_tree)):
            _assert_equal_to_reference(a, b, f"{name}[{i}]")
    elif isinstance(port_tree, torch.Tensor):
        np.testing.assert_array_equal(port_tree.numpy(), np.asarray(ref_tree), err_msg=name)
    else:  # a host int of the port
        assert port_tree == int(np.asarray(ref_tree)), name


def _assert_restores_reference(tmp_path, ref_state):
    restored, _ = restore_train_state(str(tmp_path), device="cpu")
    assert isinstance(restored, DecentralizedState) and isinstance(restored.comm, CommState)
    _assert_equal_to_reference(restored.params, ref_state.params, "params")
    assert restored.step == int(ref_state.step)
    for field in CommState._fields:
        if field == "key":
            continue
        _assert_equal_to_reference(getattr(restored.comm, field),
                                   getattr(ref_state.comm, field), field)
    hi, lo = (int(w) for w in np.asarray(ref_state.comm.key))
    assert restored.comm.key == (hi << 32) | lo
    return restored


@pytest.mark.parametrize("kw", [dict(), dict(compress="int8"),
                                dict(topology="dropout", drop_p=0.3, local_updates=2,
                                     gradient_tracking=True)],
                         ids=["dense", "int8-ef-dense", "gradient-tracking"])
def test_reference_file_restores_field_equal(tmp_path, kw):
    ref_state = _ref_state_after(_ref_toy(**kw), 3)
    ref_save_train_state(str(tmp_path), 3, ref_state)
    restored = _assert_restores_reference(tmp_path, ref_state)
    if "compress" in kw:
        assert restored.comm.hat != ()
    if "gradient_tracking" in kw:
        assert restored.comm.track != ()


def test_reference_file_continues_within_trajectory_tolerance(tmp_path):
    """The dense uncompressed stack is deterministic: the port restores the
    reference's file and steps on beside the reference's continuation."""
    ref_trainer = _ref_toy()
    ref_state = _ref_state_after(ref_trainer, 3)
    ref_save_train_state(str(tmp_path), 3, ref_state)
    state, _ = restore_train_state(str(tmp_path), device="cpu")
    trainer = _spec().build(_loss)
    for i in range(3, 13):
        batch = _batch(i)
        ref_state, ref_m = ref_trainer.step(ref_state, tuple(jnp.asarray(b) for b in batch))
        state, m = trainer.step(state, batch)
        np.testing.assert_allclose(state.params["w"].numpy(), np.asarray(ref_state.params["w"]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["loss_mean"]), float(ref_m["loss_mean"]),
                                   rtol=1e-5, atol=1e-6)
    assert state.step == int(ref_state.step) and state.comm.rounds == int(ref_state.comm.rounds)


def test_reference_pre_track_file_pads(tmp_path):
    """tests/test_checkpoint.py's pre-``track`` file: a 7-field CommState."""
    ref_save_checkpoint(str(tmp_path), 5, {
        "params": {"w": jnp.ones((2, 3))}, "opt_state": (), "step": jnp.int32(5),
        "comm": tuple(ref_trivial_comm_state())[:7]})
    restored, step = restore_train_state(str(tmp_path), device="cpu")
    assert step == 5 and restored.step == 5
    assert isinstance(restored.comm, CommState)
    assert restored.comm.track == () and restored.comm.ef_rounds == ()
    assert restored.comm.rounds == 0 and restored.comm.key == 0


def test_reference_pre_ef_rounds_file_pads_and_continues(tmp_path):
    """tests/test_checkpoint.py's pre-``ef_rounds`` file (8 fields) of the
    int8 EF dense stack restores with ``ef_rounds`` empty and every stored
    field equal."""
    ref_state = _ref_state_after(_ref_toy(compress="int8"), 2)
    ref_save_checkpoint(str(tmp_path), 2, {
        "params": ref_state.params, "opt_state": ref_state.opt_state,
        "step": ref_state.step, "comm": tuple(ref_state.comm)[:8]})
    restored = _assert_restores_reference(tmp_path, ref_state)
    assert restored.comm.ef_rounds == ()
    trainer = _spec(compress="int8").build(_loss)
    state, _ = trainer.step(restored, _batch(2))
    assert state.step == 3 and state.comm.rounds == 3


def test_reference_ef_rounds_clock_restores(tmp_path):
    comm = RefCommState(
        hat={"w": jnp.ones((4, 2))}, hat_mix={"w": jnp.full((4, 2), 2.0)},
        key=jax.random.PRNGKey(3), res_norm=jnp.float32(0.5), res_ref=jnp.float32(0.25),
        rounds=jnp.int32(11), wire_bits=jnp.float32(96.0), track=(),
        ef_rounds=jnp.int32(11))
    ref_save_train_state(str(tmp_path), 11, RefState(
        params={"w": jnp.zeros((4, 2))}, opt_state=(), step=jnp.int32(11), comm=comm))
    restored, _ = restore_train_state(str(tmp_path), device="cpu")
    assert restored.comm.ef_rounds == 11 and restored.comm.rounds == 11
    assert restored.comm.key == 3  # PRNGKey(3) holds the words (0, 3)
    assert torch.equal(restored.comm.hat_mix["w"], torch.full((4, 2), 2.0))
    assert float(restored.comm.res_ref) == 0.25


def test_port_file_restores_in_the_reference(tmp_path):
    """One layout: the reference reads a port file (nested params, 0-d
    int32 step and rounds, the seed as PRNGKey words)."""
    trainer = _spec(compress="int8").build(_loss)
    state = trainer.init(_params())
    for i in range(2):
        state, _ = trainer.step(state, _batch(i))
    save_train_state(str(tmp_path), 2, state)
    ref, step = ref_restore_train_state(str(tmp_path))
    assert step == 2 and int(ref.step) == 2 and int(ref.comm.rounds) == 2
    np.testing.assert_array_equal(np.asarray(ref.params["w"]), state.params["w"].numpy())
    np.testing.assert_array_equal(np.asarray(ref.comm.hat["w"]), state.comm.hat["w"].numpy())
    np.testing.assert_array_equal(np.asarray(ref.comm.key),
                                  np.asarray(jax.random.PRNGKey(state.comm.key)))


# -- the tree format and the codec ------------------------------------------------

def test_tree_roundtrip_and_steps(tmp_path):
    tree = {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "opt": (torch.zeros(2), None), "step": 7, "names": ["a", "b"],
            "ints": torch.arange(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 7, tree)
    save_checkpoint(str(tmp_path), 3, {"x": torch.ones(2)})
    assert latest_step(str(tmp_path)) == 7
    got, step = restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 7
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["b"], tree["params"]["b"])
    assert got["opt"][1] is None and isinstance(got["opt"], tuple)
    assert got["step"] == 7 and got["names"] == ["a", "b"]
    assert torch.equal(got["ints"], tree["ints"])
    earlier, step = restore_checkpoint(str(tmp_path), step=3, device="cpu")
    assert step == 3 and torch.equal(earlier["x"], torch.ones(2))
    # the reference reads the port's tree, bfloat16 included (ml_dtypes)
    ref, _ = ref_restore_checkpoint(str(tmp_path))
    assert str(ref["params"]["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(ref["params"]["b"], np.float32), [1.5, -2.25])
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_reference_tree_restores_in_the_port(tmp_path):
    ref_save_checkpoint(str(tmp_path), 4, {
        "w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones((4,), jnp.bfloat16),
        "none": None, "t": (1, 2.5)})
    got, _ = restore_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"].float(), torch.ones(4))
    assert got["none"] is None and got["t"] == (1, 2.5)


def test_codec_is_msgpacks_byte_for_byte(tmp_path):
    """The port's packer writes the reference's file bytes from the same
    object, and its reader reads what msgpack reads, on a real train-state
    file and on every size class of each type."""
    ref_state = _ref_state_after(_ref_toy(compress="int8"), 2)
    ref_save_train_state(str(tmp_path), 2, ref_state)
    blob = (tmp_path / "step_00000002" / "state.msgpack").read_bytes()
    obj = msgpack.unpackb(blob, raw=False)
    assert _msgpack.unpackb(blob) == obj
    assert _msgpack.packb(obj) == blob
    cases = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
             0.1, -2.5e300, True, False, None, "", "é" * 40, "s" * 300, "s" * 70000,
             b"", b"x" * 255, b"x" * 256, b"x" * 70000, list(range(15)), list(range(16)),
             list(range(70000)), {str(i): i for i in range(15)},
             {str(i): i for i in range(16)}, {"nested": [{"a": [None]}, (1, 2)]}]
    for case in cases:
        packed = msgpack.packb(case, use_bin_type=True)
        assert _msgpack.packb(case) == packed, repr(case)[:60]
        assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)
    assert _msgpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\x92\x01")  # truncated


def test_leaf_over_bin32_raises_naming_it(tmp_path, monkeypatch):
    """MessagePack's bin32 holds at most 2**32 - 1 bytes per leaf (the
    limit is lowered here so the test needs no 4 GB leaf)."""
    monkeypatch.setattr(io, "BIN32_MAX", 32)
    with pytest.raises(ValueError, match="'params/embedding/table'.*bin32"):
        save_checkpoint(str(tmp_path), 0, {"params": {"embedding": {
            "table": torch.zeros(3, 4)}}})
    save_checkpoint(str(tmp_path), 0, {"small": torch.zeros(8)})  # 32 bytes: fits


@pytest.mark.parametrize("argv", [
    ["--paper", "fmnist", "--steps", "3", "--nodes", "4", "--compress", "int8"],
    ["--arch", "qwen2_0_5b", "--smoke", "--steps", "2", "--nodes", "2", "--seq-len", "8",
     "--log-every", "1"]], ids=["paper", "arch"])
def test_cli_ckpt_dir_saves_the_final_state(tmp_path, capsys, argv):
    from repro_torch.launch import train

    out = train.main([*argv, "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    state = out if isinstance(out, DecentralizedState) else out[1]  # train_lm: (trainer, state, ...)
    assert "checkpoint saved to" in capsys.readouterr().out
    steps = int(argv[argv.index("--steps") + 1])
    assert latest_step(str(tmp_path)) == steps
    restored, _ = restore_train_state(str(tmp_path), device="cpu")
    _assert_bitwise(restored, state)
