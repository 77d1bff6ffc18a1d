"""The port's analysis tooling (``repro_torch.analysis``) against the
reference's ``repro.analysis``.

* The sanitizer: each check fires on the same injected violation at the
  same step as the reference's ``--sanitize`` — a W row off by 1e-2, a NaN
  in one node's parameters, a qmax of 128 — on the int8 dense wire, the
  reference stepped one step at a time (``jit=False``, so an injection
  between steps reaches its next trace), the port through ``run`` with the
  injection between two epochs.  The link-mask check is held function to
  function (the reference's dynamic gossip needs a device mesh) and fired
  at its step on the port's memoryless straggler gossip.  Clean runs fire
  nothing, on every stack here.
* The linter: each rule on small fixtures, the waivers, and
  ``src/repro_torch`` linting clean.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from repro.analysis import sanitize as ref_sanitize
from repro.core import TrainerSpec as RefSpec
from repro_torch.analysis import SanitizeError, SanitizeFlags, lint_paths, lint_source
from repro_torch.analysis import sanitize as port_sanitize
from repro_torch.analysis.lint import lint_schema
from repro_torch.core import TrainerSpec
from repro_torch.dynamics import DynamicGossipMixer, FaultConfig, StaticSchedule
from repro_torch.graphs import build_graph, metropolis_weights

ROOT = os.path.join(os.path.dirname(__file__), "..")
K, T, AT = 4, 6, 3          # nodes, steps, the injected step


def _ref_loss(p, b):
    x, y = b
    return jnp.mean((x @ p["w"] - y) ** 2)


def _port_loss(p, b):
    x, y = b
    return ((torch.einsum("kbi,kio->kbo", x, p["w"]) - y) ** 2).mean((1, 2))


def _data():
    rng = np.random.default_rng(0)
    w0 = (rng.normal(size=(6, 2)) * 0.1).astype(np.float32)
    x = rng.normal(size=(T, K, 3, 6)).astype(np.float32)
    y = rng.normal(size=(T, K, 3, 2)).astype(np.float32)
    return w0, x, y


def _target(mixer):
    while hasattr(mixer, "inner"):
        mixer = mixer.inner
    return mixer


# the violations: (what, stack kwargs, injection into the reference, into the port)
def _bad_w(target, state, torch_side):
    if torch_side:
        target.w[0, 0] += 1e-2
        return state
    object.__setattr__(target, "w", target.w.at[0, 0].add(1e-2))
    return state


def _nan(target, state, torch_side):
    if torch_side:
        state.params["w"][1, 0, 0] = float("nan")
        return state
    return state._replace(params={"w": state.params["w"].at[1, 0, 0].set(jnp.nan)})


def _qmax128(target, state, torch_side):
    if torch_side:
        target._rate = lambda comm: torch.full((), 128.0)
    else:
        object.__setattr__(target, "_rate", lambda comm: jnp.float32(128.0))
    return state


VIOLATIONS = {
    "w-row": ("doubly_stochastic", "doubly stochastic", {}, _bad_w),
    "nan": ("finite", "non-finite", {}, _nan),
    "qmax-128": ("rate_in_container", "int8 container", dict(compress_schedule="linear"),
                 _qmax128),
}


def _ref_first_throw(kw, inject):
    """The first step at which the reference's sanitized step throws."""
    spec = RefSpec(num_nodes=K, graph="ring", mu=3.0, lr=0.05, compress="int8",
                   sanitize=True, jit=False, **kw)
    trainer = spec.build(_ref_loss)
    w0, x, y = _data()
    state = trainer.init({"w": jnp.asarray(w0)})
    for t in range(T):
        if t == AT and inject is not None:
            state = inject(_target(trainer.mixer), state, False)
        try:
            state, _ = trainer.step(state, (jnp.asarray(x[t]), jnp.asarray(y[t])))
        except checkify.JaxRuntimeError as e:
            return t, str(e)
    return None, ""


def _port_run(kw, inject, mixer=None):
    spec = TrainerSpec(num_nodes=K, graph="ring", mu=3.0, lr=0.05, compress="int8",
                       sanitize=True, device="cpu", **kw)
    trainer = spec.build(_port_loss, mixer=mixer)
    w0, x, y = _data()
    state = trainer.init({"w": torch.from_numpy(w0)})

    def on_epoch(e, st, ms):
        if e == 0 and inject is not None:
            inject(_target(trainer.mixer), st, True)

    return trainer.run(state, (x, y), epoch_steps=AT, on_epoch=on_epoch)


@pytest.mark.parametrize("name", list(VIOLATIONS))
def test_each_check_fires_where_the_reference_fires(name):
    check, ref_words, kw, inject = VIOLATIONS[name]
    ref_step, ref_msg = _ref_first_throw(kw, inject)
    assert ref_step == AT and ref_words in ref_msg, (ref_step, ref_msg)
    with pytest.raises(SanitizeError) as err:
        _port_run(kw, inject)
    assert err.value.fired[check][0] == AT, err.value.fired
    assert f"step {AT}: {check}:" in str(err.value) and ref_words in str(err.value)


@pytest.mark.parametrize("kw", [{}, dict(compress_schedule="linear")],
                         ids=["int8", "int8-linear"])
def test_clean_runs_fire_nothing_in_either_package(kw):
    assert _ref_first_throw(kw, None) == (None, "")
    _port_run(kw, None)


def test_sanitized_trajectory_is_bit_exact():
    w0, x, y = _data()
    runs = {}
    for sanitize in (False, True):
        spec = TrainerSpec(num_nodes=K, graph="ring", mu=3.0, lr=0.05, compress="int8",
                           topology="dropout", drop_p=0.3, sanitize=sanitize, device="cpu")
        trainer = spec.build(_port_loss)
        state, ms = trainer.run(trainer.init({"w": torch.from_numpy(w0)}), (x, y))
        runs[sanitize] = (state.params["w"], ms["loss_mean"])
    assert torch.equal(runs[False][0], runs[True][0])
    assert torch.equal(runs[False][1], runs[True][1])


def _gossip():
    """The memoryless int8 gossip wire under stragglers, on the CPU."""
    from repro_torch.comm import CompressionConfig

    w = metropolis_weights(build_graph("ring", K))
    return DynamicGossipMixer(StaticSchedule(w, device="cpu"),
                              faults=FaultConfig(straggler_p=0.3, seed=1),
                              quantized=CompressionConfig(kind="int8", error_feedback=False))


def test_mask_check_matches_the_reference_and_fires_at_its_step():
    masks = [np.array([1.0, 0.0, 1.0, 1.0], np.float32), np.array([1.0, 0.5, 1.0, 1.0],
                                                                  np.float32)]
    for ms, bad in ((masks[:1], False), (masks, True)):
        err, _ = checkify.checkify(ref_sanitize.check_masks_binary)(
            [jnp.asarray(m) for m in ms])
        flags = SanitizeFlags()
        port_sanitize.check_masks_binary([torch.from_numpy(m) for m in ms], flags, 7)
        assert (err.get() is not None) == bad == ("masks_binary" in flags.fired())
        if bad:
            assert "matching 1 link mask" in err.get()
            assert flags.fired()["masks_binary"] == (7, 1.0)

    def half_mask(target, state, torch_side):
        inner = target._round_vectors

        def vectors(w):
            self_w, match_ws, ms = inner(w)
            return self_w, match_ws, [ms[0] * 0.5] + list(ms[1:])
        target._round_vectors = vectors

    with pytest.raises(SanitizeError, match=f"step {AT}: masks_binary"):
        _port_run({}, half_mask, mixer=_gossip())
    _port_run({}, None, mixer=_gossip())   # the straggler rounds' masks are binary


def test_choco_check_matches_the_reference():
    rng = np.random.default_rng(2)
    hat = rng.normal(size=(K, 5)).astype(np.float32)
    for drift, bad in ((0.0, False), (0.5, True)):
        mix = hat.copy()
        mix[0, 2] += drift
        ref_comm = type("C", (), {"hat": {"a": jnp.asarray(hat)},
                                  "hat_mix": {"a": jnp.asarray(mix)}})()
        err, _ = checkify.checkify(ref_sanitize.check_choco_invariant)(ref_comm)
        port_comm = type("C", (), {"hat": {"a": torch.from_numpy(hat)},
                                   "hat_mix": {"a": torch.from_numpy(mix)}})()
        flags = SanitizeFlags()
        port_sanitize.check_choco_invariant(port_comm, flags, 0)
        assert (err.get() is not None) == bad == ("choco_invariant" in flags.fired())


def test_flags_read_in_one_copy_and_clear():
    flags = SanitizeFlags()
    for step in range(3):
        flags.record("c", torch.tensor(step != 1), step, torch.tensor(float(step)), str)
    assert flags.fired() == {"c": (1, 1.0)}
    with pytest.raises(SanitizeError, match="step 1: c: 1.0"):
        flags.throw()
    flags.throw()  # cleared


def test_cli_threads_sanitize_to_the_trainer():
    import argparse

    ap = argparse.ArgumentParser()
    TrainerSpec.add_cli_args(ap)
    args = ap.parse_args(["--sanitize", "--ef-rebase-threshold", "2.5", "--device", "cpu"])
    spec = TrainerSpec.from_args(args, num_nodes=4, lr=0.1, graph="ring")
    assert spec.sanitize is True and spec.ef_rebase_threshold == 2.5
    assert spec.build(_port_loss).sanitize is True


# -- the linter -------------------------------------------------------------------

def test_lint_rpr001_flags_a_branch_on_a_tensor():
    src = """
def train_step(state, batch):
    loss = state + batch
    if loss > 0:
        loss = loss * 2
    if state is None or isinstance(loss, int) or loss.shape[0] > 1:
        pass
    return loss
"""
    assert [(f.code, f.line) for f in lint_source(src, "fix.py")] == [("RPR001", 4)]


def test_lint_rpr002_flags_host_reads_and_honours_waivers():
    src = """
import numpy as np

class MyMixer:
    def __call__(self, theta, state):
        a = float(theta.sum())
        b = theta.item()
        c = theta.tolist()
        d = theta.cpu()
        e = np.asarray(theta)
        f = float(self.k)
        g = float(theta.sum())  # repro: noqa[RPR002] (a justified read)
        return helper(theta)

def helper(x):
    return int(x)

def not_traced(x):
    return float(x)
"""
    found = [(f.code, f.line) for f in lint_source(src, "fix.py")]
    assert found == [("RPR002", n) for n in (6, 7, 8, 9, 10, 16)]


def test_lint_rpr004_flags_import_time_allocation():
    src = """
import torch
A = torch.zeros(3)
B = torch.ones(2).cuda()
torch.cuda.synchronize()
OK = torch.cuda.is_available()
DT = torch.float32

def f():
    return torch.zeros(3)
"""
    assert [(f.code, f.line) for f in lint_source(src, "fix.py")] == [
        ("RPR004", 3), ("RPR004", 4), ("RPR004", 4), ("RPR004", 5)]


def test_lint_rpr005_ctor_and_schema(tmp_path):
    src = """
def init_state(p):
    return CommState(hat=())

def elsewhere(s):
    return CommState(hat=())
"""
    assert [(f.code, f.line) for f in lint_source(src, "mixers.py")] == [("RPR005", 6)]
    proto = tmp_path / "protocol.py"
    proto.write_text("class CommState:\n    hat: int\n    extra: int\n")
    io = tmp_path / "io.py"
    io.write_text("COMM_STATE_PAD = {'hat': (), 'stale': ()}\n")
    msgs = [f.message for f in lint_schema(str(proto), str(io))]
    assert len(msgs) == 2 and "'extra'" in msgs[0] and "'stale'" in msgs[1]
    io.write_text("OTHER = {}\n")
    assert "not found" in lint_schema(str(proto), str(io))[0].message


def test_port_lints_clean_and_the_cli_agrees():
    src = os.path.join(ROOT, "src", "repro_torch")
    findings = lint_paths([src])
    assert findings == [], "\n".join(map(str, findings))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", src], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stdout + out.stderr


def test_audit_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.analysis import audit_host_syncs

    with pytest.raises(RuntimeError, match="CUDA"):
        audit_host_syncs(lambda: None)
