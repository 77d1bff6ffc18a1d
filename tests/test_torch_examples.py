"""The port's four examples against the reference's, and the trainer's epoch
hook against the reference's.

Each ``examples/torch_*.py`` runs on the CPU at cut steps beside its
reference example (imported from ``examples/``; module constants such as
``T`` and ``EVAL_EVERY`` are patched on the imported modules, never edited
in the files) from the same initial parameters: the reference's init,
carried across with ``repro_torch.convert``.  The data come from each
package's own modules, which give equal batches (tests/test_torch_data.py).
Each package's ``TrainerSpec`` is patched on the example's module with a
subclass whose trainers record every ``run``'s metrics, so the per-step
losses (mean and worst node) are compared: the first ``EARLY`` steps at the
trainer trajectory tests' tolerance (rtol 1e-5, atol 1e-6,
tests/test_torch_trainer.py), every step at rtol ``DRIFT``.  The examples'
robust scale at mu = 3 (the trainer tests take mu = 6), with lr 0.18 and
0.30, amplifies the two frameworks' float32 rounding faster: measured on
the CPU, the worst node's loss leaves 1e-5 by step 9 of the quickstart, and
over the 20 cut steps the losses drift to at most 6.9e-5 of the
reference's (the fmnist example's DSGD run; up to 6.8e-4 over 40 steps:
the drift grows with the run, and the cut holds it at a fixed horizon).  The reference's scan and its per-step jit agree bit for
bit on these runs, so the drift is the frameworks', not the scan's.  The
accuracies the examples print are held at 0.01; the serving example's
tokens (greedy) and engine lines as printed, for rwkv6 (its default),
jamba, deepseek-moe and the two prefix frontends (whose engine demo is
skipped, as the reference's).

The epoch hook: ``run(..., epoch_steps, on_epoch)`` calls the hook with the
reference's epoch indices and per-epoch metric shapes, a ragged last epoch
included, and the port's split run equals its one-call run bit for bit (an
eager loop either way; the reference's own split-vs-scan test differs by
one ulp under XLA's fusion, ROADMAP §C).
"""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import TrainerSpec as RefSpec
from repro.models import TransformerLM as RefLM
from repro.models import mlp_apply as ref_mlp_apply
from repro.models import mlp_init as ref_mlp_init
from repro.models.paper_nets import make_classifier_loss as ref_classifier_loss
from repro_torch import convert
from repro_torch.core import TrainerSpec
from repro_torch.models import mlp_apply, mlp_init
from repro_torch.models.paper_nets import make_classifier_loss

ROOT = Path(__file__).resolve().parents[1]
TRAJ = dict(rtol=1e-5, atol=1e-6)   # the trainer trajectory tests' tolerance
EARLY = 5                           # steps held at TRAJ (module doc)
DRIFT = 5e-4                        # every step, relative (module doc)
ACC = 0.01


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _spy(monkeypatch, module, log: list) -> None:
    """Patch ``module.TrainerSpec`` with a subclass whose trainers append
    every ``run``'s metrics (numpy) to ``log``."""
    base = module.TrainerSpec

    class Spy(base):
        def build(self, *args, **kw):
            trainer = base.build(self, *args, **kw)
            run = trainer.run

            def recorded(state, batches, **run_kw):
                state, ms = run(state, batches, **run_kw)
                log.append({k: np.asarray(v) for k, v in ms.items()})
                return state, ms

            trainer.run = recorded
            return trainer

    monkeypatch.setattr(module, "TrainerSpec", Spy)


def _runs(ref_log, port_log, keys=("loss_mean", "loss_worst")):
    """Each metric of ``keys`` over the runs of one training, concatenated:
    the first EARLY steps at TRAJ, all at DRIFT."""
    assert [len(r["loss_mean"]) for r in port_log] == [len(r["loss_mean"]) for r in ref_log]
    for key in keys:
        got = np.concatenate([r[key] for r in port_log])
        want = np.concatenate([r[key] for r in ref_log])
        np.testing.assert_allclose(got[:EARLY], want[:EARLY], err_msg=key, **TRAJ)
        np.testing.assert_allclose(got, want, rtol=DRIFT, err_msg=key)


def _ref_main(module, argv, monkeypatch):
    """The reference example's ``main()`` with ``argv``; its stdout."""
    monkeypatch.setattr("sys.argv", ["example"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def _port_main(module, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(argv + ["--device", "cpu"], **kw)
    return result, out.getvalue()


def _accs(text: str, name: str) -> list[float]:
    return [float(part.split("=")[1]) for line in text.splitlines() if line.startswith("step")
            for part in line.split() if part.startswith(name + "=")]


def test_quickstart_matches_reference(monkeypatch):
    ref_mod, port_mod = _load("quickstart.py"), _load("torch_quickstart.py")
    ref_log, port_log = [], []
    _spy(monkeypatch, ref_mod, ref_log)
    _spy(monkeypatch, port_mod, port_log)
    argv = ["--steps", "20", "--log-every", "15"]  # a ragged last epoch of 5
    want = _ref_main(ref_mod, argv, monkeypatch)
    params = convert.params_from_numpy(_np_tree(ref_mlp_init(jax.random.PRNGKey(0))),
                                       device="cpu")
    history, got = _port_main(port_mod, argv, params=params)
    _runs(ref_log, port_log)
    assert [h["step"] for h in history] == [14, 19]
    assert got.splitlines()[0] == want.splitlines()[0]  # algo, K, rho
    for name in ("acc_avg", "acc_worst", "node_std"):
        np.testing.assert_allclose(_accs(got, name), _accs(want, name), atol=ACC, err_msg=name)


def test_decentralized_fmnist_matches_reference(monkeypatch):
    ref_mod, port_mod = _load("decentralized_fmnist.py"), _load("torch_decentralized_fmnist.py")
    for mod in (ref_mod, port_mod):  # cut steps: LR and BATCH keep the T = 600 values
        monkeypatch.setattr(mod, "T", 20)
        monkeypatch.setattr(mod, "EVAL_EVERY", 10)
    ref_log, port_log = [], []
    _spy(monkeypatch, ref_mod, ref_log)
    _spy(monkeypatch, port_mod, port_log)
    params = convert.params_from_numpy(_np_tree(ref_mlp_init(jax.random.PRNGKey(0))),
                                       device="cpu")
    for robust in (True, False):
        want = ref_mod.train(robust=robust)
        got = port_mod.train(robust=robust, params=params, device="cpu")
        assert [h["step"] for h in got] == [h["step"] for h in want] == [9, 19]
        for g, w in zip(got, want):
            for key in ("acc_avg", "acc_worst_dist", "acc_node_std"):
                assert abs(g[key] - w[key]) <= ACC, (robust, g["step"], key, g[key], w[key])
        _runs(ref_log, port_log)
        ref_log.clear()
        port_log.clear()


def test_train_lm_drdsgd_matches_reference(monkeypatch):
    ref_mod, port_mod = _load("train_lm_drdsgd.py"), _load("torch_train_lm_drdsgd.py")
    ref_log, port_log = [], []
    _spy(monkeypatch, ref_mod, ref_log)
    _spy(monkeypatch, port_mod, port_log)
    argv = ["--steps", "3", "--nodes", "2", "--seq-len", "16", "--batch-per-node", "1"]
    want = _ref_main(ref_mod, argv, monkeypatch)
    cfg = dataclasses.replace(ref_get_arch("qwen2_0_5b", smoke=True), n_layers=4, d_model=256,
                              n_heads=8, n_kv_heads=2, d_ff=1024, vocab=2048)
    params = convert.params_from_numpy(_np_tree(RefLM(cfg).init(jax.random.PRNGKey(0))),
                                       device="cpu")
    assert port_mod.model_for(False).cfg.d_model // port_mod.model_for(False).cfg.n_heads == 32
    history, got = _port_main(port_mod, argv, params=params)
    _runs(ref_log, port_log, keys=("loss_mean", "loss_worst", "robust_objective",
                                   "lambda_max"))
    assert [h["step"] for h in history] == [2]
    assert got.splitlines()[0] == want.splitlines()[0]  # model, params, nodes, rho, mu


def _engine_lines(text: str) -> list[str]:
    return [line for line in text.splitlines() if line.startswith(("  rid", "sample tokens"))]


def test_serve_decode_matches_reference(monkeypatch):
    ref_mod, port_mod = _load("serve_decode.py"), _load("torch_serve_decode.py")
    argv = ["--temperature", "0", "--gen-len", "8"]
    want = _ref_main(ref_mod, argv, monkeypatch)
    ref_params = RefLM(ref_get_arch("rwkv6_7b", smoke=True)).init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(_np_tree(ref_params), device="cpu")
    result, got = _port_main(port_mod, argv, params=params)
    assert got.splitlines()[0] == want.splitlines()[0]  # family, params
    assert _engine_lines(got) == _engine_lines(want)
    assert result["report"]["completed"] == 5 and result["tokens"].shape == (4, 8)
    assert "decode steps=" in got and "programs" not in got


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "pixtral_12b", "musicgen_medium",
                                  "deepseek_moe_16b"])
def test_serve_decode_family_matches_reference(monkeypatch, arch):
    """The other families through the serving example at temperature 0:
    jamba (mamba + attention, MoE) and deepseek-moe through the static batch
    and the engine, the prefix frontends through the decode path, their
    engine demo skipped; the printed tokens are the reference's."""
    ref_mod, port_mod = _load("serve_decode.py"), _load("torch_serve_decode.py")
    argv = ["--arch", arch, "--temperature", "0", "--gen-len", "8"]
    want = _ref_main(ref_mod, argv, monkeypatch)
    ref_params = RefLM(ref_get_arch(arch, smoke=True)).init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(_np_tree(ref_params), device="cpu")
    result, got = _port_main(port_mod, argv, params=params)
    assert got.splitlines()[0] == want.splitlines()[0]  # family, params
    assert _engine_lines(got) == _engine_lines(want)
    assert result["tokens"].shape == (4, 8)
    skipped = "engine demo skipped (prefix frontend)"
    if ref_get_arch(arch, smoke=True).frontend == "token":
        assert result["report"]["completed"] == 5 and skipped not in got
        assert len(_engine_lines(got)) == 6  # the sample line and five requests
    else:
        assert result["report"] is None
        assert got.splitlines()[-1] == want.splitlines()[-1] == skipped


# -- the epoch hook ------------------------------------------------------------

HOOK_K, HOOK_STEPS, HOOK_EPOCH = 4, 7, 3   # epochs of 3, 3 and a ragged 1


def _hook_batches():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((HOOK_STEPS, HOOK_K, 8, 784)).astype(np.float32)
    y = rng.integers(0, 10, (HOOK_STEPS, HOOK_K, 8)).astype(np.int32)
    return x, y


def _hook_trainers():
    kw = dict(num_nodes=HOOK_K, graph="ring", mu=3.0, lr=0.1, grad_clip=2.0)
    ref = RefSpec(**kw).build(ref_classifier_loss(ref_mlp_apply), ref_mlp_apply)
    port = TrainerSpec(**kw, device="cpu").build(make_classifier_loss(mlp_apply), mlp_apply)
    return ref, port


@pytest.mark.parametrize("epoch_steps", [HOOK_EPOCH, None, HOOK_STEPS + 1])
def test_run_epoch_hook_matches_reference(epoch_steps):
    """The hook's calls (epoch index, each metric's shape), the metrics at
    the trajectory tolerance, and the concatenated (steps,) metrics; without
    a split one call with index 0 after the last step."""
    ref_t, port_t = _hook_trainers()
    init = _np_tree(ref_mlp_init(jax.random.PRNGKey(1)))
    x, y = _hook_batches()
    calls = {"ref": [], "port": []}

    def hook(side):
        def on_epoch(e, state, ms):
            calls[side].append((e, {k: tuple(np.shape(v)) for k, v in ms.items()},
                                np.asarray(ms["loss_mean"])))
        return on_epoch

    _, ref_ms = ref_t.run(ref_t.init(init), (x, y), epoch_steps=epoch_steps,
                          on_epoch=hook("ref"))
    _, port_ms = port_t.run(port_t.init(convert.params_from_numpy(init, device="cpu")),
                            (x, y), epoch_steps=epoch_steps, on_epoch=hook("port"))
    assert [(e, s) for e, s, _ in calls["port"]] == [(e, s) for e, s, _ in calls["ref"]]
    want_lens = [3, 3, 1] if epoch_steps == HOOK_EPOCH else [HOOK_STEPS]
    assert [s["loss_mean"] for _, s, _ in calls["port"]] == [(n,) for n in want_lens]
    for (_, _, got), (_, _, want) in zip(calls["port"], calls["ref"]):
        np.testing.assert_allclose(got, want, **TRAJ)
    assert set(port_ms) == set(ref_ms)
    for key in ref_ms:
        assert port_ms[key].shape == (HOOK_STEPS,)
        np.testing.assert_allclose(np.asarray(port_ms[key]), np.asarray(ref_ms[key]),
                                   err_msg=key, **TRAJ)


def test_split_run_equals_one_call_bitwise():
    _, port_t = _hook_trainers()
    params = mlp_init(torch.Generator().manual_seed(3))
    x, y = _hook_batches()
    whole_state, whole = port_t.run(port_t.init(params), (x, y))
    seen = []
    split_state, split = port_t.run(port_t.init(params), (x, y), epoch_steps=HOOK_EPOCH,
                                    on_epoch=lambda e, st, ms: seen.append(e))
    assert seen == [0, 1, 2]
    for key in whole:
        assert torch.equal(split[key], whole[key]), key
    for name in whole_state.params:
        assert torch.equal(split_state.params[name], whole_state.params[name]), name
