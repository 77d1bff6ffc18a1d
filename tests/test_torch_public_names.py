"""The reference's public names that the port carries too (A.17), each held
against its reference counterpart on shared inputs.

* ``repro_torch.core`` re-exports the comm types the reference's
  ``repro.core`` re-exports, and carries ``add_compression_cli_args`` and
  ``compression_from_args``: the same flags and defaults, the same configs
  from the same argument lists, the same ``SystemExit`` on a schedule with
  no codec; ``TrainerSpec.add_cli_args`` installs the same codec flags.
* ``repro_torch.comm.ef_residual``: θ − θ̂ in float32 leaf by leaf, and the
  reference's ``ValueError`` for a memoryless state.
* ``repro_torch.configs.all_archs``: every config, field for field.
* ``repro_torch.utils.tree``: ``tree_size``, ``tree_global_norm``,
  ``tree_stack_nodes``, ``tree_unstack_nodes``, ``tree_node_mean`` and
  ``tree_cast`` on numpy inputs given to both (float32 at rtol 1e-6; the
  norm sums in another order).
* ``repro_torch.analysis.lint.main``: the reference's exit codes and
  summary lines on a clean file and a file that does not parse.
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.comm as ref_comm
import repro.core as ref_core
from repro.analysis import lint as ref_lint
from repro.comm.protocol import trivial_comm_state as ref_trivial_state
from repro.configs import base as ref_configs
from repro.utils import tree as ref_tree
import repro_torch.comm as comm
import repro_torch.core as core
from repro_torch.analysis import lint
from repro_torch.comm.protocol import trivial_comm_state
from repro_torch.configs import all_archs
from repro_torch.core.spec import TrainerSpec
from repro_torch.utils import tree

CLI_CASES = [
    [],
    ["--compress", "int8"],
    ["--compress", "int4", "--no-error-feedback", "--seed", "3"],
    ["--compress", "topk", "--compress-ratio", "0.05", "--compress-schedule", "linear",
     "--schedule-rounds", "40"],
    ["--compress", "int8", "--compress-schedule", "adaptive", "--schedule-threshold", "0.25",
     "--schedule-warmup", "4"],
    ["--compress", "bf16"],
]


def _norm(v):
    """A field for comparison: dtypes by name (``jnp.float32`` and
    ``torch.float32`` alike)."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type):
        return np.dtype(v).name
    return v


def _common(port_obj, ref_obj) -> tuple[dict, dict]:
    """Both dataclasses' fields that the port has, normalised."""
    got, want = dataclasses.asdict(port_obj), dataclasses.asdict(ref_obj)
    keys = [k for k in want if k in got]
    return ({k: _norm(got[k]) for k in keys}, {k: _norm(want[k]) for k in keys})


def _parser(add, seed=True):
    ap = argparse.ArgumentParser()
    if seed:
        ap.add_argument("--seed", type=int, default=0)
    add(ap)
    return ap


def test_core_reexports_the_comm_types():
    for name in ("CommMetrics", "CommState", "CompressionConfig", "Mixer", "ScheduleConfig"):
        assert name in ref_core.__all__ and name in core.__all__
        assert getattr(core, name) is getattr(comm, name)
    for name in ("add_compression_cli_args", "compression_from_args"):
        assert name in ref_core.__all__ and name in core.__all__


@pytest.mark.parametrize("argv", CLI_CASES, ids=lambda a: " ".join(a) or "defaults")
def test_compression_flags_and_configs_equal_the_reference(argv):
    want = _parser(ref_core.add_compression_cli_args).parse_args(argv)
    got = _parser(core.add_compression_cli_args).parse_args(argv)
    assert vars(got) == vars(want)
    ref_cfg, cfg = ref_core.compression_from_args(want), core.compression_from_args(got)
    if ref_cfg is None:
        assert cfg is None
        return
    got_fields, ref_fields = _common(cfg, ref_cfg)
    assert set(ref_fields) >= {"kind", "ratio", "error_feedback", "seed", "schedule"}
    assert got_fields == ref_fields


def test_trainer_flags_take_the_codec_flags_from_one_place():
    """The train CLI's ``--compress`` flags are ``add_compression_cli_args``'s:
    the same names, choices and defaults."""
    trainer = _parser(TrainerSpec.add_cli_args, seed=False)
    codec = _parser(core.add_compression_cli_args, seed=False)
    by_dest = {a.dest: a for a in trainer._actions}
    for a in codec._actions:
        if a.dest == "help":
            continue
        b = by_dest[a.dest]
        assert (b.option_strings, b.default, b.choices, b.type, b.help) == \
            (a.option_strings, a.default, a.choices, a.type, a.help)


def test_schedule_without_a_codec_exits_in_both():
    argv = ["--compress-schedule", "linear"]
    for add, build in ((ref_core.add_compression_cli_args, ref_core.compression_from_args),
                       (core.add_compression_cli_args, core.compression_from_args)):
        with pytest.raises(SystemExit, match="needs a codec"):
            build(_parser(add).parse_args(argv))


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": rng.standard_normal((3, 7)).astype(np.float32)}


def test_ef_residual_equals_the_reference():
    theta, hat = _leaves(0), _leaves(1)
    theta["b"] = theta["b"].astype(jnp.bfloat16)
    want = ref_comm.ef_residual(
        {k: jnp.asarray(v) for k, v in theta.items()},
        ref_trivial_state()._replace(hat={k: jnp.asarray(v) for k, v in hat.items()}))
    got = comm.ef_residual(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16 if k == "b"
                                                             else torch.float32)
         for k, v in theta.items()},
        trivial_comm_state()._replace(hat={k: torch.from_numpy(v) for k, v in hat.items()}))
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="memoryless"):
        ref_comm.ef_residual(theta, ref_trivial_state())
    with pytest.raises(ValueError, match="memoryless"):
        comm.ef_residual({}, trivial_comm_state())


@pytest.mark.parametrize("smoke", [False, True])
def test_all_archs_equal_the_reference(smoke):
    want, got = ref_configs.all_archs(smoke), all_archs(smoke)
    assert list(got) == list(want)
    for name, cfg in want.items():
        got_fields, ref_fields = _common(got[name], cfg)
        assert len(ref_fields) == len(dataclasses.fields(cfg)), name
        assert got_fields == ref_fields, name


def test_tree_helpers_equal_the_reference():
    nodes = [_leaves(s) for s in range(3)]
    ref_nodes = [{k: jnp.asarray(v) for k, v in n.items()} for n in nodes]
    port_nodes = [{k: torch.from_numpy(v) for k, v in n.items()} for n in nodes]
    ref_stack, stack = ref_tree.tree_stack_nodes(ref_nodes), tree.tree_stack_nodes(port_nodes)
    for k in ref_stack:
        np.testing.assert_array_equal(stack[k].numpy(), np.asarray(ref_stack[k]))
    assert tree.tree_size(stack) == ref_tree.tree_size(ref_stack)
    np.testing.assert_allclose(float(tree.tree_global_norm(stack)),
                               float(ref_tree.tree_global_norm(ref_stack)), rtol=1e-6)
    for got, want in zip(tree.tree_unstack_nodes(stack, 3),
                         ref_tree.tree_unstack_nodes(ref_stack, 3), strict=True):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    mean, ref_mean = tree.tree_node_mean(stack), ref_tree.tree_node_mean(ref_stack)
    for k in ref_mean:
        np.testing.assert_allclose(mean[k].numpy(), np.asarray(ref_mean[k]), rtol=1e-6)
    mixed = {**stack, "i": torch.arange(6, dtype=torch.int32)}
    ref_mixed = {**ref_stack, "i": jnp.arange(6, dtype=jnp.int32)}
    cast, ref_cast = tree.tree_cast(mixed, torch.bfloat16), ref_tree.tree_cast(ref_mixed,
                                                                                 jnp.bfloat16)
    assert cast["i"].dtype == torch.int32 and str(ref_cast["i"].dtype) == "int32"
    for k in ("a", "b"):
        assert cast[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(cast[k].float().numpy(),
                                      np.asarray(ref_cast[k]).astype(np.float32))


def test_lint_main_gives_the_reference_verdicts(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    for path, rc in ((clean, 0), (broken, 1)):
        assert ref_lint.main([str(path)]) == rc
        want = capsys.readouterr().out.splitlines()
        assert lint.main([str(path)]) == rc
        got = capsys.readouterr().out.splitlines()
        assert len(got) == len(want) and got[-1].replace("repro_torch", "repro") == want[-1]
        if rc:
            assert "RPR000" in got[0] and "RPR000" in want[0]
