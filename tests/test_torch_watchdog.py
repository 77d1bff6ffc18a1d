"""The recompile watchdog (``repro_torch.obs.watchdog``) against the
reference's semantics, on the CPU.

The reference counts the programs ``jax.jit`` compiled; the port counts
the programs the trainer captured (one per batch signature; the CPU runs
the capturable form and counts it the same way).  Held side by side on a
callable that gains a second program when its input's shape changes (a
jitted function in the reference, ``DecentralizedTrainer._run`` in the
port): the same snapshots, the same budget (``allowed``, ``check(extra_
allowed=)``), ``RecompileError`` on a violation, ``on_violation="warn"``
warning and recording instead, ``ValueError`` for a callable without
``_cache_size`` (the reference's plain function, the port's ``jit=False``
run), and ``expect_compiles`` failing a region that captures more than
its budget.  Runs of two segment lengths are one program.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import watchdog as ref_wd
from repro_torch.core import DecentralizedTrainer
from repro_torch.data import make_fmnist_like, pathological_noniid_partition
from repro_torch.models import paper_nets as nets
from repro_torch.obs import watchdog as wd

K = 4


def _batches(bsz: int, steps: int):
    fed = pathological_noniid_partition(make_fmnist_like(), K, seed=0)
    rng = np.random.default_rng(bsz)
    draws = [fed.sample_batch(rng, bsz) for _ in range(steps)]
    return tuple(np.stack(parts) for parts in zip(*draws))


def _trainer(jit: bool = True):
    return DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), num_nodes=K,
                                graph="ring", lr=0.1, device="cpu", jit=jit)


class _Port:
    """The port's callable: a trainer's ``_run``; ``call(n)`` runs a segment
    of batch size ``n``."""

    def __init__(self):
        self.trainer = _trainer()
        self.state = self.trainer.init(nets.mlp_init(torch.Generator().manual_seed(0)))
        self.fn = self.trainer._run

    def call(self, n: int, steps: int = 2) -> None:
        self.state, _ = self.trainer.run(self.state, _batches(n, steps))


class _Ref:
    """The reference's callable: a jitted function."""

    def __init__(self):
        self.fn = jax.jit(lambda x: x * 2.0)

    def call(self, n: int, steps: int = 2) -> None:
        self.fn(jnp.ones((n,))).block_until_ready()


@pytest.mark.parametrize("impl", ["ref", "port"])
def test_budget_and_check(impl):
    mod, side = (ref_wd, _Ref()) if impl == "ref" else (wd, _Port())
    watch = mod.RecompileWatchdog(label="t").track("run", side.fn, allowed=1)
    assert watch.snapshot() == {"run": 0}
    side.call(8)
    side.call(8, steps=3)  # another segment length: the same program
    assert watch.check() == {"run": 1}
    side.call(5)           # a new input shape: a second program
    assert watch.programs("run") == 2
    assert watch.check(extra_allowed=1) == {"run": 2}
    with pytest.raises(mod.RecompileError, match=r"\[t\].*run .*2 programs .*budget 1"):
        watch.check()
    assert len(watch.violations) == 1


@pytest.mark.parametrize("impl", ["ref", "port"])
def test_warn_records_instead_of_raising(impl):
    mod, side = (ref_wd, _Ref()) if impl == "ref" else (wd, _Port())
    watch = mod.RecompileWatchdog(on_violation="warn").track("run", side.fn, allowed=1)
    side.call(8)
    side.call(6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert watch.check() == {"run": 2}
    assert len(caught) == 1 and issubclass(caught[0].category, RuntimeWarning)
    assert watch.violations and "2 programs" in watch.violations[0]
    with pytest.raises(ValueError, match="on_violation"):
        mod.RecompileWatchdog(on_violation="ignore")


def test_tracking_needs_a_cache_size():
    with pytest.raises(ValueError, match="_cache_size"):
        ref_wd.jit_cache_size(lambda x: x)
    with pytest.raises(ValueError, match="_cache_size"):
        wd.jit_cache_size(_trainer(jit=False)._run)
    port = _Port()
    assert wd.jit_cache_size(port.fn) == 0
    port.call(8)
    assert wd.jit_cache_size(port.fn) == 1


def test_expect_compiles_counts_captures():
    port = _Port()
    with wd.expect_compiles(at_most=1, label="one") as region:
        port.call(8)
        port.call(8, steps=3)
    assert region.count == 1
    with pytest.raises(wd.RecompileError, match=r"\[two\].*2 captures .*budget 1"):
        with wd.expect_compiles(at_most=1, label="two"):
            port.call(5)
            _Port().call(8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with wd.expect_compiles(at_most=0, on_violation="warn") as region:
            port.call(3)
    assert region.count == 1 and len(caught) == 1
    with wd.CompileCounter() as counter:
        port.call(3)
    assert counter.count == 0 and not wd._LISTENERS


def test_public_names():
    import repro.obs as ref_obs
    import repro_torch.obs as obs

    names = {"RecompileWatchdog", "RecompileError", "CompileCounter", "expect_compiles",
             "jit_cache_size"}
    assert names <= set(ref_obs.__all__) and names <= set(obs.__all__)
