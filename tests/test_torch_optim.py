"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``).

* Schedules: ``cosine_schedule`` and ``linear_warmup_cosine`` at every step
  of their horizon and past it, at rtol 1e-6 and atol 1e-7 of the base
  rate (both compute in float32; the two frameworks' ``cos`` may part by
  an ulp, which ``1 + cos`` near the end of the horizon turns into a large
  relative error of a tiny rate).
* Trajectories: every optimizer (SGD, momentum, nesterov momentum, Adam
  with and without weight decay and a schedule, ``chain_clip`` around
  each) takes 30 steps on the same seeded gradients, on the fmnist MLP's
  leaves stacked over 2 nodes (the updates are elementwise, and
  ``chain_clip``'s one norm spans the node axis either way) and on a
  random tree; the reference's
  update runs op by op (un-jitted: XLA's fusion would contract multiplies
  and adds into FMAs).  Parameters and optimizer state are held at rtol
  1e-6, atol 1e-6 of the leaf's largest |value| (entries that cross 0).
* ``chain_clip``'s norm is one norm over every leaf, node axis included.
* The trainer: 30 fmnist steps (K = 10, ER(0.3), DR-DSGD) with momentum,
  nesterov, clipped momentum on a cosine schedule and Adam (eps 1e-6,
  warmup, weight decay) through both trainers, at the trainer test's
  tolerances (rtol 1e-5, atol 1e-6): the reference jits its step.  None of
  them sets ``sgd_lr``, so the port's step is the unfused one.  Adam at
  eps 1e-8 is held on the trees above only, where both sides see the same
  gradients: it divides each entry by its own gradient's magnitude, so an
  entry whose gradient is near eps, where float32 summation noise is a
  large part of it (the fmnist MLP has 26 of 1e6 such entries at step 0),
  moves by O(lr) between any two summation orders of the backward pass
  (measured: 1.9e-2 of lr).  At eps 1e-6 the same noise moves it 100
  times less.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.core import DecentralizedTrainer as RefTrainer
from repro.core import RobustConfig as RefRobust
from repro.data import make_fmnist_like as ref_make_fmnist_like
from repro.data import pathological_noniid_partition as ref_partition
from repro.models import paper_nets as ref_nets
from repro_torch import convert
from repro_torch import optim as P
from repro_torch.core import DecentralizedTrainer, RobustConfig
from repro_torch.core.drdsgd import _fused_w
from repro_torch.models import paper_nets as nets

STEPS, K = 30, 10
TREE_NODES = 2
TREE_TOL = 1e-6

OPTIMIZERS = {
    "sgd-cosine": lambda M: M.sgd(M.cosine_schedule(0.1, STEPS)),
    "momentum": lambda M: M.momentum(0.05),
    "nesterov": lambda M: M.momentum(0.05, beta=0.8, nesterov=True),
    "adam": lambda M: M.adam(1e-3),
    "adam-wd-warmup": lambda M: M.adam(M.linear_warmup_cosine(1e-2, 5, STEPS),
                                       weight_decay=0.01),
    "clip-momentum-cosine": lambda M: M.chain_clip(M.momentum(M.cosine_schedule(0.1, STEPS)),
                                                   2.0),
    "clip-adam": lambda M: M.chain_clip(M.adam(1e-3, b1=0.8, b2=0.99, eps=1e-6), 0.5),
    "adam-eps1e-6-warmup": lambda M: M.adam(M.linear_warmup_cosine(1e-3, 10, STEPS), eps=1e-6,
                                            weight_decay=1e-4),
}


def _fmnist_shapes():
    tree = convert._flatten(jax.tree.map(np.asarray, ref_nets.mlp_init(jax.random.PRNGKey(0))))
    return {n: (TREE_NODES,) + v.shape for n, v in tree.items()}


TREES = {"fmnist": _fmnist_shapes,
         "random": lambda: {"a/w": (3, 17, 5), "a/b": (3, 5), "c": (3, 2, 4, 6), "d": (3,)}}


@pytest.mark.parametrize("steps,warmup", [(STEPS, 0), (STEPS, 5), (1, 1), (40, 39)])
def test_schedules_match_reference(steps, warmup):
    pairs = [(0.1, R.cosine_schedule(0.1, steps), P.cosine_schedule(0.1, steps)),
             (3e-4, R.cosine_schedule(3e-4, steps, 0.0), P.cosine_schedule(3e-4, steps, 0.0)),
             (0.1, R.linear_warmup_cosine(0.1, warmup, steps),
              P.linear_warmup_cosine(0.1, warmup, steps))]
    for base, ref, port in pairs:
        for s in range(steps + 10):
            got = port(s)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, float(ref(jnp.int32(s))), rtol=1e-6,
                                       atol=1e-7 * base, err_msg=s)


def _close_tree(got, want, what):
    for n in want:
        w, g = np.asarray(want[n]), got[n].numpy()
        np.testing.assert_allclose(g, w, rtol=TREE_TOL,
                                   atol=TREE_TOL * float(np.abs(w).max()), err_msg=f"{what} {n}")


def _state_trees(state):
    """An optimizer state's dicts of leaves, in field order (() for SGD)."""
    return [v for v in state] if isinstance(state, tuple) else []


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_reference(name, tree):
    shapes = TREES[tree]()
    rng = np.random.default_rng(1)
    p0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    ref_opt, opt = OPTIMIZERS[name](R), OPTIMIZERS[name](P)
    assert opt.sgd_lr is None or name.startswith("sgd")
    rp = {n: jnp.asarray(v) for n, v in p0.items()}
    pp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    rs, ps = ref_opt.init(rp), opt.init(pp)
    for t in range(STEPS):
        g = {n: (rng.standard_normal(s) * (1 + t % 3)).astype(np.float32)
             for n, s in shapes.items()}
        rp, rs = ref_opt.update({n: jnp.asarray(v) for n, v in g.items()}, rs, rp, jnp.int32(t))
        pp, ps = opt.update({n: torch.from_numpy(v) for n, v in g.items()}, ps, pp, t)
        _close_tree(pp, rp, f"params at step {t}")
        for i, (got, want) in enumerate(zip(_state_trees(ps), _state_trees(rs))):
            _close_tree(got, want, f"state field {i} at step {t}")
    assert type(ps).__name__ == type(rs).__name__


def test_chain_clip_norm_and_nesterov():
    rng = np.random.default_rng(2)
    shapes = TREES["random"]()
    g = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    want_g, want_norm = R.clip_by_global_norm({n: jnp.asarray(v) for n, v in g.items()}, 1.0)
    got_g, got_norm = P.clip_by_global_norm({n: torch.from_numpy(v) for n, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    _close_tree(got_g, want_g, "clipped")
    total = np.sqrt(sum(float(np.square(v.astype(np.float64)).sum()) for v in g.values()))
    np.testing.assert_allclose(float(got_norm), total, rtol=1e-6)  # one norm, every node
    # chain_clip hands the clipped gradients on: a zero-state momentum step is -lr * clipped
    p = {n: torch.zeros(s) for n, s in shapes.items()}
    opt = P.chain_clip(P.momentum(1.0), 1.0)
    new, state = opt.update({n: torch.from_numpy(v) for n, v in g.items()}, opt.init(p), p, 0)
    for n in g:
        torch.testing.assert_close(new[n], -got_g[n], rtol=0, atol=0)
        torch.testing.assert_close(state.velocity[n], got_g[n], rtol=0, atol=0)
    # nesterov's step looks ahead: beta v' + g, where plain momentum steps by v'
    nes = P.momentum(1.0, beta=0.5, nesterov=True)
    step1, s1 = nes.update({n: torch.from_numpy(v) for n, v in g.items()}, nes.init(p), p, 0)
    for n in g:
        torch.testing.assert_close(step1[n], -1.5 * torch.from_numpy(g[n]), rtol=1e-7,
                                   atol=1e-7)
        assert not s1.velocity[n].data_ptr() == step1[n].data_ptr()


def test_only_sgd_is_fused():
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.graphs import build_graph, metropolis_weights

    mixer = make_dense_mixer(np.asarray(metropolis_weights(build_graph("ring", 4))),
                             device="cpu")
    assert _fused_w(P.sgd(0.1), mixer, 1) is not None
    for name, make in OPTIMIZERS.items():
        if not name.startswith("sgd"):
            assert make(P).sgd_lr is None and _fused_w(make(P), mixer, 1) is None, name


TRAINER_OPTS = ("momentum", "nesterov", "clip-momentum-cosine", "adam-eps1e-6-warmup")


@pytest.fixture(scope="module")
def fmnist():
    from repro_torch.data import make_fmnist_like, pathological_noniid_partition

    fed_ref = ref_partition(ref_make_fmnist_like(n_train=2000, n_test=200), K, seed=0)
    fed = pathological_noniid_partition(make_fmnist_like(n_train=2000, n_test=200), K, seed=0)
    rng_ref, rng = np.random.default_rng(0), np.random.default_rng(0)
    batches = [fed.sample_batch(rng, 55) for _ in range(STEPS)]
    for (xa, ya), (xb, yb) in zip((fed_ref.sample_batch(rng_ref, 55) for _ in range(STEPS)),
                                  batches):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    return batches, jax.tree.map(np.asarray, ref_nets.mlp_init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", TRAINER_OPTS)
def test_trainer_trajectory_matches_reference(fmnist, name):
    batches, params = fmnist
    kw = dict(num_nodes=K, graph="erdos_renyi", graph_kwargs={"p": 0.3, "seed": 0})
    ref_t = RefTrainer(ref_nets.make_classifier_loss(ref_nets.mlp_apply), ref_nets.mlp_apply,
                       robust=RefRobust(mu=6.0), optimizer=OPTIMIZERS[name](R), **kw)
    port_t = DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                  robust=RobustConfig(mu=6.0), optimizer=OPTIMIZERS[name](P),
                                  device="cpu", **kw)
    ref_state = ref_t.init(params)
    state = port_t.init(convert.params_from_numpy(params, device="cpu"))
    for step, (x, y) in enumerate(batches):
        ref_state, ref_m = ref_t.step(ref_state, (jnp.asarray(x), jnp.asarray(y)))
        state, m = port_t.step(state, (x, y))
        for key in ("loss_mean", "loss_worst", "robust_objective"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} at step {step}")
        want = convert._flatten(jax.tree.map(np.asarray, ref_state.params))
        for n, t in state.params.items():
            np.testing.assert_allclose(t.numpy(), want[n], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n} at step {step}")
