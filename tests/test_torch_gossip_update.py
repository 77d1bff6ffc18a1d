"""The fused gossip update (B.1) in the port against the reference, on the CPU.

- The per-node plain version against the reference's Pallas kernel in
  interpret mode (``gossip_update_flat(..., interpret=True)``) on the cases
  of ``tests/test_kernel_gossip_update.py``: d in {7, 64, 128, 1000,
  131072} with n = 0..5 neighbours at rtol 1e-5, atol 1e-6; bfloat16 at
  2e-2 (the reference's tolerance); a seeded sweep of d, n, η and s at rtol
  1e-5, atol 1e-6 (the reference holds its own sweep at 2e-4).
- The node-stacked plain version against the reference's per-node kernel,
  row by row, on a Metropolis ring: node i's output is row i of
  W·(θ − η·s⊙g) (paper Eq. 9 / Eq. 20), at rtol 1e-5, atol 1e-5.
- ``gossip_update_tree`` keeps the tree's structure; the per-node launches
  of a node's leaves (B.1 over every leaf at once, split at 16 leaves and at
  the pool of 384 neighbour rows) equal a direct count, and each launch's
  table points at every leaf and every neighbour's row in place.
- The fused train step: 20 fmnist dense-none steps through the fused step
  (plain SGD + the static dense mixer, one ``gossip_update_stacked_grouped``
  call per step over every leaf) equal the unfused step (the optimizer and the mixer called
  directly) bit for bit, params and every metric, and the fused step runs
  where, and only where, it applies (not at K = 65, above the stacked
  kernel's 64 nodes).
- The grouped stacked form (every leaf of a step in one call, one launch on
  the card) equals the one-leaf plain version leaf by leaf, bit for bit,
  in float32 and bfloat16, K from 1 to 64, over the leaf cap too; its leaf
  tables equal a direct count of CTAs; the fused step groups its leaves by
  dtype in their order.

Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_update.ops import gossip_update_flat as ref_flat
from repro_torch.comm import CompressionConfig
from repro_torch.core import DecentralizedTrainer, RobustConfig
from repro_torch.core.consensus import make_gossip_mixer
from repro_torch.core.drdsgd import _fused_w
from repro_torch.data import make_fmnist_like, pathological_noniid_partition
from repro_torch.graphs import (
    build_graph,
    metropolis_weights,
    permutation_decomposition,
    ring_graph,
)
from repro_torch.kernels.gossip_update import kernel as gk
from repro_torch.kernels.gossip_update import ops
from repro_torch.kernels.gossip_update.ref import gossip_update_ref
from repro_torch.models import paper_nets as nets
from repro_torch.optim import Optimizer, sgd

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, d, n):
    rng = np.random.default_rng(seed)
    theta, grad = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    nbrs = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(n + 1)
    w = (np.exp(w) / np.exp(w).sum()).astype(np.float32)
    return theta, grad, nbrs, w


def _both(theta, grad, nbrs, w, s, eta, torch_dtype=torch.float32, jax_dtype=jnp.float32):
    """(port plain version, reference Pallas kernel in interpret mode), float32 numpy."""
    th, g, nb = (torch.from_numpy(a).to(torch_dtype) for a in (theta, grad, nbrs))
    got = ops.gossip_update_flat(th, g, nb, torch.from_numpy(w),
                                 torch.tensor(s, dtype=torch.float32), eta=eta)
    want = ref_flat(*(jnp.asarray(a, jax_dtype) for a in (theta, grad, nbrs)), jnp.asarray(w),
                    jnp.float32(s), eta=eta, interpret=True)
    assert got.dtype == torch_dtype
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("n", range(6))
@pytest.mark.parametrize("d", [7, 64, 128, 1000, 131072])
def test_per_node_matches_reference_kernel(d, n):
    got, want = _both(*_case(d + n, d, n), 1.7, 0.05)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [0, 2])
def test_per_node_bf16(n):
    got, want = _both(*_case(9, 256, n), 0.5, 0.1, torch.bfloat16, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("seed", range(12))
def test_per_node_seeded_sweep(seed):
    rng = np.random.default_rng(1000 + seed)
    d, n = int(rng.integers(1, 4097)), int(rng.integers(0, 6))
    eta, s = float(rng.uniform(1e-4, 1.0)), float(rng.uniform(0.1, 50.0))
    got, want = _both(*_case(seed, d, n), s, eta)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d", [40, 3000])
def test_stacked_matches_reference_kernel_row_by_row(d):
    k, eta = 6, 0.05
    g = ring_graph(k)
    w = metropolis_weights(g)
    rng = np.random.default_rng(d)
    thetas, grads = (rng.standard_normal((k, d)).astype(np.float32) for _ in range(2))
    scales = rng.uniform(0.5, 2.0, size=k).astype(np.float32)
    got = ops.gossip_update_stacked(torch.from_numpy(thetas), torch.from_numpy(grads),
                                    torch.from_numpy(w.astype(np.float32)),
                                    torch.from_numpy(scales), eta=eta).numpy()
    updated = thetas - eta * scales[:, None] * grads  # what each neighbour sends
    for i in range(k):
        nbr_ids = g.neighbors(i)
        weights = np.concatenate([[w[i, i]], w[i, nbr_ids]]).astype(np.float32)
        want = ref_flat(jnp.asarray(thetas[i]), jnp.asarray(grads[i]),
                        jnp.asarray(updated[nbr_ids]), jnp.asarray(weights),
                        jnp.float32(scales[i]), eta=eta, interpret=True)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-5, atol=1e-5)


def test_stacked_keeps_leaf_shapes_and_dtype():
    rng = np.random.default_rng(0)
    theta = torch.from_numpy(rng.standard_normal((4, 3, 5)).astype(np.float32))
    out = ops.gossip_update_stacked(theta, torch.ones_like(theta), torch.eye(4),
                                    torch.ones(4), eta=0.5)
    assert out.shape == theta.shape and out.dtype == theta.dtype
    assert torch.equal(out, theta - 0.5)


def test_tree_structure_preserved():
    tree = {"w": torch.ones((3, 4)), "b": {"x": torch.arange(5.0)}}
    grads = {"w": torch.ones((3, 4)), "b": {"x": torch.ones(5)}}
    nbrs = [{"w": tree["w"] * 2, "b": {"x": tree["b"]["x"] * 2}}]
    out = ops.gossip_update_tree(tree, grads, nbrs, torch.tensor([0.6, 0.4]), 1.0, eta=0.1)
    assert set(out) == {"w", "b"} and set(out["b"]) == {"x"}
    assert out["w"].shape == (3, 4) and out["b"]["x"].shape == (5,)
    want = gossip_update_ref(tree["b"]["x"], grads["b"]["x"], nbrs[0]["b"]["x"][None],
                             torch.tensor([0.6, 0.4]), torch.tensor(1.0), eta=0.1)
    assert torch.equal(out["b"]["x"], want)


def test_dispatchers_count_plain_calls_and_kernels_refuse_the_cpu():
    x = torch.ones(8)
    before = (ops.gossip_update_flat.plain_calls, ops.gossip_update_stacked.plain_calls)
    ops.gossip_update_flat(x, x, x[None], torch.tensor([0.5, 0.5]), torch.tensor(1.0), eta=0.1)
    ops.gossip_update_stacked(x[None], x[None], torch.ones(1, 1), torch.ones(1), eta=0.1)
    assert (ops.gossip_update_flat.plain_calls, ops.gossip_update_stacked.plain_calls) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gossip_update(x, x, x[None], torch.tensor([0.5, 0.5]), torch.tensor(1.0), eta=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gossip_update_stacked(x[None], x[None], torch.ones(1, 1), torch.ones(1), eta=0.1)


# -- the fused train step ---------------------------------------------------------

K, B, STEPS = 10, 55, 20
LR = (K / 300) ** 0.5
GRAPH_KW = {"p": 0.3, "seed": 0}


@pytest.fixture(scope="module")
def fmnist():
    fed = pathological_noniid_partition(make_fmnist_like(n_train=2000, n_test=200), K, seed=0)
    rng = np.random.default_rng(0)
    batches = [fed.sample_batch(rng, B) for _ in range(STEPS)]
    return batches, nets.mlp_init(torch.Generator().manual_seed(0))


def _trainer(optimizer, robust, grad_clip, **kw):
    return DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                num_nodes=K, graph="erdos_renyi", graph_kwargs=GRAPH_KW,
                                robust=RobustConfig(mu=6.0, enabled=robust),
                                optimizer=optimizer, grad_clip=grad_clip, device="cpu", **kw)


@pytest.mark.parametrize("robust,grad_clip", [(True, None), (False, 0.5)],
                         ids=["dr-dsgd", "dsgd-clip"])
def test_fused_step_equals_unfused_step(fmnist, robust, grad_clip):
    batches, params = fmnist
    fused_opt = sgd(LR)
    unfused_opt = Optimizer(fused_opt.init, fused_opt.update)  # not recognised as plain SGD
    fused = _trainer(fused_opt, robust, grad_clip)
    unfused = _trainer(unfused_opt, robust, grad_clip)
    assert _fused_w(fused_opt, fused.mixer, 1) is not None
    assert _fused_w(unfused_opt, unfused.mixer, 1) is None
    a, b = fused.init(params), unfused.init(params)
    calls = ops.gossip_update_stacked_grouped.plain_calls
    one_leaf = ops.gossip_update_stacked.plain_calls
    for t in range(STEPS):
        a, ma = fused.step(a, batches[t])
        b, mb = unfused.step(b, batches[t])
        for name in a.params:
            assert torch.equal(a.params[name], b.params[name]), (t, name)
        assert ma.keys() == mb.keys()
        for key in ma:
            assert torch.equal(ma[key], mb[key]), (t, key)
        assert a.comm.rounds == b.comm.rounds == t + 1
        assert torch.equal(a.comm.wire_bits, b.comm.wire_bits)
    # one grouped call per step over every leaf, no one-leaf call
    assert ops.gossip_update_stacked_grouped.plain_calls - calls == STEPS
    assert ops.gossip_update_stacked.plain_calls == one_leaf


def test_fused_step_applies_only_to_sgd_with_static_dense_mixing():
    w = metropolis_weights(build_graph("erdos_renyi", K, **GRAPH_KW))
    opt = sgd(LR)
    assert _fused_w(opt, _trainer(opt, True, None).mixer, 1) is not None
    others = [_trainer(opt, True, None, mixing="none").mixer,
              _trainer(opt, True, None,
                       compression=CompressionConfig(kind="int8")).mixer,
              make_gossip_mixer(permutation_decomposition(w), device="cpu")]
    assert all(_fused_w(opt, m, 1) is None for m in others)


# -- the grouped stacked form: every leaf of a step in one call ----------------

MLP_SHAPES = [(784, 128), (128,), (128, 64), (64,), (64, 10), (10,)]


def _stacked_leaves(k, shapes, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    thetas = [torch.from_numpy(rng.standard_normal((k, *s)).astype(np.float32)).to(dtype)
              for s in shapes]
    grads = [torch.from_numpy(rng.standard_normal((k, *s)).astype(np.float32)).to(dtype)
             for s in shapes]
    w = metropolis_weights(ring_graph(k)) if k > 2 else np.full((k, k), 1.0 / k)
    scale = torch.from_numpy(rng.uniform(0.1, 3.0, k).astype(np.float32))
    return thetas, grads, torch.from_numpy(w.astype(np.float32)), scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shapes", [(10, MLP_SHAPES), (8, [(896,), (151, 8), (3, 4, 5)]),
                                      (1, [(33,), (1,)]), (64, [(257,), (10,)]),
                                      (10, [(1,)] * 20)],
                         ids=["mlp", "lm-like", "k1", "k64", "over-the-cap"])
def test_grouped_stacked_equals_the_one_leaf_plain_version(k, shapes, dtype):
    """Every leaf of a group in one call: each output is the one-leaf plain
    version of its leaf, bit for bit, in the leaf's shape and dtype, in a
    tensor of its own; one grouped plain call, no one-leaf call."""
    thetas, grads, w, s = _stacked_leaves(k, shapes, seed=k + len(shapes), dtype=dtype)
    calls = ops.gossip_update_stacked_grouped.plain_calls
    one_leaf = ops.gossip_update_stacked.plain_calls
    got = ops.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.03)
    assert ops.gossip_update_stacked_grouped.plain_calls == calls + 1
    assert ops.gossip_update_stacked.plain_calls == one_leaf
    assert len(got) == len(thetas)
    assert len({t.data_ptr() for t in got}) == len(got)
    for theta, grad, out in zip(thetas, grads, got):
        want = ops.gossip_update_stacked(theta, grad, w, s, eta=0.03)
        assert out.shape == theta.shape and out.dtype == dtype
        assert torch.equal(out, want)


def _direct_stacked_tables(dims, cap):
    """B.1's leaf tables by a direct count: each leaf's CTAs counted column
    tile by column tile, the non-empty leaves cut into launches of ``cap``,
    each with the CTAs of its launch's earlier leaves summed one by one."""
    ctas = []
    for d in dims:
        n = 0
        for start in range(0, d, gk.STACKED_COLS):
            n += 1
        ctas.append(n)
    leaves = [leaf for leaf, n in enumerate(ctas) if n]
    tables = []
    for start in range(0, len(leaves), cap):
        launch = leaves[start:start + cap]
        tables.append([(leaf, sum(ctas[j] for j in launch[:i])) for i, leaf in enumerate(launch)])
    return tables


@pytest.mark.parametrize("cap", [gk.MAX_GROUP_LEAVES, 5, 1])
@pytest.mark.parametrize("dims", [[100352, 128, 8192, 64, 640, 10],
                                  [136134656, 896, 0, 1023, 1024, 1025] + [1] * 14],
                         ids=["mlp", "lm-like-over-the-cap"])
def test_stacked_leaf_tables_match_a_direct_count(dims, cap):
    tables = gk.leaf_tables(dims, cap)
    assert tables == _direct_stacked_tables(dims, cap)
    assert all(len(t) <= cap for t in tables)
    assert [leaf for t in tables for leaf, _ in t] == [i for i, d in enumerate(dims) if d]
    assert gk.MAX_GROUP_LEAVES == 16 and gk.STACKED_COLS == 1024


def _direct_node_tables(dims, n):
    """Per-node launches: at most 16 leaves, and at most 384 // n of them
    where n neighbours' rows would overflow the pool of 384."""
    cap = 16 if n == 0 else min(16, 384 // n)
    return _direct_stacked_tables(dims, cap)


@pytest.mark.parametrize("n", [0, 1, 9, 24, 25, 63])
@pytest.mark.parametrize("dims", [[100352, 128, 8192, 64, 640, 10],
                                  [7, 0, 1025] + [33] * 30],
                         ids=["mlp", "over-the-cap"])
def test_node_tables_match_a_direct_count(dims, n):
    """B.1's per-node launches for one node's leaves: the split at
    MAX_GROUP_LEAVES and at the neighbour pool, against a direct count."""
    tables = gk.node_tables(dims, n)
    assert tables == _direct_node_tables(dims, n)
    assert all(len(t) * n <= gk.NODE_NBR_POOL for t in tables)
    if dims[0] == 100352 and n <= 24:
        assert len(tables) == 1  # the fmnist MLP's 6 leaves: one launch per node
    assert gk.NODE_NBR_POOL == 384 and gk.MAX_NEIGHBORS == 63


def test_node_tables_refuse_more_than_63_neighbours():
    with pytest.raises(ValueError, match="neighbours"):
        gk.node_tables([8], 64)


def test_node_descriptors_point_at_every_leaf_and_neighbour_row():
    """The per-node launch's table and neighbour pool, against pointers
    taken directly: leaf l's neighbour j at l N + j, no copy of a row."""
    rng = np.random.default_rng(3)
    dims, n = [5, 2000, 3, 1024, 1], 3
    thetas, grads, outs = ([torch.from_numpy(rng.standard_normal(d).astype(np.float32))
                            for d in dims] for _ in range(3))
    nbrs = [[torch.zeros(d) for _ in range(n)] for d in dims]
    [table] = gk.node_tables(dims, n)
    desc, pool = gk.node_descriptors(table, thetas, grads, outs,
                                     [[x.data_ptr() for x in leaf] for leaf in nbrs])
    begin = 0
    for i, d in enumerate(dims):
        assert desc[5 * i:5 * i + 5] == [thetas[i].data_ptr(), grads[i].data_ptr(),
                                         outs[i].data_ptr(), d, begin]
        begin += -(-d // gk.STACKED_COLS)
        assert pool[n * i:n * i + n] == [x.data_ptr() for x in nbrs[i]]
    assert len(pool) == n * len(dims)


def test_grouped_stacked_kernel_refuses_what_it_does_not_take():
    thetas, grads, w, s = _stacked_leaves(4, [(8,), (3,)], seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gossip_update_stacked_grouped(thetas, grads, w, s, eta=0.1)
    with pytest.raises(ValueError, match="one or more"):
        gk.gossip_update_stacked_grouped(thetas, grads[:1], w, s, eta=0.1)


def test_dtype_groups_keep_the_leaf_order():
    from repro_torch.core.drdsgd import _dtype_groups

    params = {"a": torch.zeros(2, dtype=torch.bfloat16), "b": torch.zeros(2),
              "c": torch.zeros(2, dtype=torch.bfloat16), "d": torch.zeros(2)}
    assert _dtype_groups(params, ["a", "b", "c", "d"]) == [["a", "c"], ["b", "d"]]
    assert _dtype_groups({"a": params["b"], "b": params["d"]}, ["a", "b"]) == [["a", "b"]]


def test_fused_step_is_declined_at_65_nodes(fmnist):
    """K = 65 is above the stacked kernel's 64 nodes: the step takes the
    unfused path (the optimizer, then the mixer) and calls no form of the
    stacked update."""
    _, params = fmnist
    k = 65
    fed = pathological_noniid_partition(make_fmnist_like(n_train=6500, n_test=200), k, seed=0)
    batch = fed.sample_batch(np.random.default_rng(0), B)
    opt = sgd(LR)
    trainer = DecentralizedTrainer(nets.make_classifier_loss(nets.mlp_apply), nets.mlp_apply,
                                   num_nodes=k, graph="erdos_renyi", graph_kwargs=GRAPH_KW,
                                   robust=RobustConfig(mu=6.0), optimizer=opt, device="cpu")
    assert _fused_w(opt, trainer.mixer, 1) is None
    calls = (ops.gossip_update_stacked_grouped.plain_calls, ops.gossip_update_stacked.plain_calls)
    state, _ = trainer.step(trainer.init(params), batch)
    assert (ops.gossip_update_stacked_grouped.plain_calls,
            ops.gossip_update_stacked.plain_calls) == calls
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
