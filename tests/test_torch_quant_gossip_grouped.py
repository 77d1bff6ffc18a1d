"""The grouped int8 wire (B.2 to B.5 over every leaf of a round or matching), on the CPU.

On the card one launch quantizes every leaf of a matching
(``masked_quantize_blockwise_grouped``) and one accumulates every leaf in
place (``masked_dequant_accumulate_grouped_``); here the dispatchers run
the plain versions, which must be the one-leaf plain versions bit for bit:

- over the fmnist MLP's and the CNN's leaf sets at K = 10, three layout
  groups (two blocks per row, block 128 with a ragged leaf, ragged blocks),
  masks all ones, all zeros and mixed, qmax 127 and 7, and every src;
- the accumulate writes into each acc's own storage and returns it;
- the leaf tables the wrappers build (the prefix count of segments or CTAs
  before each leaf, the split into launches at the leaf cap) equal a direct
  count;
- the memoryless masked gossip round, now matching-outer, equals a copy of
  the leaf-outer loop it replaced bit for bit, and so do the EF wire's
  delta and re-base rounds, now an encode pass and an accumulate pass;
- the fused SGD step (B.1) is declined above the stacked kernel's 64 nodes;
- B.3 grouped (``dequant_accumulate_grouped_``: every leaf of a matching in
  place, no mask) equals the one-leaf plain version per leaf, and the
  static int8 gossip round, now one grouped B.3 call per matching, equals
  a copy of the per-leaf loop it replaced bit for bit; ``_accumulate_leaves``
  routes unmasked rounds to it;
- B.2 grouped (``quantize_blockwise_grouped``: every leaf of a round, no
  mask) equals the one-leaf plain version per leaf (the MLP's and the
  CNN's leaves, the layouts, block 128 with many segments, a group over the
  leaf cap) and B.4 grouped with every row live; unmasked
  ``encode_leaves`` equals the per-leaf encodes; the compressed dense
  round, now an encode pass (one grouped B.2 call) and a mix pass, equals a
  copy of the leaf-outer loop it replaced bit for bit.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_kernel.py, chip_smoke.py).  Inputs come from numpy with a
seed.
"""

import math
import types

import numpy as np
import pytest
import torch

from repro_torch.comm.topology import gather_round_vectors
from repro_torch.comm.wire import _send_mask
from repro_torch.kernels.quant_gossip import kernel as qk
from repro_torch.kernels.quant_gossip import ops, ref
from repro_torch.utils.tree import leaf_names

K = 10
MLP_D = [128, 100352, 64, 8192, 10, 640]
CNN_D = [32, 864, 64, 18432, 64, 36864, 500, 512000, 500, 250000, 10, 5000]
# name -> (K, widths, block_d)
GROUPS = {
    "mlp": (K, MLP_D, 65536),
    "cnn": (K, CNN_D, 65536),
    "2 blocks": (K, [131072, 100352, 10], 65536),
    "block 128": (16, [4096, 1000, 128, 7], 128),
    "ragged": (3, [1000, 256, 3], 256),
}
MASKS = ["ones", "zeros", "mixed"]


def _mask(kind, k):
    m = {"ones": np.ones(k), "zeros": np.zeros(k), "mixed": np.arange(k) % 2}[kind]
    return torch.from_numpy(m.astype(np.float32))


def _leaves(k, dims, seed):
    rng = np.random.default_rng(seed)
    xs, us = [], []
    for d in dims:
        x = (rng.standard_normal((k, d)) * rng.uniform(0.01, 3.0, (k, 1))).astype(np.float32)
        if k > 2:
            x[1] = 0.0  # an all-zero row: scale 1
        u = rng.random((k, d), dtype=np.float32)
        u[0, ::3] = 0.0
        xs.append(torch.from_numpy(x))
        us.append(torch.from_numpy(u))
    return xs, us


def _srcs(k):
    """None, then every matching of fmnist_default's graph (K = 10), or an
    involution over k rows."""
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    if k == K:
        w = metropolis_weights(build_graph("erdos_renyi", K, p=0.3, seed=0))
        perms = permutation_decomposition(w).matchings
        return [None] + [torch.from_numpy(p.astype(np.int64)) for p in perms]
    return [None, torch.tensor([i ^ 1 if (i ^ 1) < k else i for i in range(k)])]


@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_grouped_quantize_equals_one_leaf_calls(group, mask, qmax):
    k, dims, block_d = GROUPS[group]
    xs, us = _leaves(k, dims, seed=len(dims) + k)
    m = _mask(mask, k)
    calls = ops.masked_quantize_blockwise_grouped.plain_calls
    got = ops.masked_quantize_blockwise_grouped(xs, us, m, qmax=qmax, block_d=block_d)
    assert ops.masked_quantize_blockwise_grouped.plain_calls == calls + 1
    assert len(got) == len(dims)
    for x, u, (q, s), d in zip(xs, us, got, dims):
        q1, s1 = ops.masked_quantize_blockwise(x, u, m, qmax=qmax, block_d=block_d)
        assert q.dtype == torch.int8 and s.shape == (k, qk.num_blocks(d, block_d))
        assert torch.equal(q, q1) and torch.equal(s, s1)
        assert not q[m == 0].any() and not s[m == 0].any()


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_grouped_accumulate_equals_one_leaf_calls_in_place(group, mask):
    k, dims, block_d = GROUPS[group]
    xs, us = _leaves(k, dims, seed=3 * len(dims) + k)
    m = _mask(mask, k)
    payloads = [ref.quantize_blockwise_ref(x, u, block_d=block_d) for x, u in zip(xs, us)]
    gen = torch.Generator().manual_seed(k)
    w = torch.rand((k,), generator=gen) * 0.5
    w[0] = 0.0  # a row that receives nothing
    accs0 = [torch.randn((k, d), generator=gen) for d in dims]
    for src in _srcs(k):
        accs = [a.clone() for a in accs0]
        ptrs = [a.data_ptr() for a in accs]
        calls = ops.masked_dequant_accumulate_grouped_.plain_calls
        out = ops.masked_dequant_accumulate_grouped_(accs, payloads, w, m, src=src)
        assert ops.masked_dequant_accumulate_grouped_.plain_calls == calls + 1
        assert out is accs and [a.data_ptr() for a in out] == ptrs
        live = (m * w) != 0
        for a0, a, (q, s) in zip(accs0, out, payloads):
            want = ops.masked_dequant_accumulate(a0, q, s, w, m, src=src)
            assert torch.equal(a, want)
            assert torch.equal(a[~live], a0[~live])  # masked or idle rows: acc bitwise


@pytest.mark.parametrize("group", list(GROUPS) + ["over the cap"])
def test_grouped_b3_accumulate_equals_one_leaf_plain_versions_in_place(group):
    """B.3 over every leaf of a group (no mask): each acc is overwritten in
    its own storage with dequant_accumulate_ref of it, bit for bit, for
    every src; a row with w = 0 keeps its acc bitwise."""
    if group == "over the cap":
        k, dims, block_d = K, MLP_D + CNN_D + [4096, 7], 65536
    else:
        k, dims, block_d = GROUPS[group]
    xs, us = _leaves(k, dims, seed=5 * len(dims) + k)
    payloads = [ref.quantize_blockwise_ref(x, u, block_d=block_d) for x, u in zip(xs, us)]
    gen = torch.Generator().manual_seed(k + 1)
    w = torch.rand((k,), generator=gen) * 0.5
    w[0] = 0.0  # a row that receives nothing
    accs0 = [torch.randn((k, d), generator=gen) for d in dims]
    for src in _srcs(k):
        accs = [a.clone() for a in accs0]
        ptrs = [a.data_ptr() for a in accs]
        calls = ops.dequant_accumulate_grouped_.plain_calls
        one_leaf = ops.dequant_accumulate.plain_calls
        out = ops.dequant_accumulate_grouped_(accs, payloads, w, src=src)
        assert ops.dequant_accumulate_grouped_.plain_calls == calls + 1
        assert ops.dequant_accumulate.plain_calls == one_leaf
        assert out is accs and [a.data_ptr() for a in out] == ptrs
        for a0, a, (q, sc) in zip(accs0, out, payloads):
            assert torch.equal(a, ref.dequant_accumulate_ref(a0, q, sc, w, src=src))
            assert torch.equal(a[0], a0[0])


def _segments(k, dims, block_d):
    """Segments (leaf, row, block) counted one by one, leaf-major."""
    out = []
    for leaf, d in enumerate(dims):
        block = min(block_d, d) if d % min(block_d, d) == 0 else d
        for row in range(k):
            for b in range(d // block):
                out.append((leaf, row, b, block))
    return out


def _clusters(segments):
    """B.4's clusters counted one by one: a segment longer than MIN_SHARE
    is a cluster; shorter ones go CLUSTER_SIZE to a cluster, leaf by leaf."""
    out = []
    for seg in segments:
        if seg[3] > qk.MIN_SHARE or not out or out[-1][0][0] != seg[0] \
                or out[-1][0][3] > qk.MIN_SHARE or len(out[-1]) == qk.CLUSTER_SIZE:
            out.append([seg])
        else:
            out[-1].append(seg)
    return out


def _direct_tables(units, cap):
    """The leaf tables by a direct count: the non-empty leaves in order, cut
    into launches of ``cap``, each leaf with the units of its launch's
    earlier leaves summed one by one."""
    leaves = [leaf for leaf, n in enumerate(units) if n]
    tables = []
    for start in range(0, len(leaves), cap):
        launch = leaves[start:start + cap]
        tables.append([(leaf, sum(units[j] for j in launch[:i]))
                       for i, leaf in enumerate(launch)])
    return tables


@pytest.mark.parametrize("cap", [qk.MAX_GROUP_LEAVES, 5, 1])
@pytest.mark.parametrize("group", list(GROUPS) + ["over the cap"])
def test_leaf_tables_match_a_direct_count(group, cap):
    if group == "over the cap":  # the MLP's and the CNN's leaves, and two more
        k, dims, block_d = K, MLP_D + CNN_D + [4096, 7], 65536
    else:
        k, dims, block_d = GROUPS[group]
    segments = _segments(k, dims, block_d)
    assert [sum(1 for s in segments if s[0] == leaf) for leaf in range(len(dims))] == \
        [k * qk.num_blocks(d, block_d) for d in dims]
    clusters = _clusters(segments)
    seg_units = [sum(1 for c in clusters if c[0][0] == leaf) for leaf in range(len(dims))]
    assert seg_units == [qk.quantize_clusters(k, d, block_d) for d in dims]
    acc_units = [k * math.ceil(d / qk.ACC_CHUNK) for d in dims]
    for units in (seg_units, acc_units):
        tables = qk.leaf_tables(units, cap)
        assert tables == _direct_tables(units, cap)
        assert len(tables) == math.ceil(len(dims) / cap)
        assert all(len(t) <= cap for t in tables)
        assert [leaf for t in tables for leaf, _ in t] == list(range(len(dims)))
    # one launch's clusters, in the kernel's order: cluster c of a launch
    # belongs to the last leaf whose prefix is <= c, and takes its segments
    # from the leaf's first on (one, or CLUSTER_SIZE packed)
    for table in qk.leaf_tables(seg_units, cap):
        launch = [c for c in clusters if c[0][0] in {leaf for leaf, _ in table}]
        for c, members in enumerate(launch):
            found = max(i for i, (_, begin) in enumerate(table) if begin <= c)
            leaf, begin = table[found]
            assert all(s[0] == leaf for s in members)
            local = c - begin
            bpr = qk.num_blocks(dims[leaf], block_d)
            first = local * qk.CLUSTER_SIZE if members[0][3] <= qk.MIN_SHARE else local
            for rank, (_, row, b, _) in enumerate(members):
                assert divmod(first + rank, bpr) == (row, b)


def test_leaf_tables_leave_out_empty_leaves_and_q_offsets_are_aligned():
    assert qk.leaf_tables([3, 0, 5, 0], 16) == [[(0, 0), (2, 3)]]
    assert qk.leaf_tables([0, 0], 16) == []
    offsets, total = qk._aligned_offsets([10 * d for d in MLP_D], 16)
    assert all(o % 16 == 0 for o in offsets)
    assert total >= sum(10 * d for d in MLP_D) and total % 16 == 0


# -- the gossip rounds: matching-outer and two-pass against the old loops ------

def _old_quantized_gossip(self, theta, state, self_w, match_ws, masks, clock=None):
    """The memoryless round as it was: every leaf, every matching (its
    noise at the host ``state.rounds``; the clock is the new round's
    argument, which the eager rounds here fill from that int)."""
    from repro_torch.kernels.quant_gossip.ops import masked_quant_gossip_round

    wire = self.wire
    out = {}
    for i, name in enumerate(leaf_names(theta)):
        x = theta[name]
        k = x.shape[0]
        xf = x.reshape(k, -1).float()
        acc = xf * self_w[:, None]
        for m, (pw, mk, src) in enumerate(zip(match_ws, masks, self.transport.srcs)):
            u = wire.uniforms(state.key, state.rounds, i, m, xf)
            acc = masked_quant_gossip_round(xf, acc, pw, mk, src, u,
                                            qmax=float(wire._qmax),
                                            block_d=wire.quantized.block_d)
        out[name] = acc.reshape(x.shape).to(x.dtype)
    return out


def _old_encode(self, x, hat, u, send):
    """One leaf's masked encode as it was: the one-leaf quantize of the
    innovation (EF) or of θ (memoryless)."""
    payload = ops.masked_quantize_blockwise(x - hat if self.ef else x, u, send,
                                            qmax=float(self.compressor.qmax),
                                            block_d=self.compressor.block_d)
    public = ops.dequantize_blockwise(*payload)
    if self.ef:
        return payload, hat + public, hat + public
    return payload, public, ()


def _old_gossip_round(self, theta, state, *, self_w=None, match_ws=None, masks=None,
                      senders=None, clock=None):
    """The EF wire's masked delta round as it was: leaf by leaf, one-leaf
    calls (the dynamic stacks always pass masks)."""
    t = self.transport
    ef = self.ef
    send = _send_mask(masks)
    out_theta, out_hat, out_mix = {}, {}, {}
    res_sq = torch.zeros((), dtype=torch.float32, device=self_w.device)
    for i, name in enumerate(leaf_names(theta)):
        x = theta[name]
        k = x.shape[0]
        xf = x.reshape(k, -1).float()
        h = state.hat[name].reshape(k, -1) if ef else None
        if ef:
            res_sq = res_sq + (xf - h).square().sum()
        u = self.wire.uniforms(state.key, state.rounds, i, xf)
        payload, public, new_hat = _old_encode(self, xf, h, u, send)
        if ef:
            acc = state.hat_mix[name].reshape(k, -1) + self_w[:, None] * (public - h)
        else:
            acc = self_w[:, None] * public
        for pw, mk, src in zip(match_ws, masks, t.srcs):
            acc = ops.masked_dequant_accumulate(acc, *payload, pw, mk, src=src)
        out = xf + (acc - public)
        out_theta[name] = out.reshape(x.shape).to(x.dtype)
        if ef:
            out_hat[name] = new_hat.reshape(x.shape)
            out_mix[name] = acc.reshape(x.shape)
    return out_theta, state._replace(
        hat=out_hat if ef else (), hat_mix=out_mix if ef else (),
        res_norm=torch.sqrt(res_sq), rounds=state.rounds + 1,
        wire_bits=self.wire.round_wire_bits(theta, None, senders, self.k, res_sq.device))


def _old_rebase_round(self, theta, state, self_w, match_ws, masks, senders, clock=None):
    """The EF wire's re-base round as it was: leaf by leaf."""
    from repro_torch.comm.wire import wire_bits

    send = _send_mask(masks)
    out_theta, out_hat, out_mix = {}, {}, {}
    res_sq = torch.zeros((), dtype=torch.float32, device=self_w.device)
    for i, name in enumerate(leaf_names(theta)):
        x = theta[name]
        k = x.shape[0]
        xf = x.reshape(k, -1).float()
        hf = state.hat[name].reshape(k, -1)
        res_sq = res_sq + (xf - hf).square().sum()
        u = self.wire.uniforms(state.key, state.rounds, i, xf)
        _, _, new_hat = _old_encode(self, xf, hf, u, send)
        acc = self_w[:, None] * new_hat
        for pw, mk, src in zip(match_ws, masks, self.transport.srcs):
            acc = acc + (pw * mk)[:, None] * new_hat[src]
        out = xf + (acc - new_hat)
        out_theta[name] = out.reshape(x.shape).to(x.dtype)
        out_hat[name] = new_hat.reshape(x.shape)
        out_mix[name] = acc.reshape(x.shape)
    full_bits = 32.0 * sum(x.numel() // self.k for x in theta.values())
    return out_theta, state._replace(
        hat=out_hat, hat_mix=out_mix, res_norm=torch.sqrt(res_sq),
        rounds=state.rounds + 1, wire_bits=wire_bits(senders, full_bits, None))


def _mixer(stack):
    from repro_torch.comm import CompressionConfig
    from repro_torch.dynamics import DropoutSchedule, DynamicGossipMixer
    from repro_torch.graphs import build_graph, metropolis_weights

    w = metropolis_weights(build_graph("erdos_renyi", K, p=0.3, seed=0))
    sched = DropoutSchedule(w, 0.2, seed=0, device="cpu")
    if stack == "memoryless":
        cfg = CompressionConfig(kind="int8", use_kernel=True, error_feedback=False)
        return DynamicGossipMixer(sched, quantized=cfg)
    if stack == "memoryless-int4":
        return DynamicGossipMixer(sched, quantized=CompressionConfig(
            kind="int4", error_feedback=False))
    return DynamicGossipMixer(sched, quantized=CompressionConfig(kind="int8", use_kernel=True),
                              ef_rebase_every=2)


def _theta(seed):
    rng = np.random.default_rng(seed)
    shapes = {"fc0/b": (128,), "fc0/w": (784, 128), "fc1/b": (64,), "fc1/w": (128, 64),
              "fc2/b": (10,), "fc2/w": (64, 10)}
    return {n: torch.from_numpy(rng.standard_normal((K,) + s).astype(np.float32))
            for n, s in shapes.items()}


@pytest.mark.parametrize("stack", ["memoryless", "memoryless-int4", "ef-b2"])
def test_grouped_gossip_rounds_equal_the_leaf_by_leaf_rounds(stack):
    """Four rounds of the dropout-0.2 stack through the grouped calls and
    through the old leaf-outer loops (the EF stack at B = 2 runs two delta
    and two re-base rounds): θ, and θ̂ and its mix cache on the EF wire,
    bit for bit; the grouped dispatchers run once per matching (memoryless)
    or once per round and once per matching of each delta round (EF)."""
    new, old = _mixer(stack), _mixer(stack)
    old._quantized_gossip = types.MethodType(_old_quantized_gossip, old)
    old._gossip_round = types.MethodType(_old_gossip_round, old)
    old._rebase_round = types.MethodType(_old_rebase_round, old)
    theta = _theta(0)
    (ta, sa), (tb, sb) = (theta, new.init_state(theta)), (theta, old.init_state(theta))
    matchings = len(new.transport.srcs)
    for r in range(4):
        q0 = ops.masked_quantize_blockwise_grouped.plain_calls
        a0 = ops.masked_dequant_accumulate_grouped_.plain_calls
        ta, sa = new(ta, sa)
        tb, sb = old(tb, sb)
        dq = ops.masked_quantize_blockwise_grouped.plain_calls - q0
        da = ops.masked_dequant_accumulate_grouped_.plain_calls - a0
        if stack.startswith("memoryless"):
            assert (dq, da) == (matchings, matchings)
        else:
            assert (dq, da) == (1, matchings if r % 2 == 0 else 0)
        for n in theta:
            assert torch.equal(ta[n], tb[n]), (r, n)
            if sa.hat != ():
                assert torch.equal(sa.hat[n], sb.hat[n]), (r, n)
                assert torch.equal(sa.hat_mix[n], sb.hat_mix[n]), (r, n)
        assert torch.equal(sa.wire_bits, sb.wire_bits)
        assert torch.equal(sa.res_norm, sb.res_norm)


def test_matching_outer_round_is_the_composed_exchange():
    """One memoryless round by hand through ``masked_quant_gossip_round``
    (one leaf, one matching) equals the mixer's grouped round."""
    mixer = _mixer("memoryless")
    theta = _theta(1)
    state = mixer.init_state(theta)
    w = mixer.topo.round_w(state.rounds)
    self_w, match_ws, masks = gather_round_vectors(w, mixer.transport.perm_idx)
    want = _old_quantized_gossip(mixer, theta, state, self_w, match_ws, masks)
    got = mixer._quantized_gossip(theta, state, self_w, match_ws, masks)
    assert all(torch.equal(got[n], want[n]) for n in theta)


# -- the static wire's round: B.3 grouped against the per-leaf loop -----------

def _old_static_gossip_round(self, theta, state, **_):
    """The static wire's round as it was before B.3 was grouped: encode
    pass, then per matching every leaf through the one-leaf B.3
    (``_accumulate`` → ``KernelInt8Quantizer.accumulate``)."""
    t = self.transport
    ef = self.ef
    names = leaf_names(theta)
    xfs, hats, res_sq = self._flat_leaves(theta, state, t.self_w.device)
    us = [self.wire.uniforms(state.key, state.rounds, i, xf) for i, xf in enumerate(xfs)]
    encoded = self.wire.encode_leaves(xfs, hats, us)
    if ef:
        accs = [state.hat_mix[n].reshape(xf.shape) + t.self_w[:, None] * (public - h)
                for n, xf, h, (_, public, _) in zip(names, xfs, hats, encoded)]
    else:
        accs = [t.self_w[:, None] * public for _, public, _ in encoded]
    payloads = [payload for payload, _, _ in encoded]
    for pw, src in zip(t.match_ws, t.srcs):
        accs = [self._accumulate(acc, p, pw, src) for acc, p in zip(accs, payloads)]
    out_theta, out_hat, out_mix = {}, {}, {}
    for n, xf, acc, (_, public, new_hat) in zip(names, xfs, accs, encoded):
        shape = theta[n].shape
        out_theta[n] = (xf + (acc - public)).reshape(shape).to(theta[n].dtype)
        if ef:
            out_hat[n] = new_hat.reshape(shape)
            out_mix[n] = acc.reshape(shape)
    return out_theta, state._replace(
        hat=out_hat if ef else (), hat_mix=out_mix if ef else (),
        res_norm=torch.sqrt(res_sq), rounds=state.rounds + 1,
        wire_bits=self.wire.round_wire_bits(theta, None, self._sends(), self.k, res_sq.device))


def _static_mixer(ef):
    from repro_torch.comm import CompressedGossipMixer, CompressionConfig
    from repro_torch.graphs import build_graph, metropolis_weights, permutation_decomposition

    decomp = permutation_decomposition(
        metropolis_weights(build_graph("erdos_renyi", K, p=0.3, seed=0)))
    return CompressedGossipMixer(decomp, CompressionConfig(kind="int8", use_kernel=True,
                                                           error_feedback=ef), device="cpu")


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "memoryless"])
def test_static_round_grouped_b3_equals_the_per_leaf_loop(ef):
    """Three rounds of the static int8 gossip wire (EF: θ̂ and its mix cache
    carried; memoryless) through the grouped B.3 (one call per matching)
    and through a copy of the per-leaf loop it replaced (one call per leaf
    and matching): θ, θ̂, the mix cache, the residual and the wire bits bit
    for bit."""
    new, old = _static_mixer(ef), _static_mixer(ef)
    old._gossip_round = types.MethodType(_old_static_gossip_round, old)
    theta = _theta(2)
    (ta, sa), (tb, sb) = (theta, new.init_state(theta)), (theta, old.init_state(theta))
    matchings = len(new.transport.srcs)
    for r in range(3):
        g0 = ops.dequant_accumulate_grouped_.plain_calls
        o0 = ops.dequant_accumulate.plain_calls
        ta, sa = new(ta, sa)
        assert ops.dequant_accumulate_grouped_.plain_calls - g0 == matchings
        assert ops.dequant_accumulate.plain_calls == o0
        tb, sb = old(tb, sb)
        assert ops.dequant_accumulate.plain_calls - o0 == matchings * len(theta)
        for n in theta:
            assert torch.equal(ta[n], tb[n]), (r, n)
            if ef:
                assert torch.equal(sa.hat[n], sb.hat[n]), (r, n)
                assert torch.equal(sa.hat_mix[n], sb.hat_mix[n]), (r, n)
        assert torch.equal(sa.wire_bits, sb.wire_bits)
        assert torch.equal(sa.res_norm, sb.res_norm)


def test_accumulate_leaves_routes_unmasked_rounds_to_grouped_b3():
    """``_accumulate_leaves`` with no mask hands every leaf to the kernel
    quantizer's ``accumulate_grouped_`` at once (in place), with a mask to
    its ``accumulate_masked_grouped_``; a codec without them goes leaf by
    leaf."""
    from repro_torch.comm.compressors import IntQuantizer

    mixer = _static_mixer(True)
    calls = []
    quantizer = mixer.compressor
    mixer.compressor = types.SimpleNamespace(
        accumulate_grouped_=lambda *a: calls.append(("b3", a)) or a[0],
        accumulate_masked_grouped_=lambda *a: calls.append(("b5", a)) or a[0])
    accs = [torch.zeros((K, 3)), torch.zeros((K, 5))]
    payloads = ["p0", "p1"]
    w, src, mask = torch.ones(K), torch.arange(K), torch.ones(K)
    assert mixer._accumulate_leaves(accs, payloads, w, src) is accs
    assert mixer._accumulate_leaves(accs, payloads, w, src, mask=mask) is accs
    assert [c[0] for c in calls] == ["b3", "b5"]
    assert calls[0][1] == (accs, payloads, w, src)
    assert calls[1][1] == (accs, payloads, w, mask, src)
    # the real quantizer: the grouped dispatcher once, no one-leaf call
    mixer.compressor = quantizer
    xs, us = _leaves(K, [3, 5], seed=9)
    payloads = [quantizer.compress(x, u) for x, u in zip(xs, us)]
    g0, o0 = ops.dequant_accumulate_grouped_.plain_calls, ops.dequant_accumulate.plain_calls
    out = mixer._accumulate_leaves(accs, payloads, w * 0.5, src)
    assert out is accs
    assert ops.dequant_accumulate_grouped_.plain_calls == g0 + 1
    assert ops.dequant_accumulate.plain_calls == o0
    # a codec without grouped calls: one accumulate per leaf
    mixer.compressor = IntQuantizer(8)
    payloads = [mixer.compressor.compress(x, u) for x, u in zip(xs, us)]
    out = mixer._accumulate_leaves(accs, payloads, w, src)
    assert out is not accs and len(out) == 2


# -- the fused step's routing above 64 nodes -----------------------------------

@pytest.mark.parametrize("k", [64, 65])
def test_fused_step_is_declined_above_64_nodes(k):
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.core.drdsgd import _fused_w
    from repro_torch.graphs import metropolis_weights, ring_graph
    from repro_torch.kernels.gossip_update.kernel import MAX_NODES
    from repro_torch.optim import sgd

    mixer = make_dense_mixer(metropolis_weights(ring_graph(k)), device="cpu")
    fused = _fused_w(sgd(0.1), mixer, 1)
    assert MAX_NODES == 64
    assert (fused is not None) == (k <= MAX_NODES)
    if fused is not None:
        assert fused.shape == (k, k)


# -- B.2 grouped: the unmasked quantizer over every leaf of a round ------------

@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("group", list(GROUPS) + ["block 128, many segments", "over the cap"])
def test_grouped_b2_quantize_equals_one_leaf_plain_versions(group, qmax):
    """B.2 over every leaf of a group (no mask): each leaf's (q, scales) is
    quantize_blockwise_ref of it, bit for bit, laid out by _pick_block (the
    ragged fallback, block 128 with many segments, two blocks per row); the
    one-leaf dispatcher is not called.  The launches split as B.4's do."""
    if group == "over the cap":
        k, dims, block_d = K, MLP_D + CNN_D + [4096, 7], 65536
    elif group == "block 128, many segments":  # the serving int8 KV layout
        k, dims, block_d = 32, [128 * 64, 128, 128 * 3], 128
    else:
        k, dims, block_d = GROUPS[group]
    xs, us = _leaves(k, dims, seed=7 * len(dims) + k)
    calls = ops.quantize_blockwise_grouped.plain_calls
    one_leaf = ops.quantize_blockwise.plain_calls
    got = ops.quantize_blockwise_grouped(xs, us, qmax=qmax, block_d=block_d)
    assert ops.quantize_blockwise_grouped.plain_calls == calls + 1
    assert ops.quantize_blockwise.plain_calls == one_leaf
    assert len(got) == len(dims)
    for x, u, (q, s), d in zip(xs, us, got, dims):
        q1, s1 = ref.quantize_blockwise_ref(x, u, qmax=qmax, block_d=block_d)
        assert q.dtype == torch.int8 and s.shape == (k, qk.num_blocks(d, block_d))
        assert torch.equal(q, q1) and torch.equal(s, s1)
        # and the one-leaf dispatcher gives the same
        q2, s2 = ops.quantize_blockwise(x, u, qmax=qmax, block_d=block_d)
        assert torch.equal(q, q2) and torch.equal(s, s2)
    units = [qk.quantize_clusters(k, d, block_d) for d in dims]
    assert len(qk.leaf_tables(units)) == math.ceil(len(dims) / qk.MAX_GROUP_LEAVES)


def test_grouped_b2_is_masked_b4_with_every_row_live():
    """B.2 grouped is B.4 grouped with a mask of ones, bit for bit (the
    kernel shares one launch path: a null mask reads m = 1)."""
    xs, us = _leaves(K, MLP_D, seed=11)
    got = ops.quantize_blockwise_grouped(xs, us)
    want = ops.masked_quantize_blockwise_grouped(xs, us, torch.ones(K))
    for (q, s), (q1, s1) in zip(got, want):
        assert torch.equal(q, q1) and torch.equal(s, s1)


def test_grouped_b2_kernel_refuses_the_cpu_and_a_missing_u():
    xs, us = _leaves(K, [8, 4], seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        qk.quantize_blockwise_grouped(xs, us)
    with pytest.raises(ValueError, match="CUDA"):
        qk.quantize_blockwise(xs[0], us[0])
    with pytest.raises(ValueError, match="one or more"):
        qk.quantize_blockwise_grouped(xs, us[:1])


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "memoryless"])
@pytest.mark.parametrize("kernel", [True, False], ids=["int8-kernel", "int8"])
def test_unmasked_encode_leaves_equal_the_per_leaf_encodes(ef, kernel):
    """``encode_leaves`` with no send mask: the kernel quantizer encodes
    every leaf in one grouped B.2 call; any codec gives the per-leaf
    ``encode_leaf`` payloads, public copies and θ̂ bit for bit."""
    from repro_torch.comm import CompressionConfig
    from repro_torch.comm.wire import ChocoWire, CodecWire

    cfg = CompressionConfig(kind="int8", use_kernel=kernel, error_feedback=ef)
    wire = ChocoWire(cfg) if ef else CodecWire(cfg)
    xs, us = _leaves(K, MLP_D, seed=21)
    gen = torch.Generator().manual_seed(3)
    hats = [0.9 * x + 0.01 * torch.randn(x.shape, generator=gen) for x in xs] if ef \
        else [None] * len(xs)
    calls = ops.quantize_blockwise_grouped.plain_calls
    one_leaf = ops.quantize_blockwise.plain_calls
    got = wire.encode_leaves(xs, hats, us)
    assert ops.quantize_blockwise_grouped.plain_calls == calls + int(kernel)
    assert ops.quantize_blockwise.plain_calls == one_leaf
    want = [wire.encode_leaf(x, h, u) for x, h, u in zip(xs, hats, us)]
    assert ops.quantize_blockwise.plain_calls == one_leaf + (len(xs) if kernel else 0)
    for (p, pub, hat), (p1, pub1, hat1) in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(p, p1))
        assert torch.equal(pub, pub1)
        if ef:
            assert torch.equal(hat, hat1)
        else:
            assert hat == hat1 == ()


def _old_dense_round(self, theta, state, **_):
    """The compressed dense round as it was: leaf by leaf, each leaf's
    uniforms, encode and W product in turn."""
    w = self._round_w(state)
    out_theta, out_hat = {}, {}
    res_sq = torch.zeros((), dtype=torch.float32, device=w.device)
    for i, name in enumerate(leaf_names(theta)):
        x = theta[name]
        k = x.shape[0]
        xf = x.reshape(k, -1).float()
        hf = state.hat[name].reshape(k, -1) if self.ef else None
        if self.ef:
            res_sq = res_sq + (xf - hf).square().sum()
        u = self.wire.uniforms(state.key, state.rounds, i, xf)
        _, public, new_hat = self.wire.encode_leaf(xf, hf, u)
        mixed = w @ public
        out = xf + (mixed - public)
        out_theta[name] = out.reshape(x.shape).to(x.dtype)
        if self.ef:
            out_hat[name] = new_hat.reshape(x.shape)
    return out_theta, state._replace(
        hat=out_hat if self.ef else (),
        res_norm=torch.sqrt(res_sq), rounds=state.rounds + 1,
        wire_bits=self.wire.round_wire_bits(theta, None, self._senders(w), self.k, w.device))


@pytest.mark.parametrize("kernel", [True, False], ids=["int8-kernel", "int8"])
@pytest.mark.parametrize("ef", [True, False], ids=["ef", "memoryless"])
def test_two_pass_dense_round_equals_the_leaf_outer_loop(ef, kernel):
    """Three compressed dense rounds (fmnist's graph, K = 10, the MLP's
    leaves) through the two-pass round (encode every leaf: one grouped B.2
    call per round for the kernel quantizer; then mix each leaf) and
    through a copy of the leaf-outer loop it replaced: θ, θ̂, the residual
    and the wire bits bit for bit."""
    from repro_torch.comm import CompressionConfig
    from repro_torch.core.consensus import make_dense_mixer
    from repro_torch.graphs import build_graph, metropolis_weights

    w = metropolis_weights(build_graph("erdos_renyi", K, p=0.3, seed=0))
    cfg = CompressionConfig(kind="int8", use_kernel=kernel, error_feedback=ef)
    new, old = (make_dense_mixer(w, compression=cfg, device="cpu") for _ in range(2))
    old._dense_round = types.MethodType(_old_dense_round, old)
    theta = _theta(3)
    (ta, sa), (tb, sb) = (theta, new.init_state(theta)), (theta, old.init_state(theta))
    for r in range(3):
        calls = ops.quantize_blockwise_grouped.plain_calls
        one_leaf = ops.quantize_blockwise.plain_calls
        ta, sa = new(ta, sa)
        assert ops.quantize_blockwise_grouped.plain_calls == calls + int(kernel)
        assert ops.quantize_blockwise.plain_calls == one_leaf
        tb, sb = old(tb, sb)
        for n in theta:
            assert torch.equal(ta[n], tb[n]), (r, n)
            if ef:
                assert torch.equal(sa.hat[n], sb.hat[n]), (r, n)
        assert torch.equal(sa.res_norm, sb.res_norm)
        assert torch.equal(sa.wire_bits, sb.wire_bits)
