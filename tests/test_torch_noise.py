"""The compressed wire's stochastic-rounding noise: Philox-4x32-10 drawn per
round (``repro_torch.kernels.quant_gossip``: ``uniforms_grouped``, whose
plain version runs here; the kernel is held against it on the card in
``tests/test_torch_kernel.py`` and ``chip_smoke.py``).

- A numpy Philox-4x32-10 (``uint64`` products of two 32-bit words, exact)
  reproduces Random123's known-answer vectors, and so does the plain
  version's int64 arithmetic (its products taken from 16-bit halves).
- The plain ``uniforms_grouped`` equals the numpy reference bit for bit at
  leaf sizes that are and are not multiples of 4, across a group of more
  than 16 leaves (two launches on the card), at rounds past 2**32 (taken
  mod 2**32) and keys past 2**32 (both words).
- The draw is a pure function of (key, round, leaf, matching, element): a
  leaf drawn alone equals the same leaf drawn in a group, the order of
  draws changes nothing, and another round, leaf, matching or key gives
  other draws.
- A leaf's round divisor d draws it at floor(round / d) (the dynamics'
  outage coins, keyed by their window): the numpy reference at that round,
  leaf by leaf in a group of mixed divisors, past 2**32 windows, with
  negative rounds floored; a divisor below 1 is refused.
- 10**6 draws lie in [0, 1), their mean and variance within 5 sigma of
  U[0, 1)'s.
- The wires draw from it (no hook), the one-leaf and the round's draws
  agree, and a wire with a ``uniforms`` hook still returns the hook's
  values.
"""

import numpy as np
import pytest
import torch

from repro_torch.comm import CompressionConfig
from repro_torch.comm.protocol import trivial_comm_state
from repro_torch.comm.wire import CodecWire, MaskedQuantWire
from repro_torch.kernels.quant_gossip import ops, ref

M = (0xD2511F53, 0xCD9E8D57)
W = (0x9E3779B9, 0xBB67AE85)
LO = np.uint64(0xFFFFFFFF)

# Random123's known answers for philox4x32_10: (counter, key, output)
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def np_philox(c, k0, k1):
    """Philox-4x32-10 on uint64 arrays of 32-bit words (exact products)."""
    c = [np.asarray(x, dtype=np.uint64) for x in c]
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0, p1 = np.uint64(M[0]) * c[0], np.uint64(M[1]) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & LO, (p0 >> np.uint64(32)) ^ c[3] ^ k1,
             p0 & LO]
        k0, k1 = (k0 + np.uint64(W[0])) & LO, (k1 + np.uint64(W[1])) & LO
    return c


def np_uniforms(n: int, key: int, rnd: int, leaf: int, matching: int = 0) -> np.ndarray:
    """The reference layout: element e is word e % 4 of Philox((e >> 2, leaf,
    matching, round mod 2**32), key) >> 8, times 2**-24."""
    key %= 2 ** 64
    g = np.arange(-(-n // 4), dtype=np.uint64)
    words = np_philox([g, np.full_like(g, leaf), np.full_like(g, matching),
                       np.full_like(g, rnd % 2 ** 32)], key & 0xFFFFFFFF, key >> 32)
    flat = np.stack(words, 1).reshape(-1)[:n]
    return ((flat >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24))


def _round(r: int) -> torch.Tensor:
    return torch.tensor(r, dtype=torch.int64)


@pytest.mark.parametrize("case", range(len(KNOWN)))
def test_numpy_philox_known_answers(case):
    c, k, want = KNOWN[case]
    got = np_philox([[x] for x in c], *k)
    assert [int(w[0]) for w in got] == list(want)


@pytest.mark.parametrize("case", range(len(KNOWN)))
def test_plain_philox_known_answers(case):
    c, k, want = KNOWN[case]
    got = ref.philox4x32_10_ref([torch.tensor([x], dtype=torch.int64) for x in c], *k)
    assert [int(w) for w in got] == list(want)


@pytest.mark.parametrize("shapes,key,rnd,matching", [
    ([(10, 784), (10, 10), (3, 7), (1, 1), (5,)], 0, 0, 0),
    ([(6, 5), (4, 3, 3), (2, 2), (9,)], 2 ** 40 + 12345, 2 ** 32 + 7, 3),
    ([(2, n) for n in range(1, 21)], 7, 123456, 0),  # 20 leaves: over the 16 of a launch
])
def test_plain_uniforms_equal_numpy(shapes, key, rnd, matching):
    xs = [torch.empty(s) for s in shapes]
    got = ops.uniforms_grouped(xs, key, _round(rnd), matching=matching)
    for i, (x, u) in enumerate(zip(xs, got)):
        assert u.shape == x.shape and u.dtype == torch.float32
        want = np_uniforms(x.numel(), key, rnd, i, matching).reshape(x.shape)
        np.testing.assert_array_equal(u.numpy(), want)


def test_draw_is_a_pure_function_of_its_coordinates():
    xs = [torch.empty(4, 9), torch.empty(3, 5), torch.empty(17)]
    group = ops.uniforms_grouped(xs, 11, _round(5), matching=2)
    for i, x in enumerate(xs):  # each leaf alone, in reverse order
        alone = ops.uniforms_grouped([x], 11, _round(5), matching=2, leaves=[i])[0]
        assert torch.equal(alone, group[i])
    swapped = ops.uniforms_grouped(xs[::-1], 11, _round(5), matching=2, leaves=[2, 1, 0])
    assert all(torch.equal(a, b) for a, b in zip(swapped[::-1], group))
    again = ops.uniforms_grouped(xs, 11, _round(5), matching=2)
    assert all(torch.equal(a, b) for a, b in zip(again, group))


@pytest.mark.parametrize("field", ["rnd", "leaf", "matching", "key"])
def test_other_coordinates_give_other_draws(field):
    x = torch.empty(8, 64)
    base = dict(key=3, rnd=10, leaf=1, matching=0)

    def draw(key, rnd, leaf, matching):
        return ops.uniforms_grouped([x], key, _round(rnd), matching=matching, leaves=[leaf])[0]

    a, b = draw(**base), draw(**{**base, field: base[field] + 1})
    assert (a != b).float().mean() > 0.99


@pytest.mark.parametrize("rnd", [0, 9, 10, 123457, 10 * 2 ** 32 + 31, -1, -11])
def test_round_divisor_draws_at_the_window(rnd):
    xs = [torch.empty(3, 7), torch.empty(10), torch.empty(2, 2)]
    divisors = [1, 10, 2 ** 40]
    got = ops.uniforms_grouped(xs, 2 ** 33 + 5, _round(rnd), leaves=[4, 2 ** 32 - 254, 7],
                               divisors=divisors)
    for x, u, leaf, d in zip(xs, got, [4, 2 ** 32 - 254, 7], divisors):
        want = np_uniforms(x.numel(), 2 ** 33 + 5, rnd // d, leaf).reshape(x.shape)
        np.testing.assert_array_equal(u.numpy(), want)
    alone = ops.uniforms_grouped([xs[1]], 2 ** 33 + 5, _round(rnd // 10),
                                 leaves=[2 ** 32 - 254])[0]
    assert torch.equal(alone, got[1])
    for bad in ([1, 0, 1], [1, 1]):
        with pytest.raises(ValueError, match="divisor"):
            ops.uniforms_grouped(xs, 1, _round(rnd), divisors=bad)


def test_moments_of_a_million_draws():
    n = 10 ** 6
    u = ops.uniforms_grouped([torch.empty(n)], 2024, _round(1))[0].double()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    mean_sd = (1 / 12 / n) ** 0.5
    var_sd = ((1 / 80 - 1 / 144) / n) ** 0.5
    assert abs(float(u.mean()) - 0.5) < 5 * mean_sd
    assert abs(float(u.var(correction=0)) - 1 / 12) < 5 * var_sd


def test_wires_draw_from_philox():
    cfg = CompressionConfig(kind="int8", seed=9)
    state = trivial_comm_state(seed=9)._replace(rounds=4)
    xs = [torch.empty(6, 30), torch.empty(6, 7)]
    wire = CodecWire(cfg)
    assert not wire.hooked
    want = ops.uniforms_grouped(xs, 9, _round(4))
    got = wire.round_uniforms(state, _round(4), xs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for i, x in enumerate(xs):  # the one-leaf draw, at a host round
        assert torch.equal(wire.uniforms(9, 4, i, x), want[i])
    masked = MaskedQuantWire(cfg)
    want = ops.uniforms_grouped(xs, 9, _round(4), matching=2)
    got = masked.round_uniforms(state, _round(4), xs, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(masked.uniforms(9, 4, 1, 2, xs[1]), want[1])


def test_a_uniforms_hook_still_returns_its_values():
    seen = []

    def hook(*where):
        seen.append(where[:-1])
        return np.full(where[-1], 0.25 + 0.125 * where[1], np.float32)

    cfg = CompressionConfig(kind="int8")
    state = trivial_comm_state()._replace(rounds=7)
    xs = [torch.empty(3, 4), torch.empty(3, 5)]
    wire = CodecWire(cfg, uniforms=hook)
    assert wire.hooked
    got = wire.round_uniforms(state, _round(7), xs)
    assert [float(u.unique()) for u in got] == [0.25, 0.375]
    assert torch.equal(wire.uniforms(0, 7, 1, xs[1]), got[1])
    masked = MaskedQuantWire(cfg, uniforms=hook)
    got = masked.round_uniforms(state, _round(7), xs, 3)
    assert [float(u.unique()) for u in got] == [0.25, 0.375]
    assert seen == [(7, 0), (7, 1), (7, 1), (7, 0, 3), (7, 1, 3)]
