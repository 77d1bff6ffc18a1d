"""The dynamics' coins: every fault and topology draw of a round, on the device.

Each stream is one leaf of a Philox draw
(:func:`repro_torch.kernels.quant_gossip.ops.uniforms_grouped`: the kernel
on the card, its plain version on the CPU, bit-equal), a pure function of
(key, stream, round, element):

* key    — :func:`coin_key` of the process's own seed (``FaultConfig.seed``,
           a schedule's ``seed``), a host constant;
* stream — the leaf index, one per stream (:data:`LINKS`,
           :data:`STRAGGLERS`, :data:`OUTAGES`, :data:`DROPOUT`,
           :data:`GEOMETRIC`), all at or above :data:`COIN_LEAF`;
* round  — read on the device from a 0-d int64 tensor (the outage stream
           at its window ``round // outage_len``, through the leaf's round
           divisor), so a round captured in a CUDA graph draws the coins of
           the round it replays.

The wire's noise draws leaves 0 .. n − 1 of a round (n the model's leaves),
far below :data:`COIN_LEAF`, so no (key, leaf, round, element) counter of a
coin is ever one of the wire's, whatever the two seeds.  The coins no longer
depend on the device: the CPU and the card draw the same faults and
topologies.
"""

from __future__ import annotations

import hashlib

import torch

COIN_LEAF = 2 ** 32 - 256  # the coins' leaf indices: the top 256 of the counter's word
LINKS = COIN_LEAF + 0       # fault link drops, (K, K) (upper triangle used)
STRAGGLERS = COIN_LEAF + 1  # stragglers, (K,)
OUTAGES = COIN_LEAF + 2     # outages, (K,), keyed by the window
DROPOUT = COIN_LEAF + 3     # a dropout schedule's link coins, (K, K)
GEOMETRIC = COIN_LEAF + 4   # a geometric re-draw's points, (K, 2)


def coin_key(seed: int) -> int:
    """The 64-bit Philox key of the coins seeded by ``seed``."""
    digest = hashlib.blake2b(f"coins:{int(seed)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def draw(seed: int, round: torch.Tensor, shapes, streams, divisors=None) -> list:
    """U[0, 1) float32 coins of ``streams`` (one shape each) at ``round`` (a
    0-d int64 tensor; stream s at ``round // divisors[s]``) on the round's
    device: one Philox launch on the card."""
    from repro_torch.kernels.quant_gossip.ops import uniforms_grouped

    like = [torch.empty(shape, dtype=torch.float32, device=round.device) for shape in shapes]
    return uniforms_grouped(like, coin_key(seed), round, leaves=list(streams),
                            divisors=divisors)
