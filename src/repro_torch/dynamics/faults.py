"""Fault injection for dynamic-graph consensus: link drops, stragglers, outages.

The port of ``repro.dynamics.faults``.  Every fault is a per-round symmetric
link *keep* matrix applied to the round's mixing matrix through
:func:`repro_torch.graphs.mixing.renormalize_masked_weights`, so the faulted
W stays doubly stochastic (dropped mass returns to the incident diagonals)
and the node average is preserved whichever links fail.

Semantics:

* link dropout  — every link fails independently with ``link_drop_p`` each
  round.
* stragglers    — a node fails to *communicate* for one round with
  ``straggler_p``: all its incident links are down and its row of W
  degenerates to e_i, so θ_i keeps its local update but neither sends nor
  receives.
* correlated outages — a node goes down for ``outage_len`` consecutive
  rounds with probability ``outage_p`` per window (the coin is drawn per
  ``rounds // outage_len`` window).

The coins are a pure function of the round: each stream (links, stragglers)
comes from a ``torch.Generator`` on the device seeded with a blake2b hash
of (seed, round), and the outage stream from one seeded with a hash of
(seed ^ 0x5DEECE66, window).  A run therefore replays the same fault
sequence, and the dense and gossip lowerings see the same faults.  These
are not the reference's bits (it folds the round into a JAX key), and a
CUDA generator's bits differ from a CPU generator's; the tests hold the
sampler on its rates and inject the reference's replayed masks where they
compare arithmetic.  ``rounds`` is a host int, so no round reads the
device.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.mixing import symmetric_uniform

OUTAGE_SEED_XOR = 0x5DEECE66  # the reference's outage-stream seed constant


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round fault process for the dynamics subsystem.

    Attributes:
      link_drop_p: iid per-link per-round drop probability.
      straggler_p: iid per-node per-round probability of skipping the round
        (no send, no receive; local update kept).
      outage_p: per-window probability a node is down for a whole window of
        ``outage_len`` rounds (correlated failures).
      outage_len: rounds per outage window.
      seed: seed of the fault process (independent of the codec noise).
      straggler_skips_compute: when True a down node (straggler or outage)
        loses its gradient too: the train step multiplies the robust
        per-node scale by the round's ``up`` vector, so the node's
        parameters pass the optimizer unchanged that round.  The mask
        replays the process the mixer uses, so compute and communication
        fail in lockstep.
    """

    link_drop_p: float = 0.0
    straggler_p: float = 0.0
    outage_p: float = 0.0
    outage_len: int = 10
    seed: int = 0
    straggler_skips_compute: bool = False

    def __post_init__(self):
        for name in ("link_drop_p", "straggler_p", "outage_p"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.outage_len < 1:
            raise ValueError("outage_len must be >= 1")

    @property
    def enabled(self) -> bool:
        return (self.link_drop_p > 0 or self.straggler_p > 0
                or self.outage_p > 0)


def _generator(device: torch.device, stream: str, seed: int, index: int) -> torch.Generator:
    digest = hashlib.blake2b(f"faults-{stream}:{seed}:{index}".encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)  # manual_seed takes < 2**63
    return gen


def fault_keep_matrix(cfg: FaultConfig, rounds: int, k: int, device="cuda"):
    """The round's symmetric (K, K) link keep mask and (K,) node-up vector.

    Both are float32 in {0, 1} on ``device`` (``keep``'s diagonal is
    meaningless); a link is kept iff its own coin passes and both endpoints
    are up.
    """
    dev = resolve_device(device)
    keep = torch.ones((k, k), dtype=torch.float32, device=dev)
    if cfg.link_drop_p > 0:
        u = symmetric_uniform(_generator(dev, "link", cfg.seed, rounds), k)
        keep = keep * (u >= cfg.link_drop_p).float()
    up = torch.ones((k,), dtype=torch.float32, device=dev)
    if cfg.straggler_p > 0:
        us = torch.rand((k,), generator=_generator(dev, "straggler", cfg.seed, rounds),
                        dtype=torch.float32, device=dev)
        up = up * (us >= cfg.straggler_p).float()
    if cfg.outage_p > 0:
        window = rounds // cfg.outage_len
        gen = _generator(dev, "outage", cfg.seed ^ OUTAGE_SEED_XOR, window)
        uo = torch.rand((k,), generator=gen, dtype=torch.float32, device=dev)
        up = up * (uo >= cfg.outage_p).float()
    keep = keep * up[:, None] * up[None, :]
    return keep, up


def replay_fault_masks(cfg: FaultConfig, rounds, k: int, device="cuda"):
    """Replay the fault process for an array of round indices at once.

    The process is a pure function of the round, so a past run's masks
    rebuild exactly from its config on the device that drew them (a CUDA
    generator's bits are not a CPU generator's).  Each round goes through
    :func:`repro_torch.comm.topology.round_fault_masks`, the seam the
    mixers use.  Returns numpy ``(keep (R, K, K), up (R, K))``.
    """
    from repro_torch.comm import topology

    rounds = np.asarray(rounds, np.int64).reshape(-1)
    dev = resolve_device(device)
    masks = [topology.round_fault_masks(cfg, int(r), k, dev) for r in rounds]
    if not masks:
        return np.zeros((0, k, k), np.float32), np.zeros((0, k), np.float32)
    keep = torch.stack([m[0] for m in masks]).cpu().numpy()
    up = torch.stack([m[1] for m in masks]).cpu().numpy()
    return keep, up
