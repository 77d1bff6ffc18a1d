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

The coins are a pure function of (seed, stream, round): one Philox draw
per round on the device (:mod:`repro_torch.dynamics.coins`: the links,
stragglers and outages streams in one launch on the card, the outage
stream at its window ``round // outage_len``), with the round read on the
device from a 0-d int64 tensor, so a captured step draws the faults of the
round it replays.  A run therefore replays the same fault sequence, the
dense and gossip lowerings see the same faults, and the CPU draws the same
masks as the card.  These are not the reference's bits (it folds the round
into a JAX key); the tests hold the sampler on its rates and inject the
reference's replayed masks where they compare arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.protocol import round_tensor
from repro_torch.device import resolve_device
from repro_torch.dynamics import coins
from repro_torch.graphs.mixing import symmetric_uniform


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


def fault_keep_matrix(cfg: FaultConfig, round, k: int, device="cuda"):
    """The round's symmetric (K, K) link keep mask and (K,) node-up vector.

    ``round`` is a 0-d int64 tensor on ``device`` (a host int is filled
    into one).  Both masks are float32 in {0, 1} on ``device`` (``keep``'s
    diagonal is meaningless); a link is kept iff its own coin passes and
    both endpoints are up.  One Philox launch on the card draws every
    enabled stream.
    """
    dev = resolve_device(device)
    r = round_tensor(round, dev)
    streams = [(name, shape, stream, div) for name, p, shape, stream, div in (
        ("link", cfg.link_drop_p, (k, k), coins.LINKS, 1),
        ("straggler", cfg.straggler_p, (k,), coins.STRAGGLERS, 1),
        ("outage", cfg.outage_p, (k,), coins.OUTAGES, cfg.outage_len)) if p > 0]
    drawn = dict(zip([s[0] for s in streams], coins.draw(
        cfg.seed, r, [s[1] for s in streams], [s[2] for s in streams],
        [s[3] for s in streams]))) if streams else {}
    keep = torch.ones((k, k), dtype=torch.float32, device=dev)
    if "link" in drawn:
        keep = keep * (symmetric_uniform(drawn["link"]) >= cfg.link_drop_p).float()
    up = torch.ones((k,), dtype=torch.float32, device=dev)
    if "straggler" in drawn:
        up = up * (drawn["straggler"] >= cfg.straggler_p).float()
    if "outage" in drawn:
        up = up * (drawn["outage"] >= cfg.outage_p).float()
    keep = keep * up[:, None] * up[None, :]
    return keep, up


def replay_fault_masks(cfg: FaultConfig, rounds, k: int, device="cuda"):
    """Replay the fault process for an array of round indices at once.

    The process is a pure function of (seed, round) whose coins are the same
    on every device, so a past run's masks rebuild exactly from its config
    on any device: a card run's masks replay on the CPU.  Each round goes
    through :func:`repro_torch.comm.topology.round_fault_masks`, the seam
    the mixers use.  Returns numpy ``(keep (R, K, K), up (R, K))``.
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
