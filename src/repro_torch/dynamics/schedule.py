"""Time-varying topology schedules: one mixing matrix per round.

The port of ``repro.dynamics.schedule``.  A :class:`TopologySchedule` maps
the round counter to the round's doubly-stochastic (K, K) mixing matrix
``W_r``, a float32 tensor on the schedule's device (the reference's traced
operand).  The schedule's W is the single source of truth for both
consensus lowerings: the dense mixer multiplies by it, and the gossip mixer
gathers per-matching edge weights out of it along the static edge
colouring of the union support, so the two lowerings see the same weights
each round.

* :class:`StaticSchedule`      — constant W.
* :class:`RoundRobinSchedule`  — round r runs only matching ``r % M`` of
  the edge colouring.
* :class:`DropoutSchedule`     — iid Bernoulli link dropout at rate ``p``
  on a static base graph, renormalized on the device; ``p = 0`` is
  bit-identical to :class:`StaticSchedule`.
* :class:`GeometricRedrawSchedule` — nodes re-draw positions on the unit
  square every round and connect within ``radius``; Metropolis weights are
  re-derived on the device.  Dense lowering only (the support moves).

Randomness is a pure function of (seed, round): round r's coins are one
Philox draw on the device (:mod:`repro_torch.dynamics.coins`), the round
read there from a 0-d int64 tensor, so a run replays the same topology
sequence, a captured step draws the W_r of the round it replays, and the
CPU draws the same W_r as the card.  ``round_weights`` takes that tensor
(a host int is filled into one).  These are not the reference's bits (it
folds the round into a JAX key); the tests hold the sampler on its rates
and inject the reference's W_r where they compare arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.protocol import round_tensor
from repro_torch.device import resolve_device
from repro_torch.dynamics import coins
from repro_torch.graphs.mixing import (
    MixingDecomposition,
    metropolis_weights_traced,
    permutation_decomposition,
    renormalize_masked_weights,
    symmetric_uniform,
)


class TopologySchedule:
    """Protocol: per-round mixing matrix on ``device``.

    Attributes:
      k: node count.
      device: where ``round_weights`` puts W_r.
      static_support: True when supp(W_r) ⊆ supp(base W) for every round —
        the condition for the gossip lowering (static matchings, per-round
        weights).  Schedules whose support moves (geometric re-draws) are
        dense-only.
      seed: seed of the schedule's own randomness (dropout coins, re-draws).
    """

    k: int
    device: torch.device
    static_support = True
    seed = 0

    def round_weights(self, round) -> torch.Tensor:
        """The (K, K) doubly-stochastic W of round ``round`` (a 0-d int64
        tensor on ``device``; a host int is filled into one)."""
        raise NotImplementedError

    def base_weights(self) -> np.ndarray:
        """A static W whose support contains every round's support (used to
        build the gossip decomposition and for static byte estimates)."""
        raise NotImplementedError

    def decomposition(self) -> MixingDecomposition:
        """Edge colouring of the union support (gossip lowering structure)."""
        if not self.static_support:
            raise ValueError(
                f"{type(self).__name__} re-draws its support every round; "
                "only the dense lowering can run it")
        return permutation_decomposition(self.base_weights())


class StaticSchedule(TopologySchedule):
    """Constant topology — the frozen-graph baseline as a schedule."""

    def __init__(self, w: np.ndarray, *, device="cuda"):
        self._w_np = np.asarray(w, np.float64)
        self.device = resolve_device(device)
        self.w = torch.as_tensor(self._w_np, dtype=torch.float32).to(self.device)
        self.k = int(self.w.shape[0])

    def round_weights(self, round) -> torch.Tensor:
        return self.w

    def base_weights(self) -> np.ndarray:
        return self._w_np


class RoundRobinSchedule(TopologySchedule):
    """One matching of the edge colouring per round, cycled round-robin.

    Round r exchanges only along matching ``r % M`` (picked out of the
    stack on the device); the matched pairs keep their base pairwise weight
    and return the unmatched mass to the diagonal, so each W_r is doubly
    stochastic.
    """

    def __init__(self, w: np.ndarray, *, device="cuda"):
        self._w_np = np.asarray(w, np.float64)
        self.device = resolve_device(device)
        self.k = int(self._w_np.shape[0])
        decomp = permutation_decomposition(self._w_np)
        self._decomp = decomp
        mats = []
        for perm, pw in zip(decomp.matchings, decomp.matching_weights):
            m = np.zeros((self.k, self.k), np.float64)
            for i in range(self.k):
                j = int(perm[i])
                if j != i:
                    m[i, j] = pw[i]
            np.fill_diagonal(m, 1.0 - m.sum(axis=1))
            mats.append(m)
        # (M, K, K) static stack; a round picks one
        self._stack = torch.as_tensor(np.stack(mats), dtype=torch.float32).to(self.device)

    @property
    def num_matchings(self) -> int:
        return int(self._stack.shape[0])

    def round_weights(self, round) -> torch.Tensor:
        r = round_tensor(round, self.device)
        # a (1,) index (a 0-d index would be read on the host)
        idx = torch.remainder(r, self._stack.shape[0]).reshape(1)
        return torch.index_select(self._stack, 0, idx)[0]

    def base_weights(self) -> np.ndarray:
        return self._w_np

    def decomposition(self) -> MixingDecomposition:
        return self._decomp


class DropoutSchedule(TopologySchedule):
    """Bernoulli link dropout on a static base W, renormalized on the device.

    Every link of the base graph fails independently with probability ``p``
    each round; the dropped weight returns to the incident diagonals.
    ``p = 0`` reproduces the static schedule bit-exactly.
    """

    def __init__(self, w: np.ndarray, p: float, seed: int = 0, *, device="cuda"):
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self._w_np = np.asarray(w, np.float64)
        self.device = resolve_device(device)
        self.w = torch.as_tensor(self._w_np, dtype=torch.float32).to(self.device)
        self.k = int(self.w.shape[0])
        self.p = float(p)
        self.seed = seed

    def round_weights(self, round) -> torch.Tensor:
        if self.p == 0.0:
            return self.w
        r = round_tensor(round, self.device)
        u = symmetric_uniform(coins.draw(self.seed, r, [(self.k, self.k)], [coins.DROPOUT])[0])
        keep = (u >= self.p).float()
        return renormalize_masked_weights(self.w, keep)

    def base_weights(self) -> np.ndarray:
        return self._w_np


class GeometricRedrawSchedule(TopologySchedule):
    """Random geometric graph re-drawn every round (mobile/wireless nodes).

    Each round the K nodes take fresh uniform positions on the unit square
    and connect within ``radius``; Metropolis weights are derived on the
    device.  Rounds may be disconnected — consensus relies on connectivity
    over time.  Dense lowering only (the support moves).
    """

    static_support = False

    def __init__(self, k: int, radius: float = 0.5, seed: int = 0, *, device="cuda"):
        if k < 2:
            raise ValueError("need K >= 2 nodes")
        if not 0.0 < radius <= np.sqrt(2.0):
            raise ValueError(f"radius must be in (0, sqrt(2)], got {radius}")
        self.k = int(k)
        self.radius = float(radius)
        self.seed = seed
        self.device = resolve_device(device)

    def round_weights(self, round) -> torch.Tensor:
        r = round_tensor(round, self.device)
        pts = coins.draw(self.seed, r, [(self.k, 2)], [coins.GEOMETRIC])[0]
        d2 = (pts[:, None, :] - pts[None, :, :]).square().sum(dim=-1)
        adj = (d2 < self.radius ** 2).float()
        adj = adj * (1.0 - torch.eye(self.k, dtype=torch.float32, device=self.device))
        return metropolis_weights_traced(adj)

    def base_weights(self) -> np.ndarray:
        raise ValueError("geometric re-draw has no static base support")


# the schedules the port defines: each reads the round on the device
PORT_SCHEDULES = (StaticSchedule, RoundRobinSchedule, DropoutSchedule, GeometricRedrawSchedule)


def make_schedule(kind: str, *, w: np.ndarray | None = None,
                  k: int | None = None, drop_p: float = 0.0,
                  radius: float = 0.5, seed: int = 0,
                  device="cuda") -> TopologySchedule:
    """Build a schedule by name (the ``--topology`` CLI entry point)."""
    if kind == "static":
        return StaticSchedule(w, device=device)
    if kind == "round_robin":
        return RoundRobinSchedule(w, device=device)
    if kind == "dropout":
        return DropoutSchedule(w, drop_p, seed=seed, device=device)
    if kind == "geometric":
        return GeometricRedrawSchedule(k if k is not None else w.shape[0],
                                       radius=radius, seed=seed, device=device)
    raise ValueError(f"unknown topology schedule {kind!r}; options: "
                     "static, round_robin, dropout, geometric")
