"""Topology layer: the per-round mixing matrix ``W(round)``.

The port of ``repro.comm.topology`` for the static stack: one of the three
composable consensus layers (see ``comm/composed.py``).  Scheduled and star
topologies belong to the dynamics and federated slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class Topology:
    """Per-round mixing-weight provider."""

    k: int

    def round_w(self, rounds) -> torch.Tensor:
        """The (K, K) doubly-stochastic W of round ``rounds``."""
        raise NotImplementedError


class StaticTopology(Topology):
    """A fixed graph: ``round_w`` is constant (float32 on ``device``, which
    defaults to CUDA and raises without it)."""

    def __init__(self, w, device="cuda"):
        w = np.asarray(w, np.float64)
        if w.ndim != 2 or w.shape[0] != w.shape[1]:
            raise ValueError(f"W must be square, got {w.shape}")
        self.k = int(w.shape[0])
        self.w = torch.as_tensor(w, dtype=torch.float32).to(resolve_device(device))

    def round_w(self, rounds) -> torch.Tensor:
        return self.w
