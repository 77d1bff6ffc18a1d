"""Transport layer: how a round of public copies moves between nodes.

The port of ``repro.comm.transport`` for one card: one of the three
composable consensus layers (see ``comm/composed.py``).

:class:`DenseTransport`  — θ_i ← Σ_j W_ij θ_j as a (K, K) × (K, D) matrix
                           product over the leading node axis: the
                           paper-faithful baseline.
:class:`GossipTransport` — one node-axis gather per matching of the
                           edge-coloured graph.  The reference runs one
                           ``ppermute`` per matching over a mesh with one
                           node per device; on one card every node is a row
                           of one tensor, so node i's message from its
                           partner is row ``src[i] = perm[i]``.  The
                           reference zero-fills idle nodes; here an idle
                           node reads its own row with weight 0.
                           ``incremental = True``: the receiver keeps a
                           running mix cache, so EF wires own ``hat_mix``.

The star transport (federated) and the hierarchical replica axis wait for
their slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.mixing import MixingDecomposition


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (K,) weight vector to broadcast over a (K, ...) leaf."""
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def gossip_mix_local(theta, self_w, match_ws, srcs):
    """One full-precision gossip round: per leaf
    ``acc = θ·self_w + Σ_m θ[src_m]·w_m`` in float32, cast back to the
    leaf's dtype."""

    def leaf(x):
        acc = x.float() * _bcast(self_w, x)
        for pw, src in zip(match_ws, srcs):
            acc = acc + x[src].float() * _bcast(pw, x)
        return acc.to(x.dtype)

    return {n: leaf(x) for n, x in theta.items()}


class Transport:
    """Lowering-structure base.  ``incremental`` marks transports whose
    receivers keep a running mix cache (EF wires then own ``hat_mix``)."""

    incremental = False


class DenseTransport(Transport):
    """θ_i ← Σ_j W_ij θ_j along the leading node axis, in float32 (the
    reference's ``compute_dtype`` knob is not ported)."""

    def apply_w(self, w, theta):
        """One full-precision dense mixing round under a given W."""
        def leaf(x):
            k = x.shape[0]
            out = w @ x.reshape(k, -1).float()
            return out.reshape(x.shape).to(x.dtype)

        return {n: leaf(x) for n, x in theta.items()}


class GossipTransport(Transport):
    """The matching decomposition on ``device``.

    Holds the frozen float32 decomposition weights (``self_w``,
    ``match_ws``) the static stacks mix with, one ``src`` index tensor per
    matching, and the stacked colouring ``perm_idx`` (M, K) the dynamic
    stacks gather each round's weights through.  The reference's ``mesh``,
    ``node_axis`` and ``param_specs`` mean nothing on one card and are
    dropped.
    """

    incremental = True

    def __init__(self, decomp: MixingDecomposition, device="cuda"):
        dev = resolve_device(device)
        self.decomp = decomp
        self.k = int(decomp.self_weights.shape[0])
        self.self_w = torch.as_tensor(decomp.self_weights, dtype=torch.float32).to(dev)
        self.match_ws = [torch.as_tensor(w, dtype=torch.float32).to(dev)
                         for w in decomp.matching_weights]
        self.perms = decomp.ppermute_pairs()
        perm_idx = np.stack([np.asarray(p, np.int64) for p in decomp.matchings]) \
            if decomp.matchings else np.zeros((0, self.k), np.int64)
        if perm_idx.size and (perm_idx.min() < 0 or perm_idx.max() >= self.k):
            raise ValueError("matching indices out of range")
        self.perm_idx = torch.as_tensor(perm_idx).to(dev)
        self.srcs = list(self.perm_idx.unbind(0))
