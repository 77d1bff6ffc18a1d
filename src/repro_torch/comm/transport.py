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
:class:`StarTransport`   — hub-and-spoke: every node uploads its block to a
                           (virtual) server and downloads the exact mean —
                           the federated server-averaging round, simulated
                           as a node-axis mean.  Wire model: 2K × per-node
                           payload (up + down).

The hierarchical replica axis waits for its slice (it is multi-device).
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
    """θ_i ← Σ_j W_ij θ_j along the leading node axis.

    The leaves are cast to ``compute_dtype`` (float32 by default) before the
    product, and the product runs in the promotion of W's dtype and that
    one, as the reference's einsum promotes: the static W is cast once to
    ``compute_dtype`` (bfloat16 throughout), a time-varying float32 W_r
    multiplies the bfloat16-rounded leaves in float32.
    """

    def __init__(self, compute_dtype=torch.float32):
        self.compute_dtype = compute_dtype

    def apply_w(self, w, theta):
        """One full-precision dense mixing round under a given W."""
        dtype = torch.promote_types(w.dtype, self.compute_dtype)

        def leaf(x):
            k = x.shape[0]
            xc = x.reshape(k, -1).to(self.compute_dtype).to(dtype)
            out = w.to(dtype) @ xc
            return out.reshape(x.shape).to(x.dtype)

        return {n: leaf(x) for n, x in theta.items()}


class StarTransport(Transport):
    """Hub-and-spoke server averaging, simulated as an exact node mean.

    ``apply`` is the ``W = 11ᵀ/K`` product computed as a mean over the node
    axis in float32, written to every node and cast back to each leaf's
    dtype (each output leaf owns its storage).
    """

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"star transport needs k >= 1, got {k}")
        self.k = int(k)

    def apply(self, theta):
        def leaf(x):
            avg = x.float().mean(dim=0, keepdim=True)
            return avg.expand(x.shape).to(x.dtype).contiguous()

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
