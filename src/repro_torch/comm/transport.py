"""Transport layer: how a round of public copies moves between nodes.

The port of ``repro.comm.transport`` for one card: one of the three
composable consensus layers (see ``comm/composed.py``).

:class:`DenseTransport` — θ_i ← Σ_j W_ij θ_j as a (K, K) × (K, D) matrix
                          product over the leading node axis: the
                          paper-faithful baseline.

The gossip transport (one node-axis gather per matching of the edge-coloured
graph, with the fused dequantize-accumulate kernel) and the star transport
wait for their slices.
"""

from __future__ import annotations


class Transport:
    """Lowering-structure base: how a round's payloads move."""


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
