"""ComposedMixer: Topology × Transport × Wire behind the Mixer protocol.

The port of ``repro.comm.composed`` for the stacks one card runs today:

==========================  ==============================================
stack                       round body
==========================  ==============================================
none (no transport)         identity (IdentityMixer)
identity × static × dense   base ``Mixer.__call__`` over :meth:`_mix`
codec × static × dense      :meth:`_dense_round` (memoryless or CHOCO EF)
==========================  ==============================================

The layer split is kept so that later slices (the gossip transport, dynamic
topologies, the hub) extend it rather than rewrite it; a stack this slice
does not run raises at construction.
"""

from __future__ import annotations

import torch

from repro_torch.comm.protocol import (
    CommState,
    Mixer,
    params_device,
    scalar,
    trivial_comm_state,
)
from repro_torch.comm.topology import Topology
from repro_torch.comm.transport import Transport
from repro_torch.comm.wire import CodecWire, Wire, _leaf_payload_bytes
from repro_torch.utils.tree import leaf_names, tree_bytes


class ComposedMixer(Mixer):
    """One consensus operator over a (topology, transport, wire) stack.

    ``topology=None`` + ``transport=None`` is the no-communication stack
    (IdentityMixer).
    """

    def __init__(self, topology: Topology | None, transport: Transport | None,
                 wire: Wire):
        if isinstance(wire, CodecWire) and transport is None:
            raise ValueError("a codec wire needs a transport")
        self.topo = topology
        self.transport = transport
        self.wire = wire
        if topology is not None:
            self.k = topology.k
            self.w = topology.round_w(0)
        if isinstance(wire, CodecWire):
            self.compressor = wire.compressor
            self.ef = wire.ef

    @property
    def compression(self):
        return self.wire.compression

    # -- state ----------------------------------------------------------------

    def init_state(self, params) -> CommState:
        state = trivial_comm_state(device=params_device(params))
        fields = self.wire.init_fields(params)
        return state._replace(**fields) if fields else state

    # -- accounting ------------------------------------------------------------

    def bytes_per_round(self, params) -> int:
        """Static estimate of wire bytes one consensus round injects."""
        if self.transport is None:
            return 0
        if isinstance(self.wire, CodecWire):
            # dense codec: every node injects its payload once
            return self.k * _leaf_payload_bytes(self.compressor, params, self.k)
        # uncompressed static dense: every node injects its block once
        return tree_bytes(params)

    def _round_wire_bits(self, params, senders: int) -> int:
        return self.wire.round_wire_bits(params, senders, self.k)

    # -- pure application -------------------------------------------------------

    def _mix(self, theta):
        if self.transport is None:
            return theta
        return self.transport.apply_w(self.w, theta)

    # -- the protocol ----------------------------------------------------------

    def __call__(self, theta, state: CommState, *, round=None):
        if isinstance(self.wire, CodecWire):
            return self._dense_round(theta, state)
        return super().__call__(theta, state, round=round)

    def _dense_round(self, theta, state: CommState):
        """One compressed dense round: every node encodes each leaf (its
        innovation against θ̂ in EF mode), the public copies are mixed by W,
        and θ moves by γ(Σ_j W_ij θ̂_j − θ̂_i) with the quantizers' γ = 1."""
        w = self.w
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
        # _replace, not CommState(...): fields this round does not own must
        # thread through untouched
        return out_theta, state._replace(
            hat=out_hat if self.ef else (),
            res_norm=torch.sqrt(res_sq), rounds=state.rounds + 1,
            wire_bits=scalar(self._round_wire_bits(theta, senders=self.k),
                             w.device))
