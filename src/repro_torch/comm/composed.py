"""ComposedMixer: Topology × Transport × Wire behind the Mixer protocol.

The port of ``repro.comm.composed`` for one card:

==========================  ==============================================
stack                       round body
==========================  ==============================================
none (no transport)         identity (IdentityMixer)
identity × static           base ``Mixer.__call__`` over :meth:`_mix`
identity × scheduled×dense  :meth:`_dynamic_dense_call` (W_r product,
                            active-link wire accounting)
identity × scheduled×gossip :meth:`_dynamic_gossip_call` (gathered
                            per-round vectors, plain or masked-quant wire)
codec × dense               :meth:`_dense_round` (static or per-round W)
codec × gossip (static)     :meth:`_gossip_round` (no overrides)
choco+clock × sched×gossip  :meth:`_clocked_gossip_call` (delta/re-base
                            two-mode round on ``ef_rounds``)
==========================  ==============================================

A codec wire with a rate schedule takes the round's rate (a 0-d tensor on
the device, from ``res_norm``, ``res_ref`` and ``rounds``) into its encode
pass and its consensus step γ, advances ``res_ref`` after the round and
bills the round's ``wire_bits`` at that rate (``traced_wire``).

Where the reference runs one ``ppermute`` per matching inside
``shard_map``, the port gathers along the node axis (``src`` per matching;
``comm/transport.py``).  The reference's ``lax.cond`` on the re-base clock
becomes a host branch on the host int ``ef_rounds``; the adaptive re-base
reads the cache drift on the host, one sync per round.  The star transport,
the hierarchical replica axis and fault replay wait for their slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.protocol import (
    CommState,
    Mixer,
    params_device,
    scalar,
    trivial_comm_state,
)
from repro_torch.comm.topology import (
    Topology,
    active_links,
    active_sends,
    gather_round_vectors,
)
from repro_torch.comm.transport import (
    DenseTransport,
    GossipTransport,
    Transport,
    gossip_mix_local,
)
from repro_torch.comm.wire import (
    CodecWire,
    MaskedQuantWire,
    Wire,
    _leaf_payload_bytes,
    _send_mask,
    wire_bits,
)
from repro_torch.utils.tree import leaf_names, tree_bytes


def _step(xf, gamma, delta):
    """θ + γ·Δ; a host γ = 1 (the quantizers' default) adds Δ as it is."""
    if isinstance(gamma, float) and gamma == 1.0:  # repro: noqa[RPR001] (a host float)
        return xf + delta
    return xf + gamma * delta


def _gather_payload(payload, src):
    """The payload rows each node receives (the one-card ``ppermute``)."""
    if isinstance(payload, tuple):
        return tuple(p[src] for p in payload)
    return payload[src]


class ComposedMixer(Mixer):
    """One consensus operator over a (topology, transport, wire) stack.

    ``topology=None`` + ``transport=None`` is the no-communication stack
    (IdentityMixer); ``topology=None`` with a gossip transport is the
    static-gossip stack (the W lives frozen in the decomposition weights).
    """

    def __init__(self, topology: Topology | None, transport: Transport | None,
                 wire: Wire):
        self.topo = topology
        self.transport = transport
        self.wire = wire
        self._dynamic = topology is not None and topology.time_varying
        self._is_gossip = isinstance(transport, GossipTransport)
        if topology is not None:
            self.k = topology.k
        elif transport is not None:
            self.k = transport.k
        if isinstance(transport, DenseTransport) and not self._dynamic:
            # the static W is cast once to the transport's compute dtype
            self.w = topology.round_w(0).to(transport.compute_dtype)
        if self._is_gossip and self._dynamic and topology.k != transport.k:
            raise ValueError(f"topology K={topology.k} != transport K={transport.k}")
        if isinstance(wire, CodecWire):
            if transport is None:
                raise ValueError("a codec wire needs a transport")
            self.compressor = wire.compressor
            self.ef = wire.ef
            clock = getattr(wire, "clock", None)
            if clock is not None:
                if not (self._is_gossip and self._dynamic):
                    raise ValueError(
                        "the delta/re-base clock serves the dynamic gossip "
                        "stack (incremental hat_mix cache); dense re-mixes "
                        "the full public-copy matrix every round")
                self.adaptive = clock.adaptive
                self.ef_rebase_every = int(clock.every)
                self.ef_rebase_threshold = float(clock.threshold)
        elif isinstance(wire, MaskedQuantWire):
            if not (self._is_gossip and self._dynamic):
                raise ValueError(
                    "the masked quant wire rides the dynamic gossip "
                    "transport (per-round link masks)")

    @property
    def compression(self):
        return self.wire.compression

    @property
    def traced_wire(self) -> bool:
        return self._dynamic or self.wire.traced_wire

    def _round_w(self, state: CommState) -> torch.Tensor:
        """The W of the codec-dense round about to run: static, or the
        schedule's matrix for this round (EF composes with a moving W on
        this lowering because it re-mixes the full public copies)."""
        if self._dynamic:
            return self.topo.round_w(state.rounds)
        return self.w

    def _senders(self, w):
        """Wire-accounting senders: every node on the static dense
        broadcast model; active directed links of W_r on dynamic stacks."""
        if self._dynamic:
            return active_links(w)
        return self.k

    # -- state ----------------------------------------------------------------

    def init_state(self, params) -> CommState:
        state = trivial_comm_state(device=params_device(params))
        fields = self.wire.init_fields(
            params, incremental=self.transport is not None and self.transport.incremental)
        return state._replace(**fields) if fields else state

    # -- accounting ------------------------------------------------------------

    def _sends(self) -> int:
        return sum(len(pairs) for pairs in self.transport.perms)

    def bytes_per_round(self, params) -> int:
        """Static estimate of wire bytes one consensus round injects (the
        per-round ``CommState.wire_bits`` is authoritative for dynamic
        stacks)."""
        t = self.transport
        if t is None:
            return 0
        if isinstance(self.wire, MaskedQuantWire):
            per_node = sum(self.wire.leaf_bits(x.numel() // self.k)
                           for x in params.values()) / 8.0
            return round(self._sends() * per_node)
        if isinstance(self.wire, CodecWire):
            q = _leaf_payload_bytes(self.compressor, params, self.k)
            if not self._is_gossip:
                # dense codec: every node injects its payload once
                return self.k * q
            sends = self._sends()
            clock = getattr(self.wire, "clock", None)
            if clock is None:
                return sends * q
            # clocked EF: fault-free amortized estimate over the full union
            # support — ((B−1)·compressed + 1·f32 re-base)/B per link
            full = 4 * sum(x.numel() // self.k for x in params.values())
            b = max(clock.every, 1) if clock.adaptive else clock.every
            if b == 0:
                return sends * q
            if b == 1:
                return sends * full
            return round(sends * ((b - 1) * q + full) / b)
        if isinstance(t, DenseTransport):
            if self._dynamic:
                try:
                    sends = int(np.count_nonzero(self.topo.base_weights()) - self.k)
                except ValueError:  # moving support: assume complete
                    sends = self.k * (self.k - 1)
                return sends * tree_bytes(params) // self.k
            # uncompressed static dense: every node injects its block once
            return tree_bytes(params)
        return self._sends() * tree_bytes(params) // self.k

    # -- pure application (identity-wire bodies) -------------------------------

    def _mix(self, theta):
        t = self.transport
        if t is None:
            return theta
        if isinstance(t, DenseTransport):
            return t.apply_w(self.w, theta)
        return gossip_mix_local(theta, t.self_w, t.match_ws, t.srcs)

    def mix_tree(self, tree, state: CommState):
        """Consensus applied to an arbitrary dict with this round's topology
        (no state advance, no codec).  Codec wires do not implement this."""
        if isinstance(self.wire, CodecWire):
            raise NotImplementedError
        if self._dynamic:
            w = self.topo.round_w(state.rounds)
            if isinstance(self.transport, DenseTransport):
                return self.transport.apply_w(w, tree)
            self_w, match_ws, _ = gather_round_vectors(w, self.transport.perm_idx)
            return gossip_mix_local(tree, self_w, match_ws, self.transport.srcs)
        return self._mix(tree)

    # -- the protocol ----------------------------------------------------------

    def __call__(self, theta, state: CommState, *, round=None):
        if isinstance(self.wire, CodecWire):
            if self._is_gossip and getattr(self.wire, "clock", None) is not None:
                return self._clocked_gossip_call(theta, state)
            if self._is_gossip:
                return self._gossip_round(theta, state)
            return self._dense_round(theta, state)
        if self._dynamic:
            if self._is_gossip:
                return self._dynamic_gossip_call(theta, state)
            return self._dynamic_dense_call(theta, state)
        return super().__call__(theta, state, round=round)

    # -- identity-wire dynamic rounds ------------------------------------------

    def _dynamic_dense_call(self, theta, state: CommState):
        w = self.topo.round_w(state.rounds)
        mixed = self.transport.apply_w(w, theta)
        per_node_bits = 8.0 * (tree_bytes(theta) // self.k)
        return mixed, state._replace(rounds=state.rounds + 1,
                                     wire_bits=active_links(w) * per_node_bits)

    def _dynamic_gossip_call(self, theta, state: CommState):
        t = self.transport
        w = self.topo.round_w(state.rounds)
        self_w, match_ws, masks = gather_round_vectors(w, t.perm_idx)
        if isinstance(self.wire, MaskedQuantWire):
            mixed = self._quantized_gossip(theta, state, self_w, match_ws, masks)
            per_node_bits = sum(self.wire.leaf_bits(x.numel() // self.k)
                                for x in theta.values())
        else:
            mixed = gossip_mix_local(theta, self_w, match_ws, t.srcs)
            per_node_bits = 8.0 * (tree_bytes(theta) // self.k)
        return mixed, state._replace(rounds=state.rounds + 1,
                                     wire_bits=active_sends(masks) * per_node_bits)

    def _quantized_gossip(self, theta, state, self_w, match_ws, masks):
        """Every matching, every leaf at once: masked quantize of θ with fresh
        uniforms per (leaf, matching), gather, masked dequantize-accumulate
        (one B.4 and one B.5 launch per matching on the card).  The leaves
        are independent, so this is the leaf-by-leaf round bit for bit."""
        from repro_torch.kernels.quant_gossip.ops import (
            masked_dequant_accumulate_grouped_,
            masked_quantize_blockwise_grouped,
        )

        wire = self.wire
        names = leaf_names(theta)
        xfs = [theta[n].reshape(theta[n].shape[0], -1).float() for n in names]
        accs = [xf * self_w[:, None] for xf in xfs]
        qmax, block_d = float(wire._qmax), wire.quantized.block_d
        for m, (pw, mk, src) in enumerate(zip(match_ws, masks, self.transport.srcs)):
            us = [wire.uniforms(state.key, state.rounds, i, m, xf) for i, xf in enumerate(xfs)]
            payloads = masked_quantize_blockwise_grouped(xfs, us, mk, qmax=qmax,
                                                         block_d=block_d)
            masked_dequant_accumulate_grouped_(accs, payloads, pw, mk, src=src)
        return {n: acc.reshape(theta[n].shape).to(theta[n].dtype)
                for n, acc in zip(names, accs)}

    # -- codec-wire rounds -----------------------------------------------------

    def _dense_round(self, theta, state: CommState):
        """One compressed dense round: every node encodes each leaf (its
        innovation against θ̂ in EF mode) at the round's rate, the public
        copies are mixed by W, and θ moves by γ(Σ_j W_ij θ̂_j − θ̂_i).  An
        encode pass over every leaf (one B.2 launch on the card, a
        schedule's rate read there), then a mix pass; the uniforms are drawn
        per (key, round, leaf), so this is the leaf-by-leaf round bit for
        bit."""
        w = self._round_w(state)
        rate = self.wire.rate(state)
        gamma = self.wire.gamma_for(rate)
        names = leaf_names(theta)
        xfs, hats, res_sq = self._flat_leaves(theta, state, w.device)
        us = [self.wire.uniforms(state.key, state.rounds, i, xf) for i, xf in enumerate(xfs)]
        encoded = self.wire.encode_leaves(xfs, hats, us, rate)
        out_theta, out_hat = {}, {}
        for name, xf, (_, public, new_hat) in zip(names, xfs, encoded):
            shape = theta[name].shape
            out = _step(xf, gamma, w @ public - public)
            out_theta[name] = out.reshape(shape).to(theta[name].dtype)
            if self.ef:
                out_hat[name] = new_hat.reshape(shape)
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq))
        # _replace, not CommState(...): fields this round does not own must
        # thread through untouched
        return out_theta, state._replace(
            hat=out_hat if self.ef else (), res_norm=res_norm, res_ref=res_ref,
            rounds=rounds, wire_bits=self.wire.round_wire_bits(
                theta, rate, self._senders(w), self.k, w.device))

    def _gossip_round(self, theta, state: CommState, *, self_w=None,
                      match_ws=None, masks=None, senders=None):
        """One compressed gossip round over the matching decomposition.

        The static stack calls this with no overrides (frozen decomposition
        weights, every matching link active).  The clocked dynamic stack
        passes the per-round vectors gathered from W_r: ``self_w`` (K,),
        ``match_ws``/``masks`` per matching, and the active-link count
        ``senders`` for wire accounting.  With all-ones masks the masked
        paths are bit-identical to the unmasked ones.
        """
        t = self.transport
        ef = self.ef
        if self_w is None:
            self_w = t.self_w
        if match_ws is None:
            match_ws = t.match_ws
        rate = self.wire.rate(state)
        gamma = self.wire.gamma_for(rate)
        send = _send_mask(masks) if masks is not None else None
        names = leaf_names(theta)
        xfs, hats, res_sq = self._flat_leaves(theta, state, self_w.device)
        us = [self.wire.uniforms(state.key, state.rounds, i, xf) for i, xf in enumerate(xfs)]
        # encode pass: every leaf (one B.2 launch per round, B.4 where masked)
        encoded = self.wire.encode_leaves(xfs, hats, us, rate, send_mask=send)
        # EF: s_i += W_ii q_i + Σ_m W_i,src(i)·dequant(recv) keeps
        # s_i = Σ_j W_ij θ̂_j current; memoryless: the same combine of the
        # fresh C(θ) messages.  Only the payload crosses the wire.
        if ef:
            accs = [state.hat_mix[n].reshape(xf.shape) + self_w[:, None] * (public - h)
                    for n, xf, h, (_, public, _) in zip(names, xfs, hats, encoded)]
        else:
            accs = [self_w[:, None] * public for _, public, _ in encoded]
        payloads = [payload for payload, _, _ in encoded]
        # accumulate pass: per matching, every leaf (one B.3 launch on the
        # static wire, one B.5 where masked)
        for m, (pw, src) in enumerate(zip(match_ws, t.srcs)):
            accs = self._accumulate_leaves(accs, payloads, pw, src,
                                           mask=masks[m] if masks is not None else None)
        out_theta, out_hat, out_mix = {}, {}, {}
        for n, xf, acc, (_, public, new_hat) in zip(names, xfs, accs, encoded):
            shape = theta[n].shape
            out_theta[n] = _step(xf, gamma, acc - public).reshape(shape).to(theta[n].dtype)
            if ef:
                out_hat[n] = new_hat.reshape(shape)
                out_mix[n] = acc.reshape(shape)
        if senders is None:
            senders = self._sends()
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq))
        # _replace so fields this round does not own thread through
        return out_theta, state._replace(
            hat=out_hat if ef else (), hat_mix=out_mix if ef else (),
            res_norm=res_norm, res_ref=res_ref, rounds=rounds,
            wire_bits=self.wire.round_wire_bits(theta, rate, senders, self.k, res_sq.device))

    def _flat_leaves(self, theta, state, device):
        """Each leaf as a (K, d) float32 block, its θ̂ block (EF wires; None
        otherwise), and the EF residual ‖θ − θ̂‖² summed in leaf order."""
        xfs, hats = [], []
        res_sq = torch.zeros((), dtype=torch.float32, device=device)
        for name in leaf_names(theta):
            x = theta[name]
            k = x.shape[0]
            xf = x.reshape(k, -1).float()
            h = state.hat[name].reshape(k, -1) if self.ef else None
            if self.ef:
                res_sq = res_sq + (xf - h).square().sum()
            xfs.append(xf)
            hats.append(h)
        return xfs, hats, res_sq

    def _accumulate_leaves(self, accs, payloads, weight, src, mask=None):
        """:meth:`_accumulate` of every leaf; the kernel quantizer
        accumulates every leaf in place in one call (B.3 without a mask, B.5
        with one).  In place is safe: :meth:`_gossip_round` builds each acc
        afresh every round, and nothing else holds it until the round ends."""
        if mask is None:
            grouped = getattr(self.compressor, "accumulate_grouped_", None)
            if grouped is not None:
                return grouped(accs, payloads, weight, src)
        else:
            grouped = getattr(self.compressor, "accumulate_masked_grouped_", None)
            if grouped is not None:
                return grouped(accs, payloads, weight, mask, src)
        return [self._accumulate(acc, p, weight, src, mask) for acc, p in zip(accs, payloads)]

    def _accumulate(self, acc, payload, weight, src, mask=None):
        """acc + weight·dequant(payload[src]), with an optional link mask.

        ``mask`` (K,) in {0, 1}: masked links contribute exactly acc.  The
        kernel quantizer fuses the gather and the combine (one leaf: B.3 on
        the card; every leaf at once: :meth:`_accumulate_leaves`); other
        codecs gather the payload rows and decompress.
        """
        if mask is None:
            fused = getattr(self.compressor, "accumulate", None)
            if fused is not None:
                return fused(acc, payload, weight, src)
            recv = _gather_payload(payload, src)
            return acc + weight[:, None] * self.compressor.decompress(recv, acc.shape[1])
        recv = _gather_payload(payload, src)
        return acc + (weight * mask)[:, None] * self.compressor.decompress(
            recv, acc.shape[1])

    # -- the clocked EF gossip stack (delta / re-base two-mode) ----------------

    def _cache_drift(self, w, hat, hat_mix) -> torch.Tensor:
        """‖s − W θ̂‖_F over all leaves: the exact staleness of the
        incremental cache under the round's topology (adaptive mode only)."""
        total = torch.zeros((), dtype=torch.float32, device=w.device)
        for name in leaf_names(hat):
            hf = hat[name].reshape(self.k, -1)
            sf = hat_mix[name].reshape(self.k, -1)
            total = total + (sf - w @ hf).square().sum()
        return torch.sqrt(total)

    def _clocked_gossip_call(self, theta, state: CommState):
        w = self.topo.round_w(state.rounds)
        self_w, match_ws, masks = gather_round_vectors(w, self.transport.perm_idx)
        senders = active_sends(masks)
        if self.adaptive:
            # drift-triggered re-base: measure the cache staleness against
            # this round's W before mixing.  PyTorch runs eagerly, so the
            # branch reads the drift on the host: one sync per round.
            drift = self._cache_drift(w, state.hat, state.hat_mix)
            rebase = float(drift) > self.ef_rebase_threshold  # repro: noqa[RPR002]
        else:
            b = self.ef_rebase_every
            rebase = b == 1 or (b >= 2 and state.ef_rounds % b == b - 1)
        if rebase:  # repro: noqa[RPR001] (a host bool: eager torch, see above)
            t2, s2 = self._rebase_round(theta, state, self_w, match_ws, masks, senders)
        else:
            t2, s2 = self._gossip_round(theta, state, self_w=self_w, match_ws=match_ws,
                                        masks=masks, senders=senders)
        if self.adaptive:
            s2 = s2._replace(ef_drift=drift)
        return t2, s2._replace(ef_rounds=state.ef_rounds + 1)

    def _rebase_round(self, theta, state: CommState, self_w, match_ws, masks, senders):
        """Codec step + full-precision θ̂ exchange rebuilding the cache.

        The innovation is still encoded (θ̂ must keep tracking θ; masked
        senders stay frozen) but the quantized payload does not cross the
        wire this round — the matchings move the fresh public copies
        instead, and s_i = Σ_j W_ij(r) θ̂_j is exact under the current W.
        """
        send = _send_mask(masks)
        srcs = self.transport.srcs
        rate = self.wire.rate(state)
        gamma = self.wire.gamma_for(rate)
        names = leaf_names(theta)
        xfs, hats, res_sq = self._flat_leaves(theta, state, self_w.device)
        us = [self.wire.uniforms(state.key, state.rounds, i, xf) for i, xf in enumerate(xfs)]
        encoded = self.wire.encode_leaves(xfs, hats, us, rate, send_mask=send)
        out_theta, out_hat, out_mix = {}, {}, {}
        for n, xf, (_, _, new_hat) in zip(names, xfs, encoded):
            acc = self_w[:, None] * new_hat
            for pw, mk, src in zip(match_ws, masks, srcs):
                acc = acc + (pw * mk)[:, None] * new_hat[src]
            shape = theta[n].shape
            out_theta[n] = _step(xf, gamma, acc - new_hat).reshape(shape).to(theta[n].dtype)
            out_hat[n] = new_hat.reshape(shape)
            out_mix[n] = acc.reshape(shape)
        # full-precision wire: active links × per-node f32 payload
        full_bits = 32.0 * sum(x.numel() // self.k for x in theta.values())
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq))
        return out_theta, state._replace(
            hat=out_hat, hat_mix=out_mix, res_norm=res_norm, res_ref=res_ref,
            rounds=rounds, wire_bits=wire_bits(senders, full_bits, None))
