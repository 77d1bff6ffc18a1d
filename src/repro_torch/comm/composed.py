"""ComposedMixer: Topology × Transport × Wire behind the Mixer protocol.

The port of ``repro.comm.composed`` for one card:

==========================  ==============================================
stack                       round body
==========================  ==============================================
none (no transport)         identity (IdentityMixer)
identity × static           base ``Mixer.__call__`` over :meth:`_mix`
                            (dense W product, gossip, or the star mean)
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
the device, from ``res_norm``, ``res_ref`` and the schedule's host part of
the round) into its encode pass and its consensus step γ, advances
``res_ref`` after the round and bills the round's ``wire_bits`` at that
rate (``traced_wire``).

No round reads anything on the host that changes from round to round:
each takes the round as a :class:`~repro_torch.comm.protocol.RoundClock`
(the round as a 0-d int64, at which the wire's noise, the schedule's W_r
and the fault coins are drawn on the device, and the schedule's host part
as a 0-d float32), which ``__call__`` fills from ``CommState.rounds``
unless the caller passes it (the trainer's captured step packs it per
step).  With ``inplace=True`` the static codec rounds write the new
parameters into the leaves of ``theta`` and the dense round its new θ̂
into the leaves of ``CommState.hat``, where the trainer's captured step
holds its state: the same operations, so the same bits, without a second
copy of either.

Where the reference runs one ``ppermute`` per matching inside
``shard_map``, the port gathers along the node axis (``src`` per matching;
``comm/transport.py``).  The reference's ``lax.cond`` on the re-base clock
becomes a branch the host chooses from the host int ``ef_rounds``
(:meth:`ComposedMixer.plan`, passed in as ``branch``: one captured graph
per branch); the adaptive re-base runs the encode once, both
accumulations, and selects θ, the mix cache and the wire bits on the
device with ``torch.where`` on the drift (no sync).  The star transport
(the hub) runs the identity wire as an exact node mean; codec wires on the
hub ride the dense transport with the star W (``make_hub_mixer``).  Fault
replay lives in the scheduled topology, so every dynamic stack above mixes
with the faulted W_r.  The hierarchical replica axis waits for its slice.

Each round runs inside an ``obs:consensus/<class name>`` profiler range.
The sanitizer (``repro_torch.analysis.sanitize``) duck-types on the
reference's hooks: the *instance* attributes ``_round_topology_w``
(time-varying stacks only) and ``_round_vectors`` (dynamic gossip with the
identity or masked wire only), ``w`` (static dense and hub stacks) and
:meth:`ComposedMixer._rate`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.comm.protocol import (
    CommState,
    Mixer,
    RoundClock,
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
    StarTransport,
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
from repro_torch.obs.profiler import scope
from repro_torch.utils.tree import leaf_names, tree_bytes


def _step(xf, gamma, delta):
    """θ + γ·Δ; a host γ = 1 (the quantizers' default) adds Δ as it is."""
    if isinstance(gamma, float) and gamma == 1.0:  # repro: noqa[RPR001] (a host float)
        return xf + delta
    return xf + gamma * delta


def _stepped(x, xf, gamma, delta, inplace: bool):
    """θ + γ·Δ in ``x``'s dtype and shape (``xf`` its (K, D) float32 view or
    copy): a new tensor, or with ``inplace`` written into ``x`` itself (the
    same operations, so the same bits) and ``x`` returned."""
    if not inplace:  # repro: noqa[RPR001] (a host bool)
        return _step(xf, gamma, delta).reshape(x.shape).to(x.dtype)
    view = x.dtype == torch.float32 and x.is_contiguous() and xf.data_ptr() == x.data_ptr()
    if view:  # repro: noqa[RPR001] (host metadata: xf is x's float32 view)
        if isinstance(gamma, float) and gamma == 1.0:  # repro: noqa[RPR001] (a host float)
            xf.add_(delta)
        else:
            xf.add_(gamma * delta)
    else:
        x.copy_(_step(xf, gamma, delta).reshape(x.shape))
    return x


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
        if self._dynamic:
            # the sanitizer's hook: W_r of a round, replayed
            self._round_topology_w = topology.round_w
        if isinstance(transport, DenseTransport) and not self._dynamic:
            # the static W is cast once to the transport's compute dtype
            self.w = topology.round_w(0).to(transport.compute_dtype)
        elif isinstance(transport, StarTransport):
            # the star W the mean applies, for the sanitizer
            self.w = topology.round_w(0).float()
        if self._is_gossip and self._dynamic and not isinstance(wire, CodecWire):
            # the sanitizer's mask check; the clocked EF stack has none
            self._round_vectors = partial(gather_round_vectors, perm_idx=transport.perm_idx)
        if self._is_gossip and self._dynamic and topology.k != transport.k:
            raise ValueError(f"topology K={topology.k} != transport K={transport.k}")
        if isinstance(wire, CodecWire):
            if transport is None:
                raise ValueError("a codec wire needs a transport")
            if isinstance(transport, StarTransport):
                raise ValueError(
                    "codec wires on the hub stack ride the dense transport "
                    "with the star W (see make_hub_mixer)")
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
        if isinstance(transport, StarTransport) and self._dynamic:
            raise ValueError(
                "the hub stack has no fault/schedule model yet — "
                "the star topology is static (ROADMAP: federated faults)")

    @property
    def compression(self):
        return self.wire.compression

    @property
    def traced_wire(self) -> bool:
        return self._dynamic or self.wire.traced_wire

    def _rate(self, state: CommState):
        """The codec rate of the round about to run (None = static): the
        sanitizer's rate-in-container hook."""
        if not isinstance(self.wire, CodecWire):
            return None
        return self.wire.rate(state, self.clock(state.rounds, state.res_norm.device).part)

    def _round_w(self, state: CommState, round=None) -> torch.Tensor:
        """The W of the codec-dense round about to run: static, or the
        schedule's matrix for this round (EF composes with a moving W on
        this lowering because it re-mixes the full public copies) at
        ``round`` (the clock's round; None: ``state.rounds``)."""
        if self._dynamic:
            return self.topo.round_w(state.rounds if round is None else round)
        return self.w

    def host_part(self, rounds: int) -> float:
        """The wire's rate-schedule host part of round ``rounds`` (0.0
        without a scheduled codec wire)."""
        return self.wire.host_part(rounds) if isinstance(self.wire, CodecWire) else 0.0

    @property
    def _clocked(self) -> bool:
        return self._is_gossip and getattr(self.wire, "clock", None) is not None

    def plan(self, state: CommState):
        """The branch the round about to run takes, chosen on the host, and
        the state's host ints after it: the clocked EF stack's fixed
        re-base decision (``ef_rounds % B == B − 1``, True where it
        re-bases), None on every other stack (one form; the adaptive
        re-base selects on the device)."""
        if not self._clocked:
            return None, state._replace(rounds=state.rounds + 1)
        after = state._replace(rounds=state.rounds + 1, ef_rounds=state.ef_rounds + 1)
        if self.adaptive:
            return None, after
        b = self.ef_rebase_every
        return b == 1 or (b >= 2 and state.ef_rounds % b == b - 1), after

    def clock(self, rounds: int, device) -> RoundClock:
        """The :class:`RoundClock` of round ``rounds``, filled on ``device``
        (the eager step's; the captured step packs the same values)."""
        rounds = int(rounds)  # repro: noqa[RPR002] (a host int)
        return RoundClock(torch.full((), rounds, dtype=torch.int64, device=device),
                          scalar(self.host_part(rounds), device))

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
        if isinstance(t, StarTransport):
            # hub round: K uploads + K downloads of the per-node block
            return 2 * tree_bytes(params)
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
        if isinstance(t, StarTransport):
            return t.apply(theta)
        if isinstance(t, DenseTransport):
            return t.apply_w(self.w, theta)
        return gossip_mix_local(theta, t.self_w, t.match_ws, t.srcs)

    def mix_tree(self, tree, state: CommState, clock: RoundClock | None = None):
        """Consensus applied to an arbitrary dict with this round's topology
        (no state advance, no codec), the round read from ``clock`` (None:
        ``state.rounds``).  Codec wires do not implement this."""
        if isinstance(self.wire, CodecWire):
            raise NotImplementedError
        if self._dynamic:
            w = self.topo.round_w(state.rounds if clock is None else clock.round)
            if isinstance(self.transport, DenseTransport):
                return self.transport.apply_w(w, tree)
            self_w, match_ws, _ = gather_round_vectors(w, self.transport.perm_idx)
            return gossip_mix_local(tree, self_w, match_ws, self.transport.srcs)
        return self._mix(tree)

    # -- the protocol ----------------------------------------------------------

    def __call__(self, theta, state: CommState, *, round=None, clock: RoundClock | None = None,
                 inplace: bool = False, branch=None):
        """One round.  ``clock``: the round on the device (None: filled from
        ``state.rounds``); ``inplace``: the static codec rounds may write
        into ``theta``'s leaves (and the dense round into ``state.hat``'s);
        ``branch``: the round's branch from :meth:`plan` (None: chosen here
        from the state's host ints).  Other rounds return new leaves."""
        with scope(f"obs:consensus/{type(self).__name__}"):
            if not (isinstance(self.wire, CodecWire) or self._dynamic):
                return super().__call__(theta, state, round=round)
            if clock is None:
                clock = self.clock(state.rounds, params_device(theta))
            if isinstance(self.wire, CodecWire):
                if self._clocked:
                    if branch is None:
                        branch = self.plan(state)[0]
                    return self._clocked_gossip_call(theta, state, clock, branch)
                if self._is_gossip:
                    return self._gossip_round(theta, state, clock=clock, inplace=inplace)
                return self._dense_round(theta, state, clock=clock, inplace=inplace)
            if self._is_gossip:
                return self._dynamic_gossip_call(theta, state, clock)
            return self._dynamic_dense_call(theta, state, clock)

    # -- identity-wire dynamic rounds ------------------------------------------

    def _dynamic_dense_call(self, theta, state: CommState, clock: RoundClock):
        w = self.topo.round_w(clock.round)
        mixed = self.transport.apply_w(w, theta)
        per_node_bits = 8.0 * (tree_bytes(theta) // self.k)
        return mixed, state._replace(rounds=state.rounds + 1,
                                     wire_bits=active_links(w) * per_node_bits)

    def _dynamic_gossip_call(self, theta, state: CommState, clock: RoundClock):
        t = self.transport
        w = self.topo.round_w(clock.round)
        self_w, match_ws, masks = gather_round_vectors(w, t.perm_idx)
        if isinstance(self.wire, MaskedQuantWire):
            mixed = self._quantized_gossip(theta, state, self_w, match_ws, masks, clock=clock)
            per_node_bits = sum(self.wire.leaf_bits(x.numel() // self.k)
                                for x in theta.values())
        else:
            mixed = gossip_mix_local(theta, self_w, match_ws, t.srcs)
            per_node_bits = 8.0 * (tree_bytes(theta) // self.k)
        return mixed, state._replace(rounds=state.rounds + 1,
                                     wire_bits=active_sends(masks) * per_node_bits)

    def _quantized_gossip(self, theta, state, self_w, match_ws, masks,
                          clock: RoundClock | None = None):
        """Every matching, every leaf at once: masked quantize of θ with fresh
        uniforms per (leaf, matching) at the clock's round (None:
        ``state.rounds``), gather, masked dequantize-accumulate (one B.4
        and one B.5 launch per matching on the card).  The leaves are
        independent, so this is the leaf-by-leaf round bit for bit."""
        from repro_torch.kernels.quant_gossip.ops import (
            masked_dequant_accumulate_grouped_,
            masked_quantize_blockwise_grouped,
        )

        wire = self.wire
        names = leaf_names(theta)
        xfs = [theta[n].reshape(theta[n].shape[0], -1).float() for n in names]
        accs = [xf * self_w[:, None] for xf in xfs]
        qmax, block_d = float(wire._qmax), wire.quantized.block_d
        round_t = (self.clock(state.rounds, self_w.device) if clock is None else clock).round
        for m, (pw, mk, src) in enumerate(zip(match_ws, masks, self.transport.srcs)):
            us = wire.round_uniforms(state, round_t, xfs, m)
            payloads = masked_quantize_blockwise_grouped(xfs, us, mk, qmax=qmax,
                                                         block_d=block_d)
            masked_dequant_accumulate_grouped_(accs, payloads, pw, mk, src=src)
        return {n: acc.reshape(theta[n].shape).to(theta[n].dtype)
                for n, acc in zip(names, accs)}

    # -- codec-wire rounds -----------------------------------------------------

    def _dense_round(self, theta, state: CommState, clock: RoundClock,
                     inplace: bool = False):
        """One compressed dense round: every node encodes each leaf (its
        innovation against θ̂ in EF mode) at the round's rate, the public
        copies are mixed by W, and θ moves by γ(Σ_j W_ij θ̂_j − θ̂_i).  A
        draw of the round's noise (one Philox launch on the card), an encode
        pass over every leaf (one B.2 launch, a schedule's rate read there),
        then a mix pass; the uniforms are a pure function of (key, round,
        leaf), so this is the leaf-by-leaf round bit for bit.  ``inplace``
        writes θ into ``theta``'s leaves and θ̂ into ``state.hat``'s."""
        w = self._round_w(state, clock.round)
        rate = self.wire.rate(state, clock.part)
        gamma = self.wire.gamma_for(rate)
        names = leaf_names(theta)
        xfs, hats, res_sq = self._flat_leaves(theta, state, w.device)
        us = self.wire.round_uniforms(state, clock.round, xfs)
        encoded = self.wire.encode_leaves(xfs, hats, us, rate, inplace=inplace)
        del us
        out_theta, out_hat = {}, {}
        for name, xf, (_, public, new_hat) in zip(names, xfs, encoded):
            shape = theta[name].shape
            out_theta[name] = _stepped(theta[name], xf, gamma, w @ public - public, inplace)
            if self.ef:
                out_hat[name] = state.hat[name] if inplace else new_hat.reshape(shape)
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq),
                                                               clock.part)
        # _replace, not CommState(...): fields this round does not own must
        # thread through untouched
        return out_theta, state._replace(
            hat=out_hat if self.ef else (), res_norm=res_norm, res_ref=res_ref,
            rounds=rounds, wire_bits=self.wire.round_wire_bits(
                theta, rate, self._senders(w), self.k, w.device))

    def _gossip_round(self, theta, state: CommState, *, clock: RoundClock, self_w=None,
                      match_ws=None, masks=None, senders=None, inplace: bool = False):
        """One compressed gossip round over the matching decomposition.

        The static stack calls this with no overrides (frozen decomposition
        weights, every matching link active) and the round's ``clock``.
        The clocked dynamic stack passes the per-round vectors gathered from
        W_r: ``self_w`` (K,), ``match_ws``/``masks`` per matching, and the
        active-link count ``senders`` for wire accounting.  With all-ones
        masks the masked paths are bit-identical to the unmasked ones.
        ``inplace`` writes θ into ``theta``'s leaves (θ̂ and the mix cache
        are new leaves: the accumulate reads the old θ̂).
        """
        t = self.transport
        if self_w is None:
            self_w = t.self_w
        if match_ws is None:
            match_ws = t.match_ws
        send = _send_mask(masks) if masks is not None else None
        rate, xfs, hats, res_sq, encoded = self._encoded_round(theta, state, clock,
                                                               self_w.device, send)
        accs = self._delta_accs(theta, state, xfs, hats, encoded, self_w, match_ws, masks)
        out_theta, out_hat, out_mix = self._mixed(theta, xfs, rate, accs, encoded, inplace)
        if senders is None:
            senders = self._sends()
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq),
                                                               clock.part)
        # _replace so fields this round does not own thread through
        return out_theta, state._replace(
            hat=out_hat if self.ef else (), hat_mix=out_mix if self.ef else (),
            res_norm=res_norm, res_ref=res_ref, rounds=rounds,
            wire_bits=self.wire.round_wire_bits(theta, rate, senders, self.k, res_sq.device))

    def _encoded_round(self, theta, state: CommState, clock: RoundClock, device, send=None):
        """The codec step every gossip round shares: the rate, each leaf's
        (K, d) float32 block and θ̂ block, the EF residual, and every leaf's
        (payload, public', θ̂') drawn at ``clock``'s round under the send
        mask (one B.2 launch per round, B.4 where masked)."""
        rate = self.wire.rate(state, clock.part)
        xfs, hats, res_sq = self._flat_leaves(theta, state, device)
        us = self.wire.round_uniforms(state, clock.round, xfs)
        encoded = self.wire.encode_leaves(xfs, hats, us, rate, send_mask=send)
        return rate, xfs, hats, res_sq, encoded

    def _delta_accs(self, theta, state: CommState, xfs, hats, encoded, self_w, match_ws,
                    masks):
        """The delta round's mix of every leaf.  EF: s_i += W_ii q_i +
        Σ_m W_i,src(i)·dequant(recv) keeps s_i = Σ_j W_ij θ̂_j current;
        memoryless: the same combine of the fresh C(θ) messages.  Only the
        payload crosses the wire: per matching, every leaf is accumulated
        (one B.3 launch on the static wire, one B.5 where masked)."""
        if self.ef:
            accs = [state.hat_mix[n].reshape(xf.shape) + self_w[:, None] * (public - h)
                    for n, xf, h, (_, public, _) in zip(leaf_names(theta), xfs, hats,
                                                         encoded)]
        else:
            accs = [self_w[:, None] * public for _, public, _ in encoded]
        payloads = [payload for payload, _, _ in encoded]
        for m, (pw, src) in enumerate(zip(match_ws, self.transport.srcs)):
            accs = self._accumulate_leaves(accs, payloads, pw, src,
                                           mask=masks[m] if masks is not None else None)
        return accs

    def _rebase_acc(self, new_hat, self_w, match_ws, masks):
        """The re-base round's mix of one leaf: s_i = Σ_j W_ij(r) θ̂_j from
        the fresh public copies, gathered over the masked matchings."""
        acc = self_w[:, None] * new_hat
        for pw, mk, src in zip(match_ws, masks, self.transport.srcs):
            acc = acc + (pw * mk)[:, None] * new_hat[src]
        return acc

    def _mixed(self, theta, xfs, rate, accs, encoded, inplace: bool = False):
        """θ + γ·(s − public') of every leaf (written into ``theta``'s leaves
        with ``inplace``), and on EF wires θ̂' and the mix cache s."""
        gamma = self.wire.gamma_for(rate)
        out_theta, out_hat, out_mix = {}, {}, {}
        for n, xf, acc, (_, public, new_hat) in zip(leaf_names(theta), xfs, accs, encoded):
            shape = theta[n].shape
            out_theta[n] = _stepped(theta[n], xf, gamma, acc - public, inplace)
            if self.ef:
                out_hat[n] = new_hat.reshape(shape)
                out_mix[n] = acc.reshape(shape)
        return out_theta, out_hat, out_mix

    def _full_bits(self, theta, senders) -> torch.Tensor:
        """The re-base round's full-precision wire: active links × each
        node's float32 payload."""
        return wire_bits(senders, 32.0 * sum(x.numel() // self.k for x in theta.values()),
                         None)

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

    def _clocked_gossip_call(self, theta, state: CommState, clock: RoundClock, rebase):
        """The clocked EF round at ``clock``'s round: the delta round, or
        the re-base round where ``rebase`` (the host's branch) says so; the
        adaptive trigger selects between the two on the device."""
        w = self.topo.round_w(clock.round)
        self_w, match_ws, masks = gather_round_vectors(w, self.transport.perm_idx)
        senders = active_sends(masks)
        if self.adaptive:
            t2, s2 = self._adaptive_round(theta, state, w, self_w, match_ws, masks, senders,
                                          clock)
        elif rebase:  # repro: noqa[RPR001] (a host bool: the branch the host chose)
            t2, s2 = self._rebase_round(theta, state, self_w, match_ws, masks, senders, clock)
        else:
            t2, s2 = self._gossip_round(theta, state, clock=clock, self_w=self_w,
                                        match_ws=match_ws, masks=masks, senders=senders)
        return t2, s2._replace(ef_rounds=state.ef_rounds + 1)

    def _adaptive_round(self, theta, state: CommState, w, self_w, match_ws, masks, senders,
                        clock: RoundClock):
        """The drift-triggered round, chosen on the device: the cache drift
        ‖s − W_r θ̂‖_F against this round's W before mixing, one encode of
        the innovation (both modes encode it with the same noise and send
        mask, so θ̂ is the same), the delta round's accumulation (B.5 per
        matching) and the re-base round's (the fresh public copies
        gathered), then θ, the mix cache and the wire bits of the re-base
        round where drift > threshold, of the delta round elsewhere
        (``torch.where`` copies the chosen bits).  ``ef_drift`` keeps the
        drift."""
        drift = self._cache_drift(w, state.hat, state.hat_mix)
        # against the (float64) threshold in float64, not rounded to float32
        rebase = drift.double() > self.ef_rebase_threshold
        rate, xfs, hats, res_sq, encoded = self._encoded_round(
            theta, state, clock, self_w.device, _send_mask(masks))
        deltas = self._delta_accs(theta, state, xfs, hats, encoded, self_w, match_ws, masks)
        accs = [torch.where(rebase, self._rebase_acc(new_hat, self_w, match_ws, masks), delta)
                for delta, (_, _, new_hat) in zip(deltas, encoded)]
        del deltas
        out_theta, out_hat, out_mix = self._mixed(theta, xfs, rate, accs, encoded)
        bits = torch.where(rebase, self._full_bits(theta, senders),
                           self.wire.round_wire_bits(theta, rate, senders, self.k,
                                                     res_sq.device))
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq),
                                                               clock.part)
        return out_theta, state._replace(
            hat=out_hat, hat_mix=out_mix, res_norm=res_norm, res_ref=res_ref, rounds=rounds,
            wire_bits=bits, ef_drift=drift)

    def _rebase_round(self, theta, state: CommState, self_w, match_ws, masks, senders,
                      clock: RoundClock):
        """Codec step + full-precision θ̂ exchange rebuilding the cache.

        The innovation is still encoded (θ̂ must keep tracking θ; masked
        senders stay frozen) but the quantized payload does not cross the
        wire this round — the matchings move the fresh public copies
        instead, and s_i = Σ_j W_ij(r) θ̂_j is exact under the current W.
        """
        rate, xfs, _, res_sq, encoded = self._encoded_round(theta, state, clock, self_w.device,
                                                            _send_mask(masks))
        accs = [self._rebase_acc(new_hat, self_w, match_ws, masks) for _, _, new_hat in encoded]
        out_theta, out_hat, out_mix = self._mixed(theta, xfs, rate, accs, encoded)
        res_norm, res_ref, rounds = self.wire.next_sched_state(state, torch.sqrt(res_sq),
                                                               clock.part)
        return out_theta, state._replace(
            hat=out_hat, hat_mix=out_mix, res_norm=res_norm, res_ref=res_ref,
            rounds=rounds, wire_bits=self._full_bits(theta, senders))
