"""DR-DSGD / DSGD decentralized train-step builders (paper Alg. 1 & 2).

The port of ``repro.core.drdsgd``.  The train step operates on a
:class:`DecentralizedState` whose params dict is *node-stacked*: every leaf
has leading axis K.  One step is:

  1. per-node minibatch gradient g_i and minibatch loss ℓ̄_i
  2. robust scale s_i = exp(ℓ̄_i/μ)/μ  (DR-DSGD; s_i = 1 for DSGD)
  3. local update θ_i⁺ = opt(θ_i, s_i·g_i)
  4. consensus θ, comm ← mix(θ⁺, comm, round=step)

Step 1 is one forward over all K node models and one ``backward()`` of the
summed node losses: node i's loss depends only on θ_i, so the gradient of
the sum with respect to the stacked leaves is every node's own gradient.

Where the optimizer is plain :func:`~repro_torch.optim.sgd` and the mixer a
static uncompressed dense round (``DenseMixer``), steps 2–4 are one call of
the fused gossip update over every leaf, ``W @ (θ − η·(s⊙g))`` (B.1 on the
card: one launch per step, per 16 leaves and per dtype of the leaves): it
reads θ and g once and writes the mixed parameters once, where the unfused
step holds SGD's update and the mixer's output beside them.  Its plain
version computes in the unfused order, so both give the same bits on the
CPU; the metrics and the ``CommState`` are the same either way.  Every
other stack — another optimizer, a compressed wire, gossip, a wrapper
mixer (local updates, repeated rounds), a consensus period ``mix_every`` >
1, and any K above the stacked kernel's 64 nodes — runs the unfused step.
Per-node clipping and the robust scale scale the fresh gradients in place.

Both steps have a capturable form (``train_step.capturable``), which the
eager step runs and the trainer's CUDA graph captures
(:mod:`repro_torch.core.captured`): it reads nothing that changes from step
to step on the host, but takes the step's scalars as 0-d tensors
(:class:`StepScalars`: η and Adam's bias corrections, the round the mixer
runs and its rate schedule's host part), which ``train_step.host_scalars``
computes on the host and the eager step fills, and the step's branch, a
host key (``train_step.host_branch``: whether the step mixes, then each
wrapper's consensus test and each clocked EF round's re-base decision, in
order, from the step and the ``CommState``'s host ints, which it also
advances), where the reference uses ``lax.cond``.  The round is read only
from ``StepScalars.round``.  With ``inplace=True`` the form writes the new
parameters (B.1's ``out``, the optimizer, the static codec rounds) and the
optimizer state and θ̂ (the dense codec round) into the state's own
tensors: the captured step's slot.  The same operations run either way, so
the eager step, the capturable form and its replays give the same bits.
:func:`capture_declined` says which stacks the trainer captures.

``TrainStepConfig.mix_every`` > 1 mixes only on the steps ``mix_every − 1,
2·mix_every − 1, ...``: the off-steps skip the mixer, pass the
``CommState`` through unchanged and report 0 ``comm_bytes`` and
``wire_bits``.  A fault process with ``straggler_skips_compute`` (found by
peeling ``LocalUpdateMixer`` and ``RepeatMixer`` off the mixer) multiplies
the robust scale by the round's node-up vector, drawn on the device at
``StepScalars.round`` (the round the mixer consumes).

The metrics stay on the device as 0-d tensors; nothing in a step waits for
the device.  Every step reports ``disagreement`` (the reference's optional
metric, on by default there).

``obs`` (a :class:`repro_torch.obs.MetricsSink`) adds the telemetry tap:
the step packs its record — the metrics, the EF clock's ``ef_rounds`` and
``ef_drift`` where the stack has them, and on every
``obs.vector_every``-th step the per-node ``loss_nodes``, ``dr_weights``
and the values behind the ``hist_*`` counts of
:data:`repro_torch.obs.hist.TRAIN_HISTOGRAMS`, which the sink buckets when
it drains — under the ``_tap`` key (no launch on an ordinary step: the
sink stacks the queued records into one float32 payload when it drains),
which the trainer pops before the metrics reach its caller.  ``sanitize`` (a
:class:`repro_torch.analysis.sanitize.SanitizeFlags`) stages the in-step
invariant checks after the round.  Both only read what the step computes,
and neither synchronises; with both off the step is unchanged.  The phases
run inside ``obs:grad``, ``obs:dr_weighting``, ``obs:local_update``,
``obs:consensus``, ``obs:sanitize`` and ``obs:tap`` profiler ranges (the
fused step's one call is both ``obs:local_update`` and ``obs:consensus``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.comm import CompressionConfig
from repro_torch.comm import topology as comm_topology
from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.protocol import (
    CommState,
    Mixer,
    scalar,
    trivial_comm_state,
)
from repro_torch.comm.transport import DenseTransport
from repro_torch.comm.wire import IdentityWire
from repro_torch.core.robust import (
    RobustConfig,
    mixture_weights,
    robust_objective,
    robust_scale,
)
from repro_torch.kernels.gossip_update.kernel import MAX_NODES
from repro_torch.kernels.gossip_update.ops import gossip_update_stacked_grouped
from repro_torch.obs.hist import TRAIN_HISTOGRAMS
from repro_torch.obs.profiler import scope
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.utils.tree import leaf_names, tree_node_disagreement

LossFn = Callable[[Any, Any], torch.Tensor]  # (params, batch) -> (K,) losses


class StepScalars(NamedTuple):
    """A step's scalars as 0-d tensors on the parameters' device: what the
    capturable form reads in place of host numbers.

    eta:   float32 — the optimizer's step size (B.1's η on the fused step).
    bc1:   float32 — Adam's 1 − b1^(step+1) (1 for the other optimizers).
    bc2:   float32 — Adam's 1 − b2^(step+1).
    round: int64 — the round the mixer runs (``CommState.rounds``).
    part:  float32 — the wire's rate-schedule host part of that round.

    The last two are a ``RoundClock``'s fields: the mixer takes the
    scalars as its round's clock.
    """

    eta: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    round: torch.Tensor
    part: torch.Tensor


SCALAR_DTYPES = StepScalars(torch.float32, torch.float32, torch.float32, torch.int64,
                            torch.float32)


def step_scalars(values, device) -> StepScalars:
    """:class:`StepScalars` filled on ``device`` from ``values``
    (``train_step.host_scalars``'s tuple)."""
    return StepScalars(*(torch.full((), v, dtype=dt, device=device)
                         for v, dt in zip(values, SCALAR_DTYPES)))


class DecentralizedState(NamedTuple):
    params: Any          # dict of node-stacked tensors, leading axis K
    opt_state: Any
    step: int
    comm: Any = ()       # the mixer's CommState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    robust: RobustConfig
    grad_clip: float | None = None        # per-node global-norm clip (pre-scale)
    mix_every: int = 1                    # consensus period: 1 = DSGD/DR-DSGD;
                                          # > 1 = local SGD with periodic
                                          # averaging (off-steps skip the mixer)
    compression: CompressionConfig | None = None
                                          # wire codec the mixer was built
                                          # with; recorded so the step can
                                          # sanity-check the mixer


def init_state(node_params, optimizer: Optimizer,
               mixer: Mixer | None = None) -> DecentralizedState:
    """Build state from node-stacked params.  Pass the mixer so its
    ``CommState`` is allocated into ``comm``."""
    device = next(iter(node_params.values())).device
    comm = mixer.init_state(node_params) if mixer is not None \
        else trivial_comm_state(device=device)
    return DecentralizedState(params=node_params,
                              opt_state=optimizer.init(node_params),
                              step=0, comm=comm)


def replicate_params(params, k: int):
    """K identical node replicas of one parameter dict (Lemma 3 assumes all
    local models start at the same point)."""
    return {n: x.unsqueeze(0).expand((k,) + tuple(x.shape)).contiguous()
            for n, x in params.items()}


def _node_scale(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1)).to(like.dtype)


def _fused_declined(optimizer: Optimizer, mixer: Mixer, mix_every: int) -> str | None:
    """Why the step does not fuse SGD and the round into B.1 (None where it
    does): the step must be plain SGD followed by a static uncompressed
    dense round in float32 on every step (B.1 computes in float32; a
    bfloat16 ``compute_dtype`` rounds the round's inputs).  A wrapper mixer
    (``LocalUpdateMixer``, ``RepeatMixer``: not a ``ComposedMixer``) and a
    consensus period ``mix_every`` > 1 are declined, since B.1 mixes on
    every call; so is any K above the stacked B.1 kernel's ``MAX_NODES``
    (64)."""
    if optimizer.sgd_lr is None:
        return "the optimizer is not plain SGD"
    if mix_every > 1:
        return f"mix_every = {mix_every}: the off-steps skip the round"
    if not isinstance(mixer, ComposedMixer):
        return f"a wrapper mixer ({type(mixer).__name__})"
    if getattr(mixer, "_dynamic", False):
        return "a time-varying topology (dynamics)"
    if not isinstance(mixer.wire, IdentityWire):
        kind = mixer.compression.kind if mixer.compression is not None else "masked"
        return f"a compressed wire ({kind})"
    if not isinstance(mixer.transport, DenseTransport):
        return f"the {type(mixer.transport).__name__}"
    if mixer.traced_wire:
        return "a traced wire"
    if mixer.transport.compute_dtype != torch.float32:
        return f"a {mixer.transport.compute_dtype} compute dtype"
    if mixer.w.shape[0] > MAX_NODES:
        return f"K = {mixer.w.shape[0]} above the stacked B.1 kernel's {MAX_NODES} nodes"
    return None


def _fused_w(optimizer: Optimizer, mixer: Mixer, mix_every: int):
    """The (K, K) W of the fused SGD + dense-mixing step (B.1), or None
    where :func:`_fused_declined` declines the stack.  A declined step
    takes the unfused path (the optimizer, then the mixer), on every
    device, so the card and the CPU run one semantics."""
    if _fused_declined(optimizer, mixer, mix_every) is not None:
        return None
    return mixer.w


def _mixer_declined(mixer: Mixer) -> str | None:
    """Why the mixer's rounds cannot be captured (None where they can),
    wrappers peeled: every mixer a class of the port's (a class of the
    caller's may read its round on the host), no schedule class or fault seam that
    takes the round as a host int, no noise hook, and no rate schedule
    under ``RepeatMixer`` (its later rounds' host parts)."""
    m = mixer
    while m is not None:
        if not type(m).__module__.startswith("repro_torch."):
            return f"a mixer the port does not define ({type(m).__name__})"
        if getattr(m, "_scheduled", False) and getattr(m, "rounds", 1) > 1:
            return "a rate schedule under RepeatMixer reads its later rounds' host parts"
        topo = getattr(m, "topo", None)
        if getattr(topo, "foreign", None):
            return topo.foreign
        if getattr(topo, "faults", None) is not None and comm_topology.seam_replaced():
            return "a replaced fault seam (round_fault_masks) takes the round on the host"
        if getattr(getattr(m, "wire", None), "hooked", False):
            return "a uniforms hook (a host callable) draws the wire's noise"
        m = getattr(m, "inner", None)
    return None


def _unfused_declined(optimizer: Optimizer, mixer: Mixer) -> str | None:
    """Why the unfused step (the optimizer, then the mixer's round on the
    mix steps) has no capturable form (None where it has): the optimizer
    must have a device form (``apply``) and the mixer's rounds must be
    capturable (:func:`_mixer_declined`).  Every other choice the step
    makes (``mix_every``, a wrapper's consensus test, the clocked EF
    stack's re-base) is a branch the host chooses."""
    if optimizer.apply is None:
        return "the optimizer has no device form (an Optimizer(init, update))"
    return _mixer_declined(mixer)


def capture_declined(loss_fn, optimizer: Optimizer, mixer: Mixer, mix_every: int, *,
                     obs=None, sanitize: bool = False) -> str | None:
    """Why the trainer does not capture its step in CUDA graphs (None where
    it does; the CPU then runs the same capturable form eagerly).  The
    captured step is the fused one where it applies
    (:func:`_fused_declined`), else the unfused one
    (:func:`_unfused_declined`): any optimizer with a device form, then any
    of the port's mixers (static or time-varying, faulted, dense, gossip or
    hub, any codec wire, wrapped in ``LocalUpdateMixer`` or
    ``RepeatMixer``), on every step or every ``mix_every``-th, one graph per
    branch the host chooses.  The telemetry tap and the sanitizer's checks
    read the step on the host's schedule, and a loss that carries
    ``capture_declined`` (an LM family whose node-stacked loss still loops
    over the nodes) says why itself; each of those steps runs eagerly."""
    if obs is not None:
        return "a telemetry sink (obs) taps the step"
    if sanitize:
        return "sanitize stages its checks in the step"
    reason = getattr(loss_fn, "capture_declined", None)
    if reason:
        return reason
    if _fused_declined(optimizer, mixer, mix_every) is None:
        return None
    return _unfused_declined(optimizer, mixer)


def _step_faults(mixer: Mixer):
    """The fault process whose down nodes lose their gradient
    (``straggler_skips_compute`` with stragglers or outages), found by
    peeling wrapper mixers (``inner``) down to a scheduled topology; None
    otherwise."""
    m, faults = mixer, None
    while m is not None and faults is None:
        faults = getattr(getattr(m, "topo", None), "faults", None)
        m = getattr(m, "inner", None)
    if faults is not None and faults.enabled and faults.straggler_skips_compute \
            and (faults.straggler_p > 0 or faults.outage_p > 0):
        return faults
    return None


def _dtype_groups(params: dict, names: list) -> list[list]:
    """``names`` split by their leaves' dtype, each in the order of
    ``names`` (one group where every leaf has one dtype)."""
    groups: dict = {}
    for n in names:
        groups.setdefault(params[n].dtype, []).append(n)
    return list(groups.values())


def _owned(grads: dict) -> bool:
    """Every gradient contiguous and in a storage of its own: safe to
    scale in place."""
    ptrs = {g.untyped_storage().data_ptr() for g in grads.values()}
    return len(ptrs) == len(grads) and all(g.is_contiguous() for g in grads.values())


def _scaled(grads: dict, scale: torch.Tensor) -> dict:
    """Each node's gradient times its robust scale: in place where the step
    owns the gradients (the same products)."""
    if _owned(grads):
        return {n: g.mul_(_node_scale(scale, g)) for n, g in grads.items()}
    return {n: g * _node_scale(scale, g) for n, g in grads.items()}


def _tap_fields(obs, step: int, metrics: dict, comm, losses, lam) -> dict:
    """The step's record for ``obs``: the metrics, the EF clock where the
    stack has one, and on a vector step the per-node vectors and the values
    the histograms bucket (the sink counts them when it drains).  No
    launch on an ordinary step: the sink stacks the queued metrics when it
    drains."""
    rec = dict(metrics)
    if isinstance(comm.ef_rounds, int):
        rec["ef_rounds"] = comm.ef_rounds
    if isinstance(comm.ef_drift, torch.Tensor):
        rec["ef_drift"] = comm.ef_drift
    if not obs.wants_vectors(step):  # repro: noqa[RPR001] (a host int: the loop's step)
        return obs.tap_pack(step, rec)
    loss_nodes = losses.float()
    sources = {"loss_nodes": loss_nodes, "dr_weights": lam, "ef_res": comm.metrics.res_norm}
    return obs.tap_pack(step, rec, vectors={"loss_nodes": loss_nodes, "dr_weights": lam},
                        hists={spec: sources[spec.source] for spec in TRAIN_HISTOGRAMS})


def build_train_step(loss_fn: LossFn, optimizer: Optimizer, mixer: Mixer,
                     cfg: TrainStepConfig, *, obs=None, sanitize=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``loss_fn(params, batch)`` takes the node-stacked params and batch and
    returns the (K,) per-node mean losses.  The metrics dict has the keys
    of the reference's step (``repro/core/drdsgd.py:242-258``), plus
    ``_tap`` when ``obs`` (a ``MetricsSink``) is given.  ``sanitize`` (a
    ``SanitizeFlags``) receives the in-step checks.
    """
    if cfg.compression is not None and cfg.compression.enabled \
            and mixer.compression is None:
        raise ValueError(
            "TrainStepConfig.compression is set but the mixer is "
            "uncompressed — build it with the same CompressionConfig")
    if cfg.mix_every > 1 and getattr(mixer, "period", 1) > 1:
        raise ValueError(
            "mix_every > 1 with a LocalUpdateMixer (period > 1) runs two "
            "consensus clocks against each other — express the local-update "
            "period in ONE place (the mixer's period is the dynamics-aware "
            "spelling: it keeps CommState.rounds ticking every step)")
    fused_w = _fused_w(optimizer, mixer, cfg.mix_every)
    step_faults = _step_faults(mixer)
    n_opt = len(optimizer.scalars(0)) if optimizer.scalars is not None else 0
    if sanitize is not None:
        from repro_torch.analysis.sanitize import step_checks

    def check_comm(state):
        if not isinstance(state.comm, CommState):
            raise ValueError(
                "DecentralizedState.comm must be the mixer's CommState — "
                "build the state with init_state(params, optimizer, mixer=mixer)")

    def grads_and_weights(state, batch, names, sc: StepScalars):
        """The per-node losses and gradients (clipped), the robust scale and
        the mixture weights."""
        with scope("obs:grad"):
            leaves = [state.params[n].detach().requires_grad_(True) for n in names]
            losses = loss_fn(dict(zip(names, leaves)), batch)
            # B.1 and the in-place clip take contiguous gradients; a leaf used
            # twice (a tied embedding: a gather and a transposed product) may
            # get a transposed one from autograd's sum
            grads = {n: g if g.is_contiguous() else g.contiguous()
                     for n, g in zip(names, torch.autograd.grad(losses.sum(), leaves))}
            losses = losses.detach()
            if cfg.grad_clip is not None:
                grads, _ = clip_by_global_norm(grads, cfg.grad_clip, nodes=True,
                                               inplace=_owned(grads))
        # --- the paper's technique: exponential per-node gradient reweighting
        with scope("obs:dr_weighting"):
            scale = robust_scale(losses, cfg.robust)   # (K,)
            lam = mixture_weights(losses, cfg.robust)  # (K,) adversarial λ*
            if step_faults is not None:
                # a down node loses its gradient: the round's up vector, drawn at
                # the step's round (the round the mixer consumes)
                _, up = comm_topology.fault_masks(step_faults, sc.round, losses.shape[0],
                                                  losses.device)
                scale = scale * up
        return losses, grads, scale, lam

    def finish(state, losses, scale, lam, mixed, opt_state, comm, is_mix_step):
        """The sanitizer's checks, the metrics and the tap; the new state."""
        if sanitize is not None:
            with scope("obs:sanitize"):
                step_checks(mixer, state.comm, mixed, comm, sanitize, state.step)
        # wire bytes this step: the round's measured wire on time-varying
        # stacks, else the static estimate; 0 on a step that skips the mixer
        if is_mix_step:  # repro: noqa[RPR001] (a host bool: step is a host int)
            wire = comm.metrics.wire_bits
            comm_bytes = (comm.wire_bits / 8.0 if mixer.traced_wire
                          else scalar(mixer.bytes_per_round(state.params), losses.device))
        else:
            comm_bytes = wire = scalar(0.0, losses.device)
        metrics = {
            "comm_bytes": comm_bytes,
            "loss_mean": losses.mean(),
            "loss_worst": losses.max(),
            "loss_std": losses.std(correction=0),
            "robust_objective": robust_objective(losses, cfg.robust),
            "scale_mean": scale.mean(),
            "scale_max": scale.max(),
            "lambda_max": lam.max(),
            "wire_bits": wire,
            "ef_residual_norm": comm.metrics.res_norm,
            "disagreement": tree_node_disagreement(mixed),
        }
        if obs is not None:
            # the record rides the metrics as one packed entry; the trainer
            # pops it, so the metrics its caller sees are the same either way
            with scope("obs:tap"):
                metrics.update(_tap_fields(obs, state.step, metrics, comm, losses, lam))
        return DecentralizedState(mixed, opt_state, state.step + 1, comm), metrics

    def host_scalars(step: int, rounds: int) -> tuple:
        """The step's scalars as host numbers, in :class:`StepScalars`'s
        order: the optimizer's (η, and Adam's bias corrections) at ``step``,
        the round ``rounds`` and the wire's rate-schedule host part of it."""
        opt = optimizer.scalars(step) if optimizer.scalars is not None else (0.0,)
        bc = opt[1:3] if len(opt) == 3 else (1.0, 1.0)
        part = mixer.host_part(rounds)
        return (opt[0], *bc, int(rounds), part)

    def host_branch(step: int, comm: CommState):
        """The step's branch, a host key — (whether the step mixes, the
        mixer's branch from ``Mixer.plan``: each wrapper's consensus test
        and each clocked EF round's re-base, in order) — and the
        ``CommState`` with its host ints after the step."""
        if step % cfg.mix_every != cfg.mix_every - 1:  # repro: noqa[RPR001] (host ints)
            return (False, None), comm
        branch, after = mixer.plan(comm)
        return (True, branch), after

    def fused_step(state: DecentralizedState, batch, sc: StepScalars, inplace: bool = False,
                   branch=None):
        """The fused step (scale, SGD and the dense round in B.1), η read
        from ``sc.eta``; ``inplace`` makes the parameters B.1's ``out``
        (updated in place: each of its threads reads every node's column
        before it writes that column).  Nothing reads the parameters after
        B.1 (the round's bookkeeping reads their shapes only).  It mixes on
        every step, so its one branch is ``(True, None)``."""
        check_comm(state)
        names = leaf_names(state.params)
        losses, grads, scale, lam = grads_and_weights(state, batch, names, sc)
        out = state.params if inplace else None
        # scale, SGD and the dense consensus round: one pass over every
        # leaf of a dtype (one B.1 launch per step on the card)
        with scope("obs:local_update"), scope("obs:consensus"):
            mixed = {}
            for group in _dtype_groups(state.params, names):
                outs = gossip_update_stacked_grouped(
                    [state.params[n] for n in group], [grads[n] for n in group],
                    fused_w, scale, eta=sc.eta,
                    out=None if out is None else [out[n] for n in group])
                mixed.update(zip(group, outs))
            mixed = {n: mixed[n] for n in names}
            del grads  # a node-stacked copy of the parameters: free it before the metrics
            comm = mixer.round_state(state.params, state.comm)
        return finish(state, losses, scale, lam, mixed, state.opt_state, comm, True)

    def unfused_step(state: DecentralizedState, batch, sc: StepScalars, inplace: bool = False,
                     branch=None):
        """The optimizer, then the mixer's round, reading the step's scalars
        from ``sc`` and its branch from ``branch`` (:func:`host_branch`'s
        key; None: chosen here from the state's host fields); ``inplace``
        lets the optimizer and a static codec round write into the state's
        own tensors.  An optimizer without a device form reads the host step
        instead (its stacks run eagerly)."""
        check_comm(state)
        names = leaf_names(state.params)
        losses, grads, scale, lam = grads_and_weights(state, batch, names, sc)
        # mix_every > 1: off-steps skip the mixer (a branch the host chose)
        if branch is None:
            branch = host_branch(state.step, state.comm)[0]
        is_mix_step, mixer_branch = branch
        # --- local optimizer step (plain SGD in the paper)
        with scope("obs:local_update"):
            scaled = _scaled(grads, scale)
            del grads
            if optimizer.apply is not None:
                updated, opt_state = optimizer.apply(scaled, state.opt_state, state.params,
                                                     (sc.eta, sc.bc1, sc.bc2)[:n_opt], inplace)
            else:
                updated, opt_state = optimizer.update(scaled, state.opt_state,
                                                      state.params, state.step)
            del scaled  # the gradients: free them before the round
        # --- consensus: the only cross-node communication of the algorithm
        with scope("obs:consensus"):
            if not is_mix_step:  # repro: noqa[RPR001] (a host bool: step is a host int)
                mixed, comm = updated, state.comm
            else:
                mixed, comm = mixer(updated, state.comm, round=state.step, clock=sc,
                                    inplace=inplace, branch=mixer_branch)
        return finish(state, losses, scale, lam, mixed, opt_state, comm, is_mix_step)

    form = fused_step if fused_w is not None else unfused_step

    def train_step(state: DecentralizedState, batch):
        check_comm(state)
        device = next(iter(state.params.values())).device
        return form(state, batch, step_scalars(host_scalars(state.step, state.comm.rounds),
                                               device),
                    branch=host_branch(state.step, state.comm)[0])

    # the capturable form, and the host functions of its scalars and branch
    train_step.capturable = form
    train_step.host_scalars = host_scalars
    train_step.host_branch = host_branch
    return train_step


def build_eval_step(predict_fn: Callable[[Any, Any], torch.Tensor]):
    """Returns eval_step(node_params, x, y) -> (K,) per-node accuracies.

    Every node evaluates the *same* test inputs ``x`` (n, ...), the paper's
    protocol of reporting each device's accuracy on the global test set.
    ``predict_fn`` is node-stacked: it sees ``x`` broadcast to (K, n, ...).
    """

    @torch.no_grad()
    def eval_step(node_params, x, y):
        k = next(iter(node_params.values())).shape[0]
        logits = predict_fn(node_params, x.unsqueeze(0).expand((k,) + tuple(x.shape)))
        return (logits.argmax(-1) == y.long()).float().mean(-1)

    return eval_step
