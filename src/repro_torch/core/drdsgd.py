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
step holds the scaled gradients, SGD's update and the mixer's output beside
them.  Its plain version computes in the unfused order, so both give the
same bits on the CPU; the metrics and the ``CommState`` are the same either
way.  Every other stack, and any K above the stacked kernel's 64 nodes,
runs the unfused step.  Per-node clipping scales the fresh gradients in
place.

The metrics stay on the device as 0-d tensors; nothing in a step waits for
the device.  The reference's telemetry tap, sanitizer and fault masks are
not ported, nor its consensus period (``mix_every``) and optional
disagreement metric: every step mixes and reports ``disagreement``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.comm import CompressionConfig
from repro_torch.comm.composed import ComposedMixer
from repro_torch.comm.protocol import CommState, Mixer, scalar, trivial_comm_state
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
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.utils.tree import leaf_names, tree_node_disagreement

LossFn = Callable[[Any, Any], torch.Tensor]  # (params, batch) -> (K,) losses


class DecentralizedState(NamedTuple):
    params: Any          # dict of node-stacked tensors, leading axis K
    opt_state: Any
    step: int
    comm: Any = ()       # the mixer's CommState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    robust: RobustConfig
    grad_clip: float | None = None        # per-node global-norm clip (pre-scale)
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


def _fused_w(optimizer: Optimizer, mixer: Mixer):
    """The (K, K) W of the fused SGD + dense-mixing step, or None where the
    step is not plain SGD followed by a static uncompressed dense round in
    float32 (B.1 computes in float32; a bfloat16 ``compute_dtype`` rounds the
    round's inputs), or where K exceeds the stacked B.1 kernel's
    ``MAX_NODES`` (64): such a step takes the unfused path (the optimizer,
    then the mixer), on every device, so the card and the CPU run one
    semantics at any K."""
    if optimizer.sgd_lr is None or not isinstance(mixer, ComposedMixer):
        return None
    if mixer.traced_wire or not isinstance(mixer.transport, DenseTransport) \
            or not isinstance(mixer.wire, IdentityWire) \
            or mixer.transport.compute_dtype != torch.float32:
        return None
    if mixer.w.shape[0] > MAX_NODES:
        return None
    return mixer.w


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


def build_train_step(loss_fn: LossFn, optimizer: Optimizer, mixer: Mixer,
                     cfg: TrainStepConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    ``loss_fn(params, batch)`` takes the node-stacked params and batch and
    returns the (K,) per-node mean losses.  The metrics dict has the keys
    of the reference's step (``repro/core/drdsgd.py:242-258``).
    """
    if cfg.compression is not None and cfg.compression.enabled \
            and mixer.compression is None:
        raise ValueError(
            "TrainStepConfig.compression is set but the mixer is "
            "uncompressed — build it with the same CompressionConfig")
    fused_w = _fused_w(optimizer, mixer)

    def train_step(state: DecentralizedState, batch):
        if not isinstance(state.comm, CommState):
            raise ValueError(
                "DecentralizedState.comm must be the mixer's CommState — "
                "build the state with init_state(params, optimizer, mixer=mixer)")
        names = leaf_names(state.params)
        leaves = [state.params[n].detach().requires_grad_(True) for n in names]
        losses = loss_fn(dict(zip(names, leaves)), batch)
        grads = dict(zip(names, torch.autograd.grad(losses.sum(), leaves)))
        losses = losses.detach()
        if cfg.grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip, nodes=True,
                                           inplace=_owned(grads))
        # --- the paper's technique: exponential per-node gradient reweighting
        scale = robust_scale(losses, cfg.robust)   # (K,)
        lam = mixture_weights(losses, cfg.robust)  # (K,) adversarial λ*
        if fused_w is not None:
            # scale, SGD and the dense consensus round: one pass over every
            # leaf of a dtype (one B.1 launch per step on the card)
            eta = optimizer.sgd_lr(state.step)
            mixed = {}
            for group in _dtype_groups(state.params, names):
                outs = gossip_update_stacked_grouped(
                    [state.params[n] for n in group], [grads[n] for n in group], fused_w,
                    scale, eta=eta)
                mixed.update(zip(group, outs))
            mixed = {n: mixed[n] for n in names}
            del grads  # a node-stacked copy of the parameters: free it before the metrics
            opt_state, comm = state.opt_state, mixer.round_state(state.params, state.comm)
        else:
            scaled = {n: g * _node_scale(scale, g) for n, g in grads.items()}
            # --- local optimizer step (plain SGD in the paper)
            updated, opt_state = optimizer.update(scaled, state.opt_state,
                                                  state.params, state.step)
            # --- consensus: the only cross-node communication of the algorithm
            mixed, comm = mixer(updated, state.comm, round=state.step)
        # wire bytes this step: the round's measured wire on time-varying
        # stacks, else the static estimate
        comm_bytes = (comm.wire_bits / 8.0 if mixer.traced_wire
                      else scalar(mixer.bytes_per_round(state.params), losses.device))
        metrics = {
            "comm_bytes": comm_bytes,
            "loss_mean": losses.mean(),
            "loss_worst": losses.max(),
            "loss_std": losses.std(correction=0),
            "robust_objective": robust_objective(losses, cfg.robust),
            "scale_mean": scale.mean(),
            "scale_max": scale.max(),
            "lambda_max": lam.max(),
            "wire_bits": comm.metrics.wire_bits,
            "ef_residual_norm": comm.metrics.res_norm,
            "disagreement": tree_node_disagreement(mixed),
        }
        return DecentralizedState(mixed, opt_state, state.step + 1, comm), metrics

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
