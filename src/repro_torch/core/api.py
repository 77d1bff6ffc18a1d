"""High-level DecentralizedTrainer: graph + mixer + step, one object.

The port of ``repro.core.api``:

    trainer = DecentralizedTrainer(
        loss_fn, predict_fn, num_nodes=10,
        graph="erdos_renyi", graph_kwargs={"p": 0.3},
        robust=RobustConfig(mu=6.0), lr=0.05)            # device="cuda"
    state = trainer.init(params_single)
    state, metrics = trainer.step(state, batch)
    state, ms = trainer.run(state, batches)              # stacked metrics
    state, ms = trainer.run(state, batches, epoch_steps=50,
                            on_epoch=lambda e, st, m: ...)  # a hook between epochs
    accs = trainer.eval_per_node(state, x_test, y_test)

``dynamics`` (a :class:`~repro_torch.dynamics.DynamicsConfig`) runs the
dense lowering over a time-varying topology with faults and local updates,
or the federated hub; the gossip lowering comes in as a pre-built ``mixer``
(``make_gossip_mixer``, ``DynamicGossipMixer``, wrapped in a
``LocalUpdateMixer`` where wanted), as in the reference.  ``mix_every`` > 1
mixes every ``mix_every``-th step only.  ``loss_fn`` and ``predict_fn`` are node-stacked (see
:mod:`repro_torch.models.paper_nets`).  Batches may be numpy arrays or
tensors; they are moved to the trainer's device.

``jit=True`` (the default, the reference's field) runs the step as the
reference's compiled step does: where
:func:`~repro_torch.core.drdsgd.capture_declined` keeps the stack (any
optimizer of :mod:`repro_torch.optim`, any of the port's mixers — a static
or time-varying topology with or without faults, dense, gossip or the
hub, any codec wire and rate schedule, local updates with or without
gradient tracking, repeated rounds, ``mix_every`` — no ``obs``, no
``sanitize``, no noise hook or replaced fault seam, and a loss that
batches its nodes), ``step`` and ``run`` replay the step (the fused B.1
step for plain SGD over an uncompressed dense W, else the optimizer and
the round) from CUDA graphs on the card, one graph per branch the host
chooses from its clocks (local or consensus round, mix step, re-base),
with the carry donated: the state a run is given gives up its
parameters, optimizer state and θ̂, and a state kept from an earlier run is
written over (:mod:`repro_torch.core.captured`).  On the CPU the same capturable form
runs eagerly, and states are copied in and out.  ``capture_declined``
names why any other stack runs the eager step (None where the step is
captured); ``_run`` carries ``_cache_size``, the programs captured, for
:class:`repro_torch.obs.RecompileWatchdog`.  ``jit=False`` runs the eager
step on every stack, and ``run`` is a loop over it.

``obs`` (a :class:`repro_torch.obs.MetricsSink`) streams one ``train``
record per step: ``step`` and ``run`` pop the step's packed record from its
metrics and queue it in the sink, which moves the queue to the host in one
copy when it is read.  ``sanitize=True`` stages the in-step invariant
checks of :mod:`repro_torch.analysis.sanitize`; ``step`` reads their flags
after its step and ``run`` after each epoch (one device-to-host copy each)
and raises :class:`~repro_torch.analysis.sanitize.SanitizeError` naming the
failed checks and their first steps.  Both leave the metrics and the
trajectory bit-exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.comm import CompressionConfig
from repro_torch.comm.protocol import Mixer
from repro_torch.core.captured import CapturedRun
from repro_torch.core.consensus import make_dense_mixer, make_identity_mixer
from repro_torch.core.drdsgd import (
    DecentralizedState,
    TrainStepConfig,
    build_eval_step,
    build_train_step,
    capture_declined,
    init_state,
    replicate_params,
)
from repro_torch.core.robust import RobustConfig
from repro_torch.device import resolve_device
from repro_torch.dynamics import build_dynamic_mixer
from repro_torch.graphs import (
    build_graph,
    max_degree_weights,
    metropolis_weights,
    spectral_norm,
)
from repro_torch.obs.profiler import PhaseTimer
from repro_torch.optim import Optimizer, sgd


def _stack_metrics(ms: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


class _EagerRun:
    """Steps ``lo..hi-1`` of stacked batches through the eager step, the
    metrics stacked on the device; ``obs`` (a sink, or None) gets each
    step's packed record.  With ``jit=True`` on a declined stack it carries
    ``_cache_size``: no program is captured."""

    def __init__(self, train_step, obs, jit: bool):
        self._step, self._obs = train_step, obs
        if jit:
            self._cache_size = lambda: 0

    def segment(self, state, batches, lo: int, hi: int):
        ms = []
        for t in range(lo, hi):
            state, m = self._step(state, tuple(b[t] for b in batches))
            ms.append(m if self._obs is None else self._obs.tap_drain(m))
        return state, _stack_metrics(ms)


class _Run:
    """The trainer's ``_run(state, batches)``: every step of the stacked
    batches (the reference's jitted scan), with the runner's
    ``_cache_size`` where it has one."""

    def __init__(self, runner, device: torch.device):
        self._runner, self._device = runner, device
        if hasattr(runner, "_cache_size"):
            self._cache_size = runner._cache_size

    def __call__(self, state, batches):
        batches = tuple(torch.as_tensor(b).to(self._device) for b in batches)
        return self._runner.segment(state, batches, 0, batches[0].shape[0])


def run_segments(trainer: "DecentralizedTrainer", state, sample_batch,
                 steps: int, seg: int, on_segment=None, *, obs=None):
    """Drive ``trainer.run`` in host-sampled segments.

    ``sample_batch(step) -> batch`` of numpy leaves; batches are stacked
    ``seg`` at a time and moved to the device in one copy per leaf.
    ``on_segment(last_step, state, seg_metrics)`` runs between segments.
    The state is handed to ``trainer.run`` without a reference kept here, so
    a segment's first state is freed after its first step (at LM widths a
    node-stacked copy of the parameters is many GB).

    ``obs`` (a :class:`repro_torch.obs.MetricsSink`) adds the phase-timer
    rollup: every chunk emits one ``perf`` record (steps/s, wire bytes/s,
    wall-clock per ``sample``/``run``/``hook`` phase), and the ``run``
    phase ends by reading the segment's wire bytes, which waits for its
    steps: one synchronisation per segment, so the timings are wall-clock
    honest.
    """
    timer = PhaseTimer()
    done, box = 0, [state]  # the box holds the only reference between segments
    del state
    while done < steps:
        n = min(seg, steps - done)
        with timer.phase("sample"):
            samples = [sample_batch(done + i) for i in range(n)]
            stacked = tuple(np.stack(parts) for parts in zip(*samples))
        with timer.phase("run"):
            state, ms = trainer.run(box.pop(), stacked)
            # with a sink, wait for the segment here: its one synchronisation
            wire = float(ms["comm_bytes"].sum()) if obs is not None else None
        done += n
        if on_segment is not None:
            with timer.phase("hook"):
                on_segment(done - 1, state, ms)
        box.append(state)
        del state
        if obs is not None:
            obs.log("perf", done - 1, **timer.rollup(steps=n, wire_bytes=wire))
        timer.reset()
    return box.pop()


@dataclasses.dataclass
class DecentralizedTrainer:
    """Decentralized (DR-)DSGD trainer over a communication graph."""

    loss_fn: Callable[[Any, Any], torch.Tensor]
    predict_fn: Callable[[Any, Any], torch.Tensor] | None = None
    num_nodes: int = 10
    graph: str = "erdos_renyi"
    graph_kwargs: dict = dataclasses.field(default_factory=dict)
    robust: RobustConfig = dataclasses.field(default_factory=RobustConfig)
    optimizer: Optimizer | None = None
    lr: float = 0.05
    grad_clip: float | None = None
    mixer: Mixer | None = None            # override (e.g. the gossip lowering)
    mixing: str = "metropolis"            # or "max_degree", "none"
    compression: CompressionConfig | None = None
    dynamics: Any = None                  # repro_torch.dynamics.DynamicsConfig:
                                          # time-varying topology, faults,
                                          # local updates, hub; None =
                                          # static synchronous consensus
    mix_every: int = 1                    # consensus period (local SGD when > 1)
    device: str | torch.device = "cuda"
    obs: Any = None                       # repro_torch.obs.MetricsSink: one
                                          # train record per step; None = no
                                          # telemetry
    sanitize: bool = False                # in-step invariant checks
                                          # (repro_torch.analysis.sanitize),
                                          # raised at a segment's end
    jit: bool = True                      # capture the step in CUDA graphs
                                          # where capture_declined keeps the
                                          # stack; False = the eager step

    def __post_init__(self):
        self.device = resolve_device(self.device)
        g = build_graph(self.graph, self.num_nodes, **self.graph_kwargs)
        if not g.is_connected():
            raise ValueError("communication graph must be connected (Assumption 5)")
        self.graph_obj = g
        if self.mixing == "none":
            self.w = np.eye(self.num_nodes)
        elif self.mixing == "metropolis":
            self.w = metropolis_weights(g)
        elif self.mixing == "max_degree":
            self.w = max_degree_weights(g)
        else:
            raise ValueError(f"unknown mixing {self.mixing!r}")
        self.rho = spectral_norm(self.w)
        dyn = self.dynamics if (self.dynamics is not None
                                and self.dynamics.enabled) else None
        if self.mixer is None:
            if dyn is not None and self.mixing != "none":
                # time-varying topology: the dense-lowering stack
                self.mixer = build_dynamic_mixer(dyn, self.w, compression=self.compression,
                                                 device=self.device)
            else:
                self.mixer = (
                    make_identity_mixer() if self.mixing == "none"
                    else make_dense_mixer(self.w, compression=self.compression,
                                          device=self.device))
        else:
            if dyn is not None:
                raise ValueError(
                    "both a pre-built mixer and a DynamicsConfig were "
                    "provided — wrap the mixer yourself (repro_torch.dynamics."
                    "LocalUpdateMixer / DynamicGossipMixer) or drop one")
            if self.compression is not None and self.compression.enabled \
                    and self.mixer.compression is None:
                raise ValueError(
                    "compression is set but the provided mixer is uncompressed; "
                    "build the mixer with the same CompressionConfig")
        if self.optimizer is None:
            self.optimizer = sgd(self.lr)
        step_cfg = TrainStepConfig(robust=self.robust, grad_clip=self.grad_clip,
                                   mix_every=self.mix_every, compression=self.compression)
        self._checks = None
        if self.sanitize:
            from repro_torch.analysis.sanitize import SanitizeFlags

            self._checks = SanitizeFlags()
        self._train_step = build_train_step(self.loss_fn, self.optimizer,
                                            self.mixer, step_cfg, obs=self.obs,
                                            sanitize=self._checks)
        self.capture_declined = "jit=False" if not self.jit else capture_declined(
            self.loss_fn, self.optimizer, self.mixer, self.mix_every, obs=self.obs,
            sanitize=self.sanitize)
        if self.capture_declined is None:
            self._runner = CapturedRun(self._train_step, self.device)
        else:
            self._runner = _EagerRun(self._train_step, self.obs, self.jit)
        self._run = _Run(self._runner, self.device)
        if self.predict_fn is not None:
            self._eval_step = build_eval_step(self.predict_fn)

    # -- helpers --------------------------------------------------------------

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _batch(self, batch):
        return tuple(self._to_device(b) for b in batch)

    def _drain_tap(self, metrics: dict) -> dict:
        """Queue the step's packed record in the sink and drop it from the
        metrics, which are then the same with the sink on or off."""
        if self.obs is None:
            return metrics
        return self.obs.tap_drain(metrics)

    def _throw(self) -> None:
        """Raise if a sanitizer check failed since the last read."""
        if self._checks is not None:
            self._checks.throw()

    # -- public API ---------------------------------------------------------

    def init(self, params_single) -> DecentralizedState:
        """All nodes start at the same point (Lemma 3 precondition)."""
        params = {n: self._to_device(x) for n, x in params_single.items()}
        return self.init_stacked(replicate_params(params, self.num_nodes))

    def init_stacked(self, node_params) -> DecentralizedState:
        params = {n: self._to_device(node_params[n]) for n in sorted(node_params)}
        return init_state(params, self.optimizer, mixer=self.mixer)

    @property
    def captured(self) -> bool:
        """Whether ``step`` and ``run`` take the captured step."""
        return self.capture_declined is None

    def step(self, state: DecentralizedState, batch):
        """One train step on a (K, B, ...) batch; metrics are 0-d tensors.
        With ``sanitize`` it reads the checks' flags after the step.  A
        captured trainer runs it as a run of one step."""
        batch = self._batch(batch)
        if self.captured:
            state, ms = self._runner.segment(state, tuple(b.unsqueeze(0) for b in batch), 0, 1)
            return state, {k: v[0] for k, v in ms.items()}
        state, metrics = self._train_step(state, batch)
        self._throw()
        return state, self._drain_tap(metrics)

    def run(self, state: DecentralizedState, batches, *, steps: int | None = None,
            epoch_steps: int | None = None, on_epoch=None):
        """Run many train steps; ``batches`` is the step batch stacked along a
        leading time axis (every leaf (T, K, ...)).  Returns
        (final_state, metrics) with every metric stacked to (steps,).

        ``epoch_steps``/``on_epoch``: the reference's hook for eval and
        logging.  The steps run in epochs of ``epoch_steps`` (the last one
        ragged) and ``on_epoch(epoch_index, state, epoch_metrics)`` runs
        between them, each metric of the epoch stacked to (its steps,);
        without a split (no hook, no ``epoch_steps``, or ``epoch_steps >=
        steps``) it runs once after the last step with index 0.  The steps
        are the same steps either way (eager, or replays of the captured
        step), so the split changes no bit.  With ``sanitize``, each epoch's
        checks are read at its end, before ``on_epoch``.
        """
        batches = self._batch(batches)
        total = batches[0].shape[0]
        if steps is None:
            steps = total
        elif steps > total:
            raise ValueError(f"steps={steps} > stacked batches T={total}")
        if on_epoch is None or epoch_steps is None or epoch_steps >= steps:
            epoch_steps = steps
        chunks, box = [], [state]  # the box holds the only reference between epochs
        del state
        for e, start in enumerate(range(0, steps, epoch_steps)):
            # handed over without a name here: the runner frees (or, captured,
            # takes over) the epoch's first state after its first step
            state, ms = self._runner.segment(box.pop(), batches, start,
                                             min(start + epoch_steps, steps))
            self._throw()
            chunks.append(ms)
            if on_epoch is not None:
                on_epoch(e, state, chunks[-1])
            box.append(state)
            del state
        return box.pop(), {key: torch.cat([c[key] for c in chunks]) for key in chunks[0]}

    def eval_per_node(self, state: DecentralizedState, x, y) -> torch.Tensor:
        if self.predict_fn is None:
            raise ValueError("predict_fn not provided")
        return self._eval_step(state.params, self._to_device(x), self._to_device(y))

    def eval_local_distributions(self, state: DecentralizedState, x_nodes,
                                 y_nodes) -> dict:
        """Paper §6.2 protocol: device i's model on device i's distribution.

        x_nodes: (K, n, ...), y_nodes: (K, n).  Worst distribution test
        accuracy = min_i acc(θ_i, D_i^test); fairness = STDEV across devices.
        """
        if self.predict_fn is None:
            raise ValueError("predict_fn not provided")
        with torch.no_grad():
            logits = self.predict_fn(state.params, self._to_device(x_nodes))
            accs = (logits.argmax(-1) == self._to_device(y_nodes).long()
                    ).float().mean(-1).cpu().numpy()
        return {
            "acc_avg": float(accs.mean()),
            "acc_worst_dist": float(accs.min()),
            "acc_node_std": float(accs.std()),
            "acc_node_min": float(accs.min()),
            "acc_nodes": [float(a) for a in accs],
        }

    def eval_worst_distribution(self, state: DecentralizedState, per_class_sets
                                ) -> dict:
        """Paper's metrics: avg / worst-distribution accuracy + STDEV.

        Worst-distribution accuracy = min over the non-empty subsets of the
        mean node accuracy; per-node stats use each node's own model on the
        union of the subsets.
        """
        kept = [(x, y) for x, y in per_class_sets if len(y)]
        if not kept:
            raise ValueError(
                "eval_worst_distribution needs at least one non-empty test "
                "subset; all per_class_sets entries are empty")
        accs = [float(self.eval_per_node(state, x, y).mean()) for x, y in kept]
        x_all = np.concatenate([np.asarray(x) for x, _ in kept])
        y_all = np.concatenate([np.asarray(y) for _, y in kept])
        node_accs = self.eval_per_node(state, x_all, y_all).cpu().numpy()
        return {
            "acc_avg": float(node_accs.mean()),
            "acc_worst_dist": float(min(accs)),
            "acc_node_std": float(node_accs.std()),
            "acc_node_min": float(node_accs.min()),
            "acc_nodes": [float(a) for a in node_accs],
        }
