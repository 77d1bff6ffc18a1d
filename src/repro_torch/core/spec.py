"""Declarative trainer construction shared by the CLI and the chip smoke run.

The port of ``repro.core.spec`` for what the port runs: the graph with
Metropolis (or max-degree) mixing, DR-DSGD or DSGD, the consensus period
``mix_every``, the consensus wire ``compress`` ∈ {"none", "bf16", "int8",
"int4", "topk", "randk"} with its kept fraction ``compress_ratio`` and rate
schedule (``compress_schedule``, ``schedule_threshold``,
``schedule_warmup``, ``schedule_rounds``), or a pre-built
:class:`~repro_torch.comm.CompressionConfig` (the hand-in the benchmarks
use), and the dynamics (``topology`` including the federated ``hub``,
``drop_p``, ``radius``, ``local_updates``, ``gradient_tracking``,
``ef_rebase_every``, ``ef_rebase_threshold``, and the faults
``straggler_p``, ``outage_p``, ``outage_len``,
``straggler_skips_compute``: see :class:`~repro_torch.dynamics.DynamicsConfig`).
As in the reference, the gossip lowering comes in through
``build(..., mixer=...)``.

    spec = TrainerSpec(num_nodes=10, graph="erdos_renyi", compress="int8")
    trainer = spec.build(loss_fn, predict_fn)

The CLI installs the reference's flag names, ``--sanitize`` (the in-step
invariant checks of :mod:`repro_torch.analysis.sanitize`) among them, and
:func:`add_obs_cli_args` the observability flags.  The codec flags come
from :func:`add_compression_cli_args` (which :func:`compression_from_args`
reads back), shared with entry points that build raw mixers.  The one flag the
reference lacks is ``--device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.comm import CompressionConfig, ScheduleConfig
from repro_torch.core.api import DecentralizedTrainer
from repro_torch.core.robust import RobustConfig
from repro_torch.dynamics import TOPOLOGY_KINDS, DynamicsConfig, FaultConfig

_GRAPH_CHOICES = ("ring", "grid", "torus", "erdos_renyi", "geometric",
                  "complete", "star", "hypercube")
_COMPRESS_CHOICES = ("none", "bf16", "int8", "int4", "topk", "randk")
_SCHEDULE_CHOICES = ("none", "constant", "linear", "adaptive")


def add_dynamics_cli_args(ap) -> None:
    """Install the dynamic-graph, fault and local-update flags
    (``repro_torch.dynamics``) on an argparse parser."""
    ap.add_argument("--topology", default="static", choices=TOPOLOGY_KINDS,
                    help="per-round topology process: static graph, "
                         "round-robin matchings, Bernoulli link dropout, "
                         "per-round geometric re-draws, or hub — federated "
                         "server averaging (FedAvg with --local-updates; "
                         "SCAFFOLD with --gradient-tracking)")
    ap.add_argument("--drop-p", type=float, default=0.0,
                    help="link dropout probability for --topology dropout")
    ap.add_argument("--radius", type=float, default=0.5,
                    help="connection radius for --topology geometric")
    ap.add_argument("--local-updates", type=int, default=1,
                    help="H: optimizer steps per consensus round "
                         "(local SGD between mixes when > 1)")
    ap.add_argument("--gradient-tracking", action="store_true",
                    help="carry the local-update drift correction "
                         "(2x consensus wire; uncompressed mixers only)")
    ap.add_argument("--ef-rebase-every", type=int, default=8,
                    help="B: re-base period of the error-feedback "
                         "compressed gossip wire over a time-varying "
                         "topology (0 = never; static schedules only)")
    ap.add_argument("--ef-rebase-threshold", type=float, default=0.0,
                    help="adaptive re-base: re-base when the EF cache "
                         "drift exceeds this threshold (0 = clock)")
    ap.add_argument("--straggler-p", type=float, default=0.0,
                    help="per-node per-round probability of skipping "
                         "communication")
    ap.add_argument("--outage-p", type=float, default=0.0,
                    help="per-window probability a node is down for a whole "
                         "outage window (correlated faults)")
    ap.add_argument("--outage-len", type=int, default=10,
                    help="rounds per outage window")
    ap.add_argument("--straggler-skips-compute", action="store_true",
                    help="down nodes (stragglers/outages) lose their "
                         "gradient too: the robust per-node scale is masked "
                         "with the round's up vector")


def add_compression_cli_args(ap) -> None:
    """Install the standard consensus wire-codec flags on an argparse parser
    (the reference's ``add_compression_cli_args``; :meth:`TrainerSpec.add_cli_args`
    installs them too)."""
    ap.add_argument("--compress", default="none", choices=_COMPRESS_CHOICES,
                    help="consensus wire codec (repro_torch.comm)")
    ap.add_argument("--compress-ratio", type=float, default=0.01,
                    help="kept fraction for topk/randk")
    ap.add_argument("--compress-schedule", default="none", choices=_SCHEDULE_CHOICES,
                    help="adapt the codec rate during training "
                         "(repro_torch.comm.schedule): int8->int4 / annealed "
                         "topk ratio, driven by rounds (linear) or the "
                         "error-feedback innovation norm (adaptive)")
    ap.add_argument("--schedule-threshold", type=float, default=0.5,
                    help="adaptive: innovation-norm fraction below which "
                         "the rate anneals")
    ap.add_argument("--schedule-warmup", type=int, default=10,
                    help="adaptive: full-rate rounds before the reference "
                         "norm is latched")
    ap.add_argument("--schedule-rounds", type=int, default=300,
                    help="linear: rounds to anneal full -> aggressive rate")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="ablation: memoryless compression (stalls at the "
                         "quantization noise floor)")


def compression_from_args(args, seed: int = 0) -> CompressionConfig | None:
    """The CompressionConfig that :func:`add_compression_cli_args`'s flags
    describe (the reference's ``compression_from_args``): a thin CLI
    wrapper over :meth:`TrainerSpec.compression_config`, raising SystemExit
    instead of ValueError for flag misuse."""
    spec = TrainerSpec(
        compress=args.compress,
        compress_ratio=args.compress_ratio,
        error_feedback=not args.no_error_feedback,
        compress_schedule=args.compress_schedule,
        schedule_threshold=args.schedule_threshold,
        schedule_warmup=args.schedule_warmup,
        schedule_rounds=args.schedule_rounds,
        seed=getattr(args, "seed", seed),
    )
    try:
        return spec.compression_config()
    except ValueError as e:
        raise SystemExit(
            "--compress-schedule needs a codec: pass --compress "
            "int8|int4|topk|randk") from e


def add_obs_cli_args(ap) -> None:
    """Install the observability flags (``repro_torch.obs``) on an argparse
    parser.

    ``--log-every`` is deliberately not here: entry points own their logging
    cadence (it doubles as the ``run_segments`` chunk length).
    """
    ap.add_argument("--log-dir", default=None,
                    help="write schema-versioned JSONL telemetry "
                         "(repro_torch.obs.MetricsSink: per-step train records, "
                         "eval fairness metrics, per-chunk perf rollups) "
                         "into this directory")
    ap.add_argument("--profile", action="store_true",
                    help="wrap the run in torch.profiler and write a Chrome "
                         "trace under --log-dir (phases carry obs:... range "
                         "names)")
    ap.add_argument("--tap-vectors-every", type=int, default=8,
                    help="decimation of the tap's vector payload: per-node "
                         "losses / DR weights / histogram counts land on "
                         "every N-th train record (scalars land every "
                         "step; 1 = vectors every step)")


@dataclasses.dataclass
class TrainerSpec:
    """Everything needed to build a :class:`DecentralizedTrainer`, declaratively."""

    num_nodes: int = 10
    graph: str = "erdos_renyi"
    graph_kwargs: dict = dataclasses.field(default_factory=dict)
    mixing: str = "metropolis"
    mu: float = 6.0
    robust: bool = True
    lr: float = 0.05
    grad_clip: float | None = None
    mix_every: int = 1
    compress: str | CompressionConfig | None = "none"  # codec kind, or a
                                                       # pre-built config
    compress_ratio: float = 0.01
    error_feedback: bool = True
    compress_schedule: str = "none"
    schedule_threshold: float = 0.5
    schedule_warmup: int = 10
    schedule_rounds: int = 300
    topology: str = "static"              # per-round topology process
    drop_p: float = 0.0                   # link dropout for topology=dropout
    radius: float = 0.5                   # radius for topology=geometric
    local_updates: int = 1                # H: steps per consensus round
    gradient_tracking: bool = False       # local-update drift correction
    ef_rebase_every: int = 8              # B: EF-gossip hat_mix re-base period
    ef_rebase_threshold: float = 0.0      # adaptive re-base drift threshold
    straggler_p: float = 0.0              # per-round node comm skips
    outage_p: float = 0.0                 # correlated node outages
    outage_len: int = 10
    straggler_skips_compute: bool = False  # down nodes lose their gradient too
    seed: int = 0
    jit: bool = True                      # capture the step (DecentralizedTrainer.jit)
    sanitize: bool = False                # in-step invariant checks
    device: str = "cuda"

    def robust_config(self) -> RobustConfig:
        return RobustConfig(mu=self.mu, enabled=self.robust)

    def dynamics_config(self) -> DynamicsConfig | None:
        """The :class:`DynamicsConfig` this spec describes, or None for a
        static synchronous setup."""
        faults = None
        if self.straggler_p > 0 or self.outage_p > 0:
            faults = FaultConfig(
                straggler_p=self.straggler_p, outage_p=self.outage_p,
                outage_len=self.outage_len, seed=self.seed,
                straggler_skips_compute=self.straggler_skips_compute)
        cfg = DynamicsConfig(
            topology=self.topology, drop_p=self.drop_p, radius=self.radius,
            local_updates=self.local_updates,
            gradient_tracking=self.gradient_tracking,
            ef_rebase_every=self.ef_rebase_every,
            ef_rebase_threshold=self.ef_rebase_threshold,
            faults=faults, seed=self.seed)
        return cfg if cfg.enabled else None

    def compression_config(self) -> CompressionConfig | None:
        if isinstance(self.compress, CompressionConfig):
            # a pre-built config passes through (benchmarks hand these in)
            return self.compress if self.compress.enabled else None
        if self.compress is None or self.compress == "none":
            if self.compress_schedule != "none":
                raise ValueError("compress_schedule needs a codec "
                                 "(compress='int8'|'int4'|'topk'|'randk')")
            return None
        schedule = None
        if self.compress_schedule != "none":
            schedule = ScheduleConfig(
                kind=self.compress_schedule,
                threshold=self.schedule_threshold,
                warmup_rounds=self.schedule_warmup,
                anneal_rounds=self.schedule_rounds,
            )
        return CompressionConfig(
            kind=self.compress, ratio=self.compress_ratio,
            error_feedback=self.error_feedback, seed=self.seed,
            schedule=schedule,
        )

    def build(self, loss_fn, predict_fn=None, *, mixer=None, optimizer=None, obs=None
              ) -> DecentralizedTrainer:
        return DecentralizedTrainer(
            loss_fn,
            predict_fn=predict_fn,
            num_nodes=self.num_nodes,
            graph=self.graph,
            graph_kwargs=dict(self.graph_kwargs),
            robust=self.robust_config(),
            optimizer=optimizer,
            lr=self.lr,
            grad_clip=self.grad_clip,
            mixer=mixer,
            mixing=self.mixing,
            compression=self.compression_config(),
            dynamics=self.dynamics_config(),
            mix_every=self.mix_every,
            device=self.device,
            obs=obs,
            sanitize=self.sanitize,
            jit=self.jit,
        )

    # -- CLI integration ------------------------------------------------------

    @staticmethod
    def add_cli_args(ap) -> None:
        """Install the standard trainer flags (the reference's names).

        ``--nodes``/``--graph``/``--lr`` default to None so entry points can
        supply task-specific fallbacks via ``from_args(..., overrides)``.
        """
        ap.add_argument("--nodes", type=int, default=None)
        ap.add_argument("--graph", default=None, choices=_GRAPH_CHOICES)
        ap.add_argument("--p", type=float, default=0.3,
                        help="edge probability for erdos_renyi graphs")
        ap.add_argument("--mu", type=float, default=6.0)
        ap.add_argument("--dsgd", action="store_true", help="disable DR (baseline)")
        ap.add_argument("--mix-every", type=int, default=1,
                        help="consensus period (local SGD when > 1)")
        ap.add_argument("--lr", type=float, default=None)
        ap.add_argument("--seed", type=int, default=0)
        add_compression_cli_args(ap)
        ap.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch versions")
        ap.add_argument("--sanitize", action="store_true",
                        help="stage the in-step invariant checks (doubly "
                             "stochastic W, CHOCO drift, finite parameters, "
                             "binary link masks, in-container codec rate; "
                             "repro_torch.analysis.sanitize); a violation "
                             "raises at the end of its segment")
        add_dynamics_cli_args(ap)

    @classmethod
    def from_args(cls, args, **overrides: Any) -> "TrainerSpec":
        """Build a spec from an argparse namespace made by :meth:`add_cli_args`.

        For ``--nodes``/``--lr``/``--graph`` the CLI value wins when passed,
        otherwise the ``overrides`` fallback applies; every other flag is
        copied from ``args``.
        """
        spec = dict(overrides)
        spec.update(mu=args.mu, robust=not args.dsgd, compress=args.compress,
                    compress_ratio=args.compress_ratio,
                    error_feedback=not args.no_error_feedback,
                    compress_schedule=args.compress_schedule,
                    schedule_threshold=args.schedule_threshold,
                    schedule_warmup=args.schedule_warmup,
                    schedule_rounds=args.schedule_rounds,
                    mix_every=args.mix_every,
                    topology=args.topology, drop_p=args.drop_p, radius=args.radius,
                    local_updates=args.local_updates,
                    gradient_tracking=args.gradient_tracking,
                    ef_rebase_every=args.ef_rebase_every,
                    ef_rebase_threshold=args.ef_rebase_threshold,
                    straggler_p=args.straggler_p, outage_p=args.outage_p,
                    outage_len=args.outage_len,
                    straggler_skips_compute=args.straggler_skips_compute,
                    seed=args.seed, sanitize=args.sanitize, device=args.device)
        if args.nodes is not None:
            spec["num_nodes"] = args.nodes
        if args.lr is not None:
            spec["lr"] = args.lr
        if args.graph is not None:
            # only rebuild graph_kwargs when the CLI actually changes the
            # graph — re-naming the task's own graph must not clobber its
            # parameters (e.g. the paper's erdos_renyi p) with CLI defaults
            if args.graph != spec.get("graph") or "graph_kwargs" not in spec:
                spec["graph_kwargs"] = (
                    {"p": args.p, "seed": args.seed}
                    if args.graph == "erdos_renyi" else {})
            spec["graph"] = args.graph
        return cls(**spec)
