"""Declarative trainer construction shared by the CLI and the chip smoke run.

The port of ``repro.core.spec`` for what the port runs: the graph with
Metropolis (or max-degree) mixing, DR-DSGD or DSGD, the consensus wire
``compress`` ∈ {"none", "int8"} or a pre-built
:class:`~repro_torch.comm.CompressionConfig` (the hand-in the benchmarks
use), and a time-varying topology (``topology``, ``drop_p``, ``radius``,
``ef_rebase_every``, ``ef_rebase_threshold``: see
:class:`~repro_torch.dynamics.DynamicsConfig`).  As in the reference, the
gossip lowering comes in through ``build(..., mixer=...)``.

    spec = TrainerSpec(num_nodes=10, graph="erdos_renyi", compress="int8")
    trainer = spec.build(loss_fn, predict_fn)

The CLI installs the reference's flag names.  Flags of features that are
not ported yet are accepted by the parser and raise ``NotImplementedError``
naming the slice that will port them when set to anything but their
default.  The one flag the reference lacks is ``--device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.comm import CompressionConfig
from repro_torch.core.api import DecentralizedTrainer
from repro_torch.core.robust import RobustConfig
from repro_torch.dynamics import TOPOLOGY_KINDS, DynamicsConfig

_GRAPH_CHOICES = ("ring", "grid", "torus", "erdos_renyi", "geometric",
                  "complete", "star", "hypercube")
_COMPRESS_CHOICES = ("none", "bf16", "int8", "int4", "topk", "randk")
_PORTED_COMPRESS = ("none", "int8")

_LOCAL = "the local-updates slice (LocalUpdateMixer)"
_FAULTS = "the faults slice"
_SCHEDULES = "the codecs slice (rate schedules)"
# flag -> (argparse kwargs, default, slice that ports it)
_UNPORTED_FLAGS = {
    "--compress-ratio": (dict(type=float), 0.01, "the codecs slice (topk/randk)"),
    "--compress-schedule": (dict(), "none", _SCHEDULES),
    "--schedule-threshold": (dict(type=float), 0.5, _SCHEDULES),
    "--schedule-warmup": (dict(type=int), 10, _SCHEDULES),
    "--schedule-rounds": (dict(type=int), 300, _SCHEDULES),
    "--mix-every": (dict(type=int), 1, _LOCAL),
    "--local-updates": (dict(type=int), 1, _LOCAL),
    "--gradient-tracking": (dict(action="store_true"), False, _LOCAL),
    "--straggler-p": (dict(type=float), 0.0, _FAULTS),
    "--outage-p": (dict(type=float), 0.0, _FAULTS),
    "--outage-len": (dict(type=int), 10, _FAULTS),
    "--straggler-skips-compute": (dict(action="store_true"), False, _FAULTS),
    "--sanitize": (dict(action="store_true"), False,
                   "the tooling slice (runtime invariant checks)"),
}


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


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
    compress: str | CompressionConfig | None = "none"  # codec kind, or a
                                                       # pre-built config
    error_feedback: bool = True
    topology: str = "static"              # per-round topology process
    drop_p: float = 0.0                   # link dropout for topology=dropout
    radius: float = 0.5                   # radius for topology=geometric
    ef_rebase_every: int = 8              # B: EF-gossip hat_mix re-base period
    ef_rebase_threshold: float = 0.0      # adaptive re-base drift threshold
    seed: int = 0
    device: str = "cuda"

    def robust_config(self) -> RobustConfig:
        return RobustConfig(mu=self.mu, enabled=self.robust)

    def dynamics_config(self) -> DynamicsConfig | None:
        """The :class:`DynamicsConfig` this spec describes, or None for a
        static synchronous setup."""
        cfg = DynamicsConfig(
            topology=self.topology, drop_p=self.drop_p, radius=self.radius,
            ef_rebase_every=self.ef_rebase_every,
            ef_rebase_threshold=self.ef_rebase_threshold, seed=self.seed)
        return cfg if cfg.enabled else None

    def compression_config(self) -> CompressionConfig | None:
        if isinstance(self.compress, CompressionConfig):
            # a pre-built config passes through (benchmarks hand these in)
            return self.compress if self.compress.enabled else None
        if self.compress is None or self.compress == "none":
            return None
        if self.compress not in _PORTED_COMPRESS:
            raise NotImplementedError(
                f"compress={self.compress!r} is not ported yet; it waits for "
                f"the codecs slice (bf16/int4/topk/randk)")
        return CompressionConfig(kind=self.compress,
                                 error_feedback=self.error_feedback,
                                 seed=self.seed)

    def build(self, loss_fn, predict_fn=None, *, mixer=None, optimizer=None
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
            device=self.device,
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
        ap.add_argument("--lr", type=float, default=None)
        ap.add_argument("--seed", type=int, default=0)
        ap.add_argument("--compress", default="none", choices=_COMPRESS_CHOICES,
                        help="consensus wire codec; this port runs none and int8")
        ap.add_argument("--no-error-feedback", action="store_true",
                        help="ablation: memoryless compression")
        ap.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch versions")
        ap.add_argument("--topology", default="static", choices=TOPOLOGY_KINDS,
                        help="per-round topology process: static graph, "
                             "round-robin matchings, Bernoulli link dropout or "
                             "per-round geometric re-draws (hub is not ported)")
        ap.add_argument("--drop-p", type=float, default=0.0,
                        help="link dropout probability for --topology dropout")
        ap.add_argument("--radius", type=float, default=0.5,
                        help="connection radius for --topology geometric")
        ap.add_argument("--ef-rebase-every", type=int, default=8,
                        help="B: re-base period of the error-feedback "
                             "compressed gossip wire over a time-varying "
                             "topology (0 = never; static schedules only)")
        ap.add_argument("--ef-rebase-threshold", type=float, default=0.0,
                        help="adaptive re-base: re-base when the EF cache "
                             "drift exceeds this threshold (0 = clock)")
        for flag, (kwargs, default, _) in _UNPORTED_FLAGS.items():
            ap.add_argument(flag, default=default, help="not ported yet", **kwargs)

    @classmethod
    def from_args(cls, args, **overrides: Any) -> "TrainerSpec":
        """Build a spec from an argparse namespace made by :meth:`add_cli_args`.

        For ``--nodes``/``--lr``/``--graph`` the CLI value wins when passed,
        otherwise the ``overrides`` fallback applies; every other flag is
        copied from ``args``.  A flag of an unported feature set to anything
        but its default raises ``NotImplementedError``.
        """
        for flag, (_, default, later) in _UNPORTED_FLAGS.items():
            if getattr(args, _dest(flag), default) != default:
                raise NotImplementedError(f"{flag} is not ported yet; it waits for {later}")
        if args.compress not in _PORTED_COMPRESS:
            raise NotImplementedError(
                f"--compress {args.compress} is not ported yet; it waits for "
                f"the codecs slice (bf16/int4/topk/randk)")
        spec = dict(overrides)
        spec.update(mu=args.mu, robust=not args.dsgd, compress=args.compress,
                    error_feedback=not args.no_error_feedback,
                    topology=args.topology, drop_p=args.drop_p, radius=args.radius,
                    ef_rebase_every=args.ef_rebase_every,
                    ef_rebase_threshold=args.ef_rebase_threshold,
                    seed=args.seed, device=args.device)
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
