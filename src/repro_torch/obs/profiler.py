"""Profiler scopes and wall-clock phase timing for the training and serving
stack (the port of ``repro.obs.profiler``).

Three layers, cheapest first:

* :func:`scope` — names a phase of the step on the profiler timeline
  (``torch.profiler.record_function``): the gradient, DR-weighting, local
  update, consensus, sanitizer and tap phases of the train step and each
  mixer's round carry ``obs:...`` names, so a ``--profile`` trace attributes
  kernels to algorithm phases.  The steps are host-bound and a range costs
  host time, so a scope is a no-op while no profiler is open.
* :func:`host_scope` — the same for host-side phases (batch sampling, eval
  hooks, segment dispatch).
* :class:`PhaseTimer` — plain wall-clock accounting per phase, rolled up per
  ``run_segments`` chunk into ``perf`` telemetry records (steps/s, wire
  bytes/s) by :func:`repro_torch.core.api.run_segments`.

:func:`profile` wraps a region in ``torch.profiler.profile`` (CPU and CUDA
activities) and writes a Chrome trace-event JSON under the log directory
(open it at https://ui.perfetto.dev); :func:`find_perfetto_trace` finds it.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import torch

TRACE_DIR = "profile"   # <log_dir>/profile/<stamp>.trace.json


def scope(name: str):
    """Phase range on the profiler timeline; a no-op while no profiler is
    open.  Pure metadata: it never changes what the step computes."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


host_scope = scope


class PhaseTimer:
    """Wall-clock seconds per named phase; one rollup per logging chunk.

    Usage::

        timer = PhaseTimer()
        with timer.phase("sample"): batches = ...
        with timer.phase("run"):    state, ms = trainer.run(state, batches)
        rec = timer.rollup(steps=n, wire_bytes=float(ms["comm_bytes"].sum()))
        timer.reset()

    Each ``phase`` block is also a :func:`host_scope` (``obs:<name>``), so a
    ``--profile`` trace shows the same phase names the rollup reports.
    """

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        with host_scope(f"obs:{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def reset(self) -> None:
        self.phases = {}

    def rollup(self, *, steps: int = 0, wire_bytes: float | None = None,
               run_phase: str = "run") -> dict:
        """The chunk's ``perf`` record fields (see repro_torch.obs.schema).

        ``steps_per_s`` divides by the ``run_phase`` time when present (the
        segment's steps, waited for), else by the total; ``wall_s`` is always
        the total across phases.
        """
        wall = sum(self.phases.values())
        run_s = self.phases.get(run_phase, wall)
        rec = {
            "wall_s": wall,
            "steps": steps,
            "steps_per_s": (steps / run_s) if steps and run_s > 0 else 0.0,
            "phase_s": {k: round(v, 6) for k, v in self.phases.items()},
        }
        if wire_bytes is not None and run_s > 0:
            rec["wire_bytes_per_s"] = wire_bytes / run_s
        return rec


def find_perfetto_trace(log_dir: str) -> str | None:
    """The newest Chrome trace a :func:`profile` run wrote under ``log_dir``."""
    pats = [os.path.join(log_dir, TRACE_DIR, "*.trace.json.gz"),
            os.path.join(log_dir, TRACE_DIR, "*.trace.json")]
    hits = sorted(h for p in pats for h in glob.glob(p))
    return hits[-1] if hits else None


@contextlib.contextmanager
def profile(log_dir: str | None, enabled: bool = True):
    """Wrap a region in ``torch.profiler.profile`` and yield a result holder.

    ``enabled=False`` (or ``log_dir=None``) is a no-op, so call sites can
    thread a ``--profile`` flag straight through.  CUDA activity is recorded
    when a card is present.  On exit the trace is written to
    ``<log_dir>/profile/<stamp>.trace.json`` and the holder's
    ``trace_path`` points at it (and ``profiler`` at the finished
    ``torch.profiler.profile``).
    """
    holder = type("ProfileResult", (), {"trace_path": None, "profiler": None})()
    if not enabled or log_dir is None:
        yield holder
        return
    out_dir = os.path.join(log_dir, TRACE_DIR)
    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    path = os.path.join(out_dir, time.strftime("%Y%m%d-%H%M%S")
                        + f"-{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    holder.trace_path = path
    holder.profiler = prof
