"""Recompile watchdog: captured-program counts and a global capture counter
(the port of ``repro.obs.watchdog``).

The reference guards its zero-recompile invariant by counting the programs
``jax.jit`` compiled.  The port's counterpart of a compiled program is a
captured one: the trainer's step replayed from CUDA graphs
(:mod:`repro_torch.core.captured`, one program, a CUDA graph, per batch
signature).  The same API counts them:

* :class:`RecompileWatchdog` snapshots ``_cache_size()`` of tracked
  callables (``DecentralizedTrainer._run`` carries one, as the reference's
  jitted ``_run`` does) and raises :class:`RecompileError` (or warns) when
  a callable captured more programs than its budget.

* :func:`expect_compiles` counts *process-wide* captures around a region,
  from the events :func:`record_capture` publishes where the reference
  listens to ``jax.monitoring``.

Both report, on violation, which callable grew and by how much.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

_LISTENERS: list[Callable[..., None]] = []


def record_capture(event: str) -> None:
    """Publish one capture (``event`` names it) to every listening
    :class:`CompileCounter`."""
    for listener in list(_LISTENERS):
        listener(event)


class RecompileError(RuntimeError):
    """An observed capture count exceeded the declared budget."""


def jit_cache_size(fn) -> int:
    """Captured-program count of a callable that carries ``_cache_size``
    (the trainer's ``_run``)."""
    cs = getattr(fn, "_cache_size", None)
    if cs is None:
        raise ValueError(
            f"{fn!r} has no _cache_size — pass the captured callable "
            "(e.g. trainer._run of a trainer built with jit=True), not the python function")
    return int(cs())


class RecompileWatchdog:
    """Guard captured callables against unexpected recaptures.

    Usage::

        watch = RecompileWatchdog(label="fig9 dropout sweep")
        watch.track("run", trainer._run, allowed=1)
        ... drive the run ...
        watch.check()            # raises RecompileError on a recapture

    ``allowed`` is the capture budget per callable *from the moment it was
    tracked* (1 = the initial capture and nothing else).  ``check(extra=n)``
    tolerates n extra programs across the board.

    ``on_violation="warn"`` logs instead of raising (a user run should
    finish, a benchmark should fail loudly).
    """

    def __init__(self, on_violation: str = "raise", label: str = ""):
        if on_violation not in ("raise", "warn"):
            raise ValueError(f"on_violation must be 'raise'|'warn', "
                             f"got {on_violation!r}")
        self.on_violation = on_violation
        self.label = label
        self._tracked: dict[str, dict[str, Any]] = {}
        self.violations: list[str] = []

    def track(self, name: str, fn: Callable, allowed: int = 1) -> "RecompileWatchdog":
        """Start guarding ``fn`` (chainable). Baseline = its current count."""
        self._tracked[name] = {"fn": fn, "baseline": jit_cache_size(fn), "allowed": allowed}
        return self

    def programs(self, name: str) -> int:
        """Programs captured since ``track`` (0 = not yet executed)."""
        t = self._tracked[name]
        return jit_cache_size(t["fn"]) - t["baseline"]

    def snapshot(self) -> dict[str, int]:
        return {name: self.programs(name) for name in self._tracked}

    def check(self, extra_allowed: int = 0) -> dict[str, int]:
        """Verify every tracked callable stayed within budget.

        Returns the per-callable program counts; raises/warns on violation.
        """
        snap = self.snapshot()
        for name, programs in snap.items():
            budget = self._tracked[name]["allowed"] + extra_allowed
            if programs > budget:
                self._violate(
                    f"{name} captured {programs} programs "
                    f"(budget {budget}) — an input's shape or dtype changed "
                    f"between steps")
        return snap

    def _violate(self, msg: str) -> None:
        full = f"recompile watchdog{f' [{self.label}]' if self.label else ''}: {msg}"
        self.violations.append(full)
        if self.on_violation == "raise":
            raise RecompileError(full)
        warnings.warn(full, RuntimeWarning, stacklevel=3)


class CompileCounter:
    """Process-wide capture counter: counts every capture the port reports
    (:func:`record_capture`) while active."""

    def __init__(self):
        self.count = 0
        self.events: list[str] = []

    def _listener(self, event: str) -> None:
        self.count += 1
        self.events.append(event)

    def __enter__(self) -> "CompileCounter":
        _LISTENERS.append(self._listener)
        return self

    def __exit__(self, *exc) -> None:
        if self._listener in _LISTENERS:
            _LISTENERS.remove(self._listener)


class _ExpectCompiles:
    def __init__(self, at_most: int, label: str, on_violation: str):
        self.at_most = at_most
        self.watch = RecompileWatchdog(on_violation=on_violation, label=label)
        self.counter = CompileCounter()

    @property
    def count(self) -> int:
        return self.counter.count

    def __enter__(self) -> "_ExpectCompiles":
        self.counter.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.counter.__exit__(exc_type, exc, tb)
        if exc_type is None and self.counter.count > self.at_most:
            self.watch._violate(
                f"region performed {self.counter.count} captures "
                f"(budget {self.at_most})")


def expect_compiles(at_most: int, *, label: str = "",
                    on_violation: str = "raise") -> _ExpectCompiles:
    """Context manager: fail if the region captures more than ``at_most``
    programs::

        with expect_compiles(at_most=1, label=tag):
            trainer.run(state, batches)     # 1 capture
    """
    return _ExpectCompiles(at_most, label, on_violation)
