"""``repro_torch.obs`` — observability for the training and serving stack
(the port of ``repro.obs``).

* **Streaming telemetry** (:mod:`repro_torch.obs.sink`): the train step
  packs its per-step record into one float32 payload on the device, queued
  and drained to the host in one device-to-host copy per read, into a host
  ring buffer and schema-versioned JSONL (:mod:`repro_torch.obs.schema`);
  the metrics callers see and the trajectory are the same bits with the
  sink on or off, and console lines are formatters over the same records.
* **Profiler scopes** (:mod:`repro_torch.obs.profiler`): ``obs:...`` ranges
  on the gradient / DR-weighting / local-update / consensus / sanitizer /
  tap phases (no-ops while no profiler is open), a wall-clock
  :class:`PhaseTimer` rolled up per ``run_segments`` chunk, and a
  ``--profile`` Chrome trace.
* **Event tracing** (:mod:`repro_torch.obs.trace`): the ``trace`` record
  kind — serve request lifecycle spans and host-derived trainer round
  events (fault / EF re-base / rate switch), exportable to
  Chrome/perfetto trace-event JSON and mergeable onto a ``--profile``
  timeline.
* **Streaming histograms** (:mod:`repro_torch.obs.hist`): fixed-bin counts
  over per-node loss / DR weights / EF innovation computed on the device
  and riding the tap's decimated vector payload.
* **Run report + regression gate** (:mod:`repro_torch.obs.report`):
  ``python -m repro_torch.obs report|compare``.
* **Recompile watchdog** (:mod:`repro_torch.obs.watchdog`): counts of the
  trainer's captured programs (:class:`RecompileWatchdog`, over
  ``_cache_size()``) and a process-wide capture counter
  (:func:`expect_compiles`), where the reference counts JAX's compiled
  programs.
"""

from repro_torch.obs.hist import TRAIN_HISTOGRAMS, HistSpec, hist_counts
from repro_torch.obs.profiler import (
    PhaseTimer,
    find_perfetto_trace,
    host_scope,
    profile,
    scope,
)
from repro_torch.obs.report import (
    load_records,
    render_html,
    render_text,
    serve_latency_summary,
    summarize_run,
)
from repro_torch.obs.schema import (
    SCHEMA_VERSION,
    validate_jsonl,
    validate_record,
)
from repro_torch.obs.sink import (
    MetricsSink,
    format_eval,
    format_meta,
    format_perf,
    format_record,
    format_serve,
    format_trace,
    format_train,
)
from repro_torch.obs.trace import (
    export_chrome_trace,
    merge_with_profile,
    to_chrome_events,
    trainer_trace_events,
)
from repro_torch.obs.watchdog import (
    CompileCounter,
    RecompileError,
    RecompileWatchdog,
    expect_compiles,
    jit_cache_size,
)

__all__ = [
    "SCHEMA_VERSION", "validate_jsonl", "validate_record",
    "MetricsSink", "format_train", "format_eval", "format_perf",
    "format_meta", "format_record", "format_serve", "format_trace",
    "PhaseTimer", "scope", "host_scope", "profile", "find_perfetto_trace",
    "HistSpec", "hist_counts", "TRAIN_HISTOGRAMS",
    "trainer_trace_events", "to_chrome_events", "export_chrome_trace",
    "merge_with_profile",
    "load_records", "summarize_run", "serve_latency_summary",
    "render_text", "render_html",
    "RecompileWatchdog", "RecompileError", "CompileCounter",
    "expect_compiles", "jit_cache_size",
]
