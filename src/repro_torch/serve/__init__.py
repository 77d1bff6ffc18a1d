"""LM serving (the port of ``repro.serve``): static-batch generation, and
continuous batching over a paged KV pool.

* :class:`ServeEngine` (:mod:`repro_torch.serve.engine`): the engine, one
  decode step over every slot per step, per-request admission prefill, a
  host loop that reads one (2, B) output per step.
* :class:`Scheduler` / :class:`PageAllocator`: host-side slot and page
  admission control (FIFO, whole reservations).
* :mod:`repro_torch.serve.prefill`: prompt ingestion into contiguous and
  paged caches; the static-batch :func:`greedy_generate` loop.
* :mod:`repro_torch.serve.traffic`: open-loop Poisson traces over mixed
  request classes.
* :mod:`repro_torch.serve.sampling`: token selection with per-slot
  temperature.
"""

from repro_torch.serve.engine import Completion, ServeEngine
from repro_torch.serve.pool import TRASH_PAGE, PageAllocator, pages_needed
from repro_torch.serve.prefill import (
    clear_slot_state,
    greedy_generate,
    merge_prefill_cache,
    place_paged_prefill,
)
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import Admission, Request, Scheduler
from repro_torch.serve.traffic import SMOKE_CLASSES, TrafficClass, poisson_trace

__all__ = [
    "ServeEngine", "Completion",
    "Scheduler", "Request", "Admission",
    "PageAllocator", "TRASH_PAGE", "pages_needed",
    "greedy_generate", "merge_prefill_cache", "place_paged_prefill", "clear_slot_state",
    "sample_tokens",
    "TrafficClass", "SMOKE_CLASSES", "poisson_trace",
]
