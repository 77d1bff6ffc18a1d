"""Request admission control for the continuous-batching engine (the port
of ``repro.serve.scheduler``).

The :class:`Scheduler` is pure host bookkeeping and never touches a
tensor: it owns the free slot list, one
:class:`~repro_torch.serve.pool.PageAllocator` per attention kind and a
FIFO of waiting requests.  The engine asks it who can run next and tells it
which slot finished.

Admission is FIFO without reordering: if the head of the queue does not
fit (no free slot, or its page reservation exceeds the free pages of some
kind), everything behind it waits.  The head-of-line blocking keeps
per-class latency ordering honest for an open-loop trace.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.serve.pool import PageAllocator, pages_needed


@dataclasses.dataclass
class Request:
    """One generation request (input to the engine)."""

    rid: int
    prompt: np.ndarray          # (s0,) int32 token ids
    max_new: int                # generation budget (tokens; EOS may cut it)
    temperature: float = 0.0    # 0 = greedy
    arrival: float = 0.0        # open-loop arrival time (s, or steps)
    cls: str = "default"        # traffic-class label for per-class latency

    @property
    def s0(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class Admission:
    """One admission decision: request -> slot + page reservation."""

    req: Request
    slot: int
    pages: dict[str, list[int]]     # kind -> page ids (reservation)


class Scheduler:
    """Slots + pages + FIFO queue; pure host state."""

    def __init__(self, max_batch: int, page_size: int,
                 num_pages: dict[str, int], ring_len: dict[str, int]):
        self.max_batch = max_batch
        self.page_size = page_size
        self.ring_len = dict(ring_len)
        self.allocators = {k: PageAllocator(n) for k, n in num_pages.items()}
        self._free_slots = list(range(max_batch - 1, -1, -1))
        self.waiting: collections.deque[Request] = collections.deque()
        self.running: dict[int, Admission] = {}

    def reservation(self, req: Request) -> dict[str, int]:
        """Pages ``req`` holds per kind for its whole lifetime."""
        return {k: pages_needed(req.s0, req.max_new, self.ring_len[k], self.page_size)
                for k in self.allocators}

    def submit(self, req: Request) -> None:
        """Queue a request; reject one that could never fit."""
        if "attn" in self.ring_len and req.s0 + req.max_new - 1 > self.ring_len["attn"]:
            raise ValueError(
                f"request {req.rid}: s0+max_new-1 = {req.s0 + req.max_new - 1} exceeds "
                f"max_len {self.ring_len['attn']} — full-attention layers would "
                f"wrap their ring and overwrite early context")
        for kind, need in self.reservation(req).items():
            cap = self.allocators[kind].capacity
            if need > cap:
                raise ValueError(
                    f"request {req.rid} needs {need} {kind!r} pages but the pool only "
                    f"has {cap} — raise num_pages or shrink s0+max_new")
        self.waiting.append(req)

    def next_admission(self) -> Admission | None:
        """Pop (request, slot, pages) if the queue head fits; else None."""
        if not self.waiting or not self._free_slots:
            return None
        req = self.waiting[0]
        need = self.reservation(req)
        if not all(self.allocators[k].can_alloc(n) for k, n in need.items()):
            return None
        self.waiting.popleft()
        adm = Admission(req=req, slot=self._free_slots.pop(),
                        pages={k: self.allocators[k].alloc(n) for k, n in need.items()})
        self.running[adm.slot] = adm
        return adm

    def release(self, slot: int) -> Request:
        """Return a finished slot's pages and the slot to the free pools."""
        adm = self.running.pop(slot)
        for kind, pages in adm.pages.items():
            self.allocators[kind].free(pages)
        self._free_slots.append(slot)
        return adm.req

    @property
    def active_slots(self) -> int:
        return len(self.running)

    @property
    def queued(self) -> int:
        return len(self.waiting)

    def occupancy(self) -> float:
        """Worst-kind page occupancy in [0, 1] (0 with no attention kinds)."""
        if not self.allocators:
            return 0.0
        return max(a.occupancy() for a in self.allocators.values())

    def pages_used(self) -> int:
        return sum(a.used_pages for a in self.allocators.values())

    def pages_total(self) -> int:
        return sum(a.capacity for a in self.allocators.values())
