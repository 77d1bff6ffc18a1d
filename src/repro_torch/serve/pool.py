"""Host-side page accounting for the shared KV pools (the port of
``repro.serve.pool``).

The device holds, per attention kind ("attn" / "swa"), one page pool per
layer; all layers of a kind share one page geometry, so a single free list
per kind governs them all: page id ``p`` belongs to the same request in
every layer's pool.  Page 0 is the trash page: inactive slots' block-table
rows point at it, so their masked, never-read decode writes land somewhere
harmless and the table stays dense.

Allocation is a LIFO free list; admission takes whole reservations (a
request's worst-case page count, :func:`pages_needed`), so a running
request never stalls on a page it turns out to need.
"""

from __future__ import annotations

TRASH_PAGE = 0


def pages_needed(s0: int, max_new: int, ring_len: int, page_size: int) -> int:
    """Pages one request reserves in one kind's pools.

    The ring holds at most ``min(s0 + max_new - 1, ring_len)`` written
    positions (the prompt and every decoded token but the last, which is
    sampled and never written back).
    """
    used = min(s0 + max_new - 1, ring_len)
    return -(-used // page_size)


class PageAllocator:
    """LIFO free list over one kind's ``num_pages`` pages (page 0 trash)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is trash), got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, TRASH_PAGE, -1))

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free)

    def occupancy(self) -> float:
        return self.used_pages / self.capacity

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not (TRASH_PAGE < p < self.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
        self._free.extend(pages)
        if len(self._free) > self.capacity:
            raise RuntimeError("double free: free list exceeds capacity")
