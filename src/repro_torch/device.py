"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import os

import torch

# PyTorch's caching allocator with expandable segments: freed memory is
# reused in place instead of stranded in segments a live tensor still pins
ALLOC_CONF = "expandable_segments:True"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` is the default everywhere; it raises when no CUDA device is
    present instead of carrying on on the CPU.  Pass ``"cpu"`` to run the
    plain PyTorch versions (the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def expandable_segments() -> None:
    """Set ``PYTORCH_CUDA_ALLOC_CONF`` to :data:`ALLOC_CONF` unless the
    caller set it; it takes effect where no CUDA memory has been allocated
    yet.  The entry points that train LM steps call it first: the
    caching allocator otherwise strands freed memory in split segments,
    eager and captured alike (qwen2-0.5b at K = 8 on an H100 80GB HBM3 at
    700 W, ``tests/captured_memory_probe.py``: 47.4–47.5 GB allocated at
    the peak in either mode, reserved 54.08 GB eager and 49.99 GB captured
    with expandable segments, 69.82 GB and 65.68 GB without)."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
