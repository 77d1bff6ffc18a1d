"""PyTorch/CUDA port of the DR-DSGD reproduction (``repro``) for one NVIDIA H100.

The package mirrors ``repro``'s layout module by module and is held against it
on shared inputs by ``tests/test_torch_*.py``.  It imports torch and numpy,
never jax and nothing of ``repro``.  Entry points take an explicit ``device``
and default to ``"cuda"``; without a CUDA device they raise unless the caller
asks for ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
