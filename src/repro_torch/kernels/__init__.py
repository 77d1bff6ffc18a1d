"""Hand-written Hopper kernels of the port, one package per reference kernel
family (``repro.kernels.*``): the CUDA source under ``csrc/``, the ctypes
wrapper (``kernel.py``), its plain PyTorch version (``ref.py``) and the
dispatcher the rest of the port calls (``ops.py``)."""

COUNTERS = ("launches", "tensor_qmax_launches")
FAMILIES = ("flash_attention", "gossip_update", "quant_gossip", "rwkv6_scan")


def launch_counters() -> list[tuple[object, str]]:
    """Every launch counter of the kernel wrappers, as (wrapper, attribute)
    pairs: each wrapper adds to its ``launches`` (and B.2's grouped call to
    ``tensor_qmax_launches``) where it launches its kernel.  The trainer's
    captured step replays kernels without running the wrappers, so it
    adds each capture's increments to these on every replay."""
    import importlib

    out, seen = [], set()
    for family in FAMILIES:
        mod = importlib.import_module(f"repro_torch.kernels.{family}.kernel")
        for name in sorted(vars(mod)):
            fn = getattr(mod, name)
            if not callable(fn) or id(fn) in seen:
                continue
            seen.add(id(fn))
            out.extend((fn, attr) for attr in COUNTERS
                       if isinstance(getattr(fn, attr, None), int))
    return out
