"""The CUDA WKV6 kernel (B.7): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan/kernel.py``
(``wkv6_scan``, ``pallas_call`` at ``:65``) with ``csrc/wkv6.cu``, built by
:mod:`repro_torch.kernels._build`.  The source's header note gives its bound
and design.  Beyond the TPU kernel it starts from a given state and returns
the final state, which ``rwkv_forward`` hands to the decode cache.

r, k, v and w are (B, H, T, hd) views sharing one set of batch, head and
time strides (head dims contiguous), so the model passes its (B, T, D)
projections without a transposed copy; y has r's memory layout.  The
wrapper raises on what the kernel does not take — a dtype other than
float32, a head dim other than 16 or 64, an input that requires grad (the
reference has no backward) — and never runs the plain version itself.
The kernel stages the chunks of r, k, w and v by TMA where every row is
16-byte aligned (:func:`rows_by_tma`; the model's views are), by plain loads
otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "rwkv6_scan/csrc/wkv6.cu"
HEAD_DIMS = (16, 64)
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = (_P,) * 8 + (_LL,) * 4 + (_LL,) * 6 + (_P,)


def rows_by_tma(x: torch.Tensor) -> bool:
    """True where the kernel stages this (B, H, T, hd) CUDA view by TMA (its
    rows on 16 bytes and the driver takes the map), False where by plain
    loads (csrc/wkv6.cu, ``rows_map``).  Builds the kernels."""
    fn = _build.entry(SOURCE, "wkv6_rows_tma", (_P,) + (_LL,) * 7)
    b, h, t, hd = x.shape
    return bool(fn(x.data_ptr(), b, h, t, hd, *x.stride()[:3]))


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"wkv6_scan takes float32, got {name} {t.dtype}")
    if t.requires_grad:
        raise ValueError("wkv6_scan has no backward: call it on tensors that do not "
                         "require grad (torch.inference_mode())")


def wkv6_scan(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) or None (zero).

    Returns (y (B, H, T, hd), final state (B, H, hd, hd)), float32 on the
    card.  Launches the B.7 kernel on the current stream and adds one to
    ``wkv6_scan.launches``.
    """
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan needs CUDA tensors, got r on {r.device}")
    dev = r.device
    b, h, t, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_scan is built for head dims {HEAD_DIMS}, got {hd}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, x, dev)
        if x.shape != r.shape or x.stride() != r.stride():
            raise ValueError(f"{name} must have r's shape {tuple(r.shape)} and strides "
                             f"{r.stride()}, got {tuple(x.shape)} and {x.stride()}")
    if r.stride(3) != 1:
        raise ValueError(f"r, k, v, w need contiguous head dims, got strides {r.stride()}")
    _check("u", u, dev)
    if u.shape != (h, hd) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous {(h, hd)}, got {tuple(u.shape)}")
    if s0 is not None:
        _check("s0", s0, dev)
        if s0.shape != (b, h, hd, hd) or not s0.is_contiguous():
            raise ValueError(f"s0 must be a contiguous {(b, h, hd, hd)}, got "
                             f"{tuple(s0.shape)}")
    y = torch.empty_like(r)  # r's strides: the model's (B, T, H, hd) memory
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    if t == 0 or b * h == 0:
        return y, state.copy_(s0) if s0 is not None else state.zero_()
    fn = _build.entry(SOURCE, "wkv6_f32", _ARGTYPES)
    _build.launch(fn, "wkv6_f32", dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
                  y.data_ptr(), state.data_ptr(), b, h, t, hd, *r.stride()[:3],
                  *y.stride()[:3])
    wkv6_scan.launches += 1
    return y, state


# launches since the last reset (the main path's proof of use)
wkv6_scan.launches = 0
