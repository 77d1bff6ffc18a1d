"""The CUDA flash-attention kernel (B.6): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``, ``pallas_call`` at ``:100``) with
``csrc/flash_fwd.cu``, built by :mod:`repro_torch.kernels._build`.  The
source's header note gives its bound and design.

The wrapper takes the JAX op's layout, q (B, H, S, hd) and k, v (B, KVH, T,
hd), as views with any batch, head and sequence strides (head dims
contiguous), so the model hands over its (B, S, KVH, G, hd) q and (B, T,
KVH, hd) k/v without a transposed copy; the output has q's memory layout.
It raises on what the kernel does not take — a dtype other than float32,
a head dim other than 16, 64, 80 or 128, an input that requires grad (the
reference has no backward) — and never runs the plain version itself.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention/csrc/flash_fwd.cu"
HEAD_DIMS = (16, 64, 80, 128)
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P) + (_LL,) * 6 + (_LL,) * 12 + (
    ctypes.c_float, ctypes.c_int, _LL, ctypes.c_float, _P)


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"flash_attention_fwd takes float32, got {name} {t.dtype}")
    if t.requires_grad:
        raise ValueError("flash_attention_fwd has no backward: call it on tensors "
                         "that do not require grad (torch.inference_mode())")
    if t.ndim != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be 4-d with contiguous head dims, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KVH, T, hd) CUDA float32 -> (B, H, S, hd).

    Launches the B.6 kernel on the current stream and adds one to
    ``flash_attention_fwd.launches``.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd needs CUDA tensors, got q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device)
    b, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd is built for head dims {HEAD_DIMS}, got {hd}")
    if k.shape != (b, kvh, t, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, KVH, T, hd) = {(b, kvh, t, hd)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = torch.empty_like(q)  # q's strides: the model's (B, S, H, hd) memory
    if out.numel() == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention_fwd needs at least one key")
    fn = _build.entry(SOURCE, "flash_fwd_f32", _ARGTYPES)
    _build.launch(fn, "flash_fwd_f32", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, h, kvh, s, t, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], 1.0 / hd ** 0.5, int(causal),
                  0 if window is None else int(window),
                  0.0 if softcap is None else float(softcap))
    flash_attention_fwd.launches += 1
    return out


# launches since the last reset (the main path's proof of use)
flash_attention_fwd.launches = 0
