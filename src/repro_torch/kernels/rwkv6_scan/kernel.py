"""The CUDA WKV6 kernels (B.7 and its backward): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan/kernel.py``
(``wkv6_scan``, ``pallas_call`` at ``:65``) with ``csrc/wkv6.cu``, and adds
its backward, ``csrc/wkv6_bwd.cu`` (the reference differentiates its XLA
scan instead), both built by :mod:`repro_torch.kernels._build`.  The
sources' header notes give their bounds and designs.  Beyond the TPU kernel
the forward starts from a given state and returns the final state, which
``rwkv_forward`` hands to the decode cache; the backward takes the final
state's cotangent and returns the initial state's.

r, k, v and w are (B, H, T, hd) views sharing one set of batch, head and
time strides (head dims contiguous), so the model passes its (B, T, D)
projections without a transposed copy; y and the gradients dr, dk, dv, dw
have r's memory layout.  The forward takes r, k, v, w and u in float32 or
bfloat16 (one dtype for all five; bfloat16 is widened as it is read, y is
written in it, as the TPU kernel does) at head dims 8, 16, 32 and 64; the
backward takes float32 at head dims 16 and 64 (``ops.WKV6`` widens saved
bfloat16 inputs for it).  s0, ds and the states are float32.  The wrappers
raise on anything else and never run the plain version themselves.  They record nothing for autograd, so
they refuse an input that requires grad while autograd records:
``ops.WKV6`` is the differentiable entry (its forward and backward run with
grad mode off).
Both stage chunks of r, k, w and v (and the backward's dy) by TMA where
every row is 16-byte aligned (:func:`rows_by_tma`; the model's views are;
the forward's bfloat16 chunks land raw and are widened in shared memory),
by plain loads otherwise; the backward raises where the CUDA driver
refuses the map of aligned rows.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "rwkv6_scan/csrc/wkv6.cu"
BWD_SOURCE = "rwkv6_scan/csrc/wkv6_bwd.cu"
HEAD_DIMS = (8, 16, 32, 64)
BWD_HEAD_DIMS = (16, 64)
DTYPES = (torch.float32, torch.bfloat16)
# the backward's shape per head dim, as csrc/wkv6_bwd.cu compiles it
# (Shape<hd>; ``bwd_shape`` reads it back): CTAs per cluster (the column
# split), columns per thread, steps per chunk (the checkpoint stride)
BWD_SHAPE = {16: dict(nc=1, j=2, c=16), 64: dict(nc=2, j=4, c=8)}
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = (_P,) * 8 + (_LL,) * 4 + (_LL,) * 6 + (_P,)
_SYMBOL = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_BWD_ARGTYPES = (_P,) * 16 + (_LL,) * 4 + (_LL,) * 9 + (_P,)


def rows_by_tma(x: torch.Tensor) -> bool:
    """True where the kernel stages this (B, H, T, hd) float32 or bfloat16
    CUDA view by TMA (its rows on 16 bytes and the driver takes the map),
    False where by plain loads (csrc/wkv6.cu, ``rows_map``).  Builds the
    kernels."""
    fn = _build.entry(SOURCE, "wkv6_rows_tma", (_P,) + (_LL,) * 8)
    b, h, t, hd = x.shape
    return bool(fn(x.data_ptr(), b, h, t, hd, *x.stride()[:3], x.element_size()))


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtypes: tuple = (torch.float32,)) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: this WKV6 kernel takes {', '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if torch.is_grad_enabled() and t.requires_grad:
        raise ValueError("the WKV6 kernels build no autograd graph: call ops.wkv6 "
                         "(ops.WKV6's backward is B.7's backward kernel) or run under "
                         "torch.no_grad()")


def _check_state(name: str, s, b, h, hd, device) -> None:
    if s is not None:
        _check(name, s, device)
        if s.shape != (b, h, hd, hd) or not s.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {(b, h, hd, hd)}, got "
                             f"{tuple(s.shape)}")


def check_head_dim(fn: str, hd: int, dims: tuple) -> None:
    if hd not in dims:
        raise ValueError(f"{fn} is built for head dims {dims}, got {hd}")


def _check_scan(fn: str, r, k, v, w, u, s0, dims=HEAD_DIMS, dtypes=DTYPES
                ) -> tuple[int, int, int, int]:
    """Validate the inputs of a kernel built for head dims ``dims`` and
    input dtypes ``dtypes``; returns (B, H, T, hd)."""
    if r.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got r on {r.device}")
    dev = r.device
    b, h, t, hd = r.shape
    check_head_dim(fn, hd, dims)
    _check("r", r, dev, dtypes)
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, x, dev, (r.dtype,))
        if x.shape != r.shape or x.stride() != r.stride():
            raise ValueError(f"{name} must have r's shape {tuple(r.shape)} and strides "
                             f"{r.stride()}, got {tuple(x.shape)} and {x.stride()}")
    if r.stride(3) != 1:
        raise ValueError(f"r, k, v, w need contiguous head dims, got strides {r.stride()}")
    _check("u", u, dev, (r.dtype,))
    if u.shape != (h, hd) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous {(h, hd)}, got {tuple(u.shape)}")
    _check_state("s0", s0, b, h, hd, dev)
    return b, h, t, hd


def wkv6_scan(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) or None (zero).

    Returns (y (B, H, T, hd) in r's dtype, final state (B, H, hd, hd)
    float32) on the card.  Launches the B.7 kernel on the current stream and
    adds one to ``wkv6_scan.launches``.
    """
    b, h, t, hd = _check_scan("wkv6_scan", r, k, v, w, u, s0)
    dev = r.device
    y = torch.empty_like(r)  # r's strides: the model's (B, T, H, hd) memory
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    if t == 0 or b * h == 0:
        return y, state.copy_(s0) if s0 is not None else state.zero_()
    fn = _build.entry(SOURCE, _SYMBOL[r.dtype], _ARGTYPES)
    _build.launch(fn, _SYMBOL[r.dtype], dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(), _ptr(s0), y.data_ptr(), state.data_ptr(), b, h,
                  t, hd, *r.stride()[:3], *y.stride()[:3])
    wkv6_scan.launches += 1
    return y, state


# launches since the last reset (the main path's proof of use)
wkv6_scan.launches = 0


def wkv6_bwd(r, k, v, w, u, dy, s0=None, ds=None):
    """The backward of :func:`wkv6_scan` at the same inputs: dy (B, H, T, hd)
    with any strides (head dims contiguous), ds, the final state's
    cotangent, (B, H, hd, hd) or None (zero).

    Returns (dr, dk, dv, dw in r's memory layout, du (H, hd), ds0 (B, H, hd,
    hd), or None when s0 is None), float32 on the card.  Launches the
    backward kernel (and its sum of du over the batches) on the current
    stream and adds one to ``wkv6_bwd.launches``.  Scratch: the state at
    the start of every ``chunk(hd)`` steps but the first, B H (ceil(T /
    chunk) - 1) hd^2 floats; du's sums per batch.
    """
    b, h, t, hd = _check_scan("wkv6_bwd", r, k, v, w, u, s0, BWD_HEAD_DIMS, (torch.float32,))
    dev = r.device
    _check("dy", dy, dev)
    if dy.shape != r.shape or dy.stride(3) != 1:
        raise ValueError(f"dy must be {tuple(r.shape)} with contiguous head dims, got "
                         f"{tuple(dy.shape)} strides {dy.stride()}")
    _check_state("ds", ds, b, h, hd, dev)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))  # one layout, r's
    du = torch.empty((h, hd), dtype=torch.float32, device=dev)
    ds0 = None if s0 is None else torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    if t == 0 or b * h == 0:
        for x in (dr, dk, dv, dw, du):
            x.zero_()
        if ds0 is not None:
            ds0.zero_() if ds is None else ds0.copy_(ds)
        return dr, dk, dv, dw, du, ds0
    n_ck = max(-(-t // chunk(hd)) - 1, 1)
    ckpt = torch.empty(b * h * n_ck * hd * hd, dtype=torch.float32, device=dev)
    du_part = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = _build.entry(BWD_SOURCE, "wkv6_bwd_f32", _BWD_ARGTYPES)
    _build.launch(fn, "wkv6_bwd_f32", dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(), _ptr(s0), dy.data_ptr(), _ptr(ds), dr.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(), _ptr(ds0),
                  ckpt.data_ptr(), du_part.data_ptr(), b, h, t, hd, *r.stride()[:3],
                  *dy.stride()[:3], *dr.stride()[:3])
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


def _ptr(x):
    return None if x is None else x.data_ptr()


def bwd_shape(hd: int) -> dict:
    """The backward's shape at head dim ``hd`` as compiled (the keys of
    :data:`BWD_SHAPE`).  Builds the kernels."""
    fn = _build.entry(BWD_SOURCE, "wkv6_bwd_shape", (_LL, _P))
    fn.restype = None
    out = (_LL * 3)()
    fn(hd, ctypes.addressof(out))
    return dict(zip(("nc", "j", "c"), out))


def chunk(hd: int) -> int:
    """The backward's checkpoint stride at head dim ``hd``, as compiled
    (csrc/wkv6_bwd.cu).  Builds the kernels."""
    return _build.entry(BWD_SOURCE, "wkv6_bwd_chunk", (_LL,))(hd)


# launches since the last reset (the main path's proof of use)
wkv6_bwd.launches = 0
