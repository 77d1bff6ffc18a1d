"""The CUDA flash-attention kernels (B.6 and its backward): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``, ``pallas_call`` at ``:100``) with
``csrc/flash_fwd.cu``, and adds its backward, ``csrc/flash_bwd.cu`` (the
reference differentiates its XLA attention instead), both built by
:mod:`repro_torch.kernels._build`.  The sources' header notes give their
bounds and designs: both run their products on the tensor cores, each
float32 product as three TF32 products (``csrc/tc_tf32.cuh``); the
forward's bfloat16 instances take raw bfloat16 tiles staged by TMA and
issue bfloat16 products (``csrc/tc_bf16.cuh``).  The backward writes no
float atomics, so its gradients repeat bit for bit.

The wrappers take the JAX op's layout, q (B, H, S, hd) and k, v (B, KVH, T,
hd), as views with any batch, head and sequence strides (head dims
contiguous), so the model hands over its (B, S, KVH, G, hd) q and (B, T,
KVH, hd) k/v without a transposed copy; outputs and gradients have their
input's memory layout.  The forward writes the row log-sum-exp (B, H, S)
when asked, which the backward recomputes the softmax from.  The forward
takes q, k and v in float32 or bfloat16 (one dtype for the three; with
bfloat16 every product and the softmax are float32 sums of exact products,
as the TPU kernel's widened arithmetic, and the output is written in it;
lse is float32) at head dims 8, 16, 32, 64, 80 and 128; the backward
takes float32 at head dims 16, 32, 64, 80 and 128 (``ops.FlashAttention``
widens saved bfloat16 inputs for it).  Each wrapper raises on anything
else, and the forward on an input that requires grad while autograd
records (``ops.flash_attention`` is the differentiable entry); neither runs
the plain version itself, and each adds one to its ``.launches`` per
call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention/csrc/flash_fwd.cu"
BWD_SOURCE = "flash_attention/csrc/flash_bwd.cu"
HEAD_DIMS = (8, 16, 32, 64, 80, 128)
BWD_HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_MASK = (ctypes.c_float, ctypes.c_int, _LL, ctypes.c_float, _P)  # scale .. stream
_ARGTYPES = (_P,) * 5 + (_LL,) * 6 + (_LL,) * 12 + _MASK
_BWD_ARGTYPES = (_P,) * 10 + (_LL,) * 6 + (_LL,) * 24 + _MASK
_SYMBOL = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtypes: tuple = (torch.float32,)) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: this flash-attention kernel takes "
                        f"{', '.join(map(str, dtypes))}, got {t.dtype}")
    if t.ndim != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be 4-d with contiguous head dims, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def check_head_dim(name: str, hd: int, dims: tuple) -> None:
    if hd not in dims:
        raise ValueError(f"{name} is built for head dims {dims}, got {hd}")


def _check_qkv(name: str, q, k, v, window, softcap, dims=HEAD_DIMS, dtypes=DTYPES
               ) -> tuple[int, ...]:
    """Validate q, k, v and the mask for a kernel built for head dims
    ``dims`` and input dtypes ``dtypes``; returns (B, H, KVH, S, T, hd)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got q on {q.device}")
    _check("q", q, q.device, dtypes)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check(arg, t, q.device, (q.dtype,))
    b, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    check_head_dim(name, hd, dims)
    if k.shape != (b, kvh, t, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, KVH, T, hd) = {(b, kvh, t, hd)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if b * h * s and t == 0:
        raise ValueError(f"{name} needs at least one key")
    return b, h, kvh, s, t, hd


def _mask_args(hd, causal, window, softcap) -> tuple:
    return (1.0 / hd ** 0.5, int(causal), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None, return_lse: bool = False):
    """q: (B, H, S, hd); k, v: (B, KVH, T, hd) CUDA float32 or bfloat16 ->
    out (B, H, S, hd) in q's dtype, and with ``return_lse`` also the row
    log-sum-exp (B, H, S) float32.

    Launches the B.6 kernel on the current stream and adds one to
    ``flash_attention_fwd.launches``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention_fwd builds no autograd graph: call "
                         "ops.flash_attention (its backward is B.6's backward kernel) "
                         "or run under torch.no_grad()")
    b, h, kvh, s, t, hd = _check_qkv("flash_attention_fwd", q, k, v, window, softcap)
    out = torch.empty_like(q)  # q's strides: the model's (B, S, H, hd) memory
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel():
        fn = _build.entry(SOURCE, _SYMBOL[q.dtype], _ARGTYPES)
        _build.launch(fn, _SYMBOL[q.dtype], q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      b, h, kvh, s, t, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *out.stride()[:3], *_mask_args(hd, causal, window, softcap))
        flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, softcap: float | None = None):
    """The gradient of :func:`flash_attention_fwd`: given its inputs, its
    output ``out`` and row log-sum-exp ``lse`` and the output's gradient
    ``dout`` (B, H, S, hd), returns (dq, dk, dv) in q's, k's and v's memory
    layouts.

    Launches the B.6 backward kernels (``csrc/flash_bwd.cu``) on the current
    stream and adds one to ``flash_attention_bwd.launches``.
    """
    b, h, kvh, s, t, hd = _check_qkv("flash_attention_bwd", q, k, v, window, softcap,
                                     BWD_HEAD_DIMS, (torch.float32,))
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    for arg, x in (("out", out), ("dout", dout)):
        _check(arg, x, q.device)
        if x.shape != q.shape:
            raise ValueError(f"{arg} must have q's shape {tuple(q.shape)}, got {tuple(x.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 (B, H, S) = {(b, h, s)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # each query head's partial dk and dv, summed per KV head in head order
    part = torch.empty((2, b, h, t, hd), dtype=torch.float32, device=q.device) \
        if h > kvh else None
    fn = _build.entry(BWD_SOURCE, "flash_bwd_f32", _BWD_ARGTYPES)
    _build.launch(fn, "flash_bwd_f32", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  dout.data_ptr(), None if part is None else part.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, s, t, hd,
                  *(st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]),
                  *_mask_args(hd, causal, window, softcap))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def rows_by_tma(x: torch.Tensor) -> bool:
    """Whether the kernels copy the rows of ``x`` (a (B, heads, rows, hd)
    CUDA view, the forward's K or V, or the backward's float32 operands)
    into shared memory by TMA rather than cp.async or, for bfloat16 rows
    off 16 bytes, plain loads."""
    _check("x", x, x.device, DTYPES)
    fn = _build.entry(SOURCE, "flash_rows_tma", (_P,) + (_LL,) * 8)
    return bool(fn(x.data_ptr(), *x.shape, *x.stride()[:3], x.element_size()))


# launches since the last reset (the main path's proof of use)
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
