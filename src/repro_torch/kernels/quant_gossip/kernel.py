"""The CUDA quant_gossip kernels: build, load and launch.

Replaces the four Pallas TPU kernels of ``repro/kernels/quant_gossip/kernel.py``:

=============================  ==================  =========================
wrapper                        TPU kernel          source
=============================  ==================  =========================
``quantize_blockwise``         B.2 (``:98``)       ``csrc/quantize.cu``
``masked_quantize_blockwise``  B.4 (``:154``)      ``csrc/quantize.cu``
``dequant_accumulate``         B.3 (``:125``)      ``csrc/accumulate.cu``
``masked_dequant_accumulate``  B.5 (``:187``)      ``csrc/accumulate.cu``
=============================  ==================  =========================

Each source's header note gives its bound and design.  The sources are
built and loaded by :mod:`repro_torch.kernels._build`, together with every
other kernel family's.

Every wrapper validates what it is given, raises on anything its kernel
does not take (it never runs the plain version itself) and adds one to its
``.launches`` where it launches.

``_pick_block`` and ``num_blocks`` are the reference's layout rules, kept
identical so that wire-byte accounting matches what the kernels emit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_CSRC = "quant_gossip/csrc/"
SOURCES = (_CSRC + "quantize.cu", _CSRC + "accumulate.cu")
NVCC_FLAGS = _build.NVCC_FLAGS
build = _build.build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# exported symbol -> (source, argtypes)
_SYMBOLS = {
    "quantize_blockwise_f32":
        (SOURCES[0], (_P, _P, ctypes.c_float, _P, _P, _P, _LL, _LL, _LL, _P)),
    "masked_quantize_blockwise_f32":
        (SOURCES[0], (_P, _P, _P, ctypes.c_float, _P, _P, _P, _LL, _LL, _LL, _P)),
    "dequant_accumulate_f32":
        (SOURCES[1], (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P)),
    "masked_dequant_accumulate_f32":
        (SOURCES[1], (_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P)),
}


def _pick_block(d: int, block_d: int) -> int:
    block_d = min(block_d, d)
    if d % block_d:
        block_d = d  # ragged tail: fall back to a single block per row
    return block_d


def num_blocks(d: int, block_d: int) -> int:
    """Scale blocks per row for a given layout (mirrors :func:`_pick_block`,
    so wire-byte accounting matches what the kernel actually emits)."""
    return d // _pick_block(d, block_d)


def _entry(symbol: str):
    source, argtypes = _SYMBOLS[symbol]
    return _build.entry(source, symbol, argtypes)


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype,
           shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_quantize_args(x, u, mask, qmax, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got x on {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{name} kernel takes a (K, D) x, got {tuple(x.shape)}")
    _check("x", x, x.device, torch.float32, x.shape)
    _check("u", u, x.device, torch.float32, x.shape)
    if mask is not None:
        _check("mask", mask, x.device, torch.float32, (x.shape[0],))
    if not 0.0 < float(qmax) <= 127.0:
        raise ValueError(f"qmax must be in (0, 127] for an int8 payload, got {qmax}")


def _quantize(symbol, x, u, mask, qmax, block_d):
    k, d = x.shape
    block = _pick_block(d, block_d)
    n_blk = d // block
    q = torch.empty((k, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((k, n_blk), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return q, scales, False
    scratch = torch.zeros((k, n_blk), dtype=torch.int32, device=x.device)
    fn = _entry(symbol)
    masks = () if mask is None else (mask.data_ptr(),)
    _build.launch(fn, symbol, x.device, x.data_ptr(), u.data_ptr(), *masks, float(qmax),
                  q.data_ptr(), scales.data_ptr(), scratch.data_ptr(), k, d, block)
    return q, scales, True


def quantize_blockwise(x: torch.Tensor, u: torch.Tensor, *, qmax: float = 127.0,
                       block_d: int = 65536):
    """x, u: (K, D) float32 CUDA tensors -> (q int8 (K, D), scales f32 (K, D/block)).

    Launches the B.2 kernel on the current stream and adds one to
    ``quantize_blockwise.launches``.
    """
    _check_quantize_args(x, u, None, qmax, "quantize_blockwise")
    q, scales, launched = _quantize("quantize_blockwise_f32", x, u, None, qmax, block_d)
    quantize_blockwise.launches += launched
    return q, scales


def masked_quantize_blockwise(x: torch.Tensor, u: torch.Tensor, mask: torch.Tensor, *,
                              qmax: float = 127.0, block_d: int = 65536):
    """B.2 with a per-row sender mask (K,) float32 in {0, 1}: a masked row
    emits q = 0 and scale = 0.  Launches the B.4 kernel and adds one to
    ``masked_quantize_blockwise.launches``."""
    _check_quantize_args(x, u, mask, qmax, "masked_quantize_blockwise")
    q, scales, launched = _quantize("masked_quantize_blockwise_f32", x, u, mask, qmax,
                                    block_d)
    masked_quantize_blockwise.launches += launched
    return q, scales


def _accumulate(symbol, name, acc, q, scales, w, mask, src):
    if acc.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got acc on {acc.device}")
    if acc.ndim != 2 or q.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"{name} kernel takes a (K, D) acc, a (Kq, D) q and "
                         f"(Kq, n_blk) scales, got {tuple(acc.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scales.shape)}")
    dev = acc.device
    k, d = acc.shape
    kq, n_blk = q.shape[0], scales.shape[1]
    if n_blk == 0 or d % n_blk:
        raise ValueError(f"{n_blk} scale blocks do not divide D = {d}")
    _check("acc", acc, dev, torch.float32, (k, d))
    _check("q", q, dev, torch.int8, (kq, d))
    _check("scales", scales, dev, torch.float32, (kq, n_blk))
    w = w.reshape(-1)
    _check("w", w, dev, torch.float32, (k,))
    if mask is not None:
        mask = mask.reshape(-1)
        _check("mask", mask, dev, torch.float32, (k,))
    if src is None:
        if kq != k:
            raise ValueError(f"without src, q must have acc's {k} rows, got {kq}")
    else:
        _check("src", src, dev, torch.int64, (k,))
    out = torch.empty_like(acc)
    if acc.numel() == 0:
        return out, False
    fn = _entry(symbol)
    masks = () if mask is None else (mask.data_ptr(),)
    _build.launch(fn, symbol, dev, acc.data_ptr(), q.data_ptr(), scales.data_ptr(),
                  w.data_ptr(), *masks, None if src is None else src.data_ptr(),
                  out.data_ptr(), k, kq, d, n_blk)
    return out, True


def dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                       w: torch.Tensor, *, src: torch.Tensor | None = None) -> torch.Tensor:
    """acc (K, D) f32 + (w[i]·scales[src[i], blk])·q[src[i]] -> (K, D) f32.

    ``w`` holds K float32 weights, ``src`` (K,) int64 is the row each node
    receives from (None: its own row).  A row with w = 0 returns acc
    bitwise.  Launches the B.3 kernel and adds one to
    ``dequant_accumulate.launches``.
    """
    out, launched = _accumulate("dequant_accumulate_f32", "dequant_accumulate",
                                acc, q, scales, w, None, src)
    dequant_accumulate.launches += launched
    return out


def masked_dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                              w: torch.Tensor, mask: torch.Tensor, *,
                              src: torch.Tensor | None = None) -> torch.Tensor:
    """B.3 with the weight ``mask[i]·w[i]``; a masked row returns acc bitwise
    without reading the payload.  Launches the B.5 kernel and adds one to
    ``masked_dequant_accumulate.launches``."""
    out, launched = _accumulate("masked_dequant_accumulate_f32",
                                "masked_dequant_accumulate", acc, q, scales, w, mask, src)
    masked_dequant_accumulate.launches += launched
    return out


# launches of each kernel since the last reset (the main path's proof of use)
quantize_blockwise.launches = 0
masked_quantize_blockwise.launches = 0
dequant_accumulate.launches = 0
masked_dequant_accumulate.launches = 0
