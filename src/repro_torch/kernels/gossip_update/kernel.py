"""The CUDA gossip-update kernel (B.1): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/gossip_update/kernel.py``
(``gossip_update``, ``pallas_call`` at ``:54``) with
``csrc/gossip_update.cu``, built by :mod:`repro_torch.kernels._build`; the
source's header note gives its bound and design.

Two wrappers, one per entry point of the source: :func:`gossip_update`, the
reference's per-node form, and :func:`gossip_update_stacked`, every node of
a node-stacked leaf at once (the form the train step runs).  Each takes
float32 or bfloat16 parameters and float32 weights and scales on the card,
raises on anything its kernel does not take (it never runs the plain
version itself) and adds one to its ``.launches`` where it launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "gossip_update/csrc/gossip_update.cu"
MAX_NODES = 64  # the stacked kernel's largest K
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_NODE_ARGS = (_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _F, _P)
_STACKED_ARGS = (_P, _P, _P, _P, _P, _I, _LL, _F, _P)


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


def _dtype(theta: torch.Tensor) -> str:
    if theta.device.type != "cuda":
        raise ValueError(f"the gossip-update kernel needs CUDA tensors, got {theta.device}")
    if theta.dtype not in _SUFFIX:
        raise TypeError(f"the gossip-update kernel takes float32 or bfloat16, got {theta.dtype}")
    return _SUFFIX[theta.dtype]


def gossip_update(theta: torch.Tensor, grad: torch.Tensor, neighbors: torch.Tensor,
                  weights: torch.Tensor, scale: torch.Tensor, *, eta: float) -> torch.Tensor:
    """theta, grad: (D,); neighbors: (N, D); weights: (N+1,) and scale ()
    float32 -> (D,) in θ's dtype.  Adds one to ``gossip_update.launches``."""
    suffix = _dtype(theta)
    dev, (d,) = theta.device, theta.shape
    n = neighbors.shape[0]
    _check("grad", grad, dev, theta.dtype, (d,))
    _check("neighbors", neighbors, dev, theta.dtype, (n, d))
    _check("weights", weights, dev, torch.float32, (n + 1,))
    _check("scale", scale, dev, torch.float32, ())
    _check("theta", theta, dev, theta.dtype, (d,))
    out = torch.empty_like(theta)
    symbol = f"gossip_update_{suffix}"
    _build.launch(_build.entry(SOURCE, symbol, _NODE_ARGS), symbol, dev,
                  theta.data_ptr(), grad.data_ptr(), neighbors.data_ptr(), weights.data_ptr(),
                  scale.data_ptr(), out.data_ptr(), d, n, d, float(eta))
    gossip_update.launches += 1
    return out


def gossip_update_stacked(theta: torch.Tensor, grad: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, *, eta: float) -> torch.Tensor:
    """theta, grad: (K, ...) contiguous; w: (K, K) and scale (K,) float32
    -> ``W @ (θ − η·(s⊙g))`` (K, ...) in θ's dtype.  Adds one to
    ``gossip_update_stacked.launches``."""
    suffix = _dtype(theta)
    dev, k = theta.device, theta.shape[0]
    if not 0 < k <= MAX_NODES:
        raise ValueError(f"the stacked gossip-update kernel is built for 1..{MAX_NODES} "
                         f"nodes, got K = {k}")
    _check("grad", grad, dev, theta.dtype, theta.shape)
    _check("w", w, dev, torch.float32, (k, k))
    _check("scale", scale, dev, torch.float32, (k,))
    _check("theta", theta, dev, theta.dtype, theta.shape)
    out = torch.empty_like(theta)
    symbol = f"gossip_update_stacked_{suffix}"
    _build.launch(_build.entry(SOURCE, symbol, _STACKED_ARGS), symbol, dev,
                  theta.data_ptr(), grad.data_ptr(), w.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), k, theta.numel() // k, float(eta))
    gossip_update_stacked.launches += 1
    return out


# launches of each kernel since the last reset (the main path's proof of use)
gossip_update.launches = 0
gossip_update_stacked.launches = 0
