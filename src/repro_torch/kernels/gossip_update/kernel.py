"""The CUDA gossip-update kernel (B.1): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/gossip_update/kernel.py``
(``gossip_update``, ``pallas_call`` at ``:54``) with
``csrc/gossip_update.cu``, built by :mod:`repro_torch.kernels._build`; the
source's header note gives its bound and design.

Three wrappers: :func:`gossip_update`, the reference's per-node form;
:func:`gossip_update_stacked_grouped`, every node of every node-stacked
leaf of a group in one launch (the form the train step runs, once per
step; up to :data:`MAX_GROUP_LEAVES` leaves per launch, a larger group
split by :func:`leaf_tables`); and :func:`gossip_update_stacked`, one leaf,
a one-leaf group of the same kernel.  Each takes float32 or bfloat16
parameters and float32 weights and scales on the card, raises on anything
its kernel does not take (it never runs the plain version itself) and adds
one to its ``.launches`` for each launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_gossip.kernel import leaf_tables as _leaf_tables

SOURCE = "gossip_update/csrc/gossip_update.cu"
# the fixed sizes of csrc/gossip_update.cu (its gossip_update_config)
MAX_NODES = 64          # the stacked kernel's largest K
MAX_GROUP_LEAVES = 16   # leaves per stacked launch
STACKED_COLS = 1024     # columns of a leaf per CTA
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_NODE_ARGS = (_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _F, _P)
_GROUPED_ARGS = (_P, _I, _P, _P, _I, _F, _P)


def stacked_ctas(d: int) -> int:
    """CTAs of one leaf of ``d`` columns (elements per node) in a stacked
    launch."""
    return -(-d // STACKED_COLS)


def leaf_tables(dims, cap: int = MAX_GROUP_LEAVES) -> list[list[tuple[int, int]]]:
    """The stacked launches of a group of leaves of ``dims`` columns each:
    at most ``cap`` leaves per launch, in order, each launch's table listing
    (leaf index, CTAs of the launch's earlier leaves); a leaf with no
    columns is left out."""
    return _leaf_tables([stacked_ctas(d) for d in dims], cap)


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


def _stacked_grouped(thetas, grads, w, scale, eta, name):
    if not thetas or len(thetas) != len(grads):
        raise ValueError(f"{name} takes one or more leaves and one gradient per leaf, got "
                         f"{len(thetas)} thetas and {len(grads)} grads")
    suffix = _dtype(thetas[0])
    dev, dtype = thetas[0].device, thetas[0].dtype
    k = thetas[0].shape[0] if thetas[0].ndim else 0
    if not 0 < k <= MAX_NODES:
        raise ValueError(f"the stacked gossip-update kernel is built for 1..{MAX_NODES} "
                         f"nodes, got K = {k}")
    for theta, grad in zip(thetas, grads):
        if theta.ndim == 0 or theta.shape[0] != k:
            raise ValueError(f"{name} takes (K, ...) leaves of one K = {k}, got "
                             f"{tuple(theta.shape)}")
        if theta.dtype != dtype:
            raise TypeError(f"{name} takes leaves of one dtype, got {dtype} and {theta.dtype}")
        _check("theta", theta, dev, dtype, theta.shape)
        _check("grad", grad, dev, dtype, theta.shape)
    _check("w", w, dev, torch.float32, (k, k))
    _check("scale", scale, dev, torch.float32, (k,))
    outs = [torch.empty_like(theta) for theta in thetas]
    dims = [theta.numel() // k for theta in thetas]
    symbol = f"gossip_update_stacked_grouped_{suffix}"
    launched = 0
    for table in leaf_tables(dims):
        desc = (_LL * (5 * len(table)))(*[v for leaf, begin in table for v in (
            thetas[leaf].data_ptr(), grads[leaf].data_ptr(), outs[leaf].data_ptr(), dims[leaf],
            begin)])
        _build.launch(_build.entry(SOURCE, symbol, _GROUPED_ARGS), symbol, dev,
                      ctypes.addressof(desc), len(table), w.data_ptr(), scale.data_ptr(), k,
                      float(eta))
        launched += 1
    return outs, launched


def gossip_update_stacked_grouped(thetas, grads, w: torch.Tensor, scale: torch.Tensor, *,
                                  eta: float) -> list[torch.Tensor]:
    """Every leaf of a group at once: ``thetas``, ``grads`` lists of (K,
    ...) contiguous leaves of one dtype (float32 or bfloat16), w (K, K) and
    scale (K,) float32 -> [``W @ (θ_l − η·(s⊙g_l))``], one new tensor per
    leaf in θ_l's shape.  One launch per :data:`MAX_GROUP_LEAVES` leaves,
    each adding one to ``gossip_update_stacked_grouped.launches``."""
    outs, launched = _stacked_grouped(thetas, grads, w, scale, eta,
                                      "gossip_update_stacked_grouped")
    gossip_update_stacked_grouped.launches += launched
    return outs


def gossip_update_stacked(theta: torch.Tensor, grad: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, *, eta: float) -> torch.Tensor:
    """theta, grad: (K, ...) contiguous; w: (K, K) and scale (K,) float32
    -> ``W @ (θ − η·(s⊙g))`` (K, ...) in θ's dtype.  A one-leaf group of
    the grouped kernel; adds one to ``gossip_update_stacked.launches``."""
    [out], launched = _stacked_grouped([theta], [grad], w, scale, eta, "gossip_update_stacked")
    gossip_update_stacked.launches += launched
    return out


def config() -> dict:
    """The stacked kernel's fixed sizes as compiled (builds the source)."""
    fn = _build.entry(SOURCE, "gossip_update_config", (_P,))
    fn.restype = None
    out = (_LL * 3)()
    fn(ctypes.addressof(out))
    return dict(zip(("max_group_leaves", "max_nodes", "stacked_cols"), out))


# launches of each kernel since the last reset (the main path's proof of use)
gossip_update.launches = 0
gossip_update_stacked.launches = 0
gossip_update_stacked_grouped.launches = 0
