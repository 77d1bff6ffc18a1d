"""The CUDA gossip-update kernel (B.1): load and launch.

Replaces the Pallas TPU kernel ``repro/kernels/gossip_update/kernel.py``
(``gossip_update``, ``pallas_call`` at ``:54``) with
``csrc/gossip_update.cu``, built by :mod:`repro_torch.kernels._build`; the
source's header note gives its bound and design.

Four wrappers: :func:`gossip_update_leaves`, the reference's per-node form
over every leaf of one node's tree in one launch (up to
:data:`MAX_GROUP_LEAVES` leaves and :data:`NODE_NBR_POOL` neighbour rows
per launch, a larger group split by :func:`node_tables`), reading each
neighbour's row where it lies; :func:`gossip_update`, one leaf with its
neighbours' rows stacked (N, D), a one-leaf group of the same kernel;
:func:`gossip_update_stacked_grouped`, every node of every node-stacked
leaf of a group in one launch (the form the train step runs, once per
step; up to :data:`MAX_GROUP_LEAVES` leaves per launch, a larger group
split by :func:`leaf_tables`); and :func:`gossip_update_stacked`, one leaf,
a one-leaf group of the same kernel.  The stacked forms read η through a
pointer (a 0-d float32 tensor on the card; a float is written to one
first) and write into given ``out`` leaves where the caller has them (θ
itself, in place, as the train step's captured graph updates its
parameters), so the train step can be captured in a CUDA graph that reads
each step's η.  Each takes float32 or bfloat16
parameters and float32 weights and scales on the card, raises on anything
its kernel does not take (it never runs the plain version itself) and adds
one to a ``.launches`` for each launch: the per-node kernel's launches,
from either of its wrappers, count on ``gossip_update.launches``.
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
STACKED_COLS = 1024     # columns of a leaf per CTA (both forms)
NODE_NBR_POOL = 384     # neighbour rows per per-node launch (over its leaves)
MAX_NEIGHBORS = MAX_NODES - 1  # the per-node form's largest N
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_NODE_ARGS = (_P, _I, _P, _I, _P, _P, _F, _P)
_GROUPED_ARGS = (_P, _I, _P, _P, _I, _P, _P)


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


def node_tables(dims, n_nbrs: int) -> list[list[tuple[int, int]]]:
    """The per-node launches of one node's leaves of ``dims`` columns each
    with ``n_nbrs`` neighbours: :func:`leaf_tables` at a cap of
    :data:`MAX_GROUP_LEAVES` leaves, lowered so that a launch's neighbour
    rows fit the pool of :data:`NODE_NBR_POOL`."""
    if not 0 <= n_nbrs <= MAX_NEIGHBORS:
        raise ValueError(f"the per-node gossip-update kernel takes 0..{MAX_NEIGHBORS} "
                         f"neighbours, got {n_nbrs}")
    cap = MAX_GROUP_LEAVES if n_nbrs == 0 else min(MAX_GROUP_LEAVES, NODE_NBR_POOL // n_nbrs)
    return leaf_tables(dims, cap)


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


def _node_launches(thetas, grads, nbr_ptrs, n, weights, scale, eta):
    """The per-node kernel over every leaf of one node, the leaves checked
    by the caller, ``nbr_ptrs`` per leaf the N neighbours' row addresses;
    returns (outs, launches)."""
    dev = thetas[0].device
    if not 0 <= n <= MAX_NEIGHBORS:
        raise ValueError(f"the per-node gossip-update kernel takes 0..{MAX_NEIGHBORS} "
                         f"neighbours, got {n}")
    _check("weights", weights, dev, torch.float32, (n + 1,))
    _check("scale", scale, dev, torch.float32, ())
    outs = [torch.empty_like(theta) for theta in thetas]
    symbol = f"gossip_update_nodes_{_SUFFIX[thetas[0].dtype]}"
    fn = _build.entry(SOURCE, symbol, _NODE_ARGS)
    tables = ([[(0, 0)]] if len(thetas) == 1 and thetas[0].numel()
              else node_tables([theta.numel() for theta in thetas], n))
    for table in tables:
        desc, nbrs = node_descriptors(table, thetas, grads, outs, nbr_ptrs)
        desc_c = (_LL * len(desc))(*desc)  # kept alive until the launch returns
        nbrs_c = (_LL * max(len(nbrs), 1))(*nbrs)
        _build.launch(fn, symbol, dev, ctypes.addressof(desc_c), len(table),
                      ctypes.addressof(nbrs_c), n, weights.data_ptr(), scale.data_ptr(),
                      float(eta))
    return outs, len(tables)


def node_descriptors(table, thetas, grads, outs, nbr_ptrs) -> tuple[list[int], list[int]]:
    """One per-node launch's arguments (csrc/gossip_update.cu,
    gossip_update_nodes_<t>): per leaf of ``table`` its theta, grad and
    out pointers, columns and earlier CTAs; and the neighbour pool, the
    table's l-th leaf's neighbour j at l N + j (``nbr_ptrs`` per leaf)."""
    desc = [v for leaf, begin in table for v in (
        thetas[leaf].data_ptr(), grads[leaf].data_ptr(), outs[leaf].data_ptr(),
        thetas[leaf].numel(), begin)]
    return desc, [p for leaf, _ in table for p in nbr_ptrs[leaf]]


def gossip_update_leaves(thetas, grads, neighbors, weights: torch.Tensor, scale: torch.Tensor,
                         *, eta: float) -> list[torch.Tensor]:
    """Every leaf of one node at once: ``thetas``, ``grads`` lists of
    contiguous leaves of one dtype (float32 or bfloat16; any shape, D_l
    elements); ``neighbors`` per leaf a list of the N neighbours' updated
    leaves (contiguous, D_l elements each), in the node's neighbour order
    (N <= :data:`MAX_NEIGHBORS`, the same for every leaf); weights (N+1,)
    and scale () float32 -> [``W_ii·(θ_l − η·s·g_l) + Σ_n W_in·nbr_{n,l}``],
    one new tensor per leaf in θ_l's shape.  One launch per
    :func:`node_tables` table (one for the fmnist MLP's 6 leaves), each
    adding one to ``gossip_update.launches``."""
    if not thetas or len(grads) != len(thetas) or len(neighbors) != len(thetas):
        raise ValueError(f"gossip_update_leaves takes one or more leaves and one gradient "
                         f"and one neighbour list per leaf, got {len(thetas)} thetas, "
                         f"{len(grads)} grads and {len(neighbors)} neighbour lists")
    _dtype(thetas[0])
    dev, dtype, n = thetas[0].device, thetas[0].dtype, len(neighbors[0])
    for theta, grad, nbrs in zip(thetas, grads, neighbors):
        _check("theta", theta, dev, dtype, theta.shape)
        _check("grad", grad, dev, dtype, theta.shape)
        if len(nbrs) != n:
            raise ValueError(f"every leaf takes the node's {n} neighbours, got {len(nbrs)}")
        d = theta.numel()
        for nbr in nbrs:
            if nbr.numel() != d or nbr.dtype != dtype or not nbr.is_contiguous() or \
                    nbr.device != dev:
                raise ValueError(f"a neighbour's leaf must be a contiguous {dtype} of {d} "
                                 f"elements on {dev}, got {tuple(nbr.shape)} {nbr.dtype} "
                                 f"on {nbr.device}")
    outs, launched = _node_launches(thetas, grads,
                                    [[x.data_ptr() for x in nbrs] for nbrs in neighbors], n,
                                    weights, scale, eta)
    gossip_update.launches += launched
    return outs


def gossip_update(theta: torch.Tensor, grad: torch.Tensor, neighbors: torch.Tensor,
                  weights: torch.Tensor, scale: torch.Tensor, *, eta: float) -> torch.Tensor:
    """theta, grad: (D,); neighbors: (N, D); weights: (N+1,) and scale ()
    float32 -> (D,) in θ's dtype.  A one-leaf group of the per-node kernel
    (the rows of ``neighbors`` read in place); adds one to
    ``gossip_update.launches``."""
    _dtype(theta)
    dev, (d,), n = theta.device, theta.shape, neighbors.shape[0]
    _check("grad", grad, dev, theta.dtype, (d,))
    _check("neighbors", neighbors, dev, theta.dtype, (n, d))
    _check("theta", theta, dev, theta.dtype, (d,))
    row = d * neighbors.element_size()
    [out], launched = _node_launches([theta], [grad],
                                     [[neighbors.data_ptr() + j * row for j in range(n)]], n,
                                     weights, scale, eta)
    gossip_update.launches += launched
    return out


def eta_tensor(eta, device: torch.device) -> torch.Tensor:
    """η as the stacked kernel reads it: a 0-d float32 tensor on ``device``
    (a float is written to one by a fill, not a host-to-device copy)."""
    if isinstance(eta, torch.Tensor):
        return eta
    return torch.full((), float(eta), dtype=torch.float32, device=device)


def _check_out(name: str, out, thetas, grads) -> None:
    """``out``: one leaf per θ, of θ's shape, dtype and device, contiguous:
    θ itself (the update in place: each thread reads every node's column
    before it writes that column), or in a storage no θ or g shares."""
    if len(out) != len(thetas):
        raise ValueError(f"{name} takes one out leaf per theta, got {len(out)} for "
                         f"{len(thetas)}")
    inputs = {t.untyped_storage().data_ptr() for t in (*thetas, *grads)}
    for o, theta in zip(out, thetas):
        _check("out", o, theta.device, theta.dtype, theta.shape)
        if o.data_ptr() == theta.data_ptr():
            continue
        if o.untyped_storage().data_ptr() in inputs:
            raise ValueError(f"{name}: an out leaf shares a storage with a theta it is not "
                             "or with a grad; out is each theta itself or apart from them")


def _stacked_grouped(thetas, grads, w, scale, eta, name, out=None):
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
    eta = eta_tensor(eta, dev)
    _check("eta", eta, dev, torch.float32, ())
    if out is None:
        outs = [torch.empty_like(theta) for theta in thetas]
    else:
        _check_out(name, out, thetas, grads)
        outs = list(out)
    dims = [theta.numel() // k for theta in thetas]
    symbol = f"gossip_update_stacked_grouped_{suffix}"
    launched = 0
    for table in leaf_tables(dims):
        desc = (_LL * (5 * len(table)))(*[v for leaf, begin in table for v in (
            thetas[leaf].data_ptr(), grads[leaf].data_ptr(), outs[leaf].data_ptr(), dims[leaf],
            begin)])
        _build.launch(_build.entry(SOURCE, symbol, _GROUPED_ARGS), symbol, dev,
                      ctypes.addressof(desc), len(table), w.data_ptr(), scale.data_ptr(), k,
                      eta.data_ptr())
        launched += 1
    return outs, launched


def gossip_update_stacked_grouped(thetas, grads, w: torch.Tensor, scale: torch.Tensor, *,
                                  eta, out=None) -> list[torch.Tensor]:
    """Every leaf of a group at once: ``thetas``, ``grads`` lists of (K,
    ...) contiguous leaves of one dtype (float32 or bfloat16), w (K, K),
    scale (K,) and eta () float32 (or a float) -> [``W @ (θ_l −
    η·(s⊙g_l))``], one tensor per leaf in θ_l's shape: new ones, or the
    leaves of ``out`` (contiguous, θ_l's shape and dtype: θ_l itself, the
    update in place, or no storage shared with θ or g), written and
    returned.  One launch per
    :data:`MAX_GROUP_LEAVES` leaves, each adding one to
    ``gossip_update_stacked_grouped.launches``."""
    outs, launched = _stacked_grouped(thetas, grads, w, scale, eta,
                                      "gossip_update_stacked_grouped", out)
    gossip_update_stacked_grouped.launches += launched
    return outs


def gossip_update_stacked(theta: torch.Tensor, grad: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor, *, eta) -> torch.Tensor:
    """theta, grad: (K, ...) contiguous; w: (K, K), scale (K,) and eta ()
    float32 (or a float) -> ``W @ (θ − η·(s⊙g))`` (K, ...) in θ's dtype.  A
    one-leaf group of the grouped kernel; adds one to
    ``gossip_update_stacked.launches``."""
    [out], launched = _stacked_grouped([theta], [grad], w, scale, eta, "gossip_update_stacked")
    gossip_update_stacked.launches += launched
    return out


def config() -> dict:
    """The kernels' fixed sizes as compiled (builds the source)."""
    fn = _build.entry(SOURCE, "gossip_update_config", (_P,))
    fn.restype = None
    out = (_LL * 4)()
    fn(ctypes.addressof(out))
    return dict(zip(("max_group_leaves", "max_nodes", "stacked_cols", "node_nbr_pool"), out))


# launches of each kernel since the last reset (the main path's proof of use)
gossip_update.launches = 0
gossip_update_stacked.launches = 0
gossip_update_stacked_grouped.launches = 0
