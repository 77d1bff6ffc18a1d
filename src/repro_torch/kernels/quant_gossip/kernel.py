"""The CUDA quant_gossip kernels: build, load and launch.

Replaces the four Pallas TPU kernels of ``repro/kernels/quant_gossip/kernel.py``:

=========================================  =============  ========================
wrapper                                    TPU kernel     source
=========================================  =============  ========================
``quantize_blockwise_grouped``             B.2 (``:98``)  ``csrc/masked_grouped.cu``
``quantize_blockwise`` (one leaf)          B.2 (``:98``)  ``csrc/masked_grouped.cu``
``masked_quantize_blockwise_grouped``      B.4 (``:154``) ``csrc/masked_grouped.cu``
``masked_quantize_blockwise`` (one leaf)   B.4 (``:154``) ``csrc/masked_grouped.cu``
``dequant_accumulate_grouped_``            B.3 (``:125``) ``csrc/masked_grouped.cu``
``dequant_accumulate`` (one leaf)          B.3 (``:125``) ``csrc/masked_grouped.cu``
``masked_dequant_accumulate_grouped_``     B.5 (``:187``) ``csrc/masked_grouped.cu``
``masked_dequant_accumulate`` (one leaf)   B.5 (``:187``) ``csrc/masked_grouped.cu``
=========================================  =============  ========================

The source's header note gives its bound and design.  It is built and
loaded by :mod:`repro_torch.kernels._build`, together with every other
kernel family's.

The grouped wrappers take every leaf of one matching in one launch (up to
:data:`MAX_GROUP_LEAVES` leaves; a larger group is split into several
launches by :func:`leaf_tables`); the one-leaf wrappers are one-leaf groups.
B.2 is B.4's kernel with no mask (``m = 1``) and B.3 is B.5's (``a = w``),
so each pair shares one launch path bit for bit.

Every wrapper validates what it is given, raises on anything its kernel
does not take (it never runs the plain version itself) and adds one to its
``.launches`` for each launch.  The quantizers take ``qmax`` as a float
(range-checked here) or as a 0-d float32 tensor on the leaves' device (a
compression schedule's rate), which the kernel reads on the card: the
tensor is never read on the host, and the same value gives the same bits
either way.

``_pick_block`` and ``num_blocks`` are the reference's layout rules, kept
identical so that wire-byte accounting matches what the kernels emit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "quant_gossip/csrc/masked_grouped.cu"
NVCC_FLAGS = _build.NVCC_FLAGS
build = _build.build

# the fixed sizes of csrc/masked_grouped.cu (its masked_grouped_config)
CLUSTER_SIZE = 16        # CTAs per B.4 thread-block cluster
MAX_GROUP_LEAVES = 16    # leaves per grouped launch (the CNN has 12)
MIN_SHARE = 8192         # B.4: a segment this long or shorter is one CTA's
ACC_CHUNK = 4096         # B.5: elements per CTA

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# exported symbol -> argtypes
_SYMBOLS = {
    "quantize_grouped_f32": (_P, ctypes.c_int, ctypes.c_float, _P, _LL, _P),
    "masked_quantize_grouped_f32": (_P, ctypes.c_int, _P, ctypes.c_float, _P, _LL, _P),
    "masked_dequant_accumulate_grouped_f32": (_P, ctypes.c_int, _P, _P, _P, _LL, _LL, _P),
    "dequant_accumulate_grouped_f32": (_P, ctypes.c_int, _P, _P, _LL, _LL, _P),
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
    return _build.entry(SOURCE, symbol, _SYMBOLS[symbol])


def config() -> dict:
    """The grouped kernels' fixed sizes as compiled (builds the source)."""
    fn = _build.entry(SOURCE, "masked_grouped_config", (_P,))
    fn.restype = None
    out = (_LL * 5)()
    fn(ctypes.addressof(out))
    return dict(zip(("cluster_size", "max_group_leaves", "min_share", "acc_chunk",
                     "smem_cap_floats"), out))


def quantize_clusters(k: int, d: int, block_d: int) -> int:
    """B.4's thread-block clusters for a (k, d) leaf: one per (row, block)
    segment, or, where a segment is at most MIN_SHARE long and so one CTA's
    whole, one per CLUSTER_SIZE segments (packed, rounded up)."""
    block = _pick_block(d, block_d)
    segments = k * (d // block)
    return -(-segments // CLUSTER_SIZE) if block <= MIN_SHARE else segments


def leaf_tables(units, cap: int = MAX_GROUP_LEAVES) -> list[list[tuple[int, int]]]:
    """The leaf tables of a group: ``units[l]`` work units of leaf l (B.2
    and B.4: its thread-block clusters, :func:`quantize_clusters`; B.5: its
    K × chunks CTAs; B.1 stacked: its CTAs) go in launches of at most
    ``cap`` leaves, in order.  Each launch's table lists (leaf index, units
    of the launch's earlier leaves); a leaf with no units is left out."""
    tables, table, begin = [], [], 0
    for leaf, n in enumerate(units):
        if n == 0:
            continue
        if len(table) == cap:
            tables.append(table)
            table, begin = [], 0
        table.append((leaf, begin))
        begin += n
    if table:
        tables.append(table)
    return tables


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
    if isinstance(qmax, torch.Tensor):
        # read on the card, never here: a schedule's rate, whose range
        # CompressionSchedule checks once
        _check("qmax", qmax, x.device, torch.float32, ())
    elif not 0.0 < float(qmax) <= 127.0:
        raise ValueError(f"qmax must be in (0, 127] for an int8 payload, got {qmax}")


def _aligned_offsets(sizes, align: int) -> tuple[list[int], int]:
    """Offsets of consecutive buffers of ``sizes`` elements, each rounded up
    to a multiple of ``align`` elements; and the total."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // align) * align
    return offsets, total


def _quantize_grouped(xs, us, mask, qmax, block_d, name):
    """B.4 (a (K,) mask) or B.2 (mask None) over every leaf of a group."""
    if not xs or len(xs) != len(us):
        raise ValueError(f"{name} takes one or more leaves and one u per leaf, got "
                         f"{len(xs)} x and {len(us)} u")
    lead = xs[0] if mask is None else mask
    if lead.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {lead.device}")
    k = (xs[0].shape[0] if xs[0].ndim else 0) if mask is None else mask.reshape(-1).shape[0]
    for x, u in zip(xs, us):
        if x.ndim != 2 or x.shape[0] != k:
            raise ValueError(f"{name} kernel takes (K, D) leaves of one K = {k}, "
                             f"got {tuple(x.shape)}")
        _check_quantize_args(x, u, mask, qmax, name)
    dims = [x.shape[1] for x in xs]
    blocks = [_pick_block(d, block_d) for d in dims]
    n_blks = [d // b for d, b in zip(dims, blocks)]
    dev = lead.device
    # the outputs are views into one allocation each; every leaf's q starts
    # on 16 bytes, so the kernel's 4-byte stores stay aligned
    q_off, q_total = _aligned_offsets([k * d for d in dims], 16)
    s_off, s_total = _aligned_offsets([k * n for n in n_blks], 1)
    q_flat = torch.empty(q_total, dtype=torch.int8, device=dev)
    s_flat = torch.empty(s_total, dtype=torch.float32, device=dev)
    qs = [q_flat[o:o + k * d].view(k, d) for o, d in zip(q_off, dims)]
    ss = [s_flat[o:o + k * n].view(k, n) for o, n in zip(s_off, n_blks)]
    launched = 0
    # B.4 takes the mask; B.2 is the same kernel without one (m = 1)
    symbol = "quantize_grouped_f32" if mask is None else "masked_quantize_grouped_f32"
    masks = () if mask is None else (mask.data_ptr(),)
    # a tensor qmax goes to the kernel by its address and is read there
    qmax_args = (0.0, qmax.data_ptr()) if isinstance(qmax, torch.Tensor) \
        else (float(qmax), None)
    for table in leaf_tables([quantize_clusters(k, d, block_d) for d in dims]):
        desc = (_LL * (7 * len(table)))(*[v for leaf, begin in table for v in (
            xs[leaf].data_ptr(), us[leaf].data_ptr(), qs[leaf].data_ptr(),
            ss[leaf].data_ptr(), dims[leaf], blocks[leaf], begin)])
        _build.launch(_entry(symbol), symbol, dev, ctypes.addressof(desc), len(table),
                      *masks, *qmax_args, k)
        launched += 1
    return list(zip(qs, ss)), launched


def quantize_blockwise_grouped(xs, us, *, qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """B.2 over every leaf of a group: ``xs``, ``us`` lists of (K, D_l)
    float32 CUDA tensors of one K -> [(q_l int8 (K, D_l), scales_l f32 (K,
    D_l / block_l))], each leaf laid out by :func:`_pick_block` as the
    one-leaf call does.  The q's are views into one allocation, the scales
    into another.  B.4's kernel with no mask: one launch per
    :data:`MAX_GROUP_LEAVES` leaves, each adding one to
    ``quantize_blockwise_grouped.launches`` (and, with a tensor ``qmax``, to
    ``.tensor_qmax_launches``)."""
    out, launched = _quantize_grouped(xs, us, None, qmax, block_d,
                                      "quantize_blockwise_grouped")
    quantize_blockwise_grouped.launches += launched
    if isinstance(qmax, torch.Tensor):
        quantize_blockwise_grouped.tensor_qmax_launches += launched
    return out


def quantize_blockwise(x: torch.Tensor, u: torch.Tensor, *, qmax: float | torch.Tensor = 127.0,
                       block_d: int = 65536):
    """x, u: (K, D) float32 CUDA tensors -> (q int8 (K, D), scales f32 (K, D/block)).

    A one-leaf group of :func:`quantize_blockwise_grouped` on the current
    stream; adds one to ``quantize_blockwise.launches``.
    """
    [(q, scales)], launched = _quantize_grouped([x], [u], None, qmax, block_d,
                                                "quantize_blockwise")
    quantize_blockwise.launches += launched
    return q, scales


def masked_quantize_blockwise_grouped(xs, us, mask: torch.Tensor,
                                      *, qmax: float | torch.Tensor = 127.0,
                                      block_d: int = 65536):
    """B.4 over every leaf of a group: ``xs``, ``us`` lists of (K, D_l)
    float32 CUDA tensors, ``mask`` (K,) float32 in {0, 1} -> [(q_l int8 (K,
    D_l), scales_l f32 (K, D_l / block_l))], each leaf laid out by
    :func:`_pick_block` as the one-leaf call does; a masked row emits q = 0
    and scale = 0.  The q's are views into one allocation, the scales into
    another.  One launch per :data:`MAX_GROUP_LEAVES` leaves, each adding one
    to ``masked_quantize_blockwise_grouped.launches``."""
    out, launched = _quantize_grouped(xs, us, mask, qmax, block_d,
                                      "masked_quantize_blockwise_grouped")
    masked_quantize_blockwise_grouped.launches += launched
    return out


def masked_quantize_blockwise(x: torch.Tensor, u: torch.Tensor, mask: torch.Tensor, *,
                              qmax: float | torch.Tensor = 127.0, block_d: int = 65536):
    """B.2 with a per-row sender mask (K,) float32 in {0, 1}: a masked row
    emits q = 0 and scale = 0.  A one-leaf group of the B.4 kernel; adds one
    to ``masked_quantize_blockwise.launches``."""
    [(q, scales)], launched = _quantize_grouped([x], [u], mask, qmax, block_d,
                                                "masked_quantize_blockwise")
    masked_quantize_blockwise.launches += launched
    return q, scales


def _check_accumulate(name, acc, q, scales, w, mask, src):
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
    return w, mask


def _accumulate_grouped(name, accs, payloads, w, mask, src) -> int:
    if not accs or len(accs) != len(payloads):
        raise ValueError(f"{name} takes one or more leaves and one payload per leaf, got "
                         f"{len(accs)} accs and {len(payloads)} payloads")
    # each check holds the leaf to the same (K,) weights and mask
    w, mask = [_check_accumulate(name, acc, q, scales, w, mask, src)
               for acc, (q, scales) in zip(accs, payloads)][0]
    k, kq = accs[0].shape[0], payloads[0][0].shape[0]
    if any(q.shape[0] != kq for q, _ in payloads):
        raise ValueError(f"every leaf's payload must have {kq} rows")
    dims = [a.shape[1] for a in accs]
    launched = 0
    # B.5 takes the mask; B.3 is the same kernel without one (a = w)
    symbol = "dequant_accumulate_grouped_f32" if mask is None else \
        "masked_dequant_accumulate_grouped_f32"
    masks = () if mask is None else (mask.data_ptr(),)
    for table in leaf_tables([k * -(-d // ACC_CHUNK) for d in dims]):
        desc = (_LL * (6 * len(table)))(*[v for leaf, begin in table for v in (
            accs[leaf].data_ptr(), payloads[leaf][0].data_ptr(), payloads[leaf][1].data_ptr(),
            dims[leaf], payloads[leaf][1].shape[1], begin)])
        _build.launch(_entry(symbol), symbol, accs[0].device, ctypes.addressof(desc),
                      len(table), w.data_ptr(), *masks,
                      None if src is None else src.data_ptr(), k, kq)
        launched += 1
    return launched


def dequant_accumulate_grouped_(accs, payloads, w: torch.Tensor, *,
                                src: torch.Tensor | None = None):
    """B.3 over every leaf of a group, in place: for each leaf,
    ``acc_l += (w·scales_l[src])·q_l[src]`` with ``accs`` (K, D_l) float32
    and ``payloads`` [(q_l int8 (Kq, D_l), scales_l f32 (Kq, n_blk_l))];
    ``w`` holds K float32 weights and ``src`` (K,) int64 is the row each
    node receives from (None: its own row).  A row with w = 0 is left as it
    is (it is not read).  Returns ``accs``.  B.5's kernel with no mask: one
    launch per :data:`MAX_GROUP_LEAVES` leaves, each adding one to
    ``dequant_accumulate_grouped_.launches``."""
    dequant_accumulate_grouped_.launches += _accumulate_grouped(
        "dequant_accumulate_grouped_", accs, payloads, w, None, src)
    return accs


def dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                       w: torch.Tensor, *, src: torch.Tensor | None = None) -> torch.Tensor:
    """acc (K, D) f32 + (w[i]·scales[src[i], blk])·q[src[i]] -> (K, D) f32.

    A one-leaf group of :func:`dequant_accumulate_grouped_` on a copy of
    acc; a row with w = 0 returns acc bitwise.  Adds one to
    ``dequant_accumulate.launches``.
    """
    _check_accumulate("dequant_accumulate", acc, q, scales, w, None, src)
    out = acc.clone()
    dequant_accumulate.launches += _accumulate_grouped(
        "dequant_accumulate", [out], [(q, scales)], w, None, src)
    return out


def masked_dequant_accumulate_grouped_(accs, payloads, w: torch.Tensor, mask: torch.Tensor,
                                       *, src: torch.Tensor | None = None):
    """B.5 over every leaf of a group, in place: for each leaf,
    ``acc_l += ((m·w)·scales_l[src])·q_l[src]`` with ``accs`` (K, D_l)
    float32 and ``payloads`` [(q_l int8 (Kq, D_l), scales_l f32 (Kq,
    n_blk_l))]; a row with m·w = 0 is left as it is (it is not read).
    Returns ``accs``.  One launch per :data:`MAX_GROUP_LEAVES` leaves, each
    adding one to ``masked_dequant_accumulate_grouped_.launches``."""
    masked_dequant_accumulate_grouped_.launches += _accumulate_grouped(
        "masked_dequant_accumulate_grouped_", accs, payloads, w, mask, src)
    return accs


def masked_dequant_accumulate(acc: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                              w: torch.Tensor, mask: torch.Tensor, *,
                              src: torch.Tensor | None = None) -> torch.Tensor:
    """B.3 with the weight ``mask[i]·w[i]``; a masked row returns acc bitwise
    without reading the payload.  A one-leaf group of the B.5 kernel on a
    copy of acc; adds one to ``masked_dequant_accumulate.launches``."""
    _check_accumulate("masked_dequant_accumulate", acc, q, scales, w, mask, src)
    out = acc.clone()
    masked_dequant_accumulate.launches += _accumulate_grouped(
        "masked_dequant_accumulate", [out], [(q, scales)], w, mask, src)
    return out


# launches of each kernel since the last reset (the main path's proof of use)
quantize_blockwise.launches = 0
quantize_blockwise_grouped.launches = 0
quantize_blockwise_grouped.tensor_qmax_launches = 0  # of those, qmax read on the card
masked_quantize_blockwise.launches = 0
masked_quantize_blockwise_grouped.launches = 0
dequant_accumulate.launches = 0
dequant_accumulate_grouped_.launches = 0
masked_dequant_accumulate.launches = 0
masked_dequant_accumulate_grouped_.launches = 0
