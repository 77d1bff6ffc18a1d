"""Fixed-bin streaming histograms computed on the device, riding the obs tap.

The port of ``repro.obs.hist``.  The paper's headline quantities are
distributional (worst-node loss, the adversarial DR mixture, EF innovation
energy), but scalar rollups only show their extremes.  :func:`hist_counts`
buckets a tensor into a fixed ``bins``-bin grid with one ``searchsorted``
and one ``scatter_add`` over the valid mask: no data-dependent shapes and no
host synchronisation (``torch.bincount`` sizes its output from the data's
maximum on the card, which waits for it), and the counts only *read* values
the step computes.  The train step's tap does not count on the device: it
packs the :func:`transform`-ed values, and the sink buckets them when it
drains with :func:`bucket_counts`, which gives ``hist_counts``'s counts for
the same float32 values (the comparisons are exact in both).

Bin conventions (the reference's, which are ``np.histogram``'s):

* edges are the reference's float32 ``linspace(lo, hi, bins + 1)``; bin *i*
  covers ``[e_i, e_{i+1})`` and the last bin is closed at ``hi``.
* values outside ``[lo, hi]`` are dropped (``sum(counts) < K`` on a record
  is the overflow signal).
* ``log10=True`` histograms ``log10(max(x, 1e-30))``.  XLA's and PyTorch's
  ``log10`` may round one ulp apart, so a value within an ulp of an edge
  may land one bin apart between the packages.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """One streaming histogram: the source field and its fixed-bin grid.

    Attributes:
      source: name of the tensor to bucket (the train step maps
        ``loss_nodes`` / ``dr_weights`` / ``ef_res``); the tap field is
        ``hist_<source>``.
      lo, hi: grid range (of ``log10(x)`` when ``log10`` is set).
      bins: number of fixed bins.
      log10: bucket ``log10(max(x, 1e-30))`` instead of ``x``.
    """

    source: str
    lo: float
    hi: float
    bins: int = 16
    log10: bool = False

    def __post_init__(self):
        if self.bins < 1:
            raise ValueError("bins must be >= 1")
        if not self.hi > self.lo:
            raise ValueError(f"need hi > lo, got [{self.lo}, {self.hi}]")

    @property
    def field(self) -> str:
        return f"hist_{self.source}"


def _edges_np(spec: HistSpec) -> np.ndarray:
    """The reference's float32 edges, computed as XLA's CPU backend
    computes its ``jnp.linspace``: s_i = i·r with r = f32(1/bins), then
    lo·(1 − s_i) + i·(hi·r) with the last multiply-add fused (one
    rounding).  ``torch.linspace`` and a plain float32 evaluation round
    some grids apart; this form equals the reference on every
    :data:`TRAIN_HISTOGRAMS` spec (``tests/test_torch_obs.py``), and on a
    few other grids an interior edge can still land one ulp apart."""
    f32 = np.float32
    lo, hi = f32(spec.lo), f32(spec.hi)
    i = np.arange(spec.bins, dtype=f32)
    r = f32(1) / f32(spec.bins)
    left = lo * (f32(1) - i * r)
    inner = (i.astype(np.float64) * np.float64(hi * r) + left.astype(np.float64)).astype(f32)
    return np.concatenate([inner, [hi]]).astype(f32)


@functools.cache
def _edges_cached(spec: HistSpec) -> np.ndarray:
    return _edges_np(spec)


def bucket_counts(x: np.ndarray, spec: HistSpec) -> list[int]:
    """:func:`hist_counts` on the host: the counts of float32 values that
    are already :func:`transform`-ed, with the same rules (``side="right"``
    search, ``x == hi`` into the last bin, out-of-range and NaN values
    dropped)."""
    e = _edges_cached(spec)
    x = np.asarray(x, dtype=np.float32)
    idx = np.searchsorted(e, x, side="right") - 1
    idx = np.where(x == e[-1], spec.bins - 1, idx).clip(0, spec.bins - 1)
    valid = (x >= e[0]) & (x <= e[-1])
    return np.bincount(idx[valid], minlength=spec.bins).tolist()


def edges(spec: HistSpec, device="cpu") -> torch.Tensor:
    """The float32 bin-edge vector (``bins + 1``,) of a spec on ``device``
    (a host-to-device copy of ``bins + 1`` floats)."""
    return torch.from_numpy(_edges_np(spec)).to(device)


def transform(spec: HistSpec, x: torch.Tensor) -> torch.Tensor:
    """The value actually bucketed (identity, or clamped log10), flat float32."""
    x = x.reshape(-1).float()
    if spec.log10:
        x = torch.log10(torch.clamp_min(x, 1e-30))
    return x


def hist_counts(x: torch.Tensor, spec: HistSpec, e: torch.Tensor | None = None) -> torch.Tensor:
    """``np.histogram``-exact int64 bin counts of ``x`` under ``spec``, on
    ``x``'s device, with no host synchronisation.

    ``searchsorted(right=True) - 1`` puts a value equal to an interior edge
    into the right bin and ``x == hi`` into the last; out-of-range values
    add 0.  ``e`` is :func:`edges` on ``x``'s device (built here when None).
    """
    x = transform(spec, x)
    if e is None:
        e = edges(spec, x.device)
    idx = torch.searchsorted(e, x, right=True) - 1
    idx = torch.where(x == e[-1], spec.bins - 1, idx)
    valid = (x >= e[0]) & (x <= e[-1])
    idx = idx.clamp(0, spec.bins - 1)
    counts = torch.zeros(spec.bins, dtype=torch.int64, device=x.device)
    return counts.scatter_add_(0, idx, valid.long())


#: the train step's histograms (see repro_torch.core.drdsgd): per-node
#: minibatch loss, the DR mixture weights (a distribution over K nodes, so
#: [0, 1] covers it), and the EF innovation norm on a log10 grid
TRAIN_HISTOGRAMS: tuple[HistSpec, ...] = (
    HistSpec("loss_nodes", lo=0.0, hi=8.0, bins=16),
    HistSpec("dr_weights", lo=0.0, hi=1.0, bins=16),
    HistSpec("ef_res", lo=-8.0, hi=2.0, bins=16, log10=True),
)
