"""Declarative parameters: one decl dict drives init, shapes and counts (the
port of ``repro.models.params``).

A model declares every parameter once, as a flat dict keyed ``"a/b"`` (the
port's parameter layout, ``repro_torch/convert.py``) whose sorted order is
the reference's flatten order.  The logical axis names are kept as data;
the reference maps them onto a device mesh (``spec_tree``), which has no
meaning on one card and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

LogicalAxis = str | None


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    axes: tuple[LogicalAxis, ...]
    init: str = "normal"      # normal | zeros | ones | constant
    scale: float = 0.02       # std for normal init / value for constant
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} length mismatch")


def normal(shape, axes, fan_in: int | None = None, dtype=torch.float32) -> ParamDecl:
    """Normal init with 1/sqrt(fan_in) std (explicit fan_in at the decl site)."""
    std = 0.02 if fan_in is None else 1.0 / math.sqrt(fan_in)
    return ParamDecl(tuple(shape), tuple(axes), "normal", std, dtype)


def zeros(shape, axes, dtype=torch.float32) -> ParamDecl:
    return ParamDecl(tuple(shape), tuple(axes), "zeros", 0.0, dtype)


def ones(shape, axes, dtype=torch.float32) -> ParamDecl:
    return ParamDecl(tuple(shape), tuple(axes), "ones", 1.0, dtype)


def constant(shape, axes, value: float, dtype=torch.float32) -> ParamDecl:
    return ParamDecl(tuple(shape), tuple(axes), "constant", value, dtype)


def init_tree(gen: torch.Generator, decls: dict[str, ParamDecl],
              device: str | torch.device) -> dict[str, torch.Tensor]:
    """Materialise ``decls`` on ``device``, the normal leaves drawn from
    ``gen`` (a generator on that device) in sorted key order."""
    out = {}
    for name in sorted(decls):
        d = decls[name]
        if d.init == "normal":
            x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
            out[name] = x.mul_(d.scale).to(d.dtype)
        elif d.init in ("zeros", "ones", "constant"):
            out[name] = torch.full(d.shape, d.scale, dtype=d.dtype, device=device)
        else:
            raise ValueError(f"unknown init {d.init}")
    return out


def shape_tree(decls: dict[str, ParamDecl]) -> dict[str, torch.Tensor]:
    """Stand-ins with no storage (``meta`` tensors), in sorted key order."""
    return {name: torch.empty(decls[name].shape, dtype=decls[name].dtype, device="meta")
            for name in sorted(decls)}


def count_params(decls: dict[str, ParamDecl]) -> int:
    return sum(math.prod(d.shape) for d in decls.values())
