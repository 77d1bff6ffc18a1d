"""Carry parameters between the reference's pytrees and the port's dicts.

The reference keeps a model's parameters as a nested dict of arrays
(``{"fc0": {"w": (in, out), "b": (out,)}, ...}``; conv kernels HWIO).  The
port keeps the same leaves, in the same layout, as a flat dict keyed
``"fc0/w"`` — sorted keys are the reference's flatten order.  Layout changes
the port's kernels need (OIHW convolution weights) happen inside the model
functions, never at this boundary, so a parameter, its gradient and its wire
payload have the same element order on both sides.

The LM's tree (``repro.models.TransformerLM``) carries the same way: its
stacked layer groups keep their leading group axis (``"groups/l0/mix/wq"``:
(n_groups, d, H, hd)).  ``repro_torch.utils.tree.unflatten`` rebuilds the
reference's nesting from a flat dict.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.tree import flatten as _flatten


def params_from_numpy(tree: Mapping, device: str | torch.device = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """Reference parameter pytree (numpy leaves, nested or ``"a/b"``-keyed)
    -> the port's flat dict of tensors on ``device``, in sorted key order."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    return {name: torch.from_numpy(np.array(flat[name], copy=True)).to(dev)
            for name in sorted(flat)}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's flat dict -> ``{"fc0/w": ndarray, ...}`` on the host."""
    return {name: params[name].detach().cpu().numpy() for name in sorted(params)}
