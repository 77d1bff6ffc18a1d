"""The WKV6 function the rest of the port calls.

``wkv6`` takes the plain PyTorch version only for tensors on the CPU, and
counts those calls in ``.plain_calls``; autograd differentiates it there.
For CUDA tensors it launches the hand-written kernels or raises — there is
no fallback: the forward (B.7) alone where no gradient is recorded, else
:class:`WKV6`, whose backward is B.7's backward kernel.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import kernel as _k
from repro_torch.kernels.rwkv6_scan import ref as _r
from repro_torch.kernels.rwkv6_scan.kernel import BWD_HEAD_DIMS, check_head_dim


def _f32(x):
    return None if x is None else x.float()


class WKV6(torch.autograd.Function):
    """B.7 with its backward kernel, for CUDA tensors.  An output autograd
    does not reach (the final state, in training) has no cotangent: the
    kernel takes it as zero.  The backward kernel takes float32: saved
    bfloat16 inputs are widened for it, and each gradient comes back in its
    input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        check_head_dim("wkv6's backward", r.shape[-1], BWD_HEAD_DIMS)
        y, state = _k.wkv6_scan(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r, dtype=torch.float32)
        elif dy.stride(-1) != 1 or dy.dtype != torch.float32:
            dy = dy.float().contiguous()
        if ds is not None:
            ds = ds.float().contiguous()
        ins = (r, k, v, w, u, s0)
        grads = _k.wkv6_bwd(*map(_f32, ins[:5]), dy, _f32(s0), ds)
        return tuple(None if g is None else g.to(x.dtype) for g, x in zip(grads, ins))


def wkv6(r, k, v, w, u, s0=None):
    """r, k, v, w: (B, H, T, hd); u: (H, hd); s0: (B, H, hd, hd) or None.

    Returns (y (B, H, T, hd), final state (B, H, hd, hd) float32).
    """
    if _build.route("wkv6", r):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
            return WKV6.apply(r, k, v, w, u, s0)
        return _k.wkv6_scan(r, k, v, w, u, s0)
    wkv6.plain_calls += 1
    return _r.wkv6_ref(r, k, v, w, u, s0)


# how often the plain version served a call (CPU tensors only; autograd
# differentiates it there, so it stands for the backward's plain calls too)
wkv6.plain_calls = 0
