"""The flash-attention function the rest of the port calls.

``flash_attention`` takes the plain PyTorch version only for tensors on the
CPU, and counts those calls in ``.plain_calls``; autograd differentiates it
there.  For CUDA tensors it launches the hand-written kernels or raises —
there is no fallback: the forward (B.6) alone where no gradient is
recorded, else :class:`FlashAttention`, whose forward also keeps the row
log-sum-exp and whose backward is B.6's backward kernel.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _r
from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS, check_head_dim


class FlashAttention(torch.autograd.Function):
    """B.6 with its backward kernel, for CUDA tensors.  The backward kernel
    takes float32: saved bfloat16 inputs (and the bfloat16 output) are
    widened for it, and each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        check_head_dim("flash attention's backward", q.shape[-1], BWD_HEAD_DIMS)
        out, lse = _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                          softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _k.flash_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                                            dout.float(), **ctx.mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KVH, T, hd) -> (B, H, S, hd)."""
    if _build.route("flash_attention", q):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window, softcap)
        return _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    flash_attention.plain_calls += 1
    return _r.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)


# how often the plain version served a call (CPU tensors only; autograd
# differentiates it there, so it stands for the backward's plain calls too)
flash_attention.plain_calls = 0
