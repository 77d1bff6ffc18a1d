"""Plain PyTorch version of the flash-attention kernel.

Dense softmax attention in float32 with the scores materialised, as the
reference's oracle ``repro/kernels/flash_attention/ref.py::attention_ref``
computes it: scale 1/√hd, optional tanh softcap, causal and sliding-window
masks with both position axes from 0, masked scores −1e30 (a row never
gives NaN).  Query head h reads KV head ``h // (H / KVH)``.  S and T are
arbitrary.  The CPU path of the port and the tests use it; on the card it
serves only as the kernel's yardstick.
"""

from __future__ import annotations

import torch

MASKED = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KVH, T, hd) -> (B, H, S, hd) in q's dtype."""
    _, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    k = k.float().repeat_interleave(g, dim=1)
    v = v.float().repeat_interleave(g, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / (hd ** 0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, torch.full_like(scores, MASKED))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", att, v).to(q.dtype)
