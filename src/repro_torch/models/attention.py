"""GQA attention: the prefill path through the flash-attention kernel, and
the cached single-token decode (the port of ``repro.models.attention``).

``chunked_attention`` is the reference's XLA online-softmax attention with
q and k positions both starting at 0, which is how every caller uses it
(``TransformerLM._forward``); the reference names it the oracle of its
Pallas ``flash_attention`` kernel.  In the port it *is* that kernel: one
launch of B.6 per layer on the model's (B, S, KVH, G, hd) layout for CUDA
tensors, the plain version for CPU tensors.  It has a gradient: on the card
a ``torch.autograd.Function`` whose backward is B.6's backward kernel
(where the reference differentiates its XLA attention), on the CPU autograd
through the plain version.  The QKV and output projections and RoPE are
plain PyTorch either way.

Supports grouped KV heads, RoPE, optional QKV bias (qwen2), sliding-window
masking (h2o-danube, gemma2 local layers), attention-score soft-capping
(gemma2), and ring-buffer KV caches for decode.  ``attention_decode``
writes the new token's K/V into the cache in place (one token per layer
and step, no copy of the cache).  The paged KV pool (``init_paged_kv``,
``paged_kv_write``/``gather``, ``paged_attention_decode``) comes with the
engine slice (ROADMAP A.12).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import params as pr
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope

MASKED = -1e30


def attention_decl(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    decl = {
        "wq": pr.normal((d, h, hd), ("embed", "q_heads", None), fan_in=d),
        "wk": pr.normal((d, kv, hd), ("embed", "kv_heads", None), fan_in=d),
        "wv": pr.normal((d, kv, hd), ("embed", "kv_heads", None), fan_in=d),
        "wo": pr.normal((h, hd, d), ("q_heads", None, "embed"), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        decl["bq"] = pr.zeros((h, hd), ("q_heads", None))
        decl["bk"] = pr.zeros((kv, hd), ("kv_heads", None))
        decl["bv"] = pr.zeros((kv, hd), ("kv_heads", None))
    return decl


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int, kind: str, device) -> dict:
    """Zeroed KV cache of one attention layer; a sliding-window layer keeps
    only ``window`` slots (a ring buffer)."""
    t = seq_len
    if kind == "swa" and cfg.sliding_window is not None:
        t = min(t, cfg.sliding_window)
    shape = (batch, t, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _mask_bias(q_pos, k_pos, window: int | None):
    """(…, q, k) additive mask: causal, optionally sliding-window."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = diff >= 0
    if window is not None:
        ok &= diff < window
    return torch.where(ok, 0.0, MASKED).float()


def _scores(q, k, scale, cap):
    # q: (B, qc, KV, G, hd)  k: (B, kc, KV, hd) -> (B, KV, G, qc, kc)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    return s


def chunked_attention(q, k, v, *, window=None, softcap_val=None):
    """Causal attention, q and k positions both from 0.

    q: (B, S, KV, G, hd); k, v: (B, T, KV, hd).  Returns (B, S, KV, G, hd)
    in q's dtype.  One call of the flash-attention kernel (B.6) for CUDA
    tensors, its plain version for CPU tensors; q, k and v are handed over
    as (B, H, S, hd) / (B, KV, T, hd) views, and the kernel writes its
    output in q's memory layout, so nothing is transposed in memory.  Where
    autograd records, the backward is one launch of B.6's backward kernel
    on the card (``kernels/flash_attention/ops.py``).
    """
    b, s, kvh, g, hd = q.shape
    qh = q.reshape(b, s, kvh * g, hd).permute(0, 2, 1, 3)
    out = fa_ops.flash_attention(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                                 causal=True, window=window, softcap=softcap_val)
    return out.permute(0, 2, 1, 3).reshape(b, s, kvh, g, hd)


def _project_qkv(p, x, cfg: ArchConfig, positions):
    dt = cfg.compute_dtype
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = x.to(dt)
    q = (x @ p["wq"].to(dt).reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(dt).reshape(d, kvh * hd)).reshape(b, s, kvh, hd)
    v = (x @ p["wv"].to(dt).reshape(d, kvh * hd)).reshape(b, s, kvh, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, out):
    b, s, h, hd = out.shape
    return out.reshape(b, s, h * hd) @ p["wo"].to(out.dtype).reshape(h * hd, -1)


def attention_forward(p, x, cfg: ArchConfig, *, kind: str, return_kv: bool = False):
    """Prefill path. x: (B, S, D); positions 0..S-1."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = cfg.sliding_window if kind == "swa" else None
    out = chunked_attention(q.reshape(b, s, kvh, h // kvh, hd), k, v, window=window,
                            softcap_val=cfg.attn_softcap)
    proj = _out_proj(p, out.reshape(b, s, h, hd))
    if return_kv:
        return proj, {"k": k, "v": v}
    return proj


def attention_decode(p, x, cfg: ArchConfig, *, kind: str, cache, pos: int):
    """Single-token decode. x: (B, 1, D); pos: int; cache: {k, v}, updated in
    place.  Returns (out (B, 1, D), cache).  Sliding-window layers use the
    cache as a ring buffer over ``window`` slots."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t = cache["k"].shape[1]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)

    slot = pos % t  # full caches (t == seq_len) and ring buffers alike
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)

    # validity: slots <= pos are filled; once pos >= t the ring is full.
    idx = torch.arange(t, device=x.device)
    valid = (idx <= pos) | (pos >= t)
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(b, 1, kvh, h // kvh, hd)
    sc = _scores(qh, cache["k"], scale, cfg.attn_softcap)      # (B,KV,G,1,T)
    sc = torch.where(valid, sc, torch.full_like(sc, MASKED))
    att = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", att, cache["v"].float())
    out = out.reshape(b, 1, h, hd).to(x.dtype)
    return _out_proj(p, out), cache
