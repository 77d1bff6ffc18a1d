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
and step, no copy of the cache).

The paged KV pool of the serving engine (``init_paged_kv``,
``paged_kv_write``/``gather``, ``paged_attention_decode``): one layer's KV
in a shared pool of fixed-size pages ``(num_pages, page_size, kvh, hd)``,
addressed through a per-slot block table ``(B, n_blocks)``: logical ring
position ``s`` of slot ``i`` lives at ``pool[table[i, s // page_size], s %
page_size]``.  Pools are written in place.  A quantized pool keeps int8
payloads with per-(token, block) float32 scales, the quant_gossip wire's
blockwise-absmax layout, written by its quantizer (B.2, one launch for a
layer's k and v rows on the card) with u = 0.5, i.e. round to nearest: a
KV write is deterministic.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.quant_gossip import ops as qops
from repro_torch.kernels.quant_gossip.kernel import num_blocks
from repro_torch.models import params as pr
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, linear, node_broadcast

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
    """q (..., S, H, hd), k and v (..., S, KVH, hd) of x (..., S, D): x (B,
    S, D), or (K, B, S, D) with the node axis on the weights (wq (K, D, H,
    hd), ...)."""
    dt = cfg.compute_dtype
    lead, d = x.shape[:-1], x.shape[-1]
    node = p["wq"].shape[:-3]  # (K,) with the node axis, else ()
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = x.to(dt)
    q = linear(x, p["wq"].to(dt).reshape(node + (d, h * hd))).reshape(lead + (h, hd))
    k = linear(x, p["wk"].to(dt).reshape(node + (d, kvh * hd))).reshape(lead + (kvh, hd))
    v = linear(x, p["wv"].to(dt).reshape(node + (d, kvh * hd))).reshape(lead + (kvh, hd))
    if cfg.qkv_bias:
        q = q + node_broadcast(p["bq"], 2, q.ndim).to(dt)
        k = k + node_broadcast(p["bk"], 2, k.ndim).to(dt)
        v = v + node_broadcast(p["bv"], 2, v.ndim).to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, out):
    """(..., S, H, hd) -> (..., S, D) through wo (H, hd, D), or (K, H, hd, D)
    with the node axis."""
    h, hd = out.shape[-2:]
    wo = p["wo"].to(out.dtype)
    return linear(out.reshape(out.shape[:-2] + (h * hd,)),
                  wo.reshape(wo.shape[:-3] + (h * hd, -1)))


def attention_forward(p, x, cfg: ArchConfig, *, kind: str, return_kv: bool = False):
    """Prefill path. x: (B, S, D); positions 0..S-1.  With the node axis on
    the weights, x (K, B, S, D): every node's rows go to one launch of the
    kernel as a batch of K·B, since attention has no weights of its own."""
    s = x.shape[-2]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = cfg.sliding_window if kind == "swa" else None
    out = chunked_attention(q.reshape(-1, s, kvh, h // kvh, hd), k.reshape(-1, s, kvh, hd),
                            v.reshape(-1, s, kvh, hd), window=window,
                            softcap_val=cfg.attn_softcap)
    proj = _out_proj(p, out.reshape(q.shape))
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


# -- the paged KV pool (repro_torch.serve) --------------------------------------

#: feature-dim block one float32 scale covers in a quantized pool (the
#: reference's layout: 128 lanes, or all of D where 128 does not divide it)
KV_SCALE_BLOCK = 128


def paged_kv_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    """Logical ring length of a paged layer (sliding window caps "swa")."""
    t = max_len
    if kind == "swa" and cfg.sliding_window is not None:
        t = min(t, cfg.sliding_window)
    return t


def kv_scale_blocks(cfg: ArchConfig, scale_block: int = KV_SCALE_BLOCK) -> int:
    """Scales per token a quantized pool stores (the quantizer's layout)."""
    return num_blocks(cfg.n_kv_heads * cfg.resolved_head_dim, scale_block)


def init_paged_kv(cfg: ArchConfig, num_pages: int, page_size: int, *, quantized: bool,
                  device, scale_block: int = KV_SCALE_BLOCK) -> dict:
    """Zeroed page pool of one attention layer (page 0 is the trash page)."""
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    if not quantized:
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
    scales = (num_pages, page_size, kv_scale_blocks(cfg, scale_block))
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scales, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scales, dtype=torch.float32, device=device)}


@functools.lru_cache(maxsize=64)
def _half(n: int, d: int, device: torch.device) -> torch.Tensor:
    """The rounding offset u = 0.5 of an (n, d) KV write, made once per
    shape (an ordinary tensor, usable in and out of inference mode)."""
    with torch.inference_mode(False):
        return torch.full((n, d), 0.5, dtype=torch.float32, device=device)


def quantize_kv_rows(rows, *, scale_block: int = KV_SCALE_BLOCK):
    """[(N, D) rows of one N] -> [(q int8 (N, D), scales f32 (N, D/block))],
    round to nearest.

    The quant_gossip blockwise quantizer with u = 0.5 and qmax 127, so
    ``q = clip(floor(x / scale + 0.5), ±127)`` with ``scale = absmax/127``
    per (row, block).  Every list element goes through one grouped call:
    one B.2 launch on the card for a layer's k and v (the reference
    quantizes one (N, D) array per call).
    """
    rows = [r.float().contiguous() for r in rows]
    n, d = rows[0].shape
    half = _half(n, d, rows[0].device)
    return qops.quantize_blockwise_grouped(rows, [half] * len(rows), qmax=127.0,
                                           block_d=scale_block)


def paged_kv_write(pool: dict, k, v, page_ids, offsets, *,
                   scale_block: int = KV_SCALE_BLOCK) -> dict:
    """Scatter one new token per slot into ``pool``, in place.

    k, v: (B, kvh, hd); page_ids, offsets: (B,) int64 (inactive slots point
    at the trash page 0; which of their duplicate writes lands is
    unspecified, and those rows are never read).  Returns ``pool``.
    """
    b, kvh, hd = k.shape
    if "k_scale" not in pool:
        pool["k"][page_ids, offsets] = k.to(pool["k"].dtype)
        pool["v"][page_ids, offsets] = v.to(pool["v"].dtype)
        return pool
    (qk, sk), (qv, sv) = quantize_kv_rows([k.reshape(b, kvh * hd), v.reshape(b, kvh * hd)],
                                          scale_block=scale_block)
    pool["k"][page_ids, offsets] = qk.reshape(b, kvh, hd)
    pool["v"][page_ids, offsets] = qv.reshape(b, kvh, hd)
    pool["k_scale"][page_ids, offsets] = sk
    pool["v_scale"][page_ids, offsets] = sv
    return pool


def paged_kv_gather(pool: dict, table, t: int, out_dtype):
    """Read (k, v) (B, t, kvh, hd) through the block table, dequantizing.

    ``table`` (B, n_blocks) with n_blocks * page_size >= t.  Unwritten
    logical slots come back as whatever the page holds: callers mask
    validity by position exactly as the contiguous decode path does.
    """
    ps, kvh, hd = pool["k"].shape[1:]
    d = kvh * hd

    def one(name):
        g = pool[name][table]                       # (B, NB, ps, kvh, hd)
        b, nb = g.shape[:2]
        g = g.reshape(b, nb * ps, kvh, hd)[:, :t]
        if name + "_scale" not in pool:
            return g.to(out_dtype)
        s = pool[name + "_scale"][table].reshape(b, nb * ps, -1)[:, :t]
        full = g.float().reshape(b, t, d) * s.repeat_interleave(d // s.shape[-1], dim=-1)
        return full.reshape(b, t, kvh, hd).to(out_dtype)

    return one("k"), one("v")


def paged_attention_decode(p, x, cfg: ArchConfig, *, kind: str, pool: dict, table, pos,
                           max_len: int, scale_block: int = KV_SCALE_BLOCK):
    """Single-token decode against a paged pool, one position per slot.

    x: (B, 1, D); pos: (B,) int64 on x's device (each serving slot at its
    own position, ring slot ``pos % t``); pool: one layer's page pool,
    written in place; table: (B, n_blocks).  Returns (out (B, 1, D),
    pool).  The math of :func:`attention_decode`: with a float32 pool and
    lockstep positions the logits are bit-equal.
    """
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t = paged_kv_len(cfg, kind, max_len)
    ps = pool["k"].shape[1]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])

    slot = pos % t  # ring position, exactly as the contiguous cache
    page_ids = table.gather(1, (slot // ps)[:, None])[:, 0]
    paged_kv_write(pool, k[:, 0], v[:, 0], page_ids, slot % ps, scale_block=scale_block)
    ck, cv = paged_kv_gather(pool, table, t, pool["k"].dtype
                             if "k_scale" not in pool else cfg.compute_dtype)

    idx = torch.arange(t, device=x.device)
    valid = (idx[None, :] <= pos[:, None]) | (pos[:, None] >= t)  # (B, t)
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(b, 1, kvh, h // kvh, hd)
    sc = _scores(qh, ck, scale, cfg.attn_softcap)             # (B,KV,G,1,T)
    sc = torch.where(valid[:, None, None, None, :], sc, torch.full_like(sc, MASKED))
    att = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", att, cv.float())
    out = out.reshape(b, 1, h, hd).to(x.dtype)
    return _out_proj(p, out), pool
