"""Prompt ingestion and the static-batch generation loop (the port of
``repro.serve.prefill``).

* :func:`merge_prefill_cache` scatters ``model.prefill``'s caches into a
  contiguous decode cache of ``cache_len`` slots, ready for
  ``decode_step`` at ``pos = s0``.
* :func:`place_paged_prefill` / :func:`clear_slot_state` scatter ONE
  request's prefill caches into the shared paged decode cache at a slot,
  through the slot's block-table rows, in place: the engine's admission.
  A quantized pool's rows go through the quantizer once per attention
  layer kind of the pattern, every group's k and v rows in one call (one
  B.2 launch on the card), as the reference quantizes a pattern slot's
  stacked rows at once.
* :func:`greedy_generate` runs the prompt through ``prefill`` (or, with
  ``use_prefill=False`` and for the stub frontends, which have no
  prompt-only prefill, token by token through the decode path) and then
  samples from the previous logits and decodes, one token per step.
"""

from __future__ import annotations

import torch

from repro_torch.models import TransformerLM
from repro_torch.models.attention import paged_kv_len, quantize_kv_rows
from repro_torch.models.ssm import recurrent_init_state
from repro_torch.serve.sampling import sample_tokens


def _place_layer(blk: str, dst: dict, src: dict, s0: int, grouped: bool) -> dict:
    """Scatter one layer's prefill cache into its allocated decode cache.

    attn/swa KV leaves are (B, T, kvh, hd) (plus a leading group axis when
    ``grouped``): a prompt shorter than the buffer lands at slots
    ``0..s0-1``; a full sliding-window ring buffer (prefill keeps the last
    ``window`` positions) is rolled so position p sits at slot ``p % window``
    — exactly where ``attention_decode`` will read and write next.
    Recurrent states (mamba, rwkv) are already the post-prompt state and
    pass through.  Writes into ``dst`` and returns it.
    """
    if blk not in ("attn", "swa"):
        return src
    ax = 2 if grouped else 1  # the sequence axis of the KV leaves
    for name, d in dst.items():
        s = src[name].to(d.dtype)
        t, sl = d.shape[ax], s.shape[ax]
        if sl == t:
            d.copy_(torch.roll(s, s0 % t, dims=ax))
        else:
            d.narrow(ax, 0, sl).copy_(s)
    return dst


def merge_prefill_cache(model: TransformerLM, prefill_caches, batch: int,
                        cache_len: int, s0: int) -> dict:
    """The decode cache for ``cache_len`` from ``model.prefill``'s
    ``(head_caches, group_caches)``: ``model.init_cache``'s structure with
    the prompt's KV and states in place, ready for ``decode_step`` at
    ``pos = s0``."""
    cfg = model.cfg
    head_pf, group_pf = prefill_caches
    device = _device_of(prefill_caches)
    cache = model.init_cache(batch, cache_len, device)
    head = [_place_layer(blk, cache["head"][i], head_pf[i], s0, grouped=False)
            for i, (blk, _) in enumerate(cfg.head_layers())]
    groups = {f"l{i}": _place_layer(blk, cache["groups"][f"l{i}"], group_pf[f"l{i}"], s0,
                                    grouped=True)
              for i, (blk, _) in enumerate(cfg.group_pattern())}
    return {"head": head, "groups": groups}


def _device_of(caches) -> torch.device:
    head, groups = caches
    first = head[0] if head else next(iter(groups.values()))
    return next(iter(first.values())).device


def _scatter_paged_kv(cfg, kind: str, pool: dict, kv: dict, table_row, s0: int,
                      max_len: int, grouped: bool) -> dict:
    """Write one request's prefill KV (batch 1, length s0 - 1) into
    ``pool`` in place.

    Only the last ``min(L, t)`` prompt positions are written, position p at
    ring slot ``p % t`` through ``table_row``, so the scatter's indices are
    distinct even when the prompt overflows a sliding window.
    """
    t = paged_kv_len(cfg, kind, max_len)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    ax = 2 if grouped else 1  # the sequence axis of the prefill KV leaves
    ps = pool["k"].shape[ax]
    length = kv["k"].shape[ax]
    m = min(length, t)
    if m == 0:
        return pool
    slots = (s0 - 1 - m + torch.arange(m, device=table_row.device)) % t
    pages, offs = table_row[slots // ps], slots % ps
    rows = {name: kv[name][:, 0, length - m:] if grouped else kv[name][0, length - m:]
            for name in ("k", "v")}
    if "k_scale" not in pool:
        for name, r in rows.items():
            if grouped:
                pool[name][:, pages, offs] = r.to(pool[name].dtype)
            else:
                pool[name][pages, offs] = r.to(pool[name].dtype)
        return pool
    lead = rows["k"].shape[:-2]  # (G, m) or (m,)
    (qk, sk), (qv, sv) = quantize_kv_rows([rows["k"].reshape(-1, kvh * hd),
                                           rows["v"].reshape(-1, kvh * hd)])
    for name, q, s in (("k", qk, sk), ("v", qv, sv)):
        if grouped:
            pool[name][:, pages, offs] = q.reshape(*lead, kvh, hd)
            pool[name + "_scale"][:, pages, offs] = s.reshape(*lead, -1)
        else:
            pool[name][pages, offs] = q.reshape(*lead, kvh, hd)
            pool[name + "_scale"][pages, offs] = s.reshape(*lead, -1)
    return pool


def _map_slot_cache(model: TransformerLM, cache: dict, place) -> dict:
    """Apply ``place(blk, dst, grouped, i)`` to every layer's cache (``i``
    indexes the head layers and the group pattern respectively)."""
    cfg = model.cfg
    head = [place(blk, cache["head"][i], False, i) for i, (blk, _) in enumerate(cfg.head_layers())]
    groups = {f"l{i}": place(blk, cache["groups"][f"l{i}"], True, i)
              for i, (blk, _) in enumerate(cfg.group_pattern())}
    return {"head": head, "groups": groups}


def _set_row(dst: dict, src: dict, slot: int, grouped: bool) -> dict:
    """Slot ``slot``'s row of each recurrent leaf := ``src``'s only row."""
    for name, d in dst.items():
        if grouped:
            d[:, slot] = src[name][:, 0].to(d.dtype)
        else:
            d[slot] = src[name][0].to(d.dtype)
    return dst


def place_paged_prefill(model: TransformerLM, prefill_caches, cache: dict, table_rows: dict,
                        slot: int, s0: int, max_len: int) -> dict:
    """Admit one request: scatter its prefill caches into ``cache`` at
    ``slot``, in place, and return ``cache``.

    ``prefill_caches`` comes from ``model.prefill`` on the (1, s0 - 1)
    prompt prefix; ``table_rows`` is {kind: (n_blocks,) int64 on the
    device} (the slot's rows of the block tables).  KV goes through the
    block table; recurrent states replace the slot's row.
    """
    head_pf, group_pf = prefill_caches
    cfg = model.cfg

    def place(blk, dst, grouped, i):
        src = group_pf[f"l{i}"] if grouped else head_pf[i]
        if blk in ("attn", "swa"):
            return _scatter_paged_kv(cfg, blk, dst, src, table_rows[blk], s0, max_len, grouped)
        return _set_row(dst, src, slot, grouped)

    return _map_slot_cache(model, cache, place)


def clear_slot_state(model: TransformerLM, cache: dict, slot: int) -> dict:
    """Admit a length-1 prompt: nothing to prefill, but the slot's recurrent
    rows still hold the previous request's state; reset them in place.
    (Paged KV needs no clearing: validity masking by position never reads a
    slot the new request has not written.)"""

    def place(blk, dst, grouped, i):
        if blk in ("attn", "swa"):
            return dst
        fresh = recurrent_init_state(model.cfg, blk, 1, next(iter(dst.values())).device)
        if grouped:
            fresh = {k: v[None] for k, v in fresh.items()}
        return _set_row(dst, fresh, slot, grouped)

    return _map_slot_cache(model, cache, place)


def greedy_generate(model: TransformerLM, params: dict, prompt: torch.Tensor,
                    gen_len: int, temperature: float = 0.0, seed: int = 0,
                    use_prefill: bool = True) -> torch.Tensor:
    """prompt: (B, S0) int64 on the params' device.  Returns (B, gen_len)
    generated tokens: each step samples from the previous logits
    (:func:`sample_tokens`, greedy at temperature 0), then decodes it."""
    b, s0 = prompt.shape
    cache_len = s0 + gen_len
    with torch.inference_mode():
        if use_prefill and model.has_prompt_prefill:
            logits, pf = model.prefill(params, {"tokens": prompt})
            cache = merge_prefill_cache(model, pf, b, cache_len, s0)
        else:  # stub frontends (or use_prefill=False): the prompt token by token
            # through the decode path
            cache = model.init_cache(b, cache_len, prompt.device)
            logits = None
            for t in range(s0):
                logits, cache = model.decode_step(params, prompt[:, t:t + 1], t, cache)
        gen = torch.Generator(device=prompt.device).manual_seed(seed)
        temp = torch.full((b,), temperature, dtype=torch.float32, device=prompt.device)
        outs = []
        for t in range(gen_len):
            tok = sample_tokens(logits, gen, temp)
            outs.append(tok)
            logits, cache = model.decode_step(params, tok[:, None], s0 + t, cache)
        return torch.stack(outs, dim=1)
