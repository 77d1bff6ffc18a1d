"""Prompt ingestion into a contiguous decode cache, and the static-batch
generation loop (the port of the contiguous half of
``repro.serve.prefill``).

* :func:`merge_prefill_cache` scatters ``model.prefill``'s caches into a
  decode cache of ``cache_len`` slots, ready for ``decode_step`` at
  ``pos = s0``.
* :func:`greedy_generate` runs the prompt through ``prefill`` (or, with
  ``use_prefill=False``, token by token through the decode path) and then
  samples from the previous logits and decodes, one token per step.

The paged admission functions (``place_paged_prefill``,
``clear_slot_state``) come with the engine slice (ROADMAP A.12).
"""

from __future__ import annotations

import torch

from repro_torch.models import TransformerLM
from repro_torch.serve.sampling import sample_tokens


def _place_layer(blk: str, dst: dict, src: dict, s0: int, grouped: bool) -> dict:
    """Scatter one layer's prefill cache into its allocated decode cache.

    attn/swa KV leaves are (B, T, kvh, hd) (plus a leading group axis when
    ``grouped``): a prompt shorter than the buffer lands at slots
    ``0..s0-1``; a full sliding-window ring buffer (prefill keeps the last
    ``window`` positions) is rolled so position p sits at slot ``p % window``
    — exactly where ``attention_decode`` will read and write next.
    Recurrent states (rwkv) are already the post-prompt state and pass
    through.  Writes into ``dst`` and returns it.
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


def greedy_generate(model: TransformerLM, params: dict, prompt: torch.Tensor,
                    gen_len: int, temperature: float = 0.0, seed: int = 0,
                    use_prefill: bool = True) -> torch.Tensor:
    """prompt: (B, S0) int64 on the params' device.  Returns (B, gen_len)
    generated tokens: each step samples from the previous logits
    (:func:`sample_tokens`, greedy at temperature 0), then decodes it."""
    b, s0 = prompt.shape
    cache_len = s0 + gen_len
    with torch.inference_mode():
        if use_prefill:
            logits, pf = model.prefill(params, {"tokens": prompt})
            cache = merge_prefill_cache(model, pf, b, cache_len, s0)
        else:  # the prompt token by token through the decode path
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
