"""Token selection for the decode step (the port of
``repro.serve.sampling``)."""

from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, gen: torch.Generator,
                  temperature: torch.Tensor) -> torch.Tensor:
    """One token per batch row.

    logits: (B, V); gen: a generator on logits' device; temperature: (B,)
    float32.  Rows with ``temperature == 0`` take the argmax (the first
    maximal index, as ``jnp.argmax``); rows with ``temperature > 0`` draw
    from ``softmax(logits / temperature)`` with ``gen`` (the reference draws
    from a JAX key: the same distribution, not the same bits).  Returns (B,)
    int64.
    """
    greedy = logits.argmax(dim=-1)
    t = temperature.clamp_min(1e-6)[:, None]
    probs = torch.softmax(logits.float() / t, dim=-1)
    drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(temperature > 0, drawn, greedy)
