"""Shared neural building blocks over the port's flat parameter dicts (the
port of ``repro.models.layers``).

Each function takes the dict of one module's leaves (``{"scale": ...}``,
``{"w_gate": ..., "w_up": ..., "w_down": ...}``).

The node axis: where the leaves carry a leading node axis K (the
decentralized trainer's node-stacked parameters) and the activations a
leading K too, each function computes every node's own result at once, as
the reference's ``vmap`` over nodes does: products are batched over K
(:func:`linear`), a norm's scale and a bias broadcast per node
(:func:`node_broadcast`), and nothing mixes nodes.  A leaf has the node
axis when its rank is one above its declared rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import params as pr


def rmsnorm_decl(d: int) -> dict:
    return {"scale": pr.ones((d,), ("embed",))}


def node_broadcast(w: torch.Tensor, rank: int, ndim: int) -> torch.Tensor:
    """A leaf of declared rank ``rank`` as it broadcasts against activations
    of rank ``ndim``: unchanged without the node axis; with it, w (K,
    *shape) becomes (K, 1, ..., 1, *shape), node i's leaf against node i's
    rows."""
    if w.ndim == rank:
        return w
    return w.reshape(w.shape[:1] + (1,) * (ndim - w.ndim) + w.shape[1:])


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., D) and w (D, N); with the node axis, x (K, ...,
    D) and w (K, D, N): one product batched over the K nodes, node i's rows
    against node i's weight."""
    if w.ndim == 2:
        return x @ w
    k, d, n = w.shape
    return torch.bmm(x.reshape(k, -1, d), w).reshape(x.shape[:-1] + (n,))


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * node_broadcast(p["scale"], 1, x.ndim).float()
    return out.to(x.dtype)


def softcap(x, cap: float | None):
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# -- rotary position embeddings ---------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- GLU MLP ------------------------------------------------------------------

def sigmoid(x):
    """``jax.nn.sigmoid``.  Below float32 the reference computes it as XLA
    expands it, 1 / (1 + exp(-x)) with each step rounded to x's dtype
    (``torch.sigmoid`` rounds once); float32 keeps ``torch.sigmoid``."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``, x * sigmoid(x): below float32 the sigmoid is rounded
    before the product, as in the reference (``F.silu`` rounds once);
    float32 keeps ``F.silu``."""
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


def glu_mlp_decl(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": pr.normal((d_model, d_ff), ("embed", "mlp"), fan_in=d_model),
        "w_up": pr.normal((d_model, d_ff), ("embed", "mlp"), fan_in=d_model),
        "w_down": pr.normal((d_ff, d_model), ("mlp", "embed"), fan_in=d_ff),
    }


def glu_mlp(p, x, compute_dtype=None):
    dt = compute_dtype or x.dtype
    x = x.to(dt)
    gate = silu(linear(x, p["w_gate"].to(dt)))
    up = linear(x, p["w_up"].to(dt))
    return linear(gate * up, p["w_down"].to(dt))


# -- embeddings ---------------------------------------------------------------

def embedding_decl(vocab: int, d_model: int) -> dict:
    return {"table": pr.normal((vocab, d_model), ("vocab", "embed"), fan_in=d_model)}


def embed(p, tokens, compute_dtype=None):
    """The rows of ``tokens``; with the node axis, table (K, V, D) and tokens
    (K, ...): node i's tokens from node i's table."""
    table = p["table"]
    if table.ndim == 3:
        k = table.shape[0]
        node = torch.arange(k, device=tokens.device).reshape((k,) + (1,) * (tokens.ndim - 1))
        out = table[node, tokens]
    else:
        out = table[tokens]
    return out.to(compute_dtype) if compute_dtype else out


# -- the LM loss ----------------------------------------------------------------

def _chunk_xent(xc, table, yc, mc, cap):
    """Summed cross-entropy of one chunk and its count of unmasked positions;
    with the node axis (table (K, V, D), the chunk (K, B, c, D)) each is
    (K,), one per node."""
    logits = linear(xc.float(), table.float().transpose(-1, -2))
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yc[..., None])[..., 0]
    ce = (lse - gold) * mc
    if table.ndim == 3:
        return ce.flatten(1).sum(1), mc.flatten(1).sum(1)
    return ce.sum(), mc.sum()


def chunked_logits_xent(x, emb_table, labels, mask=None, chunk: int = 512,
                        logit_softcap_val: float | None = None):
    """Cross-entropy over the vocab without materializing (B, S, V) at once.

    Loops over sequence chunks of ``chunk`` positions (the last one may be
    shorter); each computes its logits (B, c, V) and its CE contribution.
    Returns the mean CE over unmasked positions.  With the node axis (x (K,
    B, S, D), emb_table (K, V, D), labels (K, B, S)) it returns the (K,)
    per-node means: a chunk cuts the sequence, never the nodes.  Where a gradient is taken
    and the sequence has more than one chunk, each chunk's logits are
    recomputed in the backward pass (``torch.utils.checkpoint``), so autograd
    keeps no chunk's logits alive.
    """
    s = x.shape[-2]
    chunk = min(chunk, s)
    mask = torch.ones(x.shape[:-1], device=x.device) if mask is None else mask.float()
    labels = labels.long()
    starts = range(0, s, chunk)
    recompute = torch.is_grad_enabled() and len(starts) > 1
    total = count = 0.0
    for lo in starts:
        args = (x[..., lo:lo + chunk, :], emb_table, labels[..., lo:lo + chunk],
                mask[..., lo:lo + chunk], logit_softcap_val)
        dl, dc = (checkpoint(_chunk_xent, *args, use_reentrant=False) if recompute
                  else _chunk_xent(*args))
        total, count = total + dl, count + dc
    return total / torch.clamp(count, min=1.0)
