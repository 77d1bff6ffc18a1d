"""Mixture-of-Experts FFN: top-k routing with capacity-bounded scatter
dispatch (the port of ``repro.models.moe``).

Tokens are scattered into per-expert (E, C, d) buffers by their rank within
the expert (a cumsum over the routing one-hots, token-major over the (T·k)
choices), each expert's GLU runs as one batched product over its buffer,
and the outputs are gathered back and combined with the gates.  A choice
past its expert's capacity C is dropped: it keeps the slot ``C − 1`` with a
zero source and a zero gate, as in the reference, so the residual carries
the token unchanged.  The router computes in float32; the gates are the
top-k softmax probabilities renormalised by ``max(sum, 1e-9)``; the
auxiliary loss is the Switch load-balance term from the top-1 choice,
times ``aux_coef``.

Covers grok-1 (8 experts, top-2), jamba-1.5 (16, top-2) and deepseek-moe
(2 shared + 64 routed fine-grained experts, top-6).  The reference's
``moe_dispatch_specs`` pins a mesh sharding on the dispatch tensors; it has
no meaning on one card and is ignored.  The dispatch is plain PyTorch
(index scatter and gather, ``torch.bmm``): the reference computes it in
plain JAX, outside any Pallas kernel.  On the card the backward of the
gather accumulates with atomics, so its bits may differ between runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import params as pr
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.layers import glu_mlp, glu_mlp_decl, silu
from repro_torch.utils.tree import subtree


def moe_decl(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    decl = {
        "router": pr.normal((d, m.num_experts), ("embed", "experts"), fan_in=d),
        "experts": {
            "w_gate": pr.normal((m.num_experts, d, m.d_expert), ("experts", "embed", "mlp"),
                                fan_in=d),
            "w_up": pr.normal((m.num_experts, d, m.d_expert), ("experts", "embed", "mlp"),
                              fan_in=d),
            "w_down": pr.normal((m.num_experts, m.d_expert, d), ("experts", "mlp", "embed"),
                                fan_in=m.d_expert),
        },
    }
    if m.num_shared:
        decl["shared"] = glu_mlp_decl(d, m.d_expert * m.num_shared)
    return decl


def _capacity(tokens: int, m: MoEConfig) -> int:
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, min(tokens, c))


def moe_route(p, xt: torch.Tensor, cfg: ArchConfig) -> dict:
    """The routing of (T, D) tokens: ``expert_ids`` and ``gate_vals`` (T, k)
    (gates zeroed where dropped), ``rank`` (T, k) within the expert, ``keep``
    (T, k), ``cap`` and the scaled aux loss."""
    m = cfg.moe
    t = xt.shape[0]
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary loss
    dispatch_frac = F.one_hot(expert_ids[:, 0], m.num_experts).float().mean(0)
    aux = m.num_experts * (dispatch_frac * probs.mean(0)).sum() * m.aux_coef

    cap = _capacity(t, m)
    flat = F.one_hot(expert_ids, m.num_experts).reshape(t * m.top_k, m.num_experts)
    ranks = torch.cumsum(flat, dim=0) - flat                    # (T*k, E)
    rank = (ranks * flat).sum(-1).reshape(t, m.top_k)
    keep = rank < cap
    return dict(expert_ids=expert_ids, gate_vals=gate_vals * keep.to(gate_vals.dtype),
                rank=rank, keep=keep, cap=cap, aux=aux)


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, D) -> (out (B, S, D), aux loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    dt = cfg.compute_dtype
    xt = x.reshape(t, d).to(dt)
    r = moe_route(p, xt, cfg)
    cap, keep = r["cap"], r["keep"]

    # scatter tokens into (E, C, D) buffers
    eid = r["expert_ids"].reshape(-1)
    rid = torch.clamp(r["rank"], max=cap - 1).reshape(-1)
    src = xt.repeat_interleave(m.top_k, dim=0) * keep.reshape(-1, 1).to(dt)
    buf = torch.zeros((m.num_experts, cap, d), dtype=dt, device=x.device)
    buf = buf.index_put((eid, rid), src, accumulate=True)

    # expert GLU: (E, C, D) x (E, D, F)
    ex = subtree(p, "experts")
    gate = silu(torch.bmm(buf, ex["w_gate"].to(dt)))
    up = torch.bmm(buf, ex["w_up"].to(dt))
    expert_out = torch.bmm(gate * up, ex["w_down"].to(dt))

    # gather back and combine with the gates
    gathered = expert_out[eid, rid].reshape(t, m.top_k, d)
    out = (gathered * r["gate_vals"][..., None].to(dt)).sum(1)
    if m.num_shared:
        out = out + glu_mlp(subtree(p, "shared"), xt, compute_dtype=dt)
    return out.reshape(b, s, d).to(x.dtype), r["aux"]
