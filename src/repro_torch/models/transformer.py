"""Decoder-only LM over a tiled ``(block, ffn)`` pattern, for training and
serving (the port of ``repro.models.transformer``), covering all ten
architectures of ``repro_torch.configs``.

A model is ``ArchConfig.layer_pattern`` x ``ffn_pattern`` applied over
``n_groups`` repeats, with optional leading layers outside the groups
(``first_k_dense``, DeepSeekMoE).  Block kinds: ``attn`` (full causal GQA),
``swa`` (sliding-window GQA), ``mamba`` (selective SSM, ``models/ssm.py``)
and ``rwkv`` (RWKV6 time + channel mix); FFN kinds: ``dense`` (GLU),
``moe`` (top-k capacity dispatch, ``models/moe.py``) and ``none``.  The
stub frontends (``patch_stub``, ``frame_stub``) prepend the precomputed
``batch["embeddings"]`` (B, P, D) to the token embeddings; the loss and
the logits read the text positions only.

  loss(params, batch)                  — training objective (CE + MoE aux)
  prefill(params, batch)               — whole prompt -> (last logits, caches)
  decode_step(params, tok, pos, cache) — one token against the cache
  paged_decode_step(params, tok, pos, cache, tables, max_len=...)
                                       — one token per serving slot against
                                         the paged pools (the engine's step)
  logits_all(params, batch)            — every text position's logits (eval)

The full-sequence forward's attention is one launch of the flash-attention
kernel (B.6) per attn/swa layer and its RWKV recurrence one launch of the
WKV6 kernel (B.7) per rwkv layer, on the card.  ``loss`` builds an autograd
graph: on the card B.6 and B.7 go through their backward kernels
(``kernels/flash_attention``, ``kernels/rwkv6_scan``).  The MoE dispatch
and the Mamba scan are plain PyTorch on every device, as the reference
computes them in plain JAX.  The layers run as a Python loop over the head
layers and the groups; the reference's ``lax.scan`` has no counterpart,
and neither has its ``remat``, which changes memory and not values.
:func:`make_lm_loss` is the node-stacked loss the decentralized trainer
takes: for the dense LMs (:func:`node_axis_declined`) one forward of all K
nodes, node-stacked leaves against (K, B, S+1) tokens, with attention's
K·B rows in one launch of B.6 per layer; for the other families a loop
over the nodes.

Parameters are the port's flat dict (``"groups/l0/mix/wq"``, with the
groups' leading axis as in the reference).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import params as pr
from repro_torch.models.attention import (
    attention_decl,
    attention_decode,
    attention_forward,
    init_kv_cache,
    init_paged_kv,
    paged_attention_decode,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    chunked_logits_xent,
    embed,
    embedding_decl,
    glu_mlp,
    glu_mlp_decl,
    rmsnorm,
    rmsnorm_decl,
    softcap,
)
from repro_torch.models.moe import moe_decl, moe_ffn
from repro_torch.models.ssm import (
    mamba_decl,
    mamba_forward,
    recurrent_init_state,
    rwkv_decl,
    rwkv_decode,
    rwkv_forward,
)
from repro_torch.utils.tree import flatten, subtree


def _layer_decl(cfg: ArchConfig, blk: str, ffn: str) -> dict:
    d: dict = {"norm1": rmsnorm_decl(cfg.d_model)}
    if blk in ("attn", "swa"):
        d["mix"] = attention_decl(cfg)
    elif blk == "mamba":
        d["mix"] = mamba_decl(cfg)
    elif blk == "rwkv":
        d["mix"] = rwkv_decl(cfg)
    else:
        raise ValueError(f"unknown block kind {blk!r}")
    if ffn == "dense":
        d["norm2"] = rmsnorm_decl(cfg.d_model)
        d["ffn"] = glu_mlp_decl(cfg.d_model, cfg.d_ff)
    elif ffn == "moe":
        d["norm2"] = rmsnorm_decl(cfg.d_model)
        d["ffn"] = moe_decl(cfg)
    elif ffn != "none":
        raise ValueError(f"unknown ffn kind {ffn!r}")
    return d


def _stack(decl: dict, n: int) -> dict:
    """Prepend the (n_groups, ...) 'layers' axis to every decl leaf."""
    return {name: pr.ParamDecl((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale,
                               d.dtype)
            for name, d in flatten(decl).items()}


def _logits(x, table, cap):
    return softcap(x.float() @ table.float().t(), cap)


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    cfg: ArchConfig

    # -- parameters -----------------------------------------------------------

    def decl(self) -> dict[str, pr.ParamDecl]:
        """Every parameter's declaration, flat and keyed ``"a/b"``."""
        cfg = self.cfg
        group = {f"l{i}": _layer_decl(cfg, blk, ffn)
                 for i, (blk, ffn) in enumerate(cfg.group_pattern())}
        d = {"embedding": embedding_decl(cfg.vocab, cfg.d_model),
             "final_norm": rmsnorm_decl(cfg.d_model)}
        if cfg.first_k_dense:
            d["head_layers"] = {f"h{i}": _layer_decl(cfg, blk, ffn)
                                for i, (blk, ffn) in enumerate(cfg.head_layers())}
        if not cfg.tie_embeddings:
            d["lm_head"] = {"table": pr.normal((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                                               fan_in=cfg.d_model)}
        out = flatten(d)
        out.update({f"groups/{n}": v for n, v in _stack(group, cfg.n_groups).items()})
        return out

    def init(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        """Seeded weights on ``gen``'s device."""
        return pr.init_tree(gen, self.decl(), gen.device)

    def param_shapes(self) -> dict[str, torch.Tensor]:
        return pr.shape_tree(self.decl())

    def num_params(self) -> int:
        return pr.count_params(self.decl())

    @property
    def has_prompt_prefill(self) -> bool:
        """Whether :meth:`prefill` serves a prompt of tokens alone: a prefix
        frontend's prefill needs its embeddings, so its prompt goes
        through the decode path instead."""
        return self.cfg.frontend == "token"

    def num_active_params(self) -> int:
        """Params touched per token (MoE: only the top_k routed experts)."""
        cfg = self.cfg
        total = self.num_params()
        if cfg.moe is None:
            return total
        n_moe = sum(1 for _, f in cfg._full_pattern() if f == "moe")
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert
        routed = n_moe * cfg.moe.num_experts * per_expert
        active = n_moe * cfg.moe.top_k * per_expert
        return total - routed + active

    # -- helpers --------------------------------------------------------------

    def _unembed_table(self, params):
        if self.cfg.tie_embeddings:
            return params["embedding/table"]
        return params["lm_head/table"]

    def _input_embed(self, params, batch, drop_last_token: bool = False):
        """Returns (x (B, P + S, D), P): the stub frontends prepend
        ``batch["embeddings"]`` (B, P, D); P = 0 for token frontends."""
        cfg = self.cfg
        toks = batch["tokens"]
        if drop_last_token:
            toks = toks[..., :-1]
        x = embed(subtree(params, "embedding"), toks, cfg.compute_dtype)
        if cfg.frontend == "token":
            return x, 0
        emb = batch["embeddings"].to(cfg.compute_dtype)
        return torch.cat([emb, x], dim=1), emb.shape[1]

    def _layers(self, params):
        """[(block, ffn, the layer's leaves, where its cache lives)] in order:
        the head layers, then each group's pattern.  Node-stacked params
        (the node axis: every leaf (K, ...)) keep K first: the group axis
        of the groups' leaves is then axis 1."""
        cfg = self.cfg
        out = []
        for i, (blk, ffn) in enumerate(cfg.head_layers()):
            out.append((blk, ffn, subtree(params, f"head_layers/h{i}"), ("head", i, None)))
        axis = params["embedding/table"].ndim - 2  # 1 with the node axis, else 0
        # one unbind per leaf: its backward stacks the groups' gradients
        # once, where indexing would scatter each into a zeroed full leaf
        group = [(blk, ffn, {n: t.unbind(axis) for n, t in
                             subtree(params, f"groups/l{i}").items()})
                 for i, (blk, ffn) in enumerate(cfg.group_pattern())]
        for g in range(cfg.n_groups):
            for i, (blk, ffn, p) in enumerate(group):
                out.append((blk, ffn, {n: t[g] for n, t in p.items()},
                            ("groups", f"l{i}", g)))
        return out

    # -- layer application ----------------------------------------------------

    def _ffn(self, p, x, ffn, aux):
        """The layer's FFN with its residual; returns (x, aux + the MoE's
        aux loss)."""
        cfg = self.cfg
        if ffn == "none":
            return x, aux
        h2 = rmsnorm(subtree(p, "norm2"), x, cfg.rmsnorm_eps)
        if ffn == "dense":
            return x + glu_mlp(subtree(p, "ffn"), h2, cfg.compute_dtype).to(x.dtype), aux
        out, moe_aux = moe_ffn(subtree(p, "ffn"), h2, cfg)
        return x + out, aux + moe_aux

    def _apply_layer_fwd(self, p, x, blk, ffn, aux, want_cache: bool):
        """Full-sequence path; returns (x, aux, new_cache_or_None)."""
        cfg = self.cfg
        h = rmsnorm(subtree(p, "norm1"), x, cfg.rmsnorm_eps)
        mix = subtree(p, "mix")
        if blk in ("attn", "swa"):
            out, st = attention_forward(mix, h, cfg, kind=blk, return_kv=True)
            window = cfg.sliding_window if blk == "swa" else None
            if want_cache and window is not None and st["k"].shape[1] > window:
                st = {k: v[:, -window:] for k, v in st.items()}
        elif blk == "mamba":
            out, st = mamba_forward(mix, h, cfg)
        else:  # rwkv
            out, st = rwkv_forward(mix, h, cfg)
        x, aux = self._ffn(p, x + out, ffn, aux)
        return x, aux, st if want_cache else None

    def _apply_layer_decode(self, p, x, blk, ffn, pos, cache, *, tables=None, max_len=None):
        """One decode layer.  ``tables`` switches attn/swa layers onto the
        paged read/write path (``pos`` is then per-slot (B,) instead of an
        int); recurrent layers are per-slot rows either way."""
        cfg = self.cfg
        h = rmsnorm(subtree(p, "norm1"), x, cfg.rmsnorm_eps)
        mix = subtree(p, "mix")
        if blk in ("attn", "swa") and tables is not None:
            out, new_cache = paged_attention_decode(mix, h, cfg, kind=blk, pool=cache,
                                                    table=tables[blk], pos=pos,
                                                    max_len=max_len)
        elif blk in ("attn", "swa"):
            out, new_cache = attention_decode(mix, h, cfg, kind=blk, cache=cache, pos=pos)
        elif blk == "mamba":
            out, new_cache = mamba_forward(mix, h, cfg, cache)
        else:  # rwkv
            out, new_cache = rwkv_decode(mix, h, cfg, cache)
        return self._ffn(p, x + out, ffn, 0.0)[0], new_cache

    # -- full-sequence forward -------------------------------------------------

    def _forward(self, params, batch, want_cache: bool, drop_last_token: bool = False):
        """Returns (x after the final norm, aux, P, (head caches, group
        caches)); aux is the MoE layers' summed aux loss (0.0 without)."""
        cfg = self.cfg
        x, prefix = self._input_embed(params, batch, drop_last_token)
        aux = 0.0
        head, groups = [], {}
        for blk, ffn, p, (where, name, _) in self._layers(params):
            x, aux, c = self._apply_layer_fwd(p, x, blk, ffn, aux, want_cache)
            if where == "head":
                head.append(c)
            else:
                groups.setdefault(name, []).append(c)
        x = rmsnorm(subtree(params, "final_norm"), x, cfg.rmsnorm_eps)
        if want_cache:
            groups = {name: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                      for name, cs in groups.items()}
        return x, aux, prefix, (head, groups)

    # -- public API -----------------------------------------------------------

    def loss(self, params, batch):
        """Training objective: mean CE of next-token prediction over the
        text positions, plus the MoE aux loss.

        batch: {"tokens": (B, S+1) int[, "embeddings": (B, P, D)]};
        positions 0..S-1 are the inputs and 1..S the labels.  A dense LM
        (:func:`node_axis_declined`) also takes node-stacked params with
        tokens (K, B, S+1) and returns the (K,) per-node losses, each node
        on its own leaves and rows.
        """
        x, aux, prefix, _ = self._forward(params, batch, False, drop_last_token=True)
        ce = chunked_logits_xent(x[..., prefix:, :], self._unembed_table(params),
                                 batch["tokens"][..., 1:], chunk=self.cfg.logits_chunk,
                                 logit_softcap_val=self.cfg.logit_softcap)
        return ce + aux

    def logits_all(self, params, batch):
        """Full logits over every text position (small models / eval only)."""
        x, _, prefix, _ = self._forward(params, batch, False)
        return _logits(x[:, prefix:], self._unembed_table(params), self.cfg.logit_softcap)

    def prefill(self, params, batch):
        """Forward the whole prompt ``batch["tokens"]`` (B, S) (after the
        stub frontends' ``batch["embeddings"]``); returns (last-position
        logits (B, vocab), (head caches, group caches)): KV (B, P + S, KVH,
        hd) per attn layer (the last ``window`` positions for swa), the
        post-prompt state per mamba and rwkv layer; group caches stacked on
        a leading group axis."""
        x, _, _, caches = self._forward(params, batch, True)
        return _logits(x[:, -1], self._unembed_table(params), self.cfg.logit_softcap), caches

    def _caches(self, attention_cache, batch: int, device) -> dict:
        """The decode cache tree: ``attention_cache(blk)`` for each attn/swa
        layer, a (batch, ...) recurrent state for each mamba and rwkv layer;
        group entries stacked on a leading group axis."""
        cfg = self.cfg

        def layer_cache(blk, lead=()):
            c = attention_cache(blk) if blk in ("attn", "swa") \
                else recurrent_init_state(cfg, blk, batch, device)
            return {k: v.expand(lead + v.shape).contiguous() for k, v in c.items()}

        return {"head": [layer_cache(blk) for blk, _ in cfg.head_layers()],
                "groups": {f"l{i}": layer_cache(blk, (cfg.n_groups,))
                           for i, (blk, _) in enumerate(cfg.group_pattern())}}

    def init_cache(self, batch: int, seq_len: int, device) -> dict:
        """Zeroed decode cache for (batch, seq_len) context on ``device``."""
        return self._caches(lambda blk: init_kv_cache(self.cfg, batch, seq_len, blk, device),
                            batch, device)

    def init_paged_cache(self, batch: int, num_pages: dict, page_size: int, *,
                         quantized: bool, device) -> dict:
        """Paged decode cache on ``device``: attn/swa layers become shared
        page pools (``num_pages`` per layer, keyed by block kind), recurrent
        layers stay per-slot (batch, ...) rows; the structure of
        :meth:`init_cache`."""
        return self._caches(lambda blk: init_paged_kv(self.cfg, num_pages[blk], page_size,
                                                      quantized=quantized, device=device),
                            batch, device)

    def decode_step(self, params, token, pos: int, cache):
        """One decode step. token: (B, 1) int; pos: int.

        Updates ``cache`` in place (the new token's K/V slot, the recurrent
        states) and returns (logits (B, vocab), cache).
        """
        return self._decode_common(params, token, pos, cache)

    def paged_decode_step(self, params, token, pos, cache, tables, *, max_len: int):
        """One decode step against a paged cache (:meth:`init_paged_cache`).

        token: (B, 1) int; pos: (B,) int64 per-slot positions on the
        device; tables: {kind: (B, n_blocks) int64} block tables.
        ``max_len`` is the logical ring length of full-attention layers.
        Updates ``cache`` in place; returns (logits (B, vocab), cache).
        """
        return self._decode_common(params, token, pos, cache, tables=tables, max_len=max_len)

    def _decode_common(self, params, token, pos, cache, tables=None, max_len=None):
        cfg = self.cfg
        x = embed(subtree(params, "embedding"), token, cfg.compute_dtype)
        for blk, ffn, p, (where, name, g) in self._layers(params):
            stored = cache["head"][name] if where == "head" else cache["groups"][name]
            layer = stored if g is None else {k: v[g] for k, v in stored.items()}
            x, new = self._apply_layer_decode(p, x, blk, ffn, pos, layer, tables=tables,
                                              max_len=max_len)
            for k, v in new.items():
                if v is not layer[k]:  # attention wrote its slot in place already
                    layer[k].copy_(v)
        x = rmsnorm(subtree(params, "final_norm"), x, cfg.rmsnorm_eps)
        return _logits(x[:, 0], self._unembed_table(params), cfg.logit_softcap), cache


def node_axis_declined(cfg: ArchConfig) -> str | None:
    """None where the LM's forward takes the node axis (every layer attn or
    swa with a dense FFN, and a token frontend: qwen2, h2o-danube, gemma2,
    llama3), else why its node-stacked loss loops over the nodes (MoE's
    expert capacity is per node; the Mamba and RWKV blocks and the stub
    frontends are not batched over nodes yet)."""
    blocks = sorted({blk for blk, _ in cfg._full_pattern()} - {"attn", "swa"})
    ffns = sorted({ffn for _, ffn in cfg._full_pattern()} - {"dense"})
    if cfg.frontend != "token":
        return f"the {cfg.frontend} frontend"
    if blocks:
        return f"{'/'.join(blocks)} blocks"
    if ffns:
        return f"{'/'.join(ffns)} FFNs"
    return None


def node_loop_loss(model: TransformerLM):
    """The node-stacked loss as a loop over the nodes: each leaf is unbound
    into K views and node i's loss runs on its own views and batch rows
    (the families :func:`node_axis_declined` declines).  The backward of
    the unbind stacks the K nodes' gradients into one (K, ...) tensor per
    leaf."""

    def loss_fn(params, batch):
        tokens, *rest = batch
        names = list(params)
        views = zip(*(params[n].unbind(0) for n in names))
        losses = []
        for i, node in enumerate(views):
            node_batch = {"tokens": tokens[i]}
            if rest:
                node_batch["embeddings"] = rest[0][i]
            losses.append(model.loss(dict(zip(names, node)), node_batch))
        return torch.stack(losses)

    return loss_fn


def make_lm_loss(model: TransformerLM):
    """The node-stacked LM loss the decentralized trainer takes (the
    reference vmaps ``model.loss`` over the node axis).

    ``loss_fn(params, (tokens,))`` or ``loss_fn(params, (tokens,
    embeddings))`` with every leaf (K, ...), tokens (K, B, S+1) and the stub
    frontends' embeddings (K, B, P, D) returns the (K,) per-node losses
    (CE + aux).  A dense LM runs all K nodes in one forward (the node axis:
    batched products, one B.6 launch per layer for the K·B rows); the
    others run :func:`node_loop_loss`, and their loss carries
    ``capture_declined``, the reason the trainer does not capture their
    step (the loop's families are not checked under capture yet).
    """
    reason = node_axis_declined(model.cfg)
    if reason is None:
        def loss_fn(params, batch):
            return model.loss(params, {"tokens": batch[0]})

        return loss_fn
    loss_fn = node_loop_loss(model)
    loss_fn.capture_declined = f"the per-node loop of the LM loss ({reason})"
    return loss_fn
