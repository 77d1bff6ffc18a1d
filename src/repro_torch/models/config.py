"""Architecture configuration of the LM families (the port of
``repro.models.config``).

The fields are the reference's, value for value, so a ``configs/<arch>.py``
module reads the same on both sides.  ``moe_dispatch_specs``,
``logits_chunk``, ``attn_q_chunk``/``attn_kv_chunk``, ``scan_layers``,
``remat`` and ``remat_policy`` steer the reference's compiled programs (mesh
sharding, XLA chunking, scan and remat); they are carried as data and do not
steer the port, whose attention tiles are the kernel's and whose layer loop
is a Python loop.  The dtypes are ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # FFN hidden size of each routed expert
    num_shared: int = 0           # always-active shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    aux_coef: float = 0.01        # load-balance loss coefficient
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture. ``layer_pattern`` is tiled to cover ``n_layers``.

    Block kinds: "attn" (full causal GQA), "swa" (sliding window),
    "mamba" (selective SSM), "rwkv" (RWKV6 time-mix).
    FFN kinds (``ffn_pattern``): "dense" (GLU MLP), "moe", "none".
    """

    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    layer_pattern: tuple[str, ...] = ("attn",)
    ffn_pattern: tuple[str, ...] = ("dense",)
    first_k_dense: int = 0               # leading layers forced to dense FFN
    moe: MoEConfig | None = None
    sliding_window: int | None = None    # for "swa" blocks
    attn_softcap: float | None = None    # gemma2
    logit_softcap: float | None = None   # gemma2
    qkv_bias: bool = False               # qwen2
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    frontend: str = "token"              # token | patch_stub | frame_stub
    frontend_len: int = 256              # prefix length for stub frontends
    # RWKV / Mamba dims
    rwkv_head_dim: int = 64
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int | None = None     # default ceil(d_model/16)
    # the reference's compiled-program knobs, carried as data (module doc)
    moe_dispatch_specs: tuple | None = None
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    logits_chunk: int = 512
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        pat = self._full_pattern()
        if len(pat) != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern (len {len(self.layer_pattern)}) with "
                f"first_k_dense={self.first_k_dense} does not tile n_layers={self.n_layers}"
            )
        if self.moe is None and "moe" in self.ffn_pattern:
            raise ValueError("ffn_pattern has 'moe' but moe config is None")

    # -- derived ------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_len(self) -> int:
        return int(math.lcm(len(self.layer_pattern), len(self.ffn_pattern)))

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_k_dense) // self.pattern_len

    def _full_pattern(self) -> list[tuple[str, str]]:
        """[(block_kind, ffn_kind)] for every layer, honoring first_k_dense."""
        out = []
        for i in range(self.n_layers):
            blk = self.layer_pattern[i % len(self.layer_pattern)]
            ffn = self.ffn_pattern[i % len(self.ffn_pattern)]
            if i < self.first_k_dense:
                ffn = "dense"
            out.append((blk, ffn))
        return out

    def group_pattern(self) -> list[tuple[str, str]]:
        """The repeated (block, ffn) pattern applied ``n_groups`` times."""
        start = self.first_k_dense
        return self._full_pattern()[start:start + self.pattern_len]

    def head_layers(self) -> list[tuple[str, str]]:
        """The leading layers outside the groups (first_k_dense)."""
        return self._full_pattern()[: self.first_k_dense]

    @property
    def is_subquadratic(self) -> bool:
        """True when no layer uses full (unbounded) attention."""
        kinds = {b for b, _ in self._full_pattern()}
        return "attn" not in kinds

    def validate_divisibility(self):
        if (self.n_layers - self.first_k_dense) % self.pattern_len:
            raise ValueError(f"{self.name}: layers not divisible by pattern")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
