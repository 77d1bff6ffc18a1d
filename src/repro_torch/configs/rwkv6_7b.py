"""rwkv6-7b [ssm] "Finch": attention-free RWKV6 with data-dependent decay.

32L, d_model=4096, d_ff=14336, vocab=65536. No attention heads — the
assigned (attn-free) spec; time-mix uses 64-dim heads (d_model/64 = 64 heads).
Recurrent state decode => `long_500k` runs. [arXiv:2404.05892]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        arch_type="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,            # time-mix heads = d_model / rwkv_head_dim
        n_kv_heads=64,
        d_ff=14336,
        vocab=65536,
        layer_pattern=("rwkv",),
        ffn_pattern=("none",),
        rwkv_head_dim=64,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_ff=256,
        vocab=512,
        layer_pattern=("rwkv",),
        ffn_pattern=("none",),
        rwkv_head_dim=16,
        logits_chunk=64,
    )
