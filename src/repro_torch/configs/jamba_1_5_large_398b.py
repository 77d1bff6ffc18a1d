"""jamba-1.5-large-398b [hybrid]: Mamba + attention 1:7 interleave, MoE.

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576 (expert size),
vocab=65536, MoE 16 experts top-2 on every second layer.  Period-8 block:
one attention layer per 7 Mamba layers (attention at position 4, as in the
released model).  Mamba recurrent state => `long_500k` runs.
[arXiv:2403.19887]
"""

from repro_torch.models.config import ArchConfig, MoEConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")


def full() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        layer_pattern=_PATTERN,
        ffn_pattern=("dense", "moe"),
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="jamba-smoke",
        arch_type="hybrid",
        n_layers=4,            # one attn + mamba mix, MoE every 2nd layer
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        layer_pattern=("mamba", "attn"),
        ffn_pattern=("dense", "moe"),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                      capacity_factor=2.0),
        mamba_d_state=8,
        mamba_d_conv=4,
        mamba_expand=2,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
