"""grok-1-314b [moe]: 8 experts, top-2 routing.

64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768 (per expert),
vocab=131072. Full attention => `long_500k` skipped. [hf:xai-org/grok-1]
"""

from repro_torch.models.config import ArchConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        arch_type="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab=131072,
        layer_pattern=("attn",),
        ffn_pattern=("moe",),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768),
        attn_softcap=30.0,     # grok uses attention logit capping
        logit_softcap=30.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="grok-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        layer_pattern=("attn",),
        ffn_pattern=("moe",),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                      capacity_factor=2.0),
        attn_softcap=30.0,
        logit_softcap=30.0,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
