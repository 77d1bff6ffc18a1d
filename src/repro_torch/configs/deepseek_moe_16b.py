"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed top-6.

28L, d_model=2048, 16 heads (kv=16 — MHA), d_ff=1408 (fine-grained expert
size, per the assignment), vocab=102400. First layer uses a dense FFN, the
remaining 27 are MoE — the DeepSeekMoE structure. Full attention =>
`long_500k` skipped. [arXiv:2401.06066]
"""

from repro_torch.models.config import ArchConfig, MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,             # assigned d_ff = fine-grained expert width
        vocab=102400,
        layer_pattern=("attn",),
        ffn_pattern=("moe",),
        first_k_dense=1,
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-smoke",
        arch_type="moe",
        n_layers=3,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_ff=64,
        vocab=512,
        layer_pattern=("attn",),
        ffn_pattern=("moe",),
        first_k_dense=1,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, num_shared=2,
                      capacity_factor=2.0),
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
