"""qwen2-0.5b [dense]: GQA with QKV bias, tied embeddings.

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151936.
Full attention => `long_500k` skipped. [arXiv:2407.10671]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b",
        arch_type="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
