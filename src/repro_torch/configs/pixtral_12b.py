"""pixtral-12b [vlm]: mistral-nemo decoder consuming Pixtral-ViT embeddings.

40L, d_model=5120, 32 heads (GQA kv=8), d_ff=14336, vocab=131072.
Per the carve-out, the ViT vision encoder + projector is a STUB:
``input_specs`` supplies precomputed patch embeddings (B, 1024, d_model)
prepended to the text tokens. Full attention => `long_500k` skipped.
[hf:mistralai/Pixtral-12B-2409]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        arch_type="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        frontend="patch_stub",
        frontend_len=1024,     # one 1024-patch image per sequence
        rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="pixtral-smoke",
        arch_type="vlm",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        frontend="patch_stub",
        frontend_len=16,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
