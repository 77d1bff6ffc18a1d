"""musicgen-medium [audio]: decoder-only over EnCodec tokens.

48L, d_model=1536, 24 heads (kv=24 — full MHA), d_ff=6144, vocab=2048.
Per the carve-out the EnCodec conv codec is a STUB: conditioning frame
embeddings (B, 256, d_model) are supplied precomputed and prepended; the
decoder autoregresses over the 2048-entry codebook. Full attention =>
`long_500k` skipped. [arXiv:2306.05284]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        arch_type="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab=2048,
        frontend="frame_stub",
        frontend_len=256,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-smoke",
        arch_type="audio",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=8,
        d_ff=256,
        vocab=512,
        frontend="frame_stub",
        frontend_len=16,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
