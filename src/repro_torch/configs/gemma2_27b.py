"""gemma2-27b [dense]: alternating local/global attention with soft-capping.

46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128), d_ff=36864,
vocab=256000. Local layers use a 4096 sliding window; global layers are full
attention, so `long_500k` is skipped (a local-only variant would be
unfaithful — see DESIGN.md). [arXiv:2408.00118]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        arch_type="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        layer_pattern=("swa", "attn"),   # local, global alternating
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab=512,
        layer_pattern=("swa", "attn"),
        sliding_window=16,
        attn_softcap=50.0,
        logit_softcap=30.0,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
