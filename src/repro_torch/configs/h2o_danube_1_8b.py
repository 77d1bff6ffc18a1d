"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

24L, d_model=2560, 32 heads (GQA kv=8), d_ff=6912, vocab=32000.
Sliding window 4096 (mistral-style) — sub-quadratic, so `long_500k` runs.
[arXiv:2401.16818]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b",
        arch_type="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        layer_pattern=("swa",),
        sliding_window=4096,
        rope_theta=10000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        layer_pattern=("swa",),
        sliding_window=16,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
