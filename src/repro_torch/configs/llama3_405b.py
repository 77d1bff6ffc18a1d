"""llama3-405b [dense]: GQA, 128k vocab.

126L, d_model=16384, 128 heads (GQA kv=8), d_ff=53248, vocab=128256.
Full attention => `long_500k` skipped. Naive per-node decentralized training
of 405B is memory-infeasible on 256 chips (K x params replicas); see
EXPERIMENTS.md §Perf for the hierarchical FSDP+gossip treatment.
[arXiv:2407.21783]
"""

from repro_torch.models.config import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b",
        arch_type="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab=128256,
        rope_theta=500_000.0,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama3-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab=512,
        rope_theta=500_000.0,
        attn_q_chunk=32,
        attn_kv_chunk=32,
        logits_chunk=64,
    )
