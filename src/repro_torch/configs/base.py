"""Config registry of the LM families (the port of ``repro.configs.base``).

Every module under ``repro_torch/configs`` copies the reference's ``full()``
(the assigned configuration) and ``smoke()`` (a reduced same-family variant
for the CPU tests) value for value.  The configs of families the port does
not serve yet (moe, mamba, stub frontends) are data here: building a
``TransformerLM`` on them raises.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = (
    "h2o_danube_1_8b",
    "rwkv6_7b",
    "grok_1_314b",
    "jamba_1_5_large_398b",
    "pixtral_12b",
    "qwen2_0_5b",
    "gemma2_27b",
    "llama3_405b",
    "musicgen_medium",
    "deepseek_moe_16b",
)

# CLI aliases with the original dashes/dots
ALIASES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "rwkv6-7b": "rwkv6_7b",
    "grok-1-314b": "grok_1_314b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "pixtral-12b": "pixtral_12b",
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma2-27b": "gemma2_27b",
    "llama3-405b": "llama3_405b",
    "musicgen-medium": "musicgen_medium",
    "deepseek-moe-16b": "deepseek_moe_16b",
}


def canonical(name: str) -> str:
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; options: {ARCH_IDS}")
    return name


def all_archs(smoke: bool = False) -> dict[str, ArchConfig]:
    """Every supported architecture's config, keyed by its id."""
    return {a: get_arch(a, smoke) for a in ARCH_IDS}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke() if smoke else mod.full()
