from repro_torch.configs.base import ALIASES, ARCH_IDS, all_archs, canonical, get_arch
from repro_torch.configs.paper_models import (
    PaperExperimentConfig,
    fmnist_default,
    cifar_default,
)

__all__ = ["ALIASES", "ARCH_IDS", "all_archs", "canonical", "get_arch", "PaperExperimentConfig",
           "fmnist_default", "cifar_default"]
