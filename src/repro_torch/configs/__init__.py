from repro_torch.configs.paper_models import (
    PaperExperimentConfig,
    fmnist_default,
    cifar_default,
)

__all__ = ["PaperExperimentConfig", "fmnist_default", "cifar_default"]
