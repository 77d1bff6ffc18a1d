"""The paper's own experiment configurations (§6.1).

The port's own copy of ``repro.configs.paper_models``: ``repro_torch``
imports nothing of ``repro``.

FMNIST MLP (784-128-64-10) and CIFAR10 CNN (3 conv + 2 fc x 500), with the
paper's hyperparameters: eta = sqrt(K/T), B = sqrt(KT), Metropolis mixing on
Erdős–Rényi graphs (p=0.3 FMNIST / p=0.5 CIFAR), mu in {2,...,9}.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExperimentConfig:
    dataset: str               # "fmnist" | "cifar"
    num_nodes: int = 10
    mu: float = 6.0
    graph: str = "erdos_renyi"
    p: float = 0.3
    steps: int = 300
    shards_per_node: int = 2
    seed: int = 0

    @property
    def lr(self) -> float:
        return (self.num_nodes / self.steps) ** 0.5

    @property
    def batch_size(self) -> int:
        b = int(round((self.num_nodes * self.steps) ** 0.5))
        return max(8, min(b, 128))


def fmnist_default() -> PaperExperimentConfig:
    return PaperExperimentConfig(dataset="fmnist", p=0.3, mu=6.0)


def cifar_default() -> PaperExperimentConfig:
    return PaperExperimentConfig(dataset="cifar", p=0.5, mu=6.0)
