from repro_torch.data.synthetic import (
    SyntheticImageDataset,
    make_fmnist_like,
    make_cifar_like,
)
from repro_torch.data.partition import (
    pathological_noniid_partition,
    iid_partition,
    dirichlet_partition,
    FederatedDataset,
)
from repro_torch.data.tokens import SyntheticTokenStream, make_node_token_streams

__all__ = [
    "SyntheticImageDataset",
    "make_fmnist_like",
    "make_cifar_like",
    "pathological_noniid_partition",
    "iid_partition",
    "dirichlet_partition",
    "FederatedDataset",
    "SyntheticTokenStream",
    "make_node_token_streams",
]
