from repro_torch.optim.optimizers import (
    Optimizer,
    sgd,
    momentum,
    adam,
    clip_by_global_norm,
    chain_clip,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    paper_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = [
    "Optimizer",
    "sgd",
    "momentum",
    "adam",
    "clip_by_global_norm",
    "chain_clip",
    "constant_schedule",
    "paper_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
]
