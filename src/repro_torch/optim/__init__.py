from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm, sgd
from repro_torch.optim.schedules import constant_schedule, paper_schedule

__all__ = ["Optimizer", "clip_by_global_norm", "sgd", "constant_schedule",
           "paper_schedule"]
