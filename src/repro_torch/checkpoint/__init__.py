"""Checkpoints of trees and of the full train state (the port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.io import (
    latest_step,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_train_state", "restore_train_state"]
