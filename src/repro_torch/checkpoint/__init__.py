from repro_torch.checkpoint.ckpt import (
    save_checkpoint,
    restore_checkpoint,
    latest_step,
    latest_valid_step,
    checkpoint_valid,
    CheckpointManager,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "latest_valid_step",
    "checkpoint_valid",
    "CheckpointManager",
]
