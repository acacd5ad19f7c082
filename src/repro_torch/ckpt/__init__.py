from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]
