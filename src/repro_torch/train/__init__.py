"""Training: checkpoints in the reference's on-disk format, the
fault-tolerant loop (data-parallel on a mesh) and the watchdog (the
reference's repro.train)."""

from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.train_loop import LoopConfig, train

__all__ = ["LoopConfig", "latest_step", "restore_checkpoint", "save_checkpoint", "train"]
