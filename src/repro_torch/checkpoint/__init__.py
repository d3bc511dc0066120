"""The port's checkpoints (``repro.checkpoint``), on the reference's
on-disk layout; ``reshard_tree`` is the multi-GPU slice (ROADMAP A8)."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
)
