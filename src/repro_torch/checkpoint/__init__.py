"""The port's checkpoints (``repro.checkpoint``), on the reference's
on-disk layout, and ``reshard_tree`` / ``gather_tree`` for a mesh."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    AsyncCheckpointer, gather_tree, latest_step, reshard_tree,
    restore_checkpoint, save_checkpoint,
)
