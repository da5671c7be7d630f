"""Training checkpoints: ``.trims`` state files, ``LATEST``, retention and
an asynchronous writer."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint, restore_into, retain, save_checkpoint,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
