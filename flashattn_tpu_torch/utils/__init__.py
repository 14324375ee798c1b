from .checkpoint import (  # noqa: F401
    AsyncCheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
