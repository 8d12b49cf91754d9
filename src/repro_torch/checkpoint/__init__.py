from repro_torch.checkpoint.checkpoint import save_checkpoint, restore_checkpoint  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
