# Copied from src/repro/checkpoint/__init__.py.
from repro_torch.checkpoint.io import peek_meta, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "peek_meta"]
