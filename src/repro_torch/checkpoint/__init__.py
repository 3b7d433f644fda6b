"""Sharded checkpoints and their manager (the reference's
``checkpoint/``)."""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
