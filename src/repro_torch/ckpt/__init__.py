"""Checkpointing: atomic, retained, optionally async, in the JAX package's
on-disk format."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
