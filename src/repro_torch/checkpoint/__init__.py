"""Atomic, async, keep-N checkpoints."""

from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
