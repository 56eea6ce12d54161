"""Persistence: in this slice only the catch-up chunker."""

from .snapshot import batch_chunks

__all__ = ["batch_chunks"]
