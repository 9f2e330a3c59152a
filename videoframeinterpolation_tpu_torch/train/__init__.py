"""Checkpoint reading for the port (training itself waits for a later slice)."""

from .checkpoint import read_flax_msgpack

__all__ = ["read_flax_msgpack"]
