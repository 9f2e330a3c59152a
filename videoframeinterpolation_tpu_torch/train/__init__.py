"""Checkpoint reading for the port (training itself waits for a later slice)."""

from .checkpoint import read_flax_msgpack, read_flax_state

__all__ = ["read_flax_msgpack", "read_flax_state"]
